"""The port's examples, ``examples/torch_quickstart.py``,
``examples/torch_cp_decompose_distributed.py``,
``examples/torch_lm_serve.py`` (five archs, the enc-dec and vision ones
among them) and ``examples/torch_lm_train.py`` (the dense default with
its resume demo, and the MoE arch), run end to end on the CPU (the
kernels' plain versions), with the reference examples' asserts: exact
recovery of dense low-rank tensors at fit > 0.99, tokens in the
vocabulary, a held-out loss that falls, and ``OK`` last. On the card
``chip_smoke.py``'s ``[examples]`` runs all four."""
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_cpu(capsys, tmp_path, monkeypatch):
    # No table of this host: the example calibrates its micro-grid.
    monkeypatch.chdir(tmp_path)
    _load("torch_quickstart").main("cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "OK"
    fit = float(next(ln for ln in out if ln.startswith(
        "low-rank recovery fit:")).split(":")[1])
    assert fit > 0.99
    assert any(ln.startswith("tuned per-mode plans:") for ln in out)


def test_cp_decompose_distributed_on_cpu(capsys):
    got = _load("torch_cp_decompose_distributed").main("cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "OK"
    assert got["fit3"] > 0.99 and got["fit4"] > 0.99
    assert set(got["ms"]) == {"dynasor", "allreduce-baseline"}
    assert all(b > 0 for b in got["bytes"].values())


def test_lm_serve_on_cpu(capsys):
    """The dense, MoE and SSM archs of the reference's example, then the
    enc-dec and vision-language smoke runs."""
    _load("torch_lm_serve").main("cpu", tokens=8)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "OK"
    archs = ["qwen3-32b", "qwen2-moe-a2.7b", "mamba2-370m",
             "seamless-m4t-large-v2", "llama-3.2-vision-11b"]
    assert [ln.split()[0] for ln in out[:-1]] == archs
    assert all("generated 4x8 tokens" in ln for ln in out[:-1])


def test_lm_train_resume_demo_on_cpu(capsys):
    """The example at its defaults (200 steps of 4 x 64 tokens) with the
    resume demo: phase 2 resumes after phase 1's last checkpoint (step
    90) and runs to step 199."""
    got = _load("torch_lm_train").main("cpu", resume_demo=True)
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "OK"
    assert "[runner] resumed from step 90" in out
    steps = [h["step"] for h in got["history"]]
    assert steps == list(range(91, 200))
    assert got["end"] < got["start"]


def test_lm_train_the_moe_arch_on_cpu(capsys):
    """``--arch qwen2-moe-a2.7b``, as the reference's example names it:
    200 steps of its smoke config, the held-out loss falls."""
    got = _load("torch_lm_train").main("cpu", arch="qwen2-moe-a2.7b")
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "OK"
    assert [h["step"] for h in got["history"]] == list(range(200))
    assert got["end"] < got["start"]


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_cp_decompose_distributed",
                                  "torch_lm_serve", "torch_lm_train"])
def test_example_refuses_without_a_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(name).main()

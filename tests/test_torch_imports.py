"""The port stands alone: no module of it, nor chip_smoke.py, imports JAX
or the JAX package ``repro`` (the machine with the card has no JAX)."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        out += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.core.cpals, "
            "repro_torch.kernels.mttkrp.kernel, repro_torch.convert, "
            "repro_torch.oocore.executor, repro_torch.oocore.planner, "
            "repro_torch.reorder.ordering; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", [
    "repro_torch.reorder.ordering", "repro_torch.oocore.planner",
    "repro_torch.oocore.executor", "repro_torch.kernels.mttkrp.ops",
    "repro_torch.core.flycoo", "repro_torch.kernels.mttkrp.kernel",
    "repro_torch.core.distributed", "repro_torch.resilience.policy",
    "repro_torch.resilience.checkpoint", "repro_torch.resilience.__main__",
    "repro_torch.checkpoint.manager", "repro_torch.obs.tracer",
    "repro_torch.runtime.fault_tolerance", "repro_torch.core.cpals",
    "repro_torch.obs.counters", "repro_torch.obs.baseline",
    "repro_torch.obs.__main__", "repro_torch.obs.prof.harness",
    "repro_torch.obs.prof.__main__", "repro_torch.tune",
    "repro_torch.tune.table", "repro_torch.tune.model",
    "repro_torch.tune.microbench", "repro_torch.tune.cli",
    "repro_torch.tune.__main__"])
def test_new_modules_import_first_without_jax(module):
    """Each module of the stream and dispatch paths imports on its own
    (the package's import cycle between ops, the planner and the
    orderings resolves in any order) and pulls in no JAX."""
    code = (f"import sys, {module}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

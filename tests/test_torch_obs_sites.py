"""Port parity: the counter emit sites of ``repro_torch`` and their
absorbers, against the reference's ``repro.obs`` sites.

Each site fires with the reference's names and labels: ``dispatch.backend``
(``ops.select_backend``), ``planner.*`` (``oocore.planner.plan_residency``,
the Hopper ladder's two plan budgets in place of the reference's one VMEM
budget), the out-of-core executor's spans and ``record_stream_stats``
counters (equal to the reference's for the same stream at the reference's
geometry), ``remap.*`` (``core.distributed.prepare_runtime``, the
reference's arithmetic) and ``reorder.perms``
(``reorder.locality_lexsort``). ``ops.step_traffic_bytes`` equals the
reference's at ``rank_multiple=128``, and ``ops.timed_device_step`` emits
its span and counters as the reference's does. The port's counters fire
per call, the reference's dispatch and planner counters per jit trace:
that difference is held here too. Inputs come from seeded generators.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import distributed as jdist  # noqa: E402
from repro.core import flycoo as jfly  # noqa: E402
from repro.core import tensors as jten  # noqa: E402
from repro.kernels.mttkrp import ops as jops  # noqa: E402
from repro.obs import counters as jcnt  # noqa: E402
from repro.obs import tracer as jtr  # noqa: E402
from repro.oocore import executor as jex  # noqa: E402
from repro.reorder import ordering as jord  # noqa: E402
from repro_torch.core import distributed as tdist  # noqa: E402
from repro_torch.core import flycoo as tfly  # noqa: E402
from repro_torch.core import tensors as tten  # noqa: E402
from repro_torch.kernels.mttkrp import ops as tops  # noqa: E402
from repro_torch.obs import counters as ocnt  # noqa: E402
from repro_torch.obs import tracer as otr  # noqa: E402
from repro_torch.oocore import executor as tex  # noqa: E402
from repro_torch.oocore import planner as tp  # noqa: E402
from repro_torch.reorder import ordering as tord  # noqa: E402

# The reference's geometry, for exact comparison of counted bytes.
JAX_GEOMETRY = dict(frow_tile=128, rank_slab=128, rank_multiple=128)
ORDERINGS = ("none", "tile", "morton")

# Reference names the port does not emit, each with what brings it.
EXCLUDED = {
    "execution.fallback": "no interpreter: a CUDA tensor runs the kernel",
    "execution.resolve": "no interpreter to resolve",
    "resilience.interpret_fallbacks": "no interpreter to fall back to",
    "dryrun.compile_s": "LM scaffolding, ROADMAP A15",
    "dryrun.lower_s": "LM scaffolding, ROADMAP A15",
    "serve.decode_s": "LM scaffolding, ROADMAP A15",
    "serve.prefill_s": "LM scaffolding, ROADMAP A15",
    "serve.tokens": "LM scaffolding, ROADMAP A15",
}
# The reference's one VMEM plan budget -> the Hopper ladder's two.
TRANSLATED = {"planner.vmem.plan_bytes": ("planner.smem.plan_bytes",
                                          "planner.l2.plan_bytes")}


def _counted(snapshot, prefixes):
    return {k: int(v) for k, v in snapshot.items()
            if k.startswith(prefixes) and not ocnt.split_key(k)[0]
            .endswith("_s")}


# ---------------------------------------------------------------------------
# The closed namespace
# ---------------------------------------------------------------------------

def test_namespace_sorted_and_the_reference_less_exclusions():
    assert list(ocnt.NAMESPACES) == sorted(set(ocnt.NAMESPACES))
    want = (set(jcnt.NAMESPACES) - set(EXCLUDED) - set(TRANSLATED)) | {
        n for names in TRANSLATED.values() for n in names}
    assert set(ocnt.NAMESPACES) == want
    assert set(EXCLUDED) <= set(jcnt.NAMESPACES)


@pytest.mark.parametrize("name", sorted(EXCLUDED) + sorted(TRANSLATED))
def test_excluded_names_are_rejected(name):
    with pytest.raises(ValueError, match="NAMESPACES"):
        ocnt.CounterRegistry().add(name, 1)


# What each reference module that emits an excluded name belongs to: the
# words its exclusion reason must carry.
REFERENCE_OWNER = {
    "src/repro/runtime/execution.py": "interpreter",
    "src/repro/resilience/policy.py": "interpreter",
    "src/repro/launch/": "LM scaffolding, ROADMAP A15",
}


def _reference_emitters(name):
    """The reference modules whose code emits counter ``name``
    (``<registry>.add("name", ...)``), not the ones that only mention it."""
    import glob
    import os
    import re
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pat = re.compile(r"\badd\(\s*" + re.escape(f'"{name}"'))
    out = []
    for path in sorted(glob.glob(os.path.join(root, "src", "repro", "**",
                                              "*.py"), recursive=True)):
        if pat.search(open(path, encoding="utf-8").read()):
            out.append(os.path.relpath(path, root))
    return out


@pytest.mark.parametrize("name", sorted(EXCLUDED))
def test_exclusion_reason_names_the_emitting_modules_item(name):
    """Each excluded name is emitted by reference code that belongs to the
    item its reason names (``dryrun.*`` is ``launch/dryrun.py``, the LM
    multi-pod dry run: A15, not the compile-validation tier A13)."""
    emitters = _reference_emitters(name)
    assert emitters, f"no reference module emits {name}"
    for module in emitters:
        owners = [item for prefix, item in REFERENCE_OWNER.items()
                  if module.startswith(prefix)]
        assert owners, f"{module} (emits {name}) has no owner listed"
        assert owners[0] in EXCLUDED[name], (name, module, EXCLUDED[name])


@pytest.mark.parametrize("name", ["resilience.table_fallbacks",
                                  "tune.measure_s", "tune.points"])
def test_tune_names_are_emitted_as_the_reference_emits_them(name, tmp_path):
    """The calibration tables' names joined the namespace with their
    sites: ``tune.*`` in ``tune.calibrate``, ``resilience.table_fallbacks``
    in ``tune.find_table``; labels as the reference's."""
    from repro import tune as jtune
    from repro.obs import counters as jcnt
    from repro_torch import tune as ttune
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    (tmp_path / "t" / "bad.json").write_text("{not json")
    (tmp_path / "j" / "bad.json").write_text("{not json")
    grid = jtune.default_grid(quick=True)[:3]
    jreg = jcnt.CounterRegistry()
    with ocnt.use_registry() as treg:
        ttune.calibrate(grid=[ttune.GridPoint(p.nmodes, p.rank, p.blk,
                                              p.tile_rows, p.density)
                              for p in grid],
                        measure=ttune.stub_measure, device="cpu")
        assert ttune.find_table(str(tmp_path / "t")) is None
    with jcnt.use_registry(jreg):
        jtune.calibrate(grid=grid, measure=jtune.stub_measure)
        assert jtune.find_table(str(tmp_path / "j")) is None
    assert name in ocnt.NAMESPACES
    got = {k: v for k, v in treg.snapshot().items()
           if ocnt.split_key(k)[0] == name}
    want = {k: v for k, v in jreg.snapshot().items()
            if jcnt.split_key(k)[0] == name}
    assert got and got == want


# ---------------------------------------------------------------------------
# Absorbers
# ---------------------------------------------------------------------------

class _FakeStats:
    def __init__(self, s, d, p, i, ordering="none", pre=(0, 0),
                 backend="pallas_fused_gather_stream", chunks=3):
        self.backend, self.chunks = backend, chunks
        self.scheduled_tile_bytes = s
        self.distinct_tile_bytes = d
        self.pipelined_tile_bytes = p
        self.index_stream_bytes = i
        self.ordering = ordering
        self.presort_scheduled_tile_bytes, \
            self.presort_distinct_tile_bytes = pre


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_record_stream_stats_equals_reference(seed, ordering):
    rng = np.random.default_rng(seed)
    s = int(rng.integers(0, 10**12))
    d, p = int(s * rng.random()), int(s * rng.random())
    stats = _FakeStats(s, d, p, int(rng.integers(0, 10**9)), ordering,
                       pre=(s + 7, d + 3))
    jreg = jcnt.CounterRegistry()
    with ocnt.use_registry() as treg:
        ocnt.record_stream_stats(stats)
    jcnt.record_stream_stats(stats, registry=jreg)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.get("oocore.dma.distinct_bytes") <= \
        treg.get("oocore.dma.scheduled_bytes")


@pytest.mark.parametrize("caps, D, nmodes", [([10, 7, 12], 4, 3),
                                             ([3, 9, 1, 5], 2, 4),
                                             ([64], 1, 3),
                                             ([5, 5, 5], 8, 3),
                                             ([0, 11, 2, 40, 6], 3, 5),
                                             ([1, 2], 16, 2)])
def test_record_remap_exchange_equals_reference(caps, D, nmodes):
    jreg = jcnt.CounterRegistry()
    with ocnt.use_registry() as treg:
        ocnt.record_remap_exchange(caps, D, nmodes)
    jcnt.record_remap_exchange(caps, D, nmodes, registry=jreg)
    assert treg.snapshot() == jreg.snapshot()
    per_pair = D * D * (4 * nmodes + 4)
    for n, cap in enumerate(caps):
        assert treg.get("remap.a2a.bytes", transition=n) == cap * per_pair
    assert treg.get("remap.a2a.uniform_bytes") == \
        len(caps) * max(caps) * per_pair


# ---------------------------------------------------------------------------
# Emit sites
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["pallas_fused", "pallas_fused_gather",
                                     "pallas_fused_gather_stream", "ref",
                                     "pallas_fused_gather_bf16"])
def test_select_backend_explicit_key_equals_reference(backend):
    with ocnt.use_registry() as treg:
        assert tops.select_backend(backend, nmodes=3, rank=128) == backend
    with jcnt.use_registry() as jreg:
        assert jops.select_backend(backend, nmodes=3, rank=128) == backend
    assert treg.snapshot() == jreg.snapshot() == {
        f"dispatch.backend{{backend={backend},source=explicit}}": 1}


@pytest.mark.parametrize("rank, factor_rows", [
    (16, (64, 64)), (256, (64, 64)), (16, None), (16, (10**7, 10**7)),
    (1024, (500, 700))])
def test_select_backend_auto_counts_static_decision_and_plan(rank,
                                                             factor_rows):
    with ocnt.use_registry() as reg:
        chosen = tops.select_backend("auto", nmodes=3, rank=rank, blk=64,
                                     factor_rows=factor_rows)
    plan = tp.plan_residency(nmodes=3, rank=rank, blk=64,
                             factor_rows=factor_rows)
    assert plan.backend == chosen
    assert reg.snapshot() == {
        f"dispatch.backend{{backend={chosen},source=static}}": 1,
        "planner.plans": 1,
        f"planner.smem.plan_bytes{{backend={chosen}}}": plan.smem_bytes,
        f"planner.l2.plan_bytes{{backend={chosen}}}": plan.l2_bytes,
    }
    # The reference's labels on the same call: the same base names and
    # label keys, its one VMEM budget where the port has two.
    with jcnt.use_registry() as jreg:
        jops.select_backend("auto", nmodes=3, rank=rank,
                            factor_rows=factor_rows)
    jkeys = {jcnt.split_key(k)[0]: sorted(jcnt.split_key(k)[1])
             for k in jreg.snapshot()}
    assert jkeys == {"dispatch.backend": ["backend", "source"],
                     "planner.plans": [],
                     "planner.vmem.plan_bytes": ["backend"]}


def test_dispatch_and_planner_count_per_call():
    # The reference counts at jit-trace time (once per signature); the
    # port runs eagerly and counts every call.
    with ocnt.use_registry() as reg:
        for _ in range(3):
            tops.select_backend("auto", nmodes=3, rank=16,
                                factor_rows=(64, 64))
    assert reg.get("planner.plans") == 3
    assert reg.total("dispatch.backend") == 3


def _sorted_case(shape, nnz, rank, mode, seed, distribution="uniform"):
    t = jten.random_sparse_tensor(shape, nnz, seed=seed,
                                  distribution=distribution)
    order = np.argsort(t.indices[:, mode], kind="stable")
    idx = t.indices[order].astype(np.int32)
    val = t.values[order].astype(np.float32)
    valid = np.ones(len(val), bool)
    rng = np.random.default_rng(seed + 1)
    factors = [rng.standard_normal((d, rank)).astype(np.float32)
               for d in shape]
    return idx, val, valid, factors


EXEC_CASES = [
    dict(shape=(20, 300, 170), nnz=200, rank=32, mode=0, seed=0,
         rows_cap=24, blk=8, max_chunk_bytes=1200),
    dict(shape=(2000, 40, 900, 30), nnz=300, rank=64, mode=1, seed=3,
         rows_cap=40, blk=32, max_chunk_bytes=2000,
         distribution="powerlaw"),
]


def _run_executor(pkg, case, ordering):
    c = dict(case)
    rows_cap, blk, mcb = c.pop("rows_cap"), c.pop("blk"), \
        c.pop("max_chunk_bytes")
    idx, val, valid, factors = _sorted_case(**{
        k: c[k] for k in ("shape", "nnz", "rank", "mode", "seed")},
        distribution=c.get("distribution", "uniform"))
    kw = dict(mode=c["mode"], rows_cap=rows_cap, blk=blk, tile_rows=8,
              max_chunk_bytes=mcb, ordering=ordering)
    if pkg == "port":
        cnt, tr = ocnt, otr
        run = lambda t: tex.mttkrp_out_of_core(  # noqa: E731
            idx, val, valid, factors, device="cpu", **JAX_GEOMETRY, **kw)
    else:
        cnt, tr = jcnt, jtr
        run = lambda t: jex.mttkrp_out_of_core(  # noqa: E731
            idx, val, valid, factors, interpret=True, **kw)
    tracer = tr.Tracer()
    with cnt.use_registry() as reg, tr.use_tracer(tracer):
        _, stats = run(tracer)
    return stats, reg.snapshot(), tracer.records


@pytest.mark.parametrize("ordering", ORDERINGS)
@pytest.mark.parametrize("case", range(len(EXEC_CASES)))
def test_executor_counters_and_spans_equal_reference(case, ordering):
    tstats, tsnap, trecs = _run_executor("port", EXEC_CASES[case], ordering)
    _, jsnap, jrecs = _run_executor("jax", EXEC_CASES[case], ordering)
    prefixes = ("oocore.", "reorder.")
    assert _counted(tsnap, prefixes) == _counted(jsnap, prefixes)
    assert tsnap["oocore.chunks"] == tstats.chunks
    assert tsnap["oocore.dma.scheduled_bytes"] \
        == tstats.scheduled_tile_bytes
    # oocore.mode_step_s: the same labels in both packages
    for snap in (tsnap, jsnap):
        (key,) = [k for k in snap if k.startswith("oocore.mode_step_s")]
        assert ocnt.split_key(key)[1] == {
            "backend": "pallas_fused_gather_stream", "ordering": ordering}
    # The oocore spans: the same names and arguments, in the same order.
    def spans(recs):
        return [(r.name, dict(r.args)) for r in recs
                if r.name.startswith("oocore.")]
    assert spans(trecs) == spans(jrecs)
    (step,) = [r for r in trecs if r.name == "oocore.mode_step"]
    assert step.self_counters["oocore.dma.pipelined_bytes"] \
        == tstats.pipelined_tile_bytes
    assert sum(r.name == "oocore.chunk" for r in trecs) == tstats.chunks


@pytest.mark.parametrize("D", [1, 2, 4])
def test_prepare_runtime_counts_remap_exchange_as_reference(D):
    tkw = dict(shape=(60, 45, 30), nnz=800, seed=2)
    fkw = dict(m_bounds=(2, 8), g_bounds=(8, 64))
    tft = tfly.build_flycoo(tten.random_sparse_tensor(**tkw), D, **fkw)
    jft = jfly.build_flycoo(jten.random_sparse_tensor(**tkw), D, **fkw)
    with ocnt.use_registry() as treg:
        tdist.prepare_runtime(tft, 16)
    with jcnt.use_registry() as jreg:
        jdist.prepare_runtime(jft, 16)
    assert _counted(treg.snapshot(), ("remap.",)) \
        == _counted(jreg.snapshot(), ("remap.",))
    assert treg.get("remap.transitions") == 3


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_locality_lexsort_counts_perms_as_reference(ordering):
    rng = np.random.default_rng(7)
    idx_in = rng.integers(0, 5000, (400, 2)).astype(np.int32)
    prim = rng.integers(0, 9, 400)
    with ocnt.use_registry() as treg:
        tperm = tord.locality_lexsort(torch.from_numpy(idx_in), ordering,
                                      primaries=(torch.from_numpy(prim),),
                                      frow_tile=128)
    with jcnt.use_registry() as jreg:
        jperm = jord.locality_lexsort(idx_in, ordering, primaries=(prim,),
                                      frow_tile=128)
    np.testing.assert_array_equal(tperm.numpy(), jperm)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.get("reorder.perms", ordering=ordering) \
        == (0 if ordering == "none" else 1)


# ---------------------------------------------------------------------------
# ops.step_traffic_bytes / ops.timed_device_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gather_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nmodes", [3, 4])
@pytest.mark.parametrize("rank", [1, 16, 100, 128, 129, 300])
def test_step_traffic_bytes_equals_reference_at_128(rank, nmodes,
                                                    gather_dtype):
    kw = dict(cap=12345, nmodes=nmodes, rank=rank, rows_cap=968,
              gather_dtype=gather_dtype)
    assert tops.step_traffic_bytes(rank_multiple=128, **kw) \
        == jops.step_traffic_bytes(**kw)
    # The port's own padding (16) models fewer gathered bytes at rank 16.
    k, gi = nmodes - 1, 2 if gather_dtype == "bfloat16" else 4
    rpad = -(-rank // 16) * 16
    assert tops.step_traffic_bytes(**kw) == (
        12345 * (8 + 4 * k) + 12345 * k * rpad * gi + 968 * rpad * 4)


def test_step_traffic_bytes_rejects_unknown_dtype():
    with pytest.raises(ValueError, match="gather_dtype"):
        tops.step_traffic_bytes(cap=1, nmodes=3, rank=16, rows_cap=8,
                                gather_dtype="float16")


@pytest.mark.parametrize("backend", ["auto", "pallas_fused_gather",
                                     "pallas_fused_gather_stream", "ref"])
def test_timed_device_step_span_counters_and_output(backend):
    idx, val, valid, factors = _sorted_case((40, 300, 170), 500, 16, 0,
                                            seed=4)
    args = (torch.from_numpy(idx), torch.from_numpy(val),
            torch.from_numpy(valid), [torch.from_numpy(f) for f in factors])
    kw = dict(mode=0, rows_cap=40, blk=32, tile_rows=8, backend=backend)
    want = tops.mttkrp_device_step(*args, **kw)
    tracer = otr.Tracer()
    with ocnt.use_registry() as reg, otr.use_tracer(tracer):
        got = tops.timed_device_step(*args, **kw)
    assert torch.equal(got, want)
    model_b = tops.step_traffic_bytes(cap=len(val), nmodes=3, rank=16,
                                      rows_cap=40)
    (span,) = [r for r in tracer.records if r.name == "ops.device_step"]
    assert span.args == {"backend": backend, "mode": 0, "ordering": "none"}
    assert span.self_counters[
        f"ops.step.model_bytes{{backend={backend}}}"] == model_b
    assert reg.get("ops.step.model_bytes", backend=backend) == model_b
    assert reg.get("ops.step_s", backend=backend) > 0
    # ops.step_s is emitted after the span closes, as in the reference.
    assert not any(k.startswith("ops.step_s") for k in span.counters)

"""Port parity: ``python -m repro_torch.oocore`` and ``python -m
repro_torch.reorder`` against ``repro.oocore`` / ``repro.reorder``.

* both smokes pass with ``--device cpu`` (the plain versions) and refuse
  to run without a card by default;
* on the smokes' own inputs, with the reference's geometry passed in
  (``frow_tile=128, rank_slab=128, rank_multiple=128``) and the
  reference's budgets, the port's executor and predictor count exactly
  what the reference's do (chunks, windows, scheduled, distinct and
  pipelined bytes), and the outputs agree at rtol 2e-5 with an atol of
  1e-5 of the output's largest magnitude (fp32 sums in another order than
  the Pallas interpreter's; at R=256 a row of the oocore smoke cancels to
  ~0.3 from terms of ~30, as ``chip_smoke.compare`` scales its atol).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.oocore import executor as jex  # noqa: E402
from repro.oocore import planner as jp  # noqa: E402
from repro_torch.oocore import __main__ as oocore_cli  # noqa: E402
from repro_torch.oocore import executor as tex  # noqa: E402
from repro_torch.oocore import planner as tp  # noqa: E402
from repro_torch.reorder import ORDERINGS  # noqa: E402
from repro_torch.reorder import __main__ as reorder_cli  # noqa: E402
from repro_torch.reorder import reorder_stream  # noqa: E402

JAX_GEOMETRY = dict(frow_tile=128, rank_slab=128, rank_multiple=128)
RTOL, ATOL_FRAC = 2e-5, 1e-5
COUNTED = ("chunks", "num_blocks", "nnz", "window_tiles",
           "chunk_block_counts", "scheduled_tile_bytes",
           "distinct_tile_bytes", "pipelined_tile_bytes",
           "index_stream_bytes", "presort_scheduled_tile_bytes",
           "presort_distinct_tile_bytes")
# The reference smokes' budgets: oocore's fixed 2000 bytes, reorder's 24
# blocks of 8-tile windows at its own stream_chunk_bytes.
JAX_OOCORE_BUDGET = 2000


@pytest.mark.parametrize("cli", [oocore_cli, reorder_cli],
                         ids=["oocore", "reorder"])
def test_smoke_passes_on_cpu(cli, capsys):
    assert cli.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "smoke passed" in out and "FAIL" not in out


@pytest.mark.parametrize("cli", [oocore_cli, reorder_cli],
                         ids=["oocore", "reorder"])
def test_smoke_needs_a_card_by_default(cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([])


def test_oocore_budget_forces_chunks_at_port_geometry():
    idx, _, valid, _, rows_cap = oocore_cli.inputs()
    budget = oocore_cli.chunk_budget(idx, valid, rows_cap)
    pred = tp.predict_stream_traffic(
        torch.from_numpy(idx), torch.from_numpy(valid), mode=oocore_cli.MODE,
        rows_cap=rows_cap, blk=oocore_cli.BLK, tile_rows=oocore_cli.TILE_ROWS,
        rank=oocore_cli.RANK, factor_rows=oocore_cli.in_rows(),
        max_chunk_bytes=budget)
    assert pred.chunks > oocore_cli.MIN_CHUNKS


def _assert_out_close(tout, jout):
    want = np.asarray(jout)
    np.testing.assert_allclose(tout.numpy(), want, rtol=RTOL,
                               atol=ATOL_FRAC * np.abs(want).max())


def _assert_counted_equal(ts, js):
    for field in COUNTED:
        assert getattr(ts, field) == getattr(js, field), field


def test_oocore_smoke_counts_equal_reference():
    idx, val, valid, factors, rows_cap = oocore_cli.inputs()
    kw = dict(mode=oocore_cli.MODE, rows_cap=rows_cap, blk=oocore_cli.BLK,
              tile_rows=oocore_cli.TILE_ROWS,
              max_chunk_bytes=JAX_OOCORE_BUDGET)
    jout, js = jex.mttkrp_out_of_core(idx, val, valid, factors, **kw)
    tout, ts = tex.mttkrp_out_of_core(idx, val, valid, factors, device="cpu",
                                      **kw, **JAX_GEOMETRY)
    _assert_counted_equal(ts, js)
    assert ts.chunks >= oocore_cli.MIN_CHUNKS
    _assert_out_close(tout, jout)
    pkw = dict(mode=oocore_cli.MODE, rows_cap=rows_cap, blk=oocore_cli.BLK,
               tile_rows=oocore_cli.TILE_ROWS, rank=oocore_cli.RANK,
               factor_rows=oocore_cli.in_rows(),
               max_chunk_bytes=JAX_OOCORE_BUDGET)
    tpred = tp.predict_stream_traffic(torch.from_numpy(idx),
                                      torch.from_numpy(valid), **pkw,
                                      **JAX_GEOMETRY)
    jpred = jp.predict_stream_traffic(idx, valid, **pkw)
    for field in ("num_blocks", "nnz", "window_tiles", "scheduled_tiles",
                  "distinct_tiles", "tile_bytes", "rank_slabs", "chunks"):
        assert getattr(tpred, field) == getattr(jpred, field), field


@pytest.mark.parametrize("ordering", ORDERINGS)
def test_reorder_smoke_counts_equal_reference(ordering):
    idx, val, valid, factors, rows_cap = reorder_cli.inputs()
    k = len(reorder_cli.SHAPE) - 1
    budget = 24 * jp.stream_chunk_bytes(reorder_cli.BLK, k, (8,) * k)
    kw = dict(mode=reorder_cli.MODE, rows_cap=rows_cap, blk=reorder_cli.BLK,
              tile_rows=reorder_cli.TILE_ROWS, max_chunk_bytes=budget,
              ordering=ordering)
    jout, js = jex.mttkrp_out_of_core(idx, val, valid, factors, **kw)
    tout, ts = tex.mttkrp_out_of_core(idx, val, valid, factors, device="cpu",
                                      **kw, **JAX_GEOMETRY)
    _assert_counted_equal(ts, js)
    assert ts.chunks >= reorder_cli.MIN_CHUNKS
    _assert_out_close(tout, jout)
    i2, m2 = torch.from_numpy(idx), torch.from_numpy(valid)
    if ordering != "none":
        i2, _, m2, _ = reorder_stream(
            i2, torch.from_numpy(val), m2, mode=reorder_cli.MODE,
            ordering=ordering, tile_rows=reorder_cli.TILE_ROWS,
            frow_tile=JAX_GEOMETRY["frow_tile"])
    pkw = dict(mode=reorder_cli.MODE, rows_cap=rows_cap, blk=reorder_cli.BLK,
               tile_rows=reorder_cli.TILE_ROWS, rank=reorder_cli.RANK,
               factor_rows=reorder_cli.in_rows(), max_chunk_bytes=budget,
               ordering=ordering)
    tpred = tp.predict_stream_traffic(i2, m2, **pkw, **JAX_GEOMETRY)
    assert tpred.scheduled_tile_bytes == ts.scheduled_tile_bytes
    assert tpred.distinct_tile_bytes == ts.distinct_tile_bytes
    assert tpred.window_tiles == ts.window_tiles
    assert tpred.chunks == ts.chunks

"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, measure.

Run from the root of a checkout on a machine with an H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. build the CUDA kernels from ``src/repro_torch/kernels/mttkrp/csrc``
     (one ``nvcc`` per source, started together), and measure the card's
     L2 read rate with the hand-written probe ``csrc/l2_probe.cu`` (the
     yardstick of every kernel's L2 bound);
  2. B1 (``fused_mttkrp_nmode_gather``) and B2 (``..._tiled``) against
     their plain PyTorch versions on random streams (K in {2,3}, R in
     {16,256}, blk=512, tile_rows=8): allclose, B1 == B2 bitwise, and a
     repeated launch bitwise equal;
  3. ``[stream-kernels]``: B6 (``fused_mttkrp_nmode_gather_stream``) on
     random streams (K in {2,3}, R in {16,64}, blk=128, tile_rows=8):
     against its plain version, B6 == B1 bitwise, a rerun bitwise equal,
     and a chunked out-of-core run with mid-tile splits bitwise equal to
     the single pass; with the ring's stage count;
  4. ``[fused-kernels]``: B3 (``fused_mttkrp_nmode``), B4
     (``fused_mttkrp_nmode_tiled``) and B5 (``segment_accumulate``) on
     random streams (K in {2,3}, R in {16,256}, and 1024 for B5): against
     their plain versions, B4 == B3 == B1 and B5 == B1 bitwise, reruns
     bitwise, ``out_init`` kept and added, B5 beside ``index_add_``;
  5. the main path at nell-2 scale: ``cp_als_distributed`` (R=16,
     ``backend="auto"``, which must launch B1 only, 3 sweeps) on a
     synthetic stand-in of FROSTT nell-2 with its real shape and nonzero
     count, then the tiled path (R=256, B2, 1 sweep); launch counts,
     fits, and each mode's sweep-0 kernel output against the plain
     version on the same inputs, with times beside the bounds;
  6. ``[fused-main]`` and ``[auto]`` on the same tensor:
     ``cp_als_distributed`` with ``pallas_fused`` (B3),
     ``pallas_fused_tiled`` (B4) and ``pallas`` (B5), R=16, 2 sweeps each,
     fits equal to the auto run's; per mode each kernel at its path's
     inputs (and B4 at R=32 in two slabs) against its plain version and
     B1 bitwise, with times, bounds, ``index_add_`` for B5 and peak
     memory; the ladder's choice per mode at R in {16,256}, blk in
     {64,512}; a profiled ``pallas`` sweep;
  7. ``[stream-main]``, the out-of-core path on the same tensor (R=16,
     blk=64): per mode ``mttkrp_out_of_core`` with Morton order in >= 5
     chunks, bitwise equal to B1 on the same permuted stream, predicted
     traffic equal to the counted; then ``cp_als_distributed`` with the
     stream backend and with B1, Morton order, 2 sweeps each: equal fits;
     per mode B6 single pass with its stage count, and on mode 0 at
     ``frow_tile`` 4 and 2 (findings: fewer copied bytes per used row);
  8. a 4-mode tensor (``frostt_like("enron")``), kernel vs plain per mode;
  9. exact recovery of a dense rank-4 tensor (fit > 0.999);
  10. ``[bf16-kernels]``: the bf16 variants of B1, B2, B3, B4 (K in
      {2,3}, R in {16,256}) and B6 (R in {16,64}) on random streams, bf16
      factor operands with fp32 sums: against their plain versions,
      B2 == B3 == B4 == B6 == B1 bitwise, reruns bitwise, and a chunked
      bf16 out-of-core run with mid-tile splits == its single pass;
  11. ``[bf16-main]`` on the nell-2 stand-in at R=16:
      ``cp_als_distributed`` with ``pallas_fused_gather_bf16`` (2 sweeps,
      the bf16 B1 only), per mode the bf16 mode steps of B2 (R=256, two
      slabs), B3, B4 (``mttkrp_device_step``) and the bf16 out-of-core run
      (B6, Morton, blk=64), then each bf16 kernel at its path's inputs
      against its
      plain version and the bf16 B1 bitwise, timed beside the fp32
      kernel on the same inputs, with HBM and L2 bounds at bf16 bytes;
      for B1-bf16 also the design that ran (the narrow kernel at R=16),
      its factor rows in flight an SM as reckoned from the launch shape
      (not measured; the log line only), the first bf16 kernel (a column
      a lane, built from ``bench_torch/gather_mttkrp_designs.cu``) timed
      in turns with it on the same inputs (bitwise equal),
      and the slots the last tile's CTA walks before and after the cut
      at its last live block (the card's cut == the plain one, within
      one block of the run's last live slot); a profiled bf16 sweep;
  12. ``[bf16-fit]``: CP-ALS (B1, seed 1, tol 0) in fp32 and in bf16 on a
      generated low-rank tensor: both fit traces and their gaps;
  13. ``[dist-main]``, Dynasor on D=4 workers in one process
      (``LocalWorkers``) on the nell-2 stand-in at R=16: host time of
      ``build_flycoo(t, 4)`` and ``prepare_runtime``, the LPT loads per
      worker and mode; ``cp_als_distributed`` with ``auto`` (B1 only, 12
      launches per sweep, 3 sweeps), sweep ms on the host clock and CUDA
      events, a profiled sweep; B1 against its plain version on every
      worker's sweep-0 inputs (row offset d*rows_cap) and mode;
      ``make_spmttkrp_all_modes`` at D=4 against D=1 in natural row
      order, ``dropped == 0``; B1 == B2 == B3 == B4 == B5 == B6 bitwise
      at D=4 (row offsets), each worker's mode step ms per backend;
      the paper's Fig. 9 paths (remap, no remap, even-split baseline):
      outputs, ms and the bytes each hands to the collectives;
  14. ``[dist-fit]``: CP-ALS at D=4 on the ``[bf16-fit]`` tensor against
      that phase's fp32 D=1 fits (5 sweeps, gap <= 1e-4);
  15. ``[resilience]`` on the nell-2 stand-in (D=1, R=16, ``auto``, 3
      sweeps): the stepped driver with a ``RetryPolicy`` and a ``Tracer``
      (fits within 1e-5 of ``[main]``'s, B1 only, its Chrome trace
      validated, span ms per mode and phase); the same call under three
      injected faults in sweep 0 (a transient and a resource fault at
      ``ops.kernel``, so one mode step runs B2, a transient one at
      ``distributed.remap``): all fired, counted and handled, factors and
      fits bitwise the fault-free run's, the rung of each mode printed;
      2 sweeps checkpointed (``keep=1``) and resumed to 3: bitwise, bytes
      and seconds per save and restore; one profiled sweep of each driver
      (wall, kernels, idle share); a chunked out-of-core step with a
      replayed chunk, bitwise; ``python -m repro_torch.resilience --device
      cuda`` in this process;
  16. ``[obs]`` (ROADMAP A11): the counted baseline workload
      (``repro_torch.obs.baseline.collect``, D=4, ``auto``, plus the
      forced-multichunk out-of-core step over three orderings) on the
      card, its counters equal to the committed
      ``bench_torch/obs/BASELINE_counters.json`` key for key and its
      launches equal to its dispatch and chunk counts; its Chrome trace
      validated with the spans ``sweep, mode, mttkrp, solve, remap,
      oocore.mode_step, oocore.chunk``; the steady-state profiler
      (``python -m repro_torch.obs.prof run``, 3 repeats, 1 warmup, in a
      fresh process) with each phase's median and MAD and the roofline
      rows, gated against ``bench_torch/obs/PROF_baseline.json``; ``ops.timed_device_step`` per mode on the
      nell-2 stand-in (``auto`` = B1, R=16), bitwise the ``auto`` sweep's
      mode steps, with its modeled bytes, seconds and rate; then
      ``[auto-stream]``: ``auto`` at blk=64 on a tensor with FROSTT
      flickr's mode sizes (power-law, 20 M draws), whose factors exceed
      L2, must take the stream rung (B6) on every mode, counted by
      ``dispatch.backend`` exactly as launched, with factors and fits
      bitwise the forced-B1 run's, sweep ms on CUDA events, beside the
      same run with the last tile's walk not cut (bitwise equal), B6 ms
      per launch and peak memory;
  17. ``[tune]`` (ROADMAP A12): ``repro_torch.tune.calibrate`` over the
      port's quick grid on the card (every backend, the hand-written
      kernels among them, each case's trailing all-padding blocks
      counted), the table saved under ``build/tune/``; per key the
      static, calibrated and oracle backends with their regret, every key
      consistent; ``cp_als_distributed(table=)`` on the nell-2 stand-in
      (R=16, ``auto``, 2 sweeps): each mode's plan, sweep ms beside
      [main]'s, each tuned mode step against the plain ``index_add_``
      step and bitwise the static configuration's where the plan is it;
      the static and calibrated rungs at ``[auto-stream]``'s keys;
  18. ``[lowering]`` (ROADMAP A13), right after the build: the
      compile-validation tier over the full grid
      (``repro_torch.kernels.mttkrp.lowering.run(FULL_GEOMETRIES)``, 9
      backends x 7 geometries): one line per point (its geometry verdict,
      the sm_90a build with the backend's entry point, the launch plan
      against the card's opt-in shared memory, registers and spill bytes)
      and one per kernel of the ptxas report; a point the geometry rules
      call launchable that fails the build or the plan fails the phase,
      and every verdict must equal ``oocore.planner.backend_fits``;
  19. ``[cli]``: ``python -m repro_torch.oocore`` and ``python -m
      repro_torch.reorder`` (their ``main([])``) on the card, each
      returning 0 and launching B6 and B1;
  20. ``[examples]``: ``examples/torch_quickstart.py``,
      ``examples/torch_cp_decompose_distributed.py``,
      ``examples/torch_lm_serve.py`` and ``examples/torch_lm_train.py``
      (its resume demo, 200 steps) (their ``main()``) on the card with
      their asserts; the fits and the Dynasor and all-reduce baseline
      times (CUDA events, 8 workers on one card);
  20b. ``[dryrun]`` (ROADMAP A15 (3) (d3)): ``repro_torch.launch.dryrun``
      on meta tensors, no card memory (``memory_allocated`` equal before
      and after): predicted FLOPs, bytes, peaks and roofline bounds of
      ``[serve]``'s and ``[train]``'s steps on the host mesh, printed
      beside what those phases measure once they have run; and the
      production 16 x 16 grid's ``decode_32k`` / ``long_500k`` cells in
      ``DRYRUN_PROCESSES`` processes, every runnable one ``ok`` and every
      skip with the reference's reason;
  21. ``[serve]`` (ROADMAP A15, slice 1): the LM serving path at full
      width: phi3-mini-3.8b with every published field (32 layers,
      d_model 3072, 32 heads of 96, d_ff 8192, vocab 32064; fp32
      parameters from the port's ``init_params``, seed 0, on the card,
      15.3 GB), ``ServeSession.generate`` on 8 seeded 1024-token prompts
      for 32 new tokens, greedy twice and once at temperature 0.8;
      prefill ms, decode ms per token, tokens/s and peak memory; checks:
      prefill's last-position logits against ``forward``'s (2e-2 of
      max|logits|), a decode step against teacher-forced ``forward`` at
      the next position (3e-2), tokens in ``[0, vocab)``, finite logits,
      the two greedy runs equal, ``serve.tokens == 8 x 32``; a decode
      step on CUDA events, and the per-call fp32 -> bf16 weight cast of
      one decode step timed alone beside its bytes bound (the prefill's
      and the decode step's op-by-op profiles, and a train step's, are
      ``bench_torch/lm_profile.py``'s). Its numbers
      are one JSON line ``{"serve": {...}}``: the path has no kernel of
      its own (the reference computes it outside any Pallas kernel);
  21b. ``[serve-moe]`` and ``[serve-ssm]`` (ROADMAP A15 (3), first
      part): the same phase for qwen2-moe-a2.7b (24 layers, 60 routed
      experts padded to 64, top-4 and 4 shared, 60.6 GB of fp32
      parameters) and mamba2-370m (48 SSD layers, tied embeddings), every
      published field, with ``[serve]``'s traffic and checks. For the
      MoE the pairs dropped (prefill, forward, decode step; summed over
      layers) and the distinct experts routed per layer; where prefill or
      forward drops a pair, their check is a finding and reruns at the
      smoke configs' drop-free capacity factor (16); the decode step is
      held to teacher forcing with the forward's routes of the new
      position replayed into its routers, and also run on its own routes
      (a finding: a bf16 ulp can move a top-k choice), counting the
      (layer, request) routes that differ; the bounds count the MoE's
      router, shared experts and the distinct experts routed, mamba's
      projections and the SSD's fp32 products, and the SSM state. Each
      frees its tensors before the next phase (``memory_allocated`` is
      logged); its numbers are one JSON line ``{"serve_moe": {...}}`` /
      ``{"serve_ssm": {...}}``;
  21c. ``[serve-int8]`` (ROADMAP A15 (3) (c)), inside ``[serve]`` on its
      weights: phi3-mini-3.8b with ``kv_cache_dtype="int8"``, the same
      prompts greedy twice (bitwise reruns); prefill's logits bitwise the
      bf16 cache's; a decode step against teacher-forced ``forward``
      within the reference's int8 bounds (0.12 of max|logits|, top-1
      agreement >= 0.5); prefill / decode ms, peak memory and the cache's
      bytes against the bf16 cache's; the int32 sums of
      ``attention.int8_contract`` exact on the card (2048 slots of
      ±127 x 127 against int64; at 2 layers, full width, a decode step's
      QK and PV sums over a 1056-slot cache equal the CPU's element for
      element); one JSON line ``{"serve_int8": {...}}``;
  21d. ``[moe-owner]`` (ROADMAP A15 (3) (d1), (d2)), inside
      ``[serve-moe]`` on its weights after the gather session is freed:
      qwen2-moe-a2.7b served under a ``("data", "model")`` mesh of
      ``(1, 4)`` (``ServeSession(mesh=)``: the owner-computes dispatch,
      4 owners of 16 experts), greedy twice (bitwise), its times beside
      the gather path's; prefill and a decode step against the gather
      path's with its routes replayed (per-layer drops equal, logits in
      ``[serve]``'s tolerances), the owner path's own routes a finding
      past layer 0; psum bytes; one MoE layer's routed sum bitwise the
      gather path's but on the tokens whose rows the owners group
      otherwise; at 2 layers, full width, fp32: routes and drops equal
      the gather path's, gradients against the gather path's and the
      CPU's (1e-5 / 1e-4), and one ``make_train_step(mesh=,
      rules=rules_for(train_4k), param_shardings=)`` step against the
      step without a mesh; one JSON line ``{"moe_owner": {...}}``;
  22. ``[train]`` (ROADMAP A15, slice 2), after ``[serve]``'s tensors are
      freed: phi3-mini-3.8b with every published field trained on the
      card through ``models.steps.make_train_step`` (fp32 parameters from
      ``init_params``, seed 0; AdamW with fp32 moments; remat ``nothing``;
      ``cosine_schedule(1e-3, 2, 10)``), 3 steps of ``SyntheticLMData(
      vocab=32064, seq_len=1024, global_batch=8, seed=0)`` in two
      microbatches of 4 x 1024 (the ``train_4k`` shape's 4096-token
      sequences cut to 1024); per step the loss, grad_norm and ms (host
      clock, device fenced), the forward+backward and optimizer ms (CUDA
      events), tokens/s, peak memory, model FLOP/s against the bf16 peak
      and the step's bound; checks: finite loss, grad_norm, parameters
      and moments, ``step == count == 3``, every leaf changed; at full
      width and 2 layers with fp32 activations ``grad_accum=2`` == 1 and
      remat ``nothing`` == ``dots`` == off within 1e-5 of each leaf's
      max|g|; ``train("qwen3-32b", smoke=True, steps=20, ckpt_dir=...,
      ckpt_every=5)`` preempted at step 10 and resumed, its losses within
      1e-4 of the uninterrupted run's. Its numbers are one JSON line
      ``{"train": {...}}``: training adds no kernel (no Pallas kernel of
      the reference, nor a backward of one, lies on it);
  22b. the families beyond the dense one (ROADMAP A15 (3) (a) + (b),
      ``phase_other_families``), each phase with the card's name and power
      limit beside its numbers, its own seconds, its parameter bytes
      (``spec_bytes``) before it allocates, and its bound:
      ``[train-ssm]`` mamba2-370m at full width and depth (48 SSD layers,
      chunk 256) trained as ``[train]`` is, with the 2-layer
      ``grad_accum`` / remat checks; ``[train-moe]`` qwen2-moe-a2.7b at
      full width cut to 4 of its 24 layers (the bytes of all 24 with
      AdamW are logged), capacity factor 1.25, ``moe_aux`` per step and
      the pairs each layer drops, and jamba-1.5-large-398b's smoke config
      (bf16 parameters, Adafactor, bf16 gradient accumulator) one step on
      the card against the CPU, with the CPU tests' bounds;
      ``[serve-encdec]`` seamless-m4t-large-v2 at full width and depth
      (24 + 24 layers) with ``[serve]``'s traffic and checks and the
      ``frames`` of ``repro.launch.serve.main`` (8 x 1024 x 1024,
      ``default_rng(0)``),
      then ``[train-encdec]`` on its weights; ``[serve-vlm]``
      llama-3.2-vision-11b at full width and depth (40 layers, 1601 image
      tokens of width 7680 a request) and ``[train-vlm]`` cut to 10 of
      its 40 layers, every ``xattn`` gate set to ``XATTN_GATE`` (0.5; at
      its published 0 a cross-attention layer adds nothing). Every phase
      also runs its step at 2 layers, full width and fp32 activations on
      the card against the CPU (``_serve_card_vs_cpu``: logits within
      1e-4 of max|logits|; ``_train_card_vs_cpu``: the loss within 1e-5
      relative and each leaf's gradient within 1e-4 of its max|g|; the
      gradients only, not clip and the optimizer's update, which the
      jamba smoke step and ``tests/test_torch_gpu.py``'s whole steps of
      the smoke configs hold). Their numbers are one JSON line each
      (``{"train_ssm": ...}`` ... ``{"train_vlm": ...}``);
  23. one JSON line with all six kernels and the five bf16 variants
      (``launches`` from the D=1 main paths, ``dist_main_launches`` from
      ``[dist-main]``, ``resilience_launches`` from ``[resilience]``,
      ``obs_launches`` from ``[obs]``'s counted run,
      ``auto_stream_launches`` from ``[auto-stream]``, ``tune_launches``
      from ``[tune]``'s calibration, ``tune_main_launches`` from its
      tuned CP-ALS run, ``cli_launches`` from ``[cli]``,
      ``examples_launches`` from ``[examples]``), the card's name and
      power limit, and the last line ``{"ok": true, "device": {...}}``.

B1, B2 and B6 lines carry, beside the HBM bound, their L2 bytes (the
factor rows B1/B2 gather, the factor tiles B6 copies), the rate they
reach, and the L2 bound: those bytes over the measured L2 read rate.
B3 and B4 lines carry their ring (stages x slots per stage), the HBM rate
their bytes take and their share of the HBM bound. bf16 variants count
their factor bytes at 2 per element.

Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))



def hw_peak(key: str) -> float:
    """One of the H100 SXM's published peaks (NVIDIA data sheet, at the
    full 700 W power limit) in ``repro_torch.launch.mesh.HW``: ``hbm_bw``
    (HBM3 bytes/s), ``peak_flops_bf16`` (dense bf16 tensor-core FLOP/s),
    ``peak_flops_fp32`` (fp32 without tensor cores)."""
    from repro_torch.launch.mesh import HW
    return HW[key]


# The card's L2 read rate (bytes/s), measured by phase_build.
L2_BYTES_PER_S = None
# Host ms of each sweep of [main]'s static auto run (phase_main).
MAIN_SWEEP_MS: list = []
# rtol, and atol as a fraction of max|plain|: the kernel sums in another
# fp32 order than index_add_.
RTOL, ATOL_FRAC = 1e-5, 1e-5
BLK, TILE_ROWS = 512, 8

# The stream path's geometry: 8-row output tiles, 8-row x 16-column factor
# tiles (the port's defaults), 128-slot blocks on the random streams. The
# nell-2 phase takes 64-slot blocks: its Morton windows (~64 tiles per
# mode) then need ~74 KB of shared memory, so three CTAs share an SM
# (measured against 128-slot blocks in PERF.md).
STREAM_BLK, STREAM_TILE_ROWS = 128, 8
MAIN_STREAM_BLK = 64

# [serve]: the LM serving path at phi3-mini-3.8b's published widths.
SERVE_ARCH = "phi3-mini-3.8b"
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS = 8, 1024, 32
# The reference's own tolerances at bf16 activations
# (tests/test_archs_smoke.py): prefill vs forward 2e-2, decode vs teacher
# forcing 3e-2, in its form allclose(rtol=tol, atol=tol); here atol is
# tol · max|logits|, so an element may differ by tol · (max|logits| +
# |its logit|), up to twice tol · max|logits| at the largest logit.
SERVE_TOL_PREFILL, SERVE_TOL_DECODE = 2e-2, 3e-2
# [serve-ssm] at fp32 activations, where decode and forward run every
# operation in one dtype: max abs err / max|logits| at most this.
SERVE_TOL_FP32 = 1e-4
# [serve-moe] / [serve-ssm]: the MoE and SSM families' serving paths at
# their published widths and full depth, with [serve]'s traffic and checks.
SERVE_MOE_ARCH = "qwen2-moe-a2.7b"
SERVE_SSM_ARCH = "mamba2-370m"
# [serve-int8]: [serve]'s arch and traffic with the int8 KV cache, on
# [serve]'s weights; a decode step against teacher-forced forward is held
# to the reference's own int8 bounds (tests/test_perf_levers.py:54-56):
# max abs err / max|logits| <= 0.12 and top-1 agreement >= 0.5.
INT8_TOL, INT8_TOP1 = 0.12, 0.5
# [moe-owner]: [serve-moe]'s arch on its weights under a ("data",
# "model") mesh of this shape: 4 expert owners (the owner-computes
# dispatch, models.moe.moe_apply_owner) and one token shard.
OWNER_MESH = (1, 4)
# The smoke configs' drop-free capacity factor: [serve-moe]'s consistency
# check reruns at it when the published 1.25 drops a pair (the 1024-token
# prefill and the 1025-token forward have 640 and 641 slots an expert, so
# they would drop different pairs).
DROP_FREE_CAPACITY = 16.0

# [train]: the LM training path at phi3-mini-3.8b's published widths.
TRAIN_ARCH = "phi3-mini-3.8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 8, 1024, 2, 3
# The families beyond the dense one (ROADMAP A15 (3) (a) + (b)): trained
# as [train] is, the MoE one cut to TRAIN_MOE_LAYERS of its 24 layers
# (all 24 with AdamW: ~242 GB), the vision one to TRAIN_VLM_LAYERS of its
# 40; served at full depth as [serve] is.
TRAIN_SSM_ARCH = "mamba2-370m"
TRAIN_MOE_ARCH, TRAIN_MOE_LAYERS = "qwen2-moe-a2.7b", 4
HYBRID_ARCH = "jamba-1.5-large-398b"
ENCDEC_ARCH = "seamless-m4t-large-v2"
VLM_ARCH, TRAIN_VLM_LAYERS = "llama-3.2-vision-11b", 10
# The xattn layers' tanh gate: published init 0, which makes a
# cross-attention layer add nothing and get no gradient; every vlm check
# opens it to this.
XATTN_GATE = 0.5
# Card vs CPU at 2 layers and fp32 activations, the GPU and CPU tests'
# tolerances: max abs err / max|logits| for serving and max error / max|g|
# per leaf for training (1e-4); the loss and its terms, relative (1e-5).
# The hybrid smoke step: also parameters within 2.5 lr_t and all but 0.1%
# of their elements within 1e-5 of max|p|.
CARD_CPU_TOL, CARD_CPU_STEP_TOL = 1e-4, 1e-5
# Except mamba's per-head A_log and dt_bias, whose gradients each sum a
# million products with heavy cancellation: at mamba2-370m's widths (2
# layers, 2 x 256 tokens) the CPU's own 1- against 8-thread order moves
# them by 4.8e-5 / 2.4e-5 of max|g|, grad_accum 1 against 2 on the card
# by 6.6e-5 / 3.0e-5, and the card against the CPU by 9.6e-5 / 4.6e-5
# (bench_torch/ssm_grad_order.py, NVIDIA H100 80GB HBM3, 700 W): 1e-4 is
# within that noise, 1e-3 is not.
CARD_CPU_LEAF_TOL = {"A_log": 1e-3, "dt_bias": 1e-3}
# grad_accum 2 vs 1 and the remat policies at full width and 2 layers:
# the CPU tests' tolerance, relative to each leaf's max|g|; the resumed
# smoke run's losses against the uninterrupted run's (the embedding's
# backward adds with atomics, so the two are not bitwise).
TRAIN_GRAD_TOL, TRAIN_RESUME_TOL = 1e-5, 1e-4

CSRC = "src/repro_torch/kernels/mttkrp/csrc/"
SOURCE = {
    "fused_mttkrp_nmode_gather": CSRC + "gather_mttkrp.cu",
    "fused_mttkrp_nmode_gather_tiled": CSRC + "gather_mttkrp.cu",
    "fused_mttkrp_nmode": CSRC + "fused_mttkrp.cu",
    "fused_mttkrp_nmode_tiled": CSRC + "fused_mttkrp.cu",
    "segment_accumulate": CSRC + "fused_mttkrp.cu",
    "fused_mttkrp_nmode_gather_stream": CSRC + "gather_stream_mttkrp.cu",
}
REPLACES = {
    "fused_mttkrp_nmode_gather": "src/repro/kernels/mttkrp/kernel.py:632",
    "fused_mttkrp_nmode_gather_tiled":
        "src/repro/kernels/mttkrp/kernel.py:728",
    "fused_mttkrp_nmode": "src/repro/kernels/mttkrp/kernel.py:429",
    "fused_mttkrp_nmode_tiled": "src/repro/kernels/mttkrp/kernel.py:516",
    "segment_accumulate": "src/repro/kernels/mttkrp/kernel.py:338",
    "fused_mttkrp_nmode_gather_stream":
        "src/repro/kernels/mttkrp/kernel.py:868",
}
# The bf16 variants: the same TPU kernels on bf16 factor operands (the
# reference's pallas_fused_bf16 / gather_dtype="bfloat16"), the same
# sources, counted apart (each wrapper's ``launches_bf16``). B5 has none:
# its contribution is fp32 on every path.
BF16 = "[bf16]"
for _name in ("fused_mttkrp_nmode_gather", "fused_mttkrp_nmode_gather_tiled",
              "fused_mttkrp_nmode", "fused_mttkrp_nmode_tiled",
              "fused_mttkrp_nmode_gather_stream"):
    SOURCE[_name + BF16] = SOURCE[_name]
    REPLACES[_name + BF16] = REPLACES[_name]
# The backend name of each kernel, and the wrapper whose count it keeps.
BACKEND_OF = {
    "fused_mttkrp_nmode_gather": "pallas_fused_gather",
    "fused_mttkrp_nmode_gather_tiled": "pallas_fused_gather_tiled",
    "fused_mttkrp_nmode": "pallas_fused",
    "fused_mttkrp_nmode_tiled": "pallas_fused_tiled",
    "segment_accumulate": "pallas",
    "fused_mttkrp_nmode_gather_stream": "pallas_fused_gather_stream",
}


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def gpu_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_bound_ms(operands, *, rows_cap: int, tile_rows: int,
                    scheds=()) -> tuple[float, str]:
    """Least time for one kernel call: max(bytes / HBM rate, flops / peak).

    Counts what this run's data needs. Bytes: for each nonzero slot
    (value != 0) its value, K indices and local row; the factors once;
    the stream kernel's tile schedules once; the per-tile block starts;
    the output written once. Padding slots need no index or row read.
    Operations: K multiplies and one add per column of each nonzero slot.
    """
    vals, idx_stream, factors, _, _ = operands
    rank, k = factors[0].shape[1], len(factors)
    nnz = int((vals != 0).sum())
    nbytes = nnz * (4 + 4 * k + 4)
    nbytes += sum(f.numel() * f.element_size() for f in factors)
    nbytes += sum(s.numel() * s.element_size() for s in scheds)
    nbytes += (rows_cap // tile_rows + 1) * 4 + rows_cap * rank * 4
    flops = nnz * rank * (k + 1)
    t_bytes = nbytes / hw_peak("hbm_bw") * 1e3
    t_ops = flops / hw_peak("peak_flops_fp32") * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    """max(bytes / HBM rate, flops / fp32 peak) in ms, and which bounds."""
    t_bytes = nbytes / hw_peak("hbm_bw") * 1e3
    t_ops = flops / hw_peak("peak_flops_fp32") * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_hbm_bytes(nnz: int, rank: int, k: int, *, rows_cap: int,
                    tile_rows: int, itemsize: int = 4) -> int:
    """Bytes one call of B3/B4 (``k`` pre-gathered rows) or, with ``k=0``,
    of B5 (one contribution row) must move, on the ``nnz`` slots that hold
    a nonzero: B3 reads per slot its value, local row and K rows of
    ``rank`` elements of ``itemsize`` bytes (2 for its bf16 variant); B5
    reads the local row and one fp32 row. Both read the per-tile block
    starts and write the fp32 output once."""
    per_slot = 4 + (4 + itemsize * k * rank if k else 4 * rank)
    return nnz * per_slot + (rows_cap // tile_rows + 1) * 4 \
        + rows_cap * rank * 4


def fused_bound_ms(nnz: int, rank: int, k: int, *, rows_cap: int,
                   tile_rows: int, itemsize: int = 4) -> tuple[float, str]:
    """Least time for one call of B3/B4 or B5 (:func:`fused_hbm_bytes`;
    B3 does K multiplies and one add per column of a nonzero slot, B5 one
    add)."""
    return bound_ms(fused_hbm_bytes(nnz, rank, k, rows_cap=rows_cap,
                                    tile_rows=tile_rows, itemsize=itemsize),
                    nnz * rank * max(k + 1, 1))


def fused_ring_fields(pre, ms: float, *, nnz: int, rows_cap: int,
                      tile_rows: int, slab: int | None = None) -> str:
    """B3/B4's ring (stages x slots per stage, the wrapper's choice), the
    HBM rate its bytes take in ``ms`` and the share of its HBM bound."""
    from repro_torch.kernels.mttkrp import kernel as K
    k, rank, item = len(pre), pre[0].shape[1], pre[0].element_size()
    stages, slots = K.fused_ring(k, rank, tile_rows, rank_slab=slab,
                                 gather_itemsize=item)
    nbytes = fused_hbm_bytes(nnz, rank, k, rows_cap=rows_cap,
                             tile_rows=tile_rows, itemsize=item)
    bound, _ = fused_bound_ms(nnz, rank, k, rows_cap=rows_cap,
                              tile_rows=tile_rows, itemsize=item)
    return (f"ring {stages} stages x {slots} slots, HBM "
            f"{nbytes / ms / 1e9:.3f} TB/s, {bound / ms:.1%} of the HBM "
            "bound")


def l2_fields(l2_bytes: int, ms: float) -> tuple[float, float]:
    """``(TB/s reached, L2 bound ms)`` of ``l2_bytes`` moved in ``ms``."""
    return l2_bytes / ms / 1e9, l2_bytes / L2_BYTES_PER_S * 1e3


def l2_text(l2_bytes: int, ms: float) -> str:
    """``ms``, the L2 TB/s reached and the share of the L2 bound, for a
    kernel line."""
    tbps, bound = l2_fields(l2_bytes, ms)
    return (f"{ms:.3f} ms, {tbps:.3f} TB/s of L2, {bound / ms:.1%} of its "
            f"L2 bound {bound:.3f} ms")


def gather_l2_bytes(operands) -> int:
    """The factor rows B1/B2 gather through L2 in one call: K rows of the
    padded rank per slot that holds a nonzero, at the factors' itemsize."""
    vals, _, factors, _, _ = operands
    return (int((vals != 0).sum()) * len(factors) * factors[0].shape[1]
            * factors[0].element_size())


def stream_copy_bytes(vals, scheds, factors, blk: int,
                      frow_tile: int, rank_slab: int) -> int:
    """The factor-tile bytes B6 copies in one call, as the kernel decides
    them: per block holding a nonzero, per mode, each schedule entry that
    neither repeats entry 0 nor lies outside the factor, one slab wide,
    once per slab, at the factors' itemsize."""
    live = (vals.view(-1, blk) != 0).any(1)
    tiles = 0
    for s, f in zip(scheds, factors):
        s = s.long()
        keep = (s != s[:, :1]) & (s >= 0) & (s < f.shape[0] // frow_tile)
        keep[:, 0] = (s[:, 0] >= 0) & (s[:, 0] < f.shape[0] // frow_tile)
        tiles += int((keep & live[:, None]).sum())
    rank, item = factors[0].shape[1], factors[0].element_size()
    return tiles * frow_tile * rank_slab * item * (rank // rank_slab)


def _counter(name: str) -> tuple[str, str]:
    """(wrapper, attribute) that holds kernel ``name``'s launch count."""
    if name.endswith(BF16):
        return name[:-len(BF16)], "launches_bf16"
    return name, "launches"


def reset_counts():
    """Every kernel's launch count to 0, the bf16 variants' too."""
    from repro_torch.kernels.mttkrp import kernel as K
    for name in SOURCE:
        wrapper, attr = _counter(name)
        setattr(getattr(K, wrapper), attr, 0)


def counts() -> dict:
    from repro_torch.kernels.mttkrp import kernel as K
    return {name: getattr(getattr(K, _counter(name)[0]), _counter(name)[1])
            for name in SOURCE}


def require_only(launched: dict, name: str, want: int, what: str):
    """``name`` launched ``want`` times and no other kernel launched."""
    others = {k: v for k, v in launched.items() if k != name and v}
    require(launched[name] == want and not others,
            f"{what}: launches {launched}, expected {want} of {name} only")


def one_worker(stream):
    """Worker 0's layout of a stacked ``(1, cap, ...)`` stream (D=1)."""
    return tuple(s[0] for s in stream)


def one_device(dev):
    """The D=1 paths' workers: one, on ``dev``."""
    from repro_torch.core.workers import LocalWorkers
    return LocalWorkers(1, dev)


def remap_one(cur, next_mode: int, rt):
    """The D=1 remap of one worker's layout ``cur``."""
    from repro_torch.core import distributed as dist
    return one_worker(dist.device_remap(*(s[None] for s in cur), next_mode,
                                        rt, one_device(cur[0].device))[:3])


def compare(out, plain, what: str) -> float:
    scale = float(plain.abs().max())
    err = float((out - plain).abs().max())
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    require(torch.allclose(out, plain, rtol=RTOL, atol=ATOL_FRAC * scale),
            f"{what}: max|kernel-plain| {err:.3e} (max|plain| {scale:.3e})")
    return err


# The first bf16 kernel (a column a lane, the fp32 kernel's staging) at a
# narrow slab, the yardstick [bf16-main] times the port's narrow kernel
# against, is built from this file, which keeps the narrow kernel's design
# space as source text; the port does not export it.
DESIGNS_SRC = os.path.join(ROOT, "bench_torch", "gather_mttkrp_designs.cu")
DESIGNS_LIB = os.path.join(ROOT, "build", "designs",
                           "gather_mttkrp_designs.so")
_DESIGNS = {}


def phase_build():
    """The port's libraries, and beside them (one more nvcc, started
    first) the design-space library of ``DESIGNS_SRC``."""
    import ctypes
    from repro_torch.kernels.mttkrp import build
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(DESIGNS_LIB), exist_ok=True)
    designs = subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I",
         str(build.SOURCES["gather_mttkrp"].parent), "-o", DESIGNS_LIB,
         DESIGNS_SRC], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        built = build.build()
        for name in built:
            build.load(name)
    finally:
        report, _ = designs.communicate()
    require(designs.returncode == 0,
            f"nvcc failed for {DESIGNS_SRC}:\n{report}")
    lib = ctypes.CDLL(DESIGNS_LIB)
    argtypes = build._LAUNCH_ARGTYPES["gather_mttkrp"]
    for fn, args in {**argtypes, "gather_mttkrp_bf16_column_launch":
                     argtypes["gather_mttkrp_bf16_launch"]}.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    lib.gather_mttkrp_error_string.argtypes = [ctypes.c_int]
    lib.gather_mttkrp_error_string.restype = ctypes.c_char_p
    _DESIGNS["lib"] = lib
    secs = time.perf_counter() - t0
    log(f"[build] {len(built)} libraries in {secs:.2f} s (one nvcc per "
        "source, in parallel), and "
        f"{os.path.relpath(DESIGNS_LIB, ROOT)} beside them (the yardstick "
        "of [bf16-main])")
    for name, (path, report) in built.items():
        log(f"[build] {os.path.relpath(path, ROOT)}")
        for ln in report.splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build]   ptxas: {ln.strip()}")


def phase_lowering():
    """The compile-validation tier over the full grid (ROADMAP A13)."""
    from repro_torch.kernels.mttkrp import kernel as K
    from repro_torch.kernels.mttkrp import lowering
    from repro_torch.oocore import planner
    t0 = time.perf_counter()
    results = lowering.run(lowering.FULL_GEOMETRIES)
    secs = time.perf_counter() - t0
    for r in results:
        row = r.row()
        status = "ok  " if r.ok else ("n/a " if not r.launchable else "FAIL")
        log(f"[lowering] {status} {r.backend:27s} {r.geometry.label():30s} "
            f"sm90a={r.sm90a} grid={row['grid']} block={row['block']} "
            f"smem={row['smem']} regs={row['registers']} "
            f"static_smem={row['static_smem']} spill={row['spill_bytes']}"
            + (f"  {r.error}" if r.error else ""))
        g = r.geometry
        fits = planner.backend_fits(
            r.backend, nmodes=g.nmodes, rank=g.rank, blk=g.blk,
            tile_rows=g.tile_rows,
            factor_rows=(g.factor_rows,) * (g.nmodes - 1),
            smem_budget=K.SMEM_LIMIT_BYTES, l2_budget=2**62)
        require(r.launchable == fits,
                f"[lowering] {r.backend} {g.label()}: geometry verdict "
                f"{r.launchable} but backend_fits {fits}")
    for res in lowering.kernel_resources():
        log(f"[lowering] kernel {res['library']}: "
            f"{lowering.kernel_label(res['kernel'])} for {res['arch']}: "
            f"{res['registers']} registers, {res['static_smem']} B static "
            f"smem, spill stores {res['spill_stores']} B, spill loads "
            f"{res['spill_loads']} B, stack {res['stack']} B")
    bad = lowering.failed(results)
    require(not bad, "[lowering] launchable points failed: "
            + "; ".join(f"{r.backend} {r.geometry.label()}: {r.error}"
                        for r in bad))
    require(len(results) == 63 and all(
        r.sm90a for r in results if r.ok and r.backend != "ref"),
        "[lowering] a built point without its sm_90a entry point")
    log(f"[lowering] {sum(r.ok for r in results)}/{len(results)} points "
        f"build for sm_90a with their launch plans, "
        f"{sum(not r.launchable for r in results)} refused by the geometry "
        f"rules, in {secs:.1f} s")


def phase_l2_rate(dev, gpu: str):
    """The card's L2 read rate: the hand-written probe reads a 16 MiB
    buffer (it stays in the 50 MB L2) 64 times per launch with 16-byte
    loads that bypass L1; the best of a few grid shapes, CUDA-event
    timed. Sets ``L2_BYTES_PER_S``."""
    global L2_BYTES_PER_S
    from repro_torch.kernels.mttkrp import build
    lib = build.load("l2_probe")
    buf = torch.randn(4 << 20, device=dev)
    sink = torch.zeros(1, device=dev)
    n4, passes = buf.numel() // 4, 64
    stream = torch.cuda.current_stream(dev).cuda_stream
    best = 0.0
    for blocks_per_sm, threads in ((4, 512), (8, 256), (2, 1024)):
        blocks = torch.cuda.get_device_properties(dev).multi_processor_count \
            * blocks_per_sm

        def launch():
            err = lib.l2_read_launch(buf.data_ptr(), n4, passes, blocks,
                                     threads, sink.data_ptr(), stream)
            require(err == 0, "l2_read_launch failed: "
                    f"{lib.l2_probe_error_string(err).decode()}")
        ms = cuda_ms(launch, 10)
        best = max(best, buf.numel() * 4 * passes / ms * 1e3)
    L2_BYTES_PER_S = best
    log(f"[gpu] L2 read rate {best / 1e12:.3f} TB/s (16 MiB buffer, "
        f"{passes} passes per launch, best of 3 grids; HBM peak "
        f"{hw_peak('hbm_bw') / 1e12:.2f} TB/s)  [{gpu}]")


def random_stream(rng, k: int, rank: int, cap: int, rows_cap: int, dev):
    """A row-sorted random stream (mode 0 is the output) and its factors."""
    frows = [int(x) for x in rng.integers(5_000, 30_000, k)]
    rows = np.sort(rng.integers(0, rows_cap, cap)).astype(np.int32)
    cols = [rng.integers(0, f, cap) for f in frows]
    idx = torch.tensor(np.stack([rows] + cols, 1).astype(np.int32),
                       device=dev)
    val = torch.tensor(rng.standard_normal(cap).astype(np.float32),
                       device=dev)
    valid = torch.ones(cap, dtype=torch.bool, device=dev)
    factors = [torch.zeros(rows_cap, rank, device=dev)] + [
        torch.tensor(rng.standard_normal((f, rank)).astype(np.float32),
                     device=dev) for f in frows]
    return idx, val, valid, factors


def random_operands(rng, k: int, rank: int, cap: int, rows_cap: int,
                    slab: int, dev, dtype=torch.float32):
    """A row-sorted random stream through the port's own block layout,
    the factors in ``dtype``."""
    from repro_torch.kernels.mttkrp import ops
    return ops.gather_operands(
        *random_stream(rng, k, rank, cap, rows_cap, dev), mode=0,
        rows_cap=rows_cap, row_offset=0, blk=BLK, tile_rows=TILE_ROWS,
        slab=slab, dtype=dtype)


def stream_operands(operands, blk: int):
    """B6's operands from B1's on the same aligned stream: factors padded
    to whole tiles, schedules with windows tightened to the data (as the
    stream backend's mode step builds them). Returns ``(operands,
    windows)``."""
    from repro_torch.kernels.mttkrp import kernel as K, ops
    vals, idx_al, fmats, rows, tob = operands
    fmats = tuple(ops._pad_factor_rows(f, K.FACTOR_ROW_TILE) for f in fmats)
    scheds, windows, _ = ops.stream_schedules(
        idx_al, blk, [f.shape[0] for f in fmats])
    return (vals, idx_al, fmats, rows, tob, scheds), windows


def phase_kernels(dev):
    from repro_torch.kernels.mttkrp import kernel as K
    rng = np.random.default_rng(0)
    cap, rows_cap = 1 << 20, 16_384
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE_ROWS)
    for k, rank in itertools.product((2, 3), (16, 256)):
        slab = min(rank, 128)
        ops_ = random_operands(rng, k, rank, cap, rows_cap, slab, dev)
        b1 = K.fused_mttkrp_nmode_gather(*ops_, **kw)
        b1_again = K.fused_mttkrp_nmode_gather(*ops_, **kw)
        b2 = K.fused_mttkrp_nmode_gather_tiled(*ops_, rank_slab=slab, **kw)
        plain = K.fused_mttkrp_nmode_gather_plain(*ops_, **kw)
        torch.cuda.synchronize()
        what = f"K={k} R={rank}"
        err = compare(b1, plain, f"B1 {what}")
        require(torch.equal(b1, b1_again), f"B1 {what}: rerun differs")
        require(torch.equal(b1, b2), f"B2 {what}: differs from B1 bitwise")
        t_b1 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather(*ops_, **kw), 5)
        t_b2 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_tiled(
            *ops_, rank_slab=slab, **kw), 5)
        t_p = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_plain(*ops_, **kw),
                      3)
        bound, by = kernel_bound_ms(ops_, rows_cap=rows_cap,
                                    tile_rows=TILE_ROWS)
        log(f"[kernels] {what} nnz={cap} slab={slab}: max_abs_err={err:.3e} "
            f"B1==B2 bitwise, rerun bitwise; B1 {t_b1:.4f} ms, B2 {t_b2:.4f} "
            f"ms, plain {t_p:.4f} ms, bound {bound:.4f} ms ({by})")


def phase_fused_kernels(dev):
    """B3, B4 and B5 on random streams: against their plain versions,
    B4 == B3 == B1 and B5 == B1 bitwise, reruns bitwise, out_init kept."""
    from repro_torch.kernels.mttkrp import kernel as K, ops
    rng = np.random.default_rng(2)
    cap, rows_cap = 1 << 20, 16_384
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE_ROWS)
    for k, rank in itertools.product((2, 3), (16, 256, 1024)):
        slab = min(rank, 128)
        ops_ = random_operands(rng, k, rank, cap, rows_cap, slab, dev)
        vals, idx_al, fmats, rows, tob = ops_
        what = f"K={k} R={rank}"
        # B1 at the whole rank, or B2 (== B1) where B1 does not fit.
        b1_fits = K.gather_smem_bytes(
            k, rank, TILE_ROWS, gather_itemsize=fmats[0].element_size()) \
            <= K.SMEM_LIMIT_BYTES
        b1 = (K.fused_mttkrp_nmode_gather(*ops_, **kw) if b1_fits else
              K.fused_mttkrp_nmode_gather_tiled(*ops_, rank_slab=slab, **kw))
        pre = ops.pregathered_rows(idx_al, fmats)
        contrib = vals[:, None]
        for r in pre:
            contrib = contrib * r
        b5 = K.segment_accumulate(contrib, rows, tob, **kw)
        plain5 = K.segment_accumulate_plain(contrib, rows, tob, **kw)
        torch.cuda.synchronize()
        err5 = compare(b5, plain5, f"B5 {what}")
        require(torch.equal(b5, b1), f"B5 {what}: differs from B1 bitwise")
        require(torch.equal(b5, K.segment_accumulate(contrib, rows, tob,
                                                     **kw)),
                f"B5 {what}: rerun differs")
        out_rows = (torch.repeat_interleave(tob.long(), BLK) * TILE_ROWS
                    + rows.long())
        t_b5 = cuda_ms(lambda: K.segment_accumulate(contrib, rows, tob,
                                                    **kw), 5)
        t_lib = cuda_ms(lambda: torch.zeros(rows_cap, rank, device=dev)
                        .index_add_(0, out_rows, contrib), 5)
        line = (f"[fused-kernels] {what} nnz={cap}: B5 max_abs_err "
                f"{err5:.3e}, B5==B1 bitwise, rerun bitwise; B5 {t_b5:.4f} "
                f"ms, index_add_ {t_lib:.4f} ms")
        del contrib, plain5, out_rows
        if rank <= 256:
            b3 = K.fused_mttkrp_nmode(vals, pre, rows, tob, **kw)
            b4 = K.fused_mttkrp_nmode_tiled(vals, pre, rows, tob,
                                            rank_slab=16, **kw)
            plain3 = K.fused_mttkrp_nmode_plain(vals, pre, rows, tob, **kw)
            torch.cuda.synchronize()
            err3 = compare(b3, plain3, f"B3 {what}")
            require(torch.equal(b3, b1), f"B3 {what}: differs from B1")
            require(torch.equal(b4, b3), f"B4 {what}: differs from B3")
            require(torch.equal(b3, K.fused_mttkrp_nmode(vals, pre, rows, tob,
                                                         **kw)),
                    f"B3 {what}: rerun differs")
            init = torch.randn(rows_cap, rank, device=dev)
            keep = init.clone()
            b3i = K.fused_mttkrp_nmode(vals, pre, rows, tob, out_init=init,
                                       **kw)
            b1i = K.fused_mttkrp_nmode_gather_tiled(
                *ops_, rank_slab=slab, out_init=init, **kw)
            require(torch.equal(init, keep), f"B3 {what}: out_init modified")
            require(torch.equal(b3i, b1i),
                    f"B3 {what}: with out_init differs from B1")
            compare(b3i, K.fused_mttkrp_nmode_plain(
                vals, pre, rows, tob, out_init=init, **kw), f"B3 {what} init")
            t_b3 = cuda_ms(lambda: K.fused_mttkrp_nmode(vals, pre, rows, tob,
                                                        **kw), 5)
            t_b4 = cuda_ms(lambda: K.fused_mttkrp_nmode_tiled(
                vals, pre, rows, tob, rank_slab=16, **kw), 5)
            nz = int((vals != 0).sum())
            rkw = dict(nnz=nz, rows_cap=rows_cap, tile_rows=TILE_ROWS)
            line += (f"; B3 max_abs_err {err3:.3e}, B4==B3==B1 bitwise, "
                     f"rerun bitwise, out_init kept and added; B3 "
                     f"{t_b3:.4f} ms ({fused_ring_fields(pre, t_b3, **rkw)})"
                     f", B4 (slab 16) {t_b4:.4f} ms "
                     f"({fused_ring_fields(pre, t_b4, slab=16, **rkw)})")
            del b3, b4, plain3, b3i, b1i, init, keep
        log(line)
        del ops_, pre, b1, b5
    torch.cuda.empty_cache()


def mid_tile_splits(tile_of_block, chunk_block_counts) -> int:
    """Chunk boundaries that fall inside an output tile's run of blocks."""
    tob = tile_of_block.cpu().numpy()
    return sum(int(tob[b] == tob[b - 1])
               for b in np.cumsum(chunk_block_counts)[:-1])


def phase_stream_kernels(dev):
    """B6 on random streams: against plain, == B1, rerun, chunked."""
    from repro_torch.kernels.mttkrp import kernel as K, ops
    from repro_torch.oocore import executor, planner
    rng = np.random.default_rng(1)
    # 1024 output rows: 128 tiles of ~8192 nonzeros, 64 blocks each, so a
    # chunk of 48 blocks ends inside a tile's run.
    cap, rows_cap = 1 << 20, 1024
    kw = dict(rows_cap=rows_cap, blk=STREAM_BLK, tile_rows=STREAM_TILE_ROWS)
    for k, rank in itertools.product((2, 3), (16, 64)):
        stream = random_stream(rng, k, rank, cap, rows_cap, dev)
        b1_ops = ops.gather_operands(*stream, mode=0, row_offset=0,
                                     slab=rank, **kw)
        s_ops, windows = stream_operands(b1_ops, STREAM_BLK)
        b6 = K.fused_mttkrp_nmode_gather_stream(*s_ops, **kw)
        b6_again = K.fused_mttkrp_nmode_gather_stream(*s_ops, **kw)
        b1 = K.fused_mttkrp_nmode_gather(*b1_ops, **kw)
        plain = K.fused_mttkrp_nmode_gather_stream_plain(*s_ops, **kw)
        torch.cuda.synchronize()
        what = f"K={k} R={rank}"
        err = compare(b6, plain, f"B6 {what}")
        require(torch.equal(b6, b6_again), f"B6 {what}: rerun differs")
        require(torch.equal(b6, b1), f"B6 {what}: differs from B1 bitwise")
        single, st1 = executor.mttkrp_out_of_core(*stream, mode=0, **kw)
        budget = 48 * planner.stream_chunk_bytes(STREAM_BLK, k,
                                                 st1.window_tiles)
        chunked, st2 = executor.mttkrp_out_of_core(
            *stream, mode=0, max_chunk_bytes=budget, **kw)
        torch.cuda.synchronize()
        splits = mid_tile_splits(b1_ops[4], st2.chunk_block_counts)
        require(st2.chunks >= 4 and splits > 0,
                f"B6 {what}: {st2.chunks} chunks, {splits} mid-tile splits")
        require(torch.equal(chunked, single),
                f"B6 {what}: chunked run differs from the single pass")
        require(torch.equal(single, b6),
                f"B6 {what}: the executor differs from the direct launch")
        t_b6 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_stream(
            *s_ops, **kw), 3)
        t_b1 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather(*b1_ops, **kw), 3)
        t_p = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_stream_plain(
            *s_ops, **kw), 1)
        bound, by = kernel_bound_ms(b1_ops, rows_cap=rows_cap,
                                    tile_rows=STREAM_TILE_ROWS,
                                    scheds=s_ops[5])
        stages, mappers = K.stream_ring(k, rank, STREAM_BLK,
                                        STREAM_TILE_ROWS, windows)
        copied = stream_copy_bytes(s_ops[0], s_ops[5], s_ops[2], STREAM_BLK,
                                   K.FACTOR_ROW_TILE, K.STREAM_RANK_SLAB)
        tbps, l2b = l2_fields(copied, t_b6)
        log(f"[stream-kernels] {what} nnz={cap} blk={STREAM_BLK} windows="
            f"{windows} stages={stages} mappers={mappers}: max_abs_err="
            f"{err:.3e}, B6==B1 bitwise, rerun bitwise, {st2.chunks} chunks "
            f"with {splits} mid-tile splits == single pass bitwise; B6 "
            f"{t_b6:.4f} ms, B1 {t_b1:.4f} ms, plain {t_p:.4f} ms, bound "
            f"{bound:.4f} ms ({by}); distinct tile bytes "
            f"{st1.distinct_tile_bytes}, copied {copied} B at {tbps:.3f} "
            f"TB/s, L2 bound {l2b:.4f} ms")
        del stream, b1_ops, s_ops, b6, b6_again, b1, plain, single, chunked


_RUNTIMES: dict = {}


def runtime(ft, rank: int, *, gather_dtype: str = "float32",
            ordering: str | None = None, **layout):
    """``prepare_runtime(ft, rank, ...)`` for the script's own checks and
    profiles, built on the host once per FLYCOO tensor and ``layout``
    (``blk``, ``tile_rows``): the packed mode-0 layout does not depend on
    the rank, the gather dtype or the ordering, which only set the
    runtime's fields. The entry points (``cp_als_distributed``) build
    their own."""
    from repro_torch.core import distributed as dist
    key = (id(ft), tuple(sorted(layout.items())))
    hit = _RUNTIMES.get(key)
    if hit is None or hit[0] is not ft:
        hit = _RUNTIMES[key] = (ft, *dist.prepare_runtime(ft, rank,
                                                          **layout))
    _, rt, packed = hit
    return dataclasses.replace(
        rt, rank=rank, gather_dtype=gather_dtype,
        ordering=ft.ordering if ordering is None else ordering), packed


def check_modes(ft, rank: int, backend: str, dev, *, reps: int = 5):
    """Sweep 0 through ``backend``; per mode, rebuild the kernel's exact
    inputs, require the kernel to reproduce the sweep's output bitwise and
    to match its plain version, and time both. Returns per-mode rows."""
    from repro_torch.core import cpals
    from repro_torch.kernels.mttkrp import kernel as K, ops
    tiled = backend == "pallas_fused_gather_tiled"
    kern = (K.fused_mttkrp_nmode_gather_tiled if tiled
            else K.fused_mttkrp_nmode_gather)
    plain = (K.fused_mttkrp_nmode_gather_tiled_plain if tiled
             else K.fused_mttkrp_nmode_gather_plain)
    slab = ops.tiled_rank_slab(rank) if tiled else ops.padded_rank(rank)
    extra = {"rank_slab": slab} if tiled else {}
    rt, packed = runtime(ft, rank)
    wk = one_device(dev)
    stream, factors, lam, x2 = cpals.device_state(ft, rt, packed, seed=0,
                                                  workers=wk)
    del packed
    res = cpals.als_sweep(stream, factors, lam, x2, rt, workers=wk,
                          sweep0=True, backend=backend)
    rows = []
    cur = one_worker(stream)
    for n in range(rt.nmodes):
        facs = list(res.factors[:n]) + list(factors[n:])
        operands = ops.gather_operands(
            *cur, facs, mode=n, rows_cap=rt.rows_cap[n], row_offset=0,
            blk=rt.blk, tile_rows=rt.tile_rows, slab=slab)
        kw = dict(rows_cap=rt.rows_cap[n], blk=rt.blk,
                  tile_rows=rt.tile_rows, **extra)
        out = kern(*operands, **kw)
        require(torch.equal(out[:, :rank], res.mttkrp[n][0]),
                f"{backend} mode {n}: rebuilt inputs do not reproduce the "
                "sweep's output bitwise")
        ref = plain(*operands, **kw)
        err = compare(out, ref, f"{backend} mode {n}")
        t_k = cuda_ms(lambda: kern(*operands, **kw), reps)
        t_p = cuda_ms(lambda: plain(*operands, **kw), max(1, reps // 2))
        bound, by = kernel_bound_ms(operands, rows_cap=rt.rows_cap[n],
                                    tile_rows=rt.tile_rows)
        rows.append(dict(mode=n, err=err, ms=t_k, plain_ms=t_p,
                         bound_ms=bound, bound_by=by,
                         l2_bytes=gather_l2_bytes(operands),
                         slots=int(operands[0].shape[0])))
        del operands, out, ref
        cur = remap_one(cur, (n + 1) % rt.nmodes, rt)
    return rows, float(res.fit)


def profile_sweep(ft, rank: int, backend: str, dev, **runtime_kw):
    """Device time by kernel over one later sweep (torch.profiler), and the
    ops that launched the most of it, with their input shapes.
    ``runtime_kw`` (``blk``, ``ordering``) go to ``prepare_runtime``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import cpals
    from repro_torch.core.workers import LocalWorkers
    rt, packed = runtime(ft, rank, **runtime_kw)
    wk = LocalWorkers(rt.num_workers, dev)
    stream, factors, lam, x2 = cpals.device_state(ft, rt, packed, seed=0,
                                                  workers=wk)
    del packed
    res = cpals.als_sweep(stream, factors, lam, x2, rt, workers=wk,
                          sweep0=True, backend=backend)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        res = cpals.als_sweep(res.stream, res.factors, res.lam, x2, rt,
                              workers=wk, sweep0=False, backend=backend)
        float(res.fit)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {ev.key: ev.device_time_total / 1e3
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA}
    busy = sum(kernels.values())
    log(f"[profile] one sweep R={rank} {backend} {runtime_kw}: wall "
        f"{wall_ms:.2f} ms, "
        f"kernels {busy:.2f} ms, device idle share {1 - busy / wall_ms:.3f}")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[profile]   kernel {ms:9.3f} ms  {name[:100]}")
    ops = [ev for ev in prof.key_averages(group_by_input_shape=True)
           if ev.device_type == DeviceType.CPU
           and ev.key.startswith("aten::") and ev.self_device_time_total > 0]
    for ev in sorted(ops, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   op {ev.self_device_time_total / 1e3:9.3f} ms  "
            f"x{ev.count} {ev.key} {str(ev.input_shapes)[:90]}")


def phase_main(dev, gpu: str):
    from repro_torch.core import cpals, flycoo, tensors
    prof = tensors.FROSTT_PROFILES["nell-2"]
    shape, nnz = prof["shape"], prof["nnz"]
    t0 = time.perf_counter()
    t = tensors.random_sparse_tensor(shape, nnz, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ft = flycoo.build_flycoo(t, 1)
    t_fly = time.perf_counter() - t0
    log(f"[main] nell-2 stand-in shape={shape} nnz={t.nnz} (profile nnz "
        f"{nnz}, uniform, seed 0): generate {t_gen:.1f} s, build_flycoo "
        f"{t_fly:.1f} s")

    # --- auto (B1 at R=16): counts zeroed just before, read just after --
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = cpals.cp_als_distributed(ft, 16, backend="auto", iters=3, tol=0.0)
    wall = time.perf_counter() - t0
    launched = counts()
    b1_launches = launched["fused_mttkrp_nmode_gather"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fits = res.fits
    MAIN_SWEEP_MS[:] = [s * 1e3 for s in res.sweep_seconds]
    log(f"[main] cp_als_distributed R=16 backend=auto: fits {fits}; "
        f"ms per sweep {[round(s * 1e3, 2) for s in res.sweep_seconds]}; "
        f"call {wall:.1f} s incl. host prepare_runtime; peak device memory "
        f"{peak_gb:.2f} GB; B1 launches {b1_launches}")
    require_only(launched, "fused_mttkrp_nmode_gather", 9,
                 "auto at R=16 (B1 on every mode)")
    require(all(np.isfinite(fits)) and max(fits) <= 1.0, f"fits {fits}")
    require(all(b >= a - 1e-3 for a, b in zip(fits[1:], fits[2:])),
            f"fit decreased after sweep 1: {fits}")
    for f in res.factors:
        require(bool(np.isfinite(f).all()), "non-finite factor")

    b1_rows, _ = check_modes(ft, 16, "pallas_fused_gather", dev)
    for r in b1_rows:
        tbps, l2b = l2_fields(r["l2_bytes"], r["ms"])
        log(f"[main] B1 mode {r['mode']}: {r['slots']} slots, kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}, HBM 3.35 TB/s); L2 "
            f"{r['l2_bytes']} B gathered at {tbps:.3f} TB/s, L2 bound "
            f"{l2b:.3f} ms; max_abs_err {r['err']:.3e}  [{gpu}]")
    profile_sweep(ft, 16, "pallas_fused_gather", dev)

    # --- B2 path (auto's next rung): R=256 in 128-column slabs ---------
    reset_counts()
    res2 = cpals.cp_als_distributed(
        ft, 256, backend="pallas_fused_gather_tiled", iters=1, tol=0.0)
    launched = counts()
    b2_launches = launched["fused_mttkrp_nmode_gather_tiled"]
    require_only(launched, "fused_mttkrp_nmode_gather_tiled", 3, "B2 path")
    log(f"[main] cp_als_distributed R=256 pallas_fused_gather_tiled: fits "
        f"{res2.fits}; ms per sweep "
        f"{[round(s * 1e3, 2) for s in res2.sweep_seconds]}; B2 launches "
        f"{b2_launches}")
    require(all(np.isfinite(res2.fits)) and max(res2.fits) <= 1.0,
            f"fits {res2.fits}")
    b2_rows, _ = check_modes(ft, 256, "pallas_fused_gather_tiled", dev,
                             reps=3)
    for r in b2_rows:
        tbps, l2b = l2_fields(r["l2_bytes"], r["ms"])
        log(f"[main] B2 mode {r['mode']}: {r['slots']} slots, kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}); L2 {r['l2_bytes']} "
            f"B gathered at {tbps:.3f} TB/s, L2 bound {l2b:.3f} ms; "
            f"max_abs_err {r['err']:.3e}  [{gpu}]")
    return ft, fits, {
        "fused_mttkrp_nmode_gather": (b1_launches, b1_rows),
        "fused_mttkrp_nmode_gather_tiled": (b2_launches, b2_rows)}


def phase_fused_main(ft, b1_fits, dev, gpu: str):
    """pallas_fused (B3), pallas_fused_tiled (B4) and pallas (B5) on the
    nell-2 stand-in that phase_main built: each CP-ALS run's fits equal
    the B1 run's; per mode, each kernel at its own inputs against its
    plain version and B1 bitwise, with times, bounds and peak memory."""
    from repro_torch.core import cpals
    from repro_torch.core.mttkrp import hadamard_rows
    from repro_torch.kernels.mttkrp import kernel as K, ops
    rank = 16
    launches = {}
    # --- the driven paths: counts zeroed just before, read just after ---
    for name in ("fused_mttkrp_nmode", "fused_mttkrp_nmode_tiled",
                 "segment_accumulate"):
        backend = BACKEND_OF[name]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        res = cpals.cp_als_distributed(ft, rank, backend=backend, iters=2,
                                       tol=0.0)
        launched = counts()
        log(f"[fused-main] cp_als_distributed R={rank} {backend}: fits "
            f"{res.fits}; ms per sweep "
            f"{[round(x * 1e3, 2) for x in res.sweep_seconds]}; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
            f"{name} launches {launched[name]}")
        require_only(launched, name, 6, f"{backend} path")
        require(res.fits == b1_fits[:2],
                f"{backend} fits {res.fits} != B1 fits {b1_fits[:2]}")
        launches[name] = launched[name]
        del res

    # --- per mode at the main path's inputs (launches not counted) ------
    rt, packed = runtime(ft, rank)
    stream, factors, _, _ = cpals.device_state(ft, rt, packed, seed=0,
                                               workers=one_device(dev))
    del packed
    nmodes = rt.nmodes
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    for r_, blk_ in itertools.product((16, 256), (64, 512)):
        picks = [ops.select_backend(
            "auto", nmodes=nmodes, rank=r_, blk=blk_, tile_rows=rt.tile_rows,
            factor_rows=[rt.i_pad[w] for w in range(nmodes) if w != n])
            for n in range(nmodes)]
        log(f"[auto] R={r_} blk={blk_}: per mode {picks}; l2_budget "
            f"{K.L2_BUDGET_BYTES} B of the card's L2 {l2} B, smem_budget "
            f"{K.SMEM_LIMIT_BYTES} B")
    gen = torch.Generator(device=dev).manual_seed(0)
    f32 = [torch.randn(rt.i_pad[w], 32, generator=gen, device=dev)
           for w in range(nmodes)]
    rows = {"fused_mttkrp_nmode": [], "fused_mttkrp_nmode_tiled": [],
            "segment_accumulate": []}
    cur = one_worker(stream)
    for n in range(nmodes):
        rows_cap = rt.rows_cap[n]
        kw = dict(rows_cap=rows_cap, blk=rt.blk, tile_rows=rt.tile_rows)
        okw = dict(mode=n, rows_cap=rows_cap, row_offset=0, blk=rt.blk,
                   tile_rows=rt.tile_rows)
        nnz = int(cur[2].sum())
        torch.cuda.reset_peak_memory_stats()
        # B3 at R=16, on B1's aligned stream.
        vals, idx_al, fmats, r_al, tob = ops.gather_operands(
            *cur, factors, slab=rank, **okw)
        b1_16 = K.fused_mttkrp_nmode_gather(vals, idx_al, fmats, r_al, tob,
                                            **kw)
        k = len(fmats)
        pre = ops.pregathered_rows(idx_al, fmats)
        del idx_al, fmats
        b3 = K.fused_mttkrp_nmode(vals, pre, r_al, tob, **kw)
        require(torch.equal(b3, b1_16), f"mode {n}: B3 differs from B1")
        plain = K.fused_mttkrp_nmode_plain(vals, pre, r_al, tob, **kw)
        err = compare(b3, plain, f"B3 mode {n}")
        t_k = cuda_ms(lambda: K.fused_mttkrp_nmode(vals, pre, r_al, tob,
                                                   **kw), 5)
        t_p = cuda_ms(lambda: K.fused_mttkrp_nmode_plain(vals, pre, r_al,
                                                         tob, **kw), 2)
        bound, by = fused_bound_ms(nnz, rank, k, rows_cap=rows_cap,
                                   tile_rows=rt.tile_rows)
        rows["fused_mttkrp_nmode"].append(dict(
            mode=n, err=err, ms=t_k, plain_ms=t_p, bound_ms=bound,
            bound_by=by, l2_bytes=nnz * k * rank * 4))
        rkw = dict(nnz=nnz, rows_cap=rows_cap, tile_rows=rt.tile_rows)
        log(f"[fused-main] B3 mode {n}: {vals.shape[0]} slots, {nnz} nnz, "
            f"kernel {t_k:.3f} ms, plain {t_p:.3f} ms, bound {bound:.3f} ms "
            f"({by}, HBM 3.35 TB/s; {fused_ring_fields(pre, t_k, **rkw)}), "
            f"max_abs_err {err:.3e}, == B1 bitwise  [{gpu}]")
        # B4 at the tiled path's own inputs (R=16: one 16-column slab).
        tkw = dict(rank_slab=16, **kw)
        b4 = K.fused_mttkrp_nmode_tiled(vals, pre, r_al, tob, **tkw)
        require(torch.equal(b4, b1_16), f"mode {n}: B4 differs from B1")
        plain = K.fused_mttkrp_nmode_tiled_plain(vals, pre, r_al, tob, **tkw)
        err = compare(b4, plain, f"B4 mode {n}")
        t_k = cuda_ms(lambda: K.fused_mttkrp_nmode_tiled(vals, pre, r_al, tob,
                                                         **tkw), 5)
        t_p = cuda_ms(lambda: K.fused_mttkrp_nmode_tiled_plain(
            vals, pre, r_al, tob, **tkw), 2)
        rows["fused_mttkrp_nmode_tiled"].append(dict(
            mode=n, err=err, ms=t_k, plain_ms=t_p, bound_ms=bound,
            bound_by=by, l2_bytes=nnz * k * rank * 4))
        log(f"[fused-main] B4 mode {n}: R=16, one slab, kernel {t_k:.3f} ms, "
            f"plain {t_p:.3f} ms, bound {bound:.3f} ms ({by}; "
            f"{fused_ring_fields(pre, t_k, slab=16, **rkw)}), max_abs_err "
            f"{err:.3e}, == B1 bitwise  [{gpu}]")
        del vals, pre, r_al, tob, b3, b4, plain
        # B4 at R=32 in two 16-column slabs, on B1's stream at R=32.
        vals, idx_al, fmats, r_al, tob = ops.gather_operands(
            *cur, f32, slab=32, **okw)
        b1_32 = K.fused_mttkrp_nmode_gather(vals, idx_al, fmats, r_al, tob,
                                            **kw)
        pre = ops.pregathered_rows(idx_al, fmats)
        del idx_al, fmats
        b4 = K.fused_mttkrp_nmode_tiled(vals, pre, r_al, tob, **tkw)
        require(torch.equal(b4, b1_32), f"mode {n}: B4 differs from B1")
        plain = K.fused_mttkrp_nmode_tiled_plain(vals, pre, r_al, tob, **tkw)
        err = compare(b4, plain, f"B4 mode {n}")
        t_k = cuda_ms(lambda: K.fused_mttkrp_nmode_tiled(vals, pre, r_al, tob,
                                                         **tkw), 5)
        t_p = cuda_ms(lambda: K.fused_mttkrp_nmode_tiled_plain(
            vals, pre, r_al, tob, **tkw), 2)
        bound, by = fused_bound_ms(nnz, 32, k, rows_cap=rows_cap,
                                   tile_rows=rt.tile_rows)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"[fused-main] B4 mode {n}: R=32, 2 slabs of 16, kernel "
            f"{t_k:.3f} ms, plain {t_p:.3f} ms, bound {bound:.3f} ms ({by}; "
            f"{fused_ring_fields(pre, t_k, slab=16, **rkw)}), max_abs_err "
            f"{err:.3e}, == B1 bitwise; peak device memory of B3 and B4 "
            f"{peak_gb:.2f} GB  [{gpu}]")
        del vals, pre, r_al, tob, b4, b1_32, plain
        # B5 at R=16, on the materialized path's own operands.
        torch.cuda.reset_peak_memory_stats()
        idx, val, valid = cur
        ell = hadamard_rows(torch.where(valid[:, None], idx, 0),
                            torch.where(valid, val, 0.0), factors, n).float()
        local_row = torch.where(valid, idx[:, n], 0).to(torch.int32)
        contrib, r_al, tob = ops.blocked_operands(ell, local_row, valid, **kw)
        del ell, local_row
        b5 = K.segment_accumulate(contrib, r_al, tob, **kw)
        require(torch.equal(b5, b1_16), f"mode {n}: B5 differs from B1")
        plain = K.segment_accumulate_plain(contrib, r_al, tob, **kw)
        err = compare(b5, plain, f"B5 mode {n}")
        out_rows = (torch.repeat_interleave(tob.long(), rt.blk)
                    * rt.tile_rows + r_al.long())
        t_k = cuda_ms(lambda: K.segment_accumulate(contrib, r_al, tob, **kw),
                      5)
        t_p = cuda_ms(lambda: K.segment_accumulate_plain(contrib, r_al, tob,
                                                         **kw), 2)
        t_lib = cuda_ms(lambda: torch.zeros(rows_cap, rank, device=dev)
                        .index_add_(0, out_rows, contrib), 5)
        bound, by = fused_bound_ms(nnz, rank, 0, rows_cap=rows_cap,
                                   tile_rows=rt.tile_rows)
        rows["segment_accumulate"].append(dict(
            mode=n, err=err, ms=t_k, plain_ms=t_p, bound_ms=bound,
            bound_by=by, library_ms=t_lib, l2_bytes=nnz * rank * 4))
        log(f"[fused-main] B5 mode {n}: {contrib.shape[0]} slots (trailing "
            f"padding cut), kernel {t_k:.3f} ms, plain {t_p:.3f} ms, "
            f"index_add_ {t_lib:.3f} ms, bound {bound:.3f} ms ({by}), "
            f"max_abs_err {err:.3e}, == B1 bitwise; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{gpu}]")
        del contrib, r_al, tob, b5, plain, out_rows, b1_16
        cur = remap_one(cur, (n + 1) % nmodes, rt)
    del cur, stream, factors, f32
    torch.cuda.empty_cache()
    profile_sweep(ft, rank, "pallas", dev)
    return {name: (launches[name], rows[name]) for name in rows}


def phase_stream_main(ft, dev, gpu: str):
    """The out-of-core path on the nell-2 stand-in that phase_main built."""
    from repro_torch.core import cpals
    from repro_torch.kernels.mttkrp import kernel as K, ops
    from repro_torch.oocore import executor, planner
    from repro_torch.reorder import reorder_stream
    rank, blk, tile_rows = 16, MAIN_STREAM_BLK, STREAM_TILE_ROWS
    rt, packed = runtime(ft, rank, blk=blk, tile_rows=tile_rows)
    stream, factors, _, _ = cpals.device_state(ft, rt, packed, seed=0,
                                               workers=one_device(dev))
    del packed
    nmodes, k = rt.nmodes, rt.nmodes - 1
    for n in range(nmodes):
        frows = [rt.i_pad[w] for w in range(nmodes) if w != n]
        require(planner.stream_fits_smem(nmodes=nmodes, rank=rank, blk=blk,
                                         tile_rows=tile_rows,
                                         factor_rows=frows),
                f"mode {n}: the data-blind window does not fit")
    log(f"[stream-main] geometry: blk={blk} tile_rows={tile_rows} frow_tile="
        f"{K.FACTOR_ROW_TILE} rank_slab={K.STREAM_RANK_SLAB}; the data-blind"
        f" window min(blk, ceil(rows/{K.FACTOR_ROW_TILE})) per mode fits "
        f"{K.SMEM_LIMIT_BYTES} B of shared memory")

    # --- the driven path: counts zeroed just before, read just after ---
    K.fused_mttkrp_nmode_gather_stream.launches = 0
    K.fused_mttkrp_nmode_gather.launches = 0
    runs, cur = [], one_worker(stream)
    for n in range(nmodes):
        rows_cap = rt.rows_cap[n]
        num_blocks = ops.n_pad_for(cur[0].shape[0], rows_cap, blk,
                                   tile_rows) // blk
        # Windows are >= 1, so this budget makes >= 5 chunks.
        budget = num_blocks * planner.stream_chunk_bytes(blk, k,
                                                         (1,) * k) // 5
        t0 = time.perf_counter()
        out, stats = executor.mttkrp_out_of_core(
            *cur, factors, mode=n, rows_cap=rows_cap, blk=blk,
            tile_rows=tile_rows, max_chunk_bytes=budget, ordering="morton")
        torch.cuda.synchronize()
        runs.append((n, cur, budget, out, stats, time.perf_counter() - t0))
        cur = remap_one(cur, (n + 1) % nmodes, rt)
    del cur, stream
    kw = dict(iters=2, tol=0.0, ordering="morton", blk=blk,
              tile_rows=tile_rows)
    res_s = cpals.cp_als_distributed(
        ft, rank, backend="pallas_fused_gather_stream", **kw)
    b6_launches = K.fused_mttkrp_nmode_gather_stream.launches
    require(K.fused_mttkrp_nmode_gather.launches == 0,
            "the stream path launched B1")
    want = sum(r[4].chunks for r in runs) + 2 * nmodes
    require(b6_launches == want,
            f"B6 launched {b6_launches} times, expected {want}")

    # --- comparisons (launches here are not counted) ---
    res_b1 = cpals.cp_als_distributed(ft, rank, backend="pallas_fused_gather",
                                      **kw)
    log(f"[stream-main] cp_als_distributed R={rank} morton, 2 sweeps: "
        f"stream fits {res_s.fits}, ms per sweep "
        f"{[round(x * 1e3, 2) for x in res_s.sweep_seconds]}; B1 fits "
        f"{res_b1.fits}, ms per sweep "
        f"{[round(x * 1e3, 2) for x in res_b1.sweep_seconds]}; B6 launches "
        f"{b6_launches} (executor chunks + 2 sweeps x {nmodes} modes)")
    require(res_s.fits == res_b1.fits,
            f"stream fits {res_s.fits} != B1 fits {res_b1.fits}")
    require(all(np.isfinite(res_s.fits)), f"fits {res_s.fits}")
    del res_s, res_b1

    rows = []
    kkw = dict(blk=blk, tile_rows=tile_rows)
    for n, (idx, val, valid), budget, out, stats, secs in runs:
        rows_cap = rt.rows_cap[n]
        frows = tuple(factors[w].shape[0] for w in range(nmodes) if w != n)
        ridx, rval, rvalid, _ = reorder_stream(
            idx, val, valid, mode=n, ordering="morton", tile_rows=tile_rows,
            max_rows=max(frows))
        b1_ops = ops.gather_operands(
            ridx, rval, rvalid, factors, mode=n, rows_cap=rows_cap,
            row_offset=0, slab=ops.padded_rank(rank), **kkw)
        b1 = K.fused_mttkrp_nmode_gather(*b1_ops, rows_cap=rows_cap, **kkw)
        require(torch.equal(out, b1[:, :rank]),
                f"mode {n}: out-of-core output differs from B1 on the same "
                "permuted stream")
        tkw = dict(mode=n, rows_cap=rows_cap, rank=rank, factor_rows=frows,
                   max_chunk_bytes=budget, **kkw)
        post = planner.predict_stream_traffic(ridx, rvalid,
                                              ordering="morton", **tkw)
        pre = planner.predict_stream_traffic(idx, valid, ordering="none",
                                             **tkw)
        del ridx, rval, rvalid
        require((post.scheduled_tile_bytes, post.distinct_tile_bytes,
                 post.window_tiles, post.chunks)
                == (stats.scheduled_tile_bytes, stats.distinct_tile_bytes,
                    stats.window_tiles, stats.chunks)
                and (pre.scheduled_tile_bytes, pre.distinct_tile_bytes)
                == (stats.presort_scheduled_tile_bytes,
                    stats.presort_distinct_tile_bytes),
                f"mode {n}: predicted traffic differs from the counted")
        # One single-pass launch at the stream backend's own inputs.
        s_ops, windows = stream_operands(b1_ops, blk)
        skw = dict(rows_cap=rows_cap, **kkw)
        b6 = K.fused_mttkrp_nmode_gather_stream(*s_ops, **skw)
        require(torch.equal(b6, b1), f"mode {n}: B6 differs from B1")
        plain = K.fused_mttkrp_nmode_gather_stream_plain(*s_ops, **skw)
        err = compare(b6, plain, f"B6 mode {n}")
        t_k = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_stream(
            *s_ops, **skw), 3)
        t_b1 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather(
            *b1_ops, rows_cap=rows_cap, **kkw), 3)
        t_p = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_stream_plain(
            *s_ops, **skw), 1)
        bound, by = kernel_bound_ms(b1_ops, rows_cap=rows_cap,
                                    tile_rows=tile_rows, scheds=s_ops[5])
        stages, mappers = K.stream_ring(k, ops.padded_rank(rank), blk,
                                        tile_rows, windows)
        smem = K.gather_stream_smem_bytes(k, ops.padded_rank(rank), blk,
                                          tile_rows, windows, stages=stages,
                                          mappers=mappers)
        copied = stream_copy_bytes(s_ops[0], s_ops[5], s_ops[2], blk,
                                   K.FACTOR_ROW_TILE, K.STREAM_RANK_SLAB)
        tbps, l2b = l2_fields(copied, t_k)
        log(f"[stream-main] mode {n}: {stats.nnz} nnz, {stats.num_blocks} "
            f"blocks; out-of-core {secs:.2f} s in {stats.chunks} chunks "
            f"{stats.chunk_block_counts[:6]}..., windows {stats.window_tiles}"
            f" (smem {stats.window_smem_bytes} B), == B1 bitwise, predicted "
            f"== counted: scheduled {stats.scheduled_tile_bytes} B, distinct "
            f"{stats.distinct_tile_bytes} B, pipelined "
            f"{stats.pipelined_tile_bytes} B, index stream "
            f"{stats.index_stream_bytes} B; as given: scheduled "
            f"{stats.presort_scheduled_tile_bytes} B, distinct "
            f"{stats.presort_distinct_tile_bytes} B; scheduled/distinct "
            f"{stats.presort_scheduled_over_distinct:.4f} as given -> "
            f"{stats.scheduled_over_distinct:.4f} morton  [{gpu}]")
        log(f"[stream-main] mode {n} single pass: windows {windows}, "
            f"stages {stages}, mappers {mappers} (smem {smem} B); B6 "
            f"{t_k:.3f} ms, B1 {t_b1:.3f} ms, plain {t_p:.3f} ms, bound "
            f"{bound:.3f} ms ({by}, HBM 3.35 TB/s); L2 {copied} B of tiles "
            f"copied at {tbps:.3f} TB/s, L2 bound {l2b:.3f} ms; max_abs_err "
            f"{err:.3e}  [{gpu}]")
        rows.append(dict(mode=n, err=err, ms=t_k, plain_ms=t_p,
                         bound_ms=bound, bound_by=by, l2_bytes=copied))
        if n == 0:
            frow_findings(b1_ops, b1, blk, tile_rows, rows_cap, gpu)
        del b1_ops, s_ops, b1, b6, plain
        # The same permuted stream in 128-slot blocks, for the choice of blk.
        ops128, windows128 = stream_operands(ops.gather_operands(
            *reorder_stream(idx, val, valid, mode=n, ordering="morton",
                            tile_rows=tile_rows, max_rows=max(frows))[:3],
            factors, mode=n, rows_cap=rows_cap, row_offset=0,
            slab=ops.padded_rank(rank), blk=2 * blk, tile_rows=tile_rows),
            2 * blk)
        kw128 = dict(rows_cap=rows_cap, blk=2 * blk, tile_rows=tile_rows)
        t128 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_stream(
            *ops128, **kw128), 3)
        smem128 = K.gather_stream_smem_bytes(k, ops.padded_rank(rank),
                                             2 * blk, tile_rows, windows128)
        log(f"[stream-main] mode {n} single pass at blk={2 * blk}: windows "
            f"{windows128} (smem {smem128} B); B6 {t128:.3f} ms  [{gpu}]")
        del ops128
    profile_sweep(ft, rank, "pallas_fused_gather_stream", dev, blk=blk,
                  tile_rows=tile_rows, ordering="morton")
    return {"fused_mttkrp_nmode_gather_stream": (b6_launches, rows)}


def frow_findings(b1_ops, b1, blk: int, tile_rows: int, rows_cap: int,
                  gpu: str):
    """B6 on one mode's permuted stream at frow_tile 4 and 2 (the default
    is 8): fewer copied bytes per row a slot reads, more schedule entries.
    Findings for the next PR; no default changes. Each run must still be
    B1's bitwise."""
    from repro_torch.kernels.mttkrp import kernel as K, ops
    vals, idx_al, fmats, rows, tob = b1_ops
    k, rank = len(fmats), fmats[0].shape[1]
    for frow in (4, 2):
        fm = tuple(ops._pad_factor_rows(f, frow) for f in fmats)
        scheds, windows, _ = ops.stream_schedules(
            idx_al, blk, [f.shape[0] for f in fm], frow_tile=frow)
        kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=tile_rows,
                  frow_tile=frow)
        args = (vals, idx_al, fm, rows, tob, scheds)
        out = K.fused_mttkrp_nmode_gather_stream(*args, **kw)
        require(torch.equal(out, b1),
                f"B6 at frow_tile={frow} differs from B1 bitwise")
        ms = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_stream(*args, **kw),
                     3)
        stages, mappers = K.stream_ring(k, rank, blk, tile_rows, windows,
                                        frow_tile=frow)
        copied = stream_copy_bytes(vals, scheds, fm, blk, frow,
                                   K.STREAM_RANK_SLAB)
        tbps, l2b = l2_fields(copied, ms)
        log(f"[stream-frow] mode 0 frow_tile {frow}: windows {windows}, "
            f"stages {stages}, mappers {mappers}; B6 {ms:.3f} ms, == B1 "
            f"bitwise; L2 {copied} B of tiles copied at {tbps:.3f} TB/s, "
            f"L2 bound {l2b:.3f} ms  [{gpu}]")
        del out, scheds, fm


def phase_bf16_kernels(dev):
    """The bf16 variants on random streams: B1, B2, B3, B4 (R in {16,256})
    and B6 (R in {16,64}) against their plain versions, each == the bf16
    B1 bitwise, reruns bitwise; a chunked bf16 out-of-core run with
    mid-tile splits == its single pass == the direct launch."""
    from repro_torch.kernels.mttkrp import kernel as K, ops
    from repro_torch.oocore import executor, planner
    rng = np.random.default_rng(3)
    bf16 = torch.bfloat16
    cap, rows_cap = 1 << 20, 16_384
    kw = dict(rows_cap=rows_cap, blk=BLK, tile_rows=TILE_ROWS)
    for k, rank in itertools.product((2, 3), (16, 256)):
        slab = min(rank, 128)
        ops_ = random_operands(rng, k, rank, cap, rows_cap, slab, dev,
                               dtype=bf16)
        vals, idx_al, fmats, rows, tob = ops_
        require(fmats[0].dtype == bf16, "bf16 operands expected")
        what = f"K={k} R={rank}"
        b1 = K.fused_mttkrp_nmode_gather(*ops_, **kw)
        b1_again = K.fused_mttkrp_nmode_gather(*ops_, **kw)
        b2 = K.fused_mttkrp_nmode_gather_tiled(*ops_, rank_slab=slab, **kw)
        pre = ops.pregathered_rows(idx_al, fmats)
        b3 = K.fused_mttkrp_nmode(vals, pre, rows, tob, **kw)
        b4 = K.fused_mttkrp_nmode_tiled(vals, pre, rows, tob, rank_slab=16,
                                        **kw)
        torch.cuda.synchronize()
        err1 = compare(b1, K.fused_mttkrp_nmode_gather_plain(*ops_, **kw),
                       f"B1-bf16 {what}")
        err2 = compare(b2, K.fused_mttkrp_nmode_gather_tiled_plain(
            *ops_, rank_slab=slab, **kw), f"B2-bf16 {what}")
        err3 = compare(b3, K.fused_mttkrp_nmode_plain(vals, pre, rows, tob,
                                                      **kw), f"B3-bf16 {what}")
        err4 = compare(b4, K.fused_mttkrp_nmode_tiled_plain(
            vals, pre, rows, tob, rank_slab=16, **kw), f"B4-bf16 {what}")
        require(torch.equal(b1, b1_again), f"B1-bf16 {what}: rerun differs")
        for name, out in (("B2", b2), ("B3", b3), ("B4", b4)):
            require(torch.equal(out, b1),
                    f"{name}-bf16 {what}: differs from B1-bf16 bitwise")
        require(torch.equal(b3, K.fused_mttkrp_nmode(vals, pre, rows, tob,
                                                     **kw)),
                f"B3-bf16 {what}: rerun differs")
        t1 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather(*ops_, **kw), 5)
        f32_ops = ops_[:2] + (tuple(f.float() for f in fmats),) + ops_[3:]
        t1_f32 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather(*f32_ops, **kw),
                         5)
        t2 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_tiled(
            *ops_, rank_slab=slab, **kw), 5)
        t2_f32 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_tiled(
            *f32_ops, rank_slab=slab, **kw), 5)
        l2b, l2b_f32 = gather_l2_bytes(ops_), gather_l2_bytes(f32_ops)
        del f32_ops
        t3 = cuda_ms(lambda: K.fused_mttkrp_nmode(vals, pre, rows, tob, **kw),
                     5)
        t4 = cuda_ms(lambda: K.fused_mttkrp_nmode_tiled(
            vals, pre, rows, tob, rank_slab=16, **kw), 5)
        rkw = dict(nnz=int((vals != 0).sum()), rows_cap=rows_cap,
                   tile_rows=TILE_ROWS)
        log(f"[bf16-kernels] {what} nnz={cap}: max_abs_err B1 {err1:.3e} "
            f"B2 {err2:.3e} B3 {err3:.3e} B4 {err4:.3e}; B2==B3==B4==B1 "
            f"bitwise, reruns bitwise; B1-bf16 {l2_text(l2b, t1)} (fp32 B1 "
            f"same inputs {l2_text(l2b_f32, t1_f32)}); B2-bf16 (slab {slab}) "
            f"{l2_text(l2b, t2)} (fp32 B2 {l2_text(l2b_f32, t2_f32)}); "
            f"B1-bf16 {t1:.4f} ms, B3-bf16 "
            f"{t3:.4f} ms ({fused_ring_fields(pre, t3, **rkw)}), B4-bf16 "
            f"(slab 16) {t4:.4f} ms "
            f"({fused_ring_fields(pre, t4, slab=16, **rkw)})")
        del ops_, pre, b1, b1_again, b2, b3, b4
    cap, rows_cap = 1 << 20, 1024
    kw = dict(rows_cap=rows_cap, blk=STREAM_BLK, tile_rows=STREAM_TILE_ROWS)
    for k, rank in itertools.product((2, 3), (16, 64)):
        stream = random_stream(rng, k, rank, cap, rows_cap, dev)
        b1_ops = ops.gather_operands(*stream, mode=0, row_offset=0,
                                     slab=rank, dtype=bf16, **kw)
        s_ops, windows = stream_operands(b1_ops, STREAM_BLK)
        what = f"K={k} R={rank}"
        b6 = K.fused_mttkrp_nmode_gather_stream(*s_ops, **kw)
        b6_again = K.fused_mttkrp_nmode_gather_stream(*s_ops, **kw)
        b1 = K.fused_mttkrp_nmode_gather(*b1_ops, **kw)
        torch.cuda.synchronize()
        err = compare(b6, K.fused_mttkrp_nmode_gather_stream_plain(
            *s_ops, **kw), f"B6-bf16 {what}")
        require(torch.equal(b6, b6_again), f"B6-bf16 {what}: rerun differs")
        require(torch.equal(b6, b1),
                f"B6-bf16 {what}: differs from B1-bf16 bitwise")
        okw = dict(mode=0, gather_dtype="bfloat16", **kw)
        single, st1 = executor.mttkrp_out_of_core(*stream, **okw)
        budget = 48 * planner.stream_chunk_bytes(STREAM_BLK, k,
                                                 st1.window_tiles)
        chunked, st2 = executor.mttkrp_out_of_core(
            *stream, max_chunk_bytes=budget, **okw)
        torch.cuda.synchronize()
        splits = mid_tile_splits(b1_ops[4], st2.chunk_block_counts)
        require(st2.chunks >= 4 and splits > 0,
                f"B6-bf16 {what}: {st2.chunks} chunks, {splits} mid-tile "
                "splits")
        require(torch.equal(chunked, single),
                f"B6-bf16 {what}: chunked run differs from the single pass")
        require(torch.equal(single, b6),
                f"B6-bf16 {what}: the executor differs from the launch")
        stages, mappers = K.stream_ring(k, rank, STREAM_BLK, STREAM_TILE_ROWS,
                                        windows, gather_itemsize=2)
        t6 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_stream(*s_ops, **kw),
                     3)
        f32_s = s_ops[:2] + (tuple(f.float() for f in s_ops[2]),) + s_ops[3:]
        t6_f32 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_stream(
            *f32_s, **kw), 3)
        copied = stream_copy_bytes(s_ops[0], s_ops[5], s_ops[2], STREAM_BLK,
                                   K.FACTOR_ROW_TILE, K.STREAM_RANK_SLAB)
        del f32_s
        log(f"[bf16-kernels] B6 {what} nnz={cap} blk={STREAM_BLK} windows="
            f"{windows} stages={stages} mappers={mappers}: max_abs_err "
            f"{err:.3e}, B6==B1 bitwise, rerun bitwise, {st2.chunks} chunks "
            f"with {splits} mid-tile splits == single pass bitwise; tile "
            f"bytes {st1.distinct_tile_bytes} (bf16); B6-bf16 "
            f"{l2_text(copied, t6)} (fp32 B6 same stream "
            f"{l2_text(2 * copied, t6_f32)})")
        del stream, b1_ops, s_ops, b6, b6_again, b1, single, chunked
    torch.cuda.empty_cache()


def bf16_path_rows(kern, plain, args, kw, *, what, reps=5, l2_bytes,
                   bound):
    """Time ``kern`` and ``plain`` on ``args`` (CUDA events) and compare
    them; returns the row of the kernels JSON for one mode."""
    out = kern(*args, **kw)
    ref = plain(*args, **kw)
    err = compare(out, ref, what)
    t_k = cuda_ms(lambda: kern(*args, **kw), reps)
    t_p = cuda_ms(lambda: plain(*args, **kw), 1)
    del ref
    return out, dict(err=err, ms=t_k, plain_ms=t_p, bound_ms=bound[0],
                     bound_by=bound[1], l2_bytes=l2_bytes)


@contextlib.contextmanager
def patched(module, **attrs):
    """``module``'s attributes set to ``attrs`` inside the block."""
    saved = {a: getattr(module, a) for a in attrs}
    for a, v in attrs.items():
        setattr(module, a, v)
    try:
        yield
    finally:
        for a, v in saved.items():
            setattr(module, a, v)


def column_b1_bf16(args, kw):
    """The first bf16 kernel at a narrow slab (a column a lane,
    ``gather_mttkrp_bf16_column_launch`` of ``DESIGNS_SRC``, built by
    phase_build) on B1's inputs: the wrapper's launch with that library
    and entry point and that kernel's lane count and shared memory."""
    from repro_torch.kernels.mttkrp import build, kernel as K
    with patched(build, load=lambda name: _DESIGNS["lib"]), \
            patched(K, _entry=lambda lib, mats: f"{lib}_bf16_column_launch",
                    _gather_design=lambda slab, gi: "column"):
        return K.fused_mttkrp_nmode_gather(*args, **kw)


def tail_walk(b1_ops, *, rows_cap: int, blk: int, tile_rows: int) -> dict:
    """The last tile's walk before and after the cut (S1): the slots of
    its run, and of the run up to the live end ``live_end_kernel``
    computes on the card (``kernel.live_tile_starts``), which must equal
    the plain reckoning and end within one block of the run's last live
    slot."""
    from repro_torch.kernels.mttkrp import kernel as K
    vals, tob = b1_ops[0], b1_ops[4]
    kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
    s = K.live_tile_starts(vals, tob, **kw).tolist()
    b0, b1, cut = s[-2], s[-1], s[0]
    plain = K.live_end_plain(vals, tob, **kw)
    require(cut == plain, f"live end {cut} on the card, {plain} plain")
    live = torch.nonzero(vals[b0 * blk:b1 * blk]).flatten()
    last = int(live[-1]) if live.numel() else -1
    after = (max(b0, cut) - b0) * blk
    require(after - 1 - last < blk and after > last,
            f"the cut walk ends at slot {after} of the run, its last live "
            f"slot is {last}")
    return dict(before=(b1 - b0) * blk, after=after, last_live=last)


def narrow_launch_shape(k: int, rank: int, tile_rows: int, num_tiles: int,
                        dev) -> dict:
    """B1-bf16's narrow kernel at these inputs: threads and shared memory
    a CTA, its ptxas registers, the CTAs one SM holds (the least of the
    32-block, 2048-thread, 64 Ki-register and shared-memory limits) and
    those the grid gives it (tiles over SMs), and the factor rows it can
    keep in flight an SM, reckoned from that launch shape (not measured):
    resident CTAs x groups x two batches of slots x K."""
    from repro_torch.kernels.mttkrp import build, kernel as K, lowering
    groups, lanes = K._groups(tile_rows), K._gather_lanes(rank, 2)
    threads = groups * lanes
    smem = K.gather_smem_bytes(k, rank, tile_rows, gather_itemsize=2)
    want = f"gather_mttkrp_narrow_kernel<{k}, bf16>"
    regs = [r["registers"] for name, r in lowering.parse_ptxas_report(
        build.build()["gather_mttkrp"][1]).items()
        if lowering.kernel_label(name) == want]
    require(len(regs) == 1, f"no ptxas line for {want}")
    warps = -(-threads // 32)
    per_sm = min(32, 64 // warps,
                 65536 // (warps * 32 * (-(-regs[0] // 8) * 8)),
                 K.SM_SMEM_BYTES // (smem + K.CTA_SMEM_RESERVED))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = min(per_sm, -(-num_tiles // sms))
    batch = max(1, K.NARROW_UNROLL // k)
    return dict(threads=threads, smem=smem, registers=regs[0],
                ctas_per_sm=per_sm, resident=resident,
                rows_in_flight=resident * groups * 2 * batch * k)


def phase_bf16_main(ft, dev, gpu: str):
    """The bf16 main path on the nell-2 stand-in that phase_main built, at
    R=16: ``cp_als_distributed`` with ``pallas_fused_gather_bf16`` (the
    bf16 B1 only); per mode the bf16 mode steps of B2 (R=256), B3, B4 and
    the bf16 out-of-core run (B6), each driven with the counts zeroed just
    before and read just after; then every bf16 kernel at its path's
    inputs against its plain version and the bf16 B1 bitwise, timed beside
    the fp32 kernel on the same inputs; a profiled bf16 sweep."""
    from repro_torch.core import cpals
    from repro_torch.kernels.mttkrp import kernel as K, ops
    from repro_torch.oocore import executor, planner
    from repro_torch.reorder import reorder_stream
    rank, bf16 = 16, torch.bfloat16
    t_phase = time.perf_counter()
    # --- the main bf16 path: counts zeroed just before, read just after --
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = cpals.cp_als_distributed(ft, rank,
                                   backend="pallas_fused_gather_bf16",
                                   iters=2, tol=0.0)
    launched = counts()
    require_only(launched, "fused_mttkrp_nmode_gather" + BF16, 6,
                 "pallas_fused_gather_bf16 (the bf16 B1 on every mode)")
    require(all(np.isfinite(res.fits)) and max(res.fits) <= 1.0,
            f"bf16 fits {res.fits}")
    for f in res.factors:
        require(bool(np.isfinite(f).all()), "non-finite bf16 factor")
    log(f"[bf16-main] cp_als_distributed R={rank} pallas_fused_gather_bf16: "
        f"fits {res.fits}; ms per sweep "
        f"{[round(x * 1e3, 2) for x in res.sweep_seconds]}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; bf16 B1 "
        f"launches {launched['fused_mttkrp_nmode_gather' + BF16]}")
    launches = {"fused_mttkrp_nmode_gather" + BF16:
                launched["fused_mttkrp_nmode_gather" + BF16]}
    del res

    rt, packed = runtime(ft, rank, gather_dtype="bfloat16")
    wk = one_device(dev)
    stream, factors, lam, x2 = cpals.device_state(ft, rt, packed, seed=0,
                                                  workers=wk)
    del packed
    sweep = cpals.als_sweep(stream, factors, lam, x2, rt, workers=wk,
                            sweep0=True, backend="pallas_fused_gather_bf16")
    nmodes, k = rt.nmodes, rt.nmodes - 1
    blk, sblk, tile_rows = rt.blk, MAIN_STREAM_BLK, rt.tile_rows
    # B2's path runs at R=256 (where auto takes B2 on this tensor's modes
    # 0 and 1), on seeded random factors in the same row spaces.
    gen = torch.Generator(device=dev).manual_seed(1)
    f256 = [torch.randn(rt.i_pad[w], 256, generator=gen, device=dev)
            for w in range(nmodes)]
    rows = {name + BF16: [] for name in (
        "fused_mttkrp_nmode_gather", "fused_mttkrp_nmode_gather_tiled",
        "fused_mttkrp_nmode", "fused_mttkrp_nmode_tiled",
        "fused_mttkrp_nmode_gather_stream")}
    cur = one_worker(stream)
    for n in range(nmodes):
        rows_cap = rt.rows_cap[n]
        facs = list(sweep.factors[:n]) + list(factors[n:])
        frows = tuple(facs[w].shape[0] for w in range(nmodes) if w != n)
        okw = dict(mode=n, rows_cap=rows_cap, row_offset=0, blk=blk,
                   tile_rows=tile_rows)
        # --- driven bf16 paths of B2 (R=256, two slabs), B3, B4 and B6
        # (counted) ---
        for backend, name in (
                ("pallas_fused", "fused_mttkrp_nmode"),
                ("pallas_fused_tiled", "fused_mttkrp_nmode_tiled")):
            reset_counts()
            out = ops.mttkrp_device_step(*cur, facs, backend=backend,
                                         gather_dtype="bfloat16", **okw)
            launched = counts()
            require_only(launched, name + BF16, 1,
                         f"mode {n} {backend} bf16 step")
            require(torch.equal(out, sweep.mttkrp[n][0]),
                    f"mode {n} {backend} bf16 step differs from B1-bf16")
            launches[name + BF16] = launches.get(name + BF16, 0) + 1
            del out
        reset_counts()
        out2 = ops.mttkrp_device_step(*cur, f256, gather_dtype="bfloat16",
                                      backend="pallas_fused_gather_tiled",
                                      **okw)
        launched = counts()
        require_only(launched, "fused_mttkrp_nmode_gather_tiled" + BF16, 1,
                     f"mode {n} pallas_fused_gather_tiled bf16 step (R=256)")
        launches["fused_mttkrp_nmode_gather_tiled" + BF16] = launches.get(
            "fused_mttkrp_nmode_gather_tiled" + BF16, 0) + 1
        num_blocks = ops.n_pad_for(cur[0].shape[0], rows_cap, sblk,
                                   tile_rows) // sblk
        budget = num_blocks * planner.stream_chunk_bytes(sblk, k,
                                                         (1,) * k) // 5
        reset_counts()
        t0 = time.perf_counter()
        out6, stats = executor.mttkrp_out_of_core(
            *cur, facs, mode=n, rows_cap=rows_cap, blk=sblk,
            tile_rows=tile_rows, max_chunk_bytes=budget, ordering="morton",
            gather_dtype="bfloat16")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = counts()
        require_only(launched, "fused_mttkrp_nmode_gather_stream" + BF16,
                     stats.chunks, f"mode {n} bf16 out-of-core run")
        launches["fused_mttkrp_nmode_gather_stream" + BF16] = launches.get(
            "fused_mttkrp_nmode_gather_stream" + BF16, 0) + stats.chunks

        # --- each bf16 kernel at its path's inputs (launches not counted) --
        nnz = int(cur[2].sum())
        b1_ops = ops.gather_operands(*cur, facs, slab=rank, dtype=bf16,
                                     **okw)
        kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
        bound = kernel_bound_ms(b1_ops, rows_cap=rows_cap, tile_rows=tile_rows)
        l2b = gather_l2_bytes(b1_ops)
        b1, row = bf16_path_rows(
            K.fused_mttkrp_nmode_gather,
            K.fused_mttkrp_nmode_gather_plain, b1_ops, kw,
            what=f"B1-bf16 mode {n}", l2_bytes=l2b, bound=bound)
        require(torch.equal(b1[:, :rank], sweep.mttkrp[n][0]),
                f"mode {n}: rebuilt inputs do not reproduce the bf16 sweep")
        rows["fused_mttkrp_nmode_gather" + BF16].append(row)
        # The first bf16 kernel on the same inputs, in the same run:
        # bitwise the narrow kernel, timed in turns with it.
        require(torch.equal(column_b1_bf16(b1_ops, kw), b1),
                f"mode {n}: the column B1-bf16 differs from the narrow "
                "kernel")
        t_old = cuda_ms(lambda: column_b1_bf16(b1_ops, kw), 5)
        t_new = cuda_ms(lambda: K.fused_mttkrp_nmode_gather(*b1_ops, **kw),
                        5)
        walk = tail_walk(b1_ops, **kw)
        shape = narrow_launch_shape(k, rank, tile_rows, rows_cap // tile_rows,
                                    dev)
        row.update(design=K._gather_design(rank, 2), column_ms=t_old)
        log(f"[bf16-main] B1-bf16 mode {n}: design "
            f"{K._gather_design(rank, 2)} (gather_mttkrp_narrow_kernel<{k}, "
            f"bf16>: {shape['threads']} threads, {shape['smem']} B shared "
            f"memory, {shape['registers']} registers a thread; "
            f"{shape['ctas_per_sm']} CTAs fit an SM, the grid's "
            f"{rows_cap // tile_rows} tiles give it {shape['resident']}: "
            f"{shape['rows_in_flight']} factor rows in flight an SM, "
            f"reckoned from this launch shape, not measured); "
            f"{row['ms']:.3f} ms, then {t_new:.3f} ms after the first bf16 "
            f"kernel (a column a lane) {t_old:.3f} ms on the same inputs, "
            f"bitwise "
            f"equal; the last tile's CTA walks {walk['before']} slots "
            f"before the cut, {walk['after']} after it (its last live slot "
            f"{walk['last_live']} of the run)  [{gpu}]")
        f32_ops = ops.gather_operands(*cur, facs, slab=rank, **okw)
        t_f32 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather(*f32_ops, **kw), 5)
        log(f"[bf16-main] B1-bf16 mode {n}: {nnz} nnz, kernel "
            f"{row['ms']:.3f} ms (fp32 B1 {t_f32:.3f} ms, same inputs: "
            f"{l2_text(gather_l2_bytes(f32_ops), t_f32)}), plain "
            f"{row['plain_ms']:.3f} ms, HBM bound {bound[0]:.3f} ms "
            f"({bound[1]}); L2 {l2b} B gathered at "
            f"{l2_fields(l2b, row['ms'])[0]:.3f} TB/s, L2 bound "
            f"{l2_fields(l2b, row['ms'])[1]:.3f} ms, "
            f"{l2_fields(l2b, row['ms'])[1] / row['ms']:.1%} of it (fp32 "
            f"{gather_l2_bytes(f32_ops)} B); max_abs_err {row['err']:.3e}, "
            f"== the bf16 sweep bitwise  [{gpu}]")
        del f32_ops
        # B2-bf16 at its path's inputs: R=256 in two 128-column slabs,
        # == the path's output and == B1-bf16 at R=256 bitwise.
        ops256 = ops.gather_operands(*cur, f256, slab=256, dtype=bf16, **okw)
        tkw = dict(rank_slab=128, **kw)
        l2b256 = gather_l2_bytes(ops256)
        bound256 = kernel_bound_ms(ops256, rows_cap=rows_cap,
                                   tile_rows=tile_rows)
        b2, row = bf16_path_rows(
            K.fused_mttkrp_nmode_gather_tiled,
            K.fused_mttkrp_nmode_gather_tiled_plain, ops256, tkw,
            what=f"B2-bf16 mode {n}", reps=3, l2_bytes=l2b256,
            bound=bound256)
        require(torch.equal(b2, out2), f"mode {n}: B2-bf16 differs from its "
                "path's output")
        require(torch.equal(b2, K.fused_mttkrp_nmode_gather(*ops256, **kw)),
                f"mode {n}: B2-bf16 differs from B1-bf16 at R=256")
        rows["fused_mttkrp_nmode_gather_tiled" + BF16].append(row)
        f32_256 = ops.gather_operands(*cur, f256, slab=256, **okw)
        t2_f32 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_tiled(
            *f32_256, **tkw), 3)
        tbps, l2bound = l2_fields(l2b256, row["ms"])
        log(f"[bf16-main] B2-bf16 mode {n}: R=256, 2 slabs, kernel "
            f"{row['ms']:.3f} ms (fp32 B2 {t2_f32:.3f} ms, same inputs: "
            f"{l2_text(gather_l2_bytes(f32_256), t2_f32)}), plain "
            f"{row['plain_ms']:.3f} ms, bound {bound256[0]:.3f} ms "
            f"({bound256[1]}); L2 {l2b256} B gathered at {tbps:.3f} TB/s, L2 "
            f"bound {l2bound:.3f} ms, {l2bound / row['ms']:.1%} of it; "
            f"max_abs_err {row['err']:.3e}, == B1-bf16"
            f" at R=256 bitwise  [{gpu}]")
        del b2, out2, ops256, f32_256
        # B3-bf16 / B4-bf16 on rows pre-gathered in bf16 (timed: the gather
        # of (n_pad, 16) bf16 rows, 32 B each).
        vals, idx_al, fmats, r_al, tob = b1_ops
        t_pre = cuda_ms(lambda: ops.pregathered_rows(idx_al, fmats), 3)
        pre = ops.pregathered_rows(idx_al, fmats)
        f32_fm = tuple(f.float() for f in fmats)
        t_pre32 = cuda_ms(lambda: ops.pregathered_rows(idx_al, f32_fm), 3)
        fbound = fused_bound_ms(nnz, rank, k, rows_cap=rows_cap,
                                tile_rows=tile_rows, itemsize=2)
        fl2 = nnz * k * rank * 2
        b3, row = bf16_path_rows(
            K.fused_mttkrp_nmode, K.fused_mttkrp_nmode_plain,
            (vals, pre, r_al, tob), kw, what=f"B3-bf16 mode {n}",
            l2_bytes=fl2, bound=fbound)
        require(torch.equal(b3, b1), f"mode {n}: B3-bf16 differs from B1-bf16")
        rows["fused_mttkrp_nmode" + BF16].append(row)
        del f32_fm
        pre32 = ops.pregathered_rows(idx_al, tuple(f.float() for f in fmats))
        t3_f32 = cuda_ms(lambda: K.fused_mttkrp_nmode(vals, pre32, r_al, tob,
                                                      **kw), 5)
        del pre32
        rkw = dict(nnz=nnz, rows_cap=rows_cap, tile_rows=tile_rows)
        log(f"[bf16-main] B3-bf16 mode {n}: kernel {row['ms']:.3f} ms (fp32 "
            f"B3 {t3_f32:.3f} ms on the same values' fp32 rows), plain "
            f"{row['plain_ms']:.3f} ms, HBM bound {fbound[0]:.3f} ms "
            f"({fbound[1]}, 72 B per nonzero; "
            f"{fused_ring_fields(pre, row['ms'], **rkw)}); pregathered_rows "
            f"bf16 {t_pre:.3f} ms vs fp32 {t_pre32:.3f} ms; max_abs_err "
            f"{row['err']:.3e}, == B1-bf16 bitwise  [{gpu}]")
        b4, row = bf16_path_rows(
            K.fused_mttkrp_nmode_tiled,
            K.fused_mttkrp_nmode_tiled_plain, (vals, pre, r_al, tob),
            dict(rank_slab=16, **kw), what=f"B4-bf16 mode {n}",
            l2_bytes=fl2, bound=fbound)
        require(torch.equal(b4, b1), f"mode {n}: B4-bf16 differs from B1-bf16")
        rows["fused_mttkrp_nmode_tiled" + BF16].append(row)
        log(f"[bf16-main] B4-bf16 mode {n}: one slab, kernel {row['ms']:.3f} "
            f"ms ({fused_ring_fields(pre, row['ms'], slab=16, **rkw)}), "
            f"plain {row['plain_ms']:.3f} ms, == B1-bf16 bitwise  [{gpu}]")
        del b1_ops, vals, idx_al, fmats, r_al, tob, pre, b1, b3, b4
        # B6-bf16 at the stream path's inputs: the Morton-permuted stream
        # in 64-slot blocks; == the bf16 B1 on that stream and == the
        # out-of-core run.
        ridx, rval, rvalid, _ = reorder_stream(
            *cur, mode=n, ordering="morton", tile_rows=tile_rows,
            max_rows=max(frows))
        m_ops = ops.gather_operands(ridx, rval, rvalid, facs, slab=rank,
                                    dtype=bf16, **dict(okw, blk=sblk))
        del ridx, rval, rvalid
        skw = dict(rows_cap=rows_cap, blk=sblk, tile_rows=tile_rows)
        b1m = K.fused_mttkrp_nmode_gather(*m_ops, **skw)
        require(torch.equal(out6, b1m[:, :rank]),
                f"mode {n}: bf16 out-of-core output differs from B1-bf16")
        s_ops, windows = stream_operands(m_ops, sblk)
        copied = stream_copy_bytes(s_ops[0], s_ops[5], s_ops[2], sblk,
                                   K.FACTOR_ROW_TILE, K.STREAM_RANK_SLAB)
        sbound = kernel_bound_ms(m_ops, rows_cap=rows_cap,
                                 tile_rows=tile_rows, scheds=s_ops[5])
        b6, row = bf16_path_rows(
            K.fused_mttkrp_nmode_gather_stream,
            K.fused_mttkrp_nmode_gather_stream_plain, s_ops, skw,
            what=f"B6-bf16 mode {n}", reps=3, l2_bytes=copied, bound=sbound)
        require(torch.equal(b6, b1m), f"mode {n}: B6-bf16 differs from B1-bf16")
        rows["fused_mttkrp_nmode_gather_stream" + BF16].append(row)
        f32_s = s_ops[:2] + (tuple(f.float() for f in s_ops[2]),) + s_ops[3:]
        t6_f32 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_stream(
            *f32_s, **skw), 3)
        stages, mappers = K.stream_ring(k, rank, sblk, tile_rows, windows,
                                        gather_itemsize=2)
        tbps, l2bound = l2_fields(copied, row["ms"])
        log(f"[bf16-main] B6-bf16 mode {n}: Morton, blk={sblk}, out-of-core "
            f"{secs:.2f} s in {stats.chunks} chunks == B1-bf16 bitwise, tile "
            f"bytes counted {stats.distinct_tile_bytes} (bf16); single pass "
            f"windows {windows}, stages {stages}, mappers {mappers}: kernel "
            f"{row['ms']:.3f} ms (fp32 B6 {t6_f32:.3f} ms, same stream: "
            f"{l2_text(2 * copied, t6_f32)}), "
            f"plain {row['plain_ms']:.3f} ms, HBM bound {sbound[0]:.3f} ms "
            f"({sbound[1]}); L2 {copied} B of tiles copied at {tbps:.3f} "
            f"TB/s, L2 bound {l2bound:.3f} ms, {l2bound / row['ms']:.1%} of "
            f"it; max_abs_err {row['err']:.3e}  "
            f"[{gpu}]")
        del m_ops, s_ops, f32_s, b1m, b6, out6
        cur = remap_one(cur, (n + 1) % nmodes, rt)
    del cur, stream, factors, sweep, f256
    torch.cuda.empty_cache()
    profile_sweep(ft, rank, "pallas_fused_gather_bf16", dev)
    log(f"[bf16-main] phase took {time.perf_counter() - t_phase:.1f} s")
    return {name: (launches[name], rows[name]) for name in rows}


def phase_bf16_fit(gpu: str):
    """The reference's bench_bf16_convergence as one line: the same CP-ALS
    (B1, seed 1, tol 0) in fp32 and with bf16 gathers on a generated
    low-rank tensor (the nell-2 stand-in's random values carry no signal);
    both fit traces, the final gap and the largest per-sweep gap. The
    reference's bench calls bf16 converged when the final gap is below
    1e-2; the (N-1)*2^-8 bound is per mode step and is printed beside the
    largest relative gap, not required of a whole run (bf16 may settle on
    another fixed point)."""
    from repro_torch.core import cpals, flycoo, tensors
    shape, true_rank, nnz, rank, sweeps = (600, 500, 400), 16, 10_000_000, \
        16, 10
    t, _ = tensors.low_rank_sparse_tensor(shape, true_rank, nnz, seed=0)
    ft = flycoo.build_flycoo(t, 1)
    kw = dict(iters=sweeps, seed=1, tol=0.0, backend="pallas_fused_gather")
    fits = {}
    for gd in ("float32", "bfloat16"):
        res = cpals.cp_als_distributed(ft, rank, gather_dtype=gd, **kw)
        require(len(res.fits) == sweeps and all(np.isfinite(res.fits)),
                f"{gd} fits {res.fits}")
        fits[gd] = res.fits
    gaps = [abs(a - b) for a, b in zip(fits["float32"], fits["bfloat16"])]
    rel = max(g / abs(a) for g, a in zip(gaps, fits["float32"]))
    bound = (len(shape) - 1) * 2.0 ** -8
    log(f"[bf16-fit] low_rank_sparse_tensor shape={shape} true rank "
        f"{true_rank} nnz={t.nnz} (seed 0), CP-ALS R={rank} B1 seed 1 tol 0, "
        f"{sweeps} sweeps: fits fp32 {fits['float32']}; fits bf16 "
        f"{fits['bfloat16']}; final gap {gaps[-1]:.3e}, largest per-sweep "
        f"gap {max(gaps):.3e} (largest relative {rel:.3e}; one mode step's "
        f"bound (N-1)*2^-8 = {bound:.3e})  [{gpu}]")
    require(gaps[-1] < 1e-2, f"bf16 did not converge within 1e-2 of fp32: "
            f"final gap {gaps[-1]}")
    return t, fits["float32"]


def event_ms(fn):
    """``(fn(), CUDA-event ms of the call)``."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def dist_state(ft, rt, packed, workers, seed: int = 0):
    """``(stream, factors)`` of ``cpals.device_state`` for ``workers``."""
    from repro_torch.core import cpals
    stream, factors, _, _ = cpals.device_state(ft, rt, packed, seed=seed,
                                               workers=workers)
    return stream, factors


def natural(ft, rt, outs):
    """Replicated permuted-row outputs → natural row order (host)."""
    from repro_torch.core import distributed as dist
    return [torch.from_numpy(dist.unpermute_factor(ft, rt, n,
                                                   o.cpu().numpy()))
            for n, o in enumerate(outs)]


def phase_dist_main(ft1, dev, gpu: str):
    """``[dist-main]``: Dynasor on D=4 workers in one process
    (``LocalWorkers``), on the nell-2 stand-in that phase_main built (its
    tensor, rebuilt as FLYCOO for 4 workers), R=16: host time and LPT
    balance; ``cp_als_distributed`` with ``auto`` (B1 on every worker and
    mode, 3 sweeps) with fits, sweep ms on both clocks and a profiled
    sweep; D=4 outputs in natural order against D=1's; the six backends
    bitwise equal at D=4 with row offsets; the paper's Fig. 9 paths and
    the bytes they hand to the collectives."""
    from repro_torch.core import cpals, distributed as dist, flycoo
    from repro_torch.core.workers import LocalWorkers
    from repro_torch.kernels.mttkrp import kernel as K, ops
    rank, D = 16, 4
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ft = flycoo.build_flycoo(ft1.tensor, D)
    t_fly = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt, packed = runtime(ft, rank)           # a new tensor: built here
    t_prep = time.perf_counter() - t0
    loads = np.stack([np.bincount(ft.owner_of(n), minlength=D)
                      for n in range(ft.nmodes)])
    ratio = [float(r.max() / r.mean()) for r in loads]
    log(f"[dist-main] D={D} workers in one process (LocalWorkers): "
        f"build_flycoo {t_fly:.1f} s, prepare_runtime {t_prep:.1f} s (host); "
        f"nonzeros per worker per mode (LPT) {loads.tolist()}, max/mean "
        f"{[round(r, 6) for r in ratio]}; nnz_cap {rt.nnz_cap}, rows_cap "
        f"{rt.rows_cap}, exchange caps {rt.bucket_caps}, blk {rt.blk}")
    rt1, packed1 = runtime(ft1, rank)
    for r_ in (rt1, rt):
        picks = [ops.select_backend(
            "auto", nmodes=r_.nmodes, rank=rank, blk=r_.blk,
            tile_rows=r_.tile_rows,
            factor_rows=[r_.i_pad[w] for w in range(r_.nmodes) if w != n])
            for n in range(r_.nmodes)]
        log(f"[dist-main] auto at D={r_.num_workers}, R={rank}: per mode "
            f"{picks} (factor rows {list(r_.i_pad)})")
        require(picks == ["pallas_fused_gather"] * r_.nmodes,
                f"auto at D={r_.num_workers} picked {picks}")

    # --- the main path: counts zeroed just before, read just after -----
    reset_counts()
    t0 = time.perf_counter()
    res = cpals.cp_als_distributed(ft, rank, backend="auto", iters=3,
                                   tol=0.0)
    wall = time.perf_counter() - t0
    launched = counts()
    want = 3 * ft.nmodes * D
    log(f"[dist-main] cp_als_distributed D={D} R={rank} backend=auto: fits "
        f"{res.fits}; ms per sweep (host) "
        f"{[round(x * 1e3, 2) for x in res.sweep_seconds]}; call {wall:.1f} "
        f"s incl. host prepare_runtime; B1 launches "
        f"{launched['fused_mttkrp_nmode_gather']} ({ft.nmodes * D} per "
        f"sweep)")
    require_only(launched, "fused_mttkrp_nmode_gather", want,
                 f"auto at D={D} (B1 on every worker and mode)")
    require(all(np.isfinite(res.fits)) and max(res.fits) <= 1.0,
            f"D={D} fits {res.fits}")
    for f in res.factors:
        require(bool(np.isfinite(f).all()), "non-finite factor at D=4")
    dist_launches = launched["fused_mttkrp_nmode_gather"]
    del res

    # --- sweeps on CUDA events (not counted), then a profiled one -------
    wk = LocalWorkers(D, dev)
    stream, factors, lam, x2 = cpals.device_state(ft, rt, packed, seed=0,
                                                  workers=wk)
    ev_ms, host_ms = [], []
    for it in range(3):
        t0 = time.perf_counter()
        sw, ms = event_ms(lambda: cpals.als_sweep(
            stream, factors, lam, x2, rt, workers=wk, sweep0=it == 0,
            backend="auto"))
        float(sw.fit)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(ms)
        if it == 0:
            sweep0 = (factors, sw)
        stream, factors, lam = sw.stream, sw.factors, sw.lam
    log(f"[dist-main] D={D} als_sweep x3: ms per sweep host "
        f"{[round(x, 2) for x in host_ms]}, CUDA events "
        f"{[round(x, 2) for x in ev_ms]}  [{gpu}]")
    del stream, factors, lam, sw
    torch.cuda.empty_cache()
    profile_sweep(ft, rank, "auto", dev)

    # --- B1 against its plain version at every worker's row offset ------
    # The remap does not read the factors: the mode-n layouts of every
    # sweep are these.
    stream, factors = dist_state(ft, rt, packed, wk)
    mode_streams = [stream]
    for n in range(1, ft.nmodes):
        mode_streams.append(dist.device_remap(*mode_streams[-1], n, rt,
                                              wk)[:3])
    init, sw = sweep0
    errs, b1_ms, plain_ms = [], [], []
    for n, cur in enumerate(mode_streams):
        facs = list(sw.factors[:n]) + list(init[n:])
        kw = dict(rows_cap=rt.rows_cap[n], blk=rt.blk,
                  tile_rows=rt.tile_rows)
        for d in range(D):
            operands = ops.gather_operands(
                cur[0][d], cur[1][d], cur[2][d], facs, mode=n,
                rows_cap=rt.rows_cap[n], row_offset=d * rt.rows_cap[n],
                blk=rt.blk, tile_rows=rt.tile_rows,
                slab=ops.padded_rank(rank))
            out, ms = event_ms(
                lambda: K.fused_mttkrp_nmode_gather(*operands, **kw))
            require(torch.equal(out[:, :rank], sw.mttkrp[n][d]),
                    f"D={D} B1 worker {d} mode {n}: rebuilt inputs do not "
                    "reproduce the sweep's output bitwise")
            plain, pms = event_ms(
                lambda: K.fused_mttkrp_nmode_gather_plain(*operands, **kw))
            errs.append(compare(out, plain, f"D={D} B1 worker {d} mode {n}"))
            b1_ms.append(ms)
            plain_ms.append(pms)
            del operands, out, plain
    del init, sw, sweep0
    shape = (ft.nmodes, D)
    log(f"[dist-main] B1 at D={D} vs its plain version on the sweep-0 "
        f"inputs of every worker (row offset d*rows_cap) and mode: == the "
        f"sweep's output bitwise; max_abs_err {max(errs):.3e} (rtol {RTOL}, "
        f"atol {ATOL_FRAC}*max|plain|); CUDA-event ms per mode x worker B1 "
        f"{np.round(np.reshape(b1_ms, shape), 3).tolist()}, plain "
        f"{np.round(np.reshape(plain_ms, shape), 3).tolist()}  [{gpu}]")

    # --- D=4 against D=1, natural row order -----------------------------
    def warm_timed(fn, reps: int = 3):
        """``(fn(), CUDA-event ms of each of reps calls, bytes one call
        hands to the collectives)``, after an untimed call: the first
        carries first-use costs (allocator growth, kernel loads) that one
        path may pay for another."""
        fn()
        times = []
        for _ in range(reps):
            wk.reset_bytes()
            out, ms = event_ms(fn)
            times.append(round(ms, 3))
        return out, times, dict(wk.sent_bytes)

    (outs4, _, diags), dyn_ms, dyn_bytes = warm_timed(
        lambda: dist.make_spmttkrp_all_modes(rt, wk, backend="auto")(
            *stream, *factors))
    dropped = int(diags["dropped"].sum())
    require(dropped == 0, f"D={D}: {dropped} nonzeros dropped")
    w1 = LocalWorkers(1, dev)
    s1, f1 = dist_state(ft1, rt1, packed1, w1)
    outs1, _, _ = dist.make_spmttkrp_all_modes(rt1, w1, backend="auto")(
        *s1, *f1)
    del s1, f1, packed1
    nat4, nat1 = natural(ft, rt, outs4), natural(ft1, rt1, outs1)
    errs = [compare(a, b, f"D={D} vs D=1 mode {n}")
            for n, (a, b) in enumerate(zip(nat4, nat1))]
    log(f"[dist-main] make_spmttkrp_all_modes auto: D={D} vs D=1 in natural "
        f"row order, max_abs_err per mode {[f'{e:.3e}' for e in errs]} "
        f"(rtol {RTOL}, atol {ATOL_FRAC}*max|D=1|); dropped {dropped}")

    # --- the six kernels at D=4, row offsets, one aligned stream --------
    rt64 = dataclasses.replace(rt, blk=MAIN_STREAM_BLK)
    ref_outs = None
    for name, backend in BACKEND_OF.items():
        got, _, _ = dist.make_spmttkrp_all_modes(rt64, wk, backend=backend)(
            *stream, *factors)
        if ref_outs is None:
            ref_outs = got
        same = all(torch.equal(a, b) for a, b in zip(got, ref_outs))
        require(same, f"D={D} {backend} differs from B1 bitwise")
        del got
        ms = [[event_ms(lambda: dist.device_mttkrp(
            cur[0][d], cur[1][d], cur[2][d], factors, n, rt64, backend,
            worker=d))[1] for d in range(D)]
            for n, cur in enumerate(mode_streams)]
        log(f"[dist-main] {name} ({backend}) D={D} blk={rt64.blk}: == B1 "
            f"bitwise on every mode; CUDA-event ms of each worker's mode "
            f"step (operand build + kernel), per mode x worker "
            f"{np.round(ms, 3).tolist()}, mean per worker "
            f"{np.round(np.mean(ms, 0), 3).tolist()}  [{gpu}]")
    del ref_outs, mode_streams, cur

    # --- the paper's comparison (Fig. 9) --------------------------------
    rows = [("dynasor (remap)", outs4, dyn_ms, dyn_bytes)]
    (case2, _, _), ms, sent = warm_timed(
        lambda: dist.make_spmttkrp_all_modes(rt, wk, backend="auto",
                                             remap=False)(*stream, *factors))
    rows.append(("case 2 (no remap)", case2, ms, sent))
    del stream
    even = tuple(torch.from_numpy(a).to(dev)
                 for a in dist.even_split_pack(ft, rt))
    rows.append(("baseline (even split)",) + warm_timed(
        lambda: dist.make_baseline_all_modes(rt, wk)(*even, *factors)))
    del even
    for label, outs, ms, sent in rows:
        errs = [compare(a, b, f"{label} mode {n}")
                for n, (a, b) in enumerate(zip(natural(ft, rt, outs),
                                               nat4))]
        log(f"[dist-main] Fig. 9 {label}: {ms} ms (CUDA events, 3 calls "
            f"after a warm one, all {ft.nmodes} modes, D={D}); bytes "
            f"handed to the collectives (self-buckets included) {sent} = "
            f"{sum(sent.values())} B (on one card these are device "
            f"copies, not interconnect traffic); max_abs_err vs "
            f"Dynasor {[f'{e:.3e}' for e in errs]}  [{gpu}]")
    del rows, case2, outs4, outs1, factors
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[dist-main] peak device memory {peak_gb:.2f} GB; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return dist_launches


def phase_dist_fit(t, fits1, gpu: str):
    """``[dist-fit]``: CP-ALS (B1, seed 1, tol 0, 5 sweeps) on D=4 workers
    on the ``[bf16-fit]`` low-rank tensor, against that phase's fp32 D=1
    run (whose first 5 sweeps are a 5-sweep run: B1 and the solve are
    deterministic); the largest gap must be <= 1e-4."""
    from repro_torch.core import cpals, flycoo
    sweeps, workers = 5, 4
    res = cpals.cp_als_distributed(flycoo.build_flycoo(t, workers), 16,
                                   iters=sweeps, seed=1, tol=0.0,
                                   backend="pallas_fused_gather")
    gaps = [abs(a - b) for a, b in zip(res.fits, fits1[:sweeps])]
    log(f"[dist-fit] low_rank_sparse_tensor shape={t.shape} nnz={t.nnz}, "
        f"CP-ALS R=16 B1 seed 1 tol 0, {sweeps} sweeps: fits D=1 "
        f"{fits1[:sweeps]}; fits D={workers} {res.fits}; largest gap "
        f"{max(gaps):.3e}  [{gpu}]")
    require(len(res.fits) == sweeps and max(gaps) <= 1e-4,
            f"D={workers} fits {res.fits} vs D=1 {fits1[:sweeps]}")


class _TimedCheckpoints:
    """Bytes and seconds of each save and restore the CP-ALS driver makes:
    ``resilience.checkpoint.save_state`` / ``restore_state`` wrapped for
    the duration of a ``with`` block (the driver calls them through the
    module, so it meets the wrappers)."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        from repro_torch.resilience import checkpoint as ck
        self._ck, self._orig = ck, (ck.save_state, ck.restore_state)
        save, restore = self._orig

        def timed_save(mgr, state):
            t0 = time.perf_counter()
            path = save(mgr, state)
            secs = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))
            self.rows.append(("save", nbytes, secs))
            return path

        def timed_restore(mgr, template, device=None, workers=None):
            t0 = time.perf_counter()
            state, step = restore(mgr, template, device=device,
                                  workers=workers)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if state is not None:
                leaves = list(state["factors"]) + [
                    v for k, v in state.items() if k != "factors"]
                nbytes = sum(x.numel() * x.element_size() if
                             isinstance(x, torch.Tensor) else x.nbytes
                             for x in leaves)
                self.rows.append(("restore", nbytes, secs))
            return state, step

        ck.save_state, ck.restore_state = timed_save, timed_restore
        return self

    def __exit__(self, *exc):
        self._ck.save_state, self._ck.restore_state = self._orig
        return False


def _mode_rungs(tracer, default: str):
    """``{(sweep, mode): backend}`` from the stepped driver's spans: the
    last degradation a mode's ``mttkrp`` span counted, else ``default``."""
    from repro_torch.obs import split_key
    by_sid = {r.sid: r for r in tracer.records}
    rungs = {}
    for r in tracer.records:
        if r.name != "mttkrp":
            continue
        mode = by_sid[r.parent]
        sweep = by_sid[mode.parent].args["sweep"]
        to = [split_key(k)[1]["to"] for k in r.counters
              if k.startswith("resilience.degradations")]
        rungs[(sweep, mode.args["mode"])] = to[-1] if to else default
    return rungs


def _phase_ms(tracer) -> dict:
    """``{(mode, phase): [ms per sweep]}`` of the stepped driver's spans."""
    by_sid = {r.sid: r for r in tracer.records}
    out = {}
    for r in sorted(tracer.records, key=lambda r: r.t0):
        if r.name in ("mttkrp", "solve", "remap"):
            key = (by_sid[r.parent].args["mode"], r.name)
            out.setdefault(key, []).append(round(r.duration_s * 1e3, 2))
    return out


def _profile_driver(fn):
    """``(wall ms, device busy ms)`` of ``fn()`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(ev.device_time_total / 1e3 for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA)
    return wall, busy


def phase_resilience(ft, main_fits, dev, gpu: str):
    """``[resilience]`` (ROADMAP A10) on the nell-2 stand-in, D=1, R=16,
    ``auto``, 3 sweeps: the stepped driver fault-free (its fits against
    ``[main]``'s ``als_sweep`` fits, its Chrome trace validated), under
    three injected faults (bitwise the fault-free run), checkpointed and
    resumed (bitwise), the chunk site of the out-of-core executor, and the
    chaos smoke ``python -m repro_torch.resilience --device cuda``."""
    import shutil
    import tempfile
    from repro_torch.core import cpals
    from repro_torch.kernels.mttkrp import ops
    from repro_torch.obs import Tracer, use_registry, validate_chrome_trace
    from repro_torch.oocore import executor, planner
    from repro_torch.resilience import (FaultSpec, RetryPolicy, inject,
                                        use_policy)
    from repro_torch.resilience import __main__ as chaos_smoke
    t_phase = time.perf_counter()
    b1 = "fused_mttkrp_nmode_gather"
    kw = dict(backend="auto", iters=3, tol=0.0)
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)

    # --- 1. fault-free stepped run: counts zeroed before, read after ----
    reset_counts()
    tracer = Tracer()
    run1 = cpals.cp_als_distributed(ft, 16, resilience=RetryPolicy(),
                                    tracer=tracer, **kw)
    launched = counts()
    require_only(launched, b1, 9, "[resilience] stepped run (B1 per mode)")
    gap = max(abs(a - b) for a, b in zip(run1.fits, main_fits))
    log(f"[resilience] stepped cp_als_distributed R=16 auto, RetryPolicy + "
        f"Tracer: fits {run1.fits}; [main] als_sweep fits {main_fits}; "
        f"largest gap {gap:.3e}; ms per sweep "
        f"{[round(s * 1e3, 2) for s in run1.sweep_seconds]}; B1 launches "
        f"{launched[b1]}  [{gpu}]")
    require(len(run1.fits) == 3 and gap <= 1e-5,
            f"stepped fits {run1.fits} vs als_sweep {main_fits}")
    with tempfile.TemporaryDirectory(dir=scratch) as td:
        path = tracer.write_chrome_trace(os.path.join(td, "stepped.json"))
        with open(path) as f:
            trace = json.load(f)
    errors = validate_chrome_trace(
        trace, expect_names=("sweep", "mode", "mttkrp", "solve", "remap"))
    require(not errors, f"stepped Chrome trace: {errors}")
    for (mode, phase), ms in sorted(_phase_ms(tracer).items()):
        log(f"[resilience] span ms per sweep, mode {mode} {phase}: {ms}")
    log(f"[resilience] Chrome trace: {len(trace['traceEvents'])} events, "
        "valid (sweep, mode, mttkrp, solve, remap)")

    # --- 2. chaos: the same call under three faults, all in sweep 0 -----
    specs = [FaultSpec("ops.kernel", 1, "transient"),
             FaultSpec("ops.kernel", 2, "resource"),
             FaultSpec("distributed.remap", 0, "transient")]
    reset_counts()
    tracer2 = Tracer()
    with use_registry() as reg, inject(specs) as inj:
        run2 = cpals.cp_als_distributed(ft, 16, resilience=RetryPolicy(),
                                        tracer=tracer2, **kw)
    launched2 = counts()
    injected = reg.total("resilience.injected")
    handled = reg.total("resilience.retries") \
        + reg.total("resilience.degradations")
    rungs = _mode_rungs(tracer2, "pallas_fused_gather")
    log(f"[resilience] chaos {[(s.site, s.index, s.kind) for s in specs]}: "
        f"fits {run2.fits}; injected {injected}, retries + degradations "
        f"{handled}; counters "
        f"{ {k: v for k, v in reg.snapshot().items() if k.startswith('resilience.') and 'site_calls' not in k} }; "
        f"launches B1 {launched2[b1]}, B2 "
        f"{launched2['fused_mttkrp_nmode_gather_tiled']}")
    for (sweep, mode), rung in sorted(rungs.items()):
        log(f"[resilience] chaos rung sweep {sweep} mode {mode}: {rung}")
    require(inj.pending() == () and injected == 3 and handled >= 3,
            f"chaos: pending {inj.pending()}, injected {injected}, "
            f"handled {handled}")
    require(rungs[(0, 1)] == "pallas_fused_gather_tiled"
            and launched2[b1] == 8
            and launched2["fused_mttkrp_nmode_gather_tiled"] == 1,
            f"chaos: rungs {rungs}, launches {launched2}")
    require(run2.fits == run1.fits
            and all(np.array_equal(a, b)
                    for a, b in zip(run2.factors, run1.factors)),
            f"chaos fits {run2.fits} not bitwise the fault-free {run1.fits}")

    # --- 3. checkpoint 2 sweeps (keep=1), resume to 3 -------------------
    ckdir = tempfile.mkdtemp(dir=scratch)
    try:
        ck = dict(kw, checkpoint_dir=ckdir, checkpoint_keep=1)
        with _TimedCheckpoints() as timed, use_registry() as reg:
            cpals.cp_als_distributed(ft, 16, **dict(ck, iters=2))
            run3 = cpals.cp_als_distributed(ft, 16, **ck)
        restores = reg.get("resilience.checkpoint.restores")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    for what, nbytes, secs in timed.rows:
        log(f"[resilience] checkpoint {what}: {nbytes} B in {secs:.3f} s "
            f"({nbytes / secs / 1e9:.3f} GB/s)  [{gpu}]")
    log(f"[resilience] resumed fits {run3.fits}, restores {restores}")
    require(restores == 1 and run3.fits == run1.fits
            and all(np.array_equal(a, b)
                    for a, b in zip(run3.factors, run1.factors)),
            f"resume: restores {restores}, fits {run3.fits} vs {run1.fits}")

    # --- 4. one sweep of each driver on one state, profiled -------------
    rt, packed = runtime(ft, 16)
    wk = one_device(dev)
    stream, factors, lam, x2 = cpals.device_state(ft, rt, packed, seed=0,
                                                  workers=wk)
    del packed
    drivers = {
        "als_sweep": lambda: float(cpals.als_sweep(
            stream, factors, lam, x2, rt, workers=wk, sweep0=True,
            backend="auto").fit),
        "stepped": lambda: cpals._cp_als_distributed_stepped(
            ft, rt, stream, factors, lam, x2, workers=wk, iters=1, tol=0.0,
            backend="auto", tracer=Tracer()),
    }
    drivers["als_sweep"]()   # first-use costs outside the profile
    for name in ("als_sweep", "stepped", "stepped", "als_sweep"):
        wall, busy = _profile_driver(drivers[name])
        log(f"[resilience] profiled sweep 0, {name}: wall {wall:.2f} ms, "
            f"kernels {busy:.2f} ms, device idle share "
            f"{1 - busy / wall:.3f}  [{gpu}]")

    # --- 5. the out-of-core chunk site: a replayed chunk, bitwise -------
    blk, tile_rows, k = MAIN_STREAM_BLK, STREAM_TILE_ROWS, rt.nmodes - 1
    cur = one_worker(stream)
    num_blocks = ops.n_pad_for(cur[0].shape[0], rt.rows_cap[0], blk,
                               tile_rows) // blk
    okw = dict(mode=0, rows_cap=rt.rows_cap[0], blk=blk, tile_rows=tile_rows,
               max_chunk_bytes=num_blocks * planner.stream_chunk_bytes(
                   blk, k, (1,) * k) // 5)
    out0, stats = executor.mttkrp_out_of_core(*cur, factors, **okw)
    with use_registry() as reg, use_policy(), \
            inject([FaultSpec("oocore.chunk", 2, "transient")]) as inj:
        out1, _ = executor.mttkrp_out_of_core(*cur, factors, **okw)
    retries = reg.get("resilience.retries", site="oocore.chunk")
    log(f"[resilience] mttkrp_out_of_core mode 0 in {stats.chunks} chunks, "
        f"transient fault at chunk 2: retries {retries}, bitwise "
        f"{torch.equal(out0, out1)}")
    require(stats.chunks >= 5 and inj.pending() == () and retries == 1
            and torch.equal(out0, out1), "out-of-core chunk replay")
    del stream, factors, cur, out0, out1

    # --- 6. the chaos smoke, in this process -----------------------------
    rc = chaos_smoke.main(["--device", "cuda"])
    require(rc == 0, f"python -m repro_torch.resilience --device cuda: {rc}")
    log(f"[resilience] phase {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return {b1: launched[b1]}


# [auto-stream]: FROSTT flickr's mode sizes with its nonzeros cut to this
# many draws (before dedup) for host and chip time. The batch sets the
# skew (each batch is scaled by its own largest draw); it was chosen so
# ~18 M distinct nonzeros survive, not taken from flickr, and the kernel
# times of [auto-stream] hold for it only.
AUTO_STREAM_NNZ = 20_000_000
AUTO_STREAM_BATCH = 20_000
OBS_SPANS = ("sweep", "mode", "mttkrp", "solve", "remap", "oocore.mode_step",
             "oocore.chunk")


class _SweepEvents:
    """CUDA-event ms of each ``cpals.als_sweep`` the CP-ALS driver makes
    inside a ``with`` block (it calls the sweep through the module)."""

    def __init__(self):
        self.pairs = []

    def __enter__(self):
        from repro_torch.core import cpals
        self._mod, self._orig = cpals, cpals.als_sweep

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._orig(*args, **kw)
            stop.record()
            self.pairs.append((start, stop))
            return out

        cpals.als_sweep = timed
        return self

    def __exit__(self, *exc):
        self._mod.als_sweep = self._orig
        return False

    def ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [round(a.elapsed_time(b), 3) for a, b in self.pairs]


def phase_obs(ft, dev, gpu: str) -> dict:
    """``[obs]`` (ROADMAP A11) on the card: the counted baseline against
    the committed one key for key, the pinned run's Chrome trace, the
    steady-state profiler with its roofline (``python -m
    repro_torch.obs.prof run`` in a fresh process), gated against the
    committed timed baseline (``bench_torch/obs/PROF_baseline.json``; a
    fingerprint or host-noise SKIP passes, a regression fails),
    ``ops.timed_device_step`` per
    mode on the nell-2 stand-in that phase_main built (bitwise the
    ``auto`` sweep's mode steps), then ``[auto-stream]``. Returns the
    launches of the counted run and of ``[auto-stream]``'s ``auto`` run."""
    import tempfile
    from repro_torch.core import cpals
    from repro_torch.kernels.mttkrp import ops
    from repro_torch.obs import (Tracer, baseline, use_registry, use_tracer,
                                 validate_chrome_trace)
    from repro_torch.obs.prof import __main__ as prof_cli
    from repro_torch.obs.prof import gate
    t_phase = time.perf_counter()
    b1, b6 = "fused_mttkrp_nmode_gather", "fused_mttkrp_nmode_gather_stream"
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)

    # --- 1. the counted baseline: counts zeroed before, read after ------
    reset_counts()
    tracer = Tracer()
    t0 = time.perf_counter()
    current = baseline.collect(tracer=tracer, device=dev)
    secs = time.perf_counter() - t0
    obs_launched = counts()
    committed = baseline.load_baseline()
    mismatches = baseline.diff(current, committed)
    for m in mismatches:
        log(f"[obs] FAIL {m}")
    cur = current["counters"]
    log(f"[obs] counted baseline on {dev}: {len(cur)} counters in "
        f"{secs:.2f} s, {len(mismatches)} mismatches against "
        f"{os.path.relpath(baseline.BASELINE_PATH, ROOT)} (collected on "
        f"the {committed['meta'].get('device')}); launches "
        f"{ {k: v for k, v in obs_launched.items() if v} }")
    require(not mismatches, "the counters collected on the card differ "
            "from the committed baseline")
    dispatched = cur["dispatch.backend{backend=pallas_fused_gather,"
                     "source=static}"]
    require_only({k: v for k, v in obs_launched.items() if k != b6}, b1,
                 dispatched, "[obs] counted run (B1 per dispatch)")
    require(obs_launched[b6] == cur["oocore.chunks"],
            f"[obs] B6 launches {obs_launched[b6]} != oocore.chunks "
            f"{cur['oocore.chunks']}")

    # --- 2. its Chrome trace ---------------------------------------------
    with tempfile.TemporaryDirectory(dir=scratch) as td:
        path = tracer.write_chrome_trace(
            os.path.join(td, "obs.json"),
            meta={"workload": baseline.WORKLOAD, "counters": cur})
        with open(path) as f:
            trace = json.load(f)
    errors = validate_chrome_trace(trace, expect_names=OBS_SPANS)
    require(not errors, f"[obs] Chrome trace: {errors}")
    log(f"[obs] Chrome trace: {len(trace['traceEvents'])} events, valid "
        f"({', '.join(OBS_SPANS)})")

    # --- 3. the profiler (timed, CUDA-fenced), gated ----------------------
    # `python -m repro_torch.obs.prof run` in a fresh process: this
    # process has run torch.profiler sessions (CUPTI) in earlier phases,
    # after which the pinned run's host-bound phases time 1.4-2.2x slower
    # and vary from run to run (PERF.md); the fresh process times
    # the workload alone. It writes bench_torch/obs/PROF_run.json, its
    # flamegraph and trace.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.prof", "run", "--repeats",
         "3", "--warmup", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT,
                                                                  "src")))
    require(proc.returncode == 0, f"[obs] prof run failed: {proc.stdout}"
            f"{proc.stderr}")
    log(f"[obs] profile of the pinned run in a fresh process "
        f"({time.perf_counter() - t0:.1f} s)")
    prof = prof_cli._load_json(prof_cli.RUN_PATH)
    errors = gate.validate_prof(prof)
    require(not errors, f"[obs] PROF artifact: {errors}")
    verdict = gate.compare(prof, prof_cli._load_json(prof_cli.BASELINE_PATH))
    for m in verdict.messages:
        log(f"[obs] gate against "
            f"{os.path.relpath(prof_cli.BASELINE_PATH, ROOT)}: {m}")
    require(verdict.status != "fail", "[obs] the profile regressed past "
            "the timed gate against the committed baseline")
    fp = prof["meta"]["fingerprint"]
    log(f"[obs] profile: repeats 3, warmup 1, noise mad_frac "
        f"{prof['meta']['noise']['mad_frac']:.4f}; fingerprint "
        f"{fp['devices']}, {fp.get('power_limit')}  [{gpu}]")
    for name, ph in sorted(prof["phases"].items(),
                           key=lambda kv: -kv[1]["median_s"]):
        log(f"[obs] phase {name}: median {ph['median_s'] * 1e3:.3f} ms, MAD "
            f"{ph['mad_s'] * 1e3:.3f} ms ({100 * ph['mad_frac']:.1f}% "
            f"sigma-equivalent)  [{gpu}]")
    for row in prof["roofline"]:
        log(f"[obs] roofline {row['span']} [{row['backend']}/{row['rung']}/"
            f"{row['ordering']}]: {row['moved_bytes']} B ({row['basis']}) "
            f"in {row['time_s'] * 1e3:.3f} ms x{row['calls']}, "
            f"{row['achieved_gbps']:.3f} GB/s  [{gpu}]")
    require(prof["roofline"], "[obs] the profile has no roofline row")

    # --- 4. timed_device_step per mode on the nell-2 stand-in ------------
    rt, packed = runtime(ft, 16)
    wk = one_device(dev)
    stream, factors, lam, x2 = cpals.device_state(ft, rt, packed, seed=0,
                                                  workers=wk)
    del packed
    res = cpals.als_sweep(stream, factors, lam, x2, rt, workers=wk,
                          sweep0=True, backend="auto")
    cur_stream = one_worker(stream)
    del stream
    reset_counts()
    for n in range(rt.nmodes):
        facs = list(res.factors[:n]) + list(factors[n:])
        for rep in range(2):
            with use_registry() as reg, use_tracer(Tracer()):
                out = ops.timed_device_step(
                    *cur_stream, facs, mode=n, rows_cap=rt.rows_cap[n],
                    backend="auto", blk=rt.blk, tile_rows=rt.tile_rows)
            require(torch.equal(out, res.mttkrp[n][0]),
                    f"[obs] timed_device_step mode {n} differs from the "
                    "auto sweep's mode step")
            model_b = reg.get("ops.step.model_bytes", backend="auto")
            step_s = reg.get("ops.step_s", backend="auto")
            log(f"[obs] timed_device_step mode {n} (call {rep + 1}) auto "
                f"R=16: ops.step.model_bytes {model_b}, ops.step_s "
                f"{step_s * 1e3:.3f} ms, {model_b / step_s / 1e12:.3f} TB/s "
                f"of modeled bytes (HBM 3.35 TB/s, L2 probe "
                f"{L2_BYTES_PER_S / 1e12:.3f} TB/s); == [main]'s mode step "
                f"bitwise  [{gpu}]")
        cur_stream = remap_one(cur_stream, (n + 1) % rt.nmodes, rt)
    launched = counts()
    require_only(launched, b1, 2 * rt.nmodes,
                 "[obs] timed_device_step (auto = B1)")
    del cur_stream, res, factors, out

    # --- 5. [auto-stream] ------------------------------------------------
    auto_stream, auto_stream_keys = phase_auto_stream(dev, gpu)
    log(f"[obs] phase {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return {"obs_launches": obs_launched, "auto_stream_launches": auto_stream,
            "auto_stream_keys": auto_stream_keys}


def wide_powerlaw_tensor(shape, nnz: int, seed: int):
    """``nnz`` power-law coordinate draws (the generator of
    ``random_sparse_tensor(distribution="powerlaw")``, seeded), in batches
    of AUTO_STREAM_BATCH, duplicates summed. Two changes from that function, both
    forced by the shape: it dedups through ``np.ravel_multi_index``, which
    raises once the element count passes int64 (FROSTT flickr's is
    1.44e19), so duplicates are found here with ``np.lexsort``; and it
    scales each draw by the largest of its call, so one call of 20 M draws
    puts nearly all of them on the first rows (43,621 distinct nonzeros),
    while batches of 20,000 keep ~18 M."""
    from repro_torch.core import tensors
    rng = np.random.default_rng(seed)
    idx = np.concatenate([
        tensors._powerlaw_columns(rng, shape,
                                  min(AUTO_STREAM_BATCH, nnz - i), 1.1)
        for i in range(0, nnz, AUTO_STREAM_BATCH)])
    val = rng.standard_normal(nnz).astype(np.float32)
    val[val == 0] = 1.0
    order = np.lexsort(tuple(idx[:, n] for n in reversed(range(len(shape)))))
    idx, val = idx[order], val[order]
    start = np.flatnonzero(np.concatenate(
        [[True], (idx[1:] != idx[:-1]).any(axis=1)]))
    return tensors.SparseTensor(idx[start].astype(np.int32),
                                np.add.reduceat(val, start), tuple(shape))


def fp32_sum_check(outs: dict, operands, what: str, *, rows_cap: int,
                   blk: int, tile_rows: int) -> dict:
    """Hold fp32 MTTKRP outputs to the float64 sum of the same products.

    Per output element, with ``n`` nonzeros in its row, K input modes and
    ``u = 2^-24``: ``|out - exact| <= g * sum|term|``, ``g = m*u/(1-m*u)``,
    ``m = n + K`` (K roundings per product, n - 1 per sum, in any order):
    the worst-case bound of fp32 summation. It is the tolerance for rows
    that sum many terms (power-law hubs), where two fp32 orders may differ
    by more than a fixed ``allclose``. ``operands`` are B1's (block-aligned
    values, indices, factors, local rows, tiles). Returns ``{name: largest
    |out - exact| / bound}``."""
    vals, idx_al, fmats, r_al, tob = operands
    live = vals != 0
    rows = (torch.repeat_interleave(tob.long(), blk) * tile_rows
            + r_al.long())[live]
    term = vals[live].double()[:, None]
    for i, f in enumerate(fmats):
        term = term * f[idx_al[live, i].long()].double()
    exact = torch.zeros(rows_cap, term.shape[1], dtype=torch.float64,
                        device=vals.device).index_add_(0, rows, term)
    mag = torch.zeros_like(exact).index_add_(0, rows, term.abs())
    m = torch.bincount(rows, minlength=rows_cap).double()[:, None] \
        + len(fmats)
    bound = m * 2.0 ** -24 / (1 - m * 2.0 ** -24) * mag
    ratios = {}
    for name, out in outs.items():
        gap = (out[:, :term.shape[1]].double() - exact).abs()
        require(bool((gap <= bound).all()),
                f"{what} {name}: |fp32 - fp64| {float(gap.max()):.3e} "
                "beyond the fp32 summation bound")
        ratios[name] = float((gap / bound.clamp_min(1e-300)).max())
    return ratios


def block_subset(operands, keep, blk: int):
    """B1's operands restricted to the blocks ``keep`` selects (a bool
    mask or a slice over blocks), in stream order; the factors are
    shared."""
    vals, idx_al, fmats, r_al, tob = operands
    nb, k = tob.shape[0], idx_al.shape[1]
    return (vals.view(nb, blk)[keep].reshape(-1).contiguous(),
            idx_al.view(nb, blk, k)[keep].reshape(-1, k).contiguous(), fmats,
            r_al.view(nb, blk)[keep].reshape(-1).contiguous(),
            tob[keep].contiguous())


def tile_occupancy(operands, *, blk: int, tile_rows: int,
                   rows_cap: int) -> dict:
    """How the aligned stream fills its output: distinct output rows and
    live tiles (tiles with a nonzero) against ``rows_cap`` and the tiles,
    blocks with a nonzero, the trailing all-padding blocks that
    ``ops.build_block_layout`` clips onto the last tile (the static length
    ``ops.n_pad_for`` gives every tile ``blk`` slots), and the busiest
    tile (most blocks with a nonzero)."""
    vals, _, _, r_al, tob = operands
    nb = tob.shape[0]
    live_blk = (vals.view(nb, blk) != 0).any(1)
    end = int(torch.nonzero(live_blk).max()) + 1
    nz = vals != 0
    rows = (torch.repeat_interleave(tob.long(), blk) * tile_rows
            + r_al.long())[nz]
    per_tile = torch.bincount(tob.long()[live_blk],
                              minlength=rows_cap // tile_rows)
    busiest = int(per_tile.argmax())
    return {"rows_cap": rows_cap, "distinct_rows": int(rows.unique().numel()),
            "tiles": rows_cap // tile_rows,
            "live_tiles": int((per_tile > 0).sum()), "blocks": nb,
            "live_blocks": int(live_blk.sum()), "end": end,
            "trailing": nb - end, "busiest": busiest,
            "busiest_blocks": int(per_tile[busiest]),
            "busiest_nnz": int(nz[torch.repeat_interleave(
                tob == busiest, blk)].sum()),
            "live_mask": live_blk}


def stream_breakdown(b1_ops, occ: dict, out_b6, out_b1, *, rows_cap: int,
                     blk: int, tile_rows: int, what: str) -> dict:
    """B6 and B1 on two parts of one aligned stream: the stream without
    its trailing all-padding blocks, and the busiest tile's blocks alone.
    Each output must be bitwise the full stream's on the rows it covers
    (padding adds nothing; a tile's run is summed in the same order).
    Returns ``{part: (B6 ms, B1 ms, B6 windows)}``."""
    from repro_torch.kernels.mttkrp import kernel as K
    tob = b1_ops[4]
    lo = occ["busiest"] * tile_rows
    parts = {"trimmed": slice(0, occ["end"]),
             "busiest": (tob == occ["busiest"]) & occ["live_mask"]}
    res = {}
    for part, keep in parts.items():
        sub = block_subset(b1_ops, keep, blk)
        s_sub, windows = stream_operands(sub, blk)
        kw = dict(rows_cap=rows_cap, blk=blk, tile_rows=tile_rows)
        o6 = K.fused_mttkrp_nmode_gather_stream(*s_sub, **kw)
        o1 = K.fused_mttkrp_nmode_gather(*sub, **kw)
        for o, full, name in ((o6, out_b6, "B6"), (o1, out_b1, "B1")):
            if part == "trimmed":
                same = torch.equal(o, full)
            else:
                same = torch.equal(o[lo:lo + tile_rows],
                                   full[lo:lo + tile_rows])
            require(same, f"{what} {name} on the {part} stream differs "
                    "from the full stream's output")
        res[part] = (cuda_ms(lambda: K.fused_mttkrp_nmode_gather_stream(
                         *s_sub, **kw), 3),
                     cuda_ms(lambda: K.fused_mttkrp_nmode_gather(*sub, **kw),
                             3), windows)
        del sub, s_sub, o6, o1
    return res


def phase_auto_stream(dev, gpu: str) -> dict:
    """``[auto-stream]``: ``auto`` on a tensor whose factors are beyond
    L2, with FROSTT flickr's mode sizes, power-law indices, seed 0, its
    nonzeros cut to AUTO_STREAM_NNZ draws. At blk=64 and R=16 the ladder
    takes the stream rung (B6) on every mode: ``dispatch.backend`` must
    count B6 exactly as often as it launched, and the factors and fits
    must be bitwise those of the same call forced to B1."""
    from repro_torch.core import cpals, distributed as dist, flycoo, tensors
    from repro_torch.kernels.mttkrp import kernel as K, ops
    from repro_torch.obs import use_registry
    b6 = "fused_mttkrp_nmode_gather_stream"
    prof = tensors.FROSTT_PROFILES["flickr"]
    shape, rank, blk = prof["shape"], 16, MAIN_STREAM_BLK
    t0 = time.perf_counter()
    require(prof["distribution"] == "powerlaw", "flickr's profile changed")
    t = wide_powerlaw_tensor(shape, AUTO_STREAM_NNZ, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ft = flycoo.build_flycoo(t, 1)
    t_fly = time.perf_counter() - t0
    log(f"[auto-stream] flickr stand-in shape={shape} nnz={t.nnz} "
        f"(nonzeros cut from the profile's {prof['nnz']} to "
        f"{AUTO_STREAM_NNZ} power-law draws in batches of "
        f"{AUTO_STREAM_BATCH}, seed 0, before dedup): "
        f"generate {t_gen:.1f} s, build_flycoo {t_fly:.1f} s")
    del t
    kw = dict(iters=2, tol=0.0, blk=blk)

    # --- the driven path: counts zeroed just before, read just after ---
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with use_registry() as reg, _SweepEvents() as ev:
        res = cpals.cp_als_distributed(ft, rank, backend="auto", **kw)
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decisions = {k: v for k, v in reg.snapshot().items()
                 if k.startswith("dispatch.backend")}
    chosen = reg.get("dispatch.backend", backend=ops.STREAM_BACKEND,
                     source="static")
    log(f"[auto-stream] cp_als_distributed R={rank} auto blk={blk}, 2 "
        f"sweeps: fits {res.fits}; sweep ms on CUDA events {ev.ms()}, on "
        f"the host {[round(x * 1e3, 3) for x in res.sweep_seconds]}; "
        f"dispatch {decisions}; B6 launches {launched[b6]}; peak device "
        f"memory {peak_gb:.2f} GB  [{gpu}]")
    require(decisions == {"dispatch.backend{backend="
                          f"{ops.STREAM_BACKEND},source=static}}": chosen}
            and chosen == 2 * len(shape),
            f"[auto-stream] auto did not take the stream rung on every "
            f"mode: {decisions}")
    require_only(launched, b6, chosen, "[auto-stream] auto (B6 per mode)")
    require(all(np.isfinite(res.fits)), f"fits {res.fits}")
    # The same run with the last tile's walk not cut (S1), as before it.
    with patched(K, _cut_tile_starts=functools.partial(K._cut_tile_starts,
                                                       cut=False)), \
            _SweepEvents() as ev_uncut:
        res_uncut = cpals.cp_als_distributed(ft, rank, backend="auto", **kw)
    require(res_uncut.fits == res.fits
            and all(np.array_equal(a, b)
                    for a, b in zip(res.factors, res_uncut.factors)),
            "[auto-stream] the uncut walk's fits differ from the cut one's")
    log(f"[auto-stream] sweep ms on CUDA events with the last tile's walk "
        f"cut at its last live block {ev.ms()}, not cut {ev_uncut.ms()} "
        f"(same run, bitwise equal)  [{gpu}]")
    del res_uncut

    # --- comparisons (launches here are not counted) ---
    res_b1 = cpals.cp_als_distributed(ft, rank,
                                      backend="pallas_fused_gather", **kw)
    require(res.fits == res_b1.fits
            and all(np.array_equal(a, b)
                    for a, b in zip(res.factors, res_b1.factors)),
            f"[auto-stream] fits {res.fits} not bitwise the forced-B1 "
            f"run's {res_b1.fits}")
    log(f"[auto-stream] factors and fits bitwise the forced-B1 run's "
        f"(fits {res_b1.fits}, host ms per sweep "
        f"{[round(x * 1e3, 3) for x in res_b1.sweep_seconds]})")
    del res, res_b1

    # B6 per launch at the path's inputs (sweep-0 streams, initial factors)
    rt, packed = dist.prepare_runtime(ft, rank, blk=blk)
    stream, factors, _, _ = cpals.device_state(ft, rt, packed, seed=0,
                                               workers=one_device(dev))
    del packed
    cur = one_worker(stream)
    del stream
    for n in range(rt.nmodes):
        b1_ops = ops.gather_operands(
            *cur, factors, mode=n, rows_cap=rt.rows_cap[n], row_offset=0,
            blk=blk, tile_rows=rt.tile_rows, slab=ops.padded_rank(rank))
        s_ops, windows = stream_operands(b1_ops, blk)
        skw = dict(rows_cap=rt.rows_cap[n], blk=blk, tile_rows=rt.tile_rows)
        out = K.fused_mttkrp_nmode_gather_stream(*s_ops, **skw)
        require(torch.equal(out, K.fused_mttkrp_nmode_gather(*b1_ops,
                                                             **skw)),
                f"[auto-stream] mode {n}: B6 differs from B1")
        plain = K.fused_mttkrp_nmode_gather_stream_plain(*s_ops, **skw)
        ratios = fp32_sum_check({"B6": out, "plain": plain}, b1_ops,
                                f"[auto-stream] mode {n}", **skw)
        err = float((out - plain).abs().max())
        t_k = cuda_ms(lambda: K.fused_mttkrp_nmode_gather_stream(
            *s_ops, **skw), 3)
        t_b1 = cuda_ms(lambda: K.fused_mttkrp_nmode_gather(*b1_ops, **skw),
                       3)
        bound, by = kernel_bound_ms(b1_ops, rows_cap=rt.rows_cap[n],
                                    tile_rows=rt.tile_rows, scheds=s_ops[5])
        nnz = int((s_ops[0] != 0).sum())
        log(f"[auto-stream] B6 mode {n}: {nnz} nnz, "
            f"windows {windows}, {t_k:.3f} ms per launch (B1 on the same "
            f"stream {t_b1:.3f} ms), bound {bound:.3f} ms ({by}); == B1 "
            f"bitwise; |B6 - plain| {err:.3e} (max|plain| "
            f"{float(plain.abs().max()):.3e}); against the fp64 sum, the "
            f"largest share of the fp32 summation bound: B6 "
            f"{ratios['B6']:.3e}, plain {ratios['plain']:.3e}  [{gpu}]")
        # Where B6's time goes: the output's occupancy, then B6 and B1 on
        # the stream without its trailing padding and on the busiest tile.
        occ = tile_occupancy(b1_ops, blk=blk, tile_rows=rt.tile_rows,
                             rows_cap=rt.rows_cap[n])
        parts = stream_breakdown(
            b1_ops, occ, out, K.fused_mttkrp_nmode_gather(*b1_ops, **skw),
            what=f"[auto-stream] mode {n}", **skw)
        log(f"[auto-stream] occupancy mode {n}: distinct output rows "
            f"{occ['distinct_rows']} / rows_cap {occ['rows_cap']} "
            f"({occ['distinct_rows'] / occ['rows_cap']:.4f}); live tiles "
            f"{occ['live_tiles']} / {occ['tiles']} "
            f"({occ['live_tiles'] / occ['tiles']:.4f}); blocks "
            f"{occ['blocks']}, of them with a nonzero {occ['live_blocks']}, "
            f"trailing padding on the last tile {occ['trailing']}; busiest "
            f"tile {occ['busiest']}: {occ['busiest_blocks']} blocks, "
            f"{occ['busiest_nnz']} nnz ({occ['busiest_nnz'] / nnz:.4f} of "
            f"the nonzeros)")
        for part, (ms6, ms1, win) in parts.items():
            log(f"[auto-stream] mode {n} {part} stream: B6 {ms6:.3f} ms "
                f"(full {t_k:.3f}), B1 {ms1:.3f} ms (full {t_b1:.3f}), "
                f"windows {win}; bitwise the full stream's rows  [{gpu}]")
        del b1_ops, s_ops, out, plain, occ, parts
        cur = remap_one(cur, (n + 1) % rt.nmodes, rt)
    del cur, factors, ft
    # The dispatch keys auto asked about, per mode ([tune] queries them).
    keys = [dict(nmodes=rt.nmodes, rank=rank, blk=blk,
                 tile_rows=rt.tile_rows,
                 factor_rows=tuple(rt.i_pad[w] for w in range(rt.nmodes)
                                   if w != n))
            for n in range(rt.nmodes)]
    return launched, keys


# The kernel each ops backend launches (the bf16 names: B3 and B1 on bf16
# operands); ref and segsum launch none.
KERNEL_OF = {b: k for k, b in BACKEND_OF.items()}
KERNEL_OF["pallas_fused_bf16"] = "fused_mttkrp_nmode" + BF16
KERNEL_OF["pallas_fused_gather_bf16"] = "fused_mttkrp_nmode_gather" + BF16


def phase_tune(ft, main_fits, auto_stream_keys, dev, gpu: str) -> dict:
    """``[tune]`` (ROADMAP A12) on the card:

    (a) ``tune.calibrate`` over the port's quick grid (16 points x every
        backend, cases of ``CARD_CASE_NNZ`` nonzeros), the table saved
        under ``build/tune/``; per point the best backend, every backend's
        ms, and the case's nonzeros, live tiles and trailing all-padding
        blocks; every kernel a backend names must have launched;
    (b) per key what ``python -m repro_torch.tune check`` prints: static,
        calibrated and oracle with each policy's regret; every key must
        be consistent;
    (c) ``cp_als_distributed`` on the nell-2 stand-in that phase_main
        built, R=16, ``backend="auto"``, ``table=``, 2 sweeps: each
        mode's plan, the sweep ms beside [main]'s static ones, the
        launches the plans name (counts zeroed just before, read just
        after); per mode on sweep 0's inputs the tuned step against the
        plain ``index_add_`` step (``compare``'s tolerance), and bitwise
        against the static configuration's step where the plan is that
        configuration (all modes so: the fits bitwise [main]'s);
    (d) ``select_backend("auto", table=...)`` at ``[auto-stream]``'s
        keys and factor rows: the static and the calibrated rung per
        mode (queried, not run).

    Returns ``(calibration launches, tuned-run launches)``."""
    from repro_torch import tune
    from repro_torch.core import cpals, distributed as dist
    from repro_torch.kernels.mttkrp import ops
    from repro_torch.tune import cli as tune_cli, microbench
    t_phase = time.perf_counter()

    # --- (a) calibration: counts zeroed before, read after ---
    reset_counts()
    t0 = time.perf_counter()
    table = tune.calibrate(quick=True, device=dev, warmup=1, iters=3)
    cal_s = time.perf_counter() - t0
    cal_launched = counts()
    path = table.save(os.path.join(ROOT, "build", "tune",
                                   "calibration_card.json"))
    cases = {(c["nmodes"], c["rank"], c["blk"], c["tile_rows"],
              c["density"]): c for c in table.meta["obs"]["cases"]}
    obs_meta = table.meta["obs"]
    log(f"[tune] calibrated {len(table.entries)} points x "
        f"{len(microbench.BACKENDS)} backends in {cal_s:.1f} s (cases of "
        f"{obs_meta['case_nnz']} nonzeros, {obs_meta['side_dim']}-row "
        f"input factors; median of 3 after 1 warmup) -> "
        f"{os.path.relpath(path, ROOT)}")
    for e in table.entries:
        c = cases[(e.nmodes, e.rank, e.blk, e.tile_rows, e.density)]
        ms = " ".join(f"{b}={t * 1e3:.4f}" for b, t in e.timings_s.items())
        log(f"[tune] point nmodes={e.nmodes} R={e.rank} blk={e.blk} "
            f"tile_rows={e.tile_rows} density={e.density}: best={e.best}; "
            f"ms {ms}; case nnz {c['nnz']}, live tiles {c['live_tiles']}/"
            f"{c['num_tiles']}, trailing all-padding blocks "
            f"{c['trailing_blocks']}/{c['blocks']}, busiest tile "
            f"{c['busiest_tile_nnz']} nnz ("
            f"{c['busiest_tile_nnz'] / c['nnz']:.3f})  [{gpu}]")
    want = {KERNEL_OF[b] for b in microbench.BACKENDS if b in KERNEL_OF}
    require(all(cal_launched[k] > 0 for k in want),
            f"[tune] calibration did not launch every kernel: "
            f"{cal_launched}")

    # --- (b) check: static, calibrated, oracle and regret per key ---
    bad = 0
    for ok, line, _ in tune_cli.check_lines(table):
        bad += not ok
        log(f"[tune] check {line}")
    require(bad == 0, f"[tune] {bad} dispatch keys inconsistent")
    log(f"[tune] {len(table.shape_keys())}/{len(table.shape_keys())} "
        "dispatch keys consistent")

    # --- (c) the main path with the table: counts zeroed just before ---
    rank = 16
    rt, packed = dist.prepare_runtime(ft, rank, table=table)
    require(rt.mode_plans is not None, "[tune] the table gave no plans")
    # The static runtime: the tuned one without its plans (the grid has
    # one tile height, 8, the static one, so rows_cap and the layout are
    # prepare_runtime(ft, rank)'s).
    require({p.tile_rows for p in rt.mode_plans} == {rt.tile_rows},
            f"[tune] plans {rt.mode_plans} change the tile height")
    rt_s = dataclasses.replace(rt, mode_plans=None)
    static = [rt_s.plan_for(n, ops.select_backend(
        "auto", nmodes=rt_s.nmodes, rank=rank, blk=rt_s.blk,
        tile_rows=rt_s.tile_rows,
        factor_rows=tuple(rt_s.i_pad[w] for w in range(rt_s.nmodes)
                          if w != n))) for n in range(rt_s.nmodes)]
    reset_counts()
    t0 = time.perf_counter()
    with _SweepEvents() as ev:
        res = cpals.cp_als_distributed(ft, rank, backend="auto", iters=2,
                                       tol=0.0, table=table)
    wall = time.perf_counter() - t0
    main_launched = counts()
    same = [p == s for p, s in zip(rt.mode_plans, static)]
    for n, (p, s) in enumerate(zip(rt.mode_plans, static)):
        log(f"[tune] nell-2 mode {n} plan: backend={p.backend} blk={p.blk} "
            f"tile_rows={p.tile_rows} rank_slabs={p.rank_slabs} "
            f"ordering={p.ordering}; static: backend={s.backend} "
            f"blk={s.blk} tile_rows={s.tile_rows}"
            + (" (the same)" if same[n] else ""))
    log(f"[tune] cp_als_distributed R={rank} auto table=, 2 sweeps: fits "
        f"{res.fits}; sweep ms on the host "
        f"{[round(x * 1e3, 3) for x in res.sweep_seconds]}, on CUDA events "
        f"{ev.ms()}; [main]'s static auto sweeps (host) "
        f"{[round(x, 3) for x in MAIN_SWEEP_MS]}; call {wall:.1f} s incl. "
        f"host prepare_runtime; launches "
        f"{ {k: v for k, v in main_launched.items() if v} }  [{gpu}]")
    expect = {k: 0 for k in SOURCE}
    for p in rt.mode_plans:
        if p.backend in KERNEL_OF:
            expect[KERNEL_OF[p.backend]] += 2
    require(main_launched == expect,
            f"[tune] launches {main_launched}, expected {expect}")
    require(all(np.isfinite(res.fits)) and max(res.fits) <= 1.0,
            f"[tune] fits {res.fits}")
    if all(same):
        require(res.fits == main_fits[:2],
                f"[tune] plans equal the static configuration but fits "
                f"{res.fits} differ from [main]'s {main_fits[:2]}")
        log("[tune] every plan is the static configuration: fits bitwise "
            "[main]'s")
    del res

    # Per mode on sweep 0's inputs: tuned step vs plain and vs static.
    wk = one_device(dev)
    stream, factors, lam, x2 = cpals.device_state(ft, rt, packed, seed=0,
                                                  workers=wk)
    del packed
    res0 = cpals.als_sweep(stream, factors, lam, x2, rt, workers=wk,
                           sweep0=True, backend="auto")
    cur = one_worker(stream)
    del stream
    for n in range(rt.nmodes):
        facs = list(res0.factors[:n]) + list(factors[n:])
        tuned = res0.mttkrp[n][0]
        plain = ops.mttkrp_device_step(*cur, facs, mode=n,
                                       rows_cap=rt.rows_cap[n],
                                       backend="ref")
        err = compare(tuned, plain, f"[tune] mode {n} tuned step")
        step = lambda r: dist.device_mttkrp(*cur, facs, n, r, "auto")
        t_tuned = cuda_ms(lambda: step(rt), 3)
        t_static = cuda_ms(lambda: step(rt_s), 3)
        note = f", static configuration's step {t_static:.3f} ms"
        if same[n]:
            require(torch.equal(tuned, step(rt_s)),
                    f"[tune] mode {n}: plan is the static configuration "
                    "but the step is not bitwise")
            note += " (bitwise the tuned step)"
        log(f"[tune] nell-2 mode {n} ({rt.mode_plans[n].backend}): tuned "
            f"step {t_tuned:.3f} ms{note}; |tuned - plain index_add_| "
            f"{err:.3e} (max|plain| {float(plain.abs().max()):.3e})  "
            f"[{gpu}]")
        del plain
        cur = remap_one(cur, (n + 1) % rt.nmodes, rt)
    del cur, factors, res0

    # --- (d) [auto-stream]'s keys: static vs calibrated rung, not run ---
    for n, kw in enumerate(auto_stream_keys):
        st = ops.select_backend("auto", **kw)
        cal = ops.select_backend("auto", table=table, **kw)
        best = table.best_backend(
            **{k: kw[k] for k in ("nmodes", "rank", "blk", "tile_rows")},
            allowed=ops.AUTO_BACKENDS)
        log(f"[tune] [auto-stream] mode {n} (nmodes={kw['nmodes']} "
            f"R={kw['rank']} blk={kw['blk']} tile_rows={kw['tile_rows']} "
            f"factor rows {kw['factor_rows']}): static {st}, calibrated "
            f"{cal} (the table's argmin {best}"
            + ("" if best == cal else ", which the residency planner "
               "rejects") + "); not run")
    log(f"[tune] phase took {time.perf_counter() - t_phase:.1f} s")
    return cal_launched, main_launched


def phase_four_mode(dev):
    from repro_torch.core import flycoo, tensors
    t = tensors.frostt_like("enron")
    ft = flycoo.build_flycoo(t, 1)
    rows, fit = check_modes(ft, 16, "pallas_fused_gather", dev)
    require(np.isfinite(fit), f"enron sweep fit {fit}")
    errs = ", ".join(f"{r['err']:.2e}" for r in rows)
    log(f"[enron] 4-mode nnz={t.nnz} R=16: sweep-0 fit {fit:.6f}; per-mode "
        f"max_abs_err [{errs}]")


def dense_lowrank(shape, rank, seed):
    from repro_torch.core.tensors import SparseTensor
    rng = np.random.default_rng(seed)
    facs = [rng.standard_normal((d, rank)) for d in shape]
    dense = np.einsum("ir,jr,kr->ijk", *facs)
    idx = np.array(list(itertools.product(*[range(d) for d in shape])),
                   dtype=np.int32)
    return SparseTensor(idx, dense.reshape(-1).astype(np.float32), shape)


def phase_recovery():
    from repro_torch.core import cpals, flycoo
    t = dense_lowrank((40, 30, 20), 4, seed=0)
    res = cpals.cp_als_distributed(flycoo.build_flycoo(t, 1), 4,
                                   backend="pallas_fused_gather", iters=40,
                                   seed=1)
    log(f"[recovery] dense rank-4 (40,30,20): fit {res.fit:.6f} after "
        f"{res.iters} sweeps")
    require(res.fit > 0.999, f"exact recovery fit {res.fit}")


def phase_cli() -> dict:
    """``python -m repro_torch.oocore`` and ``python -m
    repro_torch.reorder`` on the card. Returns their launches."""
    from repro_torch.oocore import __main__ as oocore_cli
    from repro_torch.reorder import __main__ as reorder_cli
    total = dict.fromkeys(SOURCE, 0)
    for name, cli in (("oocore", oocore_cli), ("reorder", reorder_cli)):
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main([])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = counts()
        log(f"[cli] python -m repro_torch.{name}: rc {rc} in {secs:.2f} s; "
            "launches " + ", ".join(f"{k} {v}" for k, v in launched.items()
                                    if v))
        require(rc == 0, f"[cli] python -m repro_torch.{name} returned {rc}")
        require(launched["fused_mttkrp_nmode_gather_stream"] >= 3
                and launched["fused_mttkrp_nmode_gather"] >= 1,
                f"[cli] {name}: B6 and B1 must launch, got {launched}")
        for k, v in launched.items():
            total[k] += v
    return total


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(gpu: str) -> dict:
    """The port's examples on the card, with their asserts. Returns their
    launches (the LM example launches none of the six kernels)."""
    import contextlib
    import io
    reset_counts()
    out = {}
    for name, kw in (("torch_quickstart", {}),
                     ("torch_cp_decompose_distributed", {}),
                     ("torch_lm_serve", {}),
                     ("torch_lm_train", {"resume_demo": True})):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            got = _example(name).main(**kw)
        secs = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        for ln in lines:
            log(f"[examples] {name}: {ln}")
        require(lines and lines[-1] == "OK", f"[examples] {name}: no OK")
        out[name] = (got, secs)
    dist_res, secs = out["torch_cp_decompose_distributed"]
    lm_train, lm_train_s = out["torch_lm_train"]
    log(f"[examples] lm_train {lm_train_s:.1f} s: held-out loss "
        f"{lm_train['start']:.4f} -> {lm_train['end']:.4f} over "
        f"{len(lm_train['history'])} resumed steps")
    log(f"[examples] quickstart {out['torch_quickstart'][1]:.1f} s; "
        f"lm_serve {out['torch_lm_serve'][1]:.1f} s; "
        f"distributed {secs:.1f} s: fits 3-mode {dist_res['fit3']:.6f}, "
        f"4-mode auto {dist_res['fit4']:.6f}; all-modes spMTTKRP, 8 workers "
        f"on one card (CUDA events): Dynasor {dist_res['ms']['dynasor']:.3f}"
        f" ms ({dist_res['bytes']['dynasor']} B to the collectives), "
        f"all-reduce baseline {dist_res['ms']['allreduce-baseline']:.3f} ms "
        f"({dist_res['bytes']['allreduce-baseline']} B); {gpu}")
    launched = counts()
    log("[examples] launches " + ", ".join(
        f"{k} {v}" for k, v in launched.items() if v))
    require(launched["fused_mttkrp_nmode_gather"] > 0,
            "[examples] the 4-mode auto run launched no B1")
    return launched


# [dryrun] (d): the production grid's cells run here, each in its own
# process, DRYRUN_PROCESSES at once. The whole 16 x 16 grid takes 2 h of
# CPU (PERF.md §5: a prefill_32k or dense train_4k cell 0.5-4 min, an
# MoE train_4k cell 18-44 min), so the phase runs the cells that take
# seconds: every decode_32k and long_500k cell (the skipped ones
# included, whose reasons are gated), within ~120 s.
DRYRUN_PROCESSES = 8
DRYRUN_GRID_SHAPES = ("decode_32k", "long_500k")


def dryrun_predict(cfg, shape, grad_accum=None) -> dict:
    """The dry-run's prediction for ``cfg`` at ``shape`` on the host mesh
    (one card): ``launch.dryrun.count_step`` (the step built as the
    dry-run builds it, run on meta tensors under ``launch.flops``), its
    counts, the bytes of its arguments, the peak of the bytes it creates,
    and ``launch.roofline``'s terms on the H100's published constants."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.roofline import summarize_cell
    counted = D.count_step(cfg, shape, make_host_mesh(),
                           grad_accum=grad_accum)
    costs, arg_bytes = counted["costs"], counted["argument_bytes"]
    terms = summarize_cell(costs, {}, counted["workers"])["roofline"]
    return dict(costs, argument_bytes=arg_bytes,
                predicted_peak_bytes=arg_bytes + costs["peak_bytes"],
                bound_ms=terms["bound_s"] * 1e3,
                dominant=terms["dominant"])


def phase_dryrun(gpu: str) -> dict:
    """The dry-run tools (``repro_torch.launch.dryrun``, ``flops``,
    ``roofline``) on the card's host: (a) predictions for [serve]'s and
    [train]'s steps on the host mesh (1, 1), the same ``ShapeSpec``-level
    inputs the phases take; (b) nothing is allocated on the card while
    they run; (d) the production 16 x 16 grid's cells of
    DRYRUN_GRID_SHAPES, every runnable one ``ok`` and every skipped one
    with ``configs.skip_reason``'s reason. (c), the predictions against
    what [serve] and [train] measure, is :func:`dryrun_vs_measured`."""
    from repro_torch.configs import ARCHS, SHAPES, get_config, skip_reason
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import HW
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    serve_cfg, train_cfg = get_config(SERVE_ARCH), get_config(TRAIN_ARCH)
    b, lp, n = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS
    t0 = time.perf_counter()
    pred = {
        "prefill": dryrun_predict(serve_cfg, ShapeSpec(
            "serve_prefill", lp, b, "prefill")),
        # A decode step over the session's cache of lp + n + 1 slots.
        "decode": dryrun_predict(serve_cfg, ShapeSpec(
            "serve_decode", lp + n + 1, b, "decode")),
        "train": dryrun_predict(train_cfg, ShapeSpec(
            "train_smoke", TRAIN_SEQ, TRAIN_BATCH, "train"),
            grad_accum=TRAIN_ACCUM),
    }
    pred_s = time.perf_counter() - t0
    for what, p in pred.items():
        log(f"[dryrun] {what} predicted on the host mesh (1, 1): FLOPs "
            f"{p['flops']} (bf16 {p['flops_bf16']}, fp32 "
            f"{p['flops_fp32']}), modeled bytes {p['hbm_bytes_model']} "
            f"(products {p['dot_bytes']}, gathers {p['gather_bytes']}); "
            f"arguments {p['argument_bytes']} B + peak {p['peak_bytes']} B "
            f"= {p['predicted_peak_bytes'] / 1e9:.3f} GB; roofline bound "
            f"{p['bound_ms']:.3f} ms ({p['dominant']}, H100 data sheet)  "
            f"[{gpu}]")
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    log(f"[dryrun] predictions took {pred_s:.1f} s; device memory "
        f"allocated before {before} B, after {after} B")
    require(after == before, f"[dryrun] the dry-runs allocated "
            f"{after - before} B on the card")

    t0 = time.perf_counter()
    jobs = [(arch, shape, False, None, None, HW, None)
            for arch in ARCHS for shape in DRYRUN_GRID_SHAPES]
    cells = {}
    for text, info in D.run_cells(jobs, DRYRUN_PROCESSES):
        log(f"{text}  [{gpu}]")
        cells[(info["arch"], info["shape"])] = info
    grid_s = time.perf_counter() - t0
    bad = []
    for (arch, shape), info in sorted(cells.items()):
        reason = skip_reason(get_config(arch), SHAPES[shape])
        want = "skipped" if reason else "ok"
        if info["status"] != want or info.get("reason") != reason:
            bad.append((arch, shape, info["status"]))
    n_ok = sum(i["status"] == "ok" for i in cells.values())
    log(f"[dryrun] 16x16 grid, shapes {DRYRUN_GRID_SHAPES}: {n_ok} ok, "
        f"{len(cells) - n_ok} skipped with the reference's reasons, in "
        f"{grid_s:.1f} s ({DRYRUN_PROCESSES} processes)")
    require(len(cells) == len(jobs) and not bad,
            f"[dryrun] grid cells not as expected: {bad}")
    require(torch.cuda.memory_allocated() == before,
            "[dryrun] the grid allocated on the card")
    return {"predictions": pred, "predict_s": pred_s, "grid_s": grid_s,
            "grid": {f"{a}__{s}": {k: i.get(k) for k in (
                "status", "reason", "flops_per_chip", "roofline",
                "memory_analysis", "analytic_hbm_gb", "analytic_fits",
                "cell_s")} for (a, s), i in sorted(cells.items())}}


def dryrun_vs_measured(dry: dict, serve: dict, train: dict,
                       gpu: str) -> dict:
    """(c) of [dryrun]: [serve]'s and [train]'s measured peaks and times
    beside the dry-run's predictions, as ratios (findings, not gates).
    Serving's peak is held against the larger of the prefill's and the
    decode step's predicted peaks."""
    p = dry["predictions"]
    rows = {
        "serve_peak": (serve["peak_bytes"], max(
            p["prefill"]["predicted_peak_bytes"],
            p["decode"]["predicted_peak_bytes"])),
        "prefill_ms": (serve["prefill_ms"], p["prefill"]["bound_ms"]),
        "decode_step_ms": (serve["decode_step_ms"],
                           p["decode"]["bound_ms"]),
        "train_peak": (train["peak_bytes"],
                       p["train"]["predicted_peak_bytes"]),
        "train_step_ms": (train["step_ms"], p["train"]["bound_ms"]),
    }
    out = {}
    for what, (got, want) in rows.items():
        out[what] = {"measured": got, "predicted": want,
                     "ratio": got / want if want else None}
        log(f"[dryrun] {what}: measured {got:.6g}, predicted {want:.6g}, "
            f"measured / predicted {got / want:.4f}  [{gpu}]")
    return out


def lm_forward_work(cfg, batch: int, seq: int, mem_len: int = 0, *,
                    unembed_rows: int | None = None) -> dict:
    """What one forward of ``batch`` x ``seq`` tokens needs, counting the
    run's data (``mem_len``: the memory's length, the encoder's frames or
    the image tokens). ``mm``: FLOPs of the weight products, which run on
    the bf16 tensor cores (attention's projections, the MLP, mamba's
    ``in_proj`` / ``out_proj``, an MoE layer's shared experts and the
    three products of each routed (token, expert) pair, the encoder's
    layers and the frontend projection over the memory's tokens, the
    cross-attention's K/V over the memory, the unembedding of
    ``unembed_rows`` rows, default every token); ``fp32``: FLOPs of the
    products the path runs in fp32 (attention's scores and PV over every
    score of the square the recurrence computes, ``seq`` x ``seq`` for
    self-attention and ``seq`` x ``mem_len`` for cross-attention; the MoE
    router; the SSD's intra-chunk, chunk-state and state-to-output
    products). ``weights``: the matrix elements a decode step reads
    (decoder, routed experts not included); ``enc_weights``: those only
    the memory needs (encoder, frontend projections, the cross-attention
    K/V projections); ``kv_bytes`` / ``cross_bytes`` / ``ssm_bytes``:
    per cache slot of K/V, the whole cross-attention caches and the SSM
    state, bf16 / fp32, as a decode step reads them.

    ``mm_recompute`` / ``fp32_recompute``: what a train step's backward
    recomputes under remat. ``model.forward`` checkpoints each repeat
    group of layers (non-reentrant), and each layer inside a group of more
    than two; the encoder's groups, not their layers. A checkpoint's
    recompute stops once every tensor its backward saved is back, before
    the last product of its function (the down projection of the MLP or
    of the shared experts, mamba's ``out_proj``), whose output nothing
    saves; an MoE layer without shared experts ends in the combine, which
    saves its routed products' output, so it recomputes whole. So a group
    recomputes its layers but that last product, and a nested group its
    layers but the last in full (their own checkpoints run whole inside
    it) and then each layer but its last product. The unembedding and the
    frontend projections lie outside every checkpoint."""
    d, tok, mtok = cfg.d_model, batch * seq, batch * mem_len
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.d_state
    h, p = cfg.ssm_heads, cfg.ssm_headdim
    f = cfg.d_ff_expert or cfg.d_ff
    qd, kvd, dh, heads = cfg.q_dim, cfg.kv_dim, cfg.head_dim, cfg.n_heads
    w_attn = d * (qd + 2 * kvd) + qd * d
    rows = tok if unembed_rows is None else unembed_rows
    out = {"mm": 2 * rows * cfg.vocab_padded * d, "fp32": 0,
           "weights": cfg.vocab_padded * d, "enc_weights": 0,
           "kv_bytes": 0, "cross_bytes": 0, "ssm_bytes": 0,
           "mm_recompute": 0, "fp32_recompute": 0}

    def layer(kind, tokens, length, mode):
        """Adds one layer's work; returns its ``(mm, fp32, last)``, with
        ``last`` the FLOPs of its last product."""
        mm0, fp0 = out["mm"], out["fp32"]
        mixer, _, ffn = kind.partition("+")
        if mixer == "mamba":
            w = d * (2 * di + 2 * g * n + h) + di * d
            c = min(cfg.ssm_chunk, length)
            nc = -(-length // c)
            out["fp32"] += 2 * batch * h * nc * c * c * (n + p) \
                + 2 * 2 * batch * nc * c * h * p * n
            out["ssm_bytes"] += 2 * 4 * batch * (
                (cfg.d_conv - 1) * (di + 2 * g * n) + h * p * n)
            out["mm"] += 2 * tokens * w
            out[mode] += w + cfg.d_conv * (di + 2 * g * n)
        if mixer in ("attn", "attn_local", "attn_cross"):
            out["mm"] += 2 * tokens * w_attn
            out["fp32"] += 4 * batch * heads * length * length * dh
            out[mode] += w_attn
            if mode == "weights":
                out["kv_bytes"] += 2 * batch * kvd * 2
        if mixer in ("xattn", "attn_cross"):
            out["mm"] += 2 * tokens * 2 * qd * d + 2 * mtok * 2 * d * kvd
            out["fp32"] += 4 * batch * heads * length * mem_len * dh
            out["weights"] += 2 * qd * d
            out["enc_weights"] += 2 * d * kvd
            out["cross_bytes"] += 2 * batch * mem_len * kvd * 2
        if ffn == "mlp":
            out["mm"] += 2 * tokens * 3 * d * cfg.d_ff
            out[mode] += 3 * d * cfg.d_ff
        elif ffn == "moe":
            shared = 3 * d * cfg.n_shared_experts * f
            out["mm"] += 2 * tokens * (cfg.top_k * 3 * d * f + shared)
            out["fp32"] += 2 * tokens * d * cfg.n_experts_padded
            out[mode] += shared
        last = {"mlp": cfg.d_ff, "moe": cfg.n_shared_experts * f}.get(
            ffn, di)
        return out["mm"] - mm0, out["fp32"] - fp0, 2 * tokens * last * d

    def groups(pattern, reps, tokens, length, mode, nested):
        for _ in range(reps):
            per = [layer(kind, tokens, length, mode) for kind in pattern]
            cut = [(mm - last, fp32) for mm, fp32, last in per]
            runs = per[:-1] + (cut if nested else cut[-1:])
            out["mm_recompute"] += sum(r[0] for r in runs)
            out["fp32_recompute"] += sum(r[1] for r in runs)

    groups(cfg.pattern, cfg.n_repeats, tok, seq, "weights",
           nested=len(cfg.pattern) > 2)
    if cfg.family == "encdec":
        out["mm"] += 2 * mtok * (cfg.d_frontend or d) * d
        out["enc_weights"] += (cfg.d_frontend or d) * d
        groups(cfg.enc_pattern, cfg.n_enc_layers // len(cfg.enc_pattern),
               mtok, mem_len, "enc_weights", nested=False)
    if cfg.family == "vlm":
        out["mm"] += 2 * mtok * (cfg.d_frontend or d) * d
        out["enc_weights"] += (cfg.d_frontend or d) * d
    return out


def serve_bound_ms(cfg, batch: int, prompt: int, cache_len: int, *,
                   routed_prefill=(), routed_decode=(),
                   mem_len: int = 0) -> dict:
    """Least times of the serving path's two steps on this card's
    published peaks, counting what the run's data needs
    (:func:`lm_forward_work`; the unembedding of the last position only).

    Prefill: its bf16 and fp32 products at their peaks, against its bytes:
    every weight matrix read once (the encoder's and the frontend's
    included), of an MoE layer's experts only the distinct ones its router
    picked (``routed_prefill``: one count per MoE layer, in order). Decode
    step: the decoder's weights (experts: ``routed_decode``), the bf16 K/V
    cache of ``cache_len`` slots, the cross-attention caches of
    ``mem_len`` slots and the fp32 SSM state, read once (and the state
    written); its products are negligible."""
    from repro_torch.models.params import torch_dtype
    pb = torch_dtype(cfg.param_dtype).itemsize
    f = cfg.d_ff_expert or cfg.d_ff
    work = lm_forward_work(cfg, batch, prompt, mem_len, unembed_rows=batch)
    expert = 3 * cfg.d_model * f * pb
    router = 4 * cfg.d_model * cfg.n_experts_padded
    n_moe = sum("+moe" in k for k in cfg.pattern) * cfg.n_repeats
    fixed = work["weights"] * pb + n_moe * router
    t_ops = (work["mm"] / hw_peak("peak_flops_bf16")
             + work["fp32"] / hw_peak("peak_flops_fp32")) * 1e3
    pre_bytes = fixed + work["enc_weights"] * pb \
        + expert * sum(routed_prefill)
    t_bytes = pre_bytes / hw_peak("hbm_bw") * 1e3
    dec_bytes = fixed + expert * sum(routed_decode) \
        + work["kv_bytes"] * cache_len + work["cross_bytes"] \
        + work["ssm_bytes"]
    return {"prefill_bound_ms": max(t_ops, t_bytes),
            "prefill_bound_by": "operations" if t_ops >= t_bytes
            else "bytes",
            "prefill_bf16_flops": work["mm"],
            "prefill_fp32_flops": work["fp32"],
            "prefill_bytes": pre_bytes, "decode_step_bytes": dec_bytes,
            "decode_step_bound_ms": dec_bytes / hw_peak("hbm_bw") * 1e3}


class MoeProbe:
    """While active, wraps ``repro_torch.models.moe``'s ``router_assign``
    and ``moe_apply`` (both reached through the module, so the model's
    calls go through the wrappers): per MoE call, in layer order, the
    distinct experts routed, the pairs dropped, the router's ``(probs,
    ids)`` and the bytes the owner path's psum was handed (0 on the
    gather path). With ``replay`` (a list of ``(probs, ids)``, one per
    call) the router's own choice is recorded and ``replay``'s is used in
    its place. It reads the device: use it on runs that are not timed."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from repro_torch.models import moe
        self.distinct, self.dropped, self.routes = [], [], []
        self.sent_bytes = []
        self._moe, self._orig = moe, (moe.router_assign, moe.moe_apply)
        route, apply = self._orig

        def router_assign(*args, **kw):
            probs, ids, aux = route(*args, **kw)
            self.distinct.append(int(torch.unique(ids).numel()))
            self.routes.append((probs, ids))
            if self.replay is not None:
                probs, ids = self.replay[len(self.routes) - 1]
            return probs, ids, aux

        def moe_apply(*args, **kw):
            y, metrics = apply(*args, **kw)
            self.dropped.append(metrics["moe_dropped"])
            self.sent_bytes.append(metrics.get("moe_sent_bytes", 0))
            return y, metrics

        moe.router_assign, moe.moe_apply = router_assign, moe_apply
        return self

    def __exit__(self, *exc):
        self._moe.router_assign, self._moe.moe_apply = self._orig

    def total_dropped(self) -> int:
        return int(sum(int(x) for x in self.dropped))

    def per_layer_dropped(self) -> list:
        return [int(x) for x in self.dropped]

    def ids(self, batch: int):
        """``(layers, batch, tokens, k)``: every layer's sorted ids."""
        return torch.stack([torch.sort(i, dim=1).values.reshape(
            batch, -1, i.shape[-1]) for _, i in self.routes])


def _logits_check(got, want, tol: float, what: str, tag: str,
                  note: str = "", strict: bool = False,
                  against: str = "teacher-forced forward"
                  ) -> tuple[bool, float]:
    """``torch.allclose(got, want, rtol=tol, atol=tol · max|want|)``, or
    with ``strict`` max abs err / max|want| <= tol; logged with the max
    abs and relative error and which limit held; ``(ok, relative)``.
    ``against`` names ``want`` in the log."""
    got, want = got.float(), want.float()
    require(torch.isfinite(got).all() and torch.isfinite(want).all(),
            f"{tag} {what}: non-finite logits")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if strict:
        ok, limit = err <= tol * scale, f"max abs err / max|logits| <= {tol}"
    else:
        ok = torch.allclose(got, want, rtol=tol, atol=tol * scale)
        limit = f"allclose rtol {tol}, atol {tol} x max|logits|"
    log(f"{tag} {what} vs {against}: max abs err {err:.4e}, "
        f"max|logits| {scale:.4f}, relative {err / scale:.4e} ({limit})"
        f"{note}: {'ok' if ok else 'FAIL'}")
    return ok, err / scale


def _serve_check(cfg, params, prompts, first, tag: str,
                 tols=(SERVE_TOL_PREFILL, SERVE_TOL_DECODE),
                 strict: bool = False, extras=None) -> dict:
    """Prefill and one decode step against teacher-forced ``forward``
    (``first``: the first greedy token, appended to the prompts), and the
    first greedy token against prefill's argmax (meaningful at the
    session's own config).

    For an MoE arch the decode step runs twice. Once as it is: a bf16
    ulp between decode and the forward (the decode step reads the bf16
    K/V cache, the forward its own K/V) can move a token's top-k choice,
    after which that request's logits differ by far more than rounding;
    this run is a finding, with the number of (request, layer) routes
    that differ from the forward's. And once with the forward's routing
    of the new position replayed into each layer's router: that run
    differs from the forward by rounding only, and is the check. Also
    the pairs prefill, forward and the decode step dropped and the
    distinct experts routed per MoE layer. ``tols`` and ``strict`` are
    :func:`_logits_check`'s, for prefill and decode; ``extras`` the stub
    frontend's input (``frames`` / ``img``), the same for both."""
    from repro_torch.launch.serve import _pad_caches
    from repro_torch.models import model as M
    dev = torch.device("cuda")
    b, lp = prompts.shape
    toks = torch.from_numpy(np.concatenate([prompts, first[:, None]], 1)
                            ).to(dev)
    extras = extras or {}
    with MoeProbe() as fwd:
        full, _ = M.forward(cfg, params, toks, remat=False, **extras)
    with MoeProbe() as pre:
        last, cache = M.prefill(cfg, params, toks[:, :lp], **extras)
    cache = _pad_caches(cache, lp, lp + 1)
    routed = bool(cfg.n_experts)
    fresh = (lambda: {g: {k: c.clone() for k, c in leaves.items()}
                      for g, leaves in cache.items()}) if routed \
        else (lambda: cache)
    with MoeProbe() as dec:
        step, _ = M.decode_step(cfg, params, fresh(), toks[:, lp:], lp)
    out = {"forward_dropped": fwd.total_dropped(),
           "prefill_dropped": pre.total_dropped(),
           "decode_dropped": dec.total_dropped(),
           "routed_prefill": pre.distinct, "routed_decode": dec.distinct}
    ok_pre, out["prefill_rel_err"] = _logits_check(
        last[:, 0], full[:, lp - 1], tols[0], "prefill", tag, strict=strict)
    if not routed:
        ok_dec, out["decode_rel_err"] = _logits_check(
            step[:, 0], full[:, lp], tols[1], "decode", tag, strict=strict)
    else:
        differ = (dec.ids(b)[:, :, 0] != fwd.ids(b)[:, :, lp]).any(-1)
        out["decode_routes_differing"] = int(differ.sum())
        _, out["decode_own_routes_rel_err"] = _logits_check(
            step[:, 0], full[:, lp], tols[1], "decode (own routes)",
            tag, f"; {int(differ.sum())} of {differ.numel()} (layer, "
            f"request) routes differ from the forward's, in "
            f"{int(differ.any(0).sum())} of {b} requests (a finding)",
            strict=strict)
        replay = [(p.reshape(b, lp + 1, -1)[:, lp],
                   i.reshape(b, lp + 1, -1)[:, lp]) for p, i in fwd.routes]
        with MoeProbe(replay=replay):
            step, _ = M.decode_step(cfg, params, fresh(), toks[:, lp:], lp)
        ok_dec, out["decode_rel_err"] = _logits_check(
            step[:, 0], full[:, lp], tols[1],
            "decode (the forward's routes)", tag, strict=strict)
    out["ok"] = ok_pre and ok_dec
    out["first_is_argmax"] = torch.equal(
        last[:, 0, :cfg.vocab].float().argmax(-1).cpu(),
        torch.from_numpy(first).long())
    return out


def profile_ops(fn, what: str, top: int = 8, tag: str = "serve") -> dict:
    """One profiled call of ``fn``: wall ms, device-busy ms, idle share,
    and the aten ops with the most self device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t_read = time.perf_counter()
    averages = prof.key_averages()        # one aggregation of the trace
    busy = sum(ev.device_time_total for ev in averages
               if ev.device_type == DeviceType.CUDA) / 1e3
    ops = {ev.key: ev.self_device_time_total / 1e3
           for ev in averages
           if ev.device_type == DeviceType.CPU
           and ev.key.startswith("aten::") and ev.self_device_time_total > 0}
    cast_ms = ops.get("aten::copy_", 0.0)
    log(f"[{tag}] profile {what}: wall {wall_ms:.3f} ms, kernels "
        f"{busy:.3f} ms, device idle share {1 - busy / wall_ms:.3f}; "
        f"aten::copy_ (dtype casts and cache writes) {cast_ms:.3f} ms; "
        f"profile read in {time.perf_counter() - t_read:.1f} s")
    for name, ms in sorted(ops.items(), key=lambda kv: -kv[1])[:top]:
        log(f"[{tag}]   op {ms:9.3f} ms  {name}")
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "copy_ms": cast_ms,
            "top_ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:top])}


def phase_serve(gpu: str, arch: str = SERVE_ARCH, tag: str = "[serve]",
                keep_params: bool = False) -> dict:
    """The LM serving path of ``arch`` at its published widths and full
    depth: ``ServeSession.generate`` with its checks and times. For an
    MoE arch also the pairs dropped (prefill and forward, summed over
    layers); where either drops one, the consistency check reruns at the
    smoke configs' drop-free capacity factor and only that rerun must
    pass (prefill and forward then route the same pairs). For the
    ``encdec`` / ``vlm`` families the stub frontend's ``frames`` / ``img``
    drawn as ``repro_torch.launch.serve.main`` draws them, the ``xattn``
    gates opened to ``XATTN_GATE``. With ``keep_params`` the parameters
    stay on the card, in the result's ``"params"`` (not printed)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import (ServeSession, _pad_caches,
                                          frontend_extras)
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params, iter_leaves, \
        spec_bytes
    from repro_torch.obs import counters as ocnt
    dev = torch.device("cuda")
    cfg = get_config(arch)
    b, lp, n = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(M.model_specs(cfg), seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [t for _, t in iter_leaves(params)]
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    require(param_bytes == spec_bytes(M.model_specs(cfg))
            and all(t.dtype == torch.float32 for t in leaves),
            f"{tag} parameters are not the specs' fp32 leaves")
    gates = open_gates(params)
    layers = ", ".join(f"{k} x {cfg.n_repeats}" for k in cfg.pattern)
    extra = ""
    if cfg.family == "encdec":
        extra += (f", encoder {cfg.n_enc_layers} layers ("
                  f"{', '.join(cfg.enc_pattern)}) over frames of width "
                  f"{cfg.d_frontend}")
    if cfg.family == "vlm":
        extra += (f", {cfg.n_img_tokens} image tokens of width "
                  f"{cfg.d_frontend}, {gates} xattn layers' gates set to "
                  f"{XATTN_GATE} (published init 0)")
    if cfg.n_experts:
        extra = (f", {cfg.n_experts} routed experts (padded "
                 f"{cfg.n_experts_padded}) of d_ff {cfg.d_ff_expert}, top-"
                 f"{cfg.top_k}, {cfg.n_shared_experts} shared, capacity "
                 f"factor {cfg.capacity_factor}")
    if "mamba" in "".join(cfg.pattern):
        extra += (f", SSD d_inner {cfg.d_inner}, {cfg.ssm_heads} heads x "
                  f"{cfg.ssm_headdim}, d_state {cfg.d_state}, groups "
                  f"{cfg.ssm_groups}, chunk {cfg.ssm_chunk}, d_conv "
                  f"{cfg.d_conv}")
    log(f"{tag} {cfg.name} ({cfg.family}): {cfg.n_layers} layers ({layers}),"
        f" d_model {cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim} (kv "
        f"{cfg.n_kv_heads}), d_ff {cfg.d_ff}{extra}, vocab {cfg.vocab} "
        f"(padded {cfg.vocab_padded}), tied embeddings "
        f"{cfg.tie_embeddings}, act {cfg.act_dtype}; {param_bytes} B of "
        f"fp32 parameters drawn on the card in {init_s:.2f} s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (b, lp)).astype(np.int32)
    extras = frontend_extras(cfg, rng, b, lp, dev)
    mem_len = {"encdec": lp, "vlm": cfg.n_img_tokens}.get(cfg.family, 0)
    sess = ServeSession(cfg, params, max_len=lp + n + 1)
    runs = {}
    for label, temp in (("greedy", 0.0), ("greedy-rerun", 0.0),
                        ("t0.8", 0.8)):
        with ocnt.use_registry() as reg:
            t0 = time.perf_counter()
            out = sess.generate(prompts, n, temperature=temp, seed=0,
                                extras=extras)
            wall = time.perf_counter() - t0
        pre, dec = reg.get("serve.prefill_s"), reg.get("serve.decode_s")
        runs[label] = dict(out=out, prefill_ms=pre * 1e3,
                           decode_ms_per_token=dec * 1e3 / (n - 1),
                           tokens_per_s=b * n / (pre + dec), wall_s=wall)
        log(f"{tag} generate {label}: {b} x {lp}-token prompts, {n} new "
            f"tokens: prefill {pre * 1e3:.3f} ms, decode "
            f"{dec * 1e3 / (n - 1):.3f} ms/token ({n - 1} steps), "
            f"{b * n / (pre + dec):.1f} tokens/s; wall {wall:.2f} s; "
            f"serve.tokens {reg.get('serve.tokens')}  [{gpu}]")
        require(reg.get("serve.tokens") == b * n,
                f"{tag} serve.tokens {reg.get('serve.tokens')} != {b * n}")
        require(out.shape == (b, n) and out.dtype == np.int32
                and (out >= 0).all() and (out < cfg.vocab).all(),
                f"{tag} {label}: tokens out of [0, {cfg.vocab})")
    greedy = runs["greedy"]["out"]
    require(np.array_equal(greedy, runs["greedy-rerun"]["out"]),
            f"{tag} two greedy runs differ")
    log(f"{tag} greedy runs bitwise equal; greedy tokens of request 0: "
        f"{greedy[0, :12].tolist()}; at t=0.8: "
        f"{runs['t0.8']['out'][0, :12].tolist()}")

    # prefill and one decode step against teacher-forced forward.
    check = _serve_check(cfg, params, prompts, greedy[:, 0], tag,
                         extras=extras)
    require(check["first_is_argmax"],
            f"{tag} first greedy token is not prefill's argmax")
    moe = {}
    if cfg.n_experts:
        from repro_torch.models.moe import capacity
        n_moe = len(check["routed_prefill"])
        caps = [capacity(b * l, cfg.top_k, cfg.capacity_factor,
                         cfg.n_experts_padded) for l in (lp, lp + 1)]
        moe = {k: check[k] for k in (
            "prefill_dropped", "forward_dropped", "decode_dropped",
            "routed_prefill", "routed_decode")}
        log(f"{tag} moe_dropped summed over {n_moe} MoE layers: prefill "
            f"{check['prefill_dropped']} of {b * lp * cfg.top_k * n_moe} "
            f"pairs (capacity {caps[0]} a padded expert), teacher-forced "
            f"forward {check['forward_dropped']} of "
            f"{b * (lp + 1) * cfg.top_k * n_moe} (capacity {caps[1]}), "
            f"decode step {check['decode_dropped']}; distinct experts "
            f"routed per layer: prefill {min(check['routed_prefill'])}-"
            f"{max(check['routed_prefill'])}, decode step "
            f"{min(check['routed_decode'])}-{max(check['routed_decode'])} "
            f"of {cfg.n_experts}")
        if check["prefill_dropped"] or check["forward_dropped"]:
            log(f"{tag} pairs were dropped, so prefill and forward route "
                f"different pairs: the check above is a finding, and reruns "
                f"at capacity factor {DROP_FREE_CAPACITY} (the smoke "
                f"configs' drop-free setting)")
            moe["capacity_1.25_check"] = {
                k: v for k, v in check.items() if k.endswith(
                    ("rel_err", "differing"))}
            free = _serve_check(
                dataclasses.replace(cfg, capacity_factor=DROP_FREE_CAPACITY),
                params, prompts, greedy[:, 0], tag)
            require(free["prefill_dropped"] == free["forward_dropped"] == 0,
                    f"{tag} the drop-free rerun dropped pairs")
            check.update({k: v for k, v in free.items() if k.endswith(
                ("rel_err", "differing")) or k == "ok"})
            moe["drop_free_capacity_factor"] = DROP_FREE_CAPACITY
        moe.update({k: check[k] for k in ("decode_own_routes_rel_err",
                                          "decode_routes_differing")})
    require(check["ok"], f"{tag} prefill or decode disagrees with forward")
    gc.collect()
    peak = torch.cuda.max_memory_allocated()
    fp32 = {}
    if "mamba" in "".join(cfg.pattern) and not cfg.n_experts:
        # At bf16 decode runs the causal conv in fp32 (the reference's
        # promotion) where prefill and forward run it in bf16; at fp32
        # activations every operation of the two runs in one dtype.
        log(f"{tag} the same check at fp32 activations (TF32 off)")
        c32 = _serve_check(dataclasses.replace(cfg, act_dtype="float32"),
                           params, prompts, greedy[:, 0], tag,
                           tols=(SERVE_TOL_FP32, SERVE_TOL_FP32), strict=True)
        require(c32["ok"], f"{tag} at fp32 activations prefill or decode "
                           f"disagrees with forward")
        fp32 = {"fp32_prefill_rel_err": c32["prefill_rel_err"],
                "fp32_decode_rel_err": c32["decode_rel_err"]}
        del c32
        gc.collect()

    # A decode step's time, and the eager per-call weight cast. (Where
    # the time goes op by op: bench_torch/lm_profile.py.)
    _, cache = M.prefill(cfg, params, torch.from_numpy(prompts).to(dev),
                         **extras)
    cache = _pad_caches(cache, lp, lp + n + 1)
    tok = torch.from_numpy(greedy[:, :1]).to(dev)
    step_ms = cuda_ms(lambda: M.decode_step(cfg, params, cache, tok, lp), 5)
    matrices = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "lm_head", "in_proj", "out_proj", "conv_w", "x_wq", "x_wo"}
    if cfg.tie_embeddings:
        matrices.add("embed")
    # A decode step casts the decoder's weights (of cross-attention only
    # the query and output projections: the memory's K/V are cached).
    cast = [t for path, t in iter_leaves(params)
            if path[-1] in matrices and path[0] != "encoder"]
    cast_bytes = sum(t.numel() * 6 for t in cast)     # fp32 read, bf16 write

    def cast_all():
        for t in cast:                                # one copy alive
            t.to(torch.bfloat16)

    cast_ms = cuda_ms(cast_all, 5)
    del cache
    bounds = serve_bound_ms(cfg, b, lp, lp + n + 1,
                            routed_prefill=check["routed_prefill"],
                            routed_decode=check["routed_decode"],
                            mem_len=mem_len)
    cast_bound = cast_bytes / hw_peak("hbm_bw") * 1e3
    log(f"{tag} decode step {step_ms:.3f} ms (CUDA events, 5 steps); bound "
        f"{bounds['decode_step_bound_ms']:.3f} ms "
        f"({bounds['decode_step_bytes']} B: the weight matrices a step "
        f"needs, routed experts only, and the K/V cache and SSM state read "
        f"once, the cross-attention caches of {mem_len} slots); the fp32 "
        f"-> bf16 cast of every weight one step casts, "
        f"alone: {cast_ms:.3f} ms for {cast_bytes} B (bound "
        f"{cast_bound:.3f} ms), {cast_ms / step_ms:.1%} of the step  [{gpu}]")
    warm = runs["greedy-rerun"]
    log(f"{tag} prefill {warm['prefill_ms']:.3f} ms against a bound of "
        f"{bounds['prefill_bound_ms']:.3f} ms "
        f"({bounds['prefill_bound_by']}: {bounds['prefill_bf16_flops']:.4e} "
        f"bf16 + {bounds['prefill_fp32_flops']:.4e} fp32 FLOP, "
        f"{bounds['prefill_bytes']} B); peak device memory "
        f"{peak / 1e9:.3f} GB ({peak} B)  [{gpu}]")
    result = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "param_bytes": param_bytes, "batch": b, "prompt_len": lp,
        "new_tokens": n, "gpu": gpu,
        "prefill_ms": warm["prefill_ms"],
        "decode_ms_per_token": warm["decode_ms_per_token"],
        "tokens_per_s": warm["tokens_per_s"],
        "cold_prefill_ms": runs["greedy"]["prefill_ms"],
        "cold_decode_ms_per_token": runs["greedy"]["decode_ms_per_token"],
        "t0.8_decode_ms_per_token": runs["t0.8"]["decode_ms_per_token"],
        "peak_bytes": peak, "prefill_rel_err": check["prefill_rel_err"],
        "decode_rel_err": check["decode_rel_err"], "decode_step_ms": step_ms,
        "weight_cast_ms": cast_ms, "weight_cast_bytes": cast_bytes,
        "weight_cast_bound_ms": cast_bound, **bounds, **moe, **fp32,
    }
    if cfg.family in ("encdec", "vlm"):
        result["mem_len"] = mem_len
        result["xattn_gate"] = XATTN_GATE if gates else None
    if keep_params:
        result["params"] = params
    del sess, params, leaves, cast
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{tag} freed: {torch.cuda.memory_allocated()} B still allocated "
        f"on the card")
    return result


def _int8_exact_on_card(tag: str, dev) -> dict:
    """``attention.int8_contract`` on the card against the CPU and an
    int64 product: 2048 slots of 127 x 127 (one of 127 x 2), whose exact
    sum 33,016,317 is odd and above 2^24, so no single float32 product
    gives it."""
    from repro_torch.models.attention import int8_contract
    a = torch.full((2, 4, 1, 2048), 127, dtype=torch.int8)
    a[1] = -127
    b = torch.full((2, 4, 2048, 8), 127, dtype=torch.int8)
    b[:, :, 0, :] = 2
    want = torch.matmul(a.long(), b.long())
    got = int8_contract(a.to(dev), b.to(dev)).cpu()
    one_pass = torch.matmul(a.to(dev).float(), b.to(dev).float()).cpu()
    ok = torch.equal(got.long(), want) and torch.equal(
        int8_contract(a, b), got) and not torch.equal(
            one_pass.double(), want.double())
    log(f"{tag} int8 x int8 -> int32 at 2048 slots of +-127 x 127: card == "
        f"CPU == int64 ({int(want[0, 0, 0, 0])}, odd and > 2^24) "
        f"{torch.equal(got.long(), want)}; one float32 product gives "
        f"{float(one_pass[0, 0, 0, 0]):.1f}: {'ok' if ok else 'FAIL'}")
    require(ok, f"{tag} the int8 contraction is not exact on the card")
    return {"exact_at_2048_slots": True}


def _int8_sums_card_vs_cpu(cfg, tag: str, batch: int = 2,
                           prompt: int = 1024, slots: int = 1056) -> dict:
    """At 2 layers of ``cfg`` (full width, fp32 activations, the int8
    cache): prefill ``batch x prompt`` tokens on the card, grow the cache
    to ``slots`` slots, and record every ``int8_contract`` of one decode
    step (the QK and PV sums of each layer); each recorded product of
    int8 codes, recomputed on the CPU and as an int64 product, must equal
    the card's element for element."""
    from repro_torch.launch.serve import _pad_caches
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    c2 = two_layer_config(cfg)
    params = init_params(M.model_specs(c2), seed=0, device="cuda")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, c2.vocab, (batch, prompt + 1)
                                         ).astype(np.int32)).cuda()
    _, cache = M.prefill(c2, params, toks[:, :prompt])
    cache = _pad_caches(cache, prompt, slots)
    seen, contract = [], A.int8_contract

    def recording(a, b):
        out = contract(a, b)
        seen.append((a.cpu(), b.cpu(), out.cpu()))
        return out

    A.int8_contract = recording
    try:
        M.decode_step(c2, params, cache, toks[:, prompt:], prompt)
    finally:
        A.int8_contract = contract
    del params, cache
    equal, largest = True, 0
    for a, b, out in seen:
        cpu = contract(a, b)
        exact = torch.matmul(a.long(), b.long())
        equal &= torch.equal(out, cpu) and torch.equal(out.long(), exact)
        largest = max(largest, int(exact.abs().max()))
    shapes = sorted({(tuple(a.shape), tuple(b.shape)) for a, b, _ in seen})
    ok = equal and len(seen) == 2 * c2.n_layers
    log(f"{tag} 2 layers, full width, {batch} x {prompt} tokens, cache of "
        f"{slots} slots: {len(seen)} int8 contractions of one decode step "
        f"(QK and PV per layer, {shapes}), card == CPU == int64 element "
        f"for element: {equal}; largest |sum| {largest}: "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{tag} the card's integer sums differ from the CPU's")
    return {"int8_contractions": len(seen), "largest_abs_sum": largest}


def phase_serve_int8(gpu: str, params) -> dict:
    """``[serve-int8]``: ``[serve]``'s arch with ``kv_cache_dtype="int8"``
    on ``[serve]``'s weights (``params``, on the card): the same prompts,
    greedy twice; prefill's logits bitwise the bf16 cache's; a decode step
    against teacher-forced ``forward`` within the reference's own int8
    bounds (``INT8_TOL``, ``INT8_TOP1``); the cache's bytes against the
    bf16 cache's; the integer sums exact on the card (2 layers and a
    synthetic case)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeSession, _pad_caches
    from repro_torch.models import model as M
    from repro_torch.obs import counters as ocnt
    tag = "[serve-int8]"
    dev = torch.device("cuda")
    base = get_config(SERVE_ARCH)
    cfg = dataclasses.replace(base, kv_cache_dtype="int8")
    b, lp, n = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS
    rng = np.random.default_rng(0)             # [serve]'s prompts
    prompts = rng.integers(0, cfg.vocab, (b, lp)).astype(np.int32)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sess = ServeSession(cfg, params, max_len=lp + n + 1)
    runs = {}
    for label in ("greedy", "greedy-rerun"):
        with ocnt.use_registry() as reg:
            out = sess.generate(prompts, n)
        pre, dec = reg.get("serve.prefill_s"), reg.get("serve.decode_s")
        runs[label] = dict(out=out, prefill_ms=pre * 1e3,
                           decode_ms_per_token=dec * 1e3 / (n - 1),
                           tokens_per_s=b * n / (pre + dec))
        log(f"{tag} generate {label}: {b} x {lp}-token prompts, {n} new "
            f"tokens, int8 K/V cache: prefill {pre * 1e3:.3f} ms, decode "
            f"{dec * 1e3 / (n - 1):.3f} ms/token, {b * n / (pre + dec):.1f}"
            f" tokens/s  [{gpu}]")
        require(out.shape == (b, n) and (out >= 0).all()
                and (out < cfg.vocab).all(), f"{tag} tokens out of range")
    greedy = runs["greedy"]["out"]
    require(np.array_equal(greedy, runs["greedy-rerun"]["out"]),
            f"{tag} two greedy runs differ")
    peak = torch.cuda.max_memory_allocated()
    del sess
    # prefill: bitwise the bf16 cache's; the caches' bytes at max_len.
    toks = torch.from_numpy(prompts).to(dev)
    last8, cache8 = M.prefill(cfg, params, toks)
    last, cache = M.prefill(base, params, toks)
    bitwise = torch.equal(last8, last)

    def nbytes(c):
        c = _pad_caches(c, lp, lp + n + 1)
        by = {}
        for leaves in c.values():
            for k, t in leaves.items():
                by[k] = by.get(k, 0) + t.numel() * t.element_size()
        return by

    by8, by16 = nbytes(cache8), nbytes(cache)
    del cache
    log(f"{tag} prefill logits bitwise the bf16 cache's: {bitwise}; cache "
        f"at {lp + n + 1} slots: int8 {sum(by8.values())} B ({by8}) against "
        f"bf16 {sum(by16.values())} B, "
        f"{sum(by8.values()) / sum(by16.values()):.1%}")
    require(bitwise, f"{tag} int8 prefill logits differ from the bf16 "
                     f"cache's")
    # a decode step against teacher-forced forward (bf16 cache config).
    full_toks = torch.from_numpy(np.concatenate(
        [prompts, greedy[:, :1]], 1)).to(dev)
    full, _ = M.forward(base, params, full_toks, remat=False)
    step, _ = M.decode_step(cfg, params, _pad_caches(cache8, lp, lp + 1),
                            full_toks[:, lp:], lp)
    got, want = step[:, 0].float(), full[:, lp].float()
    rel = float((got - want).abs().max() / want.abs().max())
    top1 = float((got[:, :cfg.vocab].argmax(-1)
                  == want[:, :cfg.vocab].argmax(-1)).float().mean())
    ok = rel <= INT8_TOL and top1 >= INT8_TOP1 and bool(
        torch.isfinite(got).all())
    log(f"{tag} decode step vs teacher-forced forward (bf16 K/V): max abs "
        f"err / max|logits| {rel:.4e} (bound {INT8_TOL}), top-1 agreement "
        f"{top1:.3f} (bound {INT8_TOP1}): {'ok' if ok else 'FAIL'}")
    require(ok, f"{tag} the int8 decode step is past the reference's "
                f"bounds")
    del full, step, cache8
    tok = torch.from_numpy(greedy[:, :1]).to(dev)
    _, c8 = M.prefill(cfg, params, toks)
    c8 = _pad_caches(c8, lp, lp + n + 1)
    step_ms = cuda_ms(lambda: M.decode_step(cfg, params, c8, tok, lp), 5)
    del c8
    gc.collect()
    log(f"{tag} decode step {step_ms:.3f} ms (CUDA events, 5 steps); peak "
        f"device memory {peak / 1e9:.3f} GB ({peak} B)  [{gpu}]")
    result = {
        "arch": cfg.name, "kv_cache_dtype": "int8", "batch": b,
        "prompt_len": lp, "new_tokens": n, "gpu": gpu,
        "prefill_ms": runs["greedy-rerun"]["prefill_ms"],
        "decode_ms_per_token": runs["greedy-rerun"]["decode_ms_per_token"],
        "tokens_per_s": runs["greedy-rerun"]["tokens_per_s"],
        "cold_prefill_ms": runs["greedy"]["prefill_ms"],
        "decode_step_ms": step_ms, "peak_bytes": peak,
        "cache_bytes": sum(by8.values()), "cache_bytes_by_leaf": by8,
        "bf16_cache_bytes": sum(by16.values()),
        "decode_rel_err": rel, "decode_top1": top1,
        "prefill_bitwise_bf16_cache": bitwise,
    }
    result.update(_int8_exact_on_card(tag, dev))
    result.update(_int8_sums_card_vs_cpu(cfg, tag))
    gc.collect()
    torch.cuda.empty_cache()
    return result


def owner_order_tokens(ids, dropped, n_exp: int, e_local: int):
    """``(T,)`` bool: the tokens whose routed sum the owner path may add
    in another grouping than the gather path. The gather path adds a
    token's kept rows left to right in expert order; the owner path adds
    each owner's rows left to right, then the owners' partials in owner
    order: the same additions exactly when every owner after the token's
    first holds at most one of its kept rows. ``dropped`` ``(T, k)``
    marks the pairs past capacity (a zero row in both paths)."""
    owner = torch.where(dropped, -1, ids.long() // e_local)
    counts = torch.stack([(owner == o).sum(1) for o in range(n_exp)], 1)
    first = torch.argmax((counts > 0).int(), dim=1)
    later = torch.arange(n_exp, device=ids.device)[None] > first[:, None]
    return ((counts > 1) & later).any(1)


def _dropped_pairs(ids, cap: int):
    """``(T, k)`` bool: the pairs past their expert's capacity, in the
    dispatch's stable (token, slot) order."""
    e = ids.reshape(-1).long()
    order = torch.argsort(e, stable=True)
    e_s = e[order]
    rank = torch.arange(e.numel(), device=e.device) - torch.searchsorted(
        e_s, e_s)
    out = torch.empty_like(e, dtype=torch.bool)
    out[order] = rank >= cap
    return out.reshape(ids.shape)


def _owner_layer_check(cfg, params, mesh, tag: str) -> dict:
    """One MoE layer of ``cfg`` (layer 0's weights) on 8 x 1024 random
    bf16 tokens: the owner path against the gather path, without the
    shared experts (the routed sum: bitwise but on the tokens
    ``owner_order_tokens`` names) and with them (the split ``f`` sum:
    within a bf16 ulp's reach, element counts reported)."""
    from repro_torch.models import moe
    from repro_torch.models.sharding import use_mesh_rules
    p = {k: v[0] if k != "shared" else {s: w[0] for s, w in v.items()}
         for k, v in params["blocks"]["p0"]["moe"].items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((SERVE_BATCH, SERVE_PROMPT, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    kw = dict(n_real=cfg.n_experts, top_k=cfg.top_k,
              capacity_factor=cfg.capacity_factor)
    out = {}
    for label, pp in (("routed", {k: v for k, v in p.items()
                                  if k != "shared"}), ("with shared", p)):
        yg, mg = moe.moe_apply(pp, x, **kw)
        with use_mesh_rules(mesh):
            yo, mo = moe.moe_apply(pp, x, **kw)
        differ = (yg != yo).reshape(-1, cfg.d_model).any(1)
        row = {"tokens_differing": int(differ.sum()),
               "dropped_gather": int(mg["moe_dropped"]),
               "dropped_owner": int(mo["moe_dropped"]),
               "rel_err": _rel_err(yo, yg)}
        ok = row["dropped_gather"] == row["dropped_owner"]
        if label == "routed":
            _, ids, _ = moe.router_assign(x.reshape(-1, cfg.d_model),
                                          p["router"], cfg.n_experts,
                                          cfg.top_k)
            cap = moe.capacity(x.shape[0] * x.shape[1], cfg.top_k,
                               cfg.capacity_factor, cfg.n_experts_padded)
            n_exp = mesh.shape["model"]
            may = owner_order_tokens(ids, _dropped_pairs(ids, cap), n_exp,
                                     cfg.n_experts_padded // n_exp)
            row["tokens_in_another_grouping"] = int(may.sum())
            row["differing_outside_them"] = int((differ & ~may).sum())
            ok &= row["differing_outside_them"] == 0
        ok &= row["rel_err"] <= 2e-2
        log(f"{tag} one MoE layer ({label}) on {x.shape[0]} x {x.shape[1]} "
            f"bf16 tokens, owner vs gather: {row}: {'ok' if ok else 'FAIL'}")
        require(ok, f"{tag} one layer's owner path disagrees ({label})")
        out[label.replace(" ", "_")] = row
    return out


def _owner_train_checks(cfg, mesh, tag: str, batch: int = 2,
                        seq: int = 64) -> dict:
    """At 2 layers of ``cfg``, full width, fp32 activations: the routes and
    per-layer drops of a forward under ``mesh`` equal the gather path's
    exactly; the gradients of ``accumulate_grads`` (2 microbatches) under
    ``mesh`` against the gather path's on the card and against the owner
    path's on the CPU (losses within CARD_CPU_STEP_TOL relative, each
    leaf within CARD_CPU_TOL of its max|g|; the elements that differ
    bitwise from the gather path's are counted); then one whole
    ``make_train_step(mesh=, rules=rules_for(train_4k),
    param_shardings=)`` step against the step without a mesh."""
    from repro_torch import optim
    from repro_torch.configs import SHAPES
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    from repro_torch.models.params import (init_params, iter_leaves,
                                           tree_shardings)
    from repro_torch.models.sharding import use_mesh_rules
    t0 = time.perf_counter()
    c2 = two_layer_config(cfg)
    rules = S.rules_for(SHAPES["train_4k"])
    b = SyntheticLMData(c2.vocab, seq, batch, seed=0).batch(0)
    card = init_params(M.model_specs(c2), seed=0, device="cuda")
    tb = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
    with torch.no_grad():
        with MoeProbe() as g:
            fg, _ = M.forward(c2, card, tb["tokens"], remat=False)
        with MoeProbe() as o, use_mesh_rules(mesh, rules):
            fo, _ = M.forward(c2, card, tb["tokens"], remat=False)
    routes_equal = all(torch.equal(a[1], c[1])
                       for a, c in zip(g.routes, o.routes))
    drops = (g.per_layer_dropped(), o.per_layer_dropped())
    out = {"routes_equal": routes_equal, "dropped_gather": drops[0],
           "dropped_owner": drops[1], "psum_bytes": sum(o.sent_bytes),
           "logits_rel_err": _rel_err(fo, fg),
           "logits_differing": int((fo != fg).sum()),
           "logits_elements": fo.numel()}
    del fg, fo
    runs = {}
    for label, params, ctx in (
            ("gather", card, contextlib.nullcontext()),
            ("owner", card, use_mesh_rules(mesh, rules)),
            ("owner-cpu", _to(card, "cpu"), use_mesh_rules(mesh, rules))):
        dev = next(iter_leaves(params))[1].device
        with ctx:
            (loss, metrics), grads = S.accumulate_grads(
                c2, params, {k: v.to(dev) for k, v in tb.items()}, 2)
        runs[label] = (dict(metrics, loss=loss), grads)
        del params
    rel, diff, n = {}, 0, 0
    for other in ("gather", "owner-cpu"):
        (wm, want), (gm, got) = runs[other], runs["owner"]
        worst = max(abs(float(gm[k]) - float(wm[k]))
                    / max(abs(float(wm[k])), 1e-30)
                    for k in ("loss", "ce", "z_loss", "moe_aux"))
        gworst = 0.0
        for (_, a), (_, w) in zip(iter_leaves(got), iter_leaves(want)):
            w = w.to("cuda")
            gworst = max(gworst, float((a - w).abs().max())
                         / max(float(w.abs().max()), 1e-30))
            if other == "gather":
                diff += int((a != w).sum())
                n += a.numel()
        rel[other] = (worst, gworst)
    del runs
    out.update(grad_vs_gather=rel["gather"][1],
               loss_vs_gather=rel["gather"][0],
               grad_vs_cpu=rel["owner-cpu"][1], loss_vs_cpu=rel["owner-cpu"][0],
               grad_elements_differing=diff, grad_elements=n)
    # one whole step under the mesh against the step without one
    opt = optim.make_optimizer(c2.optimizer, optim.cosine_schedule(1e-3, 2,
                                                                   10))
    shardings = tree_shardings(M.model_specs(c2), mesh, rules)
    steps = {}
    for label, kw in (("gather", {}), ("owner", dict(
            mesh=mesh, rules=rules, param_shardings=shardings))):
        params = card if label == "gather" else init_params(
            M.model_specs(c2), seed=0, device="cuda")
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device="cuda")}
        state, m = S.make_train_step(c2, opt, grad_accum=2, **kw)(state, b)
        steps[label] = ({k: float(v) for k, v in m.items()},
                        _to(state["params"], "cpu") if label == "gather"
                        else state["params"])
        del state, params
        card = None
    (wm, wp), (gm, gp) = steps["gather"], steps["owner"]
    out["step_metrics_rel_err"] = max(
        abs(gm[k] - wm[k]) / max(abs(wm[k]), 1e-30)
        for k in ("loss", "grad_norm", "ce", "moe_aux"))
    out["step_param_max_abs_err"] = max(
        float((a - w.cuda()).abs().max())
        for (_, a), (_, w) in zip(iter_leaves(gp), iter_leaves(wp)))
    lr_t = float(optim.cosine_schedule(1e-3, 2, 10)(1))
    del steps, gp, wp
    ok = (routes_equal and drops[0] == drops[1]
          and out["logits_rel_err"] <= CARD_CPU_TOL
          and rel["gather"][0] <= CARD_CPU_STEP_TOL
          and rel["gather"][1] <= CARD_CPU_TOL
          and rel["owner-cpu"][0] <= CARD_CPU_STEP_TOL
          and rel["owner-cpu"][1] <= CARD_CPU_TOL
          and out["step_metrics_rel_err"] <= CARD_CPU_STEP_TOL
          and out["step_param_max_abs_err"] <= 2.5 * lr_t)
    log(f"{tag} 2 layers, full width, fp32 activations, {batch} x {seq} "
        f"tokens: routes equal the gather path's {routes_equal}, drops per "
        f"layer {drops[0]} / {drops[1]}; logits {out['logits_rel_err']:.4e} "
        f"of max ({out['logits_differing']} of {out['logits_elements']} "
        f"elements not bitwise); gradients in 2 microbatches vs gather: "
        f"loss {rel['gather'][0]:.3e}, leaves {rel['gather'][1]:.4e} of "
        f"max|g| ({diff} of {n} elements not bitwise); vs the owner path "
        f"on the CPU: loss {rel['owner-cpu'][0]:.3e}, leaves "
        f"{rel['owner-cpu'][1]:.4e} (tolerances {CARD_CPU_STEP_TOL} / "
        f"{CARD_CPU_TOL}); make_train_step(mesh=, rules=rules_for("
        f"train_4k), param_shardings=) vs no mesh: metrics "
        f"{out['step_metrics_rel_err']:.3e}, parameters max abs err "
        f"{out['step_param_max_abs_err']:.3e} (bound 2.5 lr_t = "
        f"{2.5 * lr_t:.3e}); {time.perf_counter() - t0:.1f} s: "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{tag} the owner path's training disagrees at 2 layers")
    return out


def phase_moe_owner(gpu: str, params, gather: dict) -> dict:
    """``[moe-owner]``: ``[serve-moe]``'s arch on its weights (``params``,
    on the card) under a ``("data", "model")`` mesh of ``OWNER_MESH``,
    whose MoE layers take the owner-computes dispatch
    (``moe.moe_apply_owner``, 4 owners of 16 of the 64 padded experts):
    the same prompts served greedy twice (bitwise reruns) beside
    ``gather``'s (``[serve-moe]``'s result) times; prefill and a decode
    step against the gather path's with the gather path's routes replayed
    (per-layer drops equal exactly, logits within ``[serve]``'s
    tolerances; the owner path's own routes against the gather path's: a
    finding past layer 0, which sees the same input); one MoE layer's
    routed sum bitwise but on the tokens of another grouping; then
    :func:`_owner_train_checks` at 2 layers after the weights are
    freed."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import ServeSession, _pad_caches
    from repro_torch.models import model as M
    from repro_torch.models.sharding import use_mesh_rules
    from repro_torch.obs import counters as ocnt
    tag = "[moe-owner]"
    dev = torch.device("cuda")
    cfg = get_config(SERVE_MOE_ARCH)
    mesh = make_mesh(OWNER_MESH, ("data", "model"))
    b, lp, n = SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS
    rng = np.random.default_rng(0)              # [serve-moe]'s prompts
    prompts = rng.integers(0, cfg.vocab, (b, lp)).astype(np.int32)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"{tag} {cfg.name} under a (data, model) mesh of {OWNER_MESH}: "
        f"{mesh.shape['model']} owners of "
        f"{cfg.n_experts_padded // mesh.shape['model']} of the "
        f"{cfg.n_experts_padded} padded experts, the shared experts' "
        f"{cfg.n_shared_experts * cfg.d_ff_expert} columns split "
        f"{mesh.shape['model']} ways; {torch.cuda.memory_allocated()} B on "
        f"the card")
    sess = ServeSession(cfg, params, mesh=mesh, max_len=lp + n + 1)
    runs = {}
    for label in ("greedy", "greedy-rerun"):
        with ocnt.use_registry() as reg:
            out = sess.generate(prompts, n)
        pre, dec = reg.get("serve.prefill_s"), reg.get("serve.decode_s")
        runs[label] = dict(out=out, prefill_ms=pre * 1e3,
                           decode_ms_per_token=dec * 1e3 / (n - 1))
        log(f"{tag} generate {label}: prefill {pre * 1e3:.3f} ms (gather "
            f"path {gather['prefill_ms']:.3f}), decode "
            f"{dec * 1e3 / (n - 1):.3f} ms/token (gather "
            f"{gather['decode_ms_per_token']:.3f})  [{gpu}]")
    require(np.array_equal(runs["greedy"]["out"],
                           runs["greedy-rerun"]["out"]),
            f"{tag} two greedy runs differ")
    peak = torch.cuda.max_memory_allocated()
    del sess
    toks = torch.from_numpy(prompts).to(dev)
    with MoeProbe() as g:
        last_g, cache = M.prefill(cfg, params, toks)
    with MoeProbe(replay=g.routes) as o, use_mesh_rules(mesh):
        last_o, cache_o = M.prefill(cfg, params, toks)
    del cache_o
    own = [int((a[1] != c[1]).any(1).sum())
           for a, c in zip(g.routes, o.routes)]
    drops = (g.per_layer_dropped(), o.per_layer_dropped())
    against = "the gather path's (its routes replayed)"
    ok_pre, pre_rel = _logits_check(last_o[:, 0], last_g[:, 0],
                                    SERVE_TOL_PREFILL, "prefill", tag,
                                    against=against)
    # one decode step from the gather prefill's cache, both paths
    cache = _pad_caches(cache, lp, lp + 1)
    nxt = torch.from_numpy(runs["greedy"]["out"][:, :1]).to(dev)
    fresh = (lambda: {k: {n_: c.clone() for n_, c in v.items()}
                      for k, v in cache.items()})
    with MoeProbe() as gd:
        step_g, _ = M.decode_step(cfg, params, fresh(), nxt, lp)
    with MoeProbe(replay=gd.routes) as od, use_mesh_rules(mesh):
        step_o, _ = M.decode_step(cfg, params, fresh(), nxt, lp)
    del cache
    ok_dec, dec_rel = _logits_check(step_o[:, 0], step_g[:, 0],
                                    SERVE_TOL_DECODE, "decode step", tag,
                                    against=against)
    ddrops = (gd.per_layer_dropped(), od.per_layer_dropped())
    ok = (ok_pre and ok_dec and drops[0] == drops[1]
          and ddrops[0] == ddrops[1] and own[0] == 0)
    psum = sum(o.sent_bytes)
    log(f"{tag} prefill drops per layer equal the gather path's: "
        f"{drops[0] == drops[1]} ({sum(drops[1])} pairs in all), decode "
        f"step's: {ddrops[0] == ddrops[1]}; the owner path's own routes "
        f"differ from the gather path's for {own} tokens per layer (layer "
        f"0 sees the same input; later layers a bf16 ulp apart: a "
        f"finding); psum handed {psum} B in prefill "
        f"({psum / len(o.sent_bytes):.0f} B a layer), "
        f"{sum(od.sent_bytes)} B in a decode step; peak device memory "
        f"{peak / 1e9:.3f} GB ({peak} B)  [{gpu}]: "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{tag} the owner path disagrees with the gather path")
    result = {
        "arch": cfg.name, "mesh": list(OWNER_MESH), "gpu": gpu,
        "prefill_ms": runs["greedy-rerun"]["prefill_ms"],
        "decode_ms_per_token": runs["greedy-rerun"]["decode_ms_per_token"],
        "cold_prefill_ms": runs["greedy"]["prefill_ms"],
        "gather_prefill_ms": gather["prefill_ms"],
        "gather_decode_ms_per_token": gather["decode_ms_per_token"],
        "peak_bytes": peak, "prefill_rel_err": pre_rel,
        "decode_rel_err": dec_rel, "prefill_dropped": drops[1],
        "own_routes_differing_per_layer": own,
        "psum_bytes_prefill": psum,
        "psum_bytes_decode_step": sum(od.sent_bytes),
    }
    result["one_layer"] = _owner_layer_check(cfg, params, mesh, tag)
    del params, last_g, last_o, step_g, step_o
    gc.collect()
    torch.cuda.empty_cache()
    result["train_2_layers"] = _owner_train_checks(cfg, mesh, tag)
    gc.collect()
    torch.cuda.empty_cache()
    return result


def train_bound_ms(cfg, tokens: int, seq: int, param_bytes: int,
                   remat: bool = True, mem_len: int = 0) -> dict:
    """Least times of one train step on this card's published peaks, by
    ``serve_bound_ms``'s method (:func:`lm_forward_work` of ``tokens`` in
    sequences of ``seq``, the memory ``mem_len`` long). Forward +
    backward: the weight products (2 FLOP per weight and token forward, 4
    backward, and under remat what the backward recomputes,
    ``lm_forward_work``'s ``mm_recompute``) at the bf16 tensor-core peak,
    and the fp32 products (attention's squares computed whole, as the
    recurrence does, the router, the SSD: forward, ``fp32_recompute``,
    and a backward of twice the forward) at the fp32 peak.
    Clip: the gradients read for their norm, then read and written once
    scaled, at the HBM rate. Optimizer (AdamW): its bytes at the HBM rate
    (parameters, gradients and both moments read once, parameters and
    moments written once, all of ``param_bytes`` each). ``model_flops``
    counts the step without the recompute: 6 FLOP per weight and token,
    and the fp32 products' forward and backward."""
    work = lm_forward_work(cfg, tokens // seq, seq, mem_len)
    mm_flops = 3 * work["mm"] + remat * work["mm_recompute"]
    fp32_flops = 3 * work["fp32"] + remat * work["fp32_recompute"]
    fwd_bwd = (mm_flops / hw_peak("peak_flops_bf16")
               + fp32_flops / hw_peak("peak_flops_fp32")) * 1e3
    clip_bytes = 3 * param_bytes              # g read twice, written once
    clip = clip_bytes / hw_peak("hbm_bw") * 1e3
    opt_bytes = 7 * param_bytes               # p, g, m, v read; p, m, v
    opt = opt_bytes / hw_peak("hbm_bw") * 1e3
    return {"mm_flops": mm_flops, "fp32_flops": fp32_flops,
            "fwd_bwd_bound_ms": fwd_bwd, "clip_bytes": clip_bytes,
            "clip_bound_ms": clip, "opt_bytes": opt_bytes,
            "opt_bound_ms": opt, "step_bound_ms": fwd_bwd + clip + opt,
            "model_flops": 3 * (work["mm"] + work["fp32"])}


def timed_optimizer(opt):
    """``(opt', events)``: ``opt`` with its ``update`` bracketed by CUDA
    events, appended to ``events``, so a train step's forward+backward and
    optimizer times read apart."""
    from repro_torch import optim
    events = []

    def update(grads, state, params):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = opt.update(grads, state, params)
        stop.record()
        events.append((start, stop))
        return out

    return optim.Optimizer(opt.init, update, opt.state_specs), events


@contextlib.contextmanager
def timed_clip():
    """``optim.clip_by_global_norm`` (the norm and the in-place scaling)
    bracketed by CUDA events for the duration of a ``with`` block; yields
    the list the ``(start, stop)`` pairs are appended to. The train step
    calls it through the module, so it meets the wrapper."""
    from repro_torch import optim
    orig, events = optim.clip_by_global_norm, []

    def clip(tree, max_norm):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(tree, max_norm)
        stop.record()
        events.append((start, stop))
        return out

    optim.clip_by_global_norm = clip
    try:
        yield events
    finally:
        optim.clip_by_global_norm = orig


def _layer_sums(tree) -> dict:
    """The fp64 sum of every leaf, on the host: one per layer for a leaf
    stacked under ``blocks``, so that a layer left without gradients or
    updates shows. The ``count`` leaf is left out."""
    from repro_torch.models.params import iter_leaves
    out = {}
    for path, t in iter_leaves(tree):
        if path[-1] == "count":
            continue
        parts = t.unbind(0) if "blocks" in path else (t,)
        out[path] = torch.stack([x.sum(dtype=torch.float64)
                                 for x in parts]).cpu()
    return out


def _unchanged_layers(before: dict, after: dict) -> list:
    """``(path, layer)`` of every sum in ``before`` equal to ``after``'s
    (layer None for an unstacked leaf)."""
    same = []
    for path, b in before.items():
        eq = (b == after[path]).tolist()
        if "blocks" not in path:
            same += [(path, None)] if eq[0] else []
        else:
            same += [(path, r) for r, e in enumerate(eq) if e]
    return same


def _grad_errors(got, want) -> float:
    """max over leaves of max|got - want| / max|want|."""
    from repro_torch.models.params import iter_leaves
    worst = 0.0
    for (_, a), (_, b) in zip(iter_leaves(got), iter_leaves(want)):
        scale = max(float(b.abs().max()), 1e-30)
        worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def train_checks_2_layers(arch: str, tag: str) -> dict:
    """At ``arch``'s full width and 2 layers with fp32 activations, on the
    card, the first batch of the phase's stream (``SyntheticLMData`` seed
    0, with its frames / img): grad_accum 2 vs 1, and remat ``nothing`` /
    ``dots`` vs off, per leaf, each within TRAIN_GRAD_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.train import with_frontend
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    from repro_torch.models.params import init_params
    b, l = TRAIN_BATCH, TRAIN_SEQ
    c2 = dataclasses.replace(get_config(arch), n_layers=2,
                             act_dtype="float32")
    data = [(0, SyntheticLMData(c2.vocab, l, b, seed=0).batch(0))]
    (_, batch), = with_frontend(c2, data, b, l, 0)
    dev = torch.device("cuda")
    params = init_params(M.model_specs(c2), seed=0, device=dev)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    errs = {}
    (l1, _), g1 = S.accumulate_grads(c2, params, tb, 1)
    (l2, _), g2 = S.accumulate_grads(c2, params, tb, 2)
    errs["grad_accum 2 vs 1"] = _grad_errors(g2, g1)
    loss_rel_err = abs(float(l2 - l1)) / abs(float(l1))
    del g2
    (_, _), g_off = S.loss_and_grads(c2, params, tb, remat=False)
    for policy in ("nothing", "dots"):
        cp = dataclasses.replace(c2, remat_policy=policy)
        (_, _), g = S.loss_and_grads(cp, params, tb, remat=True)
        errs[f"remat {policy} vs off"] = _grad_errors(g, g_off)
        del g
    del params, g1, g_off
    log(f"{tag} 2 layers, full width, fp32 activations: loss of "
        f"grad_accum 2 vs 1: relative error {loss_rel_err:.4e}")
    for what, err in errs.items():
        ok = err <= TRAIN_GRAD_TOL
        log(f"{tag} 2 layers, full width, fp32 activations: {what}: max "
            f"error / max|g| over leaves {err:.4e} (tolerance "
            f"{TRAIN_GRAD_TOL}): {'ok' if ok else 'FAIL'}")
        require(ok, f"{tag} {what} differs: {err:.4e}")
    torch.cuda.empty_cache()
    return dict(errs, loss_rel_err=loss_rel_err)


def train_resume_check(tag: str) -> dict:
    """``train`` on qwen3-32b's smoke config on the card, 20 steps
    checkpointed every 5: uninterrupted, and preempted (SIGTERM) at step
    10 then resumed; the losses within TRAIN_RESUME_TOL relative."""
    import signal
    import tempfile
    from repro_torch.launch.train import train
    quiet = lambda *_: None
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="train_resume_", dir=os.path.join(
        ROOT, "build"))
    kw = dict(smoke=True, steps=20, ckpt_every=5, device="cuda")
    _, whole = train("qwen3-32b", ckpt_dir=os.path.join(root, "a"),
                     log_fn=quiet, **kw)

    def preempt_at_10(msg):
        if msg.startswith("[runner] step 10 "):
            os.kill(os.getpid(), signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    try:
        _, first = train("qwen3-32b", ckpt_dir=os.path.join(root, "b"),
                         log_fn=preempt_at_10, **kw)
    finally:
        signal.signal(signal.SIGTERM, prev)
    _, second = train("qwen3-32b", ckpt_dir=os.path.join(root, "b"),
                      log_fn=quiet, **kw)
    shutil.rmtree(root, ignore_errors=True)
    require([h["step"] for h in first] == list(range(11))
            and [h["step"] for h in second] == list(range(11, 20)),
            f"{tag} the preempted run did not stop at 10 and resume at 11")
    want = {h["step"]: h["loss"] for h in whole}
    rel = max(abs(h["loss"] - want[h["step"]]) / abs(want[h["step"]])
              for h in first + second)
    bitwise = all(h["loss"] == want[h["step"]] for h in first + second)
    ok = rel <= TRAIN_RESUME_TOL
    log(f"{tag} qwen3-32b smoke, 20 steps, preempted at 10 and resumed: "
        f"losses within {rel:.4e} relative of the uninterrupted run's "
        f"(tolerance {TRAIN_RESUME_TOL}; bitwise {bitwise}): "
        f"{'ok' if ok else 'FAIL'}")
    require(ok, f"{tag} the resumed run disagrees")
    return {"resume_loss_rel_err": rel, "resume_bitwise": bitwise}


def open_gates(params, gate: float = XATTN_GATE) -> int:
    """Set every ``x_gate`` leaf (the ``xattn`` layers' tanh gate) to
    ``gate``, in place; returns the number of layers gated."""
    n = 0
    for leaves in params["blocks"].values():
        if "x_gate" in leaves:
            leaves["x_gate"].fill_(gate)
            n += leaves["x_gate"].shape[0]
    return n


def two_layer_config(cfg):
    """``cfg`` at 2 layers and fp32 activations, every published width
    kept: one encoder and one decoder layer for ``encdec``; a self- and a
    cross-attention layer for ``vlm`` (its pattern's ``attn+mlp`` and
    ``xattn+mlp``); 2 layers of a one-kind pattern otherwise."""
    kw = {"act_dtype": "float32", "n_layers": 2}
    if cfg.family == "encdec":
        kw.update(n_layers=1, n_enc_layers=1)
    if cfg.family == "vlm":
        kw["pattern"] = ("attn+mlp", "xattn+mlp")
    return dataclasses.replace(cfg, **kw)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _rel_err(got, want) -> float:
    """max abs err / max|want| over the elements, on the host."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _serve_card_vs_cpu(cfg, tag: str, batch: int = 2, prompt: int = 64
                       ) -> dict:
    """The serving step of ``two_layer_config(cfg)`` on the card against
    the CPU on one set of weights (the port's draw, seed 0, gates opened):
    prefill's logits, its caches (bf16 K/V and ``ck`` / ``cv``: within a
    bf16 ulp of max), and one decode step, the card's given the CPU's
    cache; logits within CARD_CPU_TOL of max|logits|. The weights are
    drawn on the card and copied to the CPU."""
    from repro_torch.launch.serve import _pad_caches, frontend_extras
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    t0 = time.perf_counter()
    c2 = two_layer_config(cfg)
    card = init_params(M.model_specs(c2), seed=0, device="cuda")
    open_gates(card)
    cpu = _to(card, "cpu")
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, c2.vocab, (batch, prompt + 1)
                                            ).astype(np.int32))
    extras = frontend_extras(c2, rng, batch, prompt, "cpu")
    runs = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        ex = _to(extras, dev)
        last, cache = M.prefill(c2, params, prompts[:, :prompt].to(dev),
                                **ex)
        runs[dev] = (last, _pad_caches(cache, prompt, prompt + 1))
    out = {"prefill_rel_err": _rel_err(runs["cuda"][0], runs["cpu"][0])}
    cache_err = max(_rel_err(runs["cuda"][1][g][k], c)
                    for g, leaves in runs["cpu"][1].items()
                    for k, c in leaves.items())
    tok = prompts[:, prompt:]
    shared = _to(runs["cpu"][1], "cuda")      # before the CPU's step
    want, _ = M.decode_step(c2, cpu, runs["cpu"][1], tok, prompt)
    got, _ = M.decode_step(c2, card, shared, tok.to("cuda"), prompt)
    out["decode_rel_err"] = _rel_err(got, want)
    out["cache_rel_err"] = cache_err
    ok = (out["prefill_rel_err"] <= CARD_CPU_TOL
          and out["decode_rel_err"] <= CARD_CPU_TOL
          and cache_err <= 2 ** -8)
    log(f"{tag} card vs CPU at 2 layers ({', '.join(c2.pattern)}"
        f"{', 1 encoder layer' if c2.family == 'encdec' else ''}), full "
        f"width, fp32 activations, {batch} x {prompt} tokens: prefill "
        f"{out['prefill_rel_err']:.4e}, decode step (the CPU's cache) "
        f"{out['decode_rel_err']:.4e} of max|logits| (tolerance "
        f"{CARD_CPU_TOL}); caches {cache_err:.4e} of max (tolerance 2^-8); "
        f"{time.perf_counter() - t0:.1f} s: {'ok' if ok else 'FAIL'}")
    require(ok, f"{tag} the card and the CPU disagree at 2 layers")
    return out


def _step_card_vs_cpu(cfg, batch, tag: str, what: str, k: int = 2) -> dict:
    """One ``make_train_step`` (the config's optimizer,
    ``cosine_schedule(1e-2, 2, 10)``, ``grad_accum=k``) of ``cfg`` on the
    card and on the CPU from one state (the port's draw, seed 0, gates
    opened); the metrics, and the parameters: relative and absolute
    errors, the elements past the CPU tests' bound (1e-5 of max|p|, or
    past 2^-5 lr_t where the gradients accumulate in bf16). The weights
    are drawn on the card and copied to the CPU (the CPU's generator takes
    ~10 s for a billion elements)."""
    from repro_torch import optim
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    from repro_torch.models.params import init_params, iter_leaves
    t0 = time.perf_counter()
    card = init_params(M.model_specs(cfg), seed=0, device="cuda")
    open_gates(card)
    cpu = _to(card, "cpu")
    runs = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        opt = optim.make_optimizer(cfg.optimizer,
                                   optim.cosine_schedule(1e-2, 2, 10))
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        runs[dev] = S.make_train_step(cfg, opt, grad_accum=k)(state, batch)
    (want, wm), (got, gm) = runs["cpu"], runs["cuda"]
    out = {key: abs(float(gm[key]) - float(wm[key]))
           / max(abs(float(wm[key])), 1e-30)
           for key in ("loss", "ce", "z_loss", "moe_aux", "grad_norm")
           if float(wm[key]) or float(gm[key])}
    lr_t = float(optim.cosine_schedule(1e-2, 2, 10)(1))
    floor = 2 ** -5 * lr_t if cfg.grad_accum_dtype == "bfloat16" else 0.0
    outliers = total = 0
    worst = 0.0
    finite = True
    for (path, a), (_, b) in zip(iter_leaves(got["params"]),
                                 iter_leaves(want["params"])):
        a = a.cpu().float()
        b = b.float()
        finite &= bool(torch.isfinite(a).all())
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        outliers += int((err > max(1e-5 * float(b.abs().max()),
                                   floor)).sum())
        total += err.numel()
    out.update(param_max_abs_err=worst, lr_t=lr_t, param_outliers=outliers,
               param_elements=total)
    ok = finite and all(v <= CARD_CPU_STEP_TOL for key, v in out.items()
                        if key in ("loss", "ce", "z_loss", "moe_aux",
                                   "grad_norm")) \
        and worst <= 2.5 * lr_t and outliers <= 1e-3 * total
    metr = ", ".join(f"{key} {v:.3e}" for key, v in out.items()
                     if key in ("loss", "ce", "z_loss", "moe_aux",
                                "grad_norm"))
    log(f"{tag} {what}: card vs CPU, one train step ({cfg.optimizer}, "
        f"grad_accum {k}, params {cfg.param_dtype}, gradients accumulated "
        f"in {cfg.grad_accum_dtype}, act {cfg.act_dtype}): relative "
        f"errors {metr} (tolerance {CARD_CPU_STEP_TOL}); parameters: max "
        f"abs err {worst:.3e} (bound 2.5 lr_t = {2.5 * lr_t:.3e}), "
        f"{outliers} of {total} past the CPU tests' bound (<= 0.1%); "
        f"{time.perf_counter() - t0:.1f} s: {'ok' if ok else 'FAIL'}")
    require(ok, f"{tag} {what}: the card's step disagrees with the CPU's")
    return out


def _train_card_vs_cpu(cfg, tag: str, batch: int = 2) -> dict:
    """The gradients of one train step of ``two_layer_config(cfg)``
    (``accumulate_grads`` over 2 microbatches) on the card against the
    CPU, on one set of weights (the port's draw on the card, seed 0, gates
    opened, copied to the CPU) and the synthetic stream (seed 0)
    with its frames / img: sequences of the SSD's whole chunk (256) for
    the SSM family, 64 tokens otherwise. The loss and its terms within
    CARD_CPU_STEP_TOL relative, every leaf's gradient within
    CARD_CPU_TOL of its max|g| (the CPU tests' tolerances; for the leaves
    of CARD_CPU_LEAF_TOL, that), compared on the card. The optimizer's update is elementwise and the same code on
    both devices (``tests/test_torch_gpu.py`` holds whole steps of the
    smoke configs); at these widths its CPU state alone would add ~1 min
    to the phase."""
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.train import with_frontend
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    from repro_torch.models.params import init_params, iter_leaves
    t0 = time.perf_counter()
    c2 = two_layer_config(cfg)
    seq = c2.ssm_chunk if "mamba" in "".join(c2.pattern) else 64
    data = [(0, SyntheticLMData(c2.vocab, seq, batch, seed=0).batch(0))]
    (_, b), = with_frontend(c2, data, batch, seq, 0)
    card = init_params(M.model_specs(c2), seed=0, device="cuda")
    open_gates(card)
    runs = {}
    for dev, params in (("cpu", _to(card, "cpu")), ("cuda", card)):
        tb = {key: torch.from_numpy(v).to(dev) for key, v in b.items()}
        (loss, metrics), grads = S.accumulate_grads(c2, params, tb, 2)
        runs[dev] = (dict(metrics, loss=loss), grads)
        del params
    (wm, want), (gm, got) = runs["cpu"], runs["cuda"]
    out = {key: abs(float(gm[key]) - float(wm[key]))
           / max(abs(float(wm[key])), 1e-30)
           for key in ("loss", "ce", "z_loss", "moe_aux")
           if float(wm[key]) or float(gm[key])}
    errs, n, past = {}, 0, []          # worst error by leaf name
    for (path, a), (_, w) in zip(iter_leaves(got), iter_leaves(want)):
        w = w.to("cuda")
        err = float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        name = path[-1] if path[-1] in CARD_CPU_LEAF_TOL else ""
        errs[name] = max(errs.get(name, 0.0), err)
        if err > CARD_CPU_LEAF_TOL.get(name, CARD_CPU_TOL):
            past.append("/".join(path))
        n += a.numel()
    metr = ", ".join(f"{key} {v:.3e}" for key, v in out.items())
    ok = all(v <= CARD_CPU_STEP_TOL for v in out.values()) and not past
    worst = errs.pop("")
    heads = "".join(f"; {name} {v:.4e} (tolerance "
                    f"{CARD_CPU_LEAF_TOL[name]})" for name, v in errs.items())
    out.update(grad_rel_err=worst,
               **{f"grad_rel_err_{name}": v for name, v in errs.items()})
    log(f"{tag} card vs CPU at 2 layers ({', '.join(c2.pattern)}"
        f"{', 1 encoder layer' if c2.n_enc_layers else ''}), full width, "
        f"fp32 activations, {batch} x {seq} tokens in 2 microbatches: "
        f"relative errors {metr} (tolerance {CARD_CPU_STEP_TOL}); "
        f"gradients of {n} parameters: max error / max|g| over leaves "
        f"{worst:.4e} (tolerance {CARD_CPU_TOL}){heads}; "
        f"{time.perf_counter() - t0:.1f} s: {'ok' if ok else 'FAIL'}")
    require(ok, f"{tag} the card's gradients disagree with the CPU's in "
            f"{past[:3]}")
    return out


def _hybrid_smoke_card_vs_cpu(tag: str) -> dict:
    """The hybrid family's check on the card: jamba-1.5-large-398b's smoke
    config (its 8-layer mamba / attention / MoE pattern, twice) with the
    published config's bf16 parameters, Adafactor and bf16 gradient
    accumulator, at fp32 activations (so that the card's and the CPU's
    routes agree), one train step against the CPU's."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import SyntheticLMData
    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(smoke_config(HYBRID_ARCH),
                              param_dtype=full.param_dtype,
                              act_dtype="float32")
    require(cfg.optimizer == "adafactor"
            and cfg.grad_accum_dtype == "bfloat16"
            and cfg.param_dtype == "bfloat16",
            f"{tag} jamba's config no longer sets bf16 / Adafactor")
    batch = SyntheticLMData(cfg.vocab, 32, 4, seed=0).batch(0)
    return _step_card_vs_cpu(cfg, batch, tag,
                             f"{HYBRID_ARCH} smoke ({cfg.n_layers} layers)")


def phase_train(gpu: str, arch: str = TRAIN_ARCH, tag: str = "[train]",
                n_layers: int | None = None, params=None) -> dict:
    """The LM training path of ``arch`` at its published widths:
    ``make_train_step`` for three steps, with its checks and times. Full
    depth unless ``n_layers`` cuts it (the cut and the bytes that forced
    it are logged); ``params`` (the serving phase's, on the card) instead
    of a fresh draw. For an MoE arch also the pairs its routers drop. The
    checks at 2 layers are the caller's (``main``,
    :func:`phase_other_families`)."""
    import gc
    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.train import with_frontend
    from repro_torch.models import model as M
    from repro_torch.models import steps as S
    from repro_torch.models.params import init_params, iter_leaves, \
        spec_bytes
    dev = torch.device("cuda")
    full = get_config(arch)
    cfg = full if n_layers is None else dataclasses.replace(
        full, n_layers=n_layers)
    b, l, k, n = TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full_bytes = spec_bytes(M.model_specs(full))
    cut_bytes = spec_bytes(M.model_specs(cfg))
    if n_layers is not None:
        log(f"{tag} depth cut to {n_layers} of {full.n_layers} layers: "
            f"{cut_bytes} B of fp32 parameters, {4 * cut_bytes} B with "
            f"gradients and AdamW's two moments; all {full.n_layers} "
            f"layers: {full_bytes} B, {4 * full_bytes} B with them, "
            f"beyond the card's "
            f"{torch.cuda.get_device_properties(0).total_memory} B")
    else:
        log(f"{tag} full depth: {cut_bytes} B of fp32 parameters, "
            f"{4 * cut_bytes} B with gradients and AdamW's two moments")
    t0 = time.perf_counter()
    if params is None:
        params = init_params(M.model_specs(cfg), seed=0, device=dev)
    gates = open_gates(params)
    opt, opt_events = timed_optimizer(optim.make_optimizer(
        cfg.optimizer, optim.cosine_schedule(1e-3, 2, 10)))
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = spec_bytes(M.model_specs(cfg))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in (x for _, x in iter_leaves(state)))
    layers = ", ".join(f"{kd} x {cfg.n_repeats}" for kd in cfg.pattern)
    if cfg.family == "encdec":
        layers += (f"; encoder {cfg.n_enc_layers} x "
                   f"{', '.join(cfg.enc_pattern)} over {l} frames of width "
                   f"{cfg.d_frontend}")
    if cfg.family == "vlm":
        layers += (f"; {cfg.n_img_tokens} image tokens of width "
                   f"{cfg.d_frontend}, {gates} xattn layers' gates at "
                   f"{XATTN_GATE}")
    if cfg.n_experts:
        layers += (f"; {cfg.n_experts} experts (padded "
                   f"{cfg.n_experts_padded}) top-{cfg.top_k}, "
                   f"{cfg.n_shared_experts} shared, capacity factor "
                   f"{cfg.capacity_factor}")
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers ({layers}), d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.vocab_padded}), act "
        f"{cfg.act_dtype}, params {cfg.param_dtype}, {cfg.optimizer} (fp32 "
        f"moments), remat {cfg.remat_policy}; {param_bytes} B of "
        f"parameters, {state_bytes} B of train state, drawn on the card in "
        f"{init_s:.2f} s")
    before = {"parameter": _layer_sums(params),
              "moment": _layer_sums(state["opt"])}
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=l, global_batch=b,
                           seed=0)

    def batch_of(i):       # with the frontend's frames / img, if taken
        return next(with_frontend(cfg, [(i, data.batch(i))], b, l, 0))[1]

    def moe_dropped():     # untimed: step 0's first microbatch, no grad
        mb = torch.from_numpy(batch_of(0)["tokens"][:b // k]).to(dev)
        with torch.no_grad(), MoeProbe() as probe:
            M.forward(cfg, params, mb, remat=False)
        return [int(x) for x in probe.dropped]

    dropped_before = moe_dropped() if cfg.n_experts else None

    step_fn = S.make_train_step(cfg, opt, grad_accum=k)
    steps = []
    for i in range(n):
        batch = batch_of(i)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        with timed_clip() as clip_events:
            start.record()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        (clip_start, clip_stop), = clip_events
        opt_start, opt_stop = opt_events[-1]
        row = {"step": i, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "ce": float(metrics["ce"]), "z_loss": float(metrics["z_loss"]),
               "moe_aux": float(metrics["moe_aux"]), "step_ms": ms,
               "fwd_bwd_ms": start.elapsed_time(clip_start),
               "clip_ms": clip_start.elapsed_time(clip_stop),
               "opt_ms": opt_start.elapsed_time(opt_stop),
               "tokens_per_s": b * l / (ms / 1e3)}
        steps.append(row)
        aux = f", moe_aux {row['moe_aux']:.6f}" if cfg.n_experts else ""
        log(f"{tag} step {i}: loss {row['loss']:.6f} (ce {row['ce']:.6f}"
            f"{aux}), grad_norm {row['grad_norm']:.6f}; {ms:.3f} ms (host "
            f"clock, "
            f"device fenced): forward+backward {row['fwd_bwd_ms']:.3f} ms, "
            f"clip (global norm and scaling) {row['clip_ms']:.3f} ms, "
            f"optimizer {row['opt_ms']:.3f} ms (CUDA events); "
            f"{row['tokens_per_s']:.1f} tokens/s  [{gpu}]")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    require(all(np.isfinite([r["loss"], r["grad_norm"], r["moe_aux"]]).all()
                for r in steps), f"{tag} a non-finite loss or grad_norm")
    require(int(state["step"]) == int(state["opt"]["count"]) == n,
            f"{tag} step {int(state['step'])}, count "
            f"{int(state['opt']['count'])}, not {n}")
    for what, tree in (("parameter", params), ("moment", state["opt"])):
        bad = [p for p, t in iter_leaves(tree)
               if not bool(torch.isfinite(t).all())]
        require(not bad, f"{tag} non-finite {what}s in {bad[:3]}")
    after = {"parameter": _layer_sums(params),
             "moment": _layer_sums(state["opt"])}
    for what in before:
        same = _unchanged_layers(before[what], after[what])
        log(f"{tag} {what}s: {sum(len(v) for v in after[what].values())} "
            f"sums (one per layer of each stacked leaf) over "
            f"{len(after[what])} leaves, {len(same)} unchanged by {n} steps")
        require(not same, f"{tag} {what} (leaf, layer) unchanged by {n} "
                f"steps: {same[:3]}")
    # Where a step's time goes, op by op: bench_torch/lm_profile.py (a
    # profiled step's trace takes up to ~35 s to read).
    steady = steps[1:]
    step_ms = float(np.mean([r["step_ms"] for r in steady]))
    mem_len = {"encdec": l, "vlm": cfg.n_img_tokens}.get(cfg.family, 0)
    bound = train_bound_ms(cfg, b * l, l, param_bytes, mem_len=mem_len)
    mfu = (bound["model_flops"] / (step_ms / 1e3)
           / hw_peak("peak_flops_bf16"))
    log(f"{tag} steady step {step_ms:.3f} ms (mean of steps 1..{n - 1}),"
        f" {b * l / (step_ms / 1e3):.1f} tokens/s; bound "
        f"{bound['step_bound_ms']:.3f} ms (forward+backward "
        f"{bound['fwd_bwd_bound_ms']:.3f}: {bound['mm_flops']:.4e} FLOP of "
        f"weight products at the bf16 peak + {bound['fp32_flops']:.4e} of "
        f"fp32 products; clip {bound['clip_bound_ms']:.3f}: "
        f"{bound['clip_bytes']} B at the HBM rate; optimizer "
        f"{bound['opt_bound_ms']:.3f}: {bound['opt_bytes']} B at the HBM "
        f"rate); model FLOPs "
        f"{bound['model_flops']:.4e} a step, {mfu:.4f} of the bf16 peak "
        f"(finding); peak device memory {peak / 1e9:.3f} GB ({peak} B) of "
        f"{total / 1e9:.3f} GB  [{gpu}]")
    moe = {}
    if cfg.n_experts:
        # The pairs the routers drop at the published capacity factor, on
        # the first microbatch of step 0: before training and after it.
        from repro_torch.models.moe import capacity
        cap = capacity(b // k * l, cfg.top_k, cfg.capacity_factor,
                       cfg.n_experts_padded)
        pairs = b // k * l * cfg.top_k
        moe = {"moe_dropped_per_layer_before": dropped_before,
               "moe_dropped_per_layer": moe_dropped(),
               "moe_pairs_per_layer": pairs, "moe_capacity": cap,
               "moe_aux_per_step": [r["moe_aux"] for r in steps]}
        log(f"{tag} moe_dropped per layer (first microbatch of step 0): "
            f"{dropped_before} before training, "
            f"{moe['moe_dropped_per_layer']} after {n} steps, of "
            f"{pairs} pairs (capacity {cap} a padded expert, factor "
            f"{cfg.capacity_factor}); moe_aux per step "
            f"{[round(x, 6) for x in moe['moe_aux_per_step']]}")
    result = {
        "arch": cfg.name, "layers": cfg.n_layers,
        "published_layers": full.n_layers, "d_model": cfg.d_model,
        "param_bytes": param_bytes, "published_param_bytes": full_bytes,
        "state_bytes": state_bytes, "batch": b, "seq_len": l,
        "grad_accum": k, "steps": steps, "step_ms": step_ms,
        "tokens_per_s": b * l / (step_ms / 1e3), "peak_bytes": peak,
        "total_memory": total, "mfu_bf16": mfu, "gpu": gpu, **bound,
        **moe,
    }
    del state, params, metrics, step_fn, opt
    gc.collect()
    torch.cuda.empty_cache()
    return result


def phase_other_families(gpu: str) -> dict:
    """The families beyond the dense one (ROADMAP A15 (3) (a) + (b)), each
    phase's result under its key, each phase with its own checks at 2
    layers and fp32 on the card against the CPU: [train-ssm] (and the
    2-layer ``grad_accum`` / remat checks), [train-moe] (and the hybrid
    family's smoke step), [serve-encdec] and [train-encdec] on its
    weights, [serve-vlm], [train-vlm]. Each logs its own seconds."""
    from repro_torch.configs import get_config
    out = {}

    def took(tag, t0):
        log(f"{tag} phase took {time.perf_counter() - t0:.1f} s  [{gpu}]")

    t0, tag = time.perf_counter(), "[train-ssm]"
    r = out["train_ssm"] = phase_train(gpu, TRAIN_SSM_ARCH, tag)
    r["card_vs_cpu_2_layers"] = _train_card_vs_cpu(
        get_config(TRAIN_SSM_ARCH), tag)
    r["checks_2_layers"] = train_checks_2_layers(TRAIN_SSM_ARCH, tag)
    took(tag, t0)

    t0, tag = time.perf_counter(), "[train-moe]"
    r = out["train_moe"] = phase_train(gpu, TRAIN_MOE_ARCH, tag,
                                       n_layers=TRAIN_MOE_LAYERS)
    r["card_vs_cpu_2_layers"] = _train_card_vs_cpu(
        get_config(TRAIN_MOE_ARCH), tag)
    r["hybrid_smoke_card_vs_cpu"] = _hybrid_smoke_card_vs_cpu(tag)
    took(tag, t0)

    t0, tag = time.perf_counter(), "[serve-encdec]"
    r = out["serve_encdec"] = phase_serve(gpu, ENCDEC_ARCH, tag,
                                          keep_params=True)
    r["card_vs_cpu_2_layers"] = _serve_card_vs_cpu(get_config(ENCDEC_ARCH),
                                                   tag)
    took(tag, t0)

    t0, tag = time.perf_counter(), "[train-encdec]"
    r = out["train_encdec"] = phase_train(
        gpu, ENCDEC_ARCH, tag, params=out["serve_encdec"].pop("params"))
    r["card_vs_cpu_2_layers"] = _train_card_vs_cpu(get_config(ENCDEC_ARCH),
                                                   tag)
    took(tag, t0)

    t0, tag = time.perf_counter(), "[serve-vlm]"
    r = out["serve_vlm"] = phase_serve(gpu, VLM_ARCH, tag)
    r["card_vs_cpu_2_layers"] = _serve_card_vs_cpu(get_config(VLM_ARCH), tag)
    took(tag, t0)

    t0, tag = time.perf_counter(), "[train-vlm]"
    r = out["train_vlm"] = phase_train(gpu, VLM_ARCH, tag,
                                       n_layers=TRAIN_VLM_LAYERS)
    r["card_vs_cpu_2_layers"] = _train_card_vs_cpu(get_config(VLM_ARCH), tag)
    took(tag, t0)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda")
    gpu = gpu_info()
    log(f"[gpu] {gpu}; torch {torch.__version__} CUDA {torch.version.cuda}")
    t_all = time.perf_counter()
    laps = [t_all]

    def lap(what):         # each phase's seconds, for the time limit
        now = time.perf_counter()
        log(f"[time] {what}: {now - laps[-1]:.1f} s ({now - t_all:.1f} s "
            f"in all)")
        laps.append(now)

    phase_build()
    lap("[build]")
    phase_lowering()
    lap("[lowering]")
    phase_l2_rate(dev, gpu)
    phase_kernels(dev)
    phase_stream_kernels(dev)
    phase_fused_kernels(dev)
    lap("[gpu] [kernels] [stream-kernels] [fused-kernels]")
    ft, b1_fits, main_rows = phase_main(dev, gpu)
    lap("[main] (the nell-2 stand-in's generation included)")
    main_rows.update(phase_fused_main(ft, b1_fits, dev, gpu))
    lap("[fused-main] [auto]")
    main_rows.update(phase_stream_main(ft, dev, gpu))
    lap("[stream-main]")
    main_rows.update(phase_bf16_main(ft, dev, gpu))
    lap("[bf16-main]")
    # The [dist-main] path's launches, read apart from the D=1 paths'.
    dist_launches = {"fused_mttkrp_nmode_gather":
                     phase_dist_main(ft, dev, gpu)}
    lap("[dist-main]")
    phase_four_mode(dev)
    phase_recovery()
    phase_bf16_kernels(dev)
    t_fit, fits_fit = phase_bf16_fit(gpu)
    phase_dist_fit(t_fit, fits_fit, gpu)
    del t_fit
    lap("[four-mode] [recovery] [bf16-kernels] [bf16-fit] [dist-fit]")
    # The [resilience] path's launches (the stepped driver), read apart.
    res_launches = phase_resilience(ft, b1_fits, dev, gpu)
    lap("[resilience]")
    # The [obs] paths' launches: the counted run and [auto-stream]'s auto.
    obs = phase_obs(ft, dev, gpu)
    lap("[obs] [auto-stream]")
    # The [tune] paths' launches: the calibration and the tuned run.
    tune_launches, tune_main_launches = phase_tune(
        ft, b1_fits, obs["auto_stream_keys"], dev, gpu)
    del ft
    _RUNTIMES.clear()
    lap("[tune]")
    cli_launches = phase_cli()
    examples_launches = phase_examples(gpu)
    lap("[cli] [examples]")
    dry = phase_dryrun(gpu)
    lap("[dryrun]")
    serve = phase_serve(gpu, keep_params=True)
    serve_int8 = phase_serve_int8(gpu, serve.pop("params"))
    lap("[serve] [serve-int8]")
    serve_moe = phase_serve(gpu, SERVE_MOE_ARCH, "[serve-moe]",
                            keep_params=True)
    moe_owner = phase_moe_owner(gpu, serve_moe.pop("params"), serve_moe)
    lap("[serve-moe] [moe-owner]")
    serve_ssm = phase_serve(gpu, SERVE_SSM_ARCH, "[serve-ssm]")
    lap("[serve-ssm]")
    train = phase_train(gpu)
    train["checks_2_layers"] = train_checks_2_layers(TRAIN_ARCH, "[train]")
    train.update(train_resume_check("[train]"))
    lap("[train]")
    dry["measured"] = dryrun_vs_measured(dry, serve, train, gpu)
    lm = phase_other_families(gpu)
    kernels = []
    for name, (launches, rows) in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches,
            "dist_main_launches": dist_launches.get(name, 0),
            "resilience_launches": res_launches.get(name, 0),
            "obs_launches": obs["obs_launches"][name],
            "auto_stream_launches": obs["auto_stream_launches"][name],
            "tune_launches": tune_launches[name],
            "tune_main_launches": tune_main_launches[name],
            "cli_launches": cli_launches[name],
            "examples_launches": examples_launches[name],
            "max_abs_err": max(r["err"] for r in rows),
            "ms": float(np.mean([r["ms"] for r in rows])),
            "plain_ms": float(np.mean([r["plain_ms"] for r in rows])),
            "bound_ms": float(np.mean([r["bound_ms"] for r in rows])),
            "bound_by": rows[0]["bound_by"],
            "l2_bound_ms": float(np.mean([r["l2_bytes"] for r in rows]))
            / L2_BYTES_PER_S * 1e3,
            "library_ms": (float(np.mean([r["library_ms"] for r in rows]))
                           if "library_ms" in rows[0] else None),
            # B1-bf16: the design that ran and the first bf16 kernel (a
            # column a lane) on the same inputs, both measured in this run.
            **({"design": rows[0]["design"],
                "column_ms": float(np.mean([r["column_ms"] for r in rows]))}
               if "design" in rows[0] else {}),
        })
    # The six fp32 kernels and the five bf16 variants, each launched.
    require(len(kernels) == len(SOURCE) == 11
            and all(k["launches"] > 0 for k in kernels), "a kernel never ran")
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s; "
        "kernel ms/plain_ms/bound_ms are means per launch over the modes "
        "of the main path; launches are the D=1 main paths', "
        "dist_main_launches the [dist-main] D=4 run's, "
        "resilience_launches the [resilience] fault-free stepped run's, "
        "obs_launches the [obs] counted baseline run's, "
        "auto_stream_launches [auto-stream]'s auto run's, "
        "tune_launches the [tune] calibration's, tune_main_launches the "
        "[tune] tuned CP-ALS run's, cli_launches the [cli] smokes', "
        "examples_launches the [examples] runs'; "
        "l2_bound_ms is the L2 bytes (rows gathered by "
        "B1/B2, tiles copied by B6, rows read by B3/B4/B5; at 2 bytes per "
        "factor element for the [bf16] variants) over the "
        f"measured L2 read rate {L2_BYTES_PER_S / 1e12:.3f} TB/s; "
        "library_ms is index_add_ for segment_accumulate and null for the "
        "others: no single PyTorch call computes spMTTKRP")
    print(json.dumps({"serve": serve}))
    print(json.dumps({"serve_int8": serve_int8}))
    print(json.dumps({"serve_moe": serve_moe}))
    print(json.dumps({"moe_owner": moe_owner}))
    print(json.dumps({"serve_ssm": serve_ssm}))
    print(json.dumps({"train": train}))
    print(json.dumps({"dryrun": dry}))
    for key, result in lm.items():
        print(json.dumps({key: result}))
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

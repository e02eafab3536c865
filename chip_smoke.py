#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (img2latex_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels with nvcc, holds each against its plain
PyTorch version on the card, then drives the two greedy paths and the grid
beam, selective-beam and sampling paths through ``Predictor.predict_batch``
and checks that every kernel of each ran and that the output is right:

* vector memory at bench.py's width: 64x800 canvas, filters [32, 64, 128],
  E = H = 512, 2 LSTM layers, vocab 503, 141 steps, bf16;
* grid memory at the grid flagship's width (artifacts/mathtext_hard_grid_v2,
  scripts/bench_grid_decode.py): the same canvas and filters, a grid of
  S = 100 slots of H'·C = 1024 features, E = 256, additive attention with
  A = H = 384, 2 LSTM layers, vocab 503, 141 steps, bf16.

Weights are random, from a seed.  Also holds early exit (tokens equal to
the full loop) and the four per-row score signals of both greedy decodes
against their plain versions, the beam step (K = 5, and K = 20, a tile a
sample), the attention over memories shared by K beams and the
whole beam decode of both memory kinds (K = 5, with early exit and a length
penalty) against theirs; and sampling: the vocab-sample step alone under
four filter settings, its draws against ``next_token_probs`` (chi-square),
the whole sampling decode of both kinds step by step against the plain
version (and three deliberately broken samplers that must fail that rule),
with early exit, and grid ``predict_batch`` at temperature 0.8, top-k 10,
top-p 0.9.  Then training at ``bench_train.py``'s shapes (phases 13-17).
Then the channel-first encoder chain (``hardware.pallas_chain``, phases
18-20): the conv-pool kernel alone in both layouts (``convblock_cf``,
``fused_conv_relu_pool``) and conv1_pool's NHWC output against their plain
versions; ``predict_batch`` on the chain for both memory kinds (grid also
beam-5 and sampling) against the plain path, with the chain off beside it,
and two broken ``convblock_cf`` that must fail; ``convblock_cf``'s backward,
a train step on the chain against the plain path, and phase 16's checkpoint
loaded with ``use_pallas_chain=True``.  Then ``evaluate_checkpoint``
(phase 21) from a canvas cache written with numpy alone (no image files,
no Pillow): the grid model and phase 16's vector checkpoint over 2048
canvases at batch 512, streaming and device-cached, grid beam-5 over 512,
each held against ``predict_batch`` on the same canvases and against the
metrics recomputed on the host, the two loops against each other, and the
pipelined ``predict_batch`` timed beside the serial loop it replaced; and
each ``bench_*_torch.py`` once at a reduced batch (phase 22).  Then the
ResNet-LSTM at ``bench_resnet.py``'s width (phases 23-26: 64x800x3,
ResNet-50, E = H = 512, bf16): ``predict_batch`` greedy for vector memory
(1024 canvases) and grid memory (S = 25 slots of 2 * 2048 features) against
the plain decode, the encoder's and the decode's times; a ResNet-50 train
step at B = 128 against the plain path in float32 and bf16, and its
BatchNorm running buffers against flax's update of their inputs' float64
statistics; and a frozen ResNet-18 ``Trainer.train()`` from a
seeded pretrained npz with the device cache stored grayscale, a registry and
a profiler trace.  Each ResNet path's launches of the decode and training
kernels are counted from 0 over its own run, into keys of their own in the
kernels line (``launches_resnet_vector``, ``_grid``, ``_train_step``,
``_trainer``).

The bf16 ``lstm_layer_step``, ``vocab_argmax_step``, attention ``h @ W_h``,
conv-pool, ``vocab_sample_step``, ``beam_step`` and conv1-pool kernels run on
the tensor cores (``mma.sync``): the build's SASS must hold HMMA instructions
in each of their instantiations (where the toolkit has ``cuobjdump``); the
conv1-pool tensor-core route is held in both layouts at the main and odd
shapes, beside a broken variant that must fail its rule, timed beside the
CUDA-core kernel it replaces (``core_route``), and every bf16 path must
launch it (``conv1_pool.tc_launches``); the bf16 vocab,
sampling and beam kernels must spread the batch over clusters of at least 64
blocks, as their planners name them, and the attention take a block a memory
row (``check_launch_shapes``); the sampling and beam steps are held and timed
on both bf16 routes (the tensor-core cluster kernels and the CUDA-core block
kernels, ``block_route``) beside the cuBLAS product alone, and the beam and
sampling decodes and ``predict_batch`` paths must run the cluster kernels;
phase 3 holds ``lstm_layer_step`` in bf16 against
its plain version at both widths, both layers, 512 and 2560 rows and a ragged
shape.  Every kernel under ~1 ms is timed by CUDA-graph replay (device time;
``graph_ms``) beside the eager time, which the host's enqueueing bounds, and
the decodes' device busy share is read under ``torch.profiler``.

Prints its findings on earlier lines, then a ``{"kernels": [...]}`` line,
the card's name and power limit from nvidia-smi, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
there is no CUDA device or any phase fails.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# Peak rates of one H100 SXM (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Full-width configuration of the slice (bench.py's shapes).
IMG_H, IMG_W = 64, 800
FILTERS = [32, 64, 128]
EMBED = HIDDEN = 512
LAYERS = 2
VOCAB = 503
MAX_LEN = 141
BATCH = 512  # Predictor batch and the kernels' main-path row count
N_IMAGES = 1024
# Grid flagship ("cnn_lstm embed256 hidden384 layers2", memory "grid").
GRID_EMBED, GRID_HIDDEN = 256, 384  # attention width A = H
GRID_S = IMG_W // 8                 # one memory slot per feature column

# Tolerances (see PERF.md):
CONV_F32_ATOL = 1e-4   # float32 sums of 9 products in another order
CONV_BF16_RTOL = 2e-2  # bf16 kernel vs float32 plain: bf16 inputs, weights and output (2^-8 each)
BF16_ULP = 2.0**-7     # bf16 kernel vs bf16 plain: one rounding step of |ref|, plus CONV_F32_ATOL
# Decode: every row that differs must first differ at a step whose top-2 logit
# margin (in the plain version) is at most MARGIN_TOL, i.e. at a near-tie, and
# the rows must agree on at least MIN_ROW_MATCH.  In bf16 a carry that rounds
# the other way moves later logits by ~1e-4 to 4e-4 (largest seen on the H100:
# 4.1e-4), which over 141 steps crosses a near-tie in several percent of the
# rows (seen: 92% of rows equal); the bf16 limits are 5x that margin and a
# floor below that share.  The median top-2 margin is printed beside them.
MIN_ROW_MATCH = {"float32": 0.99, "bfloat16": 0.85}
MARGIN_TOL = {"float32": 1e-3, "bfloat16": 2e-3}
# Every bias of the smoke model is drawn from normal(0, BIAS_STD), so that each
# kernel's bias add is exercised (init_weights leaves conv, head and vocab
# biases at 0).  Then END's vocab bias is raised to the largest, so that END
# wins in part of the rows and the END -> PAD rule runs at full width, and the
# vocab biases are shifted by -1 (argmax-invariant), so that every real logit
# is negative and a padded vocab column let through above -1e30 would win.
BIAS_STD = 0.05
END_ID = 2
STEP_ATOL = {"float32": 1e-4, "bfloat16": 1.6e-2}  # decode_step h/c: 1e-4, or 2 bf16 ulps of |x|<1
# attend_step: float32 sums in another order; bf16 kernel vs bf16 plain, both
# rounding where grid_decode.py::_attend rounds: 2 bf16 steps of |ctx| (a
# weight or a product that rounds the other way, then ctx's own rounding).
ATTEND_F32_ATOL = 1e-5
ATTEND_BF16_RTOL = 2 * BF16_ULP
# Grid decode: the same token rule as the vector decode.  float32 as there;
# bf16 from the readings on the H100 (3 of 512 rows differ, each first at a
# top-2 margin <= 1.7e-4; end to end 0 of 512): margin <= 1e-3 (6x the
# largest seen) and >= 95% of rows equal (the kernels and the data are
# deterministic, so a run sees the same rows).
GRID_MIN_ROW_MATCH = {"float32": 0.99, "bfloat16": 0.95}
GRID_MARGIN_TOL = {"float32": 1e-3, "bfloat16": 1e-3}
# Per-row scores (sums of up to 141 per-step signals), kernel vs plain, on
# the rows whose tokens are equal.  float32: the per-step signals differ in
# their last bits (sums in another order), and both sides add them to a
# float32 sum of up to ~900 (141 log probabilities of ~-6) whose rounding
# step is ~6e-5, so each of the 141 additions may round the other way: the
# limit is 1e-3 plus 141 float32 rounding steps of |score|.  bf16: carries
# that round the other way move later logits; the largest difference seen on
# the H100 is 0.046 (a margin sum), so the limit is 0.1.
SCORE_ATOL = {"float32": 1e-3, "bfloat16": 0.1}
SCORE_RTOL = MAX_LEN * 2.0**-23
SIGNALS = ("logp", "margin", "entropy", "margin_logp:0.5")
# Beam search, K = 5 beams a sample (PARITY.md's beam-5; length penalty 2.0 is
# the grid flagship's best, artifacts/mathtext_hard_grid_v2/post_flagship.json).
BEAM = 5
LENGTH_PENALTY = 2.0
SELECTIVE_FRAC = 0.2
# beam_step alone: the kernel and its plain version compute the same float32
# logits from the same inputs, with sums in another order.  Samples whose
# plain top K + 1 totals hold two within BEAM_STEP_GAP of each other may pick
# in another order and are left out of the exact comparison (at most 1% of
# them); on the others tokens, parents, finished and gathered carries must be
# equal and scores within BEAM_STEP_ATOL.
BEAM_STEP_GAP = 1e-5
BEAM_STEP_ATOL = 1e-4
# Whole beam decode, at length penalty 2.0, held against the plain version
# step by step through the two decodes' traces
# (ops/beam_decode.py::beam_divergence).  Up to the first step at which a
# sample's K tokens or parents differ, both decodes hold the same beams in the
# same slots.  Before that step, what each step adds to a beam's score (its
# token's log-probability) must agree within BEAM_LOGP_TOL (plus the rounding
# of the float32 scores it is read from), and the scores within the score
# tolerance.  At that step two of the sample's K + 1 best plain totals must be
# within 2 BEAM_LOGP_TOL plus twice the largest difference of its beam scores
# before it (a candidate's total moves by its beam's score difference and by
# its log-probability's).  A sample whose histories agree throughout may pick
# another best beam only if the plain choice's gap (the least change of two
# beams' scores that changes it) is within that score difference.  At least
# BEAM_MIN_ROW_MATCH of the best beams' tokens must be equal, and the
# reference must end some rows and use at least BEAM_MIN_DISTINCT tokens (a
# decode whose best beams all end at once checks nothing of the search).  The
# search does not depend on the length penalty (it acts on the final choice
# only), so penalty 0 is not run.
# Readings on the H100 (float32 / bf16): log-probabilities added agree within
# 6.1e-5 / 1.0e-3 (2.1e-3 end to end, where the scaled grid head makes
# contexts of ~4, whose bf16 rounding step is 4x that of values near 1);
# scores before a parting within 2.6e-3 / 0.032, so in bf16 63% of the grid
# samples part at some step (the totals' median K-th/(K+1)-th gap is 0.010),
# each where the rule allows; best tokens equal in 98.8-99.4% / 69.5-84.6% of
# the rows.  The limits: float32 half the greedy rule's margin; bf16 2x the
# largest seen (BEAM_E2E_LOGP_TOL end to end); rows 0.98 / 0.6.  Phase 8 also
# checks that a bf16 decode through a beam step broken from step 10 on (the
# gathered h of two beams swapped, parents recorded rotated, or 5e-3 added to
# a score at every step) fails this rule.
BEAM_LOGP_TOL = {"float32": 5e-5, "bfloat16": 2e-3}
BEAM_E2E_LOGP_TOL = 4e-3
BEAM_MIN_ROW_MATCH = {"float32": 0.98, "bfloat16": 0.6}
BEAM_MIN_DISTINCT = 10
# The grid path's beam end to end scales the grid head of the random model by
# this, so that its memories spread across canvases as phase 8's random
# memories do (see phase_grid_beam_end_to_end).
HEAD_GAIN = 32.0
WIDE_BEAM = 20  # beam_step with one sample a 32-row tile (a CUDA-core block's 16 rows exceeded)
# Sampling.  The four settings of vocab_sample_step alone; the whole decodes
# and predict_batch run SAMPLE (temperature 0.8, top-k 10, top-p 0.9), and
# the whole decodes also top-p 0.9 alone, in float32.
SAMPLE_SETTINGS = (dict(top_k=5), dict(top_p=0.9), dict(top_k=10, top_p=0.9, temperature=0.8), dict(top_k=1))
SAMPLE = dict(top_k=10, top_p=0.9, temperature=0.8)
SAMPLE_SEED = 1234
# The sampling rule: with the same random stream, the kernel and the plain
# version draw the same token unless their logits differ by more than the
# plain version's distance to a knife edge at that step
# (ops/decode_step.py::sample_tokens): its two best perturbed scores, the
# k-th and (k+1)-th logits, or the logits of the nucleus's last token and of
# the first one left out, within SAMPLE_GAP_TOL; or the mass before either
# of those two within SAMPLE_MASS_TOL of top_p.  Every row that differs
# must first differ at such a step.
# Readings on the H100 (float32 / bf16, B = 512, T = 141): the step alone
# draws the plain version's token on every row in every setting, both types
# (the same operands: the logits differ by sums in another order, ~1e-6);
# whole decodes in float32, the decode setting and top-p 0.9 alone, 512/512
# rows equal; in bf16, where carries that round the other way move later
# logits, 98.0% (vector) and 85.4% (grid) of the rows equal, each first
# differing at a logit gap <= 8.6e-4 (none needed the mass limit; the masses
# of those steps were >= 1.8e-3 from p).  The limits: float32 a rounding
# step of logits and masses of ~1 with room; bf16 2x the largest gap seen,
# the mass limit 5x the logit one scaled by a kept token's mass (~0.1),
# and row floors 0.99 / 0.75.
SAMPLE_GAP_TOL = {"float32": 1e-4, "bfloat16": 2e-3}
SAMPLE_MASS_TOL = {"float32": 1e-5, "bfloat16": 5e-4}
SAMPLE_MIN_ROW_MATCH = {"float32": 0.99, "bfloat16": 0.75}
N_DRAWS_SEEDS = 16  # chi-square: one row's logits over BATCH rows and this many seeds


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured into a
    CUDA graph, replayed ``reps`` times between CUDA events.  Unlike
    :func:`time_ms` it leaves out the host's time to enqueue each launch,
    which exceeds the device time of a launch of a few tens of microseconds.
    ``fn`` must launch on the current stream (PyTorch's own calls allocate
    from the graph's pool)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def both_ms(fn, iters: int = 20):
    """(device time by CUDA-graph replay, eager time) of one call of ``fn``
    in ms: the kernels line's ``ms`` / ``plain_ms`` / ``library_ms`` of a row
    under ~1 ms are the first (``ms_method: cuda_graph``), ``ms_eager`` the
    kernel's second."""
    return graph_ms(fn), time_ms(fn, iters=iters, warmup=2)


# Issue rate of the H100's CUDA cores, lane-instructions a second (132 SMs x 4
# schedulers x 32 lanes at the 1.755 GHz boost clock), and the instructions of
# one attention energy, round(round(tanh(round(x + hw))) v) added to a score:
# tanhf (two MUFU, ~15 other instructions), the three roundings and their
# unpacking, the add, the product and the sum (estimated from the bf16
# kernel's SASS).  Their product is the attention's compute floor beside its byte
# bound; it is an estimate, not a peak rate, so the kernels line keeps the
# byte bound.
LANE_INSTR_PER_S = 132 * 4 * 32 * 1.755e9
ENERGY_INSTR = 24


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_tokens(got: np.ndarray, ref: np.ndarray, margins: np.ndarray, dtype: str,
                   grid: bool = False, m_tol: float = None, min_match: float = None):
    """Every row that differs must first differ at a step whose reference
    top-2 logit margin is <= the margin limit of ``dtype``; rows must agree
    on at least the row floor.  The limits are the vector decode's, or the
    grid decode's with ``grid``, unless ``m_tol`` and ``min_match`` name
    others."""
    m_tol = (GRID_MARGIN_TOL if grid else MARGIN_TOL)[dtype] if m_tol is None else m_tol
    min_match = (GRID_MIN_ROW_MATCH if grid else MIN_ROW_MATCH)[dtype] if min_match is None else min_match
    diff = got != ref
    rows = np.where(diff.any(axis=1))[0]
    first = diff.argmax(axis=1)
    at_first = [float(margins[r, first[r]]) for r in rows]
    stats = {
        "rows": int(got.shape[0]),
        "rows_differ": int(len(rows)),
        "median_top2_margin": float(np.median(margins)),
        "ref_distinct_tokens": int(len(np.unique(ref))),
        "ref_rows_ended": int((ref == END_ID).any(axis=1).sum()),
        "row_match": float(1.0 - len(rows) / got.shape[0]),
        "max_margin_at_first_diff": max(at_first) if at_first else None,
        "margin_tol": m_tol,
        "min_row_match": min_match,
    }
    ok = all(m <= m_tol for m in at_first) and stats["row_match"] >= min_match
    ok = ok and stats["ref_rows_ended"] > 0  # else the END -> PAD rule went untested
    return ok, stats


def draw_biases(model, rng) -> None:
    """Every bias from normal(0, BIAS_STD); END's vocab bias raised to the
    largest and the vocab biases shifted by -1 (see BIAS_STD)."""
    import torch

    with torch.no_grad():
        for pname, p in model.named_parameters():
            if pname.endswith("bias") or ".bias_" in pname:
                p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape), dtype=np.float32) * BIAS_STD))
        b_out = model.decoder.cell.out.bias
        b_out[END_ID] = b_out.max()
        b_out -= 1.0


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]

# The bf16 kernels redesigned for the tensor cores: each instantiation's SASS
# must hold HMMA (mma.sync) or HGMMA (wgmma) instructions.
TENSOR_CORE_KERNELS = ("lstm_layer_step_tc_kernel", "conv_pool_tc_kernel", "vocab_argmax_step_tc_kernel",
                       "attend_hw_tc_kernel", "lstm_seq_fwd_tc_kernel", "lstm_seq_bwd_tc_kernel", "lstm_seq_dw_tc_kernel",
                       "vocab_sample_step_tc_kernel", "beam_step_tc_kernel", "conv1_pool_tc_kernel")


def sass_mma_counts(lib_path):
    """{mangled kernel name: count of HMMA / HGMMA instructions} in the
    library's SASS (``cuobjdump -sass``), or None where the toolkit has no
    cuobjdump."""
    import re
    import shutil

    exe = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return None
    out = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True, timeout=600, check=True)
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts.setdefault(cur, 0)
        elif cur is not None and re.search(r"\bHG?MMA\.", line):
            counts[cur] += 1
    return counts


def check_tensor_core_build(lib_path) -> None:
    """Log the dynamic shared memory of each redesigned kernel and its
    tensor-core instruction count (from its SASS); fail if a redesigned
    kernel is missing or has no HMMA / HGMMA.  Their registers and spills
    are among the ptxas lines that main logs."""
    import torch

    from img2latex_tpu_torch.ops import _build
    from img2latex_tpu_torch.ops import conv1_phase as c1

    dims = (ctypes.c_int * 3)()
    ldims = (ctypes.c_longlong * 5)()
    rows = c1.conv1_plan(BATCH, IMG_H, IMG_W, FILTERS[0], torch.bfloat16).rows
    conv1 = c1.tc_launch_shape(BATCH, IMG_H, IMG_W, FILTERS[0], rows).smem_bytes
    log(f"dynamic shared memory a block: conv1_pool_tc_kernel {conv1} bytes (a band of {rows} pooled rows at "
        f"W = {IMG_W}), lstm_layer_step_tc_kernel {_build.lib().i2l_lstm_tc_smem_bytes()} bytes, "
        f"conv_pool_tc_kernel {_build.lib().i2l_conv_tc_smem_bytes()} bytes, vocab_argmax_step_tc_kernel "
        f"{_build.lib().i2l_vocab_tc_launch_shape(BATCH, 512, dims)} bytes, vocab_sample_step_tc_kernel "
        f"{_build.lib().i2l_sample_launch_shape(BATCH, GRID_HIDDEN, 512, SAMPLE['top_k'], 1, 1, ldims)} bytes, "
        f"beam_step_tc_kernel {_build.lib().i2l_beam_launch_shape(BATCH, BEAM, GRID_HIDDEN, 512, 1, ldims)} bytes "
        f"(at Vp = 512)")
    counts = sass_mma_counts(lib_path)
    if counts is None:
        log("cuobjdump not found: tensor-core instruction counts not measured")
        return
    for k in TENSOR_CORE_KERNELS:
        found = {name: n for name, n in counts.items() if k in name}
        log(f"SASS HMMA/HGMMA counts of {k}: {json.dumps(found)}")
        check(len(found) > 0, f"{k} is not in the library's SASS")
        check(all(n > 0 for n in found.values()), f"{k}: an instantiation runs no tensor-core instruction")


def check_launch_shapes() -> None:
    """The redesigned kernels' launches at the main path's shapes, from the
    library: the bf16 vocab, sampling and beam kernels spread B = 512 rows
    (512 x BEAM beam rows) over at least 64 blocks in clusters (one 64-column
    slice a block; the planners name the launch the library computes), and
    the attention takes one block a memory row, for 512 rows and for 512 x
    BEAM beam rows alike."""
    import torch

    from img2latex_tpu_torch.ops import _build

    dims = (ctypes.c_int * 3)()
    lib = _build.lib()
    lib.i2l_vocab_tc_launch_shape(BATCH, 512, dims)
    gx, gy, cl = tuple(dims)
    log(f"vocab_argmax_step_tc_kernel at B={BATCH}, Vp=512: grid ({gx}, {gy}) = {gx * gy} blocks, "
        f"clusters of {cl} along the columns")
    check(gx * gy >= 64 and cl > 1, "vocab_argmax_step: the bf16 launch is not split over clusters of >= 64 blocks")
    from img2latex_tpu_torch.ops import beam_decode as bd
    from img2latex_tpu_torch.ops import decode_step as ds

    for what, plan, shape in (
            ("vocab_sample_step_tc_kernel", ds.sample_plan(BATCH, GRID_HIDDEN, 512, SAMPLE["top_k"], torch.bfloat16,
                                                          SAMPLE["top_p"]),
             ds.launch_shape("sample", BATCH, GRID_HIDDEN, 512, SAMPLE["top_k"], 1, ds.ROUTE_CODES["cluster_tc"])),
            ("beam_step_tc_kernel", bd.beam_plan(BATCH, BEAM, GRID_HIDDEN, 512, torch.bfloat16),
             ds.launch_shape("beam", BATCH, BEAM, GRID_HIDDEN, 512, ds.ROUTE_CODES["cluster_tc"]))):
        log(f"{what} at B={BATCH}{f' x K={BEAM}' if 'beam' in what else ''}, Vp=512: planner {plan}, library {shape}")
        check(plan == shape and plan.route == "cluster_tc", f"{what}: the planner and the library disagree")
        check(plan.grid[0] * plan.grid[1] >= 64 and plan.cluster > 1,
              f"{what}: the bf16 launch is not split over clusters of >= 64 blocks")
    from img2latex_tpu_torch.ops import conv1_phase as c1

    plan = c1.conv1_plan(BATCH, IMG_H, IMG_W, FILTERS[0], torch.bfloat16)
    shape = c1.tc_launch_shape(BATCH, IMG_H, IMG_W, FILTERS[0], plan.rows)
    log(f"conv1_pool_tc_kernel at ({BATCH}, {IMG_H}, {IMG_W}) -> {FILTERS[0]}: planner {plan}, library {shape}")
    check(plan == shape and plan.route == "tc", "conv1_pool: the planner and the library disagree")
    for rows, k in ((BATCH, 1), (BATCH * BEAM, BEAM)):
        smem = lib.i2l_attend_launch_shape(rows, GRID_S, GRID_EMBED, GRID_HIDDEN, k, 1, dims)
        blocks, group, tile = tuple(dims)
        log(f"attend_mem_kernel at {rows} rows, rows_per_mem={k}: {blocks} blocks (one a memory row), groups of "
            f"{group} rows, memory tiles of {tile} of {GRID_S} slots, {smem} bytes of shared memory a block")
        check(blocks == BATCH and group == min(k, 8), f"attend_step rows_per_mem={k}: not a block a memory row")


def log_profile(what: str, card: str, fn) -> None:
    """Run ``fn`` once under torch.profiler and log the device time of each
    of the port's kernels (summed over launches) and the device busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t > 0:
            key = next((k for k in ("attend_hw_tc_kernel", "attend_hw_kernel", "attend_mem_kernel",
                                    "lstm_layer_step_tc_kernel", "lstm_layer_step_kernel", "vocab_argmax_step_tc_kernel",
                                    "vocab_argmax_step_kernel", "beam_step_tc_kernel", "beam_step_kernel",
                                    "vocab_sample_step_tc_kernel", "vocab_sample_step_kernel")
                        if k in e.key), "other")
            ms, n = by_kernel.get(key, (0.0, 0))
            by_kernel[key] = (ms + t / 1e3, n + e.count)
    busy = sum(ms for ms, _ in by_kernel.values())
    if busy > 0:
        log(f"{what} under torch.profiler: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy / wall_ms:.1f}%), device idle (host) {wall_ms - busy:.2f} ms; by kernel (ms, launches, "
            f"% of the busy time): {json.dumps({k: [round(ms, 4), n, round(100 * ms / busy, 1)] for k, (ms, n) in by_kernel.items()})} "
            f"[{card}]")
    else:
        log(f"{what} under torch.profiler: no device time seen (not measured)")


def time_vocab_step(dev, card: str, h, packed, H: int, width: str) -> dict:
    """vocab_argmax_step in bf16 at B = BATCH (h from the decode's layers):
    device time by CUDA-graph replay and eager, with and without a score
    signal, its plain version's, and the yardstick ``addmm + argmax`` (two
    PyTorch calls, b_out in bf16, so not the row's library call); bound.
    Returns the kernels-line fields."""
    import torch

    from img2latex_tpu_torch.ops.decode_step import vocab_argmax_step, vocab_argmax_step_plain

    Vp = packed["vocab_padded"]
    B = h.shape[0]
    tok = torch.zeros((B,), dtype=torch.int32, device=dev)
    fin = torch.zeros((B,), dtype=torch.int32, device=dev)
    out = torch.zeros((B, MAX_LEN), dtype=torch.int32, device=dev)
    score = torch.zeros((B,), dtype=torch.float32, device=dev)

    def call(step, **kw):
        return lambda: step(h, packed["w_out"], packed["b_out"], tok, fin, out, 0, END_ID, 0, **kw)

    ms_k, ms_ke = both_ms(call(vocab_argmax_step))
    ms_s, _ = both_ms(call(vocab_argmax_step, score=score, signal="margin_logp:0.5"))
    ms_p, ms_pe = both_ms(call(vocab_argmax_step_plain))
    b16 = packed["b_out"].to(torch.bfloat16)
    ms_y, ms_ye = both_ms(lambda: torch.addmm(b16, h, packed["w_out"]).argmax(-1))
    # h, W_out and b_out read, finished read and written, tokens and the out column written
    bnd, by = bound_ms(B * H * 2 + H * Vp * 2 + Vp * 4 + B * 4 * 4, 2 * B * H * Vp, "bfloat16")
    log(f"vocab_argmax_step {width} bf16 B={B} H={H} Vp={Vp}: kernel {ms_k:.4f} ms (device, CUDA graph; eager "
        f"{ms_ke:.4f}; with a score signal {ms_s:.4f}), plain {ms_p:.4f} ms (eager {ms_pe:.4f}), yardstick "
        f"addmm + argmax {ms_y:.4f} ms (eager {ms_ye:.4f}), bound {bnd:.4f} ms ({by}) [{card}]")
    return dict(ms=ms_k, ms_eager=ms_ke, plain_ms=ms_p, bound_ms=bnd, bound_by=by)


# lstm_layer_step in bf16 (the tensor-core kernel) against its plain version at
# the main path's shapes: (name, rows, E0, E1, H) for layer 0 (the embedding
# gather, E0 > 0) and layer 1 (E0 = 0, x1 the layer below's h) of each width,
# at the batch and at the beam's 2560 rows, and a ragged shape (rows past a
# tile, H odd: rows of 4H bf16 that are not 16-byte multiples).
LSTM_STEP_SHAPES = [(f"{w} {layer}", rows, E0, E1, H)
                    for rows in (BATCH, BEAM * BATCH)
                    for w, E, H in (("vector", EMBED, HIDDEN), ("grid", GRID_EMBED, GRID_HIDDEN))
                    for layer, E0, E1 in (("layer 0", E, E), ("layer 1", 0, H))] + [
    ("ragged layer 0", 70, 24, 24, 33), ("ragged layer 1", 70, 0, 33, 33)]


def phase_lstm_step_shapes(dev, card: str) -> dict:
    """The bf16 lstm_layer_step kernel against lstm_layer_step_plain on the
    same operands at LSTM_STEP_SHAPES, h and c within STEP_ATOL["bfloat16"];
    each timed by CUDA-graph replay (device time).  Returns {name: (ms, max
    abs error of h and c)}.  Its operands come from a generator of its own, so
    that the later phases draw the same data whether or not it runs."""
    import torch

    from img2latex_tpu_torch.ops.decode_step import lstm_layer_step, lstm_layer_step_plain

    rng = np.random.default_rng(SEED + 10)

    def bf(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)

    res = {}
    for name, rows, E0, E1, H in LSTM_STEP_SHAPES:
        K = E0 + E1 + H
        tok = torch.from_numpy(rng.integers(0, VOCAB, rows).astype(np.int32)).to(dev) if E0 else None
        emb = bf(rng.normal(size=(VOCAB, E0))) if E0 else None
        x1, h = bf(rng.normal(size=(rows, E1))), bf(rng.uniform(-1, 1, (rows, H)))
        w_ih, w_hh = bf(rng.normal(size=(E0 + E1, 4 * H)) / np.sqrt(K)), bf(rng.normal(size=(H, 4 * H)) / np.sqrt(K))
        b = torch.from_numpy(rng.normal(size=4 * H).astype(np.float32) * BIAS_STD).to(dev)
        c0 = bf(rng.uniform(-1, 1, (rows, H)))
        outs = []
        for step in (lstm_layer_step, lstm_layer_step_plain):
            c, h_out = c0.clone(), torch.empty_like(h)
            step(tok, emb, x1, h, w_ih, w_hh, b, c, h_out)
            outs.append((c, h_out))
        (ck, hk), (cp, hp) = outs
        err_h = (hk.float() - hp.float()).abs().max().item()
        err_c = (ck.float() - cp.float()).abs().max().item()
        check(bool(hk.float().isfinite().all().item() and ck.float().isfinite().all().item()),
              f"lstm_layer_step bf16 {name}: non-finite output")
        check(err_h <= STEP_ATOL["bfloat16"] and err_c <= STEP_ATOL["bfloat16"],
              f"lstm_layer_step bf16 {name} rows={rows}: h err {err_h}, c err {err_c} > {STEP_ATOL['bfloat16']}")
        c = c0.clone()
        ms = graph_ms(lambda: lstm_layer_step(tok, emb, x1, h, w_ih, w_hh, b, c, h_out))
        res[f"{name} rows={rows}"] = (ms, max(err_h, err_c))
        log(f"lstm_layer_step bf16 {name} rows={rows} (E0={E0}, E1={E1}, H={H}): h max abs err {err_h:.3g}, "
            f"c {err_c:.3g} (tol {STEP_ATOL['bfloat16']}); {ms:.4f} ms (device, CUDA graph) [{card}]")
    return res


def phase_attend(dev, rng, card: str, kernels: dict) -> None:
    """attend_step against its plain version at the grid path's shapes."""
    import torch

    from img2latex_tpu_torch.ops.grid_decode import attend_step, attend_step_plain

    B, S, E, H = BATCH, GRID_S, GRID_EMBED, GRID_HIDDEN
    A = H
    f32 = {
        "h": rng.uniform(-1, 1, (B, H)),
        "w_h": rng.standard_normal((H, A)) / np.sqrt(H),
        "v": rng.standard_normal(A) / np.sqrt(A),
        "u": rng.standard_normal((B, S, A)),
        "mem": np.maximum(rng.standard_normal((B, S, E)), 0),
    }
    errs = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        t = {k: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype) for k, a in f32.items()}
        args = (t["h"], t["w_h"], t["v"], t["u"], t["mem"])
        got = attend_step(*args, torch.empty((B, E), device=dev, dtype=dtype))
        ref = attend_step_plain(*args, torch.empty((B, E), device=dev, dtype=dtype)).float()
        d = (got.float() - ref).abs()
        errs[name] = d.max().item()
        if name == "float32":
            check(errs[name] <= ATTEND_F32_ATOL, f"attend_step f32 max abs err {errs[name]} > {ATTEND_F32_ATOL}")
        else:
            over = (d - ATTEND_BF16_RTOL * ref.abs()).max().item()
            check(over <= ATTEND_F32_ATOL,
                  f"attend_step bf16: max |err| - 2^-6 |ref| = {over} > {ATTEND_F32_ATOL}")
    log(f"attend_step B={B} S={S} E={E} H=A={H}: f32 max abs err {errs['float32']:.3g} "
        f"(tol {ATTEND_F32_ATOL}); bf16 vs bf16 plain max abs err {errs['bfloat16']:.3g} "
        f"(tol {ATTEND_BF16_RTOL:.4g} |ref| + {ATTEND_F32_ATOL})")
    ctx = torch.empty((B, E), device=dev, dtype=torch.bfloat16)
    hw = torch.empty((B, A), device=dev, dtype=torch.bfloat16)
    ms_k, ms_ke = both_ms(lambda: attend_step(*args, ctx, hw), iters=50)
    ms_p, ms_pe = both_ms(lambda: attend_step_plain(*args, ctx))
    log_profile(f"20 attend_step launches (B={B}, bf16)", card,
                lambda: [attend_step(*args, ctx, hw) for _ in range(20)])
    nbytes = 2 * (B * S * (A + E) + B * H + H * A + A + B * E)
    flops = 2 * B * H * A + 2 * B * S * A + 2 * B * S * E
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    tanh_ms = B * S * A * ENERGY_INSTR / LANE_INSTR_PER_S * 1e3
    log(f"attend_step bf16 B={B}: kernel {ms_k:.4f} ms (device, CUDA graph; eager {ms_ke:.4f}), plain {ms_p:.4f} ms "
        f"(eager {ms_pe:.4f}), bound {bnd:.4f} ms ({by}); energies' compute floor {tanh_ms:.4f} ms "
        f"({B * S * A / 1e6:.1f} M x ~{ENERGY_INSTR} instructions); no single PyTorch call computes additive "
        f"attention [{card}]")
    kernels["attend_step"] = dict(
        name="attend_step", route="cuda", source="img2latex_tpu_torch/csrc/grid_attend.cu",
        replaces="img2latex_tpu/ops/pallas/grid_decode.py:373", max_abs_err=errs["float32"],
        max_abs_err_bf16=errs["bfloat16"], ms=ms_k, ms_eager=ms_ke, plain_ms=ms_p, bound_ms=bnd, bound_by=by,
        library_ms=None, ms_method="cuda_graph")


def grid_config():
    from img2latex_tpu_torch.config import Config

    cfg = Config()
    cfg.model.memory = "grid"
    cfg.model.embedding_dim = GRID_EMBED
    cfg.model.decoder.hidden_dim = GRID_HIDDEN
    cfg.model.decoder.lstm_layers = LAYERS
    cfg.model.encoder.cnn.img_height, cfg.model.encoder.cnn.img_width = IMG_H, IMG_W
    cfg.model.encoder.cnn.conv_filters = list(FILTERS)
    cfg.data.max_seq_length = cfg.inference.max_length = MAX_LEN
    cfg.hardware.compute_dtype = "bfloat16"
    return cfg


def _decoders(kind: str, model, ctx_or_memory, dtype):
    """(kernel decode, plain decode) of one memory kind, each a function of
    keyword options, on the given context (vector) or memory (grid)."""
    from img2latex_tpu_torch.ops import decode_step as ds
    from img2latex_tpu_torch.ops import grid_decode as gd

    packed = ds.pack_decoder_weights(model.decoder, dtype)
    if kind == "vector":
        ctx = ctx_or_memory.to(dtype)
        return (lambda **kw: ds.greedy_decode(packed, ctx, MAX_LEN, 1, END_ID, 0, **kw),
                lambda **kw: ds.greedy_decode_plain(packed, ctx, MAX_LEN, 1, END_ID, 0, **kw))
    att = gd.pack_attention_weights(model.decoder, dtype)
    mem = ctx_or_memory.to(dtype)
    u = gd.grid_memory_proj(att, mem)
    return (lambda **kw: gd.grid_greedy_decode(packed, att, mem, u, MAX_LEN, 1, END_ID, 0, **kw),
            lambda **kw: gd.grid_greedy_decode_plain(packed, att, mem, u, MAX_LEN, 1, END_ID, 0, **kw))


def grid_memory(rng, dev):
    """A random grid memory (BATCH, GRID_S, GRID_EMBED) whose rows differ in
    scale and mean, so that the attention (nearly uniform with random
    weights) gives rows distinct contexts."""
    import torch

    gmem = (np.maximum(rng.standard_normal((BATCH, GRID_S, GRID_EMBED), dtype=np.float32), 0)
            * rng.uniform(0, 3, (BATCH, 1, 1)).astype(np.float32)
            + 2 * np.maximum(rng.standard_normal((BATCH, 1, GRID_EMBED), dtype=np.float32), 0))
    return torch.from_numpy(gmem).to(dev)


def phase_grid_decode(gmodel, memory) -> None:
    """The grid greedy decode against its plain version, B = BATCH, T = MAX_LEN."""
    import torch

    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        kernel, plain = _decoders("grid", gmodel, memory, dtype)
        got = kernel()
        ref, margins = plain(return_margins=True)
        check(tuple(got.shape) == (BATCH, MAX_LEN) and got.dtype == torch.int32, "grid decode output")
        ok, stats = compare_tokens(got.cpu().numpy(), ref.cpu().numpy(), margins.cpu().numpy(), name,
                                   grid=True)
        log(f"grid_greedy_decode {name} B={BATCH} S={GRID_S} T={MAX_LEN}: {json.dumps(stats)}")
        check(ok, f"grid_greedy_decode {name} disagrees with its plain version: {stats}")


def _make_rows_end(kind: str, model, inp, kernel_of) -> None:
    """Point END's vocab column along the top-layer h that the decode settles
    to (the mean over the rows, from 40 eager steps), and raise END's bias
    (by bisection) to the least value at which every row of the kernel
    decode ends: rows then end at different steps, as h settles."""
    import torch

    with torch.no_grad():
        memory = inp[:, None, :] if kind == "vector" else inp
        mem_proj = model.memory_proj(memory)
        carry = model.init_carry(memory.shape[0], memory.device)
        tok = torch.full((memory.shape[0],), 1, dtype=torch.int32, device=memory.device)
        for _ in range(40):
            logits, carry = model.decode_step(memory, tok, carry, mem_proj=mem_proj)
            tok = logits.argmax(-1).to(torch.int32)
        h_settled = carry[0][-1].float().mean(0)
        out = model.decoder.cell.out
        out.weight[END_ID] = h_settled / h_settled.norm()

        def all_end(b):
            out.bias[END_ID] = b
            return bool((kernel_of() == END_ID).any(dim=1).all())

        lo, hi = -4.0, 4.0
        check(all_end(hi), f"{kind}: END bias {hi} does not end every row")
        for _ in range(12):
            mid = (lo + hi) / 2
            lo, hi = (lo, mid) if all_end(mid) else (mid, hi)
        out.bias[END_ID] = hi


def phase_early_exit_and_scores(models) -> None:
    """Both memory kinds: early exit gives the full loop's tokens on a model
    whose rows all end; the four score signals against the plain version."""
    import torch

    from img2latex_tpu_torch.ops.decode_step import vocab_argmax_step

    for kind, (model, inp) in models.items():
        out = model.decoder.cell.out
        saved = (out.weight.detach().clone(), out.bias.detach().clone())
        try:
            _make_rows_end(kind, model, inp, lambda: _decoders(kind, model, inp, torch.bfloat16)[0]())
            kernel, _ = _decoders(kind, model, inp, torch.bfloat16)
            full = kernel()
            n0 = vocab_argmax_step.launches
            early = kernel(early_exit=True)
            steps = vocab_argmax_step.launches - n0
            check(bool((full == END_ID).any(dim=1).all()), f"early exit {kind}: not every row ends")
            end_at = (full == END_ID).int().argmax(dim=1).float()
            log(f"early exit {kind} bf16 B={BATCH}: END bias {out.bias.detach()[END_ID].item():.4f}, rows end at steps "
                f"{int(end_at.min())}..{int(end_at.max())} (median {float(end_at.median()):.0f}), "
                f"{steps} of {MAX_LEN} steps run; tokens equal to the full loop: {bool(torch.equal(early, full))}")
            check(torch.equal(early, full), f"early exit {kind}: tokens differ from the full loop")
            check(steps < MAX_LEN, f"early exit {kind}: ran all {steps} steps")
        finally:
            with torch.no_grad():
                out.weight.copy_(saved[0])
                out.bias.copy_(saved[1])
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            kernel, plain = _decoders(kind, model, inp, dtype)
            res = {}
            for signal in SIGNALS:
                tk, sk = kernel(return_scores=True, signal=signal)
                tp, sp = plain(return_scores=True, signal=signal)
                same = (tk == tp).all(dim=1)
                d = (sk - sp).abs()[same]
                tol = SCORE_ATOL[name] + SCORE_RTOL * sp.abs()[same]
                check(bool(torch.isfinite(sk).all()), f"scores {kind} {name} {signal}: not finite")
                res[signal] = {"max_abs_err": d.max().item(), "max_err_over_tol": (d / tol).max().item(),
                               "rows_compared": int(same.sum()), "median_score": float(sp.median())}
                check(bool((d <= tol).all()) and int(same.sum()) > 0,
                      f"scores {kind} {name} {signal}: {res[signal]}")
            log(f"scores {kind} {name} B={BATCH} T={MAX_LEN} (tol {SCORE_ATOL[name]} + {SCORE_RTOL:.3g} |ref|): "
                f"{json.dumps(res)}")


def phase_grid_end_to_end(dev, card, gcfg, gmodel, tokenizer, images, kernels) -> None:
    """Predictor.predict_batch with memory="grid" at full width, bf16."""
    import torch
    import torch.nn.functional as F

    from img2latex_tpu_torch.ops.conv1_phase import conv1_pool, conv1_pool_plain
    from img2latex_tpu_torch.ops.decode_step import (
        greedy_decode, lstm_layer_step, lstm_layer_step_plain, vocab_argmax_step, vocab_argmax_step_plain,
    )
    from img2latex_tpu_torch.ops.grid_decode import (
        attend_step, grid_greedy_decode, grid_greedy_decode_plain, grid_memory_proj,
    )
    from img2latex_tpu_torch.ops.preprocess import normalize_images
    from img2latex_tpu_torch.training.predictor import Predictor

    pred = Predictor(gcfg, gmodel, tokenizer, batch_size=BATCH)
    pred.predict_batch(images[:BATCH], return_ids=True)  # warm-up (cuDNN plans, packing)
    torch.cuda.synchronize()
    conv1_pool.launches = conv1_pool.tc_launches = attend_step.launches = lstm_layer_step.launches = 0
    vocab_argmax_step.launches = 0
    t0 = time.perf_counter()
    ids = pred.predict_batch(images, return_ids=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv1_pool": conv1_pool.launches, "attend_step": attend_step.launches,
                "lstm_layer_step": lstm_layer_step.launches, "vocab_argmax_step": vocab_argmax_step.launches}
    log(f"grid predict_batch: {N_IMAGES} images in {wall:.3f} s = {N_IMAGES / wall:.1f} images/s "
        f"(batch {BATCH}, bf16, S={GRID_S}, E={GRID_EMBED}, H=A={GRID_HIDDEN}, card {card}); "
        f"launches {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the grid path")
    check(conv1_pool.tc_launches == launches["conv1_pool"], "the grid path ran conv1_pool off the tensor-core route")
    kernels["attend_step"]["launches"] = launches["attend_step"]
    check(len(ids) == N_IMAGES and all(len(r) <= MAX_LEN for r in ids), "grid predict_batch output")
    check(all(tokenizer.end_token_id not in r and all(0 <= t < VOCAB for t in r) for r in ids),
          "grid trimmed ids")

    canv = np.stack(images[:BATCH])
    toks = pred.decode_canvases(canv)
    check(toks.shape == (BATCH, MAX_LEN) and toks.dtype == np.int32, f"grid tokens {toks.shape}")
    is_end = toks == tokenizer.end_token_id
    after = np.cumsum(is_end, axis=1) - is_end > 0
    check(bool((toks[after] == tokenizer.pad_token_id).all()), "grid: a token other than PAD follows END")
    enc = gmodel.encoder
    with torch.no_grad():
        x = normalize_images(torch.from_numpy(canv).to(dev), dtype=torch.bfloat16)
        y = conv1_pool_plain(x, enc.convs[0].weight, enc.convs[0].bias)
        for conv in enc.convs[1:]:
            y = F.max_pool2d(F.relu(F.conv2d(y, conv.weight.to(y.dtype), conv.bias.to(y.dtype), padding=1)), 2)
        Bc, C, Hf, Wf = y.shape
        grid_in = y.permute(0, 3, 2, 1).reshape(Bc, Wf, Hf * C)
        mem_ref = F.relu(F.linear(grid_in, enc.head.weight.to(y.dtype), enc.head.bias.to(y.dtype)))
        mem = gmodel.encode(x)
        check(tuple(mem.shape) == (BATCH, GRID_S, GRID_EMBED), f"grid memory {tuple(mem.shape)}")
        mem_err = ((mem.float() - mem_ref.float()).abs() / mem_ref.float().abs().clamp_min(1.0)).max().item()
        att = pred.packed_attention()
        ref, margins = grid_greedy_decode_plain(pred.packed_decoder(), att, mem_ref, grid_memory_proj(att, mem_ref),
                                                MAX_LEN, 1, END_ID, 0, return_margins=True)
    ok, stats = compare_tokens(toks, ref.cpu().numpy(), margins.cpu().numpy(), "bfloat16", grid=True)
    log(f"grid end to end vs plain path ({BATCH} images): memory max rel err {mem_err:.3g} "
        f"(tol {CONV_BF16_RTOL}); tokens {json.dumps(stats)}")
    check(np.isfinite(mem.float().cpu().numpy()).all(), "non-finite grid memory")
    check(mem_err <= CONV_BF16_RTOL and ok, "grid end-to-end output disagrees with the plain path")

    # where a grid batch's time goes, each part alone (bf16, B = BATCH)
    packed = pred.packed_decoder()
    with torch.no_grad():
        ms_feat = time_ms(lambda: enc.features(x), iters=5)
        ms_enc = time_ms(lambda: enc(x), iters=5)
        ms_u = time_ms(lambda: grid_memory_proj(att, mem), iters=5)
        u = grid_memory_proj(att, mem)
        ms_dec = time_ms(lambda: grid_greedy_decode(packed, att, mem, u, MAX_LEN, 1, END_ID, 0), iters=3, warmup=1)
        ms_dec_p = time_ms(lambda: grid_greedy_decode_plain(packed, att, mem, u, MAX_LEN, 1, END_ID, 0),
                           iters=3, warmup=1)
        # the same LSTM and vocab launches with a constant context: the decode without attention
        ms_dec_v = time_ms(lambda: greedy_decode(packed, mem[:, 0, :], MAX_LEN, 1, END_ID, 0), iters=3, warmup=1)
    bf = torch.bfloat16
    tok = torch.full((BATCH,), 1, dtype=torch.int32, device=dev)
    fin = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    out = torch.zeros((BATCH, MAX_LEN), dtype=torch.int32, device=dev)
    hh = torch.zeros((3, BATCH, GRID_HIDDEN), dtype=bf, device=dev)
    cc = torch.zeros((LAYERS, BATCH, GRID_HIDDEN), dtype=bf, device=dev)
    ctx = mem[:, 0, :].contiguous()

    def layers(step):
        step(tok, packed["emb"], ctx, hh[0], packed["w_ih_0"], packed["w_hh_0"], packed["b_0"], cc[0], hh[1])
        step(None, None, hh[1], hh[2], packed["w_ih_1"], packed["w_hh_1"], packed["b_1"], cc[1], hh[0])

    ms_l = graph_ms(lambda: layers(lstm_layer_step)) / LAYERS
    ms_lp = graph_ms(lambda: layers(lstm_layer_step_plain)) / LAYERS
    layers(lstm_layer_step)  # hh[0]: a decode step's top-layer h
    vocab = time_vocab_step(dev, card, hh[0], packed, GRID_HIDDEN, "grid")
    ms_v, ms_vp = vocab["ms"], vocab["plain_ms"]
    ms_a = kernels["attend_step"]["ms"]
    # one decode under torch.profiler: device time by kernel, and the busy share
    log_profile(f"grid decode (B={BATCH}, bf16)", card,
                lambda: grid_greedy_decode(packed, att, mem, u, MAX_LEN, 1, END_ID, 0))
    log(f"grid batch of {BATCH}, bf16, each part alone [{card}]: conv stack {ms_feat:.3f} ms, "
        f"encoder with grid head {ms_enc:.3f} ms (head {ms_enc - ms_feat:.3f}), U {ms_u:.3f} ms, "
        f"decode {ms_dec:.3f} ms (plain {ms_dec_p:.3f}; without attention {ms_dec_v:.3f}); per step: attend_step {ms_a:.4f}, "
        f"lstm_layer_step {ms_l:.4f} (plain {ms_lp:.4f}) x {LAYERS}, vocab_argmax_step {ms_v:.4f} "
        f"(plain {ms_vp:.4f}); x {MAX_LEN} steps: attention {ms_a * MAX_LEN:.2f} ms, "
        f"LSTM+vocab {(LAYERS * ms_l + ms_v) * MAX_LEN:.2f} ms")


def _beam_step_operands(dev, rng, B, K, H, Vp, dtype, tie=False):
    """Random beam-step operands at the main path's shapes: a vocab of
    VOCAB columns padded to Vp, random scores with some samples at t = 0
    (only beam 0 live), ~15% finished rows elsewhere; with ``tie`` each
    sample's beams share h and score, so every candidate ties across its K
    beams."""
    import torch

    N = B * K
    h = rng.uniform(-1, 1, (N, H)).astype(np.float32)
    scores = rng.uniform(-40, 0, N).astype(np.float32)
    fin = (rng.uniform(size=N) < 0.15).astype(np.int32)
    scores.reshape(B, K)[::7, 1:] = -1e30  # samples at t = 0, where nothing has ended yet
    fin.reshape(B, K)[::7] = 0
    if tie:
        h = np.repeat(h[::K], K, axis=0)
        scores = np.repeat(scores[::K], K)
        fin[:] = 0
    w = np.zeros((H, Vp), np.float32)
    w[:, :VOCAB] = rng.standard_normal((H, VOCAB), dtype=np.float32) * 3 / np.sqrt(H)
    b = np.full(Vp, -1e30, np.float32)
    b[:VOCAB] = rng.standard_normal(VOCAB, dtype=np.float32) * BIAS_STD
    carries = rng.uniform(-1, 1, (2, LAYERS, N, H)).astype(np.float32)

    def t(a, dt=dtype):
        return torch.from_numpy(a).to(dev, dt)

    return dict(h=t(h), w_out=t(w), b_out=t(b, torch.float32), scores=t(scores, torch.float32),
                fin=torch.from_numpy(fin).to(dev), h_src=t(carries[0]), c_src=t(carries[1]))


def _beam_step_run(step, op, K, out=None, **kw):
    """One beam step on copies of the operands (into ``out`` when given)."""
    import torch

    N = op["h"].shape[0]
    if out is None:
        out = dict(scores=op["scores"].clone(), fin=op["fin"].clone(),
                   tokens=torch.empty((N,), dtype=torch.int32, device=op["h"].device),
                   tok_hist=torch.zeros((MAX_LEN, N), dtype=torch.int32, device=op["h"].device),
                   par_hist=torch.zeros((MAX_LEN, N), dtype=torch.int32, device=op["h"].device),
                   h_dst=torch.empty_like(op["h_src"]), c_dst=torch.empty_like(op["c_src"]))
    step(op["h"], op["w_out"], op["b_out"], out["scores"], out["fin"], out["tokens"], out["tok_hist"],
         out["par_hist"], 3, K, END_ID, 0, op["h_src"], out["h_dst"], op["c_src"], out["c_dst"], **kw)
    return out


def _product_yardstick_ms(dev, rows: int, H: int, Vp: int) -> float:
    """Device time of ``torch.addmm`` in bf16 at (rows, H) x (H, Vp), by CUDA-graph replay: how
    long cuBLAS takes for the vocab product alone (a yardstick of the product's share of a step,
    not a library call of the whole step)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(rows + H)  # its own: the global stream stays as it was
    a, w, b = (torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16) for shape in ((rows, H), (H, Vp), (Vp,)))
    return graph_ms(lambda: torch.addmm(b, a, w))


def _routes(dtype):
    """(name, context) of each route a dtype's step is held on: bf16 the tensor-core cluster
    kernel and the CUDA-core block kernel (block_route), float32 the block kernel."""
    import torch

    if dtype == torch.bfloat16:
        return (("cluster_tc", contextlib.nullcontext), ("block", block_route))
    return (("block", contextlib.nullcontext),)


def phase_beam_step(dev, rng, card: str, kernels: dict) -> None:
    """beam_step against beam_step_plain at B = BATCH samples of K = BEAM
    beams, both widths and both types, random and with forced exact ties;
    and of K = WIDE_BEAM beams at the grid width; bf16 on both routes (the
    tensor-core cluster kernel and the CUDA-core block kernel).  Times both
    bf16 routes beside the cuBLAS product alone."""
    import torch

    from img2latex_tpu_torch.ops import beam_decode as bd
    from img2latex_tpu_torch.ops.beam_decode import beam_step, beam_step_plain

    B, Vp = BATCH, 512
    errs = {}
    for width, H, K in (("vector", HIDDEN, BEAM), ("grid", GRID_HIDDEN, BEAM), ("grid", GRID_HIDDEN, WIDE_BEAM)):
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for tie in (False, True):
                op = _beam_step_operands(dev, rng, B, K, H, Vp, dtype, tie=tie)
                gaps = torch.full((B, MAX_LEN, K), float("inf"), device=dev)
                ref = _beam_step_run(beam_step_plain, op, K, gaps=gaps)
                clear = gaps[:, 3].amin(dim=-1) > BEAM_STEP_GAP
                if tie:
                    clear = torch.ones_like(clear)  # exact ties on both sides: the lowest flat index wins
                rows = clear.repeat_interleave(K)
                for route, ctx in _routes(dtype):
                    with ctx():
                        check(bd.beam_plan(B, K, H, Vp, dtype).route == route, f"beam_step: not the {route} route")
                        n0 = getattr(beam_step, f"{route}_launches")
                        got = _beam_step_run(beam_step, op, K)
                        check(getattr(beam_step, f"{route}_launches") == n0 + 1, f"beam_step: {route} not launched")
                    bad = [k for k in ("tokens", "fin") if not torch.equal(got[k][rows], ref[k][rows])]
                    bad += [k for k in ("tok_hist", "par_hist") if not torch.equal(got[k][3][rows], ref[k][3][rows])]
                    bad += [k for k in ("h_dst", "c_dst") if not torch.equal(got[k][:, rows], ref[k][:, rows])]
                    err = (got["scores"][rows] - ref["scores"][rows]).abs().max().item()
                    errs[(width, name, tie, K, route)] = err
                    log(f"beam_step {width} H={H} {name} {route}{' ties' if tie else ''} B={B} K={K}: "
                        f"{int(clear.sum())}/{B} samples clear of near-ties (gap > {BEAM_STEP_GAP}); "
                        f"mismatches {bad or 'none'}; score max abs err {err:.3g} (tol {BEAM_STEP_ATOL})")
                    check(not bad and err <= BEAM_STEP_ATOL and float(clear.float().mean()) >= 0.99,
                          f"beam_step {width} {name} {route} tie={tie} K={K} disagrees with its plain version")
                    if tie:
                        par = got["par_hist"][3].view(B, K).long()
                        check(torch.equal(par, torch.arange(K, device=dev).expand(B, K)),
                              "beam_step ties: the picks are not beam 0..K-1 in order")
    K = BEAM
    N = B * K
    # timing at both widths, bf16, both routes; the kernels line keeps the grid path's
    for width, H in (("vector", HIDDEN), ("grid", GRID_HIDDEN)):
        op = _beam_step_operands(dev, rng, B, K, H, Vp, torch.bfloat16)
        out_k = _beam_step_run(beam_step, op, K)
        out_p = _beam_step_run(beam_step_plain, op, K)
        ms_k, ms_ke = both_ms(lambda: _beam_step_run(beam_step, op, K, out_k), iters=50)
        with block_route():
            ms_b, ms_be = both_ms(lambda: _beam_step_run(beam_step, op, K, out_k), iters=50)
        ms_y = _product_yardstick_ms(dev, N, H, Vp)
        # the plain version fills a row from the host (pad_row[pad_id] = 0.0), which a CUDA graph
        # cannot capture: its time stays eager (plain_ms_method)
        ms_p = time_ms(lambda: _beam_step_run(beam_step_plain, op, K, out_p), iters=20)
        nbytes = (N * H * 2 + H * Vp * 2 + Vp * 4 + N * 4 * 2 * 2 + N * 4 * 3
                  + 2 * LAYERS * N * H * 2 * 2)  # h, W_out, b_out, scores and finished r/w, tokens + history, carries r/w
        flops = 2 * N * H * Vp
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        log(f"beam_step {width} bf16 B={B} K={K} H={H} Vp={Vp}: tensor-core cluster kernel {ms_k:.4f} ms (device, "
            f"CUDA graph; eager {ms_ke:.4f}), CUDA-core block kernel {ms_b:.4f} ms (eager {ms_be:.4f}), the product "
            f"alone in cuBLAS (addmm bf16 {N}x{H}x{Vp}) {ms_y:.4f} ms, plain {ms_p:.4f} ms (eager), "
            f"bound {bnd:.4f} ms ({by}); no single PyTorch call computes log-softmax + per-sample K*V top-K "
            f"+ carry gather [{card}]")
    kernels["beam_step"] = dict(
        name="beam_step", route="cuda", source="img2latex_tpu_torch/csrc/beam_step_tc.cu",
        replaces="img2latex_tpu/ops/pallas/beam_decode.py:335",
        max_abs_err=errs[("grid", "float32", False, BEAM, "block")],
        max_abs_err_bf16=errs[("grid", "bfloat16", False, BEAM, "cluster_tc")],
        ms=ms_k, ms_eager=ms_ke, plain_ms=ms_p, bound_ms=bnd, bound_by=by, library_ms=None, ms_method="cuda_graph",
        plain_ms_method="eager", parts={"block_route_ms": ms_b, "product_yardstick_ms": ms_y})


def phase_attend_shared(dev, rng, card: str, kernels: dict) -> None:
    """attend_step with rows_per_mem = BEAM (the K beams of a sample share
    its memory) against its plain version at the grid flagship's width."""
    import torch

    from img2latex_tpu_torch.ops.grid_decode import attend_step, attend_step_plain

    B, S, E, H, K = BATCH, GRID_S, GRID_EMBED, GRID_HIDDEN, BEAM
    A, N = H, BATCH * BEAM
    f32 = {
        "h": rng.uniform(-1, 1, (N, H)),
        "w_h": rng.standard_normal((H, A)) / np.sqrt(H),
        "v": rng.standard_normal(A) / np.sqrt(A),
        "u": rng.standard_normal((B, S, A)),
        "mem": np.maximum(rng.standard_normal((B, S, E)), 0),
    }
    errs = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        t = {k: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype) for k, a in f32.items()}
        args = (t["h"], t["w_h"], t["v"], t["u"], t["mem"])
        got = attend_step(*args, torch.empty((N, E), device=dev, dtype=dtype), rows_per_mem=K)
        ref = attend_step_plain(*args, torch.empty((N, E), device=dev, dtype=dtype), rows_per_mem=K).float()
        d = (got.float() - ref).abs()
        errs[name] = d.max().item()
        if name == "float32":
            check(errs[name] <= ATTEND_F32_ATOL, f"attend_step[rows_per_mem={K}] f32 max abs err {errs[name]}")
        else:
            over = (d - ATTEND_BF16_RTOL * ref.abs()).max().item()
            check(over <= ATTEND_F32_ATOL, f"attend_step[rows_per_mem={K}] bf16: max |err| - 2^-6 |ref| = {over}")
    log(f"attend_step rows_per_mem={K} B={B} (N={N} rows) S={S} E={E} H=A={H}: f32 max abs err "
        f"{errs['float32']:.3g} (tol {ATTEND_F32_ATOL}); bf16 vs bf16 plain max abs err {errs['bfloat16']:.3g} "
        f"(tol {ATTEND_BF16_RTOL:.4g} |ref| + {ATTEND_F32_ATOL})")
    ctx = torch.empty((N, E), device=dev, dtype=torch.bfloat16)
    hw = torch.empty((N, A), device=dev, dtype=torch.bfloat16)
    ms_k, ms_ke = both_ms(lambda: attend_step(*args, ctx, hw, rows_per_mem=K), iters=50)
    ms_p, ms_pe = both_ms(lambda: attend_step_plain(*args, ctx, rows_per_mem=K), iters=10)
    # the memory and U once (not K times), h, W_h, v and ctx
    nbytes = 2 * (B * S * (A + E) + N * H + H * A + A + N * E)
    flops = 2 * N * H * A + 2 * N * S * A + 2 * N * S * E
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    tanh_ms = N * S * A * ENERGY_INSTR / LANE_INSTR_PER_S * 1e3
    log(f"attend_step[rows_per_mem={K}] bf16: kernel {ms_k:.4f} ms (device, CUDA graph; eager {ms_ke:.4f}), plain "
        f"{ms_p:.4f} ms (eager {ms_pe:.4f}), bound {bnd:.4f} ms ({by}); energies' compute floor {tanh_ms:.4f} ms "
        f"({N * S * A / 1e6:.1f} M x ~{ENERGY_INSTR} instructions); a block a memory row reads its "
        f"{2 * B * S * (A + E) / 1e6:.1f} MB of U and memory once a step for its {K} rows [{card}]")
    kernels[f"attend_step[rows_per_mem={K}]"] = dict(
        name=f"attend_step[rows_per_mem={K}]", route="cuda", source="img2latex_tpu_torch/csrc/grid_attend.cu",
        replaces="img2latex_tpu/ops/pallas/grid_decode.py:561", max_abs_err=errs["float32"],
        max_abs_err_bf16=errs["bfloat16"], ms=ms_k, ms_eager=ms_ke, plain_ms=ms_p, bound_ms=bnd, bound_by=by,
        library_ms=None, ms_method="cuda_graph")


def compare_beams(got, ref, got_trace, ref_trace, dtype: str, logp_tol: float):
    """The whole-beam-decode rule (see BEAM_LOGP_TOL): ``got`` and ``ref`` are
    the best beams' tokens (B, T) on the host, ``got_trace`` and
    ``ref_trace`` the two decodes' traces.  Returns (ok, stats)."""
    from img2latex_tpu_torch.ops.beam_decode import beam_divergence

    T = got.shape[1]
    div = {k: v.cpu().numpy() for k, v in beam_divergence(got_trace, ref_trace).items()}
    first, drift, gap, step_err = div["first"], div["drift"], div["gap"], div["step_err"]
    size = ref_trace["scores"].abs().amax(dim=(0, 2)).cpu().numpy()
    score_tol = SCORE_ATOL[dtype] + SCORE_RTOL * size
    # what a step adds, from two float32 scores each rounded to 2^-24 |score|
    step_tol = logp_tol + 2.0**-22 * size
    choice_gap = ref_trace["choice_gap"].cpu().numpy()
    gap_tol = 2 * logp_tol
    parted = first < T
    differ = (got != ref).any(axis=1)
    step_ok = ~parted | (gap <= gap_tol + 2 * drift)
    choice_only = differ & ~parted
    choice_ok = ~choice_only | (choice_gap <= drift + 4 * 2.0**-23 * size)
    kth = ref_trace["gaps"][..., -1]
    stats = {"rows": int(got.shape[0]), "rows_differ": int(differ.sum()),
             "row_match": float(1.0 - differ.mean()),
             "samples_parted": int(parted.sum()),
             "first_part_step_min_median": ([int(first[parted].min()), float(np.median(first[parted]))]
                                            if parted.any() else None),
             "max_gap_at_part": float(gap[parted].max()) if parted.any() else None,
             "parted_beyond_gap_tol": int((parted & (gap > gap_tol)).sum()),
             "steps_explained": int((parted & step_ok).sum()),
             "max_score_drift": float(drift.max()), "max_drift_over_score_tol": float((drift / score_tol).max()),
             "max_step_err": float(step_err.max()), "max_step_err_over_tol": float((step_err / step_tol).max()),
             "rows_differ_by_choice_only": int(choice_only.sum()),
             "max_choice_gap_of_those": float(choice_gap[choice_only].max()) if choice_only.any() else None,
             "median_kth_gap": float(kth[kth < 1e29].median()),
             "ref_rows_ended": int((ref == END_ID).any(axis=1).sum()),
             "ref_distinct_tokens": int(len(np.unique(ref))), "gap_tol": gap_tol,
             "min_row_match": BEAM_MIN_ROW_MATCH[dtype], "min_distinct_tokens": BEAM_MIN_DISTINCT}
    ok = bool(step_ok.all() and choice_ok.all() and (drift <= score_tol).all() and (step_err <= step_tol).all())
    ok = ok and stats["row_match"] >= BEAM_MIN_ROW_MATCH[dtype]
    ok = ok and 0 < stats["ref_rows_ended"] and stats["ref_distinct_tokens"] >= BEAM_MIN_DISTINCT
    return ok, stats


def _beam_decoders(kind: str, model, inp, dtype, cfg):
    """(kernel beam decode, plain beam decode, kernel beam decode through a
    given beam-step function) of one memory kind: functions of a config and
    a trace dict, each giving (tokens, scores)."""
    from img2latex_tpu_torch.ops import beam_decode as bd
    from img2latex_tpu_torch.ops import decode_step as ds
    from img2latex_tpu_torch.ops import grid_decode as gd

    packed = ds.pack_decoder_weights(model.decoder, dtype)
    if kind == "vector":
        ctx = inp.to(dtype)
        return (lambda c=cfg, trace=None: bd.beam_decode(packed, ctx, BEAM, c, trace=trace),
                lambda c=cfg, trace=None: bd.beam_decode_plain(packed, ctx, BEAM, c, trace=trace),
                lambda step, trace: bd._vector(ds.lstm_layer_step, step, packed, ctx, BEAM, cfg, trace=trace))
    att = gd.pack_attention_weights(model.decoder, dtype)
    mem = inp.to(dtype)
    u = gd.grid_memory_proj(att, mem)
    return (lambda c=cfg, trace=None: gd.grid_beam_decode(packed, att, mem, u, BEAM, c, trace=trace),
            lambda c=cfg, trace=None: gd.grid_beam_decode_plain(packed, att, mem, u, BEAM, c, trace=trace),
            lambda step, trace: gd._grid_beam(ds.lstm_layer_step, step, gd.attend_step, packed, att, mem, u,
                                              BEAM, cfg, trace=trace))


def _broken_beam_step(mode: str):
    """The beam_step wrapper broken from step 10 on: "gather" swaps the
    gathered h of beams 1 and 2, "parent" records each sample's parents
    rotated, "score" adds 5e-3 to beam 0's score."""
    from img2latex_tpu_torch.ops.beam_decode import beam_step

    def step(h, w_out, b_out, scores, finished, tokens, tok_hist, par_hist, t, K, *rest):
        beam_step(h, w_out, b_out, scores, finished, tokens, tok_hist, par_hist, t, K, *rest)
        if t < 10:
            return
        h_dst = rest[3]
        if mode == "gather":
            h_dst[:, 1::K], h_dst[:, 2::K] = h_dst[:, 2::K].clone(), h_dst[:, 1::K].clone()
        elif mode == "parent":
            par_hist[t] = par_hist[t].view(-1, K).roll(1, dims=1).reshape(-1)
        else:
            scores[0::K] += 5e-3

    return step


def _check_beams(what: str, tokens, scores, ref, ref_scores, got_trace, ref_trace, dtype: str,
                 logp_tol=None) -> None:
    """Shape, finite scores, the beam rule (log-probability limit
    ``logp_tol``, by default BEAM_LOGP_TOL's), and selection scores within
    the score tolerance on the rows whose tokens are equal."""
    import torch

    check(tuple(tokens.shape) == (BATCH, MAX_LEN) and tokens.dtype == torch.int32, f"{what}: output")
    check(bool(torch.isfinite(scores).all()), f"{what}: non-finite scores")
    ok, stats = compare_beams(tokens.cpu().numpy(), ref.cpu().numpy(), got_trace, ref_trace, dtype,
                              BEAM_LOGP_TOL[dtype] if logp_tol is None else logp_tol)
    same = (tokens == ref).all(dim=1)
    d = (scores - ref_scores).abs()[same]
    tol = SCORE_ATOL[dtype] + SCORE_RTOL * ref_scores.abs()[same]
    stats["score_max_abs_err"] = d.max().item() if d.numel() else None
    stats["score_max_err_over_tol"] = (d / tol).max().item() if d.numel() else None
    log(f"{what}: {json.dumps(stats)}")
    check(ok and bool((d <= tol).all()), f"{what} disagrees with its plain version")


def phase_beam_decode(models, card: str) -> None:
    """Both memory kinds, K = BEAM, T = MAX_LEN, B = BATCH, length penalty
    LENGTH_PENALTY: the whole beam decode against its plain version step by
    step in both types; early exit on a model whose rows all end; the time of
    each kind's decode in bf16."""
    import dataclasses

    import torch

    from img2latex_tpu_torch.decoding.decode import DecodeConfig
    from img2latex_tpu_torch.ops.beam_decode import beam_step

    cfg = DecodeConfig(max_length=MAX_LEN, start_id=1, end_id=END_ID, pad_id=0, beam_size=BEAM,
                       length_penalty=LENGTH_PENALTY)
    for kind, (model, inp) in models.items():
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            kernel, plain, through = _beam_decoders(kind, model, inp, dtype, cfg)
            got_trace, ref_trace = {}, {}
            n0 = beam_step.cluster_tc_launches
            tokens, scores = kernel(trace=got_trace)
            check((beam_step.cluster_tc_launches > n0) == (name == "bfloat16"),
                  f"beam_decode {kind} {name}: the tensor-core route ran {beam_step.cluster_tc_launches - n0} times")
            ref, ref_scores = plain(trace=ref_trace)
            _check_beams(f"beam_decode {kind} {name} K={BEAM} B={BATCH} T={MAX_LEN} length_penalty={LENGTH_PENALTY}",
                         tokens, scores, ref, ref_scores, got_trace, ref_trace, name)
        # the rule fails a decode whose beam step is broken (bf16, the loosest limits)
        for mode in ("gather", "parent", "score"):
            broken_trace = {}
            broken, _ = through(_broken_beam_step(mode), broken_trace)
            ok, stats = compare_beams(broken.cpu().numpy(), ref.cpu().numpy(), broken_trace, ref_trace, name,
                                      BEAM_LOGP_TOL[name])
            log(f"beam rule against a beam step broken from step 10 on ({mode}), {kind} {name}: fails "
                f"{not ok}; " + json.dumps({k: stats[k] for k in ("row_match", "samples_parted", "steps_explained",
                                                                  "max_step_err_over_tol", "max_drift_over_score_tol")}))
            check(not ok, f"the beam rule passes a decode whose beam step is broken ({mode}, {kind})")
        ms_k = time_ms(kernel, iters=3, warmup=1)
        ms_p = time_ms(plain, iters=2, warmup=1)
        log(f"{kind} beam decode bf16 B={BATCH} K={BEAM} T={MAX_LEN}: kernels {ms_k:.3f} ms, plain {ms_p:.3f} ms "
            f"[{card}]")
        # early exit on a model whose rows all end
        out = model.decoder.cell.out
        saved = (out.weight.detach().clone(), out.bias.detach().clone())
        try:
            _make_rows_end(kind, model, inp, lambda: _decoders(kind, model, inp, torch.bfloat16)[0]())
            with torch.no_grad():  # END a little stronger, so that every beam, not only the best, ends
                out.bias[END_ID] += 1.0
            kernel = _beam_decoders(kind, model, inp, torch.bfloat16, cfg)[0]
            full, full_scores = kernel()
            n0 = beam_step.launches
            early, early_scores = kernel(dataclasses.replace(cfg, early_exit=True))
            steps = beam_step.launches - n0
            ended = (full == END_ID).any(dim=1)
            log(f"beam early exit {kind} bf16 B={BATCH}: {int(ended.sum())}/{BATCH} best beams end, {steps} of "
                f"{MAX_LEN} steps run; tokens equal to the full loop: {bool(torch.equal(early, full))}")
            check(torch.equal(early, full) and torch.equal(early_scores, full_scores),
                  f"beam early exit {kind}: differs from the full loop")
            check(steps < MAX_LEN, f"beam early exit {kind}: ran all {steps} steps")
        finally:
            with torch.no_grad():
                out.weight.copy_(saved[0])
                out.bias.copy_(saved[1])


def _tune_end_bias(model, ended_share, share: float = 0.5) -> float:
    """Set END's vocab bias, by bisection within 4 of the drawn one, to where
    the share of rows ``ended_share()`` reports is nearest ``share``.
    Returns that share."""
    import torch

    out = model.decoder.cell.out
    with torch.no_grad():
        lo, hi = out.bias[END_ID].item() - 4.0, out.bias[END_ID].item() + 4.0
        best = (float("inf"), hi, 1.0)
        for _ in range(10):
            mid = (lo + hi) / 2
            out.bias[END_ID] = mid
            got = ended_share()
            best = min(best, (abs(got - share), mid, got))
            lo, hi = (lo, mid) if got > share else (mid, hi)
        out.bias[END_ID] = best[1]
    return best[2]


def stroke_canvases(rng, widths):
    """White canvases with 40-200 gray strokes (rectangles of 1-24 x 1-12
    pixels) left of each canvas's width, as a formula's glyphs: columns, and
    canvases, differ in where the ink is."""
    canvases = []
    for w in widths:
        img = np.full((IMG_H, IMG_W, 1), 255, np.uint8)
        for _ in range(rng.integers(40, 201)):
            x, y = rng.integers(0, w), rng.integers(0, IMG_H)
            img[y:y + rng.integers(1, 13), x:min(x + rng.integers(1, 25), w)] = rng.integers(0, 129)
        canvases.append(img)
    return canvases


def phase_grid_beam_end_to_end(dev, card, gcfg, gmodel, tokenizer, images, kernels) -> None:
    """Grid Predictor.predict_batch with beam 5 (length penalty 2.0) and with
    selective beam at frac 0.2 (signal "margin"), at full width in bf16, on
    stroke canvases; the first batch is held against the plain path step by
    step.  With random weights the memories of canvases differ little (their
    spread across a batch is ~0.08, against ~1.5 for phase 8's random
    memories), and the best beams use 3-6 tokens, all the same across rows,
    so the grid head is scaled by HEAD_GAIN; and END's bias is set
    (:func:`_tune_end_bias`) to where about half of the first batch's best
    beams end (with the drawn bias either all or none end)."""
    import torch
    import torch.nn.functional as F

    from img2latex_tpu_torch.decoding.decode import DecodeConfig
    from img2latex_tpu_torch.ops.beam_decode import beam_step
    from img2latex_tpu_torch.ops.conv1_phase import conv1_pool, conv1_pool_plain
    from img2latex_tpu_torch.ops.decode_step import lstm_layer_step, pack_decoder_weights, vocab_argmax_step
    from img2latex_tpu_torch.ops.grid_decode import (
        attend_step, grid_beam_decode, grid_beam_decode_plain, grid_memory_proj, pack_attention_weights,
    )
    from img2latex_tpu_torch.ops.preprocess import normalize_images
    from img2latex_tpu_torch.training.predictor import Predictor

    canv = np.stack(images[:BATCH])
    bcfg = DecodeConfig(max_length=MAX_LEN, start_id=1, end_id=END_ID, pad_id=0, beam_size=BEAM,
                        length_penalty=LENGTH_PENALTY)
    params = (gmodel.encoder.head.weight, gmodel.encoder.head.bias, gmodel.decoder.cell.out.bias)
    saved = [p.detach().clone() for p in params]
    try:
        with torch.no_grad():
            for p in params[:2]:
                p.mul_(HEAD_GAIN)
            x = normalize_images(torch.from_numpy(canv).to(dev), dtype=torch.bfloat16)
            mem = gmodel.encode(x)
            att = pack_attention_weights(gmodel.decoder, torch.bfloat16)
            u = grid_memory_proj(att, mem)

        def ended_share():
            tokens, _ = grid_beam_decode(pack_decoder_weights(gmodel.decoder, torch.bfloat16), att, mem, u, BEAM,
                                         bcfg)
            return float((tokens == END_ID).any(dim=1).float().mean())

        share = _tune_end_bias(gmodel, ended_share)
        log(f"grid beam end to end: grid head x {HEAD_GAIN}, memory spread across the batch "
            f"{mem.float().std(dim=0).mean().item():.3f}; END's vocab bias moved by "
            f"{(params[2][END_ID] - saved[2][END_ID]).item():+.4f}, {share:.3f} of the first batch's best beams end")
        pred = Predictor(gcfg, gmodel, tokenizer, batch_size=BATCH)
        modes = {"beam": dict(beam_size=BEAM, length_penalty=LENGTH_PENALTY),
                 "selective": dict(beam_size=BEAM, length_penalty=LENGTH_PENALTY, selective_beam_frac=SELECTIVE_FRAC)}
        counters = (conv1_pool, attend_step, lstm_layer_step, vocab_argmax_step, beam_step)
        for mode, kw in modes.items():
            pred.predict_batch(images[:BATCH], return_ids=True, **kw)  # warm-up
            torch.cuda.synchronize()
            for k in counters:
                k.launches = 0
            beam_step.cluster_tc_launches = conv1_pool.tc_launches = 0
            t0 = time.perf_counter()
            ids = pred.predict_batch(images, return_ids=True, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in counters}
            launches["beam_step.cluster_tc"] = beam_step.cluster_tc_launches
            launches["conv1_pool.tc"] = conv1_pool.tc_launches
            log(f"grid predict_batch, {mode} (K={BEAM}, length_penalty={LENGTH_PENALTY}"
                f"{', frac ' + str(SELECTIVE_FRAC) + ', signal margin' if mode == 'selective' else ''}): "
                f"{N_IMAGES} images in {wall:.3f} s = {N_IMAGES / wall:.1f} images/s (batch {BATCH}, bf16, card {card}); "
                f"launches {json.dumps(launches)}")
            need = [k for k in launches if k != "vocab_argmax_step" or mode == "selective"]
            for name in need:
                check(launches[name] > 0, f"kernel {name} was not launched on the grid {mode} path")
            check(launches["beam_step.cluster_tc"] == launches["beam_step"],
                  f"the grid {mode} path ran beam_step off the tensor-core route")
            check(launches["conv1_pool.tc"] == launches["conv1_pool"],
                  f"the grid {mode} path ran conv1_pool off the tensor-core route")
            check(len(ids) == N_IMAGES and all(len(r) <= MAX_LEN for r in ids), f"grid {mode} predict_batch output")
            check(all(tokenizer.end_token_id not in r and all(0 <= t < VOCAB for t in r) for r in ids),
                  f"grid {mode} trimmed ids")
            if mode == "beam":
                kernels["beam_step"]["launches"] = launches["beam_step"]
                kernels[f"attend_step[rows_per_mem={BEAM}]"]["launches"] = launches["attend_step"]

        # the first batch against the plain path, and the rows selective beam changes
        dcfg = pred.decode_config(beam_size=BEAM, length_penalty=LENGTH_PENALTY)
        toks = pred.decode_canvases(canv, dcfg=dcfg)
        greedy = pred.decode_canvases(canv)
        sel = pred.decode_canvases(canv, dcfg=pred.decode_config(beam_size=BEAM, length_penalty=LENGTH_PENALTY,
                                                                 selective_beam_frac=SELECTIVE_FRAC))
        changed = (sel != greedy).any(axis=1)
        from_beam = (sel == toks).all(axis=1)
        log(f"grid selective beam, one batch of {BATCH}: {int(changed.sum())} rows differ from greedy "
            f"(<= ceil({SELECTIVE_FRAC} x {BATCH}) = {int(np.ceil(SELECTIVE_FRAC * BATCH))} rows beam-decoded); "
            f"{int((changed & from_beam).sum())} of them equal the full beam's tokens; "
            f"beam differs from greedy in {int((toks != greedy).any(axis=1).sum())} rows")
        check(int(changed.sum()) <= int(np.ceil(SELECTIVE_FRAC * BATCH)), "selective beam changed too many rows")
        enc = gmodel.encoder
        att, packed = pred.packed_attention(), pred.packed_decoder()
        with torch.no_grad():
            y = conv1_pool_plain(x, enc.convs[0].weight, enc.convs[0].bias)
            for conv in enc.convs[1:]:
                y = F.max_pool2d(F.relu(F.conv2d(y, conv.weight.to(y.dtype), conv.bias.to(y.dtype), padding=1)), 2)
            Bc, C, Hf, Wf = y.shape
            mem_ref = F.relu(F.linear(y.permute(0, 3, 2, 1).reshape(Bc, Wf, Hf * C), enc.head.weight.to(y.dtype),
                                      enc.head.bias.to(y.dtype)))
            got_trace, ref_trace = {}, {}
            got, got_scores = grid_beam_decode(packed, att, mem, u, BEAM, dcfg, trace=got_trace)
            ref, ref_scores = grid_beam_decode_plain(packed, att, mem_ref, grid_memory_proj(att, mem_ref), BEAM, dcfg,
                                                     trace=ref_trace)
        check(np.array_equal(got.cpu().numpy(), toks), "grid beam: predict_batch's tokens differ from the beam decode "
              "of its memory")
        _check_beams(f"grid beam end to end vs plain path ({BATCH} images)", got, got_scores, ref, ref_scores,
                     got_trace, ref_trace, "bfloat16", BEAM_E2E_LOGP_TOL)
        is_end = toks == END_ID
        check(bool((toks[np.cumsum(is_end, axis=1) - is_end > 0] == 0).all()), "grid beam: a token other than PAD follows END")

        # where a beam batch's decode time goes
        with torch.no_grad():
            ms_dec = time_ms(lambda: grid_beam_decode(packed, att, mem, u, BEAM, dcfg), iters=3, warmup=1)
            ms_dec_p = time_ms(lambda: grid_beam_decode_plain(packed, att, mem, u, BEAM, dcfg), iters=2, warmup=1)
        log(f"grid beam decode bf16 B={BATCH} K={BEAM} T={MAX_LEN}: kernels {ms_dec:.3f} ms, plain {ms_dec_p:.3f} ms [{card}]")
        log_profile(f"grid beam decode (B={BATCH}, K={BEAM}, bf16)", card,
                    lambda: grid_beam_decode(packed, att, mem, u, BEAM, dcfg))
    finally:
        with torch.no_grad():
            for p, v in zip(params, saved):
                p.copy_(v)


def compare_draws(got, ref, gaps, mass_gaps, dtype: str):
    """The sampling rule (see SAMPLE_GAP_TOL): ``got`` and ``ref`` are (B,
    T) tokens (or (B,) of one step), ``gaps`` and ``mass_gaps`` the plain
    version's distances to a knife edge, all numpy.  Returns (ok, stats)."""
    if got.ndim == 1:
        got, ref, gaps, mass_gaps = got[:, None], ref[:, None], gaps[:, None], mass_gaps[:, None]
    diff = got != ref
    rows = np.where(diff.any(axis=1))[0]
    first = diff.argmax(axis=1)
    g = np.array([gaps[r, first[r]] for r in rows])
    m = np.array([mass_gaps[r, first[r]] for r in rows])
    excused = (g <= SAMPLE_GAP_TOL[dtype]) | (m <= SAMPLE_MASS_TOL[dtype])
    finite = gaps[np.isfinite(gaps)]
    floor = SAMPLE_MIN_ROW_MATCH[dtype]
    stats = {"rows": int(got.shape[0]), "rows_differ": int(len(rows)),
             "row_match": float(1.0 - len(rows) / got.shape[0]),
             "rows_differ_at_gap": int((g <= SAMPLE_GAP_TOL[dtype]).sum()),
             "rows_differ_at_mass_gap": int((m <= SAMPLE_MASS_TOL[dtype]).sum()),
             "rows_differ_unexplained": int((~excused).sum()),
             "max_gap_at_first_diff": float(np.where(g <= SAMPLE_GAP_TOL[dtype], g, 0).max()) if len(rows) else None,
             "max_mass_gap_at_first_diff": float(np.where(m <= SAMPLE_MASS_TOL[dtype], m, 0).max()) if len(rows) else None,
             "median_gap": float(np.median(finite)) if finite.size else None,
             "ref_distinct_tokens": int(len(np.unique(ref))),
             "ref_rows_ended": int((ref == END_ID).any(axis=1).sum()),
             "gap_tol": SAMPLE_GAP_TOL[dtype], "mass_tol": SAMPLE_MASS_TOL[dtype], "min_row_match": floor}
    ok = bool(excused.all()) and stats["row_match"] >= floor
    return ok, stats


def _sample_step_operands(dev, rng, B, H, Vp, dtype):
    """Random vocab-sample-step operands at the main path's shapes: h, a
    vocab of VOCAB columns padded to Vp (w_out, b_out float32 with -1e30 on
    the padding), every 7th row finished."""
    import torch

    w = np.zeros((H, Vp), np.float32)
    w[:, :VOCAB] = rng.standard_normal((H, VOCAB), dtype=np.float32) * 3 / np.sqrt(H)
    b = np.full(Vp, -1e30, np.float32)
    b[:VOCAB] = rng.standard_normal(VOCAB, dtype=np.float32) * BIAS_STD
    return {"h": torch.from_numpy(rng.uniform(-1, 1, (B, H)).astype(np.float32)).to(dev, dtype),
            "w_out": torch.from_numpy(w).to(dev, dtype), "b_out": torch.from_numpy(b).to(dev),
            "fin": torch.from_numpy((np.arange(B) % 7 == 6).astype(np.int32)).to(dev)}


def _sample_step_run(step, op, t=3, out=None, **kw):
    """One sampling step on copies of the operands (into ``out`` when given)."""
    import torch

    B, dev = op["h"].shape[0], op["h"].device
    if out is None:
        out = dict(tok=torch.empty((B,), dtype=torch.int32, device=dev), fin=op["fin"].clone(),
                   out=torch.zeros((B, MAX_LEN), dtype=torch.int32, device=dev))
    step(op["h"], op["w_out"], op["b_out"], out["tok"], out["fin"], out["out"], t, END_ID, 0, **kw)
    return out


def phase_sample_step(dev, rng, card: str, kernels: dict) -> None:
    """vocab_sample_step against its plain version at B = BATCH, both widths
    and types, the four SAMPLE_SETTINGS (the temperature folded into the
    weights as the decode folds it), bf16 on both routes; its time and bound
    in bf16 on both routes, beside the cuBLAS product alone."""
    import torch

    from img2latex_tpu_torch.ops import decode_step as ds
    from img2latex_tpu_torch.ops.decode_step import fold_temperature, vocab_sample_step, vocab_sample_step_plain

    B, Vp = BATCH, 512
    worst, worst_bf16 = 0.0, 0.0
    for width, H in (("vector", HIDDEN), ("grid", GRID_HIDDEN)):
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            op0 = _sample_step_operands(dev, rng, B, H, Vp, dtype)
            for setting in SAMPLE_SETTINGS:
                kw = dict(setting)
                folded = fold_temperature({"w_out": op0["w_out"], "b_out": op0["b_out"]}, kw.pop("temperature", 1.0))
                op = dict(op0, w_out=folded["w_out"], b_out=folded["b_out"])
                seed = int(rng.integers(-(2**31), 2**31))
                gaps = torch.full((B, MAX_LEN), float("inf"), device=dev)
                mass = torch.full((B, MAX_LEN), float("inf"), device=dev)
                ref = _sample_step_run(vocab_sample_step_plain, op, seed=seed, gaps=gaps, mass_gaps=mass, **kw)
                for route, ctx in _routes(dtype):
                    with ctx():
                        plan = ds.sample_plan(B, H, Vp, kw.get("top_k", 0), dtype, kw.get("top_p", 0.0))
                        check(plan.route == route, f"vocab_sample_step: not the {route} route")
                        n0 = getattr(vocab_sample_step, f"{route}_launches")
                        got = _sample_step_run(vocab_sample_step, op, seed=seed, **kw)
                        check(getattr(vocab_sample_step, f"{route}_launches") == n0 + 1,
                              f"vocab_sample_step: {route} not launched")
                    ok, stats = compare_draws(got["tok"].cpu().numpy(), ref["tok"].cpu().numpy(),
                                              gaps[:, 3].cpu().numpy(), mass[:, 3].cpu().numpy(), "float32")
                    log(f"vocab_sample_step {width} H={H} {name} {route} B={B} {json.dumps(setting)}: "
                        f"{json.dumps({k: stats[k] for k in ('rows_differ', 'rows_differ_unexplained', 'max_gap_at_first_diff', 'max_mass_gap_at_first_diff', 'median_gap')})}")
                    check(ok and stats["rows_differ"] <= B // 100,
                          f"vocab_sample_step {width} {name} {route} {setting} disagrees with its plain version")
                    if stats["rows_differ"] == 0:
                        check(torch.equal(got["fin"], ref["fin"]) and torch.equal(got["out"], ref["out"]),
                              "vocab_sample_step: finished or out differ")
                    elif name == "float32":
                        worst = max(worst, stats["max_gap_at_first_diff"], stats["max_mass_gap_at_first_diff"])
                    elif route == "cluster_tc":
                        worst_bf16 = max(worst_bf16, stats["max_gap_at_first_diff"], stats["max_mass_gap_at_first_diff"])
                    if setting == dict(top_k=1):  # the argmax where it is unique
                        lg = op["h"].float() @ op["w_out"].float() + op["b_out"]
                        top2 = torch.topk(lg, 2, dim=-1).values
                        live = (op["fin"] == 0) & (top2[:, 0] > top2[:, 1])
                        check(torch.equal(got["tok"][live].long(), lg.argmax(-1)[live]), "vocab_sample_step top_k=1")
    # time, bound: the decode's setting, both widths and bf16 routes (the kernels line keeps the grid
    # path's tensor-core route); each setting alone by CUDA-graph replay
    for width, H in (("vector", HIDDEN), ("grid", GRID_HIDDEN)):
        op0 = _sample_step_operands(dev, rng, B, H, Vp, torch.bfloat16)
        folded = fold_temperature({"w_out": op0["w_out"], "b_out": op0["b_out"]}, SAMPLE["temperature"])
        op = dict(op0, w_out=folded["w_out"], b_out=folded["b_out"])
        kw = dict(top_k=SAMPLE["top_k"], top_p=SAMPLE["top_p"], seed=SAMPLE_SEED)
        out_k, out_p = _sample_step_run(vocab_sample_step, op, **kw), _sample_step_run(vocab_sample_step_plain, op, **kw)
        ms_k, ms_ke = both_ms(lambda: _sample_step_run(vocab_sample_step, op, out=out_k, **kw), iters=50)
        with block_route():
            ms_b, ms_be = both_ms(lambda: _sample_step_run(vocab_sample_step, op, out=out_k, **kw), iters=50)
        ms_y = _product_yardstick_ms(dev, B, H, Vp)
        # the plain version's random stream makes host-to-device copies (uniform_field's constants),
        # which a CUDA graph cannot capture: its time stays eager (plain_ms_method)
        ms_p = time_ms(lambda: _sample_step_run(vocab_sample_step_plain, op, out=out_p, **kw), iters=10)
        ms_each = {}
        for st in SAMPLE_SETTINGS:
            skw = dict(seed=SAMPLE_SEED, top_k=st.get("top_k", 0), top_p=st.get("top_p", 0.0))
            ms_each[json.dumps(st)] = graph_ms(lambda: _sample_step_run(vocab_sample_step, op, out=out_k, **skw))
            with block_route():
                ms_each[json.dumps(st) + " block"] = graph_ms(
                    lambda: _sample_step_run(vocab_sample_step, op, out=out_k, **skw))
        # h, W_out and b_out read, finished read and written, tokens and the out column written
        nbytes = B * H * 2 + H * Vp * 2 + Vp * 4 + B * 4 * 4
        flops = 2 * B * H * Vp
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        log(f"vocab_sample_step {width} bf16 B={B} H={H} Vp={Vp} {json.dumps(SAMPLE)}: tensor-core cluster kernel "
            f"{ms_k:.4f} ms (device, CUDA graph; eager {ms_ke:.4f}), CUDA-core block kernel {ms_b:.4f} ms (eager "
            f"{ms_be:.4f}), the product alone in cuBLAS (addmm bf16 {B}x{H}x{Vp}) {ms_y:.4f} ms, plain {ms_p:.4f} ms "
            f"(eager), bound {bnd:.4f} ms ({by}); each setting (ms, device, CUDA graph; the cluster kernel, then "
            f"the block kernel): {json.dumps({k: round(v, 4) for k, v in ms_each.items()})}; "
            f"no single PyTorch call applies top-k, renormalization, top-p and the draw [{card}]")
    kernels["vocab_sample_step"] = dict(
        name="vocab_sample_step", route="cuda", source="img2latex_tpu_torch/csrc/sample_step_tc.cu",
        replaces="img2latex_tpu/ops/pallas/grid_decode.py:665", max_abs_err=worst, max_abs_err_bf16=worst_bf16,
        ms=ms_k, ms_eager=ms_ke, plain_ms=ms_p, bound_ms=bnd, bound_by=by, library_ms=None, ms_method="cuda_graph",
        plain_ms_method="eager", parts={"block_route_ms": ms_b, "product_yardstick_ms": ms_y})


def phase_sample_draws(dev, rng) -> None:
    """The kernel's draws from one row's logits (vector width, float32) over
    BATCH rows and N_DRAWS_SEEDS seeds, for each of SAMPLE_SETTINGS: none
    outside the support of ``next_token_probs``, and a chi-square test of
    the counts over the support (p >= 1e-3)."""
    import torch
    from scipy import stats as sstats

    from img2latex_tpu_torch.decoding.decode import DecodeConfig, next_token_probs
    from img2latex_tpu_torch.ops.decode_step import fold_temperature, vocab_sample_step

    op0 = _sample_step_operands(dev, rng, BATCH, HIDDEN, 512, torch.float32)
    h = op0["h"][:1].expand(BATCH, HIDDEN).contiguous()
    for setting in SAMPLE_SETTINGS:
        kw = dict(setting)
        temp = kw.pop("temperature", 1.0)
        folded = fold_temperature({"w_out": op0["w_out"], "b_out": op0["b_out"]}, temp)
        tok = torch.empty((BATCH,), dtype=torch.int32, device=dev)
        counts = torch.zeros(512, dtype=torch.float64, device=dev)
        for s in range(N_DRAWS_SEEDS):
            vocab_sample_step(h, folded["w_out"], folded["b_out"], tok, None, None, 0, END_ID, 0,
                              seed=SAMPLE_SEED + 1000 * s, **kw)
            counts += torch.bincount(tok.long(), minlength=512).double()
        logits = (h[:1] @ op0["w_out"] + op0["b_out"])[:, :VOCAB]
        probs = next_token_probs(logits, DecodeConfig(temperature=temp, **kw))[0].double()
        support = probs > 0
        n = float(counts.sum())
        outside = float(counts[:VOCAB][~support].sum() + counts[VOCAB:].sum())
        if int(support.sum()) > 1:
            expected = (probs[support] / probs[support].sum() * n).cpu().numpy()
            p = float(sstats.chisquare(counts[:VOCAB][support].cpu().numpy(), expected).pvalue)
        else:
            p = 1.0 if outside == 0 else 0.0
        log(f"vocab_sample_step draws {json.dumps(setting)}: {int(n)} draws, support {int(support.sum())} tokens, "
            f"{int(outside)} outside it, chi-square p = {p:.4g} (limit 1e-3)")
        check(outside == 0 and p >= 1e-3, f"vocab_sample_step draws {setting} do not follow next_token_probs")


def _sample_decoders(kind: str, model, inp, dtype, setting, seed=SAMPLE_SEED):
    """(kernel sampling decode, plain sampling decode returning the gaps,
    kernel-LSTM decode through a given vocab step function) of one memory
    kind, each a function of keyword options."""
    from img2latex_tpu_torch.ops import decode_step as ds
    from img2latex_tpu_torch.ops import grid_decode as gd

    kw = dict(setting)
    top_k, temp = kw.pop("top_k", 0), kw.pop("temperature", 1.0)
    packed = ds.pack_decoder_weights(model.decoder, dtype)
    folded = ds.fold_temperature(packed, temp)
    if kind == "vector":
        ctx = inp.to(dtype)
        return (lambda **o: ds.sample_decode(packed, ctx, MAX_LEN, 1, END_ID, 0, top_k, seed, temp, **kw, **o),
                lambda **o: ds.sample_decode_plain(packed, ctx, MAX_LEN, 1, END_ID, 0, top_k, seed, temp,
                                                   return_gaps=True, **kw, **o),
                lambda step: ds._vector(ds.lstm_layer_step, step, folded, ctx, MAX_LEN, 1, END_ID, 0))
    att = gd.pack_attention_weights(model.decoder, dtype)
    mem = inp.to(dtype)
    u = gd.grid_memory_proj(att, mem)
    tile = gd.auto_tile(packed, att, mem.shape[1], batch=mem.shape[0])
    return (lambda **o: gd.grid_sample_decode(packed, att, mem, u, MAX_LEN, 1, END_ID, 0, top_k, seed, temp, **kw, **o),
            lambda **o: gd.grid_sample_decode_plain(packed, att, mem, u, MAX_LEN, 1, END_ID, 0, top_k, seed, temp,
                                                    return_gaps=True, **kw, **o),
            lambda step: gd._grid(ds.lstm_layer_step, functools.partial(step, tile=tile), gd.attend_step,
                                  folded, att, mem, u, MAX_LEN, 1, END_ID, 0, False))


def _broken_sample_step(mode: str, setting, seed=SAMPLE_SEED):
    """A vocab step that draws as the plain version but broken: "row" hashes
    each row with the next row's index, "top_k" keeps k + 1 tokens, "nucleus"
    never draws the nucleus's first (most probable) token."""
    import torch

    from img2latex_tpu_torch.ops.decode_step import BATCH_TILE, sample_tokens, uniform_field

    top_k, top_p = setting.get("top_k", 0), setting.get("top_p", 0.0)

    def step(h, w_out, b_out, tokens, finished, out, t, end_id, pad_id, tile=BATCH_TILE):
        logits = h.float() @ w_out.float() + b_out
        B, Vp = logits.shape
        u = uniform_field(seed, t, B + (mode == "row"), Vp, tile, device=h.device)[(mode == "row"):]
        if mode == "nucleus":  # u = 0: -log(-log u) = -inf, the token never wins the draw
            u = u.scatter(1, logits.argmax(dim=-1, keepdim=True), 0.0)
        nxt = sample_tokens(logits, u, top_k + (mode == "top_k"), top_p)[0]
        nxt = torch.where(finished.bool(), torch.full_like(nxt, pad_id), nxt)
        finished.copy_(torch.maximum(finished, (nxt == end_id).to(torch.int32)))
        tokens.copy_(nxt)
        out[:, t] = nxt

    return step


def phase_sample_decode(models, card: str) -> None:
    """Both memory kinds, B = BATCH, T = MAX_LEN: the whole sampling decode
    against its plain version (same seed) under the sampling rule, in both
    types with SAMPLE and in float32 with top-p 0.9 alone; decodes through
    the three broken samplers fail the rule; early exit on a model whose rows
    all end gives the full loop's tokens; times in bf16."""
    import torch

    from img2latex_tpu_torch.ops.decode_step import vocab_sample_step

    for kind, (model, inp) in models.items():
        for setting, name, dtype in ((SAMPLE, "float32", torch.float32), (SAMPLE, "bfloat16", torch.bfloat16),
                                     (dict(top_p=0.9), "float32", torch.float32)):
            kernel, plain, through = _sample_decoders(kind, model, inp, dtype, setting)
            n0 = vocab_sample_step.cluster_tc_launches
            got = kernel()
            check((vocab_sample_step.cluster_tc_launches > n0) == (name == "bfloat16"),
                  f"sample_decode {kind} {name}: the tensor-core route ran "
                  f"{vocab_sample_step.cluster_tc_launches - n0} times")
            ref, gaps, mass = plain()
            check(tuple(got.shape) == (BATCH, MAX_LEN) and got.dtype == torch.int32, "sample decode output")
            ok, stats = compare_draws(got.cpu().numpy(), ref.cpu().numpy(), gaps.cpu().numpy(), mass.cpu().numpy(),
                                      name)
            what = f"sample_decode {kind} {name} B={BATCH} T={MAX_LEN} {json.dumps(setting)}"
            log(f"{what}: {json.dumps(stats)}")
            check(ok and stats["ref_rows_ended"] > 0 and stats["ref_distinct_tokens"] >= 10, f"{what} disagrees")
            if setting is SAMPLE:  # the rule fails decodes through a broken sampler
                for mode in ("row", "top_k", "nucleus"):
                    broken = through(_broken_sample_step(mode, setting))
                    bad, bstats = compare_draws(broken.cpu().numpy(), ref.cpu().numpy(), gaps.cpu().numpy(),
                                                mass.cpu().numpy(), name)
                    log(f"sampling rule against a broken sampler ({mode}), {kind} {name}: fails {not bad}; "
                        + json.dumps({k: bstats[k] for k in ("row_match", "rows_differ_unexplained")}))
                    check(not bad, f"the sampling rule passes a decode through a broken sampler ({mode}, {kind})")
        kernel, plain, _ = _sample_decoders(kind, model, inp, torch.bfloat16, SAMPLE)
        ms_k = time_ms(kernel, iters=3, warmup=1)
        ms_p = time_ms(plain, iters=2, warmup=1)
        log(f"{kind} sample decode bf16 B={BATCH} T={MAX_LEN} {json.dumps(SAMPLE)}: kernels {ms_k:.3f} ms, "
            f"plain {ms_p:.3f} ms [{card}]")
        # early exit on a model whose rows all end
        out = model.decoder.cell.out
        saved = (out.weight.detach().clone(), out.bias.detach().clone())
        try:
            _make_rows_end(kind, model, inp, lambda: _sample_decoders(kind, model, inp, torch.bfloat16, SAMPLE)[0]())
            with torch.no_grad():  # END a little stronger: the least bias that ends every row ends one late
                out.bias[END_ID] += 1.0
            kernel = _sample_decoders(kind, model, inp, torch.bfloat16, SAMPLE)[0]
            full = kernel()
            n0 = vocab_sample_step.launches
            early = kernel(early_exit=True)
            steps = vocab_sample_step.launches - n0
            end_at = (full == END_ID).int().argmax(dim=1).float()
            log(f"sample early exit {kind} bf16 B={BATCH}: rows end at steps {int(end_at.min())}..{int(end_at.max())}, "
                f"{steps} of {MAX_LEN} steps run; tokens equal to the full loop: {bool(torch.equal(early, full))}")
            check(bool((full == END_ID).any(dim=1).all()), f"sample early exit {kind}: not every row ends")
            check(torch.equal(early, full) and steps < MAX_LEN, f"sample early exit {kind}: differs or ran every step")
        finally:
            with torch.no_grad():
                out.weight.copy_(saved[0])
                out.bias.copy_(saved[1])


def phase_grid_sample_end_to_end(dev, card, gcfg, gmodel, tokenizer, images, kernels) -> None:
    """Grid Predictor.predict_batch with SAMPLE at full width in bf16 on the
    grid greedy phase's canvases: images/s, the launches, a torch.profiler
    split of one decode; the first batch equals the sampling decode of its
    memory with the batch's seed, and holds against the plain path under
    the sampling rule."""
    import torch
    import torch.nn.functional as F

    from img2latex_tpu_torch.ops.conv1_phase import conv1_pool, conv1_pool_plain
    from img2latex_tpu_torch.ops.decode_step import lstm_layer_step, vocab_argmax_step, vocab_sample_step
    from img2latex_tpu_torch.ops.grid_decode import (
        attend_step, grid_memory_proj, grid_sample_decode, grid_sample_decode_plain,
    )
    from img2latex_tpu_torch.ops.preprocess import normalize_images
    from img2latex_tpu_torch.training.predictor import Predictor, batch_seed

    pred = Predictor(gcfg, gmodel, tokenizer, batch_size=BATCH)
    pred.predict_batch(images[:BATCH], return_ids=True, **SAMPLE)  # warm-up
    torch.cuda.synchronize()
    counters = (conv1_pool, attend_step, lstm_layer_step, vocab_sample_step, vocab_argmax_step)
    for k in counters:
        k.launches = 0
    vocab_sample_step.cluster_tc_launches = conv1_pool.tc_launches = 0
    t0 = time.perf_counter()
    ids = pred.predict_batch(images, return_ids=True, seed=SAMPLE_SEED, **SAMPLE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in counters}
    launches["vocab_sample_step.cluster_tc"] = vocab_sample_step.cluster_tc_launches
    launches["conv1_pool.tc"] = conv1_pool.tc_launches
    log(f"grid predict_batch, sampling {json.dumps(SAMPLE)}: {N_IMAGES} images in {wall:.3f} s = "
        f"{N_IMAGES / wall:.1f} images/s (batch {BATCH}, bf16, card {card}); launches {json.dumps(launches)}")
    for name in ("conv1_pool", "attend_step", "lstm_layer_step", "vocab_sample_step"):
        check(launches[name] > 0, f"kernel {name} was not launched on the grid sampling path")
    check(launches["vocab_argmax_step"] == 0, "the sampling path launched the argmax kernel")
    check(launches["vocab_sample_step.cluster_tc"] == launches["vocab_sample_step"],
          "the grid sampling path ran vocab_sample_step off the tensor-core route")
    check(launches["conv1_pool.tc"] == launches["conv1_pool"], "the grid sampling path ran conv1_pool off the tensor-core route")
    kernels["vocab_sample_step"]["launches"] = launches["vocab_sample_step"]
    check(len(ids) == N_IMAGES and all(len(r) <= MAX_LEN for r in ids), "grid sampling predict_batch output")
    check(all(tokenizer.end_token_id not in r and all(0 <= t < VOCAB for t in r) for r in ids),
          "grid sampling trimmed ids")
    check(len({t for r in ids for t in r}) >= 10, "grid sampling ids use fewer than 10 tokens")

    canv = np.stack(images[:BATCH])
    dcfg = pred.decode_config(**SAMPLE)
    seed = batch_seed(SAMPLE_SEED, 0)
    toks = pred.decode_canvases(canv, dcfg=dcfg, seed=seed)
    is_end = toks == END_ID
    check(bool((toks[np.cumsum(is_end, axis=1) - is_end > 0] == 0).all()), "grid sampling: a token other than PAD follows END")
    enc = gmodel.encoder
    att, packed = pred.packed_attention(), pred.packed_decoder()
    kw = dict(top_p=SAMPLE["top_p"], temperature=SAMPLE["temperature"])
    with torch.no_grad():
        x = normalize_images(torch.from_numpy(canv).to(dev), dtype=torch.bfloat16)
        mem = gmodel.encode(x)
        u = grid_memory_proj(att, mem)
        got = grid_sample_decode(packed, att, mem, u, MAX_LEN, 1, END_ID, 0, SAMPLE["top_k"], seed, **kw)
        y = conv1_pool_plain(x, enc.convs[0].weight, enc.convs[0].bias)
        for conv in enc.convs[1:]:
            y = F.max_pool2d(F.relu(F.conv2d(y, conv.weight.to(y.dtype), conv.bias.to(y.dtype), padding=1)), 2)
        Bc, C, Hf, Wf = y.shape
        mem_ref = F.relu(F.linear(y.permute(0, 3, 2, 1).reshape(Bc, Wf, Hf * C), enc.head.weight.to(y.dtype),
                                  enc.head.bias.to(y.dtype)))
        ref, gaps, mass = grid_sample_decode_plain(packed, att, mem_ref, grid_memory_proj(att, mem_ref), MAX_LEN, 1,
                                                   END_ID, 0, SAMPLE["top_k"], seed, return_gaps=True, **kw)
    check(np.array_equal(got.cpu().numpy(), toks), "grid sampling: predict_batch's tokens differ from the decode of its memory")
    ok, stats = compare_draws(toks, ref.cpu().numpy(), gaps.cpu().numpy(), mass.cpu().numpy(), "bfloat16")
    log(f"grid sampling end to end vs plain path ({BATCH} images): {json.dumps(stats)}")
    check(ok, "grid sampling end-to-end output disagrees with the plain path")
    with torch.no_grad():
        ms_dec = time_ms(lambda: grid_sample_decode(packed, att, mem, u, MAX_LEN, 1, END_ID, 0, SAMPLE["top_k"], seed,
                                                    **kw), iters=3, warmup=1)
    log(f"grid sample decode bf16 B={BATCH} T={MAX_LEN}: kernels {ms_dec:.3f} ms [{card}]")
    log_profile(f"grid sample decode (B={BATCH}, bf16, {json.dumps(SAMPLE)})", card,
                lambda: grid_sample_decode(packed, att, mem, u, MAX_LEN, 1, END_ID, 0, SAMPLE["top_k"], seed, **kw))


# ---------------------------------------------------------------------------
# Training (bench_train.py's shapes): lstm_seq, the conv1 backward, the train
# step, Trainer.train() with a checkpoint, and a grid-memory train step.
# ---------------------------------------------------------------------------
TRAIN_BATCH = 128              # bench_train.py's batch
TRAIN_T = MAX_LEN - 1          # LSTM steps of a teacher-forced pass (inputs are targets[:, :-1])
TRAIN_DROPOUT, TRAIN_SMOOTHING, TRAIN_CLIP, TRAIN_LR = 0.3, 0.1, 5.0, 1e-3
TRAIN_STEPS_TIMED = 20
LSTM_NAMES = ("ys", "hT", "cT", "dgates_x", "dh0", "dc0", "dW_hh")
# Every training tolerance is on max |got - ref| / max |ref| of one tensor.
# lstm_seq against its plain versions (lstm_seq_fwd_plain / lstm_seq_bwd_plain,
# the kernels' rounding points): float32 sums of up to T*B = 17920 terms in
# another order; in bf16 a stored value that rounds the other way moves the
# later steps by a rounding step (2^-8 relative), so 4 steps.
LSTM_TOL = {"float32": 1e-4, "bfloat16": 2.0**-6}
# lstm_seq against lstm_seq_plain differentiated by autograd, which rounds the
# dh and dc carries to the compute type at each of the T steps where the
# kernel carries them in float32: in bf16 ~sqrt(T) rounding steps of 2^-9.
LSTM_ORACLE_TOL = {"float32": 1e-4, "bfloat16": 2.0**-4}
# conv1_pool's backward is autograd of conv1_pool_plain on both paths; cuDNN's
# gradients sum in an order that may change from call to call, and in bf16 a
# float32 dx may then round to the neighbouring bf16 value (2^-8 of it).
CONV_BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
# The block-0 weight's gradient through the whole encoder, kernel forward vs
# plain forward: bf16 activations downstream of a rounding flip.
ENC_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0**-5}
# The train step, kernel path vs plain path (lstm_seq_plain, conv1_pool_plain)
# from the same weights, batch and dropout seed, bf16: the loss is a forward
# whose only difference is the order of float32 sums; the gradients differ
# by lstm_seq_plain's bf16 carries (LSTM_ORACLE_TOL) through every layer.
STEP_LOSS_RTOL = 1e-3
STEP_GRAD_TOL = 2.0**-3
STEP_GNORM_RTOL = 2e-2
# Adam's first update is ~lr * sign(g): where a gradient is near 0 the two
# paths may step apart by up to 2 lr; most elements must agree within lr/10.
STEP_PARAM_ATOL = 2.0 * TRAIN_LR * 1.01
STEP_PARAM_FAR_SHARE = 0.01


def train_config(memory: str = "vector"):
    """bench_train.py's configuration (vector) or the grid flagship's width,
    bf16, dropout 0.3, label smoothing 0.1, clip 5.0."""
    from img2latex_tpu_torch.config import Config

    cfg = grid_config() if memory == "grid" else Config()
    if memory != "grid":
        cfg.model.embedding_dim = EMBED
        cfg.model.decoder.hidden_dim = HIDDEN
        cfg.model.decoder.lstm_layers = LAYERS
        cfg.model.encoder.cnn.img_height, cfg.model.encoder.cnn.img_width = IMG_H, IMG_W
        cfg.model.encoder.cnn.conv_filters = list(FILTERS)
        cfg.data.max_seq_length = cfg.inference.max_length = MAX_LEN
        cfg.hardware.compute_dtype = "bfloat16"
    cfg.model.decoder.dropout = TRAIN_DROPOUT
    cfg.training.label_smoothing = TRAIN_SMOOTHING
    cfg.training.clip_grad_norm = TRAIN_CLIP
    cfg.training.learning_rate = TRAIN_LR
    cfg.data.batch_size = TRAIN_BATCH
    return cfg


@contextlib.contextmanager
def plain_path():
    """Run the model through the plain versions: lstm_seq_plain for the LSTM
    recurrence, conv1_pool_plain for block 0 and convblock_cf_plain for the
    channel-first chain's blocks.  Only the reference runs of this script
    ask for it."""
    from img2latex_tpu_torch.models import encoder as enc_mod
    from img2latex_tpu_torch.models import lstm as lstm_mod
    from img2latex_tpu_torch.ops.conv1_phase import conv1_pool_plain
    from img2latex_tpu_torch.ops.conv_cf import convblock_cf_plain
    from img2latex_tpu_torch.ops.lstm_train import lstm_seq_plain

    saved = enc_mod.conv1_pool, enc_mod.convblock_cf, lstm_mod.lstm_seq
    enc_mod.conv1_pool, enc_mod.convblock_cf, lstm_mod.lstm_seq = conv1_pool_plain, convblock_cf_plain, lstm_seq_plain
    try:
        yield
    finally:
        enc_mod.conv1_pool, enc_mod.convblock_cf, lstm_mod.lstm_seq = saved


@contextlib.contextmanager
def step_route():
    """Run bf16 lstm_seq by the per-step route (a launch a step from the
    host loop; seq_plan names the "step" route), for a before-and-after in
    one run.  dW_hh stays on the tensor cores."""
    from img2latex_tpu_torch.ops import lstm_train as lt

    saved = lt.seq_plan
    lt.seq_plan = lambda B, H, dtype: lt.SeqPlan(lt.SeqRoute("step"), lt.SeqRoute("step"))
    try:
        yield
    finally:
        lt.seq_plan = saved


@contextlib.contextmanager
def block_route():
    """Run bf16 vocab_sample_step and beam_step by the CUDA-core block kernels (the planners name
    the "block" route, as they do for float32), for the before-and-after in one run."""
    import torch

    from img2latex_tpu_torch.ops import beam_decode as bd
    from img2latex_tpu_torch.ops import decode_step as ds

    saved = ds.sample_plan, bd.beam_plan
    ds.sample_plan = lambda B, H, Vp, top_k, dtype, top_p=0.0: saved[0](B, H, Vp, top_k, torch.float32, top_p)
    bd.beam_plan = lambda B, K, H, Vp, dtype: saved[1](B, K, H, Vp, torch.float32)
    try:
        yield
    finally:
        ds.sample_plan, bd.beam_plan = saved


@contextlib.contextmanager
def core_route():
    """Run bf16 conv1_pool by the CUDA-core kernel (``conv1_plan`` names the route it names for
    float32), for the before-and-after in one run."""
    import torch

    from img2latex_tpu_torch.ops import conv1_phase as c1

    saved = c1.conv1_plan
    c1.conv1_plan = lambda B, H, W, Cout, dtype: saved(B, H, W, Cout, torch.float32)
    try:
        yield
    finally:
        c1.conv1_plan = saved


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, in float32."""
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30)).item()


def _lstm_operands(dev, rng, T, B, H, dtype, zero_state=False):
    import torch

    def mk(*shape, sc=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * sc).astype(np.float32)).to(dev, dtype)

    op = dict(gx=mk(T, B, 4 * H), h0=mk(B, H, sc=0.5), c0=mk(B, H, sc=0.5),
              w=mk(4 * H, H, sc=1.0 / np.sqrt(H)), dys=mk(T, B, H), dhT=mk(B, H), dcT=mk(B, H))
    if zero_state:
        op["h0"].zero_()
        op["c0"].zero_()
    return op


def _lstm_outputs_and_grads(fn, op):
    """(ys, hT, cT) of fn and the gradients of gates_x, h0, c0, w_hh under the
    cotangents of op."""
    import torch

    leaves = [op[k].clone().requires_grad_() for k in ("gx", "h0", "c0", "w")]
    outs = fn(*leaves)
    grads = torch.autograd.grad(outs, leaves, [op["dys"], op["dhT"], op["dcT"]])
    return [o.detach() for o in outs] + list(grads)


def _lstm_plain_pair(op):
    """The same seven tensors from lstm_seq_fwd_plain and lstm_seq_bwd_plain."""
    from img2latex_tpu_torch.ops.lstm_train import lstm_seq_bwd_plain, lstm_seq_fwd_plain

    ys, cs, ga = lstm_seq_fwd_plain(op["gx"], op["h0"], op["c0"], op["w"].t().contiguous())
    dgx, dh0, dc0, dw = lstm_seq_bwd_plain(op["dys"], op["dhT"], op["dcT"], ga, cs, op["h0"],
                                           op["c0"], ys, op["w"])
    return [ys, ys[-1], cs[-1], dgx, dh0, dc0, dw]


def phase_lstm_seq(dev, rng, card: str, kernels: dict, T=TRAIN_T, B=TRAIN_BATCH, H=HIDDEN,
                   odd=((3, 5, 40), (1, 3, HIDDEN), (9, 70, 33))) -> None:
    """lstm_seq forward and backward against both plain versions, at the
    train step's shapes and at odd ones (bf16: the persistent route, and at
    H = 33 the step route); then the times of one layer, the backward split
    into its recurrence and dW_hh, beside the per-step route and cuDNN."""
    import torch

    from img2latex_tpu_torch.ops import lstm_train as lt
    from img2latex_tpu_torch.ops.lstm_train import (
        _bwd_recurrence, lstm_seq, lstm_seq_bwd, lstm_seq_bwd_plain, lstm_seq_fwd, lstm_seq_fwd_plain, lstm_seq_plain,
        persist_shape, seq_plan)

    abs_err = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for shape in ((T, B, H),) + tuple(odd):
            op = _lstm_operands(dev, rng, *shape, dtype)
            got = _lstm_outputs_and_grads(lstm_seq, op)
            ref_a = _lstm_plain_pair(op)
            ref_b = _lstm_outputs_and_grads(lstm_seq_plain, op)
            ea = {n: rel_err(g, r) for n, g, r in zip(LSTM_NAMES, got, ref_a)}
            eb = {n: rel_err(g, r) for n, g, r in zip(LSTM_NAMES, got, ref_b)}
            log(f"lstm_seq {name} T,B,H={shape}: rel err vs its plain versions "
                f"{json.dumps({k: float(f'{v:.3g}') for k, v in ea.items()})} (tol {LSTM_TOL[name]:.3g}); "
                f"vs lstm_seq_plain (autograd) {json.dumps({k: float(f'{v:.3g}') for k, v in eb.items()})} "
                f"(tol {LSTM_ORACLE_TOL[name]:.3g})")
            check(max(ea.values()) <= LSTM_TOL[name], f"lstm_seq {name} {shape} vs its plain versions: {ea}")
            check(max(eb.values()) <= LSTM_ORACLE_TOL[name], f"lstm_seq {name} {shape} vs lstm_seq_plain: {eb}")
            check(all(torch.isfinite(g.float()).all().item() for g in got), f"lstm_seq {name} {shape}: non-finite")
            if shape == (T, B, H):
                sfx = "" if name == "float32" else "_bf16"
                abs_err["fwd" + sfx] = max((g.float() - r.float()).abs().max().item() for g, r in zip(got[:3], ref_a[:3]))
                abs_err["bwd" + sfx] = max((g.float() - r.float()).abs().max().item() for g, r in zip(got[3:], ref_a[3:]))

    # one layer's times at the train step's shapes, bf16
    op = _lstm_operands(dev, rng, T, B, H, torch.bfloat16)
    gx, h0, c0, w = op["gx"], op["h0"], op["c0"], op["w"]
    wt = w.t().contiguous()
    plan = seq_plan(B, H, torch.bfloat16)
    shapes = {d: persist_shape(B, H, r, d) for d, r in (("fwd", plan.fwd), ("bwd", plan.bwd))
              if r.route == "persistent"}
    log(f"lstm_seq bf16 B={B} H={H}: seq_plan {plan}; persistent launches as the library sees them "
        f"{json.dumps(shapes)} (max_active_clusters: cudaOccupancyMaxActiveClusters) [{card}]")
    check(plan.fwd.route == plan.bwd.route == "persistent", f"lstm_seq at B={B}, H={H}: not the persistent route")
    ys, cs, ga = lstm_seq_fwd(gx, h0, c0, wt)
    bwd_args = (op["dys"], op["dhT"], op["dcT"], ga, cs, h0, c0, ys, w)
    n_f, n_b = lstm_seq_fwd.persistent_launches, lstm_seq_bwd.persistent_launches
    dgx, _, _ = _bwd_recurrence(op["dys"], op["dhT"], op["dcT"], ga, cs, c0, w)
    ms_f = time_ms(lambda: lstm_seq_fwd(gx, h0, c0, wt), iters=20, warmup=2)
    ms_b = time_ms(lambda: lstm_seq_bwd(*bwd_args), iters=20, warmup=2)
    ms_rec = time_ms(lambda: _bwd_recurrence(op["dys"], op["dhT"], op["dcT"], ga, cs, c0, w), iters=20, warmup=2)
    ms_dw = time_ms(lambda: lt._dw_hh(dgx, h0, ys, w), iters=20, warmup=2)
    check(lstm_seq_fwd.persistent_launches > n_f and lstm_seq_bwd.persistent_launches > n_b,
          "lstm_seq: the persistent kernels were not launched")
    with step_route():  # the per-step kernels on the same operands, in this run
        ms_f_step = time_ms(lambda: lstm_seq_fwd(gx, h0, c0, wt), iters=5, warmup=1)
        ms_b_step = time_ms(lambda: lstm_seq_bwd(*bwd_args), iters=5, warmup=1)
    ms_fp = time_ms(lambda: lstm_seq_fwd_plain(gx, h0, c0, wt), iters=2, warmup=1)
    ms_bp = time_ms(lambda: lstm_seq_bwd_plain(*bwd_args), iters=2, warmup=1)
    # the library call: one cuDNN layer, which also computes its input projection; beside it the
    # same work on the port's path: the projection's torch.matmul, then lstm_seq
    cudnn = torch.nn.LSTM(H, H, device=dev, dtype=torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((T, B, H), dtype=np.float32)).to(dev, torch.bfloat16)
    x.requires_grad_()
    w_ih = cudnn.weight_ih_l0.detach().clone().requires_grad_()
    w_hh = cudnn.weight_hh_l0.detach().clone().requires_grad_()
    bias = (cudnn.bias_ih_l0 + cudnn.bias_hh_l0).detach().clone().requires_grad_()
    z = torch.zeros(B, H, device=dev, dtype=torch.bfloat16)

    def cudnn_fwd_bwd():
        y, _ = cudnn(x)
        y.backward(op["dys"])

    def port_fwd():
        return lstm_seq(torch.matmul(x, w_ih.t()) + bias, z, z, w_hh)[0]

    def port_fwd_bwd():
        port_fwd().backward(op["dys"])

    with torch.no_grad():
        ms_lf = time_ms(lambda: cudnn(x), iters=10, warmup=2)
        ms_pf = time_ms(port_fwd, iters=10, warmup=2)
    ms_lfb = time_ms(cudnn_fwd_bwd, iters=10, warmup=2)
    ms_pfb = time_ms(port_fwd_bwd, iters=10, warmup=2)
    e = 2
    fwd_bytes = e * (T * B * 4 * H + 4 * H * H + 2 * B * H + 2 * T * B * H + T * B * 4 * H)
    rec_bytes = e * (2 * T * B * H + T * B * 4 * H + 4 * H * H + 3 * B * H      # dys, cs (c_prev), ga, w, dhT, dcT, c0
                     + T * B * 4 * H + 2 * B * H)                               # dgates_x, dh0, dc0
    dw_bytes = e * (T * B * 4 * H + B * H + T * B * H + 4 * H * H)                  # dgates_x, h0, ys; dW_hh
    bwd_bytes = e * (3 * T * B * H + T * B * 4 * H + 4 * H * H + 4 * B * H     # dys, cs, ys, ga, w, dhT, dcT, h0, c0
                     + T * B * 4 * H + 2 * B * H + 4 * H * H)                   # dgates_x, dh0, dc0, dW_hh
    flops = 2 * T * B * H * 4 * H
    bnd_f, by_f = bound_ms(fwd_bytes, flops, "bfloat16")
    bnd_b, by_b = bound_ms(bwd_bytes, 2 * flops, "bfloat16")
    bnd_r, by_r = bound_ms(rec_bytes, flops, "bfloat16")
    bnd_w, by_w = bound_ms(dw_bytes, flops, "bfloat16")
    log(f"lstm_seq one layer bf16 T={T} B={B} H={H}: forward {ms_f:.4f} ms (1 cluster launch, "
        f"{1e3 * ms_f / T:.2f} us a step; the step route in this run {ms_f_step:.3f} ms), backward {ms_b:.4f} ms = "
        f"recurrence {ms_rec:.4f} ms (1 cluster launch, {1e3 * ms_rec / T:.2f} us a step) + dW_hh {ms_dw:.4f} ms "
        f"(tensor cores, {100 * ms_dw / ms_b:.1f}% of the backward); the step route in this run: backward "
        f"{ms_b_step:.3f} ms (dW_hh on the tensor cores); plain forward {ms_fp:.3f} ms, "
        f"backward {ms_bp:.3f} ms; bound forward {bnd_f:.4f} ms ({by_f}), backward {bnd_b:.4f} ms ({by_b}), "
        f"recurrence {bnd_r:.4f} ({by_r}), dW_hh {bnd_w:.4f} ({by_w}) [{card}]")
    log(f"one LSTM layer with its input projection, bf16 T={T} B={B} H={H}: nn.LSTM (cuDNN) forward {ms_lf:.4f} ms, "
        f"forward and backward {ms_lfb:.4f} ms (backward {ms_lfb - ms_lf:.4f}); the port (torch.matmul + lstm_seq) "
        f"forward {ms_pf:.4f} ms, forward and backward {ms_pfb:.4f} ms (backward {ms_pfb - ms_pf:.4f}) [{card}]")
    src = "img2latex_tpu_torch/csrc/lstm_seq_tc.cu"
    kernels["lstm_seq_fwd"] = dict(
        name="lstm_seq_fwd", route="cuda", source=src, replaces="img2latex_tpu/ops/pallas/lstm_train.py:103",
        max_abs_err=abs_err["fwd"], max_abs_err_bf16=abs_err["fwd_bf16"], ms=ms_f, plain_ms=ms_fp, bound_ms=bnd_f,
        bound_by=by_f, library_ms=ms_lf, parts={"step_route_ms": ms_f_step, "with_projection_ms": ms_pf})
    kernels["lstm_seq_bwd"] = dict(
        name="lstm_seq_bwd", route="cuda", source=src, replaces="img2latex_tpu/ops/pallas/lstm_train.py:205",
        max_abs_err=abs_err["bwd"], max_abs_err_bf16=abs_err["bwd_bf16"], ms=ms_b, plain_ms=ms_bp, bound_ms=bnd_b,
        bound_by=by_b, library_ms=ms_lfb - ms_lf,
        parts={"recurrence_ms": ms_rec, "dw_hh_ms": ms_dw, "recurrence_bound_ms": bnd_r, "dw_hh_bound_ms": bnd_w,
               "step_route_ms": ms_b_step,
               "with_projection_ms": ms_pfb - ms_pf})


def phase_conv1_backward(dev, rng, card: str, kernels: dict, cfg, B=TRAIN_BATCH) -> None:
    """conv1_pool's backward against autograd of conv1_pool_plain, and the
    repaired fault: the block-0 weight's gradient through the encoder."""
    import torch
    import torch.nn.functional as F

    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.ops.conv1_phase import conv1_pool, conv1_pool_plain
    from img2latex_tpu_torch.ops.preprocess import normalize_images

    Hh, Ww = cfg.model.encoder.cnn.img_height, cfg.model.encoder.cnn.img_width
    C = cfg.model.encoder.cnn.conv_filters[0]
    u8 = torch.from_numpy(rng.integers(0, 256, size=(B, Hh, Ww, 1), dtype=np.uint8)).to(dev)
    w = torch.from_numpy(rng.standard_normal((C, 1, 3, 3), dtype=np.float32) / 3.0).to(dev)
    b = torch.from_numpy(rng.standard_normal(C, dtype=np.float32) * 0.1).to(dev)
    err32 = None
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x = normalize_images(u8, dtype=dtype)
        g = torch.from_numpy(rng.standard_normal((B, C, Hh // 2, Ww // 2), dtype=np.float32)).to(dev, dtype)

        def grads(fn):
            leaves = [x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()]
            return torch.autograd.grad(fn(*leaves), leaves, g)

        got, ref = grads(conv1_pool), grads(conv1_pool_plain)
        errs = {n: rel_err(a, r) for n, a, r in zip(("dx", "dweight", "dbias"), got, ref)}
        log(f"conv1_pool backward {name} ({B},{Hh},{Ww},1): rel err vs autograd of conv1_pool_plain "
            f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})} (tol {CONV_BWD_TOL[name]})")
        check(max(errs.values()) <= CONV_BWD_TOL[name], f"conv1_pool backward {name}: {errs}")
        check(got[1].abs().max().item() > 0, f"conv1_pool backward {name}: zero weight gradient")
        if name == "float32":
            err32 = max((a - r).abs().max().item() for a, r in zip(got, ref))

    # times of the backward alone, bf16 (the kernel path recomputes the forward)
    leaves = [x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()]
    out_k = conv1_pool(*leaves)
    out_p = conv1_pool_plain(*leaves)
    xl = leaves[0].permute(0, 3, 1, 2).contiguous().detach().requires_grad_()
    wl = w.to(torch.bfloat16).requires_grad_()
    bl = b.to(torch.bfloat16).requires_grad_()
    out_l = F.max_pool2d(F.relu(F.conv2d(xl, wl, bl, padding=1)), 2)
    ms_k = time_ms(lambda: torch.autograd.grad(out_k, leaves, g, retain_graph=True))
    ms_p = time_ms(lambda: torch.autograd.grad(out_p, leaves, g, retain_graph=True))
    ms_l = time_ms(lambda: torch.autograd.grad(out_l, [xl, wl, bl], g, retain_graph=True))
    nbytes = 2 * (2 * B * Hh * Ww + B * C * (Hh // 2) * (Ww // 2)) + 2 * 4 * (C * 10)
    bnd, by = bound_ms(nbytes, 2 * 2 * 9 * C * B * Hh * Ww, "bfloat16")
    log(f"conv1_pool backward bf16 ({B},{Hh},{Ww},1): eager (recomputes the float32 forward) {ms_k:.3f} ms, "
        f"plain autograd {ms_p:.3f} ms, conv2d+relu+max_pool2d bf16 backward {ms_l:.3f} ms, "
        f"bound {bnd:.4f} ms ({by}) [{card}]")
    kernels["conv1_pool_bwd"] = dict(
        name="conv1_pool_bwd", route="eager", source="img2latex_tpu_torch/ops/conv1_phase.py",
        replaces="img2latex_tpu/ops/pallas/conv1_phase.py:274", max_abs_err=err32,
        ms=ms_k, plain_ms=ms_p, bound_ms=bnd, bound_by=by, library_ms=ms_l)

    # the repaired fault: block 0's weight gets its gradient through the encoder on the card
    for name in ("float32", "bfloat16"):
        ecfg = copy.deepcopy(cfg)
        ecfg.hardware.compute_dtype = name
        enc = build_model(ecfg, VOCAB, seed=SEED).encoder  # on the card: no device named
        x = normalize_images(u8[:16], dtype=torch.float32)
        gm = torch.from_numpy(rng.standard_normal((x.shape[0], cfg.model.embedding_dim), dtype=np.float32)).to(dev)
        grads = []
        for path in (contextlib.nullcontext, plain_path):
            enc.zero_grad()
            with path():
                (enc(x).float() * gm).sum().backward()
            grads.append(enc.convs[0].weight.grad.clone())
        e_enc = rel_err(grads[0], grads[1])
        nonzero = grads[0].abs().max().item()
        log(f"encoder {name} on the card: block-0 weight gradient max |g| {nonzero:.3g}, rel err vs the "
            f"plain path {e_enc:.3g} (tol {ENC_GRAD_TOL[name]:.3g})")
        check(nonzero > 0, f"encoder {name}: the block-0 weight got no gradient on the card")
        check(e_enc <= ENC_GRAD_TOL[name], f"encoder {name}: block-0 gradient {e_enc} off the plain path's")


def _train_batch(cfg, seed: int):
    from img2latex_tpu_torch.data.synthetic import synthetic_batch

    h, w, c = cfg.image_shape
    images, formulas = synthetic_batch(TRAIN_BATCH, (h, w, c), cfg.data.max_seq_length, VOCAB, seed=seed)
    return {"images": images, "formulas": formulas, "n_valid": np.int32(TRAIN_BATCH)}


def _step_pair(cfg, batch):
    """One train step on the kernel path and one on the plain path, from the
    same weights, batch and dropout seed: (metrics, gradients, parameters) each."""
    import torch

    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.training.optim import build_optimizer
    from img2latex_tpu_torch.training.steps import create_train_state, make_train_step, train_loss

    out = []
    for path in (contextlib.nullcontext, plain_path):
        model = build_model(cfg, VOCAB, seed=SEED)  # on the card: no device named
        state = create_train_state(model, build_optimizer(cfg, model), cfg, seed=SEED)
        with path():
            loss, _, _ = train_loss(state, cfg, batch, 0)
            grads = torch.autograd.grad(loss, state.optimizer.params)
            state.generator.manual_seed(SEED)  # the step draws the same dropout masks again
            metrics = make_train_step(cfg, 0)(state, batch)
        out.append((metrics, grads, [p.detach().clone() for p in state.optimizer.params],
                    [n for n, _ in model.named_parameters()]))
    return out


def _compare_steps(what: str, pair) -> dict:
    (mk, gk, pk, names), (mp, gp, pp, _) = pair
    loss_k, loss_p = mk["loss"].item(), mp["loss"].item()
    gn_k, gn_p = mk["grad_norm"].item(), mp["grad_norm"].item()
    g_err = {n: rel_err(a, b) for n, a, b in zip(names, gk, gp)}
    worst = max(g_err, key=g_err.get)
    d = [(a - b).abs() for a, b in zip(pk, pp)]
    p_max = max(x.max().item() for x in d)
    far = sum((x > 0.1 * TRAIN_LR).sum().item() for x in d) / sum(x.numel() for x in d)
    stats = dict(loss=loss_k, loss_plain=loss_p, loss_rel=abs(loss_k - loss_p) / abs(loss_p),
                 grad_norm=gn_k, grad_norm_plain=gn_p, grad_norm_rel=abs(gn_k - gn_p) / gn_p,
                 worst_grad=worst, worst_grad_rel=g_err[worst], param_max_abs=p_max, param_far_share=far)
    log(f"{what}: kernel path vs plain path {json.dumps(stats)} (tols: loss {STEP_LOSS_RTOL}, grad norm "
        f"{STEP_GNORM_RTOL}, each gradient {STEP_GRAD_TOL}, parameters {STEP_PARAM_ATOL:.4g} with at most "
        f"{STEP_PARAM_FAR_SHARE} beyond lr/10)")
    check(np.isfinite(loss_k) and np.isfinite(gn_k), f"{what}: non-finite loss or grad norm")
    check(stats["loss_rel"] <= STEP_LOSS_RTOL, f"{what}: loss {loss_k} vs plain {loss_p}")
    check(stats["grad_norm_rel"] <= STEP_GNORM_RTOL, f"{what}: grad norm {gn_k} vs plain {gn_p}")
    check(g_err[worst] <= STEP_GRAD_TOL, f"{what}: gradient of {worst} off by {g_err[worst]}")
    check(p_max <= STEP_PARAM_ATOL and far <= STEP_PARAM_FAR_SHARE, f"{what}: parameters after one step {stats}")
    return stats


def _time_gemm(dev, m, k, n):
    """ms of one bf16 F.linear (m, k) x (k, n) forward and backward."""
    import torch
    import torch.nn.functional as F

    a = torch.randn(m, k, device=dev, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(n, k, device=dev, dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn(m, n, device=dev, dtype=torch.bfloat16)

    def run():
        F.linear(a, w).backward(g)

    return time_ms(run, iters=10, warmup=2)


def phase_train_step(dev, card: str, cfg, steps: int = TRAIN_STEPS_TIMED) -> None:
    """The whole train step at bench_train.py's shapes against the plain path,
    then timed runs with a torch.profiler split: on the persistent lstm_seq
    kernels, then on the per-step route."""
    import torch

    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.training.optim import build_optimizer
    from img2latex_tpu_torch.training.steps import create_train_state, make_train_step

    batch = _train_batch(cfg, seed=SEED)
    _compare_steps(f"train step (vector, {cfg.hardware.compute_dtype}, B={TRAIN_BATCH}, dropout {TRAIN_DROPOUT})",
                   _step_pair(cfg, batch))

    model = build_model(cfg, VOCAB, seed=SEED)
    state = create_train_state(model, build_optimizer(cfg, model), cfg)
    step = make_train_step(cfg, 0)
    dbatch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}  # on the card, as a device cache would
    # the persistent lstm_seq kernels (the main path), then the per-step route in this run
    for what, route in (("persistent lstm_seq", contextlib.nullcontext), ("per-step lstm_seq", step_route)):
        with route():
            _time_train_step(what, card, step, state, dbatch, steps)
    _log_train_gemms(dev, card, cfg)


def _time_train_step(what: str, card: str, step, state, dbatch, steps: int) -> None:
    """Images/s of ``steps`` train steps and launches a step by route, then a
    torch.profiler split of 3 steps: device time by kernel group, busy share."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from img2latex_tpu_torch.ops.conv1_phase import conv1_pool
    from img2latex_tpu_torch.ops.lstm_train import lstm_seq_bwd, lstm_seq_fwd

    for _ in range(2):
        step(state, dbatch)
    torch.cuda.synchronize()
    counters = ((lstm_seq_fwd, ("launches", "persistent_launches", "step_launches")),
                (lstm_seq_bwd, ("launches", "persistent_launches", "step_launches", "dw_launches")))
    for fn, names in counters:
        for n in names:
            setattr(fn, n, 0)
    conv1_pool.launches = conv1_pool.tc_launches = conv1_pool.backward_calls = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(state, dbatch)
    loss = m["loss"].item()  # waits for the card
    ms = (time.perf_counter() - t0) * 1e3 / steps
    per_step = {f"{fn.__name__}.{n}": getattr(fn, n) / steps for fn, names in counters for n in names}
    per_step.update({"conv1_pool": conv1_pool.launches / steps, "conv1_pool.tc": conv1_pool.tc_launches / steps,
                     "conv1_pool_bwd": conv1_pool.backward_calls / steps})
    log(f"train step, {what} (vector, bf16, B={TRAIN_BATCH}): {ms:.2f} ms a step over {steps} steps = "
        f"{TRAIN_BATCH * 1e3 / ms:.1f} images/s, last loss {loss:.4f}; launches a step {json.dumps(per_step)} [{card}]")
    check(np.isfinite(loss), "train step: non-finite loss")

    # where the step's time goes: kernels by name under torch.profiler over 3 steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, dbatch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = (("lstm_seq kernels", ("lstm_seq",)), ("conv1_pool kernel", ("conv1_pool",)),
              ("convolution and pooling (cuDNN)", ("conv", "cudnn", "dgrad", "wgrad", "fprop", "pool",
                                                  "implicit")),
              ("GEMMs: head, input projections, vocab product, their gradients",
               ("gemm", "cutlass", "xmma", "sm90", "cublas", "splitk")),
              ("optimizer (Adam, clip, norms)", ("adam", "multi_tensor", "foreach", "norm")))
    split, other, lstm = {}, {}, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t <= 0 or getattr(e, "device_type", None) != DeviceType.CUDA:  # kernels, not the ops launching them
            continue
        key = next((g for g, pats in groups if any(p in e.key.lower() for p in pats)), "other elementwise")
        ms_g, n = split.get(key, (0.0, 0))
        split[key] = (ms_g + t / 1e3 / 3, n + e.count / 3)
        if key == "other elementwise":
            other[e.key[:60]] = round(t / 1e3 / 3, 3)
        if key == "lstm_seq kernels":
            name = re.search(r"lstm_seq_\w+", e.key).group(0)
            lstm[name] = round(lstm.get(name, 0.0) + t / 1e3 / 3, 4)
    busy = sum(v for v, _ in split.values())
    if busy > 0:
        top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])
        log(f"train step, {what}, under torch.profiler (per step): wall {wall / 3:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy * 3 / wall:.1f}%), host idle {wall / 3 - busy:.2f} ms; by group (ms, launches): "
            f"{json.dumps({k: [round(a, 3), round(b, 1)] for k, (a, b) in split.items()})}; lstm_seq kernels (ms): "
            f"{json.dumps(lstm)}; largest 'other' kernels (ms): {json.dumps(top)} [{card}]")
    else:
        log("train step under torch.profiler: no device time seen (not measured)")


def _log_train_gemms(dev, card: str, cfg) -> None:
    """The step's large products timed alone, beside the profiler's GEMM group."""
    T, B, E, H = TRAIN_T, TRAIN_BATCH, cfg.model.embedding_dim, cfg.model.decoder.hidden_dim
    C, Hf, Wf = FILTERS[-1], IMG_H // 8, IMG_W // 8
    log(f"GEMMs of the step timed alone (bf16 forward and backward): head ({B} x {C * Hf * Wf} -> {E}) "
        f"{_time_gemm(dev, B, C * Hf * Wf, E):.3f} ms, vocab product ({T * B} x {H} -> {VOCAB}) "
        f"{_time_gemm(dev, T * B, H, VOCAB):.3f} ms, input projections ({T * B} x {2 * E} and x {H} -> {4 * H}) "
        f"{_time_gemm(dev, T * B, 2 * E, 4 * H) + _time_gemm(dev, T * B, H, 4 * H):.3f} ms [{card}]")


def phase_trainer(dev, card: str, cfg, tokenizer, kernels: dict, tmp: str, epochs: int = 2,
                  steps_per_epoch: int = 4):
    """Trainer.train() for two short epochs on a repeated synthetic batch (the
    main path of the training slice: the kernels' counts are read around
    it), then a checkpoint under ``tmp`` that Predictor.from_checkpoint loads
    and decodes with, giving the trained model's ids.  Returns the
    checkpoint's step directory and the batch."""
    import torch

    from img2latex_tpu_torch.ops.conv1_phase import conv1_pool
    from img2latex_tpu_torch.ops.lstm_train import lstm_seq_bwd, lstm_seq_fwd
    from img2latex_tpu_torch.training.predictor import Predictor
    from img2latex_tpu_torch.training.trainer import Trainer
    from img2latex_tpu_torch.utils.paths import PathManager

    tcfg = copy.deepcopy(cfg)
    tcfg.training.epochs = epochs
    tcfg.data.log_frequency = 2
    tcfg.evaluation.bleu_batches = 1
    batch = _train_batch(tcfg, seed=SEED + 1)
    loaders = {"train": [batch] * steps_per_epoch, "validate": [batch]}
    trainer = Trainer(tcfg, tokenizer, loaders, paths=PathManager(tmp))  # on the card: no device named
    before = trainer.eval_step(trainer.state, batch)["loss"].item()
    torch.cuda.synchronize()
    lstm_seq_fwd.launches = lstm_seq_bwd.launches = conv1_pool.launches = conv1_pool.backward_calls = 0
    conv1_pool.tc_launches = 0
    lstm_seq_fwd.persistent_launches = lstm_seq_bwd.persistent_launches = lstm_seq_bwd.dw_launches = 0
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lstm_seq_fwd": lstm_seq_fwd.launches, "lstm_seq_bwd": lstm_seq_bwd.launches,
                "conv1_pool": conv1_pool.launches, "conv1_pool.tc": conv1_pool.tc_launches,
                "conv1_pool_bwd": conv1_pool.backward_calls,
                "lstm_seq_fwd.persistent": lstm_seq_fwd.persistent_launches,
                "lstm_seq_bwd.persistent": lstm_seq_bwd.persistent_launches,
                "lstm_seq_bwd.dw_hh": lstm_seq_bwd.dw_launches}
    hist = result["history"]
    losses = [hist[e]["train_loss"] for e in sorted(hist)]
    val = [hist[e]["val_loss"] for e in sorted(hist)]
    log(f"Trainer.train(): {epochs} epochs of {steps_per_epoch} steps (B={TRAIN_BATCH}, "
        f"{tcfg.hardware.compute_dtype}) in {wall:.2f} s; "
        f"val loss before {before:.4f}, train loss by epoch {losses}, val loss {val}, val BLEU "
        f"{hist[max(hist)]['val_bleu']:.4f}, {hist[max(hist)]['train_images_per_sec']:.1f} images/s in the last "
        f"epoch; launches {json.dumps(launches)} [{card}]")
    for name in ("lstm_seq_fwd", "lstm_seq_bwd", "conv1_pool_bwd"):
        check(launches[name] > 0, f"{name} was not run on the training path")
        kernels[name]["launches"] = launches[name]
    check(launches["conv1_pool"] > 0, "conv1_pool was not launched on the training path")
    check(launches["conv1_pool.tc"] == launches["conv1_pool"], "the training path ran conv1_pool off the tensor-core route")
    for name in ("lstm_seq_fwd.persistent", "lstm_seq_bwd.persistent", "lstm_seq_bwd.dw_hh"):
        check(launches[name] > 0, f"{name} was not launched on the training path")
    check(all(np.isfinite(losses + val)), "Trainer: non-finite loss")
    check(val[-1] < before and losses[-1] < losses[0], "Trainer: the loss on the repeated batch did not fall")

    step_dir = trainer.ckpt_dir / f"step_{trainer.state.step}"
    meta = json.loads((step_dir / "meta.json").read_text())
    keys = {"epoch", "step", "best_val_loss", "config", "tokenizer_config", "metrics", "scheduler",
            "early_stopping"}
    check(keys <= set(meta), f"checkpoint meta.json keys {sorted(meta)}")
    loaded = Predictor.from_checkpoint(str(step_dir), batch_size=TRAIN_BATCH)  # on the card
    sd, sd_ref = loaded.model.state_dict(), trainer.model.state_dict()
    check(all(torch.equal(sd[k], sd_ref[k]) for k in sd_ref), "checkpoint weights differ from the trainer's")
    in_memory = Predictor(tcfg, trainer.model, tokenizer, batch_size=TRAIN_BATCH)
    ids_ck = loaded.decode_canvases(batch["images"])
    ids_mem = in_memory.decode_canvases(batch["images"])
    log(f"Predictor.from_checkpoint({step_dir.name}): greedy ids equal to the trained model's in memory: "
        f"{bool(np.array_equal(ids_ck, ids_mem))} ({ids_ck.shape}, {len(np.unique(ids_ck))} distinct tokens)")
    check(np.array_equal(ids_ck, ids_mem), "ids from the checkpoint differ from the trained model's")
    return step_dir, batch


def phase_grid_train_step(dev, card: str, gcfg) -> None:
    """One grid-memory train step at the grid flagship's width: the kernel
    path (conv1_pool is its only kernel) against the plain path, and its time."""
    import torch

    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.training.optim import build_optimizer
    from img2latex_tpu_torch.training.steps import create_train_state, make_train_step

    batch = _train_batch(gcfg, seed=SEED + 2)
    _compare_steps(f"grid train step ({gcfg.hardware.compute_dtype}, B={TRAIN_BATCH}, S={GRID_S}, H={GRID_HIDDEN})",
                   _step_pair(gcfg, batch))
    model = build_model(gcfg, VOCAB, seed=SEED)
    state = create_train_state(model, build_optimizer(gcfg, model), gcfg)
    step = make_train_step(gcfg, 0)
    ms = time_ms(lambda: step(state, batch), iters=3, warmup=1)
    log(f"grid train step ({gcfg.hardware.compute_dtype}, B={TRAIN_BATCH}): {ms:.2f} ms a step = {TRAIN_BATCH * 1e3 / ms:.1f} images/s "
        f"(the teacher-forced grid pass is a plain loop of cell steps) [{card}]")


# ---------------------------------------------------------------------------
# The channel-first encoder chain (hardware.pallas_chain): the conv-pool
# kernel alone in both layouts, conv1_pool's NHWC output, the chain end to end
# for both memory kinds, and training through it.
# ---------------------------------------------------------------------------
# Blocks 1 and 2 at the main path's shapes: (Cin, Cout, H, W) of their inputs.
CHAIN_BLOCKS = ((FILTERS[0], FILTERS[1], IMG_H // 2, IMG_W // 2), (FILTERS[1], FILTERS[2], IMG_H // 4, IMG_W // 4))
# (B, Cin, Cout, H, W): odd channel counts, a Cout below one 64-channel tile,
# H and W that are not multiples of the 4 x 16 pooled tile.
CHAIN_ODD = ((5, 3, 12, 8, 12), (5, 33, 12, 8, 12), (5, 1, 12, 8, 12))
# The conv-pool kernel against its plain version on the same inputs: float32
# sums of 9 Cin products in another order, within CHAIN_F32_RTOL of the
# largest value; bf16 within one rounding step of |ref| (BF16_ULP, plus
# CONV_F32_ATOL) on every element and equal on CHAIN_BF16_EQUAL of them.
CHAIN_F32_RTOL = 1e-5
CHAIN_BF16_EQUAL = 0.99
# The chain end to end against the plain path, bf16: the feature map after the
# chain within CHAIN_FEAT_RTOL of its largest value (block 2's one-step
# differences carried through block 3), the memory within CONV_BF16_RTOL and
# the tokens under compare_tokens.  A convblock_cf with its bias dropped or
# its taps shifted by one column must fail that rule.
CHAIN_FEAT_RTOL = 2.0**-6


def _conv_errors(got, ref):
    """(max abs err, max abs err beyond one bf16 step of |ref|, share equal)."""
    d = (got.float() - ref.float()).abs()
    over = (d - BF16_ULP * ref.float().abs()).max().item()
    return d.max().item(), over, (d == 0).float().mean().item()


def _conv_verdict(what: str, got, ref, dtype: str):
    """(ok, max abs err) of a conv-pool kernel's output against its plain version's, logged."""
    err, over, equal = _conv_errors(got, ref)
    scale = max(ref.float().abs().max().item(), 1.0)
    if dtype == "float32":
        ok = err <= CHAIN_F32_RTOL * scale
        log(f"{what} float32: max abs err {err:.3g} (tol {CHAIN_F32_RTOL} x {scale:.3g})")
    else:
        ok = over <= CONV_F32_ATOL and equal >= CHAIN_BF16_EQUAL
        log(f"{what} bf16: max abs err {err:.3g}, beyond one bf16 step {over:.3g} (tol {CONV_F32_ATOL}), "
            f"equal {equal:.4f} (floor {CHAIN_BF16_EQUAL})")
    return ok, err


def _check_conv(what: str, got, ref, dtype: str) -> float:
    ok, err = _conv_verdict(what, got, ref, dtype)
    check(ok, f"{what} {dtype} disagrees with its plain version")
    check(bool(got.float().isfinite().all().item()), f"{what} {dtype}: non-finite output")
    return err


# conv1_pool's bf16 tensor-core route (csrc/conv1_pool_tc.cu) beside the main shape: (B, H, W, Cout)
# with Cout 8, 40 (a chunk of 32 channels and one of 8) and 128 (four chunks), H / 2 = 5, 7 and 3
# (not multiples of the 4-row band) and W / 2 = 17, 24 and 150 (not multiples of 16).
CONV1_ODD = ((5, 10, 34, 8), (5, 14, 48, 40), (3, 6, 300, 128))


def _broken_conv1_pool(mode: str):
    """conv1_pool through the tensor-core kernel with its bias dropped, or its packed taps shifted
    by one column: each must fail the conv rule."""
    import torch

    from img2latex_tpu_torch.ops import conv1_phase as c1

    def broken(x, weight, bias, layout):
        plan = c1.conv1_plan(x.shape[0], x.shape[1], x.shape[2], weight.shape[0], x.dtype)
        taps = c1.pack_conv1_taps(weight.to(x.dtype))
        if mode == "bias dropped":
            return c1.conv1_pool_launch(x, taps, torch.zeros_like(bias), layout, plan)
        return c1.conv1_pool_launch(x, taps.roll(1, dims=1), bias, layout, plan)

    return broken


def phase_conv1_routes(dev) -> None:
    """bf16 conv1_pool on its tensor-core route, in both layouts, at the main width (64 images)
    and CONV1_ODD: within the conv rule of its plain version (one bf16 step, CHAIN_BF16_EQUAL of
    the elements equal), the NHWC output the NCHW one transposed bit for bit; and the kernel with
    its bias dropped or its taps shifted failing that rule."""
    import torch

    from img2latex_tpu_torch.ops import conv1_phase as c1
    from img2latex_tpu_torch.ops.conv1_phase import conv1_pool, conv1_pool_plain
    from img2latex_tpu_torch.ops.preprocess import normalize_images

    rng = np.random.default_rng(SEED + 14)
    shapes = ((64, IMG_H, IMG_W, FILTERS[0]),) + CONV1_ODD
    with torch.no_grad():
        for B, H, W, C in shapes:
            u8 = rng.integers(0, 256, size=(B, H, W, 1), dtype=np.uint8)
            x = normalize_images(torch.from_numpy(u8).to(dev), dtype=torch.bfloat16)
            w = torch.from_numpy(rng.standard_normal((C, 1, 3, 3), dtype=np.float32) / 3.0).to(dev)
            b = torch.from_numpy(rng.standard_normal(C, dtype=np.float32) * 0.1).to(dev)
            what = f"conv1_pool ({B},{H},{W},1) -> {C}, bf16"
            check(c1.conv1_plan(B, H, W, C, torch.bfloat16).route == "tc", f"{what}: not the tensor-core route")
            got = {}
            for layout in ("nchw", "nhwc"):
                n0 = conv1_pool.tc_launches
                got[layout] = conv1_pool(x, w, b, layout=layout)
                check(conv1_pool.tc_launches == n0 + 1, f"{what} {layout}: conv1_pool_tc_kernel was not launched")
                _check_conv(f"{what}, {layout}, tensor cores", got[layout], conv1_pool_plain(x, w, b, layout), "bfloat16")
            check(torch.equal(got["nhwc"], got["nchw"].permute(0, 2, 3, 1)),
                  f"{what}: the NHWC output is not the NCHW one transposed")
            if C != FILTERS[0]:
                continue
            for mode in ("bias dropped", "taps shifted"):
                for layout in ("nchw", "nhwc"):
                    bad_ok, _ = _conv_verdict(f"{what}, {layout}, a broken kernel ({mode})",
                                              _broken_conv1_pool(mode)(x, w, b, layout),
                                              conv1_pool_plain(x, w, b, layout), "bfloat16")
                    check(not bad_ok, f"{what}: a kernel with its {mode} passed the conv rule")


def phase_chain_kernels(dev, rng, card: str, kernels: dict) -> None:
    """convblock_cf (NCHW, bias) and fused_conv_relu_pool (NHWC, no bias),
    the conv-pool kernel, against their plain versions at the chain's two
    block shapes at B = BATCH and at odd shapes, float32 and bf16, then
    their times beside the bound and cuDNN's conv2d+relu+max_pool2d; and
    conv1_pool's NHWC output and conv1_lane_relu_pool."""
    import torch
    import torch.nn.functional as F

    from img2latex_tpu_torch.ops.conv1_lane import conv1_lane_relu_pool, conv1_lane_relu_pool_plain
    from img2latex_tpu_torch.ops.conv1_phase import conv1_pool, conv1_pool_plain
    from img2latex_tpu_torch.ops.conv_cf import convblock_cf_plain, fused_convblock_cf
    from img2latex_tpu_torch.ops.conv_pool import fused_conv_relu_pool, fused_conv_relu_pool_plain
    from img2latex_tpu_torch.ops.preprocess import normalize_images

    def operands(B, Cin, Cout, H, W):
        x = torch.from_numpy(np.maximum(rng.standard_normal((B, Cin, H, W), dtype=np.float32), 0)).to(dev)
        w = torch.from_numpy(rng.standard_normal((Cout, Cin, 3, 3), dtype=np.float32) / np.sqrt(9 * Cin)).to(dev)
        b = torch.from_numpy(rng.standard_normal(Cout, dtype=np.float32) * 0.1).to(dev)
        return x, w, b

    err = {"cf": 0.0, "nhwc": 0.0, "cf_bf16": 0.0, "nhwc_bf16": 0.0}
    shapes = [(BATCH,) + blk for blk in CHAIN_BLOCKS] + list(CHAIN_ODD)
    with torch.no_grad():
        for shape in shapes:
            x32, w, b = operands(*shape)
            for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                x = x32.to(dtype)
                e = _check_conv(f"convblock_cf {shape}", fused_convblock_cf(x, w, b), convblock_cf_plain(x, w, b), name)
                xh = x.permute(0, 2, 3, 1).contiguous()
                e2 = _check_conv(f"fused_conv_relu_pool {shape}", fused_conv_relu_pool(xh, w),
                                 fused_conv_relu_pool_plain(xh, w), name)
                if shape[0] == BATCH:
                    sfx = "" if name == "float32" else "_bf16"
                    err["cf" + sfx], err["nhwc" + sfx] = max(err["cf" + sfx], e), max(err["nhwc" + sfx], e2)
                del x, xh
            del x32
        torch.cuda.empty_cache()

        # times at the main path's two block shapes, bf16, B = BATCH
        t = {k: 0.0 for k in ("cf", "cf_p", "cf_l", "nhwc", "nhwc_p", "nhwc_l", "bound_cf", "bound_nhwc")}
        for blk in CHAIN_BLOCKS:
            Cin, Cout, H, W = blk
            x32, w, b = operands(BATCH, *blk)
            x = x32.to(torch.bfloat16)
            del x32
            xh = x.permute(0, 2, 3, 1).contiguous()
            wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
            xcl = xh.permute(0, 3, 1, 2)  # the NHWC tensor as a channels-last NCHW view, as cuDNN takes it
            t["cf"] += time_ms(lambda: fused_convblock_cf(x, w, b), iters=5, warmup=1)
            t["cf_p"] += time_ms(lambda: convblock_cf_plain(x, w, b), iters=3, warmup=1)
            t["cf_l"] += time_ms(lambda: F.max_pool2d(F.relu(F.conv2d(x, wb, bb, padding=1)), 2), iters=5, warmup=1)
            t["nhwc"] += time_ms(lambda: fused_conv_relu_pool(xh, w), iters=5, warmup=1)
            t["nhwc_p"] += time_ms(lambda: fused_conv_relu_pool_plain(xh, w), iters=3, warmup=1)
            t["nhwc_l"] += time_ms(lambda: F.max_pool2d(F.relu(F.conv2d(xcl, wb, None, padding=1)), 2), iters=5, warmup=1)
            out_bytes = 2 * BATCH * Cout * (H // 2) * (W // 2)
            flops = 2 * 9 * Cin * Cout * H * W * BATCH
            bnd_cf, by = bound_ms(x.numel() * 2 + out_bytes + 4 * w.numel() + 4 * Cout, flops, "bfloat16")
            bnd_nh, _ = bound_ms(x.numel() * 2 + out_bytes + 4 * w.numel(), flops, "bfloat16")
            t["bound_cf"] += bnd_cf
            t["bound_nhwc"] += bnd_nh
            log(f"conv-pool kernel, block {Cin}->{Cout} at ({BATCH},{Cin},{H},{W}) bf16: bound {bnd_cf:.4f} ms ({by}, "
                f"{flops:.3g} FLOP) [{card}]")
            del x, xh, xcl
            torch.cuda.empty_cache()
        log(f"convblock_cf, the chain's two blocks at B={BATCH}, bf16: kernel {t['cf']:.3f} ms, plain {t['cf_p']:.3f} ms, "
            f"conv2d+relu+max_pool2d (cuDNN) {t['cf_l']:.3f} ms, bound {t['bound_cf']:.4f} ms ({by}); "
            f"fused_conv_relu_pool (NHWC, no bias) kernel {t['nhwc']:.3f} ms, plain {t['nhwc_p']:.3f} ms, "
            f"cuDNN channels-last {t['nhwc_l']:.3f} ms, bound {t['bound_nhwc']:.4f} ms [{card}]")
        src = "img2latex_tpu_torch/csrc/conv_pool.cu"
        kernels["convblock_cf"] = dict(
            name="convblock_cf", route="cuda", source=src, replaces="img2latex_tpu/ops/pallas/conv_cf.py:170",
            max_abs_err=err["cf"], max_abs_err_bf16=err["cf_bf16"], ms=t["cf"], plain_ms=t["cf_p"],
            bound_ms=t["bound_cf"], bound_by=by, library_ms=t["cf_l"])
        kernels["fused_conv_relu_pool"] = dict(
            name="fused_conv_relu_pool", route="cuda", source=src, replaces="img2latex_tpu/ops/pallas/conv_pool.py:101",
            max_abs_err=err["nhwc"], max_abs_err_bf16=err["nhwc_bf16"], ms=t["nhwc"], plain_ms=t["nhwc_p"],
            bound_ms=t["bound_nhwc"], bound_by=by, library_ms=t["nhwc_l"])

        # conv1_pool's NHWC output (conv1_lane_relu_pool with a zero bias)
        u8 = torch.from_numpy(rng.integers(0, 256, size=(BATCH, IMG_H, IMG_W, 1), dtype=np.uint8)).to(dev)
        w1 = torch.from_numpy(rng.standard_normal((FILTERS[0], 1, 3, 3), dtype=np.float32) / 3.0).to(dev)
        b1 = torch.from_numpy(rng.standard_normal(FILTERS[0], dtype=np.float32) * 0.1).to(dev)
        err1 = {}
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x = normalize_images(u8[:64], dtype=dtype)
            got = conv1_pool(x, w1, b1, layout="nhwc")
            check(tuple(got.shape) == (x.shape[0], IMG_H // 2, IMG_W // 2, FILTERS[0]),
                  f"conv1_pool nhwc {tuple(got.shape)}")
            e = _check_conv("conv1_pool[nhwc] (64,64,800,1)", got, conv1_pool_plain(x, w1, b1, layout="nhwc"), name)
            _check_conv("conv1_lane_relu_pool (64,64,800,1)", conv1_lane_relu_pool(x, w1),
                        conv1_lane_relu_pool_plain(x, w1), name)
            check(torch.equal(got, conv1_pool(x, w1, b1, layout="nchw").permute(0, 2, 3, 1)),
                  f"conv1_pool {name}: the NHWC output is not the NCHW one transposed")
            err1[name] = e
        xb = normalize_images(u8, dtype=torch.bfloat16)
        xcl = xb.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        ms_k, ms_ke = both_ms(lambda: conv1_pool(xb, w1, b1, layout="nhwc"), iters=10)
        with core_route():
            ms_c, _ = both_ms(lambda: conv1_pool(xb, w1, b1, layout="nhwc"), iters=10)
        ms_p, _ = both_ms(lambda: conv1_pool_plain(xb, w1, b1, layout="nhwc"), iters=10)
        ms_l, _ = both_ms(lambda: F.max_pool2d(F.relu(F.conv2d(xcl, w1.to(torch.bfloat16), b1.to(torch.bfloat16),
                                                                 padding=1)), 2), iters=10)
        nbytes = xb.numel() * 2 + BATCH * FILTERS[0] * (IMG_H // 2) * (IMG_W // 2) * 2 + w1.numel() * 4 + b1.numel() * 4
        bnd, by1 = bound_ms(nbytes, 2 * 9 * FILTERS[0] * BATCH * IMG_H * IMG_W, "bfloat16")
    log(f"conv1_pool[nhwc] ({BATCH},{IMG_H},{IMG_W},1) bf16, device time (CUDA graph): tensor-core kernel "
        f"{ms_k:.4f} ms (eager {ms_ke:.4f}), the CUDA-core kernel it replaces {ms_c:.4f} ms, plain {ms_p:.4f} ms, "
        f"conv2d+relu+max_pool2d channels-last {ms_l:.4f} ms, bound {bnd:.4f} ms ({by1}) [{card}]")
    kernels["conv1_pool[nhwc]"] = dict(
        name="conv1_pool[nhwc]", route="cuda", source="img2latex_tpu_torch/csrc/conv1_pool_tc.cu",
        replaces="img2latex_tpu/ops/pallas/conv1_lane.py:96", max_abs_err=err1["float32"],
        max_abs_err_bf16=err1["bfloat16"], plan_route="tc",
        ms=ms_k, ms_eager=ms_ke, ms_cuda_core=ms_c, plain_ms=ms_p, bound_ms=bnd, bound_by=by1, library_ms=ms_l,
        ms_method="cuda_graph")


def chain_copy(cfg, model):
    """cfg with hardware.pallas_chain on, and its model from build_model
    (on the card) holding ``model``'s weights."""
    from img2latex_tpu_torch.models.seq2seq import build_model

    ccfg = copy.deepcopy(cfg)
    ccfg.hardware.pallas_chain = True
    cmodel = build_model(ccfg, VOCAB)  # on the card: no device named
    cmodel.load_state_dict(model.state_dict())
    return ccfg, cmodel


def plain_reference(pred, canv):
    """The plain path's greedy tokens and top-2 margins (host arrays), memory
    and feature map for pred's model on the uint8 canvases ``canv``."""
    import torch

    from img2latex_tpu_torch.ops.decode_step import greedy_decode_plain
    from img2latex_tpu_torch.ops.grid_decode import grid_greedy_decode_plain, grid_memory_proj
    from img2latex_tpu_torch.ops.preprocess import normalize_images

    pre = pred.cfg.preprocessing
    with torch.no_grad(), plain_path():
        x = normalize_images(torch.from_numpy(canv).to(pred.device), pre.normalization_mean,
                             pre.normalization_std, pred.dtype)
        feat = pred.model.encoder.features(x)
        mem = pred.model.encode(x)
        if pred.model.decoder.cell.attends(mem):
            att = pred.packed_attention()
            ref, margins = grid_greedy_decode_plain(pred.packed_decoder(), att, mem, grid_memory_proj(att, mem),
                                                    MAX_LEN, 1, END_ID, 0, return_margins=True)
        else:
            ref, margins = greedy_decode_plain(pred.packed_decoder(), mem[:, 0, :], MAX_LEN, 1, END_ID, 0,
                                               return_margins=True)
    return ref.cpu().numpy(), margins.cpu().numpy(), mem, feat, x


def _chain_verdict(pred, canv, ref, dtype: str = "bfloat16"):
    """(ok, stats) of the chain path's feature map, memory and tokens on canv
    against the plain path's ``ref`` (plain_reference's output)."""
    import torch

    ref_tok, margins, mem_ref, feat_ref, x = ref
    toks = pred.decode_canvases(canv)
    with torch.no_grad():
        feat = pred.model.encoder.features(x)
        mem = pred.model.encode(x)
    feat_err = rel_err(feat, feat_ref)
    mem_err = ((mem.float() - mem_ref.float()).abs() / mem_ref.float().abs().clamp_min(1.0)).max().item()
    grid = mem.shape[1] > 1
    ok, stats = compare_tokens(toks, ref_tok, margins, dtype, grid=grid)
    stats = dict(feature_rel_err=feat_err, memory_rel_err=mem_err, **stats)
    ok = ok and feat_err <= CHAIN_FEAT_RTOL and mem_err <= CONV_BF16_RTOL and bool(mem.float().isfinite().all())
    return ok, stats


def _broken_convblock_cf(mode: str):
    """A convblock_cf through the kernel with its bias dropped, or its taps
    shifted by one column: each must fail the chain's rule."""
    from img2latex_tpu_torch.ops.conv_cf import conv_pool_launch

    def broken(x, weight, bias):
        if mode == "bias dropped":
            return conv_pool_launch(x, weight, None, "nchw", "broken")
        return conv_pool_launch(x, weight.roll(1, dims=3), bias, "nchw", "broken")

    return broken


def phase_chain_end_to_end(dev, card: str, kind: str, cfg, model, tokenizer, images, kernels: dict) -> None:
    """Predictor.predict_batch on the chain (hardware.pallas_chain) at full
    width, bf16, greedy: images/s and encoder ms with the chain on and off in
    this run, the launches, the output against the plain path, and two
    broken convblock_cf that must fail; for grid also beam-5 and sampling
    through the chain (only the encoder differs from phases 9 and 12)."""
    import torch

    from img2latex_tpu_torch.models import encoder as enc_mod
    from img2latex_tpu_torch.ops.beam_decode import beam_step
    from img2latex_tpu_torch.ops.conv1_phase import conv1_pool
    from img2latex_tpu_torch.ops.conv_cf import convblock_cf
    from img2latex_tpu_torch.ops.conv_pool import fused_conv_relu_pool
    from img2latex_tpu_torch.ops.decode_step import lstm_layer_step, vocab_argmax_step, vocab_sample_step
    from img2latex_tpu_torch.training.predictor import Predictor

    ccfg, cmodel = chain_copy(cfg, model)
    pred = Predictor(ccfg, cmodel, tokenizer, batch_size=BATCH)
    off = Predictor(cfg, model, tokenizer, batch_size=BATCH)
    counted = (conv1_pool, convblock_cf, lstm_layer_step, vocab_argmax_step)
    speed, on_launches = {}, {}
    for label, p in (("chain off", off), ("chain on", pred), ("chain on ", pred), ("chain off ", off)):
        p.predict_batch(images[:BATCH], return_ids=True)  # warm-up
        torch.cuda.synchronize()
        for k in counted + (fused_conv_relu_pool,):
            k.launches = 0
        conv1_pool.nhwc_launches = conv1_pool.tc_launches = 0
        t0 = time.perf_counter()
        ids = p.predict_batch(images, return_ids=True)
        torch.cuda.synchronize()
        speed.setdefault(label.strip(), []).append(N_IMAGES / (time.perf_counter() - t0))
        launches = {k.__name__: k.launches for k in counted}
        check(conv1_pool.tc_launches == launches["conv1_pool"] > 0,
              f"{kind} predict_batch ({label.strip()}) ran conv1_pool off the tensor-core route")
        if label.strip() == "chain on":
            on_launches = launches
            check(len(ids) == N_IMAGES and all(tokenizer.end_token_id not in r and all(0 <= t < VOCAB for t in r)
                                               for r in ids), f"{kind} chain predict_batch output")
            for name in ("conv1_pool", "convblock_cf", "lstm_layer_step", "vocab_argmax_step"):
                check(launches[name] > 0, f"{name} was not launched on the {kind} chain path")
            if kind == "vector":
                # the chain runs both kernels channel-first: their NHWC layouts are not on the path
                kernels["convblock_cf"]["launches"] = launches["convblock_cf"]
                kernels["fused_conv_relu_pool"]["launches"] = fused_conv_relu_pool.launches
                kernels["conv1_pool[nhwc]"]["launches"] = conv1_pool.nhwc_launches
        else:
            check(launches["convblock_cf"] == 0, f"{kind}: convblock_cf launched with the chain off")
    canv = np.stack(images[:BATCH])
    ref = plain_reference(pred, canv)
    x = ref[4]
    with torch.no_grad():
        ms_on = time_ms(lambda: cmodel.encode(x), iters=5)
        ms_off = time_ms(lambda: model.encode(x), iters=5)
        ms_feat_on = time_ms(lambda: cmodel.encoder.features(x), iters=5)
        ms_feat_off = time_ms(lambda: model.encoder.features(x), iters=5)
    log(f"{kind} predict_batch on the chain: {N_IMAGES} images at batch {BATCH}, bf16: images/s chain on "
        f"{[round(v, 1) for v in speed['chain on']]}, chain off {[round(v, 1) for v in speed['chain off']]} "
        f"(off, on, on, off); encoder a batch: chain on {ms_on:.3f} ms (conv stack {ms_feat_on:.3f}), chain off "
        f"{ms_off:.3f} ms (conv stack {ms_feat_off:.3f}); launches with the chain on {json.dumps(on_launches)} [{card}]")
    ok, stats = _chain_verdict(pred, canv, ref)
    log(f"{kind} chain end to end vs plain path ({BATCH} images): {json.dumps(stats)} (tols: feature map "
        f"{CHAIN_FEAT_RTOL:.4g}, memory {CONV_BF16_RTOL})")
    check(ok, f"{kind} chain end-to-end output disagrees with the plain path")
    saved = enc_mod.convblock_cf
    for mode in ("bias dropped", "taps shifted"):
        enc_mod.convblock_cf = _broken_convblock_cf(mode)
        try:
            bad_ok, bad = _chain_verdict(pred, canv, ref)
        finally:
            enc_mod.convblock_cf = saved
        log(f"{kind} chain with a broken convblock_cf ({mode}): fails the rule: {not bad_ok}; "
            f"feature rel err {bad['feature_rel_err']:.3g}, memory rel err {bad['memory_rel_err']:.3g}, "
            f"rows differ {bad['rows_differ']}")
        check(not bad_ok, f"{kind}: a convblock_cf with its {mode} passed the chain's rule")
    if kind != "grid":
        return
    for label, kw, step in (("beam-5", dict(beam_size=BEAM, length_penalty=LENGTH_PENALTY), beam_step),
                            ("sampling", dict(seed=SAMPLE_SEED, **SAMPLE), vocab_sample_step)):
        pred.predict_batch(images[:BATCH], return_ids=True, **kw)  # warm-up
        torch.cuda.synchronize()
        convblock_cf.launches = step.launches = 0
        t0 = time.perf_counter()
        ids = pred.predict_batch(images, return_ids=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"grid {label} predict_batch on the chain: {N_IMAGES / wall:.1f} images/s; launches convblock_cf "
            f"{convblock_cf.launches}, {step.__name__} {step.launches} [{card}]")
        check(convblock_cf.launches > 0 and step.launches > 0, f"grid {label} on the chain: kernels not launched")
        check(len(ids) == N_IMAGES and all(tokenizer.end_token_id not in r and all(0 <= t < VOCAB for t in r)
                                           for r in ids), f"grid {label} chain predict_batch output")


def phase_chain_training(dev, rng, card: str, kernels: dict, tcfg, step_dir, batch) -> None:
    """convblock_cf's backward against autograd of convblock_cf_plain at
    B = TRAIN_BATCH; one vector train step at bench_train.py's shapes on the
    chain against the plain path, and its time beside the step off the chain;
    Predictor.from_checkpoint(..., use_pallas_chain=True) on phase 16's
    checkpoint."""
    import torch
    import torch.nn.functional as F

    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.ops.conv_cf import convblock_cf, convblock_cf_plain
    from img2latex_tpu_torch.training.optim import build_optimizer
    from img2latex_tpu_torch.training.predictor import Predictor
    from img2latex_tpu_torch.training.steps import create_train_state, make_train_step

    B = TRAIN_BATCH
    err32, t = 0.0, {"k": 0.0, "p": 0.0, "l": 0.0, "bound": 0.0}
    for Cin, Cout, H, W in CHAIN_BLOCKS:
        x32 = torch.from_numpy(np.maximum(rng.standard_normal((B, Cin, H, W), dtype=np.float32), 0)).to(dev)
        w = torch.from_numpy(rng.standard_normal((Cout, Cin, 3, 3), dtype=np.float32) / np.sqrt(9 * Cin)).to(dev)
        b = torch.from_numpy(rng.standard_normal(Cout, dtype=np.float32) * 0.1).to(dev)
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x = x32.to(dtype)
            g = torch.from_numpy(rng.standard_normal((B, Cout, H // 2, W // 2), dtype=np.float32)).to(dev, dtype)

            def grads(fn):
                leaves = [x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()]
                return torch.autograd.grad(fn(*leaves), leaves, g)

            got, ref = grads(convblock_cf), grads(convblock_cf_plain)
            errs = {n: rel_err(a, r) for n, a, r in zip(("dx", "dweight", "dbias"), got, ref)}
            log(f"convblock_cf backward {name} ({B},{Cin},{H},{W}): rel err vs autograd of convblock_cf_plain "
                f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})} (tol {CONV_BWD_TOL[name]})")
            check(max(errs.values()) <= CONV_BWD_TOL[name], f"convblock_cf backward {name}: {errs}")
            check(got[1].abs().max().item() > 0, f"convblock_cf backward {name}: zero weight gradient")
            if name == "float32":
                err32 = max(err32, max((a - r).abs().max().item() for a, r in zip(got, ref)))
        # times of the backward alone, bf16 (the kernel path recomputes the forward)
        leaves = [x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()]
        out_k, out_p = convblock_cf(*leaves), convblock_cf_plain(*leaves)
        xl = x.clone().requires_grad_()
        wl, bl = w.to(torch.bfloat16).requires_grad_(), b.to(torch.bfloat16).requires_grad_()
        out_l = F.max_pool2d(F.relu(F.conv2d(xl, wl, bl, padding=1)), 2)
        t["k"] += time_ms(lambda: torch.autograd.grad(out_k, leaves, g, retain_graph=True), iters=5, warmup=1)
        t["p"] += time_ms(lambda: torch.autograd.grad(out_p, leaves, g, retain_graph=True), iters=5, warmup=1)
        t["l"] += time_ms(lambda: torch.autograd.grad(out_l, [xl, wl, bl], g, retain_graph=True), iters=5, warmup=1)
        # reads x, w and the pooled cotangent, writes dx, dw, db; dx and dw products: 2 x the forward's FLOP
        nbytes = 2 * (2 * x.numel() + g.numel()) + 4 * 2 * (w.numel() + Cout)
        bnd, by = bound_ms(nbytes, 2 * 2 * 9 * Cin * Cout * H * W * B, "bfloat16")
        t["bound"] += bnd
        del x32, x, xl, out_k, out_p, out_l, leaves
        torch.cuda.empty_cache()
    log(f"convblock_cf backward, the chain's two blocks at B={B}, bf16: eager (recomputes the float32 forward) "
        f"{t['k']:.3f} ms, plain autograd {t['p']:.3f} ms, conv2d+relu+max_pool2d bf16 backward {t['l']:.3f} ms, "
        f"bound {t['bound']:.4f} ms ({by}) [{card}]")
    kernels["convblock_cf_bwd"] = dict(
        name="convblock_cf_bwd", route="eager", source="img2latex_tpu_torch/ops/conv_cf.py",
        replaces="img2latex_tpu/ops/pallas/conv_cf.py:221", max_abs_err=err32,
        ms=t["k"], plain_ms=t["p"], bound_ms=t["bound"], bound_by=by, library_ms=t["l"])

    # one train step on the chain against the plain path, then the chain's steps timed and counted
    ccfg = copy.deepcopy(tcfg)
    ccfg.hardware.pallas_chain = True
    tbatch = _train_batch(ccfg, seed=SEED + 3)
    _compare_steps(f"chain train step (vector, bf16, B={B}, dropout {TRAIN_DROPOUT})", _step_pair(ccfg, tbatch))
    dbatch = {k: torch.as_tensor(v).to(dev) for k, v in tbatch.items()}
    ms = {}
    for label, c in (("off", tcfg), ("on", ccfg)):
        model = build_model(c, VOCAB, seed=SEED)
        state = create_train_state(model, build_optimizer(c, model), c)
        step = make_train_step(c, 0)
        for _ in range(2):
            step(state, dbatch)
        torch.cuda.synchronize()
        convblock_cf.launches = convblock_cf.backward_calls = 0
        t0 = time.perf_counter()
        for _ in range(5):
            m = step(state, dbatch)
        check(np.isfinite(m["loss"].item()), f"train step, chain {label}: non-finite loss")
        ms[label] = (time.perf_counter() - t0) * 1e3 / 5
        if label == "on":
            check(convblock_cf.launches > 0 and convblock_cf.backward_calls > 0,
                  "convblock_cf was not run on the chain's training path")
            kernels["convblock_cf_bwd"]["launches"] = convblock_cf.backward_calls
            per_step = (convblock_cf.launches / 5, convblock_cf.backward_calls / 5)
        del model, state
    log(f"train step (vector, bf16, B={B}): chain on {ms['on']:.2f} ms = {B * 1e3 / ms['on']:.1f} images/s, chain off "
        f"{ms['off']:.2f} ms = {B * 1e3 / ms['off']:.1f} images/s; convblock_cf launches a step {per_step[0]:.0f}, "
        f"backward passes {per_step[1]:.0f} [{card}]")

    # phase 16's checkpoint decoded on the chain
    pred = Predictor.from_checkpoint(str(step_dir), batch_size=TRAIN_BATCH, use_pallas_chain=True)  # on the card
    check(pred.model.encoder.pallas_chain, "from_checkpoint(use_pallas_chain=True) left the chain off")
    convblock_cf.launches = 0
    ok, stats = _chain_verdict(pred, batch["images"], plain_reference(pred, batch["images"]))
    log(f"Predictor.from_checkpoint({step_dir.name}, use_pallas_chain=True): convblock_cf launches "
        f"{convblock_cf.launches}; vs the plain path {json.dumps(stats)}")
    check(convblock_cf.launches > 0, "the checkpoint's predictor did not run the chain")
    check(ok, "the checkpoint's chain predictor disagrees with the plain path")


EVAL_N = 2048          # test canvases of the evaluate phase
EVAL_BEAM_N = 512      # of which the beam-5 evaluate decodes the first batch
EVAL_BODY = (3, 40)    # formula lengths in tokens, drawn uniformly
EVAL_KEYS = ("end_to_end_seconds", "decode_seconds", "compile_and_first_batch_seconds", "host_prep_seconds",
             "host_post_seconds", "input_wait_seconds", "cache_build_seconds", "setup_seconds",
             "host_other_seconds", "steady_images", "images_per_second", "images_per_second_decode_only",
             "images_per_second_resident")
# each bench script at a reduced batch: (module, argv, metric)
BENCH_RUNS = (("bench_torch", ["512"], "greedy_decode_images_per_sec"),
              ("bench_beam_torch", ["128", "5"], "beam5_decode_images_per_sec"),
              ("bench_sampling_torch", ["512"], "topk_sampling_decode_images_per_sec"),
              ("bench_train_torch", ["32"], "train_step_images_per_sec"))


def write_canvas_corpus(root: str, tokenizer, n: int, cfg, seed: int = SEED + 21) -> str:
    """A test split with no image files, as the card's machine (no Pillow)
    must have it: the split file, the formulas, and the canvases drawn from
    the formulas' token ids with data/synthetic.py's numpy helpers (Pillow's
    Lanczos bytes), written into the canvas cache at ``canvas_cache_path``
    (every image counts as missing in the key).  Returns the cache dir."""
    from img2latex_tpu_torch.data.pipeline import canvas_cache_path, parse_split_file
    from img2latex_tpu_torch.data.synthetic import fit_canvas_u8, render_formula_image

    rng = np.random.default_rng(seed)
    h, w, c = cfg.image_shape
    os.makedirs(root, exist_ok=True)
    bodies = [rng.integers(4, tokenizer.vocab_size, size=int(rng.integers(*EVAL_BODY))) for _ in range(n)]
    with open(os.path.join(root, cfg.data.formulas_file), "w") as f:
        f.write("\n".join(tokenizer.decode(b.tolist()) for b in bodies) + "\n")
    split = os.path.join(root, cfg.data.test_file)
    with open(split, "w") as f:
        f.write("\n".join(f"eval_{i:06d}.png {i}" for i in range(n)) + "\n")
    cache_dir = os.path.join(root, "canvas_cache")
    os.makedirs(cache_dir)
    samples = parse_split_file(split, n)
    path = canvas_cache_path(cache_dir, samples, os.path.join(root, cfg.data.img_dir), (h, w), c,
                             cfg.preprocessing.pad_value)
    arr = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8, shape=(n, h, w, c))
    for i, body in enumerate(bodies):
        arr[i] = fit_canvas_u8(render_formula_image(body), h, w, cfg.preprocessing.pad_value)
    arr.flush()
    del arr
    return cache_dir


def _eval_counters():
    from img2latex_tpu_torch.ops.beam_decode import beam_step
    from img2latex_tpu_torch.ops.conv1_phase import conv1_pool
    from img2latex_tpu_torch.ops.decode_step import lstm_layer_step, vocab_argmax_step
    from img2latex_tpu_torch.ops.grid_decode import attend_step

    return {"conv1_pool": conv1_pool, "attend_step": attend_step, "lstm_layer_step": lstm_layer_step,
            "vocab_argmax_step": vocab_argmax_step, "beam_step": beam_step}


def _serial_predict(pred, images, batch_size: int, **kw):
    """``predict_batch(return_ids=True)`` as the port ran it before its
    pipeline: each batch prepped serially, decoded, and fetched before the
    next batch's prep."""
    from img2latex_tpu_torch.data.transforms import prepare_image_u8
    from img2latex_tpu_torch.decoding.decode import trim_host
    from img2latex_tpu_torch.training.predictor import batch_seed

    h, w, c = pred.cfg.image_shape
    tok, dcfg, out = pred.tokenizer, pred.decode_config(**kw), []
    for i in range(0, len(images), batch_size):
        chunk = images[i : i + batch_size]
        buf = np.zeros((batch_size, h, w, c), dtype=np.uint8)
        for j, img in enumerate(chunk):
            buf[j] = prepare_image_u8(img, h, w, c, pred.cfg.preprocessing.pad_value)
        tokens = pred.decode_canvases(buf, dcfg=dcfg, seed=batch_seed(0, i // batch_size))[: len(chunk)]
        out += trim_host(tokens, tok.end_token_id, tok.pad_token_id, start_id=tok.start_token_id)
    return out


def _evaluate_both_loops(what: str, card: str, pred, root: str, cache_dir: str, out_dir: str,
                         expect: tuple, sync, **kw) -> tuple:
    """evaluate_checkpoint streaming, then device-cached, through ``pred``:
    the kernels in ``expect`` launched in each run (counts set to 0 just
    before it, read just after), the two loops' predictions equal, the
    cached run's ``cache_build_seconds`` above 0.  Returns the streaming
    result and the rows of its predictions.json."""
    from img2latex_tpu_torch.training.evaluator import evaluate_checkpoint

    counters = _eval_counters()
    results, rows = {}, {}
    for loop, extra in (("streaming", {}), ("device-cached", {"data.device_cache": True})):
        sync()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = evaluate_checkpoint(None, data_dir=root, batch_size=BATCH, predictor=pred,
                                  output_dir=os.path.join(out_dir, loop),
                                  config_overrides={"data.canvas_cache_dir": cache_dir, **extra}, **kw)
        sync()
        wall = time.perf_counter() - t0
        launches = {n: counters[n].launches for n in expect}
        with open(os.path.join(out_dir, loop, "predictions.json")) as f:
            rows[loop] = json.load(f)["predictions"]
        log(f"evaluate_checkpoint, {what}, {loop}: {res['num_images']} images, {wall:.3f} s with the loader's "
            f"set-up, the metrics and predictions.json; bleu {res['bleu']:.4f}, levenshtein "
            f"{res['levenshtein']:.4f}, token accuracy {res['token_accuracy']:.4f}; "
            f"{len({r['prediction'] for r in rows[loop]})} distinct predictions; accounting "
            f"{json.dumps({k: res[k] for k in EVAL_KEYS})}; launches {json.dumps(launches)} [{card}]")
        for name, n in launches.items():
            check(n > 0, f"evaluate ({what}, {loop}): kernel {name} was not launched")
        check((res["cache_build_seconds"] > 0) == (loop == "device-cached"),
              f"evaluate ({what}, {loop}): cache_build_seconds {res['cache_build_seconds']}")
        results[loop] = res
    check(rows["streaming"] == rows["device-cached"], f"evaluate ({what}): the two loops' predictions differ")
    for k in ("num_images", "bleu", "levenshtein", "token_accuracy"):
        check(results["streaming"][k] == results["device-cached"][k], f"evaluate ({what}): {k} differs by loop")
    return results["streaming"], rows["streaming"]


def _check_against_predict_batch(what: str, pred, dataset, rows, result, n: int, **kw) -> list:
    """The evaluation's predictions against ``predict_batch(return_ids=True)``
    on the same canvases and batch, and its metrics against
    ``calculate_metrics`` / ``token_list_accuracy`` recomputed on the host.
    Returns the canvases."""
    from img2latex_tpu_torch.decoding.decode import trim_host
    from img2latex_tpu_torch.ops.metrics import calculate_metrics, token_list_accuracy

    tok = pred.tokenizer
    canvases = [dataset.image(i) for i in range(n)]
    ids = pred.predict_batch(canvases, return_ids=True, batch_size=BATCH, **kw)
    check([r["prediction"] for r in rows] == tok.decode_rows(ids),
          f"evaluate ({what}): predictions differ from predict_batch's tokens")
    tgts = trim_host(np.stack([dataset.token_ids(i) for i in range(n)])[:, 1:], tok.end_token_id, tok.pad_token_id)
    check([r["reference"] for r in rows] == tok.decode_rows(tgts), f"evaluate ({what}): references")
    q = calculate_metrics(ids, tgts, pred.cfg.evaluation.bleu_n)
    correct, total = token_list_accuracy(ids, tgts, tok.pad_token_id)
    acc = correct / total if total else 0.0
    log(f"evaluate ({what}): tokens equal predict_batch's on {n} canvases; metrics recomputed on the host "
        f"bleu {q['bleu']:.6f}, levenshtein {q['levenshtein']:.6f}, token accuracy {acc:.6f}")
    check(q["bleu"] == result["bleu"] and q["levenshtein"] == result["levenshtein"]
          and acc == result["token_accuracy"], f"evaluate ({what}): metrics differ from the host's recomputation")
    return canvases


def time_pipeline(pred, canvases, what: str, card: str, sync, reps: int = 2, **kw) -> None:
    """``predict_batch`` of ``canvases`` at batch BATCH, pipelined (as it runs:
    no prep pool for canvas-size arrays; and with the pool forced on) beside
    the serial loop it replaced, in turns (serial, pipelined, pipelined with
    the pool, and back), ``reps`` times: images/s of each, the stats of the
    pipelined runs, ids equal."""
    from img2latex_tpu_torch.training import predictor as pm

    walls = {"serial": [], "pipelined": [], "pipelined, pool forced": []}
    stats_of = {"pipelined": [], "pipelined, pool forced": []}
    order = list(walls) + list(walls)[::-1]
    ref = None
    needs_pillow = pm._needs_pillow
    for mode in order * reps:
        stats = {}
        sync()
        t0 = time.perf_counter()
        if mode == "serial":
            ids = _serial_predict(pred, canvases, BATCH, **kw)
        else:
            pm._needs_pillow = needs_pillow if mode == "pipelined" else (lambda *a: True)
            try:
                ids = pred.predict_batch(canvases, return_ids=True, stats=stats, **kw)
            finally:
                pm._needs_pillow = needs_pillow
            stats_of[mode].append({k: (round(v, 4) if isinstance(v, float) else v) for k, v in stats.items()
                                   if k != "first_calls"})
        sync()
        walls[mode].append(time.perf_counter() - t0)
        ref = ids if ref is None else ref
        check(ids == ref, f"predict_batch ({what}, {mode}) ids differ")
    n = len(canvases)
    log(f"grid predict_batch {what} of {n} canvases at batch {BATCH}, bf16, images/s in turns: "
        + "; ".join(f"{m} {', '.join(f'{n / t:.1f}' for t in ts)}" for m, ts in walls.items())
        + f"; pipelined stats (s) {json.dumps(stats_of)} [{card}]")


def phase_evaluate(dev, card: str, gcfg, gmodel, tokenizer, step_dir, tmp: str, sync=None) -> None:
    """evaluate_checkpoint on the card from a Pillow-free canvas cache
    (:func:`write_canvas_corpus`): the grid model at the flagship's width
    (its head scaled by HEAD_GAIN, so that the decodes differ across
    canvases) and phase 16's trained vector checkpoint through
    Predictor.from_checkpoint, each streaming and device-cached over
    EVAL_N canvases at batch BATCH; grid beam-5 over EVAL_BEAM_N.  Each is
    held against predict_batch on the same canvases and the host's
    metrics.  Then the pipelined predict_batch beside the serial loop it
    replaced, greedy and beam-5, in the same run (:func:`time_pipeline`)."""
    import torch

    from img2latex_tpu_torch.data.pipeline import create_data_loaders
    from img2latex_tpu_torch.training.predictor import Predictor

    if sync is None:
        sync = torch.cuda.synchronize
    root = os.path.join(tmp, "eval_corpus")
    t0 = time.perf_counter()
    cache_dir = write_canvas_corpus(root, tokenizer, EVAL_N, gcfg)
    log(f"evaluate corpus: {EVAL_N} canvases drawn with numpy into the canvas cache in "
        f"{time.perf_counter() - t0:.1f} s (no image files, no Pillow)")
    ecfg = copy.deepcopy(gcfg)
    ecfg.data.data_dir, ecfg.data.canvas_cache_dir = root, cache_dir
    dataset = create_data_loaders(ecfg, tokenizer, splits=("test",))["test"].dataset
    check(dataset._mmap is not None, "the canvas cache was not read")
    grid_kernels = ("conv1_pool", "attend_step", "lstm_layer_step", "vocab_argmax_step")
    params = (gmodel.encoder.head.weight, gmodel.encoder.head.bias)
    saved = [p.detach().clone() for p in params]
    try:
        with torch.no_grad():
            for p in params:
                p.mul_(HEAD_GAIN)
        gpred = Predictor(gcfg, gmodel, tokenizer, batch_size=BATCH)
        res, rows = _evaluate_both_loops("grid greedy", card, gpred, root, cache_dir, os.path.join(tmp, "eval_grid"),
                                         grid_kernels, sync)
        canvases = _check_against_predict_batch("grid greedy", gpred, dataset, rows, res, EVAL_N)
        res, rows = _evaluate_both_loops(f"grid beam {BEAM}", card, gpred, root, cache_dir,
                                         os.path.join(tmp, "eval_beam"), grid_kernels[:3] + ("beam_step",), sync,
                                         beam_size=BEAM, max_batches=EVAL_BEAM_N // BATCH)
        _check_against_predict_batch(f"grid beam {BEAM}", gpred, dataset, rows, res, EVAL_BEAM_N, beam_size=BEAM)
        for what, kw in (("greedy", {}), (f"beam {BEAM}", dict(beam_size=BEAM))):
            time_pipeline(gpred, canvases, what, card, sync, **kw)
    finally:
        with torch.no_grad():
            for p, v in zip(params, saved):
                p.copy_(v)

    vpred = Predictor.from_checkpoint(str(step_dir), batch_size=BATCH, device=str(dev))
    res, rows = _evaluate_both_loops("vector, phase 16's checkpoint", card, vpred, root, cache_dir,
                                     os.path.join(tmp, "eval_vector"), grid_kernels[:1] + grid_kernels[2:], sync)
    _check_against_predict_batch("vector, phase 16's checkpoint", vpred, dataset, rows, res, EVAL_N)


def phase_bench_scripts(card: str) -> None:
    """Each bench_*_torch.py's main once at a reduced batch: one JSON line
    on stdout, with its metric and a positive value."""
    import importlib
    import io

    for name, argv, metric in BENCH_RUNS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            importlib.import_module(name).main(argv)
        lines = buf.getvalue().strip().splitlines()
        check(len(lines) == 1, f"{name} printed {len(lines)} lines")
        line = json.loads(lines[0])
        log(f"{name}.py {' '.join(argv)}: {lines[0]} [{card}]")
        check(line["metric"] == metric and line["value"] > 0, f"{name}: {lines[0]}")


# ---------------------------------------------------------------------------
# The ResNet-LSTM (model.name = "resnet_lstm"): bench_resnet.py's shapes, greedy
# through Predictor.predict_batch for both memory kinds, a ResNet-50 train step
# against the plain path, and a frozen ResNet-18 Trainer.train().  The backbone
# is cuDNN's convolutions and plain tensor ops (the JAX package's is XLA's, no
# Pallas kernel); the decode and training kernels are those of the CNN's paths.
# ---------------------------------------------------------------------------
RESNET = "resnet50"
RESNET_TRAINER = "resnet18"
RESNET_GRID_S = (IMG_W + 31) // 32     # layer4 columns: 25 slots of H' * 2048 = 4096 features
# BatchNorm running buffers after a step against 0.9 * before + 0.1 * the
# statistics of each BatchNorm's input in float64 (two-pass variance), of
# each buffer's largest magnitude: the module takes them in float32 as
# E[x^2] - E[x]^2 over up to 128 * 32 * 400 values.
RESNET_BN_RTOL = STEP_LOSS_RTOL
FLAX_BN_MOMENTUM = 0.9
# ResNet-50 greedy tokens, bf16, kernel vs plain decode on the same memory
# (compare_tokens), both memory kinds: the vector decode's bf16 rule, margin
# <= 2e-3 and >= 85% of rows equal.  Readings on the H100
# (scripts/resnet_margins.py, 12 seeds a kind, and this phase's runs): the
# largest parting margin 0.00038 (vector) and 0.000998 (grid, H = 512; the
# CNN grid rule's 1e-3 was set at H = 384), the lowest row match 0.904 and
# 0.906; the kernel decode bit-equal run to run.  Through attention steps
# broken by a slot left out, the grid decode parts at margins of 0.0015-0.015
# (broken_attend_step; the phase requires "first" and "last" to fail).
RESNET_MARGIN_TOL = MARGIN_TOL["bfloat16"]
RESNET_MIN_ROW_MATCH = MIN_ROW_MATCH["bfloat16"]
RESNET_BROKEN_FAIL = ("first", "last")   # broken attention steps the grid rule must fail
RESNET_BROKEN_LOGGED = ("stale", "norm")  # logged: they part at margins the rule lets through
RESNET_TRAIN_N, RESNET_VAL_N = 4 * TRAIN_BATCH, 2 * TRAIN_BATCH  # the Trainer phase's splits
RESNET_LAUNCH_KEYS = tuple(f"launches_resnet_{p}" for p in ("vector", "grid", "train_step", "trainer"))


def resnet_config(name: str = RESNET, memory: str = "vector", train: bool = False):
    """bench_resnet.py's configuration: 64x800x3, E = H = 512, 2 layers, vocab
    503, 141 steps, bf16; with ``train`` bench_train.py's training settings."""
    cfg = train_config() if train else grid_config()
    cfg.model.name = "resnet_lstm"
    cfg.model.memory = memory
    cfg.model.encoder.resnet.model_name = name
    cfg.model.encoder.resnet.img_height, cfg.model.encoder.resnet.img_width = IMG_H, IMG_W
    cfg.model.embedding_dim = EMBED
    cfg.model.decoder.hidden_dim = HIDDEN
    cfg.data.max_seq_length = cfg.inference.max_length = MAX_LEN
    cfg.hardware.compute_dtype = "bfloat16"
    return cfg


def calibrate_batch_norm(model, x) -> None:
    """Set every BatchNorm's running statistics to those of the batch ``x``
    (one train-mode pass with momentum 0), as a trained model's would be
    those of its data; random weights with the init's (0, 1) leave the
    activations unnormalized through 16 blocks."""
    import torch

    from img2latex_tpu_torch.models.resnet import BatchNorm

    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.momentum = 0.0
    with torch.no_grad():
        model.encode(x, train=True)
    for m in norms:
        m.momentum = 0.9


def log_encoder_profile(what: str, card: str, fn) -> None:
    """Run ``fn`` (an encoder pass) once under torch.profiler and log its
    device time by kernel group: cuDNN's convolutions, the BatchNorm
    statistics' reductions, max pooling, and the elementwise passes (the
    BatchNorm's float32 normalize and casts, ReLU, the residual adds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    groups = (("convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "fprop", "dgrad", "wgrad", "sm90")),
              ("reductions", ("reduce",)), ("max pool", ("max_pool", "maxpool")),
              ("GEMM (head)", ("gemm", "cublas", "cutlass")),
              ("elementwise", ("elementwise", "vectorized", "unrolled", "copy")))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if t <= 0 or getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        key = next((g for g, pats in groups if any(p in e.key.lower() for p in pats)), "other")
        ms, n = split.get(key, (0.0, 0))
        split[key] = (ms + t / 1e3, n + e.count)
    busy = sum(ms for ms, _ in split.values())
    if busy > 0:
        log(f"{what} under torch.profiler: wall {wall:.2f} ms, device busy {busy:.2f} ms ({100 * busy / wall:.1f}%); "
            f"by group (ms, launches, % of busy): "
            f"{json.dumps({k: [round(ms, 3), n, round(100 * ms / busy, 1)] for k, (ms, n) in split.items()})} [{card}]")
    else:
        log(f"{what} under torch.profiler: no device time seen (not measured)")


def _resnet_counters():
    from img2latex_tpu_torch.ops.decode_step import lstm_layer_step, vocab_argmax_step
    from img2latex_tpu_torch.ops.grid_decode import attend_step
    from img2latex_tpu_torch.ops.lstm_train import lstm_seq_bwd, lstm_seq_fwd

    return {"lstm_layer_step": lstm_layer_step, "vocab_argmax_step": vocab_argmax_step,
            "attend_step": attend_step, "lstm_seq_fwd": lstm_seq_fwd, "lstm_seq_bwd": lstm_seq_bwd}


def _count_resnet_launches(kernels: dict, path: str, what: str, fn, names) -> None:
    """Run ``fn`` with the launch counts of ``names`` set to 0 just before and
    read just after; each must have launched.  The counts go into the kernels
    line under ``launches_resnet_<path>``, this path's own; ``launches`` stays
    the count of the path that set it."""
    import torch

    counters = _resnet_counters()
    torch.cuda.synchronize()
    for n in names:
        counters[n].launches = 0
    fn()
    torch.cuda.synchronize()
    got = {n: counters[n].launches for n in names}
    log(f"{what}: launches {json.dumps(got)}")
    for n, c in got.items():
        check(c > 0, f"kernel {n} was not launched on the {what} path")
        kernels[n][f"launches_resnet_{path}"] = c


def compare_resnet_tokens(got, ref, margins):
    """compare_tokens in bf16 under the ResNet-50 rule."""
    return compare_tokens(got, ref, margins, "bfloat16", m_tol=RESNET_MARGIN_TOL, min_match=RESNET_MIN_ROW_MATCH)


def resnet_greedy_setup(dev, memory: str, seed: int, images):
    """A ResNet-50 model of ``resnet_config(memory=memory)`` on the card with
    weights and biases drawn from ``seed``, its BatchNorm calibrated on 64
    of ``images`` (tiled to 3 channels, as the Predictor tiles them) and
    END's bias tuned so that about half the rows of the first batch end:
    (cfg, model, the batch's uint8 canvases, their normalized bf16 tensor,
    the share of rows ending)."""
    import torch

    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.ops.decode_step import greedy_decode, pack_decoder_weights
    from img2latex_tpu_torch.ops.grid_decode import grid_greedy_decode, grid_memory_proj, pack_attention_weights
    from img2latex_tpu_torch.ops.preprocess import normalize_images

    grid = memory == "grid"
    rng = np.random.default_rng(seed)
    cfg = resnet_config(memory=memory)
    model = build_model(cfg, VOCAB, seed=seed)  # on the card: no device named
    draw_biases(model, rng)
    canv = np.stack([np.repeat(img, 3, axis=-1) for img in images[:BATCH]])
    x = normalize_images(torch.from_numpy(canv).to(dev), cfg.preprocessing.normalization_mean,
                         cfg.preprocessing.normalization_std, torch.bfloat16)
    calibrate_batch_norm(model, x[:64])
    with torch.no_grad():
        mem0 = model.encode(x)

    def ended_share():  # of the first batch's rows, by the kernel decode
        packed0 = pack_decoder_weights(model.decoder, torch.bfloat16)
        if grid:
            att0 = pack_attention_weights(model.decoder, torch.bfloat16)
            toks0 = grid_greedy_decode(packed0, att0, mem0, grid_memory_proj(att0, mem0), MAX_LEN, 1, END_ID, 0)
        else:
            toks0 = greedy_decode(packed0, mem0[:, 0, :], MAX_LEN, 1, END_ID, 0)
        return float((toks0 == END_ID).any(dim=1).float().mean())

    share = _tune_end_bias(model, ended_share)  # rows that end test the END -> PAD rule
    return cfg, model, canv, x, share


def resnet_decoders(model, mem, grid: bool):
    """(kernel decode, plain decode with margins, decode through a given
    attend function) of ``model``'s packed bf16 decoder on ``mem``."""
    import torch

    from img2latex_tpu_torch.ops import decode_step as ds
    from img2latex_tpu_torch.ops import grid_decode as gd

    packed = ds.pack_decoder_weights(model.decoder, torch.bfloat16)
    if not grid:
        v = mem[:, 0, :]
        return (lambda: ds.greedy_decode(packed, v, MAX_LEN, 1, END_ID, 0),
                lambda: ds.greedy_decode_plain(packed, v, MAX_LEN, 1, END_ID, 0, return_margins=True), None)
    att = gd.pack_attention_weights(model.decoder, torch.bfloat16)
    u = gd.grid_memory_proj(att, mem)
    return (lambda: gd.grid_greedy_decode(packed, att, mem, u, MAX_LEN, 1, END_ID, 0),
            lambda: gd.grid_greedy_decode_plain(packed, att, mem, u, MAX_LEN, 1, END_ID, 0, return_margins=True),
            lambda attend: gd._grid(ds.lstm_layer_step, ds.vocab_argmax_step, attend, packed, att, mem, u,
                                    MAX_LEN, 1, END_ID, 0, False, False, "logp"))


def broken_attend_step(mode: str):
    """The attend_step wrapper broken: "first" attends over all memory slots
    but the first and "last" over all but the last (an off-by-one in the slot
    loop; the last column is white on most canvases), "stale" returns the
    context of the step before from the second step on (a missed ordering),
    "norm" scales the context by 1 + 2^-6 (weights that sum to 1.016)."""
    from img2latex_tpu_torch.ops.grid_decode import attend_step

    state = {}

    def attend(h, w_h, v, u, mem, ctx, hw=None, rows_per_mem: int = 1):
        if mode in ("first", "last"):
            if "u" not in state:
                keep = slice(1, None) if mode == "first" else slice(None, -1)
                state["u"], state["mem"] = u[:, keep].contiguous(), mem[:, keep].contiguous()
            return attend_step(h, w_h, v, state["u"], state["mem"], ctx, hw, rows_per_mem)
        attend_step(h, w_h, v, u, mem, ctx, hw, rows_per_mem)
        if mode == "norm":
            return ctx.mul_(1 + 2.0**-6)
        prev, state["prev"] = state.get("prev"), ctx.clone()
        return ctx if prev is None else ctx.copy_(prev)

    return attend


def phase_resnet_greedy(dev, card: str, tokenizer, images, kernels: dict, memory: str) -> None:
    """A ResNet-50 Predictor.predict_batch at bench_resnet.py's width (vector:
    N_IMAGES canvases; grid: one batch, S = 25 slots of 2 * 2048 features),
    its tokens against the plain decode on the same memory (the ResNet rule,
    RESNET_MARGIN_TOL and RESNET_MIN_ROW_MATCH), and the encoder's and the
    decode's times; for grid also decodes through broken attention steps,
    of which RESNET_BROKEN_FAIL's must fail the rule."""
    import torch

    from img2latex_tpu_torch.training.predictor import Predictor

    t_phase = time.perf_counter()
    grid = memory == "grid"
    cfg, model, canv, x, share = resnet_greedy_setup(dev, memory, SEED + 50 + int(grid), images)
    pred = Predictor(cfg, model, tokenizer, batch_size=BATCH)  # on the card
    run = images if not grid else images[:BATCH]
    pred.predict_batch(run[:BATCH], return_ids=True)  # warm-up (cuDNN plans, packing)
    names = ["attend_step"] if grid else []
    names += ["lstm_layer_step", "vocab_argmax_step"]
    out = {}

    def drive():
        t0 = time.perf_counter()
        out["ids"] = pred.predict_batch(run, return_ids=True)
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0

    _count_resnet_launches(kernels, memory, f"{RESNET} {memory} greedy predict_batch", drive, names)
    ids, wall = out["ids"], out["wall"]
    check(len(ids) == len(run) and all(len(r) <= MAX_LEN for r in ids), f"{RESNET} {memory} predict_batch output")
    check(all(tokenizer.end_token_id not in r and all(0 <= t < VOCAB for t in r) for r in ids),
          f"{RESNET} {memory} trimmed ids")

    toks = pred.decode_canvases(canv)
    is_end = toks == tokenizer.end_token_id
    after = np.cumsum(is_end, axis=1) - is_end > 0
    check(bool((toks[after] == tokenizer.pad_token_id).all()), f"{RESNET} {memory}: a token other than PAD follows END")
    with torch.no_grad():
        mem = model.encode(x)
        check(tuple(mem.shape) == ((BATCH, RESNET_GRID_S, EMBED) if grid else (BATCH, 1, EMBED)),
              f"{RESNET} {memory} memory {tuple(mem.shape)}")
        check(bool(torch.isfinite(mem.float()).all()), f"non-finite {RESNET} {memory} memory")
        decode, plain, through = resnet_decoders(model, mem, grid)
        ref, margins = plain()
        ref, margins = ref.cpu().numpy(), margins.cpu().numpy()
        if not grid:
            log_encoder_profile(f"{RESNET} encoder, eval (B={BATCH}, bf16)", card, lambda: model.encode(x))
        ms_feat = time_ms(lambda: model.encoder.features(x), iters=3, warmup=1)
        ms_enc = time_ms(lambda: model.encode(x), iters=3, warmup=1)
        ms_dec = time_ms(decode, iters=3, warmup=1)
    ok, stats = compare_resnet_tokens(toks, ref, margins)
    spread = float(mem.float().std(dim=0).mean())
    log(f"{RESNET} {memory} greedy predict_batch: {len(run)} images in {wall:.3f} s = {len(run) / wall:.1f} images/s "
        f"(batch {BATCH}, bf16, 64x800x3, E=H={EMBED}); a batch of {BATCH} alone: backbone {ms_feat:.3f} ms, encoder "
        f"{ms_enc:.3f} ms (head {ms_enc - ms_feat:.3f}), decode {ms_dec:.3f} ms, encoder share "
        f"{100 * ms_enc / (ms_enc + ms_dec):.1f}%; memory spread over the batch {spread:.3g}, END's bias tuned to "
        f"{share:.3f} of the rows ending; tokens vs plain decode "
        f"{json.dumps(stats)}; phase wall {time.perf_counter() - t_phase:.1f} s [{card}]")
    check(ok, f"{RESNET} {memory} greedy disagrees with the plain path: {stats}")
    if grid:  # the rule fails a decode through a broken attention step
        for mode in RESNET_BROKEN_FAIL + RESNET_BROKEN_LOGGED:
            with torch.no_grad():
                bad = through(broken_attend_step(mode)).cpu().numpy()
            bad_ok, bstats = compare_resnet_tokens(bad, ref, margins)
            log(f"{RESNET} grid rule against a broken attend_step ({mode}): fails {not bad_ok}; "
                + json.dumps({k: bstats[k] for k in ("rows_differ", "row_match", "max_margin_at_first_diff")}))
            if mode in RESNET_BROKEN_FAIL:
                check(not bad_ok, f"the {RESNET} grid rule passes a decode through a broken attend_step ({mode})")


def phase_resnet_train_step(dev, card: str, kernels: dict) -> None:
    """A ResNet-50 train step at bench_train.py's settings (B = 128, dropout
    0.3) on three-channel canvases, against the plain path in float32 and
    bf16: the loss, the gradient norm, every gradient and the parameters
    (the train phase's rules) and the BatchNorm running buffers
    (RESNET_BN_RTOL of each buffer's largest magnitude); then its time."""
    import torch

    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.training.optim import build_optimizer
    from img2latex_tpu_torch.training.steps import create_train_state, make_train_step

    t_phase = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        cfg = resnet_config(train=True)
        cfg.hardware.compute_dtype = dtype
        batch = _train_batch(cfg, seed=SEED + 60)
        check(batch["images"].shape[-1] == 3, "the ResNet train batch is not three-channel")
        torch.cuda.reset_peak_memory_stats()
        _compare_steps(f"{RESNET} train step ({dtype}, B={TRAIN_BATCH}, dropout {TRAIN_DROPOUT})",
                       _step_pair(cfg, batch))
        log(f"{RESNET} train step ({dtype}): peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    model = build_model(cfg, VOCAB, seed=SEED)
    state = create_train_state(model, build_optimizer(cfg, model), cfg)
    step = make_train_step(cfg, 0)
    dbatch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    with batch_norm_reference(model) as expect:
        _count_resnet_launches(kernels, "train_step", f"{RESNET} train step", lambda: step(state, dbatch),
                               ["lstm_seq_fwd", "lstm_seq_bwd"])
    errs = {n: rel_err(b, expect[n]) for n, b in model.named_buffers()}
    worst = max(errs, key=errs.get)
    log(f"{RESNET} train step (bfloat16): {len(errs)} BatchNorm buffers after the step against the float64 "
        f"update of their inputs' statistics, worst {worst} off by {errs[worst]:.3g} of its largest magnitude "
        f"(tol {RESNET_BN_RTOL})")
    check(len(expect) == len(errs), f"{len(errs) - len(expect)} BatchNorm buffers saw no train-mode input")
    check(errs[worst] <= RESNET_BN_RTOL, f"{RESNET} train step: buffer {worst} off by {errs[worst]}")
    _time_train_step(f"{RESNET} encoder, 64x800x3", card, step, state, dbatch, steps=5)  # ms a step, profiler split
    log(f"{RESNET} train step phase wall {time.perf_counter() - t_phase:.1f} s [{card}]")


@contextlib.contextmanager
def batch_norm_reference(model):
    """While open, each train-mode call of a BatchNorm of ``model`` records
    its input's per-channel mean and biased variance in float64 (two-pass);
    the dict yielded is filled, on close, with each running buffer's
    expected value, flax's ``0.9 * before + 0.1 * batch``, by buffer name.  A
    module called more than once fails the check."""
    import torch

    from img2latex_tpu_torch.models.resnet import BatchNorm

    seen, handles = {}, []

    def hook(name):
        def pre(mod, args):
            x, train = args[0], (args[1] if len(args) > 1 else False)
            if train:
                check(name not in seen, f"BatchNorm {name} ran twice in train mode")
                xd = x.detach().double()
                mean = xd.mean(dim=(0, 2, 3))
                var = (xd - mean[:, None, None]).pow(2).mean(dim=(0, 2, 3))
                seen[name] = (mean, var)
        return pre

    before = {n: b.detach().double().clone() for n, b in model.named_buffers()}
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            handles.append(mod.register_forward_pre_hook(hook(name)))
    expect = {}
    try:
        yield expect
    finally:
        for h in handles:
            h.remove()
    m = FLAX_BN_MOMENTUM
    for name, (mean, var) in seen.items():
        for buf, stat in (("running_mean", mean), ("running_var", var)):
            key = f"{name}.{buf}"
            expect[key] = m * before[key] + (1 - m) * stat


def seeded_backbone_npz(path: str, backbone, seed: int) -> dict:
    """A converted npz (the JAX package's flax paths and layouts) of
    ``backbone``'s shapes, drawn from ``seed``."""
    import torch

    from img2latex_tpu_torch.models.resnet import BatchNorm

    rng = np.random.default_rng(seed)
    flat = {}
    for name, mod in backbone.named_modules():
        prefix = name.replace(".", "/")
        if isinstance(mod, torch.nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            flat[f"{prefix}/kernel"] = (rng.standard_normal((kh, kw, i, o)) / np.sqrt(kh * kw * i)).astype(np.float32)
        elif isinstance(mod, BatchNorm):
            n = mod.weight.shape[0]
            flat[f"{prefix}/scale"] = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
            flat[f"{prefix}/bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
            flat[f"{prefix}/mean"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
            flat[f"{prefix}/var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    np.savez(path, **flat)
    return flat


def phase_resnet_trainer(dev, card: str, tokenizer, kernels: dict, tmp: str, epochs: int = 2) -> None:
    """Trainer.train() of a frozen ResNet-18 from a pretrained npz written
    from a seed, 2 epochs of 4 steps at B = 128 over a canvas-cache split
    (numpy-drawn formulas), with data.device_cache and
    data.device_cache_grayscale, a registry and hardware.profile: the
    backbone outside layer4 must come out bit-equal to the npz and layer4
    must move; the registry must say completed with both epochs' metrics;
    the enhanced-metrics files and the trace must exist."""
    import torch

    from img2latex_tpu_torch.data.pipeline import BatchLoader, Im2LatexDataset, read_formulas
    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.training.trainer import Trainer
    from img2latex_tpu_torch.utils.paths import PathManager
    from img2latex_tpu_torch.utils.registry import ExperimentRegistry

    t_phase = time.perf_counter()
    cfg = resnet_config(RESNET_TRAINER, train=True)
    root = os.path.join(tmp, "resnet_corpus")
    cfg.data.data_dir = root
    cache_dir = write_canvas_corpus(root, tokenizer, RESNET_TRAIN_N + RESNET_VAL_N, cfg, seed=SEED + 70)
    ds = Im2LatexDataset(os.path.join(root, cfg.data.test_file),
                         read_formulas(os.path.join(root, cfg.data.formulas_file)),
                         os.path.join(root, cfg.data.img_dir), tokenizer, img_size=(IMG_H, IMG_W), channels=3,
                         canvas_cache_dir=cache_dir)

    class Rows:  # a split of ds's rows [lo, hi), as a dataset
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi
            self.img_size, self.channels, self.tokenizer = ds.img_size, ds.channels, ds.tokenizer

        def __len__(self):
            return self.hi - self.lo

        def image(self, i):
            return ds.image(self.lo + i)

        def token_ids(self, i):
            return ds.token_ids(self.lo + i)

        def __getitem__(self, i):
            return self.image(i), self.token_ids(i)

    loaders = {"train": BatchLoader(Rows(0, RESNET_TRAIN_N), TRAIN_BATCH, shuffle=True, drop_last=True, seed=1),
               "validate": BatchLoader(Rows(RESNET_TRAIN_N, RESNET_TRAIN_N + RESNET_VAL_N), TRAIN_BATCH)}
    probe = build_model(cfg, VOCAB, seed=SEED)
    npz = os.path.join(tmp, "backbone.npz")
    flat = seeded_backbone_npz(npz, probe.encoder.backbone, seed=SEED + 71)
    del probe
    cfg.model.encoder.resnet.pretrained_path = npz
    cfg.model.encoder.resnet.freeze_backbone = True
    cfg.data.device_cache = cfg.data.device_cache_grayscale = True
    cfg.hardware.profile = True
    cfg.training.epochs = epochs
    cfg.evaluation.bleu_batches = 1
    paths = PathManager(tmp)
    registry = ExperimentRegistry(paths)
    name = "resnet18_frozen"
    trainer = Trainer(cfg, tokenizer, loaders, paths=paths, registry=registry, experiment_name=name)  # on the card
    out = {}

    def drive():
        t0 = time.perf_counter()
        out["result"] = trainer.train()
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0

    _count_resnet_launches(kernels, "trainer", f"frozen {RESNET_TRAINER} Trainer.train()", drive,
                           ["lstm_seq_fwd", "lstm_seq_bwd"])
    hist = out["result"]["history"]
    losses = [hist[e]["train_loss"] for e in sorted(hist)]
    log(f"frozen {RESNET_TRAINER} Trainer.train(): {epochs} epochs of {RESNET_TRAIN_N // TRAIN_BATCH} steps "
        f"(B={TRAIN_BATCH}, bf16, device cache of {tuple(trainer._device_cache['images'].shape)} uint8) in "
        f"{out['wall']:.2f} s; train loss by epoch {losses}, val loss {[hist[e]['val_loss'] for e in sorted(hist)]}, "
        f"{hist[max(hist)]['train_images_per_sec']:.1f} images/s in the last epoch [{card}]")
    check(all(np.isfinite(losses)), "frozen Trainer: non-finite loss")
    check(trainer._device_cache["images"].shape[-1] == 1, "device_cache_grayscale stored more than 1 channel")
    sd = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    moved, layer4_moved = [], False
    for path, src in flat.items():
        mod, leaf = path.rsplit("/", 1)
        if leaf in ("mean", "var"):
            continue
        key = f"encoder.backbone.{mod.replace('/', '.')}.{'bias' if leaf == 'bias' else 'weight'}"
        value = sd[key].numpy()
        if leaf == "kernel":
            value = value.transpose(2, 3, 1, 0)
        if path.startswith("layer4"):
            layer4_moved |= not np.array_equal(value, src)
        elif not np.array_equal(value, src):
            moved.append(path)
    check(not moved, f"frozen backbone parameters moved: {moved[:5]}")
    check(layer4_moved, "layer4 did not train in the frozen regime")
    entry = registry.get(name)
    check(entry is not None and entry["status"] == "completed", f"registry status {entry and entry['status']}")
    check(sorted(entry["metrics"]["steps"]) == [str(e) for e in range(1, epochs + 1)],
          f"registry epochs {sorted(entry['metrics']['steps'])}")
    mdir = paths.get_dir(name, "metrics")
    for e in range(1, epochs + 1):
        check((mdir / f"{name}_enhanced_metrics_epoch_{e}.json").exists(), f"no enhanced metrics for epoch {e}")
    trace = paths.get_dir(name, "logs") / "traces" / "train_epoch0" / "trace.json"
    check(trace.exists() and trace.stat().st_size > 0, "no profiler trace")
    log(f"frozen {RESNET_TRAINER}: backbone outside layer4 bit-equal to the npz ({len(flat)} arrays), layer4 moved; "
        f"registry {entry['status']} with epochs {sorted(entry['metrics']['steps'])}; trace {trace.stat().st_size / 2**20:.1f} "
        f"MiB; phase wall {time.perf_counter() - t_phase:.1f} s [{card}]")


def _build_dir():
    from img2latex_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return _build.BUILD_DIR


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from img2latex_tpu_torch.config import Config
    from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.ops import _build
    from img2latex_tpu_torch.ops.conv1_phase import conv1_pool, conv1_pool_plain
    from img2latex_tpu_torch.ops.decode_step import (
        decode_step, decode_step_plain, greedy_decode, greedy_decode_plain, lstm_layer_step,
        lstm_layer_step_plain, pack_decoder_weights, vocab_argmax_step, vocab_argmax_step_plain,
    )
    from img2latex_tpu_torch.ops.preprocess import normalize_images
    from img2latex_tpu_torch.training.predictor import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = np.random.default_rng(SEED)
    kernels = {}

    # ---- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    log(f"build: nvcc {_build.build_seconds:.1f} s, load {time.perf_counter() - t0:.1f} s, "
        f"{_build.library_path().name}")
    ptxas = _build.BUILD_DIR / "ptxas.log"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log("  ptxas: " + line.split("ptxas info    : ")[-1].strip())
    check_tensor_core_build(_build.library_path())
    check_launch_shapes()

    # ---- phase 2: kernel 1, conv1 + bias + ReLU + pool ---------------------
    u8 = rng.integers(0, 256, size=(64, IMG_H, IMG_W, 1), dtype=np.uint8)
    x32 = normalize_images(torch.from_numpy(u8).to(dev), dtype=torch.float32)
    w1 = torch.from_numpy(rng.standard_normal((FILTERS[0], 1, 3, 3), dtype=np.float32) / 3.0).to(dev)
    b1 = torch.from_numpy(rng.standard_normal(FILTERS[0], dtype=np.float32) * 0.1).to(dev)
    ref32 = conv1_pool_plain(x32, w1, b1)
    got32 = conv1_pool(x32, w1, b1)
    err32 = (got32 - ref32).abs().max().item()
    check(tuple(got32.shape) == (64, FILTERS[0], IMG_H // 2, IMG_W // 2), f"conv1 shape {tuple(got32.shape)}")
    check(err32 <= CONV_F32_ATOL, f"conv1 f32 max abs err {err32} > {CONV_F32_ATOL}")
    x16 = x32.to(torch.bfloat16)
    got16 = conv1_pool(x16, w1, b1)
    rel16 = ((got16.float() - ref32).abs() / ref32.abs().clamp_min(1.0)).max().item()
    ref16 = conv1_pool_plain(x16, w1, b1).float()
    d16 = (got16.float() - ref16).abs()
    err16 = d16.max().item()
    over16 = (d16 - BF16_ULP * ref16.abs()).max().item()  # error beyond one bf16 step of |ref|
    check(rel16 <= CONV_BF16_RTOL, f"conv1 bf16 vs f32 plain: {rel16} > {CONV_BF16_RTOL}")
    check(over16 <= CONV_F32_ATOL, f"conv1 bf16 vs bf16 plain: max |err| - 2^-7 |ref| = {over16} > {CONV_F32_ATOL}")
    log(f"conv1_pool (64,{IMG_H},{IMG_W},1): f32 max abs err {err32:.3g} (tol {CONV_F32_ATOL}); "
        f"bf16 vs f32 plain max rel err {rel16:.3g} (tol {CONV_BF16_RTOL}); bf16 vs bf16 plain max abs err {err16:.3g}, "
        f"max |err| - 2^-7 |ref| {over16:.3g} (tol {CONV_F32_ATOL})")

    # timing at the main path's shape: (BATCH, 64, 800, 1) bf16
    xb = normalize_images(
        torch.from_numpy(rng.integers(0, 256, size=(BATCH, IMG_H, IMG_W, 1), dtype=np.uint8)).to(dev),
        dtype=torch.bfloat16)
    xb_nchw = xb.permute(0, 3, 1, 2).contiguous()
    w1b, b1b = w1.to(torch.bfloat16), b1.to(torch.bfloat16)
    ms_k, ms_ke = both_ms(lambda: conv1_pool(xb, w1, b1), iters=10)
    with core_route():
        ms_c, _ = both_ms(lambda: conv1_pool(xb, w1, b1), iters=10)
    ms_p, _ = both_ms(lambda: conv1_pool_plain(xb, w1, b1), iters=10)
    ms_l, _ = both_ms(lambda: F.max_pool2d(F.relu(F.conv2d(xb_nchw, w1b, b1b, padding=1)), 2), iters=10)
    nbytes = xb.numel() * 2 + BATCH * FILTERS[0] * (IMG_H // 2) * (IMG_W // 2) * 2 + w1.numel() * 4 + b1.numel() * 4
    flops = 2 * 9 * FILTERS[0] * BATCH * IMG_H * IMG_W
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    log(f"conv1_pool ({BATCH},{IMG_H},{IMG_W},1) bf16: tensor-core kernel {ms_k:.4f} ms (device, CUDA graph, the "
        f"taps' packing included; eager {ms_ke:.4f}), the CUDA-core kernel it replaces {ms_c:.4f} ms, plain {ms_p:.4f} ms, "
        f"conv2d+relu+max_pool2d {ms_l:.4f} ms, bound {bnd:.4f} ms ({by}) [{card}]")
    kernels["conv1_pool"] = dict(
        name="conv1_pool", route="cuda", source="img2latex_tpu_torch/csrc/conv1_pool_tc.cu",
        replaces="img2latex_tpu/ops/pallas/conv1_phase.py:208", max_abs_err=err32, max_abs_err_bf16=err16, plan_route="tc",
        ms=ms_k, ms_eager=ms_ke, ms_cuda_core=ms_c, plain_ms=ms_p, bound_ms=bnd, bound_by=by, library_ms=ms_l, ms_method="cuda_graph")
    # conv1_lane.py::conv1_lane_relu_pool is the same op without the bias: the
    # same kernel with a zero bias
    z1 = torch.zeros_like(b1)
    err0 = (conv1_pool(x32, w1, z1) - conv1_pool_plain(x32, w1, z1)).abs().max().item()
    check(err0 <= CONV_F32_ATOL, f"conv1 zero bias f32 max abs err {err0} > {CONV_F32_ATOL}")
    err0_16 = _check_conv("conv1_pool, zero bias, (64,64,800,1)", conv1_pool(x16, w1, z1),
                          conv1_pool_plain(x16, w1, z1), "bfloat16")
    ms_k0, ms_k0e = both_ms(lambda: conv1_pool(xb, w1, z1), iters=10)
    with core_route():
        ms_c0, _ = both_ms(lambda: conv1_pool(xb, w1, z1), iters=10)
    ms_p0, _ = both_ms(lambda: conv1_pool_plain(xb, w1, z1), iters=10)
    ms_l0, _ = both_ms(lambda: F.max_pool2d(F.relu(F.conv2d(xb_nchw, w1b, None, padding=1)), 2), iters=10)
    bnd0, by0 = bound_ms(nbytes - b1.numel() * 4, flops, "bfloat16")
    log(f"conv1_pool, zero bias (conv1_lane_relu_pool): f32 max abs err {err0:.3g}; bf16 ({BATCH},{IMG_H},{IMG_W},1): "
        f"tensor-core kernel {ms_k0:.4f} ms, CUDA-core {ms_c0:.4f} ms, plain {ms_p0:.4f} ms, conv2d+relu+max_pool2d {ms_l0:.4f} ms, "
        f"bound {bnd0:.4f} ms ({by0}) [{card}]")
    kernels["conv1_pool[bias=0]"] = dict(
        name="conv1_pool[bias=0]", route="cuda", source="img2latex_tpu_torch/csrc/conv1_pool_tc.cu",
        replaces="img2latex_tpu/ops/pallas/conv1_lane.py:96", max_abs_err=err0, max_abs_err_bf16=err0_16, plan_route="tc",
        ms=ms_k0, ms_eager=ms_k0e, ms_cuda_core=ms_c0, plain_ms=ms_p0, bound_ms=bnd0, bound_by=by0, library_ms=ms_l0,
        ms_method="cuda_graph")

    # the bf16 tensor-core route at the main and odd shapes, both layouts, and a broken kernel
    phase_conv1_routes(dev)

    # ---- phase 3: kernel 2, the greedy decode kernels ----------------------
    cfg = Config()
    cfg.model.embedding_dim = EMBED
    cfg.model.decoder.hidden_dim = HIDDEN
    cfg.model.decoder.lstm_layers = LAYERS
    cfg.model.encoder.cnn.img_height, cfg.model.encoder.cnn.img_width = IMG_H, IMG_W
    cfg.model.encoder.cnn.conv_filters = list(FILTERS)
    cfg.data.max_seq_length = cfg.inference.max_length = MAX_LEN
    cfg.hardware.compute_dtype = "bfloat16"
    model = build_model(cfg, VOCAB, seed=SEED)  # on the card: no device named
    draw_biases(model, rng)
    ctx = torch.from_numpy(np.maximum(rng.standard_normal((BATCH, EMBED), dtype=np.float32), 0)).to(dev)
    step_errs = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        packed = pack_decoder_weights(model.decoder, dtype)
        got = greedy_decode(packed, ctx, MAX_LEN, 1, END_ID, 0)
        ref, margins = greedy_decode_plain(packed, ctx, MAX_LEN, 1, END_ID, 0, return_margins=True)
        check(tuple(got.shape) == (BATCH, MAX_LEN) and got.dtype == torch.int32, "decode output shape/dtype")
        ok, stats = compare_tokens(got.cpu().numpy(), ref.cpu().numpy(), margins.cpu().numpy(), name)
        log(f"greedy_decode {name} B={BATCH} T={MAX_LEN}: {json.dumps(stats)}")
        check(ok, f"greedy_decode {name} disagrees with its plain version: {stats}")
        # one step from random carries: decode_step (fused_decode_step's counterpart)
        tok = torch.from_numpy(rng.integers(0, VOCAB, size=BATCH).astype(np.int32)).to(dev)
        h = torch.from_numpy(rng.uniform(-1, 1, (LAYERS, BATCH, HIDDEN)).astype(np.float32)).to(dev)
        c = torch.from_numpy(rng.uniform(-1, 1, (LAYERS, BATCH, HIDDEN)).astype(np.float32)).to(dev)
        n_k, h_k, c_k = decode_step(packed, tok, ctx, h, c)
        n_p, h_p, c_p = decode_step_plain(packed, tok, ctx, h, c)
        err_h = (h_k.float() - h_p.float()).abs().max().item()
        err_c = (c_k.float() - c_p.float()).abs().max().item()
        logits = h_p[-1].float() @ packed["w_out"].float() + packed["b_out"]
        top2 = torch.topk(logits, 2, dim=-1).values
        near = (top2[:, 0] - top2[:, 1]) <= MARGIN_TOL[name]
        tok_ok = bool(((n_k == n_p) | near).all().item())
        # how far the kernel's pick lies below the plain version's best logit
        err_v = (top2[:, 0] - logits.gather(1, n_k.long()[:, None])[:, 0]).max().item()
        log(f"decode_step {name}: h max abs err {err_h:.3g}, c {err_c:.3g} (tol {STEP_ATOL[name]}); "
            f"tokens equal {int((n_k == n_p).sum())}/{BATCH}, others near-ties: {tok_ok}; "
            f"logit gap of the kernel's pick {err_v:.3g}")
        check(err_h <= STEP_ATOL[name] and err_c <= STEP_ATOL[name] and tok_ok, f"decode_step {name}")
        step_errs[name] = (max(err_h, err_c), err_v)

    # timing at the main path's shapes, bf16, B = BATCH
    packed = pack_decoder_weights(model.decoder, torch.bfloat16)
    ctxb = ctx.to(torch.bfloat16)
    tok = torch.full((BATCH,), 1, dtype=torch.int32, device=dev)
    fin = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    out = torch.zeros((BATCH, MAX_LEN), dtype=torch.int32, device=dev)
    hh = torch.zeros((3, BATCH, HIDDEN), dtype=torch.bfloat16, device=dev)
    cc = torch.zeros((LAYERS, BATCH, HIDDEN), dtype=torch.bfloat16, device=dev)

    def layers(step):  # one step's two layer launches, no allocation
        step(tok, packed["emb"], ctxb, hh[0], packed["w_ih_0"], packed["w_hh_0"], packed["b_0"], cc[0], hh[1])
        step(None, None, hh[1], hh[2], packed["w_ih_1"], packed["w_hh_1"], packed["b_1"], cc[1], hh[0])

    cell = torch.nn.LSTMCell(2 * EMBED, HIDDEN, device=dev, dtype=torch.bfloat16)
    xcell = torch.cat([packed["emb"][tok.long()], ctxb], dim=-1)
    # eagerly (each launch enqueued by the host, as the decode loop does) and
    # by CUDA-graph replay (device time alone): at tens of microseconds a
    # launch the host's enqueue time exceeds the device's
    ms_lk_e = time_ms(lambda: layers(lstm_layer_step), iters=20) / LAYERS
    ms_lp_e = time_ms(lambda: layers(lstm_layer_step_plain), iters=20) / LAYERS
    with torch.no_grad():
        ms_ll_e = time_ms(lambda: cell(xcell, (hh[0], cc[0])), iters=20)
        ms_ll = graph_ms(lambda: cell(xcell, (hh[0], cc[0])))
    ms_lk = graph_ms(lambda: layers(lstm_layer_step)) / LAYERS
    ms_lp = graph_ms(lambda: layers(lstm_layer_step_plain)) / LAYERS
    H4, Vp = 4 * HIDDEN, packed["vocab_padded"]
    # bytes: weights, bias, x (layer 0: ctx, tokens, the emb table), h in, c in/out, h out
    lb = ((2 * EMBED + HIDDEN) * H4 * 2 + H4 * 4 + BATCH * EMBED * 2 + BATCH * 4 + Vp * EMBED * 2
          + BATCH * HIDDEN * 2 * 4)
    lb += 2 * HIDDEN * H4 * 2 + H4 * 4 + BATCH * HIDDEN * 2 + BATCH * HIDDEN * 2 * 4
    lf = 2 * BATCH * (2 * EMBED + HIDDEN) * H4 + 2 * BATCH * 2 * HIDDEN * H4
    bnd_l, by_l = bound_ms(lb / LAYERS, lf / LAYERS, "bfloat16")
    vocab = time_vocab_step(dev, card, hh[0], packed, HIDDEN, "vector")
    ms_dk = time_ms(lambda: greedy_decode(packed, ctxb, MAX_LEN, 1, END_ID, 0), iters=3, warmup=1)
    ms_dp = time_ms(lambda: greedy_decode_plain(packed, ctxb, MAX_LEN, 1, END_ID, 0), iters=3, warmup=1)
    log_profile(f"vector greedy decode (B={BATCH}, bf16)", card,
                lambda: greedy_decode(packed, ctxb, MAX_LEN, 1, END_ID, 0))
    log(f"lstm_layer_step bf16 B={BATCH} (mean of layers 0 and 1), device time (CUDA graph): kernel {ms_lk:.4f} ms, "
        f"plain {ms_lp:.4f} ms, nn.LSTMCell (layer 0, no gather) {ms_ll:.4f} ms, bound {bnd_l:.4f} ms ({by_l}); "
        f"enqueued eagerly: kernel {ms_lk_e:.4f} ms, plain {ms_lp_e:.4f} ms, nn.LSTMCell {ms_ll_e:.4f} ms [{card}]")
    step_shapes = phase_lstm_step_shapes(dev, card)
    log(f"greedy_decode bf16 B={BATCH} T={MAX_LEN}: kernels {ms_dk:.3f} ms, plain {ms_dp:.3f} ms [{card}]")
    src = "img2latex_tpu_torch/csrc/greedy_decode.cu"
    rep = "img2latex_tpu/ops/pallas/decode_step.py:523"
    # ms, plain_ms and library_ms by CUDA-graph replay; max_abs_err_bf16 is
    # the tensor-core kernel's at the shapes that ms is taken at
    kernels["lstm_layer_step"] = dict(
        name="lstm_layer_step", route="cuda", source=src, replaces=rep, max_abs_err=step_errs["float32"][0],
        max_abs_err_bf16=max(e for k, (_, e) in step_shapes.items()
                             if k.startswith("vector") and k.endswith(f"rows={BATCH}")),
        ms=ms_lk, ms_eager=ms_lk_e, plain_ms=ms_lp, bound_ms=bnd_l, bound_by=by_l, library_ms=ms_ll,
        ms_method="cuda_graph")
    kernels["vocab_argmax_step"] = dict(
        name="vocab_argmax_step", route="cuda", source=src, replaces=rep, max_abs_err=step_errs["float32"][1],
        max_abs_err_bf16=step_errs["bfloat16"][1], library_ms=None, ms_method="cuda_graph", **vocab)

    # ---- phase 4: the main path end to end ---------------------------------
    tokenizer = LaTeXTokenizer(max_sequence_length=MAX_LEN)
    tokenizer.fit([" ".join(f"\\tok{i}" for i in range(VOCAB - 4))])
    check(tokenizer.vocab_size == VOCAB and tokenizer.end_token_id == END_ID, f"tokenizer vocab {tokenizer.vocab_size}")
    images = list(rng.integers(0, 256, size=(N_IMAGES, IMG_H, IMG_W, 1), dtype=np.uint8))
    pred = Predictor(cfg, model, tokenizer, batch_size=BATCH)  # on the card: no device named
    pred.predict_batch(images[:BATCH], return_ids=True)  # warm-up (cuDNN plans, packing)
    torch.cuda.synchronize()
    conv1_pool.launches = conv1_pool.tc_launches = lstm_layer_step.launches = vocab_argmax_step.launches = 0
    t0 = time.perf_counter()
    ids = pred.predict_batch(images, return_ids=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv1_pool": conv1_pool.launches, "lstm_layer_step": lstm_layer_step.launches,
                "vocab_argmax_step": vocab_argmax_step.launches}
    check(conv1_pool.tc_launches == launches["conv1_pool"], "the greedy path ran conv1_pool off the tensor-core route")
    log(f"predict_batch: {N_IMAGES} images in {wall:.3f} s = {N_IMAGES / wall:.1f} images/s "
        f"(batch {BATCH}, bf16, card {card}); launches {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
        kernels[name]["launches"] = n
    kernels["conv1_pool[bias=0]"]["launches"] = launches["conv1_pool"]  # the same kernel
    check(len(ids) == N_IMAGES and all(len(r) <= MAX_LEN for r in ids), "predict_batch output")
    check(all(tokenizer.end_token_id not in r and all(0 <= t < VOCAB for t in r) for r in ids), "trimmed ids")
    texts = pred.predict_batch(images[:2])
    check(all(isinstance(t, str) for t in texts), "LaTeX strings")

    # tokens and END/PAD structure, and agreement with the plain path on one batch
    canv = np.stack(images[:BATCH])
    toks = pred.decode_canvases(canv)
    check(toks.shape == (BATCH, MAX_LEN) and toks.dtype == np.int32, f"tokens {toks.shape} {toks.dtype}")
    is_end = toks == tokenizer.end_token_id
    after = np.cumsum(is_end, axis=1) - is_end > 0
    check(bool((toks[after] == tokenizer.pad_token_id).all()), "a token other than PAD follows END")
    with torch.no_grad():
        x = normalize_images(torch.from_numpy(canv).to(dev), dtype=torch.bfloat16)
        enc = model.encoder
        y = conv1_pool_plain(x, enc.convs[0].weight, enc.convs[0].bias)
        for conv in enc.convs[1:]:
            y = F.max_pool2d(F.relu(F.conv2d(y, conv.weight.to(y.dtype), conv.bias.to(y.dtype), padding=1)), 2)
        mem_ref = F.relu(F.linear(y.flatten(1), enc.head.weight.to(y.dtype), enc.head.bias.to(y.dtype)))
        mem = model.encode(x)[:, 0, :]
        mem_err = ((mem.float() - mem_ref.float()).abs() / mem_ref.float().abs().clamp_min(1.0)).max().item()
        ref, margins = greedy_decode_plain(pred.packed_decoder(), mem_ref, MAX_LEN, 1, END_ID, 0, return_margins=True)
    ok, stats = compare_tokens(toks, ref.cpu().numpy(), margins.cpu().numpy(), "bfloat16")
    log(f"end to end vs plain path ({BATCH} images): memory max rel err {mem_err:.3g} "
        f"(tol {CONV_BF16_RTOL}); tokens {json.dumps(stats)}")
    check(np.isfinite(mem.float().cpu().numpy()).all(), "non-finite encoder memory")
    check(mem_err <= CONV_BF16_RTOL and ok, "end-to-end output disagrees with the plain path")

    # ---- phase 5: grid memory: attention kernel, grid decode -----------------
    phase_attend(dev, rng, card, kernels)
    gcfg = grid_config()
    gmodel = build_model(gcfg, VOCAB, seed=SEED + 1)  # on the card: no device named
    draw_biases(gmodel, rng)
    gmem = grid_memory(rng, dev)
    phase_grid_decode(gmodel, gmem)

    # ---- phase 6: early exit and scores, both memory kinds ------------------
    phase_early_exit_and_scores({"vector": (model, ctx), "grid": (gmodel, gmem)})

    # ---- phase 7: the grid path end to end ----------------------------------
    # canvases with random ink over a random width and white after it, as a
    # formula leaves the right of its canvas white, so that memories differ
    widths = rng.integers(IMG_W // 8, IMG_W + 1, size=N_IMAGES)
    gimages = [np.where(np.arange(IMG_W)[None, :, None] < w, img, 255).astype(np.uint8)
               for img, w in zip(images, widths)]
    phase_grid_end_to_end(dev, card, gcfg, gmodel, tokenizer, gimages, kernels)

    # ---- phase 8: beam: the beam step, shared-memory attention, whole decodes
    phase_beam_step(dev, rng, card, kernels)
    phase_attend_shared(dev, rng, card, kernels)
    phase_beam_decode({"vector": (model, ctx), "grid": (gmodel, gmem)}, card)

    # ---- phase 9: the grid beam and selective-beam paths end to end -----------
    phase_grid_beam_end_to_end(dev, card, gcfg, gmodel, tokenizer, stroke_canvases(rng, widths), kernels)

    # ---- phase 10: sampling: the vocab-sample step alone, its draws -----------
    phase_sample_step(dev, rng, card, kernels)
    phase_sample_draws(dev, rng)

    # ---- phase 11: the whole sampling decodes, broken samplers, early exit ----
    phase_sample_decode({"vector": (model, ctx), "grid": (gmodel, gmem)}, card)

    # ---- phase 12: the grid sampling path end to end --------------------------
    phase_grid_sample_end_to_end(dev, card, gcfg, gmodel, tokenizer, gimages, kernels)

    # ---- phase 13: training: lstm_seq forward and backward alone ------------
    tcfg = train_config()
    phase_lstm_seq(dev, rng, card, kernels)

    # ---- phase 14: the conv1 backward, and block 0's gradient through the encoder
    phase_conv1_backward(dev, rng, card, kernels, tcfg)

    # ---- phase 15: the whole train step against the plain path, timed ----------
    phase_train_step(dev, card, tcfg)

    with tempfile.TemporaryDirectory(dir=str(_build_dir())) as ckpt_tmp:
        # ---- phase 16: Trainer.train(), a checkpoint, Predictor.from_checkpoint ---
        step_dir, tbatch = phase_trainer(dev, card, tcfg, tokenizer, kernels, ckpt_tmp)

        # ---- phase 17: one grid-memory train step -----------------------------------
        phase_grid_train_step(dev, card, train_config("grid"))

        # ---- phase 18: the channel-first chain's kernels alone ------------------------
        phase_chain_kernels(dev, rng, card, kernels)

        # ---- phase 19: the chain end to end: vector greedy, grid greedy, beam, sampling
        phase_chain_end_to_end(dev, card, "vector", cfg, model, tokenizer, images, kernels)
        phase_chain_end_to_end(dev, card, "grid", gcfg, gmodel, tokenizer, gimages, kernels)

        # ---- phase 20: training on the chain, phase 16's checkpoint on the chain ------
        phase_chain_training(dev, rng, card, kernels, tcfg, step_dir, tbatch)

        # ---- phase 21: evaluate_checkpoint from a Pillow-free canvas cache --------------
        phase_evaluate(dev, card, gcfg, gmodel, tokenizer, step_dir, ckpt_tmp)

    # ---- phase 22: the bench scripts, each once at a reduced batch -------------------
    phase_bench_scripts(card)

    # ---- phases 23-26: the ResNet-LSTM -----------------------------------------------
    t_resnet = time.perf_counter()
    torch.cuda.empty_cache()
    phase_resnet_greedy(dev, card, tokenizer, gimages, kernels, "vector")
    phase_resnet_greedy(dev, card, tokenizer, gimages, kernels, "grid")
    phase_resnet_train_step(dev, card, kernels)
    with tempfile.TemporaryDirectory(dir=str(_build_dir())) as resnet_tmp:
        phase_resnet_trainer(dev, card, tokenizer, kernels, resnet_tmp)
    log(f"ResNet phases 23-26 wall time {time.perf_counter() - t_resnet:.1f} s")

    # ---- report --------------------------------------------------------------
    log(f"chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s (build included)")
    order = ("conv1_pool", "conv1_pool[bias=0]", "lstm_layer_step", "vocab_argmax_step", "attend_step",
             "beam_step", f"attend_step[rows_per_mem={BEAM}]", "vocab_sample_step", "lstm_seq_fwd",
             "lstm_seq_bwd", "conv1_pool_bwd", "convblock_cf", "convblock_cf_bwd", "fused_conv_relu_pool",
             "conv1_pool[nhwc]")
    # max_abs_err is the float32 instantiation's; max_abs_err_bf16 that of a
    # bf16 kernel which is not the float32 one (the tensor-core kernels, the
    # bf16 attention, the persistent lstm_seq kernels), else null.  parts: a
    # row's times split further (lstm_seq: the backward's recurrence and
    # dW_hh, the per-step route in the same run), else null.  ms_method: "eager" (CUDA events around
    # calls the host enqueues) or "cuda_graph" (device time, graph_ms; every
    # row under ~1 ms); the row's three times share it, except where
    # plain_ms_method says otherwise.  ms_eager: the kernel's eager time
    # beside its device time.  plan_route: the route conv1_plan names at the
    # row's shape ("tc"), else null; ms_cuda_core: the CUDA-core conv1-pool
    # kernel's time at the same shape in this run (core_route), else null.
    # launches_resnet_vector, _grid, _train_step, _trainer: the launches of
    # the ResNet paths of phases 23-26, each counted from 0 over its own run
    # (vector and grid greedy predict_batch, the ResNet-50 train step, the
    # frozen ResNet-18 Trainer.train()), else null; launches does not hold them.
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "max_abs_err_bf16", "ms",
            "ms_eager", "plain_ms", "bound_ms", "bound_by", "library_ms", "ms_method", "plain_ms_method", "parts",
            "plan_route", "ms_cuda_core") + RESNET_LAUNCH_KEYS
    for n in order:
        for k in RESNET_LAUNCH_KEYS:
            kernels[n].setdefault(k, None)
        kernels[n].setdefault("max_abs_err_bf16", None)
        kernels[n].setdefault("plan_route", None)
        kernels[n].setdefault("ms_cuda_core", None)
        kernels[n].setdefault("parts", None)
        kernels[n].setdefault("ms_method", "eager")
        kernels[n].setdefault("ms_eager", kernels[n]["ms"])
        kernels[n].setdefault("plain_ms_method", kernels[n]["ms_method"])
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in keys} for n in order]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

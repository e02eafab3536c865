#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (img2latex_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels with nvcc, holds each against its plain
PyTorch version on the card, then drives the two greedy paths through
``Predictor.predict_batch`` and checks that every kernel of each ran and
that the output is right:

* vector memory at bench.py's width: 64x800 canvas, filters [32, 64, 128],
  E = H = 512, 2 LSTM layers, vocab 503, 141 steps, bf16;
* grid memory at the grid flagship's width (artifacts/mathtext_hard_grid_v2,
  scripts/bench_grid_decode.py): the same canvas and filters, a grid of
  S = 100 slots of H'·C = 1024 features, E = 256, additive attention with
  A = H = 384, 2 LSTM layers, vocab 503, 141 steps, bf16.

Weights are random, from a seed.  Also holds early exit (tokens equal to
the full loop) and the four per-row score signals of both greedy decodes
against their plain versions.

Prints its findings on earlier lines, then a ``{"kernels": [...]}`` line,
the card's name and power limit from nvidia-smi, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
there is no CUDA device or any phase fails.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_tokens(got: np.ndarray, ref: np.ndarray, margins: np.ndarray, dtype: str,
                   grid: bool = False):
    """Every row that differs must first differ at a step whose reference
    top-2 logit margin is <= the margin limit of ``dtype``; rows must agree
    on at least the row floor.  The limits are the vector decode's, or the
    grid decode's with ``grid``."""
    m_tol = (GRID_MARGIN_TOL if grid else MARGIN_TOL)[dtype]
    min_match = (GRID_MIN_ROW_MATCH if grid else MIN_ROW_MATCH)[dtype]
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
            key = next((k for k in ("attend_hw_kernel", "attend_kernel", "lstm_layer_step_kernel",
                                    "vocab_argmax_step_kernel") if k in e.key), "other")
            ms, n = by_kernel.get(key, (0.0, 0))
            by_kernel[key] = (ms + t / 1e3, n + e.count)
    busy = sum(ms for ms, _ in by_kernel.values())
    if busy > 0:
        log(f"{what} under torch.profiler: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * busy / wall_ms:.1f}%); by kernel (ms, launches): "
            f"{json.dumps({k: [round(ms, 4), n] for k, (ms, n) in by_kernel.items()})} [{card}]")
    else:
        log(f"{what} under torch.profiler: no device time seen (not measured)")


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
    ms_k = time_ms(lambda: attend_step(*args, ctx, hw), iters=50, warmup=5)
    ms_p = time_ms(lambda: attend_step_plain(*args, ctx), iters=20)
    log_profile(f"20 attend_step launches (B={B}, bf16)", card,
                lambda: [attend_step(*args, ctx, hw) for _ in range(20)])
    nbytes = 2 * (B * S * (A + E) + B * H + H * A + A + B * E)
    flops = 2 * B * H * A + 2 * B * S * A + 2 * B * S * E
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    log(f"attend_step bf16 B={B}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {bnd:.4f} ms ({by}); "
        f"no single PyTorch call computes additive attention [{card}]")
    kernels["attend_step"] = dict(
        name="attend_step", route="cuda", source="img2latex_tpu_torch/csrc/grid_attend.cu",
        replaces="img2latex_tpu/ops/pallas/grid_decode.py:373", max_abs_err=errs["float32"],
        ms=ms_k, plain_ms=ms_p, bound_ms=bnd, bound_by=by, library_ms=None)


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
    conv1_pool.launches = attend_step.launches = lstm_layer_step.launches = vocab_argmax_step.launches = 0
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

    ms_l = time_ms(lambda: layers(lstm_layer_step), iters=20) / LAYERS
    ms_lp = time_ms(lambda: layers(lstm_layer_step_plain), iters=20) / LAYERS
    ms_v = time_ms(lambda: vocab_argmax_step(hh[0], packed["w_out"], packed["b_out"], tok, fin, out, 0, 2, 0), iters=20)
    ms_vp = time_ms(lambda: vocab_argmax_step_plain(hh[0], packed["w_out"], packed["b_out"], tok, fin, out, 0, 2, 0),
                    iters=20)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
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
    ms_k = time_ms(lambda: conv1_pool(xb, w1, b1))
    ms_p = time_ms(lambda: conv1_pool_plain(xb, w1, b1))
    ms_l = time_ms(lambda: F.max_pool2d(F.relu(F.conv2d(xb_nchw, w1b, b1b, padding=1)), 2))
    nbytes = xb.numel() * 2 + BATCH * FILTERS[0] * (IMG_H // 2) * (IMG_W // 2) * 2 + w1.numel() * 4 + b1.numel() * 4
    flops = 2 * 9 * FILTERS[0] * BATCH * IMG_H * IMG_W
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    log(f"conv1_pool ({BATCH},{IMG_H},{IMG_W},1) bf16: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
        f"conv2d+relu+max_pool2d {ms_l:.4f} ms, bound {bnd:.4f} ms ({by}) [{card}]")
    kernels["conv1_pool"] = dict(
        name="conv1_pool", route="cuda", source="img2latex_tpu_torch/csrc/conv1_pool.cu",
        replaces="img2latex_tpu/ops/pallas/conv1_phase.py:208", max_abs_err=err32,
        ms=ms_k, plain_ms=ms_p, bound_ms=bnd, bound_by=by, library_ms=ms_l)
    # conv1_lane.py::conv1_lane_relu_pool is the same op without the bias: the
    # same kernel with a zero bias
    z1 = torch.zeros_like(b1)
    err0 = (conv1_pool(x32, w1, z1) - conv1_pool_plain(x32, w1, z1)).abs().max().item()
    check(err0 <= CONV_F32_ATOL, f"conv1 zero bias f32 max abs err {err0} > {CONV_F32_ATOL}")
    ms_k0 = time_ms(lambda: conv1_pool(xb, w1, z1))
    ms_p0 = time_ms(lambda: conv1_pool_plain(xb, w1, z1))
    ms_l0 = time_ms(lambda: F.max_pool2d(F.relu(F.conv2d(xb_nchw, w1b, None, padding=1)), 2))
    bnd0, by0 = bound_ms(nbytes - b1.numel() * 4, flops, "bfloat16")
    log(f"conv1_pool, zero bias (conv1_lane_relu_pool): f32 max abs err {err0:.3g}; bf16 ({BATCH},{IMG_H},{IMG_W},1): "
        f"kernel {ms_k0:.4f} ms, plain {ms_p0:.4f} ms, conv2d+relu+max_pool2d {ms_l0:.4f} ms, "
        f"bound {bnd0:.4f} ms ({by0}) [{card}]")
    kernels["conv1_pool[bias=0]"] = dict(
        name="conv1_pool[bias=0]", route="cuda", source="img2latex_tpu_torch/csrc/conv1_pool.cu",
        replaces="img2latex_tpu/ops/pallas/conv1_lane.py:96", max_abs_err=err0,
        ms=ms_k0, plain_ms=ms_p0, bound_ms=bnd0, bound_by=by0, library_ms=ms_l0)

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
    ms_lk = time_ms(lambda: layers(lstm_layer_step), iters=20) / LAYERS
    ms_lp = time_ms(lambda: layers(lstm_layer_step_plain), iters=20) / LAYERS
    ms_ll = time_ms(lambda: cell(xcell, (hh[0], cc[0])), iters=20)
    H4, Vp = 4 * HIDDEN, packed["vocab_padded"]
    # bytes: weights, bias, x (layer 0: ctx, tokens, the emb table), h in, c in/out, h out
    lb = ((2 * EMBED + HIDDEN) * H4 * 2 + H4 * 4 + BATCH * EMBED * 2 + BATCH * 4 + Vp * EMBED * 2
          + BATCH * HIDDEN * 2 * 4)
    lb += 2 * HIDDEN * H4 * 2 + H4 * 4 + BATCH * HIDDEN * 2 + BATCH * HIDDEN * 2 * 4
    lf = 2 * BATCH * (2 * EMBED + HIDDEN) * H4 + 2 * BATCH * 2 * HIDDEN * H4
    bnd_l, by_l = bound_ms(lb / LAYERS, lf / LAYERS, "bfloat16")
    ms_vk = time_ms(lambda: vocab_argmax_step(hh[0], packed["w_out"], packed["b_out"], tok, fin, out, 0, 2, 0), iters=20)
    ms_vp = time_ms(lambda: vocab_argmax_step_plain(hh[0], packed["w_out"], packed["b_out"], tok, fin, out, 0, 2, 0), iters=20)
    bnd_v, by_v = bound_ms(BATCH * HIDDEN * 2 + HIDDEN * Vp * 2 + Vp * 4 + BATCH * 4 * 4,
                           2 * BATCH * HIDDEN * Vp, "bfloat16")
    ms_dk = time_ms(lambda: greedy_decode(packed, ctxb, MAX_LEN, 1, END_ID, 0), iters=3, warmup=1)
    ms_dp = time_ms(lambda: greedy_decode_plain(packed, ctxb, MAX_LEN, 1, END_ID, 0), iters=3, warmup=1)
    log(f"lstm_layer_step bf16 B={BATCH} (mean of layers 0 and 1): kernel {ms_lk:.4f} ms, plain {ms_lp:.4f} ms, "
        f"nn.LSTMCell (layer 0, no gather) {ms_ll:.4f} ms, bound {bnd_l:.4f} ms ({by_l}) [{card}]")
    log(f"vocab_argmax_step bf16 B={BATCH}: kernel {ms_vk:.4f} ms, plain {ms_vp:.4f} ms, "
        f"bound {bnd_v:.4f} ms ({by_v}) [{card}]")
    log(f"greedy_decode bf16 B={BATCH} T={MAX_LEN}: kernels {ms_dk:.3f} ms, plain {ms_dp:.3f} ms [{card}]")
    src = "img2latex_tpu_torch/csrc/greedy_decode.cu"
    rep = "img2latex_tpu/ops/pallas/decode_step.py:523"
    kernels["lstm_layer_step"] = dict(
        name="lstm_layer_step", route="cuda", source=src, replaces=rep, max_abs_err=step_errs["float32"][0],
        ms=ms_lk, plain_ms=ms_lp, bound_ms=bnd_l, bound_by=by_l, library_ms=ms_ll)
    kernels["vocab_argmax_step"] = dict(
        name="vocab_argmax_step", route="cuda", source=src, replaces=rep, max_abs_err=step_errs["float32"][1],
        ms=ms_vk, plain_ms=ms_vp, bound_ms=bnd_v, bound_by=by_v, library_ms=None)

    # ---- phase 4: the main path end to end ---------------------------------
    tokenizer = LaTeXTokenizer(max_sequence_length=MAX_LEN)
    tokenizer.fit([" ".join(f"\\tok{i}" for i in range(VOCAB - 4))])
    check(tokenizer.vocab_size == VOCAB and tokenizer.end_token_id == END_ID, f"tokenizer vocab {tokenizer.vocab_size}")
    images = list(rng.integers(0, 256, size=(N_IMAGES, IMG_H, IMG_W, 1), dtype=np.uint8))
    pred = Predictor(cfg, model, tokenizer, batch_size=BATCH)  # on the card: no device named
    pred.predict_batch(images[:BATCH], return_ids=True)  # warm-up (cuDNN plans, packing)
    torch.cuda.synchronize()
    conv1_pool.launches = lstm_layer_step.launches = vocab_argmax_step.launches = 0
    t0 = time.perf_counter()
    ids = pred.predict_batch(images, return_ids=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv1_pool": conv1_pool.launches, "lstm_layer_step": lstm_layer_step.launches,
                "vocab_argmax_step": vocab_argmax_step.launches}
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
    # a random grid memory whose rows differ in scale and mean, so that the
    # attention (nearly uniform with random weights) gives rows distinct contexts
    gmem = (np.maximum(rng.standard_normal((BATCH, GRID_S, GRID_EMBED), dtype=np.float32), 0)
            * rng.uniform(0, 3, (BATCH, 1, 1)).astype(np.float32)
            + 2 * np.maximum(rng.standard_normal((BATCH, 1, GRID_EMBED), dtype=np.float32), 0))
    gmem = torch.from_numpy(gmem).to(dev)
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

    # ---- report --------------------------------------------------------------
    order = ("conv1_pool", "conv1_pool[bias=0]", "lstm_layer_step", "vocab_argmax_step", "attend_step")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in keys} for n in order]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Ragged shapes the main path does not reach (batches and widths that are not
multiples of the kernels' tiles, one row, exact argmax ties, attention
widths A != H, slot counts S that are not multiples of 8, early exit and
the score signals; the beam step with exact ties across beams, every row
finished, one beam, a ragged last block of samples, beams wider than a
block's 16 rows and a sample whose logits spill to device memory; attention
over memories shared by several rows; the sampling step with top-k at or
beyond the vocab, all mass on one token, finished rows, a vocab whose
logits spill to device memory, and whole sampling decodes; the training
LSTM's forward and backward with an odd batch, one step, a hidden width that
is not a multiple of the tile, zero and random initial states, and its
gradients against a float64 plain layer; conv1_pool's backward; the kernels
without a backward refusing inputs that require grad; the conv-pool kernel
of the channel-first chain and of ``fused_conv_relu_pool`` at odd channel
counts, heights and widths in both layouts, conv1_pool's NHWC output, a
non-contiguous input refused, a refused launch reported, and
``convblock_cf``'s backward) at small sizes; and the bf16 tensor-core
kernels at the main path's widths (``lstm_layer_step`` at B = 512 and 2560
rows, the conv-pool kernel at the chain blocks' channel counts, the vocab
argmax kernel at H = 384 and 512 with every signal, ragged rows, Vp = 128 and
640, and exact ties across lanes, warps, slices and cluster ranks), with an
odd H, and with an input 2 bytes past an aligned address; the attention
kernel with a block a memory row at rows_per_mem 1, 5 and 17, long memories
read in tiles, and widths that are not whole 16-byte groups; the bf16
sampling and beam steps' cluster kernels (ragged B, K 1 to 32, Vp 128 to
640, top-k 1 to 64 and past the vocab, top-p 1, samples with fewer than K
totals above -1e30, 20 repeats bit for bit), the bf16 shapes left to the
block kernels, and each step's planner against the library's launch; the
bf16 conv1-pool tensor-core kernel (both layouts, Cout 8 to 128, widths
whose pooled rows are not whole 8- or 16-pixel runs, heights that are not
whole bands, 20 repeats bit for bit) and ``conv1_plan`` against the
library's launch.
Marked ``cuda``: without a CUDA device every test skips.  Imports no JAX, so
it runs on the card's machine with

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import ctypes

import numpy as np
import pytest
import torch

from img2latex_tpu_torch.decoding.decode import DecodeConfig
from img2latex_tpu_torch.ops import _build
from img2latex_tpu_torch.ops.conv1_lane import conv1_lane_relu_pool, conv1_lane_relu_pool_plain
from img2latex_tpu_torch.ops import conv1_phase as c1
from img2latex_tpu_torch.ops.conv1_phase import conv1_pool, conv1_pool_plain
from img2latex_tpu_torch.ops.conv_cf import convblock_cf, convblock_cf_plain, fused_convblock_cf
from img2latex_tpu_torch.ops.conv_pool import fused_conv_relu_pool, fused_conv_relu_pool_plain
from img2latex_tpu_torch.ops import lstm_train as lt
from img2latex_tpu_torch.ops import beam_decode as bd
from img2latex_tpu_torch.ops import decode_step as ds
from img2latex_tpu_torch.ops import grid_decode as ds_grid

pytestmark = pytest.mark.cuda

BF16_ULP = 2.0**-7  # one bf16 rounding step, relative


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 6, 10, 5), (1, 4, 300, 128), (2, 2, 2, 1)])
def test_conv1_pool(dev, dtype, shape):
    B, H, W, C = shape
    rng = np.random.default_rng(sum(shape))
    x = _t(rng.uniform(-1, 1, (B, H, W, 1)), dev, dtype)
    w = _t(rng.normal(size=(C, 1, 3, 3)) / 3, dev)
    b = _t(rng.normal(size=C) * 0.1, dev)
    got, ref = conv1_pool(x, w, b), conv1_pool_plain(x, w, b)
    assert got.dtype == dtype and tuple(got.shape) == (B, C, H // 2, W // 2)
    rtol = 0 if dtype == torch.float32 else BF16_ULP
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-5, rtol=rtol)


def test_conv1_pool_rejects_bad_input(dev):
    w, b = torch.zeros(4, 1, 3, 3, device=dev), torch.zeros(4, device=dev)
    with pytest.raises(ValueError):
        conv1_pool(torch.zeros(1, 5, 8, 1, device=dev), w, b)  # odd height
    with pytest.raises(TypeError):
        conv1_pool(torch.zeros(1, 4, 8, 1, device=dev, dtype=torch.float16), w, b)
    with pytest.raises(ValueError):
        conv1_pool(torch.zeros(1, 4, 8, 1, device=dev), torch.zeros(200, 1, 3, 3, device=dev),
                   torch.zeros(200, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,E,H,layer0", [
    (1, 40, 40, True), (70, 24, 40, True), (65, 40, 33, False),
    # the main path's widths: vector E0 = E1 = H = 512, grid E0 = E1 = 256, H = 384; B = 512 and
    # 2560 beam rows
    (512, 512, 512, True), (512, 512, 512, False), (2560, 512, 512, True),
    (512, 256, 384, True), (2560, 256, 384, False),
    # H odd: rows of 4H bf16 are not 16-byte multiples (the guarded loader), with the gather
    (33, 24, 45, True)])
def test_lstm_layer_step(dev, dtype, B, E, H, layer0):
    rng = np.random.default_rng(B + E + H)
    Vp = 128
    E0 = E if layer0 else 0
    tokens = torch.from_numpy(rng.integers(0, Vp, B).astype(np.int32)).to(dev) if layer0 else None
    emb = _t(rng.normal(size=(Vp, E)), dev, dtype) if layer0 else None
    x1 = _t(rng.normal(size=(B, E if layer0 else H)), dev, dtype)
    K = E0 + x1.shape[1]
    h_in = _t(rng.uniform(-1, 1, (B, H)), dev, dtype)
    w_ih = _t(rng.normal(size=(K, 4 * H)) / np.sqrt(K), dev, dtype)
    w_hh = _t(rng.normal(size=(H, 4 * H)) / np.sqrt(H), dev, dtype)
    bias = _t(rng.normal(size=4 * H) * 0.1, dev)
    c0 = _t(rng.uniform(-1, 1, (B, H)), dev, dtype)
    outs = []
    for step in (ds.lstm_layer_step, ds.lstm_layer_step_plain):
        c, h_out = c0.clone(), torch.empty_like(h_in)
        step(tokens, emb, x1, h_in, w_ih, w_hh, bias, c, h_out)
        outs.append((c, h_out))
    (ck, hk), (cp, hp) = outs
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=2 * BF16_ULP, rtol=0)
    torch.testing.assert_close(hk.float(), hp.float(), **tol)
    torch.testing.assert_close(ck.float(), cp.float(), **tol)


def test_lstm_layer_step_rejects_aliasing(dev):
    z = torch.zeros(2, 8, device=dev)
    with pytest.raises(ValueError):
        ds.lstm_layer_step(None, None, z, z, torch.zeros(8, 32, device=dev), torch.zeros(8, 32, device=dev),
                           torch.zeros(32, device=dev), z.clone(), z)


@pytest.mark.parametrize("B,H,Vp", [(1, 40, 128), (17, 64, 256), (33, 512, 512)])
def test_vocab_argmax_step_and_end_rule(dev, B, H, Vp):
    rng = np.random.default_rng(B * H)
    h = _t(rng.uniform(-1, 1, (B, H)), dev)
    w = rng.normal(size=(H, Vp)).astype(np.float32)
    w[:, Vp - 1] = w[:, 3]  # exact ties between columns 3 and Vp-1: 3 must win
    w_out, b_out = _t(w, dev), torch.zeros(Vp, device=dev)
    b_out[3] = b_out[Vp - 1] = 100.0
    T, t, end_id, pad_id = 5, 2, 3, 0
    fin0 = torch.from_numpy((np.arange(B) % 3 == 0).astype(np.int32)).to(dev)
    res = []
    for step in (ds.vocab_argmax_step, ds.vocab_argmax_step_plain):
        tok = torch.full((B,), -1, dtype=torch.int32, device=dev)
        fin, out = fin0.clone(), torch.full((B, T), -1, dtype=torch.int32, device=dev)
        step(h, w_out, b_out, tok, fin, out, t, end_id, pad_id)
        res.append((tok.cpu(), fin.cpu(), out.cpu()))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b)
    tok, fin, out = res[0]
    assert ((tok == pad_id) | (tok == end_id)).all()  # finished rows PAD, the rest tie-break to END
    assert fin.all() and (out[:, t] == tok).all() and (out[:, :t] == -1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocab_argmax_step_without_end_rule(dev, dtype):
    rng = np.random.default_rng(7)
    h = _t(rng.uniform(-1, 1, (9, 48)), dev, dtype)
    w_out = _t(rng.normal(size=(48, 256)), dev, dtype)
    b_out = _t(rng.normal(size=256), dev)
    got = torch.empty(9, dtype=torch.int32, device=dev)
    ds.vocab_argmax_step(h, w_out, b_out, got, None, None, 0, -1, 0)
    logits = h.float() @ w_out.float() + b_out
    top2 = torch.topk(logits, 2, dim=-1).values
    exact = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert (got.long() == logits.argmax(-1))[exact].all()


def test_greedy_decode_ragged_batch(dev):
    rng = np.random.default_rng(11)
    E = H = 40
    V, Vp, L, B, T = 50, 128, 2, 37, 12
    packed = {"num_layers": L, "hidden_dim": H, "vocab_padded": Vp, "vocab": V}
    emb = np.zeros((Vp, E), np.float32)
    emb[:V] = rng.normal(size=(V, E))
    packed["emb"] = _t(emb, dev)
    for i in range(L):
        k = 2 * E if i == 0 else H
        packed[f"w_ih_{i}"] = _t(rng.normal(size=(k, 4 * H)) / np.sqrt(k), dev)
        packed[f"w_hh_{i}"] = _t(rng.normal(size=(H, 4 * H)) / np.sqrt(H), dev)
        packed[f"b_{i}"] = _t(rng.normal(size=4 * H) * 0.1, dev)
    w_out = np.zeros((H, Vp), np.float32)
    w_out[:, :V] = rng.normal(size=(H, V))
    b_out = np.full(Vp, -1e30, np.float32)
    b_out[:V] = 0.0
    packed["w_out"], packed["b_out"] = _t(w_out, dev), _t(b_out, dev)
    ctx = _t(np.maximum(rng.normal(size=(B, E)), 0), dev)
    got = ds.greedy_decode(packed, ctx, T, 1, 2, 0)
    ref, margins = ds.greedy_decode_plain(packed, ctx, T, 1, 2, 0, return_margins=True)
    diff = (got != ref).cpu().numpy()
    first = diff.argmax(axis=1)
    for r in np.where(diff.any(axis=1))[0]:
        assert margins[r, first[r]].item() <= 1e-3, (r, first[r])
    assert got.max().item() < V


def _attention_operands(dev, dtype, B, S, E, H, A, seed):
    rng = np.random.default_rng(seed)
    h = _t(rng.uniform(-1, 1, (B, H)), dev, dtype)
    w_h = _t(rng.normal(size=(H, A)) / np.sqrt(H), dev, dtype)
    v = _t(rng.normal(size=A) / np.sqrt(A), dev, dtype)
    u = _t(rng.normal(size=(B, S, A)), dev, dtype)
    mem = _t(np.maximum(rng.normal(size=(B, S, E)), 0), dev, dtype)
    return h, w_h, v, u, mem


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,E,H,A", [(1, 3, 8, 16, 16), (33, 13, 40, 24, 56), (37, 100, 36, 48, 20),
                                       (70, 7, 256, 96, 384), (5, 9, 30, 17, 11)])
def test_attend_step(dev, dtype, B, S, E, H, A):
    """Ragged shapes: B not a multiple of the product's 32 rows, S not a
    multiple of 8, A != H, and widths that are not whole 16-byte groups (the
    scalar-load instantiation)."""
    h, w_h, v, u, mem = _attention_operands(dev, dtype, B, S, E, H, A, B + S + E)
    got = ds_grid.attend_step(h, w_h, v, u, mem, torch.empty(B, E, device=dev, dtype=dtype))
    ref = ds_grid.attend_step_plain(h, w_h, v, u, mem, torch.empty(B, E, device=dev, dtype=dtype))
    assert got.dtype == dtype and tuple(got.shape) == (B, E)
    # float32: sums in another order; bf16: 2 ulps of |ref| (a rounded weight or product may differ)
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-5, rtol=2 * BF16_ULP)
    torch.testing.assert_close(got.float(), ref.float(), **tol)


def test_attend_step_rejects_bad_input(dev):
    h, w_h, v, u, mem = _attention_operands(dev, torch.float32, 4, 5, 8, 16, 16, 0)
    ctx = torch.empty(4, 8, device=dev)
    with pytest.raises(ValueError):
        ds_grid.attend_step(h, w_h, v, u[:, :4], mem, ctx)  # S disagrees
    with pytest.raises(ValueError):
        ds_grid.attend_step(h, w_h, v.to(torch.bfloat16), u, mem, ctx)  # mixed dtypes


def _small_decoder(dev, rng, E, H, V, Vp, L=2):
    packed = {"num_layers": L, "hidden_dim": H, "vocab_padded": Vp, "vocab": V}
    emb = np.zeros((Vp, E), np.float32)
    emb[:V] = rng.normal(size=(V, E))
    packed["emb"] = _t(emb, dev)
    for i in range(L):
        k = 2 * E if i == 0 else H
        packed[f"w_ih_{i}"] = _t(rng.normal(size=(k, 4 * H)) / np.sqrt(k), dev)
        packed[f"w_hh_{i}"] = _t(rng.normal(size=(H, 4 * H)) / np.sqrt(H), dev)
        packed[f"b_{i}"] = _t(rng.normal(size=4 * H) * 0.1, dev)
    w_out = np.zeros((H, Vp), np.float32)
    w_out[:, :V] = rng.normal(size=(H, V))
    b_out = np.full(Vp, -1e30, np.float32)
    b_out[:V] = rng.normal(size=V) * 0.1
    b_out[2] = b_out[:V].max() + 0.2  # END (id 2) ends rows at varied steps
    packed["w_out"], packed["b_out"] = _t(w_out, dev), _t(b_out, dev)
    return packed


@pytest.mark.parametrize("signal", ["logp", "margin", "entropy", "margin_logp:0.5"])
@pytest.mark.parametrize("B,H,Vp", [(1, 40, 128), (17, 64, 256), (33, 96, 512)])
def test_vocab_argmax_step_scores(dev, signal, B, H, Vp):
    rng = np.random.default_rng(B + H)
    h = _t(rng.uniform(-1, 1, (B, H)), dev)
    w = np.zeros((H, Vp), np.float32)
    V = Vp - 37
    w[:, :V] = rng.normal(size=(H, V))
    w[:, 5] = w[:, 9]  # exact tie of columns 5 and 9 in every row
    b = np.full(Vp, -1e30, np.float32)
    b[:V] = rng.normal(size=V)
    b[5] = b[9] = 30.0
    w_out, b_out = _t(w, dev), _t(b, dev)
    fin0 = torch.from_numpy((np.arange(B) % 4 == 1).astype(np.int32)).to(dev)
    res = []
    for step in (ds.vocab_argmax_step, ds.vocab_argmax_step_plain):
        tok = torch.empty(B, dtype=torch.int32, device=dev)
        fin = fin0.clone()
        score = torch.full((B,), 0.5, device=dev)
        step(h, w_out, b_out, tok, fin, None, 0, 2, 0, score=score, signal=signal)
        res.append((tok, fin, score))
    (tk, fk, sk), (tp, fp, sp) = res
    assert torch.equal(tk, tp) and torch.equal(fk, fp)
    assert torch.equal(sk[fin0 == 1], sp[fin0 == 1])  # finished rows add nothing
    torch.testing.assert_close(sk, sp, atol=1e-4, rtol=1e-5)
    if signal == "margin":  # the tie: the runner-up is the twin column
        assert (sk[fin0 == 0] == 0.5).all()


@pytest.mark.parametrize("kind", ["vector", "grid"])
@pytest.mark.parametrize("B,S", [(37, 13), (5, 100)])
def test_early_exit_and_scores_ragged(dev, kind, B, S):
    rng = np.random.default_rng(B * S)
    E, H, A, V, Vp, T = 40, 48, 48, 50, 128, 40
    packed = _small_decoder(dev, rng, E, H, V, Vp)
    mem = _t(np.maximum(rng.normal(size=(B, S, E)), 0), dev)
    if kind == "grid":
        att = {"w_h": _t(rng.normal(size=(H, A)) / np.sqrt(H), dev),
               "w_m": _t(rng.normal(size=(E, A)) / np.sqrt(E), dev),
               "b": _t(rng.normal(size=A) * 0.1, dev), "v": _t(rng.normal(size=A) / np.sqrt(A), dev),
               "attn_dim": A, "mem_dim": E, "hidden_dim": H}
        u = ds_grid.grid_memory_proj(att, mem)

        def run(fn, **kw):
            return fn(packed, att, mem, u, T, 1, 2, 0, **kw)

        kernel, plain = ds_grid.grid_greedy_decode, ds_grid.grid_greedy_decode_plain
    else:
        def run(fn, **kw):
            return fn(packed, mem[:, 0, :], T, 1, 2, 0, **kw)

        kernel, plain = ds.greedy_decode, ds.greedy_decode_plain
    full = run(kernel)
    before = ds.vocab_argmax_step.launches
    early, score = run(kernel, early_exit=True, return_scores=True, signal="margin")
    steps = ds.vocab_argmax_step.launches - before
    assert torch.equal(early, full)
    ends = (full == 2).any(dim=1)
    if bool(ends.all()):
        assert steps < T
    ref, ref_score, margins = run(plain, return_scores=True, signal="margin", return_margins=True)
    diff = (full != ref).cpu().numpy()
    first = diff.argmax(axis=1)
    for r in np.where(diff.any(axis=1))[0]:
        assert margins[r, first[r]].item() <= 1e-3, (r, first[r])
    same = ~torch.from_numpy(diff.any(axis=1)).to(dev)
    torch.testing.assert_close(score[same], ref_score[same], atol=1e-3, rtol=0)


def _beam_operands(dev, dtype, B, K, H, Vp, L, seed, tie=False, all_finished=False):
    """Random beam-step operands: scores with the dead beams of t = 0 in
    some samples, some finished rows; with ``tie`` each sample's beams have
    equal h and scores, so every candidate ties across the K beams."""
    rng = np.random.default_rng(seed)
    N = B * K
    h = rng.uniform(-1, 1, (N, H)).astype(np.float32)
    scores = rng.uniform(-5, 0, N).astype(np.float32)
    scores.reshape(B, K)[::3, 1:] = -1e30  # samples at t = 0: only beam 0 live
    fin = (rng.uniform(size=N) < 0.2).astype(np.int32)
    if all_finished:  # a decode has no dead beams once rows have ended
        scores = rng.uniform(-5, 0, N).astype(np.float32)
    if tie:
        h = np.repeat(h[::K], K, axis=0)
        scores = np.repeat(scores[::K], K)
        fin[:] = 0
    if all_finished:
        fin[:] = 1
    w = np.zeros((H, Vp), np.float32)
    V = Vp - 5
    w[:, :V] = rng.normal(size=(H, V)) / np.sqrt(H) * 3
    b = np.full(Vp, -1e30, np.float32)
    b[:V] = rng.normal(size=V) * 0.3
    carries = rng.uniform(-1, 1, (2, L, N, H)).astype(np.float32)
    return dict(h=_t(h, dev, dtype), w_out=_t(w, dev, dtype), b_out=_t(b, dev),
                scores=_t(scores, dev), fin=torch.from_numpy(fin).to(dev),
                h_src=_t(carries[0], dev, dtype), c_src=_t(carries[1], dev, dtype))


def _run_beam_step(step, op, K, T=4, t=1, end_id=2, pad_id=0):
    N = op["h"].shape[0]
    scores, fin = op["scores"].clone(), op["fin"].clone()
    tokens = torch.full((N,), -1, dtype=torch.int32, device=scores.device)
    tok_hist = torch.full((T, N), -1, dtype=torch.int32, device=scores.device)
    par_hist = torch.full((T, N), -1, dtype=torch.int32, device=scores.device)
    h_dst, c_dst = torch.empty_like(op["h_src"]), torch.empty_like(op["c_src"])
    step(op["h"], op["w_out"], op["b_out"], scores, fin, tokens, tok_hist, par_hist, t, K, end_id,
         pad_id, op["h_src"], h_dst, op["c_src"], c_dst)
    return dict(scores=scores, fin=fin, tokens=tokens, tok_hist=tok_hist, par_hist=par_hist,
                h_dst=h_dst, c_dst=c_dst)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,H,Vp,L", [(1, 1, 40, 128, 1), (7, 3, 33, 128, 2), (5, 8, 64, 256, 2),
                                        (3, 16, 40, 128, 1), (11, 5, 96, 512, 2), (17, 1, 48, 256, 2),
                                        (3, 20, 40, 128, 1), (2, 20, 64, 512, 2), (2, 120, 40, 512, 1)])
@pytest.mark.parametrize("case", ["random", "tie", "all_finished"])
def test_beam_step(dev, dtype, B, K, H, Vp, L, case):
    """Ragged last blocks (B not a multiple of 16 // K), K = 1, K = 16 (a
    block's rows), K = 20 (a block a sample, its product in two calls and a
    block-wide selection), K = 120 at Vp = 512 (the logits in device-memory
    scratch), exact ties across beams (the lowest beam must win), every
    row finished (PAD at +0, identity parents, scores unchanged)."""
    op = _beam_operands(dev, dtype, B, K, H, Vp, L, B * K + H, tie=case == "tie",
                        all_finished=case == "all_finished")
    got = _run_beam_step(bd.beam_step, op, K)
    ref = _run_beam_step(bd.beam_step_plain, op, K)
    for name in ("fin", "tokens", "tok_hist", "par_hist", "h_dst", "c_dst"):
        assert torch.equal(got[name], ref[name]), name
    torch.testing.assert_close(got["scores"], ref["scores"], atol=1e-5, rtol=1e-6)
    par = got["par_hist"][1].view(B, K).long()
    if case == "tie":
        # K equal best candidates, one in each beam: pick n is beam n's (lowest flat index first)
        assert torch.equal(par, torch.arange(K, device=dev).expand(B, K))
        assert (got["tokens"].view(B, K) == got["tokens"].view(B, K)[:, :1]).all()
    if case == "all_finished":
        # only PAD at +0 is left: the beams in order of score, their scores unchanged
        old = op["scores"].view(B, K)
        assert (got["tokens"] == 0).all() and got["fin"].all()
        assert torch.equal(got["scores"].view(B, K), old.gather(1, par))
        assert torch.equal(got["scores"].view(B, K), old.sort(dim=1, descending=True).values)
    assert (got["tok_hist"][[0, 2, 3]] == -1).all()


def test_beam_step_rejects_bad_input(dev):
    op = _beam_operands(dev, torch.float32, 2, 3, 16, 128, 1, 0)
    with pytest.raises(ValueError):
        _run_beam_step(bd.beam_step, op, 0)
    with pytest.raises(ValueError):
        _run_beam_step(bd.beam_step, op, 4)  # 6 rows are not samples of 4 beams
    with pytest.raises(ValueError):
        bd.beam_step(op["h"], op["w_out"], op["b_out"], op["scores"], op["fin"],
                     torch.empty(6, dtype=torch.int32, device=dev),
                     torch.empty(2, 6, dtype=torch.int32, device=dev),
                     torch.empty(2, 6, dtype=torch.int32, device=dev), 0, 3, 2, 0,
                     op["h_src"], op["h_src"], op["c_src"], torch.empty_like(op["c_src"]))  # aliasing


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,R,S,E,H,A", [(3, 5, 13, 40, 24, 56), (4, 2, 100, 256, 96, 384), (2, 3, 9, 30, 17, 11)])
def test_attend_step_rows_per_mem(dev, dtype, M, R, S, E, H, A):
    """R rows share each memory row: equal to the plain version, and bit for
    bit to the kernel on the memory repeated R times."""
    h, w_h, v, u, mem = _attention_operands(dev, dtype, M * R, S, E, H, A, M + R + S)
    u, mem = u[:M].contiguous(), mem[:M].contiguous()
    ctx = torch.empty(M * R, E, device=dev, dtype=dtype)
    got = ds_grid.attend_step(h, w_h, v, u, mem, ctx.clone(), rows_per_mem=R)
    ref = ds_grid.attend_step_plain(h, w_h, v, u, mem, ctx.clone(), rows_per_mem=R)
    rep = ds_grid.attend_step(h, w_h, v, u.repeat_interleave(R, 0), mem.repeat_interleave(R, 0), ctx.clone())
    assert torch.equal(got, rep)
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-5, rtol=2 * BF16_ULP)
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    with pytest.raises(ValueError):
        ds_grid.attend_step(h[:-1], w_h, v, u, mem, ctx[:-1], rows_per_mem=R)


@pytest.mark.parametrize("kind", ["vector", "grid"])
@pytest.mark.parametrize("B,K", [(13, 3), (4, 5), (9, 1)])
def test_beam_decode_ragged(dev, kind, B, K):
    """Whole beam decodes, float32, held against the plain version step by
    step (``beam_decode.beam_divergence``): before a sample's histories
    part, each step adds to each beam's score within 5e-5 of the plain
    version and the scores stay within 1e-4; they first part only at a
    near-tie of the plain totals (1e-4 plus twice the score difference
    before it); and with equal histories its best
    tokens differ only at a near-tie of the final choice; early exit gives
    the full loop's tokens."""
    rng = np.random.default_rng(B * K)
    E, H, A, V, Vp, T, S = 40, 48, 48, 50, 128, 30, 11
    packed = _small_decoder(dev, rng, E, H, V, Vp)
    mem = _t(np.maximum(rng.normal(size=(B, S, E)), 0), dev)
    cfg = DecodeConfig(max_length=T, beam_size=K, length_penalty=0.5)
    if kind == "grid":
        att = {"w_h": _t(rng.normal(size=(H, A)) / np.sqrt(H), dev),
               "w_m": _t(rng.normal(size=(E, A)) / np.sqrt(E), dev),
               "b": _t(rng.normal(size=A) * 0.1, dev), "v": _t(rng.normal(size=A) / np.sqrt(A), dev),
               "attn_dim": A, "mem_dim": E, "hidden_dim": H}
        u = ds_grid.grid_memory_proj(att, mem)

        def run(fn, c, **kw):
            return fn(packed, att, mem, u, K, c, **kw)

        kernel, plain = ds_grid.grid_beam_decode, ds_grid.grid_beam_decode_plain
    else:
        def run(fn, c, **kw):
            return fn(packed, mem[:, 0, :], K, c, **kw)

        kernel, plain = bd.beam_decode, bd.beam_decode_plain
    n0 = bd.beam_step.launches
    tokens, scores = run(kernel, cfg)
    assert bd.beam_step.launches - n0 == T
    got_trace, ref_trace = {}, {}
    assert torch.equal(run(kernel, cfg, trace=got_trace)[0], tokens)
    ref, ref_scores = run(plain, cfg, trace=ref_trace)
    div = bd.beam_divergence(got_trace, ref_trace)
    drift = div["drift"]
    assert (drift <= 1e-4).all() and (div["step_err"] <= 5e-5).all(), div
    parted = div["first"] < T
    assert (div["gap"][parted] <= 1e-4 + 2 * drift[parted]).all(), div
    diff = (tokens != ref).any(dim=1)
    assert (ref_trace["choice_gap"][diff & ~parted] <= drift[diff & ~parted] + 1e-5).all()
    same = ~diff
    torch.testing.assert_close(scores[same], ref_scores[same], atol=1e-4, rtol=1e-5)
    early, _ = run(kernel, DecodeConfig(max_length=T, beam_size=K, length_penalty=0.5, early_exit=True))
    assert torch.equal(early, tokens)


def _sample_operands(dev, dtype, B, H, Vp, V, seed):
    rng = np.random.default_rng(seed)
    h = _t(rng.uniform(-1, 1, (B, H)), dev, dtype)
    w = np.zeros((H, Vp), np.float32)
    w[:, :V] = rng.normal(size=(H, V)) * 2 / np.sqrt(H)
    w[:, 5] = w[:, 9]  # exact ties of columns 5 and 9
    b = np.full(Vp, -1e30, np.float32)
    b[:V] = rng.normal(size=V) * 0.3
    h[0] = 0  # row 0: the bias alone; all its mass on column 3
    b[3] = 50.0
    return h, _t(w, dev, dtype), _t(b, dev)


def _run_sample_step(step, h, w_out, b_out, fin0, T=5, t=2, **kw):
    B = h.shape[0]
    tok = torch.full((B,), -1, dtype=torch.int32, device=h.device)
    fin = fin0.clone()
    out = torch.full((B, T), -1, dtype=torch.int32, device=h.device)
    step(h, w_out, b_out, tok, fin, out, t, 2, 0, **kw)
    return tok, fin, out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Vp,V", [(1, 40, 128, 100), (37, 64, 256, 250), (70, 48, 384, 300),
                                      (19, 32, 4096, 4000)])
@pytest.mark.parametrize("kw", [dict(top_k=5), dict(top_p=0.9), dict(top_k=10, top_p=0.8),
                                dict(top_k=1), dict(top_k=1000), dict(top_k=1000, top_p=1.0),
                                dict(top_p=0.3, batch_tile=7)])
def test_vocab_sample_step(dev, dtype, B, H, Vp, V, kw):
    """Ragged B, Vp not a power of two (384), a vocab whose logits and keys
    spill to device memory (4096), top_k >= Vp, top_p = 1, a row with all
    its mass on one token, finished rows, several tiles of the random
    stream: the kernel draws the plain version's tokens except where the
    plain version is within a rounding step of a knife edge."""
    h, w_out, b_out = _sample_operands(dev, dtype, B, H, Vp, V, B + Vp)
    fin0 = torch.from_numpy((np.arange(B) % 5 == 4).astype(np.int32)).to(dev)
    kw = dict(seed=-7, **kw)
    tk, fk, ok = _run_sample_step(ds.vocab_sample_step, h, w_out, b_out, fin0, **kw)
    gaps, mass = torch.full((B, 5), float("inf"), device=dev), torch.full((B, 5), float("inf"), device=dev)
    tp, fp, op = _run_sample_step(ds.vocab_sample_step_plain, h, w_out, b_out, fin0, gaps=gaps, mass_gaps=mass,
                                  **kw)
    edge = (gaps[:, 2] <= 1e-4) | (mass[:, 2] <= 1e-5)
    assert ((tk == tp) | edge).all() and int((tk != tp).sum()) <= max(1, B // 20)
    assert torch.equal(fk, torch.maximum(fin0, (tk == 2).int())) and torch.equal(ok[:, 2], tk)
    assert (ok[:, [0, 1, 3, 4]] == -1).all()
    assert (tk[fin0 == 1] == 0).all() and (tk[fin0 == 0] < V).all()
    assert tk[0] == 3  # all the mass on one token


def test_vocab_sample_step_rejects_bad_input(dev):
    h, w_out, b_out = _sample_operands(dev, torch.float32, 4, 16, 128, 100, 0)
    fin = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        _run_sample_step(ds.vocab_sample_step, h, w_out, b_out, fin, top_k=0, top_p=0.0)
    with pytest.raises(TypeError):
        _run_sample_step(ds.vocab_sample_step, h, w_out.to(torch.bfloat16), b_out, fin, top_k=3)
    with pytest.raises(ValueError):
        _run_sample_step(ds.vocab_sample_step, h, w_out[:, :100].contiguous(), b_out[:100].contiguous(), fin,
                         top_k=3)


def test_vocab_sample_step_draws_follow_the_probabilities(dev):
    """One row's logits repeated over 4096 rows (their own uniforms): the
    kernel's draws stay inside the support of ``next_token_probs`` and
    follow it (chi-square p >= 1e-3)."""
    from scipy import stats

    from img2latex_tpu_torch.decoding.decode import next_token_probs

    rng = np.random.default_rng(1)
    H, Vp, V, n = 32, 256, 200, 4096
    h1, w_out, b_out = _sample_operands(dev, torch.float32, 2, H, Vp, V, 5)
    b_out[3] = 0.0  # not all the mass on one token
    h = h1[1:].expand(n, H).contiguous()
    cfg = DecodeConfig(top_k=30, top_p=0.9)
    tok = torch.empty(n, dtype=torch.int32, device=dev)
    ds.vocab_sample_step(h, w_out, b_out, tok, None, None, 0, 2, 0, seed=int(rng.integers(1 << 30)),
                         top_k=cfg.top_k, top_p=cfg.top_p)
    probs = next_token_probs((h[:1].float() @ w_out + b_out)[:, :V], cfg)[0].double().cpu()
    counts = torch.bincount(tok.long().cpu(), minlength=V).double()
    support = probs > 0
    assert counts[~support].sum() == 0
    expected = probs[support] / probs[support].sum() * n
    assert stats.chisquare(counts[support].numpy(), expected.numpy()).pvalue >= 1e-3


@pytest.mark.parametrize("kind", ["vector", "grid"])
@pytest.mark.parametrize("B,kw", [(37, dict(top_k=10, top_p=0.8, temperature=0.8)), (5, dict(top_k=4)),
                                  (21, dict(top_p=0.95, temperature=1.4))])
def test_sample_decode_ragged(dev, kind, B, kw):
    """Whole sampling decodes, float32, a tile of 8 rows: every row that
    differs from the plain version first differs at a knife edge of the
    plain version's step; early exit gives the full loop's tokens; one
    vocab_sample_step launch a step."""
    rng = np.random.default_rng(B)
    E, H, A, V, Vp, T, S = 40, 48, 48, 50, 128, 30, 11
    packed = _small_decoder(dev, rng, E, H, V, Vp)
    mem = _t(np.maximum(rng.normal(size=(B, S, E)), 0), dev)
    kw = dict(kw, seed=3, batch_tile=8)
    top_k = kw.pop("top_k", 0)
    if kind == "grid":
        att = {"w_h": _t(rng.normal(size=(H, A)) / np.sqrt(H), dev),
               "w_m": _t(rng.normal(size=(E, A)) / np.sqrt(E), dev),
               "b": _t(rng.normal(size=A) * 0.1, dev), "v": _t(rng.normal(size=A) / np.sqrt(A), dev),
               "attn_dim": A, "mem_dim": E, "hidden_dim": H}
        u = ds_grid.grid_memory_proj(att, mem)

        def run(fn, **extra):
            return fn(packed, att, mem, u, T, 1, 2, 0, top_k, **kw, **extra)

        kernel, plain = ds_grid.grid_sample_decode, ds_grid.grid_sample_decode_plain
    else:
        def run(fn, **extra):
            return fn(packed, mem[:, 0, :], T, 1, 2, 0, top_k, **kw, **extra)

        kernel, plain = ds.sample_decode, ds.sample_decode_plain
    n0 = ds.vocab_sample_step.launches
    got = run(kernel)
    assert ds.vocab_sample_step.launches - n0 == T
    ref, gaps, mass = run(plain, return_gaps=True)
    diff = (got != ref).cpu().numpy()
    first = diff.argmax(axis=1)
    for r in np.where(diff.any(axis=1))[0]:
        assert gaps[r, first[r]].item() <= 1e-4 or mass[r, first[r]].item() <= 1e-5, (r, first[r])
    assert diff.any(axis=1).mean() <= 0.1
    assert torch.equal(run(kernel, early_exit=True), got)


def _lstm_op(dev, dtype, T, B, H, seed, zero_state=False):
    rng = np.random.default_rng(seed)
    op = {"gx": _t(rng.normal(size=(T, B, 4 * H)), dev, dtype),
          "h0": _t(rng.uniform(-1, 1, (B, H)), dev, dtype), "c0": _t(rng.uniform(-1, 1, (B, H)), dev, dtype),
          "w": _t(rng.normal(size=(4 * H, H)) / np.sqrt(H), dev, dtype),
          "cts": [_t(rng.normal(size=s), dev, dtype) for s in ((T, B, H), (B, H), (B, H))]}
    if zero_state:
        op["h0"].zero_()
        op["c0"].zero_()
    return op


def _lstm_run(fn, op, dtype=None):
    """(ys, hT, cT, dgates_x, dh0, dc0, dW_hh) of fn under op's cotangents, in ``dtype``."""
    leaves = [op[k].to(dtype or op[k].dtype).clone().requires_grad_() for k in ("gx", "h0", "c0", "w")]
    outs = fn(*leaves)
    grads = torch.autograd.grad(outs, leaves, [c.to(leaves[0].dtype) for c in op["cts"]])
    return [o.detach().double() for o in outs] + [g.double() for g in grads]


def _rel(got, ref):
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def _lstm_counts():
    return (lt.lstm_seq_fwd.launches, lt.lstm_seq_fwd.persistent_launches, lt.lstm_seq_fwd.step_launches,
            lt.lstm_seq_bwd.launches, lt.lstm_seq_bwd.persistent_launches, lt.lstm_seq_bwd.step_launches,
            lt.lstm_seq_bwd.dw_launches)


def _check_lstm_launches(before, dtype, T, B, H):
    """The launches of one forward and backward, per route, as seq_plan names them."""
    plan = lt.seq_plan(B, H, dtype)
    f, fp, fs, b, bp, bs, dw = (a - z for a, z in zip(_lstm_counts(), before))
    assert f == plan.fwd_launches(T) and b == plan.bwd_launches(T) and dw == 2
    assert (fp, fs) == ((1, 0) if plan.fwd.route == "persistent" else (0, T))
    assert (bp, bs) == ((1, 0) if plan.bwd.route == "persistent" else (0, T + 1))


def _lstm_against_plain(op, dtype, T, B, H, tol):
    before = _lstm_counts()
    got = _lstm_run(lt.lstm_seq, op)
    _check_lstm_launches(before, dtype, T, B, H)
    ys, cs, ga = lt.lstm_seq_fwd_plain(op["gx"], op["h0"], op["c0"], op["w"].t().contiguous())
    ref = [ys, ys[-1], cs[-1], *lt.lstm_seq_bwd_plain(*op["cts"], ga, cs, op["h0"], op["c0"], ys, op["w"])]
    for name, g, r in zip(("ys", "hT", "cT", "dgates_x", "dh0", "dc0", "dW_hh"), got, ref):
        assert torch.isfinite(g).all(), name
        assert _rel(g, r.double()) <= tol, (name, _rel(g, r.double()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,B,H", [(7, 5, 40), (1, 3, 64), (9, 70, 33), (4, 130, 96)])
@pytest.mark.parametrize("zero_state", [False, True])
def test_lstm_seq(dev, dtype, T, B, H, zero_state):
    """Kernel forward and backward against lstm_seq_fwd_plain / lstm_seq_bwd_plain
    (the same rounding points): float32 sums in another order (1e-5 of the
    largest value); in bf16 a stored value may round the other way (2^-6).
    The launches follow seq_plan's route: float32 (and bf16 at H = 33) T
    forward and T + 3 backward launches, bf16 persistent 1 and 3."""
    op = _lstm_op(dev, dtype, T, B, H, seed=T + B + H, zero_state=zero_state)
    _lstm_against_plain(op, dtype, T, B, H, 1e-5 if dtype == torch.float32 else 2.0**-6)


@pytest.mark.parametrize("H", [40, 384, 512, 640, 1024])
@pytest.mark.parametrize("B", [1, 17, 128, 130, 512])
@pytest.mark.parametrize("T", [1, 2, 140])
@pytest.mark.parametrize("zero_state", [False, True])
def test_lstm_seq_persistent(dev, T, B, H, zero_state):
    """bf16 on the persistent route (H = 640: its forward; H = 1024 by steps)
    against the plain versions within 2^-6 of the largest value, at ragged
    batches (1, 17, 130 rows), one and two steps, 140 steps, and zero and
    random initial states."""
    op = _lstm_op(dev, torch.bfloat16, T, B, H, seed=7 * T + 3 * B + H + zero_state, zero_state=zero_state)
    _lstm_against_plain(op, torch.bfloat16, T, B, H, 2.0**-6)


def test_lstm_seq_persist_shape(dev):
    """The library's persistent launches take the shared memory and the
    clusters (a tile of seq_plan's rows each) that seq_plan computes, and at
    least one cluster fits the card."""
    for B in (17, 130, 512):
        for H in (40, 384, 512, 640):
            plan = lt.seq_plan(B, H, torch.bfloat16)
            for direction, route in (("fwd", plan.fwd), ("bwd", plan.bwd)):
                if route.route != "persistent":
                    continue
                shape = lt.persist_shape(B, H, route, direction)
                assert shape["smem_bytes"] == route.smem_bytes, (B, H, direction, shape)
                assert shape["clusters"] == -(-B // route.rows), (B, H, direction, shape)
                assert shape["max_active_clusters"] >= 1, (B, H, direction, shape)


@pytest.mark.parametrize("H,direction,rows", [(384, "fwd", 16), (384, "fwd", 32), (384, "bwd", 16), (384, "bwd", 32),
                                              (512, "fwd", 16), (512, "fwd", 32), (512, "bwd", 16), (512, "bwd", 32),
                                              (640, "fwd", 16)])
def test_lstm_seq_co_resident_clusters(dev, H, direction, rows):
    """seq_plan picks 16 or 32 rows a cluster by the waves that
    co_resident_clusters predicts from CO_RESIDENT_SMS, a constant read once
    from the card, and the blocks an SM's shared memory holds; the library's
    cudaOccupancyMaxActiveClusters must give the same at every shipped
    width's persistent launches (B = 128, clusters of 16)."""
    smem = lt._fwd_smem if direction == "fwd" else lt._bwd_smem
    nbuf = next(n for n in (2, 1) if smem(H, H // 16, n, rows) <= lt.SMEM_LIMIT)
    route = lt.SeqRoute("persistent", 16, rows, nbuf, smem(H, H // 16, nbuf, rows))
    shape = lt.persist_shape(128, H, route, direction)
    assert shape["max_active_clusters"] == lt.co_resident_clusters(16, route.smem_bytes), (route, shape)


def test_lstm_seq_repeats_bit_for_bit(dev):
    """The train step's shapes (T = 140, B = 128, H = 512, bf16) 20 times:
    the outputs and every gradient equal the first run's bits.  A missing
    fence or barrier in the clusters' exchange, or a reduction whose order
    changes, shows here."""
    op = _lstm_op(dev, torch.bfloat16, 140, 128, 512, seed=12)
    first = _lstm_run(lt.lstm_seq, op)
    for _ in range(19):
        again = _lstm_run(lt.lstm_seq, op)
        for name, a, b in zip(("ys", "hT", "cT", "dgates_x", "dh0", "dc0", "dW_hh"), again, first):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("T,B,H", [(6, 5, 24), (3, 33, 40)])
def test_lstm_seq_gradient_against_float64(dev, T, B, H):
    """The kernel's float32 outputs and gradients against lstm_seq_plain in
    float64 (autograd of the plain layer): within 1e-4 of the largest value,
    float32 rounding over T steps."""
    op = _lstm_op(dev, torch.float32, T, B, H, seed=11 * T + B)
    got = _lstm_run(lt.lstm_seq, op)
    ref = _lstm_run(lt.lstm_seq_plain, op, dtype=torch.float64)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1_pool_backward(dev, dtype):
    """conv1_pool's backward (autograd of the plain version, recomputing the
    forward) equals autograd of conv1_pool_plain."""
    rng = np.random.default_rng(5)
    x = _t(rng.uniform(-1, 1, (3, 6, 10, 1)), dev, dtype)
    w, b = _t(rng.normal(size=(5, 1, 3, 3)) / 3, dev), _t(rng.normal(size=5) * 0.1, dev)
    g = _t(rng.normal(size=(3, 5, 3, 5)), dev, dtype)
    grads = []
    for fn in (conv1_pool, conv1_pool_plain):
        leaves = [x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
    for a, r in zip(*grads):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5)
    assert grads[0][1].abs().max().item() > 0


def test_kernels_without_backward_refuse_grad(dev):
    """lstm_layer_step, vocab_argmax_step, attend_step, beam_step and
    vocab_sample_step have no backward: given an input that requires grad
    with grad mode on, each raises before it launches."""
    B, H, Vp, S, E = 4, 32, 128, 3, 16
    h = torch.zeros(B, H, device=dev, requires_grad=True)
    w = torch.zeros(H, 4 * H, device=dev)
    b = torch.zeros(4 * H, device=dev)
    tok = torch.zeros(B, dtype=torch.int32, device=dev)
    w_out, b_out = torch.zeros(H, Vp, device=dev), torch.zeros(Vp, device=dev)
    fin = torch.zeros(B, dtype=torch.int32, device=dev)
    calls = {
        "lstm_layer_step": lambda: ds.lstm_layer_step(None, None, h, h.detach().clone(), w, w, b,
                                                      torch.zeros(B, H, device=dev),
                                                      torch.zeros(B, H, device=dev)),
        "vocab_argmax_step": lambda: ds.vocab_argmax_step(h, w_out, b_out, tok, fin, None, 0, 2, 0),
        "vocab_sample_step": lambda: ds.vocab_sample_step(h, w_out, b_out, tok, fin, None, 0, 2, 0, top_k=5),
        "attend_step": lambda: ds_grid.attend_step(h, torch.zeros(H, E, device=dev), torch.zeros(E, device=dev),
                                                   torch.zeros(B, S, E, device=dev), torch.zeros(B, S, E, device=dev),
                                                   torch.zeros(B, E, device=dev)),
    }
    for name, call in calls.items():
        before = {k: getattr(m, k).launches for m, k in ((ds, "lstm_layer_step"), (ds, "vocab_argmax_step"),
                                                          (ds, "vocab_sample_step"), (ds_grid, "attend_step"))}
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        after = {k: getattr(m, k).launches for m, k in ((ds, "lstm_layer_step"), (ds, "vocab_argmax_step"),
                                                         (ds, "vocab_sample_step"), (ds_grid, "attend_step"))}
        assert after == before, name
    op = _beam_operands(dev, torch.float32, 2, 2, H, Vp, 1, seed=0)
    op["h"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        _run_beam_step(bd.beam_step, op, 2)
    with torch.no_grad():
        ds.vocab_argmax_step(h, w_out, b_out, tok, fin, None, 0, 2, 0)  # under no_grad it runs


# B, Cin, Cout, H, W: odd channel counts, a Cout that is not a multiple of the
# 64-channel tile, widths and heights that are not multiples of the 4 x 16
# pooled tile, and Cout above one tile; then the chain's two blocks' channel
# counts (32 -> 64, 64 -> 128) on a small canvas
CONV_SHAPES = [(5, 3, 12, 8, 12), (5, 33, 12, 8, 12), (2, 1, 70, 6, 34), (1, 8, 130, 4, 66),
               (2, 32, 64, 16, 64), (2, 64, 128, 16, 64)]


def _conv_close(got, ref, dtype):
    """float32: sums in another order; bf16: one rounding step of |ref|."""
    scale = max(ref.float().abs().max().item(), 1.0)
    rtol = 0 if dtype == torch.float32 else BF16_ULP
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-5 * scale, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_convblock_cf(dev, dtype, shape):
    B, Cin, Cout, H, W = shape
    rng = np.random.default_rng(sum(shape))
    x = _t(rng.normal(size=(B, Cin, H, W)), dev, dtype)
    w = _t(rng.normal(size=(Cout, Cin, 3, 3)) / np.sqrt(9 * Cin), dev)
    b = _t(rng.normal(size=Cout) * 0.1, dev)
    before = convblock_cf.launches
    with torch.no_grad():
        got = fused_convblock_cf(x, w, b)
    assert convblock_cf.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (B, Cout, H // 2, W // 2)
    _conv_close(got, convblock_cf_plain(x, w, b), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_fused_conv_relu_pool(dev, dtype, shape):
    B, Cin, Cout, H, W = shape
    rng = np.random.default_rng(sum(shape) + 1)
    x = _t(rng.normal(size=(B, H, W, Cin)), dev, dtype)
    w = _t(rng.normal(size=(Cout, Cin, 3, 3)) / np.sqrt(9 * Cin), dev)
    before = fused_conv_relu_pool.launches
    got = fused_conv_relu_pool(x, w)
    assert fused_conv_relu_pool.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (B, H // 2, W // 2, Cout)
    _conv_close(got, fused_conv_relu_pool_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 6, 10, 5), (1, 4, 300, 128)])
def test_conv1_pool_nhwc(dev, dtype, shape):
    B, H, W, C = shape
    rng = np.random.default_rng(sum(shape) + 2)
    x = _t(rng.uniform(-1, 1, (B, H, W, 1)), dev, dtype)
    w = _t(rng.normal(size=(C, 1, 3, 3)) / 3, dev)
    b = _t(rng.normal(size=C) * 0.1, dev)
    got = conv1_pool(x, w, b, layout="nhwc")
    assert tuple(got.shape) == (B, H // 2, W // 2, C)
    _conv_close(got, conv1_pool_plain(x, w, b, layout="nhwc"), dtype)
    torch.testing.assert_close(got, conv1_pool(x, w, b, layout="nchw").permute(0, 2, 3, 1), atol=0, rtol=0)
    _conv_close(conv1_lane_relu_pool(x, w), conv1_lane_relu_pool_plain(x, w), dtype)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_conv_pool_unaligned_input(dev, layout):
    """A contiguous bf16 input 2 bytes past an aligned address takes the
    guarded element loader of the tensor-core kernel in both layouts."""
    B, Cin, Cout, H, W = 2, 16, 64, 8, 34
    rng = np.random.default_rng(7)
    flat = _t(rng.normal(size=B * Cin * H * W + 1), dev, torch.bfloat16)
    shape = (B, Cin, H, W) if layout == "nchw" else (B, H, W, Cin)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 4 == 2
    w = _t(rng.normal(size=(Cout, Cin, 3, 3)) / 12, dev)
    b = _t(rng.normal(size=Cout) * 0.1, dev)
    if layout == "nchw":
        got, ref = fused_convblock_cf(x, w, b), convblock_cf_plain(x, w, b)
    else:
        got, ref = fused_conv_relu_pool(x, w), fused_conv_relu_pool_plain(x, w)
    _conv_close(got, ref, torch.bfloat16)


def test_conv_pool_refuses_bad_input(dev):
    """A non-contiguous input, an odd width, a wrong weight are refused
    before a launch; a launch the C side refuses is reported."""
    x = torch.zeros(1, 4, 8, 8, device=dev)
    w, b = torch.zeros(6, 4, 3, 3, device=dev), torch.zeros(6, device=dev)
    before = convblock_cf.launches
    with pytest.raises(ValueError, match="contiguous"):
        fused_convblock_cf(x.transpose(2, 3), w, b)
    with pytest.raises(ValueError):
        fused_convblock_cf(torch.zeros(1, 4, 8, 7, device=dev), w, b)
    with pytest.raises(ValueError):
        fused_conv_relu_pool(torch.zeros(1, 8, 8, 3, device=dev), w)
    with pytest.raises(TypeError):
        fused_convblock_cf(x.half(), w, b)
    assert convblock_cf.launches == before
    out = torch.empty(1, 6, 4, 4, device=dev)
    err = _build.lib().i2l_conv_pool(x.data_ptr(), w.data_ptr(), None, out.data_ptr(),
                                     1, 4, 5, 8, 6, 0, 0, torch.cuda.current_stream().cuda_stream)  # odd H
    assert err != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(err, "i2l_conv_pool")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convblock_cf_backward(dev, dtype):
    """convblock_cf's backward (autograd of the plain version, recomputing
    the forward) equals autograd of convblock_cf_plain; the forward-only
    wrappers refuse inputs that require grad."""
    rng = np.random.default_rng(6)
    x = _t(rng.normal(size=(3, 5, 8, 12)), dev, dtype)
    w, b = _t(rng.normal(size=(7, 5, 3, 3)) / 6, dev), _t(rng.normal(size=7) * 0.1, dev)
    g = _t(rng.normal(size=(3, 7, 4, 6)), dev, dtype)
    grads = []
    for fn in (convblock_cf, convblock_cf_plain):
        leaves = [x.clone().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
    # cuDNN's gradient sums may change order from call to call: in bf16 a
    # float32 dx may then round to the neighbouring bf16 value
    rtol = 1e-5 if dtype == torch.float32 else BF16_ULP
    for a, r in zip(*grads):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=rtol)
    assert grads[0][1].abs().max().item() > 0
    with pytest.raises(RuntimeError, match="no backward"):
        fused_convblock_cf(x.clone().requires_grad_(), w, b)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_conv_relu_pool(x.permute(0, 2, 3, 1).contiguous(), w.clone().requires_grad_())


# ---- the bf16 vocab kernel: tensor cores, column slices merged across a cluster ----------------


def _vocab_operands(dev, B, H, Vp, seed, V=None):
    """bf16 h and W_out, float32 b_out with -1e30 past the first V columns."""
    rng = np.random.default_rng(seed)
    V = Vp - 9 if V is None else V
    w = np.zeros((H, Vp), np.float32)
    w[:, :V] = rng.normal(size=(H, V)) / np.sqrt(H)
    b = np.full(Vp, -1e30, np.float32)
    b[:V] = rng.normal(size=V) * 0.5
    return _t(rng.uniform(-1, 1, (B, H)), dev, torch.bfloat16), w, b


def _vocab_both(h, w_out, b_out, fin0, signal, T=4, t=1, end_id=2, pad_id=0):
    """The kernel and its plain version from the same state: (tokens, finished, out, score) each."""
    res = []
    for step in (ds.vocab_argmax_step, ds.vocab_argmax_step_plain):
        B = h.shape[0]
        tok = torch.full((B,), -1, dtype=torch.int32, device=h.device)
        fin = None if fin0 is None else fin0.clone()
        out = torch.full((B, T), -1, dtype=torch.int32, device=h.device)
        score = None if signal is None else torch.full((B,), 0.5, device=h.device)
        kw = {} if signal is None else dict(score=score, signal=signal)
        step(h, w_out, b_out, tok, fin, out, t, end_id, pad_id, **kw)
        res.append((tok, fin, out, score))
    return res


@pytest.mark.parametrize("signal", [None, "logp", "margin", "entropy", "margin_logp:0.5"])
@pytest.mark.parametrize("B,H,Vp", [(512, 384, 512), (512, 512, 512), (1, 512, 512), (17, 384, 512),
                                    (513, 512, 512), (33, 96, 128), (70, 64, 640), (9, 40, 256)])
def test_vocab_argmax_step_tc(dev, signal, B, H, Vp):
    """bf16 at the main path's shapes (B = 512, H = 384 and 512, Vp = 512) and ragged ones: rows
    past a 32-row tile, one row, Vp = 128 (a cluster of 2), Vp = 640 (10 slices over 8 ranks), an
    unaligned H (the guarded loader); finished rows.  Tokens equal the plain version's wherever its
    top-2 margin exceeds 1e-3 (the float32 sums are taken in another order), scores within 1e-3."""
    h, w, b = _vocab_operands(dev, B, H, Vp, B + H + Vp)
    w_out, b_out = _t(w, dev, torch.bfloat16), _t(b, dev)
    fin0 = torch.from_numpy((np.arange(B) % 5 == 3).astype(np.int32)).to(dev)
    (tk, fk, ok, sk), (tp, fp, op, sp) = _vocab_both(h, w_out, b_out, fin0, signal)
    logits = h.float() @ w_out.float() + b_out
    top2 = torch.topk(logits, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1] > 1e-3) | (fin0 == 1)
    assert clear.float().mean().item() > 0.9
    assert torch.equal(tk[clear], tp[clear]) and torch.equal(fk[clear], fp[clear])
    assert torch.equal(ok[clear], op[clear]) and (tk < Vp - 9).all()
    assert (tk[fin0 == 1] == 0).all()
    if signal is not None:
        assert torch.equal(sk[fin0 == 1], sp[fin0 == 1])  # finished rows add nothing
        torch.testing.assert_close(sk[clear], sp[clear], atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("Vp,pairs", [(128, [(5, 9), (5, 21), (3, 127)]),
                                      (512, [(5, 9), (5, 21), (3, 511), (70, 200)]),
                                      (640, [(70, 582), (3, 639), (63, 64)])])
@pytest.mark.parametrize("signal", [None, "margin"])
def test_vocab_argmax_step_tc_ties(dev, Vp, pairs, signal):
    """Exact ties whose two columns lie in one lane's pair, in two warps of a block, in two slices
    of two cluster ranks, or in two slices one rank walks (Vp = 640: slices 1 and 9): the lower
    index wins, and the margin is 0."""
    B, H = 40, 64
    for lo, hi in pairs:
        h, w, b = _vocab_operands(dev, B, H, Vp, lo + hi)
        w[:, hi] = w[:, lo]
        b[lo] = b[hi] = 30.0
        w_out, b_out = _t(w, dev, torch.bfloat16), _t(b, dev)
        fin0 = torch.from_numpy((np.arange(B) % 4 == 1).astype(np.int32)).to(dev)
        (tk, fk, _, sk), (tp, fp, _, sp) = _vocab_both(h, w_out, b_out, fin0, signal, end_id=hi)
        assert (tk[fin0 == 0] == lo).all() and torch.equal(tk, tp) and torch.equal(fk, fp), (lo, hi)
        assert torch.equal(fk, fin0)  # hi is END here, and it never wins
        if signal == "margin":
            assert (sk[fin0 == 0] == 0.5).all() and torch.equal(sk, sp)


def test_vocab_argmax_step_tc_launch_shape(dev):
    """128 blocks at B = 512, Vp = 512: 16 row tiles x a cluster of 8 column slices."""
    dims = (ctypes.c_int * 3)()
    smem = _build.lib().i2l_vocab_tc_launch_shape(512, 512, dims)
    assert tuple(dims) == (8, 16, 8) and smem > 48 * 1024
    _build.lib().i2l_vocab_tc_launch_shape(512, 128, dims)
    assert tuple(dims) == (2, 16, 2)


# ---- the attention kernel: a block per memory row, all its rows at once ------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,R,S,E,H,A", [
    (512, 1, 100, 256, 384, 384), (512, 5, 100, 256, 384, 384),   # the main path's widths
    (3, 17, 13, 40, 24, 56),      # more rows than a group (17 = 8 + 8 + 1)
    (4, 5, 200, 256, 96, 384),    # a long memory: two tiles in float32
    (2, 3, 300, 256, 48, 64),     # two tiles in bf16 too
    (3, 1, 13, 30, 17, 11),       # E and A not multiples of 8: the guarded path
    (2, 5, 100, 36, 48, 20),
    (5, 17, 200, 8, 16, 16)])
def test_attend_step_per_memory(dev, dtype, M, R, S, E, H, A):
    """rows_per_mem in {1, 5, 17}, S in {13, 100, 200, 300}: equal to the plain version within the
    tolerance of test_attend_step, and bit for bit to the kernel on the memory repeated R times (a
    row's context does not depend on how many rows share its memory)."""
    h, w_h, v, u, mem = _attention_operands(dev, dtype, M * R, S, E, H, A, M + R + S + E)
    u, mem = u[:M].contiguous(), mem[:M].contiguous()
    ctx = torch.empty(M * R, E, device=dev, dtype=dtype)
    got = ds_grid.attend_step(h, w_h, v, u, mem, ctx.clone(), rows_per_mem=R)
    ref = ds_grid.attend_step_plain(h, w_h, v, u, mem, ctx.clone(), rows_per_mem=R)
    tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(atol=1e-5, rtol=2 * BF16_ULP)
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    if R > 1:
        rep = ds_grid.attend_step(h, w_h, v, u.repeat_interleave(R, 0), mem.repeat_interleave(R, 0), ctx.clone())
        assert torch.equal(got, rep)


def test_attend_step_launch_shape(dev):
    """A block a memory row: 512 blocks at 512 rows and at 2560 rows of 5 beams, the grid
    flagship's memory row (100 x 256 bf16) staged whole, in the shared memory of four blocks an SM
    (one row a memory) or three (the registers of a group of 5 rows allow no more)."""
    dims = (ctypes.c_int * 3)()
    smem = _build.lib().i2l_attend_launch_shape(512, 100, 256, 384, 1, 1, dims)
    assert tuple(dims) == (512, 1, 100) and smem <= 56 * 1024
    smem = _build.lib().i2l_attend_launch_shape(2560, 100, 256, 384, 5, 1, dims)
    assert tuple(dims) == (512, 5, 100) and smem <= 75 * 1024


# ---- the bf16 sampling and beam steps on the tensor cores, clusters over the columns -----------


def _plans_agree(plan, shape):
    assert shape is not None and plan == shape, (plan, shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(1, 384), (17, 512), (512, 384), (512, 512), (3, 33)])
@pytest.mark.parametrize("Vp", [128, 384, 512, 640, 1152, 4096])
def test_sample_plan_matches_the_library(dev, dtype, B, H, Vp):
    """sample_plan names the launch the library computes (grid, cluster, rows a tile, shared
    memory, scratch) for each top-k and top-p setting, and the library refuses the cluster route
    wherever the plan takes the block route in bf16."""
    for top_k in (0, 1, 10, 64, 65, 1000):
        for top_p in (0.0, 0.9):
            if top_k == 0 and top_p == 0.0:
                continue
            plan = ds.sample_plan(B, H, Vp, top_k, dtype, top_p)
            code = ds.ROUTE_CODES[plan.route]
            _plans_agree(plan, ds.launch_shape("sample", B, H, Vp, top_k, int(top_p > 0), code))
            if dtype == torch.bfloat16 and plan.route == "block":
                assert ds.launch_shape("sample", B, H, Vp, top_k, int(top_p > 0), 1) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(1, 384), (7, 512), (512, 384), (512, 512), (3, 33)])
@pytest.mark.parametrize("Vp", [128, 512, 640, 4096])
def test_beam_plan_matches_the_library(dev, dtype, B, H, Vp):
    """beam_plan names the library's launch for K in 1, 5, 6, 20, 32, 33 and 120."""
    for K in (1, 5, 6, 20, 32, 33, 120):
        plan = bd.beam_plan(B, K, H, Vp, dtype)
        _plans_agree(plan, ds.launch_shape("beam", B, K, H, Vp, ds.ROUTE_CODES[plan.route]))
        if dtype == torch.bfloat16 and plan.route == "block":
            assert ds.launch_shape("beam", B, K, H, Vp, 1) is None


@pytest.mark.parametrize("B,H,Vp", [(512, 384, 512), (512, 512, 512), (1, 40, 128), (33, 64, 128),
                                    (70, 96, 640), (31, 33, 384)])
@pytest.mark.parametrize("kw", [dict(top_k=1), dict(top_k=10), dict(top_k=64), dict(top_k=1000),
                                dict(top_p=1.0), dict(top_p=0.9), dict(top_k=10, top_p=0.9),
                                dict(top_k=64, top_p=0.3, batch_tile=7)])
def test_vocab_sample_step_tc(dev, B, H, Vp, kw):
    """The bf16 cluster kernel (the route sample_plan names for every shape here): ragged B, one
    row, Vp = 128 (a cluster of 2), 384 (6) and 640 (10 slices over 8 ranks), an unaligned H (the
    guarded loader), top-k 1, 10, 64 and past the vocab, top-p 1.0, several tiles of the random
    stream.  It draws the plain version's tokens except where the plain version is within a
    rounding step of a knife edge (the float32 limits of test_vocab_sample_step)."""
    h, w_out, b_out = _sample_operands(dev, torch.bfloat16, B, H, Vp, Vp - 7, B + Vp + H)
    assert ds.sample_plan(B, H, Vp, kw.get("top_k", 0), torch.bfloat16, kw.get("top_p", 0.0)).route == "cluster_tc"
    fin0 = torch.from_numpy((np.arange(B) % 5 == 4).astype(np.int32)).to(dev)
    kw = dict(seed=11, **kw)
    n0 = ds.vocab_sample_step.cluster_tc_launches
    tk, fk, ok = _run_sample_step(ds.vocab_sample_step, h, w_out, b_out, fin0, **kw)
    assert ds.vocab_sample_step.cluster_tc_launches == n0 + 1
    gaps, mass = torch.full((B, 5), float("inf"), device=dev), torch.full((B, 5), float("inf"), device=dev)
    tp, fp, op = _run_sample_step(ds.vocab_sample_step_plain, h, w_out, b_out, fin0, gaps=gaps, mass_gaps=mass,
                                  **kw)
    edge = (gaps[:, 2] <= 1e-4) | (mass[:, 2] <= 1e-5)
    assert ((tk == tp) | edge).all() and int((tk != tp).sum()) <= max(1, B // 20)
    assert torch.equal(fk, torch.maximum(fin0, (tk == 2).int())) and torch.equal(ok[:, 2], tk)
    assert (ok[:, [0, 1, 3, 4]] == -1).all()
    assert (tk[fin0 == 1] == 0).all() and (tk[fin0 == 0] < Vp - 7).all()
    assert tk[0] == 3  # all the mass on one token


@pytest.mark.parametrize("B,Vp,kw", [(40, 2048, dict(top_k=10, top_p=0.9)), (40, 512, dict(top_k=65)),
                                     (40, 512, dict(top_k=200, top_p=0.9))])
def test_vocab_sample_step_bf16_block_route(dev, B, Vp, kw):
    """The bf16 shapes left to the CUDA-core kernel (Vp above 1024; 64 < top_k < Vp) take it,
    and draw the plain version's tokens but at a knife edge."""
    H = 64
    h, w_out, b_out = _sample_operands(dev, torch.bfloat16, B, H, Vp, Vp - 7, Vp + 1)
    assert ds.sample_plan(B, H, Vp, kw["top_k"], torch.bfloat16, kw.get("top_p", 0.0)).route == "block"
    fin0 = torch.zeros(B, dtype=torch.int32, device=dev)
    n0 = ds.vocab_sample_step.block_launches
    tk, _, _ = _run_sample_step(ds.vocab_sample_step, h, w_out, b_out, fin0, seed=5, **kw)
    assert ds.vocab_sample_step.block_launches == n0 + 1
    gaps, mass = torch.full((B, 5), float("inf"), device=dev), torch.full((B, 5), float("inf"), device=dev)
    tp, _, _ = _run_sample_step(ds.vocab_sample_step_plain, h, w_out, b_out, fin0, gaps=gaps, mass_gaps=mass,
                                seed=5, **kw)
    edge = (gaps[:, 2] <= 1e-4) | (mass[:, 2] <= 1e-5)
    assert ((tk == tp) | edge).all()


def _dead_beams(op, K):
    """Samples with fewer than K totals above -1e30, where the reference's passes pick its lowest
    flat index at -1e30 again: (0) every beam finished, beams 1.. at score -1e30; (1) no beam
    finished, all at -1e30; (2) every beam finished at -2e30, so no total reaches -1e30 and the
    first pass takes the largest, later ones that index again; (3) K - 1 finished beams at -1e30
    and one live beam."""
    scores, fin = op["scores"].view(-1, K), op["fin"].view(-1, K)
    B = scores.shape[0]
    for b in range(B):
        case = b % 5
        if case == 0:
            fin[b] = 1
            scores[b, 1:] = -1e30
        elif case == 1:
            fin[b] = 0
            scores[b] = -1e30
        elif case == 2:
            fin[b] = 1
            scores[b] = -2e30
        elif case == 3:
            fin[b] = 1
            fin[b, 0] = 0
            scores[b, 1:] = -1e30


@pytest.mark.parametrize("B,K,H,Vp,L", [(512, 5, 384, 512, 2), (512, 5, 512, 512, 2), (7, 1, 40, 128, 1),
                                        (11, 5, 96, 512, 2), (9, 6, 64, 640, 2), (3, 32, 48, 256, 1),
                                        (4, 20, 33, 384, 2), (2, 33, 40, 128, 1), (13, 3, 48, 128, 2)])
@pytest.mark.parametrize("case", ["random", "tie", "all_finished", "dead"])
def test_beam_step_tc(dev, B, K, H, Vp, L, case):
    """bf16 at the main path's shapes (B = 512 samples of 5 beams, H = 384 and 512) and ragged
    ones: K = 1 (32 samples a tile), 5, 6 (5 samples, 30 rows), 32 (a tile a sample), 20 at an
    unaligned H, 33 (the CUDA-core kernel: beam_plan's block route), Vp 128 to 640 (clusters of 2
    to 8, 10 slices over 8 ranks), exact ties across beams, every row finished, and samples with
    fewer than K totals above -1e30 ("dead": the reference's repeated picks).  Tokens, parents,
    finished and the gathered carries equal the plain version's, scores within 1e-5."""
    op = _beam_operands(dev, torch.bfloat16, B, K, H, Vp, L, B * K + H + Vp, tie=case == "tie",
                        all_finished=case == "all_finished")
    if case == "dead":
        _dead_beams(op, K)
    route = bd.beam_plan(B, K, H, Vp, torch.bfloat16).route
    assert route == ("block" if K > 32 else "cluster_tc")
    n0 = getattr(bd.beam_step, f"{route}_launches")
    got = _run_beam_step(bd.beam_step, op, K)
    assert getattr(bd.beam_step, f"{route}_launches") == n0 + 1
    ref = _run_beam_step(bd.beam_step_plain, op, K)
    for name in ("fin", "tokens", "tok_hist", "par_hist", "h_dst", "c_dst"):
        assert torch.equal(got[name], ref[name]), name
    torch.testing.assert_close(got["scores"], ref["scores"], atol=1e-5, rtol=1e-6)
    if case == "dead":
        par = got["par_hist"][1].view(B, K)
        assert (par[0::5] == 0).all()  # sample case 0: beam 0's PAD, then the same pick again


@pytest.mark.parametrize("which", ["sample", "beam"])
def test_tc_steps_repeat_bit_for_bit(dev, which):
    """20 launches of each bf16 cluster kernel at the main path's shapes give the same outputs
    bit for bit (a missing barrier or fence between the cluster's blocks shows as a difference)."""
    runs = []
    if which == "sample":
        B, H, Vp = 512, 384, 512
        h, w_out, b_out = _sample_operands(dev, torch.bfloat16, B, H, Vp, 503, 3)
        fin0 = torch.from_numpy((np.arange(B) % 7 == 6).astype(np.int32)).to(dev)
        for _ in range(20):
            runs.append(_run_sample_step(ds.vocab_sample_step, h, w_out, b_out, fin0, seed=9, top_k=10, top_p=0.9))
    else:
        B, K, H, Vp = 512, 5, 384, 512
        op = _beam_operands(dev, torch.bfloat16, B, K, H, Vp, 2, 4)
        for _ in range(20):
            out = _run_beam_step(bd.beam_step, op, K)
            runs.append(tuple(out[k] for k in ("scores", "fin", "tokens", "tok_hist", "par_hist", "h_dst", "c_dst")))
    for r in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r, runs[0]))


# (B, H, W, Cout) of the bf16 conv1-pool tensor-core kernel: W/2 = 5 and 17 (NCHW stored element
# by element), 150 (a partial 16-pixel tile) and 400 (the main path's width); H/2 = 3, 5 and 7, not
# multiples of the 4-row band; Cout 40 (a chunk of one group of 8) and 128 (four chunks)
CONV1_TC_SHAPES = [(2, 6, 10, 8), (3, 10, 34, 40), (1, 4, 300, 128), (2, 14, 48, 24), (1, 2, 2, 16),
                   (4, 64, 800, 32)]


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("shape", CONV1_TC_SHAPES)
def test_conv1_pool_tc(dev, layout, shape):
    """bf16 with Cout a multiple of 8 runs conv1_pool_tc_kernel: within one bf16 step of the plain
    version, equal on 99% of the elements where there are 10^4 of them, and the NHWC output the
    NCHW one transposed bit for bit."""
    B, H, W, C = shape
    rng = np.random.default_rng(sum(shape) + 3)
    x = _t(rng.uniform(-1, 1, (B, H, W, 1)), dev, torch.bfloat16)
    w = _t(rng.normal(size=(C, 1, 3, 3)) / 3, dev)
    b = _t(rng.normal(size=C) * 0.1, dev)
    assert c1.conv1_plan(B, H, W, C, torch.bfloat16).route == "tc"
    n0, core0 = conv1_pool.tc_launches, conv1_pool.core_launches
    got = conv1_pool(x, w, b, layout=layout)
    assert conv1_pool.tc_launches == n0 + 1 and conv1_pool.core_launches == core0
    ref = conv1_pool_plain(x, w, b, layout=layout)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-4, rtol=BF16_ULP)
    if got.numel() >= 10_000:
        assert (got == ref).float().mean().item() >= 0.99
    other = conv1_pool(x, w, b, layout="nhwc" if layout == "nchw" else "nchw")
    nhwc, nchw = (got, other) if layout == "nhwc" else (other, got)
    assert torch.equal(nhwc, nchw.permute(0, 2, 3, 1))


def test_conv1_pool_tc_repeats_bit_for_bit(dev):
    """20 launches at the main path's shape give the same output bit for bit."""
    rng = np.random.default_rng(11)
    x = _t(rng.uniform(-1, 1, (64, 64, 800, 1)), dev, torch.bfloat16)
    w, b = _t(rng.normal(size=(32, 1, 3, 3)) / 3, dev), _t(rng.normal(size=32) * 0.1, dev)
    first = conv1_pool(x, w, b)
    assert all(torch.equal(conv1_pool(x, w, b), first) for _ in range(19))


@pytest.mark.parametrize("dtype,C", [(torch.bfloat16, 12), (torch.bfloat16, 1), (torch.float32, 32)])
def test_conv1_pool_core_route(dev, dtype, C):
    """float32 and bf16 with Cout not a multiple of 8 run the CUDA-core kernel."""
    rng = np.random.default_rng(C)
    x = _t(rng.uniform(-1, 1, (2, 6, 18, 1)), dev, dtype)
    w, b = _t(rng.normal(size=(C, 1, 3, 3)) / 3, dev), _t(rng.normal(size=C) * 0.1, dev)
    n0, core0 = conv1_pool.tc_launches, conv1_pool.core_launches
    got = conv1_pool(x, w, b)
    assert conv1_pool.core_launches == core0 + 1 and conv1_pool.tc_launches == n0
    torch.testing.assert_close(got.float(), conv1_pool_plain(x, w, b).float(), atol=1e-5,
                               rtol=0 if dtype == torch.float32 else BF16_ULP)


@pytest.mark.parametrize("B,H,W,C", [(512, 64, 800, 32), (3, 10, 34, 40), (1, 2, 2, 8), (7, 6, 4000, 128),
                                     (2, 40, 20000, 8)])
def test_conv1_plan_matches_the_library(dev, B, H, W, C):
    """conv1_plan's tensor-core launch is the one the library computes; the library refuses a band
    whose rows do not fit shared memory and a Cout that is not a multiple of 8."""
    plan = c1.conv1_plan(B, H, W, C, torch.bfloat16)
    assert plan.route == "tc" and c1.tc_launch_shape(B, H, W, C, plan.rows) == plan
    assert c1.tc_launch_shape(B, H, W, C + 1, plan.rows) is None
    assert c1.tc_launch_shape(B, H, W, C, 17) is None
    if plan.rows < min(c1.TC_ROWS, H // 2):  # the planner cut the band to fit shared memory
        assert c1.tc_launch_shape(B, H, W, C, plan.rows + 1) is None


def test_conv1_pool_tc_refused_launch_raises(dev):
    """A launch the C side refuses (a band of 17 rows) raises instead of falling back."""
    x = torch.zeros(1, 4, 8, 1, device=dev, dtype=torch.bfloat16)
    w, b = torch.zeros(8, 1, 3, 3, device=dev), torch.zeros(8, device=dev)
    bad = c1.Conv1Plan("tc", (1, 1, 1), c1.TC_THREADS, 17, 0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        c1.conv1_pool_launch(x, c1.pack_conv1_taps(w.to(torch.bfloat16)), b, "nchw", bad)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Ragged shapes the main path does not reach (batches and widths that are not
multiples of the kernels' tiles, one row, exact argmax ties) at small sizes.
Marked ``cuda``: without a CUDA device every test skips.  Imports no JAX, so
it runs on the card's machine with

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from img2latex_tpu_torch.ops.conv1_phase import conv1_pool, conv1_pool_plain
from img2latex_tpu_torch.ops import decode_step as ds

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
@pytest.mark.parametrize("B,E,H,layer0", [(1, 40, 40, True), (70, 24, 40, True), (65, 40, 33, False)])
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

"""The training LSTM and the conv1 backward against the JAX package, on the CPU.

``img2latex_tpu_torch.ops.lstm_train.lstm_seq`` on CPU tensors runs its
plain versions (``lstm_seq_fwd_plain`` / ``lstm_seq_bwd_plain``, the
kernels' rounding points); it is held against the TPU kernel
``lstm_seq_pallas`` in interpret mode - ys, hT, cT and the ``jax.vjp``
cotangents of gates_x, h0, c0 and W_hh under nonzero cotangents on all
three outputs - in float32 and bf16, with an odd batch (which the TPU kernel
pads internally), and against the scan path (``lstm_cell_step`` under
``lax.scan``).  ``lstm_seq_plain`` (autograd of the plain loop) is held
against the same.  ``conv1_pool``'s backward is held against the VJP of the
JAX ``conv1_pool(..., interpret=True, layout="nchw")``.

Tolerances: float32 within 1e-5 of O(1) values (sums in another order); the
bf16 plain versions equal the TPU kernel's bits (the same rounding points);
``lstm_seq_plain`` in bf16 rounds the gradients of its compute-type carries
at every step, within 2^-5 of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img2latex_tpu.models.lstm import lstm_cell_step
from img2latex_tpu.ops.pallas.conv1_phase import conv1_pool as jax_conv1_pool
from img2latex_tpu.ops.pallas.lstm_train import lstm_seq_pallas
from img2latex_tpu_torch.ops import lstm_train as lt
from img2latex_tpu_torch.ops.conv1_phase import conv1_pool

torch.set_num_threads(1)


def _operands(T, B, H, seed):
    rng = np.random.default_rng(seed)
    a = dict(gx=rng.normal(size=(T, B, 4 * H)), h0=rng.uniform(-1, 1, (B, H)), c0=rng.uniform(-1, 1, (B, H)),
             w=rng.normal(size=(H, 4 * H)) / np.sqrt(H),  # JAX layout (H, 4H)
             dys=rng.normal(size=(T, B, H)), dhT=rng.normal(size=(B, H)), dcT=rng.normal(size=(B, H)))
    return {k: v.astype(np.float32) for k, v in a.items()}


def _jax_seq(fn, a, dtype):
    j = {k: jnp.asarray(v).astype(dtype) for k, v in a.items()}
    outs, vjp = jax.vjp(fn, j["gx"], j["h0"], j["c0"], j["w"])
    grads = vjp((j["dys"], j["dhT"], j["dcT"]))
    return [np.asarray(x.astype(jnp.float32)) for x in (*outs, *grads)]


def _torch_seq(fn, a, dtype):
    leaves = [torch.from_numpy(a[k]).to(dtype).requires_grad_() for k in ("gx", "h0", "c0")]
    leaves.append(torch.from_numpy(np.ascontiguousarray(a["w"].T)).to(dtype).requires_grad_())  # (4H, H)
    outs = fn(*leaves)
    grads = torch.autograd.grad(outs, leaves, [torch.from_numpy(a[k]).to(dtype) for k in ("dys", "dhT", "dcT")])
    got = [x.detach().float().numpy() for x in (*outs, *grads)]
    got[-1] = got[-1].T  # dW_hh back to the JAX layout
    return got


def _scan_seq(gx, h0, c0, w):
    def body(hc, g):
        h, c = lstm_cell_step(g, hc[0], hc[1], w, jnp.zeros((w.shape[1],), w.dtype))
        return (h, c), h

    (hT, cT), ys = jax.lax.scan(body, (h0, c0), gx)
    return ys, hT, cT


@pytest.mark.parametrize("T,B,H", [(6, 5, 16), (3, 8, 24), (1, 3, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_seq_matches_the_tpu_kernel(T, B, H, dtype):
    a = _operands(T, B, H, seed=T * 100 + B * 10 + H)
    ref = _jax_seq(lambda *x: lstm_seq_pallas(*x, interpret=True), a, jnp.dtype(dtype))
    got = _torch_seq(lt.lstm_seq, a, getattr(torch, dtype))
    for name, g, r in zip(("ys", "hT", "cT", "dgates_x", "dh0", "dc0", "dW_hh"), got, ref):
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=1e-5, rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_plain_layer_matches_the_tpu_kernel(dtype):
    a = _operands(7, 5, 16, seed=3)
    ref = _jax_seq(lambda *x: lstm_seq_pallas(*x, interpret=True), a, jnp.dtype(dtype))
    got = _torch_seq(lt.lstm_seq_plain, a, getattr(torch, dtype))
    for name, g, r in zip(("ys", "hT", "cT", "dgates_x", "dh0", "dc0", "dW_hh"), got, ref):
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=1e-5, rtol=0, err_msg=name)
        elif name in ("ys", "hT", "cT"):
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            assert np.abs(g - r).max() <= 2.0**-5 * np.abs(r).max(), name


def test_lstm_seq_matches_the_scan_path():
    a = _operands(6, 5, 16, seed=9)
    ref = _jax_seq(_scan_seq, a, jnp.float32)
    got = _torch_seq(lt.lstm_seq, a, torch.float32)
    for name, g, r in zip(("ys", "hT", "cT", "dgates_x", "dh0", "dc0", "dW_hh"), got, ref):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0, err_msg=name)


def test_lstm_seq_cpu_launches_nothing():
    a = _operands(2, 3, 8, seed=1)
    before = (lt.lstm_seq_fwd.launches, lt.lstm_seq_bwd.launches)
    _torch_seq(lt.lstm_seq, a, torch.float32)
    assert (lt.lstm_seq_fwd.launches, lt.lstm_seq_bwd.launches) == before


def test_lstm_seq_only_some_inputs_need_grad():
    a = _operands(3, 2, 8, seed=2)
    gx = torch.from_numpy(a["gx"]).requires_grad_()
    w = torch.from_numpy(np.ascontiguousarray(a["w"].T))
    ys, hT, cT = lt.lstm_seq(gx, torch.from_numpy(a["h0"]), torch.from_numpy(a["c0"]), w)
    (ys.sum() + cT.sum()).backward()
    assert gx.grad is not None and gx.grad.shape == gx.shape


def test_dw_splits_cover_two_blocks_a_sm():
    assert lt.dw_splits(140 * 128, 512) == 2  # 256 output tiles of 64x64
    assert lt.dw_splits(3, 8) == 1


@pytest.mark.parametrize("shape", [(2, 8, 16, 8), (3, 6, 10, 5)])
def test_conv1_pool_backward_matches_jax_vjp(shape):
    """dx, dkernel and dbias against the JAX custom VJP (the kernel in
    interpret mode forward, autograd of the XLA composition backward), the
    kernel mapped from OIHW to HWIO."""
    B, H, W, C = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.uniform(-1, 1, (B, H, W, 1)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 1, C)) * 0.3).astype(np.float32)  # HWIO
    b = (rng.normal(size=C) * 0.1).astype(np.float32)
    g = rng.normal(size=(B, C, H // 2, W // 2)).astype(np.float32)
    _, vjp = jax.vjp(lambda *p: jax_conv1_pool(*p, True, "nchw"), jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    dx, dk, db = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    leaves = [torch.from_numpy(x).requires_grad_(),
              torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))).requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    tdx, tdw, tdb = torch.autograd.grad(conv1_pool(*leaves), leaves, torch.from_numpy(g))
    np.testing.assert_allclose(tdx.numpy(), dx, atol=1e-5)
    np.testing.assert_allclose(np.transpose(tdw.numpy(), (2, 3, 1, 0)), dk, atol=1e-4)
    np.testing.assert_allclose(tdb.numpy(), db, atol=1e-4)
    assert np.abs(tdw.numpy()).max() > 0

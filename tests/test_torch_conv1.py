"""The conv1-pool kernel's plain version against the JAX package's TPU kernel.

``img2latex_tpu_torch.ops.conv1_phase.conv1_pool`` on CPU tensors runs its
plain version; it is held against ``fused_conv1_pool`` (Pallas, interpret
mode), ``_xla_conv1_pool`` and ``conv1_lane_relu_pool`` (no bias) in float32,
including the NHWC -> NCHW layout of the output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img2latex_tpu.ops.pallas.conv1_lane import conv1_lane_relu_pool
from img2latex_tpu.ops.pallas.conv1_phase import _xla_conv1_pool, fused_conv1_pool
from img2latex_tpu_torch.ops.conv1_phase import conv1_pool, conv1_pool_plain

torch.set_num_threads(1)


def _inputs(shape, seed=0):
    B, H, W, C = shape
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(B, H, W, 1)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 1, C)) * 0.3).astype(np.float32)  # HWIO
    b = (rng.normal(size=C) * 0.1).astype(np.float32)
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))  # OIHW
    return x, k, b, w


@pytest.mark.parametrize("shape", [(2, 8, 16, 32), (1, 16, 64, 8), (3, 4, 130, 4)])
def test_matches_pallas_kernel(shape):
    x, k, b, w = _inputs(shape)
    ref = np.asarray(fused_conv1_pool(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                      interpret=True, layout="nchw"))
    got = conv1_pool(torch.from_numpy(x), w, torch.from_numpy(b)).numpy()
    assert got.shape == (shape[0], shape[3], shape[1] // 2, shape[2] // 2)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 16, 32), (2, 6, 10, 5)])
def test_matches_xla_composition(shape):
    x, k, b, w = _inputs(shape, seed=1)
    ref_nhwc = np.asarray(_xla_conv1_pool(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    got = conv1_pool_plain(torch.from_numpy(x), w, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.transpose(ref_nhwc, (0, 3, 1, 2)), atol=1e-5)


def test_zero_bias_matches_conv1_lane():
    x, k, _, w = _inputs((2, 8, 128, 32), seed=2)
    ref = np.asarray(conv1_lane_relu_pool(jnp.asarray(x), jnp.asarray(k), interpret=True))
    got = conv1_pool(torch.from_numpy(x), w, torch.zeros(32)).numpy()
    np.testing.assert_allclose(got, np.transpose(ref, (0, 3, 1, 2)), atol=1e-5)


def test_bf16_input_rounds_like_the_tpu_kernel():
    """bf16 in: taps cast to bf16, sums and bias in float32, output cast once."""
    x, k, b, w = _inputs((2, 8, 16, 8), seed=3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = np.asarray(_xla_conv1_pool(xb, jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(b)),
                     dtype=np.float32)
    got = conv1_pool(torch.from_numpy(x).to(torch.bfloat16), w, torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    # equal up to one bf16 rounding step (2^-7 relative) where the float32 sums differ in order
    np.testing.assert_allclose(got.float().numpy(), np.transpose(ref, (0, 3, 1, 2)),
                               rtol=2**-7, atol=1e-6)


def test_cpu_tensor_launches_nothing():
    x, _, b, w = _inputs((1, 4, 8, 4))
    before = conv1_pool.launches
    conv1_pool(torch.from_numpy(x), w, torch.from_numpy(b))
    assert conv1_pool.launches == before


def test_other_device_raises():
    with pytest.raises(ValueError):
        conv1_pool(torch.zeros(1, 4, 8, 1, device="meta"), torch.zeros(4, 1, 3, 3), torch.zeros(4))


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernel's arithmetic (csrc/conv1_pool_tc.cu), which runs only on the card:
# its B operand, pack_conv1_taps, against the JAX packing bit for bit, and a plain rendering of
# its product -- the 4x4 stride-2 window of each pooled pixel times the packed taps, the max over
# the four pool phases, the bias, ReLU and one cast -- against conv1_pool_plain and the Pallas
# kernel.  Shapes with W / 2 not a multiple of 16 (odd ones too) and H / 2 not a multiple of the
# kernel's band of 4 pooled rows.
# ---------------------------------------------------------------------------

from img2latex_tpu.ops.pallas.conv1_phase import pack_conv1_taps as jax_pack_conv1_taps
from img2latex_tpu_torch.ops.conv1_phase import pack_conv1_taps

ODD_SHAPES = [(2, 10, 34, 8), (1, 6, 10, 40), (3, 14, 48, 32), (1, 2, 2, 16), (2, 4, 300, 24)]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _kernel_arithmetic(x, packed, bias, layout="nchw"):
    """conv1_pool_tc.cu's arithmetic in plain PyTorch: unfold the 4x4 windows (rows 2ph-1..2ph+2,
    cols 2pw-1..2pw+2, zero padded; row 4s + t), times the packed taps in float32, the max over
    the four phases (rows p Cout + c), the float32 bias, ReLU, one cast to x's dtype."""
    B, H, W, _ = x.shape
    Cout = bias.shape[0]
    cols = torch.nn.functional.unfold(x.permute(0, 3, 1, 2).float(), kernel_size=4, stride=2, padding=1)
    y = packed.float() @ cols  # (B, 4 Cout, H/2 * W/2)
    y = y.view(B, 4, Cout, -1).amax(dim=1) + bias.float()[:, None]
    y = torch.relu(y).to(x.dtype).view(B, Cout, H // 2, W // 2)
    return y if layout == "nchw" else y.permute(0, 2, 3, 1).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 8, 32])
def test_pack_conv1_taps_matches_jax_bit_for_bit(C, dtype):
    _, k, _, w = _inputs((1, 4, 4, C), seed=C)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jax_pack_conv1_taps(jnp.asarray(k).astype(jdtype))
    got = pack_conv1_taps(w.to(dtype))
    assert got.dtype == dtype and tuple(got.shape) == (4 * C, 16)
    got_np = got.float().numpy() if dtype == torch.float32 else got.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(_bits(got_np), _bits(ref))


def test_pack_conv1_taps_places_each_tap():
    """Row p Cout + c, column 4s + t holds w[c, 0, s - a, t - b] for p = 2a + b, zero elsewhere."""
    w = torch.arange(1, 2 * 9 + 1, dtype=torch.float32).view(2, 1, 3, 3)
    got = pack_conv1_taps(w).view(4, 2, 4, 4)
    for a in range(2):
        for b in range(2):
            want = torch.zeros(2, 4, 4)
            want[:, a:a + 3, b:b + 3] = w[:, 0]
            assert torch.equal(got[2 * a + b], want)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_kernel_arithmetic_matches_plain_float32(shape, layout):
    x, _, b, w = _inputs(shape, seed=4)
    x, b = torch.from_numpy(x), torch.from_numpy(b)
    ref = conv1_pool_plain(x, w, b, layout)
    got = _kernel_arithmetic(x, pack_conv1_taps(w), b, layout)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6 * max(ref.abs().max().item(), 1.0))


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_kernel_arithmetic_matches_plain_bf16(shape, layout):
    """bf16 inputs and taps, float32 sums: within one bf16 rounding step (2^-7 relative) where the
    float32 sums, taken in another order, round the other way."""
    x, _, b, w = _inputs(shape, seed=5)
    x, b = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(b)
    ref = conv1_pool_plain(x, w, b, layout)
    got = _kernel_arithmetic(x, pack_conv1_taps(w.to(torch.bfloat16)), b, layout)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), rtol=2**-7, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ODD_SHAPES[:3])
def test_kernel_arithmetic_matches_pallas_kernel(shape, dtype):
    x, k, b, w = _inputs(shape, seed=6)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(fused_conv1_pool(jnp.asarray(x).astype(jdtype), jnp.asarray(k), jnp.asarray(b),
                                      interpret=True, layout="nchw"), dtype=np.float32)
    xt = torch.from_numpy(x).to(dtype)
    got = _kernel_arithmetic(xt, pack_conv1_taps(w.to(dtype)), torch.from_numpy(b)).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * max(np.abs(ref).max(), 1.0))
    else:
        np.testing.assert_allclose(got, ref, rtol=2**-7, atol=1e-6)

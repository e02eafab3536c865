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

"""The taps that ``ops/conv_cf.py::conv_pool_launch`` hands to ``csrc/conv_pool.cu``, on the CPU.

float32 inputs take the float32 kernel's (Cin, 3, 3, Cout) float32 taps; bf16
inputs the tensor-core kernel's bf16 taps, zero-padded to (Cin16, 3, 3,
Cout64).  Both hold ``weight.permute(1, 2, 3, 0)`` of the compute-type
weights where the weight has values, and zeros in the padding.
"""

import numpy as np
import pytest
import torch

from img2latex_tpu_torch.ops.conv_cf import conv_taps


@pytest.mark.parametrize("Cout,Cin", [(64, 32), (128, 64), (12, 3), (70, 1), (130, 33), (12, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_taps_layout(Cout, Cin, dtype):
    w = torch.from_numpy(np.random.default_rng(Cout * 100 + Cin).standard_normal((Cout, Cin, 3, 3), dtype=np.float32))
    taps = conv_taps(w, dtype)
    ref = w.to(dtype).permute(1, 2, 3, 0)
    assert taps.is_contiguous()
    if dtype == torch.float32:
        assert taps.dtype == torch.float32 and tuple(taps.shape) == (Cin, 3, 3, Cout)
        assert torch.equal(taps, ref)
        return
    cin16, cout64 = -(-Cin // 16) * 16, -(-Cout // 64) * 64
    assert taps.dtype == dtype and tuple(taps.shape) == (cin16, 3, 3, cout64)
    assert torch.equal(taps[:Cin, :, :, :Cout], ref)
    pad = torch.ones_like(taps, dtype=torch.bool)
    pad[:Cin, :, :, :Cout] = False
    assert not taps[pad].any()


def test_conv_taps_round_to_the_compute_type():
    """The bf16 taps are the weight rounded once to bf16, as the float32 taps
    of a bf16 call were (``kernel.astype(dtype)``)."""
    w = torch.tensor([1.0 + 2.0**-9, -3.0 + 2.0**-8, 0.1], dtype=torch.float32).reshape(3, 1, 1, 1).expand(3, 1, 3, 3)
    taps = conv_taps(w.contiguous(), torch.bfloat16)
    assert torch.equal(taps[0, 0, 0, :3].float(), w[:, 0, 0, 0].to(torch.bfloat16).float())

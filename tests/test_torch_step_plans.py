"""The routes of the sampling and beam steps (``ops/decode_step.py::sample_plan``,
``ops/beam_decode.py::beam_plan``) and of conv1_pool (``ops/conv1_phase.py::conv1_plan``), on
the CPU.

The planners are pure Python: they name the route (the bf16 tensor-core cluster kernels of
``csrc/sample_step_tc.cu`` and ``csrc/beam_step_tc.cu``, or the CUDA-core block kernels), the
grid, the cluster size, the rows a tile, the shared memory and the block route's device-memory
scratch.  Here: the routes at the shipped widths (H 384 and 512; B 1, 128 and 512; K 1, 5, 6,
20, 32 and 33; both dtypes), the shapes left to the block kernels, and bad input.  The card test
``test_torch_cuda_kernels.py::test_sample_plan_matches_the_library`` (and its beam twin) holds
each plan against the launch the library computes.
"""

import pytest
import torch

from img2latex_tpu_torch.ops import beam_decode as bd
from img2latex_tpu_torch.ops import conv1_phase as c1
from img2latex_tpu_torch.ops import decode_step as ds

WIDTHS = [384, 512]
BATCHES = [1, 128, 512]
RING, SLICE = 55_296, 9_216  # the product's cp.async ring; a 64-column slice of 32 rows in float32


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("setting", [dict(top_k=10, top_p=0.9), dict(top_k=5), dict(top_p=0.9), dict(top_k=1)])
def test_sample_plan_at_the_shipped_widths(H, B, setting):
    """bf16 takes the cluster kernel: ceil(B / 32) row tiles, clusters of 8 over Vp = 512 (128
    blocks at B = 512, where the block kernel has 32), one slice a block beside the ring; float32
    takes the block kernel, 16 rows a block, its work in shared memory."""
    top_k, top_p = setting.get("top_k", 0), setting.get("top_p", 0.0)
    plan = ds.sample_plan(B, H, 512, top_k, torch.bfloat16, top_p)
    assert plan == ds.StepPlan("cluster_tc", (8, -(-B // 32)), 8, 32, RING + SLICE, 0)
    f32 = ds.sample_plan(B, H, 512, top_k, torch.float32, top_p)
    assert (f32.route, f32.grid, f32.cluster, f32.rows, f32.scratch_floats) == ("block", (-(-B // 16), 1), 1, 16, 0)
    staged = 4 * ds.staged_floats(H)
    assert f32.smem_bytes == staged + 4 * (16 * 512 + (2 * 16 * 512 if top_p > 0 else 0))
    if B == 512:
        assert plan.grid[0] * plan.grid[1] == 128 and f32.grid[0] == 32


@pytest.mark.parametrize("H", WIDTHS)
@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("K", [1, 5, 6, 20, 32, 33])
def test_beam_plan_at_the_shipped_widths(H, B, K):
    """bf16 takes the cluster kernel while a 32-row tile holds a whole sample (K <= 32): G =
    32 // K samples a tile (B = 512, K = 5: 86 tiles of 30 rows, 688 blocks); K = 33 and float32
    take the block kernel (16 // K samples a block, one for K > 16)."""
    plan = bd.beam_plan(B, K, H, 512, torch.bfloat16)
    f32 = bd.beam_plan(B, K, H, 512, torch.float32)
    rows = 16 // K * K if K <= 16 else K
    assert (f32.route, f32.grid, f32.cluster, f32.rows) == ("block", (-(-B // (rows // K)), 1), 1, rows)
    if K > 32:
        assert plan == f32
        return
    G = 32 // K
    assert plan == ds.StepPlan("cluster_tc", (8, -(-B // G)), 8, G * K, RING + SLICE, 0)
    if (B, K) == (512, 5):
        assert plan.grid == (8, 86) and plan.rows == 30 and f32.grid == (171, 1)


@pytest.mark.parametrize("Vp,C,per_block", [(128, 2, 1), (384, 6, 1), (512, 8, 1), (640, 8, 2), (1024, 8, 2)])
def test_cluster_size_and_slices(Vp, C, per_block):
    """C = min(8, Vp / 64) blocks a cluster; ranks walk the slices past 8 in turn, and every block
    holds room for the most any rank takes."""
    plan = ds.sample_plan(100, 64, Vp, 10, torch.bfloat16, 0.9)
    assert plan.cluster == plan.grid[0] == C and plan.smem_bytes == RING + per_block * SLICE
    assert bd.beam_plan(100, 5, 64, Vp, torch.bfloat16) == ds.StepPlan("cluster_tc", (C, 17), C, 30, plan.smem_bytes)


@pytest.mark.parametrize("Vp,top_k,top_p", [(1152, 10, 0.9), (2048, 0, 0.9), (4096, 5, 0.0), (512, 65, 0.0),
                                            (512, 200, 0.9), (1024, 1023, 0.0)])
def test_sample_shapes_left_to_the_block_kernel(Vp, top_k, top_p):
    """bf16 above Vp = 1024 (a row's keys no longer fit a warp's registers) or with 64 < top_k <
    Vp (more passes than a warp makes) takes the block kernel, its work spilling to device memory
    where it does not fit shared memory."""
    plan = ds.sample_plan(40, 64, Vp, top_k, torch.bfloat16, top_p)
    assert plan.route == "block" and plan.cluster == 1 and plan.rows == 16
    np2 = 1 << (Vp - 1).bit_length()
    work = 16 * Vp + (32 * np2 if top_p > 0 else 0)
    fits = 4 * (ds.staged_floats(64) + work) <= ds.BLOCK_MAX_SMEM
    assert plan.scratch_floats == (0 if fits else 3 * work)
    assert plan.smem_bytes == 4 * (ds.staged_floats(64) + (work if fits else 0))


@pytest.mark.parametrize("top_k", [0, 1, 64, 1024, 5000])
def test_sample_top_k_the_warp_covers(top_k):
    """top_k <= 64 or top_k >= Vp (the filter off) stays on the cluster kernel."""
    assert ds.sample_plan(40, 64, 1024, top_k, torch.bfloat16, 0.9).route == "cluster_tc"


def test_beam_shapes_left_to_the_block_kernel():
    """K = 33 (no 32-row tile holds a sample) and a vocab whose slices outgrow a block's shared
    memory take the block kernel, K = 120 at Vp = 512 with its logits in device memory."""
    assert bd.beam_plan(4, 33, 64, 512, torch.bfloat16).route == "block"
    assert bd.beam_plan(4, 5, 64, 64 * 8 * 20, torch.bfloat16).route == "block"
    assert bd.beam_plan(4, 5, 64, 64 * 8 * 18, torch.bfloat16).route == "cluster_tc"
    wide = bd.beam_plan(2, 120, 40, 512, torch.bfloat16)
    assert wide.route == "block" and wide.rows == 120 and wide.scratch_floats == 2 * 120 * (512 + 6)


@pytest.mark.parametrize("args", [(0, 64, 512), (4, 0, 512), (4, 64, 0), (4, 64, 500), (4, 64, -128),
                                  (4, 8192, 512)])
def test_plans_refuse_bad_shapes(args):
    """B, H, Vp positive, Vp a multiple of 128, H within the block kernel's staging."""
    with pytest.raises(ValueError):
        ds.sample_plan(*args, 10, torch.bfloat16)
    with pytest.raises(ValueError):
        bd.beam_plan(args[0], 5, args[1], args[2], torch.bfloat16)


def test_plans_refuse_bad_settings():
    with pytest.raises(ValueError):
        ds.sample_plan(4, 64, 512, -1, torch.bfloat16)
    with pytest.raises(ValueError):
        ds.sample_plan(4, 64, 512, 5, torch.float16)
    with pytest.raises(ValueError):
        bd.beam_plan(4, 0, 64, 512, torch.bfloat16)
    with pytest.raises(ValueError):
        bd.beam_plan(4, 5, 64, 512, torch.float64)


def test_wrappers_on_the_cpu_count_no_launch():
    """On CPU tensors the wrappers run the plain versions: no counter moves."""
    B, H, Vp = 3, 8, 128
    h, w, b = torch.zeros(B, H), torch.zeros(H, Vp), torch.zeros(Vp)
    tok, fin = torch.zeros(B, dtype=torch.int32), torch.zeros(B, dtype=torch.int32)
    counts = (ds.vocab_sample_step.launches, ds.vocab_sample_step.cluster_tc_launches,
              ds.vocab_sample_step.block_launches)
    ds.vocab_sample_step(h, w, b, tok, fin, None, 0, 2, 0, top_k=3)
    assert counts == (ds.vocab_sample_step.launches, ds.vocab_sample_step.cluster_tc_launches,
                      ds.vocab_sample_step.block_launches)


# conv1_plan: bf16 with Cout a multiple of 8 takes conv1_pool_tc_kernel (4 warps a band of 4 pooled
# rows of one image, 16 KB of staged results beside the band's input rows), the rest the CUDA-core
# kernel (a thread a pooled pixel, 128 a block).  The card test
# test_torch_cuda_kernels.py::test_conv1_plan_matches_the_library holds the plan against the library.
STAGE = 4 * 4 * 1024


def test_conv1_plan_at_the_main_shape():
    """(512, 64, 800, 1) -> 32 in bf16: 8 bands x 512 images, rows of 432 words (400 of data, 16
    bytes of zeros before, 16 mod 32 words in all)."""
    plan = c1.conv1_plan(512, 64, 800, 32, torch.bfloat16)
    assert plan == c1.Conv1Plan("tc", (8, 512, 1), 128, 4, STAGE + 4 * 10 * 432)
    assert c1.conv1_plan(512, 64, 800, 32, torch.float32) == c1.Conv1Plan("cuda_core", (4, 32, 512), 128, 1, 5120)


def test_conv1_plan_at_a_small_odd_shape():
    """H / 2 = 5 is two bands (the second of one row); W / 2 = 17 is two 16-pixel tiles, whose
    reads reach word 4 + 32 of a staged row: 37 words, rounded up to 48."""
    plan = c1.conv1_plan(3, 10, 34, 40, torch.bfloat16)
    assert plan == c1.Conv1Plan("tc", (2, 3, 1), 128, 4, STAGE + 4 * 10 * 48)
    assert c1.conv1_plan(3, 2, 2, 8, torch.bfloat16) == c1.Conv1Plan("tc", (1, 3, 1), 128, 1, STAGE + 4 * 4 * 48)


@pytest.mark.parametrize("dtype,C", [(torch.float32, 32), (torch.float32, 8), (torch.bfloat16, 1),
                                     (torch.bfloat16, 12), (torch.bfloat16, 129 - 1 - 3)])
def test_conv1_plan_cuda_core_route(dtype, C):
    """float32, and bf16 with Cout not a multiple of 8, take the CUDA-core kernel."""
    plan = c1.conv1_plan(7, 6, 300, C, dtype)
    assert plan == c1.Conv1Plan("cuda_core", (2, 3, 7), 128, 1, 5120)


@pytest.mark.parametrize("W", [2, 30, 32, 34, 798, 800, 1602, 4000])
def test_conv1_tc_row_words(W):
    """A staged row holds its 16 bytes of zeros, its W / 2 words and every word the last tile's
    windows read (4 + 16 tiles), and is 16 mod 32 words long."""
    P = c1.tc_row_words(W)
    tiles = -(-(W // 2) // 16)
    assert P % 32 == 16 and 16 * tiles + 5 <= P < 16 * tiles + 5 + 32 and P >= 4 + W // 2


@pytest.mark.parametrize("W,rows", [(4000, 4), (12000, 3), (16000, 2), (20000, 1)])
def test_conv1_plan_cuts_the_band_to_fit(W, rows):
    """The band shrinks until its input rows fit the block's 227 KB of shared memory; past one row
    (W above ~28000) the CUDA-core kernel takes the shape, as it does above 65536."""
    plan = c1.conv1_plan(2, 64, W, 32, torch.bfloat16)
    assert plan.route == "tc" and plan.rows == rows and plan.smem_bytes <= c1.MAX_SMEM
    assert c1.tc_smem_bytes(W, rows + 1) > c1.MAX_SMEM or rows == c1.TC_ROWS
    assert c1.conv1_plan(2, 64, 30000, 32, torch.bfloat16).route == "cuda_core"
    assert c1.conv1_plan(2, 64, 70000, 32, torch.bfloat16).route == "cuda_core"


@pytest.mark.parametrize("args", [(0, 64, 800, 32), (65536, 64, 800, 32), (1, 63, 800, 32), (1, 64, 801, 32),
                                  (1, 0, 800, 32), (1, 64, 0, 32), (1, 64, 800, 0), (1, 64, 800, 129),
                                  (1, 2 * 65536, 8, 8)])
def test_conv1_plan_rejects_bad_shapes(args):
    with pytest.raises(ValueError):
        c1.conv1_plan(*args, torch.bfloat16)


def test_conv1_plan_rejects_other_dtypes():
    with pytest.raises(TypeError):
        c1.conv1_plan(1, 64, 800, 32, torch.float16)

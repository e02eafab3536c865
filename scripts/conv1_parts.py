"""Where a launch of the bf16 conv1-pool kernels goes, on the card.

At the main path's shape, x (512, 64, 800, 1) bf16 -> 32 channels, times by CUDA-graph replay
(``chip_smoke.py::graph_ms``, device time), in both output layouts:

* ``conv1_pool`` through the port's wrapper on each route: the tensor-core kernel
  (``csrc/conv1_pool_tc.cu``, the bf16 route) and the CUDA-core kernel (``csrc/conv1_pool.cu``,
  the route before it), the taps' packing included;
* the tensor-core kernel alone at bands of 1, 2, 4 and 8 pooled rows a block (4 is the one
  ``conv1_plan`` names);
* variants of it, each a copy of ``conv1_pool_tc.cu`` with a part cut out, built with ``nvcc``
  into a library of its own under ``img2latex_tpu_torch/build/conv1_parts/`` (they compute wrong
  values and are timed only): ``no_store`` (the output's global stores removed), ``no_product``
  (the mma replaced by a move of its operands), ``no_stage`` (NCHW written from registers, 2
  bytes a store, without the warp's staging through shared memory; NHWC as in the base), and
  ``stcs`` (the 16-byte stores as streaming ``st.global.cs``), ``span2`` and ``span1`` (a warp's item
  2 or 1 tiles of 16 pooled pixels wide instead of 4: NCHW runs of 64 or 32 bytes a channel, not
  128), ``bounds6`` (registers capped for 6 blocks an SM, not 4) and ``unroll1`` (the span's tiles
  in a loop that is not unrolled), which compute the right values, and ``no_input`` (the band's
  input rows not loaded);
* yardsticks: ``zero_`` of a tensor of the output's 419 MB (the card's rate of writing it), and
  cuDNN's ``conv2d`` + ``relu`` + ``max_pool2d`` in bf16 (channels-last for NHWC).

Prints one line a time with the card's name and power limit, in the order base, variants,
variants reversed, base for the variants.

    python3 scripts/conv1_parts.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

B, H, W, C = 512, 64, 800, 32


def _sub(src: str, old: str, new: str, count: int) -> str:
    """``src`` with each of the ``count`` copies of ``old`` replaced; raises unless ``old`` occurs
    exactly ``count`` times, so that a variant never keeps a part it claims to cut."""
    if src.count(old) != count:
        raise RuntimeError(f"the source holds {src.count(old)} of {old!r}, not {count}")
    return src.replace(old, new)


# variant -> [(old, new, count)] in conv1_pool_tc.cu
VARIANTS = {
    "base": [],
    "no_store": [("*reinterpret_cast<uint4*>(out + ", "if (H < 0) *reinterpret_cast<uint4*>(out + ", 2)],
    "no_product": [("i2l::mma_bf16_16816(acc[p], a, bf[p][j][0], bf[p][j][1]);",
                    "acc[p][0] = __uint_as_float(a[0] ^ bf[p][j][0]); acc[p][1] = __uint_as_float(a[1] ^ bf[p][j][1]); "
                    "acc[p][2] = __uint_as_float(a[2]); acc[p][3] = __uint_as_float(a[3]);", 1)],
    "no_stage": [("          if (kNHWC) {\n            // [pixel]",
                  "          if (!kNHWC) {\n"
                  "            __nv_bfloat16* o = out + (((size_t)b * Cout + c0 + 8 * j + 2 * q) * H2 + ph0 + r) * W2 + pw0 + g;\n"
                  "            o[0] = __float2bfloat16(v[0]); o[(size_t)H2 * W2] = __float2bfloat16(v[1]);\n"
                  "            o[8] = __float2bfloat16(v[2]); o[(size_t)H2 * W2 + 8] = __float2bfloat16(v[3]);\n"
                  "          } else if (kNHWC) {\n            // [pixel]", 1),
                 ("    const int ph = ph0 + r;\n    if (kNHWC) {", "    const int ph = ph0 + r;\n    if (!kNHWC) {\n    } else if (kNHWC) {", 1)],
    "stcs": [("*reinterpret_cast<uint4*>(out + ((size_t)(b * H2 + ph) * W2 + px0 + p) * Cout + c0 + 8 * jj) = v;",
              "__stcs(reinterpret_cast<uint4*>(out + ((size_t)(b * H2 + ph) * W2 + px0 + p) * Cout + c0 + 8 * jj), v);", 1),
             ("*reinterpret_cast<uint4*>(out + (((size_t)b * Cout + c0 + c) * H2 + ph) * W2 + px0 + 8 * h) = v;",
              "__stcs(reinterpret_cast<uint4*>(out + (((size_t)b * Cout + c0 + c) * H2 + ph) * W2 + px0 + 8 * h), v);", 1)],
    "span2": [("constexpr int kSpan = 4;", "constexpr int kSpan = 2;", 1)],
    "span1": [("constexpr int kSpan = 4;", "constexpr int kSpan = 1;", 1)],
    "no_input": [("i2l::cp_async_16(in + r * P", "if (H < 0) i2l::cp_async_16(in + r * P", 1)],
    "bounds6": [("__launch_bounds__(kThreads, 4)", "__launch_bounds__(kThreads, 6)", 1)],
    "unroll1": [("#pragma unroll\n    for (int t = 0; t < kSpan; ++t) {", "#pragma unroll 1\n    for (int t = 0; t < kSpan; ++t) {", 1)],
}


def _build_variant(name: str, edits) -> Path:
    from img2latex_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "conv1_parts" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    src = (_build.CSRC_DIR / "conv1_pool_tc.cu").read_text()
    for old, new, count in edits:
        src = _sub(src, old, new, count)
    (out / "conv1_pool_tc.cu").write_text(src)
    cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-I", str(_build.CSRC_DIR),
           "-o", str(out / "lib.so"), str(out / "conv1_pool_tc.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return out / "lib.so"


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("conv1_parts: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from img2latex_tpu_torch.ops import _build
    from img2latex_tpu_torch.ops import conv1_phase as c1
    from img2latex_tpu_torch.ops.preprocess import normalize_images

    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(lambda kv: _build_variant(*kv), VARIANTS.items())))
    card = cs.card_line()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = normalize_images(torch.from_numpy(rng.integers(0, 256, size=(B, H, W, 1), dtype=np.uint8)).to(dev),
                         dtype=torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((C, 1, 3, 3), dtype=np.float32) / 3.0).to(dev)
    b = torch.from_numpy(rng.standard_normal(C, dtype=np.float32) * 0.1).to(dev)
    packed = c1.pack_conv1_taps(w.to(torch.bfloat16))
    outs = {"nchw": torch.empty(B, C, H // 2, W // 2, dtype=torch.bfloat16, device=dev),
            "nhwc": torch.empty(B, H // 2, W // 2, C, dtype=torch.bfloat16, device=dev)}

    def kernel(lib, layout, rows):
        fn = lib.i2l_conv1_pool_tc
        fn.argtypes = _build.SIGNATURES["i2l_conv1_pool_tc"]
        o = outs[layout]

        def run():
            _build.check(fn(x.data_ptr(), packed.data_ptr(), b.data_ptr(), o.data_ptr(), B, H, W, C,
                            int(layout == "nhwc"), rows, torch.cuda.current_stream().cuda_stream),
                         "i2l_conv1_pool_tc")
        return run

    def line(what, ms):
        print(f"{what}: {ms:.4f} ms [{card}]", flush=True)

    nbytes = x.numel() * 2 + outs["nchw"].numel() * 2
    line(f"bound ({nbytes / 1e6:.1f} MB at 3.35 TB/s)", nbytes / 3.35e12 * 1e3)
    core = c1.conv1_plan(B, H, W, C, torch.float32)
    for layout in ("nchw", "nhwc"):
        line(f"conv1_pool {layout}, tensor-core route", cs.graph_ms(lambda: c1.conv1_pool_fwd(x, w, b, layout)))
        line(f"conv1_pool {layout}, CUDA-core route",
             cs.graph_ms(lambda: c1.conv1_pool_launch(x, w.to(torch.bfloat16).float().reshape(C, 9), b, layout, core)))
    base = ctypes.CDLL(str(libs["base"]))
    for layout in ("nchw", "nhwc"):
        for rows in (1, 2, 4, 8):
            line(f"conv1_pool_tc_kernel {layout}, {rows} rows a block", cs.graph_ms(kernel(base, layout, rows)))
    handles = {name: ctypes.CDLL(str(path)) for name, path in libs.items()}
    names = list(VARIANTS)
    for name in names + names[::-1]:
        for layout in ("nchw", "nhwc"):
            line(f"variant {name} {layout}, 4 rows a block", cs.graph_ms(kernel(handles[name], layout, 4)))
    line("zero_ of the 419 MB output", cs.graph_ms(lambda: outs["nchw"].zero_()))
    xn = x.permute(0, 3, 1, 2).contiguous()
    xcl = xn.contiguous(memory_format=torch.channels_last)
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    line("cuDNN conv2d+relu+max_pool2d nchw", cs.graph_ms(lambda: F.max_pool2d(F.relu(F.conv2d(xn, wb, bb, padding=1)), 2)))
    line("cuDNN conv2d+relu+max_pool2d channels-last",
         cs.graph_ms(lambda: F.max_pool2d(F.relu(F.conv2d(xcl, wb, bb, padding=1)), 2)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a launch of the bf16 cluster kernels of the beam and sampling steps goes, on the card.

Times, by CUDA-graph replay (``chip_smoke.py::graph_ms``, device time), ``beam_step`` at B = 512
samples of K = 5 beams (H = 384 and 512, Vp = 512, L = 2) and ``vocab_sample_step`` at B = 512
(H = 384, Vp = 512) with temperature 0.8, top-k 10 and top-p 0.9, with top-p 0.9 alone and with
top-k 5 alone, for:

* ``base``: the kernels as they are;
* ``no_product``: the tensor-core product of each slice removed (``vocab_slices.cuh``);
* ``no_gather``: the beam step's carry gather removed;
* ``no_select``: the beam step's per-block K passes and the cluster's merge removed;
* ``no_rows``: the sampling step's work after the product removed (a row's distributed shared
  memory reads, the filters and the draw);
* ``no_sort``: the sampling step's register sort removed (top-p without top-k);
* ``ring3``, ``ring2``: the product's cp.async ring 3 or 2 stages deep instead of 4
  (``tile_mma.cuh``), which lets 4 or 5 beam blocks share an SM instead of 3.

The variants without a part compute wrong values and are timed only: each is a copy of the
package under ``img2latex_tpu_torch/build/parts/<name>/`` with the part cut out of its sources,
built into its own library and run in its own process, in the order base, variants, variants
reversed, base.

    python3 scripts/vocab_step_parts.py
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "img2latex_tpu_torch"
OUT = PKG / "build" / "parts"


def _sub(src: str, old: str, new: str, count: int) -> str:
    """``src`` with each of the ``count`` copies of ``old`` replaced; raises unless ``old`` occurs
    exactly ``count`` times, so that a variant never keeps a part it claims to cut."""
    if src.count(old) != count:
        raise RuntimeError(f"the source holds {src.count(old)} of {old!r}, not {count}")
    return src.replace(old, new)


# variant -> [(file in csrc, old, new, count)]
VARIANTS = {
    "base": [],
    "no_product": [("vocab_slices.cuh", "tile::block_product<kAligned>(acc, ring, A, w_out, M, Vp, H, row0, sl * tile::kBN);",
                    "for (int j = 0; j < 2; ++j) for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;", 1)],
    "no_gather": [("beam_step_tc.cu", "e < total; e += C * tile::kThreads", "e < (H < 0 ? total : 0); e += C * tile::kThreads",
                   1)],
    "no_select": [("beam_step_tc.cu", "for (int n = 0; n < K; ++n) {", "for (int n = 0; n < (H < 0 ? K : 0); ++n) {", 2)],
    "no_rows": [("sample_step_tc.cu", "i < tile::kBM && row0 + i < B;", "i < (H < 0 ? tile::kBM : 0) && row0 + i < B;", 1)],
    "no_sort": [("sample_step_tc.cu", "warp_sort_desc<kN>(key, lane);", "(void)0;", 1)],
    "ring3": [("tile_mma.cuh", "constexpr int kStages = 4;", "constexpr int kStages = 3;", 1)],
    "ring2": [("tile_mma.cuh", "constexpr int kStages = 4;", "constexpr int kStages = 2;", 1)],
}

# Run in each variant's process: argv = [package root, variant name, repository root].
_TIMER = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[3])
import chip_smoke as cs
from img2latex_tpu_torch.ops import beam_decode as bd
from img2latex_tpu_torch.ops import decode_step as ds
assert bd.__file__.startswith(sys.argv[1]), bd.__file__
dev = torch.device("cuda")
B, K, Vp = 512, 5, 512
res = {}
for H in (384, 512):
    op = cs._beam_step_operands(dev, np.random.default_rng(H), B, K, H, Vp, torch.bfloat16)
    out = cs._beam_step_run(bd.beam_step, op, K)
    res[f"beam_step H={H}"] = cs.graph_ms(lambda: cs._beam_step_run(bd.beam_step, op, K, out))
op = cs._sample_step_operands(dev, np.random.default_rng(1), B, 384, Vp, torch.bfloat16)
out = cs._sample_step_run(ds.vocab_sample_step, op, top_k=10, top_p=0.9)
for name, kw in (("top-k 10, top-p 0.9", dict(top_k=10, top_p=0.9)), ("top-p 0.9", dict(top_p=0.9)),
                 ("top-k 5", dict(top_k=5))):
    res[f"vocab_sample_step H=384 {name}"] = cs.graph_ms(
        lambda: cs._sample_step_run(ds.vocab_sample_step, op, out=out, seed=5, **kw))
print(f"{sys.argv[2]}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in res.items()) + f" [{cs.card_line()}]", flush=True)
"""


def _variant(name: str, edits) -> Path:
    root = OUT / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name, ignore=shutil.ignore_patterns("build", "__pycache__"))
    for fname, old, new, count in edits:
        f = root / PKG.name / "csrc" / fname
        f.write_text(_sub(f.read_text(), old, new, count))
    return root


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("vocab_step_parts: no CUDA device", file=sys.stderr)
        return 1
    roots = {name: _variant(name, edits) for name, edits in VARIANTS.items()}
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from img2latex_tpu_torch.ops import _build; _build.build()", str(r)])
              for r in roots.values()]
    if any(p.wait() != 0 for p in builds):
        return 1
    names = list(VARIANTS)
    for name in names + names[::-1]:
        subprocess.run([sys.executable, "-c", _TIMER, str(roots[name]), name, str(ROOT)], check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the ResNet-50 greedy decode's bf16 kernels part from the plain decode, on the card.

``chip_smoke.py`` phases 23-24 hold the tokens of the kernel decode against the plain decode on
the same ResNet-50 memory (``compare_tokens``: a row may differ only from a step whose reference
top-2 logit margin is at most a limit, and a share of rows must agree).  This script reads what
those limits rest on, at the phases' shapes (batch 512, 64x800x3, E = H = 512, V = 503, T = 141,
bf16) over several seeds (the model's weights and biases, and the canvases):

* the kernel decode against the plain decode on one memory: rows that differ, the row match and
  the largest top-2 margin at a row's first difference; and the kernel decode run twice
  (bit-equal or not);
* the kernel decode on a memory that cuDNN's benchmark mode computed (other convolution
  algorithms, other roundings) against the plain decode on the default memory;
* for grid memory, decodes through the broken attention steps of
  ``chip_smoke.py::broken_attend_step`` ("first" and "last": the first or the last memory slot
  left out; "stale": the step before's context; "norm": the context scaled by 1 + 2^-6) against
  the plain decode.

Prints one JSON line a seed and memory kind, then a summary line, each with the card's name and
power limit, and writes them to ``chiprun_out/resnet_margins.json``.

    python3 scripts/resnet_margins.py [n_seeds=8]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BROKEN = ("first", "last", "stale", "norm")


def canvases(seed: int, n: int):
    """``n`` canvases as chip_smoke.py's main draws them: random ink over a
    random width, white after it."""
    import chip_smoke as cs

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(n, cs.IMG_H, cs.IMG_W, 1), dtype=np.uint8)
    widths = rng.integers(cs.IMG_W // 8, cs.IMG_W + 1, size=n)
    return [np.where(np.arange(cs.IMG_W)[None, :, None] < w, img, 255).astype(np.uint8)
            for img, w in zip(images, widths)]


def stats_of(cs, got, ref, margins) -> dict:
    """compare_tokens' statistics with no limit, and the five largest first-difference margins."""
    _, st = cs.compare_tokens(got, ref, margins, "bfloat16", m_tol=float("inf"), min_match=0.0)
    diff = got != ref
    rows = np.where(diff.any(axis=1))[0]
    first = diff.argmax(axis=1)
    st["top_first_diff_margins"] = sorted((float(margins[r, first[r]]) for r in rows), reverse=True)[:5]
    return {k: st[k] for k in ("rows_differ", "row_match", "max_margin_at_first_diff", "top_first_diff_margins",
                               "median_top2_margin", "ref_rows_ended")}


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from img2latex_tpu_torch.ops import _build

    argv = sys.argv[1:] if argv is None else argv
    n_seeds = int(argv[0]) if argv else 8
    if not torch.cuda.is_available():
        print("resnet_margins: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.lib()
    lines = []
    for memory in ("vector", "grid"):
        grid = memory == "grid"
        for seed in range(n_seeds):
            images = canvases(1000 + seed, cs.BATCH)
            _, model, _, x, share = cs.resnet_greedy_setup(dev, memory, 2000 + seed, images)
            row = {"memory": memory, "seed": seed, "end_share": share}
            with torch.no_grad():
                torch.backends.cudnn.benchmark = False
                mem = model.encode(x)
                decode, plain, through = cs.resnet_decoders(model, mem, grid)
                toks = decode().cpu().numpy()
                row["kernel_twice_equal"] = bool(np.array_equal(toks, decode().cpu().numpy()))
                ref, margins = (t.cpu().numpy() for t in plain())
                row["kernel"] = stats_of(cs, toks, ref, margins)
                torch.backends.cudnn.benchmark = True
                model.encode(x)  # the benchmark's search
                mem_b = model.encode(x)
                torch.backends.cudnn.benchmark = False
                row["bench_memory_max_abs_diff"] = float((mem_b.float() - mem.float()).abs().max())
                decode_b, _, _ = cs.resnet_decoders(model, mem_b, grid)
                row["kernel_on_bench_memory"] = stats_of(cs, decode_b().cpu().numpy(), ref, margins)
                if grid:
                    for mode in BROKEN:
                        row[f"broken_{mode}"] = stats_of(cs, through(cs.broken_attend_step(mode)).cpu().numpy(),
                                                         ref, margins)
            row["card"] = card
            print(json.dumps(row), flush=True)
            lines.append(row)
            del model, x, mem
            torch.cuda.empty_cache()
    summary = {"card": card, "seconds": round(time.perf_counter() - t0, 1)}
    for memory in ("vector", "grid"):
        rows = [r for r in lines if r["memory"] == memory]
        for key in ("kernel", "kernel_on_bench_memory") + tuple(f"broken_{m}" for m in BROKEN):
            got = [r[key] for r in rows if key in r]
            if not got:
                continue
            margins = [g["max_margin_at_first_diff"] for g in got if g["max_margin_at_first_diff"] is not None]
            summary[f"{memory}_{key}"] = {"max_margin_at_first_diff": max(margins) if margins else None,
                                          "min_margin_at_first_diff": min(margins) if margins else None,
                                          "min_row_match": min(g["row_match"] for g in got),
                                          "max_rows_differ": max(g["rows_differ"] for g in got)}
        summary[f"{memory}_kernel_twice_equal"] = all(r["kernel_twice_equal"] for r in rows)
    print(json.dumps(summary), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "resnet_margins.json").write_text(json.dumps({"rows": lines, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

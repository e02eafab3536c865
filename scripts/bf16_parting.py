"""Rows of the bf16 grid greedy decode that part from the plain version's
tokens, on several data draws, for the PyTorch port in a given tree.

Each draw is ``chip_smoke.py``'s grid decode check (B = 512, T = 141, the
grid model from the same weight seed, biases and grid memory drawn from
``np.random.default_rng(SEED + 1000 + draw)``), held by the same rule
(``compare_tokens`` with ``grid=True``).  ``--root`` points at the tree whose
``img2latex_tpu_torch`` runs (default: this one), so that two versions of the
kernels can be compared on the same draws, for example the parent commit
unpacked by ``git archive`` into an ignored directory::

    python3 scripts/bf16_parting.py --draws 6
    python3 scripts/bf16_parting.py --draws 6 --root build/parent

Needs a CUDA card.  Prints one JSON line a draw, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="tree whose img2latex_tpu_torch runs")
    ap.add_argument("--draws", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke as cs  # its constants, model config and rule; it imports no package at import

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("bf16_parting: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import img2latex_tpu_torch
    from img2latex_tpu_torch.models.seq2seq import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    pkg = os.path.dirname(img2latex_tpu_torch.__file__)
    print(f"package {pkg}; card {cs.card_line()}", flush=True)
    gcfg = cs.grid_config()
    parted = []
    for d in range(args.draws):
        rng = np.random.default_rng(cs.SEED + 1000 + d)
        gmodel = build_model(gcfg, cs.VOCAB, seed=cs.SEED + 1)
        cs.draw_biases(gmodel, rng)
        kernel, plain = cs._decoders("grid", gmodel, cs.grid_memory(rng, dev), torch.bfloat16)
        got = kernel()
        ref, margins = plain(return_margins=True)
        ok, stats = cs.compare_tokens(got.cpu().numpy(), ref.cpu().numpy(), margins.cpu().numpy(), "bfloat16",
                                      grid=True)
        parted.append(stats["rows_differ"])
        print(json.dumps({"draw": d, "rule_ok": ok, **stats}), flush=True)
    print(json.dumps({"package": pkg, "rows_differ": parted, "rows": cs.BATCH}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

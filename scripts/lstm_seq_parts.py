"""Where a step of the persistent bf16 ``lstm_seq`` kernels goes, on the card.

Times one layer (T = 140, B = 128, H = 512, bf16, CUDA events around 20
launches) of the forward and of the backward recurrence
(``ops/lstm_train.py::_bwd_recurrence``) for:

* ``base``: the kernels as they are;
* ``no_product``: each step's tensor-core product removed;
* ``no_exchange_no_barrier``: the distributed shared memory writes and the
  step's cluster barriers removed;
* the row choices of ``seq_plan``: 16 or 32 rows a cluster for the forward,
  16 (two buffers) or 32 (one buffer) for the backward, at H = 512 and at
  H = 384 (whose 16-row forward fits two blocks an SM).

The variants without a part compute wrong values and are timed only: each is
a copy of the package under ``img2latex_tpu_torch/build/parts/<name>/``
whose ``csrc/lstm_seq_tc.cu`` has the part cut out, built into its own
library and run in its own process, in the order base, variants, variants
reversed, base.

    python3 scripts/lstm_seq_parts.py
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
    """``src`` with each of the ``count`` copies of ``old`` replaced; raises
    unless ``old`` occurs exactly ``count`` times, so that a variant never
    keeps a part it claims to cut."""
    if src.count(old) != count:
        raise RuntimeError(f"lstm_seq_tc.cu holds {src.count(old)} of {old!r}, not {count}")
    return src.replace(old, new)


def _no_product(src: str) -> str:
    src = _sub(src, "for (int k0 = 0; k0 < K; k0 += P_STAGE) {",
               "for (int k0 = 0; k0 < (H < 0 ? K : 0); k0 += P_STAGE) {", 1)
    return _sub(src, "for (int k0 = 0; k0 < KD; k0 += P_STAGE) {",
                "for (int k0 = 0; k0 < (H < 0 ? KD : 0); k0 += P_STAGE) {", 1)


def _no_exchange_no_barrier(src: str) -> str:
    start, end = src.index("// ---- forward ----"), src.index("// ---- dW_hh on the tensor cores")
    body = src[start:end]
    body = _sub(body, "*reinterpret_cast<uint4*>(remote", "if (v.x == 0x12345) *reinterpret_cast<uint4*>(remote", 1)
    body = _sub(body, "*reinterpret_cast<float4*>(remote", "if (v.x == 1234.5f) *reinterpret_cast<float4*>(remote", 1)
    body = _sub(_sub(body, "cluster_arrive();", "{}", 4), "cluster_wait();", "{}", 4)
    return src[:start] + body + src[end:]


VARIANTS = {"base": None, "no_product": _no_product, "no_exchange_no_barrier": _no_exchange_no_barrier}

# Run in each variant's process: argv = [package root, variant name, row choices (0: seq_plan's),
# repository root, H].
_TIMER = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(1, sys.argv[4])
import chip_smoke as cs
from img2latex_tpu_torch.ops import lstm_train as lt
assert lt.__file__.startswith(sys.argv[1]), lt.__file__
T, B, H = 140, 128, int(sys.argv[5])
fwd_rows, bwd_rows = (int(x) for x in sys.argv[3].split(","))
plan = lt.seq_plan(B, H, torch.bfloat16)
if fwd_rows:
    U = H // 16
    nb = 2 if lt._fwd_smem(H, U, 2, fwd_rows) <= lt.SMEM_LIMIT else 1
    fwd = lt.SeqRoute("persistent", 16, fwd_rows, nb, lt._fwd_smem(H, U, nb, fwd_rows))
    nb = 2 if lt._bwd_smem(H, U, 2, bwd_rows) <= lt.SMEM_LIMIT else 1
    bwd = lt.SeqRoute("persistent", 16, bwd_rows, nb, lt._bwd_smem(H, U, nb, bwd_rows))
    plan = lt.SeqPlan(fwd, bwd)
    lt.seq_plan = lambda b, h, d: plan
dev = torch.device("cuda")
op = cs._lstm_operands(dev, np.random.default_rng(3), T, B, H, torch.bfloat16)
wt = op["w"].t().contiguous()
ys, c_, ga = lt.lstm_seq_fwd(op["gx"], op["h0"], op["c0"], wt)
args = (op["dys"], op["dhT"], op["dcT"], ga, c_, op["c0"], op["w"])
f = cs.time_ms(lambda: lt.lstm_seq_fwd(op["gx"], op["h0"], op["c0"], wt), iters=20, warmup=2)
b = cs.time_ms(lambda: lt._bwd_recurrence(*args), iters=20, warmup=2)
print(f"{sys.argv[2]} H={H} (forward {plan.fwd.rows} rows, {plan.fwd.buffers} buffers; backward {plan.bwd.rows} rows, "
      f"{plan.bwd.buffers} buffers): forward {f:.4f} ms ({1e3 * f / T:.2f} us a step), backward recurrence "
      f"{b:.4f} ms ({1e3 * b / T:.2f} us a step) [{cs.card_line()}]", flush=True)
"""


def _variant(name: str, edit) -> Path:
    root = OUT / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, root / PKG.name, ignore=shutil.ignore_patterns("build", "__pycache__"))
    if edit is not None:
        cu = root / PKG.name / "csrc" / "lstm_seq_tc.cu"
        src = cu.read_text()
        cu.write_text(edit(src))
    return root


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lstm_seq_parts: no CUDA device", file=sys.stderr)
        return 1
    roots = {name: _variant(name, edit) for name, edit in VARIANTS.items()}
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from img2latex_tpu_torch.ops import _build; _build.build()", str(r)])
              for r in roots.values()]
    if any(p.wait() != 0 for p in builds):
        return 1
    runs = [(name, "0,0", 512) for name in VARIANTS] + [("base", "16,16", 512), ("base", "32,32", 512),
                                                       ("base", "0,0", 384), ("base", "32,32", 384)]
    for name, rows, H in runs + runs[::-1]:
        subprocess.run([sys.executable, "-c", _TIMER, str(roots[name]), name, rows, str(ROOT), str(H)],
                       check=True, timeout=600)
    return 0


if __name__ == "__main__":
    sys.exit(main())

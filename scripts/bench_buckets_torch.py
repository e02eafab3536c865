"""Aspect-ratio bucketing throughput of the PyTorch/CUDA port: the fixed 64x800
canvas against bucketed canvases, greedy decode on one card.

The counterpart of ``scripts/bench_buckets.py`` for ``img2latex_tpu_torch``,
with its shapes (vocab 503, 64x800 gray canvas, filters [32, 64, 128],
E = H = 512, 2 LSTM layers, 141 steps, bf16, random weights from a seed),
batch 1024 and buckets [320, 512, 640], and its population: natural widths
lognormal with median 0.42 x 800 px and sigma 0.45, seed 0, clipped to
[24, 799].  The fixed path runs the encoder at 800 px for every image; the
bucketed path runs each bucket's batches at its canvas width (the bucket
plus the 32-px white margin) through ``Predictor.dispatch_canvases(width=)``,
which fills the feature map back to full width with the white canvas's
columns (the tokens are the fixed canvas's: ``tests/test_torch_buckets.py``).
The decode does not depend on the width, so the gain is the encoder's share
times the width saved.

Each path: one warm-up call per canvas width (the kernels' build, the
library's plans, the white canvas's features), then every batch of the
population enqueued with a checksum of its tokens added on the card, and
one sync.  Canvases are random uint8 already on the card (throughput only).

    python scripts/bench_buckets_torch.py [n_images=8192] [--smoke]

``--smoke`` runs the JAX script's smoke shapes (vocab 64, 32x256, E = H =
32, 1 layer, 12 steps, float32, buckets [64, 128, 192], batch 8, 64
images).  Prints ONE JSON line: ``{"metric": "bucketed_vs_fixed_speedup",
"value": x, "unit": "x", "fixed_img_per_sec": ..., "bucketed_img_per_sec":
..., "fixed_rows_per_sec": ..., "bucketed_rows_per_sec": ...}``.  The
``img_per_sec`` rates and ``value`` count the population's ``n_images``
over each path's wall time.  The ``rows_per_sec`` rates count every row of
every batch, padding rows included, as ``scripts/bench_buckets.py`` counts
its ``img_per_sec``: a bucket's last batch is partial, so the bucketed path
runs more rows than the fixed one (9 batches against 8 at 8192 images).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE: Optional[str] = None  # the card; tests name "cpu"


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from img2latex_tpu_torch.config import Config
    from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.training.predictor import Predictor
    from img2latex_tpu_torch.utils.device import resolve_device

    args = sys.argv[1:] if argv is None else list(argv)
    smoke = "--smoke" in args
    args = [a for a in args if not a.startswith("--")]
    if smoke:
        vocab, h, w_full, embed, hidden, layers, max_len = 64, 32, 256, 32, 32, 1, 12
        buckets, B, dtype = [64, 128, 192], 8, "float32"
        n_images = int(args[0]) if args else 64
    else:
        vocab, h, w_full, embed, hidden, layers, max_len = 503, 64, 800, 512, 512, 2, 141
        buckets, B, dtype = [320, 512, 640], 1024, "bfloat16"
        n_images = int(args[0]) if args else 8192
    dev = resolve_device(DEVICE)

    cfg = Config()
    cfg.model.embedding_dim = embed
    cfg.model.decoder.hidden_dim = hidden
    cfg.model.decoder.lstm_layers = layers
    cfg.model.decoder.dropout = 0.0
    cfg.model.encoder.cnn.img_height, cfg.model.encoder.cnn.img_width = h, w_full
    cfg.data.max_seq_length = cfg.inference.max_length = max_len
    cfg.hardware.compute_dtype = dtype
    tok = LaTeXTokenizer(max_sequence_length=max_len)
    tok.default_init()
    model = build_model(cfg, vocab, device=str(dev), seed=0)
    pred = Predictor(cfg, model, tok, batch_size=B, device=str(dev))
    dcfg = pred.decode_config()

    rng = np.random.default_rng(0)
    median_w = int(w_full * 0.42)
    nat_w = np.clip(rng.lognormal(np.log(median_w), 0.45, size=n_images), 24, w_full - 1).astype(int)
    margin = pred.bucket_margin_px()

    def bucket_of(w):
        for bw in buckets:
            if w + margin <= bw:
                return bw
        return None

    assignments = [bucket_of(int(w)) for w in nat_w]
    share = {bw: assignments.count(bw) for bw in buckets + [None]}
    print(f"width median {np.median(nat_w):.0f}; bucket shares {share}", file=sys.stderr)

    def batches_for(width):
        """(batches of the bucket, one batch of canvases on the device)."""
        canvas_w = w_full if width is None else width + margin
        img = torch.from_numpy(rng.integers(0, 256, size=(B, h, canvas_w, 1), dtype=np.uint8)).to(dev)
        return -(-share[width] // B), img

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def time_path(runs):
        """runs: (bucket width or None, batches, canvases) -> (seconds, rows)."""
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for bw, _, img in runs:  # warm-up of each width
            acc += pred.dispatch_canvases(img, dcfg, width=bw).sum(dtype=torch.int64)
        _ = int(acc)
        sync()
        acc.zero_()
        total = 0
        t0 = time.perf_counter()
        for bw, n_b, img in runs:
            for _ in range(n_b):
                acc += pred.dispatch_canvases(img, dcfg, width=bw).sum(dtype=torch.int64)
                total += B
        _ = int(acc)  # one sync
        return time.perf_counter() - t0, total

    fixed_s, fixed_rows = time_path([(None, -(-n_images // B), batches_for(None)[1])])
    bucketed = []
    for bw in buckets + [None]:
        n_b, img = batches_for(bw)
        if n_b:
            bucketed.append((bw, n_b, img))
    bucket_s, bucket_rows = time_path(bucketed)
    fixed_ips, bucket_ips = n_images / fixed_s, n_images / bucket_s
    print(f"device={dev} batch={B} {n_images} images: fixed {fixed_ips:.0f} img/s ({fixed_rows} rows) vs bucketed "
          f"{bucket_ips:.0f} img/s ({bucket_rows} rows) ({bucket_ips / fixed_ips:.2f}x)", file=sys.stderr)
    result = {"metric": "bucketed_vs_fixed_speedup", "value": round(bucket_ips / fixed_ips, 3), "unit": "x",
              "fixed_img_per_sec": round(fixed_ips, 1), "bucketed_img_per_sec": round(bucket_ips, 1),
              "fixed_rows_per_sec": round(fixed_rows / fixed_s, 1),
              "bucketed_rows_per_sec": round(bucket_rows / bucket_s, 1)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

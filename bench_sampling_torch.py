"""Benchmark of the PyTorch/CUDA port: top-k sampling decode throughput (images/s).

The counterpart of ``bench_sampling.py`` for ``img2latex_tpu_torch`` on one
card: ``bench.py``'s shapes (64x800 gray canvas, filters [32, 64, 128],
E = H = 512, 2 LSTM layers, vocab 503, 141 steps, bf16, random weights from
a seed) and its path with the vector sampling decode at temperature 0.8 and
top-k 10 (``ops/decode_step.py::sample_decode``: the LSTM kernel and the
vocab-sample kernel).  A warm-up call, then 20 timed calls, each with the
kernel seed of its index (``training/predictor.py::batch_seed``), that add a
checksum of the tokens on the card, and one sync.

    python bench_sampling_torch.py [batch=3072] [kernel]

``scan`` (the JAX package's XLA scan path) names a TPU-only variant and raises.

Prints ONE JSON line: ``{"metric": "topk_sampling_decode_images_per_sec",
..., "vs_baseline": null}``.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np

VOCAB = 503
IMG_H, IMG_W, IMG_C = 64, 800, 1
FILTERS = [32, 64, 128]
EMBED, HIDDEN, LAYERS = 512, 512, 2
MAX_LEN = 141
ITERS = 20
TEMPERATURE, TOP_K = 0.8, 10
DEVICE: Optional[str] = None  # the card; tests name "cpu"


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    import torch

    from img2latex_tpu_torch.config import Config
    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.ops.decode_step import pack_decoder_weights, sample_decode
    from img2latex_tpu_torch.ops.preprocess import normalize_images
    from img2latex_tpu_torch.training.predictor import batch_seed
    from img2latex_tpu_torch.utils.device import resolve_device

    args = sys.argv[1:] if argv is None else list(argv)
    B = int(args[0]) if args else 3072
    variant = args[1] if len(args) > 1 else "kernel"
    if variant == "scan":
        raise ValueError("bench_sampling_torch.py: 'scan' is the JAX package's XLA scan path; the port "
                         "samples with its kernels only")
    if variant != "kernel":
        raise ValueError(f"bench_sampling_torch.py: unknown variant {variant!r} (kernel)")
    dev = resolve_device(DEVICE)

    cfg = Config()
    cfg.model.embedding_dim = EMBED
    cfg.model.decoder.hidden_dim = HIDDEN
    cfg.model.decoder.lstm_layers = LAYERS
    cfg.model.decoder.dropout = 0.0
    cfg.model.encoder.cnn.img_height, cfg.model.encoder.cnn.img_width = IMG_H, IMG_W
    cfg.model.encoder.cnn.conv_filters = list(FILTERS)
    cfg.data.max_seq_length = cfg.inference.max_length = MAX_LEN
    cfg.hardware.compute_dtype = "bfloat16"
    model = build_model(cfg, VOCAB, device=str(dev), seed=0).eval()
    dtype = torch.bfloat16
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, size=(B, IMG_H, IMG_W, IMG_C), dtype=np.uint8)).to(dev)
    packed = pack_decoder_weights(model.decoder, dtype)

    @torch.no_grad()
    def decode(images_u8, seed: int):
        x = normalize_images(images_u8, dtype=dtype)
        memory = model.encode(x)
        return sample_decode(packed, memory[:, 0, :], MAX_LEN, 1, 2, 0, top_k=TOP_K, seed=seed,
                             temperature=TEMPERATURE)

    t0 = time.perf_counter()
    _ = int(decode(images, batch_seed(0, 0)).sum(dtype=torch.int64))  # warm-up: the kernels' build
    first_s = time.perf_counter() - t0
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for i in range(ITERS):
        acc += decode(images, batch_seed(0, i)).sum(dtype=torch.int64)
    total = int(acc)  # one sync
    elapsed = time.perf_counter() - t0
    assert total >= 0
    ips = B * ITERS / elapsed
    print(f"device={dev} batch={B} top_k={TOP_K} T={TEMPERATURE} first={first_s:.1f}s "
          f"steady={elapsed / ITERS * 1e3:.1f}ms/iter", file=sys.stderr)
    result = {"metric": "topk_sampling_decode_images_per_sec", "value": round(ips, 1), "unit": "img/s",
              "vs_baseline": None}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

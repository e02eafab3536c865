"""Benchmark of the PyTorch/CUDA port: greedy-decode throughput (images/s).

The counterpart of ``bench.py`` for ``img2latex_tpu_torch`` on one card: the
same shapes (64x800 gray canvas, filters [32, 64, 128], E = H = 512, 2 LSTM
layers, vocab 503, 141 steps, bf16, random weights from a seed) and the same
path, a uint8 batch already on the card -> normalize -> CNN encoder (block 0
through the conv1-pool kernel) -> the whole greedy decode
(``ops/decode_step.py::greedy_decode``).  A warm-up call, then 20 timed
calls that add a checksum of the tokens on the card, and one sync.

    python bench_torch.py [batch=6144] [conv1|chain]

``chain`` puts blocks 1-2 of the encoder on the channel-first chain
(``hardware.pallas_chain``).  ``xla`` names an encoder without the TPU
kernels, which exists only in the JAX package, and raises.

Prints ONE JSON line: ``{"metric": "greedy_decode_images_per_sec",
"value": N, "unit": "img/s", "vs_baseline": null}``.  ``bench.py``'s
baseline is a TPU v5e-8 target, so this script states none.
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
DEVICE: Optional[str] = None  # the card; tests name "cpu"


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    import torch

    from img2latex_tpu_torch.config import Config
    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.ops.decode_step import greedy_decode, pack_decoder_weights
    from img2latex_tpu_torch.ops.preprocess import normalize_images
    from img2latex_tpu_torch.utils.device import resolve_device

    args = sys.argv[1:] if argv is None else list(argv)
    B = int(args[0]) if args else 6144
    variant = args[1] if len(args) > 1 else "conv1"
    if variant == "xla":
        raise ValueError("bench_torch.py: 'xla' is the JAX package's encoder without its TPU kernels; "
                         "the port has no such variant (use conv1 or chain)")
    if variant not in ("conv1", "chain"):
        raise ValueError(f"bench_torch.py: unknown encoder variant {variant!r} (conv1 or chain)")
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
    cfg.hardware.pallas_chain = variant == "chain"
    model = build_model(cfg, VOCAB, device=str(dev), seed=0).eval()
    dtype = torch.bfloat16
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, size=(B, IMG_H, IMG_W, IMG_C), dtype=np.uint8)).to(dev)
    packed = pack_decoder_weights(model.decoder, dtype)

    @torch.no_grad()
    def decode(images_u8):
        x = normalize_images(images_u8, dtype=dtype)
        memory = model.encode(x)
        return greedy_decode(packed, memory[:, 0, :], MAX_LEN, 1, 2, 0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    _ = int(decode(images).sum(dtype=torch.int64))  # warm-up: the kernels' build, library plans
    first_s = time.perf_counter() - t0
    sync()
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        acc += decode(images).sum(dtype=torch.int64)
    total = int(acc)  # one sync
    elapsed = time.perf_counter() - t0
    assert total >= 0
    ips = B * ITERS / elapsed
    print(f"device={dev} batch={B} encoder={variant} first={first_s:.1f}s "
          f"steady={elapsed / ITERS * 1e3:.1f}ms/iter", file=sys.stderr)
    result = {"metric": "greedy_decode_images_per_sec", "value": round(ips, 1), "unit": "img/s",
              "vs_baseline": None}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

"""Benchmark of the PyTorch/CUDA port: beam-search decode throughput (images/s).

The counterpart of ``bench_beam.py`` for ``img2latex_tpu_torch`` on one
card: ``bench.py``'s shapes (64x800 gray canvas, filters [32, 64, 128],
E = H = 512, 2 LSTM layers, vocab 503, 141 steps, bf16, random weights from
a seed) and its path with the vector beam decode
(``ops/beam_decode.py::beam_decode``: the LSTM kernel over K·B rows and the
beam-step kernel) in place of greedy.  A warm-up call, then 10 timed calls
(as ``bench_beam.py``) that add a checksum of the tokens on the card, and one
sync.

    python bench_beam_torch.py [batch=512] [beam=5]

``--scan`` (the JAX package's XLA scan path) and a third argument (the TPU
kernel's batch tile) name TPU-only variants and raise.

Prints ONE JSON line: ``{"metric": "beam{K}_decode_images_per_sec", ...,
"vs_baseline": null}``.
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
ITERS = 10
DEVICE: Optional[str] = None  # the card; tests name "cpu"


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    import torch

    from img2latex_tpu_torch.config import Config
    from img2latex_tpu_torch.decoding.decode import DecodeConfig
    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.ops.beam_decode import beam_decode
    from img2latex_tpu_torch.ops.decode_step import pack_decoder_weights
    from img2latex_tpu_torch.ops.preprocess import normalize_images
    from img2latex_tpu_torch.utils.device import resolve_device

    argv = sys.argv[1:] if argv is None else list(argv)
    if "--scan" in argv:
        raise ValueError("bench_beam_torch.py: --scan is the JAX package's XLA scan path; the port "
                         "decodes with its beam kernels only")
    args = [a for a in argv if not a.startswith("--")]
    if len(args) > 2:
        raise ValueError("bench_beam_torch.py: a third argument sets the TPU kernel's batch tile, "
                         "which the port's kernels do not take")
    B = int(args[0]) if args else 512
    K = int(args[1]) if len(args) > 1 else 5
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
    dcfg = DecodeConfig(max_length=MAX_LEN, start_id=1, end_id=2, pad_id=0, beam_size=K)

    @torch.no_grad()
    def decode(images_u8):
        x = normalize_images(images_u8, dtype=dtype)
        memory = model.encode(x)
        return beam_decode(packed, memory[:, 0, :], K, dcfg)[0]

    t0 = time.perf_counter()
    _ = int(decode(images).sum(dtype=torch.int64))  # warm-up: the kernels' build, library plans
    first_s = time.perf_counter() - t0
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        acc += decode(images).sum(dtype=torch.int64)
    total = int(acc)  # one sync
    elapsed = time.perf_counter() - t0
    assert total >= 0
    ips = B * ITERS / elapsed
    print(f"device={dev} batch={B} beam={K} first={first_s:.1f}s steady={elapsed / ITERS * 1e3:.1f}ms/iter",
          file=sys.stderr)
    result = {"metric": f"beam{K}_decode_images_per_sec", "value": round(ips, 1), "unit": "img/s",
              "vs_baseline": None}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

"""Benchmark of the PyTorch/CUDA port: ResNet-LSTM greedy-decode throughput (images/s).

The counterpart of ``bench_resnet.py`` for ``img2latex_tpu_torch`` on one
card: the same shapes (64x800x3 canvas, a ResNet encoder, vector memory,
E = H = 512, 2 LSTM layers, vocab 503, 141 steps, bf16, random weights from
a seed) and the same path, a uint8 batch already on the card -> normalize
(ImageNet mean and std) -> ResNet backbone (cuDNN convolutions, the flax
BatchNorm on its running statistics) and head -> the whole greedy decode
through the port's kernels (``ops/decode_step.py::greedy_decode``).  A
warm-up call, then 20 timed calls that add a checksum of the tokens on the
card, and one sync; then the encoder alone, timed the same way, for its
share (on standard error).

    python bench_resnet_torch.py [batch=512] [resnet_name=resnet50]

Prints ONE JSON line: ``{"metric": "<resnet_name>_greedy_decode_images_per_sec",
"value": N, "unit": "img/s", "vs_baseline": null}``.  ``bench_resnet.py``'s
baseline is a TPU target, so this script states none.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np

VOCAB = 503
IMG_H, IMG_W, IMG_C = 64, 800, 3
EMBED, HIDDEN, LAYERS = 512, 512, 2
MAX_LEN = 141
ITERS = 20
DEVICE: Optional[str] = None  # the card; tests name "cpu"


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    import torch

    from img2latex_tpu_torch.config import Config
    from img2latex_tpu_torch.models.resnet import STAGE_SIZES
    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.ops.decode_step import greedy_decode, pack_decoder_weights
    from img2latex_tpu_torch.ops.preprocess import normalize_images
    from img2latex_tpu_torch.utils.device import resolve_device

    args = sys.argv[1:] if argv is None else list(argv)
    B = int(args[0]) if args else 512
    name = args[1] if len(args) > 1 else "resnet50"
    if name not in STAGE_SIZES:
        raise ValueError(f"bench_resnet_torch.py: unknown ResNet {name!r} (one of {sorted(STAGE_SIZES)})")
    dev = resolve_device(DEVICE)

    cfg = Config()
    cfg.model.name = "resnet_lstm"
    cfg.model.encoder.resnet.model_name = name
    cfg.model.encoder.resnet.img_height, cfg.model.encoder.resnet.img_width = IMG_H, IMG_W
    cfg.model.embedding_dim = EMBED
    cfg.model.decoder.hidden_dim = HIDDEN
    cfg.model.decoder.lstm_layers = LAYERS
    cfg.model.decoder.dropout = 0.0
    cfg.data.max_seq_length = cfg.inference.max_length = MAX_LEN
    cfg.hardware.compute_dtype = "bfloat16"
    model = build_model(cfg, VOCAB, device=str(dev), seed=0)
    dtype = torch.bfloat16
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, size=(B, IMG_H, IMG_W, IMG_C), dtype=np.uint8)).to(dev)
    packed = pack_decoder_weights(model.decoder, dtype)

    @torch.no_grad()
    def encode(images_u8):
        return model.encode(normalize_images(images_u8, dtype=dtype))

    @torch.no_grad()
    def decode(images_u8):
        return greedy_decode(packed, encode(images_u8)[:, 0, :], MAX_LEN, 1, 2, 0)

    def timed(fn, reduce):
        acc = torch.zeros((), dtype=torch.float64, device=dev)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            acc += reduce(fn(images))
        total = float(acc)  # one sync
        return (time.perf_counter() - t0) / ITERS, total

    t0 = time.perf_counter()
    _ = int(decode(images).sum(dtype=torch.int64))  # warm-up: the kernels' build, cuDNN plans
    first_s = time.perf_counter() - t0
    step_s, total = timed(decode, lambda t: t.sum(dtype=torch.int64))
    enc_s, enc_sum = timed(encode, lambda m: m.float().sum())
    assert total >= 0 and np.isfinite(enc_sum)
    ips = B / step_s
    print(f"{name} device={dev} batch={B} first={first_s:.1f}s steady={step_s * 1e3:.1f}ms/iter "
          f"encoder={enc_s * 1e3:.1f}ms/iter ({100 * enc_s / step_s:.1f}%)", file=sys.stderr)
    result = {"metric": f"{name}_greedy_decode_images_per_sec", "value": round(ips, 1), "unit": "img/s",
              "vs_baseline": None}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

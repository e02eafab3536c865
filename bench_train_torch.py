"""Benchmark of the PyTorch/CUDA port: training-step throughput (images/s).

The counterpart of ``bench_train.py`` for ``img2latex_tpu_torch`` on one
card: its shapes (batch 128, 64x800 gray canvas, filters [32, 64, 128],
E = H = 512, 2 LSTM layers, vocab 503, sequences of 141, bf16, dropout 0.3,
random weights from a seed) and the whole train step
(``training/steps.py::make_train_step``: normalize, the teacher-forced
forward with the conv1-pool and whole-sequence LSTM kernels, the
label-smoothed loss, the backward, clip and Adam) on a batch already on the
card.  A warm-up step, then 30 timed steps and one sync on the last loss.

    python bench_train_torch.py [batch=128]

``--augment`` (the JAX package's on-device augmentation) is not ported
(ROADMAP.md queue 1 item 5) and raises.

Prints ONE JSON line: ``{"metric": "train_step_images_per_sec", ...,
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
SEQ = 141
ITERS = 30
DEVICE: Optional[str] = None  # the card; tests name "cpu"


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    import torch

    from img2latex_tpu_torch.config import Config
    from img2latex_tpu_torch.models.seq2seq import build_model
    from img2latex_tpu_torch.training.optim import build_optimizer
    from img2latex_tpu_torch.training.steps import create_train_state, make_train_step
    from img2latex_tpu_torch.utils.device import resolve_device

    args = sys.argv[1:] if argv is None else list(argv)
    if "--augment" in args:
        raise ValueError("bench_train_torch.py: --augment (on-device augmentation) is not ported yet "
                         "(ROADMAP.md queue 1 item 5)")
    B = int(args[0]) if args else 128
    dev = resolve_device(DEVICE)

    cfg = Config()
    cfg.model.embedding_dim = EMBED
    cfg.model.decoder.hidden_dim = HIDDEN
    cfg.model.decoder.lstm_layers = LAYERS
    cfg.model.decoder.dropout = 0.3
    cfg.model.encoder.cnn.img_height, cfg.model.encoder.cnn.img_width = IMG_H, IMG_W
    cfg.model.encoder.cnn.conv_filters = list(FILTERS)
    cfg.data.max_seq_length = SEQ
    cfg.training.accumulation_steps = 1
    cfg.hardware.compute_dtype = "bfloat16"
    model = build_model(cfg, VOCAB, device=str(dev), seed=0)
    state = create_train_state(model, build_optimizer(cfg, model), cfg, seed=1)
    step = make_train_step(cfg, pad_id=0)
    rng = np.random.default_rng(0)
    batch = {
        "images": torch.from_numpy(rng.integers(0, 256, size=(B, IMG_H, IMG_W, IMG_C), dtype=np.uint8)).to(dev),
        "formulas": torch.from_numpy(rng.integers(0, VOCAB, size=(B, SEQ), dtype=np.int32)).to(dev),
    }

    t0 = time.perf_counter()
    _ = float(step(state, batch)["loss"])  # warm-up: the kernels' build, library plans
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(ITERS):
        metrics = step(state, batch)
    loss = float(metrics["loss"])  # one sync: the card runs the steps in order
    elapsed = time.perf_counter() - t0
    assert np.isfinite(loss)
    ips = B * ITERS / elapsed
    print(f"device={dev} batch={B} first={first_s:.1f}s steady={elapsed / ITERS * 1e3:.1f}ms/step",
          file=sys.stderr)
    result = {"metric": "train_step_images_per_sec", "value": round(ips, 1), "unit": "img/s",
              "vs_baseline": None}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

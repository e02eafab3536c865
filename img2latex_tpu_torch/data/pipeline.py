"""Host data pipeline: dataset parsing, static-shape batching, prefetch
(counterpart of ``img2latex_tpu/data/pipeline.py``).

* Every batch has the same shape - images ``(B, H, W, C)`` uint8 NHWC,
  formulas ``(B, max_seq_length)`` int32 - and a short last batch is padded
  to ``B`` with zero images and all-PAD formulas and carries ``n_valid``
  (``pipeline.py:267-345``): the masked loss and accuracy ignore the padded
  rows, and validation cuts them off before BLEU.
* Images are decoded in a thread pool (Pillow, imported inside the image
  load of :mod:`img2latex_tpu_torch.data.transforms`) with a background
  prefetcher.
* Batches stay uint8; they are normalized on the device by the step.

Not ported yet: the multi-host slice of each batch, the memory-mapped canvas
cache, ``load_in_memory`` and host-side augmentation.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from img2latex_tpu_torch.config import Config
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.data.transforms import load_image_u8

logger = logging.getLogger(__name__)


def read_formulas(path: str) -> List[str]:
    with open(path, encoding="utf-8", errors="replace") as f:
        return [line.rstrip("\n") for line in f]


def parse_split_file(path: str, n_formulas: int) -> List[Tuple[str, int]]:
    """Parse ``<image> <formula_idx>`` lines (or ``<idx> <image>``), skipping
    malformed and out-of-range entries with a logged count."""
    pairs: List[Tuple[str, int]] = []
    skipped = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                if line.strip():
                    skipped += 1
                continue
            name, idx_s = parts
            try:
                idx = int(idx_s)
            except ValueError:
                try:
                    idx = int(name)
                    name = idx_s
                except ValueError:
                    skipped += 1
                    continue
            if not 0 <= idx < n_formulas:
                skipped += 1
                continue
            pairs.append((name, idx))
    if skipped:
        logger.warning("Skipped %d malformed/out-of-range lines in %s", skipped, path)
    return pairs


class Im2LatexDataset:
    """Map-style dataset over an IM2LaTeX split (host side, uint8 output)."""

    def __init__(self, split_file: str, formulas: Sequence[str], img_dir: str,
                 tokenizer: LaTeXTokenizer, img_size: Tuple[int, int] = (64, 800),
                 channels: int = 1, pad_value: int = 255):
        self.samples = parse_split_file(split_file, len(formulas))
        self.formulas = formulas
        self.img_dir = img_dir
        self.tokenizer = tokenizer
        self.img_size = img_size
        self.channels = channels
        self.pad_value = pad_value

    def __len__(self) -> int:
        return len(self.samples)

    def image(self, i: int) -> np.ndarray:
        """The i-th canvas; a missing file gives a zero canvas, logged."""
        name, _ = self.samples[i]
        path = os.path.join(self.img_dir, name)
        if not os.path.exists(path) and not os.path.splitext(name)[1]:
            path = path + ".png"
        if not os.path.exists(path):
            logger.warning("Image not found: %s (zero canvas substituted)", path)
            return np.zeros((self.img_size[0], self.img_size[1], self.channels), dtype=np.uint8)
        return load_image_u8(path, self.img_size[0], self.img_size[1], self.channels, self.pad_value)

    def token_ids(self, i: int) -> np.ndarray:
        """``<START> formula <END>`` padded/truncated to max_seq_length."""
        _, fidx = self.samples[i]
        ids = self.tokenizer.encode(self.formulas[fidx], add_special_tokens=True)
        L = self.tokenizer.max_sequence_length
        out = np.full((L,), self.tokenizer.pad_token_id, dtype=np.int32)
        ids = ids[:L]
        out[: len(ids)] = ids
        return out

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.image(i), self.token_ids(i)


class BatchLoader:
    """Static-shape batch iterator with threaded decode and background prefetch."""

    def __init__(self, dataset: Im2LatexDataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_threads: int = 8, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def _make_batch(self, pool: ThreadPoolExecutor, indices: np.ndarray) -> Dict[str, np.ndarray]:
        B = self.batch_size
        h, w = self.dataset.img_size
        c = self.dataset.channels
        L = self.dataset.tokenizer.max_sequence_length
        images = np.zeros((B, h, w, c), dtype=np.uint8)
        # padded tail rows are all-PAD formulas: the masked loss ignores them
        formulas = np.full((B, L), self.dataset.tokenizer.pad_token_id, dtype=np.int32)
        for j, (img, ids) in enumerate(pool.map(self.dataset.__getitem__, indices.tolist())):
            images[j] = img
            formulas[j] = ids
        return {"images": images, "formulas": formulas, "n_valid": np.int32(len(indices))}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._order()
        n = len(order)
        B = self.batch_size
        starts = range(0, n - B + 1, B) if self.drop_last else range(0, n, B)
        chunks = [order[s : s + B] for s in starts]
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def bounded_put(item) -> bool:
            """Enqueue unless the consumer has gone away (stop set)."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            err: Optional[BaseException] = None
            with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                try:
                    for chunk in chunks:
                        if stop.is_set() or not bounded_put(self._make_batch(pool, chunk)):
                            break
                except BaseException as e:  # forwarded to the consumer
                    err = e
                finally:
                    bounded_put((sentinel, err))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if isinstance(item, tuple) and len(item) == 2 and item[0] is sentinel:
                    if item[1] is not None:
                        raise item[1]
                    break
                yield item
        finally:
            # an abandoned iterator: unblock and reap the producer and its pool
            stop.set()
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=30.0)


def create_data_loaders(cfg: Config, tokenizer: LaTeXTokenizer,
                        splits: Sequence[str] = ("train", "validate", "test")) -> Dict[str, BatchLoader]:
    """Loaders of the config's splits: train shuffled with the last short batch
    dropped, the others in order with it padded; the eval batch size is
    ``min(batch_size * eval_batch_size_multiplier, max_eval_batch_size)``."""
    h, w, c = cfg.image_shape
    data_dir = cfg.data.data_dir
    formulas = read_formulas(os.path.join(data_dir, cfg.data.formulas_file))
    img_dir = os.path.join(data_dir, cfg.data.img_dir)
    split_files = {"train": cfg.data.train_file, "validate": cfg.data.validate_file,
                   "test": cfg.data.test_file}
    eval_bs = min(cfg.data.batch_size * cfg.data.eval_batch_size_multiplier,
                  cfg.data.max_eval_batch_size)
    loaders: Dict[str, BatchLoader] = {}
    for split in splits:
        ds = Im2LatexDataset(os.path.join(data_dir, split_files[split]), formulas, img_dir,
                             tokenizer, img_size=(h, w), channels=c,
                             pad_value=cfg.preprocessing.pad_value)
        is_train = split == "train"
        loaders[split] = BatchLoader(ds, batch_size=cfg.data.batch_size if is_train else eval_bs,
                                     shuffle=is_train, drop_last=is_train, seed=cfg.training.seed,
                                     num_threads=max(cfg.data.num_workers, 4),
                                     prefetch=cfg.data.device_prefetch)
    return loaders

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
* ``canvas_cache_dir``: a split's prepared canvases persist in one
  memory-mapped ``.npy`` (``pipeline.py:146-205``), at the path
  :func:`canvas_cache_path` names with the JAX package's key, so that a
  cache either package built is read by the other.  It is built once where
  Pillow is and read anywhere with numpy alone (the card's machine has no
  Pillow).
* ``load_in_memory`` holds a split's canvases in host RAM, unless they
  would take more than half of the RAM available (``/proc/meminfo``, else
  ``os.sysconf``), which is logged.

Not ported yet: the multi-host slice of each batch and host-side
augmentation.
"""

from __future__ import annotations

import hashlib
import logging
import os
import queue
import threading
import time
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


def _image_path(img_dir: str, name: str) -> str:
    path = os.path.join(img_dir, name)
    if not os.path.exists(path) and not os.path.splitext(name)[1]:
        path = path + ".png"
    return path


def canvas_cache_path(cache_dir: str, samples: Sequence[Tuple[str, int]], img_dir: str,
                      img_size: Tuple[int, int], channels: int, pad_value: int) -> str:
    """The ``.npy`` path of a split's prepared canvases under ``cache_dir``:
    the JAX package's key (``pipeline.py:158-176``), a SHA-1 of every sample
    name with its file's size and mtime (or ``missing``), ``abspath(img_dir)``,
    the canvas geometry, the pad value and ``v2``."""
    h, w = img_size
    hsh = hashlib.sha1()
    for name, _ in samples:
        hsh.update(name.encode())
        try:
            st = os.stat(_image_path(img_dir, name))
            hsh.update(f"|{st.st_size}:{st.st_mtime_ns}\n".encode())
        except OSError:
            hsh.update(b"|missing\n")  # a missing file gives a zero canvas
    hsh.update(f"|{os.path.abspath(img_dir)}|{h}x{w}x{channels}|pad{pad_value}|v2".encode())
    return os.path.join(cache_dir, f"canvas_{hsh.hexdigest()[:16]}.npy")


def available_ram_bytes() -> Optional[int]:
    """``MemAvailable`` of ``/proc/meminfo``, else the available pages of
    ``os.sysconf``; None where neither is readable."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (AttributeError, ValueError, OSError):
        return None


class Im2LatexDataset:
    """Map-style dataset over an IM2LaTeX split (host side, uint8 output)."""

    def __init__(self, split_file: str, formulas: Sequence[str], img_dir: str,
                 tokenizer: LaTeXTokenizer, img_size: Tuple[int, int] = (64, 800),
                 channels: int = 1, pad_value: int = 255, load_in_memory: bool = False,
                 canvas_cache_dir: Optional[str] = None):
        self.samples = parse_split_file(split_file, len(formulas))
        self.formulas = formulas
        self.img_dir = img_dir
        self.tokenizer = tokenizer
        self.img_size = img_size
        self.channels = channels
        self.pad_value = pad_value
        self._cache: Optional[List[np.ndarray]] = None
        self._mmap: Optional[np.ndarray] = None
        if canvas_cache_dir:
            try:
                self._mmap = self._open_canvas_cache(canvas_cache_dir)
            except Exception:
                logger.warning("canvas cache unavailable at %s; falling back to per-image loads",
                               canvas_cache_dir, exc_info=True)
        if load_in_memory:
            est = len(self.samples) * img_size[0] * img_size[1] * channels
            avail = available_ram_bytes()
            if avail is not None and est > avail * 0.5:
                logger.warning("load_in_memory would use ~%.1f GB (>50%% of available %.1f GB); "
                               "falling back to lazy loading", est / 1e9, avail / 1e9)
            else:
                self._cache = [self.image(i) for i in range(len(self.samples))]

    def __len__(self) -> int:
        return len(self.samples)

    def _open_canvas_cache(self, cache_dir: str) -> np.ndarray:
        """mmap this split's canvases at :func:`canvas_cache_path`, building
        the file on a miss: a per-pid tmp file, an atomic ``os.replace`` (so
        that concurrent builds race benignly), and the tmp file unlinked
        when the build is aborted."""
        h, w = self.img_size
        path = canvas_cache_path(cache_dir, self.samples, self.img_dir, self.img_size, self.channels,
                                 self.pad_value)
        if not os.path.exists(path):
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            done = False
            try:
                arr = np.lib.format.open_memmap(tmp, mode="w+", dtype=np.uint8,
                                                shape=(len(self.samples), h, w, self.channels))
                t0 = time.perf_counter()
                for i in range(len(self.samples)):
                    arr[i] = self._load_image(i)
                arr.flush()
                del arr
                os.replace(tmp, path)
                done = True
                logger.info("canvas cache built: %s (%d canvases, %.0f MB, %.1f s)", path,
                            len(self.samples), len(self.samples) * h * w * self.channels / 1e6,
                            time.perf_counter() - t0)
            finally:
                if not done:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
        return np.load(path, mmap_mode="r")

    def image(self, i: int) -> np.ndarray:
        """The i-th canvas: from RAM, the canvas cache, or the image file."""
        if self._cache is not None:
            return self._cache[i]
        if self._mmap is not None:
            return np.asarray(self._mmap[i])
        return self._load_image(i)

    def _load_image(self, i: int) -> np.ndarray:
        """The i-th canvas read through Pillow; a missing file gives a zero canvas, logged."""
        name, _ = self.samples[i]
        path = _image_path(self.img_dir, name)
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
                             pad_value=cfg.preprocessing.pad_value,
                             load_in_memory=cfg.data.load_in_memory,
                             canvas_cache_dir=cfg.data.canvas_cache_dir)
        is_train = split == "train"
        loaders[split] = BatchLoader(ds, batch_size=cfg.data.batch_size if is_train else eval_bs,
                                     shuffle=is_train, drop_last=is_train, seed=cfg.training.seed,
                                     num_threads=max(cfg.data.num_workers, 4),
                                     prefetch=cfg.data.device_prefetch)
    return loaders

"""The port's host pipeline on the CPU: the canvas cache, ``load_in_memory``,
``decode_chunks``, the pipelined ``Predictor.predict_batch`` and the bench scripts.

* Canvas cache: the port's ``canvas_cache_path`` is the JAX dataset's path
  for the same corpus; a cache the JAX package built is read by the port
  without a rebuild, byte-equal to the port's own build; touching an image
  changes the key; an aborted build leaves no tmp file; ``load_in_memory``
  gives the same canvases (and skips over half the free RAM).
* ``decode_chunks`` with a fake ``run``: results in plan order, chunk i + 1
  prepped before chunk i is fetched, the ``stats`` keys and the
  ``first_calls`` rule.
* ``predict_batch(stats=...)``: the ids equal the JAX ``predict_batch``'s and
  those of the serial loop it replaced (greedy, beam, selective beam,
  sampling; the prep pool on and off), and ``stats`` is filled.
* The four ``bench_*_torch.py`` at shrunk shapes on the CPU: one JSON line
  each with its metric; their TPU-only arguments raise; no forbidden import.
"""

import ast
import importlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from img2latex_tpu.data.pipeline import Im2LatexDataset as JaxDataset
from img2latex_tpu.data.pipeline import read_formulas
from img2latex_tpu.data.synthetic import write_synthetic_corpus
from img2latex_tpu.data.tokenizer import LaTeXTokenizer as JaxTokenizer
from img2latex_tpu_torch.config import Config
from img2latex_tpu_torch.data import pipeline as pl
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.decoding.decode import decode_chunks, trim_host
from img2latex_tpu_torch.training import predictor as pm
from test_torch_predictor import _images, _pair
from test_torch_sampling import _jax_batch_seeds, _sampling_pair

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H, W = 16, 64


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    write_synthetic_corpus(root, n_train=4, n_val=3, n_test=7, seed=3)
    formulas = read_formulas(os.path.join(root, "im2latex_formulas.norm.lst"))
    jtok = JaxTokenizer(max_sequence_length=16)
    jtok.fit(formulas)
    tok = LaTeXTokenizer.from_config(jtok.to_config())
    return root, formulas, jtok, tok


def _split(root):
    return os.path.join(root, "im2latex_test_filter.lst")


def _jax_ds(corpus, cache_dir=None, **kw):
    root, formulas, jtok, _ = corpus
    return JaxDataset(_split(root), formulas, os.path.join(root, "img"), jtok, img_size=(H, W),
                      canvas_cache_dir=cache_dir, **kw)


def _port_ds(corpus, cache_dir=None, **kw):
    root, formulas, _, tok = corpus
    return pl.Im2LatexDataset(_split(root), formulas, os.path.join(root, "img"), tok, img_size=(H, W),
                              canvas_cache_dir=cache_dir, **kw)


def _canvases(ds):
    return np.stack([ds.image(i) for i in range(len(ds))])


def test_cache_path_is_the_jax_path(corpus, tmp_path):
    jds = _jax_ds(corpus, str(tmp_path))
    built = sorted(p.name for p in tmp_path.iterdir())
    assert len(built) == 1 and built[0].startswith("canvas_") and built[0].endswith(".npy")
    root = corpus[0]
    path = pl.canvas_cache_path(str(tmp_path), jds.samples, os.path.join(root, "img"), (H, W), 1, 255)
    assert path == str(tmp_path / built[0])


def test_jax_built_cache_is_read_without_a_rebuild(corpus, tmp_path, monkeypatch):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    ref = _canvases(_jax_ds(corpus, str(jax_dir)))
    port_own = _canvases(_port_ds(corpus, str(port_dir)))  # the port's own build
    (jax_file,), (port_file,) = list(jax_dir.iterdir()), list(port_dir.iterdir())
    assert jax_file.name == port_file.name
    assert jax_file.read_bytes() == port_file.read_bytes()
    mtime = jax_file.stat().st_mtime_ns

    def no_load(self, i):
        raise AssertionError("the port rebuilt a cache the JAX package had built")

    monkeypatch.setattr(pl.Im2LatexDataset, "_load_image", no_load)
    ds = _port_ds(corpus, str(jax_dir))
    assert ds._mmap is not None
    got = _canvases(ds)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, port_own)
    assert jax_file.stat().st_mtime_ns == mtime and len(list(jax_dir.iterdir())) == 1


def test_touching_an_image_changes_the_key(corpus, tmp_path):
    root = corpus[0]
    ds = _port_ds(corpus)
    img_dir = os.path.join(root, "img")
    before = pl.canvas_cache_path(str(tmp_path), ds.samples, img_dir, (H, W), 1, 255)
    name = ds.samples[2][0]
    st = os.stat(os.path.join(img_dir, name))
    os.utime(os.path.join(img_dir, name), ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    try:
        after = pl.canvas_cache_path(str(tmp_path), ds.samples, img_dir, (H, W), 1, 255)
        assert after != before
        assert pl.canvas_cache_path(str(tmp_path), ds.samples, img_dir, (H, W), 1, 254) != after
    finally:
        os.utime(os.path.join(img_dir, name), ns=(st.st_atime_ns, st.st_mtime_ns))
    assert pl.canvas_cache_path(str(tmp_path), ds.samples, img_dir, (H, W), 1, 255) == before


def test_aborted_build_leaves_no_tmp_file(corpus, tmp_path, monkeypatch):
    load = pl.Im2LatexDataset._load_image

    def fail_on_third(self, i):
        if i == 2:
            raise RuntimeError("build aborted")
        return load(self, i)

    monkeypatch.setattr(pl.Im2LatexDataset, "_load_image", fail_on_third)
    ds = _port_ds(corpus, str(tmp_path))  # logged, then per-image loads
    assert ds._mmap is None
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr(pl.Im2LatexDataset, "_load_image", load)
    np.testing.assert_array_equal(_canvases(ds), _canvases(_jax_ds(corpus)))


def test_load_in_memory_returns_the_same_canvases(corpus, tmp_path, monkeypatch):
    lazy = _canvases(_port_ds(corpus))
    held = _port_ds(corpus, load_in_memory=True)
    assert held._cache is not None and len(held._cache) == len(held)
    np.testing.assert_array_equal(_canvases(held), lazy)
    np.testing.assert_array_equal(_canvases(_port_ds(corpus, str(tmp_path), load_in_memory=True)), lazy)
    np.testing.assert_array_equal(lazy, _canvases(_jax_ds(corpus, load_in_memory=True)))
    assert pl.available_ram_bytes() > 0
    monkeypatch.setattr(pl, "available_ram_bytes", lambda: 1000)  # over half the free RAM: lazy
    assert _port_ds(corpus, load_in_memory=True)._cache is None


def test_create_data_loaders_passes_the_cache_through(corpus, tmp_path):
    root, _, _, tok = corpus
    cfg = Config()
    cfg.data.data_dir = root
    cfg.model.encoder.cnn.img_height, cfg.model.encoder.cnn.img_width = H, W
    cfg.data.canvas_cache_dir = str(tmp_path)
    cfg.data.load_in_memory = True
    ds = pl.create_data_loaders(cfg, tok, splits=("test",))["test"].dataset
    assert ds._mmap is not None and ds._cache is not None
    np.testing.assert_array_equal(_canvases(ds), _canvases(_jax_ds(corpus)))


# ---------------------------------------------------------------------------
# decode_chunks
# ---------------------------------------------------------------------------


class _Tokens:
    """A fake decode's result: its fetch (``np.asarray``) is logged."""

    def __init__(self, log, i, rows):
        self.log, self.i, self.rows = log, i, rows

    def __array__(self, dtype=None, copy=None):
        self.log.append(("fetch", self.i))
        return np.full((self.rows, 3), self.i, np.int32)


def _plan(log, keys, seeds):
    def make(i, n):
        def prep():
            log.append(("prep", i))
            return np.zeros((n, 2), np.uint8)

        def run(buf, seed):
            log.append(("run", i))
            seeds.append(seed)
            return _Tokens(log, i, buf.shape[0])

        return prep, run

    plan, start = [], 0
    for i, key in enumerate(keys):
        n = 2 + i % 2
        prep, run = make(i, n)
        plan.append((key, run, prep, range(start, start + n)))
        start += n
    return plan


def test_decode_chunks_keeps_plan_order_and_seeds():
    log, seeds = [], []
    out = decode_chunks(_plan(log, ["a"] * 5, seeds), seed=7)
    assert [list(idxs) for idxs, _ in out] == [[0, 1], [2, 3, 4], [5, 6], [7, 8, 9], [10, 11]]
    assert [int(t[0, 0]) for _, t in out] == [0, 1, 2, 3, 4]
    assert seeds == [pm.batch_seed(7, i) for i in range(5)]


def test_decode_chunks_preps_the_next_chunk_before_the_fetch():
    log = []
    decode_chunks(_plan(log, ["a"] * 4, []), seed=0)
    at = {e: n for n, e in enumerate(log)}
    for i in range(3):
        assert at[("run", i)] < at[("prep", i + 1)] < at[("fetch", i)]
    for i in range(1, 4):
        assert at[("fetch", i - 1)] > at[("run", i)]  # fetch i - 1 only after dispatching i
    assert log[-1] == ("fetch", 3)


def test_decode_chunks_stats_and_first_calls():
    stats = {}
    keys = ["a", "a", "b", "a", "b"]
    out = decode_chunks(_plan([], keys, []), seed=0, stats=stats)
    sizes = [len(idxs) for idxs, _ in out]
    assert set(stats) == {"prep_s", "dispatch_s", "fetch_s", "first_calls", "steady_images"}
    assert [f["exec"] for f in stats["first_calls"]] == ["a", "b"]
    assert [f["images"] for f in stats["first_calls"]] == [sizes[0], sizes[2]]
    assert all(f["seconds"] >= 0 for f in stats["first_calls"])
    assert stats["steady_images"] == sizes[1] + sizes[3] + sizes[4]
    assert min(stats["prep_s"], stats["dispatch_s"], stats["fetch_s"]) >= 0
    assert decode_chunks([], seed=0, stats={}) == []


# ---------------------------------------------------------------------------
# predict_batch through decode_chunks
# ---------------------------------------------------------------------------

KINDS = {"greedy": {}, "beam": dict(beam_size=3),
         "selective": dict(beam_size=3, selective_beam_frac=0.5), "sampling": dict(top_k=5)}
_REF = {}


@pytest.fixture(scope="module")
def pairs():
    return {"greedy": _pair(seed=5), "sampling": _sampling_pair("vector")}


def _serial(tpred, imgs, seed=0, **kw):
    """The serial loop ``predict_batch`` ran before the pipeline."""
    dcfg = tpred.decode_config(**kw)
    B, (h, w, c) = tpred.batch_size, tpred.cfg.image_shape
    out = []
    for i in range(0, len(imgs), B):
        chunk = imgs[i : i + B]
        buf = np.zeros((B, h, w, c), np.uint8)
        for j, img in enumerate(chunk):
            buf[j] = pm.prepare_image_u8(img, h, w, c, 255)
        toks = tpred.decode_canvases(buf, dcfg=dcfg, seed=pm.batch_seed(seed, i // B))[: len(chunk)]
        out += trim_host(toks, 2, 0, start_id=1)
    return out


@pytest.mark.parametrize("inputs", ["arrays", "paths"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_pipelined_ids_equal_jax_and_the_serial_loop(pairs, kind, inputs, monkeypatch, tmp_path):
    """Canvas-size arrays prep serially; PNG paths (read by Pillow) prep in the pool."""
    jpred, tpred = pairs["sampling" if kind == "sampling" else "greedy"]
    kw = KINDS[kind]
    if kind == "sampling":
        imgs = list(np.random.default_rng(12).integers(0, 256, size=(7, 16, 64, 1), dtype=np.uint8))
        seed = 21
        # the JAX Predictor's per-batch seeds, so that both draw the same stream
        jseeds = _jax_batch_seeds(seed, 2)
        monkeypatch.setattr(pm, "batch_seed", lambda s, i: jseeds[i])
    else:
        imgs, seed = _images(7, seed=40), 0
    if kind not in _REF:
        _REF[kind] = jpred.predict_batch(imgs, return_ids=True, seed=seed, **kw)
    ref = _REF[kind]
    if inputs == "paths":
        from PIL import Image

        paths = [str(tmp_path / f"{i}.png") for i in range(len(imgs))]
        for img, path in zip(imgs, paths):
            Image.fromarray(np.asarray(img).reshape(16, 64), mode="L").save(path)
        imgs = paths
    monkeypatch.setattr(pm.os, "cpu_count", lambda: 4)
    used = []
    prep_pool = tpred._prep_pool
    monkeypatch.setattr(tpred, "_prep_pool", lambda: used.append(1) or prep_pool())
    stats = {}
    got = tpred.predict_batch(imgs, return_ids=True, seed=seed, stats=stats, **kw)
    assert got == ref
    assert got == _serial(tpred, imgs, seed=seed, **kw)
    assert len(used) == (2 if inputs == "paths" else 0)  # the pool, once a chunk, only for Pillow's reads
    assert len({tuple(r) for r in ref}) > 1  # the rows differ


def test_needs_pillow():
    h, w = 16, 64
    assert not pm._needs_pillow(np.zeros((h, w), np.uint8), h, w)
    assert not pm._needs_pillow(np.zeros((h, w, 1), np.uint8), h, w)
    assert not pm._needs_pillow(torch.zeros(3, h, w), h, w)  # CHW at the canvas size
    assert pm._needs_pillow(np.zeros((h, w + 1, 1), np.uint8), h, w)
    assert pm._needs_pillow("a.png", h, w)


def test_predict_batch_fills_stats(pairs):
    _, tpred = pairs["greedy"]
    stats = {}
    imgs = _images(7, seed=41)
    texts = tpred.predict_batch(imgs, stats=stats)
    assert set(stats) == {"prep_s", "dispatch_s", "fetch_s", "first_calls", "steady_images", "post_s"}
    assert stats["first_calls"] == [{"exec": "(4, None)", "seconds": stats["first_calls"][0]["seconds"],
                                     "images": 4}]
    assert stats["steady_images"] == 3 and stats["post_s"] >= 0 and stats["fetch_s"] >= 0
    assert texts == tpred.predict_batch(imgs) and tpred.predict_batch([]) == []
    again = {}
    tpred.predict_batch(imgs, stats=again)  # a second call's first chunk is its own first call
    assert len(again["first_calls"]) == 1


def test_staging_buffer_on_the_cpu_is_a_new_zero_array(pairs):
    _, tpred = pairs["greedy"]
    a, b = tpred.staging_buffer((2, 16, 64, 1)), tpred.staging_buffer((2, 16, 64, 1))
    assert a.shape == (2, 16, 64, 1) and a.dtype == np.uint8 and not a.any() and a is not b
    canv = np.stack([img.reshape(16, 64, 1) for img in _images(4, seed=42)])
    tokens = tpred.dispatch_canvases(canv)
    assert isinstance(tokens, torch.Tensor) and tokens.dtype == torch.int32
    np.testing.assert_array_equal(tokens.numpy(), tpred.decode_canvases(torch.from_numpy(canv)))


# ---------------------------------------------------------------------------
# the bench scripts
# ---------------------------------------------------------------------------

BENCHES = {"bench_torch": (["3"], "greedy_decode_images_per_sec"),
           "bench_beam_torch": (["3", "2"], "beam2_decode_images_per_sec"),
           "bench_sampling_torch": (["3"], "topk_sampling_decode_images_per_sec"),
           "bench_train_torch": (["3"], "train_step_images_per_sec")}
TPU_ONLY = {"bench_torch": [["3", "xla"], ["3", "other"]],
            "bench_beam_torch": [["3", "2", "--scan"], ["3", "2", "8"]],
            "bench_sampling_torch": [["3", "scan"]],
            "bench_train_torch": [["3", "--augment"]]}


def _small(name, monkeypatch):
    mod = importlib.import_module(name)
    for attr, value in (("DEVICE", "cpu"), ("IMG_H", 16), ("IMG_W", 64), ("FILTERS", [4, 8, 8]),
                        ("EMBED", 16), ("HIDDEN", 16), ("VOCAB", 24), ("MAX_LEN", 6), ("SEQ", 6),
                        ("ITERS", 2)):
        if hasattr(mod, attr):
            monkeypatch.setattr(mod, attr, value)
    return mod


@pytest.mark.parametrize("name", list(BENCHES))
def test_bench_prints_one_json_line(name, monkeypatch, capsys):
    argv, metric = BENCHES[name]
    mod = _small(name, monkeypatch)
    mod.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == metric and line["value"] > 0 and line["unit"] == "img/s"
    assert line["vs_baseline"] is None


def test_bench_chain_variant(monkeypatch, capsys):
    mod = _small("bench_torch", monkeypatch)
    mod.main(["3", "chain"])
    assert json.loads(capsys.readouterr().out)["value"] > 0


@pytest.mark.parametrize("name,argv", [(n, a) for n, cases in TPU_ONLY.items() for a in cases])
def test_bench_rejects_tpu_only_arguments(name, argv, monkeypatch, capsys):
    mod = _small(name, monkeypatch)
    with pytest.raises(ValueError, match="bench_"):
        mod.main(argv)
    assert capsys.readouterr().out == ""


def test_bench_without_a_card_raises(monkeypatch):
    mod = importlib.import_module("bench_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["2"])


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "psutil", "matplotlib",
             "triton", "img2latex_tpu")


@pytest.mark.parametrize("path", sorted(ROOT.glob("bench_*_torch.py")) + [ROOT / "bench_torch.py"],
                         ids=lambda p: p.name)
def test_bench_imports_nothing_forbidden(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    assert any(n.startswith("img2latex_tpu_torch") for n in names)
    assert [n for n in names if any(n == f or n.startswith(f + ".") for f in FORBIDDEN)] == []


def test_port_and_bench_import_no_psutil():
    """psutil is absent on the card's machine (PIL and yaml: tests/test_torch_hygiene.py)."""
    paths = [ROOT / "chip_smoke.py", *ROOT.glob("bench_*torch.py"), *(ROOT / "img2latex_tpu_torch").rglob("*.py")]
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
                assert not any(m.split(".")[0] == "psutil" for m in mods), (path, mods)

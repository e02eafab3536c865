"""Aspect-ratio bucketing and the whole split in the port, against the JAX package on the CPU.

The same flax weights (every bias drawn, the head scaled so that memories
differ across canvases) go into the JAX ``Predictor`` and the port's, and
the same images through both, in float32:

* ``natural_size``, ``assign_bucket``, the stride and the margin (the CNN
  and ResNet-18 to 152) equal the JAX package's;
* the canvas at a bucket's width (``prepare_image_at_width``) is bit-equal
  to the JAX ``_prepare_image_at_width``: narrower and wider than the
  canvas, 1 and 3 channels, float, CHW and HW arrays, PIL images, files and
  a missing file; an array at the model height needs no Pillow;
* the bucketed memory equals the full canvas's exactly (the ResNet's within
  1e-6: its convolutions sum in another order at another width); bucketed
  ``predict_batch`` equals the JAX bucketed output and the port's fixed
  canvas, for vector and grid memory, the chain on and off, greedy and beam
  2; selective beam equals the JAX bucketed output and takes each row's
  greedy or beam decode; and a ResNet-18 whose margin (224 px) leaves a
  bucket narrower than its canvas;
* ``predict_split_bucketed(passes=3)`` equals the chunked bucketed output
  and the JAX one, with the JAX accounting; ``Predictor.dispatch_split``
  gives the per-batch decodes' tokens; an empty input gives ``[]``
  (the JAX package raises ``KeyError`` there);
* the bucketed seeds: the j-th batch over the buckets, narrowest first,
  draws with ``batch_seed(seed, j)`` in both bucketed paths;
* ``scripts/bench_buckets_torch.py --smoke`` prints its one JSON line, and
  raises without a card.
"""

import importlib
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from img2latex_tpu.config import Config as JaxConfig
from img2latex_tpu.data import transforms as jax_transforms
from img2latex_tpu.data.tokenizer import LaTeXTokenizer as JaxTokenizer
from img2latex_tpu.decoding.decode import DecodeConfig as JaxDecodeConfig
from img2latex_tpu.models.seq2seq import build_model as jax_build_model
from img2latex_tpu.training.predictor import Predictor as JaxPredictor
from img2latex_tpu_torch.bridge import load_flax_params
from img2latex_tpu_torch.config import config_from_dict
from img2latex_tpu_torch.data import transforms
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.models.seq2seq import build_model
from img2latex_tpu_torch.ops.preprocess import normalize_images
from img2latex_tpu_torch.training.predictor import Predictor, batch_seed, bucket_margin_px, bucket_stride
from test_torch_resnet import drawn

torch.set_num_threads(1)

H, W = 32, 256          # the CNN's canvas: filters [4, 8], stride 4, margin 16
BUCKETS = [64, 128, 192]
WIDTHS = [40, 90, 150, 230, 44, 200, 30]  # natural widths at height H: every bucket and the full canvas
HEAD_GAIN = 16.0
RES_W, RES_BUCKETS = 1024, [256, 512, 768]  # ResNet-18: stride 32, margin 224
RES_WIDTHS = [24, 200, 500, 900, 30]


def _draw(variables, seed):
    """Every bias drawn and the head scaled by HEAD_GAIN (module docstring)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = str(path[-1].key)
        if key == "bias" or key.startswith("b_"):
            return rng.normal(size=leaf.shape).astype(np.float32) * 0.1
        return leaf * HEAD_GAIN if "Dense_0" in (str(p.key) for p in path) else leaf

    return jax.tree_util.tree_map_with_path(draw, variables)


def _jax_cfg(memory="vector", resnet=False):
    cfg = JaxConfig()
    cfg.model.memory = memory
    cfg.model.embedding_dim = 32
    cfg.model.decoder.hidden_dim = 32
    cfg.model.decoder.lstm_layers = 2
    cfg.model.decoder.dropout = 0.0
    if resnet:
        cfg.model.name = "resnet_lstm"
        cfg.model.encoder.resnet.model_name = "resnet18"
        cfg.model.encoder.resnet.img_height, cfg.model.encoder.resnet.img_width = H, RES_W
    else:
        cfg.model.encoder.cnn.img_height, cfg.model.encoder.cnn.img_width = H, W
        cfg.model.encoder.cnn.conv_filters = [4, 8]
    cfg.data.max_seq_length = 16
    cfg.inference.max_length = 12
    cfg.hardware.compute_dtype = "float32"
    cfg.hardware.use_mesh = False
    cfg.hardware.use_pallas_decode = False
    return cfg


def _tokenizer():
    tok = JaxTokenizer(max_sequence_length=16)
    tok.default_init()
    return tok


def _jax_pair(memory, resnet=False, seed=1):
    """(JAX Predictor, its config, its variables, the tokenizer)."""
    cfg = _jax_cfg(memory, resnet)
    tok = _tokenizer()
    jmodel = jax_build_model(cfg, tok.vocab_size)
    h, w, c = cfg.image_shape
    v = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, h, w, c)), jnp.zeros((2, 5), jnp.int32)))
    if resnet:
        rng = np.random.default_rng(seed)
        v = {"params": drawn(v["params"], rng), "batch_stats": drawn(v["batch_stats"], rng)}
        head = v["params"]["encoder"]["Dense_0"]
        head["kernel"] = head["kernel"] * HEAD_GAIN
    else:
        v = _draw(v, seed)
    jpred = JaxPredictor(cfg, jmodel, v["params"], v.get("batch_stats", {}), tok, batch_size=4)
    return jpred, cfg, v, tok


def _port(cfg, variables, tok, chain=False, batch_size=4):
    tcfg = config_from_dict(cfg.to_dict())
    tcfg.hardware.pallas_chain = chain
    ttok = LaTeXTokenizer.from_config(tok.to_config())
    model = load_flax_params(build_model(tcfg, ttok.vocab_size, device="cpu"), variables)
    return Predictor(tcfg, model, ttok, batch_size=batch_size, device="cpu")


@pytest.fixture(scope="module", params=["vector", "grid"])
def pair(request):
    """(memory, JAX Predictor, the port's with the chain off, with the chain on, JAX outputs cache)."""
    jpred, cfg, v, tok = _jax_pair(request.param)
    return request.param, jpred, _port(cfg, v, tok), _port(cfg, v, tok, chain=True), {}


def _images(widths, h=H, seed=0):
    """Grayscale arrays (h, w) at the model height, random ink over their width."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w), dtype=np.uint8) for w in widths]


# ---------------------------------------------------------------------------
# routing and geometry
# ---------------------------------------------------------------------------


def _inputs(tmp_path):
    rng = np.random.default_rng(4)
    gray = _images([70], h=20)[0]
    rgb = rng.integers(0, 256, size=(24, 50, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(gray).save(path)
    return [gray, gray[:, :, None], rgb, np.transpose(rgb, (2, 0, 1)), gray.astype(np.float32) / 255.0,
            Image.fromarray(rgb), Image.fromarray(gray), path, str(tmp_path / "missing.png"),
            np.zeros((5,), np.uint8)]


def test_natural_size_and_assign_bucket_match_jax(tmp_path):
    for img in _inputs(tmp_path):
        assert transforms.natural_size(img) == jax_transforms.natural_size(img)
    for w in (8, 30, 47, 48, 49, 100, 180, 255, 400):
        img = np.zeros((16, w), np.uint8)
        for buckets, stride, margin in ((BUCKETS, 4, 16), ([63, 64, 999], 4, 16), ([240, 236], 4, 16),
                                        ([256, 512], 32, 224)):
            for h, full in ((32, 256), (64, 800)):
                got = transforms.assign_bucket(img, buckets, h, full, stride, margin)
                assert got == jax_transforms.assign_bucket(img, buckets, h, full, stride, margin)


@pytest.mark.parametrize("name", ["cnn", "cnn3", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152"])
def test_stride_and_margin_match_jax(name):
    cfg = _jax_cfg(resnet=name.startswith("resnet"))
    if name.startswith("resnet"):
        cfg.model.encoder.resnet.model_name = name
    elif name == "cnn3":
        cfg.model.encoder.cnn.conv_filters = [32, 64, 128]
    jpred = JaxPredictor(cfg, None, {}, {}, _tokenizer())
    tcfg = config_from_dict(cfg.to_dict())
    assert bucket_stride(tcfg) == jpred._bucket_stride()
    assert bucket_margin_px(tcfg) == jpred.bucket_margin_px()
    assert (bucket_stride(tcfg), bucket_margin_px(tcfg)) == {
        "cnn": (4, 16), "cnn3": (8, 32), "resnet50": (32, 224)}.get(name, (32, bucket_margin_px(tcfg)))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("canvas_w", [48, 64, 100])
def test_canvas_at_width_bit_equal_to_jax(tmp_path, monkeypatch, channels, canvas_w):
    cfg = _jax_cfg()
    cfg.model.encoder.cnn.img_height = 20
    cfg.model.encoder.cnn.channels = channels
    jpred = JaxPredictor(cfg, None, {}, {}, _tokenizer())
    rng = np.random.default_rng(channels * canvas_w)
    at_height = [_images([64], h=20)[0], rng.integers(0, 256, size=(20, 80, 3), dtype=np.uint8),
                 rng.integers(0, 256, size=(20, 30, 1), dtype=np.uint8),
                 rng.integers(0, 256, size=(3, 20, 90), dtype=np.uint8),
                 rng.uniform(-1, 1, size=(20, 40)).astype(np.float32)]
    others = _inputs(tmp_path)[:-1] + [rng.integers(0, 256, size=(20, 70, 4), dtype=np.uint8)]
    for img in at_height + others:
        ref = jpred._prepare_image_at_width(img, canvas_w)
        got = transforms.prepare_image_at_width(img, 20, canvas_w, channels)
        assert got.dtype == np.uint8 and got.shape == ref.shape == (20, canvas_w, channels)
        np.testing.assert_array_equal(got, ref)
    assert (transforms.prepare_image_at_width(str(tmp_path / "missing.png"), 20, canvas_w, channels) == 0).all()

    def no_pillow():
        raise AssertionError("Pillow reached on the numpy route")

    monkeypatch.setattr(transforms, "_pil", no_pillow)
    for img in at_height:  # arrays at the model height: numpy alone
        np.testing.assert_array_equal(transforms.prepare_image_at_width(img, 20, canvas_w, channels),
                                      jpred._prepare_image_at_width(img, canvas_w))


# ---------------------------------------------------------------------------
# the bucketed decode
# ---------------------------------------------------------------------------


def _memory(tpred, canvas, width=None):
    pre = tpred.cfg.preprocessing
    x = normalize_images(torch.from_numpy(canvas[None]), pre.normalization_mean, pre.normalization_std,
                         torch.float32)
    with torch.no_grad():
        return tpred.encode(x, width)


@pytest.mark.parametrize("chain", [False, True], ids=["conv", "chain"])
def test_bucketed_memory_equals_full_canvas(pair, chain):
    _, _, tplain, tchain, _ = pair
    tpred = tchain if chain else tplain
    margin = tpred.bucket_margin_px()
    for img in _images([40, 90, 150]):
        full = _memory(tpred, transforms.prepare_image_at_width(img, H, W, 1))
        bw = tpred._assign_bucket(img, BUCKETS)
        assert bw is not None
        bucketed = _memory(tpred, transforms.prepare_image_at_width(img, H, bw + margin, 1), bw)
        assert torch.equal(bucketed, full)


def _jax_ids(pair, key, **kw):
    """The JAX Predictor's ids, once per module for each setting."""
    _, jpred, _, _, cache = pair
    if key not in cache:
        cache[key] = jpred.predict_batch(_images(WIDTHS), return_ids=True, **kw)
    return cache[key]


@pytest.mark.parametrize("chain", [False, True], ids=["conv", "chain"])
@pytest.mark.parametrize("beam", [0, 2], ids=["greedy", "beam2"])
def test_bucketed_predict_equals_jax_and_fixed(pair, chain, beam):
    _, _, tplain, tchain, _ = pair
    tpred = tchain if chain else tplain
    imgs = _images(WIDTHS)
    assert len({tpred._assign_bucket(i, BUCKETS) for i in imgs}) == len(BUCKETS) + 1
    stats = {}
    got = tpred.predict_batch(imgs, return_ids=True, beam_size=beam, bucket_widths=BUCKETS, stats=stats)
    assert got == _jax_ids(pair, ("bucketed", beam), beam_size=beam, bucket_widths=BUCKETS)
    assert got == tpred.predict_batch(imgs, return_ids=True, beam_size=beam)
    assert len({tuple(r) for r in got}) > 1
    assert stats["bucket_assign_s"] > 0 and stats.get("steady_images", 0) == 0  # one chunk a bucket: first calls
    assert sorted(f["exec"] for f in stats["first_calls"]) == sorted(str((4, b)) for b in BUCKETS + [None])


def test_selective_beam_bucketed(pair):
    """Selective beam ranks a chunk's rows, so a bucketed run differs from a
    fixed-canvas one; the port's chunks are the JAX package's, so the
    outputs are equal, and each row is its greedy or its beam decode."""
    _, _, tpred, _, _ = pair
    imgs = _images(WIDTHS)
    kw = dict(return_ids=True, bucket_widths=BUCKETS)
    sel = tpred.predict_batch(imgs, beam_size=2, selective_beam_frac=0.5, **kw)
    assert sel == _jax_ids(pair, "selective", beam_size=2, selective_beam_frac=0.5, bucket_widths=BUCKETS)
    greedy = tpred.predict_batch(imgs, beam_size=0, **kw)
    beam = tpred.predict_batch(imgs, beam_size=2, **kw)
    assert all(s == g or s == b for s, g, b in zip(sel, greedy, beam))


def test_order_and_config_buckets(pair):
    """Interleaved buckets come back in input order; ``inference.bucket_widths``
    is the default of ``predict_batch``."""
    _, _, tpred, _, _ = pair
    imgs = _images([40, 200, 44, 204, 48, 208])
    fixed = tpred.predict_batch(imgs, return_ids=True)
    tpred.cfg.inference.bucket_widths = [64]
    try:
        stats = {}
        assert tpred.predict_batch(imgs, return_ids=True, stats=stats) == fixed
        assert "bucket_assign_s" in stats
        assert tpred.predict(imgs[0]) == tpred.predict_batch(imgs[:1], bucket_widths=[])[0]
    finally:
        tpred.cfg.inference.bucket_widths = None


@pytest.mark.parametrize("memory", ["vector", "grid"])
def test_resnet18_bucketed(memory):
    jpred, cfg, v, tok = _jax_pair(memory, resnet=True, seed=3)  # weights whose rows differ in both kinds
    tpred = _port(cfg, v, tok)
    assert tpred.bucket_margin_px() == jpred.bucket_margin_px() == 224
    imgs = [np.repeat(i[:, :, None], 3, axis=2) for i in _images(RES_WIDTHS, seed=2)]
    assert [tpred._assign_bucket(i, RES_BUCKETS) for i in imgs] == [256, 512, 768, None, 256]
    got = tpred.predict_batch(imgs, return_ids=True, bucket_widths=RES_BUCKETS)
    assert got == tpred.predict_batch(imgs, return_ids=True)
    assert got == jpred.predict_batch(imgs, return_ids=True, bucket_widths=RES_BUCKETS)
    assert len({tuple(r) for r in got}) > 1
    # the convolutions' float32 sums run in another order at another width
    # on the CPU (oneDNN): the memory agrees to a rounding step, not bit for bit
    canvas = transforms.prepare_image_at_width(imgs[0], H, 256 + 224, 3)
    full = _memory(tpred, transforms.prepare_image_at_width(imgs[0], H, RES_W, 3))
    err = (_memory(tpred, canvas, 256) - full).abs().max() / full.abs().max()
    assert err <= 1e-6


# ---------------------------------------------------------------------------
# the whole split by bucket
# ---------------------------------------------------------------------------


def _dcfg(tpred, **kw):
    return tpred.decode_config(**kw)


def test_split_bucketed_equals_chunked(pair):
    """Groups that are not contiguous, a padded last batch in every bucket
    and three passes (``tests/test_buckets.py:186-216``)."""
    _, jpred, tpred, _, _ = pair
    imgs = _images([40, 90, 44, 96, 48, 230])
    chunked = tpred.predict_batch(imgs, return_ids=True, bucket_widths=[64, 128], batch_size=2)
    stats = {}
    split = tpred.predict_split_bucketed(imgs, _dcfg(tpred), 2, [64, 128], passes=3, stats=stats)
    assert split == chunked
    tok = jpred.tokenizer
    jdcfg = JaxDecodeConfig(max_length=jpred.cfg.inference.max_length, start_id=tok.start_token_id,
                            end_id=tok.end_token_id, pad_id=tok.pad_token_id)
    assert split == jpred.predict_split_bucketed(imgs, jdcfg, 2, [64, 128], passes=3)
    assert len(stats["first_calls"]) == 3
    assert [f["exec"] for f in stats["first_calls"]] == ["bucket_split[64][2x2]", "bucket_split[128][1x2]",
                                                         "bucket_split[full][1x2]"]
    assert stats["steady_images"] == len(imgs) * 2
    assert stats["post_s"] > 0 and stats["cache_build_s"] > 0 and stats["setup_s"] > 0
    assert stats["dispatch_s"] > 0 and "fetch_s" in stats


@pytest.mark.parametrize("sampling", [False, True], ids=["greedy", "sampling"])
def test_dispatch_split_equals_per_batch(pair, sampling):
    """The whole split's tokens are the per-batch decodes', batch i with its seed."""
    _, _, tpred, _, _ = pair
    canv = np.stack([transforms.prepare_image_at_width(i, H, W, 1) for i in _images(WIDTHS[:6])])
    canv = canv.reshape(3, 2, H, W, 1)
    dcfg = _dcfg(tpred, top_k=3, temperature=1.5) if sampling else _dcfg(tpred)
    seeds = [batch_seed(5, i) for i in range(3)]
    got = tpred.dispatch_split(torch.from_numpy(canv), dcfg, seeds)
    assert tuple(got.shape) == (3, 2, dcfg.max_length)
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), tpred.decode_canvases(canv[i], dcfg=dcfg, seed=seeds[i]))


def test_split_bucketed_empty_input(pair):
    """The JAX package raises KeyError on an empty input list; the port returns []."""
    _, jpred, tpred, _, _ = pair
    stats = {}
    assert tpred.predict_split_bucketed([], _dcfg(tpred), 2, BUCKETS, passes=2, stats=stats) == []
    assert stats == {}
    tok = jpred.tokenizer
    jdcfg = JaxDecodeConfig(max_length=4, start_id=tok.start_token_id, end_id=tok.end_token_id,
                            pad_id=tok.pad_token_id)
    with pytest.raises(KeyError):
        jpred.predict_split_bucketed([], jdcfg, 2, BUCKETS)
    assert tpred.predict_batch([], return_ids=True, bucket_widths=BUCKETS) == []


def test_bucketed_sampling_seeds(pair):
    """The j-th batch over the buckets (narrowest first, the full canvas
    last) draws with ``batch_seed(seed, j)`` in both bucketed paths (the
    JAX package draws from ``fold_in`` keys: a deliberate difference)."""
    _, _, tpred, _, _ = pair
    imgs = _images([170, 40, 90, 44, 230])  # buckets 64: [1, 3], 128: [2], 192: [0], full: [4]
    kw = dict(top_k=3, temperature=1.5)
    dcfg = _dcfg(tpred, **kw)
    assert dcfg.sampling
    chunked = tpred.predict_batch(imgs, return_ids=True, bucket_widths=BUCKETS, batch_size=2, seed=7, **kw)
    assert chunked == tpred.predict_split_bucketed(imgs, dcfg, 2, BUCKETS, seed=7)
    margin = tpred.bucket_margin_px()
    canv = np.zeros((2, H, 192 + margin, 1), np.uint8)
    canv[0] = transforms.prepare_image_at_width(imgs[0], H, 192 + margin, 1)
    # batch j = 2: the 64 bucket's one batch (0), the 128 bucket's (1), then 192's
    toks = tpred.decode_canvases(canv, dcfg=dcfg, seed=batch_seed(7, 2), width=192)
    assert tpred._post_ids(toks[:1])[0] == chunked[0]
    other = tpred.predict_batch(imgs, return_ids=True, bucket_widths=BUCKETS, batch_size=2, seed=8, **kw)
    assert other != chunked


# ---------------------------------------------------------------------------
# scripts/bench_buckets_torch.py
# ---------------------------------------------------------------------------


def _bench_module():
    scripts = str(Path(__file__).resolve().parent.parent / "scripts")
    if scripts not in sys.path:
        sys.path.append(scripts)
    return importlib.import_module("bench_buckets_torch")


def test_bench_buckets_prints_one_json_line(monkeypatch, capsys):
    mod = _bench_module()
    monkeypatch.setattr(mod, "DEVICE", "cpu")
    result = mod.main(["24", "--smoke"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert result["metric"] == "bucketed_vs_fixed_speedup" and result["unit"] == "x"
    assert result["value"] > 0 and result["fixed_img_per_sec"] > 0 and result["bucketed_img_per_sec"] > 0
    # rows count the padding of partial batches; images count the population
    assert result["fixed_rows_per_sec"] >= result["fixed_img_per_sec"]
    assert result["bucketed_rows_per_sec"] >= result["bucketed_img_per_sec"]


def test_bench_buckets_without_a_card_raises(monkeypatch, capsys):
    mod = _bench_module()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["8", "--smoke"])
    assert capsys.readouterr().out == ""

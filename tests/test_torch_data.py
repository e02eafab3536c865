"""The port's copies of the config, tokenizer and canvas preparation against the JAX package's."""

import dataclasses

import numpy as np
import pytest

from img2latex_tpu.config import Config as JaxConfig
from img2latex_tpu.data.tokenizer import LaTeXTokenizer as JaxTokenizer
from img2latex_tpu.data.transforms import prepare_image_u8 as jax_prepare
from img2latex_tpu_torch.config import Config, config_from_dict, load_config
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.data.transforms import prepare_image_u8

FORMULAS = ["\\frac { a } { b } + c", "x ^ { 2 } + y ^ { 2 } = z ^ { 2 }", "\\sum _ { i } x _ i", "a + b"]


def _subset(ours, theirs):
    """``theirs`` cut to the keys of ``ours``, recursively."""
    if isinstance(ours, dict):
        return {k: _subset(v, theirs[k]) for k, v in ours.items()}
    return theirs


def test_config_from_jax_dict_keeps_shared_fields():
    jcfg = JaxConfig()
    jcfg.model.embedding_dim = 256
    jcfg.model.encoder.cnn.conv_filters = [8, 16]
    jcfg.inference.max_length = 99
    jcfg.hardware.compute_dtype = "float32"
    cfg = config_from_dict(jcfg.to_dict())
    for section in ("model", "inference", "preprocessing"):
        ours = dataclasses.asdict(getattr(cfg, section))
        theirs = dataclasses.asdict(getattr(jcfg, section))
        assert _subset(ours, theirs) == ours, section
    assert cfg.hardware.compute_dtype == "float32"
    assert cfg.image_shape == jcfg.image_shape
    assert Config().to_dict() == config_from_dict(Config().to_dict()).to_dict()


def test_config_strict_and_validation():
    with pytest.raises(ValueError):
        config_from_dict({"model": {"nope": 1}}, strict=True)
    with pytest.raises(ValueError):
        config_from_dict({"hardware": {"compute_dtype": "float16"}})
    assert load_config(None, {"inference.max_length": 7}).inference.max_length == 7


def test_tokenizer_matches_jax():
    jt, t = JaxTokenizer(max_sequence_length=12), LaTeXTokenizer(max_sequence_length=12)
    jt.fit(FORMULAS)
    t.fit(FORMULAS)
    assert t.token_to_id == jt.token_to_id
    for f in FORMULAS + ["unseen \\tokens"]:
        assert t.encode(f, add_special_tokens=True) == jt.encode(f, add_special_tokens=True)
    np.testing.assert_array_equal(t.encode_batch(FORMULAS, True), jt.encode_batch(FORMULAS, True))
    rows = [[1, 5, 6, 2, 0], [7, 999, 3, 8]]
    assert t.decode_rows(rows) == jt.decode_rows(rows)
    assert [t.decode(r) for r in rows] == [jt.decode(r) for r in rows]
    assert LaTeXTokenizer.from_config(jt.to_config()).token_to_id == jt.token_to_id


@pytest.mark.parametrize("kind", ["hw", "hwc", "chw", "float01", "float11", "rgb"])
def test_prepare_image_matches_jax(kind):
    rng = np.random.default_rng(0)
    g = rng.integers(0, 256, size=(16, 64), dtype=np.uint8)
    img = {
        "hw": g,
        "hwc": g[:, :, None],
        "chw": g[None],
        "float01": g.astype(np.float32) / 255.0,
        "float11": g.astype(np.float32) / 127.5 - 1.0,
        "rgb": rng.integers(0, 256, size=(16, 64, 3), dtype=np.uint8),
    }[kind]
    got = prepare_image_u8(img, 16, 64, 1)
    assert got.dtype == np.uint8 and got.shape == (16, 64, 1)
    np.testing.assert_array_equal(got, jax_prepare(img, 16, 64, 1))


def test_prepare_off_size_image_resizes_like_jax():
    img = np.random.default_rng(1).integers(0, 256, size=(20, 40), dtype=np.uint8)
    np.testing.assert_array_equal(prepare_image_u8(img, 16, 64, 1), jax_prepare(img, 16, 64, 1))

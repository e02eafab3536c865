"""The port's ``evaluate_checkpoint`` against the JAX package's, on the CPU in float32.

A small flax model of each memory kind (drawn biases, a scaled head) is
saved as the JAX trainer saves it and converted for the port
(``convert_flax_checkpoint``, as in ``tests/test_torch_convert.py``).  A
synthetic corpus's test split of 11 images, at batch 4, ends in a padded
batch.  Both packages evaluate the split: greedy, beam 2, and with
``data.device_cache`` (both sides with ``inference.whole_split=False``, the
per-batch cached loop); the whole split held on the device (``passes`` 1 and
3); and by aspect-ratio bucket, streaming and with each bucket held as a
whole split, on a model of a 128-px canvas whose buckets the corpus's
images fill.  The ``predictions.json`` rows must be equal string for
string, ``num_images`` equal, BLEU, Levenshtein and token accuracy within
1e-12, and the result keys the same (``whole_split`` and ``decode_passes``
equal where they are).  Also: the port's cached run equals its streaming
run; a split over the budget streams; ``max_batches`` caps the run; a
caller's predictor keeps its config while ``config_overrides`` apply to the
evaluation.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img2latex_tpu.data.synthetic import write_synthetic_corpus
from img2latex_tpu.data.tokenizer import LaTeXTokenizer as JaxTokenizer
from img2latex_tpu.models.seq2seq import build_model as jax_build_model
from img2latex_tpu.utils.checkpoint import save_checkpoint as jax_save
from img2latex_tpu.training.evaluator import evaluate_checkpoint as jax_evaluate
from img2latex_tpu.utils.checkpoint import restore_checkpoint as jax_restore
from img2latex_tpu_torch.training.evaluator import evaluate_checkpoint
from img2latex_tpu_torch.training.predictor import Predictor
from img2latex_tpu_torch.utils.checkpoint import convert_flax_checkpoint
from test_torch_conv_chain import _jax_cfg
from test_torch_convert import _write_jax_checkpoint

torch.set_num_threads(1)

BATCH = 4
N_TEST = 11  # not a multiple of BATCH: the last batch is padded
TOL = 1e-12
MODES = {"greedy": ({}, {}, {}),
         "beam": (dict(beam_size=2), {}, {}),
         "device_cache": ({}, {"data.device_cache": True, "inference.whole_split": False},
                          {"data.device_cache": True, "inference.whole_split": False})}
BUCKETS = [48, 64, 88]  # of the 128-px canvas: stride 8, margin 32
WIDE_W = 128
WIDE_GAIN = 16.0  # the head's scale: the corpus's mostly white canvases give memories that differ


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_synthetic_corpus(str(tmp_path_factory.mktemp("evalcorpus")), n_train=2, n_val=2,
                                  n_test=N_TEST, seed=7)


@pytest.fixture(scope="module", params=["vector", "grid"])
def ckpt(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"eval_{request.param}")
    jax_dir, port_dir = root / "jax", root / "port"
    _write_jax_checkpoint(jax_dir, request.param, seed=11)
    state, meta = jax_restore(jax_dir)
    state = jax.device_get(state)
    convert_flax_checkpoint(state["params"], meta, port_dir, step=int(meta["step"]))
    return request.param, str(jax_dir), str(port_dir)


@pytest.fixture(scope="module", params=["vector", "grid"])
def wide_ckpt(request, tmp_path_factory):
    """A JAX checkpoint of ``_jax_cfg``'s model on a WIDE_W-px canvas (every
    bias drawn, the head scaled by WIDE_GAIN) and its conversion for the port."""
    memory = request.param
    root = tmp_path_factory.mktemp(f"wide_{memory}")
    cfg = _jax_cfg(memory)
    cfg.model.encoder.cnn.img_width = WIDE_W
    cfg.hardware.pallas_chain = False
    tok = JaxTokenizer(max_sequence_length=cfg.data.max_seq_length)
    tok.default_init()
    jmodel = jax_build_model(cfg, tok.vocab_size)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(3), jnp.zeros((2, 16, WIDE_W, 1)),
                                           jnp.zeros((2, 5), jnp.int32)))
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        if str(path[-1].key) == "bias" or "b_" in str(path[-1].key):
            return rng.normal(size=leaf.shape).astype(np.float32) * 0.1
        return leaf * WIDE_GAIN if "Dense_0" in (str(p.key) for p in path) else leaf

    variables = jax.tree_util.tree_map_with_path(draw, variables)
    meta = {"epoch": 0, "step": 1, "best_val_loss": 1.5, "config": cfg.to_dict(),
            "tokenizer_config": tok.to_config(), "metrics": {}}
    jax_save(root / "jax", {"params": variables["params"], "step": jnp.asarray(1)}, meta, step=1, is_best=True)
    state, meta = jax_restore(root / "jax")
    convert_flax_checkpoint(jax.device_get(state)["params"], meta, root / "port", step=1)
    return memory, str(root / "jax"), str(root / "port")


def _rows(path):
    return json.loads((path / "predictions.json").read_text())


def _check_equal(got, ref, tmp_path):
    """The two results and their predictions.json files, as the module docstring says."""
    assert set(got) == set(ref)
    assert got["num_images"] == ref["num_images"] == N_TEST
    for key in ("bleu", "levenshtein", "token_accuracy"):
        assert abs(got[key] - ref[key]) <= TOL, key
    for key in ("decode", "bucketed", "whole_split", "decode_passes"):
        assert got.get(key) == ref.get(key), key
    rows_ref, rows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert rows["predictions"] == rows_ref["predictions"]
    assert len({r["prediction"] for r in rows["predictions"]}) > 1  # the decodes differ across images
    assert set(rows["metrics"]) == set(rows_ref["metrics"])
    assert rows["predictions"][0]["image"].endswith(".png")


@pytest.mark.parametrize("mode", list(MODES))
def test_evaluate_equals_jax(ckpt, corpus, mode, tmp_path):
    _, jax_dir, port_dir = ckpt
    kw, jax_over, port_over = MODES[mode]
    ref = jax_evaluate(jax_dir, data_dir=corpus, batch_size=BATCH, output_dir=str(tmp_path / "jax"),
                       config_overrides=jax_over or None, **kw)
    got = evaluate_checkpoint(port_dir, data_dir=corpus, batch_size=BATCH, output_dir=str(tmp_path / "port"),
                              config_overrides=port_over or None, device="cpu", **kw)
    _check_equal(got, ref, tmp_path)
    assert (got["cache_build_seconds"] > 0) == (ref["cache_build_seconds"] > 0) == (mode == "device_cache")
    assert "whole_split" not in got


def test_device_cache_equals_streaming(ckpt, corpus, tmp_path):
    _, _, port_dir = ckpt
    pred = Predictor.from_checkpoint(port_dir, device="cpu")
    plain = evaluate_checkpoint(None, data_dir=corpus, batch_size=BATCH, predictor=pred,
                                output_dir=str(tmp_path / "plain"))
    cached = evaluate_checkpoint(None, data_dir=corpus, batch_size=BATCH, predictor=pred,
                                 config_overrides={"data.device_cache": True, "inference.whole_split": False},
                                 output_dir=str(tmp_path / "cached"))
    assert plain["cache_build_seconds"] == 0.0 and cached["cache_build_seconds"] > 0.0
    assert _rows(tmp_path / "plain")["predictions"] == _rows(tmp_path / "cached")["predictions"]
    for key in ("num_images", "bleu", "levenshtein", "token_accuracy", "steady_images"):
        assert cached[key] == plain[key], key
    assert cached["steady_images"] == N_TEST - BATCH  # the first batch is the first call
    assert len(cached["decode"]) == 7 and not cached["bucketed"]


def test_split_over_the_budget_streams(ckpt, corpus):
    _, _, port_dir = ckpt
    over = evaluate_checkpoint(port_dir, data_dir=corpus, batch_size=BATCH, device="cpu",
                               config_overrides={"data.device_cache": True,
                                                 "data.device_cache_budget_gb": 1e-9})
    assert over["cache_build_seconds"] == 0.0 and over["num_images"] == N_TEST


@pytest.mark.parametrize("cache", [False, True])
def test_max_batches_caps_the_run(ckpt, corpus, cache, tmp_path):
    _, _, port_dir = ckpt
    out = evaluate_checkpoint(port_dir, data_dir=corpus, batch_size=BATCH, max_batches=2, device="cpu",
                              output_dir=str(tmp_path), config_overrides={"data.device_cache": cache})
    assert out["num_images"] == 2 * BATCH
    assert len(_rows(tmp_path)["predictions"]) == 2 * BATCH


def test_callers_predictor_keeps_its_config(ckpt, corpus):
    _, _, port_dir = ckpt
    pred = Predictor.from_checkpoint(port_dir, batch_size=3, device="cpu")
    before = pred.cfg.to_dict()
    out = evaluate_checkpoint(None, data_dir=corpus, batch_size=BATCH, predictor=pred,
                              config_overrides={"inference.max_length": 5, "data.device_cache": True})
    assert pred.cfg.to_dict() == before and pred.batch_size == 3
    assert out["decode"]["max_length"] == 5 and out["cache_build_seconds"] > 0
    assert pred.cfg.inference.max_length != 5 and not pred.cfg.data.device_cache


def test_config_overrides_load_with_the_checkpoint(ckpt, corpus):
    _, _, port_dir = ckpt
    out = evaluate_checkpoint(port_dir, data_dir=corpus, batch_size=BATCH, device="cpu",
                              config_overrides={"inference.max_length": 4})
    assert out["decode"]["max_length"] == 4 and out["num_images"] == N_TEST


@pytest.mark.parametrize("passes", [1, 3])
def test_whole_split_equals_jax(ckpt, corpus, passes, tmp_path):
    """data.device_cache with inference.whole_split on (the default): the
    split decoded as a whole, ``passes`` times, as the JAX package does it."""
    _, jax_dir, port_dir = ckpt
    over = {"data.device_cache": True}
    ref = jax_evaluate(jax_dir, data_dir=corpus, batch_size=BATCH, output_dir=str(tmp_path / "jax"),
                       config_overrides=over, passes=passes)
    got = evaluate_checkpoint(port_dir, data_dir=corpus, batch_size=BATCH, output_dir=str(tmp_path / "port"),
                              config_overrides=over, passes=passes, device="cpu")
    _check_equal(got, ref, tmp_path)
    assert got["whole_split"] is True and got["decode_passes"] == passes and got["cache_build_seconds"] > 0
    assert got["steady_images"] == ref["steady_images"] == (passes - 1) * N_TEST
    assert got["images_per_second_includes_compile"] == ref["images_per_second_includes_compile"] == (passes == 1)
    assert got["compile_and_first_batch_seconds"] > 0


@pytest.mark.parametrize("resident", [False, True], ids=["streaming", "resident"])
def test_bucketed_equals_jax(wide_ckpt, corpus, resident, tmp_path):
    """bucket_widths: read from the image files and decoded by bucket,
    streaming, or with each bucket held as a whole split (3 passes)."""
    _, jax_dir, port_dir = wide_ckpt
    over = {"data.device_cache": resident}
    passes = 3 if resident else 1
    ref = jax_evaluate(jax_dir, data_dir=corpus, batch_size=BATCH, output_dir=str(tmp_path / "jax"),
                       config_overrides=over, bucket_widths=BUCKETS, passes=passes)
    got = evaluate_checkpoint(port_dir, data_dir=corpus, batch_size=BATCH, output_dir=str(tmp_path / "port"),
                              config_overrides=over, bucket_widths=BUCKETS, passes=passes, device="cpu")
    _check_equal(got, ref, tmp_path)
    assert got["bucketed"] is True and got.get("whole_split", False) == resident
    assert got["steady_images"] == ref["steady_images"]
    # the corpus's images fill more than one bucket, and the fixed canvas decodes them alike
    pred = Predictor.from_checkpoint(port_dir, device="cpu")
    with open(f"{corpus}/im2latex_test_filter.lst") as f:
        paths = [f"{corpus}/img/{line.split()[0]}" for line in f if line.strip()]
    assert len({pred._assign_bucket(p, BUCKETS) for p in paths}) > 1
    evaluate_checkpoint(None, data_dir=corpus, batch_size=BATCH, predictor=pred, output_dir=str(tmp_path / "fixed"))
    assert _rows(tmp_path / "fixed")["predictions"] == _rows(tmp_path / "port")["predictions"]

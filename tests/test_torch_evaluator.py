"""The port's ``evaluate_checkpoint`` against the JAX package's, on the CPU in float32.

A small flax model of each memory kind (drawn biases, a scaled head) is
saved as the JAX trainer saves it and converted for the port
(``convert_flax_checkpoint``, as in ``tests/test_torch_convert.py``).  A
synthetic corpus's test split of 11 images, at batch 4, ends in a padded
batch.  Both packages evaluate the split: greedy, beam 2, and with
``data.device_cache`` (the JAX side with ``inference.whole_split=False``, its
per-batch cached loop).  The ``predictions.json`` rows must be equal string
for string, ``num_images`` equal, BLEU, Levenshtein and token accuracy within
1e-12, and the result keys the same.  Also: the port's cached run equals its
streaming run; a split over the budget streams; ``max_batches`` caps the run;
a caller's predictor keeps its config while ``config_overrides`` apply to the
evaluation; ``bucket_widths`` and ``passes=2`` raise.
"""

import json

import jax
import pytest
import torch

from img2latex_tpu.data.synthetic import write_synthetic_corpus
from img2latex_tpu.training.evaluator import evaluate_checkpoint as jax_evaluate
from img2latex_tpu.utils.checkpoint import restore_checkpoint as jax_restore
from img2latex_tpu_torch.training.evaluator import evaluate_checkpoint
from img2latex_tpu_torch.training.predictor import Predictor
from img2latex_tpu_torch.utils.checkpoint import convert_flax_checkpoint
from test_torch_convert import _write_jax_checkpoint

torch.set_num_threads(1)

BATCH = 4
N_TEST = 11  # not a multiple of BATCH: the last batch is padded
TOL = 1e-12
MODES = {"greedy": ({}, {}, {}),
         "beam": (dict(beam_size=2), {}, {}),
         "device_cache": ({}, {"data.device_cache": True, "inference.whole_split": False},
                          {"data.device_cache": True})}


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


def _rows(path):
    return json.loads((path / "predictions.json").read_text())


@pytest.mark.parametrize("mode", list(MODES))
def test_evaluate_equals_jax(ckpt, corpus, mode, tmp_path):
    _, jax_dir, port_dir = ckpt
    kw, jax_over, port_over = MODES[mode]
    ref = jax_evaluate(jax_dir, data_dir=corpus, batch_size=BATCH, output_dir=str(tmp_path / "jax"),
                       config_overrides=jax_over or None, **kw)
    got = evaluate_checkpoint(port_dir, data_dir=corpus, batch_size=BATCH, output_dir=str(tmp_path / "port"),
                              config_overrides=port_over or None, device="cpu", **kw)
    assert set(got) == set(ref)
    assert got["num_images"] == ref["num_images"] == N_TEST
    for key in ("bleu", "levenshtein", "token_accuracy"):
        assert abs(got[key] - ref[key]) <= TOL, key
    assert got["decode"] == ref["decode"]
    assert (got["cache_build_seconds"] > 0) == (ref["cache_build_seconds"] > 0) == (mode == "device_cache")
    rows_ref, rows = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert rows["predictions"] == rows_ref["predictions"]
    assert len({r["prediction"] for r in rows["predictions"]}) > 1  # the decodes differ across images
    assert set(rows["metrics"]) == set(rows_ref["metrics"])
    assert rows["predictions"][0]["image"].endswith(".png")


def test_device_cache_equals_streaming(ckpt, corpus, tmp_path):
    _, _, port_dir = ckpt
    pred = Predictor.from_checkpoint(port_dir, device="cpu")
    plain = evaluate_checkpoint(None, data_dir=corpus, batch_size=BATCH, predictor=pred,
                                output_dir=str(tmp_path / "plain"))
    cached = evaluate_checkpoint(None, data_dir=corpus, batch_size=BATCH, predictor=pred,
                                 config_overrides={"data.device_cache": True}, output_dir=str(tmp_path / "cached"))
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


def test_not_ported_options_raise(ckpt, corpus):
    _, _, port_dir = ckpt
    with pytest.raises(NotImplementedError, match="queue 4"):
        evaluate_checkpoint(port_dir, data_dir=corpus, bucket_widths=[32], device="cpu")
    with pytest.raises(NotImplementedError, match="queue 4"):
        evaluate_checkpoint(port_dir, data_dir=corpus, passes=2, device="cpu")

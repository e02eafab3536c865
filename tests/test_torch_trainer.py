"""The port's trainer, checkpoints, data pipeline and metrics, on the CPU.

* ``ops/metrics.py`` equals the JAX package's ``calculate_metrics`` (and its
  parts) on random id lists;
* ``data/synthetic.synthetic_batch`` equals the JAX package's for the same
  seed (the port fits canvases with a numpy copy of Pillow's Lanczos resize);
* ``data/pipeline`` batches from a PNG corpus equal the JAX package's, the
  padded tail included;
* ``Trainer`` trains two epochs on ``device="cpu"``, writes checkpoints,
  resumes the step, the learning rate, the best loss and the early-stop
  counters, and ``Predictor.from_checkpoint`` decodes the ids of the
  in-memory model.
"""

import json

import numpy as np
import pytest
import torch

from img2latex_tpu.config import Config as JaxConfig
from img2latex_tpu.data.pipeline import create_data_loaders as jax_loaders
from img2latex_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from img2latex_tpu.data.synthetic import write_synthetic_corpus
from img2latex_tpu.data.tokenizer import LaTeXTokenizer as JaxTokenizer
from img2latex_tpu.ops import metrics as jax_metrics
from img2latex_tpu_torch.config import config_from_dict
from img2latex_tpu_torch.data.pipeline import create_data_loaders
from img2latex_tpu_torch.data.synthetic import synthetic_batch
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.ops import metrics
from img2latex_tpu_torch.training.optim import get_learning_rate, set_learning_rate
from img2latex_tpu_torch.training.predictor import Predictor
from img2latex_tpu_torch.training.trainer import Trainer, _trim_batch_ids
from img2latex_tpu_torch.utils import checkpoint as ckpt_lib
from img2latex_tpu_torch.utils.paths import PathManager

torch.set_num_threads(1)

H_IMG, W_IMG, V, L = 16, 64, 40, 12


# ---------------------------------------------------------------------------
# Metrics and synthetic data: copies of the JAX package's
# ---------------------------------------------------------------------------


def _id_lists(rng, n):
    return [list(rng.integers(0, 12, size=rng.integers(0, 15))) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    preds, tgts = _id_lists(rng, 40), _id_lists(rng, 40)
    tgts[3] = list(preds[3])  # an exact match
    for n in (1, 2, 4):
        got, ref = metrics.calculate_metrics(preds, tgts, n), jax_metrics.calculate_metrics(preds, tgts, n)
        assert got["batch_size"] == ref["batch_size"]
        np.testing.assert_allclose([got["bleu"], got["levenshtein"]], [ref["bleu"], ref["levenshtein"]],
                                   rtol=1e-12, atol=0)
    for p, t in zip(preds, tgts):
        assert metrics.levenshtein_raw(p, t) == jax_metrics.levenshtein_raw(p, t)
        assert metrics.bleu_n_score(p, t) == pytest.approx(jax_metrics.bleu_n_score(p, t), rel=1e-12, abs=0)
    assert metrics.token_list_accuracy(preds, tgts, 0) == jax_metrics.token_list_accuracy(preds, tgts, 0)
    assert metrics.calculate_metrics([], []) == jax_metrics.calculate_metrics([], [])


@pytest.mark.parametrize("shape", [(16, 64, 1), (64, 800, 1), (32, 200, 3), (20, 50, 1)])
def test_synthetic_batch_equals_jax(shape):
    for seed in (0, 5):
        imgs, forms = synthetic_batch(6, shape, 14, V, seed=seed)
        ref_imgs, ref_forms = jax_synthetic_batch(6, shape, 14, V, seed=seed)
        np.testing.assert_array_equal(imgs, ref_imgs)
        np.testing.assert_array_equal(forms, ref_forms)


# ---------------------------------------------------------------------------
# The data pipeline against the JAX package's, on a PNG corpus
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    write_synthetic_corpus(root, n_train=11, n_val=5, n_test=3, seed=4)
    jcfg = JaxConfig()
    jcfg.data.data_dir = root
    jcfg.data.batch_size = 4
    jcfg.data.max_seq_length = L
    jcfg.model.encoder.cnn.img_height, jcfg.model.encoder.cnn.img_width = H_IMG, W_IMG
    jtok = JaxTokenizer(max_sequence_length=L)
    jtok.fit_on_formulas_file(f"{root}/im2latex_formulas.norm.lst")
    tok = LaTeXTokenizer(max_sequence_length=L)
    tok.fit_on_formulas_file(f"{root}/im2latex_formulas.norm.lst")
    return root, jcfg, jtok, tok


def test_batches_equal_jax(corpus):
    root, jcfg, jtok, tok = corpus
    assert tok.to_config() == jtok.to_config()
    ref = jax_loaders(jcfg, jtok)
    got = create_data_loaders(config_from_dict(jcfg.to_dict()), tok)
    for split in ("train", "validate", "test"):
        ref[split].set_epoch(1)
        got[split].set_epoch(1)
        rb, gb = list(ref[split]), list(got[split])
        assert len(rb) == len(gb) == len(got[split]) > 0
        for r, g in zip(rb, gb):
            np.testing.assert_array_equal(g["images"], r["images"])
            np.testing.assert_array_equal(g["formulas"], r["formulas"])
            assert int(g["n_valid"]) == int(r["n_valid"])
    last = list(got["validate"])[-1]  # 5 samples in batches of 8: a padded tail
    assert int(last["n_valid"]) == 5 and (last["formulas"][5:] == tok.pad_token_id).all()
    assert not last["images"][5:].any()


# ---------------------------------------------------------------------------
# Trainer, checkpoints, resume, Predictor.from_checkpoint
# ---------------------------------------------------------------------------


def _config():
    jcfg = JaxConfig()
    jcfg.model.embedding_dim = jcfg.model.decoder.hidden_dim = 16
    jcfg.model.encoder.cnn.img_height, jcfg.model.encoder.cnn.img_width = H_IMG, W_IMG
    jcfg.model.encoder.cnn.conv_filters = [4, 8, 8]
    jcfg.data.max_seq_length = jcfg.inference.max_length = L
    jcfg.data.batch_size = 6
    jcfg.data.log_frequency = 2
    jcfg.hardware.compute_dtype = "float32"
    jcfg.training.epochs = 2
    jcfg.training.learning_rate = 3e-3
    jcfg.training.lr_plateau_patience = 0
    jcfg.evaluation.bleu_batches = 1
    return config_from_dict(jcfg.to_dict())


def _tokenizer():
    tok = LaTeXTokenizer(max_sequence_length=L)
    tok.fit([" ".join(f"\\t{i}" for i in range(V - 4))])
    assert tok.vocab_size == V
    return tok


def _loaders(cfg):
    batches = []
    for s in range(3):
        images, formulas = synthetic_batch(cfg.data.batch_size, cfg.image_shape, L, V, seed=s)
        batches.append({"images": images, "formulas": formulas, "n_valid": np.int32(len(images))})
    return {"train": batches, "validate": batches[:1]}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cfg, tok = _config(), _tokenizer()
    root = tmp_path_factory.mktemp("exp")
    trainer = Trainer(cfg, tok, _loaders(cfg), paths=PathManager(str(root)), device="cpu")
    before = trainer.eval_step(trainer.state, _loaders(cfg)["validate"][0])["loss"].item()
    result = trainer.train()
    return cfg, tok, trainer, result, before, root


def test_trainer_runs_two_epochs(trained):
    cfg, _, trainer, result, before, _ = trained
    hist = result["history"]
    assert result["epochs_run"] == 2 and sorted(hist) == [0, 1]
    assert trainer.state.step == 6
    assert hist[1]["val_loss"] < before
    assert hist[1]["train_loss"] < hist[0]["train_loss"]
    for key in ("train_accuracy", "train_images_per_sec", "val_accuracy", "val_bleu", "val_levenshtein",
                "learning_rate"):
        assert np.isfinite(hist[1][key])
    assert result["best_val_loss"] == min(h["val_loss"] for h in hist.values())


def test_checkpoint_layout(trained):
    _, tok, trainer, _, _, _ = trained
    step_dir = trainer.ckpt_dir / f"step_{trainer.state.step}"
    meta = json.loads((step_dir / "meta.json").read_text())
    assert {"epoch", "step", "best_val_loss", "config", "tokenizer_config", "metrics", "scheduler",
            "early_stopping"} <= set(meta)
    assert meta["step"] == trainer.state.step and meta["tokenizer_config"] == tok.to_config()
    assert ckpt_lib.latest_step(trainer.ckpt_dir) == trainer.state.step
    assert ckpt_lib.best_step(trainer.ckpt_dir) in (3, 6)
    assert ckpt_lib.resolve_checkpoint_path(step_dir) == (trainer.ckpt_dir, trainer.state.step)


def test_resume_restores_the_loop_state(trained):
    cfg, tok, trainer, _, _, root = trained
    # move the loop state off its defaults, then checkpoint it
    trainer.scheduler.step(float("inf"))  # patience 0: the LR halves
    set_learning_rate(trainer.optimizer, trainer.scheduler.lr)
    trainer.early_stopping.step(float("inf"))
    trainer.save_checkpoint(epoch=1)
    resumed = Trainer(cfg, tok, _loaders(cfg), paths=PathManager(str(root)), device="cpu")
    resumed.load_checkpoint(str(trainer.ckpt_dir))
    assert resumed.state.step == trainer.state.step and resumed.start_epoch == 2
    assert resumed.best_val_loss == trainer.best_val_loss
    assert resumed.scheduler.state_dict() == trainer.scheduler.state_dict()
    assert resumed.early_stopping.state_dict() == trainer.early_stopping.state_dict()
    assert get_learning_rate(resumed.optimizer) == trainer.scheduler.lr == cfg.training.learning_rate / 2
    for (name, a), b in zip(resumed.model.state_dict().items(), trainer.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert resumed.optimizer.adam.state_dict()["state"].keys() == trainer.optimizer.adam.state_dict()["state"].keys()
    cfg.training.epochs = 3
    result = resumed.train()
    assert result["epochs_run"] == 1 and resumed.state.step == trainer.state.step + 3


def test_predictor_from_checkpoint_decodes_like_the_model(trained):
    cfg, tok, trainer, _, _, root = trained
    images = list(_loaders(cfg)["train"][1]["images"])
    ref = Predictor(cfg, trainer.model, tok, batch_size=4, device="cpu").predict_batch(images, return_ids=True)
    step_dir = trainer.ckpt_dir / f"step_{trainer.state.step}"
    loaded = Predictor.from_checkpoint(str(step_dir), batch_size=4, device="cpu")
    assert loaded.predict_batch(images, return_ids=True) == ref
    by_root = Predictor.from_checkpoint(str(root / "outputs" / cfg.training.experiment_name), device="cpu",
                                        config_overrides={"inference.max_length": 5})
    assert by_root.cfg.inference.max_length == 5
    assert by_root.tokenizer.to_config() == tok.to_config()


def test_trim_batch_ids():
    ids = np.array([[5, 6, 7, 8], [9, 9, 9, 9]])
    targets = np.array([[5, 6, 2, 0], [4, 0, 0, 0]])
    assert _trim_batch_ids(ids, targets, 0, 2) == ([[5, 6], [9]], [[5, 6], [4]])

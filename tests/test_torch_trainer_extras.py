"""The rest of the port's single-card Trainer, on the CPU, against the JAX package's.

* (f) the port's version of ``tests/test_freeze_regime.py::test_frozen_training_preserves_backbone``:
  a ResNet-18 ``Trainer.train()`` with ``pretrained_path`` (an npz written
  from a seed) and ``freeze_backbone`` leaves the backbone outside layer4
  bit-equal to the npz, while layer4, the head and the decoder move;
* (g) ``data.device_cache`` on and off give the same batches and equal
  losses (exactly: the same uint8 rows reach the same step), for the CNN, a
  ResNet-18, and a ResNet-18 with ``data.device_cache_grayscale``, which
  stores 1 channel and feeds 3;
* (h) the registry, ``metrics.json`` and the enhanced-metrics files: the
  registry's calls give the JAX registry's file but for its timestamps, a
  registry written by one package is read by the other, and
  ``compute_all_metrics`` writes the JAX file on the same inputs; a port and
  a JAX ``Trainer.train()`` of the same CNN (the port's weights bridged from
  the JAX trainer's) write the same registry entries, ``metrics.json`` and
  enhanced-metrics files: the same keys, the counts and learning rates
  equal, the losses within 1e-5 relative, the times aside; with
  ``save_basic_metrics`` and no registry the same ``metrics.json`` keys;
* (i) ``maybe_trace`` writes a Chrome trace on the CPU (and
  ``hardware.profile`` one under ``logs/traces/train_epoch0/``), and
  ``hardware.debug_nans`` raises at a NaN loss, where the default step does
  not check;
* the ``ast`` import scan of ``tests/test_torch_hygiene.py`` over the root
  ``bench_*_torch.py`` scripts, and ``bench_resnet_torch.py`` at shrunk
  shapes on the CPU: one JSON line with the JAX script's metric name;
* ``Predictor.from_checkpoint`` of a port checkpoint of each of the five
  ResNet variants, both memory kinds among them.
"""

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from img2latex_tpu.config import Config as JaxConfig
from img2latex_tpu.data.pipeline import create_data_loaders as jax_loaders
from img2latex_tpu.data.synthetic import write_synthetic_corpus
from img2latex_tpu.data.tokenizer import LaTeXTokenizer as JaxTokenizer
from img2latex_tpu.ops import metrics as jax_metrics
from img2latex_tpu.training.trainer import Trainer as JaxTrainer
from img2latex_tpu.utils.paths import PathManager as JaxPathManager
from img2latex_tpu.utils.registry import ExperimentRegistry as JaxRegistry
from img2latex_tpu_torch.bridge import load_flax_params
from img2latex_tpu_torch.config import config_from_dict
from img2latex_tpu_torch.data.pipeline import create_data_loaders
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.models.resnet import BatchNorm
from img2latex_tpu_torch.models.seq2seq import build_model
from img2latex_tpu_torch.ops import metrics
from img2latex_tpu_torch.training.predictor import Predictor
from img2latex_tpu_torch.training.trainer import Trainer
from img2latex_tpu_torch.utils import checkpoint as ckpt_lib
from img2latex_tpu_torch.utils import profiling
from img2latex_tpu_torch.utils.paths import PathManager
from img2latex_tpu_torch.utils.registry import ExperimentRegistry
from test_torch_hygiene import _forbidden

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H_IMG, W_IMG, L = 32, 64, 12
LOSS_RTOL = 1e-5
TIME_KEYS = {"train_time_s", "train_images_per_sec"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("extras_corpus"))
    write_synthetic_corpus(root, n_train=16, n_val=10, n_test=2, seed=21)
    tok = LaTeXTokenizer(max_sequence_length=L)
    tok.fit_on_formulas_file(f"{root}/im2latex_formulas.norm.lst")
    jtok = JaxTokenizer(max_sequence_length=L)
    jtok.fit_on_formulas_file(f"{root}/im2latex_formulas.norm.lst")
    return root, tok, jtok


def jax_config(root, name="cnn_lstm"):
    cfg = JaxConfig()
    cfg.data.data_dir = root
    cfg.data.batch_size = 8
    cfg.data.max_seq_length = cfg.inference.max_length = L
    cfg.model.name = name
    cfg.model.encoder.resnet.model_name = "resnet18"
    cfg.model.encoder.resnet.img_height, cfg.model.encoder.resnet.img_width = H_IMG, W_IMG
    cfg.model.encoder.cnn.img_height, cfg.model.encoder.cnn.img_width = H_IMG, W_IMG
    cfg.model.encoder.cnn.conv_filters = [4, 8, 8]
    cfg.model.embedding_dim = cfg.model.decoder.hidden_dim = 16
    cfg.model.decoder.lstm_layers = 1
    cfg.model.decoder.dropout = 0.0
    cfg.training.epochs = 2
    cfg.evaluation.bleu_batches = 1
    cfg.hardware.compute_dtype = "float32"
    cfg.hardware.use_mesh = False
    return cfg


def port_config(root, name="cnn_lstm", **overrides):
    cfg = config_from_dict(jax_config(root, name).to_dict())
    for dotted, value in overrides.items():
        obj = cfg
        *parts, leaf = dotted.split(".")
        for p in parts:
            obj = getattr(obj, p)
        setattr(obj, leaf, value)
    return cfg


# ---------------------------------------------------------------------------
# (f) the frozen regime through the product config path
# ---------------------------------------------------------------------------


def seeded_backbone_npz(path, backbone, seed):
    """A converted-npz (flax paths and layouts) for ``backbone``'s shapes, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    flat = {}
    for name, mod in backbone.named_modules():
        prefix = name.replace(".", "/")
        if isinstance(mod, torch.nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            flat[f"{prefix}/kernel"] = (rng.standard_normal((kh, kw, i, o)) / np.sqrt(kh * kw * i)).astype(np.float32)
        elif isinstance(mod, BatchNorm):
            n = mod.weight.shape[0]
            flat[f"{prefix}/scale"] = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
            flat[f"{prefix}/bias"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
            flat[f"{prefix}/mean"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
            flat[f"{prefix}/var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    np.savez(path, **flat)
    return flat


def test_frozen_training_preserves_backbone(corpus, tmp_path):
    root, tok, _ = corpus
    cfg = port_config(root, "resnet_lstm")
    probe = build_model(cfg, tok.vocab_size, device="cpu")
    flat = seeded_backbone_npz(tmp_path / "backbone.npz", probe.encoder.backbone, seed=22)
    cfg.model.encoder.resnet.pretrained_path = str(tmp_path / "backbone.npz")
    cfg.model.encoder.resnet.freeze_backbone = True
    paths = PathManager(str(tmp_path))
    trainer = Trainer(cfg, tok, create_data_loaders(cfg, tok), paths=paths, device="cpu", experiment_name="frz")
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.train()
    ckpt_dir, step = ckpt_lib.resolve_checkpoint_path(str(paths.get_dir("frz", "checkpoints")))
    state, _ = ckpt_lib.restore_checkpoint(ckpt_dir, step if step is not None else -1)
    got = state["model"]
    frozen_moved, layer4_moved = [], False
    for path, src in flat.items():
        if path.endswith(("/mean", "/var")):
            continue
        mod, leaf = path.rsplit("/", 1)
        key = f"encoder.backbone.{mod.replace('/', '.')}.weight" if leaf in ("kernel", "scale") else \
            f"encoder.backbone.{mod.replace('/', '.')}.bias"
        value = got[key].numpy()
        if leaf == "kernel":
            value = value.transpose(2, 3, 1, 0)
        if path.startswith("layer4"):
            layer4_moved |= not np.array_equal(value, src)
        elif not np.array_equal(value, src):
            frozen_moved.append(path)
    assert not frozen_moved, f"frozen params moved: {frozen_moved[:5]}"
    assert layer4_moved, "layer4 should train in the frozen regime"
    for key in ("encoder.head.weight", "decoder.cell.out.weight"):
        assert not torch.equal(got[key], start[key]), key
    # the frozen layers' running statistics still update in train mode
    assert not torch.equal(got["encoder.backbone.bn1.running_mean"], start["encoder.backbone.bn1.running_mean"])


# ---------------------------------------------------------------------------
# (g) the device-resident splits
# ---------------------------------------------------------------------------


def _losses(trainer):
    hist = trainer.train()["history"]
    return [(hist[e]["train_loss"], hist[e]["val_loss"], hist[e]["val_bleu"], hist[e]["steps"]) for e in sorted(hist)]


@pytest.mark.parametrize("name,gray", [("cnn_lstm", False), ("resnet_lstm", False), ("resnet_lstm", True)],
                         ids=["cnn", "resnet18", "resnet18-grayscale"])
def test_device_cache_gives_equal_losses(corpus, name, gray):
    root, tok, _ = corpus
    runs = {}
    for cached in (False, True):
        cfg = port_config(root, name, **{"data.device_cache": cached, "data.device_cache_grayscale": gray})
        trainer = Trainer(cfg, tok, create_data_loaders(cfg, tok), device="cpu")
        runs[cached] = (_losses(trainer), trainer)
    assert runs[True][0] == runs[False][0]
    assert runs[True][0][0][3] == 16 // 8  # n // B steps
    trainer = runs[True][1]
    c = trainer.cfg.image_shape[2]
    assert trainer._device_cache["images"].shape[-1] == (1 if gray else c)
    assert trainer._val_device_cache["images"].shape[0] == 16  # 10 rows padded to a whole eval batch of 16
    assert runs[False][1]._device_cache is None


def test_device_cache_batches_follow_the_loader(corpus):
    root, tok, _ = corpus
    cfg = port_config(root, "resnet_lstm", **{"data.device_cache": True, "data.device_cache_grayscale": True})
    trainer = Trainer(cfg, tok, create_data_loaders(cfg, tok), device="cpu")
    trainer.loaders["train"].set_epoch(1)
    host = list(trainer.loaders["train"])
    cached = list(trainer._epoch_steps(1))
    assert len(cached) == len(host) == 2
    for h, d in zip(host, cached):
        np.testing.assert_array_equal(d["images"].numpy(), h["images"][..., :1])
        np.testing.assert_array_equal(d["formulas"].numpy(), h["formulas"])
    over = port_config(root, "cnn_lstm", **{"data.device_cache": True, "data.device_cache_budget_gb": 1e-9})
    small = Trainer(over, tok, create_data_loaders(over, tok), device="cpu")
    assert len(list(small._epoch_steps(0))) == 2 and small._device_cache is False  # over budget: the loader


# ---------------------------------------------------------------------------
# (h) the registry, metrics.json and the enhanced metrics against the JAX package's
# ---------------------------------------------------------------------------


def _strip_times(tree):
    if isinstance(tree, dict):
        return {k: _strip_times(v) for k, v in tree.items() if k not in ("creation_time", "last_updated")}
    return tree


def _registry_calls(reg):
    first = reg.register_experiment("exp", description="d", tags=["a"], config_path="c.yaml")
    second = reg.register_experiment("exp")
    reg.update_status(second, "training")
    reg.log_metrics(second, 1, {"loss": np.float32(0.5), "steps": np.int64(3), "arr": np.arange(2), "x": 1.25})
    reg.log_metrics("unknown", 2, {"loss": 0.25})
    reg.update_status(second, "completed")
    with pytest.raises(ValueError):
        reg.update_status(second, "bogus")
    return first, second


def test_registry_file_equals_jax(tmp_path):
    port_reg, jax_reg = ExperimentRegistry(PathManager(str(tmp_path / "p"))), JaxRegistry(JaxPathManager(str(tmp_path / "j")))
    assert _registry_calls(port_reg) == _registry_calls(jax_reg) == ("exp", "exp_v1")
    got = json.loads((tmp_path / "p/outputs/registry/experiment_registry.json").read_text())
    ref = json.loads((tmp_path / "j/outputs/registry/experiment_registry.json").read_text())
    assert _strip_times(got) == _strip_times(ref)
    assert set(got["exp_v1"]) == set(ref["exp_v1"])  # last_updated included
    for name in ("exp_v1", "unknown"):
        mfile = f"outputs/{name}/metrics/metrics.json"
        assert json.loads((tmp_path / "p" / mfile).read_text()) == json.loads((tmp_path / "j" / mfile).read_text())
    assert [r["name"] for r in port_reg.list_experiments()] == [r["name"] for r in jax_reg.list_experiments()]
    ref_rows = [{k: None if isinstance(v, float) and np.isnan(v) else v for k, v in r.items()}  # pandas' NaN for None
                for r in jax_reg.compare_experiments(metric="loss").to_dict("records")]
    assert port_reg.compare_experiments(metric="loss") == ref_rows
    assert port_reg.delete_experiment("exp", delete_files=True) == jax_reg.delete_experiment("exp", delete_files=True)


def test_registry_read_across_packages(tmp_path):
    port_reg, jax_reg = ExperimentRegistry(PathManager(str(tmp_path))), JaxRegistry(JaxPathManager(str(tmp_path)))
    port_reg.register_experiment("a", auto_version=False)
    port_reg.log_metrics("a", 1, {"val_loss": 0.5})
    assert jax_reg.get("a") == port_reg.get("a")
    name = jax_reg.register_experiment("a")  # versioned past the port's entry
    jax_reg.update_status(name, "training")
    assert name == "a_v1" and port_reg.get(name) == jax_reg.get(name)
    assert port_reg.get(name)["status"] == "training"


def _preds_and_dense(rng, tok, n=5, L_=10):
    dense = rng.integers(4, tok.vocab_size, size=(n, L_))
    dense[:, 7:] = tok.pad_token_id
    pred_ids = np.where(rng.random((n, L_)) < 0.7, dense, rng.integers(4, tok.vocab_size, size=(n, L_)))
    probs = rng.random((n, L_)).astype(np.float32)
    preds = [list(map(int, r[:7])) for r in pred_ids]
    tgts = [list(map(int, r[:7])) for r in dense]
    return preds, tgts, probs, pred_ids.astype(np.int32), dense.astype(np.int32)


def test_compute_all_metrics_file_equals_jax(corpus, tmp_path):
    _, tok, jtok = corpus
    preds, tgts, probs, pred_ids, dense = _preds_and_dense(np.random.default_rng(23), tok)
    kw = dict(probs_max=probs, pred_ids=pred_ids, dense_targets=dense, num_samples=3, experiment_name="e",
              save_to_file=True, epoch=2, bleu_n=4)
    got = metrics.compute_all_metrics(preds, tgts, tok, metrics_dir=str(tmp_path / "p"), **kw)
    ref = jax_metrics.compute_all_metrics(preds, tgts, jtok, metrics_dir=str(tmp_path / "j"), **kw)
    name = "e_enhanced_metrics_epoch_2.json"
    assert (tmp_path / "p" / name).read_text() == (tmp_path / "j" / name).read_text()
    assert json.dumps(metrics._to_jsonable(got)) == json.dumps(jax_metrics._to_jsonable(ref))
    bare = metrics.compute_all_metrics(preds, tgts, tok)  # token lists only, nothing written
    assert bare == jax_metrics.compute_all_metrics(preds, tgts, jtok)


def _close(got, ref, path=""):
    """Equal structure and keys; numbers within LOSS_RTOL; times aside."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, sorted(set(got) ^ set(ref)))
        for k in ref:
            if k not in TIME_KEYS | {"creation_time", "last_updated"}:
                _close(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, f"{path}/{i}")
    elif isinstance(ref, float):
        assert got == pytest.approx(ref, rel=LOSS_RTOL, abs=1e-7), path
    else:
        assert got == ref, path


@pytest.fixture(scope="module")
def both_trainers(corpus, tmp_path_factory):
    """A JAX and a port Trainer.train() of the same CNN, the port's weights
    bridged from the JAX trainer's initial state, each with a registry."""
    root, tok, jtok = corpus
    out = tmp_path_factory.mktemp("both")
    jcfg = jax_config(root)
    jpaths = JaxPathManager(str(out / "j"))
    jt = JaxTrainer(jcfg, jtok, jax_loaders(jcfg, jtok), paths=jpaths, registry=JaxRegistry(jpaths),
                    experiment_name="run")
    params0 = jax.device_get(jt.state.params)
    jt.train()
    cfg = config_from_dict(jcfg.to_dict())
    model = load_flax_params(build_model(cfg, tok.vocab_size, device="cpu"), {"params": params0})
    paths = PathManager(str(out / "p"))
    Trainer(cfg, tok, create_data_loaders(cfg, tok), model=model, paths=paths, registry=ExperimentRegistry(paths),
            experiment_name="run", device="cpu").train()
    return out


def test_trainer_registry_and_metrics_equal_jax(both_trainers):
    out = both_trainers
    reg = "outputs/registry/experiment_registry.json"
    got, ref = json.loads((out / "p" / reg).read_text()), json.loads((out / "j" / reg).read_text())
    assert got["run"]["status"] == ref["run"]["status"] == "completed"
    assert sorted(got["run"]["metrics"]["steps"]) == ["1", "2"]
    _close(got, ref)
    for rel_path in ("outputs/run/metrics/metrics.json", "outputs/run/metrics/run_enhanced_metrics_epoch_1.json",
                     "outputs/run/metrics/run_enhanced_metrics_epoch_2.json"):
        _close(json.loads((out / "p" / rel_path).read_text()), json.loads((out / "j" / rel_path).read_text()))


def test_basic_metrics_without_registry(corpus, tmp_path):
    root, tok, _ = corpus
    cfg = port_config(root, "cnn_lstm", **{"training.epochs": 1, "hardware.profile": True})
    paths = PathManager(str(tmp_path))
    Trainer(cfg, tok, create_data_loaders(cfg, tok), paths=paths, device="cpu", experiment_name="solo").train()
    data = json.loads((tmp_path / "outputs/solo/metrics/metrics.json").read_text())
    keys = {"step", "train_loss", "train_accuracy", "train_time_s", "train_images_per_sec", "steps", "val_loss",
            "val_accuracy", "val_bleu", "val_levenshtein", "learning_rate"}
    assert list(data["steps"]) == ["1"] and set(data["steps"]["1"]) == keys
    assert not (tmp_path / "outputs/registry").exists()
    trace = tmp_path / "outputs/solo/logs/traces/train_epoch0/trace.json"
    assert "traceEvents" in json.loads(trace.read_text())


# ---------------------------------------------------------------------------
# (i) the trace and the NaN check
# ---------------------------------------------------------------------------


def test_maybe_trace_writes_a_chrome_trace(tmp_path):
    with profiling.maybe_trace(True, str(tmp_path), "probe"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "traces/probe/trace.json").read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with profiling.maybe_trace(False, str(tmp_path), "off"):
        pass
    assert not (tmp_path / "traces/off").exists()
    timer = profiling.StepTimer(device="cpu")
    for _ in range(3):
        with timer:
            torch.ones(8).sum()
    assert timer.count == 3 and timer.mean_ms > 0


def test_debug_nans_raises_at_a_nan_loss(corpus):
    root, tok, _ = corpus
    cfg = port_config(root, "cnn_lstm")
    trainer = Trainer(cfg, tok, {"train": [], "validate": []}, device="cpu")
    batch = next(iter(create_data_loaders(cfg, tok, splits=("train",))["train"]))
    with torch.no_grad():
        trainer.model.decoder.cell.out.bias.fill_(float("nan"))
    try:
        profiling.apply_numerics_flags(False)
        assert not np.isfinite(trainer.train_step(trainer.state, batch)["loss"].item())  # unchecked by default
        profiling.apply_numerics_flags(True)
        with pytest.raises(FloatingPointError, match="loss"):
            trainer.train_step(trainer.state, batch)
    finally:
        profiling.apply_numerics_flags(False)


# ---------------------------------------------------------------------------
# The import scan over the port's bench scripts
# ---------------------------------------------------------------------------


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize("path", sorted(ROOT.glob("bench_*_torch.py")) + [ROOT / "bench_torch.py"],
                         ids=lambda p: p.name)
def test_bench_script_imports_nothing_forbidden(path):
    assert path.exists()
    assert [n for n in _imports(path) if _forbidden(n)] == []
    assert any(n.startswith("img2latex_tpu_torch") for n in _imports(path))


def test_bench_resnet_prints_one_json_line(monkeypatch, capsys):
    import importlib

    mod = importlib.import_module("bench_resnet_torch")
    for attr, value in (("DEVICE", "cpu"), ("IMG_H", 32), ("IMG_W", 64), ("EMBED", 16), ("HIDDEN", 16),
                        ("VOCAB", 24), ("MAX_LEN", 6), ("ITERS", 2)):
        monkeypatch.setattr(mod, attr, value)
    mod.main(["2", "resnet18"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "resnet18_greedy_decode_images_per_sec" and line["value"] > 0
    assert line["unit"] == "img/s" and line["vs_baseline"] is None
    with pytest.raises(ValueError, match="bench_resnet_torch"):
        mod.main(["2", "resnet7"])


@pytest.mark.parametrize("name,memory", [("resnet18", "vector"), ("resnet34", "grid"), ("resnet50", "vector"),
                                         ("resnet101", "grid"), ("resnet152", "vector")])
def test_predictor_from_checkpoint_rebuilds_each_variant(tmp_path, name, memory):
    """A port checkpoint of each ResNet variant (BatchNorm buffers drawn away
    from 0 and 1) comes back whole from Predictor.from_checkpoint and decodes
    three-channel canvases as the model it was written from."""
    cfg = port_config(str(tmp_path), "resnet_lstm", **{"model.encoder.resnet.model_name": name,
                                                       "model.memory": memory,
                                                       "model.encoder.resnet.img_height": 32,
                                                       "model.encoder.resnet.img_width": 32})
    tok = LaTeXTokenizer(max_sequence_length=L)
    tok.default_init()
    model = build_model(cfg, tok.vocab_size, device="cpu", seed=3)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for buf_name, buf in model.named_buffers():
            buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    meta = {"epoch": 0, "step": 1, "config": cfg.to_dict(), "tokenizer_config": tok.to_config()}
    ckpt_lib.save_checkpoint(tmp_path / "ckpt", {"model": model.state_dict(), "step": 1}, meta, step=1)
    pred = Predictor.from_checkpoint(str(tmp_path / "ckpt"), batch_size=2, device="cpu")
    assert pred.cfg.model.encoder.resnet.model_name == name and pred.cfg.image_shape == (32, 32, 3)
    sd = pred.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    imgs = [rng.integers(0, 256, size=(32, 32), dtype=np.uint8) for _ in range(3)]
    assert pred.predict_batch(imgs, return_ids=True) == Predictor(cfg, model, tok, batch_size=2,
                                                                  device="cpu").predict_batch(imgs, return_ids=True)

"""The port's ResNet-LSTM against the JAX package's, on the CPU.

The same flax weights (a JAX ``resnet_lstm`` initialized from a seed, its
BatchNorm scales, biases and running statistics then drawn away from 1, 0, 0
and 1) are mapped by ``img2latex_tpu_torch.bridge`` onto the port's model,
and the same inputs go through both:

* (a) the ResNet-18 encoder (here) and the ResNet-50 encoder
  (``tests/test_torch_resnet50.py``), vector and grid memory, in eval
  mode and in train mode, at B = 4 and 64x128 (layer4 keeps 2x4 positions a
  channel): layer4's map and the memory, and after a train-mode pass the
  running buffers.  Float32 within 1e-4 of the largest magnitude, except
  ResNet-50 in train mode: there the JAX package's float32 result is itself
  up to ~6e-4 from a float64 run of the same flax code (the batch
  statistics' float32 sums, amplified through 16 train-mode blocks; the
  port's float32 lies ~1e-4 from it), so that case is held in float64
  (both packages, 1e-9) and the port's float32 must lie no farther from the
  float64 result than the JAX package's float32 does;
* (b) the train step: ``tests/test_torch_resnet_train.py``;
* (c) ``predict_batch`` greedy tokens of a ResNet-18, vector and grid,
  equal to the JAX ``Predictor``'s in float32;
* (d) a JAX ``resnet_lstm`` checkpoint (Orbax) converted by
  ``convert_flax_checkpoint`` and decoded by ``Predictor.from_checkpoint``:
  the same tokens;
* (e) ``load_converted_resnet`` on an npz written from a seed equals the
  JAX loader's result exactly, and both refuse a wrong shape and an unknown
  path with the same message;
* every variant and both memory kinds build, and ``receptive_field`` and
  the head's sizes equal the JAX package's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img2latex_tpu.config import Config as JaxConfig
from img2latex_tpu.data.tokenizer import LaTeXTokenizer as JaxTokenizer
from img2latex_tpu.models import pretrained as jax_pretrained
from img2latex_tpu.models import resnet as jax_resnet
from img2latex_tpu.models.encoder import ResNetEncoder as JaxResNetEncoder
from img2latex_tpu.models.seq2seq import build_model as jax_build_model
from img2latex_tpu.training.predictor import Predictor as JaxPredictor
from img2latex_tpu.utils.checkpoint import restore_checkpoint as jax_restore
from img2latex_tpu.utils.checkpoint import save_checkpoint as jax_save
from img2latex_tpu_torch.bridge import _flat, load_flax_params, params_from_flax
from img2latex_tpu_torch.config import config_from_dict
from img2latex_tpu_torch.data.synthetic import synthetic_batch
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.models import pretrained, resnet
from img2latex_tpu_torch.models.encoder import ResNetEncoder
from img2latex_tpu_torch.models.seq2seq import build_model
from img2latex_tpu_torch.training.predictor import Predictor
from img2latex_tpu_torch.utils.checkpoint import convert_flax_checkpoint

torch.set_num_threads(1)

H_IMG, W_IMG, B, E, L = 64, 128, 4, 16, 12
ENC_RTOL = 1e-4  # of the largest magnitude, float32
F64_RTOL = 1e-9
HEAD_GAIN = 4.0


def jax_config(name="resnet18", memory="vector", freeze=False):
    cfg = JaxConfig()
    cfg.model.name = "resnet_lstm"
    cfg.model.encoder.resnet.model_name = name
    cfg.model.encoder.resnet.img_height, cfg.model.encoder.resnet.img_width = H_IMG, W_IMG
    cfg.model.encoder.resnet.freeze_backbone = freeze
    cfg.model.memory = memory
    cfg.model.embedding_dim = E
    cfg.model.decoder.hidden_dim = E
    cfg.model.decoder.lstm_layers = 2
    cfg.model.decoder.dropout = 0.0
    cfg.data.max_seq_length = L
    cfg.inference.max_length = L
    cfg.hardware.compute_dtype = "float32"
    cfg.hardware.use_mesh = False
    return cfg


def drawn(tree, rng):
    """The tree with BatchNorm scales near 1, every bias near 0, running means
    near 0 and variances in [0.5, 1.5], so that each has power in a test."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = drawn(v, rng)
        elif k == "scale":
            out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def jax_variables(jmodel, seed, channels=3):
    v = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, H_IMG, W_IMG, channels)),
                                   jnp.zeros((2, 5), jnp.int32)))
    rng = np.random.default_rng(seed)
    return {"params": drawn(v["params"], rng), "batch_stats": drawn(v["batch_stats"], rng)}


def canvases(n, seed):
    """Formula canvases of the synthetic corpus, grayscale tiled to 3 channels, uint8."""
    u8, _ = synthetic_batch(n, (H_IMG, W_IMG, 1), L, 40, seed=seed)
    return np.repeat(u8, 3, axis=-1)


def normalized(u8):
    mean, std = np.array([0.485, 0.456, 0.406], np.float32), np.array([0.229, 0.224, 0.225], np.float32)
    return (u8.astype(np.float32) * np.float32(1 / 255) - mean) / std


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def port_stats(model):
    """The port's running buffers, keyed as the bridge keys them."""
    return {k: v.detach().numpy() for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def stats_err(model, jax_stats, params):
    ref = params_from_flax({"params": params, "batch_stats": jax_stats}, model)
    return max(rel(v, ref[k].numpy()) for k, v in port_stats(model).items())


# ---------------------------------------------------------------------------
# (a) the encoders
# ---------------------------------------------------------------------------


def encoder_pair(name):
    """One JAX init of variant ``name``: the vector model's variables, and
    the grid model's with its head drawn from a seed (the backbone is the
    same), each with the port's model bridged from it."""
    x = normalized(canvases(B, seed=4))
    out = {"name": name, "x": x, "f64": {}}
    for memory in ("vector", "grid"):
        cfg = jax_config(name, memory)
        cfg.model.decoder.attention = False  # the decoders' trees alike; only the encoder is held here
        jmodel = jax_build_model(cfg, 40)
        if memory == "vector":
            variables = jax_variables(jmodel, seed=3)
        else:
            variables = copy.deepcopy(variables)
            fdim = resnet.feature_dim(name)
            variables["params"]["encoder"]["Dense_0"]["kernel"] = (
                np.random.default_rng(5).standard_normal((2 * fdim, E)) / np.sqrt(2 * fdim)).astype(np.float32)
        tmodel = load_flax_params(build_model(config_from_dict(cfg.to_dict()), 40, device="cpu"), variables)
        out[memory] = (jmodel, variables, tmodel)
    return out


@pytest.fixture(scope="module")
def encoders():
    return encoder_pair("resnet18")


def _jax_encode(jmodel, variables, x, train):
    """(layer4 map NHWC, memory, batch_stats after the pass or None) of the
    JAX model, the memory from the same map (``from_features``)."""
    (feats, mem), mut = jmodel.apply(
        variables, jnp.asarray(x), mutable=["batch_stats"],
        method=lambda m, x: (f := m.encoder(x, train=train, features_only=True), m.encode_from_features(f)))
    return np.asarray(feats), np.asarray(mem), jax.device_get(mut["batch_stats"]) if train else None


def _port_encode(encoder, x, train):
    """(layer4 map NHWC, memory, the encoder after the pass) of a copy of ``encoder``."""
    enc = copy.deepcopy(encoder)
    with torch.no_grad():
        feats = enc.features(x, train=train)
        mem = enc.project(feats)
    return feats.permute(0, 2, 3, 1).numpy(), mem.numpy(), enc


def _float64_reference(enc_fixture, memory):
    """ResNet-50 in train mode in float64, both packages: (JAX map, JAX
    memory, JAX batch_stats, port map, port memory, port encoder)."""
    if memory not in enc_fixture["f64"]:
        _, variables, tmodel = enc_fixture[memory]
        x = enc_fixture["x"]
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        enc_vars = {"params": v64["params"]["encoder"], "batch_stats": v64["batch_stats"]["encoder"]}
        with jax.enable_x64(True):
            jenc = JaxResNetEncoder(model_name=enc_fixture["name"], embedding_dim=E, output=memory,
                                    dtype=jnp.float64, param_dtype=jnp.float64)
            (f_ref, m_ref), mut = jenc.apply(
                enc_vars, jnp.asarray(x, jnp.float64), mutable=["batch_stats"],
                method=lambda m, x: (f := m(x, train=True, features_only=True), m(from_features=f)))
            ref = (np.asarray(f_ref), np.asarray(m_ref), jax.device_get(mut["batch_stats"]))
        e64 = copy.deepcopy(tmodel.encoder).double()
        e64.dtype = e64.backbone.dtype = torch.float64
        enc_fixture["f64"][memory] = ref + _port_encode(e64, torch.from_numpy(x.astype(np.float64)), True)
    return enc_fixture["f64"][memory]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("memory", ["vector", "grid"])
def test_encoder_matches_flax(encoders, memory, train):
    check_encoder(encoders, memory, train)


def check_encoder(encoders, memory, train):
    """The port's layer4 map, memory and running buffers against flax's
    (module docstring, (a)); ``encoders`` from :func:`encoder_pair`."""
    jmodel, variables, tmodel = encoders[memory]
    x = encoders["x"]
    feats_ref, mem_ref, stats_ref = _jax_encode(jmodel, variables, x, train)
    feats, mem, enc = _port_encode(tmodel.encoder, torch.from_numpy(x), train)
    model = copy.deepcopy(tmodel)
    model.encoder = enc
    assert feats.shape == feats_ref.shape and feats_ref.shape[1:3] == (2, 4)
    assert mem.shape == ((B, 4, E) if memory == "grid" else (B, E))
    mem = mem.reshape(mem_ref.shape)
    errs = [rel(feats, feats_ref), rel(mem, mem_ref)]
    if train:
        errs.append(stats_err(model, stats_ref, variables["params"]))
    else:
        assert stats_err(model, variables["batch_stats"], variables["params"]) == 0.0  # eval leaves them
    if not (train and encoders["name"] == "resnet50"):
        assert max(errs) <= ENC_RTOL, errs
        return
    # ResNet-50 in train mode: both packages in float64, then each float32 against that
    f_ref, m_ref, stats64, f64, m64, e64 = _float64_reference(encoders, memory)
    m64 = m64.reshape(m_ref.shape)
    assert rel(f64, f_ref) <= F64_RTOL and rel(m64, m_ref) <= F64_RTOL
    for path, ref in _flat(stats64).items():
        mod, leaf = path.rsplit("/", 1)
        got = getattr(e64.get_submodule(mod.replace("/", ".")), "running_" + leaf)
        assert rel(got.numpy(), ref) <= F64_RTOL, path
    for got32, ref32, ref64 in ((feats, feats_ref, f_ref), (mem, mem_ref, m_ref)):
        assert rel(got32, ref64) <= max(rel(ref32, ref64), ENC_RTOL), (rel(got32, ref64), rel(ref32, ref64))


# ---------------------------------------------------------------------------
# (c, d) predict_batch and a converted checkpoint
# ---------------------------------------------------------------------------


def _pair(memory, seed):
    cfg = jax_config("resnet18", memory)
    jtok = JaxTokenizer(max_sequence_length=L)
    jtok.default_init()
    jmodel = jax_build_model(cfg, jtok.vocab_size)
    variables = jax_variables(jmodel, seed=seed)
    head = variables["params"]["encoder"]["Dense_0"]
    head["kernel"] = head["kernel"] * HEAD_GAIN  # memories far apart, so that rows differ
    jpred = JaxPredictor(cfg, jmodel, variables["params"], variables["batch_stats"], jtok, batch_size=4)
    tcfg = config_from_dict(cfg.to_dict())
    tok = LaTeXTokenizer.from_config(jtok.to_config())
    tmodel = load_flax_params(build_model(tcfg, tok.vocab_size, device="cpu"), variables)
    return cfg, jtok, variables, jpred, Predictor(tcfg, tmodel, tok, batch_size=4, device="cpu")


def _images(n, seed):
    u8, _ = synthetic_batch(n, (H_IMG, W_IMG, 1), L, 40, seed=seed)
    return list(u8[..., 0])  # HW grayscale: both predictors tile it to 3 channels


@pytest.mark.parametrize("memory", ["vector", "grid"])
def test_predict_batch_equals_jax(memory):
    _, _, _, jpred, tpred = _pair(memory, seed=7)
    imgs = _images(6, seed=8)
    ref = jpred.predict_batch(imgs, return_ids=True)
    got = tpred.predict_batch(imgs, return_ids=True)
    assert got == ref
    assert len({tuple(r) for r in ref}) > 1  # the canvases decode to different rows


def test_converted_checkpoint_decodes_as_jax(tmp_path):
    cfg, jtok, variables, jpred, _ = _pair("grid", seed=9)
    meta = {"epoch": 0, "step": 3, "best_val_loss": 1.0, "config": cfg.to_dict(),
            "tokenizer_config": jtok.to_config(), "metrics": {}}
    jax_save(tmp_path / "jax", {"params": variables["params"], "batch_stats": variables["batch_stats"],
                                "step": jnp.asarray(3)}, meta, step=3, is_best=True)
    state, meta = jax_restore(tmp_path / "jax")
    state = jax.device_get(state)
    convert_flax_checkpoint(state["params"], meta, tmp_path / "port", step=3, batch_stats=state["batch_stats"])
    tpred = Predictor.from_checkpoint(str(tmp_path / "port"), batch_size=4, device="cpu")
    assert tpred.cfg.model.name == "resnet_lstm" and tpred.cfg.image_shape == (H_IMG, W_IMG, 3)
    imgs = _images(5, seed=10)
    assert tpred.predict_batch(imgs, return_ids=True) == jpred.predict_batch(imgs, return_ids=True)
    with pytest.raises(KeyError, match="batch_stats"):  # a ResNet without its statistics
        convert_flax_checkpoint(state["params"], meta, tmp_path / "bad", step=3)


# ---------------------------------------------------------------------------
# (e) the converted-npz loader
# ---------------------------------------------------------------------------


def _seeded_npz(path, jvars, seed):
    rng = np.random.default_rng(seed)
    flat = {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in _flat(jvars["params"]["encoder"]["backbone"]).items()}
    flat.update({k: rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                 for k, v in _flat(jvars["batch_stats"]["encoder"]["backbone"]).items()})
    np.savez(path, **flat)
    return flat


def test_load_converted_resnet_equals_jax(tmp_path):
    cfg = jax_config("resnet18", "vector")
    jmodel = jax_build_model(cfg, 40)
    variables = jax_variables(jmodel, seed=11)
    flat = _seeded_npz(tmp_path / "bb.npz", variables, seed=12)
    ref = jax.device_get(jax_pretrained.load_converted_resnet(variables, str(tmp_path / "bb.npz")))
    model = load_flax_params(build_model(config_from_dict(cfg.to_dict()), 40, device="cpu"), variables)
    pretrained.load_converted_resnet(model.encoder.backbone, str(tmp_path / "bb.npz"))
    expect = params_from_flax(ref, model)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in expect.items())
    assert any(not np.array_equal(_flat(ref["params"])[k], v) for k, v in _flat(variables["params"]).items())
    assert len(flat) == sum(k.startswith("encoder.backbone.") for k in sd)


@pytest.mark.parametrize("fault", ["shape", "path"])
def test_load_converted_resnet_refuses_as_jax(tmp_path, fault):
    cfg = jax_config("resnet18", "vector")
    jmodel = jax_build_model(cfg, 40)
    variables = jax_variables(jmodel, seed=13)
    flat = _seeded_npz(tmp_path / "ok.npz", variables, seed=14)
    if fault == "shape":
        flat["layer2_0/conv1/kernel"] = np.zeros((3, 3, 64, 7), np.float32)
        exc = ValueError
    else:
        flat["layer9_0/conv1/kernel"] = np.zeros((3, 3, 64, 64), np.float32)
        exc = KeyError
    np.savez(tmp_path / "bad.npz", **flat)
    with pytest.raises(exc) as ref:
        jax_pretrained.load_converted_resnet(variables, str(tmp_path / "bad.npz"))
    model = build_model(config_from_dict(cfg.to_dict()), 40, device="cpu")
    with pytest.raises(exc) as got:
        pretrained.load_converted_resnet(model.encoder.backbone, str(tmp_path / "bad.npz"))
    assert str(got.value) == str(ref.value)


def test_torchvision_key_mapping_equals_jax():
    rng = np.random.default_rng(15)
    sd = {"conv1.weight": torch.from_numpy(rng.standard_normal((64, 3, 7, 7)).astype(np.float32)),
          "bn1.running_var": np.ones(64, np.float32), "fc.weight": np.zeros((2, 2)),
          "layer3.1.downsample.1.bias": np.arange(4.0), "layer1.0.bn2.num_batches_tracked": np.int64(3),
          "layer2.0.downsample.0.weight": rng.standard_normal((8, 4, 1, 1))}
    got, ref = pretrained.convert_state_dict(sd), jax_pretrained.convert_state_dict(sd)
    assert got.keys() == ref.keys() and all(np.array_equal(got[k], ref[k]) for k in ref)
    assert [pretrained.map_torch_key(k) for k in sd] == [jax_pretrained.map_torch_key(k) for k in sd]
    assert repr(pretrained.unflatten(got)) == repr(jax_pretrained.unflatten(ref))


# ---------------------------------------------------------------------------
# Every variant, both memory kinds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(resnet.STAGE_SIZES))
def test_variants_build_as_jax(name):
    assert resnet.receptive_field(name) == jax_resnet.receptive_field(name)
    assert resnet.feature_dim(name) == jax_resnet.feature_dim(name)
    model = build_model(config_from_dict(jax_config(name, "vector").to_dict()), 40, device="cpu")
    assert len(model.encoder.backbone.block_names) == sum(resnet.STAGE_SIZES[name])
    assert model.encoder.feature_shape == (resnet.feature_dim(name), 2, 4)
    assert model.encoder.head.in_features == resnet.feature_dim(name)
    with torch.device("meta"):
        grid = ResNetEncoder(name, H_IMG, W_IMG, 3, E, "grid")
    assert grid.head.in_features == resnet.feature_dim(name) * 2
    with pytest.raises(ValueError):
        config_from_dict({"model": {"name": "resnet_lstm", "encoder": {"resnet": {"model_name": "resnet7"}}}})

"""The channel-first encoder chain (``hardware.pallas_chain``) against the JAX package, on the CPU.

The same numpy inputs go through the JAX functions and the port's:

* ``convblock_cf`` (its plain version on CPU tensors) against the TPU kernel
  ``fused_convblock_cf`` in interpret mode and ``_xla_convblock_cf``;
  ``fused_conv_relu_pool`` (NHWC, no bias) against the JAX one in interpret
  mode; ``conv1_lane_relu_pool`` and ``conv1_pool(layout="nhwc")`` against
  ``conv1_lane_relu_pool`` and ``fused_conv1_pool(layout="nhwc")``;
* ``convblock_cf``'s gradients (dx, dW, db) against ``jax.vjp`` of the JAX
  ``convblock_cf``, in float32 and in bf16 on inputs built to tie in the
  pool windows;
* the chain encoder (vector and grid) against the JAX ``CNNEncoder`` with
  ``pallas_chain="interpret"``, weights through the bridge; the head's
  layout (flatten plus the bridge's row permutation = the JAX ``kperm``,
  the grid permute = the JAX ``einsum``);
* greedy ids of the port's ``Predictor`` with ``hardware.pallas_chain`` on,
  both memory kinds, and one train step, against the JAX ``Predictor`` and
  ``make_train_step`` with the chain in interpret mode.

Tolerances: float32 within 1e-5 of the largest value (sums in another
order: the TPU kernel sums 16 packed taps, the plain version 9); bf16 within
one bf16 rounding step (2^-7 of the value) on every element and equal on at
least 99% (a float32 sum that lands on the other side of a rounding
boundary); the bf16 gradients on tie-built inputs, whose sums are exact,
equal to the float32 VJP's rounded once to bf16 (JAX's own bf16 VJP raises:
see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from img2latex_tpu.config import Config as JaxConfig
from img2latex_tpu.data.tokenizer import LaTeXTokenizer as JaxTokenizer
from img2latex_tpu.models.seq2seq import build_model as jax_build_model
from img2latex_tpu.ops.pallas.conv1_lane import conv1_lane_relu_pool as jax_conv1_lane
from img2latex_tpu.ops.pallas.conv1_phase import fused_conv1_pool as jax_fused_conv1_pool
from img2latex_tpu.ops.pallas.conv_cf import _xla_convblock_cf
from img2latex_tpu.ops.pallas.conv_cf import convblock_cf as jax_convblock_cf
from img2latex_tpu.ops.pallas.conv_cf import fused_convblock_cf as jax_fused_convblock_cf
from img2latex_tpu.ops.pallas.conv_pool import fused_conv_relu_pool as jax_fused_conv_relu_pool
from img2latex_tpu.training.predictor import Predictor as JaxPredictor
from img2latex_tpu_torch.bridge import load_flax_params, params_from_flax
from img2latex_tpu_torch.config import config_from_dict
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.models import encoder as enc_mod
from img2latex_tpu_torch.models.seq2seq import build_model
from img2latex_tpu_torch.ops.conv1_lane import conv1_lane_relu_pool, conv1_lane_relu_pool_plain
from img2latex_tpu_torch.ops.conv1_phase import conv1_pool
from img2latex_tpu_torch.ops.conv_cf import convblock_cf, convblock_cf_plain, fused_convblock_cf
from img2latex_tpu_torch.ops.conv_pool import fused_conv_relu_pool
from img2latex_tpu_torch.training.predictor import Predictor
from img2latex_tpu_torch.training.steps import make_train_step, train_loss
from test_torch_train import GRAD_ATOL, PARAM_ATOL, batches, jax_config, port_state, run_jax

torch.set_num_threads(1)

BF16_ULP = 2.0**-7  # one bf16 rounding step, relative
SHAPES = [(2, 4, 8, 8, 16), (1, 3, 12, 8, 12), (2, 8, 16, 16, 64), (1, 33, 5, 4, 6)]  # B, Cin, Cout, H, W


def _block(B, Cin, Cout, H, W, seed, nhwc=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, Cin) if nhwc else (B, Cin, H, W)).astype(np.float32)
    k = (rng.normal(size=(3, 3, Cin, Cout)) / np.sqrt(9 * Cin)).astype(np.float32)  # HWIO
    b = (rng.normal(size=Cout) * 0.1).astype(np.float32)
    return x, k, b


def _oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, ref):
    np.testing.assert_allclose(got, ref, atol=1e-5 * max(np.abs(ref).max(), 1.0), rtol=0)


def _bf16_close(got, ref):
    """Within one bf16 rounding step on every element, equal on >= 99%."""
    assert np.all(np.abs(got - ref) <= BF16_ULP * np.abs(ref) + 1e-6)
    assert (got == ref).mean() >= 0.99


@pytest.mark.parametrize("shape", SHAPES)
def test_convblock_cf_matches_jax_f32(shape):
    x, k, b = _block(*shape, seed=sum(shape))
    jx, jk, jb = jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)
    ref_kernel = np.asarray(jax_fused_convblock_cf(jx, jk, jb, interpret=True))
    ref_xla = np.asarray(_xla_convblock_cf(jx, jk, jb))
    got = convblock_cf(torch.from_numpy(x), _oihw(k), torch.from_numpy(b)).numpy()
    B, _, Cout, H, W = shape
    assert got.shape == (B, Cout, H // 2, W // 2)
    _close(got, ref_kernel)
    _close(got, ref_xla)
    fused = fused_convblock_cf(torch.from_numpy(x), _oihw(k), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(fused, got)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_convblock_cf_matches_jax_bf16(shape):
    x, k, b = _block(*shape, seed=sum(shape) + 1)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ref = _f32(jax_fused_convblock_cf(jx, jnp.asarray(k), jnp.asarray(b), interpret=True))
    got = convblock_cf(torch.from_numpy(x).to(torch.bfloat16), _oihw(k), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(), ref)
    _bf16_close(convblock_cf_plain(torch.from_numpy(x).to(torch.bfloat16), _oihw(k),
                                   torch.from_numpy(b)).float().numpy(),
                _f32(_xla_convblock_cf(jx, jnp.asarray(k), jnp.asarray(b))))


@pytest.mark.parametrize("cin", [1, 3, 8])
def test_fused_conv_relu_pool_matches_jax(cin):
    B, Cout, H, W = 2, 12, 8, 16
    x, k, _ = _block(B, cin, Cout, H, W, seed=cin, nhwc=True)
    ref = np.asarray(jax_fused_conv_relu_pool(jnp.asarray(x), jnp.asarray(k), interpret=True))
    got = fused_conv_relu_pool(torch.from_numpy(x), _oihw(k)).numpy()
    assert got.shape == (B, H // 2, W // 2, Cout)
    _close(got, ref)
    tiled = np.asarray(jax_fused_conv_relu_pool(jnp.asarray(x), jnp.asarray(k), w_tile=8, interpret=True))
    np.testing.assert_array_equal(fused_conv_relu_pool(torch.from_numpy(x), _oihw(k), w_tile=8).numpy(), got)
    _close(got, tiled)
    with pytest.raises(ValueError):
        fused_conv_relu_pool(torch.from_numpy(x), _oihw(k), w_tile=3)


def test_conv1_nhwc_matches_jax():
    B, H, W, C = 2, 8, 64, 16
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, size=(B, H, W, 1)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 1, C)) * 0.3).astype(np.float32)
    b = (rng.normal(size=C) * 0.1).astype(np.float32)
    jx, jk, jb = jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)
    tx, tw, tb = torch.from_numpy(x), _oihw(k), torch.from_numpy(b)
    lane = conv1_lane_relu_pool(tx, tw).numpy()
    assert lane.shape == (B, H // 2, W // 2, C)
    _close(lane, np.asarray(jax_conv1_lane(jx, jk, interpret=True)))
    np.testing.assert_array_equal(conv1_lane_relu_pool_plain(tx, tw).numpy(), lane)
    nhwc = conv1_pool(tx, tw, tb, layout="nhwc").numpy()
    _close(nhwc, np.asarray(jax_fused_conv1_pool(jx, jk, jb, interpret=True, layout="nhwc")))
    np.testing.assert_array_equal(nhwc, conv1_pool(tx, tw, tb, layout="nchw").permute(0, 2, 3, 1).numpy())
    with pytest.raises(ValueError):
        conv1_pool(tx, tw, tb, layout="hwcn")


def _tie_block(B, Cin, Cout, H, W, seed):
    """Dyadic values on a coarse grid: every product and sum is exact in
    float32 and the conv outputs are exact in bf16, so pool windows tie often."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 2, size=(B, Cin, H, W)) * 0.5).astype(np.float32)
    k = (rng.integers(-1, 2, size=(3, 3, Cin, Cout)) * 0.25).astype(np.float32)
    b = (rng.integers(-2, 3, size=Cout) * 0.5).astype(np.float32)
    g = (rng.integers(-3, 4, size=(B, Cout, H // 2, W // 2)) * 0.25).astype(np.float32)
    return x, k, b, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convblock_cf_gradients_match_jax_vjp(dtype):
    """dx, dW and db against the JAX custom VJP (the kernel in interpret mode
    forward, autograd of the XLA composition backward).

    bf16: the JAX VJP itself raises in bf16 on this JAX version (the conv's
    transpose meets a float32 cotangent and a bf16 kernel), so the reference
    is the float32 VJP on tie-built inputs whose every value is exact in
    bf16: the same forward values, so the same ties, the gradient of each
    window routed to its first largest element by both; the port's bf16 dx
    and dW are that gradient rounded once to bf16, db is exact."""
    shape = (2, 4, 6, 8, 12)
    if dtype == "float32":
        x, k, b = _block(*shape, seed=3)
        g = np.random.default_rng(4).normal(size=(2, 6, 4, 6)).astype(np.float32)
    else:
        x, k, b, g = _tie_block(*shape, seed=3)
    out, vjp = jax.vjp(lambda *a: jax_convblock_cf(*a, True), jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    dx, dk, db = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(), _oihw(k).requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    tout = convblock_cf(*leaves)
    tdx, tdw, tdb = torch.autograd.grad(tout, leaves, torch.from_numpy(g).to(tdt))
    got = [tdx.float().numpy(), np.transpose(tdw.numpy(), (2, 3, 1, 0)), tdb.numpy()]
    if dtype == "float32":
        for a, r in zip(got, (dx, dk, db)):
            _close(a, r)
        return
    np.testing.assert_array_equal(tout.detach().float().numpy(), np.asarray(out))
    # the inputs do tie: positive windows whose largest value occurs twice or more
    win = torch.from_numpy(np.array(jax.nn.relu(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME", dimension_numbers=("NCHW", "HWIO", "NCHW"))
        + jnp.asarray(b)[None, :, None, None])))
    win = win.unfold(2, 2, 2).unfold(3, 2, 2).reshape(2, 6, 4, 6, 4)
    ties = ((win == win.amax(-1, keepdim=True)).sum(-1) > 1) & (win.amax(-1) > 0)
    assert ties.float().mean() > 0.05
    bf16 = lambda a: torch.from_numpy(np.array(a)).to(torch.bfloat16).float().numpy()  # noqa: E731
    np.testing.assert_array_equal(got[0], bf16(dx))
    np.testing.assert_array_equal(got[1], bf16(dk))
    np.testing.assert_array_equal(got[2], db)


def _jax_cfg(memory, dtype="float32"):
    cfg = JaxConfig()
    cfg.model.memory = memory
    cfg.model.embedding_dim = 32
    cfg.model.decoder.hidden_dim = 32
    cfg.model.decoder.lstm_layers = 2
    cfg.model.decoder.dropout = 0.0
    cfg.model.encoder.cnn.img_height = 16
    cfg.model.encoder.cnn.img_width = 64
    cfg.model.encoder.cnn.conv_filters = [4, 8, 16]
    cfg.data.max_seq_length = 24
    cfg.inference.max_length = 20
    cfg.hardware.compute_dtype = dtype
    cfg.hardware.use_mesh = False
    cfg.hardware.compilation_cache_dir = ""
    cfg.hardware.pallas_chain = "interpret"
    return cfg


def _chain_models(memory, seed=1):
    """(JAX model with the chain in interpret mode, its variables, the port's
    model with ``hardware.pallas_chain`` on, the JAX config, the tokenizer)."""
    cfg = _jax_cfg(memory)
    jtok = JaxTokenizer(max_sequence_length=24)
    jtok.default_init()
    jmodel = jax_build_model(cfg, jtok.vocab_size)
    variables = jax.device_get(
        jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, 16, 64, 1)), jnp.zeros((2, 5), jnp.int32)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        """Every bias drawn, so that each bias add counts; the head scaled by
        16, so that memories and then decodes differ across canvases."""
        if str(path[-1].key) in ("bias", "b_ih_l0", "b_ih_l1", "b_hh_l0", "b_hh_l1"):
            return rng.normal(size=leaf.shape).astype(np.float32) * 0.1
        return leaf * 16 if "Dense_0" in (str(p.key) for p in path) else leaf

    variables = jax.tree_util.tree_map_with_path(draw, variables)
    tcfg = config_from_dict(cfg.to_dict())
    tcfg.hardware.pallas_chain = True
    tmodel = load_flax_params(build_model(tcfg, jtok.vocab_size, device="cpu"), variables)
    return jmodel, variables, tmodel, cfg, jtok


def _images(n, seed=0):
    """Canvases with random ink over a random width and white after it."""
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, size=(16, 64, 1), dtype=np.uint8) for _ in range(n)]
    for img in imgs:
        img[:, rng.integers(4, 65):] = 255
    return imgs


class _Count:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("memory", ["vector", "grid"])
def test_chain_encoder_matches_jax(memory, monkeypatch):
    jmodel, variables, tmodel, _, _ = _chain_models(memory)
    x = np.random.default_rng(2).normal(size=(2, 16, 64, 1)).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x), method=jmodel.encode))
    counted = _Count(convblock_cf)
    monkeypatch.setattr(enc_mod, "convblock_cf", counted)
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    _close(got, ref)
    assert counted.calls == 2  # blocks 1 and 2 went through the chain's block


def test_chain_gate_falls_back_like_jax(monkeypatch):
    """H or W not divisible by 2**n_blocks: the JAX gate takes the XLA path,
    and so does the port (conv2d + relu + max_pool2d after block 0)."""
    _, _, tmodel, _, _ = _chain_models("grid")
    counted = _Count(convblock_cf)
    monkeypatch.setattr(enc_mod, "convblock_cf", counted)
    with torch.no_grad():
        tmodel.encoder.features(torch.zeros(1, 16, 60, 1))
    assert counted.calls == 0
    with torch.no_grad():
        tmodel.encoder.features(torch.zeros(1, 16, 64, 1))
    assert counted.calls == 2


def test_head_layout_equals_jax_chain_head():
    """The port's flatten plus the bridge's row permutation is the JAX
    ``kperm`` product, and its grid permute is the JAX ``einsum``
    (``encoder.py:233-243``)."""
    rng = np.random.default_rng(8)
    B, C, H, W, E = 2, 16, 2, 8, 32
    x = rng.normal(size=(B, C, H, W)).astype(np.float32)
    for memory, rows in (("vector", H * W * C), ("grid", H * C)):
        _, variables, tmodel, _, _ = _chain_models(memory)
        kern = np.asarray(variables["params"]["encoder"]["Dense_0"]["kernel"])
        assert kern.shape == (rows, E)
        head = params_from_flax(variables, tmodel)["encoder.head.weight"]
        if memory == "vector":
            kperm = jnp.transpose(jnp.asarray(kern).reshape(H, W, C, E), (2, 0, 1, 3)).reshape(C * H * W, E)
            ref = np.asarray(jnp.dot(jnp.asarray(x).reshape(B, C * H * W), kperm))
            got = F.linear(torch.from_numpy(x).flatten(1), head).numpy()
        else:
            ref = np.asarray(jnp.einsum("bchw,hce->bwe", jnp.asarray(x), jnp.asarray(kern).reshape(H, C, E)))
            got = F.linear(torch.from_numpy(x).permute(0, 3, 2, 1).reshape(B, W, H * C), head).numpy()
        _close(got, ref)


@pytest.mark.parametrize("memory", ["vector", "grid"])
def test_predictor_ids_equal_jax_chain(memory):
    jmodel, variables, tmodel, cfg, jtok = _chain_models(memory, seed=3)
    jpred = JaxPredictor(cfg, jmodel, variables["params"], {}, jtok, batch_size=4)
    tcfg = config_from_dict(cfg.to_dict())
    tcfg.hardware.pallas_chain = True
    tpred = Predictor(tcfg, tmodel, LaTeXTokenizer.from_config(jtok.to_config()), batch_size=4, device="cpu")
    imgs = _images(6, seed=4)
    imgs[0] = np.full((16, 64, 1), 255, np.uint8)
    ref = jpred.predict_batch(imgs, return_ids=True)
    got = tpred.predict_batch(imgs, return_ids=True)
    assert got == ref
    assert len({tuple(r) for r in ref}) > 1  # the canvases give distinct decodes


@pytest.fixture(scope="module")
def chain_step():
    """The JAX step runs eagerly: under ``jax.jit`` the JAX chain's custom VJP
    fails on this JAX version (linearizing ``_xla_convblock_cf``'s
    ``reduce_window`` inside the traced backward)."""
    cfg = jax_config("vector", True)
    cfg.hardware.pallas_chain = "interpret"
    with jax.disable_jit():
        params0, grads, metrics, params1 = run_jax(cfg, 1)
    tcfg, state = port_state(cfg, params0)
    assert state.model.encoder.pallas_chain
    loss, _, _ = train_loss(state, tcfg, batches(1)[0], 0)
    names = [n for n, _ in state.model.named_parameters()]
    tgrads = torch.autograd.grad(loss, [p for _, p in state.model.named_parameters()])
    tmetrics = make_train_step(tcfg, 0)(state, batches(1)[0])
    return dict(grads=grads, metrics=metrics, params0=params0, params1=params1, state=state,
                loss=loss.item(), tgrads=dict(zip(names, tgrads)), tmetrics=tmetrics)


def test_chain_train_step_matches_jax(chain_step):
    """One f32 train step with the chain on both sides (JAX in interpret
    mode): loss, counts, gradient norm, every gradient and every parameter
    after the step, at test_torch_train.py's tolerances."""
    m, tm = chain_step["metrics"], chain_step["tmetrics"]
    np.testing.assert_allclose(chain_step["loss"], float(m["loss"]), rtol=1e-6)
    np.testing.assert_allclose(tm["loss"].item(), float(m["loss"]), rtol=1e-6)
    assert (tm["correct"].item(), tm["total"].item()) == (int(m["correct"]), int(m["total"]))
    np.testing.assert_allclose(tm["grad_norm"].item(), float(m["grad_norm"]), rtol=1e-5)
    model = chain_step["state"].model
    ref = params_from_flax({"params": chain_step["grads"]}, model)
    for name, g in chain_step["tgrads"].items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=GRAD_ATOL, rtol=0, err_msg=name)
    assert np.abs(chain_step["tgrads"]["encoder.convs.1.weight"].numpy()).max() > 0
    # parameters after the step: within PARAM_ATOL, except where the gradient
    # Adam sees (g clipped, plus the L2 term wd * p) is within float32 noise
    # of 0 (< 1e-5), where its first update, ~lr * g / |g|, may differ by up
    # to 2 lr
    after = params_from_flax({"params": chain_step["params1"]}, model)
    before = params_from_flax({"params": chain_step["params0"]}, model)
    opt = chain_step["state"].optimizer
    lr, wd = opt.adam.param_groups[0]["lr"], opt.adam.param_groups[0]["weight_decay"]
    scale = min(1.0, opt.clip_grad_norm / float(m["grad_norm"]))
    for name, p in model.named_parameters():
        noise = np.abs(scale * ref[name].numpy() + wd * before[name].numpy()) < 1e-5
        atol = np.where(noise, 2 * lr, PARAM_ATOL)
        assert np.all(np.abs(p.detach().numpy() - after[name].numpy()) <= atol), name


def test_forward_only_wrappers_raise_under_grad():
    x = torch.zeros(1, 4, 8, 8, requires_grad=True)
    w = torch.zeros(6, 4, 3, 3)
    with pytest.raises(RuntimeError):
        fused_convblock_cf(x, w, torch.zeros(6))
    with pytest.raises(RuntimeError):
        fused_conv_relu_pool(torch.zeros(1, 8, 8, 4, requires_grad=True), w)
    with pytest.raises(RuntimeError):
        conv1_lane_relu_pool(torch.zeros(1, 8, 8, 1), torch.zeros(6, 1, 3, 3, requires_grad=True))
    with torch.no_grad():
        assert fused_convblock_cf(x, w, torch.zeros(6)).shape == (1, 6, 4, 4)
    assert convblock_cf.launches == 0  # CPU tensors launch nothing

"""The port's train step against the JAX package's, on the CPU.

The same flax weights (mapped by img2latex_tpu_torch.bridge) and the same
uint8 batches (img2latex_tpu_torch.data.synthetic, equal to the JAX
package's) go through ``img2latex_tpu.training.steps.make_train_step`` and
the port's, in float32 with dropout 0: the JAX side with
``hardware.pallas_lstm=True`` (the Pallas LSTM in interpret mode, which
``build_model`` sets off the TPU) and with the scan path; then grid memory
(plain loops on both sides) and a bf16 step.  Compared: the loss, the
correct/total counts, the gradient norm, every gradient (the flax grads tree
mapped by the bridge) and every parameter after one step, and after three
steps with ``accumulation_steps=2``.  Also the losses, dropout and the
optimizer's pieces.

Tolerances: gradients within 1e-6 of 1e-1-sized values (float32 sums in
another order); parameters within 1e-5 after Adam's first steps, whose
update is ~lr * g / |g| and so moves by up to lr where a gradient is within
float32 noise of 0 (seen: 1.5e-6); the bf16 loss within 1e-2 (bf16 rounding
of every activation, with the same rounding points on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img2latex_tpu.config import Config as JaxConfig
from img2latex_tpu.models.seq2seq import build_model as jax_build_model
from img2latex_tpu.ops.losses import masked_accuracy as jax_masked_accuracy
from img2latex_tpu.ops.losses import smoothed_cross_entropy as jax_sce
from img2latex_tpu.ops.preprocess import normalize_images as jax_normalize
from img2latex_tpu.training import optim as jax_optim
from img2latex_tpu.training.steps import create_train_state as jax_create_state
from img2latex_tpu.training.steps import make_train_step as jax_make_step
from img2latex_tpu_torch.bridge import load_flax_params, params_from_flax
from img2latex_tpu_torch.config import config_from_dict
from img2latex_tpu_torch.data.synthetic import synthetic_batch
from img2latex_tpu_torch.models.lstm import dropout
from img2latex_tpu_torch.models.seq2seq import build_model
from img2latex_tpu_torch.ops import decode_step as ds
from img2latex_tpu_torch.ops.losses import masked_accuracy, smoothed_cross_entropy
from img2latex_tpu_torch.training import optim
from img2latex_tpu_torch.training.steps import create_train_state, make_train_step, train_loss

torch.set_num_threads(1)

H_IMG, W_IMG, V, E, L, B = 16, 64, 40, 16, 12, 4
GRAD_ATOL, PARAM_ATOL = 1e-6, 1e-5


def jax_config(memory="vector", pallas=True, accumulation=1, dtype="float32"):
    cfg = JaxConfig()
    cfg.model.embedding_dim = E
    cfg.model.decoder.hidden_dim = E if memory == "vector" else 24
    cfg.model.decoder.lstm_layers = 2
    cfg.model.decoder.dropout = 0.0
    cfg.model.encoder.cnn.img_height, cfg.model.encoder.cnn.img_width = H_IMG, W_IMG
    cfg.model.encoder.cnn.conv_filters = [4, 8, 8]
    cfg.model.memory = memory
    cfg.data.max_seq_length = L
    cfg.hardware.compute_dtype = dtype
    cfg.hardware.pallas_lstm = pallas
    cfg.training.accumulation_steps = accumulation
    return cfg


def batches(n):
    return [dict(zip(("images", "formulas"), synthetic_batch(B, (H_IMG, W_IMG, 1), L, V, seed=s)))
            for s in range(n)]


def run_jax(cfg, n_steps, with_grads=True):
    """(initial params, grads of step 1, metrics of step 1, params after n_steps)."""
    model = jax_build_model(cfg, V)
    tx = jax_optim.build_optimizer(cfg)
    state = jax_create_state(model, tx, cfg, jax.random.PRNGKey(0))
    params0 = jax.device_get(state.params)
    data = batches(n_steps)
    grads = None
    if with_grads:
        b0 = data[0]

        def loss_fn(p):
            logits = model.apply({"params": p}, jax_normalize(jnp.asarray(b0["images"])),
                                 jnp.asarray(b0["formulas"]), train=True,
                                 rngs={"dropout": jax.random.PRNGKey(1)})
            return jax_sce(logits, jnp.asarray(b0["formulas"])[:, 1:], 0, cfg.training.label_smoothing)

        grads = jax.device_get(jax.grad(loss_fn)(state.params))
    step = jax.jit(jax_make_step(model, tx, cfg, 0))
    metrics = None
    for b in data:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(1))
        metrics = metrics or jax.device_get(m)
    return params0, grads, metrics, jax.device_get(state.params)


def port_state(cfg, params0):
    tcfg = config_from_dict(cfg.to_dict())
    model = build_model(tcfg, V, device="cpu")
    load_flax_params(model, {"params": params0})
    return tcfg, create_train_state(model, optim.build_optimizer(tcfg, model), tcfg)


def assert_params(model, jax_params, atol=PARAM_ATOL):
    ref = params_from_flax({"params": jax_params}, model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=atol, rtol=0, err_msg=name)


@pytest.fixture(scope="module", params=[("vector", True), ("vector", False), ("grid", False)],
                ids=["vector-pallas", "vector-scan", "grid"])
def one_step(request):
    memory, pallas = request.param
    cfg = jax_config(memory, pallas)
    params0, grads, metrics, params1 = run_jax(cfg, 1)
    tcfg, state = port_state(cfg, params0)
    loss, _, _ = train_loss(state, tcfg, batches(1)[0], 0)
    tgrads = torch.autograd.grad(loss, [p for _, p in state.model.named_parameters()])
    names = [n for n, _ in state.model.named_parameters()]
    tmetrics = make_train_step(tcfg, 0)(state, batches(1)[0])
    return dict(grads=grads, metrics=metrics, params1=params1, state=state, loss=loss.item(),
                tgrads=dict(zip(names, tgrads)), tmetrics=tmetrics)


def test_step_loss_counts_and_grad_norm(one_step):
    m, tm = one_step["metrics"], one_step["tmetrics"]
    np.testing.assert_allclose(tm["loss"].item(), float(m["loss"]), rtol=1e-6)
    np.testing.assert_allclose(one_step["loss"], float(m["loss"]), rtol=1e-6)
    assert (tm["correct"].item(), tm["total"].item()) == (int(m["correct"]), int(m["total"]))
    np.testing.assert_allclose(tm["grad_norm"].item(), float(m["grad_norm"]), rtol=1e-5)


def test_step_every_gradient(one_step):
    ref = params_from_flax({"params": one_step["grads"]}, one_step["state"].model)
    assert set(ref) == set(one_step["tgrads"])
    for name, g in one_step["tgrads"].items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_step_every_parameter_after_one_step(one_step):
    assert one_step["state"].step == 1
    assert_params(one_step["state"].model, one_step["params1"])


def test_three_steps_with_accumulation():
    """accumulation_steps=2: the running mean of two micro-batch gradients is
    clipped and applied at step 2; step 3 accumulates and changes nothing."""
    cfg = jax_config("vector", True, accumulation=2)
    params0, _, _, params3 = run_jax(cfg, 3, with_grads=False)
    tcfg, state = port_state(cfg, params0)
    step = make_train_step(tcfg, 0)
    after = [[p.detach().clone() for p in state.model.parameters()]]
    for b in batches(3):
        step(state, b)
        after.append([p.detach().clone() for p in state.model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(after[0], after[1]))
    assert not all(torch.equal(a, b) for a, b in zip(after[1], after[2]))
    assert all(torch.equal(a, b) for a, b in zip(after[2], after[3]))
    assert_params(state.model, params3)


def test_bf16_step_loss():
    cfg = jax_config("vector", True, dtype="bfloat16")
    params0, _, metrics, _ = run_jax(cfg, 1, with_grads=False)
    tcfg, state = port_state(cfg, params0)
    m = make_train_step(tcfg, 0)(state, batches(1)[0])
    np.testing.assert_allclose(m["loss"].item(), float(metrics["loss"]), rtol=1e-2)
    np.testing.assert_allclose(m["grad_norm"].item(), float(metrics["grad_norm"]), rtol=5e-2)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("case", ["random", "all_pad_row", "all_pad_batch"])
def test_losses_match(smoothing, case):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(3, 5, V)).astype(np.float32) * 3
    targets = rng.integers(0, V, size=(3, 5)).astype(np.int32)
    targets[0, 3:] = 0
    if case == "all_pad_row":
        targets[1] = 0
    elif case == "all_pad_batch":
        targets[:] = 0
    ref = float(jax_sce(jnp.asarray(logits), jnp.asarray(targets), 0, smoothing))
    got = smoothed_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), 0, smoothing).item()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    if case == "all_pad_batch":
        assert got == 0.0
    jc, jt = jax_masked_accuracy(jnp.asarray(logits), jnp.asarray(targets), 0)
    tc, tt = masked_accuracy(torch.from_numpy(logits), torch.from_numpy(targets), 0)
    assert (tc.item(), tt.item()) == (int(jc), int(jt))


def test_loss_of_bf16_logits_is_taken_in_float32():
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3, V)).astype(np.float32))
    targets = torch.tensor([[4, 5, 0], [6, 0, 0]])
    got = smoothed_cross_entropy(logits.to(torch.bfloat16), targets, 0, 0.1)
    ref = smoothed_cross_entropy(logits.to(torch.bfloat16).float(), targets, 0, 0.1)
    assert got.dtype == torch.float32 and got.item() == ref.item()


# ---------------------------------------------------------------------------
# Dropout (masks are never compared with JAX's: threefry and torch's
# generators draw different streams from the same seed)
# ---------------------------------------------------------------------------


def test_dropout_keep_share_and_scale():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000) * 0.7
    y = dropout(x, 0.3, g)
    kept = y != 0
    n = x.numel()
    # binomial(n, 0.7): 5 standard deviations
    assert abs(kept.float().mean().item() - 0.7) <= 5 * np.sqrt(0.7 * 0.3 / n)
    np.testing.assert_allclose(y[kept].numpy(), 1.0, rtol=1e-6)
    xb = torch.full((1000,), 0.7, dtype=torch.bfloat16)
    yb = dropout(xb, 0.3, torch.Generator().manual_seed(1))
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb[yb != 0], (xb / 0.7)[yb != 0])
    assert dropout(x, 0.0, g) is x


def _dropout_step(seed):
    cfg = jax_config("vector", True)
    cfg.model.decoder.dropout = 0.3
    tcfg = config_from_dict(cfg.to_dict())
    model = build_model(tcfg, V, device="cpu", seed=3)
    state = create_train_state(model, optim.build_optimizer(tcfg, model), tcfg, seed=seed)
    m = make_train_step(tcfg, 0)(state, batches(1)[0])
    return m["loss"].item(), [p.detach().clone() for p in model.parameters()]


def test_dropout_step_follows_the_generator_seed():
    (l1, p1), (l2, p2), (l3, p3) = _dropout_step(5), _dropout_step(5), _dropout_step(6)
    assert l1 == l2 and all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert l1 != l3 and not all(torch.equal(a, b) for a, b in zip(p1, p3))


def test_eval_forward_applies_no_dropout():
    cfg = jax_config("vector", True)
    cfg.model.decoder.dropout = 0.5
    model = build_model(config_from_dict(cfg.to_dict()), V, device="cpu", seed=3)
    b = batches(1)[0]
    x = torch.from_numpy(b["images"]).float() / 255.0 * 2 - 1
    f = torch.from_numpy(b["formulas"]).long()
    with torch.no_grad():
        assert torch.equal(model(x, f), model(x, f))
        assert not torch.equal(model(x, f), model(x, f, train=True, generator=torch.Generator().manual_seed(0)))


# ---------------------------------------------------------------------------
# Optimizer and host-side LR control
# ---------------------------------------------------------------------------


def test_optimizer_clips_then_adds_l2_then_adam():
    """One step against the clip -> L2 -> Adam chain written out."""
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    g = rng.normal(size=(5, 3)).astype(np.float32) * 10  # norm above the clip
    lr, wd, clip = 1e-2, 0.1, 1.0
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optim.Optimizer([p], lr, weight_decay=wd, clip_grad_norm=clip)
    p.grad = torch.from_numpy(g.copy())
    opt.step()
    gc = g / np.linalg.norm(g) * clip
    gl2 = gc + wd * p0
    m, v = 0.1 * gl2, 0.001 * gl2 ** 2
    ref = p0 - lr * (m / 0.1) / (np.sqrt(v / 0.001) + 1e-8)
    np.testing.assert_allclose(p.detach().numpy(), ref, rtol=1e-5, atol=1e-7)
    assert p.grad is None


def test_optimizer_matches_optax_chain():
    cfg = jax_config()
    cfg.training.clip_grad_norm = 0.5
    tx = jax_optim.build_optimizer(cfg)
    rng = np.random.default_rng(3)
    params = {"a": jnp.asarray(rng.normal(size=(4, 3)).astype(np.float32))}
    st = tx.init(params)
    tp = torch.nn.Parameter(torch.from_numpy(np.asarray(params["a"]).copy()))
    opt = optim.Optimizer([tp], cfg.training.learning_rate, cfg.training.weight_decay, 0.5)
    for k in range(3):
        g = rng.normal(size=(4, 3)).astype(np.float32) * (3 - k)
        upd, st = tx.update({"a": jnp.asarray(g)}, st, params)
        params = jax.tree_util.tree_map(lambda x, u: x + u, params, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(params["a"]), atol=1e-6, rtol=0)


def test_plateau_and_early_stopping_match_jax():
    seq = [1.0, 0.9, 0.95, 0.91, 0.92, 0.93, 0.899, 0.9, 0.9, 0.9, 0.9, 0.5, 0.6, 0.6, 0.6]
    js, ts = jax_optim.PlateauScheduler(1e-3, factor=0.5, patience=2), optim.PlateauScheduler(1e-3, 0.5, 2)
    je, te = jax_optim.EarlyStopping(3), optim.EarlyStopping(3)
    for x in seq:
        assert ts.step(x) == js.step(x) and ts.lr == js.lr
        assert te.step(x) == je.step(x)
        assert ts.state_dict() == js.state_dict() and te.state_dict() == je.state_dict()
    restored = optim.PlateauScheduler(1.0)
    restored.load_state_dict(ts.state_dict())
    assert restored.state_dict() == ts.state_dict()


def test_set_learning_rate_edits_the_param_groups():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = optim.Optimizer([p], 1e-3)
    optim.set_learning_rate(opt, 2.5e-4)
    assert optim.get_learning_rate(opt) == 2.5e-4
    assert all(g["lr"] == 2.5e-4 for g in opt.adam.param_groups)
    p.grad = torch.ones(3)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), -2.5e-4, rtol=1e-5)


# ---------------------------------------------------------------------------
# Kernels without a backward
# ---------------------------------------------------------------------------


def test_kernel_without_backward_refuses_grad_on_the_cpu():
    """As differentiating a pallas_call without a VJP fails in JAX, a wrapper
    whose kernel has no backward raises when autograd would record it."""
    H = 8
    x1 = torch.zeros(2, H, requires_grad=True)
    args = (None, None, x1, torch.zeros(2, H), torch.zeros(H, 4 * H), torch.zeros(H, 4 * H),
            torch.zeros(4 * H), torch.zeros(2, H), torch.zeros(2, H))
    with pytest.raises(RuntimeError, match="no backward"):
        ds.lstm_layer_step(*args)
    with pytest.raises(RuntimeError, match="no backward"):
        ds.vocab_argmax_step(x1, torch.zeros(H, 128), torch.zeros(128), torch.zeros(2, dtype=torch.int32),
                             None, None, 0, 2, 0)
    with torch.no_grad():
        ds.lstm_layer_step(*args)
    ds.lstm_layer_step(None, None, x1.detach(), *args[3:])

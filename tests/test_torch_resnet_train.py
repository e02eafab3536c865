"""A ResNet-18 train step of the port against the JAX package's ``make_train_step``, on the CPU.

The same flax weights (``test_torch_resnet.jax_variables``: a seeded init
with its BatchNorm scales, biases and running statistics drawn away from 1,
0, 0 and 1), the same uint8 batch (1 channel, tiled to 3 by both steps as a
grayscale device cache is) and dropout 0, in float32, with and without
``model.encoder.resnet.freeze_backbone``.  Compared after one step:

* the loss and ``grad_norm`` (the global norm over every gradient, the
  frozen ones included): relative 1e-5; the correct and total counts equal;
* every parameter: within 2 lr everywhere, and within 1e-5 in all but 0.5%
  of the elements (Adam's first update is ``lr * g / |g|``, so a gradient
  that is float32 noise around 0 can move a parameter by up to lr either
  way); with the freeze mask the backbone outside layer4 bit-equal to before
  the step, and without it none of it;
* the running statistics (``batch_stats``): within 1e-5 of the largest
  magnitude of each buffer, and every buffer moved, the frozen layers' too.

Then two frozen-backbone steps with ``training.clip_grad_norm`` at 0.1,
below the batches' gradient norms (about 0.6-0.75), so that the clip acts in
both: the global-norm clip is taken over the trainable parameters only, as
``optax.multi_transform`` takes it.  Compared after each step: the loss and
``grad_norm``, relative 1e-5 after the first and 1e-4 after the second
(whose parameters already differ by float32 noise that Adam's first update
can blow up to lr); after both: every parameter within 2 lr a step, and
within 1e-5 in all but 0.5% of the elements, the frozen ones bit-equal;
the running statistics within 1e-4 of each buffer's largest magnitude.
The same two steps with the clip taken over all parameters, or with no
clip, must break the parameter rule: the test's power over the clip.

Also the freeze mask's labels (``optim.trainable_label``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img2latex_tpu.models.seq2seq import build_model as jax_build_model
from img2latex_tpu.training import optim as jax_optim
from img2latex_tpu.training.steps import create_train_state as jax_create_state
from img2latex_tpu.training.steps import make_train_step as jax_make_step
from img2latex_tpu_torch.bridge import load_flax_params, params_from_flax
from img2latex_tpu_torch.config import config_from_dict
from img2latex_tpu_torch.data.synthetic import synthetic_batch
from img2latex_tpu_torch.models.seq2seq import build_model
from img2latex_tpu_torch.training import optim
from img2latex_tpu_torch.training.steps import create_train_state, make_train_step
from test_torch_resnet import B, H_IMG, L, W_IMG, jax_config, jax_variables, stats_err

torch.set_num_threads(1)

LOSS_RTOL, STATS_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-5
PARAM_FAR_SHARE = 0.005
LR = 1e-3
CLIP_LOW = 0.1
STEP2_RTOL, STATS2_RTOL = 1e-4, 1e-4


def jax_reference(cfg, variables, batches):
    """The JAX ``make_train_step`` over ``batches`` (uint8 1-channel images,
    tiled to 3) from ``variables``: the parameters, ``batch_stats`` and each
    step's metrics."""
    jmodel = jax_build_model(cfg, 40)
    tx = jax_optim.build_optimizer(cfg)
    state = jax_create_state(jmodel, tx, cfg, jax.random.PRNGKey(0))
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    step = jax.jit(jax_make_step(jmodel, tx, cfg, 0))
    metrics = []
    for u8, formulas in batches:
        jbatch = {"images": jnp.asarray(np.repeat(u8, 3, axis=-1)), "formulas": jnp.asarray(formulas)}
        state, m = step(state, jbatch, jax.random.PRNGKey(1))
        metrics.append(m)
    return jax.device_get({"params": state.params, "batch_stats": state.batch_stats, "metrics": metrics})


class AllParamClip(optim.Optimizer):
    """The clip taken over every gradient, the frozen ones included (wrong)."""

    def _clip(self, grads):
        norm = optim.global_norm(grads + [p.grad for p in self.frozen if p.grad is not None])
        scale = min(1.0, self.clip_grad_norm / norm.item())
        for g in grads:
            g.mul_(scale)


class NoClip(optim.Optimizer):
    """No clip at all (wrong)."""

    def _clip(self, grads):
        pass


def port_steps(cfg, variables, batches, optimizer_class=None):
    """The port's ``make_train_step`` over ``batches`` from ``variables``:
    the model after them, its state before, and each step's metrics."""
    tcfg = config_from_dict(cfg.to_dict())
    model = load_flax_params(build_model(tcfg, 40, device="cpu"), variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = optim.build_optimizer(tcfg, model)
    if optimizer_class is not None:
        opt.__class__ = optimizer_class
    state = create_train_state(model, opt, tcfg)
    step = make_train_step(tcfg, 0)
    metrics = [step(state, {"images": u8, "formulas": formulas}) for u8, formulas in batches]
    return model, before, metrics


def param_verdict(model, ref, steps):
    """(largest difference, share of elements beyond PARAM_ATOL) against the
    JAX parameters, and whether both are inside the rule for ``steps`` steps."""
    expect = params_from_flax(ref, model)
    far, n, worst = 0, 0, 0.0
    for name, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - expect[name].numpy())
        worst = max(worst, float(d.max()))
        far += int((d > PARAM_ATOL).sum())
        n += d.size
    return worst, far / n, worst <= 2 * LR * steps * 1.01 and far <= PARAM_FAR_SHARE * n


@pytest.fixture(scope="module", params=[False, True], ids=["trainable", "frozen"])
def one_step(request):
    freeze = request.param
    cfg = jax_config("resnet18", "vector", freeze=freeze)
    variables = jax_variables(jax_build_model(cfg, 40), seed=5)
    batch = synthetic_batch(B, (H_IMG, W_IMG, 1), L, 40, seed=6)  # 1 channel: both steps tile it to 3
    ref = jax_reference(cfg, variables, [batch])
    ref["metrics"] = ref["metrics"][0]
    model, before, got = port_steps(cfg, variables, [batch])
    return freeze, model, before, got[0], ref


def test_train_step_loss_and_grad_norm(one_step):
    _, _, _, got, ref = one_step
    assert abs(got["loss"].item() - float(ref["metrics"]["loss"])) <= LOSS_RTOL * abs(float(ref["metrics"]["loss"]))
    gn, gn_ref = got["grad_norm"].item(), float(ref["metrics"]["grad_norm"])
    assert abs(gn - gn_ref) <= LOSS_RTOL * gn_ref
    assert (got["correct"].item(), got["total"].item()) == (int(ref["metrics"]["correct"]), int(ref["metrics"]["total"]))


def test_train_step_parameters(one_step):
    freeze, model, before, _, ref = one_step
    expect = params_from_flax(ref, model)
    far, n, frozen, moved = 0, 0, [], []
    for name, p in model.named_parameters():
        d = np.abs(p.detach().numpy() - expect[name].numpy())
        assert d.max() <= 2 * 1e-3 * 1.01, name
        far += int((d > PARAM_ATOL).sum())
        n += d.size
        if optim.trainable_label(name) == "freeze":
            (frozen if torch.equal(p, before[name]) else moved).append(name)
    assert far <= PARAM_FAR_SHARE * n, far / n
    if freeze:
        assert moved == [] and len(frozen) > 0
    else:
        assert frozen == []


def test_train_step_batch_stats(one_step):
    _, model, before, _, ref = one_step
    assert stats_err(model, ref["batch_stats"], ref["params"]) <= STATS_RTOL
    # every running buffer moved, the frozen layers' included
    assert all(not torch.equal(v, before[k]) for k, v in model.state_dict().items() if "running_" in k)


def test_freeze_mask_labels():
    model = build_model(config_from_dict(jax_config(freeze=True).to_dict()), 40, device="cpu")
    opt = optim.build_optimizer(config_from_dict(jax_config(freeze=True).to_dict()), model)
    names = {id(p): n for n, p in model.named_parameters()}
    frozen = {names[id(p)] for p in opt.frozen}
    assert frozen and all(n.startswith("encoder.backbone.") and ".layer4_" not in n for n in frozen)
    assert {names[id(p)] for p in opt.params} | frozen == set(names.values())
    assert not frozen & {names[id(p)] for p in opt.params}
    plain = optim.build_optimizer(config_from_dict(jax_config(freeze=False).to_dict()), model)
    assert plain.frozen == [] and len(plain.params) == len(names)




@pytest.fixture(scope="module")
def clipped_steps():
    cfg = jax_config("resnet18", "vector", freeze=True)
    cfg.training.clip_grad_norm = CLIP_LOW
    variables = jax_variables(jax_build_model(cfg, 40), seed=5)
    batches = [synthetic_batch(B, (H_IMG, W_IMG, 1), L, 40, seed=6 + i) for i in range(2)]
    return cfg, variables, batches, jax_reference(cfg, variables, batches)


def test_clipped_steps_metrics(clipped_steps):
    cfg, variables, batches, ref = clipped_steps
    _, _, got = port_steps(cfg, variables, batches)
    for i, (m, r) in enumerate(zip(got, ref["metrics"])):
        tol = LOSS_RTOL if i == 0 else STEP2_RTOL
        assert float(r["grad_norm"]) > CLIP_LOW  # the clip acts
        assert abs(m["loss"].item() - float(r["loss"])) <= tol * abs(float(r["loss"])), i
        assert abs(m["grad_norm"].item() - float(r["grad_norm"])) <= tol * float(r["grad_norm"]), i


def test_clipped_steps_parameters_and_stats(clipped_steps):
    cfg, variables, batches, ref = clipped_steps
    model, before, _ = port_steps(cfg, variables, batches)
    worst, far, ok = param_verdict(model, ref, len(batches))
    assert ok, (worst, far)
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]) == (optim.trainable_label(name) == "freeze"), name
    assert stats_err(model, ref["batch_stats"], ref["params"]) <= STATS2_RTOL


@pytest.mark.parametrize("wrong", [AllParamClip, NoClip], ids=["all_param_clip", "no_clip"])
def test_clipped_steps_reject_a_wrong_clip(clipped_steps, wrong):
    cfg, variables, batches, ref = clipped_steps
    model, _, _ = port_steps(cfg, variables, batches, optimizer_class=wrong)
    worst, far, ok = param_verdict(model, ref, len(batches))
    assert not ok, (worst, far)

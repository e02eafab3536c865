"""A JAX package checkpoint converted for the port, and ``Predictor.predict`` at batch 1.

A small flax model is written by the JAX package's ``save_checkpoint``
(Orbax), read back by its ``restore_checkpoint`` plus ``jax.device_get``,
converted by ``img2latex_tpu_torch.utils.checkpoint.convert_flax_checkpoint``
and loaded by the port's ``Predictor.from_checkpoint(..., device="cpu",
use_pallas_chain=True)``.  Its greedy ids equal those of the JAX
``Predictor.from_checkpoint(..., use_pallas_chain="interpret")`` in float32,
for vector and grid memory.  Also: ``predict(image)`` decodes at batch 1 and
equals ``predict_batch([image])[0]``; the precedence of ``use_pallas_chain``
and ``config_overrides``; what the conversion refuses.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img2latex_tpu.training.predictor import Predictor as JaxPredictor
from img2latex_tpu.utils.checkpoint import restore_checkpoint as jax_restore
from img2latex_tpu.utils.checkpoint import save_checkpoint as jax_save
from img2latex_tpu_torch.ops import conv_cf
from img2latex_tpu_torch.training.predictor import Predictor
from img2latex_tpu_torch.utils.checkpoint import convert_flax_checkpoint, restore_checkpoint
from test_torch_conv_chain import _chain_models, _images

torch.set_num_threads(1)

STEP = 7


def _write_jax_checkpoint(path, memory, seed):
    """The chain test's model (drawn biases, a scaled head), saved as the JAX
    trainer saves it: Orbax arrays, the config with the chain off."""
    _, variables, _, cfg, tok = _chain_models(memory, seed=seed)
    cfg.hardware.pallas_chain = False
    meta = {"epoch": 0, "step": STEP, "best_val_loss": 1.5, "config": cfg.to_dict(),
            "tokenizer_config": tok.to_config(), "metrics": {}}
    jax_save(path, {"params": variables["params"], "step": jnp.asarray(STEP)}, meta, step=STEP, is_best=True)


@pytest.fixture(scope="module", params=["vector", "grid"])
def converted(request, tmp_path_factory):
    memory = request.param
    root = tmp_path_factory.mktemp(f"ckpt_{memory}")
    jax_dir, port_dir = root / "jax", root / "port"
    _write_jax_checkpoint(jax_dir, memory, seed=5)
    state, meta = jax_restore(jax_dir)
    state = jax.device_get(state)
    step_dir = convert_flax_checkpoint(state["params"], meta, port_dir, step=int(meta["step"]),
                                       batch_stats=state.get("batch_stats"))
    return memory, jax_dir, port_dir, step_dir


def test_converted_ids_equal_jax_predictor(converted):
    memory, jax_dir, port_dir, step_dir = converted
    assert step_dir == port_dir.absolute() / f"step_{STEP}"
    assert json.loads((step_dir / "meta.json").read_text())["step"] == STEP
    jpred = JaxPredictor.from_checkpoint(str(jax_dir), batch_size=4, use_pallas_chain="interpret")
    tpred = Predictor.from_checkpoint(str(port_dir), batch_size=4, device="cpu", use_pallas_chain=True)
    assert tpred.model.encoder.pallas_chain and tpred.cfg.model.memory == memory
    imgs = _images(6, seed=6)
    ref = jpred.predict_batch(imgs, return_ids=True)
    assert tpred.predict_batch(imgs, return_ids=True) == ref
    assert tpred.predict_batch(imgs[:2]) == jpred.predict_batch(imgs[:2])


def test_converted_state_holds_the_model_only(converted):
    _, _, port_dir, _ = converted
    state, meta = restore_checkpoint(port_dir)
    assert set(state) == {"model", "step"} and state["step"] == STEP
    assert {"config", "tokenizer_config", "epoch", "best_val_loss"} <= set(meta)


def test_use_pallas_chain_then_config_overrides(converted):
    _, _, port_dir, _ = converted
    assert not Predictor.from_checkpoint(str(port_dir), device="cpu").model.encoder.pallas_chain
    pred = Predictor.from_checkpoint(str(port_dir), device="cpu", use_pallas_chain=True,
                                     config_overrides={"hardware.pallas_chain": False})
    assert not pred.model.encoder.pallas_chain and not pred.cfg.hardware.pallas_chain


def test_conversion_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError):
        convert_flax_checkpoint({}, {"config": {}, "tokenizer_config": {}}, tmp_path, 1,
                                batch_stats={"bn": {"mean": np.zeros(2)}})
    with pytest.raises(ValueError):
        convert_flax_checkpoint({}, {"config": {}}, tmp_path, 1)


def test_predict_decodes_at_batch_one(converted, monkeypatch):
    _, _, port_dir, _ = converted
    pred = Predictor.from_checkpoint(str(port_dir), batch_size=4, device="cpu", use_pallas_chain=True)
    seen = []
    decode = pred.decode_canvases

    def spy(canvases, **kw):
        seen.append(canvases.shape[0])
        return decode(canvases, **kw)

    monkeypatch.setattr(pred, "decode_canvases", spy)
    counted, plain = [], conv_cf.convblock_cf_plain
    monkeypatch.setattr(conv_cf, "convblock_cf_plain", lambda *a: counted.append(1) or plain(*a))
    img = _images(1, seed=9)[0]
    one = pred.predict(img)
    assert seen == [1] and counted  # one canvas, through the chain's block
    assert one == pred.predict_batch([img])[0]
    assert seen[1:] == [4]

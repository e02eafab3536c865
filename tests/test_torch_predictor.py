"""The port's Predictor end to end against the JAX package's Predictor.

Both are built from the same flax weights at small shapes and decode the
same uint8 canvases greedily in float32 on the CPU: token ids and LaTeX must
be equal, also for a batch that is not a multiple of ``batch_size``.  Also:
the port's entry points raise without a card unless ``device="cpu"`` is
named.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img2latex_tpu.config import Config as JaxConfig
from img2latex_tpu.data.tokenizer import LaTeXTokenizer as JaxTokenizer
from img2latex_tpu.models.seq2seq import build_model as jax_build_model
from img2latex_tpu.training.predictor import Predictor as JaxPredictor
from img2latex_tpu_torch.bridge import load_flax_params
from img2latex_tpu_torch.config import config_from_dict
from img2latex_tpu_torch.data.tokenizer import LaTeXTokenizer
from img2latex_tpu_torch.models.seq2seq import build_model
from img2latex_tpu_torch.training.predictor import Predictor

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    cfg = JaxConfig()
    cfg.model.embedding_dim = 32
    cfg.model.decoder.hidden_dim = 32
    cfg.model.decoder.lstm_layers = 2
    cfg.model.decoder.dropout = 0.0
    cfg.model.encoder.cnn.img_height = 16
    cfg.model.encoder.cnn.img_width = 64
    cfg.model.encoder.cnn.conv_filters = [4, 8, 8]
    cfg.data.max_seq_length = 24
    cfg.inference.max_length = 20
    cfg.hardware.compute_dtype = "float32"
    cfg.hardware.use_mesh = False
    jtok = JaxTokenizer(max_sequence_length=24)
    jtok.default_init()
    jmodel = jax_build_model(cfg, jtok.vocab_size)
    variables = jax.device_get(
        jmodel.init(jax.random.PRNGKey(1), jnp.zeros((2, 16, 64, 1)), jnp.zeros((2, 5), jnp.int32))
    )
    jpred = JaxPredictor(cfg, jmodel, variables["params"], {}, jtok, batch_size=4)
    tcfg = config_from_dict(cfg.to_dict())
    tok = LaTeXTokenizer.from_config(jtok.to_config())
    tmodel = load_flax_params(build_model(tcfg, tok.vocab_size, device="cpu"), variables)
    tpred = Predictor(tcfg, tmodel, tok, batch_size=4, device="cpu")
    return jpred, tpred


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, size=(16, 64, 1), dtype=np.uint8) for _ in range(n)]
    imgs[0] = np.full((16, 64), 255, np.uint8)  # HW input, all white
    return imgs


@pytest.mark.parametrize("n", [4, 7])
def test_ids_equal_jax_predictor(pair, n):
    jpred, tpred = pair
    imgs = _images(n, seed=n)
    ref = jpred.predict_batch(imgs, return_ids=True)
    got = tpred.predict_batch(imgs, return_ids=True)
    assert len(got) == n
    assert got == ref


def test_latex_equals_jax_predictor(pair):
    jpred, tpred = pair
    imgs = _images(5, seed=11)
    assert tpred.predict_batch(imgs) == jpred.predict_batch(imgs)
    assert tpred.predict(imgs[1]) == jpred.predict(imgs[1])


def test_tokens_end_then_pad(pair):
    _, tpred = pair
    canv = np.random.default_rng(3).integers(0, 256, size=(4, 16, 64, 1), dtype=np.uint8)
    toks = tpred.decode_canvases(canv)
    assert toks.shape == (4, 20) and toks.dtype == np.int32
    is_end = toks == 2
    after = np.cumsum(is_end, axis=1) - is_end > 0
    assert (toks[after] == 0).all()


def test_beam_and_sampling_not_ported(pair):
    _, tpred = pair
    tpred.cfg.inference.beam_size = 3
    try:
        with pytest.raises(NotImplementedError):
            tpred.predict_batch(_images(1))
    finally:
        tpred.cfg.inference.beam_size = 0


def test_no_card_and_no_cpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_from_dict({"model": {"embedding_dim": 16, "decoder": {"hidden_dim": 16},
                                      "encoder": {"cnn": {"img_height": 8, "img_width": 16,
                                                          "conv_filters": [2, 2]}}},
                            "hardware": {"compute_dtype": "float32"}})
    tok = LaTeXTokenizer()
    tok.default_init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg, tok.vocab_size)
    model = build_model(cfg, tok.vocab_size, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(cfg, model, tok)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(cfg, model, tok, device="cuda")


def test_grid_memory_not_ported():
    cfg = config_from_dict({"model": {"memory": "grid"}})
    with pytest.raises(NotImplementedError):
        build_model(cfg, 10, device="cpu")

"""The port's model, bridge and decode kernels' plain versions against the JAX package.

Same weights (a flax Seq2SeqModel initialised at small shapes, mapped by
img2latex_tpu_torch.bridge) and the same inputs (numpy, seeded) go through
both packages on the CPU in float32.  Pallas kernels run in interpret mode,
as the JAX package's own tests run them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img2latex_tpu.config import Config as JaxConfig
from img2latex_tpu.decoding.decode import DecodeConfig as JaxDecodeConfig
from img2latex_tpu.decoding.decode import greedy_sample_decode
from img2latex_tpu.models.seq2seq import Seq2SeqModel as JaxSeq2Seq
from img2latex_tpu.models.seq2seq import build_model as jax_build_model
from img2latex_tpu.models.seq2seq import init_decoder_carry
from img2latex_tpu.ops.pallas.decode_step import fused_decode_step
from img2latex_tpu.ops.pallas.decode_step import pack_decoder_weights as jax_pack
from img2latex_tpu.ops.pallas.decode_step import pallas_full_greedy_decode
from img2latex_tpu.ops.preprocess import normalize_images as jax_normalize
from img2latex_tpu_torch.bridge import load_flax_params, params_from_flax
from img2latex_tpu_torch.config import config_from_dict
from img2latex_tpu_torch.decoding.decode import DecodeConfig, greedy_decode_eager
from img2latex_tpu_torch.models.seq2seq import build_model
from img2latex_tpu_torch.ops import decode_step as ds
from img2latex_tpu_torch.ops.preprocess import normalize_images

torch.set_num_threads(1)

H_IMG, W_IMG, V, E, T = 16, 64, 40, 32, 20


def small_jax_config():
    cfg = JaxConfig()
    cfg.model.embedding_dim = E
    cfg.model.decoder.hidden_dim = E
    cfg.model.decoder.lstm_layers = 2
    cfg.model.decoder.dropout = 0.0
    cfg.model.encoder.cnn.img_height = H_IMG
    cfg.model.encoder.cnn.img_width = W_IMG
    cfg.model.encoder.cnn.conv_filters = [4, 8, 8]
    cfg.hardware.compute_dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def models():
    cfg = small_jax_config()
    jmodel = jax_build_model(cfg, V)
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, H_IMG, W_IMG, 1)), jnp.zeros((2, 5), jnp.int32)
    )
    params = jax.device_get(params)
    tmodel = build_model(config_from_dict(cfg.to_dict()), V, device="cpu")
    load_flax_params(tmodel, params)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, size=(6, H_IMG, W_IMG, 1), dtype=np.uint8)
    jmem = jmodel.apply(params, jax_normalize(jnp.asarray(u8)), method=JaxSeq2Seq.encode)
    return cfg, jmodel, params, tmodel, u8, jmem


def _jax_greedy(jmodel, params, memory, B):
    def step_fn(tokens, carry):
        return jmodel.apply(params, memory, tokens, carry, method=JaxSeq2Seq.decode_step)

    dcfg = JaxDecodeConfig(max_length=T, start_id=1, end_id=2, pad_id=0)
    return np.asarray(greedy_sample_decode(step_fn, init_decoder_carry(2, B, E), B, dcfg))


class TestBridge:
    def test_every_leaf_loads(self, models):
        _, _, params, tmodel, _, _ = models
        sd = params_from_flax(params, tmodel)
        assert set(sd) == set(tmodel.state_dict())
        n_leaves = len(jax.tree_util.tree_leaves(params))
        assert n_leaves == len(sd)

    def test_conv_and_dense_layouts(self, models):
        _, _, params, tmodel, _, _ = models
        p = params["params"]
        np.testing.assert_array_equal(
            tmodel.encoder.convs[1].weight.detach().numpy(),
            np.transpose(p["encoder"]["Conv_1"]["kernel"], (3, 2, 0, 1)),
        )
        np.testing.assert_array_equal(
            tmodel.decoder.cell.out.weight.detach().numpy(), p["decoder"]["cell"]["out"]["kernel"].T
        )
        np.testing.assert_array_equal(
            tmodel.decoder.cell.lstm.weight_ih_l0.detach().numpy(),
            p["decoder"]["cell"]["lstm"]["W_ih_l0"].T,
        )

    @pytest.mark.parametrize("change", ["missing", "extra"])
    def test_missing_or_extra_leaf_raises(self, models, change):
        _, _, params, tmodel, _, _ = models
        tree = jax.tree_util.tree_map(np.asarray, params)
        cell = tree["params"]["decoder"]["cell"]
        if change == "missing":
            del cell["lstm"]["b_hh_l1"]
        else:
            cell["attention"] = {"v": {"kernel": np.zeros((E, 1), np.float32)}}
        with pytest.raises(KeyError):
            params_from_flax(tree, tmodel)


class TestModel:
    @pytest.mark.parametrize("channels", [1, 3])
    def test_normalize_matches(self, channels):
        u8 = np.random.default_rng(1).integers(0, 256, size=(2, 4, 6, channels), dtype=np.uint8)
        ref = np.asarray(jax_normalize(jnp.asarray(u8)))
        got = normalize_images(torch.from_numpy(u8)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)

    def test_encoder_memory_matches(self, models):
        _, _, _, tmodel, u8, jmem = models
        with torch.no_grad():
            mem = tmodel.encode(normalize_images(torch.from_numpy(u8)))
        assert tuple(mem.shape) == (6, 1, E)
        np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), atol=1e-5)

    def test_teacher_forced_logits_match(self, models):
        _, jmodel, params, tmodel, u8, _ = models
        tgt = np.random.default_rng(2).integers(0, V, size=(6, 9)).astype(np.int32)
        ref = np.asarray(jmodel.apply(params, jax_normalize(jnp.asarray(u8)), jnp.asarray(tgt)))
        with torch.no_grad():
            got = tmodel(normalize_images(torch.from_numpy(u8)), torch.from_numpy(tgt)).numpy()
        assert got.shape == (6, 8, V)
        np.testing.assert_allclose(got, ref, atol=1e-4)

    def test_decode_step_matches(self, models):
        _, jmodel, params, tmodel, _, jmem = models
        rng = np.random.default_rng(3)
        tok = rng.integers(0, V, size=6).astype(np.int32)
        h = rng.uniform(-1, 1, (2, 6, E)).astype(np.float32)
        c = rng.uniform(-1, 1, (2, 6, E)).astype(np.float32)
        ref_logits, (ref_h, ref_c) = jmodel.apply(
            params, jmem, jnp.asarray(tok), (jnp.asarray(h), jnp.asarray(c)),
            method=JaxSeq2Seq.decode_step,
        )
        with torch.no_grad():
            logits, (th, tc) = tmodel.decode_step(
                torch.from_numpy(np.array(jmem)), torch.from_numpy(tok),
                (torch.from_numpy(h), torch.from_numpy(c)),
            )
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-5)
        np.testing.assert_allclose(th.numpy(), np.asarray(ref_h), atol=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(ref_c), atol=1e-5)

    def test_lstm_step_equals_sequence(self, models):
        _, _, _, tmodel, _, _ = models
        lstm = tmodel.decoder.cell.lstm
        xs = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 5, 2 * E)).astype(np.float32))
        with torch.no_grad():
            ys, (hT, cT) = lstm(xs)
            carry = lstm.init_carry(3)
            steps = []
            for t in range(5):
                y, carry = lstm.step(xs[:, t], carry)
                steps.append(y)
        torch.testing.assert_close(torch.stack(steps, 1), ys, atol=1e-6, rtol=0)
        torch.testing.assert_close(carry[0], hT, atol=1e-6, rtol=0)
        torch.testing.assert_close(carry[1], cT, atol=1e-6, rtol=0)


class TestGreedyDecode:
    def test_pack_pads_vocab(self, models):
        _, _, _, tmodel, _, _ = models
        packed = ds.pack_decoder_weights(tmodel.decoder, torch.float32)
        assert packed["vocab"] == V and packed["vocab_padded"] == 128
        assert tuple(packed["emb"].shape) == (128, E)
        assert tuple(packed["w_out"].shape) == (E, 128)
        assert tuple(packed["w_ih_0"].shape) == (2 * E, 4 * E)
        assert float(packed["b_out"][V:].max()) < -1e29
        assert float(packed["w_out"][:, V:].abs().max()) == 0.0

    def test_pack_matches_jax_pack(self, models):
        _, _, params, tmodel, _, _ = models
        ref = jax_pack(params, V, dtype=jnp.float32)
        got = ds.pack_decoder_weights(tmodel.decoder, torch.float32)
        for key in ["emb", "w_out", "b_out", "w_ih_0", "w_hh_0", "b_0", "w_ih_1", "w_hh_1", "b_1"]:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), atol=1e-7, err_msg=key)

    def test_plain_decode_equals_pallas_and_scan(self, models):
        _, jmodel, params, tmodel, _, jmem = models
        packed_j = jax_pack(params, V, dtype=jnp.float32)
        ref_kernel = np.asarray(
            pallas_full_greedy_decode(packed_j, jmem[:, 0, :], T, 1, 2, 0, interpret=True)
        )
        ref_scan = _jax_greedy(jmodel, params, jmem, 6)
        packed = ds.pack_decoder_weights(tmodel.decoder, torch.float32)
        ctx = torch.from_numpy(np.array(jmem)[:, 0, :])
        got = ds.greedy_decode(packed, ctx, T, 1, 2, 0).numpy()
        plain = ds.greedy_decode_plain(packed, ctx, T, 1, 2, 0).numpy()
        assert got.dtype == np.int32 and got.shape == (6, T)
        np.testing.assert_array_equal(got, ref_kernel)
        np.testing.assert_array_equal(got, ref_scan)
        np.testing.assert_array_equal(plain, got)

    def test_end_then_pad(self, models):
        """A context that makes END the argmax at once: END, then PAD to the end."""
        _, _, _, tmodel, _, _ = models
        packed = ds.pack_decoder_weights(tmodel.decoder, torch.float32)
        packed["b_out"] = packed["b_out"].clone()
        packed["b_out"][2] = 1e6
        out = ds.greedy_decode(packed, torch.zeros(3, E), T, 1, 2, 0).numpy()
        assert (out[:, 0] == 2).all() and (out[:, 1:] == 0).all()

    def test_eager_oracle_equals_scan(self, models):
        _, jmodel, params, tmodel, _, jmem = models
        ref = _jax_greedy(jmodel, params, jmem, 6)
        memory = torch.from_numpy(np.array(jmem))

        def step_fn(tokens, carry):
            return tmodel.decode_step(memory, tokens, carry)

        dcfg = DecodeConfig(max_length=T, start_id=1, end_id=2, pad_id=0)
        got = greedy_decode_eager(step_fn, tmodel.init_carry(6), 6, dcfg).numpy()
        np.testing.assert_array_equal(got, ref)

    def test_decode_step_equals_fused_step(self, models):
        _, _, params, tmodel, _, jmem = models
        rng = np.random.default_rng(5)
        tok = rng.integers(0, V, size=6).astype(np.int32)
        h = rng.uniform(-1, 1, (2, 6, E)).astype(np.float32)
        c = rng.uniform(-1, 1, (2, 6, E)).astype(np.float32)
        step = fused_decode_step(jax_pack(params, V, dtype=jnp.float32), interpret=True)
        ref_tok, ref_h, ref_c = step(jnp.asarray(tok), jmem[:, 0, :], jnp.asarray(h), jnp.asarray(c))
        packed = ds.pack_decoder_weights(tmodel.decoder, torch.float32)
        ctx = torch.from_numpy(np.array(jmem)[:, 0, :])
        args = (packed, torch.from_numpy(tok), ctx, torch.from_numpy(h), torch.from_numpy(c))
        for fn in (ds.decode_step, ds.decode_step_plain):
            nxt, nh, nc = fn(*args)
            np.testing.assert_array_equal(nxt.numpy(), np.asarray(ref_tok))
            np.testing.assert_allclose(nh.numpy(), np.asarray(ref_h), atol=1e-5)
            np.testing.assert_allclose(nc.numpy(), np.asarray(ref_c), atol=1e-5)

    def test_cpu_wrappers_launch_nothing(self, models):
        _, _, _, tmodel, _, _ = models
        packed = ds.pack_decoder_weights(tmodel.decoder, torch.float32)
        before = (ds.lstm_layer_step.launches, ds.vocab_argmax_step.launches)
        ds.greedy_decode(packed, torch.zeros(2, E), 3, 1, 2, 0)
        assert (ds.lstm_layer_step.launches, ds.vocab_argmax_step.launches) == before

    def test_unsupported_device_raises(self, models):
        _, _, _, tmodel, _, _ = models
        packed = ds.pack_decoder_weights(tmodel.decoder, torch.float32)
        meta = {k: v.to("meta") if isinstance(v, torch.Tensor) else v for k, v in packed.items()}
        with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
            ds.greedy_decode(meta, torch.zeros(2, E, device="meta"), 3, 1, 2, 0)

"""The port's grid-memory slice against the JAX package, on the CPU in float32.

A flax grid ``Seq2SeqModel`` (additive attention, E != H) initialised at
small shapes is mapped into the port by ``img2latex_tpu_torch.bridge``; the
same uint8 canvases (numpy, seeded) go through both packages.  Pallas
kernels run in interpret mode, as the JAX package's own tests run them.
Also: early exit and the four per-row score signals of both greedy decodes
(vector and grid memory) against the JAX whole-decode kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img2latex_tpu.config import Config as JaxConfig
from img2latex_tpu.decoding.decode import DecodeConfig as JaxDecodeConfig
from img2latex_tpu.decoding.decode import greedy_sample_decode
from img2latex_tpu.decoding.decode import signal_alpha as jax_signal_alpha
from img2latex_tpu.models.seq2seq import Seq2SeqModel as JaxSeq2Seq
from img2latex_tpu.models.seq2seq import build_model as jax_build_model
from img2latex_tpu.models.seq2seq import init_decoder_carry
from img2latex_tpu.ops.pallas.decode_step import pack_decoder_weights as jax_pack
from img2latex_tpu.ops.pallas.decode_step import pallas_full_greedy_decode
from img2latex_tpu.ops.pallas.grid_decode import pack_attention_weights as jax_pack_att
from img2latex_tpu.ops.pallas.grid_decode import pallas_full_grid_greedy_decode
from img2latex_tpu.ops.preprocess import normalize_images as jax_normalize
from img2latex_tpu_torch.bridge import load_flax_params, params_from_flax
from img2latex_tpu_torch.config import config_from_dict
from img2latex_tpu_torch.decoding.decode import (
    DecodeConfig,
    greedy_decode_eager,
    parse_signal,
    signal_alpha,
)
from img2latex_tpu_torch.models.seq2seq import build_model
from img2latex_tpu_torch.ops import decode_step as ds
from img2latex_tpu_torch.ops import grid_decode as gd
from img2latex_tpu_torch.ops.preprocess import normalize_images

torch.set_num_threads(1)

H_IMG, W_IMG, E, H, V, T, B = 32, 64, 64, 96, 50, 20, 8
SIGNALS = ["logp", "margin", "entropy", "margin_logp:0.5"]
SCORE_ATOL = 1e-4  # float32 sums of 20 per-step signals, taken in another order


def grid_jax_config():
    cfg = JaxConfig()
    cfg.model.memory = "grid"
    cfg.model.embedding_dim = E
    cfg.model.decoder.hidden_dim = H  # != E: non-square attention
    cfg.model.decoder.lstm_layers = 2
    cfg.model.decoder.dropout = 0.0
    cfg.model.encoder.cnn.img_height = H_IMG
    cfg.model.encoder.cnn.img_width = W_IMG
    cfg.model.encoder.cnn.conv_filters = [4, 8]
    cfg.hardware.compute_dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def grid():
    cfg = grid_jax_config()
    jmodel = jax_build_model(cfg, V)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, H_IMG, W_IMG, 1)), jnp.zeros((2, 5), jnp.int32)))
    tmodel = load_flax_params(build_model(config_from_dict(cfg.to_dict()), V, device="cpu"), params)
    u8 = np.random.default_rng(0).integers(0, 256, size=(B, H_IMG, W_IMG, 1), dtype=np.uint8)
    jmem = jmodel.apply(params, jax_normalize(jnp.asarray(u8)), method=JaxSeq2Seq.encode)
    tmem = torch.from_numpy(np.array(jmem))
    packed = ds.pack_decoder_weights(tmodel.decoder, torch.float32)
    att = gd.pack_attention_weights(tmodel.decoder, torch.float32)
    u = gd.grid_memory_proj(att, tmem)
    return dict(cfg=cfg, jmodel=jmodel, params=params, tmodel=tmodel, u8=u8, jmem=jmem, tmem=tmem,
                packed=packed, att=att, u=u, jpacked=jax_pack(params, V, dtype=jnp.float32),
                jatt=jax_pack_att(params, dtype=jnp.float32))


def _scan(g, early_exit=False, return_scores=False, signal="margin"):
    jmodel, params, jmem = g["jmodel"], g["params"], g["jmem"]
    mem_proj = jmodel.apply(params, jmem, method=JaxSeq2Seq.memory_proj)

    def step_fn(tokens, carry):
        return jmodel.apply(params, jmem, tokens, carry, mem_proj, method=JaxSeq2Seq.decode_step)

    dcfg = JaxDecodeConfig(max_length=T, start_id=1, end_id=2, pad_id=0, early_exit=early_exit,
                           selective_signal=signal)
    out = greedy_sample_decode(step_fn, init_decoder_carry(2, B, H), B, dcfg,
                               return_scores=return_scores)
    return jax.tree_util.tree_map(np.asarray, out)


def _jax_kernel(g, kind, **kw):
    if kind == "grid":
        out = pallas_full_grid_greedy_decode(g["jpacked"], g["jatt"], g["jmem"], T, 1, 2, 0,
                                             interpret=True, **kw)
    else:
        out = pallas_full_greedy_decode(g["jpacked"], g["jmem"][:, 0, :], T, 1, 2, 0,
                                        interpret=True, **kw)
    return jax.tree_util.tree_map(np.asarray, out)


def _port(g, kind, fn="plain", **kw):
    if kind == "grid":
        f = gd.grid_greedy_decode_plain if fn == "plain" else gd.grid_greedy_decode
        out = f(g["packed"], g["att"], g["tmem"], g["u"], T, 1, 2, 0, **kw)
    else:
        f = ds.greedy_decode_plain if fn == "plain" else ds.greedy_decode
        out = f(g["packed"], g["tmem"][:, 0, :], T, 1, 2, 0, **kw)
    return tuple(x.numpy() for x in out) if isinstance(out, tuple) else out.numpy()


class TestGridModel:
    def test_every_leaf_loads(self, grid):
        sd = params_from_flax(grid["params"], grid["tmodel"])
        assert set(sd) == set(grid["tmodel"].state_dict())
        assert len(jax.tree_util.tree_leaves(grid["params"])) == len(sd)
        assert "decoder.cell.attention.attn.weight" in sd

    def test_grid_head_and_attention_layouts(self, grid):
        p = grid["params"]["params"]
        tm = grid["tmodel"]
        np.testing.assert_array_equal(tm.encoder.head.weight.detach().numpy(),
                                      p["encoder"]["Dense_0"]["kernel"].T)
        att = p["decoder"]["cell"]["attention"]
        np.testing.assert_array_equal(tm.decoder.cell.attention.attn.weight.detach().numpy(),
                                      att["attn"]["kernel"].T)
        np.testing.assert_array_equal(tm.decoder.cell.attention.v.weight.detach().numpy(),
                                      att["v"]["kernel"].T)

    def test_missing_attention_leaf_raises(self, grid):
        tree = jax.tree_util.tree_map(np.asarray, grid["params"])
        del tree["params"]["decoder"]["cell"]["attention"]["v"]
        with pytest.raises(KeyError):
            params_from_flax(tree, grid["tmodel"])

    def test_encoder_memory_matches(self, grid):
        with torch.no_grad():
            mem = grid["tmodel"].encode(normalize_images(torch.from_numpy(grid["u8"])))
        assert tuple(mem.shape) == (B, W_IMG // 4, E)
        np.testing.assert_allclose(mem.numpy(), np.asarray(grid["jmem"]), atol=1e-5)

    def test_memory_proj_matches(self, grid):
        ref = grid["jmodel"].apply(grid["params"], grid["jmem"], method=JaxSeq2Seq.memory_proj)
        with torch.no_grad():
            got = grid["tmodel"].memory_proj(grid["tmem"])
        assert tuple(got.shape) == (B, W_IMG // 4, H)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(grid["u"].numpy(), np.asarray(ref), atol=1e-5)

    def test_teacher_forced_logits_match(self, grid):
        tgt = np.random.default_rng(2).integers(0, V, size=(B, 9)).astype(np.int32)
        x = grid["u8"]
        ref = np.asarray(grid["jmodel"].apply(grid["params"], jax_normalize(jnp.asarray(x)),
                                              jnp.asarray(tgt)))
        with torch.no_grad():
            got = grid["tmodel"](normalize_images(torch.from_numpy(x)), torch.from_numpy(tgt)).numpy()
        assert got.shape == (B, 8, V)
        np.testing.assert_allclose(got, ref, atol=1e-4)

    def test_pack_attention_matches_jax(self, grid):
        for key in ("w_h", "w_m", "b"):
            np.testing.assert_array_equal(grid["att"][key].numpy(), np.asarray(grid["jatt"][key]))
        np.testing.assert_array_equal(grid["att"]["v"].numpy(), np.asarray(grid["jatt"]["v"])[0])

    def test_attend_step_plain_matches_attention(self, grid):
        rng = np.random.default_rng(4)
        h = rng.uniform(-1, 1, (B, H)).astype(np.float32)
        mem_proj = grid["jmodel"].apply(grid["params"], grid["jmem"], method=JaxSeq2Seq.memory_proj)

        def attend(module, h, memory, mp):
            return module.decoder.cell.attention(h, memory, mem_proj=mp)

        ref, _ = grid["jmodel"].apply(grid["params"], jnp.asarray(h), grid["jmem"], mem_proj,
                                      method=attend)
        att = grid["att"]
        ctx = torch.empty(B, E)
        for fn in (gd.attend_step_plain, gd.attend_step):
            got = fn(torch.from_numpy(h), att["w_h"], att["v"], grid["u"], grid["tmem"], ctx)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    def test_decode_step_with_mem_proj_matches(self, grid):
        rng = np.random.default_rng(5)
        tok = rng.integers(0, V, size=B).astype(np.int32)
        h = rng.uniform(-1, 1, (2, B, H)).astype(np.float32)
        c = rng.uniform(-1, 1, (2, B, H)).astype(np.float32)
        jm, params, jmem = grid["jmodel"], grid["params"], grid["jmem"]
        mp = jm.apply(params, jmem, method=JaxSeq2Seq.memory_proj)
        ref, (rh, rc) = jm.apply(params, jmem, jnp.asarray(tok), (jnp.asarray(h), jnp.asarray(c)),
                                 mp, method=JaxSeq2Seq.decode_step)
        with torch.no_grad():
            got, (th, tc) = grid["tmodel"].decode_step(
                grid["tmem"], torch.from_numpy(tok), (torch.from_numpy(h), torch.from_numpy(c)),
                mem_proj=grid["tmodel"].memory_proj(grid["tmem"]))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(th.numpy(), np.asarray(rh), atol=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(rc), atol=1e-5)


class TestGridDecode:
    def test_plain_equals_pallas_and_scan(self, grid):
        ref_kernel = _jax_kernel(grid, "grid")
        ref_scan = _scan(grid)
        got = _port(grid, "grid")
        assert got.dtype == np.int32 and got.shape == (B, T)
        np.testing.assert_array_equal(got, ref_kernel)
        np.testing.assert_array_equal(got, ref_scan)
        np.testing.assert_array_equal(_port(grid, "grid", fn="wrapper"), got)

    def test_eager_oracle_equals_scan(self, grid):
        tm, tmem = grid["tmodel"], grid["tmem"]
        mem_proj = tm.memory_proj(tmem)

        def step_fn(tokens, carry):
            return tm.decode_step(tmem, tokens, carry, mem_proj=mem_proj)

        dcfg = DecodeConfig(max_length=T, start_id=1, end_id=2, pad_id=0)
        got = greedy_decode_eager(step_fn, tm.init_carry(B), B, dcfg).numpy()
        np.testing.assert_array_equal(got, _scan(grid))

    @pytest.mark.parametrize("signal", SIGNALS)
    def test_eager_scores_equal_scan(self, grid, signal):
        tm, tmem = grid["tmodel"], grid["tmem"]
        mem_proj = tm.memory_proj(tmem)

        def step_fn(tokens, carry):
            return tm.decode_step(tmem, tokens, carry, mem_proj=mem_proj)

        dcfg = DecodeConfig(max_length=T, start_id=1, end_id=2, pad_id=0, selective_signal=signal)
        tokens, scores = greedy_decode_eager(step_fn, tm.init_carry(B), B, dcfg, return_scores=True)
        ref_tokens, ref_scores = _scan(grid, return_scores=True, signal=signal)
        np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
        np.testing.assert_allclose(scores.numpy(), ref_scores, atol=SCORE_ATOL)


@pytest.fixture(scope="module")
def ending(grid):
    """``grid`` with END's vocab column moved next to that of the token the
    decode repeats most (plus a random direction, its bias a little lower),
    so that rows end at different steps, well before T: what early exit
    needs to show.  Seeded; the same weights go to both packages."""
    g = dict(grid)
    params = jax.tree_util.tree_map(np.array, grid["params"])
    base = _port(grid, "vector")
    dom = int(np.bincount(base.ravel()).argmax())
    out = params["params"]["decoder"]["cell"]["out"]
    r = np.random.default_rng(3).normal(size=H).astype(np.float32)
    out["kernel"][:, 2] = out["kernel"][:, dom] + 4.0 * r / np.sqrt(H)
    out["bias"][2] = out["bias"][dom] - 0.09
    tmodel = load_flax_params(build_model(config_from_dict(grid["cfg"].to_dict()), V, device="cpu"),
                              params)
    g.update(params=params, tmodel=tmodel, jpacked=jax_pack(params, V, dtype=jnp.float32),
             packed=ds.pack_decoder_weights(tmodel.decoder, torch.float32))
    return g


@pytest.mark.parametrize("kind", ["vector", "grid"])
class TestEarlyExitAndScores:
    def test_rows_end_early(self, ending, kind):
        out = _port(ending, kind)
        ends = (out == 2).argmax(axis=1)
        assert (out == 2).any(axis=1).all() and ends.max() < T - ds.EARLY_EXIT_EVERY
        assert len(set(ends.tolist())) > 1

    def test_early_exit_equals_full_loop_and_jax(self, ending, kind, monkeypatch):
        full = _port(ending, kind)
        steps = []

        def counting(*args, **kw):
            steps.append(args[6])
            return ds.vocab_argmax_step_plain(*args, **kw)

        monkeypatch.setattr(ds, "vocab_argmax_step", counting)
        monkeypatch.setattr(gd, "vocab_argmax_step", counting)
        got = _port(ending, kind, fn="wrapper", early_exit=True)
        np.testing.assert_array_equal(got, full)
        np.testing.assert_array_equal(got, _jax_kernel(ending, kind, early_exit=True))
        last_end = int((full == 2).argmax(axis=1).max())
        assert len(steps) < T and last_end < len(steps) <= last_end + ds.EARLY_EXIT_EVERY

    @pytest.mark.parametrize("signal", SIGNALS)
    def test_scores_match_jax_kernel(self, ending, kind, signal):
        ref_tokens, ref_scores = _jax_kernel(ending, kind, return_scores=True, signal=signal)
        tokens, scores = _port(ending, kind, return_scores=True, signal=signal)
        np.testing.assert_array_equal(tokens, ref_tokens)
        assert scores.dtype == np.float32 and scores.shape == (B,)
        np.testing.assert_allclose(scores, ref_scores, atol=SCORE_ATOL)
        w_tokens, w_scores = _port(ending, kind, fn="wrapper", return_scores=True, signal=signal,
                                   early_exit=True)
        np.testing.assert_array_equal(w_tokens, tokens)
        np.testing.assert_allclose(w_scores, scores, atol=1e-6)


class TestSignals:
    @pytest.mark.parametrize("signal,alpha", [("margin_logp", 1.0), ("margin_logp:0.25", 0.25),
                                              ("margin_logp:-2", -2.0)])
    def test_signal_alpha_matches_jax(self, signal, alpha):
        assert signal_alpha(signal) == alpha == jax_signal_alpha(signal)
        assert parse_signal(signal) == ("margin_logp", alpha)

    @pytest.mark.parametrize("signal", ["margin_logpx", "margin_logp:nan", "margin_logp:inf", "logq"])
    def test_malformed_signal_raises(self, signal):
        with pytest.raises(ValueError):
            parse_signal(signal)

    def test_empty_alpha_diverges_from_jax(self):
        """The JAX package reads 'margin_logp:' as the default alpha; the port raises."""
        assert jax_signal_alpha("margin_logp:") == 1.0
        with pytest.raises(ValueError):
            signal_alpha("margin_logp:")

"""The port's beam search and selective beam against the JAX package, on the CPU in float32.

The search's pieces (``topk_iterative``, ``select_uncertain``,
``backtrack_and_select``) against the JAX functions on seeded numpy inputs
with exact ties; the eager ``beam_decode`` against the JAX scan
``beam_decode``; the kernels' plain versions (``beam_decode_plain``,
``grid_beam_decode_plain``) against ``pallas_full_beam_decode`` and
``pallas_full_grid_beam_decode`` in interpret mode; early exit; and
``Predictor.predict_batch`` with beam, a length penalty and selective beam
under each signal against the JAX ``Predictor``.  The decodes run on the
``ending`` model of ``tests/test_torch_grid.py`` (a grid model whose rows end
at different steps, its vector decode on ``memory[:, 0, :]``), so that END
absorption, frozen scores and early exit are exercised.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img2latex_tpu.config import config_from_dict as jax_config_from_dict
from img2latex_tpu.decoding.decode import DecodeConfig as JaxDecodeConfig
from img2latex_tpu.decoding.decode import backtrack_and_select as jax_backtrack
from img2latex_tpu.decoding.decode import beam_decode as jax_beam_decode
from img2latex_tpu.decoding.decode import select_uncertain as jax_select_uncertain
from img2latex_tpu.decoding.decode import topk_iterative as jax_topk_iterative
from img2latex_tpu.models.seq2seq import Seq2SeqModel as JaxSeq2Seq
from img2latex_tpu.models.seq2seq import init_decoder_carry
from img2latex_tpu.ops.pallas.beam_decode import pallas_full_beam_decode
from img2latex_tpu.ops.pallas.grid_decode import pallas_full_grid_beam_decode
from img2latex_tpu_torch.config import Config, config_from_dict
from img2latex_tpu_torch.decoding.decode import (
    DecodeConfig,
    backtrack_and_select,
    beam_decode,
    select_uncertain,
    topk_iterative,
)
from img2latex_tpu_torch.ops import beam_decode as bd
from img2latex_tpu_torch.ops import grid_decode as gd
from test_torch_grid import B, T, _port, ending, grid  # noqa: F401  (shared module fixtures)
from test_torch_predictor import _images, _pair

torch.set_num_threads(1)

KINDS = ["vector", "grid"]
SIGNALS = ["logp", "margin", "entropy", "margin_logp:0.5"]
SCORE_ATOL = 1e-5  # float32 sums of up to 20 log-probabilities, in another order


def _cfgs(K, length_penalty=0.0, early_exit=False):
    kw = dict(max_length=T, start_id=1, end_id=2, pad_id=0, beam_size=K,
              length_penalty=length_penalty)
    return DecodeConfig(early_exit=early_exit, **kw), JaxDecodeConfig(early_exit=early_exit, **kw)


def _memory(g, kind):
    """The kind's memory: the grid, or its first slot (attention over one
    slot is the constant context of the vector decode)."""
    return (g["jmem"], g["tmem"]) if kind == "grid" else (g["jmem"][:, :1], g["tmem"][:, :1])


def _jax_scan(g, kind, K, jcfg):
    jm, params = g["jmodel"], g["params"]
    jmem = jnp.repeat(_memory(g, kind)[0], K, axis=0)
    mem_proj = jm.apply(params, jmem, method=JaxSeq2Seq.memory_proj)

    def step_fn(tokens, carry):
        return jm.apply(params, jmem, tokens, carry, mem_proj, method=JaxSeq2Seq.decode_step)

    out = jax_beam_decode(step_fn, init_decoder_carry(2, B * K, g["tmodel"].decoder.hidden_dim),
                          B, K, jcfg)
    return tuple(np.asarray(x) for x in out)


def _jax_kernel(g, kind, K, jcfg, **kw):
    if kind == "grid":
        out = pallas_full_grid_beam_decode(g["jpacked"], g["jatt"], g["jmem"], K, jcfg,
                                           interpret=True, **kw)
    else:
        out = pallas_full_beam_decode(g["jpacked"], g["jmem"][:, 0, :], K, jcfg, interpret=True, **kw)
    return tuple(np.asarray(x) for x in out)


def _port_beam(g, kind, K, cfg, fn="plain", **kw):
    if kind == "grid":
        f = gd.grid_beam_decode_plain if fn == "plain" else gd.grid_beam_decode
        out = f(g["packed"], g["att"], g["tmem"], g["u"], K, cfg, **kw)
    else:
        f = bd.beam_decode_plain if fn == "plain" else bd.beam_decode
        out = f(g["packed"], g["tmem"][:, 0, :], K, cfg, **kw)
    return tuple(x.numpy() for x in out)


class TestSearchPieces:
    @pytest.mark.parametrize("k", [1, 4, 9])
    def test_topk_iterative_matches_jax_with_ties(self, k):
        rng = np.random.default_rng(k)
        x = rng.integers(-3, 3, size=(5, 24)).astype(np.float32)  # many exact ties
        x[0] = 1.0  # one row all equal
        vals, idx = topk_iterative(torch.from_numpy(x), k)
        ref_vals, ref_idx = jax_topk_iterative(jnp.asarray(x), k)
        np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1]))
        np.testing.assert_array_equal(idx[0].numpy(), np.arange(k))

    @pytest.mark.parametrize("k", [1, 3, 6])
    def test_select_uncertain_matches_jax_with_ties(self, k):
        rng = np.random.default_rng(10 + k)
        tokens = rng.integers(3, 9, size=(8, 10)).astype(np.int32)
        lengths = rng.integers(0, 11, size=8)
        tokens[np.arange(10)[None, :] >= lengths[:, None]] = 0  # PAD tails, one may be all PAD
        scores = (-lengths * rng.integers(1, 3, size=8)).astype(np.float32)  # equal means
        got = select_uncertain(torch.from_numpy(tokens), torch.from_numpy(scores), k, 0)
        ref = jax_select_uncertain(jnp.asarray(tokens), jnp.asarray(scores), k, 0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("length_penalty", [0.0, 0.7])
    def test_backtrack_and_select_matches_jax(self, length_penalty):
        rng = np.random.default_rng(3)
        Tn, Bn, K = 9, 6, 4
        tok = rng.integers(0, 7, size=(Tn, Bn, K)).astype(np.int32)
        par = rng.integers(0, K, size=(Tn, Bn, K)).astype(np.int32)
        scores = rng.normal(size=(Bn, K)).astype(np.float32)
        scores[0] = scores[0, 0]  # a sample whose beams tie
        cfg, jcfg = _cfgs(K, length_penalty)
        got = backtrack_and_select(torch.from_numpy(tok), torch.from_numpy(par),
                                   torch.from_numpy(scores), cfg)
        ref = jax_backtrack(jnp.asarray(tok), jnp.asarray(par), jnp.asarray(scores), Bn, K, jcfg)
        assert got[0].dtype == torch.int32 and tuple(got[0].shape) == (Bn, Tn)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
class TestBeamDecode:
    def test_model_rows_end(self, ending, kind):
        """The decodes below end at different steps and differ from greedy."""
        tokens, _ = _port_beam(ending, kind, 3, _cfgs(3)[0])
        ends = (tokens == 2).argmax(axis=1)
        assert (tokens == 2).any(axis=1).all() and len(set(ends.tolist())) > 1
        assert (tokens != _port(ending, kind)).any()

    @pytest.mark.parametrize("K", [1, 3, 5])
    def test_eager_matches_jax_scan(self, ending, kind, K):
        cfg, jcfg = _cfgs(K)
        tm = ending["tmodel"]
        tmem = _memory(ending, kind)[1].repeat_interleave(K, dim=0)
        mem_proj = tm.memory_proj(tmem)

        def step_fn(tokens, carry):
            return tm.decode_step(tmem, tokens, carry, mem_proj=mem_proj)

        tokens, scores = beam_decode(step_fn, tm.init_carry(B * K), B, K, cfg)
        ref_tokens, ref_scores = _jax_scan(ending, kind, K, jcfg)
        np.testing.assert_array_equal(tokens.numpy(), ref_tokens)
        np.testing.assert_allclose(scores.numpy(), ref_scores, atol=SCORE_ATOL)

    @pytest.mark.parametrize("K,length_penalty", [(1, 0.0), (3, 0.7), (5, 0.0)])
    def test_plain_matches_pallas_kernel(self, ending, kind, K, length_penalty):
        cfg, jcfg = _cfgs(K, length_penalty)
        ref_tokens, ref_scores = _jax_kernel(ending, kind, K, jcfg)
        tokens, scores = _port_beam(ending, kind, K, cfg)
        assert tokens.dtype == np.int32 and tokens.shape == (B, T)
        assert scores.dtype == np.float32 and scores.shape == (B,)
        np.testing.assert_array_equal(tokens, ref_tokens)
        np.testing.assert_allclose(scores, ref_scores, atol=SCORE_ATOL)
        w_tokens, w_scores = _port_beam(ending, kind, K, cfg, fn="wrapper")
        np.testing.assert_array_equal(w_tokens, tokens)
        np.testing.assert_array_equal(w_scores, scores)

    def test_length_penalty_matches_scan(self, ending, kind):
        cfg, jcfg = _cfgs(4, 2.0)
        ref_tokens, ref_scores = _jax_scan(ending, kind, 4, jcfg)
        tokens, scores = _port_beam(ending, kind, 4, cfg)
        np.testing.assert_array_equal(tokens, ref_tokens)
        np.testing.assert_allclose(scores, ref_scores, atol=SCORE_ATOL)

    def test_early_exit_equals_full_loop_and_jax(self, ending, kind, monkeypatch):
        cfg, jcfg = _cfgs(3)
        full = _port_beam(ending, kind, 3, cfg)
        steps = []

        def counting(*args, **kw):
            steps.append(args[8])
            return bd.beam_step_plain(*args, **kw)

        monkeypatch.setattr(bd, "beam_step", counting)
        monkeypatch.setattr(gd, "beam_step", counting)
        early_cfg, early_jcfg = _cfgs(3, early_exit=True)
        got = _port_beam(ending, kind, 3, early_cfg, fn="wrapper")
        np.testing.assert_array_equal(got[0], full[0])
        np.testing.assert_array_equal(got[1], full[1])
        ref = _jax_kernel(ending, kind, 3, early_jcfg, early_exit=True)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], atol=SCORE_ATOL)
        plain = _port_beam(ending, kind, 3, early_cfg)
        np.testing.assert_array_equal(plain[0], full[0])
        assert 0 < len(steps) < T and len(steps) % bd.EARLY_EXIT_EVERY == 0

    def test_k1_equals_greedy(self, ending, kind):
        tokens, _ = _port_beam(ending, kind, 1, _cfgs(1)[0])
        np.testing.assert_array_equal(tokens, _port(ending, kind))

    def test_gaps(self, ending, kind):
        """The plain versions' trace (per-step histories, scores and gaps),
        and ``beam_divergence`` of two traces: none where they agree, and the
        step and gap of a history changed at one step."""
        cfg = _cfgs(3, length_penalty=0.7)[0]
        ref, got = {}, {}
        tokens, scores = _port_beam(ending, kind, 3, cfg, trace=ref)
        np.testing.assert_array_equal(tokens, _port_beam(ending, kind, 3, cfg)[0])
        _port_beam(ending, kind, 3, cfg, fn="wrapper", trace=got)
        assert ref["gaps"].shape == (B, T, 3) and ref["scores"].shape == (T, B, 3)
        assert ref["tok_hist"].shape == ref["par_hist"].shape == (T, B, 3)
        assert (ref["gaps"] >= 0).all() and (ref["choice_gap"] >= 0).all()
        assert "gaps" not in got
        div = bd.beam_divergence(got, ref)
        assert (div["first"] == T).all() and torch.isinf(div["gap"]).all()
        assert (div["drift"] == 0).all() and (div["step_err"] == 0).all()
        got["par_hist"] = got["par_hist"].clone()
        got["par_hist"][5, 1, 2] = (got["par_hist"][5, 1, 2] + 1) % 3
        got["scores"] = got["scores"].clone()
        got["scores"][3, 1] += 0.25
        got["scores"][6:, 0] += 1.0  # sample 0's histories agree: every step counts
        div = bd.beam_divergence(got, ref)
        assert div["first"][1] == 5 and (div["first"][[0] + list(range(2, B))] == T).all()
        assert div["drift"][1].item() == pytest.approx(0.25) and div["drift"][0].item() == pytest.approx(1.0)
        # a score changed at one step changes what that step and the next added
        assert div["step_err"][1].item() == pytest.approx(0.25) and div["step_err"][0].item() == pytest.approx(1.0)
        assert div["gap"][1] == ref["gaps"][1, 5].min() and torch.isinf(div["gap"][0])

    def test_beam_width_limit(self, ending, kind):
        """No width limit: K = 20 (beyond the 16 rows of a kernel block)
        gives the JAX beam kernel's tokens; K = 0 raises."""
        cfg, jcfg = _cfgs(20, length_penalty=0.7)
        ref_tokens, ref_scores = _jax_kernel(ending, kind, 20, jcfg)
        tokens, scores = _port_beam(ending, kind, 20, cfg, fn="wrapper")
        np.testing.assert_array_equal(tokens, ref_tokens)
        np.testing.assert_allclose(scores, ref_scores, atol=SCORE_ATOL)
        with pytest.raises(ValueError):
            _port_beam(ending, kind, 0, _cfgs(1)[0], fn="wrapper")


@pytest.fixture(scope="module")
def pair():
    return _pair(seed=5)  # a seed whose beam and greedy ids differ


@pytest.fixture(scope="module")
def grid_pair():
    return _pair("grid", seed=2)


def _both(pair, grid_pair, memory):
    return pair if memory == "vector" else grid_pair


@pytest.mark.parametrize("memory", KINDS)
@pytest.mark.parametrize("n", [4, 7])
def test_predictor_beam_ids_equal_jax(pair, grid_pair, memory, n):
    jpred, tpred = _both(pair, grid_pair, memory)
    imgs = _images(n, seed=50 + n)
    ref = jpred.predict_batch(imgs, beam_size=3, return_ids=True)
    assert tpred.predict_batch(imgs, beam_size=3, return_ids=True) == ref


@pytest.mark.parametrize("memory", KINDS)
def test_predictor_length_penalty_and_early_exit_equal_jax(pair, grid_pair, memory):
    jpred, tpred = _both(pair, grid_pair, memory)
    imgs = _images(7, seed=61)
    kw = dict(beam_size=4, length_penalty=0.7, return_ids=True)
    ref = jpred.predict_batch(imgs, **kw)
    assert tpred.predict_batch(imgs, **kw) == ref
    assert tpred.predict_batch(imgs, early_exit=True, **kw) == ref


@pytest.mark.parametrize("signal", SIGNALS)
@pytest.mark.parametrize("memory,n", [("vector", 7), ("grid", 4), ("grid", 7)])
def test_predictor_selective_ids_equal_jax(pair, grid_pair, memory, n, signal):
    jpred, tpred = _both(pair, grid_pair, memory)
    imgs = _images(n, seed=70 + n)
    jpred.cfg.inference.selective_signal = tpred.cfg.inference.selective_signal = signal
    try:
        kw = dict(beam_size=3, selective_beam_frac=0.5, return_ids=True)
        ref = jpred.predict_batch(imgs, **kw)
        assert tpred.predict_batch(imgs, **kw) == ref
    finally:
        jpred.cfg.inference.selective_signal = tpred.cfg.inference.selective_signal = "margin"


def test_predictor_selective_beams_the_least_confident_rows(grid_pair, monkeypatch):
    """frac 0.5 of a batch of 4 beam-decodes ceil(0.5 * 4) = 2 rows."""
    _, tpred = grid_pair
    from img2latex_tpu_torch.training import predictor as pm

    calls = []

    def spy(packed, att, memory, u, K, cfg):
        calls.append(memory.shape[0])
        return gd.grid_beam_decode(packed, att, memory, u, K, cfg)

    monkeypatch.setattr(pm, "grid_beam_decode", spy)
    tpred.predict_batch(_images(4, seed=3), beam_size=2, selective_beam_frac=0.5)
    tpred.predict_batch(_images(4, seed=3), beam_size=2, selective_beam_frac=1.0)
    assert calls == [math.ceil(0.5 * 4), 4]


class TestConfig:
    def test_fields_round_trip(self):
        d = Config().to_dict()
        d["inference"].update(length_penalty=2.0, selective_beam_frac=0.2,
                              selective_signal="margin_logp:0.5", beam_size=5)
        cfg = config_from_dict(d)
        assert (cfg.inference.length_penalty, cfg.inference.selective_beam_frac,
                cfg.inference.selective_signal) == (2.0, 0.2, "margin_logp:0.5")
        assert config_from_dict(cfg.to_dict()).to_dict() == cfg.to_dict()
        jcfg = jax_config_from_dict(cfg.to_dict())
        for name in ("beam_size", "length_penalty", "selective_beam_frac", "selective_signal"):
            assert getattr(jcfg.inference, name) == getattr(cfg.inference, name)

    def test_defaults_equal_jax(self):
        from img2latex_tpu.config import Config as JaxConfig

        j, t = JaxConfig().inference, Config().inference
        for name in ("length_penalty", "selective_beam_frac", "selective_signal"):
            assert getattr(t, name) == getattr(j, name)

    @pytest.mark.parametrize("signal", ["logp", "margin", "entropy", "margin_logp", "margin_logp:-2",
                                        "margin_logpx", "margin_logp:nan", "logq", "margin_logp:inf"])
    def test_signal_validated_like_jax(self, signal):
        d = {"inference": {"selective_signal": signal}}
        try:
            jax_config_from_dict(d)
            jax_ok = True
        except ValueError:
            jax_ok = False
        if jax_ok:
            assert config_from_dict(d).inference.selective_signal == signal
        else:
            with pytest.raises(ValueError, match="selective_signal"):
                config_from_dict(d)

    def test_empty_alpha_rejected_unlike_jax(self):
        d = {"inference": {"selective_signal": "margin_logp:"}}
        assert jax_config_from_dict(d).inference.selective_signal == "margin_logp:"
        with pytest.raises(ValueError, match="selective_signal"):
            config_from_dict(d)

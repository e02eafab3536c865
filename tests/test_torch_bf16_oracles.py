"""The port's bf16 plain versions against the JAX package's bf16 rounding points, on the CPU.

The plain versions are what the card's bf16 kernels are held to, so they
must round where the TPU kernels round:

* ``attend_step_plain`` in bf16 against ``grid_decode.py::_attend`` called
  on bf16 ``jnp`` arrays at the grid flagship's attention widths (S = 100,
  E = 256, A = H = 384), a few rows, one memory row a row and five (the
  memory repeated on the JAX side, as the beam kernel sees it);
* the greedy decodes through ``vocab_argmax_step_plain`` (and, for grid
  memory, ``attend_step_plain``) in bf16 with each score signal, against the
  JAX whole-decode kernels in interpret mode at a small size (the shared
  ``ending`` fixture of ``test_torch_grid.py``);
* the beam decodes (``beam_decode_plain``, ``grid_beam_decode_plain``, K = 4,
  length penalty 0.7, 5 steps) and the sampling decodes (``sample_decode_plain``,
  ``grid_sample_decode_plain``, temperature 0.8 with top-k 10 and top-p 0.9,
  and top-p 0.9 alone, tiles of 4 rows) in bf16 against
  ``pallas_full_beam_decode``, ``pallas_full_grid_beam_decode``,
  ``pallas_full_sample_decode`` and ``pallas_full_grid_sample_decode`` in
  interpret mode on the same model: the plain versions the card's bf16 beam
  and sampling kernels are held to.

Inputs come from numpy seeds and are rounded to bf16 the same way on both
sides.  Tolerances: the context within 2 bf16 rounding steps of |ctx| (a
weight or product that rounds the other way, then ctx's own rounding;
``chip_smoke.py``'s ``ATTEND_BF16_RTOL``); a row's tokens equal, except that
a row may part at a step whose top-2 logit margin in the port is at most
2e-3 (``chip_smoke.py``'s bf16 ``MARGIN_TOL``: sums in another order move a
bf16 carry by a rounding step); the scores of rows whose tokens are equal
within 0.1 (``chip_smoke.py``'s bf16 ``SCORE_ATOL``).  Beams are held step
by step (``ops/beam_decode.py::beam_divergence``; the JAX kernel's per-step
histories and scores are read from its ``backtrack_and_select`` call, the
scores of step t from a decode of t + 1 steps): before a sample's histories
part, what each step adds to a beam's score agrees within 2e-3 (plus the
rounding of the float32 scores), the scores within 0.1; they part only where
two of the port's K + 1 best totals are within 4e-3 plus twice the score
difference before it; a sample whose histories agree picks another best beam
only where the choice's gap is within that difference (``chip_smoke.py``'s
bf16 ``BEAM_LOGP_TOL`` and ``compare_beams``).  Sampled rows are held by
``sample_tokens``' knife-edge distances: a row may part only at a step where
the port's logit gap is at most 2e-3 or its nucleus mass within 5e-4 of
top_p (``chip_smoke.py``'s bf16 ``SAMPLE_GAP_TOL`` and ``SAMPLE_MASS_TOL``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import img2latex_tpu.decoding.decode as jax_decode
from img2latex_tpu.decoding.decode import DecodeConfig as JaxDecodeConfig
from img2latex_tpu.ops.pallas.beam_decode import pallas_full_beam_decode
from img2latex_tpu.ops.pallas.decode_step import pack_decoder_weights as jax_pack
from img2latex_tpu.ops.pallas.decode_step import pallas_full_greedy_decode, pallas_full_sample_decode
from img2latex_tpu.ops.pallas.grid_decode import _attend
from img2latex_tpu.ops.pallas.grid_decode import pack_attention_weights as jax_pack_att
from img2latex_tpu.ops.pallas.grid_decode import pallas_full_grid_beam_decode, pallas_full_grid_greedy_decode
from img2latex_tpu.ops.pallas.grid_decode import pallas_full_grid_sample_decode
from img2latex_tpu_torch.decoding.decode import DecodeConfig
from img2latex_tpu_torch.ops import beam_decode as bd
from img2latex_tpu_torch.ops import decode_step as ds
from img2latex_tpu_torch.ops import grid_decode as gd
from test_torch_grid import B, SIGNALS, T, V, ending, grid  # noqa: F401  (shared module fixtures)

torch.set_num_threads(1)

ATTEND_BF16_RTOL = 2.0**-6
ATTEND_ATOL = 1e-5
MARGIN_TOL = 2e-3
SCORE_ATOL = 0.1
BEAM_LOGP_TOL = 2e-3
SAMPLE_GAP_TOL, SAMPLE_MASS_TOL = 2e-3, 5e-4
BEAM_K, BEAM_LENGTH_PENALTY, BEAM_T = 4, 0.7, 5
SAMPLE_TILE, SAMPLE_SEED = 4, 77


def _bf16_pair(a):
    """The same bf16 values as a torch tensor and a jnp array."""
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a).to(torch.bfloat16), jnp.asarray(a, jnp.bfloat16)


@pytest.mark.parametrize("rows_per_mem", [1, 5])
def test_attend_step_plain_bf16_matches_jax_attend(rows_per_mem):
    M, S, E, H = 3, 100, 256, 384
    A, N = H, 3 * rows_per_mem
    rng = np.random.default_rng(20 + rows_per_mem)
    h, jh = _bf16_pair(rng.uniform(-1, 1, (N, H)))
    w_h, jw_h = _bf16_pair(rng.normal(size=(H, A)) / np.sqrt(H))
    v, jv = _bf16_pair(rng.normal(size=(1, A)) / np.sqrt(A))
    u, ju = _bf16_pair(rng.normal(size=(M, S, A)))
    mem, jmem = _bf16_pair(np.maximum(rng.normal(size=(M, S, E)), 0))
    ref = _attend(jnp.repeat(jmem, rows_per_mem, axis=0), jnp.repeat(ju, rows_per_mem, axis=0), jw_h, jv, jh)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    for fn in (gd.attend_step_plain, gd.attend_step):
        got = fn(h, w_h, v[0], u, mem, torch.empty(N, E, dtype=torch.bfloat16), rows_per_mem=rows_per_mem)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - ref)
        assert (err <= ATTEND_BF16_RTOL * np.abs(ref) + ATTEND_ATOL).all(), err.max()


@pytest.fixture(scope="module")
def ending_bf16(ending):
    """``ending`` packed in bf16 on both sides."""
    g = dict(ending)
    tm = g["tmodel"]
    g["jpacked"] = jax_pack(g["params"], V, dtype=jnp.bfloat16)
    g["jatt"] = jax_pack_att(g["params"], dtype=jnp.bfloat16)
    g["jmem"] = jnp.asarray(g["jmem"], jnp.bfloat16)
    g["tmem"] = torch.from_numpy(np.array(g["jmem"].astype(jnp.float32))).to(torch.bfloat16)
    g["packed"] = ds.pack_decoder_weights(tm.decoder, torch.bfloat16)
    g["att"] = gd.pack_attention_weights(tm.decoder, torch.bfloat16)
    g["u"] = gd.grid_memory_proj(g["att"], g["tmem"])
    return g


@pytest.mark.parametrize("kind", ["vector", "grid"])
@pytest.mark.parametrize("signal", SIGNALS)
def test_greedy_decode_plain_bf16_matches_jax_kernel(ending_bf16, kind, signal):
    g = ending_bf16
    kw = dict(return_scores=True, signal=signal)
    if kind == "grid":
        ref_tokens, ref_scores = pallas_full_grid_greedy_decode(g["jpacked"], g["jatt"], g["jmem"], T, 1, 2, 0,
                                                                interpret=True, **kw)
        tokens, scores, margins = gd.grid_greedy_decode_plain(g["packed"], g["att"], g["tmem"], g["u"], T, 1, 2,
                                                              0, return_margins=True, **kw)
    else:
        ref_tokens, ref_scores = pallas_full_greedy_decode(g["jpacked"], g["jmem"][:, 0, :], T, 1, 2, 0,
                                                           interpret=True, **kw)
        tokens, scores, margins = ds.greedy_decode_plain(g["packed"], g["tmem"][:, 0, :], T, 1, 2, 0,
                                                         return_margins=True, **kw)
    ref_tokens, ref_scores = np.asarray(ref_tokens), np.asarray(ref_scores)
    tokens, scores, margins = tokens.numpy(), scores.numpy(), margins.numpy()
    assert tokens.shape == ref_tokens.shape == (B, T) and scores.dtype == np.float32
    diff = tokens != ref_tokens
    parted = diff.any(axis=1)
    first = diff.argmax(axis=1)
    for r in np.where(parted)[0]:
        assert margins[r, first[r]] <= MARGIN_TOL, (r, first[r], margins[r, first[r]])
    assert (~parted).sum() >= B // 2  # the score comparison below covers most rows
    np.testing.assert_allclose(scores[~parted], ref_scores[~parted], atol=SCORE_ATOL, rtol=0)
    assert (tokens == 2).any(axis=1).sum() > 0  # rows end: the END rule ran in bf16


def _jax_beam(g, kind, T_run, monkeypatch):
    """The JAX beam kernel's best tokens and scores over T_run steps, and the (T_run, B, K) token
    and parent histories and (B, K) final scores it hands to ``backtrack_and_select``."""
    seen = {}
    original = jax_decode.backtrack_and_select

    def record(tok_seq, beam_seq, final_scores, *args, **kw):
        seen.update(tok=np.asarray(tok_seq), par=np.asarray(beam_seq), scores=np.asarray(final_scores))
        return original(tok_seq, beam_seq, final_scores, *args, **kw)

    monkeypatch.setattr(jax_decode, "backtrack_and_select", record)
    jcfg = JaxDecodeConfig(max_length=T_run, start_id=1, end_id=2, pad_id=0, beam_size=BEAM_K,
                           length_penalty=BEAM_LENGTH_PENALTY)
    if kind == "grid":
        out = pallas_full_grid_beam_decode(g["jpacked"], g["jatt"], g["jmem"], BEAM_K, jcfg, interpret=True)
    else:
        out = pallas_full_beam_decode(g["jpacked"], g["jmem"][:, 0, :], BEAM_K, jcfg, interpret=True)
    return (np.asarray(out[0]), np.asarray(out[1]),
            {k: v[:, :B].copy() if k != "scores" else v[:B].copy() for k, v in seen.items()})


@pytest.mark.parametrize("kind", ["vector", "grid"])
def test_beam_decode_plain_bf16_matches_jax_kernel(ending_bf16, kind, monkeypatch):
    g = ending_bf16
    T = BEAM_T
    cfg = DecodeConfig(max_length=T, start_id=1, end_id=2, pad_id=0, beam_size=BEAM_K,
                       length_penalty=BEAM_LENGTH_PENALTY)
    ref_trace = {}
    if kind == "grid":
        tokens, scores = gd.grid_beam_decode_plain(g["packed"], g["att"], g["tmem"], g["u"], BEAM_K, cfg,
                                                   trace=ref_trace)
    else:
        tokens, scores = bd.beam_decode_plain(g["packed"], g["tmem"][:, 0, :], BEAM_K, cfg, trace=ref_trace)
    jtokens, jscores, hist = _jax_beam(g, kind, T, monkeypatch)
    step_scores = [_jax_beam(g, kind, t + 1, monkeypatch)[2]["scores"] for t in range(T - 1)] + [hist["scores"]]
    got_trace = {"tok_hist": torch.from_numpy(hist["tok"]).int(), "par_hist": torch.from_numpy(hist["par"]).int(),
                 "scores": torch.from_numpy(np.stack(step_scores)).float()}
    div = {k: v.numpy() for k, v in bd.beam_divergence(got_trace, ref_trace).items()}
    first, drift, gap, step_err = div["first"], div["drift"], div["gap"], div["step_err"]
    size = ref_trace["scores"].abs().amax(dim=(0, 2)).numpy()
    assert (step_err <= BEAM_LOGP_TOL + 2.0**-22 * size).all(), step_err
    assert (drift <= SCORE_ATOL).all(), drift
    parted = first < T
    assert (gap[parted] <= 2 * BEAM_LOGP_TOL + 2 * drift[parted]).all(), (first, gap, drift)
    tokens, scores = tokens.numpy(), scores.numpy()
    differ = (tokens != jtokens).any(axis=1)
    choice_gap = ref_trace["choice_gap"].numpy()
    only = differ & ~parted
    assert (choice_gap[only] <= drift[only] + 4 * 2.0**-23 * size[only]).all()
    assert (~differ).sum() >= B // 2
    np.testing.assert_allclose(scores[~differ], jscores[~differ], atol=SCORE_ATOL, rtol=0)
    assert (tokens == 2).any(axis=1).sum() > 0  # beams end: END absorption ran in bf16


@pytest.mark.parametrize("kind", ["vector", "grid"])
@pytest.mark.parametrize("kw", [dict(top_k=10, top_p=0.9, temperature=0.8), dict(top_p=0.9)])
def test_sample_decode_plain_bf16_matches_jax_kernel(ending_bf16, kind, kw):
    g = ending_bf16
    kw = dict(kw)
    top_k = kw.pop("top_k", 0)
    if kind == "grid":
        ref = pallas_full_grid_sample_decode(g["jpacked"], g["jatt"], g["jmem"], T, 1, 2, 0, top_k, SAMPLE_SEED,
                                             interpret=True, batch_tile=SAMPLE_TILE, **kw)
        got, gaps, mass = gd.grid_sample_decode_plain(g["packed"], g["att"], g["tmem"], g["u"], T, 1, 2, 0, top_k,
                                                      SAMPLE_SEED, batch_tile=SAMPLE_TILE, return_gaps=True, **kw)
    else:
        ref = pallas_full_sample_decode(g["jpacked"], g["jmem"][:, 0, :], T, 1, 2, 0, top_k, SAMPLE_SEED,
                                        interpret=True, batch_tile=SAMPLE_TILE, **kw)
        got, gaps, mass = ds.sample_decode_plain(g["packed"], g["tmem"][:, 0, :], T, 1, 2, 0, top_k, SAMPLE_SEED,
                                                 batch_tile=SAMPLE_TILE, return_gaps=True, **kw)
    ref, got, gaps, mass = np.asarray(ref), got.numpy(), gaps.numpy(), mass.numpy()
    assert got.shape == ref.shape == (B, T) and got.dtype == np.int32
    diff = got != ref
    first = diff.argmax(axis=1)
    for r in np.where(diff.any(axis=1))[0]:
        assert gaps[r, first[r]] <= SAMPLE_GAP_TOL or mass[r, first[r]] <= SAMPLE_MASS_TOL, (r, first[r])
    assert (~diff.any(axis=1)).sum() >= B // 2
    assert (got == 2).any(axis=1).sum() > 0 and len(np.unique(got)) > 3

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
  ``ending`` fixture of ``test_torch_grid.py``).

Inputs come from numpy seeds and are rounded to bf16 the same way on both
sides.  Tolerances: the context within 2 bf16 rounding steps of |ctx| (a
weight or product that rounds the other way, then ctx's own rounding;
``chip_smoke.py``'s ``ATTEND_BF16_RTOL``); a row's tokens equal, except that
a row may part at a step whose top-2 logit margin in the port is at most
2e-3 (``chip_smoke.py``'s bf16 ``MARGIN_TOL``: sums in another order move a
bf16 carry by a rounding step); the scores of rows whose tokens are equal
within 0.1 (``chip_smoke.py``'s bf16 ``SCORE_ATOL``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from img2latex_tpu.ops.pallas.decode_step import pack_decoder_weights as jax_pack
from img2latex_tpu.ops.pallas.decode_step import pallas_full_greedy_decode
from img2latex_tpu.ops.pallas.grid_decode import _attend
from img2latex_tpu.ops.pallas.grid_decode import pack_attention_weights as jax_pack_att
from img2latex_tpu.ops.pallas.grid_decode import pallas_full_grid_greedy_decode
from img2latex_tpu_torch.ops import decode_step as ds
from img2latex_tpu_torch.ops import grid_decode as gd
from test_torch_grid import B, SIGNALS, T, V, ending, grid  # noqa: F401  (shared module fixtures)

torch.set_num_threads(1)

ATTEND_BF16_RTOL = 2.0**-6
ATTEND_ATOL = 1e-5
MARGIN_TOL = 2e-3
SCORE_ATOL = 0.1


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

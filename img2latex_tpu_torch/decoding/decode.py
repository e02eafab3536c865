"""Greedy, sampling and beam decoding: the eager oracles, the filters, the
beam search's pieces and host-side post-processing.

Counterpart of ``img2latex_tpu/decoding/decode.py::greedy_sample_decode``,
``filter_top_k``, ``filter_top_p``, ``_next_token_probs``,
``signal_alpha``, ``select_uncertain``, ``topk_iterative``,
``beam_decode``, ``backtrack_and_select``, ``trim_host`` and
``decode_chunks`` (the host's prep pipelined against the card's decode,
:func:`decode_chunks`).  Greedy is the argmax of the
logits (the lowest index wins ties); a row that emitted END emits PAD from
the next step on, and the token fed back is the one emitted.
:func:`greedy_decode_eager` steps the model one token at a time in plain
PyTorch, for either memory kind (the caller's step function closes over the
memory and, for grid memory, its attention projection); the whole-decode
kernels (:mod:`img2latex_tpu_torch.ops.decode_step`,
:mod:`img2latex_tpu_torch.ops.grid_decode`) are held against it.

Sampling (``DecodeConfig.sampling``: a positive temperature and ``top_k``
or ``top_p`` above 0; a plain temperature still takes the argmax) draws
from :func:`next_token_probs`: the softmax of ``logits / temperature``,
top-k (every tie of the k-th largest kept), renormalized, then top-p (the
smallest prefix of the descending probabilities, in a stable order, whose
mass strictly before each token is at most p; the best token always
stays), renormalized.  The eager oracle draws with a ``torch.Generator``,
so its draws agree with the JAX package's only in distribution; the
kernels' draws reproduce the TPU kernels' random stream
(:func:`img2latex_tpu_torch.ops.decode_step.uniform_field`).

Per-row confidence scores (``return_scores``) sum a per-step signal over the
steps a row is live (END included, the PAD steps after it not), from the
float32 logits of the step (:func:`step_signal`):

* ``"logp"``: log-softmax of the chosen token;
* ``"margin"``: top-1 minus top-2 logit (the log-probability gap);
* ``"entropy"``: negative entropy of the step's distribution;
* ``"margin_logp[:alpha]"``: margin + alpha * logp (alpha 1 by default).

Beam search (:func:`beam_decode`) keeps K beams a sample, rows sample-major
(row ``b * K + k`` is beam k of sample b).  Each step adds the row's
log-softmax to its beam's score and keeps the K best of the K * V
candidates of each sample, the lowest flat index ``k * V + v`` winning ties
(:func:`topk_iterative`).  A beam that emitted END emits PAD at +0 and
nothing else (every other candidate gets -1e30), so its score is frozen.
At t = 0 only beam 0 is live (the others start at -1e30), so the first step
picks K distinct tokens.  The (token, parent) history is backtracked at the
end and the best beam chosen, by ``score / length^length_penalty`` when the
penalty is above 0 (:func:`backtrack_and_select`).  The kernels of
:mod:`img2latex_tpu_torch.ops.beam_decode` are held against it.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# step_fn(tokens (B,), carry) -> (logits (B, V), new_carry)
StepFn = Callable[[torch.Tensor, object], Tuple[torch.Tensor, object]]


NEG_INF = -1e30


def signal_alpha(signal: str, default: float = 1.0) -> float:
    """The blend weight of a ``"margin_logp[:alpha]"`` signal.

    Strict: the head must be exactly ``margin_logp`` and the alpha finite.
    Unlike the JAX package, which reads ``"margin_logp:"`` (a colon with
    nothing after it) as the default alpha, this raises for it."""
    head, colon, tail = signal.partition(":")
    if head != "margin_logp" or (colon and not tail):
        raise ValueError(
            f"malformed composite selective signal {signal!r} "
            "(expected 'margin_logp' or 'margin_logp:<alpha>')"
        )
    alpha = float(tail) if tail else default
    if not math.isfinite(alpha):
        raise ValueError(f"selective-signal alpha must be finite, got {alpha!r}")
    return alpha


def parse_signal(signal: str) -> Tuple[str, float]:
    """``signal`` -> (``"logp"``, ``"margin"``, ``"entropy"`` or
    ``"margin_logp"``, alpha); raises for any other name."""
    if signal in ("logp", "margin", "entropy"):
        return signal, 0.0
    return "margin_logp", signal_alpha(signal)


@dataclass(frozen=True)
class DecodeConfig:
    """Greedy, sampling and beam decode settings.

    ``temperature``, ``top_k``, ``top_p``: the sampling settings
    (:attr:`sampling`).  ``beam_size``: 0 for greedy, else the beam width K.  ``length_penalty``:
    the best beam is the one of largest ``score / length^length_penalty``
    (the plain score at 0).  ``selective_beam_frac``: with beam and
    0 < frac < 1, only the least confident rows of a greedy decode are
    beam-decoded (0 or >= 1: every row).  ``early_exit``: stop once every
    row (or beam) has emitted END; the output is the same as the full
    loop's.  ``selective_signal``: the per-step confidence that
    ``return_scores`` sums (module docstring)."""

    max_length: int = 141
    start_id: int = 1
    end_id: int = 2
    pad_id: int = 0
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    beam_size: int = 0
    length_penalty: float = 0.0
    selective_beam_frac: float = 0.0
    early_exit: bool = False
    selective_signal: str = "margin"

    @property
    def sampling(self) -> bool:
        """Draw the tokens: a positive temperature and top-k or top-p on."""
        return self.temperature > 0 and (self.top_k > 0 or self.top_p > 0.0)


def filter_top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Zero the probabilities below the k-th largest (its ties stay); no
    renormalization."""
    k = min(k, probs.shape[-1])
    kth = torch.topk(probs, k, dim=-1).values[..., -1:]
    return torch.where(probs < kth, torch.zeros_like(probs), probs)


def filter_top_p(probs: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the probabilities in
    descending order (equal ones in index order) whose mass before each
    token is at most ``p``; the most probable token always stays."""
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    cum = torch.cumsum(probs.gather(-1, order), dim=-1)
    remove = torch.cat([torch.zeros_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] > p], dim=-1)
    return torch.where(remove.scatter(-1, order, remove), torch.zeros_like(probs), probs)


def _renormalize(probs: torch.Tensor) -> torch.Tensor:
    total = probs.sum(dim=-1, keepdim=True)
    return torch.where(total > 0, probs / total.clamp_min(1e-38), probs)


def next_token_probs(logits: torch.Tensor, cfg: DecodeConfig) -> torch.Tensor:
    """(B, V) logits -> the (B, V) float32 probabilities a sampling step
    draws from: temperature, top-k, renormalized, top-p, renormalized."""
    logits = logits.float()
    if cfg.temperature != 1.0 and cfg.temperature > 0:
        logits = logits / cfg.temperature
    probs = torch.softmax(logits, dim=-1)
    if cfg.top_k > 0:
        probs = _renormalize(filter_top_k(probs, cfg.top_k))
    if cfg.top_p > 0.0:
        probs = filter_top_p(probs, cfg.top_p)
    return _renormalize(probs)


def step_signal(logits: torch.Tensor, nxt: torch.Tensor, signal: str) -> torch.Tensor:
    """(B, V) logits and the chosen tokens (B,) -> the (B,) float32 signal,
    as the TPU decode loop computes it (``ops/pallas/decode_step.py:327-372``):
    the logsumexp from the row max, the runner-up by masking the chosen
    column (greedy picks the argmax, so an exact tie gives margin 0)."""
    name, alpha = parse_signal(signal)
    logits = logits.float()
    top1 = logits.max(dim=-1).values
    lse = top1 + torch.log(torch.exp(logits - top1[:, None]).sum(-1))
    chosen = logits.gather(1, nxt.long()[:, None])[:, 0]
    if name == "logp":
        return chosen - lse
    if name == "entropy":
        logp = logits - lse[:, None]
        return (torch.exp(logp) * logp).sum(-1)
    col = torch.arange(logits.shape[1], device=logits.device)
    rest = torch.where(col[None, :] == nxt.long()[:, None], NEG_INF, logits)
    margin = top1 - rest.max(dim=-1).values
    return margin if name == "margin" else margin + alpha * (chosen - lse)


@torch.no_grad()
def greedy_decode_eager(step_fn: StepFn, carry0, batch_size: int, cfg: DecodeConfig,
                        return_scores: bool = False, generator: Optional[torch.Generator] = None):
    """Token ids (B, max_length) int32: generated tokens only (no START),
    END kept, PAD after it.  Runs on the device of the (h, c) ``carry0``.
    With ``cfg.sampling`` each token is drawn from :func:`next_token_probs`
    with ``generator`` (one seeded with 0 on that device when not given),
    else it is the argmax.  With ``return_scores`` also returns the (B,)
    float32 sums of ``cfg.selective_signal`` over the live steps, from the
    unfiltered logits."""
    device = carry0[0].device
    if cfg.sampling and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    tokens = torch.full((batch_size,), cfg.start_id, dtype=torch.int32, device=device)
    finished = torch.zeros((batch_size,), dtype=torch.bool, device=device)
    score = torch.zeros((batch_size,), dtype=torch.float32, device=device)
    out = torch.full((batch_size, cfg.max_length), cfg.pad_id, dtype=torch.int32, device=device)
    carry = carry0
    for t in range(cfg.max_length):
        if cfg.early_exit and bool(finished.all()):
            break  # the remaining steps would emit PAD
        logits, carry = step_fn(tokens, carry)
        if cfg.sampling:
            probs = next_token_probs(logits, cfg)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if return_scores:
            score += torch.where(finished, 0.0, step_signal(logits, nxt, cfg.selective_signal))
        tokens = torch.where(finished, torch.full_like(nxt, cfg.pad_id), nxt)
        finished = finished | (tokens == cfg.end_id)
        out[:, t] = tokens
    return (out, score) if return_scores else out


def select_uncertain(tokens: torch.Tensor, scores: torch.Tensor, k: int,
                     pad_id: int) -> torch.Tensor:
    """Indices ((k,) int64) of the k rows of least mean signal (the summed
    score over the row's non-PAD length), least first; among equal means
    the lower row index comes first, as ``lax.top_k`` orders them."""
    lengths = (tokens != pad_id).sum(dim=-1).float()
    mean = scores.float() / lengths.clamp_min(1.0)
    return topk_iterative(-mean, k)[1].long()


def topk_iterative(flat: torch.Tensor, k: int, neg: float = float("-inf")):
    """The k largest values of the last axis and their indices, by k passes
    of (argmax, mask the winner with ``neg``): among equal values the lowest
    index wins, as in ``lax.top_k`` (``torch.topk`` leaves the order of ties
    unspecified).  Returns (values, int64 indices), each (..., k)."""
    vals, idxs = [], []
    cur = flat
    for _ in range(k):
        i = torch.argmax(cur, dim=-1)  # the first maximum
        vals.append(cur.gather(-1, i[..., None])[..., 0])
        idxs.append(i)
        cur = cur.scatter(-1, i[..., None], neg)
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def backtrack_and_select(tok_seq: torch.Tensor, beam_seq: torch.Tensor, final_scores: torch.Tensor,
                         cfg: DecodeConfig, return_all: bool = False):
    """(T, B, K) token and parent histories and (B, K) final scores -> the
    best beam's tokens (B, T) int32 and its selection score (B,) float32:
    ``score / max(length, 1)^length_penalty`` (length counts the non-PAD
    tokens, END included) when the penalty is above 0, else the score.
    Among equal selection scores the lowest beam wins.  With ``return_all``
    the (B, K) selection scores of every beam follow, and the (B, K) factors
    that made them from the scores (``length^-length_penalty``, or 1)."""
    T, B, K = tok_seq.shape
    beam = torch.arange(K, device=tok_seq.device).expand(B, K)
    rev = []
    for t in range(T - 1, -1, -1):
        rev.append(tok_seq[t].gather(1, beam))
        beam = beam_seq[t].long().gather(1, beam)
    sequences = torch.stack(rev[::-1], dim=-1).to(torch.int32)  # (B, K, T)
    norm = final_scores.float()
    scale = torch.ones_like(norm)
    if cfg.length_penalty > 0:
        lengths = (sequences != cfg.pad_id).sum(dim=-1).float()
        scale = lengths.clamp_min(1.0) ** -cfg.length_penalty
        norm = norm / lengths.clamp_min(1.0) ** cfg.length_penalty
    best = torch.argmax(norm, dim=-1)
    tokens = sequences.gather(1, best[:, None, None].expand(B, 1, T))[:, 0]
    res = (tokens, norm.gather(1, best[:, None])[:, 0])
    return res + (norm, scale) if return_all else res


@torch.no_grad()
def beam_decode(step_fn: StepFn, carry0, batch_size: int, beam_size: int, cfg: DecodeConfig):
    """Eager beam search over ``batch_size * beam_size`` sample-major rows
    (module docstring): ``step_fn`` works on all rows (the caller repeats
    each sample's memory K times), ``carry0`` is their (h, c), each
    (L, B * K, H).  Returns the best beam's tokens (B, max_length) int32 and
    its selection score (B,) float32 (:func:`backtrack_and_select`).  With
    ``cfg.early_exit`` the loop stops once every beam has ended; the steps
    not run hold PAD tokens and identity parents, which is what the full
    loop records once every beam has ended (frozen scores stay in order)."""
    B, K, T = batch_size, beam_size, cfg.max_length
    device = carry0[0].device
    tokens = torch.full((B * K,), cfg.start_id, dtype=torch.int32, device=device)
    scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0
    fin = torch.zeros((B, K), dtype=torch.bool, device=device)
    tok_seq = torch.full((T, B, K), cfg.pad_id, dtype=torch.int32, device=device)
    beam_seq = torch.arange(K, dtype=torch.int32, device=device).expand(T, B, K).clone()
    base = (torch.arange(B, device=device) * K)[:, None]
    carry = carry0
    for t in range(T):
        if cfg.early_exit and bool(fin.all()):
            break
        logits, carry = step_fn(tokens, carry)
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).view(B, K, V)
        pad_onehot = torch.full((V,), NEG_INF, device=device)
        pad_onehot[cfg.pad_id] = 0.0
        logp = torch.where(fin[..., None], pad_onehot, logp)
        total = (scores[..., None] + logp).view(B, K * V)
        scores, flat_idx = topk_iterative(total, K)
        parent = flat_idx // V
        tok = (flat_idx % V).to(torch.int32)
        rows = (parent + base).view(-1)
        carry = tuple(x.index_select(-2, rows) for x in carry)  # (L, B K, H) leaves
        fin = fin.gather(1, parent) | (tok == cfg.end_id)
        tokens = tok.view(-1)
        tok_seq[t] = tok
        beam_seq[t] = parent.to(torch.int32)
    return backtrack_and_select(tok_seq, beam_seq, scores, cfg)


def trim_host(tokens: np.ndarray, end_id: int, pad_id: int,
              start_id: Optional[int] = None) -> List[List[int]]:
    """(B, T) ids -> one list per row, cut at the first END (exclusive),
    PAD dropped, and a START at position 0 dropped when ``start_id`` is given."""
    arr = np.asarray(tokens)
    if arr.size == 0:
        return [[] for _ in range(arr.shape[0])] if arr.ndim == 2 else []
    B, T = arr.shape
    is_end = arr == end_id
    end_pos = np.where(is_end.any(axis=1), is_end.argmax(axis=1), T)
    valid = (np.arange(T)[None, :] < end_pos[:, None]) & (arr != pad_id)
    if start_id is not None:
        valid[:, 0] &= arr[:, 0] != start_id
    return [arr[i, valid[i]].tolist() for i in range(B)]


def decode_chunks(plan, seed: int, stats: Optional[dict] = None) -> List[Tuple[Sequence[int], np.ndarray]]:
    """Pipelined host prep and device decode of a sequence of chunks (the
    counterpart of ``img2latex_tpu/decoding/decode.py::decode_chunks``).

    ``plan``: ``(exec_key, run, prep_fn, idxs)`` entries.  ``prep_fn()``
    returns the chunk's uint8 canvases; ``run(canvases, seed)`` enqueues
    its decode and returns the token tensor without waiting for the card;
    ``idxs`` are the input positions the chunk covers.  The i-th chunk is
    decoded with the kernel seed ``training/predictor.py::batch_seed(seed,
    i)`` (the JAX package splits a ``PRNGKey`` instead).  The loop dispatches
    chunk i, fetches chunk i - 1, then preps chunk i + 1, and fetches chunk
    i (``.cpu()``, which waits for the card) only after that, so that the
    host's prep rides under the card's decode of chunk i.

    ``stats`` (optional, mutated) takes the evaluator's accounting:
    ``prep_s``, ``dispatch_s`` and ``fetch_s`` (wall seconds of the host's
    prep, enqueueing and waiting for tokens), ``steady_images``, and
    ``first_calls``: one ``{"exec", "seconds", "images"}`` entry for the
    first chunk of each ``exec_key``, whose dispatch and fetch walls are
    kept out of ``dispatch_s`` / ``fetch_s`` and whose images are kept out
    of ``steady_images``.  In the port a first call carries the first
    launch's ``nvcc`` build of the kernel library (once a process) and the
    libraries' handles and plans (cuBLAS, cuDNN), where the JAX package's
    carries an XLA compile.

    Returns ``(idxs, tokens)`` pairs in plan order, tokens a host array."""
    from img2latex_tpu_torch.training.predictor import batch_seed  # it imports this module

    seen: set = set()
    out: List[Tuple[Sequence[int], np.ndarray]] = []
    pending = None  # (tokens on the card, idxs, key, first dispatch wall or None)

    def _fetch(p) -> None:
        tokens_dev, idxs, key, dispatch_wall = p
        t0 = time.perf_counter()
        arr = tokens_dev.cpu().numpy() if isinstance(tokens_dev, torch.Tensor) else np.asarray(tokens_dev)
        dt = time.perf_counter() - t0
        if stats is not None:
            if dispatch_wall is not None:
                stats.setdefault("first_calls", []).append(
                    {"exec": str(key), "seconds": dt + dispatch_wall, "images": len(idxs)})
            else:
                stats["fetch_s"] = stats.get("fetch_s", 0.0) + dt
                stats["steady_images"] = stats.get("steady_images", 0) + len(idxs)
        out.append((idxs, arr))

    for i, (key, run, prep_fn, idxs) in enumerate(plan):
        t0 = time.perf_counter()
        buf = prep_fn()
        t1 = time.perf_counter()
        tokens = run(buf, batch_seed(seed, i))
        t2 = time.perf_counter()
        first = key not in seen
        seen.add(key)
        if stats is not None:
            stats["prep_s"] = stats.get("prep_s", 0.0) + (t1 - t0)
            if not first:
                stats["dispatch_s"] = stats.get("dispatch_s", 0.0) + (t2 - t1)
        if pending is not None:
            _fetch(pending)
        pending = (tokens, idxs, key, (t2 - t1) if first else None)
    if pending is not None:
        _fetch(pending)
    return out

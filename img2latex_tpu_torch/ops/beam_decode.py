"""Whole beam decode of the LSTM decoder, vector memory.

Replaces the TPU kernel ``img2latex_tpu/ops/pallas/beam_decode.py::pallas_full_beam_decode``
(``pl.pallas_call`` at line 335; the loop ``_beam_loop`` at lines 107-278).
The TPU kernel keeps the decoder weights in VMEM and runs, every step, the
LSTM over K·B rows, the vocab projection, a per-sample top-K over the K·Vp
candidates and the parent gather of the carries.  Here each step is L
launches of ``lstm_layer_step`` (``csrc/greedy_decode.cu``, unchanged: it
takes any row count) and one launch of :func:`beam_step`
(:func:`beam_plan` names its route: in bf16 ``csrc/beam_step_tc.cu``, whole
samples a row tile with the product on the tensor cores and its columns
split over a thread-block cluster; otherwise ``csrc/beam_step.cu``'s
CUDA-core kernel): the vocab product, the log-softmax, END absorption, the
per-sample top-K (the lowest flat index wins ties), the token, parent,
score and finished updates, the history column and the carry gather.

Rows are sample-major (row ``b * K + k`` is beam k of sample b) over the
whole batch: the TPU kernel's beam-major tiles of ``batch_tile`` samples are
a VMEM layout, and its result does not depend on them.  The (T, B, K) token
and parent histories and the (B, K) final scores then go through
:func:`img2latex_tpu_torch.decoding.decode.backtrack_and_select` in plain
PyTorch on the device, as the JAX package leaves that step to XLA
(``_select_from_beam_tiles``, line 281).  With ``early_exit`` the histories
are filled with PAD tokens and identity parents first, and the host reads
the all-finished flag every :data:`~img2latex_tpu_torch.ops.decode_step.EARLY_EXIT_EVERY`
steps.

* :func:`beam_plan` - the route of a beam step;
* :func:`beam_step` / :func:`beam_step_plain` - one step after the LSTM;
* :func:`beam_decode` / :func:`beam_decode_plain` - the whole decode;
* :func:`beam_divergence` - where two traced decodes of the same inputs
  part, step by step (for holding the kernels against the plain versions).

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from img2latex_tpu_torch.decoding.decode import (
    NEG_INF,
    DecodeConfig,
    backtrack_and_select,
    topk_iterative,
)
from img2latex_tpu_torch.ops import _build
from img2latex_tpu_torch.ops.decode_step import (
    _DTYPES,
    BLOCK_ROWS,
    EARLY_EXIT_EVERY,
    MAX_GRID_Y,
    ROUTE_CODES,
    TILE_ROWS,
    ContextFn,
    StepPlan,
    _check_plan_args,
    _count_launch,
    block_plan,
    cluster_tc_plan,
    lstm_layer_step,
    lstm_layer_step_plain,
)

BEAM_TC_MAX_K = TILE_ROWS  # csrc/beam_step_tc.cu: a row tile holds at least one whole sample
BEAM_TC_MAX_SMEM = 224 * 1024


def _check_beam(K: int) -> None:
    if K < 1:
        raise ValueError(f"beam width {K} is not a positive number of beams")


def beam_plan(B: int, K: int, H: int, Vp: int, dtype: torch.dtype) -> StepPlan:
    """The route of :func:`beam_step` for B samples of K beams: bf16 takes
    the tensor-core cluster kernel where a 32-row tile holds a whole sample
    (K <= 32; G = 32 // K samples a tile, so B = 512, K = 5 is 86 tiles of
    30 rows, 688 blocks in clusters of 8) and a block's slices fit its
    shared memory; float32 and wider bf16 beams take the CUDA-core kernel
    (G = 16 // K samples a block, or one sample for K > 16), whose logits go
    to device-memory scratch where they do not fit its shared memory."""
    _check_plan_args("beam_plan", B, H, Vp, dtype)
    if K < 1:
        raise ValueError(f"beam_plan: beam width {K}")
    if dtype == torch.bfloat16 and K <= BEAM_TC_MAX_K:
        G = TILE_ROWS // K
        plan = cluster_tc_plan(-(-B // G), Vp, G * K)
        if plan.smem_bytes <= BEAM_TC_MAX_SMEM and plan.grid[1] <= MAX_GRID_Y:
            return plan
    rows = BLOCK_ROWS // K * K if K <= BLOCK_ROWS else K
    return block_plan(-(-B // (rows // K)), rows, H, rows * (Vp + 6))  # logits and 6 per-row arrays


def beam_step_plain(h, w_out, b_out, scores, finished, tokens, tok_hist, par_hist, t: int, K: int,
                    end_id: int, pad_id: int, h_src, h_dst, c_src, c_dst,
                    gaps: Optional[torch.Tensor] = None) -> None:
    """Plain version of :func:`beam_step` (same arguments, same effect).
    ``gaps`` (B, T, K) float32, when given, receives at ``[:, t]`` each
    sample's K gaps between consecutive totals of its K + 1 largest
    (``[:, t, K - 1]`` is the K-th minus the (K+1)-th)."""
    N = h.shape[0]
    B = N // K
    logits = h.float() @ w_out.float() + b_out
    Vp = logits.shape[1]
    m = logits.max(dim=-1, keepdim=True).values
    logp = logits - (torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True)) + m)
    pad_row = torch.full((Vp,), NEG_INF, device=h.device)
    pad_row[pad_id] = 0.0
    logp = torch.where(finished.bool()[:, None], pad_row, logp)
    total = (scores[:, None] + logp).view(B, K * Vp)
    vals, idx = topk_iterative(total, K + (gaps is not None), neg=NEG_INF)
    if gaps is not None:
        gaps[:, t] = vals[:, :K] - vals[:, 1:]
        vals, idx = vals[:, :K], idx[:, :K]
    parent = idx // Vp
    tok = (idx % Vp).to(torch.int32).reshape(-1)
    rows = (parent + torch.arange(B, device=h.device)[:, None] * K).reshape(-1)
    finished.copy_(finished[rows] | (tok == end_id).to(torch.int32))
    scores.copy_(vals.reshape(-1))
    tokens.copy_(tok)
    tok_hist[t] = tok
    par_hist[t] = parent.reshape(-1).to(torch.int32)
    h_dst.copy_(h_src[:, rows])
    c_dst.copy_(c_src[:, rows])


def beam_step(h, w_out, b_out, scores, finished, tokens, tok_hist, par_hist, t: int, K: int,
              end_id: int, pad_id: int, h_src, h_dst, c_src, c_dst) -> None:
    """One beam step after the top LSTM layer for B samples of K beams (N =
    B K rows, sample-major; module docstring of ``csrc/beam_step.cu``).

    h (N, H) is the top layer's new h, w_out (H, Vp), b_out (Vp,) float32
    with -1e30 on the padded columns.  ``scores`` (N,) float32 and
    ``finished`` (N,) int32 are updated in place, ``tokens`` (N,) int32
    receives the new tokens, ``tok_hist`` and ``par_hist`` (T, N) int32
    receive column ``t``, and ``h_dst``, ``c_dst`` (L, N, H) receive the
    carries ``h_src``, ``c_src`` reindexed by each new beam's parent."""
    _check_beam(K)
    _build.check_no_grad("beam_step", h, w_out, b_out, h_src, c_src)
    if h.device.type == "cpu":
        return beam_step_plain(h, w_out, b_out, scores, finished, tokens, tok_hist, par_hist, t, K,
                               end_id, pad_id, h_src, h_dst, c_src, c_dst)
    if h.device.type != "cuda":
        raise ValueError(f"beam_step: unsupported device {h.device}")
    N, H = h.shape
    Vp = w_out.shape[1]
    L = h_src.shape[0]
    dtype = h.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"beam_step: dtype {dtype} is not float32 or bfloat16")
    if N % K:
        raise ValueError(f"beam_step: {N} rows are not a whole number of samples of {K} beams")
    T = tok_hist.shape[0]
    shapes = {"w_out": (w_out, (H, Vp), dtype), "b_out": (b_out, (Vp,), torch.float32),
              "scores": (scores, (N,), torch.float32), "finished": (finished, (N,), torch.int32),
              "tokens": (tokens, (N,), torch.int32), "tok_hist": (tok_hist, (T, N), torch.int32),
              "par_hist": (par_hist, (T, N), torch.int32), "h_src": (h_src, (L, N, H), dtype),
              "h_dst": (h_dst, (L, N, H), dtype), "c_src": (c_src, (L, N, H), dtype),
              "c_dst": (c_dst, (L, N, H), dtype)}
    for name, (x, shape, dt) in shapes.items():
        if tuple(x.shape) != shape or x.dtype != dt:
            raise ValueError(f"beam_step: {name} is {tuple(x.shape)} {x.dtype}, expected {shape} {dt}")
    for x in [h] + [x for x, _, _ in shapes.values()]:
        if not x.is_contiguous() or x.device != h.device:
            raise ValueError("beam_step: operands must be contiguous and on one device")
    if Vp % 128 or w_out.data_ptr() % 16:
        raise ValueError("beam_step: w_out must be 16-byte aligned with Vp a multiple of 128")
    if not 0 <= t < T or not 0 <= pad_id < Vp:
        raise ValueError(f"beam_step: step {t} outside 0..{T - 1} or pad_id {pad_id} outside the vocab")
    if h_dst.data_ptr() == h_src.data_ptr() or c_dst.data_ptr() == c_src.data_ptr():
        raise ValueError("beam_step: the carries are gathered out of place (dst must not alias src)")
    plan = beam_plan(N // K, K, H, Vp, dtype)
    scratch = (torch.empty((plan.scratch_floats,), dtype=torch.float32, device=h.device)
               if plan.scratch_floats else None)
    err = _build.lib().i2l_beam_step(
        h.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), scores.data_ptr(), finished.data_ptr(),
        tokens.data_ptr(), tok_hist.data_ptr(), par_hist.data_ptr(), h_src.data_ptr(),
        h_dst.data_ptr(), c_src.data_ptr(), c_dst.data_ptr(),
        None if scratch is None else scratch.data_ptr(), L, N // K, K, H, Vp, t, end_id,
        pad_id, ROUTE_CODES[plan.route], _DTYPES[dtype], torch.cuda.current_stream(h.device).cuda_stream,
    )
    _build.check(err, "i2l_beam_step")
    _count_launch(beam_step, plan)


beam_step.launches = beam_step.cluster_tc_launches = beam_step.block_launches = 0


def _beam(layer_step, step_fn, packed: Dict[str, Any], ctx_of: ContextFn, B: int, K: int, device,
          cfg: DecodeConfig, trace: Optional[Dict[str, torch.Tensor]] = None):
    """The beam loop shared by both memory kinds: per step, the context from
    ``ctx_of`` (given the top-layer h of each beam after the previous step's
    parent gather, zero at t = 0), the L layer launches, then ``step_fn``.
    Returns the best beam's tokens (B, T) int32 and selection score (B,)
    float32.  ``trace``, when given, receives the (T, B, K) token and parent
    histories ("tok_hist", "par_hist") and scores after each step
    ("scores"); "choice_gap" (B,), the least change of two beams' scores
    (the one up, the other down) that changes the final choice (inf for
    K = 1); and, through the plain beam step, "gaps" (B, T, K) (see
    :func:`beam_step_plain`)."""
    _check_beam(K)
    L = int(packed["num_layers"])
    H = int(packed["hidden_dim"])
    dtype = packed["emb"].dtype
    T, N = cfg.max_length, B * K
    tokens = torch.full((N,), cfg.start_id, dtype=torch.int32, device=device)
    scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=device)
    scores[:, 0] = 0.0  # only beam 0 is live at t = 0
    scores = scores.view(N)
    finished = torch.zeros((N,), dtype=torch.int32, device=device)
    if cfg.early_exit:  # the steps not run would record PAD and identity parents
        tok_hist = torch.full((T, N), cfg.pad_id, dtype=torch.int32, device=device)
        par_hist = torch.arange(K, dtype=torch.int32, device=device).repeat(B).expand(T, N).contiguous()
    else:
        tok_hist = torch.empty((T, N), dtype=torch.int32, device=device)
        par_hist = torch.empty((T, N), dtype=torch.int32, device=device)
    extra = {}
    if trace is not None:
        score_hist = torch.empty((T, N), dtype=torch.float32, device=device)
        if step_fn is beam_step_plain:
            extra["gaps"] = torch.full((B, T, K), float("inf"), device=device)
    # h: the LSTM reads h[0] and writes h[1], the gather goes back to h[0];
    # c: the LSTM updates c[cc] in place, the gather goes to c[1 - cc].
    h = torch.zeros((2, L, N, H), dtype=dtype, device=device)
    c = torch.zeros((2, L, N, H), dtype=dtype, device=device)
    cc = steps = 0
    for t in range(T):
        if cfg.early_exit and t % EARLY_EXIT_EVERY == 0 and t > 0 and bool(finished.all()):
            break
        x1 = ctx_of(h[0, L - 1])
        for i in range(L):
            layer_step(
                tokens if i == 0 else None, packed["emb"] if i == 0 else None, x1,
                h[0, i], packed[f"w_ih_{i}"], packed[f"w_hh_{i}"], packed[f"b_{i}"],
                c[cc, i], h[1, i],
            )
            x1 = h[1, i]
        step_fn(x1, packed["w_out"], packed["b_out"], scores, finished, tokens, tok_hist, par_hist,
                t, K, cfg.end_id, cfg.pad_id, h[1], h[0], c[cc], c[1 - cc], **extra)
        if trace is not None:
            score_hist[t] = scores
        cc, steps = 1 - cc, steps + 1
    tokens, best, norm, scale = backtrack_and_select(tok_hist.view(T, B, K), par_hist.view(T, B, K),
                                                     scores.view(B, K), cfg, return_all=True)
    if trace is not None:
        score_hist[steps:] = scores  # the steps not run leave the scores as they are
        pick = torch.argmax(norm, dim=-1, keepdim=True)
        gap = (norm.gather(1, pick) - norm) / (scale.gather(1, pick) + scale)
        trace.update(tok_hist=tok_hist.view(T, B, K), par_hist=par_hist.view(T, B, K),
                     scores=score_hist.view(T, B, K),
                     choice_gap=gap.scatter(1, pick, float("inf")).amin(dim=-1), **extra)
    return tokens, best


def beam_divergence(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Where two traces (``trace`` of :func:`beam_decode` and the others) of
    one beam decode part, per sample (``ref`` must come from the plain
    versions).  Up to the first step whose K tokens or parents differ, the
    two decodes hold the same beams in the same slots: there each step adds
    to a beam's score the log-probability of its token given its parent,
    and a candidate outranks another in one decode and not in the other only
    if their gap in ``ref`` is at most twice the difference of the beam
    scores plus twice that of the log-probabilities.  Returns (B,) tensors:

    * "first": that step (T where none differs);
    * "drift": the largest difference of the sample's beam scores before it;
    * "step_err": the largest difference of what one step added to a beam's
      score, before it;
    * "gap": ``ref``'s least gap between consecutive totals of its K + 1
      best at that step (inf where none differs)."""
    T = ref["tok_hist"].shape[0]
    differ = ((got["tok_hist"] != ref["tok_hist"]) | (got["par_hist"] != ref["par_hist"])).any(dim=-1)
    parted = differ.any(dim=0)
    first = torch.where(parted, differ.int().argmax(dim=0), T)
    before = (torch.arange(T, device=first.device)[:, None] < first)[..., None]

    def added(tr):  # what each step added to each beam's score (parents at t = 0 have score 0)
        prev = torch.cat([torch.zeros_like(tr["scores"][:1]), tr["scores"][:-1]])
        return tr["scores"] - prev.gather(-1, tr["par_hist"].long())

    def worst(d):
        return torch.where(before, d, torch.zeros_like(d)).amax(dim=(0, 2))

    at = ref["gaps"].amin(dim=-1).gather(1, first.clamp(max=T - 1)[:, None])[:, 0]
    return {"first": first, "drift": worst((got["scores"] - ref["scores"]).abs()),
            "step_err": worst((added(got) - added(ref)).abs()),
            "gap": torch.where(parted, at, torch.full_like(at, float("inf")))}


def _vector(layer_step, step_fn, packed, ctx, K, cfg, **kwargs):
    _check_beam(K)
    # the context is the same for the K beams of a sample: broadcast once
    ctx = ctx.to(packed["emb"].dtype).repeat_interleave(K, dim=0).contiguous()
    return _beam(layer_step, step_fn, packed, lambda h_top: ctx, ctx.shape[0] // K, K, ctx.device,
                 cfg, **kwargs)


def beam_decode(packed: Dict[str, Any], ctx: torch.Tensor, beam_size: int, cfg: DecodeConfig,
                trace: Optional[Dict[str, torch.Tensor]] = None):
    """Beam search of width ``beam_size`` over vector memory: ctx (B, E) ->
    the best beam's tokens (B, cfg.max_length) int32 (END kept, PAD after
    it) and its selection score (B,) float32, with ``cfg``'s ids,
    ``length_penalty`` and ``early_exit``; ``trace`` as in :func:`_beam`.
    CUDA tensors run the kernels; CPU tensors run their plain versions."""
    return _vector(lstm_layer_step, beam_step, packed, ctx, beam_size, cfg, trace=trace)


def beam_decode_plain(packed: Dict[str, Any], ctx: torch.Tensor, beam_size: int, cfg: DecodeConfig,
                      trace: Optional[Dict[str, torch.Tensor]] = None):
    """:func:`beam_decode` through the plain versions on any device; its
    ``trace`` also receives the gaps of every step."""
    return _vector(lstm_layer_step_plain, beam_step_plain, packed, ctx, beam_size, cfg, trace=trace)

"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` (one process per source,
run in parallel) and linked into one shared library with a plain C
interface, ``build/libi2l_kernels_<hash>.so`` inside the package, which is
loaded with ``ctypes``.  The sources include no PyTorch
header, so the build takes seconds.  The library is rebuilt only when a
source (or the flags) change: the file name carries their hash.

Each C function launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.  The build
happens at the first launch, never at import, so the package imports on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
COMPILE_FLAGS = ARCH_FLAGS + ["-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c"]
LINK_FLAGS = ARCH_FLAGS + ["-shared", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
IP = ctypes.POINTER(ctypes.c_int)
# C signature of every exported function: argument types, in order.
SIGNATURES = {
    # x, taps, bias, out, B, H, W, Cout, nhwc, dtype, stream
    "i2l_conv1_pool": [P, P, P, P, I, I, I, I, I, I, P],
    # x, taps, bias (or null), out, B, Cin, H, W, Cout, nhwc, dtype, stream
    "i2l_conv_pool": [P] * 4 + [I] * 7 + [P],
    # tokens, emb, E0, x1, E1, h_in, w_ih, w_hh, b, c, h_out, B, H, dtype, stream
    "i2l_lstm_layer_step": [P, P, I, P, I, P, P, P, P, P, P, I, I, I, P],
    # h, w_out, b_out, tokens, finished, out, score, signal, alpha, t, T, B, H, Vp, end_id,
    # pad_id, dtype, stream
    "i2l_vocab_argmax_step": [P, P, P, P, P, P, P, I, F, I, I, I, I, I, I, I, I, P],
    # h, w_h, v, u, mem, hw, ctx, B, S, E, H, A, rows_per_mem, dtype, stream
    "i2l_attend_step": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    # h, w_out, b_out, scores, finished, tokens, tok_hist, par_hist, h_src, h_dst, c_src, c_dst,
    # scratch, L, B, K, H, Vp, t, end_id, pad_id, dtype, stream
    "i2l_beam_step": [P] * 13 + [I] * 9 + [P],
    # B, K, H, Vp -> floats of device-memory scratch
    "i2l_beam_step_scratch": [I] * 4,
    # h, w_out, b_out, tokens, finished, out, scratch, t, T, B, H, Vp, end_id, pad_id, seed,
    # top_k, top_p, batch_tile, dtype, stream
    "i2l_vocab_sample_step": [P] * 7 + [I] * 9 + [F, I, I, P],
    # B, H, Vp, top_p_on -> floats of device-memory scratch
    "i2l_vocab_sample_step_scratch": [I] * 4,
    # gx, h_prev, c_prev, w_t, ys, cs, ga, B, H, dtype, stream
    "i2l_lstm_seq_fwd_step": [P] * 7 + [I] * 3 + [P],
    # dgx_next, w, dy, ga, cs, c_prev, dc, dgx, dh0, dc0, B, H, dtype, stream
    "i2l_lstm_seq_bwd_step": [P] * 10 + [I] * 3 + [P],
    # dgx, h0, ys, partial, dw, M, B, H, nsplit, stream (float32)
    "i2l_lstm_seq_dw": [P] * 5 + [I] * 4 + [P],
    # gx, h0, c0, w_t, ys, cs, ga, T, B, H, cluster, rows, buffers, stream
    "i2l_lstm_seq_fwd_persist": [P] * 7 + [I] * 6 + [P],
    # dys, dy_last, dcT, ga, cs, c0, w, dgx, dh0, dc0, T, B, H, cluster, rows, buffers, stream
    "i2l_lstm_seq_bwd_persist": [P] * 10 + [I] * 6 + [P],
    # dgx, h0, ys, partial, dw, M, B, H, nsplit, stream
    "i2l_lstm_seq_dw_tc": [P] * 5 + [I] * 4 + [P],
    # B, H, cluster, rows, buffers, direction, dims (max active clusters, clusters, threads) -> shared memory bytes
    "i2l_lstm_seq_persist_shape": [I] * 6 + [IP],
    # dynamic shared memory of the bf16 tensor-core kernels, bytes
    "i2l_lstm_tc_smem_bytes": [],
    "i2l_conv_tc_smem_bytes": [],
    # launch shapes, for logs: B, Vp, dims (grid x, grid y, cluster) -> dynamic shared memory bytes
    "i2l_vocab_tc_launch_shape": [I, I, IP],
    # B, S, E, A, rows_per_mem, dtype, dims (blocks, rows a group, slots a tile) -> shared memory bytes
    "i2l_attend_launch_shape": [I] * 6 + [IP],
}
# Return types other than int (a CUDA error code).
RESTYPES = {"i2l_beam_step_scratch": ctypes.c_longlong, "i2l_vocab_sample_step_scratch": ctypes.c_longlong}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_seconds: Optional[float] = None  # wall time of the nvcc run; 0.0 when the cached library was reused


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc was not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libi2l_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels (once per source hash) and return the library's path.

    One ``nvcc -c`` per source, all started together, then one link into
    ``libi2l_kernels_<hash>.so``.  ``ptxas -v`` (registers, shared memory,
    spills of each kernel) goes to ``build/ptxas.log``."""
    global build_seconds
    out = library_path()
    if out.exists():
        if build_seconds is None:
            build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    t0 = time.perf_counter()
    try:
        procs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        outputs = [proc.communicate()[0] for _, _, proc in procs]  # waits for every nvcc
        logs = []
        for (cmd, _, proc), text in zip(procs, outputs):
            logs.append(f"$ {' '.join(cmd)}\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}")
        so = tmp / "lib.so"
        cmd = [nvcc, *LINK_FLAGS, "-o", str(so), *(str(obj) for _, obj, _ in procs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
        (BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
        os.replace(so, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            handle.i2l_error_string.argtypes = [I]
            handle.i2l_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check_no_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd would record a call to a kernel that has no
    backward: grad mode on and an input that requires grad.  The kernels
    write their outputs where autograd does not see them, so the gradient
    would be silently wrong; differentiating a ``pallas_call`` without a VJP
    fails in JAX too."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under torch.no_grad() or on "
                           "tensors that do not require grad")


def recompute_backward(plain, saved, needs, grad: torch.Tensor, *extra) -> tuple:
    """The backward of an ``autograd.Function`` whose forward is a kernel:
    autograd of ``plain(*saved, *extra)`` at the saved inputs, recomputing
    the forward (the route of a JAX custom VJP that linearizes the plain
    composition).  One gradient for each of ``saved``, None where ``needs``
    (``ctx.needs_input_grad``) asks for none."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
        out = plain(*leaves, *extra)
        wanted = [t for t in leaves if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
    return tuple(next(grads) if need else None for need in needs[:len(saved)])


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        what = _lib.i2l_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {what}")

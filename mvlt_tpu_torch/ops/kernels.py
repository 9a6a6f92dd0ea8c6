"""The port's three hand-written Hopper kernels, their wrappers, and the plain
PyTorch version of each.

K1 ``gemm``, K2 ``biased_attention`` and K3 ``layernorm`` are CUDA C++ for
``sm_90a`` (sources in ``mvlt_tpu_torch/csrc/``). They are compiled with
``nvcc`` at first use into ``build/torch_kernels/`` (one shared library per
source, all built in parallel) and bound with ``ctypes``. Every TPU kernel on
the VQA forward is rebuilt from these three in :mod:`mvlt_tpu_torch.ops.blocks`.

Each wrapper checks device, dtype, shape and contiguity, allocates its output
with ``torch.empty``, launches on PyTorch's current stream, raises if the
launch was refused, and adds one to its ``launches`` count. A wrapper takes
its plain version only because its input lies on the CPU; on a CUDA tensor it
launches the kernel or raises.

The plain versions compute in float32 from the (possibly bf16) inputs and
round once at the end, which is the numerics of the kernels and of the JAX
interpret path (``fast=False``): f32 accumulation, exact erf GELU, a
max-subtracted softmax with an exact divide, two-pass LN moments.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

import torch
import torch.nn.functional as F

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = {"gemm": "gemm.cu", "attention": "attention.cu", "layernorm": "layernorm.cu"}

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mvlt_gemm": [_vp] * 7 + [_int] * 4 + [_vp],
    "mvlt_attention": [_vp] * 4 + [_int] * 5 + [_float, _vp],
    "mvlt_layernorm": [_vp] * 5 + [_int, _int, _float, _vp],
}

_build_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels "
                           "are built from mvlt_tpu_torch/csrc at first use")
    return found


def build() -> dict:
    """Compile every kernel source (one ``nvcc`` each, all started together)
    unless a library built from the same source bytes exists, then load them.
    Returns ``{name: ctypes.CDLL}``; raises if any build fails."""
    with _build_lock:
        if _libs:
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs, targets = {}, {}
        for name, src in SOURCES.items():
            path = _CSRC / src
            digest = hashlib.sha1(path.read_bytes()).hexdigest()[:12]
            target = BUILD_DIR / f"{name}-{digest}.so"
            targets[name] = target
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-o", str(tmp), str(path)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{SOURCES[name]}:\n{out}")
                continue
            os.replace(tmp, targets[name])
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        libs = {}
        for name, target in targets.items():
            lib = ctypes.CDLL(str(target))
            for fn, argtypes in _SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib
        _libs.update(libs)
        return _libs


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _cuda_arg(t: Optional[torch.Tensor], name: str, dtype: torch.dtype,
              device: torch.device, ndim: int) -> None:
    if t is None:
        return
    _require(t.device == device, f"{name} is on {t.device}, expected {device}")
    _require(t.dtype == dtype, f"{name} has dtype {t.dtype}, expected {dtype}")
    _require(t.dim() == ndim, f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def _rows(x: torch.Tensor, idx: Optional[torch.Tensor]) -> torch.Tensor:
    return x if idx is None else x.index_select(0, idx.long())


# ---------------------------------------------------------------------------
# K1 gemm
# ---------------------------------------------------------------------------

def gemm_plain(a, w, bias=None, *, gelu: bool = False, residual=None,
               residual_index=None, store_index=None):
    """``out[store_index[m]] = epi(a[m] @ w.T + bias)``, where ``epi`` is an
    optional exact GELU then ``+ residual[residual_index[m]]``; f32 inside.
    a: (M, K); w: (N, K) (PyTorch Linear layout); bias: (N,)."""
    y = a.float() @ w.float().t()
    if bias is not None:
        y = y + bias.float()
    if gelu:
        y = F.gelu(y)
    if residual is not None:
        y = y + _rows(residual, residual_index).float()
    y = y.to(a.dtype)
    if store_index is None:
        return y
    out = torch.empty_like(y)
    out[store_index.long()] = y
    return out


def gemm(a, w, bias=None, *, gelu: bool = False, residual=None,
         residual_index=None, store_index=None):
    """K1 wrapper; same contract as :func:`gemm_plain`. On CUDA: bf16
    operands, K and N multiples of 8, int32 row indices, and ``store_index``
    a permutation of the rows (every output row is written)."""
    if not a.is_cuda:
        return gemm_plain(a, w, bias, gelu=gelu, residual=residual,
                          residual_index=residual_index,
                          store_index=store_index)
    dev, bf = a.device, torch.bfloat16
    _cuda_arg(a, "a", bf, dev, 2)
    _cuda_arg(w, "w", bf, dev, 2)
    M, K = a.shape
    N = w.shape[0]
    _require(w.shape[1] == K, f"w {tuple(w.shape)} does not match a {tuple(a.shape)}")
    _require(K % 8 == 0 and N % 8 == 0, f"K={K} and N={N} must be multiples of 8")
    _cuda_arg(bias, "bias", bf, dev, 1)
    _require(bias is None or bias.shape[0] == N, "bias must have N entries")
    _cuda_arg(residual, "residual", bf, dev, 2)
    _require(residual is None or residual.shape[1] == N, "residual must have N columns")
    _require(residual is not None or residual_index is None,
             "residual_index needs a residual")
    for name, idx in (("residual_index", residual_index), ("store_index", store_index)):
        _cuda_arg(idx, name, torch.int32, dev, 1)
        _require(idx is None or idx.shape[0] == M, f"{name} must have M entries")
    _require(residual is None or residual_index is not None or residual.shape[0] == M,
             "residual must have M rows")
    y = torch.empty((M, N), dtype=bf, device=dev)
    lib = build()["gemm"]
    _check(lib.mvlt_gemm(_ptr(a), _ptr(w), _ptr(bias), _ptr(residual),
                         _ptr(residual_index), _ptr(store_index), _ptr(y),
                         M, N, K, int(gelu), _stream(dev)), "gemm")
    gemm.launches += 1
    return y


gemm.launches = 0


# ---------------------------------------------------------------------------
# K2 biased_attention
# ---------------------------------------------------------------------------

def biased_attention_plain(qkv, num_heads: int, seq_n: int, scale: float,
                           pattern=None, key_bias=None):
    """qkv: (G*N, 3C) fused rows, groups of ``seq_n`` consecutive rows.
    pattern: (P, nH, N, N) f32 additive bias, group g uses ``pattern[g % P]``;
    key_bias: (G, N) f32 additive per-key bias. Returns ctx (G*N, C)."""
    rows, C3 = qkv.shape
    C, N = C3 // 3, seq_n
    G, Dh = rows // N, C3 // 3 // num_heads
    t = qkv.float().view(G, N, 3, num_heads, Dh).permute(2, 0, 3, 1, 4)
    q, k, v = t[0] * scale, t[1], t[2]
    s = q @ k.transpose(-1, -2)                                # (G, nH, N, N)
    if pattern is not None:
        P = pattern.shape[0]
        s = s + pattern.float()[torch.arange(G, device=qkv.device) % P]
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(qkv.dtype).float()
    ctx = (p @ v).to(qkv.dtype)                                # (G, nH, N, Dh)
    return ctx.permute(0, 2, 1, 3).reshape(rows, C)


def biased_attention(qkv, num_heads: int, seq_n: int, scale: float,
                     pattern=None, key_bias=None):
    """K2 wrapper; same contract as :func:`biased_attention_plain`. On CUDA:
    bf16 qkv, f32 biases, N <= 128 and head dim <= 64."""
    if not qkv.is_cuda:
        return biased_attention_plain(qkv, num_heads, seq_n, scale,
                                      pattern, key_bias)
    dev = qkv.device
    _cuda_arg(qkv, "qkv", torch.bfloat16, dev, 2)
    rows, C3 = qkv.shape
    N = seq_n
    _require(C3 % 3 == 0 and (C3 // 3) % num_heads == 0,
             f"qkv width {C3} is not 3 * heads * head_dim")
    C = C3 // 3
    _require(0 < N <= 128 and rows % N == 0, f"rows {rows} not groups of N={N} <= 128")
    _require(C // num_heads <= 64, f"head dim {C // num_heads} > 64")
    G = rows // N
    _cuda_arg(pattern, "pattern", torch.float32, dev, 4)
    P = 1
    if pattern is not None:
        P = pattern.shape[0]
        _require(tuple(pattern.shape[1:]) == (num_heads, N, N) and G % P == 0,
                 f"pattern {tuple(pattern.shape)} does not fit {G} groups of "
                 f"({num_heads}, {N}, {N})")
    _cuda_arg(key_bias, "key_bias", torch.float32, dev, 2)
    _require(key_bias is None or tuple(key_bias.shape) == (G, N),
             f"key_bias must be ({G}, {N})")
    ctx = torch.empty((rows, C), dtype=torch.bfloat16, device=dev)
    lib = build()["attention"]
    _check(lib.mvlt_attention(_ptr(qkv), _ptr(pattern), _ptr(key_bias),
                              _ptr(ctx), G, N, C, num_heads, P, float(scale),
                              _stream(dev)), "biased_attention")
    biased_attention.launches += 1
    return ctx


biased_attention.launches = 0


# ---------------------------------------------------------------------------
# K3 layernorm
# ---------------------------------------------------------------------------

def layernorm_plain(x, gamma, beta, eps: float, row_index=None):
    """``LN(x[row_index]) * gamma + beta`` over the last dim, f32 moments."""
    y = F.layer_norm(_rows(x, row_index).float(), (x.shape[-1],),
                     gamma.float(), beta.float(), eps)
    return y.to(x.dtype)


def layernorm(x, gamma, beta, eps: float, row_index=None):
    """K3 wrapper; same contract as :func:`layernorm_plain`. On CUDA: bf16
    x (rows, C), f32 gamma / beta, int32 row_index."""
    if not x.is_cuda:
        return layernorm_plain(x, gamma, beta, eps, row_index)
    dev = x.device
    _cuda_arg(x, "x", torch.bfloat16, dev, 2)
    C = x.shape[1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        _cuda_arg(t, name, torch.float32, dev, 1)
        _require(t.shape[0] == C, f"{name} must have {C} entries")
    _cuda_arg(row_index, "row_index", torch.int32, dev, 1)
    M = x.shape[0] if row_index is None else row_index.shape[0]
    y = torch.empty((M, C), dtype=torch.bfloat16, device=dev)
    lib = build()["layernorm"]
    _check(lib.mvlt_layernorm(_ptr(x), _ptr(row_index), _ptr(gamma),
                              _ptr(beta), _ptr(y), M, C, float(eps),
                              _stream(dev)), "layernorm")
    layernorm.launches += 1
    return y


layernorm.launches = 0

KERNELS = (gemm, biased_attention, layernorm)

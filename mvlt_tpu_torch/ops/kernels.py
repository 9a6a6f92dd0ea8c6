"""The port's hand-written Hopper kernels, their wrappers, and the plain
PyTorch version of each.

K1 ``gemm``, K2 ``biased_attention``, K3 ``layernorm``, K4
``biased_attention_bwd`` and K5 ``layernorm_bwd`` / ``column_sum`` are CUDA
C++ for ``sm_90a`` (sources in ``mvlt_tpu_torch/csrc/``). They are compiled
with ``nvcc`` at first use into ``build/torch_kernels/`` (one shared library
per source, all built in parallel) and bound with ``ctypes``. Every TPU
kernel on the ported paths is rebuilt from these in
:mod:`mvlt_tpu_torch.ops.blocks`.

K2 and K4 have two opt-in modes each: in-kernel attention dropout from a
device seed (``adrop=(seed, rate)``; the Philox stream of
``csrc/philox.cuh``, whose plain version is :func:`adrop_mask_plain`), and
the stored softmax (K2 ``save_p=True`` writes p, K4 ``p=`` reads it). Each
mode has a launch count of its own beside ``launches`` (``MODE_COUNTS``).

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on PyTorch's current
stream, raises if the launch was refused, and adds one to its ``launches``
count. A wrapper takes its plain version only because its input lies on the
CPU; on a CUDA tensor it launches the kernel or raises.

The plain versions compute in float32 from the (possibly bf16) inputs and
round once at the end, which is the numerics of the kernels and of the JAX
interpret path (``fast=False``): f32 accumulation, exact erf GELU and its
exact derivative, a max-subtracted softmax with an exact divide, two-pass LN
moments.
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

import numpy as np
import torch
import torch.nn.functional as F

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = {"gemm": "gemm.cu", "attention": "attention.cu",
           "layernorm": "layernorm.cu", "attention_bwd": "attention_bwd.cu",
           "layernorm_bwd": "layernorm_bwd.cu"}

_vp, _int, _float, _uint = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                            ctypes.c_uint)
_i64 = ctypes.c_longlong
# C function -> (argument types, result type)
_SIGNATURES = {
    "mvlt_gemm": ([_vp] * 10 + [_int] * 7 + [_vp], _int),
    "mvlt_attention": ([_vp] * 9 + [_int] * 5 + [_float, _uint, _float, _vp],
                       _int),
    "mvlt_attention_smem": ([_int, _int], _i64),
    "mvlt_smem_optin": ([], _int),
    "mvlt_layernorm": ([_vp] * 5 + [_int, _int, _float, _int, _vp], _int),
    "mvlt_attention_bwd": ([_vp] * 13 + [_int] * 5
                           + [_float, _uint, _float, _vp], _int),
    "mvlt_attention_bwd_smem": ([_int] * 3, _i64),
    "mvlt_attention_bwd_chunks": ([_int] * 3, _int),
    "mvlt_layernorm_bwd": ([_vp] * 10 + [_int, _int, _float, _int, _int, _vp],
                           _int),
    "mvlt_layernorm_bwd_blocks": ([_int], _int),
    "mvlt_column_sum": ([_vp, _int] + [_vp] * 4 + [_int] * 3 + [_vp], _int),
    "mvlt_column_sum_chunks": ([_int, _int], _int),
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
    unless a library built from the same source and header bytes exists,
    then load them.
    Returns ``{name: ctypes.CDLL}``; raises if any build fails."""
    with _build_lock:
        if _libs:
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs, targets = {}, {}
        headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
        for name, src in SOURCES.items():
            path = _CSRC / src
            digest = hashlib.sha1(path.read_bytes() + headers).hexdigest()[:12]
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
            for fn, (argtypes, restype) in _SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
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


def _row_scale_plain(scale: Optional[torch.Tensor], M: int):
    """A (S,) row scale as the (M, 1) f32 column it stands for: row m takes
    ``scale[m // (M // S)]``."""
    if scale is None:
        return None
    _require(scale.dim() == 1 and M % scale.shape[0] == 0,
             f"row_scale {tuple(scale.shape)} does not divide {M} rows")
    return scale.float().repeat_interleave(M // scale.shape[0])[:, None]


def _cuda_row_scale(scale: Optional[torch.Tensor], M: int,
                    device: torch.device) -> int:
    """Check a (S,) f32 row scale on the card; returns the rows per value."""
    if scale is None:
        return 1
    _cuda_arg(scale, "row_scale", torch.float32, device, 1)
    _require(scale.shape[0] > 0 and M % scale.shape[0] == 0,
             f"row_scale of {scale.shape[0]} values does not divide {M} rows")
    return M // scale.shape[0]


# ---------------------------------------------------------------------------
# K1 gemm
# ---------------------------------------------------------------------------

_LAYOUTS = {"nt": 0, "nn": 1, "tn": 2}


def gelu_grad_exact(a: torch.Tensor) -> torch.Tensor:
    """d/da of the erf GELU ``a * Phi(a)``: ``Phi(a) + a * phi(a)``
    (``_gelu_grad``, pallas_attn.py:1604, exact path), in f32."""
    a = a.float()
    return 0.5 * (1.0 + torch.erf(a * 0.7071067811865476)) + \
        a * torch.exp(-0.5 * a * a) * 0.3989422804014327


def gemm_plain(a, w, bias=None, *, gelu: bool = False, residual=None,
               residual_index=None, store_index=None, layout: str = "nt",
               out_dtype=None, gelu_grad=None, save_preact: bool = False,
               emask=None, row_scale=None):
    """``out[store_index[m]] = epi(op(a, w)[m] + bias)``; f32 inside.

    ``layout``: ``"nt"`` a (M, K) @ w (N, K)^T (the PyTorch Linear layout),
    ``"nn"`` a (M, K) @ w (K, N), ``"tn"`` a (K, M)^T @ w (K, N). ``epi`` is,
    in order: an optional exact GELU, or a product with the exact GELU
    derivative of the f32 pre-activation ``gelu_grad`` (M, N); then a product
    with ``emask`` (M, N) (the hidden-dropout mask); then a product with the
    f32 ``row_scale`` (S,), row m taking ``row_scale[m // (M // S)]`` (the
    DropPath multipliers, one per image); then
    ``+ residual[residual_index[m]]``. The output has ``out_dtype`` (default
    ``a.dtype``). With ``save_preact`` it returns ``(out, pre)``, ``pre`` the
    f32 value before the GELU, in unscattered row order."""
    af, wf = a.float(), w.float()
    if layout == "nt":
        y = af @ wf.t()
    elif layout == "nn":
        y = af @ wf
    elif layout == "tn":
        y = af.t() @ wf
    else:
        raise ValueError(f"unknown layout {layout!r}")
    if bias is not None:
        y = y + bias.float()
    pre = y if save_preact else None
    if gelu_grad is not None:
        y = y * gelu_grad_exact(gelu_grad)
    if gelu:
        y = F.gelu(y)
    if emask is not None:
        y = y * emask.float()
    if row_scale is not None:
        y = y * _row_scale_plain(row_scale, y.shape[0])
    if residual is not None:
        y = y + _rows(residual, residual_index).float()
    y = y.to(out_dtype or a.dtype)
    if store_index is not None:
        out = torch.empty_like(y)
        out[store_index.long()] = y
        y = out
    return (y, pre) if save_preact else y


def gemm(a, w, bias=None, *, gelu: bool = False, residual=None,
         residual_index=None, store_index=None, layout: str = "nt",
         out_dtype=None, gelu_grad=None, save_preact: bool = False,
         emask=None, row_scale=None):
    """K1 wrapper; same contract as :func:`gemm_plain`. On CUDA: bf16
    operands, bias and emask, an f32 row scale, a bf16 or f32 residual, a
    bf16 or f32 output, the contiguous dims of both operands multiples of 8,
    int32 row indices, and ``store_index`` a permutation of the rows (every
    output row is written)."""
    if not a.is_cuda:
        return gemm_plain(a, w, bias, gelu=gelu, residual=residual,
                          residual_index=residual_index,
                          store_index=store_index, layout=layout,
                          out_dtype=out_dtype, gelu_grad=gelu_grad,
                          save_preact=save_preact, emask=emask,
                          row_scale=row_scale)
    dev, bf, f32 = a.device, torch.bfloat16, torch.float32
    _require(layout in _LAYOUTS, f"unknown layout {layout!r}")
    _cuda_arg(a, "a", bf, dev, 2)
    _cuda_arg(w, "w", bf, dev, 2)
    if layout == "tn":
        K, M = a.shape
    else:
        M, K = a.shape
    if layout == "nt":
        N, wk = w.shape
    else:
        wk, N = w.shape
    _require(wk == K, f"w {tuple(w.shape)} does not match a {tuple(a.shape)} "
                      f"in layout {layout}")
    inner = M if layout == "tn" else K
    _require(inner % 8 == 0 and N % 8 == 0,
             f"the contiguous dims ({inner}, {N}) must be multiples of 8")
    _cuda_arg(bias, "bias", bf, dev, 1)
    _require(bias is None or bias.shape[0] == N, "bias must have N entries")
    res_f32 = residual is not None and residual.dtype == f32
    _cuda_arg(residual, "residual", f32 if res_f32 else bf, dev, 2)
    _require(residual is None or residual.shape[1] == N, "residual must have N columns")
    _require(residual is not None or residual_index is None,
             "residual_index needs a residual")
    for name, idx in (("residual_index", residual_index), ("store_index", store_index)):
        _cuda_arg(idx, name, torch.int32, dev, 1)
        _require(idx is None or idx.shape[0] == M, f"{name} must have M entries")
    _require(residual is None or residual_index is not None or residual.shape[0] == M,
             "residual must have M rows")
    _require(not (gelu and gelu_grad is not None), "gelu and gelu_grad exclude each other")
    _require(not (save_preact and gelu_grad is not None),
             "save_preact and gelu_grad exclude each other")
    _cuda_arg(gelu_grad, "gelu_grad", f32, dev, 2)
    _require(gelu_grad is None or tuple(gelu_grad.shape) == (M, N),
             f"gelu_grad must be ({M}, {N})")
    _cuda_arg(emask, "emask", bf, dev, 2)
    _require(emask is None or tuple(emask.shape) == (M, N),
             f"emask must be ({M}, {N})")
    s_div = _cuda_row_scale(row_scale, M, dev)
    out_dtype = out_dtype or bf
    _require(out_dtype in (bf, f32), f"out_dtype {out_dtype} is not bf16 or f32")
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    pre = torch.empty((M, N), dtype=f32, device=dev) if save_preact else gelu_grad
    epi = 2 if gelu_grad is not None else int(gelu)
    flags = int(out_dtype == f32) | (2 * int(res_f32))
    lib = build()["gemm"]
    _check(lib.mvlt_gemm(_ptr(a), _ptr(w), _ptr(bias), _ptr(residual),
                         _ptr(residual_index), _ptr(store_index), _ptr(y),
                         _ptr(pre), _ptr(emask), _ptr(row_scale), M, N, K,
                         _LAYOUTS[layout], epi, flags, s_div,
                         _stream(dev)), "gemm")
    gemm.launches += 1
    return (y, pre) if save_preact else y


gemm.launches = 0


# ---------------------------------------------------------------------------
# The attention-dropout stream of K2 / K4 (csrc/philox.cuh), plain
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of ``a * m`` for int64 ``a`` in [0, 2^32)
    and a 32-bit constant ``m``: the product is split at 16 bits of ``m`` so
    that no partial leaves int64's positive range (on the CPU and on the
    card alike)."""
    p0 = a * (m & 0xFFFF)                     # < 2^48
    p1 = a * (m >> 16)                        # < 2^48
    mid = p0 + ((p1 & 0xFFFF) << 16)          # < 2^49
    return (p1 >> 16) + (mid >> 32), mid & _U32


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors (or ints) holding 32-bit words:
    ``counter`` four words, ``key`` two, broadcast together; returns the
    four output words. The plain version of ``mvlt::philox4x32_10``."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(torch.as_tensor(c0), _PHILOX_M[0])
        hi1, lo1 = _mulhilo(torch.as_tensor(c2), _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def adrop_constants(rate: float):
    """(keep threshold T, kept value) of attention dropout at ``rate``: an
    element is kept iff its 32-bit word is below T = min(int(keep * 2^32),
    2^32 - 1) and is then f32(1 / keep), as ``_adrop_mask`` (pallas_attn.py
    :2150-2153) keeps and scales."""
    keep = 1.0 - float(rate)
    _require(0.0 < keep < 1.0, f"attention dropout rate {rate} not in (0, 1)")
    return min(int(keep * 2 ** 32), 2 ** 32 - 1), float(np.float32(1.0 / keep))


def _adrop_seed(seed: torch.Tensor) -> None:
    _require(tuple(seed.shape) == (2,) and seed.dtype == torch.int32,
             f"adrop seed must be a (2,) int32 tensor, got "
             f"{tuple(seed.shape)} {seed.dtype}")


def adrop_mask_plain(seed: torch.Tensor, B: int, num_heads: int, N: int,
                     rate: float) -> torch.Tensor:
    """The attention-dropout mask that K2 draws and K4 regenerates, (B, nH,
    N, N) f32 of 0 or f32(1 / keep), on ``seed``'s device and without a
    host read of it. ``seed``: (2,) int32, two 16-bit halves (hi, lo).
    Element (b, h, i, j) takes word ``e % 4`` of Philox4x32-10 with key
    ``(hi * 65536 + lo, 0)`` and counter ``(e // 4, b * 256 + h, 0, 0)``,
    e = i * N + j, b the absolute sample: it depends on nothing but the
    seed, b, h, i, j and N."""
    _adrop_seed(seed)
    _require(num_heads <= 256, f"{num_heads} heads > 256")
    thresh, kept = adrop_constants(rate)
    dev, i64 = seed.device, torch.int64
    s = seed.to(i64)
    key0 = s[0] * 65536 + s[1]                # 0-d, stays on the device
    e = torch.arange(N * N, device=dev, dtype=i64)
    b = torch.arange(B, device=dev, dtype=i64)[:, None, None]
    h = torch.arange(num_heads, device=dev, dtype=i64)[None, :, None]
    words = philox4x32_10((e >> 2, b * 256 + h, 0, 0), (key0, 0))
    sel = e & 3
    w = torch.where(sel == 0, words[0], torch.where(
        sel == 1, words[1], torch.where(sel == 2, words[2], words[3])))
    mask = torch.where(w < thresh, torch.tensor(kept, device=dev),
                       torch.tensor(0.0, device=dev))
    return mask.view(B, num_heads, N, N)


# ---------------------------------------------------------------------------
# K2 biased_attention, and the shared memory of K2 and K4
# ---------------------------------------------------------------------------

# the shared memory a block may opt in to on an H100 (227 KB)
H100_SMEM_OPTIN = 232448


def attention_smem_bytes(N: int, Dh: int) -> int:
    """Shared memory of one K2 block (``smem_bytes`` in csrc/attention.cu):
    f32 q and v (N x Dh), k (N x (Dh + 1)) and the scores (N x (N + 1))."""
    return 4 * (2 * N * Dh + N * (Dh + 1) + N * (N + 1))


def attention_bwd_smem_bytes(N: int, Dh: int, pattern: bool = False) -> int:
    """Shared memory of one K4 block (``smem_bytes`` in
    csrc/attention_bwd.cu): bf16 q, k, v and dctx rows of Dh + 2, the f32
    p and ds tiles (N x (N + 1)) and, in pattern mode, the f32 N x N sum of
    ds over the block's windows."""
    return (2 * 4 * N * (Dh + 2) + 4 * 2 * N * (N + 1)
            + (4 * N * N if pattern else 0))


def max_attention_n(Dh: int, smem_optin: int = H100_SMEM_OPTIN, *,
                    backward: bool = False) -> int:
    """The largest N whose K2 (or, with ``backward``, K4) block fits in
    ``smem_optin`` bytes at head dim ``Dh``."""
    need = attention_bwd_smem_bytes if backward else attention_smem_bytes
    n = 0
    while need(n + 1, Dh) <= smem_optin:
        n += 1
    return n


_optin: dict = {}


def smem_optin(device: torch.device) -> int:
    """``cudaDevAttrMaxSharedMemoryPerBlockOptin`` of ``device``, queried
    once."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _optin:
        with torch.cuda.device(idx):
            value = build()["attention"].mvlt_smem_optin()
        if value <= 0:
            raise RuntimeError("could not query the shared memory per block")
        _optin[idx] = value
    return _optin[idx]


def check_attention_fits(N: int, Dh: int, smem_optin: int, *,
                         backward: bool = False, pattern: bool = False) -> None:
    """Raise ``ValueError`` unless a K2 (K4, with ``pattern`` in its pattern
    mode) block for (N, Dh) fits in ``smem_optin`` bytes of shared memory."""
    need = (attention_bwd_smem_bytes(N, Dh, pattern) if backward
            else attention_smem_bytes(N, Dh))
    kernel = "biased_attention_bwd" if backward else "biased_attention"
    _require(need <= smem_optin,
             f"{kernel}: N={N}, head dim {Dh} needs {need} bytes of shared "
             f"memory per block, the card allows {smem_optin} (N <= "
             f"{max_attention_n(Dh, smem_optin, backward=backward)} at this "
             "head dim)")


def _check_masks(qbias, amask, G: int, num_heads: int, N: int) -> None:
    _require(qbias is None or tuple(qbias.shape) == (G, N, N),
             f"qbias must be ({G}, {N}, {N}), got "
             f"{None if qbias is None else tuple(qbias.shape)}")
    _require(amask is None or tuple(amask.shape) == (G, num_heads, N, N),
             f"amask must be ({G}, {num_heads}, {N}, {N}), got "
             f"{None if amask is None else tuple(amask.shape)}")


def _attention_geometry(qkv, num_heads: int, seq_n: int, backward: bool,
                        pattern: bool = False):
    """(G, C, Dh) of fused rows on the card, after the shape and
    shared-memory checks."""
    rows, C3 = qkv.shape
    N = seq_n
    _require(C3 % 3 == 0 and (C3 // 3) % num_heads == 0,
             f"qkv width {C3} is not 3 * heads * head_dim")
    C = C3 // 3
    Dh = C // num_heads
    _require(0 < N and rows % N == 0, f"rows {rows} not groups of N={N}")
    _require(Dh <= 64, f"head dim {Dh} > 64")
    _require(Dh % 2 == 0 or not backward, f"head dim {Dh} is odd")
    check_attention_fits(N, Dh, smem_optin(qkv.device), backward=backward,
                         pattern=pattern)
    return rows // N, C, Dh


def _cuda_masks(qbias, amask, G, num_heads, N, dev) -> None:
    _cuda_arg(qbias, "qbias", torch.float32, dev, 3)
    _cuda_arg(amask, "amask", torch.bfloat16, dev, 4)
    _check_masks(qbias, amask, G, num_heads, N)


def _check_adrop(adrop, amask, save_mask: bool = False) -> None:
    _require(adrop is None or amask is None,
             "adrop and amask exclude each other")
    _require(adrop is not None or not save_mask, "save_mask needs adrop")
    if adrop is not None:
        _adrop_seed(adrop[0])


def _cuda_adrop(adrop, num_heads: int, dev):
    """(seed, threshold, kept value) of ``adrop`` on the card."""
    if adrop is None:
        return None, 0, 0.0
    seed, rate = adrop
    _cuda_arg(seed, "adrop seed", torch.int32, dev, 1)
    _require(num_heads <= 256, f"{num_heads} heads > 256")
    return (seed, *adrop_constants(rate))


def _with_extras(ctx, p, mask):
    """ctx alone, or ``(ctx, [p], [mask])`` with the outputs asked for."""
    extras = tuple(t for t in (p, mask) if t is not None)
    return (ctx,) + extras if extras else ctx


def biased_attention_plain(qkv, num_heads: int, seq_n: int, scale: float,
                           pattern=None, key_bias=None, qbias=None,
                           amask=None, *, adrop=None, save_p: bool = False,
                           save_mask: bool = False):
    """qkv: (G*N, 3C) fused rows, groups of ``seq_n`` consecutive rows.
    pattern: (P, nH, N, N) f32 additive bias, group g uses ``pattern[g % P]``;
    key_bias: (G, N) f32 additive per-key bias; qbias: (G, N, N) f32
    additive per-sample bias (the seq2seq mask, shared by the heads); amask:
    (G, nH, N, N) multiplier of the softmax output (the attention-dropout
    mask), applied before p is rounded to the compute dtype. ``adrop``:
    ``(seed, rate)`` in place of amask, the mask
    ``adrop_mask_plain(seed, G, nH, N, rate)`` (group g is sample g).
    Returns ctx (G*N, C), or with ``save_p`` / ``save_mask`` the tuple
    ``(ctx, [p], [mask])``: p (G, nH, N, N) the softmax before any dropout
    mask in qkv's dtype, mask (G, nH, N, N) f32 the dropout mask drawn."""
    rows, C3 = qkv.shape
    C, N = C3 // 3, seq_n
    G, Dh = rows // N, C3 // 3 // num_heads
    _check_masks(qbias, amask, G, num_heads, N)
    _check_adrop(adrop, amask, save_mask)
    if adrop is not None:
        amask = adrop_mask_plain(adrop[0], G, num_heads, N, adrop[1])
    t = qkv.float().view(G, N, 3, num_heads, Dh).permute(2, 0, 3, 1, 4)
    q, k, v = t[0] * scale, t[1], t[2]
    s = q @ k.transpose(-1, -2)                                # (G, nH, N, N)
    if pattern is not None:
        P = pattern.shape[0]
        s = s + pattern.float()[torch.arange(G, device=qkv.device) % P]
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    if qbias is not None:
        s = s + qbias.float()[:, None]
    p = torch.softmax(s, dim=-1)
    pst = p.to(qkv.dtype) if save_p else None
    if amask is not None:
        p = p * amask.float()
    p = p.to(qkv.dtype).float()
    ctx = (p @ v).to(qkv.dtype)                                # (G, nH, N, Dh)
    return _with_extras(ctx.permute(0, 2, 1, 3).reshape(rows, C), pst,
                        amask if save_mask else None)


def biased_attention(qkv, num_heads: int, seq_n: int, scale: float,
                     pattern=None, key_bias=None, qbias=None, amask=None, *,
                     adrop=None, save_p: bool = False,
                     save_mask: bool = False):
    """K2 wrapper; same contract as :func:`biased_attention_plain`. On CUDA:
    bf16 qkv and amask, f32 biases, an int32 device seed, an even head dim
    <= 64, at most 256 heads with ``adrop``, and N within the card's shared
    memory (:func:`check_attention_fits`; N <= 162 at head dim 64 on an
    H100). ``adrop`` counts in ``adrop_launches``, ``save_p`` in
    ``save_p_launches``, both also in ``launches``."""
    if not qkv.is_cuda:
        return biased_attention_plain(qkv, num_heads, seq_n, scale,
                                      pattern, key_bias, qbias, amask,
                                      adrop=adrop, save_p=save_p,
                                      save_mask=save_mask)
    dev = qkv.device
    _cuda_arg(qkv, "qkv", torch.bfloat16, dev, 2)
    rows = qkv.shape[0]
    N = seq_n
    G, C, _ = _attention_geometry(qkv, num_heads, N, backward=False)
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
    _cuda_masks(qbias, amask, G, num_heads, N, dev)
    _check_adrop(adrop, amask, save_mask)
    seed, thresh, kept = _cuda_adrop(adrop, num_heads, dev)
    ctx = torch.empty((rows, C), dtype=torch.bfloat16, device=dev)
    tiles = (G, num_heads, N, N)
    pst = torch.empty(tiles, dtype=torch.bfloat16, device=dev) if save_p else None
    mask = torch.empty(tiles, dtype=torch.float32, device=dev) if save_mask else None
    lib = build()["attention"]
    _check(lib.mvlt_attention(_ptr(qkv), _ptr(pattern), _ptr(key_bias),
                              _ptr(qbias), _ptr(amask), _ptr(seed), _ptr(ctx),
                              _ptr(pst), _ptr(mask), G, N, C, num_heads, P,
                              float(scale), thresh, kept, _stream(dev)),
           "biased_attention")
    biased_attention.launches += 1
    biased_attention.adrop_launches += adrop is not None
    biased_attention.save_p_launches += save_p
    return _with_extras(ctx, pst, mask)


biased_attention.launches = 0
biased_attention.adrop_launches = biased_attention.save_p_launches = 0


# ---------------------------------------------------------------------------
# K3 layernorm
# ---------------------------------------------------------------------------

def layernorm_plain(x, gamma, beta, eps: float, row_index=None,
                    out_dtype=None):
    """``LN(x[row_index]) * gamma + beta`` over the last dim, f32 moments;
    the output has ``out_dtype`` (default ``x.dtype``)."""
    y = F.layer_norm(_rows(x, row_index).float(), (x.shape[-1],),
                     gamma.float(), beta.float(), eps)
    return y.to(out_dtype or x.dtype)


def layernorm(x, gamma, beta, eps: float, row_index=None, out_dtype=None):
    """K3 wrapper; same contract as :func:`layernorm_plain`. On CUDA: bf16
    or f32 x (rows, C), bf16 output, f32 gamma / beta, int32 row_index."""
    if not x.is_cuda:
        return layernorm_plain(x, gamma, beta, eps, row_index, out_dtype)
    dev = x.device
    x_f32 = x.dtype == torch.float32
    _cuda_arg(x, "x", torch.float32 if x_f32 else torch.bfloat16, dev, 2)
    _require((out_dtype or x.dtype) == torch.bfloat16,
             "layernorm writes bf16 on CUDA; pass out_dtype=torch.bfloat16")
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
                              int(x_f32), _stream(dev)), "layernorm")
    layernorm.launches += 1
    return y


layernorm.launches = 0



# ---------------------------------------------------------------------------
# K4 biased_attention_bwd
# ---------------------------------------------------------------------------

def _pattern_geometry(pattern, G: int, num_heads: int, N: int) -> int:
    P = pattern.shape[0]
    _require(tuple(pattern.shape[1:]) == (num_heads, N, N),
             f"pattern {tuple(pattern.shape)} is not (P, {num_heads}, {N}, {N})")
    _require(P > 0 and G % P == 0,
             f"{G} groups do not divide among {P} patterns (G % P != 0)")
    return P


def biased_attention_bwd_plain(qkv, dctx, num_heads: int, seq_n: int,
                               scale: float, key_bias=None, qbias=None,
                               amask=None, pattern=None, *, adrop=None,
                               p=None):
    """VJP of :func:`biased_attention_plain` from the saved fused rows. qkv:
    (G*N, 3C); dctx: (G*N, C); key_bias: (G, N) f32; qbias: (G, N, N) f32;
    amask: (G, nH, N, N); pattern: (P, nH, N, N) f32, group g using
    ``pattern[g % P]``, G % P == 0. Without a pattern it returns ``(dqkv
    (G*N, 3C) in qkv.dtype, dkbias (G, N) f32)``, dkbias the column sum of ds
    over rows and heads (``_seq_core_bwd_kernel``); with one, ``(dqkv,
    dkbias or None when no key_bias is given, dpattern (P, nH, N, N) f32)``,
    dpattern the sum of ds over the G / P groups that share a pattern (the
    relative-position bias gradient of ``_core_bwd_kernel``). The unmasked p
    enters ds and ``p * amask`` enters dv (pallas_attn.py:2482-2501).
    ``adrop``: ``(seed, rate)`` in place of amask, the mask regenerated by
    :func:`adrop_mask_plain`. ``p``: the softmax that
    ``biased_attention(..., save_p=True)`` stored, (G, nH, N, N), used in
    place of the recomputed one (``_core_bwd_storep_kernel``, :3859)."""
    rows, C3 = qkv.shape
    C, N = C3 // 3, seq_n
    G, Dh = rows // N, C // num_heads
    _check_masks(qbias, amask, G, num_heads, N)
    _check_adrop(adrop, amask)
    _check_stored_p(p, G, num_heads, N)
    if adrop is not None:
        amask = adrop_mask_plain(adrop[0], G, num_heads, N, adrop[1])
    P = None if pattern is None else _pattern_geometry(pattern, G, num_heads, N)
    t = qkv.float().view(G, N, 3, num_heads, Dh).permute(2, 0, 3, 1, 4)
    q, k, v = t[0] * scale, t[1], t[2]
    dc = dctx.float().view(G, N, num_heads, Dh).permute(0, 2, 1, 3)
    if p is not None:
        p = p.float()
    else:
        s = q @ k.transpose(-1, -2)                             # (G, nH, N, N)
        if pattern is not None:
            s = s + pattern.float()[torch.arange(G, device=qkv.device) % P]
        if key_bias is not None:
            s = s + key_bias.float()[:, None, None, :]
        if qbias is not None:
            s = s + qbias.float()[:, None]
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
    am = None if amask is None else amask.float()
    pa = p if am is None else p * am
    dv = pa.transpose(-1, -2) @ dc
    dp = dc @ v.transpose(-1, -2)
    if am is not None:
        dp = dp * am
    pdp = p * dp
    ds = pdp - p * pdp.sum(-1, keepdim=True)
    dq = (ds @ k) * scale
    dk = ds.transpose(-1, -2) @ q
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(rows, C3)
    dkb = ds.sum(dim=(1, 2))
    if pattern is None:
        return dqkv.to(qkv.dtype), dkb
    dpat = ds.view(G // P, P, num_heads, N, N).sum(0)
    return (dqkv.to(qkv.dtype), dkb if key_bias is not None else None, dpat)


def _check_stored_p(p, G: int, num_heads: int, N: int) -> None:
    _require(p is None or tuple(p.shape) == (G, num_heads, N, N),
             f"stored p must be ({G}, {num_heads}, {N}, {N}), got "
             f"{None if p is None else tuple(p.shape)}")


def biased_attention_bwd(qkv, dctx, num_heads: int, seq_n: int, scale: float,
                         key_bias=None, qbias=None, amask=None, pattern=None,
                         *, adrop=None, p=None):
    """K4 wrapper; same contract as :func:`biased_attention_bwd_plain`. On
    CUDA: bf16 qkv, dctx, amask and p, f32 biases and patterns, an int32
    device seed, an even head dim <= 64, at most 256 heads with ``adrop``,
    and N within the card's shared memory (:func:`check_attention_fits`; N
    <= 140 at head dim 64 on an H100). The sums over groups run in a fixed
    order: two calls on the same inputs give bitwise-equal gradients.
    ``adrop`` counts in ``adrop_launches``, ``p`` in ``stored_p_launches``,
    both also in ``launches``."""
    if not qkv.is_cuda:
        return biased_attention_bwd_plain(qkv, dctx, num_heads, seq_n, scale,
                                          key_bias, qbias, amask, pattern,
                                          adrop=adrop, p=p)
    dev, bf, f32 = qkv.device, torch.bfloat16, torch.float32
    _cuda_arg(qkv, "qkv", bf, dev, 2)
    rows, C3 = qkv.shape
    N = seq_n
    G, C, _ = _attention_geometry(qkv, num_heads, N, backward=True,
                                  pattern=pattern is not None)
    _cuda_arg(dctx, "dctx", bf, dev, 2)
    _require(tuple(dctx.shape) == (rows, C), f"dctx must be ({rows}, {C})")
    _cuda_arg(key_bias, "key_bias", f32, dev, 2)
    _require(key_bias is None or tuple(key_bias.shape) == (G, N),
             f"key_bias must be ({G}, {N})")
    _cuda_masks(qbias, amask, G, num_heads, N, dev)
    _check_adrop(adrop, amask)
    seed, thresh, kept = _cuda_adrop(adrop, num_heads, dev)
    _cuda_arg(p, "p", bf, dev, 4)
    _check_stored_p(p, G, num_heads, N)
    _cuda_arg(pattern, "pattern", f32, dev, 4)
    P = 1 if pattern is None else _pattern_geometry(pattern, G, num_heads, N)
    lib = build()["attention_bwd"]
    dqkv = torch.empty((rows, C3), dtype=bf, device=dev)
    part = dkb = dpat_part = dpat = None
    if pattern is None or key_bias is not None:
        part = torch.empty((G, num_heads, N), dtype=f32, device=dev)
        dkb = torch.empty((G, N), dtype=f32, device=dev)
    if pattern is not None:
        chunks = lib.mvlt_attention_bwd_chunks(G, P, num_heads)
        _require(chunks > 0, "could not split the pattern groups")
        dpat_part = torch.empty((chunks, P, num_heads, N, N), dtype=f32,
                                device=dev)
        dpat = torch.empty((P, num_heads, N, N), dtype=f32, device=dev)
    _check(lib.mvlt_attention_bwd(_ptr(qkv), _ptr(dctx), _ptr(pattern),
                                  _ptr(key_bias), _ptr(qbias), _ptr(amask),
                                  _ptr(seed), _ptr(p), _ptr(dqkv), _ptr(part),
                                  _ptr(dkb), _ptr(dpat_part), _ptr(dpat), G,
                                  N, C, num_heads, P, float(scale), thresh,
                                  kept, _stream(dev)),
           "biased_attention_bwd")
    biased_attention_bwd.launches += 1
    biased_attention_bwd.adrop_launches += adrop is not None
    biased_attention_bwd.stored_p_launches += p is not None
    if pattern is None:
        return dqkv, dkb
    return dqkv, dkb, dpat


biased_attention_bwd.launches = 0
biased_attention_bwd.adrop_launches = biased_attention_bwd.stored_p_launches = 0


# ---------------------------------------------------------------------------
# K5 layernorm_bwd, column_sum
# ---------------------------------------------------------------------------

def layernorm_bwd_plain(res, gamma, g, eps: float, hmask=None, gres=None,
                        row_scale=None, out_dtype=None):
    """VJP of ``LN(res) * gamma + beta`` over rows of the pre-LN sum ``res``
    (M, C) for the upstream gradient ``g`` (M, C). Returns ``(dres f32, da,
    dgamma, dbeta, db)``: ``dres`` the LN VJP plus the optional incoming
    residual gradient ``gres`` (M, C) (the pre-LN form: ``dres1 = g +
    LN2^T(dh2)`` of a Swin block); ``da = dres * hmask * row_scale`` in
    ``out_dtype`` (default ``g.dtype``), the cotangent of a proj / fc2
    output that the hidden-dropout mask ``hmask`` (M, C) and the f32 row
    scale ``row_scale`` (S,) multiplied (row m takes ``row_scale[m // (M //
    S)]``: the DropPath multiplier); the last three f32 column sums: ``sum g
    * xhat``, ``sum g`` and ``sum da`` (unrounded)."""
    r_ = res.float()
    mu = r_.mean(-1, keepdim=True)
    var = ((r_ - mu) ** 2).mean(-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    xhat = (r_ - mu) * r
    gf = g.float()
    dxhat = gf * gamma.float()
    dres = r * (dxhat - dxhat.mean(-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    if gres is not None:
        dres = dres + gres.float()
    da = dres if hmask is None else dres * hmask.float()
    if row_scale is not None:
        da = da * _row_scale_plain(row_scale, da.shape[0])
    return (dres, da.to(out_dtype or g.dtype), (gf * xhat).sum(0), gf.sum(0),
            da.sum(0))


def layernorm_bwd(res, gamma, g, eps: float, hmask=None, gres=None,
                  row_scale=None, out_dtype=None):
    """K5 wrapper; same contract as :func:`layernorm_bwd_plain`. On CUDA:
    f32 or bf16 res, f32 gamma and row_scale, bf16 or f32 g and gres, bf16
    hmask, a bf16 da, C <= 1024."""
    if not res.is_cuda:
        return layernorm_bwd_plain(res, gamma, g, eps, hmask, gres, row_scale,
                                   out_dtype)
    dev, f32, bf = res.device, torch.float32, torch.bfloat16
    res_bf = res.dtype == bf
    _cuda_arg(res, "res", bf if res_bf else f32, dev, 2)
    M, C = res.shape
    _require(C <= 1024, f"C={C} > 1024")
    _cuda_arg(gamma, "gamma", f32, dev, 1)
    _require(gamma.shape[0] == C, f"gamma must have {C} entries")
    g_f32 = g.dtype == f32
    _cuda_arg(g, "g", f32 if g_f32 else bf, dev, 2)
    _require(tuple(g.shape) == (M, C), f"g must be ({M}, {C})")
    gres_f32 = gres is not None and gres.dtype == f32
    _cuda_arg(gres, "gres", f32 if gres_f32 else bf, dev, 2)
    _require(gres is None or tuple(gres.shape) == (M, C),
             f"gres must be ({M}, {C})")
    _cuda_arg(hmask, "hmask", bf, dev, 2)
    _require(hmask is None or tuple(hmask.shape) == (M, C),
             f"hmask must be ({M}, {C})")
    s_div = _cuda_row_scale(row_scale, M, dev)
    _require((out_dtype or g.dtype) == bf,
             "layernorm_bwd writes da in bf16 on CUDA; pass "
             "out_dtype=torch.bfloat16")
    lib = build()["layernorm_bwd"]
    dres = torch.empty((M, C), dtype=f32, device=dev)
    dres_bf = torch.empty((M, C), dtype=bf, device=dev)
    part = torch.empty((lib.mvlt_layernorm_bwd_blocks(M), 3 * C), dtype=f32,
                       device=dev)
    sums = torch.empty((3, C), dtype=f32, device=dev)
    flags = int(res_bf) | 2 * int(g_f32) | 4 * int(gres_f32)
    _check(lib.mvlt_layernorm_bwd(_ptr(res), _ptr(gamma), _ptr(g),
                                  _ptr(hmask), _ptr(gres), _ptr(row_scale),
                                  _ptr(dres), _ptr(dres_bf), _ptr(part),
                                  _ptr(sums), M, C, float(eps), flags, s_div,
                                  _stream(dev)), "layernorm_bwd")
    layernorm_bwd.launches += 1
    return dres, dres_bf, sums[0], sums[1], sums[2]


layernorm_bwd.launches = 0


def column_sum_plain(x, row_scale=None):
    """Sum over the rows of an (M, N) matrix, in f32. With an f32
    ``row_scale`` (S,) (row m takes ``row_scale[m // (M // S)]``) it returns
    ``(sum of x * scale, x * scale in x.dtype)``."""
    if row_scale is None:
        return x.float().sum(0)
    xs = x.float() * _row_scale_plain(row_scale, x.shape[0])
    return xs.sum(0), xs.to(x.dtype)


def column_sum(x, row_scale=None):
    """K5 column sum; same contract as :func:`column_sum_plain`. On CUDA:
    bf16 or f32 x (bf16 with a row scale), f32 row_scale."""
    if not x.is_cuda:
        return column_sum_plain(x, row_scale)
    dev, f32 = x.device, torch.float32
    x_f32 = x.dtype == f32
    _require(not (x_f32 and row_scale is not None),
             "column_sum with a row scale takes bf16 x")
    _cuda_arg(x, "x", f32 if x_f32 else torch.bfloat16, dev, 2)
    M, N = x.shape
    s_div = _cuda_row_scale(row_scale, M, dev)
    xs = None if row_scale is None else torch.empty_like(x)
    lib = build()["layernorm_bwd"]
    part = torch.empty((lib.mvlt_column_sum_chunks(M, N), N), dtype=f32,
                       device=dev)
    out = torch.empty((N,), dtype=f32, device=dev)
    _check(lib.mvlt_column_sum(_ptr(x), int(x_f32), _ptr(row_scale), _ptr(xs),
                               _ptr(part), _ptr(out), M, N, s_div,
                               _stream(dev)), "column_sum")
    column_sum.launches += 1
    return out if row_scale is None else (out, xs)


column_sum.launches = 0

# the kernels of the inference forward, and every kernel
FORWARD_KERNELS = (gemm, biased_attention, layernorm)
KERNELS = FORWARD_KERNELS + (biased_attention_bwd, layernorm_bwd, column_sum)
# the opt-in modes' launch counts, beside each kernel's ``launches``
MODE_COUNTS = {biased_attention: ("adrop_launches", "save_p_launches"),
               biased_attention_bwd: ("adrop_launches", "stored_p_launches")}

"""The port's hand-written Hopper kernels, their wrappers, and the plain
PyTorch version of each.

K1 ``gemm``, K2 ``biased_attention``, K3 ``layernorm``, K4
``biased_attention_bwd`` and K5 ``layernorm_bwd`` / ``column_sum`` are CUDA
C++ for ``sm_90a`` (sources in ``mvlt_tpu_torch/csrc/``). They are compiled
with ``nvcc`` at first use into ``build/torch_kernels/`` (one shared library
per source, all built in parallel) and bound with ``ctypes``. Every TPU
kernel on the ported paths is rebuilt from these in
:mod:`mvlt_tpu_torch.ops.blocks`.

K1 is a persistent TMA + ``wgmma`` GEMM for the NT, NN and TN layouts with
a fused epilogue; a product with no epilogue whose output tiles fill at most
half the card runs as a deterministic split-K, as :func:`gemm_plan` cuts it
(counted in ``gemm.splitk_launches``). K2 and K4 (its two passes: queries,
then keys; every product on ``wgmma``) run N in one of three forms, as
:func:`attention_form` routes it and :func:`attention_plan` /
:func:`attention_bwd_plan` tile it. The register form, up to N = 160 and in
every window mode up to 288: one warpgroup per 64 query rows of a (group,
head), the scores in registers. The middle form, for the sequence modes at
160 < N <= 288 (the fusion's 180, 201, 221, 278): a producer and two
consumer warpgroups on 128 query rows, k and v whole in shared memory by
TMA, a row's scores in registers, one sweep (K4's second pass is the long
form's). The long form, past N = 288 up to 46,340: the same block, the keys
streamed in 32-key chunks through a four-stage ring in two sweeps. K3
and K5 lay a row on a group of lanes sized to C and move it in 16-byte
words (:func:`row_plan`); K5's column sums run in an order that its plan
alone fixes (:func:`layernorm_bwd_plan`, :func:`column_sum_plan`), through
a few partial rows and a fold, with no atomics.

K2 and K4 have two opt-in modes each: in-kernel attention dropout from a
device seed (``adrop=(seed, rate)``; the Philox stream of
``csrc/philox.cuh``, whose plain version is :func:`adrop_mask_plain`), and
the stored softmax (K2 ``save_p=True`` writes p, K4 ``p=`` reads it). K2
reads q, k, v through explicit strides, so it also takes separate head-major
(G, nH, N, Dh) tensors (:func:`biased_attention_heads`, the layout of
``window_attention``). Each mode, and the middle form, has a launch count of
its own beside ``launches`` (``MODE_COUNTS``).

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
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import NamedTuple, Optional

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
    "mvlt_gemm": ([_vp] * 10 + [_int] * 7 + [_vp, _int, _vp], _int),
    "mvlt_attention": ([_vp] * 3 + [_i64] * 3 + [_vp] + [_i64] * 3 + [_vp] * 7
                       + [_int] * 5 + [_float, _uint, _float, _int, _int, _vp],
                       _int),
    "mvlt_attention_smem": ([_int] * 4, _i64),
    "mvlt_smem_optin": ([], _int),
    "mvlt_layernorm": ([_vp] * 5 + [_int, _int, _float, _int, _vp], _int),
    "mvlt_layernorm_plan": ([_int, _int, _vp], _int),
    "mvlt_attention_bwd": ([_vp] * 14 + [_int] * 5
                           + [_float, _uint, _float, _int, _int, _vp], _int),
    "mvlt_attention_bwd_smem": ([_int] * 4, _i64),
    "mvlt_attention_bwd_scratch": ([_int] * 2, _i64),
    "mvlt_attention_bwd_chunks": ([_int] * 3, _int),
    "mvlt_layernorm_bwd": ([_vp] * 10 + [_int, _int, _float] + [_int] * 4
                           + [_vp], _int),
    "mvlt_layernorm_bwd_plan": ([_int] * 3 + [_vp], _int),
    "mvlt_column_sum": ([_vp, _int] + [_vp] * 4 + [_int] * 5 + [_vp], _int),
    "mvlt_column_sum_plan": ([_int] * 3 + [_vp], _int),
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


# nvcc's flags for every source: sm_90a, and ``--split-compile=0``, which
# runs the compiler's optimisations on all CPUs, so that the many template
# instances of K2 and K4 compile in parallel (``scripts/build_time.sh``: the
# five sources in 35 s against 96 on an NVIDIA H100 80GB HBM3 machine with 8
# cores); ``-Xptxas -v`` keeps ptxas's report
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def build() -> dict:
    """Compile every kernel source (one ``nvcc`` each, all started together)
    unless a library built from the same source and header bytes exists,
    then load them.
    Returns ``{name: ctypes.CDLL}``; raises if any build fails."""
    if _libs:                 # every launch asks: no lock once built
        return _libs
    with _build_lock:
        if _libs:
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs, targets = {}, {}
        headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
        for name, src in SOURCES.items():
            path = _CSRC / src
            digest = hashlib.sha1(path.read_bytes() + headers + " ".join(
                NVCC_FLAGS).encode()).hexdigest()[:12]
            target = BUILD_DIR / f"{name}-{digest}.so"
            targets[name] = target
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(path)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{SOURCES[name]}:\n{out}")
                continue
            # ptxas's report (registers, shared memory, spills per kernel)
            targets[name].with_suffix(".ptxas").write_text(out)
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


def ptxas_report(name: str, fragment: str) -> dict:
    """ptxas's lines for each kernel of library ``name`` (a ``SOURCES``
    key) whose mangled name holds ``fragment``: ``{kernel: [lines]}`` (its
    registers, shared memory, stack, spills and any warning), from the
    report the build wrote beside the library; {} where the library was
    built without one."""
    path = pathlib.Path(build()[name]._name).with_suffix(".ptxas")
    report, kernel = {}, None
    for line in path.read_text().splitlines() if path.exists() else ():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line
            kernel = kernel if fragment in kernel else None
            if kernel:
                report[kernel] = []
        elif kernel and ("ptxas" in line or "bytes" in line):
            report[kernel].append(line.strip())
    return report


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {code}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# the current stream's handle without building a Stream object (several
# microseconds of host time a launch); PyTorch's own accessor where it has one
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device: torch.device) -> int:
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _cuda_arg(t: Optional[torch.Tensor], name: str, dtype: torch.dtype,
              device: torch.device, ndim: int) -> None:
    # the messages are formatted only on failure: this runs for every
    # tensor of every launch, on the host's critical path
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


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
# csrc/gemm.cu's output tile and k-tile
GEMM_TILE_M, GEMM_TILE_N, GEMM_TILE_K = 128, 128, 64
H100_SMS = 132
# fewest k-tiles a split-K slice takes, so that its mainloop amortises the
# partial tile it writes and the fold reads back
SPLITK_MIN_KTILES = 4


class GemmPlan(NamedTuple):
    """How K1 runs one product: ``splits`` slices of the contraction, slice z
    covering ``slices[z] = (k_begin, k_end)``; each slice's f32 partial is
    summed in slice order. ``splits == 1``: one pass, epilogue included."""
    splits: int
    slices: tuple


@functools.lru_cache(maxsize=4096)
def gemm_plan(M: int, N: int, K: int, sms: int = H100_SMS,
              epilogue: bool = False) -> GemmPlan:
    """K1's plan for an (M, N) output over a contraction of K (any layout).

    The contraction is split only for a product with no epilogue whose
    output tiles fill at most half of the ``sms`` streaming multiprocessors
    (the weight gradients dW = dY^T X of the Swin stages): into
    ``sms // tiles`` slices, at most one per ``SPLITK_MIN_KTILES`` k-tiles,
    each a run of whole k-tiles (the last may end in a partial one), as
    even as the k-tiles allow. ``csrc/gemm.cu`` cuts the slices by the same
    rule (``kt0 = z * ktiles / splits``)."""
    tiles = -(-M // GEMM_TILE_M) * -(-N // GEMM_TILE_N)
    ktiles = -(-K // GEMM_TILE_K)
    splits = 1
    if not epilogue and 2 * tiles <= sms:
        splits = max(1, min(sms // tiles, ktiles // SPLITK_MIN_KTILES))
    bounds = [z * ktiles // splits * GEMM_TILE_K for z in range(splits + 1)]
    slices = tuple((bounds[z], min(bounds[z + 1], K)) for z in range(splits))
    return GemmPlan(splits, slices)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    output row is written). A product with no epilogue may run as a split-K
    (:func:`gemm_plan`): the slices' f32 partials go to a workspace and a
    second kernel sums them in order (counted in ``splitk_launches``)."""
    if not a.is_cuda:
        return gemm_plain(a, w, bias, gelu=gelu, residual=residual,
                          residual_index=residual_index,
                          store_index=store_index, layout=layout,
                          out_dtype=out_dtype, gelu_grad=gelu_grad,
                          save_preact=save_preact, emask=emask,
                          row_scale=row_scale)
    dev, bf, f32 = a.device, torch.bfloat16, torch.float32
    # every check formats its message only on failure (host time per call)
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
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
    if wk != K:
        raise ValueError(f"w {tuple(w.shape)} does not match a "
                         f"{tuple(a.shape)} in layout {layout}")
    inner = M if layout == "tn" else K
    if inner % 8 or N % 8:
        raise ValueError(f"the contiguous dims ({inner}, {N}) must be "
                         "multiples of 8")
    _cuda_arg(bias, "bias", bf, dev, 1)
    if bias is not None and bias.shape[0] != N:
        raise ValueError("bias must have N entries")
    res_f32 = residual is not None and residual.dtype == f32
    _cuda_arg(residual, "residual", f32 if res_f32 else bf, dev, 2)
    if residual is not None:
        if residual.shape[1] != N:
            raise ValueError("residual must have N columns")
        if residual_index is None and residual.shape[0] != M:
            raise ValueError("residual must have M rows")
    elif residual_index is not None:
        raise ValueError("residual_index needs a residual")
    for name, idx in (("residual_index", residual_index),
                      ("store_index", store_index)):
        _cuda_arg(idx, name, torch.int32, dev, 1)
        if idx is not None and idx.shape[0] != M:
            raise ValueError(f"{name} must have M entries")
    if gelu_grad is not None:
        if gelu or save_preact:
            raise ValueError("gelu_grad excludes gelu and save_preact")
        _cuda_arg(gelu_grad, "gelu_grad", f32, dev, 2)
        if tuple(gelu_grad.shape) != (M, N):
            raise ValueError(f"gelu_grad must be ({M}, {N})")
    _cuda_arg(emask, "emask", bf, dev, 2)
    if emask is not None and tuple(emask.shape) != (M, N):
        raise ValueError(f"emask must be ({M}, {N})")
    s_div = _cuda_row_scale(row_scale, M, dev)
    out_dtype = out_dtype or bf
    if out_dtype not in (bf, f32):
        raise ValueError(f"out_dtype {out_dtype} is not bf16 or f32")
    y = torch.empty((M, N), dtype=out_dtype, device=dev)
    pre = torch.empty((M, N), dtype=f32, device=dev) if save_preact else gelu_grad
    epi = 2 if gelu_grad is not None else int(gelu)
    flags = int(out_dtype == f32) | (2 * int(res_f32))
    epilogue = (gelu or pre is not None or bias is not None
                or residual is not None or store_index is not None
                or emask is not None or row_scale is not None)
    splits = gemm_plan(M, N, K, _sm_count(dev.index), epilogue).splits
    ws = (torch.empty((splits, M, N), dtype=f32, device=dev)
          if splits > 1 else None)
    _check(build()["gemm"].mvlt_gemm(
        _ptr(a), _ptr(w), _ptr(bias), _ptr(residual), _ptr(residual_index),
        _ptr(store_index), _ptr(y), _ptr(pre), _ptr(emask), _ptr(row_scale),
        M, N, K, _LAYOUTS[layout], epi, flags, s_div, _ptr(ws), splits,
        _stream(dev)), "gemm")
    gemm.launches += 1
    gemm.splitk_launches += splits > 1
    return (y, pre) if save_preact else y


gemm.launches = gemm.splitk_launches = 0


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
    if not (tuple(seed.shape) == (2,) and seed.dtype == torch.int32):
        raise ValueError(f"adrop seed must be a (2,) int32 tensor, got "
                         f"{tuple(seed.shape)} {seed.dtype}")


def adrop_mask_plain(seed: torch.Tensor, B: int, num_heads: int, N: int,
                     rate: float, head0: int = 0) -> torch.Tensor:
    """The attention-dropout mask that K2 draws and K4 regenerates, (B, nH,
    N, N) f32 of 0 or f32(1 / keep), on ``seed``'s device and without a
    host read of it. ``seed``: (2,) int32, two 16-bit halves (hi, lo).
    Element (b, h, i, j) takes word ``e % 4`` of Philox4x32-10 with key
    ``(hi * 65536 + lo, 0)`` and counter ``(e // 4, b * 256 + h, 0, 0)``,
    e = i * N + j, b the absolute sample: it depends on nothing but the
    seed, b, h, i, j and N. ``head0``: h runs over ``head0 .. head0 + nH -
    1`` (a tensor-parallel rank's heads), so the result is that slice of
    the mask of all heads."""
    _adrop_seed(seed)
    _require(0 <= head0 and head0 + num_heads <= 256,
             f"heads {head0}..{head0 + num_heads - 1} past 256")
    thresh, kept = adrop_constants(rate)
    dev, i64 = seed.device, torch.int64
    s = seed.to(i64)
    key0 = s[0] * 65536 + s[1]                # 0-d, stays on the device
    e = torch.arange(N * N, device=dev, dtype=i64)
    b = torch.arange(B, device=dev, dtype=i64)[:, None, None]
    h = torch.arange(head0, head0 + num_heads, device=dev,
                     dtype=i64)[None, :, None]
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
# csrc/attention.cu's tiling: a block is one warpgroup on 64 query rows of
# one (group, head); S is computed in chunks of 32 keys (one m64n32 product
# each), at most 9 of them (144 f32 registers a thread), so N <= 288 in the
# register-resident form
ATTENTION_ROWS, ATTENTION_KEYS, ATTENTION_MAX_CHUNKS = 64, 32, 9
ATTENTION_MAX_N = ATTENTION_KEYS * ATTENTION_MAX_CHUNKS
# past it, the long form of K2 and K4 (csrc/attention.cu,
# csrc/attention_bwd.cu): a block of three warpgroups, a producer that keeps
# a ring of ATTENTION_LONG_STAGES stages full (TMA for the bf16 rows,
# cp.async for the bias tiles) and two consumers of 64 rows each, so
# ATTENTION_LONG_ROWS rows a block (queries in K2 and K4's first pass, keys
# in its second) against the other side streamed in chunks of
# ATTENTION_LONG_CHUNK rows; one block an SM; K4's first pass sweeps the
# keys ATTENTION_LONG_SWEEPS times. Its shared memory and registers do not
# grow with N; N * N element indices stay 32-bit up to 46,340. It takes the
# sequence modes (key bias, qbias, amask, in-kernel dropout) on the packed
# rows; the window modes (pattern, stored p, head-major) keep the register
# form and its N <= 288.
ATTENTION_LONG_ROWS, ATTENTION_LONG_CHUNK, ATTENTION_LONG_STAGES = 128, 32, 4
ATTENTION_LONG_SWEEPS, ATTENTION_LONG_SM_BLOCKS = 2, 1
ATTENTION_LONG_MAX_N = 46340
# between them, the middle form of K2 and of K4's first pass (K4's second
# pass is the long form's): the long form's block on 128 query rows, with k
# and v whole in shared memory (each 32-key chunk on a TMA barrier of its
# own), a row's scores in the consumers' registers and one sweep over the
# keys; the bias tiles through a ring of ATTENTION_MID_STAGES stages, each
# holding a qbias tile and the key bias or, later, an amask tile. It takes
# the sequence modes at 6-9 key chunks (161 <= N <= 288), and the plan moves
# them off the register form at its first N: at the fusion lengths 180-278
# it beat the register form in every mode on the card
# (`chip_smoke.py --mid-n`; PERF.md, Findings)
ATTENTION_MID_STAGES, ATTENTION_MID_MIN_N = 5, 161
# the forms, in the order of their codes in csrc (`form` of mvlt_attention
# and mvlt_attention_bwd)
ATTENTION_FORMS = ("register", "middle", "long")
# bias-tile bytes a ring stage holds (csrc's QB_TILE, AM_TILE, KB_TILE and
# their pass-2 forms): K2 and K4's first pass, 128 rows of 32 qbias f32
# (rows padded to 160 bytes) and amask bf16 (80), the key bias's 32 f32;
# K4's second pass, 32 query rows of the block's 128 keys, qbias (528) and
# amask (264), each query's four statistics and four keep words
_LONG_ROW_TILES = (ATTENTION_LONG_ROWS * (160 + 80 + 4)
                   + ATTENTION_LONG_CHUNK * 4)
_LONG_COL_TILES = ATTENTION_LONG_CHUNK * (528 + 264 + 4 * 4 + 4 * 4)
# the middle form's second pass (the long form's; with an amask at odd N its
# rows staged 16 bytes at a time from the boundary at or before each): amask
# rows padded to 272 bytes and each query row's shift beside the tiles
_MID_COL_TILES = ATTENTION_LONG_CHUNK * (528 + 272 + 4 * 4 + 4 * 4 + 1)
_MID_STAGE = ATTENTION_LONG_ROWS * 160 + ATTENTION_LONG_CHUNK * 4


def _long_smem(cols: int, operands: int, tiles: int) -> int:
    """Shared memory of a long-form block: 1024 bytes of slack for the
    swizzle's alignment, ``operands`` bf16 operands of 128 rows, a ring
    stage's two 32-row chunks and ``tiles`` bytes of bias tiles a stage,
    128 bytes of mbarriers."""
    rows = operands * ATTENTION_LONG_ROWS + ATTENTION_LONG_STAGES * 2 * \
        ATTENTION_LONG_CHUNK
    return 1024 + rows * cols * 2 + ATTENTION_LONG_STAGES * tiles + 128


def _mid_smem(cols: int, operands: int, chunks: int) -> int:
    """Shared memory of a middle-form block (K2, K4's first pass): 1024
    bytes of slack, ``operands`` bf16 operands of 128 rows, k and v over
    ``chunks`` whole 32-key chunks, the ring's stages, a keep word per row
    and chunk, 256 bytes of mbarriers."""
    rows = operands * ATTENTION_LONG_ROWS + 2 * chunks * ATTENTION_KEYS
    return (1024 + rows * cols * 2 + ATTENTION_MID_STAGES * _MID_STAGE
            + chunks * ATTENTION_LONG_ROWS * 4 + 256)


# the shared memory an H100 SM gives its blocks, and what it keeps per block
H100_SMEM_SM, SMEM_BLOCK_RESERVED = 233472, 1024


def attention_min_blocks(chunks: int) -> int:
    """Blocks K2 keeps on an SM at ``chunks`` key chunks (``min_blocks`` in
    csrc/attention.cu: its register cap)."""
    return (6 if chunks <= 2 else 5 if chunks <= 3 else 4 if chunks <= 4
            else 3 if chunks <= 6 else 2)


class AttentionPlan(NamedTuple):
    """How K2 runs one (N, Dh) in its :attr:`form`: ``tiles`` blocks per
    (group, head), each on :attr:`rows` query rows against ``key_chunks``
    chunks of 32 keys; rows of ``head_cols`` bf16 columns in shared memory
    (the head dim zero-padded to one swizzle row); ``smem`` bytes of shared
    memory a block, and ``mask_smem`` more when an amask is given. The
    register form: one warpgroup on 64 rows, the scores in registers, an
    amask's 64 rows staged where that keeps :func:`attention_min_blocks`
    blocks on an SM (else 0: read from device memory). The middle form: a
    producer and two consumer warpgroups on 128 rows, k and v whole in
    shared memory, the scores in registers, one sweep; its bias tiles
    through a ring of :attr:`stages` stages. The long form: the same block,
    the keys streamed in chunks of ``ATTENTION_LONG_CHUNK`` through a ring
    of :attr:`stages` stages, twice (the row statistics, then P V); ``smem``
    the same whatever N is. Neither staged form has ``mask_smem``."""
    tiles: int
    key_chunks: int
    head_cols: int
    smem: int
    mask_smem: int
    form: str = "register"

    @property
    def rows(self) -> int:
        """Query rows a block."""
        return ATTENTION_ROWS if self.form == "register" else \
            ATTENTION_LONG_ROWS

    @property
    def stages(self) -> int:
        """Stages of the ring (0: the register form has none)."""
        return {"register": 0, "middle": ATTENTION_MID_STAGES,
                "long": ATTENTION_LONG_STAGES}[self.form]

    @property
    def sm_blocks(self) -> int:
        """Blocks an SM holds (the register form's register cap)."""
        return (attention_min_blocks(self.key_chunks)
                if self.form == "register" else ATTENTION_LONG_SM_BLOCKS)


def _head_cols(Dh: int) -> int:
    return 32 if Dh <= 32 else 64


def attention_form(N: int, window: bool = False, *, backward: bool = False,
                   amask: bool = False) -> str:
    """The form K2 (K4 with ``backward``) runs N in, with or without an
    ``amask``, as the forms measured on an H100 (`chip_smoke.py --mid-n`;
    PERF.md, Findings): the register form up to ``ATTENTION_MID_MIN_N - 1``
    and in every window mode (pattern, stored p, head-major: N <= 288); up
    to ``ATTENTION_MAX_N`` K2's middle form, and K4's where an amask's rows
    start 2 bytes off 4 (odd N; the long form copies them 2 bytes at a
    time: at 201 and 221 the middle form took 0.342 and 0.368 ms as graphs
    against its 0.783 and 0.850), else K4's long form (it beat the middle
    form's pass 1, whose dp round trips a chunk cost more than the long
    form's second sweep: 0.247 against 0.276 ms at 221 with a key bias,
    0.416 against 0.497 at 278); the long form past 288 (which no window
    mode takes: :func:`check_attention_fits` refuses them there)."""
    if N > ATTENTION_MAX_N:
        return "long"
    if window or N < ATTENTION_MID_MIN_N:
        return "register"
    return "long" if backward and not (amask and N % 2) else "middle"


def _form_of(N: int, Dh: int, kernel: str, form: Optional[str]) -> str:
    """``form``, or the plan's form for N, after checking that it takes
    (N, Dh); raises ``ValueError`` for N outside 1 ..
    ``ATTENTION_LONG_MAX_N`` and for a form that does not take N."""
    if not 0 < N <= ATTENTION_LONG_MAX_N:
        raise ValueError(
            f"{kernel}: N={N}, head dim {Dh} is beyond the kernel's N <= "
            f"{ATTENTION_LONG_MAX_N} (the long form's i * N + j element "
            "indices are 32-bit)")
    form = form or attention_form(N, backward=kernel.endswith("_bwd"))
    if form not in ATTENTION_FORMS:
        raise ValueError(f"{kernel}: no form {form!r} (one of "
                         f"{ATTENTION_FORMS})")
    if form == "register" and N > ATTENTION_MAX_N:
        raise ValueError(f"{kernel}: N={N}, head dim {Dh}: the register "
                         f"form holds N <= {ATTENTION_MAX_N} keys")
    if form == "middle" and not ATTENTION_MID_MIN_N <= N <= ATTENTION_MAX_N:
        raise ValueError(f"{kernel}: N={N}, head dim {Dh}: the middle form "
                         f"takes {ATTENTION_MID_MIN_N} <= N <= "
                         f"{ATTENTION_MAX_N}")
    return form


def _check_head_dim(Dh: int, what: str) -> None:
    if not (Dh > 0 and Dh % 16 == 0 and Dh <= 64):
        raise ValueError(
            f"{what}head dim {Dh} is not a multiple of 16 up to 64 (the wgmma "
            "k16 steps over one swizzle row)")


@functools.lru_cache(maxsize=1024)
def attention_plan(N: int, Dh: int, form: Optional[str] = None
                   ) -> AttentionPlan:
    """K2's tile plan for sequences of N at head dim Dh (``smem_bytes`` in
    csrc/attention.cu) in ``form``, by default :func:`attention_form`'s for
    K2's sequence modes: the register form up to N = 160, the middle form up
    to ``ATTENTION_MAX_N``, the long form beyond (the window modes take the
    register form: :func:`check_attention_fits`). Raises ``ValueError`` for
    a head dim that is not 16, 32, 48 or 64, for N outside 1 ..
    ``ATTENTION_LONG_MAX_N`` and for a form that does not take N."""
    _check_head_dim(Dh, "biased_attention: ")
    cols = _head_cols(Dh)
    form = _form_of(N, Dh, "biased_attention", form)
    chunks = -(-N // ATTENTION_KEYS)
    if form == "long":
        return AttentionPlan(-(-N // ATTENTION_LONG_ROWS),
                             -(-N // ATTENTION_LONG_CHUNK), cols,
                             _long_smem(cols, 1, _LONG_ROW_TILES), 0, form)
    if form == "middle":
        return AttentionPlan(-(-N // ATTENTION_LONG_ROWS), chunks, cols,
                             _mid_smem(cols, 1, chunks), 0, form)
    smem = (ATTENTION_ROWS + 2 * chunks * ATTENTION_KEYS) * cols * 2 + 1024
    rows = ATTENTION_ROWS * N * 2 + 16
    budget = H100_SMEM_SM // attention_min_blocks(chunks) - SMEM_BLOCK_RESERVED
    return AttentionPlan(-(-N // ATTENTION_ROWS), chunks, cols, smem,
                         rows if smem + rows <= budget else 0)


def attention_smem_bytes(N: int, Dh: int, amask: bool = False,
                         form: Optional[str] = None) -> int:
    """Shared memory of one K2 block of ``form`` (the plan's by default;
    ``mvlt_attention_smem``): the register form's q's 64 rows, k and v
    padded to whole 32-key chunks, bf16 rows of 32 or 64 columns, 1024
    bytes of alignment slack, and with ``amask`` the tile's 64 amask rows
    (+ 16 bytes) where they are staged; the middle and long forms' blocks
    (:func:`attention_plan`); -1 where that form does not take (N, Dh)."""
    try:
        plan = attention_plan(N, Dh, form)
    except ValueError:
        return -1
    return plan.smem + (plan.mask_smem if amask else 0)


def check_attention_layout(ptrs, strides) -> None:
    """Raise ``ValueError`` unless K2's 16-byte loads and stores can take
    these byte addresses (q, k, v, ctx) and element strides (bf16)."""
    if any(p % 16 for p in ptrs):
        raise ValueError("biased_attention: q, k, v and ctx must start on "
                         "16-byte boundaries (addresses mod 16: "
                         f"{[p % 16 for p in ptrs]})")
    if any(s % 8 for s in strides):
        raise ValueError("biased_attention: every group, head and row stride "
                         "must be a multiple of 8 elements (16 bytes), got "
                         f"{tuple(strides)}")


class AttentionBwdPlan(NamedTuple):
    """How K4 runs one (N, Dh) in its :attr:`form` (csrc/attention_bwd.cu),
    in two passes: pass 1 on :attr:`rows` query rows a block against every
    key, pass 2 on as many keys against every query, so ``tiles`` blocks of
    each per (group, head); ``chunks`` 32-wide chunks of the other side;
    rows of ``head_cols`` bf16 columns in shared memory; ``dq_smem`` /
    ``dkv_smem`` bytes of shared memory a block of pass 1 / pass 2,
    ``mask_smem`` more in pass 1 when an amask is given, and
    ``pattern_smem`` more for pass 2's sum of ds over its groups in pattern
    mode; ``scratch_words`` f32 words of scratch per (group, head): each
    query's row max, row sum and rowsum(p * dp), then its keep bits of the
    regenerated dropout, one word per 32 keys. The register form: one
    warpgroup on 64 rows, pass 1 keeping S over every chunk in registers,
    an amask's 64 rows staged in pass 1 where that keeps
    :func:`attention_bwd_min_blocks` blocks on an SM (0: read from device
    memory). The middle form (no pattern mode): pass 1 on the long form's
    block of 128 rows with k and v whole in shared memory, S in registers
    and one sweep of S, its bias tiles through a ring of :attr:`stages`
    stages; pass 2 the long form's. The long form (no pattern mode): each
    pass a block of a producer and two consumer warpgroups on 128 rows, the
    other side streamed in chunks of ``ATTENTION_LONG_CHUNK`` through a
    ring of :attr:`stages` stages with its bias tiles (pass 1 sweeps the
    keys :attr:`sweeps` times: the row statistics with rd folded in, then
    ds and dq), ``dq_smem`` and ``dkv_smem`` the same at every N. Neither
    staged form has ``mask_smem`` or ``pattern_smem``."""
    tiles: int
    chunks: int
    head_cols: int
    dq_smem: int
    dkv_smem: int
    mask_smem: int
    pattern_smem: int
    scratch_words: int
    form: str = "register"

    @property
    def rows(self) -> int:
        """Rows a block of either pass (queries in pass 1, keys in pass 2)."""
        return ATTENTION_ROWS if self.form == "register" else \
            ATTENTION_LONG_ROWS

    @property
    def stages(self) -> int:
        """Stages of pass 1's ring (0: the register form has none)."""
        return {"register": 0, "middle": ATTENTION_MID_STAGES,
                "long": ATTENTION_LONG_STAGES}[self.form]

    @property
    def sm_blocks(self) -> int:
        """Blocks of pass 1 an SM holds (the register form's register cap)."""
        return (attention_bwd_min_blocks(self.chunks)
                if self.form == "register" else ATTENTION_LONG_SM_BLOCKS)

    @property
    def sweeps(self) -> int:
        """Pass 1's sweeps of S over the keys (the register and middle
        forms hold every key's scores at once)."""
        return ATTENTION_LONG_SWEEPS if self.form == "long" else 1


def attention_bwd_min_blocks(chunks: int) -> int:
    """Blocks of K4's first pass an SM keeps at ``chunks`` key chunks
    (``dq_min_blocks`` in csrc/attention_bwd.cu: its register cap)."""
    return 4 if chunks <= 1 else 3 if chunks <= 2 else 2


@functools.lru_cache(maxsize=1024)
def attention_bwd_plan(N: int, Dh: int, form: Optional[str] = None
                       ) -> AttentionBwdPlan:
    """K4's tile plan for sequences of N at head dim Dh (``smem_bytes`` and
    ``scratch_words`` in csrc/attention_bwd.cu) in ``form``, by default
    :func:`attention_form`'s for K4 without an amask: the register form up
    to N = 160, the long form beyond (with an amask at odd N up to 288 the
    middle form; the pattern and stored-p modes take the register form:
    :func:`check_attention_fits`). Raises ``ValueError``, naming N and the
    head dim, for a head dim that is not 16, 32, 48 or 64, for N outside 1
    .. ``ATTENTION_LONG_MAX_N`` and for a form that does not take N."""
    _check_head_dim(Dh, f"biased_attention_bwd: N={N}, head dim {Dh}: the ")
    form = _form_of(N, Dh, "biased_attention_bwd", form)
    chunks = -(-N // ATTENTION_KEYS)
    cols = _head_cols(Dh)
    words = 3 * N + N * chunks
    if form != "register":
        dkv = _long_smem(cols, 2, _LONG_COL_TILES if form == "long"
                         else _MID_COL_TILES)
        dq = (_long_smem(cols, 2, _LONG_ROW_TILES) if form == "long"
              else _mid_smem(cols, 2, chunks))
        return AttentionBwdPlan(-(-N // ATTENTION_LONG_ROWS), chunks, cols,
                                dq, dkv, 0, 0, words, form)
    rows = chunks * ATTENTION_KEYS
    dq = (2 * ATTENTION_ROWS + 2 * rows) * cols * 2 + 1024
    mask = ATTENTION_ROWS * N * 2 + 16
    budget = (H100_SMEM_SM // attention_bwd_min_blocks(chunks)
              - SMEM_BLOCK_RESERVED)
    return AttentionBwdPlan(-(-N // ATTENTION_ROWS), chunks, cols, dq,
                            dq + 6 * rows * 4,
                            mask if dq + mask <= budget else 0,
                            ATTENTION_ROWS * rows * 4, words)


def attention_bwd_smem_bytes(N: int, Dh: int, pattern: bool = False,
                             amask: bool = False,
                             form: Optional[str] = None) -> int:
    """Shared memory of K4's larger pass (``mvlt_attention_bwd_smem``) in
    ``form`` (by default the one :func:`attention_form` gives the call, and
    in pattern mode the register form), in pattern mode or not, with an
    amask or not; -1 where that form does not take (N, Dh), and in pattern
    mode outside the register form (past N = 288)."""
    if form is None and 0 < N <= ATTENTION_LONG_MAX_N:
        form = ("register" if pattern and N <= ATTENTION_MAX_N else
                attention_form(N, backward=True, amask=amask))
    try:
        plan = attention_bwd_plan(N, Dh, form)
    except ValueError:
        return -1
    if plan.form != "register":
        return -1 if pattern else max(plan.dq_smem, plan.dkv_smem)
    return max(plan.dq_smem + (plan.mask_smem if amask else 0),
               plan.dkv_smem + (plan.pattern_smem if pattern else 0))


def max_attention_n(Dh: int, smem_optin: int = H100_SMEM_OPTIN, *,
                    backward: bool = False, amask: bool = False,
                    window: bool = False) -> int:
    """The largest N such that K2 (with or without an amask; or, with
    ``backward``, K4 in pattern mode; with ``window``, K2 in a window mode)
    admits every N up to it at head dim ``Dh`` on a card whose blocks may
    opt in to ``smem_optin`` bytes, each N in the form the plan gives it:
    at most 288 in the window modes (the register form),
    ``ATTENTION_LONG_MAX_N`` in the sequence modes where the register, the
    middle and then the long form fit the card."""
    def need(n):
        if backward:
            return attention_bwd_smem_bytes(n, Dh, pattern=True, amask=amask)
        return attention_smem_bytes(n, Dh, amask,
                                    attention_form(n, window) if n <=
                                    ATTENTION_MAX_N else None)
    n = 0
    while n < ATTENTION_MAX_N and 0 < need(n + 1) <= smem_optin:
        n += 1
    if n == ATTENTION_MAX_N and not (backward or window) and 0 < need(
            n + 1) <= smem_optin:
        return ATTENTION_LONG_MAX_N
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
                         backward: bool = False, pattern: bool = False,
                         amask: bool = False, window: str = "",
                         form: Optional[str] = None):
    """Raise ``ValueError`` unless K2 (with ``amask`` staging its rows; K4,
    with ``pattern`` in its pattern mode) takes (N, Dh) on a card whose
    blocks may opt in to ``smem_optin`` bytes of shared memory, by its tile
    plan (:func:`attention_plan`, :func:`attention_bwd_plan`) in ``form``
    (by default the plan's); returns that plan. ``window`` names a
    window-only mode of the call ("pattern", "stored p", "head-major";
    ``pattern`` implies it), which only the register form takes: such a
    call runs in the register form, and past N = 288 (or in another form
    asked for) it is refused."""
    window = window or ("pattern" if pattern else "")
    if backward:
        plan_of, kernel = attention_bwd_plan, "biased_attention_bwd"
    else:
        plan_of, kernel = attention_plan, "biased_attention"
    # raises for what the kernel cannot take
    plan = plan_of(N, Dh, form or (attention_form(
        N, bool(window), backward=backward, amask=amask) if N > 0 else None))
    if window and plan.form != "register":
        raise ValueError(
            f"{kernel}: N={N}, head dim {Dh}: the {window} mode keeps the "
            f"register-resident tiling, N <= {ATTENTION_MAX_N}; the middle "
            "and long forms take the sequence modes only (key bias, qbias, "
            "amask, in-kernel dropout)")
    need = (attention_bwd_smem_bytes(N, Dh, pattern, amask, plan.form)
            if backward else plan.smem + (plan.mask_smem if amask else 0))
    if need > smem_optin:       # formatted only on failure: every call asks
        top = max_attention_n(Dh, smem_optin, backward=backward, amask=amask,
                              window=bool(window))
        raise ValueError(
            f"{kernel}: N={N}, head dim {Dh} needs {need} bytes of shared "
            f"memory per block, the card allows {smem_optin} (N <= {top} at "
            "this head dim)")
    return plan


def _check_masks(qbias, amask, G: int, num_heads: int, N: int) -> None:
    if not (qbias is None or tuple(qbias.shape) == (G, N, N)):
        raise ValueError(f"qbias must be ({G}, {N}, {N}), got "
                         f"{None if qbias is None else tuple(qbias.shape)}")
    if not (amask is None or tuple(amask.shape) == (G, num_heads, N, N)):
        raise ValueError(f"amask must be ({G}, {num_heads}, {N}, {N}), got "
                         f"{None if amask is None else tuple(amask.shape)}")


def _attention_geometry(qkv, num_heads: int, seq_n: int, backward: bool,
                        pattern: bool = False, amask: bool = False,
                        window: str = "", form: Optional[str] = None):
    """(G, C, Dh, plan) of fused rows on the card, after the shape and
    shared-memory checks (``window``: the call's window-only mode;
    ``form``: the form asked for, else the plan's)."""
    rows, C3 = qkv.shape
    N = seq_n
    if not (C3 % 3 == 0 and (C3 // 3) % num_heads == 0):
        raise ValueError(f"qkv width {C3} is not 3 * heads * head_dim")
    C = C3 // 3
    Dh = C // num_heads
    if N <= 0 or rows % N:
        raise ValueError(f"rows {rows} not groups of N={N}")
    plan = check_attention_fits(N, Dh, smem_optin(qkv.device),
                                backward=backward, pattern=pattern,
                                amask=amask, window=window, form=form)
    return rows // N, C, Dh, plan


def _cuda_masks(qbias, amask, G, num_heads, N, dev, form: str) -> None:
    _cuda_arg(qbias, "qbias", torch.float32, dev, 3)
    _cuda_arg(amask, "amask", torch.bfloat16, dev, 4)
    _check_masks(qbias, amask, G, num_heads, N)
    # the middle form may stage an amask's rows from the 16-byte boundary
    # at or before each row's start, which must lie in the tensor
    if form == "middle" and amask is not None and amask.data_ptr() % 16:
        raise ValueError("the middle form needs an amask that starts on a "
                         "16-byte boundary")


def _check_adrop(adrop, amask, save_mask: bool = False) -> None:
    _require(adrop is None or amask is None,
             "adrop and amask exclude each other")
    _require(adrop is not None or not save_mask, "save_mask needs adrop")
    if adrop is not None:
        _adrop_seed(adrop[0])


def adrop_head0(adrop) -> int:
    """The global index of head 0 in ``adrop``: ``(seed, rate)`` is 0;
    ``(seed, rate, head0)`` draws the mask of heads ``head0 ..`` (a
    tensor-parallel rank's heads draw what one device draws for them)."""
    return int(adrop[2]) if adrop is not None and len(adrop) > 2 else 0


def _adrop_mask(adrop, G: int, num_heads: int, N: int) -> torch.Tensor:
    return adrop_mask_plain(adrop[0], G, num_heads, N, adrop[1],
                            head0=adrop_head0(adrop))


def _cuda_adrop(adrop, num_heads: int, dev):
    """(seed, threshold, kept value, head0) of ``adrop`` on the card."""
    if adrop is None:
        return None, 0, 0.0, 0
    seed, rate = adrop[:2]
    head0 = adrop_head0(adrop)
    _cuda_arg(seed, "adrop seed", torch.int32, dev, 1)
    if head0 < 0 or head0 + num_heads > 256:
        raise ValueError(f"heads {head0}..{head0 + num_heads - 1} past 256")
    return (seed, *adrop_constants(rate), head0)


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
    ``adrop_mask_plain(seed, G, nH, N, rate)`` (group g is sample g);
    ``(seed, rate, head0)`` draws heads ``head0 ..`` of it (a
    tensor-parallel rank's).
    Returns ctx (G*N, C), or with ``save_p`` / ``save_mask`` the tuple
    ``(ctx, [p], [mask])``: p (G, nH, N, N) the softmax before any dropout
    mask in qkv's dtype, mask (G, nH, N, N) f32 the dropout mask drawn."""
    rows, C3 = qkv.shape
    C, N = C3 // 3, seq_n
    G, Dh = rows // N, C3 // 3 // num_heads
    _check_masks(qbias, amask, G, num_heads, N)
    _check_adrop(adrop, amask, save_mask)
    if adrop is not None:
        amask = _adrop_mask(adrop, G, num_heads, N)
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
                     save_mask: bool = False, form: Optional[str] = None):
    """K2 wrapper; same contract as :func:`biased_attention_plain`. On CUDA:
    bf16 qkv and amask, f32 biases, an int32 device seed, a head dim of 16,
    32, 48 or 64, at most 256 heads with ``adrop``, and N <= 46,340, in the
    middle form (160 < N <= 288) and the long form (past N = 288) with no
    pattern and no ``save_p`` (:func:`attention_plan`,
    :func:`check_attention_fits`); anything else raises ``ValueError``
    before a launch. Two calls on the same inputs are bitwise equal.
    ``form`` ("register", "middle", "long") overrides the plan's form, for
    the card's checks that time the forms against each other; callers leave
    it to the plan. ``adrop`` counts in ``adrop_launches``, ``save_p`` in
    ``save_p_launches``, the middle form in ``mid_launches``, all also in
    ``launches``."""
    if not qkv.is_cuda:
        return biased_attention_plain(qkv, num_heads, seq_n, scale,
                                      pattern, key_bias, qbias, amask,
                                      adrop=adrop, save_p=save_p,
                                      save_mask=save_mask)
    dev = qkv.device
    _cuda_arg(qkv, "qkv", torch.bfloat16, dev, 2)
    rows = qkv.shape[0]
    N = seq_n
    window = "pattern" if pattern is not None else "stored p" if save_p else ""
    G, C, _, plan = _attention_geometry(
        qkv, num_heads, N, backward=False, amask=amask is not None,
        window=window, form=form or attention_form(
            N, bool(window), amask=amask is not None))
    _cuda_arg(pattern, "pattern", torch.float32, dev, 4)
    P = 1
    if pattern is not None:
        P = pattern.shape[0]
        if tuple(pattern.shape[1:]) != (num_heads, N, N) or G % P:
            raise ValueError(f"pattern {tuple(pattern.shape)} does not fit "
                             f"{G} groups of ({num_heads}, {N}, {N})")
    _cuda_arg(key_bias, "key_bias", torch.float32, dev, 2)
    if not (key_bias is None or tuple(key_bias.shape) == (G, N)):
        raise ValueError(f"key_bias must be ({G}, {N})")
    _cuda_masks(qbias, amask, G, num_heads, N, dev, plan.form)
    _check_adrop(adrop, amask, save_mask)
    seed, thresh, kept, head0 = _cuda_adrop(adrop, num_heads, dev)
    ctx = torch.empty((rows, C), dtype=torch.bfloat16, device=dev)
    tiles = (G, num_heads, N, N)
    pst = torch.empty(tiles, dtype=torch.bfloat16, device=dev) if save_p else None
    mask = torch.empty(tiles, dtype=torch.float32, device=dev) if save_mask else None
    # q, k, v: the three C-wide column blocks of the fused rows
    col = C * qkv.element_size()
    Dh = C // num_heads
    ptrs = [qkv.data_ptr() + i * col for i in range(3)]
    check_attention_layout(ptrs + [ctx.data_ptr()], (N * 3 * C, Dh, 3 * C))
    _launch_attention(ptrs, (N * 3 * C, Dh, 3 * C), ctx, (N * C, Dh, C),
                      pattern, key_bias, qbias, amask, seed, pst, mask, G, N,
                      num_heads, Dh, P, scale, thresh, kept, head0, plan.form)
    biased_attention.adrop_launches += adrop is not None
    biased_attention.save_p_launches += save_p
    return _with_extras(ctx, pst, mask)


def _launch_attention(qkv_ptrs, in_strides, ctx, out_strides, pattern,
                      key_bias, qbias, amask, seed, pst, mask, G, N, num_heads,
                      Dh, P, scale, thresh, kept, head0=0,
                      form: str = "register") -> None:
    """One K2 launch of ``form``: q, k, v at the addresses ``qkv_ptrs`` with
    element strides ``in_strides`` (group, head, row), ctx with
    ``out_strides``."""
    lib = build()["attention"]
    _check(lib.mvlt_attention(*qkv_ptrs, *in_strides, _ptr(ctx), *out_strides,
                              _ptr(pattern), _ptr(key_bias), _ptr(qbias),
                              _ptr(amask), _ptr(seed), _ptr(pst), _ptr(mask),
                              G, N, num_heads, Dh, P, float(scale), thresh,
                              kept, head0, ATTENTION_FORMS.index(form),
                              _stream(ctx.device)),
           "biased_attention")
    biased_attention.launches += 1
    biased_attention.mid_launches += form == "middle"


biased_attention.launches = 0
biased_attention.adrop_launches = biased_attention.save_p_launches = 0
biased_attention.heads_launches = biased_attention.mid_launches = 0


def _pattern_index(pattern, G: int, device):
    """pattern[g % P] for each of G groups."""
    return pattern.float()[torch.arange(G, device=device) % pattern.shape[0]]


def biased_attention_heads_plain(q, k, v, scale: float, pattern=None):
    """K2 on head-major tensors: q, k, v (G, nH, N, Dh); pattern (P, nH, N, N)
    f32, group g using ``pattern[g % P]``. Returns ctx (G, nH, N, Dh) in
    q's dtype: the softmax of ``(q * scale) k^T + pattern`` in f32, rounded
    to q's dtype for the PV product, PV in f32 (``_kernel``, pallas_attn.py
    :40, interpret path)."""
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    if pattern is not None:
        s = s + _pattern_index(pattern, q.shape[0], q.device)
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    return (p @ v.float()).to(q.dtype)


def biased_attention_heads(q, k, v, scale: float, pattern=None):
    """K2 wrapper in the head-major layout; same contract as
    :func:`biased_attention_heads_plain`. On CUDA: bf16 q, k, v of one shape
    and one set of strides with a contiguous head dim (views of fused qkv
    rows are taken as they are), 16-byte aligned, with group, head and row
    strides that are multiples of 8; f32 contiguous pattern with G % P ==
    0; the head dims and N of :func:`biased_attention`. ctx is written as
    (G, N, nH, Dh) rows and returned as its (G, nH, N, Dh) view. Counts in
    ``heads_launches`` and ``launches``."""
    if not q.is_cuda:
        return biased_attention_heads_plain(q, k, v, scale, pattern)
    dev, bf = q.device, torch.bfloat16
    if q.dim() != 4:
        raise ValueError(f"q must be (G, nH, N, Dh), got {tuple(q.shape)}")
    G, nH, N, Dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != bf:
            raise ValueError(f"{name} must be bf16 on {dev}, got {t.dtype} "
                             f"on {t.device}")
        if t.shape != q.shape or t.stride() != q.stride():
            raise ValueError(f"q, k and v must share shape and strides "
                             f"({name}: {tuple(t.shape)} {t.stride()})")
    _require(q.stride(3) == 1, "the head dim of q, k, v must be contiguous")
    check_attention_fits(N, Dh, smem_optin(dev), window="head-major")
    check_attention_layout([q.data_ptr(), k.data_ptr(), v.data_ptr()],
                           q.stride()[:3])
    _cuda_arg(pattern, "pattern", torch.float32, dev, 4)
    P = 1
    if pattern is not None:
        P = _pattern_geometry(pattern, G, nH, N)
    ctx = torch.empty((G, N, nH, Dh), dtype=bf, device=dev)
    _launch_attention((q.data_ptr(), k.data_ptr(), v.data_ptr()),
                      q.stride()[:3], ctx, (N * nH * Dh, Dh, nH * Dh),
                      pattern, None, None, None, None, None, None, G, N, nH,
                      Dh, P, scale, 0, 0.0)
    biased_attention.heads_launches += 1
    return ctx.permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# K3 layernorm; the row plan that K3 and K5 share
# ---------------------------------------------------------------------------

# csrc/norm.cuh: warps a block of the row kernels, elements a chunk
NORM_WARPS, NORM_VEC = 4, 8
# the widest row K3 takes (Swin-B's last patch merge) and K5 takes (its
# column sums stay in registers: four chunks a lane)
LAYERNORM_MAX_C, LAYERNORM_BWD_MAX_C = 2048, 1024


class RowPlan(NamedTuple):
    """How K3 and K5 lay a row of C channels on a warp (``csrc/norm.cuh``):
    a group of ``lanes`` lanes (a power of two) owns a row, each lane
    ``chunks`` chunks of 8 elements (lane l of the group holds chunks
    ``j * lanes + l``); a block of ``NORM_WARPS`` warps holds
    ``rows_per_block`` rows at once; ``vec``: 16-byte accesses (C % 8 ==
    0), else element by element."""
    lanes: int
    chunks: int
    rows_per_block: int
    vec: bool


@functools.lru_cache(maxsize=None)
def row_plan(C: int, max_c: int) -> RowPlan:
    """The (lanes, chunks) that leave the fewest chunk slots of a row idle,
    and of those the fewest chunks a lane (C = 96: 4 x 3, 192: 8 x 3, 384:
    16 x 3, 768: 32 x 3); a row of more than 128 chunks (K3 only) takes the
    warp. ``ValueError`` unless 1 <= C <= ``max_c``."""
    _require(1 <= C <= max_c, f"C={C} is outside 1 .. {max_c}")
    n = -(-C // NORM_VEC)
    vec = C % NORM_VEC == 0
    if n > 4 * 32:
        return RowPlan(32, -(-n // 32), NORM_WARPS, vec)
    best, waste = None, None
    for j in range(1, 5):
        g = 1
        while g < -(-n // j):
            g *= 2
        if g <= 32 and (waste is None or g * j - n < waste):
            waste, best = g * j - n, RowPlan(g, j, NORM_WARPS * (32 // g), vec)
    return best


class LayerNormPlan(NamedTuple):
    """K3's launch (``mvlt_layernorm_plan`` in ``csrc/layernorm.cu``): the
    row plan and ``blocks``, one per ``rows_per_block`` rows."""
    lanes: int
    chunks: int
    rows_per_block: int
    vec: bool
    blocks: int


def layernorm_plan(M: int, C: int) -> LayerNormPlan:
    """K3's plan for M rows of C (1 <= C <= ``LAYERNORM_MAX_C``)."""
    _require(M >= 1, f"layernorm over {M} rows")
    rp = row_plan(C, LAYERNORM_MAX_C)
    return LayerNormPlan(*rp, -(-M // rp.rows_per_block))


def layernorm_plain(x, gamma, beta, eps: float, row_index=None,
                    out_dtype=None):
    """``LN(x[row_index]) * gamma + beta`` over the last dim, f32 moments;
    the output has ``out_dtype`` (default ``x.dtype``)."""
    y = F.layer_norm(_rows(x, row_index).float(), (x.shape[-1],),
                     gamma.float(), beta.float(), eps)
    return y.to(out_dtype or x.dtype)


def layernorm(x, gamma, beta, eps: float, row_index=None, out_dtype=None):
    """K3 wrapper; same contract as :func:`layernorm_plain`. On CUDA: bf16
    or f32 x (rows, C), C <= 2048, bf16 output, f32 gamma / beta, int32
    row_index."""
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
    layernorm_plan(M, C)                      # refuses what K3 cannot take
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
    if tuple(pattern.shape[1:]) != (num_heads, N, N):
        raise ValueError(f"pattern {tuple(pattern.shape)} is not (P, "
                         f"{num_heads}, {N}, {N})")
    if P <= 0 or G % P:
        raise ValueError(f"{G} groups do not divide among {P} patterns "
                         "(G % P != 0)")
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
    place of the recomputed one (``_core_bwd_storep_kernel``, :3859). The
    math runs in float32, or in float64 when qkv is float64."""
    rows, C3 = qkv.shape
    C, N = C3 // 3, seq_n
    G, Dh = rows // N, C // num_heads
    _check_masks(qbias, amask, G, num_heads, N)
    _check_adrop(adrop, amask)
    _check_stored_p(p, G, num_heads, N)
    if adrop is not None:
        amask = _adrop_mask(adrop, G, num_heads, N)
    P = None if pattern is None else _pattern_geometry(pattern, G, num_heads, N)
    ft = torch.promote_types(qkv.dtype, torch.float32)
    t = qkv.to(ft).view(G, N, 3, num_heads, Dh).permute(2, 0, 3, 1, 4)
    q, k, v = t[0] * scale, t[1], t[2]
    dc = dctx.to(ft).view(G, N, num_heads, Dh).permute(0, 2, 1, 3)
    if p is not None:
        p = p.to(ft)
    else:
        s = q @ k.transpose(-1, -2)                             # (G, nH, N, N)
        if pattern is not None:
            s = s + pattern.to(ft)[torch.arange(G, device=qkv.device) % P]
        if key_bias is not None:
            s = s + key_bias.to(ft)[:, None, None, :]
        if qbias is not None:
            s = s + qbias.to(ft)[:, None]
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
    am = None if amask is None else amask.to(ft)
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
    if not (p is None or tuple(p.shape) == (G, num_heads, N, N)):
        raise ValueError(f"stored p must be ({G}, {num_heads}, {N}, {N}), "
                         f"got {tuple(p.shape)}")


def biased_attention_bwd(qkv, dctx, num_heads: int, seq_n: int, scale: float,
                         key_bias=None, qbias=None, amask=None, pattern=None,
                         *, adrop=None, p=None, form: Optional[str] = None):
    """K4 wrapper; same contract as :func:`biased_attention_bwd_plain`. On
    CUDA: bf16 qkv, dctx, amask and p, f32 biases and patterns, an int32
    device seed, at most 256 heads with ``adrop``, 16-byte aligned tensors,
    and (N, head dim) within :func:`attention_bwd_plan` (N <= 46,340, in the
    middle form (160 < N <= 288) and past N = 288 with no pattern and no
    stored p; head dims 16, 32, 48, 64); anything else raises
    ``ValueError`` before a launch. The sums over groups and heads run in a
    fixed order: two calls on the same inputs give bitwise-equal gradients.
    ``form`` overrides the plan's form, as :func:`biased_attention`'s.
    ``adrop`` counts in ``adrop_launches``, ``p`` in ``stored_p_launches``,
    the middle form in ``mid_launches``, all also in ``launches``."""
    if not qkv.is_cuda:
        return biased_attention_bwd_plain(qkv, dctx, num_heads, seq_n, scale,
                                          key_bias, qbias, amask, pattern,
                                          adrop=adrop, p=p)
    dev, bf, f32 = qkv.device, torch.bfloat16, torch.float32
    _cuda_arg(qkv, "qkv", bf, dev, 2)
    rows, C3 = qkv.shape
    N = seq_n
    window = ("pattern" if pattern is not None else
              "stored p" if p is not None else "")
    G, C, Dh, plan = _attention_geometry(
        qkv, num_heads, N, backward=True, pattern=pattern is not None,
        amask=amask is not None, window=window, form=form or attention_form(
            N, bool(window), backward=True, amask=amask is not None))
    # the messages are formatted only on failure (host time per call)
    _cuda_arg(dctx, "dctx", bf, dev, 2)
    if tuple(dctx.shape) != (rows, C):
        raise ValueError(f"dctx must be ({rows}, {C})")
    _cuda_arg(key_bias, "key_bias", f32, dev, 2)
    if not (key_bias is None or tuple(key_bias.shape) == (G, N)):
        raise ValueError(f"key_bias must be ({G}, {N})")
    _cuda_masks(qbias, amask, G, num_heads, N, dev, plan.form)
    _check_adrop(adrop, amask)
    seed, thresh, kept, head0 = _cuda_adrop(adrop, num_heads, dev)
    _cuda_arg(p, "p", bf, dev, 4)
    _check_stored_p(p, G, num_heads, N)
    _cuda_arg(pattern, "pattern", f32, dev, 4)
    P = 1 if pattern is None else _pattern_geometry(pattern, G, num_heads, N)
    lib = build()["attention_bwd"]
    dqkv = torch.empty((rows, C3), dtype=bf, device=dev)
    # one f32 buffer: the head partials of dkbias (G, nH, N), then the
    # first pass's statistics for the second (G, nH, scratch_words)
    words = plan.scratch_words
    buf = torch.empty(G * num_heads * (N + words), dtype=f32, device=dev)
    scratch = buf.data_ptr() + 4 * G * num_heads * N
    part = dkb = dpat_part = dpat = None
    if pattern is None or key_bias is not None:
        part = buf.data_ptr()
        dkb = torch.empty((G, N), dtype=f32, device=dev)
    if pattern is not None:
        chunks = lib.mvlt_attention_bwd_chunks(G, P, num_heads)
        _require(chunks > 0, "could not split the pattern groups")
        dpat_part = torch.empty((chunks, P, num_heads, N, N), dtype=f32,
                                device=dev)
        dpat = torch.empty((P, num_heads, N, N), dtype=f32, device=dev)
    _check(lib.mvlt_attention_bwd(_ptr(qkv), _ptr(dctx), _ptr(pattern),
                                  _ptr(key_bias), _ptr(qbias), _ptr(amask),
                                  _ptr(seed), _ptr(p), _ptr(dqkv), part,
                                  _ptr(dkb), _ptr(dpat_part), _ptr(dpat),
                                  scratch, G, N, C, num_heads, P,
                                  float(scale), thresh, kept, head0,
                                  ATTENTION_FORMS.index(plan.form),
                                  _stream(dev)),
           "biased_attention_bwd")
    biased_attention_bwd.launches += 1
    biased_attention_bwd.mid_launches += plan.form == "middle"
    biased_attention_bwd.adrop_launches += adrop is not None
    biased_attention_bwd.stored_p_launches += p is not None
    if pattern is None:
        return dqkv, dkb
    return dqkv, dkb, dpat


biased_attention_bwd.launches = biased_attention_bwd.mid_launches = 0
biased_attention_bwd.adrop_launches = biased_attention_bwd.stored_p_launches = 0


# ---------------------------------------------------------------------------
# K5 layernorm_bwd, column_sum
# ---------------------------------------------------------------------------

# csrc/layernorm_bwd.cu: column_sum's threads a block, blocks an SM it aims
# for, and rows' loads in flight a thread
COLSUM_THREADS, COLSUM_BLOCKS_PER_SM, COLSUM_UNROLL = 256, 4, 4


def ln_bwd_blocks_per_sm(chunks: int) -> int:
    """Blocks of K5's VJP kernel that sit on one SM: its launch bounds'
    register cap (3 blocks of 128 threads up to three chunks a lane)."""
    return 3 if chunks <= 3 else 2


class LayerNormBwdPlan(NamedTuple):
    """K5's VJP launch (``mvlt_layernorm_bwd_plan``): the row plan,
    ``passes`` of ``rows_per_block`` rows, and ``blocks`` persistent blocks
    (one wave), block b taking passes b, b + blocks, ...; each writes one
    partial row [dgamma; dbeta; db] of the f32 ``scratch`` (blocks, 3C),
    which the fold sums in block order."""
    lanes: int
    chunks: int
    rows_per_block: int
    vec: bool
    passes: int
    blocks: int
    scratch: tuple


@functools.lru_cache(maxsize=4096)
def layernorm_bwd_plan(M: int, C: int, sms: int = H100_SMS
                       ) -> LayerNormBwdPlan:
    """K5's VJP plan for M rows of C (1 <= C <= ``LAYERNORM_BWD_MAX_C``) on
    ``sms`` SMs."""
    _require(M >= 1, f"layernorm_bwd over {M} rows")
    rp = row_plan(C, LAYERNORM_BWD_MAX_C)
    passes = -(-M // rp.rows_per_block)
    blocks = min(passes, ln_bwd_blocks_per_sm(rp.chunks) * sms)
    return LayerNormBwdPlan(*rp, passes, blocks, (blocks, 3 * C))


class ColumnSumPlan(NamedTuple):
    """``column_sum``'s launch (``mvlt_column_sum_plan``): a grid of
    ``strips`` x ``row_chunks`` blocks; block (s, k) sums the
    ``strip_chunks`` 8-column chunks of strip s over rows [k * rows, min(M,
    (k + 1) * rows)) into row k of the f32 ``scratch`` (row_chunks, N),
    which the fold sums in order; ``vec``: 16-byte loads (N % 8 == 0)."""
    strip_chunks: int
    strips: int
    row_chunks: int
    rows: int
    vec: bool
    scratch: tuple


@functools.lru_cache(maxsize=4096)
def column_sum_plan(M: int, N: int, sms: int = H100_SMS) -> ColumnSumPlan:
    """``column_sum``'s plan for an (M, N) input on ``sms`` SMs: strips of
    the largest power-of-two count of chunks (at most 32, 256 columns) that
    divides N's chunks; as many runs of rows as keep the grid within
    ``COLSUM_BLOCKS_PER_SM`` blocks an SM (one wave), each at least one
    pass of the block's row lanes with ``COLSUM_UNROLL`` loads in flight,
    none empty."""
    _require(M >= 1 and N >= 1, f"column_sum over ({M}, {N})")
    n = -(-N // NORM_VEC)
    sc = min(32, n & -n)
    strips = n // sc
    per_pass = COLSUM_THREADS // sc * COLSUM_UNROLL
    chunks = min(max(1, COLSUM_BLOCKS_PER_SM * sms // strips),
                 -(-M // per_pass))
    rows = -(-M // chunks)
    runs = -(-M // rows)
    return ColumnSumPlan(sc, strips, runs, rows, N % NORM_VEC == 0, (runs, N))


def layernorm_bwd_plain(res, gamma, g, eps: float, hmask=None, gres=None,
                        row_scale=None, out_dtype=None, dres: bool = True):
    """VJP of ``LN(res) * gamma + beta`` over rows of the pre-LN sum ``res``
    (M, C) for the upstream gradient ``g`` (M, C). Returns ``(dres f32, da,
    dgamma, dbeta, db)``: ``dres`` the LN VJP plus the optional incoming
    residual gradient ``gres`` (M, C) (the pre-LN form: ``dres1 = g +
    LN2^T(dh2)`` of a Swin block), or None with ``dres=False`` (a caller
    that reads only da); ``da = dres * hmask * row_scale`` in
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
    d = r * (dxhat - dxhat.mean(-1, keepdim=True)
             - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    if gres is not None:
        d = d + gres.float()
    da = d if hmask is None else d * hmask.float()
    if row_scale is not None:
        da = da * _row_scale_plain(row_scale, da.shape[0])
    return (d if dres else None, da.to(out_dtype or g.dtype),
            (gf * xhat).sum(0), gf.sum(0), da.sum(0))


def layernorm_bwd(res, gamma, g, eps: float, hmask=None, gres=None,
                  row_scale=None, out_dtype=None, dres: bool = True):
    """K5 wrapper; same contract as :func:`layernorm_bwd_plain`. On CUDA:
    f32 or bf16 res, f32 gamma and row_scale, bf16 or f32 g and gres, bf16
    hmask, a bf16 da, C <= 1024. The column sums run in the fixed order of
    :func:`layernorm_bwd_plan`: two calls on the same inputs are bitwise
    equal."""
    if not res.is_cuda:
        return layernorm_bwd_plain(res, gamma, g, eps, hmask, gres, row_scale,
                                   out_dtype, dres)
    dev, f32, bf = res.device, torch.float32, torch.bfloat16
    res_bf = res.dtype == bf
    _cuda_arg(res, "res", bf if res_bf else f32, dev, 2)
    M, C = res.shape
    sms = _sm_count(dev.index)
    plan = layernorm_bwd_plan(M, C, sms)     # refuses C > 1024
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
    d = torch.empty((M, C), dtype=f32, device=dev) if dres else None
    da = torch.empty((M, C), dtype=bf, device=dev)
    part = torch.empty(plan.scratch, dtype=f32, device=dev)
    sums = torch.empty((3, C), dtype=f32, device=dev)
    flags = int(res_bf) | 2 * int(g_f32) | 4 * int(gres_f32)
    _check(lib.mvlt_layernorm_bwd(_ptr(res), _ptr(gamma), _ptr(g),
                                  _ptr(hmask), _ptr(gres), _ptr(row_scale),
                                  _ptr(d), _ptr(da), _ptr(part), _ptr(sums),
                                  M, C, float(eps), flags, s_div, sms,
                                  plan.blocks, _stream(dev)), "layernorm_bwd")
    layernorm_bwd.launches += 1
    return d, da, sums[0], sums[1], sums[2]


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
    bf16 or f32 x (bf16 with a row scale), f32 row_scale, M >= 1. The sums
    run in the fixed order of :func:`column_sum_plan`: two calls on the
    same inputs are bitwise equal."""
    if not x.is_cuda:
        return column_sum_plain(x, row_scale)
    dev, f32 = x.device, torch.float32
    x_f32 = x.dtype == f32
    _require(not (x_f32 and row_scale is not None),
             "column_sum with a row scale takes bf16 x")
    _cuda_arg(x, "x", f32 if x_f32 else torch.bfloat16, dev, 2)
    M, N = x.shape
    sms = _sm_count(dev.index)
    plan = column_sum_plan(M, N, sms)
    s_div = _cuda_row_scale(row_scale, M, dev)
    xs = None if row_scale is None else torch.empty_like(x)
    lib = build()["layernorm_bwd"]
    part = torch.empty(plan.scratch, dtype=f32, device=dev)
    out = torch.empty((N,), dtype=f32, device=dev)
    _check(lib.mvlt_column_sum(_ptr(x), int(x_f32), _ptr(row_scale), _ptr(xs),
                               _ptr(part), _ptr(out), M, N, s_div, sms,
                               plan.row_chunks, _stream(dev)), "column_sum")
    column_sum.launches += 1
    return out if row_scale is None else (out, xs)


column_sum.launches = 0

# the kernels of the inference forward, and every kernel
FORWARD_KERNELS = (gemm, biased_attention, layernorm)
KERNELS = FORWARD_KERNELS + (biased_attention_bwd, layernorm_bwd, column_sum)
# the opt-in modes' launch counts, beside each kernel's ``launches``
MODE_COUNTS = {gemm: ("splitk_launches",),
               biased_attention: ("adrop_launches", "save_p_launches",
                                   "heads_launches", "mid_launches"),
               biased_attention_bwd: ("adrop_launches", "stored_p_launches",
                                      "mid_launches")}

"""The six TPU kernels of the VQA forward, rebuilt from K1-K3.

Each public function is named after its JAX counterpart in
``mvlt_tpu/ops/pallas_attn.py`` and takes the same arguments, with dense
weights in the PyTorch ``(out, in)`` layout. It is composed only of the
kernels of :mod:`mvlt_tpu_torch.ops.kernels` (``gemm``, ``biased_attention``,
``layernorm``) and pure layout ops (reshape, row index). Beside each is its
``*_plain`` twin, the same composition over the kernels' plain versions, and
each kernel twin counts its CUDA calls in ``.launches``.

===========================  ==========================================
port function                TPU kernel it replaces
===========================  ==========================================
``swin_full_block``          ``_full_kernel`` (:652, ``_full_body`` :571)
``swin_full_block(shift)``   ``_full_shift_kernel`` (:702)
``window_block_attention``   ``_block_kernel`` (:166)
``fused_mlp_preln``          ``_mlp_preln_kernel`` (:3359)
``fused_attn_ln``            ``_attn_ln_kernel`` (:2156)
``fused_mlp_ln``             ``_mlp_ln_kernel`` (:2817)
===========================  ==========================================

They hold the math of the JAX interpret path (``fast=False``), not the TPU
fast path. The TPU layout choices are dropped: windows are not merged into
pairs and rows are not padded to multiples of 8, since K2 takes any N <= 128.
One bf16 rounding differs from the fused TPU kernels: the residual sums
that the TPU kernel keeps in f32 between its halves (``res1`` in
``_full_body``, ``x + attn`` before the post-LN) are rounded to the compute
dtype where one K1 hands them to the next kernel. In float32 the two agree.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import torch

from mvlt_tpu_torch.ops import kernels
from mvlt_tpu_torch.ops.layers import SWIN_LN_EPS

# What a forward runs: the kernels, or the same composition on their plain
# versions. The counterparts below are added to both namespaces.
KERNEL_OPS = SimpleNamespace(gemm=kernels.gemm,
                             attention=kernels.biased_attention,
                             layernorm=kernels.layernorm)
PLAIN_OPS = SimpleNamespace(gemm=kernels.gemm_plain,
                            attention=kernels.biased_attention_plain,
                            layernorm=kernels.layernorm_plain)


@functools.lru_cache(maxsize=None)
def shift_permutation(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """dst -> src row map from the UNSHIFTED to the SHIFTED window-major
    layout of one (H, W) map: ``shifted[dst] = unshifted[perm[dst]]``
    (the dense form of ``_shift_perm``, pallas_attn.py:1475). Shifted map
    position (h, w) holds the unshifted (h + shift, w + shift), mod (H, W):
    the reference's ``torch.roll(x, (-shift, -shift))``."""
    nWw = W // window

    def window_major(h, w):
        return (((h // window) * nWw + w // window) * window * window
                + (h % window) * window + w % window)

    h = np.arange(H)[:, None]
    w = np.arange(W)[None, :]
    perm = np.empty(H * W, np.int64)
    perm[window_major(h, w).ravel()] = window_major(
        (h + shift) % H, (w + shift) % W).ravel()
    return perm


@functools.lru_cache(maxsize=64)
def _shift_index(n_img: int, H: int, W: int, window: int, shift: int,
                 device: torch.device) -> torch.Tensor:
    """int32 (n_img * H * W,) row index of :func:`shift_permutation` over a
    batch of images, on ``device``."""
    perm = shift_permutation(H, W, window, shift)
    full = (np.arange(n_img)[:, None] * (H * W) + perm[None]).ravel()
    return torch.as_tensor(full, dtype=torch.int32, device=device)


def _swin_full_block(p, x, params, bias, scale: float, num_heads: int, *,
                     shift_spec=None):
    BW, N, C = x.shape
    (ln1s, ln1b, wqkv, bqkv, wproj, bproj,
     ln2s, ln2b, w1, b1, w2, b2) = params
    rows = x.reshape(BW * N, C)
    idx = None
    if shift_spec is not None:
        H, W, window, shift = shift_spec
        idx = _shift_index(BW * N // (H * W), H, W, window, shift, x.device)
    # with a shift, LN1 and the proj residual gather the shifted windows and
    # the fc2 store scatters back: I/O stay in the unshifted layout
    h = p.layernorm(rows, ln1s, ln1b, SWIN_LN_EPS, row_index=idx)
    qkv = p.gemm(h, wqkv, bqkv)
    ctx = p.attention(qkv, num_heads, N, scale, pattern=bias)
    res1 = p.gemm(ctx, wproj, bproj, residual=rows, residual_index=idx)
    h2 = p.layernorm(res1, ln2s, ln2b, SWIN_LN_EPS)
    m = p.gemm(h2, w1, b1, gelu=True)
    out = p.gemm(m, w2, b2, residual=res1, store_index=idx)
    return out.view(BW, N, C)


def _window_block_attention(p, x, wqkv, bqkv, wproj, bproj, bias,
                            scale: float, num_heads: int, residual=None):
    BW, N, C = x.shape
    qkv = p.gemm(x.reshape(BW * N, C), wqkv, bqkv)
    ctx = p.attention(qkv, num_heads, N, scale, pattern=bias)
    res = None if residual is None else residual.reshape(BW * N, C)
    return p.gemm(ctx, wproj, bproj, residual=res).view(BW, N, C)


def _fused_mlp_preln(p, x, ln2s, ln2b, w1, b1, w2, b2):
    rows = x.reshape(-1, x.shape[-1])
    h = p.layernorm(rows, ln2s, ln2b, SWIN_LN_EPS)
    m = p.gemm(h, w1, b1, gelu=True)
    return p.gemm(m, w2, b2, residual=rows).view(x.shape)


def _fused_attn_ln(p, x, wqkv, bqkv, wproj, bproj, kbias, lns, lnb,
                   scale: float, num_heads: int, eps: float = 1e-12):
    B, N, C = x.shape
    rows = x.reshape(B * N, C)
    qkv = p.gemm(rows, wqkv, bqkv)
    ctx = p.attention(qkv, num_heads, N, scale, key_bias=kbias)
    res = p.gemm(ctx, wproj, bproj, residual=rows)
    return p.layernorm(res, lns, lnb, eps).view(B, N, C)


def _fused_mlp_ln(p, x, w1, b1, w2, b2, lns, lnb, eps: float = 1e-12):
    rows = x.reshape(-1, x.shape[-1])
    m = p.gemm(rows, w1, b1, gelu=True)
    res = p.gemm(m, w2, b2, residual=rows)
    return p.layernorm(res, lns, lnb, eps).view(x.shape)


def _twins(body, doc: str):
    """(kernel twin with a ``launches`` count, plain twin) of ``body``. A
    call with a ``shift_spec`` counts in ``shift_launches`` instead: the
    shifted Swin block replaces a TPU kernel of its own."""
    def kernel_twin(x, *args, **kw):
        out = body(KERNEL_OPS, x, *args, **kw)
        if x.is_cuda:
            if kw.get("shift_spec") is not None:
                kernel_twin.shift_launches += 1
            else:
                kernel_twin.launches += 1
        return out

    def plain_twin(x, *args, **kw):
        return body(PLAIN_OPS, x, *args, **kw)

    name = body.__name__.lstrip("_")
    kernel_twin.__name__, kernel_twin.__doc__ = name, doc
    plain_twin.__name__ = name + "_plain"
    plain_twin.__doc__ = f"Plain PyTorch twin of :func:`{name}`."
    kernel_twin.launches = kernel_twin.shift_launches = 0
    setattr(KERNEL_OPS, name, kernel_twin)
    setattr(PLAIN_OPS, name, plain_twin)
    return kernel_twin, plain_twin


swin_full_block, swin_full_block_plain = _twins(_swin_full_block, """\
Whole pre-LN Swin block on (BW, N, C) raw windows:
LN1 -> K1 qkv -> K2 -> K1 proj (+x) -> LN2 -> K1 fc1+GELU -> K1 fc2 (+res1).
``params``: (ln1s, ln1b, wqkv, bqkv, wproj, bproj, ln2s, ln2b, w1, b1, w2,
b2); ``bias``: (P, nH, N, N) f32 patterns, window g uses ``bias[g % P]``.
With ``shift_spec=(H, W, window, shift)`` x and the output are in the
UNSHIFTED window-major layout (as ``_full_forward_shift``, pallas_attn.py
:994) and ``bias`` must carry the shift mask per window (P = nW).""")

window_block_attention, window_block_attention_plain = _twins(
    _window_block_attention, """\
LN-free Swin attention on (BW, N, C) windows: K1 qkv -> K2 -> K1 proj.
An optional ``residual`` (BW, N, C) is added in the proj epilogue, which
is how stage 4 folds the residual of JAX's fallback
(pallas_attn.py:3326-3335).""")

fused_mlp_preln, fused_mlp_preln_plain = _twins(_fused_mlp_preln, """\
Pre-LN MLP half ``x + fc2(GELU(fc1(LN2 x)))`` over rows of (..., C).""")

fused_attn_ln, fused_attn_ln_plain = _twins(_fused_attn_ln, """\
Post-LN BERT attention half ``LN(x + proj(attn(x)))`` on (B, N, C), with a
(B, N) f32 additive key bias.""")

fused_mlp_ln, fused_mlp_ln_plain = _twins(_fused_mlp_ln, """\
Post-LN BERT MLP half ``LN(x + fc2(GELU(fc1 x)))`` over rows of (..., C).""")

COUNTERPARTS = (swin_full_block, window_block_attention, fused_mlp_preln,
                fused_attn_ln, fused_mlp_ln)

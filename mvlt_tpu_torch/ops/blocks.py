"""The TPU kernels of the VQA forward, of the fusion encoder's training
steps (VQA finetune, MLM+ITM pretrain) and of the Swin backbone's training
step, rebuilt from K1-K5.

Each public function is named after its JAX counterpart in
``mvlt_tpu/ops/pallas_attn.py`` and takes the same arguments, with dense
weights in the PyTorch ``(out, in)`` layout. It is composed only of the
kernels of :mod:`mvlt_tpu_torch.ops.kernels` and pure layout ops (reshape,
row index). Beside each is its ``*_plain`` twin, the same composition over
the kernels' plain versions, and each kernel twin counts its CUDA calls in
``.launches``.

===========================  ==========================================
port function                TPU kernel it replaces
===========================  ==========================================
``swin_full_block``          ``_full_kernel`` (:652, ``_full_body`` :571)
``swin_full_block(shift)``   ``_full_shift_kernel`` (:702)
``window_block_attention``   ``_block_kernel`` (:166)
``fused_mlp_preln``          ``_mlp_preln_kernel`` (:3359)
``fused_attn_ln``            ``_attn_ln_kernel`` (:2156)
``fused_attn_ln_masked``     ``_attn_ln_kernel`` with qbias / amask /
                             hmask (entry ``fused_attn_ln_masked`` :2721)
``fused_mlp_ln``             ``_mlp_ln_kernel`` (:2817)
``fused_mlp_ln_masked``      ``_mlp_ln_kernel`` with hmask (entry :3194)
``seq_attention_core_bwd``   ``_seq_core_bwd_kernel`` (:2413), on K4
``mlp_ln_half_bwd``          ``_mlp_ln_bwd_kernel`` (:2931), on K1 + K5
``swin_full_block(dp=...)``  ``_full_kernel_dp`` / ``_save`` / ``_dp_save``
  and under autograd         (:730-772, entry ``_full_forward_inner``
                             :1296), on K1-K3
``... (shift_spec, dp)``     ``_full_shift_kernel_dp`` / ``_save`` /
                             ``_dp_save`` (:807-895)
``swin_half_block``          ``_ln_matmul_kernel`` (:3456) +
                             ``_swin_tail_kernel`` (:3467), entry :3573
``attention_core``           ``_core_fwd_kernel`` (:3614), on K2
``attention_core_bwd``       ``_core_bwd_kernel2d`` (:3782, entry
                             ``attention_core_bwd_flat`` :3898) and
                             ``_core_bwd_kernel`` (:3637, entry :4067),
                             on K4's pattern mode
``swin_mlp_half_bwd``        ``_swin_mlp_bwd_kernel`` (:1618), K1 + K3 + K5
``swin_qkv_tail_bwd``        ``_swin_qkv_tail_kernel`` (:1787), K1 + K3 + K5
``fused_attn_ln_adrop``      ``_attn_ln_kernel`` with ``adrop_rate``
                             (entry ``fused_attn_ln_adrop`` :2770,
                             ``_adrop_mask`` :2133), on K1 + K2(adrop) +
                             K1 + K3; backward ``_seq_core_bwd_kernel``
                             with ``adrop_rate`` (:2485) on K4(adrop)
``swin_full_block(store_p)`` ``_full_kernel_save_p`` / ``_dp_save_p``
                             (:774, :791) on K2(save_p)
``... (shift_spec, store_p)``  ``_full_shift_kernel_save_p`` /
                             ``_dp_save_p`` (:896, :928)
``attention_core_bwd(p2=)``  ``_core_bwd_storep_kernel`` (:3859, entry
                             ``attention_core_bwd_flat`` :3898 with
                             ``p2``), on K4(stored p)
===========================  ==========================================

The masked twins take the dropout masks as inputs, as the JAX kernels do
(values 0 or 1/keep in the compute dtype): ``amask`` (B, nH, N, N)
multiplies the softmax output before p is rounded for the PV product (K2),
``hmask`` (B, N, C) multiplies the proj / fc2 output before the residual
add (K1's epilogue multiplier); ``qbias`` (B, N, N) f32 is the seq2seq
mask, added to the scores. In the backward, K5 applies hmask to the
cotangent that enters the products and to the bias gradient, and K4 takes
qbias and amask. JAX pads N to a multiple of 8 with a -1e9 key bias in
the backward (pallas_attn.py:2618-2630), a TPU layout choice; the port
keeps N ragged.

Training. When an input of ``fused_attn_ln`` or ``fused_mlp_ln`` requires
grad, it runs as a ``torch.autograd.Function`` (the counterpart of the JAX
``custom_vjp``). Its forward is the same composition with the pre-LN sum
written in f32 by K1 and saved, as the store-residual forwards save it
(``_attn_ln_fwd`` :2403, ``_mlp_ln_fwd`` :2925); the attention half also
saves qkv and ctx, and takes its pre-LN sum from that save instead of
JAX's recompute from ctx (the same value up to summation order). The
backwards follow ``_attn_ln_bwd_stored``'s bf16 branch (:2653-2672) and
``mlp_ln_half_bwd``: the LN VJP on K5, the products on K1 (``tn`` for the
weight grads, ``nn`` for the input grads, the GELU derivative in the
epilogue of dm), the attention core on K4. Weight grads come back in the
dtype of the weight that went in, as ``.astype(w.dtype)`` does in JAX. One
bf16 rounding differs: db1 is the column sum of the bf16 da1 that feeds the
next two products, where the TPU kernel sums its f32 da1.

Swin training. ``swin_full_block`` with DropPath multipliers ``dp`` or
under autograd, and ``swin_half_block``, run the training forward of
``_full_body`` / ``_half_train_forward``: LN1 (K3, gathering the shifted
windows) -> K1 qkv -> the attention core (K2 with the bias patterns; the
half block through ``attention_core``) -> K1 proj with the f32 row scale dp1
and the residual x, written in f32 (res1) -> K3 LN2 -> K1 fc1 + GELU -> K1
fc2 with dp2 and the residual res1 (scattered back when shifted). Under
autograd they are a ``torch.autograd.Function`` that saves x, qkv and ctx
(and recomputes res1, as ``_swin_mlp_bwd_kernel`` does); its backward is
``_stored_block_bwd`` (pallas_attn.py:1877-2007): ``swin_mlp_half_bwd`` ->
K1 dWproj / dctx -> ``attention_core_bwd`` -> ``swin_qkv_tail_bwd``. Shifted
blocks keep qkv and ctx in the shifted layout; x and the block's cotangent
are gathered into it and dx scattered back (``_full_bwd_stored_shift``
:2010). The pattern gradient is per pattern (P = nW when shifted); the
relative-position table takes its sum through the autograd of the bias. The
DropPath multipliers are (B,) f32, one per image, which K1 and K5 index by
``row // (M // B)``: the shifted layout moves rows only within an image.

Opt-in modes (the JAX package's switches, routed by the model). In-kernel
attention dropout (``MVLT_KERNEL_DROPOUT``): ``fused_attn_ln_adrop`` takes a
(2,) int32 device seed and the rate in place of amask; K2 draws the mask
with Philox and K4 regenerates it from the saved seed, so no mask tensor is
made or stored. Stored softmax (``MVLT_STOREP``): ``swin_full_block(...,
store_p=True)`` under autograd has K2 write p (bf16, (BW, nH, N, N)) in the
window order in which qkv and ctx are kept (shifted when shifted), and the
backward hands it to ``attention_core_bwd(p2=...)`` (K4 from the stored p)
unless ``MVLT_NO_STOREP`` is set by then.

They hold the math of the JAX interpret path (``fast=False``), not the TPU
fast path. The TPU layout choices are dropped: windows are not merged into
pairs, rows are not padded to multiples of 8, and no VMEM admission rule
(``weights_fit``, ``shift_kernel_feasible``, ``_vmem_cap``) picks a kernel
variant; K2 and K4 take any N whose tiles fit the card's shared memory
(:func:`~mvlt_tpu_torch.ops.kernels.check_attention_fits`: N <= 162 for K2
and N <= 140 for K4 at head dim 64 on an H100).
One bf16 rounding differs from the fused TPU kernels: the residual sums
that the TPU kernel keeps in f32 between its halves (``res1`` in
``_full_body``, ``x + attn`` before the post-LN) are rounded to the compute
dtype where one K1 hands them to the next kernel (in the inference forwards;
the training forwards keep them in f32). In float32 the two agree.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import torch

from mvlt_tpu_torch.ops import kernels
from mvlt_tpu_torch.ops.layers import SWIN_LN_EPS
from mvlt_tpu_torch.utils.env import env_flag

# What a forward runs: the kernels, or the same composition on their plain
# versions. The counterparts below are added to both namespaces.
KERNEL_OPS = SimpleNamespace(gemm=kernels.gemm,
                             attention=kernels.biased_attention,
                             layernorm=kernels.layernorm)
PLAIN_OPS = SimpleNamespace(gemm=kernels.gemm_plain,
                            attention=kernels.biased_attention_plain,
                            layernorm=kernels.layernorm_plain)
KERNEL_OPS.attention_bwd = kernels.biased_attention_bwd
KERNEL_OPS.layernorm_bwd = kernels.layernorm_bwd
KERNEL_OPS.column_sum = kernels.column_sum
PLAIN_OPS.attention_bwd = kernels.biased_attention_bwd_plain
PLAIN_OPS.layernorm_bwd = kernels.layernorm_bwd_plain
PLAIN_OPS.column_sum = kernels.column_sum_plain


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
                     shift_spec=None, dp=None, store_p: bool = False):
    if _swin_trains(x, params, bias, dp):
        return _swin_train(p, x, params, bias, scale, num_heads, shift_spec,
                           dp, half=False, store_p=store_p)
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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _cast(t, like):
    return None if t is None else t.to(like.dtype)


def _rows2(t):
    """(..., C) -> contiguous (rows, C), or None."""
    return None if t is None else t.reshape(-1, t.shape[-1]).contiguous()


def _swin_trains(x, params, bias, dp) -> bool:
    """Whether a Swin block runs its training form: DropPath multipliers
    are given, or a gradient is needed."""
    return dp is not None or _needs_grad(x, bias, *params)


def _swin_train_forward(p, rows, params, bias, scale, num_heads, N, idx, dp,
                        half, store_p=False):
    """The training forward on (M, C) raw rows; returns (out (M, C) in
    ``rows.dtype``, unshifted; qkv and ctx in the (shifted) window layout;
    with ``store_p`` the softmax (BW, nH, N, N) in that layout, else
    None)."""
    (ln1s, ln1b, wqkv, bqkv, wproj, bproj,
     ln2s, ln2b, w1, b1, w2, b2) = params
    dp1, dp2 = (None, None) if dp is None else dp
    C = rows.shape[1]
    h = p.layernorm(rows, ln1s, ln1b, SWIN_LN_EPS, row_index=idx)
    qkv = p.gemm(h, wqkv, bqkv)
    pst = None
    if half:
        ctx = p.attention_core(qkv.view(-1, N, 3 * C), bias, scale,
                               num_heads).view(-1, C)
    elif store_p:
        ctx, pst = p.attention(qkv, num_heads, N, scale, pattern=bias,
                               save_p=True)
    else:
        ctx = p.attention(qkv, num_heads, N, scale, pattern=bias)
    res1 = p.gemm(ctx, wproj, bproj, residual=rows, residual_index=idx,
                  row_scale=dp1, out_dtype=torch.float32)
    h2 = p.layernorm(res1, ln2s, ln2b, SWIN_LN_EPS, out_dtype=rows.dtype)
    m = p.gemm(h2, w1, b1, gelu=True)
    out = p.gemm(m, w2, b2, residual=res1, row_scale=dp2, store_index=idx,
                 out_dtype=rows.dtype)
    return out, qkv, ctx, pst


class _SwinBlock(torch.autograd.Function):
    """The Swin block's training forward with the store-residual backward
    (``_full_fwd`` / ``_swin_half_block_fwd`` and ``_stored_block_bwd``);
    with ``store_p`` the forward also saves the softmax and the backward
    starts from it (``_full_kernel_save_p``, ``attention_core_bwd_flat``'s
    ``p2`` path)."""

    @staticmethod
    def forward(ctx, p, x, bias, dp1, dp2, scale, num_heads, shift_spec, half,
                store_p, *params):
        BW, N, C = x.shape
        rows = x.reshape(BW * N, C).contiguous()
        idx = _block_shift_index(BW * N, shift_spec, x.device)
        dp = None if dp1 is None else (dp1, dp2)
        out, qkv, cx, pst = _swin_train_forward(p, rows, params, bias, scale,
                                                num_heads, N, idx, dp, half,
                                                store_p)
        ctx.save_for_backward(rows, bias, dp1, dp2, qkv, cx, pst, *params)
        ctx.p, ctx.dims = p, (BW, N, C, scale, num_heads, idx)
        return out.view(BW, N, C)

    @staticmethod
    def backward(ctx, g):
        p, (BW, N, C, scale, num_heads, idx) = ctx.p, ctx.dims
        rows, bias, dp1, dp2, qkv, cx, pst, *params = ctx.saved_tensors
        (ln1s, ln1b, wqkv, bqkv, wproj, bproj,
         ln2s, ln2b, w1, b1, w2, b2) = params
        f32 = torch.float32
        g2 = g.reshape(BW * N, C).to(rows.dtype).contiguous()
        xs = rows
        if idx is not None:                     # into the shifted layout
            g2, xs = (t.index_select(0, idx.long()) for t in (g2, rows))
        dp = None if dp1 is None else (dp1, dp2)
        (dres1, da, dbproj, dw1, db1, dw2, db2, dln2s,
         dln2b) = p.swin_mlp_half_bwd(xs, cx, g2, wproj, bproj, ln2s, ln2b,
                                      w1, b1, w2, dp)
        dwproj = p.gemm(da, cx, layout="tn", out_dtype=f32)
        dctx = p.gemm(da, wproj, layout="nn")
        # the kill switch is read again here, as attention_core_bwd_flat
        # reads it (pallas_attn.py:3943)
        p2 = None if pst is None or env_flag("MVLT_NO_STOREP") else pst
        dqkv, dbias = p.attention_core_bwd(qkv, dctx, bias, N, scale,
                                           num_heads, p2=p2)
        dx, dwqkv, dbqkv, dln1s, dln1b = p.swin_qkv_tail_bwd(
            xs, dqkv, dres1, wqkv, ln1s, ln1b)
        if idx is not None:                     # back to the unshifted rows
            out = torch.empty_like(dx)
            out[idx.long()] = dx
            dx = out
        grads = (dln1s, dln1b, dwqkv, dbqkv, dwproj, dbproj, dln2s, dln2b,
                 dw1, db1, dw2, db2)
        return (None, dx.view(BW, N, C),
                dbias if ctx.needs_input_grad[2] else None,
                None, None, None, None, None, None, None,
                *(_cast(d, w) for d, w in zip(grads, params)))


def _block_shift_index(M: int, shift_spec, device):
    if shift_spec is None:
        return None
    H, W, window, shift = shift_spec
    return _shift_index(M // (H * W), H, W, window, shift, device)


def _swin_train(p, x, params, bias, scale, num_heads, shift_spec, dp, half,
                store_p=False):
    """The training form; p is stored only where a backward will read it."""
    dp1, dp2 = (None, None) if dp is None else dp
    if _needs_grad(x, bias, *params):
        return _SwinBlock.apply(p, x, bias, dp1, dp2, scale, num_heads,
                                shift_spec, half, store_p, *params)
    BW, N, C = x.shape
    rows = x.reshape(BW * N, C)
    idx = _block_shift_index(BW * N, shift_spec, x.device)
    out, _, _, _ = _swin_train_forward(p, rows, params, bias, scale,
                                       num_heads, N, idx, dp, half)
    return out.view(BW, N, C)


def _swin_half_block(p, x, params, bias, scale: float, num_heads: int, *,
                     shift_spec=None, dp=None):
    return _swin_train(p, x, params, bias, scale, num_heads, shift_spec, dp,
                       half=True)


def _attention_core(p, qkv, bias, scale: float, num_heads: int):
    BW, N, C3 = qkv.shape
    ctx = p.attention(qkv.reshape(BW * N, C3), num_heads, N, scale,
                      pattern=bias)
    return ctx.view(BW, N, C3 // 3)


def _attention_core_bwd(p, qkv2, dctx2, bias, n: int, scale: float,
                        num_heads: int, p2=None):
    dqkv2, _, dbias = p.attention_bwd(qkv2, dctx2, num_heads, n, scale,
                                      pattern=bias, p=p2)
    return dqkv2, dbias


def _swin_mlp_half_bwd(p, x2, ctx2, g2, wproj, bproj, ln2s, ln2b, w1, b1, w2,
                       dp=None, eps: float = SWIN_LN_EPS):
    f32 = torch.float32
    dp1, dp2 = (None, None) if dp is None else dp
    res1 = p.gemm(ctx2, wproj, bproj, residual=x2, row_scale=dp1,
                  out_dtype=f32)                        # res1 recompute
    h2 = p.layernorm(res1, ln2s, ln2b, eps, out_dtype=x2.dtype)
    m, a1 = p.gemm(h2, w1, b1, gelu=True, save_preact=True)
    if dp2 is None:
        dmlp, db2 = g2, p.column_sum(g2)
    else:
        db2, dmlp = p.column_sum(g2, row_scale=dp2)     # g * dp2 and its sum
    dw2 = p.gemm(dmlp, m, layout="tn", out_dtype=f32)
    da1 = p.gemm(dmlp, w2, layout="nn", gelu_grad=a1)
    db1 = p.column_sum(da1)
    dw1 = p.gemm(da1, h2, layout="tn", out_dtype=f32)
    dh2 = p.gemm(da1, w1, layout="nn", out_dtype=f32)
    dres1, da, dln2s, dln2b, dbproj = p.layernorm_bwd(
        res1, ln2s, dh2, eps, gres=g2, row_scale=dp1, out_dtype=x2.dtype)
    return dres1, da, dbproj, dw1, db1, dw2, db2, dln2s, dln2b


def _swin_qkv_tail_bwd(p, x2, dqkv2, dres1, wqkv, ln1s, ln1b,
                       eps: float = SWIN_LN_EPS):
    f32 = torch.float32
    h1 = p.layernorm(x2, ln1s, ln1b, eps)                # LN1 recompute
    dwqkv = p.gemm(dqkv2, h1, layout="tn", out_dtype=f32)
    dbqkv = p.column_sum(dqkv2)
    dh1 = p.gemm(dqkv2, wqkv, layout="nn", out_dtype=f32)
    _, dx, dln1s, dln1b, _ = p.layernorm_bwd(x2, ln1s, dh1, eps, gres=dres1,
                                             out_dtype=x2.dtype)
    return dx, dwqkv, dbqkv, dln1s, dln1b


class _AttnLN(torch.autograd.Function):
    """``fused_attn_ln`` / ``fused_attn_ln_masked`` / ``fused_attn_ln_adrop``
    with the store-residual backward (``_attn_ln_bwd_stored``, bf16 branch
    :2653-2672). With in-kernel dropout it saves the (2,) seed, not a
    mask."""

    @staticmethod
    def forward(ctx, p, x, wqkv, bqkv, wproj, bproj, kbias, qbias, amask,
                hmask, lns, lnb, seed, rate, scale, num_heads, eps):
        B, N, C = x.shape
        rows = x.reshape(B * N, C).contiguous()
        hm = _rows2(hmask)
        adrop = None if seed is None else (seed, rate)
        qkv = p.gemm(rows, wqkv, bqkv)
        attn = p.attention(qkv, num_heads, N, scale, key_bias=kbias,
                           qbias=qbias, amask=amask, adrop=adrop)
        res = p.gemm(attn, wproj, bproj, residual=rows, emask=hm,
                     out_dtype=torch.float32)
        out = p.layernorm(res, lns, lnb, eps, out_dtype=x.dtype)
        ctx.save_for_backward(rows, wqkv, bqkv, wproj, bproj, kbias, qbias,
                              amask, hm, lns, qkv, attn, res, seed)
        ctx.p, ctx.dims = p, (B, N, C, scale, num_heads, eps, rate)
        return out.view(B, N, C)

    @staticmethod
    def backward(ctx, g):
        p, (B, N, C, scale, num_heads, eps, rate) = ctx.p, ctx.dims
        (rows, wqkv, bqkv, wproj, bproj, kbias, qbias, amask, hm, lns, qkv,
         attn, res, seed) = ctx.saved_tensors
        f32 = torch.float32
        g2 = g.reshape(B * N, C).to(rows.dtype).contiguous()
        # da = dres * hmask feeds the proj products and dbproj; the residual
        # path takes the unmasked dres
        dres, da, dlns, dlnb, dbproj = p.layernorm_bwd(res, lns, g2, eps,
                                                       hmask=hm)
        dwproj = p.gemm(da, attn, layout="tn", out_dtype=f32)
        dctx = p.gemm(da, wproj, layout="nn")
        dqkv, dkbias = p.seq_attention_core_bwd(
            qkv.view(B, N, 3 * C), dctx.view(B, N, C), kbias, qbias, amask,
            scale, num_heads, adrop=None if seed is None else (seed, rate))
        dqkv = dqkv.reshape(B * N, 3 * C)
        dwqkv = p.gemm(dqkv, rows, layout="tn", out_dtype=f32)
        dbqkv = p.column_sum(dqkv) if bqkv is not None else None
        dx = p.gemm(dqkv, wqkv, layout="nn", residual=dres,
                    out_dtype=rows.dtype)
        return (None, dx.view(B, N, C), _cast(dwqkv, wqkv), _cast(dbqkv, bqkv),
                _cast(dwproj, wproj), _cast(dbproj, bproj),
                dkbias if ctx.needs_input_grad[6] else None, None, None, None,
                dlns, dlnb, None, None, None, None, None)


class _MlpLN(torch.autograd.Function):
    """``fused_mlp_ln`` / ``fused_mlp_ln_masked`` with the store-residual
    backward (``mlp_ln_half_bwd``)."""

    @staticmethod
    def forward(ctx, p, x, w1, b1, w2, b2, hmask, lns, lnb, eps):
        rows = x.reshape(-1, x.shape[-1]).contiguous()
        hm = _rows2(hmask)
        m = p.gemm(rows, w1, b1, gelu=True)
        res = p.gemm(m, w2, b2, residual=rows, emask=hm,
                     out_dtype=torch.float32)
        out = p.layernorm(res, lns, lnb, eps, out_dtype=x.dtype)
        ctx.save_for_backward(rows, w1, b1, w2, b2, hm, lns, res)
        ctx.p, ctx.shape, ctx.eps = p, x.shape, eps
        return out.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        rows, w1, b1, w2, b2, hm, lns, res = ctx.saved_tensors
        g2 = g.reshape(rows.shape).to(rows.dtype).contiguous()
        dx, dw1, db1, dw2, db2, dlns, dlnb = ctx.p.mlp_ln_half_bwd(
            rows, res, g2, hm, w1, b1, w2, lns, ctx.eps)
        return (None, dx.to(rows.dtype).view(ctx.shape), _cast(dw1, w1),
                _cast(db1, b1), _cast(dw2, w2), _cast(db2, b2), None, dlns,
                dlnb, None)


def _attn_ln(p, x, wqkv, bqkv, wproj, bproj, kbias, qbias, amask, hmask,
             lns, lnb, scale, num_heads, eps, adrop=None):
    if _needs_grad(x, wqkv, bqkv, wproj, bproj, lns, lnb):
        seed, rate = (None, 0.0) if adrop is None else adrop
        return _AttnLN.apply(p, x, wqkv, bqkv, wproj, bproj, kbias, qbias,
                             amask, hmask, lns, lnb, seed, rate, scale,
                             num_heads, eps)
    B, N, C = x.shape
    rows = x.reshape(B * N, C)
    qkv = p.gemm(rows, wqkv, bqkv)
    ctx = p.attention(qkv, num_heads, N, scale, key_bias=kbias, qbias=qbias,
                      amask=amask, adrop=adrop)
    res = p.gemm(ctx, wproj, bproj, residual=rows, emask=_rows2(hmask))
    return p.layernorm(res, lns, lnb, eps).view(B, N, C)


def _mlp_ln(p, x, w1, b1, w2, b2, hmask, lns, lnb, eps):
    if _needs_grad(x, w1, b1, w2, b2, lns, lnb):
        return _MlpLN.apply(p, x, w1, b1, w2, b2, hmask, lns, lnb, eps)
    rows = x.reshape(-1, x.shape[-1])
    m = p.gemm(rows, w1, b1, gelu=True)
    res = p.gemm(m, w2, b2, residual=rows, emask=_rows2(hmask))
    return p.layernorm(res, lns, lnb, eps).view(x.shape)


def _fused_attn_ln(p, x, wqkv, bqkv, wproj, bproj, kbias, lns, lnb,
                   scale: float, num_heads: int, eps: float = 1e-12):
    return _attn_ln(p, x, wqkv, bqkv, wproj, bproj, kbias, None, None, None,
                    lns, lnb, scale, num_heads, eps)


def _fused_attn_ln_masked(p, x, wqkv, bqkv, wproj, bproj, kbias, qbias,
                          amask, hmask, lns, lnb, scale: float,
                          num_heads: int, eps: float = 1e-12):
    return _attn_ln(p, x, wqkv, bqkv, wproj, bproj, kbias, qbias, amask,
                    hmask, lns, lnb, scale, num_heads, eps)


def _fused_attn_ln_adrop(p, x, wqkv, bqkv, wproj, bproj, kbias, qbias, hmask,
                         lns, lnb, adrop_seed, scale: float, num_heads: int,
                         adrop_rate: float, eps: float = 1e-12):
    return _attn_ln(p, x, wqkv, bqkv, wproj, bproj, kbias, qbias, None, hmask,
                    lns, lnb, scale, num_heads, eps,
                    adrop=(adrop_seed, adrop_rate))


def _fused_mlp_ln(p, x, w1, b1, w2, b2, lns, lnb, eps: float = 1e-12):
    return _mlp_ln(p, x, w1, b1, w2, b2, None, lns, lnb, eps)


def _fused_mlp_ln_masked(p, x, w1, b1, w2, b2, hmask, lns, lnb,
                         eps: float = 1e-12):
    return _mlp_ln(p, x, w1, b1, w2, b2, hmask, lns, lnb, eps)


def _seq_attention_core_bwd(p, qkv, dctx, kbias, qbias, amask, scale: float,
                            num_heads: int, adrop=None):
    B, N, C3 = qkv.shape
    dqkv, dkbias = p.attention_bwd(
        qkv.reshape(B * N, C3), dctx.reshape(B * N, C3 // 3), num_heads, N,
        scale, key_bias=kbias, qbias=qbias, amask=amask, adrop=adrop)
    return dqkv.view(B, N, C3), dkbias


def _mlp_ln_half_bwd(p, x2, res2, g2, hmask2, w1, b1, w2, lns,
                     eps: float = 1e-12):
    f32 = torch.float32
    dres, dmlp, dlns, dlnb, db2 = p.layernorm_bwd(res2, lns, g2, eps,
                                                  hmask=hmask2)
    m, a1 = p.gemm(x2, w1, b1, gelu=True, save_preact=True)   # fc1 recompute
    dw2 = p.gemm(dmlp, m, layout="tn", out_dtype=f32)
    da1 = p.gemm(dmlp, w2, layout="nn", gelu_grad=a1)
    db1 = p.column_sum(da1)
    dw1 = p.gemm(da1, x2, layout="tn", out_dtype=f32)
    dx = p.gemm(da1, w1, layout="nn", residual=dres, out_dtype=f32)
    return dx, dw1, db1, dw2, db2, dlns, dlnb


# the launch counts of a counterpart, one per TPU kernel it can stand for,
# and the counts of the opt-in modes within them
COUNTS = ("launches", "shift_launches", "train_launches",
          "train_shift_launches", "train_store_p_launches",
          "train_shift_store_p_launches", "store_p_launches",
          "adrop_launches")


def _shift_count(x, args, kw) -> str:
    return "shift_launches" if kw.get("shift_spec") is not None else "launches"


def _full_block_count(x, args, kw) -> str:
    train = _swin_trains(x, args[0], args[1], kw.get("dp"))
    return ("train_" if train else "") + _shift_count(x, args, kw)


def _full_block_mode(x, args, kw):
    """A training block that stores p (under autograd) also counts in
    ``train_store_p_launches`` / ``train_shift_store_p_launches``."""
    if not (kw.get("store_p") and _needs_grad(x, args[1], *args[0])):
        return None
    return _full_block_count(x, args, kw).replace("launches",
                                                  "store_p_launches")


def _kw_mode(key: str, name: str):
    """A mode count: ``name`` when the keyword ``key`` is given."""
    return lambda x, args, kw: name if kw.get(key) is not None else None


def _twins(body, doc: str, count=_shift_count, mode=None):
    """(kernel twin with launch counts, plain twin) of ``body``. A kernel
    call adds one to the count that ``count(x, args, kw)`` names: a call
    with a ``shift_spec`` counts in ``shift_launches``, as the shifted Swin
    block replaces a TPU kernel of its own; ``swin_full_block``'s training
    form counts in ``train_launches`` / ``train_shift_launches``. An opt-in
    mode also counts in the count that ``mode(x, args, kw)`` names, if
    any; ``kernel_twin.counts_for(x, args, kw)`` names the counts a call
    adds to."""
    def counts_for(x, args, kw):
        return tuple(filter(None, (count(x, args, kw),
                                   mode and mode(x, args, kw))))

    def kernel_twin(x, *args, **kw):
        out = body(KERNEL_OPS, x, *args, **kw)
        if x.is_cuda:
            for name in counts_for(x, args, kw):
                setattr(kernel_twin, name, getattr(kernel_twin, name) + 1)
        return out

    def plain_twin(x, *args, **kw):
        return body(PLAIN_OPS, x, *args, **kw)

    name = body.__name__.lstrip("_")
    kernel_twin.__name__, kernel_twin.__doc__ = name, doc
    kernel_twin.counts_for = counts_for
    plain_twin.__name__ = name + "_plain"
    plain_twin.__doc__ = f"Plain PyTorch twin of :func:`{name}`."
    for c in COUNTS:
        setattr(kernel_twin, c, 0)
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
:994) and ``bias`` must carry the shift mask per window (P = nW).
``dp``: None or the DropPath multipliers (dp1, dp2) of the attention and MLP
branches, each (B,) f32 (0 or 1/keep per image). With ``dp``, or when a
gradient is needed, the block runs its training form (res1 kept in f32; an
autograd Function under grad) and counts in ``train_launches`` /
``train_shift_launches``. ``store_p``: under autograd, K2 also writes the
softmax (BW, nH, N, N) in the compute dtype and the backward starts from it
(K4 stored-p); such a call also counts in ``train_store_p_launches`` /
``train_shift_store_p_launches``.""", count=_full_block_count,
    mode=_full_block_mode)

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

fused_attn_ln_masked, fused_attn_ln_masked_plain = _twins(
    _fused_attn_ln_masked, """\
Training / seq2seq twin of ``fused_attn_ln``:
``LN(x + proj(attn(x)) * hmask)``, the softmax of ``q k^T * scale + kbias +
qbias`` multiplied by ``amask`` before the PV product. kbias (B, N) f32 or
None, qbias (B, N, N) f32 or None, amask (B, nH, N, N) and hmask (B, N, C)
in the compute dtype or None. K1 qkv -> K2 (kbias, qbias, amask) -> K1 proj
(emask = hmask, + x) -> K3.""")

fused_attn_ln_adrop, fused_attn_ln_adrop_plain = _twins(
    _fused_attn_ln_adrop, """\
``fused_attn_ln_masked`` with in-kernel attention dropout (JAX's argument
order): no amask; ``adrop_seed`` a (2,) int32 tensor of two 16-bit halves on
x's device, ``adrop_rate`` the dropout rate. K1 qkv -> K2 (kbias, qbias,
the Philox mask of ``kernels.adrop_mask_plain(adrop_seed, B, nH, N,
adrop_rate)``, values 0 or f32(1/keep)) -> K1 proj (emask = hmask, + x) ->
K3. Under autograd the seed is saved and the backward's K4 regenerates the
same mask.""")

fused_mlp_ln_masked, fused_mlp_ln_masked_plain = _twins(
    _fused_mlp_ln_masked, """\
Training twin of ``fused_mlp_ln``: ``LN(x + fc2(GELU(fc1 x)) * hmask)`` over
rows of (..., C); hmask has the shape of x. K1 fc1+GELU -> K1 fc2
(emask = hmask, + x) -> K3.""")

seq_attention_core_bwd, seq_attention_core_bwd_plain = _twins(
    _seq_attention_core_bwd, """\
VJP of the attention core of ``fused_attn_ln(_masked)`` wrt (qkv, kbias),
from the saved fused rows: qkv (B, N, 3C), dctx (B, N, C), kbias (B, N) f32
or None, qbias (B, N, N) f32 or None, amask (B, nH, N, N) or None; ``adrop``
None or the forward's ``(seed, rate)``, whose mask K4 regenerates (counted
also in ``adrop_launches``). Returns ``(dqkv (B, N, 3C) in qkv.dtype,
dkbias (B, N) f32)``.""", mode=_kw_mode("adrop", "adrop_launches"))

mlp_ln_half_bwd, mlp_ln_half_bwd_plain = _twins(_mlp_ln_half_bwd, """\
Backward of the post-LN MLP half from the saved f32 pre-LN sum: x2, g2
(M, C), res2 (M, C) f32, w1 (I, C), b1 (I,), w2 (C, I), lns (C,). Returns
``(dx (M, C) f32 with the residual term, dw1, db1, dw2, db2, dlns, dlnb)``,
weight grads f32 in the port's (out, in) layout. K5 LN VJP -> K1 fc1
recompute (GELU and the f32 pre-activation) -> K1 tn dW2 -> K1 nn dm with
the GELU' epilogue -> K5 column sum db1 -> K1 tn dW1 -> K1 nn dx (+dres).
``hmask2`` (M, C) or None: the fc2 output's dropout mask; K5 applies it to
dmlp and db2 (``_mlp_ln_bwd_kernel`` :2984-2989).""")

swin_half_block, swin_half_block_plain = _twins(_swin_half_block, """\
Wide-stage Swin block for training (``swin_half_block``, pallas_attn.py
:3573) on (BW, N, C) raw windows, with the arguments of
``swin_full_block``: LN1 -> K1 qkv (``_ln_matmul_kernel``) ->
``attention_core`` -> the tail (``_swin_tail_kernel``: K1 proj with dp1 and
+x in f32 -> K3 LN2 -> K1 fc1+GELU -> K1 fc2 with dp2 and +res1). The same
math and kernels as ``swin_full_block``'s training form; an autograd
Function under grad, with the same backward.""")

attention_core, attention_core_plain = _twins(_attention_core, """\
``softmax(q k^T * scale + bias[g % P]) v`` on fused-qkv windows (K2 with
patterns): qkv (BW, N, 3C), bias (P, nH, N, N) f32 with BW % P == 0.
Returns ctx (BW, N, C).""")

attention_core_bwd, attention_core_bwd_plain = _twins(_attention_core_bwd, """\
VJP of ``attention_core`` wrt (qkv, bias) on flat rows (K4's pattern mode):
qkv2 (BW*n, 3C), dctx2 (BW*n, C), bias (P, nH, n, n) f32 with BW % P == 0.
Returns ``(dqkv2 (BW*n, 3C) in qkv2.dtype, dbias (P, nH, n, n) f32)``,
dbias the sum of ds over the windows that share a pattern, in a fixed
order. Serves both ``attention_core_bwd_flat`` and the per-window
``attention_core_bwd``, whose difference is a TPU layout choice. ``p2``:
None, or the softmax (BW, nH, n, n) that ``swin_full_block(...,
store_p=True)`` saved, used in place of the QK^T / exp recompute (K4
stored-p, ``_core_bwd_storep_kernel``; counted also in
``store_p_launches``).""", mode=_kw_mode("p2", "store_p_launches"))

swin_mlp_half_bwd, swin_mlp_half_bwd_plain = _twins(_swin_mlp_half_bwd, """\
Backward of the pre-LN Swin block's MLP half over flattened (shifted) rows:
x2, ctx2 (M, C) and the block output's cotangent g2 (M, C) in the compute
dtype, weights in the (out, in) layout, ``dp`` None or (dp1, dp2) (B,) f32.
Recomputes res1 = x + dp1 * (ctx Wproj^T + bproj) (K1, row scale, f32 out),
LN2 (K3) and fc1 + GELU (K1, saving the pre-activation); then K5 column sum
of g * dp2 (its scaled copy dmlp and db2), K1 tn dW2, K1 nn da1 with the
GELU' epilogue, K5 db1, K1 tn dW1, K1 nn dh2 (f32), and K5 in pre-LN form:
dres1 = g + LN2^T(dh2), da = dres1 * dp1 and their sums. Returns ``(dres1
(M, C) f32, da (M, C) in the compute dtype, dbproj, dw1, db1, dw2, db2,
dln2s, dln2b)``, sums f32. ``ddp1`` / ``ddp2`` of ``_swin_mlp_bwd_kernel``
are not computed: the DropPath multipliers come from a Bernoulli draw,
where their cotangent stops, and no parameter depends on them (b2 enters
only ddp2, so the port does not take it).""")

swin_qkv_tail_bwd, swin_qkv_tail_bwd_plain = _twins(_swin_qkv_tail_bwd, """\
Backward of the pre-LN Swin block's qkv head over flattened (shifted) rows:
x2 (M, C) and dqkv2 (M, 3C) in the compute dtype, dres1 (M, C) f32. LN1
recompute (K3) -> K1 tn dWqkv -> K5 column sum dbqkv -> K1 nn dh1 (f32) ->
K5 in pre-LN form with dres1 as the incoming residual gradient. Returns
``(dx (M, C) in the compute dtype, dwqkv, dbqkv, dln1s, dln1b)``, sums
f32.""")

COUNTERPARTS = (swin_full_block, window_block_attention, fused_mlp_preln,
                fused_attn_ln, fused_mlp_ln, fused_attn_ln_masked,
                fused_mlp_ln_masked, seq_attention_core_bwd, mlp_ln_half_bwd,
                swin_half_block, attention_core, attention_core_bwd,
                swin_mlp_half_bwd, swin_qkv_tail_bwd, fused_attn_ln_adrop)

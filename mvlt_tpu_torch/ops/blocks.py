"""The TPU kernels of the VQA forward, of the fusion encoder's training
steps (VQA finetune, MLM+ITM pretrain), of the Swin backbone's training
step and of its ``attn_impl='pallas'`` route, and the three that no entry
point reaches, rebuilt from K1-K5: every ``pl.pallas_call`` of
``mvlt_tpu/ops/pallas_attn.py``, and every backward rule around one, has a
counterpart here.

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
``window_attention``         ``_kernel`` (:40, entry ``window_attention``
                             :112), on K2's head-major mode; backward
                             ``window_attention_bwd`` (``_bwd`` :128) on
                             K4's pattern mode
``swin_attn_half``           ``_attn_half_kernel`` (:3228, entry :3272),
                             on K3 + K1 + K2 + K1
``fused_seq_attention``      ``_seq_attn_kernel`` (:334, entry :386), on
                             K1 + K2 + K1; backward
                             ``fused_seq_attention_bwd`` (``_seq_bwd``
                             :440) on K1 + K4 + K5
``full_forward_windows``     ``_full_kernel_windows`` (:1161, entry
                             ``_full_forward_windows`` :1206), as
                             ``swin_full_block``
``window_block_attention``   ``_block_bwd`` (:2092), which recomputes with
  under autograd             ``attention_core`` and differentiates through
                             ``attention_core_bwd``: K1 + K2 + K1 + K5 +
                             K4 (pattern) (``window_block_attention_bwd``)
``fused_mlp_preln``          ``_mlp_preln_bwd`` (:3429, a ``jax.vjp`` of
  under autograd             the XLA reference), on K3 + K1 + K5
                             (``fused_mlp_preln_bwd``)
``swin_attn_half``           ``_attn_half_bwd`` (:3345, a ``jax.vjp`` of
  under autograd             the XLA reference), on K3 + K1 + K2 + K4 +
                             ``swin_qkv_tail_bwd`` (``swin_attn_half_bwd``)
``attention_core_op``        ``_core_op_fwd`` / ``_core_op_bwd`` (:4131),
                             row 19 forward, row 21 backward
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

Tensor parallelism (``tp=``, a model group: ``parallel/shard.TP``). The
fusion rows 4 / 15 / 15' (``fused_attn_ln*``) and 5 / 17' (``fused_mlp_ln*``)
take the rank's heads of the fused qkv (or its fc1 columns) and its rows of
proj (or fc2), as Megatron splits them: K1 qkv (or fc1 + GELU) -> K2 on the
rank's heads -> K1 on the rank's rows with no epilogue, writing f32 partial
sums -> Megatron's *g* (an all-reduce over the group) -> bias (added once),
hidden mask and residual in f32 -> K3. Their backwards (rows 16 and 17) run
K5 -> K1 tn / nn on the local shards -> K4 on the local heads -> *f* (the
f32 partial input gradient all-reduced, then the residual's added). In-kernel
dropout passes ``(seed, rate, head0)``, the rank's first global head, so a
rank draws what one device draws for its heads. The counterparts count one
launch a call either way.

The Swin rows take ``tp=`` too, cut at the same two points. The half rows
(``window_block_attention``, ``swin_attn_half``, ``fused_mlp_preln`` and
their VJPs) take one model group; the whole-block rows (``swin_full_block``,
``swin_half_block``, ``swin_mlp_half_bwd``) a pair, (the attention half's
group, the MLP's), each None where that half runs whole (a block whose
heads mp does not divide holds its attention half). Forward: K3 LN1 (+ the
shift gather) -> K1 qkv on the rank's rows of the fused q / k / v -> K2 on
its heads, with its heads' slice of the pattern bias (built from the
rank's columns of the relative-position table: a contiguous tensor of
nH / mp heads, not a head offset) -> K1 proj on its columns into f32
partial sums -> all-reduce -> bias, DropPath row scale and residual added
once in f32 -> K3 LN2 -> K1 fc1 + GELU on its columns -> K1 fc2 into f32
partials -> all-reduce -> bias, row scale, residual -> cast and the shift
scatter. Serving takes the same cut points (res1 in f32). Backward: K1 tn
/ nn on the local shards, K4 on the local heads, and the f32 partial of
LN2's and LN1's input gradient all-reduced before K5's pre-LN VJP
(:func:`_grad_sum`); res1 is recomputed through the same all-reduce. The
table's gradient covers the rank's heads; the model summing it over the
group (``comm.copy_to_group`` on the table) keeps the replicated table
equal on every rank. No partial is rounded to bf16 before its sum.

They hold the math of the JAX interpret path (``fast=False``), not the TPU
fast path. The TPU layout choices are dropped: windows are not merged into
pairs, rows are not padded to multiples of 8, and no VMEM admission rule
(``weights_fit``, ``shift_kernel_feasible``, ``_vmem_cap``) picks a kernel
variant; K2 and K4 take any N their tile plans admit
(:func:`~mvlt_tpu_torch.ops.kernels.attention_plan`,
:func:`~mvlt_tpu_torch.ops.kernels.attention_bwd_plan`, checked against
the card's shared memory by
:func:`~mvlt_tpu_torch.ops.kernels.check_attention_fits`): 64 query rows a
block with the scores of up to nine 32-key chunks in registers up to N =
288, and past it the long form, 128 rows a block, which streams the keys
(K4's second pass: the queries) through a ring of 32-row chunks, up to N =
46,340 at head dims 16-64. Rows 4, 15, 15' and 16 (``fused_attn_ln``,
``fused_attn_ln_masked``, ``fused_attn_ln_adrop``,
``seq_attention_core_bwd``) therefore run at any S
the fusion encoder gives them, as JAX's fused encoder does (it has no
length gate); the window modes (pattern, stored p, head-major: the Swin
rows) keep N <= 288 and refuse beyond it before a launch.
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
import torch.utils.checkpoint

from mvlt_tpu_torch.ops import kernels
from mvlt_tpu_torch.ops.layers import SWIN_LN_EPS
from mvlt_tpu_torch.parallel import comm
from mvlt_tpu_torch.utils.env import env_flag

# What a forward runs: the kernels, or the same composition on their plain
# versions. The counterparts below are added to both namespaces.
KERNEL_OPS = SimpleNamespace(gemm=kernels.gemm,
                             attention=kernels.biased_attention,
                             layernorm=kernels.layernorm)
PLAIN_OPS = SimpleNamespace(gemm=kernels.gemm_plain,
                            attention=kernels.biased_attention_plain,
                            layernorm=kernels.layernorm_plain)
KERNEL_OPS.attention_heads = kernels.biased_attention_heads
PLAIN_OPS.attention_heads = kernels.biased_attention_heads_plain
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
                     shift_spec=None, dp=None, store_p: bool = False,
                     tp=None):
    if _swin_trains(x, params, bias, dp) or tp is not None:
        # under TP serving takes the training form's f32 cut points too
        return _swin_train(p, x, params, bias, scale, num_heads, shift_spec,
                           dp, half=False, store_p=store_p, tp=tp)
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


def _block_forward(p, x, wqkv, bqkv, wproj, bproj, bias, scale, num_heads,
                   residual=None, tp=None):
    BW, N, C = x.shape
    qkv = p.gemm(x.reshape(BW * N, C), wqkv, bqkv)
    ctx = p.attention(qkv, num_heads, N, scale, pattern=bias)
    res = None if residual is None else residual.reshape(BW * N, C)
    if tp is None:
        return p.gemm(ctx, wproj, bproj, residual=res).view(BW, N, C)
    return _proj_sum(p, ctx, wproj, bproj, None, res, tp, x.dtype).view(
        BW, N, C)


class _WindowBlockAttention(torch.autograd.Function):
    """``window_block_attention`` with the VJP of ``_block_bwd``
    (pallas_attn.py:2092): it saves the inputs and recomputes qkv and ctx,
    as JAX does."""

    @staticmethod
    def forward(ctx, p, x, wqkv, bqkv, wproj, bproj, bias, residual, scale,
                num_heads, tp):
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, bias)
        ctx.p, ctx.dims, ctx.tp = p, (scale, num_heads), tp
        return _block_forward(p, x, wqkv, bqkv, wproj, bproj, bias, scale,
                              num_heads, residual, tp)

    @staticmethod
    def backward(ctx, g):
        x, wqkv, bqkv, wproj, bproj, bias = ctx.saved_tensors
        dx, dwqkv, dbqkv, dwproj, dbproj, dbias = \
            ctx.p.window_block_attention_bwd(x, wqkv, bqkv, wproj, bias, g,
                                             *ctx.dims, **_tp_kw(ctx.tp))
        # the folded residual takes the cotangent as it is
        dres = g if ctx.needs_input_grad[7] else None
        return (None, dx, _cast(dwqkv, wqkv), _cast(dbqkv, bqkv),
                _cast(dwproj, wproj), _cast(dbproj, bproj),
                dbias if ctx.needs_input_grad[6] else None, dres, None, None,
                None)


def _window_block_attention(p, x, wqkv, bqkv, wproj, bproj, bias,
                            scale: float, num_heads: int, residual=None, *,
                            tp=None):
    if _needs_grad(x, wqkv, bqkv, wproj, bproj, bias, residual):
        return _WindowBlockAttention.apply(p, x, wqkv, bqkv, wproj, bproj,
                                           bias, residual, scale, num_heads,
                                           tp)
    return _block_forward(p, x, wqkv, bqkv, wproj, bproj, bias, scale,
                          num_heads, residual, tp)


def _proj_bwd(p, ctx2, g2, wproj):
    """The VJP of ``ctx Wproj^T + bproj`` on rows: (K1 tn dWproj f32, K5
    dbproj, K1 nn dctx in g2's dtype)."""
    return (p.gemm(g2, ctx2, layout="tn", out_dtype=torch.float32),
            p.column_sum(g2), p.gemm(g2, wproj, layout="nn"))


def _qkv_bwd(p, x2, dqkv2, wqkv):
    """The VJP of ``x Wqkv^T + bqkv`` on rows: (K1 tn dWqkv f32, K5 dbqkv,
    K1 nn dx in dqkv2's dtype)."""
    return (p.gemm(dqkv2, x2, layout="tn", out_dtype=torch.float32),
            p.column_sum(dqkv2), p.gemm(dqkv2, wqkv, layout="nn"))


def _window_block_attention_bwd(p, x, wqkv, bqkv, wproj, bias, g,
                                scale: float, num_heads: int, *, tp=None):
    BW, N, C = x.shape
    x2 = x.reshape(BW * N, C).contiguous()
    qkv = p.gemm(x2, wqkv, bqkv)                          # recompute (K1)
    Cl = qkv.shape[1] // 3                  # this rank's columns under TP
    ctx2 = p.attention_core(qkv.view(BW, N, 3 * Cl), bias, scale,
                            num_heads).view(BW * N, Cl)   # and K2
    g2 = g.reshape(BW * N, C).to(x.dtype).contiguous()
    dwproj, dbproj, dctx = _proj_bwd(p, ctx2, g2, wproj)
    dqkv, dbias = p.attention_core_bwd(qkv, dctx, bias, N, scale, num_heads)
    if tp is None:
        dwqkv, dbqkv, dx = _qkv_bwd(p, x2, dqkv, wqkv)
    else:
        dwqkv = p.gemm(dqkv, x2, layout="tn", out_dtype=torch.float32)
        dbqkv = p.column_sum(dqkv)
        dx = comm.all_reduce_(p.gemm(dqkv, wqkv, layout="nn",
                                     out_dtype=torch.float32),
                              tp.group).to(x.dtype)
    return dx.view(BW, N, C), dwqkv, dbqkv, dwproj, dbproj, dbias


def _mlp_preln_forward(p, x, ln2s, ln2b, w1, b1, w2, b2, tp=None):
    rows = x.reshape(-1, x.shape[-1])
    h = p.layernorm(rows, ln2s, ln2b, SWIN_LN_EPS)
    m = p.gemm(h, w1, b1, gelu=True)
    if tp is None:
        return p.gemm(m, w2, b2, residual=rows).view(x.shape)
    return _proj_sum(p, m, w2, b2, None, rows, tp, x.dtype).view(x.shape)


class _MlpPreLN(torch.autograd.Function):
    """``fused_mlp_preln`` with the VJP of ``_mlp_preln_bwd``
    (pallas_attn.py:3429), recomputing LN2 and fc1 from the saved x."""

    @staticmethod
    def forward(ctx, p, x, ln2s, ln2b, w1, b1, w2, b2, tp):
        ctx.save_for_backward(x, ln2s, ln2b, w1, b1, w2, b2)
        ctx.p, ctx.tp = p, tp
        return _mlp_preln_forward(p, x, ln2s, ln2b, w1, b1, w2, b2, tp)

    @staticmethod
    def backward(ctx, g):
        x, ln2s, ln2b, w1, b1, w2, b2 = ctx.saved_tensors
        dx, dln2s, dln2b, dw1, db1, dw2, db2 = ctx.p.fused_mlp_preln_bwd(
            x, ln2s, ln2b, w1, b1, w2, g, **_tp_kw(ctx.tp))
        return (None, dx, dln2s, dln2b, _cast(dw1, w1), _cast(db1, b1),
                _cast(dw2, w2), _cast(db2, b2), None)


def _fused_mlp_preln(p, x, ln2s, ln2b, w1, b1, w2, b2, *, tp=None):
    if _needs_grad(x, ln2s, ln2b, w1, b1, w2, b2):
        return _MlpPreLN.apply(p, x, ln2s, ln2b, w1, b1, w2, b2, tp)
    return _mlp_preln_forward(p, x, ln2s, ln2b, w1, b1, w2, b2, tp)


def _fused_mlp_preln_bwd(p, x, ln2s, ln2b, w1, b1, w2, g,
                         eps: float = SWIN_LN_EPS, *, tp=None):
    f32 = torch.float32
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    g2 = g.reshape(x2.shape).to(x.dtype).contiguous()
    h2 = p.layernorm(x2, ln2s, ln2b, eps)                 # LN2 recompute
    m, a1 = p.gemm(h2, w1, b1, gelu=True, save_preact=True)
    db2 = p.column_sum(g2)
    dw2 = p.gemm(g2, m, layout="tn", out_dtype=f32)
    da1 = p.gemm(g2, w2, layout="nn", gelu_grad=a1)
    db1 = p.column_sum(da1)
    dw1 = p.gemm(da1, h2, layout="tn", out_dtype=f32)
    dh2 = _grad_sum(p.gemm(da1, w1, layout="nn", out_dtype=f32), tp)
    # dx = g + LN2^T(dh2): the residual's cotangent enters as gres
    _, dx, dln2s, dln2b, _ = p.layernorm_bwd(x2, ln2s, dh2, eps, gres=g2,
                                             out_dtype=x.dtype, dres=False)
    return dx.view(x.shape), dln2s, dln2b, dw1, db1, dw2, db2


def _tp_kw(tp) -> dict:
    """``{"tp": tp}``, or no keyword off a mesh."""
    return {} if tp is None else {"tp": tp}


def _grad_sum(dh, tp):
    """The f32 input gradient of a column-parallel product (its partial
    over the rank's columns) summed over the model group before the LN VJP
    that takes it: Megatron's *f* backward. ``tp`` None: dh as it is."""
    return dh if tp is None else comm.all_reduce_(dh, tp.group)


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
                        half, store_p=False, tp=None):
    """The training forward on (M, C) raw rows; returns (out (M, C) in
    ``rows.dtype``, unshifted; qkv and ctx in the (shifted) window layout;
    with ``store_p`` the softmax (BW, nH, N, N) in that layout, else
    None). ``tp`` None, or (the attention half's TP, the MLP's), each None
    where that half runs whole: a split half's K1 writes f32 partial sums,
    summed over the model group before the bias, the row scale and the
    residual are added once."""
    (ln1s, ln1b, wqkv, bqkv, wproj, bproj,
     ln2s, ln2b, w1, b1, w2, b2) = params
    dp1, dp2 = (None, None) if dp is None else dp
    tpa, tpm = (None, None) if tp is None else tp
    h = p.layernorm(rows, ln1s, ln1b, SWIN_LN_EPS, row_index=idx)
    qkv = p.gemm(h, wqkv, bqkv)
    Cl = qkv.shape[1] // 3                  # this rank's columns under TP
    pst = None
    if half:
        ctx = p.attention_core(qkv.view(-1, N, 3 * Cl), bias, scale,
                               num_heads).view(-1, Cl)
    elif store_p:
        ctx, pst = p.attention(qkv, num_heads, N, scale, pattern=bias,
                               save_p=True)
    else:
        ctx = p.attention(qkv, num_heads, N, scale, pattern=bias)
    res1 = _proj_sum(p, ctx, wproj, bproj, None, rows, tpa, torch.float32,
                     residual_index=idx, row_scale=dp1)
    h2 = p.layernorm(res1, ln2s, ln2b, SWIN_LN_EPS, out_dtype=rows.dtype)
    m = p.gemm(h2, w1, b1, gelu=True)
    out = _proj_sum(p, m, w2, b2, None, res1, tpm, rows.dtype,
                    row_scale=dp2, store_index=idx)
    return out, qkv, ctx, pst


class _SwinBlock(torch.autograd.Function):
    """The Swin block's training forward with the store-residual backward
    (``_full_fwd`` / ``_swin_half_block_fwd`` and ``_stored_block_bwd``);
    with ``store_p`` the forward also saves the softmax and the backward
    starts from it (``_full_kernel_save_p``, ``attention_core_bwd_flat``'s
    ``p2`` path)."""

    @staticmethod
    def forward(ctx, p, x, bias, dp1, dp2, scale, num_heads, shift_spec, half,
                store_p, tp, *params):
        BW, N, C = x.shape
        rows = x.reshape(BW * N, C).contiguous()
        idx = _block_shift_index(BW * N, shift_spec, x.device)
        dp = None if dp1 is None else (dp1, dp2)
        out, qkv, cx, pst = _swin_train_forward(p, rows, params, bias, scale,
                                                num_heads, N, idx, dp, half,
                                                store_p, tp)
        # every tensor residual goes through save_for_backward, where the
        # saved-tensor hooks of a rematerialised unit see it
        ctx.save_for_backward(rows, bias, dp1, dp2, qkv, cx, pst, idx,
                              *params)
        ctx.p, ctx.dims, ctx.tp = p, (BW, N, C, scale, num_heads), tp
        return out.view(BW, N, C)

    @staticmethod
    def backward(ctx, g):
        p, (BW, N, C, scale, num_heads) = ctx.p, ctx.dims
        tpa = None if ctx.tp is None else ctx.tp[0]
        rows, bias, dp1, dp2, qkv, cx, pst, idx, *params = ctx.saved_tensors
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
                                      w1, b1, w2, dp, **_tp_kw(ctx.tp))
        dwproj = p.gemm(da, cx, layout="tn", out_dtype=f32)
        dctx = p.gemm(da, wproj, layout="nn")
        # the kill switch is read again here, as attention_core_bwd_flat
        # reads it (pallas_attn.py:3943)
        p2 = None if pst is None or env_flag("MVLT_NO_STOREP") else pst
        dqkv, dbias = p.attention_core_bwd(qkv, dctx, bias, N, scale,
                                           num_heads, p2=p2)
        dx, dwqkv, dbqkv, dln1s, dln1b = p.swin_qkv_tail_bwd(
            xs, dqkv, dres1, wqkv, ln1s, ln1b, **_tp_kw(tpa))
        if idx is not None:                     # back to the unshifted rows
            out = torch.empty_like(dx)
            out[idx.long()] = dx
            dx = out
        grads = (dln1s, dln1b, dwqkv, dbqkv, dwproj, dbproj, dln2s, dln2b,
                 dw1, db1, dw2, db2)
        return (None, dx.view(BW, N, C),
                dbias if ctx.needs_input_grad[2] else None,
                None, None, None, None, None, None, None, None,
                *(_cast(d, w) for d, w in zip(grads, params)))


def _block_shift_index(M: int, shift_spec, device):
    if shift_spec is None:
        return None
    H, W, window, shift = shift_spec
    return _shift_index(M // (H * W), H, W, window, shift, device)


def _swin_train(p, x, params, bias, scale, num_heads, shift_spec, dp, half,
                store_p=False, tp=None):
    """The training form; p is stored only where a backward will read it."""
    dp1, dp2 = (None, None) if dp is None else dp
    if _needs_grad(x, bias, *params):
        return _SwinBlock.apply(p, x, bias, dp1, dp2, scale, num_heads,
                                shift_spec, half, store_p, tp, *params)
    BW, N, C = x.shape
    rows = x.reshape(BW * N, C)
    idx = _block_shift_index(BW * N, shift_spec, x.device)
    out, _, _, _ = _swin_train_forward(p, rows, params, bias, scale,
                                       num_heads, N, idx, dp, half, tp=tp)
    return out.view(BW, N, C)


def _swin_half_block(p, x, params, bias, scale: float, num_heads: int, *,
                     shift_spec=None, dp=None, tp=None):
    return _swin_train(p, x, params, bias, scale, num_heads, shift_spec, dp,
                       half=True, tp=tp)


def _attention_core(p, qkv, bias, scale: float, num_heads: int):
    if _needs_grad(qkv, bias):
        raise NotImplementedError(
            "attention_core has no VJP, as in JAX: differentiate "
            "attention_core_op (pallas_attn.py:4120)")
    BW, N, C3 = qkv.shape
    ctx = p.attention(qkv.reshape(BW * N, C3), num_heads, N, scale,
                      pattern=bias)
    return ctx.view(BW, N, C3 // 3)


class _AttentionCoreOp(torch.autograd.Function):
    """``attention_core_op``: row 19's forward, row 21's backward
    (``_core_op_fwd`` / ``_core_op_bwd``, pallas_attn.py:4131-4138)."""

    @staticmethod
    def forward(ctx, p, qkv, bias, scale, num_heads):
        ctx.save_for_backward(qkv, bias)
        ctx.p, ctx.dims = p, (scale, num_heads)
        return p.attention_core(qkv, bias, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        qkv, bias = ctx.saved_tensors
        BW, N, C3 = qkv.shape
        dctx = g.reshape(BW * N, C3 // 3).to(qkv.dtype).contiguous()
        dqkv, dbias = ctx.p.attention_core_bwd(
            qkv.reshape(BW * N, C3), dctx, bias, N, *ctx.dims)
        return (None, dqkv.view(BW, N, C3),
                dbias if ctx.needs_input_grad[2] else None, None, None)


def _attention_core_op(p, qkv, bias, scale: float, num_heads: int):
    if _needs_grad(qkv, bias):
        return _AttentionCoreOp.apply(p, qkv.contiguous(), bias, scale,
                                      num_heads)
    return p.attention_core(qkv, bias, scale, num_heads)


def _attention_core_bwd(p, qkv2, dctx2, bias, n: int, scale: float,
                        num_heads: int, p2=None):
    dqkv2, _, dbias = p.attention_bwd(qkv2, dctx2, num_heads, n, scale,
                                      pattern=bias, p=p2)
    return dqkv2, dbias


def _swin_mlp_half_bwd(p, x2, ctx2, g2, wproj, bproj, ln2s, ln2b, w1, b1, w2,
                       dp=None, eps: float = SWIN_LN_EPS, *, tp=None):
    f32 = torch.float32
    dp1, dp2 = (None, None) if dp is None else dp
    tpa, tpm = (None, None) if tp is None else tp
    res1 = _proj_sum(p, ctx2, wproj, bproj, None, x2, tpa, f32,
                     row_scale=dp1)                     # res1 recompute
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
    dh2 = _grad_sum(p.gemm(da1, w1, layout="nn", out_dtype=f32), tpm)
    dres1, da, dln2s, dln2b, dbproj = p.layernorm_bwd(
        res1, ln2s, dh2, eps, gres=g2, row_scale=dp1, out_dtype=x2.dtype)
    return dres1, da, dbproj, dw1, db1, dw2, db2, dln2s, dln2b


def _swin_qkv_tail_bwd(p, x2, dqkv2, dres1, wqkv, ln1s, ln1b,
                       eps: float = SWIN_LN_EPS, *, tp=None):
    f32 = torch.float32
    h1 = p.layernorm(x2, ln1s, ln1b, eps)                # LN1 recompute
    dwqkv = p.gemm(dqkv2, h1, layout="tn", out_dtype=f32)
    dbqkv = p.column_sum(dqkv2)
    dh1 = _grad_sum(p.gemm(dqkv2, wqkv, layout="nn", out_dtype=f32), tp)
    # dx is da; the f32 dres would be written for no reader
    _, dx, dln1s, dln1b, _ = p.layernorm_bwd(x2, ln1s, dh1, eps, gres=dres1,
                                             out_dtype=x2.dtype, dres=False)
    return dx, dwqkv, dbqkv, dln1s, dln1b


class _AttnLN(torch.autograd.Function):
    """``fused_attn_ln`` / ``fused_attn_ln_masked`` / ``fused_attn_ln_adrop``
    with the store-residual backward (``_attn_ln_bwd_stored``, bf16 branch
    :2653-2672). With in-kernel dropout it saves the (2,) seed, not a
    mask."""

    @staticmethod
    def forward(ctx, p, x, wqkv, bqkv, wproj, bproj, kbias, qbias, amask,
                hmask, lns, lnb, seed, rate, scale, num_heads, eps, tp=None):
        B, N, C = x.shape
        rows = x.reshape(B * N, C).contiguous()
        hm = _rows2(hmask)
        adrop = _adrop_arg(seed, rate, num_heads, tp)
        qkv = p.gemm(rows, wqkv, bqkv)
        attn = p.attention(qkv, num_heads, N, scale, key_bias=kbias,
                           qbias=qbias, amask=amask, adrop=adrop)
        res = _proj_sum(p, attn, wproj, bproj, hm, rows, tp, torch.float32)
        out = p.layernorm(res, lns, lnb, eps, out_dtype=x.dtype)
        ctx.save_for_backward(rows, wqkv, bqkv, wproj, bproj, kbias, qbias,
                              amask, hm, lns, qkv, attn, res, seed)
        ctx.p, ctx.dims = p, (B, N, C, scale, num_heads, eps, rate)
        ctx.tp = tp
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
        tp = ctx.tp
        Cl = dctx.shape[1]                  # this rank's columns under TP
        dqkv, dkbias = p.seq_attention_core_bwd(
            qkv.view(B, N, 3 * Cl), dctx.view(B, N, Cl), kbias, qbias, amask,
            scale, num_heads, adrop=_adrop_arg(seed, rate, num_heads, tp))
        dqkv = dqkv.reshape(B * N, 3 * Cl)
        dwqkv = p.gemm(dqkv, rows, layout="tn", out_dtype=f32)
        dbqkv = p.column_sum(dqkv) if bqkv is not None else None
        if tp is None:
            dx = p.gemm(dqkv, wqkv, layout="nn", residual=dres,
                        out_dtype=rows.dtype)
        else:
            dx = _input_grad_sum(p.gemm(dqkv, wqkv, layout="nn",
                                        out_dtype=f32), dres, tp, rows.dtype)
        if ctx.needs_input_grad[6] and tp is not None:
            comm.all_reduce_(dkbias, tp.group)      # a sum over the heads
        return (None, dx.view(B, N, C), _cast(dwqkv, wqkv), _cast(dbqkv, bqkv),
                _cast(dwproj, wproj), _cast(dbproj, bproj),
                dkbias if ctx.needs_input_grad[6] else None, None, None, None,
                dlns, dlnb, None, None, None, None, None, None)


class _MlpLN(torch.autograd.Function):
    """``fused_mlp_ln`` / ``fused_mlp_ln_masked`` with the store-residual
    backward (``mlp_ln_half_bwd``)."""

    @staticmethod
    def forward(ctx, p, x, w1, b1, w2, b2, hmask, lns, lnb, eps, tp=None):
        rows = x.reshape(-1, x.shape[-1]).contiguous()
        hm = _rows2(hmask)
        m = p.gemm(rows, w1, b1, gelu=True)
        res = _proj_sum(p, m, w2, b2, hm, rows, tp, torch.float32)
        out = p.layernorm(res, lns, lnb, eps, out_dtype=x.dtype)
        ctx.save_for_backward(rows, w1, b1, w2, b2, hm, lns, res)
        ctx.p, ctx.shape, ctx.eps, ctx.tp = p, x.shape, eps, tp
        return out.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        rows, w1, b1, w2, b2, hm, lns, res = ctx.saved_tensors
        g2 = g.reshape(rows.shape).to(rows.dtype).contiguous()
        kw = {} if ctx.tp is None else {"tp": ctx.tp}
        dx, dw1, db1, dw2, db2, dlns, dlnb = ctx.p.mlp_ln_half_bwd(
            rows, res, g2, hm, w1, b1, w2, lns, ctx.eps, **kw)
        return (None, dx.to(rows.dtype).view(ctx.shape), _cast(dw1, w1),
                _cast(db1, b1), _cast(dw2, w2), _cast(db2, b2), None, dlns,
                dlnb, None, None)


def _adrop_arg(seed, rate, num_heads: int, tp):
    """K2 / K4's ``adrop``: None, ``(seed, rate)``, or under TP ``(seed,
    rate, head0)`` with this rank's first global head, so that its heads
    draw what one device draws for them."""
    if seed is None:
        return None
    return (seed, rate) if tp is None else (seed, rate, tp.rank * num_heads)


class _RowParallel(torch.autograd.Function):
    """The partial sums of :func:`row_parallel` under autograd: K1's f32
    product on the rank's rows, all-reduced (*g*: the backward takes the
    whole output's cotangent as it is), then K1 nn for the input's
    gradient and K1 tn for the weight's (f32, cast to the weight's
    dtype)."""

    @staticmethod
    def forward(ctx, p, a, w, tp):
        ctx.save_for_backward(a, w)
        ctx.p = p
        return comm.all_reduce_(p.gemm(a, w, out_dtype=torch.float32),
                                tp.group)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g2 = g.to(a.dtype).contiguous()
        da = ctx.p.gemm(g2, w, layout="nn")
        dw = ctx.p.gemm(g2, a, layout="tn", out_dtype=torch.float32)
        return None, da, dw.to(w.dtype), None


def row_parallel(p, a, w, bias, tp):
    """Megatron's row-parallel product a @ w.T under TP, f32 (M, N): K1 (or
    its plain version, as ``p`` says) on this rank's rows of the product
    with no epilogue, *g* (the f32 partial sums all-reduced over the model
    group), then the bias once. Differentiable (:class:`_RowParallel`);
    the Swin and fusion rows write their backward out in their own
    Functions."""
    if _needs_grad(a, w):
        part = _RowParallel.apply(p, a.contiguous(), w, tp)
    else:
        part = comm.all_reduce_(p.gemm(a, w, out_dtype=torch.float32),
                                tp.group)
    return part if bias is None else part + bias.float()


def row_parallel_dense(dense, x, ops, tp):
    """``dense`` (a :class:`~mvlt_tpu_torch.ops.layers.Dense` holding its
    rank's input columns) on x (..., in / mp): :func:`row_parallel`, rounded
    to x's dtype once the bias is added."""
    shape = x.shape
    y = row_parallel(ops, x.reshape(-1, shape[-1]).contiguous(),
                     dense.weight.to(x.dtype), dense.bias, tp)
    return y.to(x.dtype).view(*shape[:-1], y.shape[-1])


def _proj_sum(p, a, w, bias, hm, rows, tp, out_dtype, *, row_scale=None,
              residual_index=None, store_index=None):
    """A residual branch's last product and its epilogue, ``rows[index] +
    row_scale * hm * (a w^T + bias)`` scattered by ``store_index``: on one
    device K1 with all of it in its epilogue; under TP :func:`row_parallel`
    (the f32 partial sums all-reduced, the bias added once), then the
    hidden mask, the row scale (one per image) and the residual in f32, and
    the scatter."""
    if tp is None:
        return p.gemm(a, w, bias, residual=rows, emask=hm, out_dtype=out_dtype,
                      row_scale=row_scale, residual_index=residual_index,
                      store_index=store_index)
    part = row_parallel(p, a, w, bias, tp)
    if hm is not None:
        part = part * hm.float()
    if row_scale is not None:
        part = (part.view(row_scale.shape[0], -1, part.shape[1])
                * row_scale.view(-1, 1, 1)).view(part.shape)
    if residual_index is not None:
        rows = rows.index_select(0, residual_index.long())
    out = (part if rows is None else part + rows.float()).to(out_dtype)
    if store_index is None:
        return out
    scattered = torch.empty_like(out)
    scattered[store_index.long()] = out
    return scattered


def _input_grad_sum(dx_part, dres, tp, out_dtype):
    """*f*'s backward: the f32 partial input gradient of a column-parallel
    product all-reduced over the model group, + the residual's (once)."""
    comm.all_reduce_(dx_part, tp.group)
    return (dx_part + dres.float()).to(out_dtype)


def _attn_ln(p, x, wqkv, bqkv, wproj, bproj, kbias, qbias, amask, hmask,
             lns, lnb, scale, num_heads, eps, adrop=None, tp=None):
    if _needs_grad(x, wqkv, bqkv, wproj, bproj, lns, lnb):
        seed, rate = (None, 0.0) if adrop is None else adrop
        return _AttnLN.apply(p, x, wqkv, bqkv, wproj, bproj, kbias, qbias,
                             amask, hmask, lns, lnb, seed, rate, scale,
                             num_heads, eps, tp)
    B, N, C = x.shape
    rows = x.reshape(B * N, C)
    if adrop is not None:
        adrop = _adrop_arg(*adrop, num_heads, tp)
    qkv = p.gemm(rows, wqkv, bqkv)
    ctx = p.attention(qkv, num_heads, N, scale, key_bias=kbias, qbias=qbias,
                      amask=amask, adrop=adrop)
    res = _proj_sum(p, ctx, wproj, bproj, _rows2(hmask), rows, tp, x.dtype)
    return p.layernorm(res, lns, lnb, eps).view(B, N, C)


def _mlp_ln(p, x, w1, b1, w2, b2, hmask, lns, lnb, eps, tp=None):
    if _needs_grad(x, w1, b1, w2, b2, lns, lnb):
        return _MlpLN.apply(p, x, w1, b1, w2, b2, hmask, lns, lnb, eps, tp)
    rows = x.reshape(-1, x.shape[-1])
    m = p.gemm(rows, w1, b1, gelu=True)
    res = _proj_sum(p, m, w2, b2, _rows2(hmask), rows, tp, x.dtype)
    return p.layernorm(res, lns, lnb, eps).view(x.shape)


def _fused_attn_ln(p, x, wqkv, bqkv, wproj, bproj, kbias, lns, lnb,
                   scale: float, num_heads: int, eps: float = 1e-12, *,
                   tp=None):
    return _attn_ln(p, x, wqkv, bqkv, wproj, bproj, kbias, None, None, None,
                    lns, lnb, scale, num_heads, eps, tp=tp)


def _fused_attn_ln_masked(p, x, wqkv, bqkv, wproj, bproj, kbias, qbias,
                          amask, hmask, lns, lnb, scale: float,
                          num_heads: int, eps: float = 1e-12, *, tp=None):
    return _attn_ln(p, x, wqkv, bqkv, wproj, bproj, kbias, qbias, amask,
                    hmask, lns, lnb, scale, num_heads, eps, tp=tp)


def _fused_attn_ln_adrop(p, x, wqkv, bqkv, wproj, bproj, kbias, qbias, hmask,
                         lns, lnb, adrop_seed, scale: float, num_heads: int,
                         adrop_rate: float, eps: float = 1e-12, *, tp=None):
    return _attn_ln(p, x, wqkv, bqkv, wproj, bproj, kbias, qbias, None, hmask,
                    lns, lnb, scale, num_heads, eps,
                    adrop=(adrop_seed, adrop_rate), tp=tp)


def _fused_mlp_ln(p, x, w1, b1, w2, b2, lns, lnb, eps: float = 1e-12, *,
                  tp=None):
    return _mlp_ln(p, x, w1, b1, w2, b2, None, lns, lnb, eps, tp=tp)


def _fused_mlp_ln_masked(p, x, w1, b1, w2, b2, hmask, lns, lnb,
                         eps: float = 1e-12, *, tp=None):
    return _mlp_ln(p, x, w1, b1, w2, b2, hmask, lns, lnb, eps, tp=tp)


def _seq_attention_core_bwd(p, qkv, dctx, kbias, qbias, amask, scale: float,
                            num_heads: int, adrop=None):
    B, N, C3 = qkv.shape
    dqkv, dkbias = p.attention_bwd(
        qkv.reshape(B * N, C3), dctx.reshape(B * N, C3 // 3), num_heads, N,
        scale, key_bias=kbias, qbias=qbias, amask=amask, adrop=adrop)
    return dqkv.view(B, N, C3), dkbias


def _mlp_ln_half_bwd(p, x2, res2, g2, hmask2, w1, b1, w2, lns,
                     eps: float = 1e-12, *, tp=None):
    f32 = torch.float32
    dres, dmlp, dlns, dlnb, db2 = p.layernorm_bwd(res2, lns, g2, eps,
                                                  hmask=hmask2)
    m, a1 = p.gemm(x2, w1, b1, gelu=True, save_preact=True)   # fc1 recompute
    dw2 = p.gemm(dmlp, m, layout="tn", out_dtype=f32)
    da1 = p.gemm(dmlp, w2, layout="nn", gelu_grad=a1)
    db1 = p.column_sum(da1)
    dw1 = p.gemm(da1, x2, layout="tn", out_dtype=f32)
    if tp is None:
        dx = p.gemm(da1, w1, layout="nn", residual=dres, out_dtype=f32)
    else:
        dx = _input_grad_sum(p.gemm(da1, w1, layout="nn", out_dtype=f32),
                             dres, tp, f32)
    return dx, dw1, db1, dw2, db2, dlns, dlnb


def _full_forward_windows(p, x, params, bias, scale: float, num_heads: int):
    return _swin_full_block(p, x, params, bias, scale, num_heads)


def _attn_half_forward(p, x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, bias,
                       scale, num_heads, tp=None):
    BW, N, C = x.shape
    rows = x.reshape(BW * N, C)
    h = p.layernorm(rows, ln1s, ln1b, SWIN_LN_EPS)
    qkv = p.gemm(h, wqkv, bqkv)
    ctx = p.attention(qkv, num_heads, N, scale, pattern=bias)
    if tp is None:
        return p.gemm(ctx, wproj, bproj, residual=rows).view(BW, N, C)
    return _proj_sum(p, ctx, wproj, bproj, None, rows, tp, x.dtype).view(
        BW, N, C)


class _AttnHalf(torch.autograd.Function):
    """``swin_attn_half`` with the VJP of ``_attn_half_bwd``
    (pallas_attn.py:3345), recomputing LN1, qkv and ctx from the saved
    x."""

    @staticmethod
    def forward(ctx, p, x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, bias, scale,
                num_heads, tp):
        ctx.save_for_backward(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, bias)
        ctx.p, ctx.dims, ctx.tp = p, (scale, num_heads), tp
        return _attn_half_forward(p, x, ln1s, ln1b, wqkv, bqkv, wproj, bproj,
                                  bias, scale, num_heads, tp)

    @staticmethod
    def backward(ctx, g):
        x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, bias = ctx.saved_tensors
        (dx, dln1s, dln1b, dwqkv, dbqkv, dwproj, dbproj,
         dbias) = ctx.p.swin_attn_half_bwd(x, ln1s, ln1b, wqkv, bqkv, wproj,
                                           bias, g, *ctx.dims,
                                           **_tp_kw(ctx.tp))
        return (None, dx, dln1s, dln1b, _cast(dwqkv, wqkv), _cast(dbqkv, bqkv),
                _cast(dwproj, wproj), _cast(dbproj, bproj),
                dbias if ctx.needs_input_grad[8] else None, None, None, None)


def _swin_attn_half(p, x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, bias,
                    scale: float, num_heads: int, *, tp=None):
    if _needs_grad(x, ln1s, ln1b, wqkv, bqkv, wproj, bproj, bias):
        return _AttnHalf.apply(p, x, ln1s, ln1b, wqkv, bqkv, wproj, bproj,
                               bias, scale, num_heads, tp)
    return _attn_half_forward(p, x, ln1s, ln1b, wqkv, bqkv, wproj, bproj,
                              bias, scale, num_heads, tp)


def _swin_attn_half_bwd(p, x, ln1s, ln1b, wqkv, bqkv, wproj, bias, g,
                        scale: float, num_heads: int, *, tp=None):
    BW, N, C = x.shape
    x2 = x.reshape(BW * N, C).contiguous()
    h = p.layernorm(x2, ln1s, ln1b, SWIN_LN_EPS)          # recompute
    qkv = p.gemm(h, wqkv, bqkv)
    Cl = qkv.shape[1] // 3                  # this rank's columns under TP
    ctx2 = p.attention_core(qkv.view(BW, N, 3 * Cl), bias, scale,
                            num_heads).view(BW * N, Cl)
    g2 = g.reshape(BW * N, C).to(x.dtype).contiguous()
    dwproj, dbproj, dctx = _proj_bwd(p, ctx2, g2, wproj)
    dqkv, dbias = p.attention_core_bwd(qkv, dctx, bias, N, scale, num_heads)
    # the residual's cotangent g enters LN1's VJP as its incoming residual
    dx, dwqkv, dbqkv, dln1s, dln1b = p.swin_qkv_tail_bwd(
        x2, dqkv, g2, wqkv, ln1s, ln1b, **_tp_kw(tp))
    return (dx.view(BW, N, C), dln1s, dln1b, dwqkv, dbqkv, dwproj, dbproj,
            dbias)


class _WindowAttention(torch.autograd.Function):
    """``window_attention`` with the VJP of ``_bwd`` (pallas_attn.py:128)."""

    @staticmethod
    def forward(ctx, p, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.p, ctx.scale = p, scale
        return p.attention_heads(q, k, v, scale, pattern=bias)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = ctx.p.window_attention_bwd(q, k, v, bias, g,
                                                       ctx.scale)
        return (None, dq, dk, dv, dbias if ctx.needs_input_grad[4] else None,
                None)


def _window_attention(p, q, k, v, bias, scale: float):
    if len({q.stride(), k.stride(), v.stride()}) > 1:
        q, k, v = (t.contiguous() for t in (q, k, v))
    if _needs_grad(q, k, v, bias):
        return _WindowAttention.apply(p, q, k, v, bias, scale)
    return p.attention_heads(q, k, v, scale, pattern=bias)


def _window_attention_bwd(p, q, k, v, bias, g, scale: float):
    BW, nH, N, Dh = q.shape
    C = nH * Dh
    # into fused rows for K4's pattern mode, and dqkv back out as views
    qkv = torch.empty(BW, N, 3, nH, Dh, dtype=q.dtype, device=q.device)
    for i, t in enumerate((q, k, v)):
        qkv[:, :, i].copy_(t.transpose(1, 2))
    dctx = g.to(q.dtype).transpose(1, 2).reshape(BW * N, C).contiguous()
    dqkv, _, dbias = p.attention_bwd(qkv.view(BW * N, 3 * C), dctx, nH, N,
                                     scale, pattern=bias)
    dq, dk, dv = dqkv.view(BW, N, 3, nH, Dh).permute(2, 0, 3, 1, 4).unbind(0)
    return dq, dk, dv, dbias


class _SeqAttention(torch.autograd.Function):
    """``fused_seq_attention`` with the VJP of ``_seq_bwd`` (pallas_attn.py
    :440) on saved fused rows."""

    @staticmethod
    def forward(ctx, p, x, wqkv, bqkv, wproj, bproj, kbias, scale,
                num_heads):
        B, N, C = x.shape
        rows = x.reshape(B * N, C).contiguous()
        qkv = p.gemm(rows, wqkv, bqkv)
        attn = p.attention(qkv, num_heads, N, scale, key_bias=kbias)
        ctx.save_for_backward(rows, qkv, attn, wqkv, bqkv, wproj, bproj,
                              kbias)
        ctx.p, ctx.dims = p, (B, N, C, scale, num_heads)
        return p.gemm(attn, wproj, bproj).view(B, N, C)

    @staticmethod
    def backward(ctx, g):
        p, (B, N, C, scale, num_heads) = ctx.p, ctx.dims
        rows, qkv, attn, wqkv, bqkv, wproj, bproj, kbias = ctx.saved_tensors
        dx, dwqkv, dbqkv, dwproj, dbproj = p.fused_seq_attention_bwd(
            rows, qkv, attn, g.reshape(B * N, C), wqkv, wproj, kbias, N,
            scale, num_heads)
        return (None, dx.view(B, N, C), _cast(dwqkv, wqkv), _cast(dbqkv, bqkv),
                _cast(dwproj, wproj), _cast(dbproj, bproj), None, None, None)


def _fused_seq_attention(p, x, wqkv, bqkv, wproj, bproj, kbias, scale: float,
                         num_heads: int):
    if _needs_grad(kbias):
        raise NotImplementedError(
            "fused_seq_attention gives the key bias no gradient: it is a "
            "padding mask (JAX's _seq_bwd returns one; ROADMAP.md section C)")
    if _needs_grad(x, wqkv, bqkv, wproj, bproj):
        return _SeqAttention.apply(p, x, wqkv, bqkv, wproj, bproj, kbias,
                                   scale, num_heads)
    B, N, C = x.shape
    qkv = p.gemm(x.reshape(B * N, C), wqkv, bqkv)
    ctx = p.attention(qkv, num_heads, N, scale, key_bias=kbias)
    return p.gemm(ctx, wproj, bproj).view(B, N, C)


def _fused_seq_attention_bwd(p, x2, qkv2, ctx2, g2, wqkv, wproj, kbias,
                             seq_n: int, scale: float, num_heads: int):
    g2 = g2.to(x2.dtype).contiguous()
    dwproj, dbproj, dctx = _proj_bwd(p, ctx2, g2, wproj)
    dqkv, _ = p.attention_bwd(qkv2, dctx, num_heads, seq_n, scale,
                              key_bias=kbias)
    dwqkv, dbqkv, dx = _qkv_bwd(p, x2, dqkv, wqkv)
    return dx, dwqkv, dbqkv, dwproj, dbproj


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


# what torch.utils.checkpoint raises to end a recompute early
_STOP_RECOMPUTATION = getattr(torch.utils.checkpoint,
                              "_StopRecomputationError", ())


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

    def launched(x, args, kw):
        if x.is_cuda:
            for name in counts_for(x, args, kw):
                setattr(kernel_twin, name, getattr(kernel_twin, name) + 1)

    def kernel_twin(x, *args, **kw):
        try:
            out = body(KERNEL_OPS, x, *args, **kw)
        except _STOP_RECOMPUTATION:
            # a rematerialised unit's recompute stops at its last saved
            # tensor: this call's autograd Function saved it as it
            # returned, after its kernels launched
            launched(x, args, kw)
            raise
        launched(x, args, kw)
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
(pallas_attn.py:3326-3335). Under autograd a ``torch.autograd.Function``
that saves its inputs and whose backward is ``window_block_attention_bwd``
(the residual takes the cotangent as it is).""")

window_block_attention_bwd, window_block_attention_bwd_plain = _twins(
    _window_block_attention_bwd, """\
VJP of ``window_block_attention`` (``_block_bwd``, pallas_attn.py:2092-2121)
for the cotangent g (BW, N, C) of its output: it recomputes qkv (K1) and ctx
(``attention_core``, K2 with the patterns), then K1 tn dWproj (f32), K5
dbproj, K1 nn dctx (f32 accumulate, rounded to x's dtype, as JAX casts it at
:2110), ``attention_core_bwd`` (K4's pattern mode: dqkv and the f32 dbias,
summed over the windows that share a pattern), K1 tn dWqkv (f32), K5 dbqkv
and K1 nn dx. JAX upcasts its bf16-valued operands to f32 for these
products; K1 takes them in bf16 with f32 accumulation, which computes the
same products in another summation order. x (BW, N, C), weights in the
(out, in) layout, bias (P, nH, N, N) f32. Returns ``(dx (BW, N, C) in x's
dtype, dwqkv, dbqkv, dwproj, dbproj, dbias)``, the weight and bias grads
f32.""")

fused_mlp_preln, fused_mlp_preln_plain = _twins(_fused_mlp_preln, """\
Pre-LN MLP half ``x + fc2(GELU(fc1(LN2 x)))`` over rows of (..., C). Under
autograd a ``torch.autograd.Function`` that saves its inputs and whose
backward is ``fused_mlp_preln_bwd``.""")

fused_mlp_preln_bwd, fused_mlp_preln_bwd_plain = _twins(
    _fused_mlp_preln_bwd, """\
VJP of ``fused_mlp_preln`` (``_mlp_preln_bwd``, pallas_attn.py:3429-3441,
``jax.vjp`` of ``_mlp_preln_xla_ref`` :3374) for the cotangent g of its
output, on the pieces of ``swin_mlp_half_bwd`` without the proj and the
DropPath: K3 LN2 recompute, K1 fc1 + GELU (saving the f32 pre-activation),
K5 db2, K1 tn dW2, K1 nn da1 with the GELU' epilogue, K5 db1, K1 tn dW1, K1
nn dh2 (f32), K5 in pre-LN form (dx = g + LN2^T(dh2)). The erf GELU of
JAX's interpret path; its TPU bf16 path takes the tanh GELU (:3431), a
fast-math choice the port does not copy. Returns ``(dx in x's dtype and
shape, dln2s, dln2b, dw1, db1, dw2, db2)``, sums and weight grads f32.""")

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
Returns ctx (BW, N, C). It has no VJP, as in JAX: under autograd it raises
(``attention_core_op`` is the differentiable form).""")

attention_core_op, attention_core_op_plain = _twins(_attention_core_op, """\
The differentiable attention core (``attention_core_op``, pallas_attn.py
:4120): ``attention_core`` (row 19, K2 with the patterns) forward; under
autograd a ``torch.autograd.Function`` that saves qkv and the bias and whose
backward is ``attention_core_bwd`` (row 21, K4's pattern mode): dqkv (BW,
N, 3C) in qkv's dtype and an f32 dbias of the bias's shape (P, nH, N,
N).""")

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

window_attention, window_attention_plain = _twins(_window_attention, """\
Swin window attention alone (``window_attention``, pallas_attn.py:112): q,
k, v (BW, nH, N, Dh), bias (P, nH, N, N) f32, window w using ``bias[w %
P]``. Returns ctx (BW, nH, N, Dh) in q's dtype: K2 in its head-major mode,
reading q, k, v where they lie (views of the qkv product's rows are taken
as they are) and writing ctx as (BW, N, nH, Dh) rows, of which the result
is a view. Under autograd a ``torch.autograd.Function`` whose backward is
``window_attention_bwd``.""")

window_attention_bwd, window_attention_bwd_plain = _twins(
    _window_attention_bwd, """\
VJP of ``window_attention`` (``_bwd``, pallas_attn.py:128-147) for the
cotangent g (BW, nH, N, Dh): K4's pattern mode on q, k, v copied into fused
(BW*N, 3C) rows. p is recomputed in f32 and is not rounded (as in ``_bwd``);
dbias is ds summed over the windows that share a pattern, in a fixed order
(``segment_sum`` over w % P). Returns ``(dq, dk, dv)`` in q's dtype, views
of one (BW, N, 3, nH, Dh) buffer, and ``dbias`` (P, nH, N, N) f32.""")

swin_attn_half, swin_attn_half_plain = _twins(_swin_attn_half, """\
Pre-LN Swin attention half ``x + proj(attn(qkv(LN1 x)))`` on (BW, N, C)
windows (``swin_attn_half``, pallas_attn.py:3272, body ``_attn_half_kernel``
:3228): K3 LN1 (f32 moments) -> K1 qkv -> K2 (patterns) -> K1 proj with x
added in f32 in the epilogue. JAX reaches it only in serving; under
autograd it is a ``torch.autograd.Function`` that saves its inputs and
whose backward is ``swin_attn_half_bwd``.""")

swin_attn_half_bwd, swin_attn_half_bwd_plain = _twins(
    _swin_attn_half_bwd, """\
VJP of ``swin_attn_half`` (``_attn_half_bwd``, pallas_attn.py:3338-3356,
``jax.vjp`` of ``_attn_half_xla_ref`` :3262) for the cotangent g (BW, N, C):
K3 LN1, K1 qkv and ``attention_core`` (K2) recomputed; K1 tn dWproj, K5
dbproj, K1 nn dctx; ``attention_core_bwd`` (K4's pattern mode); then
``swin_qkv_tail_bwd`` (LN1 recompute, K1 tn dWqkv, K5 dbqkv, K1 nn dh1, K5
in pre-LN form with g as the residual's cotangent). Returns ``(dx (BW, N,
C) in x's dtype, dln1s, dln1b, dwqkv, dbqkv, dwproj, dbproj, dbias)``, the
sums and weight grads f32.""")

fused_seq_attention, fused_seq_attention_plain = _twins(
    _fused_seq_attention, """\
Fused qkv + bidirectional self-attention + out projection of the fusion
encoder (``fused_seq_attention``, pallas_attn.py:386, body
``_seq_attn_kernel`` :334): x (B, N, C), kbias (B, N) f32 additive key bias
or None. K1 qkv -> K2 (key bias, N ragged: JAX pads N to a multiple of 8
with a -1e9 key bias) -> K1 proj; no LN, no residual. Under autograd a
``torch.autograd.Function`` whose backward is ``fused_seq_attention_bwd``;
kbias gets no gradient and must not require one.""")

fused_seq_attention_bwd, fused_seq_attention_bwd_plain = _twins(
    _fused_seq_attention_bwd, """\
VJP of ``fused_seq_attention`` (``_seq_bwd``, pallas_attn.py:440) from the
saved rows x2 (M, C), qkv2 (M, 3C), ctx2 (M, C) and the cotangent g2 (M,
C), M = B * seq_n: K1 tn dWproj, K5 column sum dbproj, K1 nn dctx, K4 with
the key bias (the attention core, as in ``seq_attention_core_bwd``), K1 tn
dWqkv, K5 column sum dbqkv, K1 nn dx. Returns ``(dx (M, C) in x2's dtype,
dwqkv, dbqkv, dwproj, dbproj)``, the weight and bias grads f32 in the port's
(out, in) layout.""")

full_forward_windows, full_forward_windows_plain = _twins(
    _full_forward_windows, """\
The per-window whole Swin block (``_full_forward_windows``, pallas_attn.py
:1206, body ``_full_kernel_windows`` :1161): the math of
``swin_full_block`` (row 2) on x (BW, N, C), ``params`` its 12-tensor
tuple, bias (P, nH, N, N). The TPU reaches it only as a layout fallback
that no geometry takes (:1356); the port runs it on the same composition,
K3 + K1 + K2 + K1 + K3 + K1 + K1.""")

COUNTERPARTS = (swin_full_block, window_block_attention, fused_mlp_preln,
                fused_attn_ln, fused_mlp_ln, fused_attn_ln_masked,
                fused_mlp_ln_masked, seq_attention_core_bwd, mlp_ln_half_bwd,
                swin_half_block, attention_core, attention_core_bwd,
                swin_mlp_half_bwd, swin_qkv_tail_bwd, fused_attn_ln_adrop,
                window_attention, window_attention_bwd, swin_attn_half,
                fused_seq_attention, fused_seq_attention_bwd,
                full_forward_windows, window_block_attention_bwd,
                fused_mlp_preln_bwd, swin_attn_half_bwd, attention_core_op)

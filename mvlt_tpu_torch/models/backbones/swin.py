"""Swin Transformer backbone of the port (counterpart of
``mvlt_tpu/models/backbones/swin.py``): the serving path and the training
path.

The layout follows the JAX package: NHWC images, patch embedding as a
reshape + dense over (ph, pw, c)-flattened patches, window-major token rows
inside a block. The block dispatch mirrors the JAX routing on the TPU, so
that the counterparts in :mod:`mvlt_tpu_torch.ops.blocks` run as the TPU
kernels ran:

- serving: W-MSA and SW-MSA blocks of a stage whose block weights fit the
  TPU's VMEM run ``swin_full_block`` (the SW-MSA one with the shift folded
  in); wider stages whose halves fit (Swin-S stage 4, C = 768) run LN1 ->
  ``window_block_attention`` (+x folded into its proj) -> ``fused_mlp_preln``,
  see :func:`uses_half_blocks` and :func:`half_weights_fit`; wider still
  (Swin-B stage 4, C = 1024) JAX's plain route, on which ``WindowAttention``
  'auto' picks ``window_block_attention`` (``swin.py:170-180, 338-366``):
  LN1 -> ``window_block_attention`` (+x) -> LN2 -> ``Mlp``. A wide stage
  whose map is larger than its window (Swin-S stage 4 at 448: 14 x 14,
  window 7) has shifted blocks: both wide routes roll the map around the
  partition and take the shift mask in the bias (P = nW), as
  ``_fused_half_blocks`` does (``swin.py:483-530``);
- training (a gradient is needed, or DropPath multipliers are drawn):
  narrow stages run ``swin_full_block``'s training form (``swin.py:285-303``),
  wide stages ``swin_half_block`` (``swin.py:318-336``), both with the
  store-residual backward. Each block with a DropPath rate above 0 draws its
  two (B,) multipliers from the step's mask source
  (:func:`~mvlt_tpu_torch.ops.layers.drop_path_multipliers`); the rates are
  a linspace over all blocks (``swin.py:620``). With ``MVLT_STOREP`` set
  (and ``MVLT_NO_STOREP`` not), a whole-block training block with >= 12
  heads whose window-pair-merged N is <= 128 stores its softmax for the
  backward (:func:`stores_p`; the 18 stage-3 blocks of Swin-S).

JAX's plain route (``swin.py:338-366``): LN1 -> roll -> partition ->
``WindowAttention`` (:meth:`SwinBlock._window_attention`) -> reverse -> roll ->
``x + DropPath`` -> LN2 -> ``Mlp`` (with its two dropouts) -> ``+ DropPath``,
each DropPath mask a (B, 1, 1) draw as flax draws it
(:func:`~mvlt_tpu_torch.ops.layers.drop_path_mask`). Every block takes it on
``attn_impl`` 'pallas', 'pallas_block' and 'xla', serving and training; on
'auto' (the default) a block trains on it when a dropout rate is above 0
(``drop_rate`` or ``attn_drop_rate``: JAX's fused training routes need both
at 0, ``train_ok`` / ``train_half_ok``, swin.py:285-288, 318-320), and
serves on the fused routes above whatever the rates. The attention there is
``window_attention`` (row 8) on 'pallas', ``window_block_attention`` (row 1,
with its VJP) on 'pallas_block', and on 'xla' a plain torch attention (JAX
computes it in XLA) with the attention dropout on its probabilities; 'auto'
resolves as JAX on the TPU does (swin.py:170-180): 'pallas_block', or 'xla'
when attention dropout is active. Masks are drawn where JAX draws them: the
position dropout after the patch embedding, then per block the attention
dropout, ``proj_drop``, ``drop_path1``, the MLP's two dropouts and
``drop_path2``. ``VisualAdapter`` passes no option, as in JAX.

The relative-position bias is built as JAX builds it, ``onehot @ table``
(``rel_bias_from_table``, ``swin.py:67-85``), so its backward is a product and
not a scatter with atomics; serving caches the built bias.

``remat=True`` (``MVLTConfig.remat_backbone``, JAX's ``nn.remat`` of every
``SwinBlock``, swin.py:623-624) runs each block under
:func:`~mvlt_tpu_torch.ops.layers.rematerialized` while autograd records
it, on every ``attn_impl``: the backward recomputes the block's forward
(its kernels launch twice a step) on the DropPath and dropout draws of the
first run. Serving is unchanged.

``ape=True`` adds the absolute position table (1, H*W, embed_dim), f32,
after the patch embedding and before the position dropout (swin.py:612-617).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from torch import nn

from mvlt_tpu_torch.config import SwinConfig
from mvlt_tpu_torch.ops.blocks import row_parallel_dense
from mvlt_tpu_torch.ops.layers import (SWIN_LN_EPS, Dense, LayerNorm, Mlp,
                                       drop_path, drop_path_mask,
                                       drop_path_multipliers, dropout,
                                       dropout_part, gelu_exact, records_grad,
                                       rematerialized)
from mvlt_tpu_torch.parallel import comm
from mvlt_tpu_torch.utils.env import env_flag


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(N, N) pairwise relative-position index inside a (wh, ww) window
    (swin.py:53-64)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def relative_position_onehot(wh: int, ww: int) -> np.ndarray:
    """(N*N, (2wh-1)(2ww-1)) float32 one-hot of
    :func:`relative_position_index` (``_rel_index_onehot``, swin.py:67-78)."""
    idx = relative_position_index(wh, ww).reshape(-1)
    oh = np.zeros((idx.size, (2 * wh - 1) * (2 * ww - 1)), np.float32)
    oh[np.arange(idx.size), idx] = 1.0
    return oh


@functools.lru_cache(maxsize=None)
def shifted_window_mask(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """Additive SW-MSA mask (nW, N, N), 0 / -100 (swin.py:88-103)."""
    img = np.zeros((H, W), np.int32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img[h, w] = cnt
            cnt += 1
    img = img.reshape(H // window, window, W // window, window)
    win = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, window*window, C)."""
    B, H, W, C = x.shape
    x = x.view(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def window_reverse(windows: torch.Tensor, window: int, H: int,
                   W: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    C = windows.shape[-1]
    B = windows.shape[0] // (H * W // window // window)
    x = windows.view(B, H // window, W // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def uses_half_blocks(dim: int) -> bool:
    """Whether a Swin block of width ``dim`` is too wide for the whole-block
    kernel: on the TPU it needs its 12*C^2 bf16 weights in 12 MB of VMEM
    (``weights_fit``, swin.py:272). Such a block trains on the halves
    (``swin_half_block``, JAX's ``train_half_ok``, swin.py:318-323) and
    serves on them where :func:`half_weights_fit` also holds (swin.py:
    307-313): ``swin_attn_half`` then ``fused_mlp_preln``. At Swin-S 224
    that is stage 4 (C = 768), at Swin-B 224 stage 4 (C = 1024). The port
    keeps this routing so that the flagship path runs each of the six
    counterparts."""
    return 12 * dim * dim * 2 > 12 * 1024 * 1024


def half_weights_fit(dim: int) -> bool:
    """JAX's second gate on the serving halves (``half_ok``, swin.py:
    307-311): the MLP half's 8*C^2 bf16 weights in 12 MB of VMEM. It holds
    at C = 768 (9.4 MB) and fails at Swin-B's C = 1024 (16.8 MB), whose
    wide blocks JAX serves on its plain route (swin.py:338-366)."""
    return 8 * dim * dim * 2 <= 12 * 1024 * 1024


def attn_half_admits(n_windows: int, N: int, C: int, n_patterns: int,
                     group: int = 16) -> bool:
    """Whether JAX's ``swin_attn_half`` runs its own kernel
    (``_attn_half_kernel``) on (n_windows, N, C) windows with
    ``n_patterns`` bias patterns, rather than its fallback, LN1 +
    ``_block_kernel`` + residual (``_block_forward_with_ln_fallback``,
    pallas_attn.py:3326). A copy of the pair-merge rule (``_can_merge_pairs``
    / ``_merge_window_pairs``, :227-246) and the group search (:3279-3293):
    a group of G windows (halved from ``group``, or ``group // 2`` merged)
    must be 8-row aligned, divide the windows and the patterns, and keep
    its working set within 4 MiB unless G is 1. At Swin-S 224, stage 4 (N =
    49, merged 98) falls back; a C = 768 stage of window 12 (N = 144) or 8
    (merged N = 128) admits."""
    BW, n, P, G = n_windows, N, n_patterns, group
    if n <= 64 and BW % 2 == 0 and (P == 1 or P % 2 == 0):
        BW, n, P, G = BW // 2, 2 * n, max(P // 2, 1), max(group // 2, 1)

    def misfit(G):
        return (G * n) % 8 != 0 or BW % G != 0 or (P > 1 and P % G != 0)
    while G > 1 and (misfit(G) or G * n * C * (4 + 3 + 2) * 4 > 4 * 1024 ** 2):
        G //= 2
    return not misfit(G)


# the attn_impl values the port routes, and JAX's CPU test modes (its
# Pallas kernels in interpret mode), which it does not
ATTN_IMPLS = ("auto", "pallas", "pallas_block", "xla")
_INTERPRET_ATTN_IMPLS = ("interpret", "interpret_full", "interpret_half",
                         "interpret_block")


def check_attn_impl(attn_impl: str) -> str:
    """``attn_impl`` if the port routes it (:data:`ATTN_IMPLS`); JAX's
    'interpret*' values raise ``NotImplementedError``, anything else
    ``ValueError``."""
    if attn_impl in ATTN_IMPLS:
        return attn_impl
    if attn_impl in _INTERPRET_ATTN_IMPLS:
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} is one of the JAX package's CPU test "
            f"modes; the port routes {ATTN_IMPLS} (ROADMAP.md queue A, item "
            "12)")
    raise ValueError(f"unknown attn_impl {attn_impl!r}: the port routes "
                     f"{ATTN_IMPLS} (ROADMAP.md queue A, item 12, lists the "
                     "JAX package's values)")


def window_attention_xla(q, k, v, bias, scale: float, masks=None,
                         rate: float = 0.0, tp=None) -> torch.Tensor:
    """``WindowAttention``'s XLA attention (swin.py:216-228) in plain torch:
    q, k, v (BW, nH, N, Dh), bias (P, nH, N, N) f32, window g using
    ``bias[g % P]``. Scores ``(q * scale) k^T`` in f32, softmax in f32
    rounded to q's dtype, the attention dropout on the probabilities
    (a (BW, nH, N, N) draw from ``masks`` when ``rate`` > 0; under TP, ``tp``
    a model group, nH is the rank's heads and the mask its slice of the
    draw of all heads), then ``p v``. Returns ctx (BW, nH, N, Dh)."""
    BW, nH, N, _ = q.shape
    P = bias.shape[0]
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    s = (s.view(BW // P, P, nH, N, N) + bias).view(BW, nH, N, N)
    p = dropout_part(torch.softmax(s, dim=-1).to(q.dtype), masks, rate, tp,
                     dim=1)
    return torch.matmul(p, v)


def stores_p(num_heads: int, N: int, n_windows: int, n_patterns: int,
             shifted: bool) -> bool:
    """Whether a whole-block training block stores its softmax p for the
    backward: JAX's semantic gate (pallas_attn.py:1059-1061, 1318-1320),
    read at call time. ``MVLT_STOREP`` set, ``MVLT_NO_STOREP`` not, at least
    12 heads, and the window-pair-merged N at most 128: the shifted kernel
    always merges pairs (2N); the unshifted one when ``_can_merge_pairs``
    holds (N <= 64, an even window count, one pattern or an even number).
    The port does not merge pairs, and JAX's VMEM admission rules, which can
    still send a block to a route without stored p, are TPU layout choices
    that it does not mirror (ROADMAP, section C)."""
    merge = shifted or (N <= 64 and n_windows % 2 == 0
                        and (n_patterns == 1 or n_patterns % 2 == 0))
    return (num_heads >= 12 and (2 * N if merge else N) <= 128
            and env_flag("MVLT_STOREP") and not env_flag("MVLT_NO_STOREP"))


class SwinBlock(nn.Module):
    """(S)W-MSA + MLP block, pre-LN, with stochastic depth at rate
    ``drop_path`` and dropout at rates ``drop`` (hidden) and ``attn_drop``
    (attention probabilities) in training (swin.py:235-366).

    Tensor parallelism (:meth:`set_tp`, from
    :func:`mvlt_tpu_torch.parallel.shard.apply_mesh_`; JAX's Megatron rules
    under GSPMD, ``partition.py:37-47``): the block then holds its rank's
    heads of ``qkv`` (q, k and v of the same heads), its columns of
    ``proj``'s input, of ``fc1``'s output and of ``fc2``'s input, and its
    columns of the relative-position table, and splits every route at
    Megatron's two points (``ops/blocks.py``: the f32 partials of proj and
    fc2 summed over the model group, the bias, DropPath and residual added
    once). Where mp does not divide the heads the attention half is held
    whole on every rank and only the MLP splits. The route gates read the
    global geometry (heads, C), so a rank takes the route one device takes;
    the DropPath draws are the same on every model rank, and a dropout of a
    split tensor (the attention probabilities, the GELU output) is the
    rank's slice of the draw of the whole.
"""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale,
                 drop_path: float = 0.0, *, dtype: torch.dtype, device,
                 attn_impl: str = "auto", drop: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        self.attn_impl = check_attn_impl(attn_impl)
        H, W = input_resolution
        window, shift = window_size, shift_size
        if min(input_resolution) <= window:
            # window no smaller than the map: one window, no shift
            # (swin.py:259-262; Swin-S stage 4 at 7x7)
            window, shift = min(input_resolution), 0
        self.dim, self.resolution = dim, (H, W)
        self.window, self.shift, self.num_heads = window, shift, num_heads
        self.drop_path, self.drop, self.attn_drop = drop_path, drop, attn_drop
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.norm1 = LayerNorm(dim, SWIN_LN_EPS, device=device)
        self.qkv = Dense(dim, 3 * dim, qkv_bias, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * window - 1) ** 2, num_heads, dtype=torch.float32,
            device=device))
        self.norm2 = LayerNorm(dim, SWIN_LN_EPS, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, dtype=dtype,
                       device=device)
        N = window * window
        self.register_buffer("rel_onehot", torch.as_tensor(
            relative_position_onehot(window, window), device=device),
            persistent=False)
        mask = (shifted_window_mask(H, W, window, shift) if shift
                else np.zeros((1, N, N), np.float32))
        self.register_buffer("shift_mask", torch.as_tensor(mask, device=device),
                             persistent=False)
        self._bias_key, self._bias = None, None
        self.tp_attn = self.tp_mlp = None

    def set_tp(self, attn, mlp) -> None:
        """Put the block on a model group (``parallel/shard.TP``): ``attn``
        the group when its attention half is split over the heads (None:
        held whole), ``mlp`` the group when its MLP is split."""
        self.tp_attn, self.tp_mlp = attn, mlp
        self._bias_key = None

    def _tp(self):
        """The whole-block rows' ``tp=``: {} off a mesh, else the pair."""
        if self.tp_attn is None and self.tp_mlp is None:
            return {}
        return {"tp": (self.tp_attn, self.tp_mlp)}

    def _heads(self) -> int:
        """The heads this rank computes."""
        return self.num_heads // (1 if self.tp_attn is None
                                  else self.tp_attn.size)

    def _table(self) -> torch.Tensor:
        """The relative-position table's columns of this rank's heads: under
        TP Megatron's *f* first, so that the table's gradient (each rank's
        heads) is summed over the model group."""
        t = self.relative_position_bias_table
        if self.tp_attn is None:
            return t
        n = self._heads()
        h0 = self.tp_attn.rank * n
        return comm.copy_to_group(t, self.tp_attn.group)[:, h0:h0 + n]

    def _build_bias(self) -> torch.Tensor:
        N = self.window * self.window
        rel = (self.rel_onehot @ self._table()).view(N, N, -1).permute(
            2, 0, 1)
        return (rel[None] + self.shift_mask[:, None]).contiguous()

    def attention_bias(self) -> torch.Tensor:
        """(P, nH, N, N) f32: the relative-position bias from its table, plus
        the -100 shift mask per window when shifted (P = nW, else 1); under
        TP the rank's nH / mp heads. Where a gradient is needed it is built
        with its graph; serving recomputes it only when the table
        changes."""
        t = self.relative_position_bias_table
        if torch.is_grad_enabled() and t.requires_grad:
            return self._build_bias()
        key = (t.data_ptr(), t._version)
        if key != self._bias_key:
            with torch.no_grad():
                self._bias = self._build_bias()
            self._bias_key = key
        return self._bias

    def forward(self, x: torch.Tensor, ops, masks=None) -> torch.Tensor:
        """x (B, H*W, C); ``masks`` (a :class:`DropoutMasks`) turns DropPath
        and dropout on."""
        if self.attn_impl != "auto" or (masks is not None and (
                self.drop > 0.0 or self.attn_drop > 0.0)):
            return self._plain_forward(x, ops, masks)
        H, W = self.resolution
        B, L, C = x.shape
        window, shift = self.window, self.shift
        bias = self.attention_bias()
        dt = x.dtype
        params = (self.norm1.weight, self.norm1.bias, self.qkv.weight.to(dt),
                  self.qkv.bias.to(dt), self.proj.weight.to(dt),
                  self.proj.bias.to(dt), self.norm2.weight, self.norm2.bias,
                  self.mlp.fc1.weight.to(dt), self.mlp.fc1.bias.to(dt),
                  self.mlp.fc2.weight.to(dt), self.mlp.fc2.bias.to(dt))
        dp = drop_path_multipliers(masks, self.drop_path, B, x.device)
        spec = (H, W, window, shift) if shift else None
        train = dp is not None or (torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, bias, *params)))
        if not train and uses_half_blocks(C):
            # the serving halves take the rolled map, the shift entering
            # only through the bias (_fused_half_blocks, swin.py:483-530)
            return self._half_blocks(x, bias, ops)
        windows = window_partition(x.view(B, H, W, C), window)
        nH, tp = self._heads(), self._tp()
        if train and uses_half_blocks(C):
            y = ops.swin_half_block(windows, params, bias, self.scale, nH,
                                    shift_spec=spec, dp=dp, **tp)
        elif train:
            # the gate reads the block's global heads, as one device does
            store = stores_p(self.num_heads, window * window,
                             windows.shape[0], bias.shape[0], bool(shift))
            y = ops.swin_full_block(windows, params, bias, self.scale, nH,
                                    shift_spec=spec, dp=dp, store_p=store,
                                    **tp)
        else:
            y = ops.swin_full_block(windows, params, bias, self.scale, nH,
                                    shift_spec=spec, **tp)
        return window_reverse(y, window, H, W).reshape(B, L, C)

    def _plain_forward(self, x, ops, masks):
        """JAX's plain route (swin.py:338-366)."""
        H, W = self.resolution
        B, L, C = x.shape
        window, shift = self.window, self.shift
        h = self.norm1(x, ops).view(B, H, W, C)
        if shift:
            h = torch.roll(h, (-shift, -shift), (1, 2))
        a = window_reverse(self._window_attention(window_partition(h, window),
                                                  ops, masks), window, H, W)
        if shift:
            a = torch.roll(a, (shift, shift), (1, 2))
        rate = self.drop_path
        x = x + drop_path(a.reshape(B, L, C),
                          drop_path_mask(masks, rate, B, x.device), rate)
        y = self._mlp(self.norm2(x, ops), ops, masks)
        return x + drop_path(y, drop_path_mask(masks, rate, B, x.device), rate)

    def _mlp(self, x, ops, masks=None):
        """flax ``Mlp``; under TP fc1 column-parallel (after *f*), the GELU
        dropout the rank's columns of the whole draw, fc2 row-parallel."""
        tp, mlp = self.tp_mlp, self.mlp
        if tp is None:
            return mlp(x, ops, masks)
        h = gelu_exact(mlp.fc1(comm.copy_to_group(x, tp.group), ops))
        h = dropout_part(h, masks, mlp.drop, tp)
        return dropout(row_parallel_dense(mlp.fc2, h, ops, tp), masks,
                       mlp.drop)

    def _window_attention(self, windows, ops, masks):
        """``WindowAttention`` (swin.py:123-233) on (B*nW, N, C) windows,
        ending in ``proj_drop``."""
        impl = self.attn_impl
        attn_drop = masks is not None and self.attn_drop > 0.0
        if impl == "auto":
            impl = "xla" if attn_drop else "pallas_block"
        elif attn_drop and impl != "xla":
            raise ValueError(
                f"attn_impl={impl!r} cannot apply attention dropout "
                f"(attn_drop_rate={self.attn_drop}); use attn_impl='auto' or "
                "'xla' for training with attention dropout")
        BW, N, C = windows.shape
        nH, dt, tp = self._heads(), windows.dtype, self.tp_attn
        Dh = C // self.num_heads
        bias = self.attention_bias()
        if impl == "pallas_block":
            qkv, proj = self.qkv, self.proj
            out = ops.window_block_attention(
                windows, qkv.weight.to(dt), _cast(qkv.bias, dt),
                proj.weight.to(dt), _cast(proj.bias, dt), bias, self.scale,
                nH, **({} if tp is None else {"tp": tp}))
        else:
            h = self.qkv(windows if tp is None else
                         comm.copy_to_group(windows, tp.group), ops)
            q, k, v = h.view(BW, N, 3, nH, Dh).permute(2, 0, 3, 1, 4).unbind(0)
            if impl == "pallas":
                ctx = ops.window_attention(q, k, v, bias, self.scale)
            else:
                ctx = window_attention_xla(q, k, v, bias, self.scale, masks,
                                           self.attn_drop, tp)
            ctx = ctx.transpose(1, 2).reshape(BW, N, nH * Dh)
            out = self.proj(ctx, ops) if tp is None else \
                row_parallel_dense(self.proj, ctx, ops, tp)
        return dropout(out, masks, self.drop)

    def _half_blocks(self, x, bias, ops):
        """Serving a block too wide for the whole-block kernel, as JAX's
        ``_fused_half_blocks`` (swin.py:483-530) and its plain route
        (:338-366) serve it: a shifted block rolls the (B, H, W, C) map by
        (-shift, -shift) before the window partition and back after the
        reverse, and its bias carries the -100 shift mask per window (P =
        nW). Where the halves fit (:func:`half_weights_fit`):
        ``swin_attn_half`` where JAX's would run its own kernel
        (:func:`attn_half_admits`), else its fallback, LN1 ->
        ``window_block_attention`` (+x); then ``fused_mlp_preln``. Otherwise
        JAX's plain route: LN1 (K3) -> ``window_block_attention`` (+x) ->
        LN2 (K3) -> ``Mlp`` (K1, GELU, K1) (+res). x (B, H*W, C)."""
        H, W = self.resolution
        B, L, C = x.shape
        window, shift = self.window, self.shift
        xm = x.view(B, H, W, C)
        if shift:
            xm = torch.roll(xm, (-shift, -shift), (1, 2))
        windows = window_partition(xm, window)
        BW, N, _ = windows.shape
        # the products in the activations' dtype (f32 masters serve in bf16)
        dt = windows.dtype
        qkv = (self.qkv.weight.to(dt), self.qkv.bias.to(dt))
        proj = (self.proj.weight.to(dt), self.proj.bias.to(dt))
        nH = self._heads()
        ta = {} if self.tp_attn is None else {"tp": self.tp_attn}
        tm = {} if self.tp_mlp is None else {"tp": self.tp_mlp}
        if not half_weights_fit(C):
            y = ops.window_block_attention(
                self.norm1(windows, ops), *qkv, *proj, bias, self.scale, nH,
                residual=windows, **ta)
            y = y + self._mlp(self.norm2(y, ops), ops)
        else:
            # the gate reads the global C, as one device's does
            if attn_half_admits(BW, N, C, bias.shape[0]):
                y = ops.swin_attn_half(windows, self.norm1.weight,
                                       self.norm1.bias, *qkv, *proj, bias,
                                       self.scale, nH, **ta)
            else:
                y = ops.window_block_attention(
                    self.norm1(windows, ops), *qkv, *proj, bias, self.scale,
                    nH, residual=windows, **ta)
            mlp = self.mlp
            y = ops.fused_mlp_preln(y, self.norm2.weight, self.norm2.bias,
                                    mlp.fc1.weight.to(dt),
                                    mlp.fc1.bias.to(dt),
                                    mlp.fc2.weight.to(dt),
                                    mlp.fc2.bias.to(dt), **tm)
        y = window_reverse(y, window, H, W)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        return y.reshape(B, L, C)


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class PatchMerging(nn.Module):
    """2x2 patch merging: concat -> LN -> dense without bias
    (swin.py:536-557)."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int, *,
                 dtype: torch.dtype, device):
        super().__init__()
        self.resolution = input_resolution
        self.norm = LayerNorm(4 * dim, SWIN_LN_EPS, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype,
                               device=device)

    def forward(self, x: torch.Tensor, ops) -> torch.Tensor:
        H, W = self.resolution
        B, L, C = x.shape
        x = x.view(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = x.reshape(B, (H // 2) * (W // 2), 4 * C)
        return self.reduction(self.norm(x, ops), ops)


class PatchEmbed(nn.Module):
    """Non-overlapping patchify as reshape + dense over (ph, pw, c)-flattened
    NHWC patches, then LN (swin.py:560-584)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int,
                 patch_norm: bool, *, dtype: torch.dtype, device):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Dense(patch_size * patch_size * in_chans, embed_dim,
                          dtype=dtype, device=device)
        self.norm = (LayerNorm(embed_dim, SWIN_LN_EPS, device=device)
                     if patch_norm else None)

    def forward(self, x: torch.Tensor, ops) -> torch.Tensor:
        B, H, W, C = x.shape
        p = self.patch_size
        x = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
        x = self.proj(x.reshape(B, (H // p) * (W // p), p * p * C), ops)
        return x if self.norm is None else self.norm(x, ops)


class SwinTransformer(nn.Module):
    """Hierarchical Swin encoder returning all final-stage tokens
    (B, H/32 * W/32, num_features) after the final LN (swin.py:587-649).
    ``dtype`` is the parameters' dtype, ``compute_dtype`` (default: the
    same) the activations'. ``attn_impl`` (one of :data:`ATTN_IMPLS`) goes
    to every block, as JAX's option does; ``remat`` rematerialises each
    block in training."""

    def __init__(self, config: SwinConfig, *, dtype: torch.dtype, device,
                 compute_dtype=None, attn_impl: str = "auto",
                 remat: bool = False):
        super().__init__()
        cfg = config
        self.attn_impl = check_attn_impl(attn_impl)
        self.remat = remat
        self.config, self.dtype = cfg, compute_dtype or dtype
        if cfg.ape:
            # swin.py:612-616: (1, H*W, embed_dim) f32, truncated normal 0.02
            pr = cfg.patches_resolution
            self.absolute_pos_embed = nn.Parameter(nn.init.trunc_normal_(
                torch.empty(1, pr[0] * pr[1], cfg.embed_dim,
                            dtype=torch.float32, device=device),
                std=0.02, a=-0.04, b=0.04))
        else:
            self.absolute_pos_embed = None
        # stochastic depth: a linspace over all blocks (swin.py:620)
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths)).tolist()
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans,
                                      cfg.embed_dim, cfg.patch_norm,
                                      dtype=dtype, device=device)
        self.stages = nn.ModuleList()
        self.downsamples = nn.ModuleList()
        for i in range(cfg.num_layers):
            dim = int(cfg.embed_dim * 2 ** i)
            res = (cfg.patches_resolution[0] // 2 ** i,
                   cfg.patches_resolution[1] // 2 ** i)
            offset = sum(cfg.depths[:i])
            self.stages.append(nn.ModuleList([
                SwinBlock(dim, res, cfg.num_heads[i], cfg.window_size,
                          0 if j % 2 == 0 else cfg.window_size // 2,
                          cfg.mlp_ratio, cfg.qkv_bias, cfg.qk_scale,
                          float(dpr[offset + j]), dtype=dtype, device=device,
                          attn_impl=attn_impl, drop=cfg.drop_rate,
                          attn_drop=cfg.attn_drop_rate)
                for j in range(cfg.depths[i])]))
            if i < cfg.num_layers - 1:
                self.downsamples.append(PatchMerging(res, dim, dtype=dtype,
                                                     device=device))
        self.norm = LayerNorm(cfg.num_features, SWIN_LN_EPS, device=device)

    def forward(self, x: torch.Tensor, ops, masks=None) -> torch.Tensor:
        """``masks`` (a :class:`DropoutMasks`) turns DropPath and dropout
        on; its draws come in order: the position dropout, then block by
        block."""
        cfg = self.config
        if x.shape[1] == cfg.in_chans and x.shape[1] != x.shape[2]:
            x = x.permute(0, 2, 3, 1)            # NCHW accepted (swin.py:605)
        x = self.patch_embed(x.to(self.dtype), ops)
        if self.absolute_pos_embed is not None:
            # swin.py:616 adds the f32 table to the embedding, which makes
            # JAX's residual stream f32; the port's stays in the compute
            # dtype, the sum rounded once from f32
            x = (x.float() + self.absolute_pos_embed).to(self.dtype)
        x = dropout(x, masks, cfg.drop_rate)      # swin.py:617
        for i, blocks in enumerate(self.stages):
            for block in blocks:
                if self.remat and records_grad(x, block):
                    x = rematerialized(block, x, ops, masks=masks)
                else:
                    x = block(x, ops, masks)
            if i < len(self.downsamples):
                x = self.downsamples[i](x, ops)
        return self.norm(x, ops)

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
  in); wider stages (Swin-S stage 4, C = 768) run LN1 ->
  ``window_block_attention`` (+x folded into its proj) -> ``fused_mlp_preln``,
  see :func:`uses_half_blocks`;
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

The relative-position bias is built as JAX builds it, ``onehot @ table``
(``rel_bias_from_table``, ``swin.py:67-85``), so its backward is a product and
not a scatter with atomics; serving caches the built bias.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from torch import nn

from mvlt_tpu_torch.config import SwinConfig
from mvlt_tpu_torch.ops.layers import (SWIN_LN_EPS, Dense, LayerNorm, Mlp,
                                       drop_path_multipliers)
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
    """Whether a Swin block of width ``dim`` runs as two halves.

    On the TPU the whole-block kernel needs its 12*C^2 bf16 weights in
    12 MB of VMEM (``weights_fit``, swin.py:272); wider blocks take the
    pre-LN halves (swin.py:307-313). At those widths ``swin_attn_half``
    finds no 8-aligned window group and falls back to LN1 + ``_block_kernel``
    + residual (pallas_attn.py:3289), followed by ``fused_mlp_preln``. At
    Swin-S 224 that is stage 4 (C = 768). The port keeps this routing so that
    the flagship path runs each of the six counterparts."""
    return 12 * dim * dim * 2 > 12 * 1024 * 1024


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
    ``drop_path`` in training (swin.py:235-366)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float, qkv_bias: bool, qk_scale,
                 drop_path: float = 0.0, *, dtype: torch.dtype, device):
        super().__init__()
        H, W = input_resolution
        window, shift = window_size, shift_size
        if min(input_resolution) <= window:
            # window no smaller than the map: one window, no shift
            # (swin.py:259-262; Swin-S stage 4 at 7x7)
            window, shift = min(input_resolution), 0
        self.dim, self.resolution = dim, (H, W)
        self.window, self.shift, self.num_heads = window, shift, num_heads
        self.drop_path = drop_path
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.norm1 = LayerNorm(dim, SWIN_LN_EPS, device=device)
        self.qkv = Dense(dim, 3 * dim, qkv_bias, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * window - 1) ** 2, num_heads, dtype=torch.float32,
            device=device))
        self.norm2 = LayerNorm(dim, SWIN_LN_EPS, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        N = window * window
        self.register_buffer("rel_onehot", torch.as_tensor(
            relative_position_onehot(window, window), device=device),
            persistent=False)
        mask = (shifted_window_mask(H, W, window, shift) if shift
                else np.zeros((1, N, N), np.float32))
        self.register_buffer("shift_mask", torch.as_tensor(mask, device=device),
                             persistent=False)
        self._bias_key, self._bias = None, None

    def _build_bias(self) -> torch.Tensor:
        N = self.window * self.window
        rel = (self.rel_onehot @ self.relative_position_bias_table).view(
            N, N, -1).permute(2, 0, 1)
        return (rel[None] + self.shift_mask[:, None]).contiguous()

    def attention_bias(self) -> torch.Tensor:
        """(P, nH, N, N) f32: the relative-position bias from its table, plus
        the -100 shift mask per window when shifted (P = nW, else 1). Where a
        gradient is needed it is built with its graph; serving recomputes it
        only when the table changes."""
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
        on."""
        H, W = self.resolution
        B, L, C = x.shape
        window, shift = self.window, self.shift
        windows = window_partition(x.view(B, H, W, C), window)
        bias = self.attention_bias()
        dt = windows.dtype
        params = (self.norm1.weight, self.norm1.bias, self.qkv.weight.to(dt),
                  self.qkv.bias.to(dt), self.proj.weight.to(dt),
                  self.proj.bias.to(dt), self.norm2.weight, self.norm2.bias,
                  self.mlp.fc1.weight.to(dt), self.mlp.fc1.bias.to(dt),
                  self.mlp.fc2.weight.to(dt), self.mlp.fc2.bias.to(dt))
        dp = drop_path_multipliers(masks, self.drop_path, B, x.device)
        spec = (H, W, window, shift) if shift else None
        train = dp is not None or (torch.is_grad_enabled() and any(
            t.requires_grad for t in (windows, bias, *params)))
        if train and uses_half_blocks(C):
            y = ops.swin_half_block(windows, params, bias, self.scale,
                                    self.num_heads, shift_spec=spec, dp=dp)
        elif train:
            store = stores_p(self.num_heads, window * window,
                             windows.shape[0], bias.shape[0], bool(shift))
            y = ops.swin_full_block(windows, params, bias, self.scale,
                                    self.num_heads, shift_spec=spec, dp=dp,
                                    store_p=store)
        elif uses_half_blocks(C):
            y = self._half_blocks(windows, bias, ops)
        else:
            y = ops.swin_full_block(windows, params, bias, self.scale,
                                    self.num_heads, shift_spec=spec)
        return window_reverse(y, window, H, W).reshape(B, L, C)

    def _half_blocks(self, windows, bias, ops):
        """LN1 -> window_block_attention (+x) -> fused_mlp_preln."""
        if self.shift:
            # the half route serves only stages whose map fits one window
            # (Swin-S / Swin-B stage 4); a shifted wide stage is not ported
            raise NotImplementedError(
                f"shifted Swin block at width {self.dim} (half-block route)")
        h = self.norm1(windows, ops)
        y = ops.window_block_attention(
            h, self.qkv.weight, self.qkv.bias, self.proj.weight,
            self.proj.bias, bias, self.scale, self.num_heads,
            residual=windows)
        return ops.fused_mlp_preln(y, self.norm2.weight, self.norm2.bias,
                                   self.mlp.fc1.weight, self.mlp.fc1.bias,
                                   self.mlp.fc2.weight, self.mlp.fc2.bias)


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
    same) the activations'."""

    def __init__(self, config: SwinConfig, *, dtype: torch.dtype, device,
                 compute_dtype=None):
        super().__init__()
        cfg = config
        if cfg.ape:
            raise NotImplementedError(
                "absolute position embedding (ape=True) is not ported yet; "
                "see ROADMAP.md queue A")
        self.config, self.dtype = cfg, compute_dtype or dtype
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
                          float(dpr[offset + j]), dtype=dtype, device=device)
                for j in range(cfg.depths[i])]))
            if i < cfg.num_layers - 1:
                self.downsamples.append(PatchMerging(res, dim, dtype=dtype,
                                                     device=device))
        self.norm = LayerNorm(cfg.num_features, SWIN_LN_EPS, device=device)

    def forward(self, x: torch.Tensor, ops, masks=None) -> torch.Tensor:
        """``masks`` (a :class:`DropoutMasks`) turns DropPath on; its draws
        come in block order."""
        cfg = self.config
        if masks is not None and (cfg.drop_rate or cfg.attn_drop_rate):
            raise NotImplementedError(
                "Swin training with drop_rate / attn_drop_rate above 0 is not "
                "ported (the JAX kernel routes need both at 0, swin.py:285)")
        if x.shape[1] == cfg.in_chans and x.shape[1] != x.shape[2]:
            x = x.permute(0, 2, 3, 1)            # NCHW accepted (swin.py:605)
        x = self.patch_embed(x.to(self.dtype), ops)
        for i, blocks in enumerate(self.stages):
            for block in blocks:
                x = block(x, ops, masks)
            if i < len(self.downsamples):
                x = self.downsamples[i](x, ops)
        return self.norm(x, ops)

"""The Swin backbone's training counterparts (rows 11-14 and 18-21 of the
TPU kernel table) against the JAX Pallas kernels in interpret mode, on the
same inputs drawn from a numpy seed, forward and VJP: the whole block with
DropPath multipliers, unshifted and shifted; the half block; the attention
core and its VJP with one pattern and with one per window; and the two
store-residual backward halves in bf16. Also the kernel options they add
(K1's row scale, K5's pre-LN form, the scaled column sum, K4's pattern mode)
and the DropPath draw.

float32: atol = rtol = 1e-4 (the same math; only summation order differs).
The DropPath multipliers zero one image of two on some branch, so a scaled
branch and an unscaled one differ in every test.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.ops import pallas_attn as pa
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch.models.backbones.swin import (SwinTransformer,
                                                  shifted_window_mask)
from mvlt_tpu_torch.ops import blocks, kernels
from mvlt_tpu_torch.ops.layers import DropoutMasks, drop_path_multipliers

torch.set_num_threads(2)

KEEP = 0.8
SCALE = float(np.float32(1.0) / np.float32(KEEP))
# per image (two images): dp1 drops image 0, dp2 drops image 1
DP = (np.array([0.0, SCALE], np.float32), np.array([SCALE, 0.0], np.float32))


def _np(rng, *shape, std=1.0):
    return (rng.normal(size=shape) * std).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _block_params(rng, C, std=0.1):
    """(JAX params with (in, out) dense kernels, port params with (out, in)
    weights), float32, the LN parameters perturbed from 1 / 0."""
    ln = lambda: (_np(rng, C, std=0.1) + 1.0, _np(rng, C, std=0.1))  # noqa: E731
    dense = lambda k, n: (_np(rng, k, n, std=std), _np(rng, n, std=std))  # noqa: E731
    parts = [ln(), dense(C, 3 * C), dense(C, C), ln(), dense(C, 4 * C),
             dense(4 * C, C)]
    flat = [a for p in parts for a in p]
    jp = tuple(jnp.asarray(a) for a in flat)
    tp = [_t(a.T if a.ndim == 2 else a, grad=True) for a in flat]
    return jp, tp


def _close(got, want, tol=1e-4, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=name)


def _check_param_grads(tp, jgrads):
    for i, (p, w) in enumerate(zip(tp, jgrads)):
        w = np.asarray(w)
        _close(p.grad.detach().numpy(), w.T if w.ndim == 2 else w,
               name=f"param {i}")


def _jax_dp(rows_per_image):
    return tuple(jnp.asarray(np.repeat(d, rows_per_image)[:, None])
                 for d in DP)


@pytest.mark.parametrize("shift", [False, True])
def test_swin_full_block_train_matches_jax_vjp(shift):
    """Rows 11-12: ``swin_full_block(..., dp=...)`` under ``jax.vjp``
    (``_full_kernel_dp_save`` / ``_full_shift_kernel_dp_save`` and the
    stored backward, as test_pallas_attn.py:520,580 run them) against the
    port's autograd Function: output, dx, every parameter grad and the
    relative-position bias grad (JAX's ``drel``; the port's pattern grad
    summed over the shift patterns through the bias's autograd)."""
    rng = np.random.default_rng(300 + shift)
    B, H, W, win, C, nH = 2, 8, 8, 4, 16, 2
    N, nW = win * win, (H // win) * (W // win)
    x, g = _np(rng, B * nW, N, C, std=0.5), _np(rng, B * nW, N, C)
    jp, tp = _block_params(rng, C)
    rel = _np(rng, 1, nH, N, N, std=0.3)
    mask = shifted_window_mask(H, W, win, 2)
    scale = (C // nH) ** -0.5
    spec = (H, W, win, 2) if shift else None

    def jf(x, params, rel):
        bias = (rel, jnp.asarray(mask)) if shift else rel
        return pa.swin_full_block(x, params, bias, scale, nH, interpret=True,
                                  shift_spec=spec, dp=_jax_dp(H * W))

    want, vjp = jax.vjp(jf, jnp.asarray(x), jp, jnp.asarray(rel))
    jdx, jdp, jdrel = vjp(jnp.asarray(g))
    tx, trel = _t(x, grad=True), _t(rel, grad=True)
    bias = trel + _t(mask)[:, None] if shift else trel
    got = blocks.swin_full_block(tx, tp, bias, scale, nH, shift_spec=spec,
                                 dp=tuple(_t(d) for d in DP))
    got.backward(_t(g))
    _close(got.detach().numpy(), want, name="out")
    _close(tx.grad.numpy(), jdx, name="dx")
    _check_param_grads(tp, jdp)
    _close(trel.grad.numpy(), jdrel, name="drel")


def test_swin_half_block_matches_jax_vjp():
    """Row 18: ``swin_half_block`` (``_ln_matmul_kernel``, ``attention_core``,
    ``_swin_tail_kernel`` and the stored backward) under ``jax.vjp``, as
    test_pallas_attn.py:1083 runs it, with DropPath and one bias pattern
    per window (P = 4): output, dx, parameter and per-pattern bias grads."""
    rng = np.random.default_rng(310)
    B, nW, N, C, nH = 2, 4, 16, 16, 2
    x, g = _np(rng, B * nW, N, C, std=0.5), _np(rng, B * nW, N, C)
    jp, tp = _block_params(rng, C)
    bias = _np(rng, nW, nH, N, N, std=0.3)
    scale = (C // nH) ** -0.5
    want, vjp = jax.vjp(
        lambda x, p, b: pa.swin_half_block(x, p, b, _jax_dp(nW * N), scale,
                                           nH, True),
        jnp.asarray(x), jp, jnp.asarray(bias))
    jdx, jdp, jdbias = vjp(jnp.asarray(g))
    tx, tb = _t(x, grad=True), _t(bias, grad=True)
    got = blocks.swin_half_block(tx, tp, tb, scale, nH,
                                 dp=tuple(_t(d) for d in DP))
    got.backward(_t(g))
    _close(got.detach().numpy(), want, name="out")
    _close(tx.grad.numpy(), jdx, name="dx")
    _check_param_grads(tp, jdp)
    _close(tb.grad.numpy(), jdbias, name="dbias")


@pytest.mark.parametrize("P", [1, 4])
def test_attention_core_and_vjp_match_jax(P):
    """Rows 19-21: ``attention_core`` and ``attention_core_bwd`` (K2 / K4 in
    pattern mode) against ``attention_core``, ``attention_core_bwd_flat``
    and the per-window ``attention_core_bwd`` in interpret mode, with one
    shared pattern and with one pattern per window: ctx, dqkv and dbias
    (the sum of ds over the windows of each pattern)."""
    rng = np.random.default_rng(320 + P)
    BW, N, C, nH = 8, 49, 16, 2
    qkv, dctx = _np(rng, BW, N, 3 * C, std=0.5), _np(rng, BW, N, C)
    bias = _np(rng, P, nH, N, N, std=0.3)
    scale = (C // nH) ** -0.5
    jq, jd, jb = (jnp.asarray(a) for a in (qkv, dctx, bias))
    want = pa.attention_core(jq, jb, scale, nH, interpret=True)
    got = blocks.attention_core(_t(qkv), _t(bias), scale, nH)
    _close(got.numpy(), want, name="ctx")
    dqkv, dbias = blocks.attention_core_bwd(
        _t(qkv).reshape(BW * N, 3 * C), _t(dctx).reshape(BW * N, C),
        _t(bias), N, scale, nH)
    flat = pa.attention_core_bwd_flat(jq.reshape(BW * N, 3 * C),
                                      jd.reshape(BW * N, C), jb, N, scale, nH,
                                      interpret=True)
    per_window = pa.attention_core_bwd(jq, jd, jb, scale, nH, interpret=True)
    for (wq, wb), what in ((flat, "flat"), (per_window, "per window")):
        _close(dqkv.numpy(), np.asarray(wq).reshape(BW * N, 3 * C),
               name=f"dqkv {what}")
        _close(dbias.numpy(), wb, name=f"dbias {what}")


def test_pattern_attention_bwd_contract():
    """K4's pattern mode (plain version): G % P != 0 raises; no key bias
    gives no key-bias gradient; dpattern is the per-window ds summed over
    the windows of each pattern (checked against P = G, one pattern a
    window)."""
    rng = np.random.default_rng(330)
    G, N, C, nH = 6, 9, 8, 2
    qkv, dctx = _t(_np(rng, G * N, 3 * C)), _t(_np(rng, G * N, C))
    each = _t(_np(rng, G, nH, N, N))
    _, none, per = kernels.biased_attention_bwd(qkv, dctx, nH, N, 0.5,
                                                pattern=each)
    assert none is None
    shared = each[:3].contiguous()
    pat3 = each.clone()
    pat3[3:] = shared                       # window g uses shared[g % 3]
    dq3, _, d3 = kernels.biased_attention_bwd(qkv, dctx, nH, N, 0.5,
                                              pattern=shared)
    dqe, _, de = kernels.biased_attention_bwd(qkv, dctx, nH, N, 0.5,
                                              pattern=pat3)
    torch.testing.assert_close(dq3, dqe)
    torch.testing.assert_close(d3, de[:3] + de[3:])
    with pytest.raises(ValueError, match="G % P"):
        kernels.biased_attention_bwd(qkv, dctx, nH, N, 0.5,
                                     pattern=each[:4].contiguous())


def _mlp_half_inputs(rng, M, C, dt):
    H = 4 * C
    a = dict(x2=_np(rng, M, C, std=0.5), ctx2=_np(rng, M, C, std=0.5),
             g2=_np(rng, M, C), wproj=_np(rng, C, C, std=0.1),
             bproj=_np(rng, C, std=0.1), ln2s=_np(rng, C, std=0.1) + 1.0,
             ln2b=_np(rng, C, std=0.1), w1=_np(rng, C, H, std=0.1),
             b1=_np(rng, H, std=0.1), w2=_np(rng, H, C, std=0.1),
             b2=_np(rng, C, std=0.1))
    # round the compute-dtype inputs once, so both sides see the same values
    for k in ("x2", "ctx2", "g2", "wproj", "bproj", "w1", "b1", "w2", "b2"):
        a[k] = np.asarray(jnp.asarray(a[k], dt).astype(jnp.float32))
    return a


# bf16 bar of rows 13-14 against the JAX kernels, per tensor, relative to
# the tensor's largest |value|: the same rounding points on both sides
# except db1 (the port sums the bf16 da1, the TPU kernel its f32 da1:
# 2.1e-3 and 2.3e-3 measured) and the LN moments (two-pass here,
# E[x^2] - E[x]^2 there); every other output measured within 2e-4.
BF16_BAR = 1e-2


@pytest.mark.parametrize("with_dp", [False, True])
def test_swin_mlp_half_bwd_matches_jax_kernel_bf16(with_dp):
    """Row 13: ``swin_mlp_half_bwd`` against ``_swin_mlp_bwd_kernel`` in
    interpret mode at bf16 (as test_pallas_attn.py:786 runs it), with the
    DropPath multipliers per image: dres1, the weight, bias and LN grads,
    and the port's da / dbproj against JAX's ``dres1 * dp1`` and its sum.
    ddp1 / ddp2 are not computed by the port (their cotangent stops at the
    Bernoulli draw)."""
    rng = np.random.default_rng(340 + with_dp)
    M, C, dt, bf = 64, 32, jnp.bfloat16, torch.bfloat16
    a = _mlp_half_inputs(rng, M, C, dt)
    jdp = _jax_dp(M // 2) if with_dp else None
    want = pa.swin_mlp_half_bwd(
        *(jnp.asarray(a[k], dt) for k in ("x2", "ctx2", "g2", "wproj",
                                          "bproj")),
        jnp.asarray(a["ln2s"]), jnp.asarray(a["ln2b"]),
        *(jnp.asarray(a[k], dt) for k in ("w1", "b1", "w2", "b2")),
        jdp, interpret=True)
    wdres1, wdw1, wdb1, wdw2, wdb2, wdln2s, wdln2b = (
        np.asarray(w, np.float32) for w in want[:7])
    dp1 = np.repeat(DP[0], M // 2)[:, None] if with_dp else 1.0
    wda = np.asarray(jnp.asarray(wdres1 * dp1, dt).astype(jnp.float32))
    got = blocks.swin_mlp_half_bwd(
        *(_t(a[k]).to(bf) for k in ("x2", "ctx2", "g2")),
        _t(a["wproj"].T).to(bf), _t(a["bproj"]).to(bf), _t(a["ln2s"]),
        _t(a["ln2b"]), _t(a["w1"].T).to(bf), _t(a["b1"]).to(bf),
        _t(a["w2"].T).to(bf),
        tuple(_t(d) for d in DP) if with_dp else None)
    names = "dres1 da dbproj dw1 db1 dw2 db2 dln2s dln2b".split()
    wants = (wdres1, wda, (wdres1 * dp1).sum(0), wdw1.T, wdb1, wdw2.T, wdb2,
             wdln2s, wdln2b)
    for name, gt, w in zip(names, got, wants):
        err = float((gt.float() - _t(w)).abs().max())
        assert err <= BF16_BAR * float(np.abs(w).max()), (name, err)


def test_swin_qkv_tail_bwd_matches_jax_kernel_bf16():
    """Row 14: ``swin_qkv_tail_bwd`` against ``_swin_qkv_tail_kernel`` in
    interpret mode at bf16 (as test_pallas_attn.py:996 runs it, with dqkv
    in the compute dtype as the block passes it): dx, dWqkv, dbqkv, dLN1."""
    rng = np.random.default_rng(350)
    M, C, dt, bf = 64, 32, jnp.bfloat16, torch.bfloat16
    r = lambda a: np.asarray(jnp.asarray(a, dt).astype(jnp.float32))  # noqa: E731
    x2, dqkv = r(_np(rng, M, C, std=0.5)), r(_np(rng, M, 3 * C))
    dres1 = _np(rng, M, C)
    wqkv = r(_np(rng, C, 3 * C, std=0.1))
    ln1s, ln1b = _np(rng, C, std=0.1) + 1.0, _np(rng, C, std=0.1)
    want = pa.swin_qkv_tail_bwd(jnp.asarray(x2, dt), jnp.asarray(dqkv, dt),
                                jnp.asarray(dres1), jnp.asarray(wqkv, dt),
                                jnp.asarray(ln1s), jnp.asarray(ln1b),
                                interpret=True)
    got = blocks.swin_qkv_tail_bwd(_t(x2).to(bf), _t(dqkv).to(bf),
                                   _t(dres1), _t(wqkv.T).to(bf), _t(ln1s),
                                   _t(ln1b))
    for name, gt, w in zip("dx dwqkv dbqkv dln1s dln1b".split(), got, want):
        w = np.asarray(w, np.float32)
        w = w.T if name == "dwqkv" else w
        err = float((gt.float() - _t(w)).abs().max())
        assert err <= BF16_BAR * float(np.abs(w).max()), (name, err)


def test_row_scale_preln_and_scaled_column_sum_plain():
    """The options the Swin slice adds to K1 and K5, on their plain
    versions: K1's f32 row scale (one value per image, before the
    residual), K5's pre-LN form (an incoming residual gradient, a row scale
    on da and its sum, bf16 res and f32 g) and the column sum with a row
    scale and its scaled copy."""
    rng = np.random.default_rng(360)
    M, K, N = 12, 8, 16
    a, w, b, r = (_t(_np(rng, *s)) for s in ((M, K), (N, K), (N,), (M, N)))
    s = _t([0.0, 1.25, 2.0])
    want = (a @ w.T + b) * s.repeat_interleave(4)[:, None] + r
    torch.testing.assert_close(kernels.gemm(a, w, b, residual=r, row_scale=s),
                               want)
    res, g, gres = (_t(_np(rng, M, N)) for _ in range(3))
    gam = _t(_np(rng, N, std=0.1) + 1.0)
    base = kernels.layernorm_bwd(res, gam, g, 1e-5)
    dres, da, dgam, dbet, db = kernels.layernorm_bwd(res, gam, g, 1e-5,
                                                     gres=gres, row_scale=s)
    torch.testing.assert_close(dres, base[0] + gres)
    torch.testing.assert_close(da, dres * s.repeat_interleave(4)[:, None])
    torch.testing.assert_close(db, da.sum(0))
    torch.testing.assert_close((dgam, dbet), base[2:4])
    bf = kernels.layernorm_bwd(res.bfloat16(), gam, g, 1e-5,
                               out_dtype=torch.bfloat16)
    assert bf[1].dtype == torch.bfloat16 and bf[0].dtype == torch.float32
    total, scaled = kernels.column_sum(g.bfloat16(), row_scale=s)
    want = g.bfloat16().float() * s.repeat_interleave(4)[:, None]
    torch.testing.assert_close(scaled, want.bfloat16())
    torch.testing.assert_close(total, want.sum(0))
    with pytest.raises(ValueError, match="row_scale"):
        kernels.gemm(a, w, b, row_scale=_t([1.0] * 5))


def _tiny_swin(rate=0.3):
    cfg = pcfg.SwinConfig(img_size=32, patch_size=4, embed_dim=8,
                          depths=(2, 2), num_heads=(2, 4), window_size=4,
                          drop_path_rate=rate)
    model = SwinTransformer(cfg, dtype=torch.float32, device="cpu")
    gen = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(_t(gen.normal(0, 0.1, tuple(p.shape))))
    return model


def test_drop_path_draw_order_count_and_scale():
    """The DropPath draw: rates are ``linspace(0, 0.3, 4)``; block 0 (rate
    0) draws nothing and each other block draws two (B,) masks, attention
    branch first, in block order; each multiplier is float32 ``m / keep``
    (1 / 0.9, not a bf16 value, at rate 0.1)."""
    model = _tiny_swin()
    rates = [b.drop_path for st in model.stages for b in st]
    np.testing.assert_allclose(rates, np.linspace(0, 0.3, 4))
    B = 3
    masks = [np.array([True, False, True]), np.array([False, True, True])] * 3
    seen = []
    ops = types.SimpleNamespace(**vars(blocks.PLAIN_OPS))

    def spy(x, *args, dp=None, **kw):
        seen.append(dp)
        return blocks.swin_full_block_plain(x, *args, dp=dp, **kw)

    ops.swin_full_block = spy
    with torch.no_grad():
        model(_t(_np(np.random.default_rng(1), B, 3, 32, 32)), ops,
              DropoutMasks.replay(masks))
    assert seen[0] is None and len(seen) == 4
    for (dp1, dp2), rate in zip(seen[1:], rates[1:]):
        scale = np.float32(1.0) / np.float32(1.0 - rate)
        assert dp1.dtype == dp2.dtype == torch.float32
        np.testing.assert_array_equal(dp1.numpy(), masks[0] * scale)
        np.testing.assert_array_equal(dp2.numpy(), masks[1] * scale)
    rec = DropoutMasks(torch.Generator().manual_seed(0), record=True)
    dp = drop_path_multipliers(rec, 0.3, 64, "cpu")
    assert [m.shape for m in rec.recorded] == [(64,), (64,)]
    assert set(dp[0].unique().tolist()) <= {0.0, float(np.float32(1 / 0.7))}
    assert drop_path_multipliers(rec, 0.0, 64, "cpu") is None
    assert drop_path_multipliers(None, 0.3, 64, "cpu") is None


def test_swin_backbone_trains_on_every_parameter():
    """Under autograd the backbone gives every parameter a gradient (the
    C1 fault: the LayerNorms outside the blocks, the relative-position
    tables), and the kernel twins take their plain versions on the CPU
    without counting a launch."""
    model = _tiny_swin()
    before = [getattr(f, c) for f in blocks.COUNTERPARTS for c in blocks.COUNTS]
    out = model(_t(_np(np.random.default_rng(2), 2, 3, 32, 32)),
                blocks.KERNEL_OPS,
                DropoutMasks(torch.Generator().manual_seed(0)))
    out.square().mean().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name
    after = [getattr(f, c) for f in blocks.COUNTERPARTS for c in blocks.COUNTS]
    assert before == after

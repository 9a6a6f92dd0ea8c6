"""The port's TPU-kernel counterparts (plain twins, as the CPU runs them)
against the JAX Pallas kernels in interpret mode, on the same inputs drawn
from a numpy seed: the six forward ones, the masked training forwards and
the two backward ones, with every mask option.

float32: atol = rtol = 1e-4 (the same math; only summation order differs).
bfloat16: the port rounds the residual sum to bf16 where one kernel hands
it to the next, while the fused TPU kernel keeps it in f32 (see
``mvlt_tpu_torch/ops/blocks.py``); outputs are O(1), so the bar is
atol = 6e-2, rtol = 2e-2 (a few bf16 steps at the largest values).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.ops import pallas_attn as pa
from mvlt_tpu_torch.ops import blocks, kernels

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 6e-2, 2e-2)}


def _pair(a, dtype):
    """The same numpy array as a JAX and a torch tensor of one dtype."""
    jdt, tdt = DTYPES[dtype][:2]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def _f32(a):
    return jnp.asarray(a, jnp.float32), torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, dtype):
    atol, rtol = DTYPES[dtype][2:]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _dense(rng, k, n, dtype, std=0.1):
    """(jax kernel (in, out), jax bias), (port weight (out, in), port bias)."""
    w = rng.normal(size=(k, n)) * std
    b = rng.normal(size=(n,)) * std
    (jw, tw), (jb, tb) = _pair(w, dtype), _pair(b, dtype)
    return (jw, jb), (tw.t().contiguous(), tb)


def _ln(rng, c):
    (js, ts), (jb, tb) = (_f32(rng.normal(size=(c,)) * 0.1 + 1.0),
                          _f32(rng.normal(size=(c,)) * 0.1))
    return (js, jb), (ts, tb)


def _block_params(rng, C, dtype):
    ln1, qkv, proj = _ln(rng, C), _dense(rng, C, 3 * C, dtype), _dense(rng, C, C, dtype)
    ln2, fc1, fc2 = _ln(rng, C), _dense(rng, C, 4 * C, dtype), _dense(rng, 4 * C, C, dtype)
    parts = (ln1, qkv, proj, ln2, fc1, fc2)
    return (tuple(a for p in parts for a in p[0]),
            tuple(a for p in parts for a in p[1]))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_block_attention(dtype):
    """``_block_kernel`` (pallas_attn.py:166); shapes of
    test_pallas_attn.py:68-83, plus the stage-4 residual fold."""
    rng = np.random.default_rng(100)
    BW, N, C, nH, nWb = 16, 49, 32, 4, 4
    jx, tx = _pair(rng.normal(size=(BW, N, C)), dtype)
    (jwq, jbq), (twq, tbq) = _dense(rng, C, 3 * C, dtype, 0.2)
    (jwp, jbp), (twp, tbp) = _dense(rng, C, C, dtype, 0.2)
    jbias, tbias = _f32(rng.normal(size=(nWb, nH, N, N)) * 0.5)
    scale = (C // nH) ** -0.5
    want = pa.window_block_attention(jx, jwq, jbq, jwp, jbp, jbias, scale,
                                     nH, interpret=True)
    got = blocks.window_block_attention_plain(tx, twq, tbq, twp, tbp, tbias,
                                              scale, nH)
    _close(got, want, dtype)
    jr, tr = _pair(rng.normal(size=(BW, N, C)), dtype)
    got = blocks.window_block_attention_plain(tx, twq, tbq, twp, tbp, tbias,
                                              scale, nH, residual=tr)
    want = (jr.astype(jnp.float32) + want.astype(jnp.float32))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_swin_full_block(dtype):
    """``_full_kernel`` (pallas_attn.py:652) through its pad-to-56 path;
    shapes of test_pallas_attn.py:131-148."""
    rng = np.random.default_rng(101)
    BW, N, C, nH, nWb = 8, 49, 16, 2, 4
    jx, tx = _pair(rng.normal(size=(BW, N, C)), dtype)
    jp, tp = _block_params(rng, C, dtype)
    jbias, tbias = _f32(rng.normal(size=(nWb, nH, N, N)) * 0.5)
    scale = (C // nH) ** -0.5
    want = pa.swin_full_block(jx, jp, jbias, scale, nH, interpret=True)
    got = blocks.swin_full_block_plain(tx, tp, tbias, scale, nH)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_swin_full_block_shift(dtype):
    """``_full_shift_kernel`` (pallas_attn.py:702): unshifted window-major
    in and out, the roll folded in; shapes of test_pallas_attn.py:340-369.
    The port takes the rel bias and the shift mask combined per window."""
    rng = np.random.default_rng(102)
    H = W = 8
    win, shift, C, nH, B = 4, 2, 16, 2, 3
    N, nW = win * win, (H // win) * (W // win)
    assert pa.shift_kernel_feasible(H, W, win, C, B)
    jx, tx = _pair(rng.normal(size=(B * nW, N, C)), dtype)
    jp, tp = _block_params(rng, C, dtype)
    rel = rng.normal(size=(1, nH, N, N)) * 0.5
    mask = np.where(rng.random((nW, N, N)) < 0.2, -100.0, 0.0)
    scale = (C // nH) ** -0.5
    want = pa.swin_full_block(jx, jp, (_f32(rel)[0], _f32(mask)[0]), scale,
                              nH, interpret=True,
                              shift_spec=(H, W, win, shift))
    combined = torch.from_numpy((rel + mask[:, None]).astype(np.float32))
    got = blocks.swin_full_block_plain(tx, tp, combined, scale, nH,
                                       shift_spec=(H, W, win, shift))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_attn_ln(dtype):
    """``_attn_ln_kernel`` (pallas_attn.py:2156) with a live key-padding
    bias; shapes of test_pallas_attn.py:184-202."""
    rng = np.random.default_rng(103)
    B, N, C, nH = 4, 11, 32, 4
    jx, tx = _pair(rng.normal(size=(B, N, C)) * 0.5, dtype)
    (jwq, jbq), (twq, tbq) = _dense(rng, C, 3 * C, dtype)
    (jwp, jbp), (twp, tbp) = _dense(rng, C, C, dtype)
    lengths = np.array([11, 7, 9, 3])
    kb = np.where(np.arange(N)[None] < lengths[:, None], 0.0, -10000.0)
    jkb, tkb = _f32(kb)
    (jls, jlb), (tls, tlb) = _ln(rng, C)
    scale = (C // nH) ** -0.5
    want = pa.fused_attn_ln(jx, jwq, jbq, jwp, jbp, jkb, jls, jlb, scale, nH,
                            1e-12, interpret=True)
    got = blocks.fused_attn_ln_plain(tx, twq, tbq, twp, tbp, tkb, tls, tlb,
                                     scale, nH, 1e-12)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_mlp_ln(dtype):
    """``_mlp_ln_kernel`` (pallas_attn.py:2817); shapes of
    test_pallas_attn.py:234-249."""
    rng = np.random.default_rng(104)
    B, N, C = 3, 10, 32
    jx, tx = _pair(rng.normal(size=(B, N, C)) * 0.5, dtype)
    (jw1, jb1), (tw1, tb1) = _dense(rng, C, 4 * C, dtype)
    (jw2, jb2), (tw2, tb2) = _dense(rng, 4 * C, C, dtype)
    (jls, jlb), (tls, tlb) = _ln(rng, C)
    want = pa.fused_mlp_ln(jx, jw1, jb1, jw2, jb2, jls, jlb, 1e-12,
                           interpret=True)
    got = blocks.fused_mlp_ln_plain(tx, tw1, tb1, tw2, tb2, tls, tlb, 1e-12)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_mlp_preln(dtype):
    """``_mlp_preln_kernel`` (pallas_attn.py:3359); shapes of
    test_pallas_attn.py:296-310."""
    rng = np.random.default_rng(105)
    B, N, C = 3, 10, 32
    jx, tx = _pair(rng.normal(size=(B, N, C)) * 0.5, dtype)
    (jls, jlb), (tls, tlb) = _ln(rng, C)
    (jw1, jb1), (tw1, tb1) = _dense(rng, C, 4 * C, dtype)
    (jw2, jb2), (tw2, tb2) = _dense(rng, 4 * C, C, dtype)
    want = pa.fused_mlp_preln(jx, jls, jlb, jw1, jb1, jw2, jb2,
                              interpret=True)
    got = blocks.fused_mlp_preln_plain(tx, tls, tlb, tw1, tb1, tw2, tb2)
    _close(got, want, dtype)


@pytest.mark.parametrize("H,W,window,shift", [(8, 8, 4, 2), (56, 56, 7, 3),
                                              (28, 28, 7, 3), (14, 14, 7, 3),
                                              (12, 8, 4, 2)])
def test_shift_permutation_matches_jax(H, W, window, shift):
    """The port's dst -> src row map is the JAX kernel's ``_shift_perm``."""
    np.testing.assert_array_equal(
        blocks.shift_permutation(H, W, window, shift),
        pa._shift_perm(H, W, window, shift))


def test_kernel_twins_equal_plain_on_cpu_and_count_nothing():
    """On CPU tensors every wrapper is its plain version, and no launch is
    counted: counts record only kernels that ran on the card."""
    rng = np.random.default_rng(106)
    x = torch.from_numpy(rng.normal(size=(2, 16, 8)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(8, 32)).astype(np.float32))
    b1, b2, g, b = torch.zeros(32), torch.zeros(8), torch.ones(8), torch.zeros(8)
    before = [f.launches for f in (*kernels.KERNELS, *blocks.COUNTERPARTS)]
    torch.testing.assert_close(
        blocks.fused_mlp_ln(x, w1, b1, w2, b2, g, b, 1e-12),
        blocks.fused_mlp_ln_plain(x, w1, b1, w2, b2, g, b, 1e-12),
        rtol=0, atol=0)
    after = [f.launches for f in (*kernels.KERNELS, *blocks.COUNTERPARTS)]
    assert before == after


def test_gemm_plain_epilogue_and_row_indices():
    """K1's contract on the plain version: bias, exact GELU, residual with a
    row gather, and a row scatter of the store."""
    rng = np.random.default_rng(107)
    a = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(6, 4)).astype(np.float32))
    gi = torch.tensor([5, 4, 3, 2, 1, 0], dtype=torch.int32)
    si = torch.tensor([1, 2, 0, 5, 3, 4], dtype=torch.int32)
    got = kernels.gemm(a, w, b, gelu=True, residual=r, residual_index=gi,
                       store_index=si)
    y = torch.nn.functional.gelu(a @ w.t() + b) + r[gi.long()]
    want = torch.empty_like(y)
    want[si.long()] = y
    torch.testing.assert_close(got, want)


def test_layernorm_plain_row_gather():
    rng = np.random.default_rng(108)
    x = torch.from_numpy(rng.normal(size=(5, 12)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(12,)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(12,)).astype(np.float32))
    idx = torch.tensor([4, 0, 3, 1, 2], dtype=torch.int32)
    got = kernels.layernorm(x, g, b, 1e-5, row_index=idx)
    want = torch.nn.functional.layer_norm(x[idx.long()], (12,), g, b, 1e-5)
    torch.testing.assert_close(got, want)


# ---------------------------------------------------------------------------
# the fusion encoder's training path: backward counterparts, K4 / K5 plain
# versions and the autograd Functions, in float32 at 1e-4
# ---------------------------------------------------------------------------

def _np(rng, *shape, std=1.0):
    return (rng.normal(size=shape) * std).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


@pytest.mark.parametrize("B,N,C,nH", [(4, 13, 32, 4), (2, 16, 48, 2)])
def test_seq_attention_core_bwd(B, N, C, nH):
    """``_seq_core_bwd_kernel`` (pallas_attn.py:2413) in interpret mode, as
    test_pallas_attn.py:701 runs it: dqkv and dkbias, with a ragged N (13)
    and a padded key bias."""
    rng = np.random.default_rng(110 + N)
    qkv, dctx = _np(rng, B, N, 3 * C, std=0.3), _np(rng, B, N, C)
    kb = np.where(rng.random((B, N)) > 0.2, 0.0, -10000.0).astype(np.float32)
    scale = (C // nH) ** -0.5
    want = pa.seq_attention_core_bwd(jnp.asarray(qkv), jnp.asarray(dctx),
                                     jnp.asarray(kb), None, None, scale, nH,
                                     interpret=True)
    got = blocks.seq_attention_core_bwd_plain(_t(qkv), _t(dctx), _t(kb), None,
                                              None, scale, nH)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
    assert got[0].shape == (B, N, 3 * C) and got[1].shape == (B, N)


def test_seq_attention_core_bwd_refuses_masks():
    """Masks whose shape does not fit (B, N, N) / (B, nH, N, N) are
    refused, by the kernel twin and the plain one."""
    qkv, dctx = torch.zeros(1, 4, 24), torch.zeros(1, 4, 8)
    kb = torch.zeros(1, 4)
    for qbias, amask in ((torch.zeros(1, 3, 4), None),
                         (None, torch.ones(1, 1, 4, 4)),
                         (None, torch.ones(2, 2, 4, 4))):
        for fn in (blocks.seq_attention_core_bwd,
                   blocks.seq_attention_core_bwd_plain):
            with pytest.raises(ValueError, match="qbias|amask"):
                fn(qkv, dctx, kb, qbias, amask, 0.5, 2)


def _masks_np(rng, B, nH, N, C):
    """A causal -10000 qbias, a real 0 or 1/0.9 attention-dropout mask and
    a hidden-dropout mask (test_pallas_attn.py:643-647)."""
    causal = np.triu(np.full((N, N), -10000.0), 1).astype(np.float32)
    qbias = np.repeat(causal[None], B, 0)
    amask = ((rng.random((B, nH, N, N)) > 0.1) / 0.9).astype(np.float32)
    hmask = ((rng.random((B, N, C)) > 0.1) / 0.9).astype(np.float32)
    return qbias, amask, hmask


# the combinations of test_pallas_attn.py:651-652 and :731-732
ATTN_MASKS = [(True, True, True), (False, True, False), (True, False, False),
              (False, False, True)]
CORE_MASKS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("qb,am", CORE_MASKS)
def test_seq_attention_core_bwd_masked(qb, am):
    """``_seq_core_bwd_kernel`` with qbias / amask (interpret mode, as
    test_pallas_attn.py:700 runs it): dqkv and dkbias at a ragged N, with a
    real dropout mask (a mask of ones would not tell p from p * amask)."""
    rng = np.random.default_rng(150)
    B, N, C, nH = 3, 13, 32, 4
    qkv, dctx = _np(rng, B, N, 3 * C, std=0.3), _np(rng, B, N, C)
    kb = np.where(rng.random((B, N)) > 0.2, 0.0, -10000.0).astype(np.float32)
    qbias, amask, _ = _masks_np(rng, B, nH, N, C)
    qbias, amask = (qbias if qb else None), (amask if am else None)
    scale = (C // nH) ** -0.5
    want = pa.seq_attention_core_bwd(
        jnp.asarray(qkv), jnp.asarray(dctx), jnp.asarray(kb),
        None if qbias is None else jnp.asarray(qbias),
        None if amask is None else jnp.asarray(amask), scale, nH,
        interpret=True)
    got = blocks.seq_attention_core_bwd_plain(
        _t(qkv), _t(dctx), _t(kb), None if qbias is None else _t(qbias),
        None if amask is None else _t(amask), scale, nH)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("qb,am,hm", ATTN_MASKS)
def test_fused_attn_ln_masked_matches_jax_vjp(qb, am, hm):
    """``fused_attn_ln_masked`` (``_attn_ln_kernel`` with has_qbias /
    has_amask / has_hmask, interpret mode) and its custom VJP
    (``_attn_ln_bwd_stored``): the output and the gradients of x, the
    weights and the LN parameters, f32 at 1e-4. The port runs its autograd
    Function over the plain versions."""
    rng = np.random.default_rng(151)
    B, N, C, nH = 3, 11, 32, 4
    x, gy = _np(rng, B, N, C, std=0.5), _np(rng, B, N, C)
    w = [_np(rng, C, 3 * C, std=0.1), _np(rng, 3 * C, std=0.1),
         _np(rng, C, C, std=0.1), _np(rng, C, std=0.1)]
    lns, lnb = _np(rng, C, std=0.1) + 1.0, _np(rng, C, std=0.1)
    kb = np.where(np.arange(N)[None] < np.array([11, 6, 9])[:, None],
                  0.0, -10000.0).astype(np.float32)
    qbias, amask, hmask = _masks_np(rng, B, nH, N, C)
    masks = [m if on else None for m, on in ((qbias, qb), (amask, am),
                                             (hmask, hm))]
    jmasks = [None if m is None else jnp.asarray(m) for m in masks]
    scale = (C // nH) ** -0.5
    args = [x, *w, lns, lnb]

    def fn(x_, a, b, c, d, s, t):
        return pa.fused_attn_ln_masked(x_, a, b, c, d, jnp.asarray(kb),
                                       *jmasks, s, t, scale, nH, 1e-12, 8,
                                       True)

    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(gy))
    t = [_t(a).requires_grad_() for a in args]
    got = blocks.fused_attn_ln_masked_plain(
        t[0], t[1].t(), t[2], t[3].t(), t[4], _t(kb),
        *(None if m is None else _t(m) for m in masks), t[5], t[6], scale,
        nH, 1e-12)
    got.backward(_t(gy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-4, rtol=1e-4)
    for i, (tt, wg) in enumerate(zip(t, want)):
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(wg), atol=1e-4,
                                   rtol=1e-4, err_msg=f"input {i}")


def test_fused_mlp_ln_masked_matches_jax_vjp():
    """``fused_mlp_ln_masked`` (``_mlp_ln_kernel`` with has_hmask,
    interpret mode) and its custom VJP: output and every input gradient,
    f32 at 1e-4."""
    rng = np.random.default_rng(152)
    B, N, C = 3, 11, 32
    x, gy = _np(rng, B, N, C, std=0.5), _np(rng, B, N, C)
    w = [_np(rng, C, 4 * C, std=0.1), _np(rng, 4 * C, std=0.1),
         _np(rng, 4 * C, C, std=0.1), _np(rng, C, std=0.1)]
    lns, lnb = _np(rng, C, std=0.1) + 1.0, _np(rng, C, std=0.1)
    hmask = _masks_np(rng, B, 1, N, C)[2]
    args = [x, *w, lns, lnb]

    def fn(x_, a, b, c, d, s, t):
        return pa.fused_mlp_ln_masked(x_, a, b, c, d, jnp.asarray(hmask), s,
                                      t, 1e-12, 16, True)

    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(gy))
    t = [_t(a).requires_grad_() for a in args]
    got = blocks.fused_mlp_ln_masked_plain(t[0], t[1].t(), t[2], t[3].t(),
                                           t[4], _t(hmask), t[5], t[6], 1e-12)
    got.backward(_t(gy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=1e-4, rtol=1e-4)
    for i, (tt, wg) in enumerate(zip(t, want)):
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(wg), atol=1e-4,
                                   rtol=1e-4, err_msg=f"input {i}")


def test_attention_shared_memory_fits_every_admitted_n():
    """The shared-memory reckoning of K2 and K4 (mirrors of ``smem_bytes``
    in csrc/attention.cu and csrc/attention_bwd.cu): at head dim 64 every N
    up to 288 fits the 232,448 bytes an H100 block may opt in to, in every
    mode. Up to 288 the bound is the register form's tile plan (nine 32-key
    chunks of scores in registers), not shared memory: K2 needs 82,944
    bytes at N = 288 in the register form (199,040 in the middle form that
    the sequence modes take there: k and v whole, a five-stage ring);
    K4's two passes need O(N Dh) (58,368 / 62,208 bytes at
    N = 131, where the scalar K4's N x N f32 tiles took 207,504 and stopped
    at N = 140), and its pattern mode's sum of ds over a block's groups adds
    64 rows of N f32 (171,776 bytes at N = 288). Past 288 the long form's
    shared memory is the same at every N (K2 175,744 bytes, K4 192,128:
    128 rows a block, a four-stage ring with its bias tiles), up to its cap
    of 46,340; the window modes (K4's pattern mode, K2's pattern,
    stored-p and head-major modes) stop at 288. On a card with less shared
    memory the window modes' bound is again where the next N stops
    fitting."""
    optin, Dh = kernels.H100_SMEM_OPTIN, 64
    top = kernels.ATTENTION_LONG_MAX_N
    bwd_pattern = functools.partial(kernels.attention_bwd_smem_bytes,
                                    pattern=True)
    assert optin == 232448
    for n in range(1, 289):
        assert 0 < kernels.attention_smem_bytes(n, Dh) <= optin, n
        assert 0 < kernels.attention_bwd_smem_bytes(n, Dh) <= optin, n
        assert 0 < bwd_pattern(n, Dh) <= optin, n
    assert kernels.attention_bwd_smem_bytes(131, Dh) == 62208
    assert bwd_pattern(131, Dh) == 62208 + 40960
    assert bwd_pattern(288, Dh) == 171776
    assert kernels.attention_smem_bytes(288, Dh, form="register") == 82944
    assert kernels.attention_smem_bytes(288, Dh) == 199040
    # an amask's rows are staged only where two blocks still fit an SM
    assert kernels.attention_smem_bytes(288, Dh, amask=True,
                                        form="register") == 82944
    assert kernels.attention_smem_bytes(131, Dh, amask=True) == 50176 + 16784
    # the long form: the same bytes at every N past 288, no pattern mode
    for n in (289, 348, 474, 4096, top):
        for amask in (False, True):
            assert kernels.attention_smem_bytes(n, Dh, amask) == 175744, n
            assert kernels.attention_bwd_smem_bytes(n, Dh,
                                                    amask=amask) == 192128
        assert bwd_pattern(n, Dh) == -1
    assert kernels.attention_smem_bytes(top + 1, Dh) == -1
    assert kernels.attention_bwd_smem_bytes(top + 1, Dh) == -1
    assert kernels.max_attention_n(Dh, optin) == top
    kernels.check_attention_fits(top, Dh, optin, amask=True)
    kernels.check_attention_fits(top, Dh, optin, backward=True, amask=True)
    with pytest.raises(ValueError, match=f"N={top + 1}, head dim 64"):
        kernels.check_attention_fits(top + 1, Dh, optin)
    # the window modes: K2's (with ``window``) and K4's pattern mode
    modes = ((False, kernels.attention_smem_bytes, "head-major"),
             (True, bwd_pattern, ""))
    for backward, need, window in modes:
        n = kernels.max_attention_n(Dh, optin, backward=backward,
                                    window=bool(window))
        assert n == 288
        assert need(n, Dh) <= optin
        kernels.check_attention_fits(n, Dh, optin, backward=backward,
                                     pattern=backward, window=window)
        with pytest.raises(ValueError, match=f"N={n + 1}, head dim 64"):
            kernels.check_attention_fits(n + 1, Dh, optin, backward=backward,
                                         pattern=backward, window=window)
    for backward, need, window in modes:
        small = need(150, Dh)
        n = kernels.max_attention_n(Dh, small, backward=backward,
                                    window=bool(window))
        assert need(n, Dh) <= small < need(n + 1, Dh) and n >= 150
        with pytest.raises(ValueError, match=f"N={n + 1}, head dim 64"):
            kernels.check_attention_fits(n + 1, Dh, small, backward=backward,
                                         pattern=backward, window=window)
    # the sequence modes on that card: the register form stops fitting
    # before 288, so every N up to the same n is taken, n + 1 is not
    small = kernels.attention_smem_bytes(150, Dh)
    n = kernels.max_attention_n(Dh, small)
    assert kernels.attention_smem_bytes(n, Dh) <= small < \
        kernels.attention_smem_bytes(n + 1, Dh) and 150 <= n < 288


def test_gemm_plain_emask_and_layernorm_bwd_hmask():
    """K1's epilogue multiplier sits after the bias and before the residual
    add; K5 with hmask returns the unmasked dres, the masked cotangent and
    its column sum (the proj / fc2 bias gradient)."""
    rng = np.random.default_rng(153)
    a, w, b, r = _np(rng, 6, 8), _np(rng, 4, 8), _np(rng, 4), _np(rng, 6, 4)
    e = ((rng.random((6, 4)) > 0.3) / 0.7).astype(np.float32)
    got = kernels.gemm(_t(a), _t(w), _t(b), residual=_t(r), emask=_t(e))
    np.testing.assert_allclose(got.numpy(), (a @ w.T + b) * e + r, atol=1e-5,
                               rtol=1e-5)
    res, g = _np(rng, 5, 12, std=2.0), _np(rng, 5, 12)
    gam = _np(rng, 12, std=0.1) + 1.0
    h = ((rng.random((5, 12)) > 0.2) / 0.8).astype(np.float32)
    plain = kernels.layernorm_bwd(_t(res), _t(gam), _t(g), 1e-12)
    masked = kernels.layernorm_bwd(_t(res), _t(gam), _t(g), 1e-12,
                                   hmask=_t(h))
    torch.testing.assert_close(masked[0], plain[0])
    torch.testing.assert_close(masked[1], plain[0] * _t(h))
    torch.testing.assert_close(masked[2:4], plain[2:4])
    torch.testing.assert_close(masked[4], (plain[0] * _t(h)).sum(0))


@pytest.mark.parametrize("M", [48, 37])
def test_mlp_ln_half_bwd(M):
    """``_mlp_ln_bwd_kernel`` (pallas_attn.py:2931) in interpret mode, as
    test_pallas_attn.py:898 runs it: all seven outputs; the port's weight
    grads are in its (out, in) layout."""
    rng = np.random.default_rng(120 + M)
    C, H = 32, 128
    x, g = _np(rng, M, C, std=0.5), _np(rng, M, C)
    w1, b1 = _np(rng, C, H, std=0.1), _np(rng, H, std=0.1)
    w2, b2 = _np(rng, H, C, std=0.1), _np(rng, C, std=0.1)
    lns = _np(rng, C, std=0.1) + 1.0
    m = jax.nn.gelu(jnp.asarray(x) @ w1 + b1, approximate=False)
    res = np.asarray(m @ w2 + b2 + x, np.float32)
    want = pa.mlp_ln_half_bwd(*(jnp.asarray(a) for a in (x, res, g)), None,
                              *(jnp.asarray(a) for a in (w1, b1, w2, lns)),
                              eps=1e-12, interpret=True)
    got = blocks.mlp_ln_half_bwd_plain(_t(x), _t(res), _t(g), None,
                                       _t(w1.T), _t(b1), _t(w2.T), _t(lns),
                                       1e-12)
    for name, gt, w in zip("dx dw1 db1 dw2 db2 dlns dlnb".split(), got, want):
        w = np.asarray(w)
        if name in ("dw1", "dw2"):
            w = w.T
        np.testing.assert_allclose(gt.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    # the hmask2 option (the fc2 output's dropout mask, a real one), as
    # ``_mlp_ln_bwd_stored`` passes it (pallas_attn.py:3123-3126)
    h = ((rng.random((M, C)) > 0.1) / 0.9).astype(np.float32)
    res = np.asarray((m @ w2 + b2) * h + x, np.float32)
    want = pa.mlp_ln_half_bwd(*(jnp.asarray(a) for a in (x, res, g, h)),
                              *(jnp.asarray(a) for a in (w1, b1, w2, lns)),
                              eps=1e-12, interpret=True)
    got = blocks.mlp_ln_half_bwd(_t(x), _t(res), _t(g), _t(h), _t(w1.T),
                                 _t(b1), _t(w2.T), _t(lns))
    for name, gt, w in zip("dx dw1 db1 dw2 db2 dlns dlnb".split(), got, want):
        w = np.asarray(w)
        if name in ("dw1", "dw2"):
            w = w.T
        np.testing.assert_allclose(gt.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"{name} with hmask")


def test_layernorm_bwd_plain_matches_jax_vjp():
    """K5's contract: dres, dgamma, dbeta and db = sum dres against
    ``jax.vjp`` of the kernels' ``_ln``."""
    rng = np.random.default_rng(130)
    M, C = 19, 40
    res, g = _np(rng, M, C, std=2.0) + 0.3, _np(rng, M, C)
    gam, bet = _np(rng, C, std=0.1) + 1.0, _np(rng, C, std=0.1)
    _, vjp = jax.vjp(lambda r, s, b: pa._ln(r, s, b, eps=1e-12),
                     jnp.asarray(res), jnp.asarray(gam), jnp.asarray(bet))
    dres, dgam, dbet = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    got = kernels.layernorm_bwd(_t(res), _t(gam), _t(g), 1e-12)
    for gt, w in zip(got, (dres, dres, dgam, dbet, dres.sum(0))):
        np.testing.assert_allclose(gt.numpy(), w, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(kernels.column_sum(_t(g)).numpy(), g.sum(0),
                               atol=1e-5, rtol=1e-5)


def test_gemm_plain_layouts_and_gelu_grad():
    """K1's backward modes on the plain version: ``nn``, ``tn``, the saved
    f32 pre-activation, the GELU-derivative epilogue (against ``jax.vjp``
    of the exact GELU) and an f32 residual into an f32 output."""
    rng = np.random.default_rng(131)
    a, w, b = _np(rng, 6, 8), _np(rng, 8, 5), _np(rng, 5)
    torch.testing.assert_close(kernels.gemm(_t(a), _t(w), layout="nn"),
                               _t(a @ w))
    torch.testing.assert_close(kernels.gemm(_t(a.T), _t(w), layout="tn"),
                               _t(a @ w))
    m, pre = kernels.gemm(_t(a), _t(w.T), _t(b), gelu=True, save_preact=True)
    torch.testing.assert_close(pre, _t(a @ w + b))
    dy = _np(rng, 6, 5)
    _, vjp = jax.vjp(lambda u: jax.nn.gelu(u, approximate=False),
                     jnp.asarray(a @ w + b))
    want = np.asarray(vjp(jnp.asarray(dy))[0])
    got = kernels.gemm(_t(dy), _t(np.eye(5, dtype=np.float32)), layout="nn",
                       gelu_grad=pre)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    r = _np(rng, 6, 5)
    got = kernels.gemm(_t(a).to(torch.bfloat16), _t(w).to(torch.bfloat16),
                       layout="nn", residual=_t(r), out_dtype=torch.float32)
    assert got.dtype == torch.float32
    want = (_t(a).to(torch.bfloat16).float() @ _t(w).to(torch.bfloat16).float()
            + _t(r))
    torch.testing.assert_close(got, want)


def _vjp_case(rng, half):
    """Inputs, cotangent and the JAX VJP of one fused half (interpret)."""
    B, N, C, nH = 3, 11, 32, 4
    x, gy = _np(rng, B, N, C, std=0.5), _np(rng, B, N, C)
    lns, lnb = _np(rng, C, std=0.1) + 1.0, _np(rng, C, std=0.1)
    if half == "attn":
        w = [_np(rng, C, 3 * C, std=0.1), _np(rng, 3 * C, std=0.1),
             _np(rng, C, C, std=0.1), _np(rng, C, std=0.1)]
        kb = np.where(np.arange(N)[None] < np.array([11, 6, 9])[:, None],
                      0.0, -10000.0).astype(np.float32)
        scale = (C // nH) ** -0.5
        fn = lambda x_, a, b, c, d, s, t: pa.fused_attn_ln(  # noqa: E731
            x_, a, b, c, d, jnp.asarray(kb), s, t, scale, nH, 1e-12,
            interpret=True)
        port = lambda p, x_, a, b, c, d, s, t: blocks.fused_attn_ln_plain(  # noqa: E731
            x_, a, b, c, d, _t(kb), s, t, scale, nH, 1e-12)
    else:
        w = [_np(rng, C, 4 * C, std=0.1), _np(rng, 4 * C, std=0.1),
             _np(rng, 4 * C, C, std=0.1), _np(rng, C, std=0.1)]
        fn = lambda x_, a, b, c, d, s, t: pa.fused_mlp_ln(  # noqa: E731
            x_, a, b, c, d, s, t, 1e-12, interpret=True)
        port = lambda p, x_, a, b, c, d, s, t: blocks.fused_mlp_ln_plain(  # noqa: E731
            x_, a, b, c, d, s, t, 1e-12)
    args = [x, *w, lns, lnb]
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return args, gy, np.asarray(out), [np.asarray(g) for g in vjp(
        jnp.asarray(gy))], port


@pytest.mark.parametrize("half", ["attn", "mlp"])
def test_fused_half_autograd_matches_jax_vjp(half):
    """With inputs that require grad, ``fused_attn_ln`` / ``fused_mlp_ln``
    run as autograd Functions (store-residual forward, K1/K4/K5 backward);
    output and every input gradient against ``jax.vjp`` of the JAX kernels
    in interpret mode (the custom VJPs ``_attn_ln_bwd_stored`` /
    ``_mlp_ln_bwd_stored``)."""
    rng = np.random.default_rng(140)
    args, gy, want_out, want, port = _vjp_case(rng, half)
    t = [_t(a).requires_grad_() for a in args]
    # dense weights in the port's (out, in) layout
    t_port = [t[0], t[1].t(), t[2], t[3].t(), t[4], t[5], t[6]]
    out = port(None, *t_port)
    out.backward(_t(gy))
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-4,
                               rtol=1e-4)
    for i, (tt, w) in enumerate(zip(t, want)):
        np.testing.assert_allclose(tt.grad.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"input {i}")


def _rows_args(rng, BW, N, C, nH, P):
    """Seeded arguments of rows 1, 6 and 19 in float32 (weights in the
    port's (out, in) layout)."""
    def t(*shape, std=1.0):
        return torch.from_numpy((rng.normal(size=shape) * std).astype(
            np.float32))
    x = t(BW, N, C)
    bias = t(P, nH, N, N, std=0.3)
    return {
        "window_block_attention": (
            blocks.window_block_attention,
            [x, t(3 * C, C, std=C ** -0.5), t(3 * C, std=0.1),
             t(C, C, std=C ** -0.5), t(C, std=0.1), bias],
            ((C // nH) ** -0.5, nH)),
        "fused_mlp_preln": (
            blocks.fused_mlp_preln,
            [x, t(C, std=0.1) + 1.0, t(C, std=0.1), t(4 * C, C, std=C ** -0.5),
             t(4 * C, std=0.1), t(C, 4 * C, std=(4 * C) ** -0.5),
             t(C, std=0.1)], ()),
        "attention_core": (
            blocks.attention_core, [t(BW, N, 3 * C, std=0.5), bias],
            ((C // nH) ** -0.5, nH)),
    }


@pytest.mark.parametrize("row", ["attention_core"])
@pytest.mark.parametrize("grad_arg", [0, -1])
def test_forward_without_vjp_refuses_autograd(row, grad_arg):
    """Row 19 has no VJP, in JAX or in the port (``attention_core_op`` is
    the differentiable form): under autograd it raises on every device,
    before any kernel runs (on the card the ctypes kernels would return
    outputs with no ``grad_fn``); with no gradient asked for, the same call
    runs. Rows 1 and 6 have their VJPs (tests/test_torch_swin_routes.py)."""
    rng = np.random.default_rng(91)
    fn, args, extra = _rows_args(rng, 2, 16, 16, 2, 1)[row]
    want = fn(*args, *extra)
    assert want.grad_fn is None and torch.isfinite(want).all()
    args[grad_arg].requires_grad_()
    with pytest.raises(NotImplementedError,
                       match="has no VJP, as in JAX: differentiate "
                             "attention_core_op"):
        fn(*args, *extra)
    with torch.no_grad():
        assert torch.equal(fn(*args, *extra), want)

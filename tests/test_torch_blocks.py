"""The port's six TPU-kernel counterparts (plain twins, as the CPU runs
them) against the JAX Pallas kernels in interpret mode, on the same inputs
drawn from a numpy seed.

float32: atol = rtol = 1e-4 (the same math; only summation order differs).
bfloat16: the port rounds the residual sum to bf16 where one kernel hands
it to the next, while the fused TPU kernel keeps it in f32 (see
``mvlt_tpu_torch/ops/blocks.py``); outputs are O(1), so the bar is
atol = 6e-2, rtol = 2e-2 (a few bf16 steps at the largest values).
"""

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

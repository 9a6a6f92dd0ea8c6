"""K2's tile plan and admission (pure Python, as the wrapper computes them
before a launch), the plain version at the sequence lengths the new tiling
admits (N = 221, 278: ViT-B/16 or the linear patch with BERT text) against
JAX's attention core, and the profiler's naming of the kernel.

The plain version is what every CPU test and the card's checks hold K2 to;
here it is held to ``mvlt_tpu.ops.pallas_attn._attend(..., fast=False)``
per (group, head) in float32, with the key bias and the seq2seq bias summed
into ``_attend``'s one bias: the same math, so 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.ops import pallas_attn as pa
from mvlt_tpu_torch import profile_step
from mvlt_tpu_torch.ops import kernels

torch.set_num_threads(2)


@pytest.mark.parametrize("N,Dh,tiles,chunks,cols,staged", [
    (49, 32, 1, 2, 32, True),      # Swin windows (every stage)
    (74, 64, 2, 3, 64, True),      # BERT, VQA question 23
    (131, 64, 3, 5, 64, True),     # the pretrain step, text 80
    (144, 32, 3, 5, 32, True),     # row 7: window 12
    (221, 64, 4, 7, 64, True),     # 196 image tokens, text 23
    (278, 64, 5, 9, 64, False),    # 196 image tokens, text 80
    (288, 64, 5, 9, 64, False),    # the cap
    (1, 16, 1, 1, 32, True),       # head dim 16 zero-padded to a 64-byte row
    (96, 48, 2, 3, 64, False),     # head dim 48 zero-padded to a 128-byte row
])
def test_attention_plan_tiles(N, Dh, tiles, chunks, cols, staged):
    """The register form: one warpgroup a block on 64 query rows, ceil(N /
    64) blocks a (group, head), ceil(N / 32) key chunks, rows of one swizzle
    width; shared memory q's 64 rows + k and v over whole chunks + 1024
    bytes of alignment, and with an amask its 64 rows of N bf16 + 16 bytes
    where that still leaves room for the blocks the register cap puts on an
    SM (not at N = 278: 82,944 + 35,600 bytes > 233,472 / 2 - 1,024). The
    plan gives it every N up to 160 and the window modes up to 288; the
    sequence modes at 221, 278 and 288 take the middle form (its own
    test)."""
    plan = kernels.attention_plan(N, Dh, "register")
    assert kernels.attention_plan(N, Dh).form == (
        "middle" if N >= kernels.ATTENTION_MID_MIN_N else "register")
    assert kernels.ATTENTION_ROWS == 64
    assert plan == kernels.AttentionPlan(tiles=tiles, key_chunks=chunks,
                                         head_cols=cols,
                                         smem=(64 + 64 * chunks) * cols * 2
                                         + 1024,
                                         mask_smem=(128 * N + 16) * staged)
    blocks = kernels.attention_min_blocks(chunks)
    assert (plan.smem + 128 * N + 16 <= 233472 // blocks - 1024) == staged
    assert kernels.attention_smem_bytes(N, Dh, form="register") == plan.smem
    assert kernels.attention_smem_bytes(N, Dh, amask=True,
                                        form="register") == \
        plan.smem + plan.mask_smem
    kernels.check_attention_fits(N, Dh, kernels.H100_SMEM_OPTIN, amask=True)
    assert plan.tiles * 64 >= N > (plan.tiles - 1) * 64
    assert plan.key_chunks * 32 >= N > (plan.key_chunks - 1) * 32
    kernels.check_attention_fits(N, Dh, kernels.H100_SMEM_OPTIN)


@pytest.mark.parametrize("Dh", [8, 24, 40, 72, 128, 0])
def test_attention_plan_refuses_head_dims(Dh):
    """The wgmma k16 steps cover one 64- or 128-byte row: head dims 16, 32,
    48 and 64 only; the refusal names the rule and happens before any
    launch (the wrapper plans first)."""
    with pytest.raises(ValueError, match=f"head dim {Dh} is not a multiple "
                                         "of 16 up to 64"):
        kernels.attention_plan(131, Dh)
    assert kernels.attention_smem_bytes(131, Dh) == -1
    with pytest.raises(ValueError, match="head dim"):
        kernels.check_attention_fits(131, Dh, kernels.H100_SMEM_OPTIN)


@pytest.mark.parametrize("N", [289, 300, 512, 0])
def test_attention_plan_refuses_n_beyond_the_cap(N):
    """N above 288 needs more than nine 32-key chunks of scores in
    registers: K2 takes it in its long form (128 query rows a block, the
    keys and their bias tiles streamed through a ring of 32-key chunks,
    shared memory the same at every N: 175,744 bytes at head dim 64,
    151,168 at 32), whose cap is N = 46,340 (32-bit i * N + j); it refuses
    N = 0 and N past that cap at every head dim."""
    cap = kernels.ATTENTION_LONG_MAX_N
    for Dh, smem in ((32, 151168), (64, 175744)):
        if N == 0:
            with pytest.raises(ValueError, match=f"N={N}, head dim {Dh}"):
                kernels.attention_plan(N, Dh)
            assert kernels.attention_smem_bytes(N, Dh) == -1
        else:
            plan = kernels.attention_plan(N, Dh)
            assert plan.form == "long" and plan.tiles == -(-N // 128)
            assert kernels.attention_smem_bytes(N, Dh) == smem
            assert kernels.attention_smem_bytes(N, Dh, amask=True) == smem
        with pytest.raises(ValueError, match=f"N={cap + 1}, head dim {Dh} "
                                             f"is beyond the kernel's N <= "
                                             f"{cap}"):
            kernels.attention_plan(cap + 1, Dh)
        assert kernels.attention_smem_bytes(cap + 1, Dh, amask=True) == -1
    assert kernels.max_attention_n(64) == kernels.max_attention_n(32) == cap
    assert kernels.max_attention_n(64, amask=True) == cap
    assert kernels.max_attention_n(64, window=True) == 288


def test_attention_layout_refusals():
    """The loader's 16-byte copies: q, k, v and ctx on 16-byte boundaries,
    strides multiples of 8 bf16 elements. The packed layout of BERT-base
    (strides N * 3C, Dh, 3C) and the head-major views of a Swin qkv
    product pass; an odd offset or stride is refused."""
    C, N = 768, 131
    base = 1 << 20
    ptrs = [base, base + 2 * C, base + 4 * C, base + 8 * C * 3 * N]
    kernels.check_attention_layout(ptrs, (N * 3 * C, 64, 3 * C))
    qkv = torch.empty(4, 49, 3 * 96, dtype=torch.bfloat16)
    q = qkv.view(4, 49, 3, 3, 32).permute(2, 0, 3, 1, 4)[0]
    kernels.check_attention_layout([base, base + 192, base + 384],
                                   q.stride()[:3])
    with pytest.raises(ValueError, match="16-byte boundaries"):
        kernels.check_attention_layout([base + 2] + ptrs[1:],
                                       (N * 3 * C, 64, 3 * C))
    with pytest.raises(ValueError, match="multiple of 8 elements"):
        kernels.check_attention_layout(ptrs, (N * 3 * 100, 20, 300))


def _jax_attention(qkv, nH, N, scale, kbias=None, qbias=None):
    """``_attend(fast=False)`` per (group, head) over fused rows (G*N, 3C),
    f32; ctx (G*N, C)."""
    rows, C3 = qkv.shape
    C, G = C3 // 3, rows // N
    Dh = C // nH
    t = qkv.reshape(G, N, 3, nH, Dh)
    ctx = np.zeros((G, N, nH, Dh), np.float32)
    for g in range(G):
        bias = np.zeros((N, N), np.float32)
        if kbias is not None:
            bias = bias + kbias[g][None, :]
        if qbias is not None:
            bias = bias + qbias[g]
        for h in range(nH):
            q, k, v = (jnp.asarray(t[g, :, i, h]) for i in range(3))
            ctx[g, :, h] = np.asarray(pa._attend(q, k, v, jnp.asarray(bias),
                                                 False, scale))
    return ctx.reshape(rows, C)


@pytest.mark.parametrize("N", [221, 278])
@pytest.mark.parametrize("mode", ["key bias", "seq2seq"])
def test_plain_attention_at_long_n_matches_jax(N, mode):
    """``biased_attention_plain`` at the S of a 196-token image with BERT
    text (23 or 80 tokens), with a padded key bias or the seq2seq mask
    (bidirectional over the 1 + 196 + 1 image positions, causal over the
    text), against JAX's interpret-path core in float32."""
    rng = np.random.default_rng(N + len(mode))
    G, nH, Dh = 2, 2, 16
    qkv = (rng.normal(size=(G * N, 3 * nH * Dh)) * 0.5).astype(np.float32)
    scale = Dh ** -0.5
    kbias = qbias = None
    if mode == "key bias":
        lengths = np.array([N, N - 37])
        kbias = np.where(np.arange(N)[None] < lengths[:, None], 0.0,
                         -10000.0).astype(np.float32)
    else:
        img = 1 + 196 + 1
        allowed = np.tril(np.ones((N, N), bool))
        allowed[:, :img] = True
        allowed[:img, img:] = False
        qbias = np.broadcast_to(np.where(allowed, 0.0, -10000.0),
                                (G, N, N)).astype(np.float32)
    got = kernels.biased_attention_plain(
        torch.from_numpy(qkv), nH, N, scale,
        key_bias=None if kbias is None else torch.from_numpy(kbias),
        qbias=None if qbias is None else torch.from_numpy(qbias))
    want = _jax_attention(qkv, nH, N, scale, kbias, qbias)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # the CPU wrapper is the plain version
    again = kernels.biased_attention(
        torch.from_numpy(qkv), nH, N, scale,
        key_bias=None if kbias is None else torch.from_numpy(kbias),
        qbias=None if qbias is None else torch.from_numpy(qbias))
    assert torch.equal(again, got)


@pytest.mark.parametrize("symbol", [
    "void (anonymous namespace)::attention_wgmma_kernel<5, 64>("
    "(anonymous namespace)::Params)",
    "void (anonymous namespace)::attention_wgmma_kernel<2, 32>("
    "(anonymous namespace)::Params)",
    "void (anonymous namespace)::attention_long_kernel<64>("
    "(anonymous namespace)::Params)",
    "void (anonymous namespace)::attention_mid_kernel<9, 64>(CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Params)",
    "void (anonymous namespace)::attention_mid_kernel<6, 32>(CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Params)",
])
def test_profile_family_names_the_new_kernel(symbol):
    """``profile_step`` files every instance of the wgmma kernel, the middle
    form's and the long form's under K2, and K4's kernels stay K4's."""
    assert profile_step.family(symbol) == "K2 biased_attention"
    assert profile_step.family(
        "void (anonymous namespace)::attention_bwd_dq_kernel<5, 64>(...)") \
        == "K4 biased_attention_bwd"
    assert profile_step.family(
        "void (anonymous namespace)::attention_bwd_dq_mid_kernel<9, 64>(...)"
    ) == "K4 biased_attention_bwd"


# the forms of each fusion length a path runs, K2's and K4's (with an
# amask: the paths' training steps with dropout): the VQA question (74) and
# the pretrain / retrieval text (131) in the register form; the two-view
# caption / retrieval steps (180), the caption step (201) and ViT-B/16 or
# the linear patch with 23 / 80 text tokens (221 / 278) in K2's middle
# form, which beat the register and long forms there on the card in every
# mode (PERF.md, Findings), and K4's long form, but for the middle form with
# an amask at odd N (the caption step's 201; 221 with dropout); past 288
# (298, 348, two views' 474) the long form
PATH_FORMS = {74: ("register",) * 3, 131: ("register",) * 3,
              180: ("middle", "long", "long"),
              201: ("middle", "long", "middle"),
              221: ("middle", "long", "middle"),
              278: ("middle", "long", "long"),
              298: ("long",) * 3, 348: ("long",) * 3, 474: ("long",) * 3}
WINDOW_MODES = (dict(window="pattern"), dict(window="stored p"),
                dict(window="head-major"), dict(backward=True, pattern=True),
                dict(backward=True, window="stored p"))


@pytest.mark.parametrize("Dh", [32, 64])
@pytest.mark.parametrize("N", range(1, 475))
def test_attention_form_at_every_n(N, Dh):
    """The forms K2 and K4 take N in, through the fusion's lengths: the
    register form up to ``ATTENTION_MID_MIN_N - 1``; K2's middle form to
    288, K4's where an amask's rows start 2 bytes off 4 (odd N) and its long
    form otherwise; the long form past 288; in both kernels' plans and at
    each path length as PATH_FORMS says; every form's shared memory within
    the 232,448 bytes an H100 block may opt in to, with and without an
    amask; the window modes in the register form up to 288 and refused past
    it (where the plan would take the long form), never in the middle
    form."""
    mid = kernels.ATTENTION_MID_MIN_N <= N <= kernels.ATTENTION_MAX_N
    reg = N < kernels.ATTENTION_MID_MIN_N
    forms = (kernels.attention_form(N),
             kernels.attention_form(N, backward=True),
             kernels.attention_form(N, backward=True, amask=True))
    assert forms == ("register" if reg else "middle" if mid else "long",
                     "register" if reg else "long",
                     "register" if reg else
                     "middle" if mid and N % 2 else "long")
    assert kernels.attention_form(N, amask=True) == forms[0]
    assert kernels.attention_plan(N, Dh).form == forms[0]
    assert kernels.attention_bwd_plan(N, Dh).form == forms[1]
    assert PATH_FORMS.get(N, forms) == forms
    optin = kernels.H100_SMEM_OPTIN
    for amask in (False, True):
        assert 0 < kernels.attention_smem_bytes(N, Dh, amask) <= optin
        assert 0 < kernels.attention_bwd_smem_bytes(N, Dh, amask=amask) <= \
            optin
        assert kernels.check_attention_fits(
            N, Dh, optin, amask=amask).form == forms[0]
        assert kernels.check_attention_fits(
            N, Dh, optin, backward=True, amask=amask).form == forms[1 + amask]
    assert kernels.attention_form(N, window=True) == (
        "register" if N <= kernels.ATTENTION_MAX_N else "long")
    for kw in WINDOW_MODES:
        if N <= kernels.ATTENTION_MAX_N:
            assert kernels.check_attention_fits(N, Dh, optin,
                                                **kw).form == "register"
        else:
            with pytest.raises(ValueError, match="register-resident"):
                kernels.check_attention_fits(N, Dh, optin, **kw)
        with pytest.raises(ValueError):   # no window mode in the middle form
            kernels.check_attention_fits(N, Dh, optin, form="middle", **kw)

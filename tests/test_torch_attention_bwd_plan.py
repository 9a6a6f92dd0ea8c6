"""K4's tile plan and admission (pure Python, as the wrapper computes them
before a launch), the plain version at the sequence lengths the new plan
admits (N = 221, 278: ViT-B/16 or the linear patch with BERT text) against
JAX's ``seq_attention_core_bwd``, and the profiler's naming of K4's
kernels.

The plain version is what every CPU test and the card's checks hold K4 to;
here it is held to ``mvlt_tpu.ops.pallas_attn.seq_attention_core_bwd`` in
interpret mode (``_seq_core_bwd_kernel``'s f32 path) on the same float32
inputs: the same math, so 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.ops import pallas_attn as pa
from mvlt_tpu_torch import profile_step
from mvlt_tpu_torch.ops import kernels

torch.set_num_threads(2)


@pytest.mark.parametrize("N,Dh,tiles,chunks,cols", [
    (49, 32, 1, 2, 32),        # Swin windows (every stage)
    (74, 64, 2, 3, 64),        # BERT, VQA question 23
    (131, 64, 3, 5, 64),       # the pretrain step, text 80
    (221, 64, 4, 7, 64),       # 196 image tokens, text 23
    (278, 64, 5, 9, 64),       # 196 image tokens, text 80
    (288, 64, 5, 9, 64),       # the cap
    (1, 16, 1, 1, 32),         # head dim 16 zero-padded to a 64-byte row
    (96, 48, 2, 3, 64),        # head dim 48 zero-padded to a 128-byte row
])
def test_attention_bwd_plan_tiles(N, Dh, tiles, chunks, cols):
    """The register form (the plan's up to N = 160 and in the pattern and
    stored-p modes up to 288; the sequence modes at 221, 278 and 288 take
    the long form or, with an amask at odd N, the middle form,
    :func:`test_middle_form_plans`): two passes of one warpgroup a block,
    ceil(N / 64) blocks of each per (group, head): pass 1 on 64 query rows
    against ceil(N / 32) key chunks (q's and dctx's 64 rows, k and v over
    whole chunks, 1024 bytes of alignment; with an amask its 64 rows of N
    bf16 + 16 bytes where the register cap's blocks still fit an SM, as K2
    stages them), pass 2 on 64
    keys against every query chunk (the same rows plus each query's row
    max, row sum, its reciprocal, rowsum(p * dp) and two keep words), and
    in pattern mode 64 keys x the queries in f32 more; the scratch holds
    three statistics and one keep word per 32 keys for each query. Shared
    memory grows with N Dh (and N for the mask rows), never N^2, and fits
    the card at every N up to 288."""
    plan = kernels.attention_bwd_plan(N, Dh, "register")
    assert kernels.attention_bwd_plan(N, Dh).form == \
        kernels.attention_form(N, backward=True)
    rows = 32 * chunks
    dq = (128 + 2 * rows) * cols * 2 + 1024
    blocks = kernels.attention_bwd_min_blocks(chunks)
    staged = dq + 128 * N + 16 <= 233472 // blocks - 1024
    assert plan == kernels.AttentionBwdPlan(
        tiles=tiles, chunks=chunks, head_cols=cols, dq_smem=dq,
        dkv_smem=dq + 24 * rows, mask_smem=(128 * N + 16) * staged,
        pattern_smem=256 * rows, scratch_words=3 * N + N * chunks)
    assert staged == (N <= 221)     # at N = 278, 288: read score by score
    assert kernels.attention_bwd_smem_bytes(N, Dh, amask=True,
                                            form="register") == max(
        dq + plan.mask_smem, plan.dkv_smem)
    assert plan.tiles * 64 >= N > (plan.tiles - 1) * 64
    assert plan.chunks * 32 >= N > (plan.chunks - 1) * 32
    assert kernels.attention_bwd_smem_bytes(N, Dh, form="register") == \
        plan.dkv_smem
    assert kernels.attention_bwd_smem_bytes(N, Dh, pattern=True) == \
        plan.dkv_smem + plan.pattern_smem <= kernels.H100_SMEM_OPTIN
    for pattern in (False, True):
        kernels.check_attention_fits(N, Dh, kernels.H100_SMEM_OPTIN,
                                     backward=True, pattern=pattern)
    # every K4 call follows a K2 forward of the same shape and form: the
    # same tiles
    fwd = kernels.attention_plan(N, Dh, "register")
    assert (fwd.tiles, fwd.key_chunks, fwd.head_cols) == (tiles, chunks, cols)


def test_attention_bwd_plan_at_the_path_shapes():
    """The shared memory of the shapes the paths run: Swin windows (N 49,
    head dim 32) in pattern mode, 35,328 bytes, room for six blocks an SM;
    BERT at N 74 and 131 (head dim 64), 44,288 and 62,208 bytes; S 221 and
    278 in the register form 80,128 and 98,048 bytes (the scalar K4 needed
    509,184 and 767,280 there, beyond the card); in the middle form,
    which the plan gives 221 with an amask, 198,016 and 215,424 (its first
    pass: q's and dctx's 128 rows, k and v whole, five ring stages); in
    the long form, which it gives them otherwise, 192,128."""
    want = {(49, 32, True, None): 35328, (74, 64, False, None): 44288,
            (131, 64, False, None): 62208,
            (221, 64, False, "register"): 80128,
            (278, 64, False, "register"): 98048,
            (221, 64, False, "middle"): 198016,
            (278, 64, False, "middle"): 215424,
            (221, 64, False, None): 192128, (278, 64, False, None): 192128}
    for (N, Dh, pattern, form), smem in want.items():
        assert kernels.attention_bwd_smem_bytes(N, Dh, pattern,
                                                form=form) == smem
    assert kernels.attention_bwd_smem_bytes(221, 64, amask=True) == 198016
    assert 6 * (35328 + 1024) <= kernels.H100_SMEM_SM
    assert kernels.max_attention_n(64, backward=True) == 288
    assert kernels.max_attention_n(32, backward=True) == 288


@pytest.mark.parametrize("N", [161, 180, 192, 201, 221, 256, 278, 288])
@pytest.mark.parametrize("Dh", [16, 32, 48, 64])
def test_middle_form_plans(N, Dh):
    """The middle form (160 < N <= 288, the sequence modes) is the long
    form's block, 128 rows on two consumer warpgroups and a producer, one
    block an SM, ceil(N / 128) blocks a (group, head), with k and v whole
    in shared memory and one sweep of S: a K2 block holds 1024 bytes of
    alignment slack, q's 128 rows, k and v over whole 32-key chunks, five
    ring stages of 20,608 bytes (a qbias tile of 128 rows at 160 bytes and
    32 key-bias f32, or an amask tile), a keep word per row and chunk and
    256 bytes of mbarriers; K4's first pass the same with dctx's 128 rows
    beside q's, its second pass the long form's, with 9 bytes more a query
    row of each of its four stages for an amask at odd N (rows of 272
    bytes, each row's shift).
    Every one fits an H100 block, and the window modes refuse it."""
    cols = 32 if Dh <= 32 else 64
    chunks = -(-N // 32)
    ring = 5 * (128 * 160 + 32 * 4)
    fwd = kernels.attention_plan(N, Dh, "middle")
    assert fwd == kernels.AttentionPlan(
        tiles=-(-N // 128), key_chunks=chunks, head_cols=cols,
        smem=1024 + (128 + 64 * chunks) * cols * 2 + ring + chunks * 512
        + 256, mask_smem=0, form="middle")
    bwd = kernels.attention_bwd_plan(N, Dh, "middle")
    assert bwd == kernels.AttentionBwdPlan(
        tiles=-(-N // 128), chunks=chunks, head_cols=cols,
        dq_smem=fwd.smem + 128 * cols * 2,
        dkv_smem=kernels.attention_bwd_plan(474, Dh).dkv_smem + 4 * 32 * 9,
        mask_smem=0,
        pattern_smem=0, scratch_words=3 * N + N * chunks, form="middle")
    for plan in (fwd, bwd):
        assert (plan.rows, plan.stages, plan.sm_blocks) == (128, 5, 1)
    assert bwd.sweeps == 1
    assert max(fwd.smem, bwd.dq_smem, bwd.dkv_smem) <= kernels.H100_SMEM_OPTIN
    for amask in (False, True):
        assert kernels.attention_smem_bytes(N, Dh, amask, "middle") == fwd.smem
        assert kernels.attention_bwd_smem_bytes(N, Dh, amask=amask,
                                                form="middle") == \
            max(bwd.dq_smem, bwd.dkv_smem)
    assert kernels.attention_bwd_smem_bytes(N, Dh, pattern=True,
                                            form="middle") == -1
    with pytest.raises(ValueError, match="the middle form takes 161"):
        kernels.attention_plan(160, Dh, "middle")
    with pytest.raises(ValueError, match="the middle form takes 161"):
        kernels.attention_bwd_plan(289, Dh, "middle")


@pytest.mark.parametrize("N,Dh", [(289, 64), (289, 32), (300, 16), (0, 64),
                                  (131, 24), (49, 8), (74, 72), (74, 128)])
def test_attention_bwd_plan_refuses(N, Dh):
    """N = 0 and head dims other than 16, 32, 48 and 64 are refused before
    any launch, with a message naming N and the head dim. N above 288 (past
    nine 32-key chunks of scores in pass 1's registers) takes the long
    form, whose shared memory is the same at every N (its first pass's,
    the larger: 192,128 bytes at head dim 64, 159,360 at 16 / 32), in the
    sequence modes only: its pattern mode and its stored-p mode are
    refused, naming the mode."""
    if N > kernels.ATTENTION_MAX_N and Dh in (16, 32, 48, 64):
        plan = kernels.attention_bwd_plan(N, Dh)
        assert plan.form == "long"
        assert plan.pattern_smem == plan.mask_smem == 0
        smem = 192128 if Dh > 32 else 159360
        assert kernels.attention_bwd_smem_bytes(N, Dh) == smem
        assert kernels.attention_bwd_smem_bytes(N, Dh, amask=True) == smem
        assert kernels.attention_bwd_smem_bytes(N, Dh, pattern=True) == -1
        kernels.check_attention_fits(N, Dh, kernels.H100_SMEM_OPTIN,
                                     backward=True, amask=True)
        for kw, mode in ((dict(pattern=True), "pattern"),
                         (dict(window="stored p"), "stored p")):
            with pytest.raises(ValueError, match=f"N={N}, head dim {Dh}: "
                                                 f"the {mode} mode"):
                kernels.check_attention_fits(N, Dh, kernels.H100_SMEM_OPTIN,
                                             backward=True, **kw)
        return
    with pytest.raises(ValueError, match=f"N={N}, head dim {Dh}"):
        kernels.attention_bwd_plan(N, Dh)
    assert kernels.attention_bwd_smem_bytes(N, Dh) == -1
    assert kernels.attention_bwd_smem_bytes(N, Dh, pattern=True) == -1
    with pytest.raises(ValueError, match=f"N={N}, head dim {Dh}"):
        kernels.check_attention_fits(N, Dh, kernels.H100_SMEM_OPTIN,
                                     backward=True)


@pytest.mark.parametrize("symbol", [
    "void (anonymous namespace)::attention_bwd_dq_kernel<5, 64>("
    "(anonymous namespace)::Params)",
    "void (anonymous namespace)::attention_bwd_dq_kernel<2, 32>("
    "(anonymous namespace)::Params)",
    "void (anonymous namespace)::attention_bwd_dkv_kernel<64>("
    "(anonymous namespace)::Params)",
    "void (anonymous namespace)::attention_bwd_dkv_kernel<32>("
    "(anonymous namespace)::Params)",
    "void (anonymous namespace)::attention_bwd_dq_long_kernel<64>("
    "(anonymous namespace)::Params)",
    "void (anonymous namespace)::attention_bwd_dkv_long_kernel<32>("
    "(anonymous namespace)::Params)",
    "void (anonymous namespace)::attention_bwd_dq_mid_kernel<9, 64>("
    "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Params)",
    "void (anonymous namespace)::attention_bwd_dq_mid_kernel<6, 32>("
    "CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Params)",
    "(anonymous namespace)::sum_heads_kernel(const float *, float *, int, "
    "int, int)",
    "(anonymous namespace)::sum_chunks_kernel(const float *, float *, int, "
    "unsigned long)",
])
def test_profile_family_names_k4_kernels(symbol):
    """``profile_step`` files both passes of K4 in each form (the middle
    form's first pass among them) and its two fixed-order sums under K4
    (else their time would fall into "other"), and none of them under
    K2."""
    assert profile_step.family(symbol) == "K4 biased_attention_bwd"


def _attention_vjp_f64(qkv, dctx, nH, scale, kbias, qbias):
    """The VJP of softmax(q k^T scale + kbias + qbias) v in float64 numpy:
    (dqkv (G, N, 3C), dkbias (G, N), the column sum of ds over rows and
    heads)."""
    G, N, C3 = qkv.shape
    Dh = C3 // 3 // nH
    t = qkv.astype(np.float64).reshape(G, N, 3, nH, Dh).transpose(2, 0, 3, 1, 4)
    q, k, v = t[0] * scale, t[1], t[2]
    dc = dctx.astype(np.float64).reshape(G, N, nH, Dh).transpose(0, 2, 1, 3)
    s = q @ k.transpose(0, 1, 3, 2) + kbias[:, None, None, :]
    if qbias is not None:
        s = s + qbias[:, None]
    e = np.exp(s - s.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    dp = dc @ v.transpose(0, 1, 3, 2)
    ds = p * (dp - (p * dp).sum(-1, keepdims=True))
    dq, dk = (ds @ k) * scale, ds.transpose(0, 1, 3, 2) @ q
    dv = p.transpose(0, 1, 3, 2) @ dc
    dqkv = np.stack([dq, dk, dv]).transpose(1, 3, 0, 2, 4).reshape(G, N, C3)
    return dqkv, ds.sum(axis=(1, 2))


@pytest.mark.parametrize("N", [221, 278])
@pytest.mark.parametrize("mode", ["key bias", "seq2seq"])
def test_plain_attention_bwd_at_long_n_matches_jax(N, mode):
    """``biased_attention_bwd_plain`` at the S of a 196-token image with
    BERT text (23 or 80 tokens), with a padded key bias or the seq2seq mask
    (bidirectional over the 1 + 196 + 1 image positions, causal over the
    text; the port passes no key bias there, JAX zeros), and JAX's
    ``seq_attention_core_bwd`` in interpret mode in float32, each held to a
    float64 numpy VJP of the same inputs: dqkv and dkbias. The port's plain
    version runs in float64, so that neither side's float32 sum order (the
    CPU matmuls' order varies with the process's history) meets the
    other's: each float32 result stands alone against the exact one."""
    rng = np.random.default_rng(N + 7 * len(mode))
    G, nH, Dh = 2, 2, 16
    C = nH * Dh
    qkv = (rng.normal(size=(G, N, 3 * C)) * 0.5).astype(np.float32)
    dctx = rng.normal(size=(G, N, C)).astype(np.float32)
    scale = Dh ** -0.5
    kbias = np.zeros((G, N), np.float32)
    qbias = None
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
                                (G, N, N)).astype(np.float32).copy()
    exact = _attention_vjp_f64(qkv, dctx, nH, scale, kbias, qbias)
    jax_out = pa.seq_attention_core_bwd(
        jnp.asarray(qkv), jnp.asarray(dctx), jnp.asarray(kbias),
        None if qbias is None else jnp.asarray(qbias), None, scale, nH,
        interpret=True)
    f64 = lambda a: torch.from_numpy(a.astype(np.float64))  # noqa: E731
    args = (f64(qkv.reshape(G * N, 3 * C)), f64(dctx.reshape(G * N, C)), nH,
            N, scale, None if qbias is not None else f64(kbias),
            None if qbias is None else f64(qbias))
    got = kernels.biased_attention_bwd_plain(*args)
    assert got[0].dtype == got[1].dtype == torch.float64
    for what, out in (("port, float64", [got[0].numpy().reshape(G, N, 3 * C),
                                         got[1].numpy()]),
                      ("JAX, float32", [np.asarray(a) for a in jax_out])):
        for name, a, want in zip(("dqkv", "dkbias"), out, exact):
            np.testing.assert_allclose(a, want, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{what} {name}")
    # the CPU wrapper is the plain version
    again = kernels.biased_attention_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, got))

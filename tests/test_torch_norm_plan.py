"""K3's and K5's launch plans (pure Python, as the wrappers compute them
before a launch), K5's ``dres=False`` contract on the plain version against
JAX's ``jax.vjp`` of the kernels' ``_ln``, and the profiler's naming of the
K3 / K5 kernels.

The plans are what the wrappers allocate from and what ``csrc/norm.cuh``,
``csrc/layernorm.cu`` and ``csrc/layernorm_bwd.cu`` compute again (the card's
``chip_smoke.py`` holds the two equal over a sweep). Here they must cover
every row and every column of an input exactly once, with the partial sums
within their cap, at the shapes the paths run and at ragged ones."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.ops import pallas_attn as pa
from mvlt_tpu_torch import profile_step
from mvlt_tpu_torch.ops import kernels

torch.set_num_threads(2)

ROWS = [1, 7, 49, 4192, 6272, 100352]
WIDTHS = [36, 96, 100, 384, 768, 1024, 3072]


def _row_columns(plan, C):
    """The columns each (group lane, chunk) of a row plan owns: lane l of
    the group holds chunks j * lanes + l, each 8 columns, those < C."""
    owned = []
    for lane in range(plan.lanes):
        for j in range(plan.chunks):
            q = j * plan.lanes + lane
            owned.extend(c for c in range(8 * q, 8 * q + 8) if c < C)
    return owned


@pytest.mark.parametrize("C", WIDTHS)
@pytest.mark.parametrize("M", ROWS)
def test_norm_plans_cover_every_row_and_column_once(M, C):
    """K5's VJP plan: each row's columns are owned once within its lane
    group, and the persistent blocks' passes (block b takes b, b + blocks,
    ...) cover rows 0 .. M-1 once, with at most the register cap's blocks
    an SM (the partial rows of the scratch). K3's plan: one row group per
    row, ceil(M / rows_per_block) blocks. ``column_sum``: the strips cover
    the columns once, the runs of rows cover the rows once and none is
    empty, the grid within one wave of four blocks an SM. Widths beyond a cap
    (K5 1024, K3 2048) are refused before any launch."""
    sms = kernels.H100_SMS
    if C > kernels.LAYERNORM_BWD_MAX_C:
        with pytest.raises(ValueError, match=f"C={C}"):
            kernels.layernorm_bwd_plan(M, C, sms)
    else:
        p = kernels.layernorm_bwd_plan(M, C, sms)
        assert sorted(_row_columns(p, C)) == list(range(C))
        assert p.lanes in (1, 2, 4, 8, 16, 32) and 1 <= p.chunks <= 4
        assert p.rows_per_block == kernels.NORM_WARPS * 32 // p.lanes
        assert p.vec == (C % 8 == 0)
        assert p.passes == -(-M // p.rows_per_block)
        cap = kernels.ln_bwd_blocks_per_sm(p.chunks) * sms
        assert 1 <= p.blocks <= min(cap, p.passes)
        assert p.scratch == (p.blocks, 3 * C)
        seen = np.zeros(M, np.int64)
        for b in range(p.blocks):
            for pas in range(b, p.passes, p.blocks):
                lo = pas * p.rows_per_block
                seen[lo:min(M, lo + p.rows_per_block)] += 1
        assert (seen == 1).all()
    if C > kernels.LAYERNORM_MAX_C:
        with pytest.raises(ValueError, match=f"C={C}"):
            kernels.layernorm_plan(M, C)
    else:
        p3 = kernels.layernorm_plan(M, C)
        assert sorted(_row_columns(p3, C)) == list(range(C))
        assert p3.blocks * p3.rows_per_block >= M > (p3.blocks - 1) * \
            p3.rows_per_block
    N = C
    q = kernels.column_sum_plan(M, N, sms)
    chunks = -(-N // 8)
    assert q.strips * q.strip_chunks == chunks and q.strip_chunks <= 32
    assert q.strip_chunks & (q.strip_chunks - 1) == 0
    starts = [k * q.rows for k in range(q.row_chunks)]
    assert starts[-1] < M <= q.row_chunks * q.rows      # none empty, all rows
    wave = kernels.COLSUM_BLOCKS_PER_SM * sms
    assert q.strips * q.row_chunks <= max(wave, q.strips)      # one wave
    assert q.scratch == (q.row_chunks, N) and q.vec == (N % 8 == 0)


def test_norm_plans_at_the_step_shapes():
    """At the Swin-S step's shapes (b32) and the fusion's (B*S = 32*131):
    K5's VJP takes 3 blocks an SM (396 partial rows, where the former grid
    left 1056 at stages 1-2) and lays C = 96 / 384 / 768 as 8 / 2 / 1 rows a
    warp with no idle slot; ``column_sum`` fills one wave of 4 blocks an
    SM to within one run of rows (a grid one block past it, as the dqkv
    sums' 9 strips x 59 runs were, runs that block alone after the rest)."""
    for M, C, lanes in ((100352, 96, 4), (6272, 384, 16), (4192, 768, 32)):
        p = kernels.layernorm_bwd_plan(M, C)
        assert (p.lanes, p.chunks, p.blocks) == (lanes, 3, 396)
        assert p.lanes * p.chunks * 8 == C
    for M, N in ((100352, 384), (100352, 288), (6272, 1536), (4192, 2304),
                 (4192, 3072), (100352, 96)):
        q = kernels.column_sum_plan(M, N)
        wave = 4 * kernels.H100_SMS
        assert wave - q.strips < q.strips * q.row_chunks <= wave
        assert q.strip_chunks * 8 * q.strips == N


@pytest.mark.parametrize("mode", ["plain", "hmask", "preln"])
def test_layernorm_bwd_without_dres_matches_full_and_jax(mode):
    """``dres=False`` returns None in dres's place and the other four
    outputs of the full call unchanged; those match ``jax.vjp`` of
    ``pallas_attn._ln`` (f32, 1e-5): da = (dres + gres) * hmask * scale and
    its column sum, dgamma, dbeta."""
    rng = np.random.default_rng({"plain": 1, "hmask": 2, "preln": 3}[mode])
    M, C = 24, 40
    res = (rng.normal(size=(M, C)) * 2.0 + 0.3).astype(np.float32)
    g = rng.normal(size=(M, C)).astype(np.float32)
    gam = (rng.normal(size=C) * 0.1 + 1.0).astype(np.float32)
    bet = (rng.normal(size=C) * 0.1).astype(np.float32)
    kw, hm, gres, scale = {}, np.ones((M, C), np.float32), 0.0, np.ones(M)
    if mode == "hmask":
        hm = ((rng.random((M, C)) > 0.2) / 0.8).astype(np.float32)
        kw["hmask"] = torch.from_numpy(hm)
    if mode == "preln":
        gres = rng.normal(size=(M, C)).astype(np.float32)
        s = np.array([0.0, 1.25, 1.25, 1.25], np.float32)
        scale = np.repeat(s, M // 4)
        kw.update(gres=torch.from_numpy(gres), row_scale=torch.from_numpy(s))
    args = (torch.from_numpy(res), torch.from_numpy(gam), torch.from_numpy(g),
            1e-12)
    full = kernels.layernorm_bwd_plain(*args, **kw)
    part = kernels.layernorm_bwd_plain(*args, dres=False, **kw)
    assert part[0] is None and full[0] is not None
    for a, b in zip(part[1:], full[1:]):
        assert torch.equal(a, b)
    # the CPU wrapper is the plain version, dres=False included
    wrapped = kernels.layernorm_bwd(*args, dres=False, **kw)
    assert wrapped[0] is None
    assert all(torch.equal(a, b) for a, b in zip(wrapped[1:], part[1:]))
    _, vjp = jax.vjp(lambda r, s_, b_: pa._ln(r, s_, b_, eps=1e-12),
                     jnp.asarray(res), jnp.asarray(gam), jnp.asarray(bet))
    dres, dgam, dbet = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    da = (dres + gres) * hm * scale[:, None]
    for got, want in zip(part[1:], (da, dgam, dbet, da.sum(0))):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("symbol,fam", [
    ("void (anonymous namespace)::ln_bwd_kernel<4, 3>((anonymous "
     "namespace)::LnBwd)", "K5 layernorm_bwd"),
    ("void (anonymous namespace)::ln_bwd_kernel<32, 3>((anonymous "
     "namespace)::LnBwd)", "K5 layernorm_bwd"),
    ("(anonymous namespace)::colsum_kernel(const void *, int, const float *, "
     "__nv_bfloat16 *, float *, int, int, int, int, int, int)",
     "K5 column_sum"),
    ("(anonymous namespace)::fold_kernel(const float *, float *, int, int)",
     "K5 partial-sum fold"),
    ("void (anonymous namespace)::layernorm_kernel<16, 3>(const void *, int, "
     "const int *, const float *, const float *, __nv_bfloat16 *, int, int, "
     "float, int)", "K3 layernorm"),
    ("void (anonymous namespace)::gemm_fold_kernel(float const*, int)",
     "K1 gemm"),
])
def test_profile_family_names_norm_kernels(symbol, fam):
    """``profile_step`` files K5's three kernels and K3's instances under
    their families (else their time would fall into "other"), and K1's
    split-K fold stays K1's."""
    assert profile_step.family(symbol) == fam

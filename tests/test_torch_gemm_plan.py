"""K1's split-K plan (``kernels.gemm_plan``) and the fold it stands for, on
the CPU: the slices cover the contraction once, in order, in whole k-tiles;
a product is split only when it has no epilogue and its output tiles fill
at most half the card (so the BERT products stay whole and the Swin-S
stage-1 weight gradients fill a wave); and summing the plain product over
the slices in slice order, as ``csrc/gemm.cu``'s fold does, gives the
product over the whole contraction (f32: 1e-5 relative, the same sums in
another order) and JAX's ``jnp.dot``. Also ``profile_step``'s attribution of
K1's kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu_torch import profile_step
from mvlt_tpu_torch.ops import kernels

torch.set_num_threads(2)

SMS = kernels.H100_SMS
# Swin-S b32: rows per stage and channels (stage 1: 32 * 56 * 56 rows)
SWIN_STAGES = [(32 * 56 * 56, 96), (32 * 28 * 28, 192), (32 * 14 * 14, 384),
               (32 * 7 * 7, 768)]


def _weight_grads(C):
    """(M, N) outputs of the four weight gradients of a Swin block: dW2
    (C, 4C), dW1 (4C, C), dWqkv (3C, C), dWproj (C, C)."""
    return [(C, 4 * C), (4 * C, C), (3 * C, C), (C, C)]


def _tiles(M, N):
    return -(-M // kernels.GEMM_TILE_M) * -(-N // kernels.GEMM_TILE_N)


@pytest.mark.parametrize("M,N,K", [
    (96, 96, 100352), (384, 96, 100352), (1536, 384, 6272), (768, 768, 4192),
    (96, 136, 3000), (24, 16, 1000), (64, 64, 257), (4192, 768, 768),
    (8, 8, 64 * 4 * 132 + 1)])
def test_plan_slices_cover_k_once_in_order(M, N, K):
    plan = kernels.gemm_plan(M, N, K, SMS)
    tk = kernels.GEMM_TILE_K
    assert plan.splits == len(plan.slices) >= 1
    assert plan.slices[0][0] == 0 and plan.slices[-1][1] == K
    for (b0, e0), (b1, _) in zip(plan.slices, plan.slices[1:]):
        assert e0 == b1                       # contiguous, in order
        assert b0 % tk == 0 and e0 % tk == 0 and e0 > b0
    last = plan.slices[-1]
    assert last[1] > last[0] and last[0] % tk == 0
    if plan.splits > 1:
        # every slice at least SPLITK_MIN_KTILES k-tiles, the last maybe
        # ending in a partial one
        assert min(e - b for b, e in plan.slices[:-1]) >= \
            kernels.SPLITK_MIN_KTILES * tk


@pytest.mark.parametrize("M,N,K", [(96, 384, 100352), (768, 768, 2368),
                                   (96, 96, 3000)])
def test_plan_never_splits_a_product_with_an_epilogue(M, N, K):
    assert kernels.gemm_plan(M, N, K, SMS).splits > 1
    assert kernels.gemm_plan(M, N, K, SMS, epilogue=True).splits == 1


@pytest.mark.parametrize("N,K", [(768, 768), (2304, 768), (3072, 768),
                                 (768, 3072)])
def test_plan_keeps_bert_products_that_fill_a_wave_whole(N, K):
    """BERT-base over the pretrain step's 32 * 131 = 4192 rows: the forward
    and data-gradient products already give the card more than a wave."""
    M = 4192
    assert _tiles(M, N) >= SMS
    assert kernels.gemm_plan(M, N, K, SMS).splits == 1


@pytest.mark.parametrize("stage", range(len(SWIN_STAGES)))
def test_plan_fills_the_card_with_swin_weight_gradients(stage):
    rows, C = SWIN_STAGES[stage]
    for M, N in _weight_grads(C):
        plan = kernels.gemm_plan(M, N, rows, SMS)
        tiles = _tiles(M, N)
        if stage == 0:
            assert tiles * plan.splits >= SMS, (M, N, plan.splits)
        if 2 * tiles <= SMS:
            assert plan.splits > 1, (stage, M, N)
        else:
            assert plan.splits == 1, (stage, M, N)
        assert tiles * plan.splits <= SMS or plan.splits == 1


def _operands(rng, layout, M, N, K):
    a = rng.normal(size=(K, M) if layout == "tn" else (M, K))
    w = rng.normal(size=(N, K) if layout == "nt" else (K, N))
    return a.astype(np.float32), w.astype(np.float32)


def _slice(layout, a, w, k0, k1):
    """The operands of the product over contraction indices [k0, k1)."""
    if layout == "tn":
        return a[k0:k1], w[k0:k1]
    wk = w[:, k0:k1] if layout == "nt" else w[k0:k1]
    return a[:, k0:k1].contiguous(), wk.contiguous()


@pytest.mark.parametrize("layout", ["nt", "nn", "tn"])
def test_fold_in_slice_order_matches_the_whole_product(layout):
    M, N, K = 24, 16, 1000
    plan = kernels.gemm_plan(M, N, K, SMS)
    assert plan.splits > 1
    rng = np.random.default_rng(3)
    an, wn = _operands(rng, layout, M, N, K)
    a, w = torch.from_numpy(an), torch.from_numpy(wn)
    whole = kernels.gemm_plain(a, w, layout=layout, out_dtype=torch.float32)
    fold = torch.zeros(M, N)
    for k0, k1 in plan.slices:                # in slice order, as the kernel
        fold = fold + kernels.gemm_plain(*_slice(layout, a, w, k0, k1),
                                         layout=layout,
                                         out_dtype=torch.float32)
    scale = whole.abs().max().item()
    assert (fold - whole).abs().max().item() <= 1e-5 * scale
    if layout == "tn":
        ref = np.asarray(jnp.dot(jnp.asarray(an).T, jnp.asarray(wn)))
        assert np.abs(fold.numpy() - ref).max() <= 1e-5 * scale


def test_profile_step_attributes_k1_kernels_to_k1():
    names = {
        "void (anonymous namespace)::gemm_wgmma_kernel<0>(CUtensorMap_st, "
        "CUtensorMap_st, (anonymous namespace)::Args)": "NT",
        "void (anonymous namespace)::gemm_wgmma_kernel<1>(CUtensorMap_st, "
        "CUtensorMap_st, (anonymous namespace)::Args)": "NN",
        "void (anonymous namespace)::gemm_wgmma_kernel<2>(CUtensorMap_st, "
        "CUtensorMap_st, (anonymous namespace)::Args)": "TN",
        "(anonymous namespace)::gemm_fold_kernel(float const*, void*, "
        "long long, int, int)": "split-K fold",
    }
    for name, part in names.items():
        assert profile_step.family(name) == "K1 gemm", name
        assert profile_step.k1_part(name).startswith(part), name
    cublas = "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT"
    assert profile_step.family(cublas) == profile_step.CUBLAS
    assert profile_step.family("sm90_xmma_gemm_bf16bf16_bf16f32") == \
        profile_step.CUBLAS
    assert profile_step.k1_part(cublas) is None

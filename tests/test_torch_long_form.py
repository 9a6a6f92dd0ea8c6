"""K2 and K4 past N = 288: their long form's plans (pure Python, as the
wrappers admit a call before any launch), and the paths it opens against
the JAX package at fusion lengths beyond 288.

JAX's fused encoder has no length gate (``mvlt_tpu/models/fusion.py:105-
117``), so rows 4, 15 and 16 (``fused_attn_ln``, ``fused_attn_ln_masked``
and ``seq_attention_core_bwd``) run there at any S: here they run in
interpret mode (JAX pads S = 300 to 304 in the backward; the port stays
ragged) against the port's plain versions, which are what the card's
checks hold the long form to, at S = 300 and 474 in every mask
combination of ``tests/test_torch_blocks.py`` (``CORE_MASKS``,
``ATTN_MASKS``), float32 at 1e-4. Then ``CaptionModel`` on a tiny ViT and
the two-view ``RetrievalModel`` on a tiny ViT and on the linear patch
reach S > 288 through a long text, against JAX's models on the same
weights and masks: logits, loss and every gradient at 1e-4 (x max|grad|
per tensor)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.models.heads import CaptionModel as JaxCaption
from mvlt_tpu.models.heads import RetrievalModel as JaxRetrieval
from mvlt_tpu.ops import pallas_attn as pa
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.models import heads
from mvlt_tpu_torch.models.heads import CaptionModel, RetrievalModel
from mvlt_tpu_torch.ops import blocks, kernels
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.utils import convert

torch.set_num_threads(2)

LONG_S = [300, 474]
# the combinations of test_pallas_attn.py:651-652 and :731-732
ATTN_MASKS = [(True, True, True), (False, True, False), (True, False, False),
              (False, False, True)]
CORE_MASKS = [(False, False), (True, False), (False, True), (True, True)]


def _np(rng, *shape, std=1.0):
    return (rng.normal(size=shape) * std).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _masks_np(rng, B, nH, N, C):
    """A seq2seq qbias (a bidirectional prefix of N - 40, the rest
    causal), a 0 or 1/0.9 attention-dropout mask and a hidden-dropout
    mask."""
    allowed = np.tril(np.ones((N, N), bool))
    allowed[:, :N - 40] = True
    allowed[:N - 40, N - 40:] = False
    qbias = np.repeat(np.where(allowed, 0.0, -10000.0)[None], B,
                      0).astype(np.float32)
    amask = ((rng.random((B, nH, N, N)) > 0.1) / 0.9).astype(np.float32)
    hmask = ((rng.random((B, N, C)) > 0.1) / 0.9).astype(np.float32)
    return qbias, amask, hmask


def _key_bias(B, N):
    lengths = np.array([N, N - 37, N - 101])[:B]
    return np.where(np.arange(N)[None] < lengths[:, None], 0.0,
                    -10000.0).astype(np.float32)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [289, 298, 348, 474, 1024,
                               kernels.ATTENTION_LONG_MAX_N])
@pytest.mark.parametrize("Dh", [16, 32, 48, 64])
def test_long_form_plans_do_not_grow_with_n(N, Dh):
    """Past N = 288 K2 and K4's passes run a block of a producer and two
    consumer warpgroups on 128 rows, the other side streamed through a
    four-stage ring of 32-row chunks: a block's shared memory is 1024 bytes
    of alignment slack, its 128-row operands (q for K2; q and dctx, or k
    and v, for K4), the ring's two chunks a stage and their bias tiles (K2
    and pass 1: 128 rows of 32 qbias f32 at 160 bytes, amask bf16 at 80,
    a keep word each, 32 key-bias f32; pass 2: 32 query rows of 128 keys,
    qbias at 528 and amask at 264 bytes, four statistics and four keep
    words a query) and 128 bytes of mbarriers, the same at every N; the
    scratch keeps three statistics and a keep word per 32 keys for each
    query, as the register form's."""
    cols = 32 if Dh <= 32 else 64
    ring = 4 * 2 * 32 * cols * 2
    row_tiles = 4 * (128 * (160 + 80 + 4) + 32 * 4)
    fwd = kernels.attention_plan(N, Dh)
    assert fwd == kernels.AttentionPlan(
        tiles=-(-N // 128), key_chunks=-(-N // 32), head_cols=cols,
        smem=1024 + 128 * cols * 2 + ring + row_tiles + 128, mask_smem=0,
        form="long")
    bwd = kernels.attention_bwd_plan(N, Dh)
    dq = 1024 + 2 * 128 * cols * 2 + ring + row_tiles + 128
    dkv = 1024 + 2 * 128 * cols * 2 + ring + 4 * 32 * (528 + 264 + 16 + 16) \
        + 128
    assert bwd == kernels.AttentionBwdPlan(
        tiles=-(-N // 128), chunks=-(-N // 32), head_cols=cols, dq_smem=dq,
        dkv_smem=dkv, mask_smem=0, pattern_smem=0,
        scratch_words=3 * N + N * -(-N // 32), form="long")
    for amask in (False, True):
        assert kernels.attention_smem_bytes(N, Dh, amask) == fwd.smem
        assert kernels.attention_bwd_smem_bytes(N, Dh, amask=amask) == \
            max(dq, dkv)
        kernels.check_attention_fits(N, Dh, kernels.H100_SMEM_OPTIN,
                                     amask=amask)
        kernels.check_attention_fits(N, Dh, kernels.H100_SMEM_OPTIN,
                                     backward=True, amask=amask)
    assert kernels.attention_bwd_smem_bytes(N, Dh, pattern=True) == -1


@pytest.mark.parametrize("N", [289, 298, 348, 474, 1000])
@pytest.mark.parametrize("Dh", [32, 64])
def test_long_form_plans_are_the_hopper_design(N, Dh):
    """The plans mirror the long form's design: 128 rows a block (two
    consumer warpgroups of 64), a ring of at least three stages, one block
    an SM, K4's first pass in two sweeps over the keys; shared memory the
    same at every N and within the opt-in of an H100 block (K2: 173,696
    bytes at head dim 64, 149,120 at 32; K4's first pass 190,080 / 157,312,
    its second 171,648 / 138,880); the window modes still refuse N = 289."""
    fwd, bwd = kernels.attention_plan(N, Dh), kernels.attention_bwd_plan(N, Dh)
    first_f, first_b = (kernels.attention_plan(289, Dh),
                        kernels.attention_bwd_plan(289, Dh))
    want = {64: (175744, 192128, 172160), 32: (151168, 159360, 139392)}[Dh]
    assert (fwd.smem, bwd.dq_smem, bwd.dkv_smem) == want
    assert (fwd.smem, bwd.dq_smem, bwd.dkv_smem) == \
        (first_f.smem, first_b.dq_smem, first_b.dkv_smem)
    assert max(want) <= kernels.H100_SMEM_OPTIN
    for plan in (fwd, bwd):
        assert plan.form == "long" and plan.rows == 128 and plan.stages >= 3
        assert plan.sm_blocks == 1 and plan.tiles == -(-N // 128)
    assert bwd.sweeps == 2
    for form in ("register", "middle"):   # S held for the whole row
        assert kernels.attention_bwd_plan(288, Dh, form).sweeps == 1
    for kw in (dict(window="pattern"), dict(window="stored p"),
               dict(window="head-major"), dict(backward=True, pattern=True),
               dict(backward=True, window="stored p")):
        with pytest.raises(ValueError, match="N=289"):
            kernels.check_attention_fits(289, Dh, kernels.H100_SMEM_OPTIN,
                                         **kw)


@pytest.mark.parametrize("backward,window", [
    (False, "pattern"), (False, "stored p"), (False, "head-major"),
    (True, "pattern"), (True, "stored p")])
@pytest.mark.parametrize("N", [289, 474])
def test_window_modes_refuse_past_288(N, backward, window):
    """The window modes keep the register form: past N = 288 the plan
    refuses them before any launch, with a message that names the mode and
    the register form's N <= 288; at N = 288 they are taken."""
    pattern = window == "pattern"
    kw = dict(backward=backward, pattern=pattern,
              window="" if pattern else window)
    with pytest.raises(ValueError, match=f"N={N}, head dim 64: the {window} "
                                         "mode keeps the register-resident "
                                         "tiling, N <= 288"):
        kernels.check_attention_fits(N, 64, kernels.H100_SMEM_OPTIN, **kw)
    kernels.check_attention_fits(288, 64, kernels.H100_SMEM_OPTIN, **kw)
    assert kernels.max_attention_n(64, backward=backward,
                                   window=not backward) == 288


def test_fusion_fits_every_length_of_the_paths():
    """``check_fusion_fits`` returns S and takes, on the card, the caption
    step on ViT-B/16 or the linear patch (S = 298 at RGC's 100 text tokens,
    348 at MIMIC-CXR's 150) and two IU X-Ray views (474); it refuses only
    past the long form's N <= 46,340."""
    cuda = torch.device("cuda")     # only compared, never allocated on
    for conv in ("vit", "linear"):
        cfg = dataclasses.replace(flagship.flagship_vit_caption_config(),
                                  conv=conv)
        for text, views, S in ((100, 1, 298), (150, 1, 348), (80, 2, 474)):
            assert heads.check_fusion_fits(cfg, text, views, cuda) == S
        with pytest.raises(NotImplementedError, match="N <= 46340"):
            heads.check_fusion_fits(cfg, 46340 - 197, 1, cuda)
        assert heads.check_fusion_fits(cfg, 46340 - 198, 1, cuda) == 46340


# ---------------------------------------------------------------------------
# rows 4, 15 and 16 at S > 288 against JAX in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", LONG_S)
@pytest.mark.parametrize("qb,am", CORE_MASKS)
def test_seq_attention_core_bwd_past_288(S, qb, am):
    """``_seq_core_bwd_kernel`` (row 16) with qbias / amask in interpret
    mode: dqkv and dkbias, f32 at 1e-4."""
    rng = np.random.default_rng(S + 2 * qb + am)
    B, C, nH = 2, 32, 2
    qkv, dctx = _np(rng, B, S, 3 * C, std=0.3), _np(rng, B, S, C)
    kb = _key_bias(B, S)
    qbias, amask, _ = _masks_np(rng, B, nH, S, C)
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


def _fold_rd(s, dpm, chunk):
    """Sweep 1 of K4's long-form pass 1 (``attention_bwd_dq_long_kernel``)
    in numpy f32, in the kernel's order: per row, the four lanes of a quad
    each hold l and r over their columns (8 b + 2 q + e of each chunk, b
    then e), the chunk's max taken over the quad, both rescaled by exp(old
    max - new max) when it grows, then l += e and r += e * dp * mask
    column by column; at the row's end the quad sums (lane 1's into lane
    0's, then lane 2's pair into it) and rd = r / l, correctly rounded."""
    f32 = np.float32
    R, N = s.shape
    nc = -(-N // chunk)
    s = np.pad(s, ((0, 0), (0, nc * chunk - N)),
               constant_values=-np.inf).astype(f32)
    dpm = np.pad(dpm, ((0, 0), (0, nc * chunk - N))).astype(f32)
    mx = np.full(R, -np.inf, f32)
    l, r = np.zeros((R, 4), f32), np.zeros((R, 4), f32)
    lanes = 2 * np.arange(4)
    for c in range(nc):
        keys = slice(c * chunk, (c + 1) * chunk)
        blk, dblk = s[:, keys], dpm[:, keys]
        nm = np.maximum(mx, blk.max(axis=1))
        grow = nm > mx
        f = np.exp(mx[grow] - nm[grow]).astype(f32)
        l[grow] *= f[:, None]
        r[grow] *= f[:, None]
        mx = nm
        for b in range(chunk // 8):
            for e in range(2):
                cols = 8 * b + lanes + e
                ex = np.exp(blk[:, cols] - mx[:, None]).astype(f32)
                l += ex
                r += ex * dblk[:, cols]
    lq = (l[:, 0] + l[:, 1]) + (l[:, 2] + l[:, 3])
    rq = (r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])
    return rq / lq


@pytest.mark.parametrize("S", [298, 348, 474])
def test_long_form_rd_fold_matches_jax_order(S):
    """K4's long form folds rd = rowsum(p * dp * mask) into its first sweep
    (r = sum of e * dp * mask against the running max, rd = r / l at the
    row's end) where JAX sums the normalised p * dp (``_seq_core_bwd_
    kernel``, pallas_attn.py:2498-2501, f32). That moves only the order of
    f32 sums: p, pa and ds are still rounded to bf16 where they were. On
    the same f32 scores and dp (the seq2seq qbias, a 0 or 1/0.9 dropout
    mask, bf16 q, k, v, dctx, head dim 64), the numpy model of the fold
    over the plan's 32-key chunks agrees with JAX's rd within 1e-5 x
    max|rd| (the f32 rounding of two sums of S terms)."""
    chunk = kernels.ATTENTION_LONG_CHUNK
    assert kernels.attention_bwd_plan(S, 64).sweeps == 2
    rng = np.random.default_rng(S)
    bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa: E731
    q, k, v, do = (bf(_np(rng, S, 64, std=0.5)) for _ in range(4))
    qbias, amask, _ = _masks_np(rng, 1, 1, S, 64)
    amask = bf(amask[0, 0])
    s = ((q @ k.T).astype(np.float32) * np.float32(64 ** -0.5) +
         qbias[0]).astype(np.float32)
    dpm = ((do @ v.T).astype(np.float32) * amask).astype(np.float32)
    ones = jnp.ones((S, 1), jnp.float32)
    e = jnp.exp(jnp.asarray(s) - jnp.max(jnp.asarray(s), axis=-1,
                                         keepdims=True))
    denom = jax.lax.dot_general(e, ones, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
    pdp = e / denom * jnp.asarray(dpm)
    want = np.asarray(jax.lax.dot_general(
        pdp, ones, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32))[:, 0]
    got = _fold_rd(s, dpm, chunk)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _attn_ln_args(rng, B, S, C):
    x, gy = _np(rng, B, S, C, std=0.5), _np(rng, B, S, C)
    w = [_np(rng, C, 3 * C, std=0.1), _np(rng, 3 * C, std=0.1),
         _np(rng, C, C, std=0.1), _np(rng, C, std=0.1)]
    lns, lnb = _np(rng, C, std=0.1) + 1.0, _np(rng, C, std=0.1)
    return x, gy, w, lns, lnb


@pytest.mark.parametrize("S", LONG_S)
@pytest.mark.parametrize("qb,am,hm", ATTN_MASKS)
def test_fused_attn_ln_masked_past_288(S, qb, am, hm):
    """``fused_attn_ln_masked`` (row 15, ``_attn_ln_kernel`` with has_qbias
    / has_amask / has_hmask) and its custom VJP in interpret mode: the
    output and the gradients of x, the weights and the LN parameters, f32
    at 1e-4, the port's autograd Function over the plain versions."""
    rng = np.random.default_rng(10 * S + 4 * qb + 2 * am + hm)
    B, C, nH = 2, 32, 2
    x, gy, w, lns, lnb = _attn_ln_args(rng, B, S, C)
    kb = _key_bias(B, S)
    masks = [m if on else None for m, on in
             zip(_masks_np(rng, B, nH, S, C), (qb, am, hm))]
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


@pytest.mark.parametrize("S", LONG_S)
def test_fused_attn_ln_past_288(S):
    """``fused_attn_ln`` (row 4, the serving attention half with a padded
    key bias) in interpret mode against the port's plain twin, f32 at
    1e-4: the retrieval grid's score calls at two views (S = 474)."""
    rng = np.random.default_rng(S)
    B, C, nH = 3, 32, 4
    x, _, w, lns, lnb = _attn_ln_args(rng, B, S, C)
    kb = _key_bias(B, S)
    scale = (C // nH) ** -0.5
    want = pa.fused_attn_ln(*(jnp.asarray(a) for a in (x, *w, kb, lns, lnb)),
                            scale, nH, 1e-12, 8, True)
    got = blocks.fused_attn_ln_plain(_t(x), _t(w[0]).t(), _t(w[1]),
                                     _t(w[2]).t(), _t(w[3]), _t(kb), _t(lns),
                                     _t(lnb), scale, nH, 1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the models past S = 288 against JAX's
# ---------------------------------------------------------------------------

VIT = jcfg.ViTConfig(image_size=32, patch_size=8, num_layers=2, num_heads=4,
                     hidden_dim=32, mlp_dim=64)
B, IMG = 2, 32


def _tiny(cfg, conv):
    """``cfg`` on a tiny ViT (32 wide: through ``resnet_fc`` into the 48-wide
    fusion encoder, 16 tokens a view) or the linear patch (48 wide, 4
    tokens a view), a 2-layer fusion encoder over 300 words."""
    fusion = dataclasses.replace(cfg.fusion, hidden_size=48,
                                 num_hidden_layers=2, num_attention_heads=4,
                                 intermediate_size=96, vocab_size=300)
    return dataclasses.replace(cfg, conv=conv, vit=VIT, fusion=fusion)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), tree)


def _stats(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + np.abs(
        rng.normal(0.0, 0.2, np.shape(a))).astype(np.float32), tree)


def _init(jmodel, *args):
    v = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *args)
    out = {"params": _perturb(v["params"], 1)}
    if "batch_stats" in v:
        out["batch_stats"] = _stats(v["batch_stats"], 2)
    return out


def _load(model_cls, cfg, variables):
    model = model_cls(pcfg.MVLTConfig.from_json(cfg.to_json()),
                      dtype=torch.float32, device="cpu")
    model.load_state_dict(convert.params_from_flax(variables))   # strict
    return model


def _inject_masks(monkeypatch, seed):
    rng, drawn = np.random.default_rng(seed), []

    def bernoulli(key, p=0.5, shape=None, mode="low"):
        mask = rng.random(tuple(shape)) < p
        drawn.append(mask)
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return drawn


def _grads_close(model, grads):
    """Every port gradient within 1e-4 x max|JAX grad| of its tensor (a
    parameter the loss does not reach: no gradient on either side; the
    linear patch's conv bias before a BatchNorm on batch statistics: 0 in
    exact arithmetic, below 1e-6 x the largest gradient on both sides)."""
    want = convert.params_from_flax({"params": grads})
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name, p in got.items():
        w = want[name].numpy()
        if p.grad is None:
            assert not w.any(), name
            continue
        if name == "conv.backbone.proj.bias" and \
                "conv.backbone.bn.weight" in got:
            assert max(float(np.abs(w).max()),
                       float(p.grad.abs().max())) <= 1e-6 * top, name
            continue
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("views,L", [(1, 280), (2, 264)])
def test_vit_caption_past_288_matches_jax(views, L, monkeypatch):
    """``CaptionModel`` on the tiny ViT at S = 1 + 16 + 1 + 280 = 298 (one
    view) and 1 + 32 + 1 + 264 = 298 (two views): the 'unilm' training
    logits, then the loss with fusion dropouts 0.1 on JAX's masks and
    every gradient."""
    cfg = _tiny(jcfg.MVLTConfig.for_caption(max_length=L, mlm_gather_k=4),
                "vit")
    S = 2 + 16 * views + L
    assert S > kernels.ATTENTION_MAX_N
    batch = {k: v.numpy() for k, v in flagship.example_caption_batch(
        B, L, seed=4, image_size=IMG, vocab=300, views=views).items()}
    keys = ("image", "caption", "mlm_labels")
    jargs = [jnp.asarray(batch["image"])] + [
        jnp.asarray(batch[k], jnp.int32) for k in keys[1:]]
    jm = JaxCaption(cfg)
    variables = _init(jm, *jargs[:2])
    want = jax.jit(lambda v, im, c: jm.apply(v, im, c, "unilm"))(
        variables, *jargs[:2])
    model = _load(CaptionModel, cfg, variables)
    got = model(*(torch.from_numpy(batch[k]) for k in keys[:2]), "unilm")
    assert got.shape == (B, L, 300)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)

    drawn = _inject_masks(monkeypatch, 5)

    def loss_fn(params):
        return jm.apply({"params": params}, *jargs, "unilm",
                        deterministic=False, method=jm.loss,
                        rngs={"dropout": jax.random.PRNGKey(3)})

    (want_loss, _), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    assert [m.shape for m in drawn] == [(B, 4, S, S), (B, S, 48),
                                        (B, S, 48)] * 2
    loss, _ = model.loss(*(torch.from_numpy(batch[k]) for k in keys),
                         "unilm", masks=DropoutMasks.replay(drawn))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-4
    _grads_close(model, grads)


@pytest.mark.parametrize("conv", ["vit", "linear"])
def test_two_view_retrieval_past_288_matches_jax(conv, monkeypatch):
    """The two-view ``RetrievalModel`` (IU X-Ray's frontal and lateral
    views) on ``conv`` with captions long enough for S > 288: the 2-way
    match logits, then the loss on ``cat(pos, neg)`` rows with attention
    dropout 0.1 on JAX's masks (the linear patch's BN on batch statistics)
    and every gradient."""
    tokens = 16 if conv == "vit" else 4
    L = 289 - 2 - 2 * tokens + 5
    S = 2 + 2 * tokens + L
    cfg = _tiny(jcfg.MVLTConfig.for_retrieval(max_length=L), conv)
    batch = {k: v.numpy() for k, v in flagship.example_retrieval_batch(
        B, L, seed=6, image_size=IMG, vocab=300, views=2).items()}
    assert batch["image"].shape == (2 * B, 2, 3, IMG, IMG)
    image = jnp.asarray(batch["image"])
    caption = jnp.asarray(batch["caption"], jnp.int32)
    jm = JaxRetrieval(cfg)
    variables = _init(jm, image, caption)
    want = jm.apply(variables, image, caption)
    model = _load(RetrievalModel, cfg, variables)
    got = model(torch.from_numpy(batch["image"]),
                torch.from_numpy(batch["caption"]))
    np.testing.assert_allclose(
        got.detach().numpy(),
        np.asarray(want[0] if isinstance(want, tuple) else want),
        atol=1e-4, rtol=0)

    drawn = _inject_masks(monkeypatch, 9)
    mutable = ["batch_stats"] if "batch_stats" in variables else False

    def loss_fn(params):
        out = jm.apply(dict(variables, params=params), image, caption,
                       jnp.asarray(batch["label"], jnp.int32),
                       method=JaxRetrieval.loss,
                       rngs={"dropout": jax.random.PRNGKey(2)},
                       mutable=mutable)
        return (out[0] if mutable else out)[0]

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    assert [m.shape for m in drawn] == [(2 * B, 4, S, S)] * 2
    loss, _ = model.loss(torch.from_numpy(batch["image"]),
                         torch.from_numpy(batch["caption"]),
                         torch.from_numpy(batch["label"]),
                         masks=DropoutMasks.replay(drawn))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-4
    _grads_close(model, grads)

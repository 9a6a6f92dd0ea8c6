"""The port's opt-in kernel modes against the JAX package: in-kernel
attention dropout (``MVLT_KERNEL_DROPOUT``: ``fused_attn_ln_adrop``, K2 /
K4 with a Philox seed) and the stored-softmax backward of the >= 12-head
Swin blocks (``MVLT_STOREP`` / ``MVLT_NO_STOREP``: ``swin_full_block(...,
store_p=True)``, K2 writing p, K4 reading it).

JAX's in-kernel dropout draws from the TPU's PRNG, which does not run off
the TPU (pallas_attn.py:2784-2785; fusion.py:144 routes to the explicit
mask there), so the port's Philox mask is held through JAX's explicit-mask
path: ``adrop_mask_plain(seed, ...)`` fed as JAX's ``amask`` in f32, and in
the whole step as the keep masks that JAX's ``jax.random.bernoulli``
returns. The stored-p path runs in JAX's interpret mode under
``MVLT_STOREP=1``, and each test checks that JAX really took it.

float32: atol = rtol = 1e-4 (the same math; only summation order differs).
The bf16 step states its own bar.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.models.backbones import swin as jswin
from mvlt_tpu.models.heads import PretrainModel as JaxPretrain
from mvlt_tpu.ops import pallas_attn as pa
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.models.backbones import swin as pswin
from mvlt_tpu_torch.models.heads import PretrainModel
from mvlt_tpu_torch.ops import blocks, kernels
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.utils.convert import pretrain_params_from_flax
from mvlt_tpu_torch.utils.env import env_flag

torch.set_num_threads(2)

RATE = 0.1
KEPT = float(np.float32(1.0 / 0.9))          # 1.1111112, not bf16 1.109375


def _np(rng, *shape, std=1.0):
    return (rng.normal(size=shape) * std).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _close(got, want, tol=1e-4, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=name)


def _seed(hi, lo):
    return torch.tensor([hi, lo], dtype=torch.int32)


# ---------------------------------------------------------------------------
# The Philox stream and the mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0), "d16cfe09 94fdcceb 5001e420 24126ea1")])
def test_philox_known_answers(counter, key, want):
    """Philox4x32-10's known-answer vectors (Random123), through the 16-bit
    split products of the plain version."""
    t = [torch.tensor(v, dtype=torch.int64) for v in counter + key]
    words = kernels.philox4x32_10(t[:4], t[4:])
    assert " ".join(f"{int(w):08x}" for w in words) == want


def test_adrop_mask_plain_values_rate_and_repeatability():
    """Values 0 or f32(1/keep); the keep fraction at rate 0.1 over 2.1e6
    draws within 5 sigma of 0.9; one seed gives one mask."""
    seed = _seed(4321, 60001)
    m = kernels.adrop_mask_plain(seed, 16, 8, 128, RATE)
    assert m.shape == (16, 8, 128, 128) and m.dtype == torch.float32
    assert set(m.unique().tolist()) == {0.0, KEPT}
    n = m.numel()
    kept = (m > 0).sum().item() / n
    assert abs(kept - 0.9) <= 5 * (0.9 * 0.1 / n) ** 0.5, kept
    assert torch.equal(m, kernels.adrop_mask_plain(seed, 16, 8, 128, RATE))
    assert not torch.equal(m, kernels.adrop_mask_plain(_seed(4321, 60002), 16,
                                                       8, 128, RATE))
    thresh, value = kernels.adrop_constants(RATE)
    assert (thresh, value) == (int(0.9 * 2 ** 32), KEPT)


def test_adrop_mask_plain_depends_only_on_seed_sample_head_and_position():
    """A different sample or head draws a different mask; element (b, h, i,
    j) stays the same when the batch or the head count grows."""
    seed = _seed(7, 9)
    m = kernels.adrop_mask_plain(seed, 3, 2, 37, RATE)
    assert not torch.equal(m[0, 0], m[1, 0])
    assert not torch.equal(m[0, 0], m[0, 1])
    big = kernels.adrop_mask_plain(seed, 5, 4, 37, RATE)
    assert torch.equal(big[:3, :2], m)
    with pytest.raises(ValueError, match="seed"):
        kernels.adrop_mask_plain(torch.zeros(3, dtype=torch.int32), 1, 1, 4,
                                 RATE)


# ---------------------------------------------------------------------------
# fused_attn_ln_adrop and seq_attention_core_bwd(adrop=...) against JAX's
# explicit-mask kernels fed the Philox mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,hm", [("kbias", True), ("kbias", False),
                                     ("qbias", True), ("qbias", False)])
def test_fused_attn_ln_adrop_matches_jax_masked_vjp(mode, hm):
    """``fused_attn_ln_adrop`` (plain, f32, under autograd) against
    ``fused_attn_ln_masked`` in interpret mode with ``amask`` the port's
    Philox mask: output and the gradients of x, the weights and the LN
    parameters, in the key-bias and the seq2seq (qbias) mode, with and
    without hmask, at a ragged N."""
    rng = np.random.default_rng(700)
    B, N, C, nH = 3, 11, 32, 4
    x, gy = _np(rng, B, N, C, std=0.5), _np(rng, B, N, C)
    w = [_np(rng, C, 3 * C, std=0.1), _np(rng, 3 * C, std=0.1),
         _np(rng, C, C, std=0.1), _np(rng, C, std=0.1)]
    lns, lnb = _np(rng, C, std=0.1) + 1.0, _np(rng, C, std=0.1)
    kb = np.where(np.arange(N)[None] < np.array([11, 6, 9])[:, None],
                  0.0, -10000.0).astype(np.float32)
    qb = np.repeat(np.triu(np.full((N, N), -10000.0), 1)[None], B, 0)
    hmask = ((rng.random((B, N, C)) > 0.1) / 0.9).astype(np.float32)
    seed = _seed(513, 7)
    amask = kernels.adrop_mask_plain(seed, B, nH, N, RATE).numpy()
    jkb = jnp.asarray(kb if mode == "kbias" else np.zeros((B, N), np.float32))
    jqb = jnp.asarray(qb.astype(np.float32)) if mode == "qbias" else None
    jhm = jnp.asarray(hmask) if hm else None
    scale = (C // nH) ** -0.5
    args = [x, *w, lns, lnb]

    def fn(x_, a, b, c, d, s, t):
        return pa.fused_attn_ln_masked(x_, a, b, c, d, jkb, jqb,
                                       jnp.asarray(amask), jhm, s, t, scale,
                                       nH, 1e-12, 8, True)

    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(gy))
    t = [_t(a, grad=True) for a in args]
    got = blocks.fused_attn_ln_adrop_plain(
        t[0], t[1].t(), t[2], t[3].t(), t[4],
        _t(kb) if mode == "kbias" else None,
        _t(qb) if mode == "qbias" else None, _t(hmask) if hm else None,
        t[5], t[6], seed, scale, nH, RATE, 1e-12)
    got.backward(_t(gy))
    _close(got.detach().numpy(), out, name="out")
    for i, (tt, wg) in enumerate(zip(t, want)):
        _close(tt.grad.numpy(), wg, name=f"input {i}")


@pytest.mark.parametrize("B,N,C,nH", [(3, 13, 32, 4), (2, 16, 48, 2)])
def test_seq_attention_core_bwd_adrop_matches_jax(B, N, C, nH):
    """``seq_attention_core_bwd(adrop=...)`` (the mask regenerated from the
    seed) against JAX's ``seq_attention_core_bwd`` with that mask as amask,
    interpret mode: dqkv and dkbias, ragged N included."""
    rng = np.random.default_rng(710 + N)
    qkv, dctx = _np(rng, B, N, 3 * C, std=0.3), _np(rng, B, N, C)
    kb = np.where(rng.random((B, N)) > 0.2, 0.0, -10000.0).astype(np.float32)
    seed = _seed(N, 2 ** 16 - 1)
    amask = kernels.adrop_mask_plain(seed, B, nH, N, RATE).numpy()
    scale = (C // nH) ** -0.5
    want = pa.seq_attention_core_bwd(jnp.asarray(qkv), jnp.asarray(dctx),
                                     jnp.asarray(kb), None, jnp.asarray(amask),
                                     scale, nH, interpret=True)
    got = blocks.seq_attention_core_bwd_plain(_t(qkv), _t(dctx), _t(kb), None,
                                              None, scale, nH,
                                              adrop=(seed, RATE))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_adrop_and_amask_exclude_each_other():
    qkv = torch.zeros(8, 24)
    am = torch.ones(2, 2, 4, 4)
    with pytest.raises(ValueError, match="exclude"):
        kernels.biased_attention(qkv, 2, 4, 0.5, amask=am,
                                 adrop=(_seed(1, 2), RATE))
    with pytest.raises(ValueError, match="save_mask"):
        kernels.biased_attention(qkv, 2, 4, 0.5, save_mask=True)
    ctx, p, mask = kernels.biased_attention(qkv, 2, 4, 0.5, save_p=True,
                                            save_mask=True,
                                            adrop=(_seed(1, 2), RATE))
    assert p.shape == mask.shape == (2, 2, 4, 4)
    assert torch.equal(mask, kernels.adrop_mask_plain(_seed(1, 2), 2, 2, 4,
                                                      RATE))


# ---------------------------------------------------------------------------
# Stored p: the whole Swin block against JAX under MVLT_STOREP=1
# ---------------------------------------------------------------------------

def _block_params(rng, C, std=0.05):
    """(JAX params with (in, out) dense kernels, port params with (out, in)
    weights), float32."""
    shapes = [(C,), (C,), (C, 3 * C), (3 * C,), (C, C), (C,), (C,), (C,),
              (C, 4 * C), (4 * C,), (4 * C, C), (C,)]
    flat = [_np(rng, *s, std=std) for s in shapes]
    flat[0] += 1.0
    flat[6] += 1.0
    jp = tuple(jnp.asarray(a) for a in flat)
    tp = [_t(a.T if a.ndim == 2 else a, grad=True) for a in flat]
    return jp, tp


def _storep_traced(monkeypatch):
    """Count JAX's traces of ``_core_bwd_storep_kernel``, and fail on its
    'falling back to the recompute kernel' warning."""
    calls = []
    real = pa._core_bwd_storep_kernel

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(pa, "_core_bwd_storep_kernel", counted)
    warnings.filterwarnings("error", message="stored-p backward requested")
    return calls


def _count_stored(monkeypatch):
    """Record, per K2 / K4 call (kernel twin or plain), whether p was
    stored / read."""
    seen = {"save_p": 0, "p": 0}
    for ops in (blocks.KERNEL_OPS, blocks.PLAIN_OPS):
        def attention(*a, _f=ops.attention, **kw):
            seen["save_p"] += bool(kw.get("save_p"))
            return _f(*a, **kw)

        def attention_bwd(*a, _f=ops.attention_bwd, **kw):
            seen["p"] += kw.get("p") is not None
            return _f(*a, **kw)

        monkeypatch.setattr(ops, "attention", attention)
        monkeypatch.setattr(ops, "attention_bwd", attention_bwd)
    return seen


KEEP = 0.8
SCALE = float(np.float32(1.0) / np.float32(KEEP))
DP = (np.array([0.0, SCALE], np.float32), np.array([SCALE, 0.0], np.float32))


@pytest.mark.parametrize("shift,dp", [(False, False), (True, True)])
def test_swin_full_block_store_p_matches_jax(shift, dp, monkeypatch):
    """Rows 11 sp / 12 sp / 20 sp: ``swin_full_block(..., store_p=True)``
    under autograd (plain, f32) against JAX's ``swin_full_block`` in
    interpret mode under ``MVLT_STOREP=1``, at the geometries of
    test_pallas_attn.py:1161 (8 windows of 49, C 96, 12 heads) and :1204
    (the shifted 14 x 14 map of 4 windows, two images, with DropPath):
    output, dx, every parameter grad and the bias grad. JAX traced its
    stored-p backward kernel and did not fall back; the port stored p in
    K2 and read it in K4."""
    monkeypatch.setenv("MVLT_STOREP", "1")
    calls = _storep_traced(monkeypatch)
    seen = _count_stored(monkeypatch)
    rng = np.random.default_rng(720 + shift)
    N, C, nH = 49, 96, 12
    H = W = 14
    nW = 4
    BW = 2 * nW if shift else 8
    x, g = _np(rng, BW, N, C, std=0.1), _np(rng, BW, N, C)
    jp, tp = _block_params(rng, C)
    rel = _np(rng, 1, nH, N, N, std=0.1)
    mask = np.where(rng.uniform(size=(nW, N, N)) > 0.9, -100.0,
                    0.0).astype(np.float32)
    scale = (C // nH) ** -0.5
    spec = (H, W, 7, 3) if shift else None
    jdp = (tuple(jnp.asarray(np.repeat(d, H * W)[:, None]) for d in DP)
           if dp else None)

    def jf(x_, params, rel_):
        bias = (rel_, jnp.asarray(mask)) if shift else rel_
        return pa.swin_full_block(x_, params, bias, scale, nH, interpret=True,
                                  shift_spec=spec, dp=jdp)

    want, vjp = jax.vjp(jf, jnp.asarray(x), jp, jnp.asarray(rel))
    jdx, jdparams, jdrel = vjp(jnp.asarray(g))
    assert calls, "JAX did not run its stored-p backward"
    tx, trel = _t(x, grad=True), _t(rel, grad=True)
    bias = trel + _t(mask)[:, None] if shift else trel
    got = blocks.swin_full_block_plain(
        tx, tp, bias, scale, nH, shift_spec=spec, store_p=True,
        dp=tuple(_t(d) for d in DP) if dp else None)
    got.backward(_t(g))
    assert seen == {"save_p": 1, "p": 1}
    _close(got.detach().numpy(), want, name="out")
    _close(tx.grad.numpy(), jdx, name="dx")
    for i, (p, w) in enumerate(zip(tp, jdparams)):
        w = np.asarray(w)
        _close(p.grad.numpy(), w.T if w.ndim == 2 else w, name=f"param {i}")
    _close(trel.grad.numpy(), jdrel, name="drel")


def test_no_storep_turns_the_store_off(monkeypatch):
    """``MVLT_NO_STOREP=1`` wins over ``MVLT_STOREP=1`` in the model's gate,
    and, set before the backward, sends a stored block's backward to the
    recompute path (as attention_core_bwd_flat reads it, :3943) with the
    same gradients."""
    monkeypatch.setenv("MVLT_STOREP", "1")
    assert pswin.stores_p(12, 49, 128, 1, False)
    assert pswin.stores_p(12, 49, 128, 4, True)
    assert not pswin.stores_p(6, 49, 128, 1, False)     # < 12 heads
    assert not pswin.stores_p(12, 81, 128, 4, True)     # shift merges: 162
    assert pswin.stores_p(12, 81, 128, 1, False)        # N > 64: unmerged
    assert not pswin.stores_p(12, 144, 128, 1, False)   # 144 > 128
    monkeypatch.setenv("MVLT_NO_STOREP", "1")
    assert not pswin.stores_p(12, 49, 128, 1, False)
    monkeypatch.delenv("MVLT_NO_STOREP")

    rng = np.random.default_rng(730)
    BW, N, C, nH = 4, 16, 24, 12
    x, g = _np(rng, BW, N, C, std=0.5), _np(rng, BW, N, C)
    _, tp = _block_params(rng, C, std=0.1)
    bias = _t(_np(rng, 1, nH, N, N, std=0.3))
    grads = []
    for no_storep in ("0", "1"):
        seen = _count_stored(monkeypatch)
        tx = _t(x, grad=True)
        params = [p.detach().clone().requires_grad_() for p in tp]
        out = blocks.swin_full_block_plain(tx, params, bias, 0.5, nH,
                                           store_p=True)
        monkeypatch.setenv("MVLT_NO_STOREP", no_storep)
        out.backward(_t(g))
        assert seen == {"save_p": 1, "p": int(no_storep == "0")}
        grads.append([tx.grad] + [p.grad for p in params])
    for a, b in zip(*grads):
        _close(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# The tiny Swin pretrain step with the switches on, against JAX
# ---------------------------------------------------------------------------

B, L, IMG = 2, 7, 32
KEYS = ("image", "caption_masked", "caption_label", "itm_label")


def _jax_config():
    """A tiny Swin whose two stages have 12 heads: stage 1 (8 x 8 map, four
    4 x 4 windows) has an unshifted and a shifted block, stage 2 is one
    window (as Swin-S stage 4), so p is stored in both layouts; DropPath
    0.3; a 2-layer fusion encoder of the Swin's width, dropouts 0.1."""
    cfg = jcfg.MVLTConfig.for_pretrain(itm_task=True, mlm_gather_k=4)
    swin = jcfg.SwinConfig(img_size=IMG, patch_size=4, embed_dim=24,
                           depths=(2, 2), num_heads=(12, 12), window_size=4,
                           drop_path_rate=0.3)
    return dataclasses.replace(
        cfg, conv="swin", swin=swin,
        fusion=dataclasses.replace(
            cfg.fusion, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=32, vocab_size=300))


def _port_config(cfg):
    d = dataclasses.asdict(cfg)
    return pcfg.MVLTConfig(
        fusion=pcfg.FusionConfig(**d.pop("fusion")),
        swin=pcfg.SwinConfig(**d.pop("swin")),
        resnet=pcfg.ResNetConfig(**d.pop("resnet")),
        vit=pcfg.ViTConfig(**d.pop("vit")), **d)


def _jax_args(batch):
    return [jnp.asarray(batch["image"])] + [
        jnp.asarray(batch[k], jnp.int32) for k in KEYS[1:]]


@pytest.fixture(scope="module")
def tiny():
    cfg = _jax_config()
    batch = {k: v.numpy() for k, v in flagship.example_pretrain_batch(
        B, L, seed=5, image_size=IMG, vocab=300).items()}
    variables = jax.jit(JaxPretrain(cfg).init)(jax.random.PRNGKey(0),
                                               *_jax_args(batch))
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), variables["params"])
    return cfg, {"params": params}, batch


def _inject_masks(monkeypatch, seed, adrop_seeds):
    """Patch ``jax.random.bernoulli`` to draw from numpy, in call order,
    except that each (B, nH, S, S) attention-dropout draw returns the keep
    mask of the port's Philox stream for the next of ``adrop_seeds``.
    Returns the draws in order, each Philox one as (seed, keep mask)."""
    rng, drawn = np.random.default_rng(seed), []
    seeds = iter(adrop_seeds)

    def bernoulli(key, p=0.5, shape=None, mode="low"):
        shape = tuple(shape)
        if len(shape) == 4:
            s = next(seeds)
            mask = kernels.adrop_mask_plain(s, shape[0], shape[1], shape[2],
                                            1.0 - p).numpy() > 0
            drawn.append((s, mask))
        else:
            mask = rng.random(shape) < p
            drawn.append(mask)
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return drawn


def _port_model(cfg, variables, compute_dtype=None):
    model = PretrainModel(_port_config(cfg), dtype=torch.float32,
                          device="cpu", compute_dtype=compute_dtype)
    model.load_state_dict(pretrain_params_from_flax(variables))
    return model


def _jax_grads(cfg, variables, batch, seq2seq, dtype=jnp.float32):
    jmodel = JaxPretrain(cfg, dtype=dtype)

    def loss_fn(params):
        return jmodel.apply({"params": params}, *_jax_args(batch),
                            seq2seq=seq2seq, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(3)})

    (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return metrics, pretrain_params_from_flax({"params": grads})


def _port_grads(model, batch, drawn, seeds: bool):
    """The port's loss and grads in seq2seq mode on JAX's draws: each
    Philox draw replayed as its seed (``seeds``, in-kernel dropout) or as
    its keep mask (an explicit attention mask)."""
    replay = [m[0] if isinstance(m, tuple) and seeds else
              m[1] if isinstance(m, tuple) else
              m.reshape(B) if m.shape == (B,) else m for m in drawn]
    loss, metrics = model.loss(*(torch.from_numpy(batch[k]) for k in KEYS),
                               seq2seq=True,
                               masks=DropoutMasks.replay(replay))
    loss.backward()
    return metrics, {n: p.grad for n, p in model.named_parameters()}


def _jax_swin_interpret_full(monkeypatch):
    monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    monkeypatch.setattr(jswin, "SwinTransformer", functools.partial(
        jswin.SwinTransformer, attn_impl="interpret_full"))


SEEDS = [_seed(101, 202), _seed(65535, 0)]


def _jax_step(tiny, dtype):
    """JAX's ``interpret_full`` route under ``MVLT_STOREP=1``, seq2seq, its
    attention-dropout draws the port's Philox keep masks for ``SEEDS``:
    (metrics, grads, draws, traces of the stored-p backward kernel)."""
    cfg, variables, batch = tiny
    with pytest.MonkeyPatch.context() as mp:
        _jax_swin_interpret_full(mp)
        mp.setenv("MVLT_STOREP", "1")
        calls = _storep_traced(mp)
        drawn = _inject_masks(mp, 12, SEEDS)
        metrics, grads = _jax_grads(cfg, variables, batch, True, dtype)
    return metrics, grads, drawn, len(calls)


@pytest.fixture(scope="module")
def jax_f32_step(tiny):
    return _jax_step(tiny, jnp.float32)


def _check_unused_head(got, want):
    """The bidirectional MLM head has no gradient in seq2seq mode."""
    assert set(got) == set(want)
    for name, g in got.items():
        if name.startswith("mlm_head_bidir."):
            assert g is None and not want[name].numpy().any(), name


def test_tiny_swin_pretrain_step_store_p_matches_jax_f32(tiny, jax_f32_step,
                                                         monkeypatch):
    """The tiny Swin pretrain step, f32, ``MVLT_STOREP=1``, seq2seq, against
    JAX's ``interpret_full`` route (its stored-p Pallas kernels in interpret
    mode), on the masks JAX drew: the losses within 1e-5 and every gradient
    within 1e-4 x max|grad| of its tensor. All four Swin blocks stored p on
    both sides (JAX traced its stored-p backward kernel four times, without
    falling back)."""
    cfg, variables, batch = tiny
    want_m, want, drawn, traces = jax_f32_step
    assert traces == 4
    monkeypatch.setenv("MVLT_STOREP", "1")
    seen = _count_stored(monkeypatch)
    got_m, got = _port_grads(_port_model(cfg, variables), batch, drawn,
                             seeds=False)
    assert seen == {"save_p": 4, "p": 4}
    for name in ("loss", "mlm_loss", "itm_loss"):
        assert abs(float(got_m[name].detach()) - float(want_m[name])) <= 1e-5
    _check_unused_head(got, want)
    for name, g in got.items():
        if g is not None:
            w = want[name].numpy()
            err = float(np.abs(g.numpy() - w).max())
            assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-12), name


# The bf16 step: JAX's interpret kernels and the port's plain versions
# round to bf16 at different places (JAX rounds ds to bf16 before dq / dk in
# its stored-p kernel, the port keeps it in f32 as K4 does; the port's kept
# dropout value is f32 1.1111112 where JAX's mask is bf16 1.109375), and a
# rounding step that flips passes through the blocks. Each gradient is held
# to JAX bf16's within 0.05 x max|grad| of its tensor (the bar of the bf16
# tests of test_torch_train.py) plus JAX bf16's own distance from JAX f32 on
# that tensor, in the same unit: the pooler's bias, whose gradient at two
# samples sums two rows through tanh', is 0.09 from f32 in JAX bf16 itself
# (0.05 in the port) and the rest below 0.04 on both sides. Losses within
# 1e-2.
BF16_GRAD_BAR = 0.05


def test_tiny_swin_pretrain_step_both_switches_near_jax_bf16(
        tiny, jax_f32_step, monkeypatch):
    """The tiny Swin pretrain step in bf16 (f32 masters) with
    ``MVLT_KERNEL_DROPOUT=1`` and ``MVLT_STOREP=1``, seq2seq, against JAX's
    bf16 ``interpret_full`` route, whose ``jax.random.bernoulli`` returns the
    port's Philox keep masks for the attention-dropout draws (JAX's own
    in-kernel dropout does not run off the TPU): the port routes every
    fusion layer through ``fused_attn_ln_adrop`` (one seed a layer, no
    attention mask drawn) and stores p in every Swin block."""
    cfg, variables, batch = tiny
    exact = jax_f32_step[1]
    want_m, want, drawn, traces = _jax_step(tiny, jnp.bfloat16)
    assert traces == 4
    monkeypatch.setenv("MVLT_STOREP", "1")
    monkeypatch.setenv("MVLT_KERNEL_DROPOUT", "1")
    seen = _count_stored(monkeypatch)
    adrop = blocks.KERNEL_OPS.fused_attn_ln_adrop
    used = []
    monkeypatch.setattr(blocks.KERNEL_OPS, "fused_attn_ln_adrop",
                        lambda *a, **kw: used.append(1) or adrop(*a, **kw))
    got_m, got = _port_grads(_port_model(cfg, variables, torch.bfloat16),
                             batch, drawn, seeds=True)
    assert seen == {"save_p": 4, "p": 4} and len(used) == 2
    for name in ("loss", "mlm_loss", "itm_loss"):
        a, b = float(got_m[name].detach()), float(want_m[name])
        assert abs(a - b) <= 1e-2 * max(1.0, abs(b)), (name, a, b)
    _check_unused_head(got, want)
    for name, g in got.items():
        if g is None:
            continue
        w, e = want[name].numpy(), exact[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        own = float(np.abs(w - e).max()) / scale
        err = float(np.abs(g.float().numpy() - w).max()) / scale
        assert err <= BF16_GRAD_BAR + own, (name, err, own)


# ---------------------------------------------------------------------------
# The Swin-S step of record on the meta device with both switches
# ---------------------------------------------------------------------------

class _KeepAll(DropoutMasks):
    """A mask source for the meta device: every unit kept, seed zero."""

    def draw(self, keep, shape, device):
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)

    def seed(self, device):
        return torch.zeros(2, dtype=torch.int32, device=device)


def _walk_swin_s(monkeypatch):
    """Counts per counterpart and mode of one Swin-S b32 pretrain step
    (text 80) walked forward and backward on the meta device."""
    counts = {}
    for fn in blocks.COUNTERPARTS:
        name = fn.__name__

        def call(x, *args, _name=name, _fn=getattr(blocks.PLAIN_OPS, name),
                 **kw):
            for key in getattr(blocks, _name).counts_for(x, args, kw):
                counts[f"{_name}.{key}"] = counts.get(f"{_name}.{key}", 0) + 1
            return _fn(x, *args, **kw)

        monkeypatch.setattr(blocks.PLAIN_OPS, name, call)
    model = PretrainModel(flagship.flagship_swin_pretrain_config(),
                          dtype=torch.float32, device="meta",
                          compute_dtype=torch.bfloat16)
    n, text = 32, 80
    args = (torch.empty(n, 3, 224, 224, device="meta"),
            torch.ones(n, text, dtype=torch.long, device="meta"),
            torch.full((n, text), -100, dtype=torch.long, device="meta"),
            torch.zeros(n, dtype=torch.long, device="meta"))
    loss, _ = model.loss(*args, plain=True, masks=_KeepAll())
    loss.backward()
    return counts


PR6_COUNTS = {"swin_full_block.train_launches": 11,
              "swin_full_block.train_shift_launches": 11,
              "swin_half_block.launches": 2, "attention_core.launches": 2,
              "swin_mlp_half_bwd.launches": 24,
              "attention_core_bwd.launches": 24,
              "swin_qkv_tail_bwd.launches": 24,
              "mlp_ln_half_bwd.launches": 12,
              "fused_mlp_ln_masked.launches": 12,
              "seq_attention_core_bwd.launches": 12}


@pytest.mark.parametrize("switches", [True, False])
def test_swin_pretrain_switches_routing_counts_on_meta_device(switches,
                                                              monkeypatch):
    """With both switches: 12 ``fused_attn_ln_adrop`` (no
    ``fused_attn_ln_masked``), 12 regenerating ``seq_attention_core_bwd``,
    9 + 9 whole-block training forwards storing p (the stage-3 blocks) and
    18 of the 24 ``attention_core_bwd`` from the stored p. Switched off
    (and with ``"0"``), the counts of the step of record are unchanged."""
    value = "1" if switches else "0"
    monkeypatch.setenv("MVLT_KERNEL_DROPOUT", value)
    monkeypatch.setenv("MVLT_STOREP", value)
    counts = _walk_swin_s(monkeypatch)
    if switches:
        want = dict(PR6_COUNTS, **{
            "fused_attn_ln_adrop.launches": 12,
            "seq_attention_core_bwd.adrop_launches": 12,
            "swin_full_block.train_store_p_launches": 9,
            "swin_full_block.train_shift_store_p_launches": 9,
            "attention_core_bwd.store_p_launches": 18})
    else:
        want = dict(PR6_COUNTS, **{"fused_attn_ln_masked.launches": 12})
    assert counts == want


# ---------------------------------------------------------------------------
# The mask source's seed and the switches' parsing
# ---------------------------------------------------------------------------

def test_dropout_masks_seed_record_and_replay():
    """``seed`` draws a (2,) int32 of 16-bit halves from the generator, in
    order with the masks; recorded draws replay to the same values, and a
    replayed mask where a seed is drawn is refused."""
    src = DropoutMasks(torch.Generator().manual_seed(3), record=True)
    m = src.draw(0.9, (4, 4), "cpu")
    s = src.seed("cpu")
    assert s.shape == (2,) and s.dtype == torch.int32
    assert ((s >= 0) & (s < 2 ** 16)).all()
    again = DropoutMasks.replay(src.recorded)
    assert torch.equal(again.draw(0.9, (4, 4), "cpu"), m)
    assert torch.equal(again.seed("cpu"), s)
    with pytest.raises(RuntimeError, match="seed"):
        again.seed("cpu")
    with pytest.raises(ValueError, match="seed"):
        DropoutMasks.replay([m]).seed("cpu")


@pytest.mark.parametrize("value,on", [("1", True), ("true", True),
                                      ("0", False), ("", False),
                                      ("off", False), ("No", False)])
def test_env_flag_parses_like_the_jax_package(value, on, monkeypatch):
    from mvlt_tpu.utils.env import env_flag as jax_env_flag
    monkeypatch.setenv("MVLT_STOREP", value)
    assert env_flag("MVLT_STOREP") is on is jax_env_flag("MVLT_STOREP")

"""The Swin backbone's ``attn_impl='pallas'`` route and the last four TPU
kernels' counterparts (rows 7-10 of PERF.md's kernel table) against the JAX
package, on the same numpy inputs.

- Row 8, ``window_attention`` (K2 head-major, backward on K4's pattern
  mode), against ``window_attention(interpret=True)`` and its custom VJP.
- Row 9, ``fused_seq_attention`` (K1 + K2 + K1, backward K1 + K4 + K5), at a
  ragged N (JAX pads it to a multiple of 8 with a -1e9 key bias).
- Row 7, ``swin_attn_half`` (K3 + K1 + K2 + K1), where JAX runs
  ``_attn_half_kernel`` (its fallback patched to raise), and the port's gate
  at a geometry where JAX falls back.
- Row 10, ``full_forward_windows``, against ``_full_forward_windows``.
- The tiny Swin (``swin_tiny_test``, depths (2, 2), DropPath 0.3) on
  ``'pallas'`` against JAX's ``attn_impl='interpret'`` (the same plain
  route, ``window_attention`` in interpret mode): the backbone forward, and
  the pretrain loss, every gradient and three AdamW steps on DropPath masks
  replayed from JAX's (B, 1, 1) draws, in both mask modes. The parameters
  load through the unchanged bridge with ``strict=True``.
- Routing on the meta device, and the values of ``attn_impl`` the port
  refuses.

float32 agrees to 1e-4 x max|ref|; each bf16 test states its bar.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.models.backbones import swin as jswin
from mvlt_tpu.models.heads import PretrainModel as JaxPretrain
from mvlt_tpu.ops import pallas_attn
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.config import swin_small
from mvlt_tpu_torch.models.backbones import adapter
from mvlt_tpu_torch.models.backbones import swin as pswin
from mvlt_tpu_torch.models.heads import PretrainModel, VQAModel
from mvlt_tpu_torch.ops import blocks
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.train.state import make_optimizer
from mvlt_tpu_torch.train.steps import make_pretrain_step
from mvlt_tpu_torch.utils.convert import pretrain_params_from_flax
from test_torch_swin_train import (B, KEYS, L, _inject_masks, _jax_args,
                                   _port_config, tiny)  # noqa: F401

torch.set_num_threads(2)


def _np(rng, *shape, std=1.0):
    return (rng.normal(size=shape) * std).astype(np.float32)


def _close(got, want, tol=1e-4, what=""):
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# --- row 8: window_attention ------------------------------------------------

def _window_inputs(nWb, dtype=np.float32):
    rng = np.random.default_rng(11 + nWb)
    BW, nH, N, Dh = 8, 2, 16, 4
    q, k, v = (_np(rng, BW, nH, N, Dh) for _ in range(3))
    bias = _np(rng, nWb, nH, N, N, std=0.5)
    if nWb > 1:
        bias[1, :, :3, 5:] = -100.0            # a shift-mask-like pattern
    g = _np(rng, BW, nH, N, Dh)
    return q, k, v, bias, g, Dh ** -0.5


def _jax_window(q, k, v, bias, g, scale, dtype):
    args = [jnp.asarray(a, dtype) for a in (q, k, v)] + [jnp.asarray(bias)]

    def f(q, k, v, b):
        return pallas_attn.window_attention(q, k, v, b, scale, interpret=True)
    out, vjp = jax.vjp(f, *args)
    return out, vjp(jnp.asarray(g, dtype))


def _port_window(q, k, v, bias, g, scale, dtype):
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in (q, k, v)] + [torch.tensor(bias, requires_grad=True)]
    out = blocks.window_attention(*leaves, scale)
    out.backward(torch.tensor(g, dtype=dtype))
    return out, [t.grad for t in leaves]


@pytest.mark.parametrize("nWb", [1, 4])
def test_window_attention_and_grads_match_jax(nWb):
    """Forward and ``jax.vjp`` (dq, dk, dv, dbias summed per pattern) in
    f32. JAX's ``_bwd`` recomputes p in f32 and K4 keeps p in f32 too (its p
    tile and dv = p^T g), so the route adds no rounding of p."""
    q, k, v, bias, g, scale = _window_inputs(nWb)
    want, wgrads = _jax_window(q, k, v, bias, g, scale, jnp.float32)
    got, grads = _port_window(q, k, v, bias, g, scale, torch.float32)
    _close(got, want, what="ctx")
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads, wgrads):
        _close(a, b, what=name)


def test_window_attention_bf16_near_jax_bf16():
    """bf16 q, k, v on both sides, f32 bias. Both round p to bf16 for the PV
    product only, keep p in f32 in the backward and round ctx, dq, dk, dv
    once to bf16, so they differ by summation order: bar 2^-7 x max|ref|
    (one bf16 step flipping at the largest value), f32 dbias 1e-3."""
    q, k, v, bias, g, scale = _window_inputs(4)
    want, wgrads = _jax_window(q, k, v, bias, g, scale, jnp.bfloat16)
    got, grads = _port_window(q, k, v, bias, g, scale, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and grads[0].dtype == torch.bfloat16
    _close(got, want, tol=2.0 ** -7, what="ctx")
    for name, a, b, tol in zip(("dq", "dk", "dv", "dbias"), grads, wgrads,
                               (2.0 ** -7,) * 3 + (1e-3,)):
        _close(a, b, tol=tol, what=name)


def test_window_attention_takes_views_of_the_qkv_rows():
    """q, k, v as the 'pallas' route makes them, views of one (BW, N, 3C)
    product, give what contiguous copies give."""
    rng = np.random.default_rng(5)
    BW, N, nH, Dh = 4, 9, 2, 4
    qkv = torch.tensor(_np(rng, BW, N, 3 * nH * Dh))
    q, k, v = qkv.view(BW, N, 3, nH, Dh).permute(2, 0, 3, 1, 4).unbind(0)
    bias = torch.tensor(_np(rng, 1, nH, N, N))
    got = blocks.window_attention(q, k, v, bias, 0.5)
    want = blocks.window_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), bias, 0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- row 9: fused_seq_attention ---------------------------------------------

def test_fused_seq_attention_and_grads_match_jax():
    """N = 11 (JAX pads to 16 with a -1e9 key bias; the port keeps N
    ragged), a padded key bias: the forward and the grads of x and of the
    four weights, JAX's custom VJP (``_seq_bwd``) against the port's
    autograd Function (K1 + K4 + K5). Weights in the port's (out, in)."""
    rng = np.random.default_rng(21)
    Bq, N, C, nH = 3, 11, 16, 2
    x = _np(rng, Bq, N, C)
    wqkv, bqkv = _np(rng, C, 3 * C, std=0.2), _np(rng, 3 * C, std=0.1)
    wproj, bproj = _np(rng, C, C, std=0.2), _np(rng, C, std=0.1)
    kbias = np.where(np.arange(N)[None] < np.array([[11], [7], [4]]), 0.0,
                     -10000.0).astype(np.float32)
    g = _np(rng, Bq, N, C)
    scale = (C // nH) ** -0.5

    def f(x, wq, bq, wp, bp):
        return pallas_attn.fused_seq_attention(x, wq, bq, wp, bp,
                                               jnp.asarray(kbias), scale, nH,
                                               interpret=True)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in
                             (x, wqkv, bqkv, wproj, bproj)))
    wgrads = vjp(jnp.asarray(g))
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (x, wqkv.T.copy(), bqkv, wproj.T.copy(), bproj)]
    got = blocks.fused_seq_attention(*leaves, torch.tensor(kbias), scale, nH)
    got.backward(torch.tensor(g))
    _close(got, want, what="out")
    for name, t, w, transpose in zip(
            ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj"), leaves, wgrads,
            (False, True, False, True, False)):
        _close(t.grad.T if transpose else t.grad, w, what=name)


def test_fused_seq_attention_refuses_a_key_bias_gradient():
    x = torch.zeros(2, 5, 8)
    w, b = torch.zeros(24, 8), torch.zeros(24)
    kbias = torch.zeros(2, 5, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        blocks.fused_seq_attention(x, w, b, w[:8], b[:8], kbias, 0.5, 2)


# --- row 7: swin_attn_half --------------------------------------------------

def _half_args(rng, BW, N, C, nH, P):
    x = _np(rng, BW, N, C, std=0.5)
    ln1 = (_np(rng, C, std=0.1) + 1.0, _np(rng, C, std=0.1))
    wqkv, bqkv = _np(rng, C, 3 * C, std=0.1), _np(rng, 3 * C, std=0.1)
    wproj, bproj = _np(rng, C, C, std=0.1), _np(rng, C, std=0.1)
    bias = _np(rng, P, nH, N, N, std=0.1)
    return x, ln1, (wqkv, bqkv, wproj, bproj), bias, (C // nH) ** -0.5


@pytest.mark.parametrize("BW,N,P", [(6, 16, 2), (3, 16, 1)])
def test_swin_attn_half_matches_jax_kernel(BW, N, P, monkeypatch):
    """At geometries where ``swin_attn_half`` admits a group (window pairs
    merged to N = 32, and unmerged N = 16 at an odd window count), with its
    fallback patched to raise: JAX ran ``_attn_half_kernel``. The port's
    gate agrees, and its counterpart matches in f32."""
    def no_fallback(*a, **kw):
        raise AssertionError("JAX took _block_forward_with_ln_fallback")
    monkeypatch.setattr(pallas_attn, "_block_forward_with_ln_fallback",
                        no_fallback)
    rng = np.random.default_rng(31)
    C, nH = 32, 4
    x, ln1, (wq, bq, wp, bp), bias, scale = _half_args(rng, BW, N, C, nH, P)
    want = pallas_attn.swin_attn_half(
        *(jnp.asarray(a) for a in (x, *ln1, wq, bq, wp, bp, bias)), scale,
        nH, interpret=True)
    assert pswin.attn_half_admits(BW, N, C, P)
    got = blocks.swin_attn_half(
        *(torch.tensor(a) for a in (x, *ln1, wq.T.copy(), bq, wp.T.copy(),
                                    bp, bias)), scale, nH)
    _close(got, want, what="swin_attn_half")


def _count_plain_ops(monkeypatch):
    """Count every call through ``blocks.PLAIN_OPS`` (the counterparts and
    the kernels' plain versions, also where one calls another, and in the
    backward of an autograd Function); returns the counts."""
    counts = {}

    def counted(name, fn):
        def call(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        return call
    for name, fn in list(vars(blocks.PLAIN_OPS).items()):
        monkeypatch.setattr(blocks.PLAIN_OPS, name, counted(name, fn))
    return counts


def _only(counts, names):
    return {k: v for k, v in counts.items() if k in names}


@pytest.mark.parametrize("res,window,admits", [(4, 4, True), (3, 3, False)])
def test_stage4_half_route_takes_row_7_where_jax_does(res, window, admits,
                                                      monkeypatch):
    """A one-window wide block (the map equals the window, as at Swin-S stage
    4) of two images: at window 4 (N = 16, merged 32) JAX's
    ``swin_attn_half`` runs its kernel and the port's half route calls
    ``swin_attn_half``; at window 3 (N = 9, merged 18: no 8-aligned group)
    JAX falls back to LN1 + ``_block_kernel`` + residual and the port takes
    row 1, LN1 -> ``window_block_attention``. Outputs match JAX's half route
    in f32 both ways."""
    fell_back = []
    fallback = pallas_attn._block_forward_with_ln_fallback
    monkeypatch.setattr(pallas_attn, "_block_forward_with_ln_fallback",
                        lambda *a: fell_back.append(1) or fallback(*a))
    rng = np.random.default_rng(41)
    Bn, C, nH = 2, 32, 4
    N = window * window
    x, ln1, (wq, bq, wp, bp), _, scale = _half_args(rng, Bn, N, C, nH, 1)
    table = _np(rng, (2 * window - 1) ** 2, nH, std=0.3)
    bias = (pswin.relative_position_onehot(window, window) @ table).reshape(
        N, N, nH).transpose(2, 0, 1)[None].copy()
    want = pallas_attn.swin_attn_half(
        *(jnp.asarray(a) for a in (x, *ln1, wq, bq, wp, bp, bias)), scale,
        nH, interpret=True)
    assert bool(fell_back) == (not admits)
    assert pswin.attn_half_admits(Bn, N, C, 1) == admits
    monkeypatch.setattr(pswin, "uses_half_blocks", lambda dim: True)
    block = pswin.SwinBlock(C, (res, res), nH, window, 0, 4.0, True, None,
                            dtype=torch.float32, device="cpu")
    sd = {"norm1.weight": ln1[0], "norm1.bias": ln1[1], "qkv.weight": wq.T,
          "qkv.bias": bq, "proj.weight": wp.T, "proj.bias": bp,
          "relative_position_bias_table": table}
    counts = _count_plain_ops(monkeypatch)
    with torch.no_grad():
        for name, p in block.named_parameters():
            # the MLP half's weights stay zero: it passes the attention
            # half's output through unchanged
            p.copy_(torch.tensor(np.ascontiguousarray(sd[name]))
                    if name in sd else torch.zeros_like(p))
        out = block(torch.tensor(x).view(Bn, N, C), blocks.PLAIN_OPS)
    row = "swin_attn_half" if admits else "window_block_attention"
    assert _only(counts, ("swin_attn_half", "window_block_attention",
                          "fused_mlp_preln")) == {row: 1, "fused_mlp_preln": 1}
    _close(out.view(Bn, N, C), want, what="half route")


# --- row 10: full_forward_windows -------------------------------------------

@pytest.mark.parametrize("nWb", [1, 4])
def test_full_forward_windows_matches_jax(nWb):
    """``_full_forward_windows`` called directly (no geometry reaches it
    through ``swin_full_block``), interpret mode, f32."""
    rng = np.random.default_rng(61 + nWb)
    BW, N, C, nH = 8, 16, 16, 2
    x = _np(rng, BW, N, C)
    ln = lambda: (_np(rng, C, std=0.1) + 1.0, _np(rng, C, std=0.1))  # noqa
    ln1, ln2 = ln(), ln()
    dense = [(_np(rng, i, o, std=i ** -0.5), _np(rng, o, std=0.1))
             for i, o in ((C, 3 * C), (C, C), (C, 4 * C), (4 * C, C))]
    bias = _np(rng, nWb, nH, N, N, std=0.5)
    scale = (C // nH) ** -0.5
    jparams = (*ln1, *dense[0], *dense[1], *ln2, *dense[2], *dense[3])
    want = pallas_attn._full_forward_windows(
        jnp.asarray(x), tuple(jnp.asarray(a) for a in jparams),
        jnp.asarray(bias), scale=scale, num_heads=nH, group=8,
        interpret=True)
    tparams = tuple(torch.tensor(np.ascontiguousarray(a.T if a.ndim == 2
                                                      else a))
                    for a in jparams)
    got = blocks.full_forward_windows(torch.tensor(x), tparams,
                                      torch.tensor(bias), scale, nH)
    _close(got, want, what="full_forward_windows")


# --- the tiny Swin on the 'pallas' route ------------------------------------

def _routes(monkeypatch):
    """JAX's Swin on 'interpret' (its plain route with window_attention in
    interpret mode), the port's on 'pallas'; both adapters read the class
    at model construction. Returns the list of JAX's window_attention
    calls."""
    monkeypatch.setattr(jswin, "SwinTransformer", functools.partial(
        jswin.SwinTransformer, attn_impl="interpret"))
    monkeypatch.setattr(adapter, "SwinTransformer", functools.partial(
        pswin.SwinTransformer, attn_impl="pallas"))
    calls, original = [], pallas_attn.window_attention
    monkeypatch.setattr(pallas_attn, "window_attention",
                        lambda *a, **kw: calls.append(1) or original(*a, **kw))
    return calls


def _pallas_port(cfg, variables):
    model = PretrainModel(_port_config(cfg), dtype=torch.float32,
                          device="cpu")
    model.load_state_dict(pretrain_params_from_flax(variables))  # strict
    assert all(b.attn_impl == "pallas" for s in model.conv.backbone.stages
               for b in s)
    return model


def test_tiny_swin_forward_matches_jax(tiny, monkeypatch):
    """The backbone alone, deterministic, on JAX's 'interpret' route and
    the port's 'pallas' route, f32: its 4 blocks call window_attention."""
    cfg, variables, batch = tiny
    calls = _routes(monkeypatch)
    image = batch["image"]
    jmodel = jswin.SwinTransformer(cfg.swin)
    want = jax.jit(jmodel.apply)(
        {"params": variables["params"]["conv"]["backbone"]},
        jnp.asarray(image))
    assert len(calls) == 4
    model = _pallas_port(cfg, variables).conv.backbone
    counts = _count_plain_ops(monkeypatch)
    with torch.no_grad():
        got = model(torch.from_numpy(image), blocks.PLAIN_OPS)
    assert counts["window_attention"] == 4 and "swin_full_block" not in counts
    _close(got, want, what="backbone")


@pytest.mark.parametrize("seq2seq", [False, True])
def test_tiny_pallas_loss_and_grads_match_jax(tiny, seq2seq, monkeypatch):
    """The pretrain loss and every gradient (relative-position tables
    included), DropPath 0.3 and fusion dropout 0.1 on the masks JAX drew:
    six (B, 1, 1) DropPath draws (blocks 1-3, flax ``DropPath``), then the
    fusion's; the port replays them unchanged."""
    cfg, variables, batch = tiny
    monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    calls = _routes(monkeypatch)
    drawn = _inject_masks(monkeypatch, 17)
    jmodel = JaxPretrain(cfg)

    def loss_fn(params):
        return jmodel.apply({"params": params}, *_jax_args(batch),
                            seq2seq=seq2seq, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(3)})

    (_, want_m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    assert len(calls) == 4
    S = 1 + 16 + 1 + L
    assert [m.shape for m in drawn] == [(B, 1, 1)] * 6 + [
        (B, 2, S, S), (B, S, 16), (B, S, 16)] * 2
    model = _pallas_port(cfg, variables)
    loss, metrics = model.loss(
        *(torch.from_numpy(batch[k]) for k in KEYS), seq2seq=seq2seq,
        masks=DropoutMasks.replay(drawn))
    loss.backward()
    for name in ("loss", "mlm_loss", "itm_loss"):
        assert abs(float(metrics[name].detach()) - float(want_m[name])) \
            <= 1e-5, name
    want = pretrain_params_from_flax({"params": grads})
    unused = "mlm_head_bidir." if seq2seq else "mlm_head_seq2seq."
    for name, p in model.named_parameters():
        if name.startswith(unused):
            assert p.grad is None and not want[name].numpy().any(), name
            continue
        _close(p.grad, want[name].numpy(), what=name)


def test_tiny_pallas_three_steps_match_jax_step(tiny, monkeypatch):
    """Three AdamW steps (bidirectional, seq2seq, bidirectional) of the port
    on 'pallas' against the JAX step with the masks JAX took: losses within
    1e-4, then every parameter within 3e-4 (about 2 lr a step, as
    test_torch_swin_train.py bounds the kernel route). JAX runs its XLA
    route here, which draws the same (B, 1, 1) DropPath masks and computes
    what its 'interpret' route computes (the loss and gradients above hold
    the port to that one); its Pallas interpreter would triple the test's
    time."""
    from mvlt_tpu.train.state import create_train_state
    from mvlt_tpu.train.state import make_optimizer as jax_optimizer
    from mvlt_tpu.train.steps import make_pretrain_step as jax_pretrain_step

    cfg, variables, batch = tiny
    monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    monkeypatch.setattr(adapter, "SwinTransformer", functools.partial(
        pswin.SwinTransformer, attn_impl="pallas"))
    drawn = _inject_masks(monkeypatch, 18)
    jmodel = JaxPretrain(cfg)
    state = create_train_state(jmodel, jax.tree.map(jnp.array, variables),
                               jax_optimizer(cfg))
    jbatch = dict(zip(KEYS, _jax_args(batch)))
    model = _pallas_port(cfg, variables)
    step = make_pretrain_step(model, make_optimizer(model, model.config))
    tbatch = {k: torch.from_numpy(batch[k]) for k in KEYS}
    # one jitted step per mode: the numpy masks are drawn while it traces,
    # so the third step runs on the first one's masks
    jsteps, masks = {}, {}
    for i, seq2seq in enumerate((False, True, False)):
        drawn.clear()
        jstep = jsteps.setdefault(seq2seq, jax_pretrain_step(jmodel, seq2seq))
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(i))
        masks.setdefault(seq2seq, list(drawn))
        step.masks = DropoutMasks.replay(masks[seq2seq])
        pm = step(tbatch, seq2seq)
        for name in ("loss", "mlm_loss", "itm_loss"):
            assert abs(float(pm[name]) - float(jm[name])) <= 1e-4, (i, name)
    want = pretrain_params_from_flax({"params": state.params})
    for name, value in model.state_dict().items():
        err = float(np.abs(value.numpy() - want[name].numpy()).max())
        assert err <= 3e-4, (name, err)


# --- routing on the meta device, and the option's values --------------------

class _KeepAll(DropoutMasks):
    """A mask source for the meta device: every unit kept."""

    def draw(self, keep, shape, device):
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)


FUSION_FWD = {"fused_attn_ln": 12, "fused_mlp_ln": 12}
ROUTES_FWD = {
    "auto": {"swin_full_block": 22, "window_block_attention": 2,
             "fused_mlp_preln": 2, **FUSION_FWD},
    "pallas": {"window_attention": 24, **FUSION_FWD},
}


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_flagship_forward_routing_on_meta(impl, monkeypatch):
    """The flagship forward (Swin-S @224, b8) walked on the meta device:
    'auto' keeps PR 2's routing (22 whole blocks, 2 stage-4 halves on row
    1, no row 7), 'pallas' runs row 8 in all 24 blocks and no fused Swin
    kernel."""
    counts = _count_plain_ops(monkeypatch)
    monkeypatch.setattr(adapter, "SwinTransformer", functools.partial(
        pswin.SwinTransformer, attn_impl=impl))
    model = VQAModel(flagship.flagship_vqa_config(), dtype=torch.bfloat16,
                     device="meta")
    _, logits = model(torch.empty(8, 3, 224, 224, device="meta"),
                      torch.ones(8, 23, dtype=torch.long, device="meta"),
                      plain=True)
    assert logits.shape == (8, 224)
    assert _only(counts, [f.__name__ for f in blocks.COUNTERPARTS]) == \
        ROUTES_FWD[impl]


def test_swin_pretrain_pallas_routing_on_meta(monkeypatch):
    """The Swin-S step of record (b32, text 80) on 'pallas', forward and
    backward on the meta device: 24 ``window_attention`` forwards and 24
    ``window_attention_bwd`` (K4 pattern mode), no Swin block kernel, the
    fusion as on 'auto'; every parameter but the other mode's MLM head gets
    a grad."""
    counts = _count_plain_ops(monkeypatch)
    monkeypatch.setattr(adapter, "SwinTransformer", functools.partial(
        pswin.SwinTransformer, attn_impl="pallas"))
    model = PretrainModel(flagship.flagship_swin_pretrain_config(),
                          dtype=torch.float32, device="meta",
                          compute_dtype=torch.bfloat16)
    n, text = 32, 80
    loss, _ = model.loss(
        torch.empty(n, 3, 224, 224, device="meta"),
        torch.ones(n, text, dtype=torch.long, device="meta"),
        torch.full((n, text), -100, dtype=torch.long, device="meta"),
        torch.zeros(n, dtype=torch.long, device="meta"), plain=True,
        masks=_KeepAll())
    names = [f.__name__ for f in blocks.COUNTERPARTS]
    assert _only(counts, names) == {"window_attention": 24,
                                    "fused_attn_ln_masked": 12,
                                    "fused_mlp_ln_masked": 12}
    counts.clear()
    loss.backward()
    assert _only(counts, names) == {"window_attention_bwd": 24,
                                    "seq_attention_core_bwd": 12,
                                    "mlp_ln_half_bwd": 12}
    assert counts["attention_bwd"] == 24 + 12       # K4: pattern + key bias
    for name, p in model.named_parameters():
        assert (p.grad is None) == name.startswith("mlm_head_seq2seq."), name


def test_swin_s_width_at_384_window_12_takes_row_7_at_stage_4(monkeypatch):
    """A Swin-S-width backbone at 384 with window 12 on 'auto', served on the
    meta device: stage 4 (12 x 12, one window of N = 144) admits
    ``_attn_half_kernel``'s group, so it takes row 7 twice and row 1 never;
    stages 1-3 keep the whole-block kernel."""
    cfg = dataclasses.replace(swin_small(), img_size=384, window_size=12)
    model = pswin.SwinTransformer(cfg, dtype=torch.bfloat16, device="meta")
    counts = _count_plain_ops(monkeypatch)
    with torch.no_grad():
        out = model(torch.empty(2, 384, 384, 3, device="meta"),
                    blocks.PLAIN_OPS)
    assert out.shape == (2, 144, 768)
    assert _only(counts, [f.__name__ for f in blocks.COUNTERPARTS]) == {
        "swin_attn_half": 2, "fused_mlp_preln": 2, "swin_full_block": 22}


@pytest.mark.parametrize("impl,error", [
    ("interpret", NotImplementedError), ("interpret_full", NotImplementedError),
    ("flash", ValueError)])
def test_unported_attn_impl_raises(impl, error):
    with pytest.raises(error, match="ROADMAP.md queue A"):
        pswin.SwinTransformer(swin_small(), dtype=torch.bfloat16,
                              device="meta", attn_impl=impl)


def test_the_adapter_passes_no_attn_impl():
    """As in JAX (``adapter.py:56-58``): the route is set by constructing the
    backbone, and a VQA model built as usual stays on 'auto'."""
    model = VQAModel(flagship.flagship_vqa_config(), dtype=torch.bfloat16,
                     device="meta")
    assert model.conv.backbone.attn_impl == "auto"

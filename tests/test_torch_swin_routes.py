"""JAX's plain Swin block route in the port, and the backward rules it
needs, against the JAX package on the same numpy inputs (Pallas kernels in
interpret mode).

- The four VJPs: row 1 ``window_block_attention`` (``_block_bwd``), row 6
  ``fused_mlp_preln`` (``_mlp_preln_bwd``), row 7 ``swin_attn_half``
  (``_attn_half_bwd``) and ``attention_core_op`` (``_core_op_bwd``),
  every input's gradient with one bias pattern and with one per window.
- The tiny Swin (``swin_tiny_test``, depths (2, 2), DropPath 0.3: stage 1
  has a shifted block with 4 window patterns, stage 2 is one window) on one
  converted tree: the backbone forward on 'auto', 'pallas', 'pallas_block'
  and 'xla' against JAX's; the pretrain loss and every gradient on the
  masks JAX drew (its ``jax.random.bernoulli`` patched to draw from numpy,
  the list replayed to the port) for 'auto' with ``drop_rate`` 0.1 (JAX on
  'interpret_block', its kernel route, and on its XLA route), 'auto' with
  ``attn_drop_rate`` 0.1, 'pallas_block' and 'xla', and 'pallas' with
  ``drop_rate`` 0.1 (JAX on 'interpret'); three AdamW steps on the
  ``drop_rate`` route against the JAX step.
- The routing of the Swin-S step and forward on the meta device, and the
  refusals that stay.

float32 agrees to 1e-4 x max|ref| per tensor; the bf16 test states its
bar.
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
from mvlt_tpu_torch.config import MVLTConfig, TrainConfig, swin_small
from mvlt_tpu_torch.models.backbones import adapter
from mvlt_tpu_torch.models.backbones import swin as pswin
from mvlt_tpu_torch.models.heads import PretrainModel, VQAModel
from mvlt_tpu_torch.ops import blocks
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.tasks.common import TaskRunner
from mvlt_tpu_torch.train.state import make_optimizer
from mvlt_tpu_torch.train.steps import make_pretrain_step
from mvlt_tpu_torch.utils.convert import pretrain_params_from_flax
from test_torch_attn_impl import _KeepAll, _count_plain_ops, _only
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


# --- the four VJPs against JAX's custom_vjp ---------------------------------

BW, N, C, NH = 8, 16, 16, 2
SCALE = (C // NH) ** -0.5


def _bias(rng, P):
    bias = _np(rng, P, NH, N, N, std=0.5)
    if P > 1:
        bias[1, :, :3, 5:] = -100.0            # a shift-mask-like pattern
    return bias


def _dense(rng, k, n):
    """(JAX kernel (in, out), bias) and the port's (out, in) weight."""
    w, b = _np(rng, k, n, std=k ** -0.5), _np(rng, n, std=0.1)
    return w, b, np.ascontiguousarray(w.T)


def _ln(rng):
    return _np(rng, C, std=0.1) + 1.0, _np(rng, C, std=0.1)


def _vjp_pair(jax_fn, port_fn, jargs, pargs, g, dtype=np.float32):
    """(JAX output, JAX grads), (port output, port grads) of one function
    on the same inputs and cotangent; ``dtype`` casts the non-f32 leaves
    (the biases of the attention stay f32)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def keep32(a):
        return a.ndim == 4                   # the attention bias

    jx = [jnp.asarray(a, jnp.float32 if keep32(a) else jdt) for a in jargs]
    want, vjp = jax.vjp(jax_fn, *jx)
    wgrads = vjp(jnp.asarray(g, jdt))
    leaves = [torch.tensor(a, dtype=torch.float32 if keep32(a) else tdt,
                           requires_grad=True) for a in pargs]
    got = port_fn(*leaves)
    got.backward(torch.tensor(g, dtype=tdt))
    return (want, wgrads), (got, [t.grad for t in leaves])


def _row1_case(P, dtype=np.float32):
    rng = np.random.default_rng(100 + P)
    x = _np(rng, BW, N, C)
    wq, bq, tq = _dense(rng, C, 3 * C)
    wp, bp, tp = _dense(rng, C, C)
    bias = _bias(rng, P)
    g = _np(rng, BW, N, C)

    def jfn(x, wq, bq, wp, bp, b):
        return pallas_attn.window_block_attention(x, wq, bq, wp, bp, b, SCALE,
                                                  NH, 16, True)

    def pfn(x, wq, bq, wp, bp, b):
        return blocks.window_block_attention(x, wq, bq, wp, bp, b, SCALE, NH)

    return _vjp_pair(jfn, pfn, (x, wq, bq, wp, bp, bias),
                     (x, tq, bq, tp, bp, bias), g, dtype)


ROW1 = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dbias")
TRANSPOSED = {"dwqkv", "dwproj", "dw1", "dw2"}


def _check_grads(names, grads, wgrads, tol=1e-4):
    for name, a, b in zip(names, grads, wgrads):
        _close(a.T if name in TRANSPOSED else a, b, tol=tol, what=name)


@pytest.mark.parametrize("P", [1, 4])
def test_window_block_attention_vjp_matches_jax(P):
    """Row 1 under autograd (K1 + K2 + K1; backward ``_block_bwd`` on K1,
    ``attention_core`` / ``attention_core_bwd`` and K5) against
    ``window_block_attention``'s custom VJP in interpret mode, f32: the
    output, dx, the four weight grads and dbias (summed per pattern)."""
    (want, wgrads), (got, grads) = _row1_case(P)
    _close(got, want, what="out")
    _check_grads(ROW1, grads, wgrads)


def test_window_block_attention_vjp_bf16_near_jax():
    """bf16 x and weights, f32 bias. JAX's ``_block_bwd`` upcasts the bf16
    values to f32 for its products and rounds dctx and the outputs to bf16;
    the port's K1 (plain version here) takes bf16 operands with f32
    accumulation, the same products in another summation order, and both
    round p to bf16 for the PV product only. Bar: 2^-6 x max|ref| per
    tensor (two bf16 steps at the largest value: the rounding of dctx, then
    that of the output), dbias and the f32 weight grads included."""
    (want, wgrads), (got, grads) = _row1_case(4, "bfloat16")
    assert got.dtype == torch.bfloat16 and grads[0].dtype == torch.bfloat16
    _close(got, want, tol=2.0 ** -6, what="out")
    _check_grads(ROW1, grads, wgrads, tol=2.0 ** -6)


def test_window_block_attention_residual_takes_the_cotangent():
    """Serving's folded ``+x`` (``residual=``): the output is the residual
    plus the block, and the residual's gradient is the cotangent itself."""
    rng = np.random.default_rng(7)
    x, res = (torch.tensor(_np(rng, BW, N, C)) for _ in range(2))
    _, bq, tq = _dense(rng, C, 3 * C)
    _, bp, tp = _dense(rng, C, C)
    w = [torch.tensor(a) for a in (tq, bq, tp, bp, _bias(rng, 1))]
    res.requires_grad_()
    out = blocks.window_block_attention(x, *w, SCALE, NH, residual=res)
    with torch.no_grad():
        want = blocks.window_block_attention(x, *w, SCALE, NH) + res
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    g = torch.tensor(_np(rng, BW, N, C))
    out.backward(g)
    assert torch.equal(res.grad, g)


def test_fused_mlp_preln_vjp_matches_jax():
    """Row 6 under autograd (backward on K3 + K1 + K5) against
    ``fused_mlp_preln``'s custom VJP in interpret mode, f32, on 128 rows (a
    whole chunk of JAX's row grid): dx, dln2s, dln2b and the four MLP
    grads. JAX's interpret path differentiates the erf GELU; its TPU bf16
    path takes the tanh GELU (``_mlp_preln_bwd``, pallas_attn.py:3431), a
    fast-math choice the port does not copy, so this bar holds the erf
    form only."""
    rng = np.random.default_rng(5)
    x = _np(rng, BW, N, C)
    ln2 = _ln(rng)
    w1, b1, t1 = _dense(rng, C, 4 * C)
    w2, b2, t2 = _dense(rng, 4 * C, C)
    g = _np(rng, BW, N, C)

    def jfn(x, s, b, w1, b1, w2, b2):
        return pallas_attn.fused_mlp_preln(x, s, b, w1, b1, w2, b2, 128, True)

    (want, wgrads), (got, grads) = _vjp_pair(
        jfn, blocks.fused_mlp_preln, (x, *ln2, w1, b1, w2, b2),
        (x, *ln2, t1, b1, t2, b2), g)
    _close(got, want, what="out")
    _check_grads(("dx", "dln2s", "dln2b", "dw1", "db1", "dw2", "db2"), grads,
                 wgrads)


@pytest.mark.parametrize("P", [1, 4])
def test_swin_attn_half_vjp_matches_jax(P):
    """Row 7 under autograd (backward: LN1 / qkv / ctx recomputed,
    ``attention_core_bwd``, ``swin_qkv_tail_bwd``) against
    ``swin_attn_half``'s custom VJP in interpret mode, f32: dx, dln1s,
    dln1b, the four weight grads and dbias."""
    rng = np.random.default_rng(200 + P)
    x = _np(rng, BW, N, C)
    ln1 = _ln(rng)
    wq, bq, tq = _dense(rng, C, 3 * C)
    wp, bp, tp = _dense(rng, C, C)
    bias = _bias(rng, P)
    g = _np(rng, BW, N, C)

    def jfn(x, s, b, wq, bq, wp, bp, bias):
        return pallas_attn.swin_attn_half(x, s, b, wq, bq, wp, bp, bias,
                                          SCALE, NH, 16, True)

    def pfn(*args):
        return blocks.swin_attn_half(*args, SCALE, NH)

    (want, wgrads), (got, grads) = _vjp_pair(
        jfn, pfn, (x, *ln1, wq, bq, wp, bp, bias),
        (x, *ln1, tq, bq, tp, bp, bias), g)
    _close(got, want, what="out")
    _check_grads(("dx", "dln1s", "dln1b", "dwqkv", "dbqkv", "dwproj",
                  "dbproj", "dbias"), grads, wgrads)


@pytest.mark.parametrize("P", [1, 4])
def test_attention_core_op_vjp_matches_jax(P):
    """``attention_core_op`` (row 19 forward, row 21 backward) against
    JAX's in interpret mode, f32: ctx, dqkv and the f32 dbias of the bias's
    shape (P, nH, N, N)."""
    rng = np.random.default_rng(300 + P)
    qkv = _np(rng, BW, N, 3 * C, std=0.5)
    bias = _bias(rng, P)
    g = _np(rng, BW, N, C)

    def jfn(qkv, b):
        return pallas_attn.attention_core_op(qkv, b, SCALE, NH, True)

    def pfn(qkv, b):
        return blocks.attention_core_op(qkv, b, SCALE, NH)

    (want, wgrads), (got, grads) = _vjp_pair(jfn, pfn, (qkv, bias),
                                             (qkv, bias), g)
    _close(got, want, what="ctx")
    assert grads[1].shape == (P, NH, N, N) and grads[1].dtype == torch.float32
    _check_grads(("dqkv", "dbias"), grads, wgrads)


# --- the tiny Swin on every route -------------------------------------------

def _swin_cfg(cfg, **rates):
    return dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin,
                                                             **rates))


def _port_backbone(cfg, variables, impl):
    sd = pretrain_params_from_flax(variables)
    prefix = "conv.backbone."
    model = pswin.SwinTransformer(_port_config(cfg).swin,
                                  dtype=torch.float32, device="cpu",
                                  attn_impl=impl)
    model.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                           if k.startswith(prefix)})          # strict
    return model


SERVING_ROWS = {"auto": {"swin_full_block": 4},
                "pallas": {"window_attention": 4},
                "pallas_block": {"window_block_attention": 4}, "xla": {}}


def test_one_tree_serves_alike_on_every_route(tiny, monkeypatch):
    """One converted tree (``utils/convert.py``) loads, strictly, into the
    tiny backbone on 'auto', 'pallas', 'pallas_block' and 'xla': JAX's plain
    route reads the same ``attn/qkv``, ``attn/proj``, table, ``norm1/2`` and
    ``mlp`` leaves as its fused routes. Each route's forward matches JAX's
    (its XLA route on the CPU), f32, and runs the counterparts JAX's would
    on the TPU: the whole block, row 8, row 1, or none."""
    cfg, variables, batch = tiny
    image = batch["image"]
    want = jax.jit(jswin.SwinTransformer(cfg.swin).apply)(
        {"params": variables["params"]["conv"]["backbone"]},
        jnp.asarray(image))
    names = [f.__name__ for f in blocks.COUNTERPARTS]
    for impl, rows in SERVING_ROWS.items():
        model = _port_backbone(cfg, variables, impl)
        counts = _count_plain_ops(monkeypatch)
        with torch.no_grad():
            got = model(torch.from_numpy(image), blocks.PLAIN_OPS)
        assert _only(counts, names) == rows, impl
        _close(got, want, what=impl)
        monkeypatch.undo()


def _dropout_shapes(cfg, S):
    """The masks JAX draws, in order, on its plain route: the position
    dropout, then per block the attention dropout, ``proj_drop``,
    ``drop_path1``, the MLP's two dropouts and ``drop_path2`` (each where
    its rate is above 0: DropPath from block 1 on), then the fusion's."""
    sw = cfg.swin
    res, dim = sw.img_size // sw.patch_size, sw.embed_dim
    hidden = sw.drop_rate > 0

    def some(*shapes, on=True):
        return list(shapes) if on else []
    shapes, block = some((B, res * res, dim), on=hidden), 0
    for i, depth in enumerate(sw.depths):
        r, c = res >> i, dim << i
        w = min(sw.window_size, r)
        n_win = B * (r // w) ** 2
        for _ in range(depth):
            dp = some((B, 1, 1), on=block > 0)
            shapes += some((n_win, sw.num_heads[i], w * w, w * w),
                           on=sw.attn_drop_rate > 0)
            shapes += some((n_win, w * w, c), on=hidden) + dp + some(
                (B, r * r, int(c * sw.mlp_ratio)), (B, r * r, c),
                on=hidden) + dp
            block += 1
    return shapes + [(B, 2, S, S), (B, S, 16), (B, S, 16)] * 2


def _set_routes(monkeypatch, jax_impl, port_impl):
    if jax_impl != "xla":
        monkeypatch.setattr(jswin, "SwinTransformer", functools.partial(
            jswin.SwinTransformer, attn_impl=jax_impl))
    monkeypatch.setattr(adapter, "SwinTransformer", functools.partial(
        pswin.SwinTransformer, attn_impl=port_impl))


# (port attn_impl, JAX attn_impl, Swin rates, the counterparts the port's
# forward calls); JAX's 'xla' is its CPU default ('auto' resolves to it)
TRAIN_ROUTES = {
    "auto_drop_vs_interpret_block": (
        "auto", "interpret_block", dict(drop_rate=0.1),
        {"window_block_attention": 4}),
    "auto_drop_vs_xla": ("auto", "xla", dict(drop_rate=0.1),
                         {"window_block_attention": 4}),
    "auto_attn_drop": ("auto", "xla", dict(attn_drop_rate=0.1), {}),
    "pallas_block": ("pallas_block", "interpret_block", {},
                     {"window_block_attention": 4}),
    "xla": ("xla", "xla", {}, {}),
    "pallas_drop": ("pallas", "interpret", dict(drop_rate=0.1),
                    {"window_attention": 4}),
}


@pytest.mark.parametrize("route", list(TRAIN_ROUTES))
def test_tiny_loss_and_grads_match_jax(tiny, route, monkeypatch):
    """The tiny pretrain step's loss and every gradient (relative-position
    tables included), bidirectional, DropPath 0.3 and fusion dropouts 0.1,
    on the masks JAX drew in trace order and the port replays: JAX's and
    the port's draws have the same shapes in the same order."""
    impl, jax_impl, rates, rows = TRAIN_ROUTES[route]
    cfg, variables, batch = tiny
    cfg = _swin_cfg(cfg, **rates)
    monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    _set_routes(monkeypatch, jax_impl, impl)
    drawn = _inject_masks(monkeypatch, 23)
    jmodel = JaxPretrain(cfg)

    def loss_fn(params):
        return jmodel.apply({"params": params}, *_jax_args(batch),
                            seq2seq=False, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(3)})

    (_, want_m), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    assert [m.shape for m in drawn] == _dropout_shapes(cfg, 1 + 16 + 1 + L)
    model = PretrainModel(_port_config(cfg), dtype=torch.float32,
                          device="cpu")
    model.load_state_dict(pretrain_params_from_flax(variables))  # strict
    counts = _count_plain_ops(monkeypatch)
    loss, metrics = model.loss(
        *(torch.from_numpy(batch[k]) for k in KEYS), seq2seq=False,
        plain=True, masks=DropoutMasks.replay(drawn))
    swin_rows = {"swin_full_block", "swin_half_block", "window_attention",
                 "window_block_attention", "swin_attn_half",
                 "fused_mlp_preln"}
    assert _only(counts, swin_rows) == rows
    counts.clear()
    loss.backward()
    bwd = {"window_block_attention": "window_block_attention_bwd",
           "window_attention": "window_attention_bwd"}
    assert _only(counts, set(bwd.values()) | {"swin_mlp_half_bwd"}) == {
        bwd[k]: v for k, v in rows.items()}
    for name in ("loss", "mlm_loss", "itm_loss"):
        assert abs(float(metrics[name].detach()) - float(want_m[name])) \
            <= 1e-5, name
    want = pretrain_params_from_flax({"params": grads})
    for name, p in model.named_parameters():
        if name.startswith("mlm_head_seq2seq."):
            assert p.grad is None and not want[name].numpy().any(), name
            continue
        _close(p.grad, want[name].numpy(), what=name)


def test_tiny_drop_rate_three_steps_match_jax_step(tiny, monkeypatch):
    """Three AdamW steps (bidirectional, seq2seq, bidirectional) of the
    port's 'auto' route with ``drop_rate`` 0.1 (every block on row 1 and its
    VJP) against the JAX step on its XLA route with the masks JAX took:
    losses within 1e-4, then every parameter within 3e-4 (about 2 lr a
    step, as test_torch_swin_train.py bounds the kernel route)."""
    from mvlt_tpu.train.state import create_train_state
    from mvlt_tpu.train.state import make_optimizer as jax_optimizer
    from mvlt_tpu.train.steps import make_pretrain_step as jax_pretrain_step

    cfg, variables, batch = tiny
    cfg = _swin_cfg(cfg, drop_rate=0.1)
    monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    drawn = _inject_masks(monkeypatch, 24)
    jmodel = JaxPretrain(cfg)
    state = create_train_state(jmodel, jax.tree.map(jnp.array, variables),
                               jax_optimizer(cfg))
    jbatch = dict(zip(KEYS, _jax_args(batch)))
    model = PretrainModel(_port_config(cfg), dtype=torch.float32,
                          device="cpu")
    model.load_state_dict(pretrain_params_from_flax(variables))
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


# --- routing of the Swin-S step and forward on the meta device --------------

FUSION_STEP = {"fused_attn_ln_masked": 12, "fused_mlp_ln_masked": 12}
FUSION_BWD = {"seq_attention_core_bwd": 12, "mlp_ln_half_bwd": 12}
# the Swin-S step's counterparts (forward, backward) on each route
STEP_ROUTES = {
    "drop_rate": (flagship.flagship_swin_dropout_pretrain_config, "auto",
                  {"window_block_attention": 24},
                  {"window_block_attention_bwd": 24, "attention_core": 24,
                   "attention_core_bwd": 24}),
    "pallas_block": (flagship.flagship_swin_pretrain_config, "pallas_block",
                     {"window_block_attention": 24},
                     {"window_block_attention_bwd": 24, "attention_core": 24,
                      "attention_core_bwd": 24}),
    "xla": (flagship.flagship_swin_pretrain_config, "xla", {}, {}),
    "attn_drop_rate": (flagship.flagship_swin_attn_dropout_pretrain_config,
                       "auto", {}, {}),
}


@pytest.mark.parametrize("route", list(STEP_ROUTES))
def test_swin_s_step_routing_on_meta(route, monkeypatch):
    """The Swin-S step of record (b32, text 80) forward and backward on the
    meta device: with ``drop_rate`` 0.1 (or on 'pallas_block') 24 row-1
    forwards and 24 ``_block_bwd``s, each recomputing on ``attention_core``
    and differentiating through ``attention_core_bwd``, and no fused Swin
    block; on 'xla' (and with attention dropout, which 'auto' sends there)
    no attention kernel in the backbone. The fusion is as on the step of
    record; every parameter but the other mode's MLM head gets a grad."""
    config, impl, fwd, bwd = STEP_ROUTES[route]
    counts = _count_plain_ops(monkeypatch)
    monkeypatch.setattr(adapter, "SwinTransformer", functools.partial(
        pswin.SwinTransformer, attn_impl=impl))
    model = PretrainModel(config(), dtype=torch.float32, device="meta",
                          compute_dtype=torch.bfloat16)
    n, text = 32, 80
    loss, _ = model.loss(
        torch.empty(n, 3, 224, 224, device="meta"),
        torch.ones(n, text, dtype=torch.long, device="meta"),
        torch.full((n, text), -100, dtype=torch.long, device="meta"),
        torch.zeros(n, dtype=torch.long, device="meta"), plain=True,
        masks=_KeepAll())
    names = [f.__name__ for f in blocks.COUNTERPARTS]
    assert _only(counts, names) == {**fwd, **FUSION_STEP}
    assert "attention_heads" not in counts
    counts.clear()
    loss.backward()
    assert _only(counts, names) == {**bwd, **FUSION_BWD}
    assert counts["attention_bwd"] == (24 if bwd else 0) + 12     # K4
    for name, p in model.named_parameters():
        assert (p.grad is None) == name.startswith("mlm_head_seq2seq."), name


@pytest.mark.parametrize("impl,rows", [
    ("pallas_block", {"window_block_attention": 24}), ("xla", {})])
def test_flagship_forward_routing_on_meta(impl, rows, monkeypatch):
    """The flagship forward (Swin-S @224, b8) on 'pallas_block': row 1 in
    all 24 blocks, no row 2 / 3 / 6; on 'xla' no Swin counterpart. The
    fusion encoder as on 'auto'."""
    counts = _count_plain_ops(monkeypatch)
    monkeypatch.setattr(adapter, "SwinTransformer", functools.partial(
        pswin.SwinTransformer, attn_impl=impl))
    model = VQAModel(flagship.flagship_vqa_config(), dtype=torch.bfloat16,
                     device="meta")
    _, logits = model(torch.empty(8, 3, 224, 224, device="meta"),
                      torch.ones(8, 23, dtype=torch.long, device="meta"),
                      plain=True)
    assert logits.shape == (8, 224)
    assert _only(counts, [f.__name__ for f in blocks.COUNTERPARTS]) == {
        **rows, "fused_attn_ln": 12, "fused_mlp_ln": 12}


# --- the refusals that stay -------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas_block", "pallas"])
def test_kernel_attention_refuses_attention_dropout(tiny, impl):
    """As JAX (swin.py:180-190): the kernel attentions cannot drop attention
    probabilities, so training on them with ``attn_drop_rate`` above 0
    raises ``ValueError`` (serving runs)."""
    cfg, variables, _ = tiny
    cfg = _swin_cfg(cfg, attn_drop_rate=0.1)
    model = _port_backbone(cfg, variables, impl)
    image = torch.zeros(B, 3, 32, 32)
    with torch.no_grad():
        assert torch.isfinite(model(image, blocks.PLAIN_OPS)).all()
    with pytest.raises(ValueError, match="cannot apply attention dropout"):
        model(image, blocks.PLAIN_OPS,
              masks=DropoutMasks(torch.Generator().manual_seed(0)))


def test_attention_core_still_refuses_autograd():
    """Row 19 has no VJP in JAX; its differentiable form is
    ``attention_core_op``, which runs where ``attention_core`` raises."""
    rng = np.random.default_rng(8)
    qkv = torch.tensor(_np(rng, BW, N, 3 * C), requires_grad=True)
    bias = torch.tensor(_bias(rng, 1))
    with pytest.raises(NotImplementedError, match="attention_core_op"):
        blocks.attention_core(qkv, bias, SCALE, NH)
    blocks.attention_core_op(qkv, bias, SCALE, NH).sum().backward()
    assert qkv.grad.shape == qkv.shape


@pytest.mark.parametrize("flag", ["remat_backbone", "remat_fusion"])
def test_remat_flags_raise_until_ported(flag):
    """JAX remats its Swin blocks / fusion layers with these flags, and so
    does the port now (``tests/test_torch_remat.py`` holds it to JAX): a
    model and a runner build with either flag, the model's flag reaches
    the module it rematerialises and nothing else, and ``TrainConfig``'s,
    which JAX reads nowhere, changes nothing."""
    model = VQAModel(dataclasses.replace(MVLTConfig(), **{flag: True}),
                     device="meta")
    assert model.conv.backbone.remat == (flag == "remat_backbone")
    assert model.fusion.remat == (flag == "remat_fusion")
    runner = TaskRunner(VQAModel, MVLTConfig(), TrainConfig(**{flag: True}),
                        device="cpu")
    assert runner.train_config.remat_backbone == (flag == "remat_backbone")

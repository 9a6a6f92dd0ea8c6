"""What the JAX package does on one device beside its model paths, in the
port, against the JAX package on the same numpy inputs:

- the ViT-B/16 backbone trained with ``dropout`` and ``attention_dropout``
  at 0.1 (a tiny ViT under the MLM+ITM pretrain model, both mask modes), on
  the masks JAX drew in trace order (``jax.random.bernoulli`` patched to
  draw from numpy) replayed to the port: one (1, 1, N, N) attention mask a
  block, as flax's ``broadcast_dropout`` draws it;
- AdamW with its first moment in bf16 (``adam_mu_dtype``; optax's
  ``mu_dtype``), alone and under the clip and accumulation, and with
  optax schedules, against ``optax.adamw``; a bf16 moment through
  ``save_checkpoint`` / ``restore_checkpoint``;
- the profiling hooks (``trace``, ``annotate``, ``StepTimer``) and
  ``print_obj`` on the CPU.

float32 losses within 1e-4 and gradients within 1e-4 x max|grad| per
tensor; parameters within 1e-6 of optax's (as ``test_torch_optim.py``
holds the f32 moments); the bf16 moments as stated in their test.
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvlt_tpu.models.heads import PretrainModel as JaxPretrain
from mvlt_tpu_torch.config import MVLTConfig
from mvlt_tpu_torch.models.heads import PretrainModel
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.train.state import (AdamW, ClipAccumAdamW, TrainState,
                                        make_optimizer)
from mvlt_tpu_torch.utils import checkpoint, profiling
from mvlt_tpu_torch.utils.convert import params_from_flax
from mvlt_tpu_torch.utils.misc import print_obj
from test_torch_backbones_other import (B, L, _grads_close, _init,
                                        _inject_masks, _inputs, _jax_config,
                                        _load)

torch.set_num_threads(2)


# --- ViT dropout --------------------------------------------------------------

@pytest.mark.parametrize("seq2seq", [False, True])
def test_vit_dropout_pretrain_matches_jax(seq2seq, monkeypatch):
    """``PretrainModel`` on a tiny ViT (hidden 32, 2 layers, 4 heads, 16
    patches) with both ViT dropouts and the fusion dropouts at 0.1: JAX's
    draws come in flax's trace order (the position dropout, then per block
    the attention mask (1, 1, N, N), the dropout after attention, after
    the GELU and after ``mlp_fc2``, then the fusion's), the port takes the
    same shapes in the same order, and the losses and every gradient match;
    then one step of the port's AdamW moves the loss."""
    cfg = _jax_config("pretrain", "vit")
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, dropout=0.1, attention_dropout=0.1))
    batch = _inputs(2)
    keys = ("image", "caption_masked", "caption_label", "itm_label")
    args = [jnp.asarray(batch["image"])] + [
        jnp.asarray(batch[k], jnp.int32) for k in keys[1:]]
    jm = JaxPretrain(cfg)
    variables = _init(jm, *args)
    drawn = _inject_masks(monkeypatch, 17)

    def loss_fn(params):
        return jm.apply({"params": params}, *args, seq2seq=seq2seq,
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(3)})

    (_, want_m), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    N, C, M = 1 + 16, cfg.vit.hidden_dim, cfg.vit.mlp_dim
    S = 1 + 16 + 1 + L
    vit = [(B, N, C)] + [(1, 1, N, N), (B, N, C), (B, N, M), (B, N, C)] * 2
    assert [m.shape for m in drawn] == vit + [(B, 4, S, S), (B, S, 48),
                                              (B, S, 48)] * 2
    model = _load(PretrainModel, cfg, variables)
    taken = DropoutMasks.replay(drawn)
    taken.recorded = []
    loss, metrics = model.loss(*(torch.from_numpy(batch[k]) for k in keys),
                               seq2seq=seq2seq, plain=True, masks=taken)
    assert [tuple(m.shape) for m in taken.recorded] == [m.shape
                                                        for m in drawn]
    loss.backward()
    for name in ("loss", "mlm_loss", "itm_loss"):
        assert abs(float(metrics[name].detach()) - float(want_m[name])) \
            <= 1e-4, name
    _grads_close(model, params_from_flax({"params": grads}),
                 skip=("mlm_head_bidir." if seq2seq else "mlm_head_seq2seq."))
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    make_optimizer(model, MVLTConfig(lr=1e-3)).step()
    after, _ = model.loss(*(torch.from_numpy(batch[k]) for k in keys),
                          seq2seq=seq2seq, plain=True,
                          masks=DropoutMasks.replay(drawn))
    assert float(after.detach()) < float(loss.detach())


# --- AdamW: bf16 moments, schedules -------------------------------------------

SHAPES = [(64, 32), (32,), (3, 5, 7), (1,)]
LR, UPDATES = 1e-3, 3


def _data(seed, k):
    """Parameters at a model's scale (normal, std 0.02) and unit-scale
    gradients, ``UPDATES * k`` mini-steps of them."""
    rng = np.random.default_rng(seed)
    params = [(0.02 * rng.normal(size=s)).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(UPDATES * k)]
    return params, grads


def _adam_states(state):
    """optax's ``ScaleByAdamState``s in ``state``, however deep."""
    if isinstance(state, optax.ScaleByAdamState):
        return [state]
    if isinstance(state, (tuple, list)):
        return [s for x in state for s in _adam_states(x)]
    if hasattr(state, "_fields"):
        return [s for f in state._fields
                for s in _adam_states(getattr(state, f))]
    return []


def _optax(params, grads, *, clip=None, k=1, mu_dtype=None, lr=LR):
    cfg = MVLTConfig()
    tx = optax.adamw(lr, b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
                     weight_decay=cfg.weight_decay, mu_dtype=mu_dtype)
    if clip is not None:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    if k > 1:
        tx = optax.MultiSteps(tx, k)

    @jax.jit
    def update(p, st, g):
        u, st = tx.update(g, st, p)
        return optax.apply_updates(p, u), st

    p = [jnp.asarray(x) for x in params]
    st = tx.init(p)
    trace = []
    for g in grads:
        p, st = update(p, st, [jnp.asarray(x) for x in g])
        (adam,) = _adam_states(st)
        trace.append(([np.asarray(x) for x in p],
                      [np.asarray(m.astype(jnp.float32)) for m in adam.mu],
                      [np.asarray(m).dtype for m in adam.mu]))
    return trace


class _Model(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.ps = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])


def _port(params, grads, *, clip=None, k=1, mu="float32", schedule=None):
    model = _Model(params)
    opt = make_optimizer(model, MVLTConfig(lr=LR, adam_mu_dtype=mu),
                         grad_clip_norm=clip, grad_accum_steps=k,
                         schedule=schedule)
    adam = opt.adamw if isinstance(opt, ClipAccumAdamW) else opt
    assert isinstance(adam, AdamW)
    trace = []
    for g in grads:
        opt.zero_grad()
        for p, x in zip(model.ps, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        # before AdamW's first update (under MultiSteps) mu is its zeros
        mus = [adam.state[p].get("mu", torch.zeros_like(p, dtype=getattr(
            torch, mu))) for p in model.ps]
        trace.append(([p.detach().numpy().copy() for p in model.ps],
                      [m.float().numpy() for m in mus],
                      [m.dtype for m in mus]))
    return opt, trace


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_bf16_moments_match_optax(clip, k):
    """``adam_mu_dtype='bfloat16'`` against ``optax.adamw(mu_dtype=bf16)``
    (with the clip at 0.5, which fires on every update, and under
    MultiSteps k = 3), 3 updates: every mini-step's parameters within 1e-6;
    the stored first moments bf16 on both sides, each within one bf16 ulp
    of optax's and at most 0.5% of them not bitwise equal (optax's order:
    b1 rounded to bf16, the sum in f32, mu rounded last; the f32 sum's last
    bit can differ between XLA's fused multiply-add and torch's two ops,
    which moves the rounding of a value near a bf16 tie: 1 of the 52,464
    stored moments over the four cases here)."""
    params, grads = _data(10 + k + (clip is not None), k)
    want = _optax(params, grads, clip=clip, k=k, mu_dtype=jnp.bfloat16)
    _, got = _port(params, grads, clip=clip, k=k, mu="bfloat16")
    off, total = [], []
    for i, ((gp, gm, gd), (wp, wm, wd)) in enumerate(zip(got, want)):
        assert set(gd) == {torch.bfloat16}
        assert set(wd) == {np.dtype(jnp.bfloat16)}
        for x, y in zip(gp, wp):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6,
                                       err_msg=f"mini-step {i + 1}")
        for x, y in zip(gm, wm):
            # the bf16 bit patterns (the values are exact bf16, held as f32)
            bx, by = (np.asarray(a, np.float32).view(np.int32) >> 16
                      for a in (x, y))
            assert np.abs(bx - by).max() <= 1, f"mu {i + 1}"
            off.append(int((bx != by).sum()))
            total.append(bx.size)
    assert sum(off) <= 0.005 * sum(total), (sum(off), sum(total))
    moved = max(np.abs(x - y).max() for x, y in zip(got[-1][0], params))
    assert moved > 1e-3


SCHEDULES = {
    "warmup": optax.linear_schedule(0.0, LR, transition_steps=4),
    "cosine": optax.cosine_decay_schedule(LR, decay_steps=5, alpha=0.1),
}


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_optax(name, k):
    """``make_optimizer(..., schedule=lambda n: float(sched(n)))`` against
    ``optax.adamw(sched)`` (and under MultiSteps k = 3, where the schedule
    moves once in k mini-steps): the schedule is read at optax's count, 0
    on the first update; parameters within 1e-6 at every mini-step."""
    sched = SCHEDULES[name]
    params, grads = _data(20 + k, k)
    want = _optax(params, grads, k=k, lr=sched)
    opt, got = _port(params, grads, k=k,
                     schedule=lambda n: float(sched(n)))
    for i, ((gp, _, _), (wp, _, _)) in enumerate(zip(got, want)):
        for x, y in zip(gp, wp):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6,
                                       err_msg=f"mini-step {i + 1}")
    adam = opt.adamw if isinstance(opt, ClipAccumAdamW) else opt
    assert [g["count"] for g in adam.param_groups] == [UPDATES]


def test_bf16_moment_survives_a_checkpoint(tmp_path):
    """A bf16 first moment, its f32 second moment and optax's count through
    ``save_checkpoint`` / ``restore_checkpoint`` into a fresh optimizer:
    dtypes kept (torch's load would cast mu to the f32 parameters' dtype)
    and values bitwise; the next update of the restored state equals the
    next update of the original."""
    params, grads = _data(31, 1)
    cfg = MVLTConfig(lr=LR, adam_mu_dtype="bfloat16")

    def state():
        model = _Model(params)
        return TrainState(model=model, optimizer=make_optimizer(model, cfg))

    def update(st, g):
        st.optimizer.zero_grad()
        for p, x in zip(st.model.ps, g):
            p.grad = torch.from_numpy(x.copy())
        st.optimizer.step()
        st.step += 1

    a = state()
    for g in grads[:2]:
        update(a, g)
    checkpoint.save_checkpoint(str(tmp_path), a)
    b, ok = checkpoint.restore_checkpoint(str(tmp_path), state())
    assert ok and b.step == 2
    for pa, pb in zip(a.model.ps, b.model.ps):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert sb["mu"].dtype == torch.bfloat16
        assert sb["nu"].dtype == torch.float32
        assert torch.equal(sa["mu"], sb["mu"])
        assert torch.equal(sa["nu"], sb["nu"])
    assert b.optimizer.param_groups[0]["count"] == 2
    update(a, grads[2])
    update(b, grads[2])
    for pa, pb in zip(a.model.ps, b.model.ps):
        assert torch.equal(pa, pb)


# --- profiling hooks ----------------------------------------------------------

def test_trace_annotate_and_step_timer_on_cpu(tmp_path):
    """``trace`` writes one Chrome trace under its directory that names the
    ``annotate`` range and the ops inside it; ``StepTimer.stop`` returns the
    host time (a CPU tensor needs no device sync); ``print_obj`` dumps an
    object's fields to stdout or a logger."""
    x = torch.randn(64, 64)
    timer = profiling.StepTimer()
    with profiling.trace(str(tmp_path / "tb")) as prof:
        timer.start()
        with profiling.annotate("mvlt test step"):
            y = (x @ x).relu().sum()
        took = timer.stop(y)
    assert took > 0
    path = tmp_path / "tb" / profiling.TRACE_FILE
    assert os.listdir(tmp_path / "tb") == [profiling.TRACE_FILE]
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "mvlt test step" in names and "aten::mm" in names
    assert any(e.key == "mvlt test step" for e in prof.key_averages())
    with pytest.raises(AssertionError):
        profiling.StepTimer().stop()

    class Obj:
        def __init__(self):
            self.lr, self.name = 1e-4, "mvlt"

    lines = []
    logger = logging.getLogger("print_obj_test")
    logger.addHandler(type("H", (logging.Handler,), {
        "emit": lambda self, r: lines.append(r.getMessage())})())
    logger.setLevel(logging.INFO)
    print_obj(Obj(), logger)
    assert lines == ["lr: 0.0001", "name: mvlt"]

"""The port's optimizer options against optax (``mvlt_tpu/train/state.py:
40-52``): ``grad_clip_norm`` (``optax.clip_by_global_norm``) and
``grad_accum_steps`` (``optax.MultiSteps`` around the chain), 6 updates on
the same parameters and gradients from a numpy seed, float32.

The parameters have a model's scale (normal, std 0.02, as the port's
``init_seeded_`` draws them) and the gradients unit scale, so the clip at
0.5 fires on every update; the learning rate is 1e-3, so that 6 updates
move each parameter by about 0.3 of its scale. The bar is 1e-6 absolute
on every parameter: ``torch.optim.AdamW`` and optax's ``adamw`` round
their updates in another order (about 1e-8 here)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvlt_tpu_torch.config import MVLTConfig
from mvlt_tpu_torch.train.state import ClipAccumAdamW, make_optimizer

torch.set_num_threads(2)

SHAPES = [(64, 32), (32,), (3, 5, 7), (1,)]
LR, UPDATES = 1e-3, 6


def _data(seed, k):
    rng = np.random.default_rng(seed)
    params = [(0.02 * rng.normal(size=s)).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(UPDATES * k)]
    return params, grads


def _optax(params, grads, clip, k):
    cfg = MVLTConfig()
    tx = optax.adamw(LR, b1=cfg.adam_b1, b2=cfg.adam_b2, eps=cfg.adam_eps,
                     weight_decay=cfg.weight_decay)
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
        trace.append([np.asarray(x) for x in p])
    return trace


class _Model(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.ps = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])


def _port(params, grads, clip, k):
    model = _Model(params)
    cfg = MVLTConfig(lr=LR)
    opt = make_optimizer(model, cfg, grad_clip_norm=clip, grad_accum_steps=k)
    trace = []
    for g in grads:
        opt.zero_grad()
        for p, x in zip(model.ps, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        trace.append([p.detach().numpy().copy() for p in model.ps])
    return opt, trace


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_clip_and_accumulation_match_optax(k, clip):
    """Every mini-step's parameters equal optax's within 1e-6: between
    the k-th calls they do not move (MultiSteps emits zero updates), and
    on them AdamW takes the clipped mean of the k gradients."""
    params, grads = _data(k + (clip is not None), k)
    want = _optax(params, grads, clip, k)
    opt, got = _port(params, grads, clip, k)
    assert isinstance(opt, torch.optim.AdamW) == (k == 1 and clip is None)
    for i, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6,
                                       err_msg=f"mini-step {i + 1}")
        if k > 1 and (i + 1) % k:
            # no update between the k-th mini-steps
            ref = params if i + 1 < k else got[(i + 1) // k * k - 1]
            for x, y in zip(a, ref):
                np.testing.assert_array_equal(x, y)
    # the parameters moved: the clip fired and the update is not trivial
    moved = max(np.abs(x - y).max() for x, y in zip(got[-1], params))
    assert moved > 1e-3


def test_accumulation_moves_adamw_count_once_in_k():
    """AdamW's count (and so its bias correction) moves on the k-th
    mini-step only, as optax's inner state does under MultiSteps."""
    params, grads = _data(7, 3)
    opt, _ = _port(params, grads[:5], None, 3)
    assert isinstance(opt, ClipAccumAdamW)
    counts = {int(s["step"]) for s in opt.adamw.state.values()}
    assert counts == {1} and opt.mini_step == 2


def test_bf16_moments_still_raise():
    model = _Model([np.zeros(3, np.float32)])
    with pytest.raises(NotImplementedError, match="AdamW options"):
        make_optimizer(model, MVLTConfig(adam_mu_dtype="bfloat16"))

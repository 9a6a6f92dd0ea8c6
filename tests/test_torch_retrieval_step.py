"""The port's retrieval train step against the JAX package's, on the same
weights, the same ``cat(pos, neg)`` batch from a numpy seed and the same
DropPath and attention-dropout masks, in float32 at 1e-4.

The model is ``test_torch_retrieval.py``'s (tiny Swin with DropPath 0.3, a
2-layer fusion encoder, ``for_retrieval``: attention dropout 0.1, hidden
dropout 0.0). JAX's ``jax.random.bernoulli`` draws from numpy and keeps
each mask in call order (the backbone's DropPath first, then each fusion
layer's attention mask; no hidden mask at rate 0), and the port replays
that list through ``DropoutMasks.replay``. JAX runs its XLA route and its
fused encoder in interpret mode (``MVLT_FORCE_FUSED_ENCODER=1``:
``fused_attn_ln_masked`` with an amask and no hmask, ``fused_mlp_ln``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.models.heads import RetrievalModel as JaxRetrieval
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.train.state import make_optimizer
from mvlt_tpu_torch.train.steps import make_retrieval_step
from mvlt_tpu_torch.utils.convert import retrieval_params_from_flax
from test_torch_retrieval import (IMG, L, _perturbed, jax_config,
                                  port_config, port_model)

torch.set_num_threads(2)

PAIRS = 2
ROWS = 2 * PAIRS
S = 1 + 16 + 1 + L
KEYS = ("image", "caption", "label")
ROUTES = ["xla", "fused encoder, interpret"]


def _batch():
    b = flagship.example_retrieval_batch(PAIRS, L, seed=4, image_size=IMG,
                                         vocab=300)
    return {k: v.numpy() for k, v in b.items()}


def _jax_args(batch):
    return [jnp.asarray(batch["image"])] + [
        jnp.asarray(batch[k], jnp.int32) for k in KEYS[1:]]


def _inject_masks(monkeypatch, seed):
    """Patch ``jax.random.bernoulli`` to draw from numpy; returns the list
    the masks are appended to, in call order."""
    rng, drawn = np.random.default_rng(seed), []

    def bernoulli(key, p=0.5, shape=None, mode="low"):
        mask = rng.random(tuple(shape)) < p
        drawn.append(mask)
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return drawn


def _replay(drawn):
    """JAX draws each DropPath mask as (B, 1, 1); the port takes it as its
    (B,) draw."""
    return DropoutMasks.replay(m.reshape(ROWS) if m.shape == (ROWS, 1, 1)
                               else m for m in drawn)


@pytest.fixture(scope="module")
def tiny():
    cfg = jax_config()
    batch = _batch()
    variables = jax.jit(JaxRetrieval(cfg).init)(
        jax.random.PRNGKey(0), *_jax_args(batch)[:2])
    return cfg, _perturbed(variables, seed=2)


def _route(monkeypatch, route):
    if route != "xla":
        monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")


def _jax_loss_and_grads(cfg, variables, batch):
    jm = JaxRetrieval(cfg)

    def loss_fn(params):
        return jm.apply({"params": params}, *_jax_args(batch),
                        deterministic=False, method=jm.loss,
                        rngs={"dropout": jax.random.PRNGKey(3)})

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])


def _check_grads(model, grads):
    want = retrieval_params_from_flax({"params": grads})
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("route", ROUTES)
def test_loss_and_grads_match_jax_with_dropout(tiny, route, monkeypatch):
    """``RetrievalModel.loss`` on the ``cat(pos, neg)`` batch: the masks JAX
    drew (6 DropPath draws, then one (B, nH, S, S) attention mask per
    fusion layer and no hidden mask), the CE within 1e-5, the logits within
    1e-4 and every gradient within 1e-4 x max|grad|."""
    cfg, variables = tiny
    _route(monkeypatch, route)
    batch = _batch()
    drawn = _inject_masks(monkeypatch, 7)
    (want_loss, want_logits), grads = _jax_loss_and_grads(cfg, variables,
                                                          batch)
    assert [m.shape for m in drawn] == [(ROWS, 1, 1)] * 6 + [
        (ROWS, 2, S, S)] * 2
    model = port_model(cfg, variables)
    loss, logits = model.loss(*(torch.from_numpy(batch[k]) for k in KEYS),
                              masks=_replay(drawn))
    loss.backward()
    assert logits.shape == (ROWS, 2)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=1e-4, rtol=0)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    _check_grads(model, grads)


def test_retrieval_step_matches_jax_step(tiny, monkeypatch):
    """One ``make_retrieval_step`` against JAX's (``steps.py:266-279``) with
    the masks JAX took when its step was traced: loss and accuracy, the
    step's gradients against ``jax.grad`` of the loss on those masks, and
    every updated parameter, each within 1e-4."""
    from mvlt_tpu.train.state import create_train_state
    from mvlt_tpu.train.state import make_optimizer as jax_optimizer
    from mvlt_tpu.train.steps import make_retrieval_step as jax_step

    cfg, variables = tiny
    batch = _batch()
    drawn = _inject_masks(monkeypatch, 8)
    jm = JaxRetrieval(cfg)
    state = create_train_state(jm, jax.tree.map(jnp.array, variables),
                               jax_optimizer(cfg))
    state, metrics = jax_step(jm)(state, dict(zip(KEYS, _jax_args(batch))),
                                  jax.random.PRNGKey(0))
    assert len(drawn) == 6 + 2
    step_masks = list(drawn)
    model = port_model(cfg, variables)
    step = make_retrieval_step(model, make_optimizer(model, model.config))
    step.masks = _replay(step_masks)
    out = step({k: torch.from_numpy(batch[k]) for k in KEYS})
    assert abs(float(out["loss"]) - float(metrics["loss"])) <= 1e-4
    assert float(out["accuracy"]) == float(metrics["accuracy"])
    # the grads JAX's step took: jax.grad of the loss on the step's masks
    monkeypatch.setattr(jax.random, "bernoulli", _replaying(step_masks))
    _, grads = _jax_loss_and_grads(cfg, variables, batch)
    _check_grads(model, grads)
    want = retrieval_params_from_flax({"params": state.params})
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        err = float(np.abs(value.numpy() - want[name].numpy()).max())
        assert err <= 1e-4, (name, err)


def _replaying(masks):
    """A ``jax.random.bernoulli`` that hands out ``masks`` in order."""
    it = iter(masks)

    def bernoulli(key, p=0.5, shape=None, mode="low"):
        mask = next(it)
        assert mask.shape == tuple(shape)
        return jnp.asarray(mask)
    return bernoulli


def test_build_retrieval_train_step_on_cpu(tiny):
    """``build_retrieval_train_step`` at the tiny size on the CPU (plain
    versions, f32): 2 * pairs rows, an accuracy in [0, 1], and finite
    losses that fall at a learning rate of 1e-3 when every step replays the
    first step's masks (so that the draws do not hide the descent); without
    CUDA, ``device='cuda'`` raises."""
    cfg = dataclasses.replace(port_config(tiny[0]), lr=1e-3)
    step, batch = flagship.build_retrieval_train_step(
        pairs=3, text_len=L, device="cpu", compute_dtype=torch.float32,
        config=cfg, image_size=IMG)
    assert batch["image"].shape[0] == batch["label"].shape[0] == 6
    step.masks = DropoutMasks(torch.Generator().manual_seed(0), record=True)
    outs = [step(batch)]
    recorded = step.masks.recorded
    for _ in range(2):
        step.masks = DropoutMasks.replay(recorded)
        outs.append(step(batch))
    losses = [float(o["loss"]) for o in outs]
    assert np.isfinite(losses).all() and losses[2] < losses[1] < losses[0]
    assert all(0.0 <= float(o["accuracy"]) <= 1.0 for o in outs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            flagship.build_retrieval_train_step(pairs=1, device="cuda")

"""The port's VQA finetune train step against the JAX package, on the same
weights (through ``vqa_params_from_flax``) and the same inputs from a numpy
seed: a tiny ResNet (``layers=(1, 1), width=8``) + ``resnet_fc`` + a 2-layer
fusion encoder, fusion dropouts 0.0.

float32: every gradient within 1e-4 x max|grad| of its tensor (the same
math; only summation order differs), against JAX's XLA path and against its
fused encoder (Pallas forwards in interpret mode, store-residual VJPs).
bfloat16: the JAX graph runs the interpret backward kernels
(``seq_attention_core_bwd``, ``mlp_ln_half_bwd``). Both sides round
activations to bf16 at different places. Fusion-encoder and head gradients:
0.05 x max|grad| per tensor against JAX bf16 (measured up to 0.025; each side
is within ~0.01 of the f32 gradients). The ResNet's gradients at this tiny
size (BatchNorm over 4 images of 8-64 channels) are dominated by bf16
rounding in both packages: JAX bf16 is up to 0.24 from its own f32
gradient in relative Frobenius norm, the port up to 0.31. They are held at
1e-4 in f32 above; here each is held to 0.4 of the f32 gradient's norm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.models.backbones.resnet import ResNet as JaxResNet
from mvlt_tpu.models.heads import VQAModel as JaxVQA
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.models.backbones.resnet import ResNet
from mvlt_tpu_torch.models.heads import VQAModel
from mvlt_tpu_torch.ops.layers import DropoutMasks, cross_entropy_ignore_index
from mvlt_tpu_torch.train.state import make_optimizer
from mvlt_tpu_torch.train.steps import make_vqa_step
from mvlt_tpu_torch.utils.convert import vqa_params_from_flax

torch.set_num_threads(2)

TINY_RESNET = dict(layers=(1, 1), width=8)
IMG, B, L = 32, 4, 7


def _jax_config():
    cfg = jcfg.MVLTConfig.for_vqa(result_num=10)
    return dataclasses.replace(
        cfg, conv="resnet50", resnet=jcfg.ResNetConfig(**TINY_RESNET),
        fusion=dataclasses.replace(
            cfg.fusion, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, vocab_size=300,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))


def _port_config(cfg):
    """The port's config with the same fields as a JAX one."""
    d = dataclasses.asdict(cfg)
    return pcfg.MVLTConfig(
        fusion=pcfg.FusionConfig(**d.pop("fusion")),
        swin=pcfg.SwinConfig(**d.pop("swin")),
        resnet=pcfg.ResNetConfig(**d.pop("resnet")),
        vit=pcfg.ViTConfig(**d.pop("vit")), **d)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(B, 3, IMG, IMG)).astype(np.float32)
    question = rng.integers(1, 300, size=(B, L))
    question[0, 4:] = 0                      # padded question tokens
    question[2, 5:] = 0
    label = rng.integers(0, 10, size=B)
    label[1] = -100                          # an ignored label
    return image, question, label


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32) + rng.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, perturbed flax variables incl. batch_stats, inputs)."""
    cfg = _jax_config()
    image, question, label = _inputs()
    variables = JaxVQA(cfg).init(jax.random.PRNGKey(0), jnp.asarray(image),
                                 jnp.asarray(question, jnp.int32))
    variables = {"params": _perturb(variables["params"], 1),
                 "batch_stats": jax.tree.map(np.asarray,
                                             variables["batch_stats"])}
    return cfg, variables, (image, question, label)


def _port_model(cfg, variables, compute_dtype=None):
    model = VQAModel(_port_config(cfg), dtype=torch.float32,
                     compute_dtype=compute_dtype)
    model.load_state_dict(vqa_params_from_flax(variables))
    return model


def _jax_grads(cfg, variables, inputs, dtype=jnp.float32):
    image, question, label = inputs
    model = JaxVQA(cfg, dtype=dtype)

    def loss_fn(params):
        (loss, _), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(image), jnp.asarray(question, jnp.int32),
            jnp.asarray(label, jnp.int32), deterministic=False,
            method=model.loss, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(3)})
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    return float(loss), vqa_params_from_flax({"params": grads})


def _port_grads(model, inputs):
    image, question, label = (torch.from_numpy(np.asarray(a)) for a in inputs)
    loss, _ = model.loss(image, question, label)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def _assert_grads_close(got, want, bar):
    assert set(got) == set(want)
    worst = (0.0, None)
    for name, g in got.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.detach().float().numpy() - w).max())
        assert err <= bar * scale, (name, err, scale)
        worst = max(worst, (err / scale, name))
    return worst


@pytest.mark.parametrize("fused", [False, True])
def test_grads_match_jax_f32(tiny, fused, monkeypatch):
    cfg, variables, inputs = tiny
    if fused:
        monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    want_loss, want = _jax_grads(cfg, variables, inputs)
    got_loss, got = _port_grads(_port_model(cfg, variables), inputs)
    assert abs(got_loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
    _assert_grads_close(got, want, 1e-4)


def test_grads_near_jax_bf16_interpret_backward_kernels(tiny, monkeypatch):
    cfg, variables, inputs = tiny
    monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    _, exact = _jax_grads(cfg, variables, inputs)
    want_loss, want = _jax_grads(cfg, variables, inputs, jnp.bfloat16)
    got_loss, got = _port_grads(
        _port_model(cfg, variables, torch.bfloat16), inputs)
    assert abs(got_loss - want_loss) <= 1e-3 * max(1.0, abs(want_loss))
    resnet = {n for n in got if n.startswith("conv.backbone.")}
    _assert_grads_close({n: g for n, g in got.items() if n not in resnet},
                        {n: g for n, g in want.items() if n not in resnet},
                        0.05)
    for name in resnet:
        f32 = exact[name].numpy()
        err = np.linalg.norm(got[name].float().numpy() - f32)
        assert err <= 0.4 * np.linalg.norm(f32), name


def test_three_steps_match_jax_step(tiny):
    """Three ``make_vqa_step`` steps against the JAX step (mesh None): the
    loss of each step within 1e-4, then every parameter within 3e-4 (AdamW
    moves an element by about lr = 4e-5 a step whatever its gradient, so an
    element whose gradient is at rounding level may move the other way:
    at most 2 lr a step) and the BatchNorm running statistics within
    1e-4 x max|value|."""
    from mvlt_tpu.train.state import create_train_state
    from mvlt_tpu.train.state import make_optimizer as jax_optimizer
    from mvlt_tpu.train.steps import make_vqa_step as jax_vqa_step

    cfg, variables, (image, question, label) = tiny
    jmodel = JaxVQA(cfg)
    state = create_train_state(jmodel, jax.tree.map(jnp.array, variables),
                               jax_optimizer(cfg))
    jstep = jax_vqa_step(jmodel)
    jbatch = {"image": jnp.asarray(image),
              "question": jnp.asarray(question, jnp.int32),
              "label": jnp.asarray(label, jnp.int32)}

    model = _port_model(cfg, variables)
    step = make_vqa_step(model, make_optimizer(model, model.config))
    batch = {"image": torch.from_numpy(image),
             "question": torch.from_numpy(question),
             "label": torch.from_numpy(label)}
    for i in range(3):
        state, jm = jstep(state, jbatch, jax.random.PRNGKey(i))
        pm = step(batch)
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-4, i
        assert float(pm["accuracy"]) == pytest.approx(float(jm["accuracy"]))

    want = vqa_params_from_flax({"params": state.params,
                                 "batch_stats": state.extra_variables[
                                     "batch_stats"]})
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        w = want[name].numpy()
        err = float(np.abs(value.numpy() - w).max())
        if name.endswith(("running_mean", "running_var")):
            assert err <= 1e-4 * max(1.0, float(np.abs(w).max())), name
        else:
            assert err <= 3e-4, (name, err)


@pytest.mark.parametrize("train", [False, True])
def test_resnet_features_and_batch_stats_match_jax(train):
    """The tiny ResNet on its own: features at 1e-4, and in training the
    running statistics after one flax-style update (momentum 0.9, biased
    batch variance)."""
    rng = np.random.default_rng(5)
    image = rng.normal(size=(3, 3, IMG, IMG)).astype(np.float32)
    rcfg = jcfg.ResNetConfig(**TINY_RESNET)
    jmodel = JaxResNet(rcfg)
    x = jnp.asarray(image.transpose(0, 2, 3, 1))
    variables = jmodel.init(jax.random.PRNGKey(1), x)
    variables = {"params": _perturb(variables["params"], 2),
                 "batch_stats": _perturb(variables["batch_stats"], 3)}
    want, mut = jmodel.apply(variables, x, deterministic=not train,
                             mutable=["batch_stats"])
    model = ResNet(pcfg.ResNetConfig(**TINY_RESNET), dtype=torch.float32,
                   device="cpu")
    sd = vqa_params_from_flax({
        "params": {"conv": {"backbone": variables["params"]}},
        "batch_stats": {"conv": {"backbone": variables["batch_stats"]}}})
    model.load_state_dict({k[len("conv.backbone."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(image), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    stats = vqa_params_from_flax({
        "params": {}, "batch_stats": {"conv": {"backbone":
                                               mut["batch_stats"]}}})
    for name, value in stats.items():
        np.testing.assert_allclose(
            model.state_dict()[name[len("conv.backbone."):]].numpy(),
            value.numpy(), atol=1e-5, rtol=1e-5)


def test_resnet_tree_maps_every_leaf_once(tiny):
    cfg, variables, _ = tiny
    sd = vqa_params_from_flax(variables)
    model = VQAModel(_port_config(cfg))
    assert set(sd) == set(model.state_dict())
    assert tuple(sd["conv.backbone.stem.conv.weight"].shape) == (8, 3, 7, 7)
    assert "conv.backbone.blocks.layer2_0.downsample.bn.running_var" in sd
    bad = {"params": variables["params"], "batch_stats": dict(
        variables["batch_stats"], extra={"mean": np.zeros(3)})}
    with pytest.raises(KeyError):
        vqa_params_from_flax(bad)
    missing = vqa_params_from_flax({"params": variables["params"]})
    with pytest.raises(RuntimeError, match="running_mean"):
        model.load_state_dict(missing)


@pytest.mark.parametrize("make", ["for_vqa", "for_pretrain", "swin_small",
                                  "swin_base", "swin_tiny_test", "resnet101",
                                  "resnet50"])
def test_config_copy_matches_jax(make):
    ours = getattr(pcfg.MVLTConfig, make, None) or getattr(pcfg, make)
    theirs = getattr(jcfg.MVLTConfig, make, None) or getattr(jcfg, make)
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_cross_entropy_ignore_index_matches_jax():
    from mvlt_tpu.ops.layers import cross_entropy_ignore_index as jce
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=6)
    labels[[1, 4]] = -100
    got = cross_entropy_ignore_index(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
    want = jce(jnp.asarray(logits), jnp.asarray(labels))
    assert abs(float(got) - float(want)) <= 1e-6
    none = cross_entropy_ignore_index(torch.from_numpy(logits),
                                      torch.full((6,), -100))
    assert float(none) == 0.0


def test_build_vqa_train_step_on_cpu_counts_nothing_and_learns():
    """``build_vqa_train_step`` at a tiny size on the CPU (plain versions):
    seeded weights and labels, three steps lower the loss, and no CUDA
    launch is counted."""
    from mvlt_tpu_torch.ops import blocks, kernels
    cfg = _port_config(_jax_config())
    before = [f.launches for f in (*kernels.KERNELS, *blocks.COUNTERPARTS)]
    step, batch = flagship.build_vqa_train_step(
        batch=B, seq_len=L, device="cpu", compute_dtype=torch.float32,
        config=cfg, image_size=IMG)
    assert batch["label"].min() >= 0 and batch["label"].max() < 10
    losses = [float(step(batch)["loss"]) for _ in range(3)]
    assert losses[2] < losses[0] and np.isfinite(losses).all()
    after = [f.launches for f in (*kernels.KERNELS, *blocks.COUNTERPARTS)]
    assert before == after


def test_flagship_train_config():
    cfg = flagship.flagship_vqa_train_config()
    assert (cfg.conv, cfg.resnet.layers, cfg.result_num) == \
        ("resnet101", (3, 4, 23, 3), 224)
    assert cfg.fusion.hidden_dropout_prob == 0.0
    assert cfg.fusion.attention_probs_dropout_prob == 0.0
    assert cfg.resnet.feature_channels == 2048


def test_build_vqa_train_step_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship.build_vqa_train_step(batch=1, device="cuda")


def test_grads_match_jax_with_fusion_dropout(tiny, monkeypatch):
    """Fusion dropouts 0.1 (the ``for_vqa`` default) and the pooled output's
    dropout, f32, the JAX side on its fused encoder: each mask JAX takes is
    drawn from numpy by a patched ``jax.random.bernoulli`` and replayed to
    the port in the same order (as tests/test_torch_pretrain.py does). The
    loss within 1e-5 and every gradient within 1e-4 x max|grad|. Without a
    mask source the port's loss refuses to train with dropout."""
    cfg, variables, inputs = tiny
    drop = dataclasses.replace(cfg, fusion=dataclasses.replace(
        cfg.fusion, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1))
    monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    rng, drawn = np.random.default_rng(6), []

    def bernoulli(key, p=0.5, shape=None, mode="low"):
        drawn.append(rng.random(tuple(shape)) < p)
        return jnp.asarray(drawn[-1])

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    want_loss, want = _jax_grads(drop, variables, inputs)
    assert len(drawn) == 2 * 3 + 1 and drawn[-1].shape == (B, 32)
    model = _port_model(drop, variables)
    tin = [torch.from_numpy(np.asarray(a)) for a in inputs]
    with pytest.raises(ValueError, match="mask source"):
        model.loss(*tin)
    loss, _ = model.loss(*tin, masks=DropoutMasks.replay(drawn))
    loss.backward()
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * max(1.0, want_loss)
    _assert_grads_close({n: p.grad for n, p in model.named_parameters()},
                        want, 1e-4)

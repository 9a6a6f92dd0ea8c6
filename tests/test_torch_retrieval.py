"""The port's retrieval slice against the JAX package, on the same weights
(through ``retrieval_params_from_flax``) and the same inputs from a numpy
seed, in float32 at 1e-4: ``RetrievalModel``'s logits, P(match), image
features and fusion-only score (JAX on its XLA route and on its fused
encoder in interpret mode); the N x N ``score_grid`` against JAX's through
a ``TaskRunner`` over a ``RetrievalDataset`` (n = 5 in chunks of 2, so the
last chunk is ragged, with a duplicate report); the copied rank metrics
(bitwise); the routing of the full-width grid and step on the ``meta``
device; and the builders on the CPU. The train step is
``test_torch_retrieval_step.py``.

The model is the tiny Swin of ``test_torch_caption.py`` (DropPath 0.3) and
a 2-layer fusion encoder of its width, ``for_retrieval`` (attention dropout
0.1, hidden dropout 0.0) with the packaged WordPiece vocabulary.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.data.datasets import RetrievalDataset, SyntheticSource
from mvlt_tpu.metrics import retrieval as jax_metrics
from mvlt_tpu.models.heads import RetrievalModel as JaxRetrieval
from mvlt_tpu.tasks import retrieval as jax_tasks
from mvlt_tpu.tasks.common import TaskRunner
from mvlt_tpu.text.tokenizer import WordPieceTokenizer, find_default_vocab
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.metrics import retrieval as port_metrics
from mvlt_tpu_torch.models.heads import RetrievalModel
from mvlt_tpu_torch.ops import blocks, kernels
from mvlt_tpu_torch.ops.layers import DropoutMasks
from mvlt_tpu_torch.tasks import retrieval as port_tasks
from mvlt_tpu_torch.utils.convert import retrieval_params_from_flax

torch.set_num_threads(2)

B, L, IMG = 3, 9, 32
TOKENIZER = WordPieceTokenizer(find_default_vocab())


def jax_config():
    cfg = jcfg.MVLTConfig.for_retrieval(max_length=L).with_tokenizer(
        TOKENIZER)
    return dataclasses.replace(
        cfg, conv="swin",
        swin=dataclasses.replace(jcfg.swin_tiny_test(), depths=(2, 2),
                                 drop_path_rate=0.3),
        fusion=dataclasses.replace(
            cfg.fusion, hidden_size=16, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=32))


def port_config(cfg):
    d = dataclasses.asdict(cfg)
    return pcfg.MVLTConfig(
        fusion=pcfg.FusionConfig(**d.pop("fusion")),
        swin=pcfg.SwinConfig(**d.pop("swin")),
        resnet=pcfg.ResNetConfig(**d.pop("resnet")),
        vit=pcfg.ViTConfig(**d.pop("vit")), **d)


def _inputs(seed=3):
    """(image (B, 3, 32, 32), caption (B, L) with padding) as numpy."""
    rng = np.random.default_rng(seed)
    image = rng.normal(size=(B, 3, IMG, IMG)).astype(np.float32)
    caption = flagship._example_captions(rng, B, L, 300, 104)
    return image, caption


def _perturbed(variables, seed=1):
    """Every leaf + normal(0, 0.05): LN gammas / betas and biases become
    non-trivial, so each parameter's mapping shows in the output."""
    rng = np.random.default_rng(seed)
    return {"params": jax.tree.map(lambda a: np.asarray(a, np.float32) +
                                   rng.normal(0.0, 0.05, np.shape(a)).astype(
                                       np.float32), variables["params"])}


@pytest.fixture(scope="module")
def tiny():
    cfg = jax_config()
    image, caption = _inputs()
    variables = jax.jit(JaxRetrieval(cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(image),
        jnp.asarray(caption, jnp.int32))
    return cfg, _perturbed(variables)


def port_model(cfg, variables):
    model = RetrievalModel(port_config(cfg), device="cpu")
    model.load_state_dict(retrieval_params_from_flax(variables))   # strict
    return model


def test_params_from_flax_maps_the_retrieval_tree(tiny):
    """Every leaf of the flax tree (backbone, fusion with its pooler,
    ``final_transform``, ``final_linear``) lands on one port parameter, and
    every port parameter gets one."""
    cfg, variables = tiny
    sd = retrieval_params_from_flax(variables)
    leaves = jax.tree_util.tree_leaves(variables["params"])
    fused = 3 * cfg.fusion.num_hidden_layers * 2     # q / k / v into qkv
    assert len(sd) == len(leaves) - fused + fused // 3
    assert set(sd) == set(port_model(cfg, variables).state_dict())
    assert {"final_linear.weight", "final_linear.bias",
            "final_transform.transform_dense.weight",
            "final_transform.transform_layernorm.bias"} <= set(sd)
    assert sd["final_linear.weight"].shape == (2, 16)


@pytest.mark.parametrize("route", ["xla", "fused encoder, interpret"])
def test_retrieval_forward_matches_jax(tiny, route, monkeypatch):
    """Logits (B, 2), P(match), the backbone features and the fusion-only
    score of those features, against JAX's ``RetrievalModel`` on its XLA
    route and with its BERT layers on the Pallas kernels in interpret mode
    (``MVLT_FORCE_FUSED_ENCODER=1``), within 1e-4."""
    cfg, variables = tiny
    if route != "xla":
        monkeypatch.setenv("MVLT_FORCE_FUSED_ENCODER", "1")
    image, caption = _inputs()
    jm = JaxRetrieval(cfg)
    ji, jc = jnp.asarray(image), jnp.asarray(caption, jnp.int32)
    apply = jax.jit(jm.apply, static_argnames="method")
    want_logits = apply(variables, ji, jc)
    want_score = apply(variables, ji, jc, method=jm.score)
    want_feat = apply(variables, ji, method=jm.encode_image)
    want_from_feat = apply(variables, want_feat, jc,
                           method=jm.score_from_features)
    model = port_model(cfg, variables)
    ti, tc = torch.from_numpy(image), torch.from_numpy(caption)
    feat = model.encode_image(ti)
    got = {"logits": model(ti, tc), "score": model.score(ti, tc),
           "features": feat,
           "score_from_features": model.score_from_features(feat, tc)}
    want = {"logits": want_logits, "score": want_score,
            "features": want_feat, "score_from_features": want_from_feat}
    assert got["logits"].shape == (B, 2) and got["score"].shape == (B,)
    assert got["score"].dtype == torch.float32
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0, err_msg=k)


class _DuplicateReports(SyntheticSource):
    """A synthetic source whose sample 3 repeats sample 1's report and
    shares its ``cap_id``, as duplicate reports do in a test set."""

    def __init__(self, n):
        super().__init__(n=n)
        self.captions[3] = self.captions[1]

    def _cap_id(self, index):
        return 1 if index == 3 else index

    def __getitem__(self, index):
        im, cap, idx, _ = super().__getitem__(index)
        return im, cap, idx, self._cap_id(index)

    def peek(self, index):
        return self.captions[index], self._cap_id(index)


@pytest.fixture(scope="module")
def grid_case(tiny):
    """JAX's ``score_grid`` through a ``TaskRunner`` over a ``RetrievalDataset``
    of 5 samples in chunks of 2, and the three arrays it read."""
    cfg, variables = tiny
    test_ds = RetrievalDataset(_DuplicateReports(5), TOKENIZER, max_length=L,
                               split="test")
    runner = TaskRunner(JaxRetrieval(cfg), cfg,
                        jcfg.TrainConfig(batch_size=2), name="test-ret-port")
    s = test_ds[0]
    runner.init_state((jnp.asarray(s["image"][None]),
                       jnp.asarray(s["caption"][None])))
    runner.state = runner.state.replace(params=variables["params"])
    want = jax_tasks.score_grid(runner, test_ds, batch_size=2)
    images = np.stack([test_ds.source[i][0] for i in range(5)])
    captions = np.stack([test_ds._cap_ids(test_ds.source[i][1])
                         for i in range(5)])
    cap_ids = np.array([test_ds.source[i][3] for i in range(5)])
    return want, (images, captions, cap_ids)


def test_score_grid_matches_jax_task_runner(tiny, grid_case):
    """The port's ``score_images`` on the images, caption ids and ``cap_id``s
    that JAX's read out of the dataset, n = 5 in chunks of 2 (the last
    chunk ragged in the port, zero-padded in JAX): similarities within
    1e-4, labels (identity | equal ``cap_id``) and the R@k of both
    directions equal."""
    cfg, variables = tiny
    want, (images, captions, cap_ids) = grid_case
    got = port_tasks.score_images(port_model(cfg, variables),
                                  torch.from_numpy(images),
                                  torch.from_numpy(captions.astype(np.int64)),
                                  cap_ids, batch_size=2)
    assert got["similarities"].shape == (5, 5)
    assert got["similarities"].dtype == np.float32
    np.testing.assert_allclose(got["similarities"], want["similarities"],
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["labels"][1, 3] == got["labels"][3, 1] == 1
    assert port_metrics.evaluate_retrieval(
        got["similarities"], got["labels"]) == jax_metrics.evaluate_retrieval(
            want["similarities"], want["labels"])


def test_score_grid_equals_per_pair_score(tiny, grid_case):
    """The grid (backbone once per image, features broadcast) against the
    full model's ``score`` per pair (backbone per pair), within 1e-5."""
    cfg, variables = tiny
    _, (images, captions, cap_ids) = grid_case
    model = port_model(cfg, variables)
    caps = torch.from_numpy(captions.astype(np.int64))
    grid = port_tasks.score_images(model, images, caps, cap_ids,
                                   batch_size=2)["similarities"]
    image = torch.from_numpy(images)
    for i in range(5):
        row = model.score(image[i:i + 1].expand(5, -1, -1, -1), caps)
        np.testing.assert_allclose(grid[i], row.numpy(), atol=1e-5, rtol=0)


def _seeded_grid(seed, n):
    """Scores on a coarse lattice (many ties) and ``cap_id``s with
    duplicates."""
    rng = np.random.default_rng(seed)
    sims = np.round(rng.random((n, n)) * 4).astype(np.float32) / 4
    cap_ids = rng.integers(0, n - 3, size=n)
    return sims, ((np.arange(n)[:, None] == np.arange(n)[None, :])
                  | (cap_ids[:, None] == cap_ids[None, :])).astype(np.int32)


@pytest.mark.parametrize("seed,n", [(0, 7), (1, 12), (2, 30)])
def test_rank_metrics_match_jax_bitwise(seed, n):
    """``compute_ranks`` / ``recall_at_k`` / ``evaluate_retrieval`` equal
    the JAX package's on grids with ties and duplicate ``cap_id``s; a row
    with no match ranks n."""
    sims, labels = _seeded_grid(seed, n)
    labels[0] = 0
    assert port_metrics.compute_ranks(sims, labels) == \
        jax_metrics.compute_ranks(sims, labels)
    i2t, _ = port_metrics.compute_ranks(sims, labels)
    assert i2t[0] == n
    assert port_metrics.recall_at_k(i2t, (1, 3)) == \
        jax_metrics.recall_at_k(i2t, (1, 3))
    assert port_metrics.evaluate_retrieval(sims, labels) == \
        jax_metrics.evaluate_retrieval(sims, labels)


def test_flagship_retrieval_config_is_for_retrieval():
    """``flagship_retrieval_config`` is JAX's ``for_retrieval`` with Swin-S:
    attention dropout 0.1, hidden dropout 0.0, DropPath 0.3, caption length
    80 (S = 1 + 49 + 1 + 80 = 131), lr 1e-6."""
    want = jcfg.MVLTConfig.for_retrieval(conv="swin", swin=jcfg.swin_small())
    got = flagship.flagship_retrieval_config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.fusion.attention_probs_dropout_prob,
            got.fusion.hidden_dropout_prob, got.swin.drop_path_rate,
            got.max_length, got.lr, got.itm_task) == (0.1, 0.0, 0.3, 80,
                                                      1e-6, True)
    assert dataclasses.asdict(pcfg.MVLTConfig.for_retrieval()) == \
        dataclasses.asdict(jcfg.MVLTConfig.for_retrieval())


def test_example_retrieval_batch_is_pos_then_neg():
    """``cat(pos, neg)``: P positives labelled 1, then P negatives labelled
    0, each negative sharing exactly one of its image and its caption with
    its positive; both kinds of swap occur."""
    P = 16
    b = flagship.example_retrieval_batch(P, 12, seed=2, image_size=8)
    assert b["image"].shape == (2 * P, 3, 8, 8)
    assert b["caption"].shape == (2 * P, 12)
    assert b["label"].tolist() == [1] * P + [0] * P
    kinds = set()
    for i in range(P):
        same_image = torch.equal(b["image"][i], b["image"][P + i])
        same_caption = torch.equal(b["caption"][i], b["caption"][P + i])
        assert same_image != same_caption, i
        kinds.add(same_image)
    assert kinds == {True, False}
    row = b["caption"][0]
    n = int((row > 0).sum())
    assert n >= 5 and row[n - 1] == 104 and not row[n:].any()


class _KeepAll(DropoutMasks):
    """A mask source for the meta device: every unit kept."""

    def draw(self, keep, shape, device):
        return torch.ones(tuple(shape), dtype=torch.bool, device=device)


def _count_routes(monkeypatch):
    """Patch the plain twins to count their calls (and keep their
    arguments) and ``gemm`` to keep (M, N) of every product."""
    counts, calls, products = {}, {}, []
    suffix = {"launches": "", "shift_launches": "_shift",
              "train_launches": "_train",
              "train_shift_launches": "_train_shift"}

    def counted(name, fn):
        count = (blocks._full_block_count if name == "swin_full_block"
                 else blocks._shift_count)

        def call(x, *args, **kw):
            key = name + suffix[count(x, args, kw)]
            counts[key] = counts.get(key, 0) + 1
            calls.setdefault(name, []).append(args)
            return fn(x, *args, **kw)
        return call

    for fn in blocks.COUNTERPARTS:
        name = fn.__name__
        monkeypatch.setattr(blocks.PLAIN_OPS, name,
                            counted(name, getattr(blocks.PLAIN_OPS, name)))
    gemm = blocks.PLAIN_OPS.gemm

    def gemm_seen(a, w, *args, **kw):
        products.append((a.shape[0], w.shape[0]))
        return gemm(a, w, *args, **kw)

    monkeypatch.setattr(blocks.PLAIN_OPS, "gemm", gemm_seen)
    return counts, calls, products


def test_retrieval_grid_routing_on_meta_device(monkeypatch):
    """The grid at the flagship config (Swin-S + BERT-base, bf16, S = 131)
    walked on the meta device: a chunk of 64 images runs the Swin serving
    rows once (row 2 11 times, row 3 11, row 1 2, row 6 2); each score call
    runs 12 + 12 of rows 4 and 5 and nothing of the backbone; two images
    against 3 captions in chunks of 2 make 4 calls, the last ragged. Every
    product goes through ``ops.gemm``, and none has N = 2: ``final_linear``
    is ``F.linear``."""
    counts, _, products = _count_routes(monkeypatch)
    cfg = flagship.flagship_retrieval_config()
    model = RetrievalModel(cfg, dtype=torch.bfloat16, device="meta")
    feats = port_tasks.encode_images(
        model, torch.empty(64, 3, 224, 224, device="meta"), 64, plain=True)
    assert feats.shape == (64, 49, 768)
    assert counts == {"swin_full_block": 11, "swin_full_block_shift": 11,
                      "window_block_attention": 2, "fused_mlp_preln": 2}
    counts.clear()
    products.clear()
    caps = torch.ones(64, 80, dtype=torch.long, device="meta")
    p = model.score_from_features(feats[:1].expand(64, -1, -1), caps,
                                  plain=True)
    assert p.shape == (64,) and p.dtype == torch.float32
    assert counts == {"fused_attn_ln": 12, "fused_mlp_ln": 12}
    # the pooler and the head's transform, each on the 64 [CLS] rows
    assert products.count((64, 768)) == 2
    assert all(n != 2 for _, n in products)
    counts.clear()
    sims = port_tasks.score_matrix(model, feats[:2], caps[:3], 2, plain=True)
    assert sims.shape == (2, 3)
    assert counts == {"fused_attn_ln": 48, "fused_mlp_ln": 48}


def test_retrieval_step_routing_on_meta_device(monkeypatch):
    """The retrieval step at the flagship config (b64 = cat(32 pos, 32 neg),
    text 80: S = 131) walked forward and backward on the meta device: the
    Swin training rows as in the Swin-S pretrain step (11 + 11 whole blocks
    and 2 half blocks forward, 24 of each backward piece); in the fusion,
    12 ``fused_attn_ln_masked`` with the attention-dropout mask and no
    hidden mask (hidden dropout 0.0) and no qbias, 12 ``fused_mlp_ln`` in
    its training form; backward 12 K4 calls with the key bias and the
    amask, 12 ``mlp_ln_half_bwd`` without ``hmask2``. No product has N = 2,
    and every parameter gets a gradient."""
    counts, calls, products = _count_routes(monkeypatch)
    cfg = flagship.flagship_retrieval_config()
    model = RetrievalModel(cfg, dtype=torch.float32, device="meta",
                           compute_dtype=torch.bfloat16)
    n = 64
    loss, logits = model.loss(
        torch.empty(n, 3, 224, 224, device="meta"),
        torch.ones(n, 80, dtype=torch.long, device="meta"),
        torch.zeros(n, dtype=torch.long, device="meta"), plain=True,
        masks=_KeepAll())
    assert logits.shape == (n, 2)
    assert counts == {"swin_full_block_train": 11,
                      "swin_full_block_train_shift": 11,
                      "swin_half_block": 2, "attention_core": 2,
                      "fused_attn_ln_masked": 12, "fused_mlp_ln": 12}
    for args in calls["fused_attn_ln_masked"]:
        kbias, qbias, amask, hmask = args[4:8]
        assert kbias.shape == (n, 131) and qbias is None and hmask is None
        assert amask.shape == (n, 12, 131, 131)
    counts.clear()
    loss.backward()
    assert counts == {"swin_mlp_half_bwd": 24, "attention_core_bwd": 24,
                      "swin_qkv_tail_bwd": 24, "seq_attention_core_bwd": 12,
                      "mlp_ln_half_bwd": 12}
    for args in calls["seq_attention_core_bwd"]:
        assert args[1] is not None and args[2] is None and args[3] is not None
    assert all(args[2] is None for args in calls["mlp_ln_half_bwd"])
    assert all(n_ != 2 for _, n_ in products)
    for name, p in model.named_parameters():
        assert p.grad is not None, name


def _launch_totals():
    return [f.launches for f in kernels.KERNELS] + [
        getattr(f, c) for f in blocks.COUNTERPARTS for c in blocks.COUNTS]


def test_build_retrieval_grid_on_cpu(tiny):
    """``build_retrieval_grid`` at the tiny size on the CPU (plain versions,
    f32): a (7, 7) grid of probabilities in chunks of 3 whose labels mark
    the diagonal and the duplicate report, R@10 = 1 both ways, no CUDA
    launch counted; without CUDA, ``device='cuda'`` raises."""
    before = _launch_totals()
    grid, (images, captions, cap_ids) = flagship.build_retrieval_grid(
        n=16, text_len=L, batch_size=3, dtype=torch.float32, device="cpu",
        config=port_config(tiny[0]), image_size=IMG)
    out = grid(images[:7], captions[:7], cap_ids[:7])
    sims, labels = out["similarities"], out["labels"]
    assert sims.shape == labels.shape == (7, 7)
    assert np.isfinite(sims).all() and ((sims > 0) & (sims < 1)).all()
    assert (np.diag(labels) == 1).all()
    assert len(set(cap_ids.tolist())) == 16 - 2
    assert _launch_totals() == before
    result = port_metrics.evaluate_retrieval(sims, labels)
    assert result["i2t_retrieval"]["R@10"] == 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            flagship.build_retrieval_grid(n=2, device="cuda")

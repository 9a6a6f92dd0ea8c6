"""The port's mesh layout and partition rules against the JAX package's, in
one process (no process group): ``build_mesh``'s shapes, errors and rank
layout against ``mvlt_tpu.parallel.build_mesh`` over the 8 virtual CPU
devices; for every leaf of the tiny and the flagship-geometry task models
(pretrain, VQA, caption, retrieval) at mp = 2 and 4, the port's spec of the
tensor it stands for equals JAX's ``partition_spec_for_path``; the fused
qkv's split gives each rank q, k and v of the heads JAX places there; the
rows a data rank holds are the block ``P('data')`` places on it, retrieval's
``cat(pos, neg)`` included; which backbone tensors the port splits and
which attention halves it holds whole;
the loader's per-rank rows; the flagship-geometry lowering; the in-kernel
dropout draw of a rank's heads; and the new package's imports.
"""

import dataclasses
import logging
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mvlt_tpu import config as jcfg
from mvlt_tpu import flagship as jflagship
from mvlt_tpu.models import heads as jheads
from mvlt_tpu.parallel import build_mesh as jax_build_mesh
from mvlt_tpu.parallel import partition_spec_for_path as jax_spec
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.data.loader import DataLoader
from mvlt_tpu_torch.models import heads as pheads
from mvlt_tpu_torch.ops import kernels
from mvlt_tpu_torch.parallel import mesh as pmesh
from mvlt_tpu_torch.parallel import partition, shard
from mvlt_tpu_torch.tasks.retrieval import merge_pairs
from mvlt_tpu_torch.train.steps import rank_rows
from mvlt_tpu_torch.utils import convert

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_parallel,data_parallel",
                         [(1, -1), (2, -1), (4, -1), (8, -1), (2, 4),
                          (3, -1), (2, 3), (16, -1)])
def test_mesh_shape_and_errors_match_jax(model_parallel, data_parallel):
    """(dp, mp) of 8 devices, or JAX's ``ValueError`` word for word; and
    each rank's (data, model) coordinates are those of the device of the
    same index in JAX's grid."""
    cfg = dict(model_parallel=model_parallel, data_parallel=data_parallel)
    try:
        jmesh = jax_build_mesh(jcfg.MeshConfig(**cfg))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmesh.mesh_shape(pcfg.MeshConfig(**cfg), 8)
        assert str(got.value) == str(e)
        return
    shape = pmesh.mesh_shape(pcfg.MeshConfig(**cfg), 8)
    assert shape == (jmesh.shape["data"], jmesh.shape["model"])
    grid = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(8):
        d, m = pmesh.rank_coords(rank, shape[1])
        assert grid[d, m] == jax.devices()[rank].id


def test_one_process_mesh_has_no_groups():
    """Without a process group the mesh is (1, 1) and holds no group; a
    mesh that asks for more raises JAX's error."""
    mesh = pmesh.build_mesh(pcfg.MeshConfig())
    assert mesh.shape == (1, 1) and mesh.data_group is None \
        and mesh.model_group is None
    with pytest.raises(ValueError, match="does not divide device count 1"):
        pmesh.build_mesh(pcfg.MeshConfig(model_parallel=2))
    assert pmesh.initialize_distributed(device="cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# the partition rules, leaf by leaf
# ---------------------------------------------------------------------------

def _jax_configs(geometry):
    """(kind -> JAX config): the tiny pretrain config of the dry runs, the
    same on a tiny ViT, or the flagship geometry (Swin-S @224 + BERT-base)."""
    if geometry == "tiny":
        base = jflagship.tiny_pretrain_config()
    elif geometry == "tiny_vit":
        base = dataclasses.replace(
            jflagship.tiny_pretrain_config(), conv="vit",
            vit=jcfg.ViTConfig(image_size=32, patch_size=8, num_layers=2,
                               num_heads=4, hidden_dim=32, mlp_dim=64))
    else:
        base = dataclasses.replace(jflagship.flagship_vqa_config(),
                                   itm_task=True)
    return {"pretrain": base,
            "vqa": dataclasses.replace(base, result_num=10),
            "caption": dataclasses.replace(base, is_decoder=True),
            "retrieval": base}


_KINDS = {"pretrain": (jheads.PretrainModel, pheads.PretrainModel),
          "vqa": (jheads.VQAModel, pheads.VQAModel),
          "caption": (jheads.CaptionModel, pheads.CaptionModel),
          "retrieval": (jheads.RetrievalModel, pheads.RetrievalModel)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.fixture(scope="module")
def leaves():
    """(geometry, kind) -> (flax leaves {path: shape-struct}, port config)."""
    cache = {}

    def get(geometry, kind):
        if (geometry, kind) not in cache:
            cfg = _jax_configs(geometry)[kind]
            size = cfg.vit.image_size if cfg.conv == "vit" else \
                cfg.swin.img_size
            img = jax.ShapeDtypeStruct((1, 3, size, size), jnp.float32)
            txt = jax.ShapeDtypeStruct((1, 8), jnp.int32)
            args = ((img, txt, txt, jax.ShapeDtypeStruct((1,), jnp.int32))
                    if kind == "pretrain" else (img, txt))
            model = _KINDS[kind][0](cfg)
            shapes = jax.eval_shape(
                lambda *a: model.init(jax.random.PRNGKey(0), *a), *args)
            cache[geometry, kind] = (_flat(shapes["params"]),
                                     pcfg.MVLTConfig.from_json(cfg.to_json()))
        return cache[geometry, kind]

    return get


@pytest.mark.parametrize("kind", sorted(_KINDS))
@pytest.mark.parametrize("geometry", ["tiny", "tiny_vit", "flagship"])
@pytest.mark.parametrize("mp", [2, 4])
def test_param_shardings_equal_jax_specs(leaves, kind, geometry, mp):
    """Every flax leaf's JAX spec equals the port's spec of the tensor it
    maps onto (``utils/convert.py``), backbone included; every port
    parameter stands for some leaf; the port splits exactly the dimension
    JAX's spec names, in the (out, in) layout."""
    flat, cfg = leaves(geometry, kind)
    model = _KINDS[kind][1](cfg, dtype=torch.float32, device="meta")
    port = partition.param_shardings(model, mp)
    seen = set()
    for path, leaf in flat.items():
        want = tuple(jax_spec(path, leaf.ndim, leaf.shape, mp))
        key, _, _ = convert._port_name(path)
        assert port[key].spec == want, (path, key, port[key], want)
        seen.add(key)
        if "model" in want:
            axis = want.index("model")
            # a kernel's input side (flax axis 0) is the port's dimension
            # 1; ViT's attention kernels are (H, heads, d) / (heads, d, H)
            dim = int(axis == 0) if path.endswith("/kernel") else axis
            assert port[key].dim == dim, (path, port[key])
        else:
            assert port[key].dim is None, (path, port[key])
    assert seen == set(port)


def test_rules_fall_back_where_mp_does_not_divide():
    """BERT's vocabulary: the word embedding's 30,523 rows stay replicated
    at mp = 2 and the MLM decoder's 30,522 columns are split; at mp = 4
    both stay replicated; the fusion layers split at both."""
    assert partition.shard_for("fusion.word_embeddings", (30523, 768),
                               2).dim is None
    assert partition.shard_for("mlm_head_bidir.decoder.weight",
                               (30522, 768), 2).dim == 0
    assert partition.shard_for("mlm_head_bidir.decoder.weight",
                               (30522, 768), 4).dim is None
    s = partition.shard_for("fusion.layers.3.qkv.weight", (2304, 768), 4)
    assert (s.spec, s.dim, s.parts) == ((None, "model"), 0, 3)


@pytest.mark.parametrize("mp", [2, 4])
def test_fused_qkv_split_gives_each_rank_jax_heads(mp):
    """JAX places query / key / value kernels and biases ``P(None,
    'model')`` / ``P('model')`` on a (1, mp) mesh; the port's slice of its
    fused qkv on model rank r is those three shards, q then k then v, of
    the same heads (not a contiguous third of the fused rows)."""
    H = 32
    rng = np.random.default_rng(0)
    att = {n: {"kernel": rng.normal(size=(H, H)).astype(np.float32),
               "bias": rng.normal(size=(H,)).astype(np.float32)}
           for n in ("query", "key", "value")}
    sd = convert.params_from_flax(
        {"params": {"fusion": {"layer_0": {"attention": att}}}})
    w, b = sd["fusion.layers.0.qkv.weight"], sd["fusion.layers.0.qkv.bias"]
    mesh = jax_build_mesh(jcfg.MeshConfig(model_parallel=mp),
                          devices=jax.devices()[:mp])
    shards = {}
    for n in ("query", "key", "value"):
        for leaf, spec in (("kernel", P(None, "model")), ("bias", P("model"))):
            arr = jax.device_put(att[n][leaf], NamedSharding(mesh, spec))
            for s in arr.addressable_shards:
                r = list(mesh.devices.flat).index(s.device)
                shards[n, leaf, r] = np.asarray(s.data)
    for r in range(mp):
        sw = partition.local_shard(
            w, partition.shard_for("fusion.layers.0.qkv.weight", w.shape, mp),
            r, mp)
        sb = partition.local_shard(
            b, partition.shard_for("fusion.layers.0.qkv.bias", b.shape, mp),
            r, mp)
        want_w = np.concatenate([shards[n, "kernel", r].T
                                 for n in ("query", "key", "value")])
        want_b = np.concatenate([shards[n, "bias", r]
                                 for n in ("query", "key", "value")])
        assert np.array_equal(sw.numpy(), want_w)
        assert np.array_equal(sb.numpy(), want_b)


def _held_configs():
    """(name, port config): the tiny pretrain config and the flagship
    geometry on Swin-S, Swin-B and ViT-B/16."""
    tiny = pcfg.MVLTConfig.from_json(jflagship.tiny_pretrain_config().to_json())
    swin_s = flagship.flagship_swin_pretrain_config()
    swin_b = dataclasses.replace(flagship.flagship_swin_base_vqa_config(),
                                 itm_task=True)
    vit = flagship.flagship_vit_pretrain_config()
    return {"tiny": tiny, "swin_s": swin_s, "swin_b": swin_b, "vit_b": vit}


# the global heads of each stage (Swin) or block (ViT) whose attention half
# the port holds whole, by config and mp: those mp does not divide
_HELD_STAGES = {("tiny", 2): (), ("tiny", 4): (0,),
                ("swin_s", 2): (0,), ("swin_s", 4): (0, 1),
                ("swin_b", 2): (), ("swin_b", 4): (),
                ("vit_b", 2): (), ("vit_b", 4): ()}


@pytest.mark.parametrize("config,mp", sorted(_HELD_STAGES))
def test_backbone_held_replicated_under_tp(config, mp, caplog):
    """A model placed on a (1, mp) mesh (no process group: the collectives
    are skipped; the flagship geometries on ``meta``) splits every backbone
    tensor that JAX's rules split, Swin's qkv head-aligned, except the
    attention halves (qkv, proj / out) of the blocks whose heads mp does
    not divide: Swin-S stage 1 (3 heads) at mp = 2, stages 1-2 (3, 6) at
    mp = 4, the tiny config's stage 1 (2 heads) at mp = 4, no block of
    Swin-B or ViT-B/16. Those are held whole, their MLP split, and the log
    line names them; the blocks run on mp-th of their heads elsewhere."""
    cfg = _held_configs()[config]
    device = "cpu" if config == "tiny" else "meta"
    model = pheads.PretrainModel(cfg, dtype=torch.float32, device=device)
    full = {n: p.shape for n, p in model.named_parameters()}
    rules = partition.param_shardings(model, mp)
    with caplog.at_level(logging.INFO, logger="mvlt_tpu_torch.parallel"):
        shard.apply_mesh_(model, pmesh.Mesh((1, mp), 0, 1))
    heads = (cfg.vit.num_heads,) * cfg.vit.num_layers if cfg.conv == "vit" \
        else cfg.swin.num_heads
    held_stages = _HELD_STAGES[config, mp]
    assert [i for i, h in enumerate(heads) if h % mp] == list(held_stages)
    attn = re.compile(r"conv\.backbone\.(stages\.(\d+)\.\d+|blocks\.\d+)\."
                      r"(qkv|proj|out)\.(weight|bias)")
    held = []
    for n, p in model.named_parameters():
        s = rules[n]
        m = attn.fullmatch(n)
        whole = s.dim is None or (m is not None and m.group(2) is not None
                                  and int(m.group(2)) in held_stages)
        if whole:
            assert p.shape == full[n], n
            if s.dim is not None:
                held.append(n)
        else:
            want = list(full[n])
            want[s.dim] //= mp
            assert list(p.shape) == want, n
            assert n in shard.split_shardings(model), n
    backbone = [n for n in shard.split_shardings(model)
                if n.startswith("conv.")]
    assert {n.rsplit(".", 1)[0].rsplit(".", 1)[1] for n in backbone} >= (
        {"qkv", "out", "mlp_fc1", "mlp_fc2"} if cfg.conv == "vit"
        else {"qkv", "proj", "fc1", "fc2"})
    logged = [r.message for r in caplog.records if "held replicated" in
              r.message]
    if held:
        assert len(logged) == 1 and all(n in logged[0] for n in held)
        assert len(held) == 3 * sum(cfg.swin.depths[i] for i in held_stages)
    else:
        assert not logged
    blocks = (model.conv.backbone.blocks if cfg.conv == "vit" else
              [b for stage in model.conv.backbone.stages for b in stage])
    depth = [0] * cfg.vit.num_layers if cfg.conv == "vit" else [
        i for i, d in enumerate(cfg.swin.depths) for _ in range(d)]
    for i, b in zip(depth, blocks):
        assert b.tp_mlp is not None
        assert (b.tp_attn is None) == (cfg.conv != "vit"
                                       and i in held_stages)
    assert all(layer.tp is not None for layer in model.fusion.layers)
    assert sum(shard.split_flags(model)) == len(shard.split_shardings(model))


# ---------------------------------------------------------------------------
# the batch placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_parallel", [1, 2, 4])
def test_batch_rows_match_p_data(model_parallel):
    """The rows a rank holds are the block JAX's ``P('data')`` places on the
    device of the same mesh coordinates; a batch the data axis does not
    divide raises JAX's error."""
    jmesh = jax_build_mesh(jcfg.MeshConfig(model_parallel=model_parallel))
    dp = jmesh.shape["data"]
    n = 4 * dp
    arr = jax.device_put(np.arange(n), NamedSharding(jmesh, P("data")))
    grid = list(jmesh.devices.flat)
    for s in arr.addressable_shards:
        d, m = divmod(grid.index(s.device), model_parallel)
        mesh = pmesh.Mesh((dp, model_parallel), d, m)
        a, b = partition.batch_rows(mesh, n)
        assert list(range(a, b)) == np.asarray(s.data).tolist()
    if dp > 1:
        with pytest.raises(ValueError, match="not divisible by data-parallel"):
            partition.batch_rows(pmesh.Mesh((dp, model_parallel)), n + 1)


def test_retrieval_pairs_split_pos_and_neg():
    """``merge_pairs`` concatenates 32 positives and 32 negatives; at dp = 2
    data rank 0 holds the positives and rank 1 the negatives, as
    ``P('data')`` splits the concatenation on JAX."""
    pairs = {side: {"image": np.full((32, 3, 4, 4), v, np.float32),
                    "caption": np.full((32, 5), v, np.int64),
                    "label": np.full((32,), v, np.int64)}
             for side, v in (("pos", 1), ("neg", 0))}
    merged = merge_pairs(pairs)
    for rank, value in ((0, 1), (1, 0)):
        rows = rank_rows(merged, pmesh.Mesh((2, 1), rank, 0))
        assert all(v.shape[0] == 32 and (v == value).all()
                   for v in rows.values())


class _Rows:
    def __init__(self, n=22):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, epoch=0):
        return {"x": np.asarray([i])}


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_loader_yields_each_rank_its_rows(dp):
    """A loader with ``rows=(rank, dp)`` fetches only the rank's block of
    each global batch: the ranks' batches put together in rank order are
    the one-process batches; a ``drop_last`` loader refuses a batch size
    that dp does not divide."""
    for drop_last in (True, False):
        whole = [b["x"][:, 0].tolist() for b in DataLoader(
            _Rows(), 8, shuffle=True, drop_last=drop_last).epoch(1)]
        parts = [[b["x"][:, 0].tolist() for b in DataLoader(
            _Rows(), 8, shuffle=True, drop_last=drop_last,
            rows=(r, dp)).epoch(1)] for r in range(dp)]
        for i, batch in enumerate(whole):
            assert sum((p[i] for p in parts), []) == batch
    if dp > 1:
        with pytest.raises(ValueError, match="not divisible"):
            DataLoader(_Rows(), 4 * dp + 1, drop_last=True, rows=(0, dp))


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("n,dp", [(9, 2), (11, 4)])
def test_loader_gives_an_empty_block_zero_rows(n, dp, num_workers):
    """An eval loader whose tail batch is shorter than dp (1 row at dp 2, 3
    rows at dp 4): every rank yields as many batches, a rank without rows
    a zero-row batch of the same keys, dtype and trailing shape, and the
    ranks' rows put together are the one-process batches."""
    whole = [b["x"] for b in DataLoader(_Rows(n), 8, shuffle=False).epoch(0)]
    parts = [list(DataLoader(_Rows(n), 8, shuffle=False, rows=(r, dp),
                             num_workers=num_workers).epoch(0))
             for r in range(dp)]
    assert all(len(p) == len(whole) for p in parts)
    assert whole[-1].shape[0] < dp
    for i, batch in enumerate(whole):
        got = [p[i]["x"] for p in parts]
        assert all(g.dtype == batch.dtype and g.shape[1:] == batch.shape[1:]
                   for g in got)
        assert np.array_equal(np.concatenate(got), batch)
    assert parts[-1][-1]["x"].shape == (0, 1)


# ---------------------------------------------------------------------------
# the rest
# ---------------------------------------------------------------------------

def test_lower_flagship_multichip_checks_every_rule():
    """The flagship-geometry pretrain model on ``meta``: at mp = 2 the 12
    layers' six split tensors and the two MLM decoders' weight and bias
    (76), and the Swin-S blocks' six (qkv weight and bias, proj, fc1 weight
    and bias, fc2) in 24 blocks, less stage 1's three attention tensors in
    its 2 blocks (138); at mp = 4 the decoders' 30,522 columns stay
    replicated (72) and stages 1-2 hold their attention (132)."""
    assert flagship.lower_flagship_multichip(4) == {1: 0, 2: 76 + 138}
    assert flagship.lower_flagship_multichip(4, mps=[4]) == {4: 72 + 132}
    with pytest.raises(ValueError, match="does not divide"):
        flagship.lower_flagship_multichip(4, mps=[3])


def test_in_kernel_dropout_of_a_ranks_heads():
    """``adrop_mask_plain(..., head0=h0)`` is the slice of heads h0.. of the
    mask of all heads: a TP rank draws what one device draws for its
    heads."""
    seed = torch.tensor([3, 7], dtype=torch.int32)
    full = kernels.adrop_mask_plain(seed, 2, 12, 9, 0.1)
    for h0 in (0, 6):
        part = kernels.adrop_mask_plain(seed, 2, 6, 9, 0.1, head0=h0)
        assert torch.equal(part, full[:, h0:h0 + 6])
    with pytest.raises(ValueError):
        kernels.adrop_mask_plain(seed, 1, 6, 4, 0.1, head0=251)


def test_parallel_package_imports_no_jax():
    """Importing every module of ``mvlt_tpu_torch.parallel`` leaves no JAX
    and no ``mvlt_tpu`` module in ``sys.modules``."""
    code = textwrap.dedent("""
        import sys
        from mvlt_tpu_torch.parallel import comm, mesh, partition, shard
        import mvlt_tpu_torch.parallel
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("mvlt_tpu", "jax", "jaxlib",
                                            "flax", "optax", "orbax"))
        print("FOREIGN", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout

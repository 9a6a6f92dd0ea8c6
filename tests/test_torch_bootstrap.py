"""The port's ``--backbone_ckpt`` bootstrap against the JAX package's: a
seeded tiny Swin saved in the MSFT layout (fused qkv, ``{"model": sd}``) and
in the HF layout (also under a ``swin.`` prefix), and a tiny ResNet in the
torchvision layout and in the HF layout, each built in-process from a seeded
HF model (no weights are downloaded). The port's ``load_backbone`` of each
file equals ``params_from_flax`` of JAX's ``load_backbone`` of the same
file, tensor for tensor; the state dict merges into a fresh model through
``TaskRunner.init_state``; ``run_vqa`` and ``run_pretrain`` load it with
``--backbone_ckpt``."""

import dataclasses
import os

import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.utils.bootstrap import load_backbone as jax_load_backbone
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch.models.heads import VQAModel
from mvlt_tpu_torch.tasks.common import TaskRunner
from mvlt_tpu_torch.utils.bootstrap import load_backbone
from mvlt_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(2)

# tiny_config's Swin (img 32, embed 16, depths (1, 1), heads (2, 4), window
# 4) and a two-stage bottleneck ResNet of width 8
RESNET = dict(layers=(1, 1), width=8)


def _hf_swin():
    from transformers import SwinConfig, SwinModel
    torch.manual_seed(12)
    return SwinModel(SwinConfig(image_size=32, patch_size=4, embed_dim=16,
                                depths=[1, 1], num_heads=[2, 4],
                                window_size=4, drop_path_rate=0.0)).eval()


def _hf_resnet():
    from transformers import ResNetConfig, ResNetModel
    torch.manual_seed(13)
    model = ResNetModel(ResNetConfig(
        num_channels=3, embedding_size=8, hidden_sizes=[32, 64],
        depths=[1, 1], layer_type="bottleneck",
        downsample_in_first_stage=False, downsample_in_bottleneck=False))
    # running statistics that differ from their init
    g = torch.Generator().manual_seed(14)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.copy_(torch.randn(m.running_mean.shape,
                                             generator=g))
            m.running_var.copy_(torch.rand(m.running_var.shape,
                                           generator=g) + 0.5)
    return model.eval()


def _msft_swin_layout(sd):
    """An HF Swin state dict renamed to the official MSFT ``.pth`` layout
    (q / k / v fused into ``attn.qkv``)."""
    out = {}
    ren = [("embeddings.patch_embeddings.projection", "patch_embed.proj"),
           ("embeddings.norm", "patch_embed.norm"),
           ("encoder.layers", "layers"), ("layernorm_before", "norm1"),
           ("layernorm_after", "norm2"),
           ("attention.self.relative_position_bias_table",
            "attn.relative_position_bias_table"),
           ("attention.output.dense", "attn.proj"),
           ("intermediate.dense", "mlp.fc1"), ("output.dense", "mlp.fc2")]
    for k, v in sd.items():
        if ".attention.self." in k and k.rsplit(".", 2)[-2] in (
                "query", "key", "value"):
            continue
        if k.startswith("layernorm."):
            out["norm." + k.split(".", 1)[1]] = v
            continue
        for a, b in ren:
            k = k.replace(a, b)
        out[k] = v
    for k in sd:
        if k.endswith("attention.self.query.weight"):
            p = k[:-len("query.weight")]
            dst = p.replace("encoder.layers", "layers").replace(
                "attention.self.", "attn.qkv.")
            for leaf in ("weight", "bias"):
                out[dst + leaf] = torch.cat(
                    [sd[p + f"{n}.{leaf}"] for n in ("query", "key", "value")])
    return out


def _torchvision_resnet_layout(sd):
    """An HF ResNet state dict renamed to torchvision's layout."""
    out = {}
    for k, v in sd.items():
        k = (k.replace("embedder.embedder.convolution", "conv1")
             .replace("embedder.embedder.normalization", "bn1"))
        if k.startswith("encoder.stages."):
            _, _, s, _, b, rest = k.split(".", 5)
            p = f"layer{int(s) + 1}.{b}."
            if rest.startswith("shortcut.convolution"):
                rest = "downsample.0" + rest[len("shortcut.convolution"):]
            elif rest.startswith("shortcut.normalization"):
                rest = "downsample.1" + rest[len("shortcut.normalization"):]
            else:
                _, c, kind, leaf = rest.split(".", 3)
                rest = ("conv" if kind == "convolution" else "bn") + \
                    f"{int(c) + 1}.{leaf}"
            k = p + rest
        out[k] = v
    return out


def _config(conv):
    cfg = jcfg.tiny_config(jcfg.MVLTConfig.for_vqa(result_num=4))
    if conv == "swin":
        return cfg
    return dataclasses.replace(cfg, conv="resnet50",
                               resnet=jcfg.ResNetConfig(**RESNET))


def _checkpoint(layout, path):
    if layout.startswith("swin"):
        sd = _hf_swin().state_dict()
        if layout == "swin_msft":
            obj = {"model": _msft_swin_layout(sd)}
        elif layout == "swin_hf_prefixed":
            obj = {"swin." + k: v for k, v in sd.items()}
        else:
            obj = sd
    else:
        sd = _hf_resnet().state_dict()
        obj = _torchvision_resnet_layout(sd) if layout == "resnet_tv" else sd
    torch.save(obj, path)
    return path


@pytest.mark.parametrize("layout", ["swin_msft", "swin_hf",
                                    "swin_hf_prefixed", "resnet_tv",
                                    "resnet_hf"])
def test_load_backbone_equals_jax(tmp_path, layout):
    path = _checkpoint(layout, str(tmp_path / f"{layout}.pth"))
    jc = _config("swin" if layout.startswith("swin") else "resnet")
    want = params_from_flax(jax_load_backbone(path, jc))
    got = load_backbone(path, pcfg.MVLTConfig.from_json(jc.to_json()))
    assert got.keys() == want.keys()
    assert all(k.startswith("conv.backbone.") for k in got)
    for k in got:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    if layout.startswith("resnet"):
        assert any(k.endswith("running_var") for k in got)


@pytest.mark.parametrize("layout", ["swin_msft", "resnet_tv"])
def test_backbone_merges_into_a_fresh_model(tmp_path, layout):
    """Every backbone tensor of a fresh ``VQAModel`` comes from the file
    (the BatchNorm running statistics too); the fusion encoder and the
    head stay at their seeded init."""
    path = _checkpoint(layout, str(tmp_path / "b.pth"))
    cfg = pcfg.MVLTConfig.from_json(_config(
        "swin" if layout.startswith("swin") else "resnet").to_json())
    sd = load_backbone(path, cfg)
    runner = TaskRunner(VQAModel, cfg, pcfg.TrainConfig(), device="cpu",
                        name="bootstrap-merge")
    fresh = runner.init_state().model.state_dict()
    runner.init_state(pretrained_variables=[sd])
    own = runner.model.state_dict()
    backbone = [k for k in own if k.startswith("conv.backbone.")
                and not k.endswith("num_batches_tracked")]
    assert set(backbone) <= set(sd)
    for k in backbone:
        assert torch.equal(own[k], sd[k]), k
    for k in own:
        if not k.startswith("conv.backbone."):
            assert torch.equal(own[k], fresh[k]), k


def test_vit_and_other_convs_refuse(tmp_path):
    """A Swin file read for ``conv='vit'`` lacks the HF ``ViTModel`` keys
    (the ViT layout is read since the ViT was ported; it was refused
    before); the linear patch has no official checkpoint."""
    path = _checkpoint("swin_hf", str(tmp_path / "s.pth"))
    cfg = pcfg.tiny_config(pcfg.MVLTConfig.for_vqa(result_num=4))
    with pytest.raises(KeyError, match="embeddings.cls_token"):
        load_backbone(path, dataclasses.replace(cfg, conv="vit"))
    with pytest.raises(NotImplementedError, match="does not apply"):
        load_backbone(path, dataclasses.replace(cfg, conv="linear"))


def test_run_vqa_and_run_pretrain_load_backbone_ckpt(tmp_path, monkeypatch):
    """``--backbone_ckpt`` in both drivers (``--synthetic --tiny --device
    cpu``): the runner logs the backbone's tensors loaded, and with 0
    epochs the pretrain runner's backbone is the file's."""
    from mvlt_tpu_torch import run_pretrain, run_vqa
    from mvlt_tpu_torch.tasks import common
    path = _checkpoint("swin_msft", str(tmp_path / "swin.pth"))
    lines = []
    merge = common._merge_pretrained

    def logged(model, pretrained, logger):
        used, total = merge(model, pretrained, logger)
        lines.append(f"loaded {used}/{total}")
        return used, total

    monkeypatch.setattr(common, "_merge_pretrained", logged)
    run_vqa.main(["--synthetic", "--tiny", "--device", "cpu", "--epochs",
                  "1", "--batch_size", "8", "--num_workers", "0",
                  "--backbone_ckpt", path,
                  "--model_name", str(tmp_path / "vqa")])
    runner = run_pretrain.main(["--synthetic", "--tiny", "--device", "cpu",
                                "--epochs", "0", "--backbone_ckpt", path,
                                "--model_name", str(tmp_path / "pt"),
                                "--export_dir", str(tmp_path / "ex")])
    sd = load_backbone(path, runner.config)
    assert [l.split("/")[0] for l in lines] == [f"loaded {len(sd)}"] * 2
    own = runner.model.state_dict()
    for k, v in sd.items():
        assert torch.equal(own[k], v), k
    assert os.path.isdir(tmp_path / "vqa" / "round0")

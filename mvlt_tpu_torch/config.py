"""Configuration tree of the port: its own copy of the dataclasses and
constructors of ``mvlt_tpu/config.py`` that it uses, with the same field
names and defaults, so one config describes a model in both packages
(``dataclasses.asdict`` of the two agree; ``tests/test_torch_train.py``).

Defaults mirror the reference (``modules/config.py:4-72``) and its Swin
YAMLs, as in the JAX package. ``MVLTConfig.to_json`` writes the same text as
JAX's for the same fields (the ``config.json`` of a ``save_pretrained``
directory), and ``TrainConfig`` / ``MeshConfig`` keep every field of
``mvlt_tpu/config.py:285-327``; the port runs on one device, so a mesh of
more than one is refused where a runner is built (``tasks/common.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """BERT-base fusion encoder (reference ``modules/model.py:16-33``). The
    word-embedding table has ``vocab_size + 1`` rows (``model.py:21``)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"  # exact (erf) GELU
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    max_position_embeddings: int = 512
    type_vocab_size: int = 3
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def embedding_rows(self) -> int:
        return self.vocab_size + 1


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """Swin transformer backbone (reference Swin YAMLs)."""

    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.3
    ape: bool = False
    patch_norm: bool = True

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (self.num_layers - 1))

    @property
    def patches_resolution(self) -> Tuple[int, int]:
        return (self.img_size // self.patch_size,
                self.img_size // self.patch_size)


def swin_small() -> SwinConfig:
    """Swin-S (reference ``swin_small_patch4_window7_224.yaml``)."""
    return SwinConfig(embed_dim=96, depths=(2, 2, 18, 2),
                      num_heads=(3, 6, 12, 24), drop_path_rate=0.3)


def swin_base() -> SwinConfig:
    """Swin-B (reference ``swin_base_patch4_window7_224.yaml``)."""
    return SwinConfig(embed_dim=128, depths=(2, 2, 18, 2),
                      num_heads=(4, 8, 16, 32), drop_path_rate=0.5)


def swin_tiny_test() -> SwinConfig:
    """A tiny Swin for unit tests (not in the reference)."""
    return SwinConfig(img_size=32, patch_size=4, embed_dim=8, depths=(1, 1),
                      num_heads=(2, 4), window_size=4, drop_path_rate=0.0)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """Bottleneck ResNet (torchvision layout; reference
    ``modules/visual_feature_extractor.py:7-44``)."""

    layers: Tuple[int, ...] = (3, 4, 23, 3)  # resnet101
    width: int = 64

    @property
    def out_channels(self) -> int:
        return 512 * 4

    @property
    def feature_channels(self) -> int:
        """Channels of the last stage's map: ``out_channels`` for the four
        stages of ResNet-50/101, fewer for a shallower test config."""
        return self.width * 2 ** (len(self.layers) - 1) * 4


def resnet101() -> ResNetConfig:
    return ResNetConfig(layers=(3, 4, 23, 3))


def resnet50() -> ResNetConfig:
    return ResNetConfig(layers=(3, 4, 6, 3))


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT-B/16 (reference ``modules/visual_feature_extractor.py:65-107``),
    the backbone of ``conv='vit'`` (``models/backbones/vit.py``). JAX's ViT
    sizes its position table from the first image it sees and never reads
    ``image_size``; the port sizes it from ``image_size`` (197 rows at 224)
    and refuses an image of another size. The port trains with
    ``dropout`` / ``attention_dropout`` 0 only (both 0 here and in the
    reference's torchvision ViT)."""

    image_size: int = 224
    patch_size: int = 16
    num_layers: int = 12
    num_heads: int = 12
    hidden_dim: int = 768
    mlp_dim: int = 3072
    dropout: float = 0.0
    attention_dropout: float = 0.0


@dataclasses.dataclass(frozen=True)
class MVLTConfig:
    """Top-level model config shared by the task heads (reference
    ``MVLBertConfig``, ``modules/config.py:4-27``)."""

    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    # backbone: 'swin' | 'resnet101' | 'resnet50' | 'vit' | 'linear'
    conv: str = "swin"
    swin: SwinConfig = dataclasses.field(default_factory=swin_small)
    resnet: ResNetConfig = dataclasses.field(default_factory=resnet101)
    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig)

    mlm_task: bool = True
    itm_task: bool = True
    result_num: int = 224
    max_length: int = 40
    is_decoder: bool = False
    mlm_gather_k: int = 16

    remat_backbone: bool = False
    remat_fusion: bool = False

    pad_token_id: int = 0
    eos_token_id: int = 104     # [END]
    cls_token_id: int = 101     # [CLS]
    sep_token_id: int = 102     # [SEP]
    mask_token_id: int = 103    # [MASK]

    # AdamW of the reference loops (run_vqa.py:85)
    lr: float = 4e-5
    weight_decay: float = 1e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-6
    adam_mu_dtype: str = "float32"

    def __post_init__(self):
        # every special token is looked up in the word-embedding table
        vocab = self.fusion.vocab_size
        for name in ("pad_token_id", "eos_token_id", "cls_token_id",
                     "sep_token_id", "mask_token_id"):
            tid = getattr(self, name)
            if not 0 <= tid < vocab:
                raise ValueError(
                    f"{name}={tid} is outside the word-embedding vocab "
                    f"(vocab_size={vocab}); pass in-vocab special ids "
                    f"when shrinking the vocab.")

    def with_tokenizer(self, tokenizer) -> "MVLTConfig":
        """Special token ids and vocabulary size from a tokenizer
        (``mvlt_tpu/config.py:209-220``)."""
        ids = tokenizer.convert_tokens_to_ids(["[END]", "[CLS]", "[SEP]",
                                               "[MASK]"])
        return dataclasses.replace(
            self, eos_token_id=ids[0], cls_token_id=ids[1],
            sep_token_id=ids[2], mask_token_id=ids[3],
            fusion=dataclasses.replace(self.fusion,
                                       vocab_size=len(tokenizer)))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "MVLTConfig":
        """The inverse of :meth:`to_json`; unknown keys are dropped and a
        missing sub-config takes its defaults (``mvlt_tpu/config.py:
        260-282``)."""
        raw = json.loads(text)

        def _mk(cls, d):
            if d is None:
                return cls()
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d.items() if k in names})

        kw = dict(raw)
        kw["fusion"] = _mk(FusionConfig, raw.get("fusion"))
        kw["swin"] = _mk(SwinConfig, raw.get("swin"))
        kw["resnet"] = _mk(ResNetConfig, raw.get("resnet"))
        kw["vit"] = _mk(ViTConfig, raw.get("vit"))
        names = {f.name for f in dataclasses.fields(MVLTConfig)}
        return MVLTConfig(**{k: v for k, v in kw.items() if k in names})

    @staticmethod
    def for_vqa(**kw) -> "MVLTConfig":
        base = dict(
            fusion=FusionConfig(hidden_dropout_prob=0.1,
                                attention_probs_dropout_prob=0.1),
            result_num=224, lr=4e-5)
        base.update(kw)
        return MVLTConfig(**base)

    @staticmethod
    def for_pretrain(**kw) -> "MVLTConfig":
        base = dict(
            fusion=FusionConfig(hidden_dropout_prob=0.1,
                                attention_probs_dropout_prob=0.1),
            itm_task=False, max_length=150, lr=4e-5)
        base.update(kw)
        return MVLTConfig(**base)

    @staticmethod
    def for_retrieval(**kw) -> "MVLTConfig":
        """Image-text retrieval (``mvlt_tpu/config.py:239-244``): attention
        dropout 0.1, hidden dropout 0.0, ITM on, ``max_length`` 80, lr
        1e-6."""
        base = dict(
            fusion=FusionConfig(attention_probs_dropout_prob=0.1),
            itm_task=True, max_length=80, lr=1e-6)
        base.update(kw)
        return MVLTConfig(**base)

    @staticmethod
    def for_caption(**kw) -> "MVLTConfig":
        """Report generation (``mvlt_tpu/config.py:247-252``): fusion
        dropouts 0.1, lr 1e-5, ``is_decoder``; ``max_length`` 80 unless
        given (MIMIC-CXR's 150, ``run_report_generation.py:70-71``)."""
        base = dict(
            fusion=FusionConfig(hidden_dropout_prob=0.1,
                                attention_probs_dropout_prob=0.1),
            max_length=80, lr=1e-5, is_decoder=True)
        base.update(kw)
        return MVLTConfig(**base)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (``mvlt_tpu/config.py:285-293``): a (data, model)
    grid over the world of processes, one a device
    (:func:`mvlt_tpu_torch.parallel.build_mesh`); ``model_parallel``
    adjacent ranks split the fusion encoder and the MLM decoder (Megatron
    TP), ``data_parallel`` (-1: the rest) split the batch."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop knobs (``mvlt_tpu/config.py:296-327``), every field
    kept. In the port ``rng_impl`` selects nothing (the masks come from a
    ``torch.Generator``); ``bf16_compute`` picks the model's compute dtype
    (f32 masters either way); ``num_workers`` -1 sizes the loader's worker
    processes to the host (``data/loader.py``); ``async_checkpoint`` writes
    on a background thread after a host snapshot. ``remat_backbone`` /
    ``remat_fusion`` are read by nothing, as in JAX: the model's
    ``MVLTConfig`` flags of the same names rematerialise."""

    batch_size: int = 32
    epochs: int = 100
    seed: int = 0
    rng_impl: str = "rbg"
    bf16_compute: bool = True
    remat_backbone: bool = False
    remat_fusion: bool = False
    grad_accum_steps: int = 1
    num_workers: int = -1
    log_every: int = 50
    checkpoint_every_epochs: int = 1
    async_checkpoint: bool = True
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def tiny_config(cfg: MVLTConfig) -> MVLTConfig:
    """A task config shrunk for smoke runs with its semantics kept: dropouts,
    task switches and special tokens stay, only sizes change
    (``mvlt_tpu/config.py:330-342``)."""
    return dataclasses.replace(
        cfg,
        fusion=dataclasses.replace(
            cfg.fusion, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128),
        swin=SwinConfig(img_size=32, patch_size=4, embed_dim=16,
                        depths=(1, 1), num_heads=(2, 4), window_size=4,
                        drop_path_rate=0.0))


def vit_sized_for(cfg: MVLTConfig, image_size: int) -> MVLTConfig:
    """``cfg`` with ``vit.image_size`` set to ``image_size`` when ``conv`` is
    the ViT, else ``cfg`` as it is. JAX's ViT sizes its position table from
    the images it is initialized on (``vit.py:58-66``), so its drivers'
    ``--tiny`` ViT sees the tiny runs' 32-px images; the port sizes the
    table from the config, which the drivers' ``--tiny`` sets so."""
    if cfg.conv.lower() not in ("vit", "visiontransformer"):
        return cfg
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, image_size=image_size))

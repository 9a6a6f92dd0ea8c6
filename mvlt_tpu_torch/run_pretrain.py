"""MLM+ITM pretraining on the port (counterpart of the root
``run_pretrain.py``): RGC / ROCO / MedICaT sources selected by flags,
per-epoch checkpoints and exports.

    python -m mvlt_tpu_torch.run_pretrain --rgc_index <train_img_idx2path.pkl>
    python -m mvlt_tpu_torch.run_pretrain --roco_root <dir> --medicat_root <dir>
    python -m mvlt_tpu_torch.run_pretrain --synthetic --tiny --device cpu \\
        --epochs 1

The arguments are JAX's (``run_pretrain.py:19-46``) and ``--device``
(default ``cuda``; without a CUDA device the run raises, it never falls
back). ROCO and MedICaT images are decoded to uint8 on the host and
normalized on the device unless ``--host_normalize`` or a float source
(``--rgc_index``, ``--synthetic``) is mixed in. ``--backbone_ckpt`` loads an official
Swin, ResNet or HF ViT state dict into the fresh model
(``utils/bootstrap.py``). ``--conv vit`` / ``linear`` (196 image tokens)
train at S = 278 with the default text length 80, and past N = 288 (a
``--max_length`` above 90) on K2 / K4's long form. Refused: on a CUDA
device a fusion sequence beyond K2 / K4's N <= 46,340. On the card the
model trains with f32 masters and bf16 compute
(``TrainConfig.bf16_compute``); on the CPU it runs the kernels' plain
versions. It writes ``<model_name>/`` (``log.txt``, ``metrics.jsonl``,
``step_*`` checkpoints), ``<export_dir>`` and ``<export_dir>_epoch<e>``
(``config.json`` + ``model.pt``, what ``run_vqa --pretrained`` reads).

Over several devices, one process a device:

    torchrun --nproc_per_node N -m mvlt_tpu_torch.run_pretrain ... \\
        --model_parallel M

(torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR``;
each rank takes ``cuda:LOCAL_RANK`` and NCCL, or gloo with ``--device
cpu``): a (N / M, M) mesh, the fusion encoder and the MLM decoder split
over each group of M adjacent ranks (Megatron TP), the batch over the N / M
data ranks (``--batch_size`` stays the global batch); world rank 0 logs and
writes.
"""

from __future__ import annotations

import argparse
import dataclasses


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m mvlt_tpu_torch.run_pretrain")
    p.add_argument("--rgc_index", default=None,
                   help="RGC train_img_idx2path.pkl path")
    p.add_argument("--roco_root", default=None)
    p.add_argument("--medicat_root", default=None)
    p.add_argument("--model_name", default="./checkpoints/pretrain")
    p.add_argument("--export_dir", default="./checkpoints/pretrain_export")
    p.add_argument("--conv", default="swin")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=4e-5)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--max_length", type=int, default=80)
    p.add_argument("--itm_task", action="store_true", default=True)
    p.add_argument("--no_itm_task", dest="itm_task", action="store_false")
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=-1,
                   help="host loader worker processes (-1 auto, 0 threaded)")
    p.add_argument("--host_normalize", action="store_true",
                   help="normalize images on the host (float32) instead of "
                        "on the device")
    p.add_argument("--jpeg_draft", action="store_true",
                   help="libjpeg draft-mode decode (faster, slightly "
                        "different pixels)")
    p.add_argument("--backbone_ckpt", default=None,
                   help="official backbone checkpoint (Swin .pth / "
                        "torchvision ResNet / HF state dict; HF ViT), loaded into "
                        "the fresh model as the reference does at build "
                        "(modules/model.py:222-226)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu for the plain versions)")
    return p.parse_args(argv)


def build_source(args):
    from mvlt_tpu_torch.data.datasets import (ConcatSource, ImageFolderSource,
                                              PickleSource, SyntheticSource)
    sources = []
    if args.synthetic:
        sources.append(SyntheticSource(n=64, image_size=32 if args.tiny
                                       else 224))
    if args.rgc_index:
        sources.append(PickleSource(args.rgc_index))
    if args.roco_root:
        sources.append(ImageFolderSource.from_roco(args.roco_root))
    if args.medicat_root:
        sources.append(ImageFolderSource.from_medicat(args.medicat_root))
    # one batch holds one image layout: beside a source of f32 (3, H, W)
    # frames, ROCO / MedICaT decode to f32 too (JAX's driver leaves them on
    # uint8 there, and the batch cannot be stacked)
    floats = any(isinstance(s, (PickleSource, SyntheticSource))
                 for s in sources)
    for src in sources:
        if isinstance(src, ImageFolderSource):
            src.normalize = ("host" if args.host_normalize or floats
                             else "device")
            src.fast_decode = args.jpeg_draft
    if not sources:
        raise SystemExit("no data source given (use --rgc_index/--roco_root/"
                         "--medicat_root or --synthetic)")
    return sources[0] if len(sources) == 1 else ConcatSource(*sources)


def build_config(args, tokenizer):
    from mvlt_tpu_torch.config import MVLTConfig, tiny_config, vit_sized_for
    cfg = MVLTConfig.for_pretrain(lr=args.lr)
    cfg = dataclasses.replace(cfg, conv=args.conv, itm_task=args.itm_task,
                              max_length=args.max_length)
    if args.tiny:
        cfg = tiny_config(cfg)
        cfg = vit_sized_for(cfg, cfg.swin.img_size)
    return cfg.with_tokenizer(tokenizer)


def main(argv=None):
    args = parse_args(argv)
    from mvlt_tpu_torch.config import MeshConfig, TrainConfig
    from mvlt_tpu_torch.data.datasets import PretrainDataset
    from mvlt_tpu_torch.flagship import _need_cuda
    from mvlt_tpu_torch.models.heads import PretrainModel, check_fusion_fits
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.tasks.pretrain import train_pretrain
    from mvlt_tpu_torch.text.tokenizer import default_tokenizer

    _need_cuda(args.device, "run_pretrain")
    from mvlt_tpu_torch.parallel import initialize_distributed
    args.device = initialize_distributed(device=args.device)
    tc = TrainConfig(batch_size=args.batch_size, epochs=args.epochs,
                     num_workers=args.num_workers,
                     mesh=MeshConfig(model_parallel=args.model_parallel))
    tokenizer = default_tokenizer(synthetic_ok=args.synthetic)
    cfg = build_config(args, tokenizer)
    check_fusion_fits(cfg, args.max_length, 1, args.device)
    runner = TaskRunner(PretrainModel, cfg, tc, workdir=args.model_name,
                        name="pretrain", device=args.device)
    pretrained = None
    if args.backbone_ckpt:
        from mvlt_tpu_torch.utils.bootstrap import load_backbone
        pretrained = [load_backbone(args.backbone_ckpt, cfg)]
    source = build_source(args)
    dataset = PretrainDataset(source, tokenizer, max_length=args.max_length,
                              mlm_task=cfg.mlm_task, itm_task=cfg.itm_task)
    runner.init_state(pretrained_variables=pretrained)
    runner.maybe_restore()
    train_pretrain(runner, dataset, epochs=args.epochs,
                   export_dir=args.export_dir)
    return runner


if __name__ == "__main__":
    main()

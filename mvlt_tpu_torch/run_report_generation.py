"""Report generation train and beam-search test on the port (counterpart of
the root ``run_report_generation.py``): RGC, IU X-Ray (two views a study),
MIMIC-CXR or synthetic data, selected by ``--dataset``.

    python -m mvlt_tpu_torch.run_report_generation --dataset iu_xray \\
        --data_root ./dataset --pretrained <export dir>
    python -m mvlt_tpu_torch.run_report_generation --dataset synthetic \\
        --tiny --device cpu --epochs 1

The arguments are JAX's (``run_report_generation.py:34-68``) and
``--device`` (default ``cuda``; without a CUDA device the run raises, it
never falls back). ``--dataset iu_xray`` / ``mimic_cxr`` read
``<data_root>/<dataset>/{images/, annotation.json}``: with ``--pretrained``
the frames are uint8, normalized on the device (f32 on the host with
``--host_normalize``), without it the ImageNet transforms; ``--tiny``
reads them at the tiny Swin's size. ``--backbone_ckpt`` loads an official
Swin, ResNet or HF ViT state dict over the ``--pretrained`` export
(``utils/bootstrap.py``). Training runs by default, ``--do_test`` alone
only tests (JAX's rule). ``--quant int8w`` serves that test on
weight-only int8 (``tasks/caption.eval_caption``, ``ops/quant.py``).
Refused: on a CUDA device a fusion sequence beyond K2 / K4's N <= 46,340
(``models.heads.check_fusion_fits``). ``--conv vit`` or ``linear`` (196
tokens a view) run on the card too: S = 474 on ``iu_xray``'s two views,
348 at ``mimic_cxr``'s 150 text tokens, 298 at ``rgc``'s 100, where K2 and
K4 take their long form (N > 288). On the
card the model trains with f32 masters and bf16 compute; on the CPU it
runs the kernels' plain versions. It writes ``<model_name>/`` (``log.txt``,
``metrics.jsonl``, ``step_*`` checkpoints) and prints the test's scores.

Over several devices, one process a device:

    torchrun --nproc_per_node N -m mvlt_tpu_torch.run_report_generation ... \\
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
import os


def _split_index_path(index_path: str, split: str) -> str:
    """A sibling split's pickle index: the train index's BASENAME with
    'train' replaced (a whole-path replace would mangle directories that
    contain 'train', or silently test on the training set)."""
    d, base = os.path.split(index_path)
    if "train" not in base:
        raise SystemExit(
            f"cannot derive the {split!r} index from {index_path!r}: "
            "the filename does not contain 'train' — pass a per-split "
            "index path explicitly")
    return os.path.join(d, base.replace("train", split))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m mvlt_tpu_torch.run_report_generation")
    p.add_argument("--dataset", default="iu_xray",
                   choices=["rgc", "iu_xray", "mimic_cxr", "synthetic"])
    p.add_argument("--data_root", default="./dataset")
    p.add_argument("--rgc_index", default=None)
    p.add_argument("--model_name", default="./checkpoints/caption")
    p.add_argument("--pretrained", default=None,
                   help="pretrain export dir (the port's save_pretrained "
                        "format)")
    p.add_argument("--backbone_ckpt", default=None,
                   help="official backbone checkpoint (Swin .pth / "
                        "torchvision ResNet / HF state dict; HF ViT)")
    p.add_argument("--conv", default="swin")
    p.add_argument("--learning_strategy", default="unilm",
                   choices=["unilm", "normal"])
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--test_freq", type=int, default=5)
    p.add_argument("--num_beams", type=int, default=5)
    p.add_argument("--max_length", type=int, default=None)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=-1,
                   help="host loader worker processes (-1 auto, 0 threaded)")
    p.add_argument("--host_normalize", action="store_true",
                   help="normalize images on the host (float32) instead of "
                        "on the device")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--do_train", action="store_true", default=None)
    p.add_argument("--no_train", dest="do_train", action="store_false")
    p.add_argument("--do_test", action="store_true")
    p.add_argument("--quant", default="", choices=["", "int8w"],
                   help="int8w: the --do_test decode on weight-only int8 "
                        "(int8 + per-channel scales, dequantized to bf16 "
                        "for each generate call)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu for the plain versions)")
    return p.parse_args(argv)


def default_max_length(dataset: str) -> int:
    return {"rgc": 100, "iu_xray": 80, "mimic_cxr": 150,
            "synthetic": 24}[dataset]


def build_config(args, tokenizer, max_length: int):
    from mvlt_tpu_torch.config import MVLTConfig, tiny_config, vit_sized_for
    cfg = MVLTConfig.for_caption(lr=args.lr, max_length=max_length)
    cfg = dataclasses.replace(cfg, conv=args.conv)
    if args.tiny:
        cfg = tiny_config(cfg)
        cfg = vit_sized_for(cfg, cfg.swin.img_size)
    return cfg.with_tokenizer(tokenizer)


def build_datasets(args, tokenizer, max_length: int, image_size: int = 224):
    """(train, test) of ``args.dataset``; ``image_size`` is the size the
    IU X-Ray / MIMIC-CXR frames are read at."""
    from mvlt_tpu_torch.data.datasets import (CaptionDataset,
                                              CXRAnnotationDataset,
                                              PickleSource, SyntheticSource)
    if args.dataset == "synthetic":
        # distinct seeds: a test split seeded as the train split would
        # score the memorized training samples
        mk = lambda split, seed: CaptionDataset(
            SyntheticSource(n=16, image_size=32 if args.tiny else 224,
                            seed=seed),
            tokenizer, max_length, split,
            learning_strategy=args.learning_strategy)
        return mk("train", 0), mk("test", 1)
    if args.dataset == "rgc":
        if not args.rgc_index:
            raise SystemExit("--dataset rgc requires --rgc_index")
        mk = lambda split: CaptionDataset(
            PickleSource(_split_index_path(args.rgc_index, split)),
            tokenizer, max_length, split,
            learning_strategy=args.learning_strategy)
        return mk("train"), mk("test")
    root = os.path.join(args.data_root, args.dataset)
    mk = lambda split: CXRAnnotationDataset(
        os.path.join(root, "images"), os.path.join(root, "annotation.json"),
        tokenizer, split, two_view=args.dataset == "iu_xray",
        max_length=max_length, pretrained=args.pretrained is not None,
        learning_strategy=args.learning_strategy,
        normalize="host" if args.host_normalize else "device",
        image_size=image_size)
    return mk("train"), mk("test")


def main(argv=None):
    """Returns ``(runner, {"evals": the periodic tests' scores, "test":
    the --do_test scores or None})``."""
    args = parse_args(argv)
    from mvlt_tpu_torch.config import MeshConfig, TrainConfig
    from mvlt_tpu_torch.flagship import _need_cuda
    from mvlt_tpu_torch.models.heads import CaptionModel, check_fusion_fits
    from mvlt_tpu_torch.tasks.caption import (check_quant, eval_caption,
                                              train_caption)
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.text.tokenizer import default_tokenizer
    from mvlt_tpu_torch.utils import checkpoint as ckpt_lib

    _need_cuda(args.device, "run_report_generation")
    from mvlt_tpu_torch.parallel import comm, initialize_distributed
    args.device = initialize_distributed(device=args.device)
    check_quant(args.quant)
    if args.do_train is None:
        # train by default (the reference's behavior), but --do_test alone
        # tests only
        args.do_train = not args.do_test
    tokenizer = default_tokenizer(synthetic_ok=args.dataset == "synthetic")
    max_length = args.max_length or default_max_length(args.dataset)
    cfg = build_config(args, tokenizer, max_length)
    # S = 1 + views x image tokens + 1 + max_length must fit K2 / K4's plans
    check_fusion_fits(cfg, max_length, 2 if args.dataset == "iu_xray" else 1,
                      args.device)
    tc = TrainConfig(batch_size=args.batch_size, epochs=args.epochs,
                     num_workers=args.num_workers,
                     mesh=MeshConfig(model_parallel=args.model_parallel))
    runner = TaskRunner(CaptionModel, cfg, tc, workdir=args.model_name,
                        name="caption", device=args.device)
    train_ds, test_ds = build_datasets(args, tokenizer, max_length,
                                       cfg.swin.img_size)
    # the pretrain export first, then the backbone over it
    pretrained = []
    if args.pretrained:
        pretrained.append(ckpt_lib.load_pretrained(args.pretrained)[1])
    if args.backbone_ckpt:
        from mvlt_tpu_torch.utils.bootstrap import load_backbone
        pretrained.append(load_backbone(args.backbone_ckpt, cfg))
    runner.init_state(pretrained_variables=pretrained or None)
    runner.maybe_restore()

    out = {"evals": [], "test": None}
    if args.do_train:
        out["evals"] = train_caption(
            runner, train_ds, test_ds, epochs=args.epochs,
            test_freq=args.test_freq,
            learning_strategy=args.learning_strategy,
            num_beams=args.num_beams, tokenizer=tokenizer)
    if args.do_test:
        out["test"] = eval_caption(runner, test_ds, tokenizer,
                                   num_beams=args.num_beams,
                                   strategy=args.learning_strategy,
                                   quant=args.quant)
        if comm.global_rank() == 0:
            print(out["test"])
    return runner, out


if __name__ == "__main__":
    main()

"""Med-VQA finetune and eval on the port (counterpart of the root
``run_vqa.py``): SLAKE / VQA-RAD, per-epoch validation, the best-valid
checkpoint, open / closed accuracy, rounds of seeds.

    python -m mvlt_tpu_torch.run_vqa --dataset SLAKE --data_root ./dataset
    python -m mvlt_tpu_torch.run_vqa --synthetic --tiny --device cpu \\
        --epochs 2 --batch_size 8

The arguments are JAX's (``run_vqa.py:19-41``) and ``--device`` (default
``cuda``; without a CUDA device the run raises, it never falls back). On the
card the model trains with f32 masters and bf16 compute
(``TrainConfig.bf16_compute``); on the CPU it runs the kernels' plain
versions. ``--backbone_ckpt`` loads an official Swin or ResNet state dict
into the fresh model, over the ``--pretrained`` export, as JAX merges them
(``utils/bootstrap.py``). Refused: ``--model_parallel`` other than 1 (one
device). It writes
``<model_name>/round<i>/`` (``log.txt``, ``metrics.jsonl``, ``step_*``
checkpoints) and ``<model_name>/results.json``, a list of one dict a round
with JAX's keys (``valid_acc``, ``epoch``, ``test_final``, ``test``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m mvlt_tpu_torch.run_vqa")
    p.add_argument("--dataset", default="SLAKE", choices=["SLAKE", "VQA-RAD"])
    p.add_argument("--data_root", default="./dataset")
    p.add_argument("--model_name", default="./checkpoints/vqa")
    p.add_argument("--pretrained", default=None,
                   help="pretrain export dir (the port's save_pretrained "
                        "format)")
    p.add_argument("--backbone_ckpt", default=None,
                   help="official backbone checkpoint (Swin .pth / "
                        "torchvision ResNet / HF state dict)")
    p.add_argument("--conv", default="swin")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--lr", type=float, default=4e-5)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--total_round", type=int, default=1,
                   help="seeds to train (reference runs 10)")
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=-1,
                   help="host loader worker processes (-1 auto, 0 threaded)")
    p.add_argument("--synthetic", action="store_true",
                   help="smoke-run on synthetic data (no dataset needed)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model for smoke runs")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu for the plain versions)")
    return p.parse_args(argv)


def build_config(args, tokenizer, result_num):
    from mvlt_tpu_torch.config import MVLTConfig, tiny_config
    cfg = MVLTConfig.for_vqa(result_num=result_num, lr=args.lr)
    cfg = dataclasses.replace(cfg, conv=args.conv)
    if args.tiny:
        cfg = tiny_config(cfg)
    return cfg.with_tokenizer(tokenizer)


def build_datasets(args, tokenizer):
    from mvlt_tpu_torch.data.datasets import MedVQADataset
    if args.synthetic:
        size = 32 if args.tiny else 224
        images = np.random.default_rng(0).normal(
            size=(8, 3, size, size)).astype(np.float32)
        entries = lambda n: [
            {"img_id": i % 8, "question": f"is the finding {i} present ?",
             "label": i % 4, "answer_type": "OPEN" if i % 2 else "CLOSED"}
            for i in range(n)]
        mk = lambda n: MedVQADataset.from_arrays(
            images, entries(n), {str(i): i for i in range(4)})
        train, valid, test = mk(32), mk(8), mk(8)
    else:
        train = MedVQADataset(args.data_root, args.dataset, "train")
        valid = MedVQADataset(args.data_root, args.dataset, "validate") \
            if args.dataset == "SLAKE" else None
        test = MedVQADataset(args.data_root, args.dataset, "test")
    for ds in (train, valid, test):
        if ds is not None:
            ds.tokenize(tokenizer)
    return train, valid, test


def train_round(args, round_i: int, cfg, datasets, pretrained=None):
    """One seed: a runner under ``<model_name>/round<i>`` trained by
    ``train_vqa``. Returns (runner, best)."""
    from mvlt_tpu_torch.config import MeshConfig, TrainConfig
    from mvlt_tpu_torch.models.heads import VQAModel
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.tasks.vqa import train_vqa
    tc = TrainConfig(batch_size=args.batch_size, epochs=args.epochs,
                     seed=round_i, num_workers=args.num_workers,
                     mesh=MeshConfig(model_parallel=args.model_parallel))
    runner = TaskRunner(VQAModel, cfg, tc,
                        workdir=f"{args.model_name}/round{round_i}",
                        name="vqa", device=args.device)
    runner.init_state(pretrained_variables=pretrained)
    train, valid, test = datasets
    best = train_vqa(runner, train, valid, test, epochs=args.epochs)
    runner.logger.info("round %d: %s", round_i, best)
    return runner, best


def main(argv=None):
    args = parse_args(argv)
    from mvlt_tpu_torch.flagship import _need_cuda
    from mvlt_tpu_torch.text.tokenizer import default_tokenizer
    from mvlt_tpu_torch.utils import checkpoint as ckpt_lib

    _need_cuda(args.device, "run_vqa")
    tokenizer = default_tokenizer(synthetic_ok=args.synthetic)
    datasets = build_datasets(args, tokenizer)
    cfg = build_config(args, tokenizer, len(datasets[0].ans2label))
    # the pretrain export first, then the backbone over it (run_vqa.py:95-101)
    pretrained = []
    if args.pretrained:
        pretrained.append(ckpt_lib.load_pretrained(args.pretrained)[1])
    if args.backbone_ckpt:
        from mvlt_tpu_torch.utils.bootstrap import load_backbone
        pretrained.append(load_backbone(args.backbone_ckpt, cfg))
    pretrained = pretrained or None

    results = []
    for round_i in range(args.total_round):
        _, best = train_round(args, round_i, cfg, datasets, pretrained)
        results.append(best)

    os.makedirs(args.model_name, exist_ok=True)
    with open(os.path.join(args.model_name, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)
    print(json.dumps(results, default=str))
    return results


if __name__ == "__main__":
    main()

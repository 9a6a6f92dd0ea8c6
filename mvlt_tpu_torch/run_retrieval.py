"""Image-text retrieval train, test and rank on the port (counterpart of the
root ``run_retrieval.py``, which covers the reference's ``run_retrieval.py``
and ``run_retrieval_iuxray.py``).

    python -m mvlt_tpu_torch.run_retrieval --rgc_index <train_img_idx2path.pkl> \\
        --do_train --do_test
    python -m mvlt_tpu_torch.run_retrieval --iu_xray_root <dir> --do_train \\
        --do_test
    python -m mvlt_tpu_torch.run_retrieval --synthetic --tiny --device cpu \\
        --do_train --do_test --epochs 1

The arguments are JAX's (``run_retrieval.py:33-62``) and ``--device``
(default ``cuda``; without a CUDA device the run raises, it never falls
back). ``--iu_xray_root`` reads ``images/`` and ``annotation.json`` (two
views a study, uint8 frames normalized on the device unless
``--host_normalize``) and forces ``--swap image``
(run_retrieval_iuxray.py:130-137); ``--tiny`` reads the frames at the
tiny Swin's size. ``--backbone_ckpt`` loads an official Swin or ResNet
state dict over the ``--pretrained`` export. Refused: ``--model_parallel``
other than 1 (one device), and a run with neither ``--do_train`` nor
``--do_test``. It writes ``<model_name>/`` (``log.txt``,
``metrics.jsonl``, ``step_*`` checkpoints) and, with ``--do_test``,
``<model_name>/eval.json`` (R@1 / 5 / 10 both ways), which it also prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from mvlt_tpu_torch.run_report_generation import _split_index_path


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m mvlt_tpu_torch.run_retrieval")
    p.add_argument("--rgc_index", default=None,
                   help="RGC {split}_img_idx2path.pkl (train path)")
    p.add_argument("--iu_xray_root", default=None,
                   help="IU X-Ray root with images/ + annotation.json "
                        "(run_retrieval_iuxray.py variant; implies "
                        "--swap image)")
    p.add_argument("--model_name", default="./checkpoints/retrieval")
    p.add_argument("--pretrained", default=None,
                   help="pretrain export dir (the port's save_pretrained "
                        "format)")
    p.add_argument("--backbone_ckpt", default=None,
                   help="official backbone checkpoint (Swin .pth / "
                        "torchvision ResNet / HF state dict)")
    p.add_argument("--conv", default="swin")
    p.add_argument("--swap", default="either", choices=["either", "image"],
                   help="negative sampling: iu-xray variant uses 'image'")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-6)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--max_length", type=int, default=80)
    p.add_argument("--model_parallel", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=-1,
                   help="host loader worker processes (-1 auto, 0 threaded)")
    p.add_argument("--host_normalize", action="store_true",
                   help="normalize images on the host (float32) instead of "
                        "on the device")
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_test", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu for the plain versions)")
    return p.parse_args(argv)


def build_config(args, tokenizer):
    from mvlt_tpu_torch.config import MVLTConfig, tiny_config
    cfg = MVLTConfig.for_retrieval(lr=args.lr, max_length=args.max_length)
    cfg = dataclasses.replace(cfg, conv=args.conv)
    if args.tiny:
        cfg = tiny_config(cfg)
    return cfg.with_tokenizer(tokenizer)


def build_sources(args, image_size: int = 224):
    """(train source, test source); sets ``args.swap`` to 'image' for IU
    X-Ray."""
    from mvlt_tpu_torch.data.datasets import (AnnotationSource, PickleSource,
                                              SyntheticSource)
    if args.synthetic:
        size = 32 if args.tiny else 224
        return (SyntheticSource(n=32, image_size=size),
                SyntheticSource(n=8, image_size=size, seed=1))
    if args.iu_xray_root:
        args.swap = "image"       # run_retrieval_iuxray.py:130-137
        mk = lambda split: AnnotationSource(
            os.path.join(args.iu_xray_root, "images"),
            os.path.join(args.iu_xray_root, "annotation.json"), split,
            image_size=image_size,
            normalize="host" if args.host_normalize else "device")
        return mk("train"), mk("test")
    if not args.rgc_index:
        raise SystemExit("no data source: pass --rgc_index, "
                         "--iu_xray_root, or --synthetic")
    return (PickleSource(args.rgc_index),
            PickleSource(_split_index_path(args.rgc_index, "test")))


def main(argv=None):
    """Returns ``(runner, the eval dict or None)``."""
    args = parse_args(argv)
    from mvlt_tpu_torch.config import MeshConfig, TrainConfig
    from mvlt_tpu_torch.data.datasets import RetrievalDataset
    from mvlt_tpu_torch.flagship import _need_cuda
    from mvlt_tpu_torch.models.heads import RetrievalModel
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.tasks.retrieval import eval_retrieval, train_retrieval
    from mvlt_tpu_torch.text.tokenizer import default_tokenizer
    from mvlt_tpu_torch.utils import checkpoint as ckpt_lib

    _need_cuda(args.device, "run_retrieval")
    if not (args.do_train or args.do_test):
        raise SystemExit("nothing to do: pass --do_train and/or --do_test")
    tokenizer = default_tokenizer(synthetic_ok=args.synthetic)
    cfg = build_config(args, tokenizer)
    tc = TrainConfig(batch_size=args.batch_size, epochs=args.epochs,
                     num_workers=args.num_workers,
                     mesh=MeshConfig(model_parallel=args.model_parallel))
    runner = TaskRunner(RetrievalModel, cfg, tc, workdir=args.model_name,
                        name="retrieval", device=args.device)
    src_train, src_test = build_sources(args, cfg.swin.img_size)
    train_ds = RetrievalDataset(src_train, tokenizer, args.max_length,
                                "train", swap=args.swap)
    test_ds = RetrievalDataset(src_test, tokenizer, args.max_length, "test")
    pretrained = []
    if args.pretrained:
        pretrained.append(ckpt_lib.load_pretrained(args.pretrained)[1])
    if args.backbone_ckpt:
        from mvlt_tpu_torch.utils.bootstrap import load_backbone
        pretrained.append(load_backbone(args.backbone_ckpt, cfg))
    runner.init_state(pretrained_variables=pretrained or None)
    runner.maybe_restore()

    result = None
    if args.do_train:
        train_retrieval(runner, train_ds, epochs=args.epochs)
    if args.do_test:
        result = eval_retrieval(runner, test_ds,
                                batch_size=min(64, len(test_ds)))
        runner.logger.info("retrieval eval: %s", result)
        if args.model_name:
            os.makedirs(args.model_name, exist_ok=True)
            with open(os.path.join(args.model_name, "eval.json"), "w") as f:
                json.dump(result, f, indent=2)
        print(json.dumps(result))
    return runner, result


if __name__ == "__main__":
    main()

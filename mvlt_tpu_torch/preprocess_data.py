"""Offline dataset preprocessing CLI of the port (the root
``preprocess_data.py``'s flags exactly, on :mod:`mvlt_tpu_torch.data.
preprocess`): ``python -m mvlt_tpu_torch.preprocess_data TASK ...`` with
TASK one of ``rgc``, ``vqa-images``, ``vqa-text``, ``u8-cache``. It needs no
card."""

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    """The root script's argparse flags."""
    p = argparse.ArgumentParser()
    p.add_argument("task", choices=["rgc", "vqa-images", "vqa-text",
                                    "u8-cache"])
    p.add_argument("--data_root", default="./dataset")
    p.add_argument("--dataset", default="SLAKE", choices=["SLAKE", "VQA-RAD"])
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--source", default="roco",
                   choices=["roco", "medicat", "annotation"],
                   help="u8-cache input layout: ROCO split dir, MedICaT "
                        "json, or an R2Gen-style annotation.json "
                        "(two-view)")
    p.add_argument("--split", default="train")
    p.add_argument("--image_dir", default=None,
                   help="image dir for --source annotation")
    p.add_argument("--out", default=None, help="u8-cache output dir")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from mvlt_tpu_torch.data import preprocess as pp
    if args.task == "rgc":
        pp.preprocess_rgc(os.path.join(args.data_root, "RGC"),
                          image_size=args.image_size)
    elif args.task == "vqa-images":
        out = pp.preprocess_vqa_images(args.data_root, args.dataset,
                                       args.image_size)
        print("wrote", out)
    elif args.task == "u8-cache":
        from mvlt_tpu_torch.data.datasets import ImageFolderSource
        out_dir = args.out or os.path.join(args.data_root,
                                           f"u8cache_{args.source}_{args.split}")
        if args.source == "roco":
            items = ImageFolderSource.from_roco(args.data_root,
                                                args.split).items
            ids = None
        elif args.source == "medicat":
            items = ImageFolderSource.from_medicat(args.data_root).items
            ids = None
        else:
            import json as _json
            with open(os.path.join(args.data_root, "annotation.json")) as f:
                examples = _json.load(f)[args.split]
            image_dir = args.image_dir or os.path.join(args.data_root,
                                                       "images")
            items = [([os.path.join(image_dir, q) for q in e["image_path"]]
                      if len(e["image_path"]) > 1
                      else os.path.join(image_dir, e["image_path"][0]),
                      e["report"]) for e in examples]
            ids = [e["id"] for e in examples]
        out = pp.build_u8_cache(items, out_dir, args.image_size,
                                img_ids=ids, cap_ids=ids)
        print("wrote", out)
    else:
        out = pp.preprocess_vqa_text(args.data_root, args.dataset)
        print("wrote", out)


if __name__ == "__main__":
    main()

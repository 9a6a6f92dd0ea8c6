"""Times the beam search's cache reorder on one GPU: one (layers 12, beams
160 = b32 x 5, heads 12, slots 202, head dim 64) bf16 cache tensor, as
report generation at length 150 holds it, gathered along the beam axis by
advanced indexing, by ``index_select`` and in the suffix-only form, beside
a plain copy of the tensor (the bandwidth yardstick). CUDA events over 20
calls after 3 warm-up calls.

    python scripts/cache_reorder_probe.py
"""

import subprocess

import torch

PREFIX = 51          # [CLS] + 49 Swin-S tokens + [SEP]: never reordered


def ms(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    c = torch.randn(12, 160, 12, 202, 64, device=dev).to(torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(0)
    flat = (torch.arange(32, device=dev)[:, None] * 5 + torch.randint(
        0, 5, (32, 5), device=dev, generator=g)).reshape(-1)
    P = PREFIX

    def suffix_indexing():
        c[:, :, :, P:] = c[:, flat, :, P:]

    def suffix_index_select():
        c[:, :, :, P:] = c[:, :, :, P:].index_select(1, flat)

    assert torch.equal(c[:, flat], c.index_select(1, flat))
    variants = {
        "clone (bandwidth yardstick)": c.clone,
        "c[:, flat]": lambda: c[:, flat],
        "c.index_select(1, flat)": lambda: c.index_select(1, flat),
        "suffix c[:, :, :, P:] = c[:, flat, :, P:]": suffix_indexing,
        "suffix by index_select": suffix_index_select,
    }
    gb = 2 * c.numel() * c.element_size() / 1e9
    for name, fn in variants.items():
        print(f"{name}: {ms(fn):.3f} ms (a full copy reads and writes "
              f"{gb:.3f} GB)")


if __name__ == "__main__":
    main()

"""Package-level properties of the port: it imports no JAX, the flagship
builder never falls back to the CPU, its weights and inputs come from a
numpy seed, and the kernels' CUDA wrappers agree with their plain versions
on the card (marked ``cuda``: skipped where there is none)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.ops import blocks, kernels
from mvlt_tpu_torch.ops.layers import LayerNorm

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Importing the port and running a tiny forward leaves jax and flax out
    of ``sys.modules``."""
    code = textwrap.dedent("""
        import dataclasses, sys, torch
        torch.set_num_threads(2)
        from mvlt_tpu.config import MVLTConfig, SwinConfig
        import mvlt_tpu_torch
        from mvlt_tpu_torch.flagship import example_inputs, init_seeded_
        from mvlt_tpu_torch.models.heads import VQAModel
        cfg = MVLTConfig.for_vqa(result_num=5)
        cfg = dataclasses.replace(cfg, swin=SwinConfig(
            img_size=16, patch_size=4, embed_dim=16, depths=(2, 1),
            num_heads=(2, 4), window_size=2, drop_path_rate=0.0),
            fusion=dataclasses.replace(cfg.fusion, hidden_size=32,
            num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, vocab_size=200))
        model = init_seeded_(VQAModel(cfg))
        image, question = example_inputs(2, 6, image_size=16, vocab=200)
        prob, logits = model(image, question)
        assert logits.shape == (2, 5) and torch.isfinite(logits).all()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax"))
        print("JAX_MODULES", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX_MODULES []" in out.stdout, out.stdout


def test_build_vqa_forward_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship.build_vqa_forward(batch=1, device="cuda")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A machine with no CUDA toolkit gets a clear error, not a fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()


def test_init_seeded_and_example_inputs():
    cfg = flagship.flagship_vqa_config()
    assert (cfg.conv, cfg.swin.embed_dim, cfg.swin.depths, cfg.result_num) \
        == ("swin", 96, (2, 2, 18, 2), 224)
    from mvlt_tpu_torch.models.fusion import EncoderLayer
    layer = EncoderLayer(cfg.fusion, dtype=torch.float32, device="cpu")
    flagship.init_seeded_(layer, seed=3)
    for m in layer.modules():
        if isinstance(m, LayerNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert torch.equal(m.bias, torch.zeros_like(m.bias))
    w = layer.intermediate.weight
    assert abs(w.std().item() - 0.02) < 1e-3 and w.abs().max() > 0
    again = flagship.init_seeded_(
        EncoderLayer(cfg.fusion, dtype=torch.float32, device="cpu"), seed=3)
    assert torch.equal(again.qkv.weight, layer.qkv.weight)

    image, question = flagship.example_inputs(8, 23, seed=0)
    assert image.shape == (8, 3, 224, 224) and question.shape == (8, 23)
    lengths = (question > 0).sum(1)
    assert (lengths >= 5).all() and (lengths < 23).any()
    # padding only after the question
    for row, n in zip(question, lengths):
        assert (row[:n] > 0).all() and (row[n:] == 0).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: "
                    "python -m pytest tests/test_torch_port.py -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(98, 96, 288), (25, 48, 40)])
def test_cuda_gemm_matches_plain(cuda_device, M, K, N):
    g = torch.Generator().manual_seed(M)
    a = torch.randn(M, K, generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn(N, K, generator=g) * K ** -0.5).to(cuda_device,
                                                         torch.bfloat16)
    r = torch.randn(M, N, generator=g).to(cuda_device, torch.bfloat16)
    idx = torch.randperm(M, generator=g).to(cuda_device, torch.int32)
    got = kernels.gemm(a, w, None, gelu=True, residual=r, residual_index=idx,
                       store_index=idx)
    want = kernels.gemm_plain(a, w, None, gelu=True, residual=r,
                              residual_index=idx, store_index=idx)
    assert (got.float() - want.float()).abs().max() <= \
        2 ** -7 * max(1.0, want.float().abs().max().item())


@pytest.mark.cuda
def test_cuda_swin_block_matches_plain(cuda_device):
    g = torch.Generator().manual_seed(0)

    def rnd(*s, std=1.0, dt=torch.bfloat16):
        return (torch.randn(*s, generator=g) * std).to(cuda_device, dt)

    C, nH, N = 64, 2, 49
    params = (rnd(C, dt=torch.float32) + 1, rnd(C, dt=torch.float32),
              rnd(3 * C, C, std=C ** -0.5), rnd(3 * C), rnd(C, C, std=C ** -0.5),
              rnd(C), rnd(C, dt=torch.float32) + 1, rnd(C, dt=torch.float32),
              rnd(4 * C, C, std=C ** -0.5), rnd(4 * C),
              rnd(C, 4 * C, std=(4 * C) ** -0.5), rnd(C))
    x = rnd(2 * 4, N, C)
    bias = rnd(4, nH, N, N, dt=torch.float32)
    kw = dict(shift_spec=(14, 14, 7, 3))
    got = blocks.swin_full_block(x, params, bias, 0.25, nH, **kw)
    want = blocks.swin_full_block_plain(x, params, bias, 0.25, nH, **kw)
    assert (got.float() - want.float()).abs().max() <= \
        2 ** -5 * max(1.0, want.float().abs().max().item())
    assert np.isfinite(got.float().cpu().numpy()).all()

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


def test_port_imports_nothing_of_mvlt_tpu():
    """Importing the port, its entry points, its train step and
    ``chip_smoke`` leaves no ``mvlt_tpu`` / ``mvlt_tpu.*`` module (and no
    JAX) in ``sys.modules``: the port keeps its own copies of host modules."""
    code = textwrap.dedent("""
        import sys
        import mvlt_tpu_torch
        from mvlt_tpu_torch import flagship
        from mvlt_tpu_torch.train import steps, state
        from mvlt_tpu_torch.models.heads import PretrainModel
        from mvlt_tpu_torch.models.backbones import resnet
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("mvlt_tpu", "jax", "jaxlib", "flax"))
        print("FOREIGN_MODULES", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOREIGN_MODULES []" in out.stdout, out.stdout


def _rnd(g, *shape, std=1.0, dt=torch.bfloat16, dev="cuda"):
    return (torch.randn(*shape, generator=g) * std).to(dev, dt)


def _near(got, want, bar):
    scale = max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= bar * scale


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nn", "tn"])
def test_cuda_gemm_backward_modes_match_plain(cuda_device, layout):
    """K1's ``nn`` / ``tn`` layouts with a ragged contraction (``tn`` over
    rows of any count, ``nn`` over a multiple of 8), f32 output, f32
    residual, the saved pre-activation and the GELU' epilogue."""
    g = torch.Generator().manual_seed(7)
    M, K, N = 72, (104 if layout == "nn" else 100), 40
    a = _rnd(g, *((M, K) if layout == "nn" else (K, M)), dev=cuda_device)
    w = _rnd(g, K, N, std=K ** -0.5, dev=cuda_device)
    r = _rnd(g, M, N, dt=torch.float32, dev=cuda_device)
    for kw in (dict(out_dtype=torch.float32, residual=r), dict()):
        _near(kernels.gemm(a, w, layout=layout, **kw),
              kernels.gemm_plain(a, w, layout=layout, **kw), 2 ** -7)
    a1 = _rnd(g, M, N, dt=torch.float32, dev=cuda_device)
    _near(kernels.gemm(a, w, layout=layout, gelu_grad=a1),
          kernels.gemm_plain(a, w, layout=layout, gelu_grad=a1), 2 ** -7)
    if layout == "nn":
        wt = w.t().contiguous()
        y, pre = kernels.gemm(a, wt, gelu=True, save_preact=True)
        y0, pre0 = kernels.gemm_plain(a, wt, gelu=True, save_preact=True)
        _near(y, y0, 2 ** -7)
        _near(pre, pre0, 1e-4)


@pytest.mark.cuda
def test_cuda_attention_bwd_and_layernorm_bwd_match_plain(cuda_device):
    """K4 at a ragged N with a padded key bias, K5 and its column sum."""
    g = torch.Generator().manual_seed(8)
    G, N, C, nH = 3, 37, 64, 2
    qkv = _rnd(g, G * N, 3 * C, std=0.5, dev=cuda_device)
    dctx = _rnd(g, G * N, C, dev=cuda_device)
    kb = torch.where(torch.rand(G, N, generator=g) < 0.2, -10000.0,
                     0.0).to(cuda_device)
    got = kernels.biased_attention_bwd(qkv, dctx, nH, N, 0.125, kb)
    want = kernels.biased_attention_bwd_plain(qkv, dctx, nH, N, 0.125, kb)
    _near(got[0], want[0], 2 ** -7)
    _near(got[1], want[1], 1e-4)
    res = _rnd(g, 50, 96, std=2.0, dt=torch.float32, dev=cuda_device)
    gam = _rnd(g, 96, dt=torch.float32, dev=cuda_device) + 1.0
    gy = _rnd(g, 50, 96, dev=cuda_device)
    for a, b in zip(kernels.layernorm_bwd(res, gam, gy, 1e-12),
                    kernels.layernorm_bwd_plain(res, gam, gy, 1e-12)):
        _near(a, b, 2 ** -7)
    _near(kernels.column_sum(gy), kernels.column_sum_plain(gy), 1e-4)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [131, 128, 37])
def test_cuda_masked_attention_fwd_bwd_match_plain(cuda_device, N):
    """K2 and K4 with a seq2seq qbias and a real dropout mask, then K4 with
    a key bias alone, at N = 131 (the pretrain step's), 128 (the largest N
    the earlier K4 layout claimed and could not launch) and a ragged 37."""
    g = torch.Generator().manual_seed(N)
    G, C, nH = 3, 128, 2
    qkv = _rnd(g, G * N, 3 * C, std=0.5, dev=cuda_device)
    dctx = _rnd(g, G * N, C, dev=cuda_device)
    causal = torch.triu(torch.full((N, N), -10000.0), 1)
    qb = causal.expand(G, N, N).contiguous().to(cuda_device)
    am = ((torch.rand(G, nH, N, N, generator=g) < 0.9).float() / 0.9).to(
        cuda_device, torch.bfloat16)
    kb = torch.where(torch.rand(G, N, generator=g) < 0.2, -10000.0,
                     0.0).to(cuda_device)
    for kbias, qbias, amask in ((None, qb, am), (kb, None, am), (kb, None, None)):
        _near(kernels.biased_attention(qkv, nH, N, 0.125, None, kbias, qbias,
                                       amask),
              kernels.biased_attention_plain(qkv, nH, N, 0.125, None, kbias,
                                             qbias, amask), 2 ** -7)
        got = kernels.biased_attention_bwd(qkv, dctx, nH, N, 0.125, kbias,
                                           qbias, amask)
        want = kernels.biased_attention_bwd_plain(qkv, dctx, nH, N, 0.125,
                                                  kbias, qbias, amask)
        _near(got[0], want[0], 2 ** -7)
        _near(got[1], want[1], 1e-4)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_gemm_emask_and_layernorm_bwd_hmask_match_plain(cuda_device):
    g = torch.Generator().manual_seed(9)
    M, K, N = 72, 96, 64
    a = _rnd(g, M, K, dev=cuda_device)
    w = _rnd(g, N, K, std=K ** -0.5, dev=cuda_device)
    r = _rnd(g, M, N, dt=torch.float32, dev=cuda_device)
    e = ((torch.rand(M, N, generator=g) < 0.9).float() / 0.9).to(
        cuda_device, torch.bfloat16)
    kw = dict(residual=r, emask=e, out_dtype=torch.float32)
    _near(kernels.gemm(a, w, **kw), kernels.gemm_plain(a, w, **kw), 2 ** -7)
    res = _rnd(g, M, N, std=2.0, dt=torch.float32, dev=cuda_device)
    gam = _rnd(g, N, dt=torch.float32, dev=cuda_device) + 1.0
    gy = _rnd(g, M, N, dev=cuda_device)
    for x, y in zip(kernels.layernorm_bwd(res, gam, gy, 1e-12, hmask=e),
                    kernels.layernorm_bwd_plain(res, gam, gy, 1e-12, hmask=e)):
        _near(x, y, 2 ** -7)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 4])
def test_cuda_pattern_attention_bwd_matches_plain_and_repeats(cuda_device, P):
    """K4's window-pattern mode at Swin windows (N = 49, head dim 32) with
    one pattern and one per window: dqkv and dpattern against the plain
    version, two calls bitwise equal, and G % P != 0 refused on the host."""
    g = torch.Generator().manual_seed(40 + P)
    G, N, C, nH = 16, 49, 64, 2
    qkv = _rnd(g, G * N, 3 * C, std=0.5, dev=cuda_device)
    dctx = _rnd(g, G * N, C, dev=cuda_device)
    pat = _rnd(g, P, nH, N, N, dt=torch.float32, dev=cuda_device)
    got = kernels.biased_attention_bwd(qkv, dctx, nH, N, 0.2, pattern=pat)
    want = kernels.biased_attention_bwd_plain(qkv, dctx, nH, N, 0.2,
                                              pattern=pat)
    assert got[1] is None and want[1] is None
    _near(got[0], want[0], 2 ** -7)
    _near(got[2], want[2], 1e-4)
    again = kernels.biased_attention_bwd(qkv, dctx, nH, N, 0.2, pattern=pat)
    assert torch.equal(got[0], again[0]) and torch.equal(got[2], again[2])
    with pytest.raises(ValueError, match="G % P"):
        kernels.biased_attention_bwd(qkv[:15 * N], dctx[:15 * N], nH, N, 0.2,
                                     pattern=pat[:1].expand(2, -1, -1, -1)
                                     .contiguous())
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_row_scale_and_preln_backward_match_plain(cuda_device):
    """K1's f32 row scale (per image), K5's pre-LN form (bf16 res, f32 g,
    an incoming residual gradient, a row scale on da) and the scaled column
    sum against their plain versions."""
    g = torch.Generator().manual_seed(10)
    M, K, N = 96, 64, 32
    a = _rnd(g, M, K, dev=cuda_device)
    w = _rnd(g, N, K, std=K ** -0.5, dev=cuda_device)
    r = _rnd(g, M, N, dt=torch.float32, dev=cuda_device)
    s = torch.tensor([0.0, 1.25, 1.25, 0.0], device=cuda_device)
    kw = dict(residual=r, row_scale=s, out_dtype=torch.float32)
    _near(kernels.gemm(a, w, **kw), kernels.gemm_plain(a, w, **kw), 2 ** -7)
    x = _rnd(g, M, N, dev=cuda_device)
    gam = _rnd(g, N, dt=torch.float32, dev=cuda_device) + 1.0
    dh = _rnd(g, M, N, dt=torch.float32, dev=cuda_device)
    for gres, rs in ((r, None), (x, s)):
        kw = dict(gres=gres, row_scale=rs, out_dtype=torch.bfloat16)
        for y, y0 in zip(kernels.layernorm_bwd(x, gam, dh, 1e-5, **kw),
                         kernels.layernorm_bwd_plain(x, gam, dh, 1e-5, **kw)):
            _near(y, y0, 2 ** -7)
    for y, y0 in zip(kernels.column_sum(x, row_scale=s),
                     kernels.column_sum_plain(x, row_scale=s)):
        _near(y, y0, 1e-4)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_swin_vqa_loss_trains_the_backbone(cuda_device):
    """A tiny Swin VQA loss on the card gives every ``conv.*`` parameter a
    finite, nonzero gradient: the Swin blocks run their autograd Function,
    the LayerNorms outside them ``F.layer_norm`` and the relative-position
    bias keeps its graph (with bf16 parameters and with f32 masters)."""
    import dataclasses

    from mvlt_tpu_torch.config import MVLTConfig, SwinConfig
    from mvlt_tpu_torch.models.heads import VQAModel
    from mvlt_tpu_torch.ops.layers import DropoutMasks

    cfg = MVLTConfig.for_vqa(result_num=5)
    cfg = dataclasses.replace(cfg, swin=SwinConfig(
        img_size=64, patch_size=4, embed_dim=32, depths=(2, 2),
        num_heads=(2, 4), window_size=4, drop_path_rate=0.2),
        fusion=dataclasses.replace(cfg.fusion, hidden_size=64,
                                   num_hidden_layers=1, num_attention_heads=2,
                                   intermediate_size=128, vocab_size=200))
    # 8 images, so that DropPath (rate up to 0.2) keeps every branch alive
    # in some image and every parameter gets a nonzero gradient
    image, question = flagship.example_inputs(8, 8, image_size=64, vocab=200)
    label = torch.arange(8) % 5
    for dtype in (torch.bfloat16, torch.float32):
        model = flagship.init_seeded_(VQAModel(
            cfg, dtype=dtype, device=cuda_device,
            compute_dtype=torch.bfloat16))
        before = blocks.swin_full_block.train_launches
        loss, _ = model.loss(image.to(cuda_device), question.to(cuda_device),
                             label.to(cuda_device),
                             masks=DropoutMasks(torch.Generator(
                                 device=cuda_device).manual_seed(0)))
        loss.backward()
        assert blocks.swin_full_block.train_launches > before
        for name, p in model.named_parameters():
            if name.startswith("conv."):
                assert p.grad is not None, name
                assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["kbias", "qbias"])
def test_cuda_attention_adrop_matches_plain(cuda_device, mode):
    """K2 and K4 with in-kernel dropout (a device seed, rate 0.1) at N = 131
    and a ragged 37: K2's drawn mask bitwise equal to ``adrop_mask_plain``,
    two calls bitwise equal, ctx and K4's gradients against the plain
    versions, which take that mask."""
    g = torch.Generator().manual_seed(50)
    seed = torch.tensor([40503, 777], dtype=torch.int32, device=cuda_device)
    for N in (131, 37):
        G, C, nH = 3, 128, 2
        qkv = _rnd(g, G * N, 3 * C, std=0.5, dev=cuda_device)
        dctx = _rnd(g, G * N, C, dev=cuda_device)
        kb = torch.where(torch.rand(G, N, generator=g) < 0.2, -10000.0,
                         0.0).to(cuda_device)
        qb = torch.triu(torch.full((N, N), -10000.0), 1).expand(
            G, N, N).contiguous().to(cuda_device)
        kw = dict(key_bias=kb) if mode == "kbias" else dict(qbias=qb)
        ctx, mask = kernels.biased_attention(qkv, nH, N, 0.125, adrop=(
            seed, 0.1), save_mask=True, **kw)
        again = kernels.biased_attention(qkv, nH, N, 0.125,
                                         adrop=(seed, 0.1), **kw)
        assert torch.equal(mask, kernels.adrop_mask_plain(seed, G, nH, N, 0.1))
        assert torch.equal(ctx, again)
        _near(ctx, kernels.biased_attention_plain(qkv, nH, N, 0.125,
                                                  adrop=(seed, 0.1), **kw),
              2 ** -7)
        got = kernels.biased_attention_bwd(qkv, dctx, nH, N, 0.125,
                                           adrop=(seed, 0.1), **kw)
        want = kernels.biased_attention_bwd_plain(qkv, dctx, nH, N, 0.125,
                                                  adrop=(seed, 0.1), **kw)
        _near(got[0], want[0], 2 ** -7)
        _near(got[1], want[1], 1e-4)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 4])
def test_cuda_stored_p_attention_matches_plain(cuda_device, P):
    """K2 storing p and K4 from the stored p at Swin-S stage-3 windows (N =
    49, C 384, 12 heads, 16 windows), one pattern and one per window: p
    within bf16 rounding of the plain softmax, K4 against its plain version
    on the same p and near its recompute mode, dpattern bitwise equal over
    two calls."""
    g = torch.Generator().manual_seed(60 + P)
    G, N, C, nH = 16, 49, 384, 12
    qkv = _rnd(g, G * N, 3 * C, std=0.5, dev=cuda_device)
    dctx = _rnd(g, G * N, C, dev=cuda_device)
    pat = _rnd(g, P, nH, N, N, dt=torch.float32, dev=cuda_device)
    sc = (C // nH) ** -0.5
    ctx, p = kernels.biased_attention(qkv, nH, N, sc, pat, save_p=True)
    ctx0, p0 = kernels.biased_attention_plain(qkv, nH, N, sc, pat, save_p=True)
    assert p.dtype == torch.bfloat16 and p.shape == (G, nH, N, N)
    _near(ctx, ctx0, 2 ** -7)
    # one bf16 step below 1 (2^-7) where the two f32 values round apart
    assert (p.float() - p0.float()).abs().max().item() <= 2 ** -7
    got = kernels.biased_attention_bwd(qkv, dctx, nH, N, sc, pattern=pat, p=p)
    want = kernels.biased_attention_bwd_plain(qkv, dctx, nH, N, sc,
                                              pattern=pat, p=p)
    _near(got[0], want[0], 2 ** -7)
    _near(got[2], want[2], 1e-4)
    recompute = kernels.biased_attention_bwd(qkv, dctx, nH, N, sc,
                                             pattern=pat)
    _near(got[0], recompute[0], 2 ** -5)
    again = kernels.biased_attention_bwd(qkv, dctx, nH, N, sc, pattern=pat,
                                         p=p)
    assert torch.equal(got[0], again[0]) and torch.equal(got[2], again[2])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_stored_p_attention_key_bias_mode(cuda_device):
    """K4 from the stored p without a pattern (the key-bias mode, one group
    a block) at N = 131, head dim 64, with a padded key bias: dqkv and
    dkbias against the plain version on the same p."""
    g = torch.Generator().manual_seed(70)
    G, N, C, nH = 3, 131, 128, 2
    qkv = _rnd(g, G * N, 3 * C, std=0.5, dev=cuda_device)
    dctx = _rnd(g, G * N, C, dev=cuda_device)
    kb = torch.where(torch.rand(G, N, generator=g) < 0.2, -10000.0,
                     0.0).to(cuda_device)
    _, p = kernels.biased_attention(qkv, nH, N, 0.125, key_bias=kb,
                                    save_p=True)
    got = kernels.biased_attention_bwd(qkv, dctx, nH, N, 0.125, kb, p=p)
    want = kernels.biased_attention_bwd_plain(qkv, dctx, nH, N, 0.125, kb,
                                              p=p)
    _near(got[0], want[0], 2 ** -7)
    _near(got[1], want[1], 1e-4)
    torch.cuda.synchronize()

"""Package-level properties of the port: it imports no JAX, the flagship
builder never falls back to the CPU, its weights and inputs come from a
numpy seed, and the kernels' CUDA wrappers agree with their plain versions
on the card (marked ``cuda``: skipped where there is none)."""

import functools
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
    """Importing the port, its entry points (the VQA, pretrain, report
    generation and retrieval drivers among them), its train step, its host
    modules (tokenizer, datasets, loader, transforms, the VQA, retrieval
    and caption metrics, tasks, checkpoints, logging, the backbone
    bootstrap), the ViT and linear-patch backbones, the Swin backbone on
    each of its ``attn_impl`` routes with its dropout modules and the
    backward rules of rows 1, 6 and 7 (``ops/blocks.py``), the native
    tokenizers (built and run), the preprocessing module and its CLI, and
    ``chip_smoke`` leaves no ``mvlt_tpu`` /
    ``mvlt_tpu.*`` module (and no JAX, flax, optax or orbax) in
    ``sys.modules``: the port keeps its own copies of host modules."""
    code = textwrap.dedent("""
        import sys
        import mvlt_tpu_torch
        from mvlt_tpu_torch import flagship
        from mvlt_tpu_torch.train import steps, state
        from mvlt_tpu_torch.models.heads import PretrainModel
        from mvlt_tpu_torch.models.backbones import resnet
        from mvlt_tpu_torch import run_vqa, run_pretrain, config, profile_step
        from mvlt_tpu_torch.text import tokenizer
        from mvlt_tpu_torch.data import datasets, loader, transforms
        from mvlt_tpu_torch.metrics import vqa, retrieval
        from mvlt_tpu_torch.metrics import (bleu, cider, eval_cap, meteor,
                                            porter, ptb, rouge)
        from mvlt_tpu_torch.tasks import common, vqa as vqa_task, pretrain
        from mvlt_tpu_torch.tasks import caption, retrieval as ret_task
        from mvlt_tpu_torch import run_report_generation, run_retrieval
        from mvlt_tpu_torch.utils import checkpoint, logging, convert
        from mvlt_tpu_torch.utils import bootstrap
        from mvlt_tpu_torch.utils import misc, profiling
        from mvlt_tpu_torch.train import state
        from mvlt_tpu_torch import profile_step
        from mvlt_tpu_torch.models.backbones import adapter
        from mvlt_tpu_torch.models.backbones import linear_patch, vit
        from mvlt_tpu_torch.models.backbones import swin
        from mvlt_tpu_torch.ops import blocks, layers
        import torch
        cfg = flagship.flagship_swin_attn_dropout_pretrain_config()
        for impl in swin.ATTN_IMPLS:
            swin.SwinTransformer(cfg.swin, dtype=torch.bfloat16,
                                 device="meta", attn_impl=impl)
        for make in (flagship.flagship_swin448_vqa_config,
                     flagship.flagship_swin_ape_pretrain_config):
            swin.SwinTransformer(make().swin, dtype=torch.bfloat16,
                                 device="meta")
        with profiling.annotate("x"):
            profiling.StepTimer().start()
        run_vqa.parse_args(["--synthetic"])
        run_pretrain.parse_args(["--synthetic"])
        run_report_generation.parse_args(["--dataset", "synthetic"])
        run_retrieval.parse_args(["--synthetic"])
        meteor.corpus_meteor({0: ["a b"]}, {0: ["a c"]})
        from mvlt_tpu_torch.text import native
        from mvlt_tpu_torch.data import preprocess
        from mvlt_tpu_torch import preprocess_data
        preprocess_data.build_parser().parse_args(["u8-cache"])
        assert ptb.ptb_tokenize("a (b)") == "a -lrb- b -rrb-"
        assert tokenizer.WordPieceTokenizer()._native is not None
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("mvlt_tpu", "jax", "jaxlib", "flax",
                                            "optax", "orbax"))
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
@pytest.mark.parametrize("N", [131, 128, 37, 221, 278])
def test_cuda_masked_attention_fwd_bwd_match_plain(cuda_device, N):
    """K2 and K4 with a seq2seq qbias and a real dropout mask, then with a
    key bias and the mask, then with a key bias alone, at N = 131 (the
    pretrain step's), 128 (the largest N the earlier K4 layout claimed and
    could not launch), a ragged 37, and 221 and 278 (a 196-token image with
    BERT text), which K4 takes since its tile plan (the scalar K4 refused N
    > 140 before launching). Two calls of K2 and of K4 are bitwise
    equal."""
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
    assert N <= kernels.max_attention_n(C // nH, backward=True)
    for kbias, qbias, amask in ((None, qb, am), (kb, None, am), (kb, None, None)):
        ctx = kernels.biased_attention(qkv, nH, N, 0.125, None, kbias, qbias,
                                       amask)
        _near(ctx, kernels.biased_attention_plain(qkv, nH, N, 0.125, None,
                                                  kbias, qbias, amask),
              2 ** -7)
        assert torch.equal(ctx, kernels.biased_attention(
            qkv, nH, N, 0.125, None, kbias, qbias, amask))
        got = kernels.biased_attention_bwd(qkv, dctx, nH, N, 0.125, kbias,
                                           qbias, amask)
        want = kernels.biased_attention_bwd_plain(qkv, dctx, nH, N, 0.125,
                                                  kbias, qbias, amask)
        _near(got[0], want[0], 2 ** -7)
        _near(got[1], want[1], 1e-4)
        again = kernels.biased_attention_bwd(qkv, dctx, nH, N, 0.125, kbias,
                                             qbias, amask)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nt", "nn", "tn"])
def test_cuda_gemm_every_layout_and_epilogue_matches_plain(cuda_device,
                                                           layout):
    """K1's TMA + wgmma mainloop in each layout at ragged edges (M, N not
    multiples of the 128 x 128 tile, a contraction not a multiple of the
    k-tile: any row count in ``tn``), with every epilogue, unsplit; then an
    epilogue-free product that the plan splits, in bf16 and f32, against
    the plain version, two calls bitwise equal."""
    g = torch.Generator().manual_seed(11)
    f32 = torch.float32
    M, N = 200, 136
    K = 333 if layout == "tn" else 328

    def operands(M, N, K):
        a = _rnd(g, *((K, M) if layout == "tn" else (M, K)), dev=cuda_device)
        w = _rnd(g, *((N, K) if layout == "nt" else (K, N)), std=K ** -0.5,
                 dev=cuda_device)
        return a, w

    a, w = operands(M, N, K)
    b = _rnd(g, N, dev=cuda_device)
    r = _rnd(g, M, N, dt=f32, dev=cuda_device)
    a1 = _rnd(g, M, N, dt=f32, dev=cuda_device)
    e = ((torch.rand(M, N, generator=g) < 0.9).float() / 0.9).to(
        cuda_device, torch.bfloat16)
    dp = (torch.rand(8, generator=g) < 0.7).float().to(cuda_device) / 0.7
    idx = torch.randperm(M, generator=g).to(cuda_device, torch.int32)
    for bias, kw in ((None, dict()), (None, dict(out_dtype=f32)),
                     (b, dict(gelu=True, save_preact=True)),
                     (None, dict(gelu_grad=a1, out_dtype=f32)),
                     (b, dict(emask=e, row_scale=dp, residual=r,
                              residual_index=idx, store_index=idx))):
        got = kernels.gemm(a, w, bias, layout=layout, **kw)
        want = kernels.gemm_plain(a, w, bias, layout=layout, **kw)
        for x, y in zip(*((got, want) if kw.get("save_preact")
                          else ((got,), (want,)))):
            _near(x, y, 2 ** -7)
    M, N, K = 96, 136, 3000
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert kernels.gemm_plan(M, N, K, sms).splits > 1
    a, w = operands(M, N, K)
    for out_dtype in (torch.bfloat16, f32):
        before = kernels.gemm.splitk_launches
        got = kernels.gemm(a, w, layout=layout, out_dtype=out_dtype)
        assert kernels.gemm.splitk_launches == before + 1
        _near(got, kernels.gemm_plain(a, w, layout=layout,
                                      out_dtype=out_dtype), 2 ** -7)
        assert torch.equal(got, kernels.gemm(a, w, layout=layout,
                                             out_dtype=out_dtype))
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
    """K2 and K4 with in-kernel dropout (a device seed, rate 0.1) at N = 131,
    a ragged 37, and 221 and 278 (which K4 takes since its tile plan): K2's
    drawn mask bitwise equal to ``adrop_mask_plain``, two calls bitwise
    equal, ctx and K4's gradients (the mask regenerated) against the plain
    versions, which take that mask."""
    g = torch.Generator().manual_seed(50)
    seed = torch.tensor([40503, 777], dtype=torch.int32, device=cuda_device)
    for N in (131, 37, 221, 278):
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
    ctx1, p1 = kernels.biased_attention(qkv, nH, N, sc, pat, save_p=True)
    assert torch.equal(ctx, ctx1) and torch.equal(p, p1)
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


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 4])
def test_cuda_window_attention_matches_plain(cuda_device, P):
    """K2's head-major mode at Swin windows (N = 49, head dim 32), on
    contiguous q, k, v and on views of one (BW, N, 3C) product (the
    'pallas' route's layout), the packed mode on the same rows, and
    ``window_attention`` forward and backward (K4 pattern mode) against
    their plain versions."""
    g = torch.Generator().manual_seed(80 + P)
    G, N, nH, Dh = 16, 49, 3, 32
    C = nH * Dh
    qkv = _rnd(g, G, N, 3 * C, std=0.5, dev=cuda_device)
    q, k, v = qkv.view(G, N, 3, nH, Dh).permute(2, 0, 3, 1, 4).unbind(0)
    pat = _rnd(g, P, nH, N, N, dt=torch.float32, dev=cuda_device)
    sc = Dh ** -0.5
    want = kernels.biased_attention_heads_plain(q, k, v, sc, pat)
    for args in ((q, k, v), (q.contiguous(), k.contiguous(), v.contiguous())):
        got = kernels.biased_attention_heads(*args, sc, pat)
        assert got.shape == (G, nH, N, Dh) and got.dtype == torch.bfloat16
        _near(got, want, 2 ** -7)
    packed = kernels.biased_attention(qkv.view(G * N, 3 * C), nH, N, sc, pat)
    heads = kernels.biased_attention_heads(q, k, v, sc, pat)
    assert torch.equal(packed.view(G, N, nH, Dh).transpose(1, 2), heads)
    assert torch.equal(heads, kernels.biased_attention_heads(q, k, v, sc, pat))
    gy = _rnd(g, G, nH, N, Dh, dev=cuda_device)
    got = blocks.window_attention_bwd(q, k, v, pat, gy, sc)
    want = blocks.window_attention_bwd_plain(q, k, v, pat, gy, sc)
    for a, b, bar in zip(got, want, (2 ** -7,) * 3 + (1e-4,)):
        _near(a, b, bar)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_rows_7_9_10_match_plain(cuda_device):
    """``swin_attn_half`` at N = 144 (window 12, head dim 32: 139,392 bytes
    of K2 shared memory), ``fused_seq_attention`` at a ragged N = 37 with a
    padded key bias, forward and backward, and ``full_forward_windows`` with
    four patterns, against their plain versions."""
    g = torch.Generator().manual_seed(90)
    rnd = functools.partial(_rnd, g, dev=cuda_device)
    C, nH, N = 96, 3, 144
    x = rnd(2, N, C)
    ln = (rnd(C, std=0.1, dt=torch.float32) + 1.0,
          rnd(C, std=0.1, dt=torch.float32))
    wq, bq, wp, bp = (rnd(3 * C, C, std=C ** -0.5), rnd(3 * C, std=0.1),
                      rnd(C, C, std=C ** -0.5), rnd(C, std=0.1))
    bias = rnd(1, nH, N, N, std=0.5, dt=torch.float32)
    half = (x, *ln, wq, bq, wp, bp, bias, 0.2, nH)
    _near(blocks.swin_attn_half(*half), blocks.swin_attn_half_plain(*half),
          2 ** -5)
    S = 37
    xs = rnd(4, S, C)
    kb = torch.where(torch.rand(4, S, generator=g) < 0.2, -10000.0,
                     0.0).to(cuda_device)
    seq = (xs, wq, bq, wp, bp, kb, 0.2, nH)
    _near(blocks.fused_seq_attention(*seq),
          blocks.fused_seq_attention_plain(*seq), 2 ** -5)
    x2 = xs.view(4 * S, C)
    qkv2 = kernels.gemm(x2, wq, bq)
    ctx2 = kernels.biased_attention(qkv2, nH, S, 0.2, key_bias=kb)
    bwd = (x2, qkv2, ctx2, rnd(4 * S, C), wq, wp, kb, S, 0.2, nH)
    for a, b in zip(blocks.fused_seq_attention_bwd(*bwd),
                    blocks.fused_seq_attention_bwd_plain(*bwd)):
        _near(a, b, 2 ** -5)
    params = (*ln, wq, bq, wp, bp, *ln, rnd(4 * C, C, std=C ** -0.5),
              rnd(4 * C, std=0.1), rnd(C, 4 * C, std=(4 * C) ** -0.5),
              rnd(C, std=0.1))
    xw = rnd(8, 49, C)
    pat = rnd(4, nH, 49, 49, std=0.5, dt=torch.float32)
    _near(blocks.full_forward_windows(xw, params, pat, 0.2, nH),
          blocks.full_forward_windows_plain(xw, params, pat, 0.2, nH), 2 ** -5)
    torch.cuda.synchronize()


def _twice_equal(fn):
    one, two = fn(), fn()
    one = one if isinstance(one, tuple) else (one,)
    two = two if isinstance(two, tuple) else (two,)
    return all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(one, two))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [96, 100, 768])
def test_cuda_layernorm_bwd_vector_and_element_paths(cuda_device, C):
    """K5's VJP on its 16-byte path (C = 96, 768) and its element path (C =
    100), at M = 1, at M not a multiple of a block's rows and past one wave
    of persistent blocks, in each mode the paths use (plain; hmask; the
    pre-LN form with bf16 res, f32 g, f32 / bf16 gres and a row scale;
    ``dres=False``) against the plain version at 2^-7, two calls bitwise
    equal."""
    g = torch.Generator().manual_seed(60 + C)
    for M in (1, 37, 4 * 1056 + 5):
        res = _rnd(g, M, C, std=2.0, dt=torch.float32, dev=cuda_device)
        xb = _rnd(g, M, C, std=2.0, dev=cuda_device)
        gam = _rnd(g, C, dt=torch.float32, dev=cuda_device) + 1.0
        gy = _rnd(g, M, C, dev=cuda_device)
        dh = _rnd(g, M, C, dt=torch.float32, dev=cuda_device)
        h = ((torch.rand(M, C, generator=g) < 0.9).float() / 0.9).to(
            cuda_device, torch.bfloat16)
        s = torch.full((M,), 1.25, device=cuda_device)   # a scale a row
        s[::3] = 0.0
        gres32 = _rnd(g, M, C, dt=torch.float32, dev=cuda_device)
        modes = [(res, gy, {}), (res, gy, dict(hmask=h)),
                 (xb, dh, dict(gres=gres32, dres=False)),
                 (res, dh, dict(gres=gy, row_scale=s))]
        for r, gg, kw in modes:
            kw = dict(kw, out_dtype=torch.bfloat16)
            got = kernels.layernorm_bwd(r, gam, gg, 1e-5, **kw)
            want = kernels.layernorm_bwd_plain(r, gam, gg, 1e-5, **kw)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    _near(a, b, 2 ** -7)
            assert _twice_equal(
                lambda: kernels.layernorm_bwd(r, gam, gg, 1e-5, **kw))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("N", [288, 3070])
def test_cuda_column_sum_vector_and_element_paths(cuda_device, N):
    """K5's column sum on its 16-byte path (N = 288) and its element path
    (N = 3070), bf16 and f32, with and without a row scale, at M = 1, a
    ragged M and a tall M, against the plain version; two calls bitwise
    equal."""
    g = torch.Generator().manual_seed(70 + N)
    for M in (1, 37, 20000):
        xb = _rnd(g, M, N, std=0.1, dev=cuda_device)
        xf = _rnd(g, M, N, std=0.1, dt=torch.float32, dev=cuda_device)
        _near(kernels.column_sum(xb), kernels.column_sum_plain(xb), 1e-4)
        _near(kernels.column_sum(xf), kernels.column_sum_plain(xf), 1e-4)
        s = torch.full((M if M < 40 else 40,), 1.5, device=cuda_device)
        s[0] = 0.0
        got = kernels.column_sum(xb, row_scale=s)
        want = kernels.column_sum_plain(xb, row_scale=s)
        _near(got[0], want[0], 1e-4)
        _near(got[1], want[1], 2 ** -7)
        for x, kw in ((xb, {}), (xf, {}), (xb, dict(row_scale=s))):
            assert _twice_equal(lambda: kernels.column_sum(x, **kw))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("C", [96, 100, 768, 1536])
def test_cuda_layernorm_vector_and_element_paths(cuda_device, C):
    """K3 on its 16-byte path (C = 96, 768; 1536, a row per warp at six
    chunks a lane) and its element path (C = 100), f32 and bf16 in, with the
    row gather, at M = 1 and a ragged M; a width past 2048 is refused."""
    g = torch.Generator().manual_seed(80 + C)
    for M in (1, 37, 1000):
        gam = _rnd(g, C, dt=torch.float32, dev=cuda_device) + 1.0
        bet = _rnd(g, C, std=0.1, dt=torch.float32, dev=cuda_device)
        idx = torch.randperm(M, generator=g).to(cuda_device, torch.int32)
        for dt in (torch.float32, torch.bfloat16):
            x = _rnd(g, M, C, std=2.0, dt=dt, dev=cuda_device) + 0.5
            for ri in (None, idx):
                _near(kernels.layernorm(x, gam, bet, 1e-5, ri,
                                        out_dtype=torch.bfloat16),
                      kernels.layernorm_plain(x, gam, bet, 1e-5, ri,
                                              out_dtype=torch.bfloat16),
                      2 ** -7)
    wide = _rnd(g, 2, 2056, dev=cuda_device)
    one = torch.ones(2056, device=cuda_device)
    with pytest.raises(ValueError, match="C=2056"):
        kernels.layernorm(wide, one, one, 1e-5)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_caption_generate_is_deterministic_and_prefill_matches_plain(
        cuda_device):
    """Report generation at full width (Swin-S + BERT-base, bf16) on the
    card at b2, beam 3, length 8: two beam calls and two sampling calls on
    the default (seeded) noise are bitwise equal, ``unroll`` and
    ``suffix_reorder`` give the loop's results, and the prefill's logits on
    the kernels are within 0.05 x max|plain| of the plain versions'."""
    from mvlt_tpu_torch.models import generation
    gen, image = flagship.build_caption_generate(batch=2, num_beams=3,
                                                 max_length=8,
                                                 device=cuda_device)
    out = gen(image)
    for other in (gen(image), gen(image, unroll=True),
                  gen(image, suffix_reorder=True)):
        assert all(torch.equal(a, b) for a, b in zip(out, other))
    sample = gen(image, num_beams=1, sample=True)
    assert all(torch.equal(a, b) for a, b in
               zip(sample, gen(image, num_beams=1, sample=True)))
    with torch.no_grad():
        feat = gen.model.encode_image(image)
        got = generation._prefill(gen.model, feat, gen.spec,
                                  blocks.KERNEL_OPS)[0].float()
        want = generation._prefill(gen.model, feat, gen.spec,
                                   blocks.PLAIN_OPS)[0].float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 0.05 * want.abs().max()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_retrieval_grid_matches_plain(cuda_device):
    """The retrieval grid at full width (Swin-S + BERT-base, bf16, S = 131)
    on the card, 6 samples in chunks of 4 (the last chunk ragged): P(match)
    on the kernels within 0.05 x max|plain| of the plain versions', two
    calls bitwise equal, the diagonal labelled."""
    grid, (images, captions, cap_ids) = flagship.build_retrieval_grid(
        n=6, batch_size=4, device=cuda_device)
    got = grid(images, captions, cap_ids)
    again = grid(images, captions, cap_ids)["similarities"]
    want = grid(images, captions, cap_ids, plain=True)["similarities"]
    sims = got["similarities"]
    assert sims.shape == (6, 6) and np.isfinite(sims).all()
    assert np.array_equal(sims, again)
    assert np.abs(sims - want).max() <= 0.05 * np.abs(want).max()
    assert (np.diag(got["labels"]) == 1).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_vqa_driver_epoch_matches_plain(cuda_device, tmp_path):
    """One b8 epoch of the VQA driver (``train_vqa`` through a
    ``TaskRunner``, the loader, the CUDA prefetch, validation and test) on
    the kernels and on the plain versions from one seed: each step draws
    the same masks on both (they depend on the seed and the step), the
    losses agree within 1e-2 relative, the kernels ran, and the trained
    model's eval logits agree with its plain forward within 0.05 x
    max|plain|."""
    import dataclasses
    import json

    from mvlt_tpu_torch.config import MVLTConfig, SwinConfig, TrainConfig
    from mvlt_tpu_torch.data.datasets import (MedVQADataset,
                                              write_synthetic_vqa)
    from mvlt_tpu_torch.models.heads import VQAModel
    from mvlt_tpu_torch.tasks.common import TaskRunner
    from mvlt_tpu_torch.tasks.vqa import train_vqa
    from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer

    tok = WordPieceTokenizer()
    write_synthetic_vqa(str(tmp_path / "data"), images=8, answers=5,
                        image_size=64, splits={"train": 16, "validate": 8,
                                               "test": 8})
    splits = []
    for split in ("train", "validate", "test"):
        ds = MedVQADataset(str(tmp_path / "data"), "SLAKE", split)
        ds.tokenize(tok)
        splits.append(ds)
    cfg = MVLTConfig.for_vqa(result_num=5)
    cfg = dataclasses.replace(cfg, swin=SwinConfig(
        img_size=64, patch_size=4, embed_dim=32, depths=(2, 2),
        num_heads=(2, 4), window_size=4, drop_path_rate=0.2),
        fusion=dataclasses.replace(cfg.fusion, hidden_size=64,
                                   num_hidden_layers=1, num_attention_heads=2,
                                   intermediate_size=128)).with_tokenizer(tok)
    tc = TrainConfig(batch_size=8, epochs=1, num_workers=0, log_every=1)
    losses, runners = {}, {}
    for plain in (False, True):
        workdir = tmp_path / ("plain" if plain else "kernels")
        runner = TaskRunner(VQAModel, cfg, tc, workdir=str(workdir),
                            name=f"vqa-cuda-{plain}", device=cuda_device,
                            plain=plain)
        runner.init_state()
        before = kernels.gemm.launches
        best = train_vqa(runner, *splits)
        assert (kernels.gemm.launches > before) == (not plain)
        assert set(best) == {"valid_acc", "epoch", "test_final", "test"}
        losses[plain] = [json.loads(l)["loss"] for l in
                         (workdir / "metrics.jsonl").read_text().splitlines()]
        runners[plain] = runner
    assert len(losses[False]) == 2
    for a, b in zip(losses[False], losses[True]):
        assert abs(a - b) <= 1e-2 * abs(b), losses
    model = runners[False].model
    image = torch.from_numpy(np.stack([splits[2][i]["image"]
                                       for i in range(8)])).to(cuda_device)
    question = torch.from_numpy(np.stack([splits[2][i]["question"]
                                          for i in range(8)])).to(cuda_device)
    _, lk = model(image, question)
    _, lp = model(image, question, plain=True)
    err = (lk.float() - lp.float()).abs().max().item()
    assert err <= 0.05 * lp.float().abs().max().item()

"""The port's KV-cached decoding (``mvlt_tpu_torch/models/generation.py``,
``FusionEncoder.forward_kv`` / ``decode_step``, ``decode_step_mask``)
against the JAX package, on the same weights (through ``params_from_flax``)
and the same image features, in float32.

The model is a tiny ``CaptionModel``: the tiny Swin of
``test_torch_swin_train.py`` and a 2-layer fusion encoder of its width over
a 300-word vocabulary. Random weights give nearly flat logits, so eos would
never fire; as in ``tests/test_decode_parity_fuzz.py`` the race is
engineered: the eos column of the MLM decoder is amplified and its bias
shifted, and the Swin's final LayerNorm gain is raised so that each image's
features reach the encoder (the per-image scales then differ). The cases
assert that early finishers and rows that reach the length cap both occur.
JAX decodes in its ``lax.while_loop`` under ``jax.jit``, the port in its
host loop. Ids and sequences must be equal, scores within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu import config as jcfg
from mvlt_tpu.models import generation as jgen
from mvlt_tpu.models.fusion import init_cache as jax_init_cache
from mvlt_tpu.models.heads import CaptionModel as JaxCaption
from mvlt_tpu.ops import masks as jmasks
from mvlt_tpu_torch import config as pcfg
from mvlt_tpu_torch import flagship
from mvlt_tpu_torch.models import generation as pgen
from mvlt_tpu_torch.models.fusion import init_cache
from mvlt_tpu_torch.models.heads import CaptionModel
from mvlt_tpu_torch.ops import blocks, kernels
from mvlt_tpu_torch.ops import masks as pmasks
from mvlt_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(2)

B, IMG, MAX_LEN = 4, 32, 16
IMAGE_SCALES = np.array([1.0, 4.0, 10.0, 25.0], np.float32)
NORM_GAIN, EOS_W_SCALE, EOS_BIAS_SHIFT = 30.0, 3.0, 1.0


def _jax_config(max_length=MAX_LEN):
    cfg = jcfg.MVLTConfig.for_caption(max_length=max_length, mlm_gather_k=4)
    return dataclasses.replace(
        cfg, conv="swin",
        swin=dataclasses.replace(jcfg.swin_tiny_test(), depths=(2, 2),
                                 drop_path_rate=0.3),
        fusion=dataclasses.replace(
            cfg.fusion, hidden_size=16, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=32, vocab_size=300))


def _port_config(cfg):
    d = dataclasses.asdict(cfg)
    return pcfg.MVLTConfig(
        fusion=pcfg.FusionConfig(**d.pop("fusion")),
        swin=pcfg.SwinConfig(**d.pop("swin")),
        resnet=pcfg.ResNetConfig(**d.pop("resnet")),
        vit=pcfg.ViTConfig(**d.pop("vit")), **d)


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, JAX model, engineered variables, image, JAX features,
    port model, port features as a tensor)."""
    cfg = _jax_config()
    rng = np.random.default_rng(0)
    image = (rng.normal(size=(B, 3, IMG, IMG))
             * IMAGE_SCALES[:, None, None, None]).astype(np.float32)
    jmodel = JaxCaption(cfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     jnp.asarray(image),
                                     jnp.ones((B, 5), jnp.int32))
    pert = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + pert.normal(
        0.0, 0.05, np.shape(a)).astype(np.float32), variables["params"])
    params["conv"]["backbone"]["norm"]["scale"] *= NORM_GAIN
    dec = params["mlm_head_seq2seq"]["decoder"]
    dec["kernel"][:, cfg.eos_token_id] *= EOS_W_SCALE
    dec["bias"][cfg.eos_token_id] += EOS_BIAS_SHIFT
    variables = {"params": params}
    feat = jax.jit(lambda v, im: jmodel.apply(
        v, im, method=lambda m, x: m.encode_image(x)))(variables,
                                                       jnp.asarray(image))
    model = CaptionModel(_port_config(cfg), device="cpu")
    model.load_state_dict(params_from_flax(variables))          # strict
    return (cfg, jmodel, variables, image, feat, model,
            torch.from_numpy(np.array(feat)))


def _specs(cfg, **kw):
    """(JAX spec, port spec) of the same fields."""
    jspec = jgen.GenerationSpec.from_config(cfg, **kw)
    return jspec, pgen.GenerationSpec(**dataclasses.asdict(jspec))


def _mix(lengths, cap):
    """Early finishers and rows at the cap both occur."""
    lengths = list(lengths)
    assert any(n < cap for n in lengths) and any(n == cap for n in lengths), \
        lengths


def _finished_at(ids, eos):
    """Per row: 1 + the position of the first eos, or the row's length."""
    return [row.index(eos) + 1 if eos in row else len(row)
            for row in np.asarray(ids).tolist()]


@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("write_pos", [0, 5, 9])
def test_decode_step_mask_matches_jax(T, write_pos):
    want = np.asarray(jmasks.decode_step_mask(3, T, 12, jnp.int32(write_pos)))
    got = pmasks.decode_step_mask(3, T, 12, write_pos)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pmasks.mask_to_bias(got).numpy(),
        np.asarray(jmasks.mask_to_bias(jnp.asarray(want)))[:, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax_reference(dtype):
    """The port's ``multi_head_attention`` (SDPA) computes JAX's
    ``reference_attention`` (``attention.py:35-55``: f32 scores with the
    scale on q, the additive bias, probabilities in v's dtype, PV
    accumulated in f32) at a decode step's shapes (2 queries over a 13-slot
    cache with the decode mask) and a prefill's (the seq2seq mask): within
    1e-6 of JAX in float32; in bf16 within one rounding step of v's
    dtype."""
    from mvlt_tpu.ops.attention import reference_attention as jax_attention
    from mvlt_tpu_torch.ops.attention import multi_head_attention
    rng = np.random.default_rng(5)
    tdt = getattr(torch, dtype)
    for T, S, mask in ((2, 13, pmasks.decode_step_mask(1, 2, 13, 6)),
                       (9, 9, pmasks.seq2seq_fusion_mask(1, 3, 9))):
        q, k, v = (rng.normal(size=(3, 2, n, 8)).astype(np.float32)
                   for n in (T, S, S))
        bias = pmasks.mask_to_bias(mask)[:, None]
        tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
        want = np.asarray(jax_attention(
            *(jnp.asarray(t.float().numpy(), dtype) for t in (tq, tk, tv)),
            jnp.asarray(bias.numpy())), np.float32)
        got = multi_head_attention(tq, tk, tv, bias).float().numpy()
        tol = 1e-6 if dtype == "float32" else 2 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_init_cache_matches_jax():
    cfg = _jax_config()
    want = jax_init_cache(cfg.fusion, 3, 11, jnp.float32)
    got = init_cache(_port_config(cfg).fusion, 3, 11, torch.float32, "cpu")
    for name in ("k", "v"):
        assert tuple(got[name].shape) == want[name].shape == (2, 3, 2, 11, 8)
        assert not got[name].any()


def _jax_prefill_and_cache(jmodel, variables, feat, jspec):
    logits, kv, P = jgen._prefill(jmodel, variables, feat, jspec)
    cache = jgen._make_cache(jmodel, variables, kv, P, B, jspec)
    return logits, kv, cache


@pytest.mark.parametrize("strategy", ["unilm", "normal"])
@torch.no_grad()
def test_prefill_and_decode_step_match_jax(tiny, strategy):
    """The prefill's per-layer (k, v) over the whole prefix and its first
    logits, then one decode step at write_pos P from the same cache: its
    hidden states and the cache rows it wrote, within 1e-4."""
    cfg, jmodel, variables, _, feat, model, pfeat = tiny
    jspec, spec = _specs(cfg, strategy=strategy)
    jlogits, jkv, jcache = jax.jit(lambda v, f: _jax_prefill_and_cache(
        jmodel, v, f, jspec))(variables, feat)
    P = feat.shape[1] + 2
    logits, kv, P2 = pgen._prefill(model, pfeat, spec, blocks.PLAIN_OPS)
    assert P2 == P == 16 + 2
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    S = P + (strategy == "unilm")
    for (k, v), (jk, jv) in zip(kv, jkv):
        assert tuple(k.shape) == jk.shape == (B, 2, S, 8)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-4)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4)

    cache = pgen._make_cache(model, kv, P, B, spec)
    tokens = np.array([[7, 103], [50, 103], [104, 103], [299, 103]])
    if strategy == "normal":
        tokens = tokens[:, :1]
    jhidden, jcache = jax.jit(lambda v, t, c: jmodel.apply(
        v, t, c, jnp.int32(P),
        method=lambda m, t, c, p: m.fusion.decode_step(t, c, p)))(
            variables, jnp.asarray(tokens, jnp.int32), jcache)
    hidden = model.fusion.decode_step(torch.from_numpy(tokens), cache, P,
                                      blocks.PLAIN_OPS)
    np.testing.assert_allclose(hidden.detach().numpy(), np.asarray(jhidden),
                               atol=1e-4, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=1e-4)


@pytest.mark.parametrize("strategy", ["unilm", "normal"])
def test_greedy_matches_jax(tiny, strategy):
    cfg, jmodel, variables, _, feat, model, pfeat = tiny
    jspec, spec = _specs(cfg, strategy=strategy)
    jids, jscores = jax.jit(lambda v, f: jgen.greedy_search(
        jmodel, v, f, jspec))(variables, feat)
    ids, scores = pgen.greedy_search(model, pfeat, spec)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=1e-4, rtol=0)
    _mix(_finished_at(jids[:, :-1], cfg.eos_token_id), MAX_LEN - 1)


def test_sampling_matches_jax_with_replayed_draws(tiny):
    """Sampling under JAX's key sequence: its Gumbel draws (one split of
    the key a step, ``generation.py:162,174``) replayed to the port."""
    cfg, jmodel, variables, _, feat, model, pfeat = tiny
    jspec, spec = _specs(cfg, sample=True)
    key = jax.random.PRNGKey(7)
    jids, jscores = jax.jit(lambda v, f, k: jgen.greedy_search(
        jmodel, v, f, jspec, k))(variables, feat, key)
    draws, rng = [], key
    for _ in range(MAX_LEN):
        rng, sub = jax.random.split(rng)
        draws.append(np.array(jax.random.gumbel(sub, (B, 300),
                                                  jnp.float32)))
    ids, scores = pgen.greedy_search(model, pfeat, spec,
                                     pgen.GumbelNoise.replay(draws))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=1e-4, rtol=0)
    assert len(set(map(tuple, ids.tolist()))) == B     # the draws mattered


@pytest.mark.parametrize("max_length", [8, 16])
@pytest.mark.parametrize("num_beams", [1, 3, 5])
def test_beam_matches_jax(tiny, num_beams, max_length):
    cfg, jmodel, variables, _, feat, model, pfeat = tiny
    cfg = dataclasses.replace(cfg, max_length=max_length)
    jspec, spec = _specs(cfg, num_beams=num_beams)
    jseqs, jlens, jscores = jax.jit(lambda v, f: jgen.beam_search(
        jmodel, v, f, jspec))(variables, feat)
    seqs, lens, scores = pgen.beam_search(model, pfeat, spec)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(jseqs))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=1e-4, rtol=0)
    _mix(lens.tolist(), max_length)


def test_generate_encodes_once_with_the_port_swin(tiny):
    """``generate`` from pixels: the port's Swin features match JAX's
    within 1e-4, and the decode from them is ``beam_search`` on them."""
    cfg, *_, image, feat, model, _ = tiny
    spec = pgen.GenerationSpec.from_config(_port_config(cfg), num_beams=3)
    pfeat = model.encode_image(torch.from_numpy(image))
    np.testing.assert_allclose(pfeat.numpy(), np.asarray(feat), atol=1e-4,
                               rtol=0)
    got = pgen.generate(model, torch.from_numpy(image), spec)
    for a, b in zip(got, pgen.beam_search(model, pfeat, spec)):
        assert torch.equal(a, b)


def _uncached_greedy(model, feat, spec):
    """The reference greedy loop without a cache (``test_generation.py:
    45-79``): each step runs the full seq2seq forward over the committed
    tokens (+ the [MASK] probe for 'unilm') and reads its last position."""
    ops = blocks.PLAIN_OPS
    ids = torch.full((B, spec.max_length), spec.pad_token_id,
                     dtype=torch.long)
    unfinished = torch.ones(B, dtype=torch.long)
    mask = torch.ones(feat.shape[:2], dtype=torch.bool)
    for t in range(spec.max_length):
        text = ids[:, :t]
        if spec.strategy == "unilm":
            text = torch.cat([text, torch.full((B, 1), spec.mask_token_id)],
                             dim=1)
        elif t == 0:
            text = None
        hidden, _ = model.fusion(text, None, feat, mask, ops, seq2seq=True,
                                 pool=False)
        tok = model.mlm_head_seq2seq(hidden[:, -1], ops).argmax(-1)
        tok = tok * unfinished + spec.pad_token_id * (1 - unfinished)
        ids[:, t] = tok
        unfinished = unfinished * (tok != spec.eos_token_id)
        if not unfinished.any():
            break
    return ids


@pytest.mark.parametrize("strategy", ["unilm", "normal"])
def test_cached_greedy_matches_uncached_oracle(tiny, strategy):
    cfg, *_, model, pfeat = tiny
    spec = pgen.GenerationSpec.from_config(_port_config(cfg),
                                           strategy=strategy)
    with torch.no_grad():
        oracle = _uncached_greedy(model, pfeat, spec)
    ids, _ = pgen.greedy_search(model, pfeat, spec)
    np.testing.assert_array_equal(ids.numpy(), oracle.numpy())


@pytest.mark.parametrize("num_beams", [1, 3])
def test_unrolled_decode_matches_loop(tiny, num_beams):
    """``unroll=True`` runs every step without reading the done flags and
    gives the loop's results exactly (greedy, and beams that finish early
    and at the cap)."""
    cfg, *_, model, pfeat = tiny
    spec = pgen.GenerationSpec.from_config(_port_config(cfg),
                                           num_beams=num_beams)
    search = pgen.beam_search if num_beams > 1 else pgen.greedy_search
    looped = search(model, pfeat, spec)
    unrolled = search(model, pfeat, dataclasses.replace(spec, unroll=True))
    for a, b in zip(looped, unrolled):
        assert torch.equal(a, b)


def test_suffix_reorder_matches_full_gather(tiny):
    cfg, *_, model, pfeat = tiny
    spec = pgen.GenerationSpec.from_config(_port_config(cfg), num_beams=3)
    full = pgen.beam_search(model, pfeat, spec)
    suffix = pgen.beam_search(model, pfeat,
                              dataclasses.replace(spec, suffix_reorder=True))
    for a, b in zip(full, suffix):
        assert torch.equal(a, b)


def test_build_caption_generate_on_cpu_counts_nothing():
    """``build_caption_generate`` at the tiny size on the CPU (plain
    versions): the output shapes of beam and greedy, two sampling calls
    on the default (seeded) noise agree, and no CUDA launch is counted."""
    before = [f.launches for f in kernels.KERNELS] + [
        getattr(f, c) for f in blocks.COUNTERPARTS for c in blocks.COUNTS]
    gen, image = flagship.build_caption_generate(
        batch=2, num_beams=3, max_length=6, dtype=torch.float32,
        device="cpu", config=_port_config(_jax_config()), image_size=IMG)
    seqs, lens, scores = gen(image)
    assert seqs.shape == (2, 6) and lens.shape == scores.shape == (2,)
    ids, sc = gen(image, num_beams=1, sample=True)
    assert ids.shape == sc.shape == (2, 6)
    assert torch.equal(ids, gen(image, num_beams=1, sample=True)[0])
    after = [f.launches for f in kernels.KERNELS] + [
        getattr(f, c) for f in blocks.COUNTERPARTS for c in blocks.COUNTS]
    assert before == after


def test_build_caption_generate_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship.build_caption_generate(batch=1, device="cuda")


def test_generate_routing_on_meta_device(monkeypatch):
    """Report generation at the flagship config (Swin-S + BERT-base, b32,
    beam 5, unilm, bf16) walked on the meta device with ``unroll=True``
    (no value is read): the Swin serving rows run once per batch, not K
    times (row 2 11 times, row 3 11, row 1 2, row 6 2); the prefill runs 12
    ``fused_mlp_ln`` (row 5) and no fused attention half (rows 4 and 15:
    its attention halves are plain, as JAX's ``need_kv`` gate sends them);
    the decode steps run no counterpart. Every product but the MLM
    decoder's goes through ``ops.gemm``; the decoder (N = 30,522) never
    does."""
    counts, products = {}, []

    def counted(name, fn):
        def call(x, *args, **kw):
            key = name + ("_shift" if kw.get("shift_spec") is not None
                          else "")
            counts[key] = counts.get(key, 0) + 1
            return fn(x, *args, **kw)
        return call

    for fn in blocks.COUNTERPARTS:
        name = fn.__name__
        monkeypatch.setattr(blocks.PLAIN_OPS, name,
                            counted(name, getattr(blocks.PLAIN_OPS, name)))
    gemm = blocks.PLAIN_OPS.gemm

    def gemm_seen(a, w, *args, **kw):
        products.append((a.shape[0], w.shape[0]))
        return gemm(a, w, *args, **kw)

    monkeypatch.setattr(blocks.PLAIN_OPS, "gemm", gemm_seen)
    cfg = flagship.flagship_caption_config()
    model = CaptionModel(cfg, dtype=torch.bfloat16, device="meta")
    spec = pgen.GenerationSpec.from_config(cfg, num_beams=5, unroll=True)
    spec = dataclasses.replace(spec, max_length=3)
    seqs, lens, scores = pgen.generate(
        model, torch.empty(32, 3, 224, 224, device="meta"), spec, plain=True)
    assert seqs.shape == (32, 3) and lens.shape == scores.shape == (32,)
    assert counts == {"swin_full_block": 11, "swin_full_block_shift": 11,
                      "window_block_attention": 2, "fused_mlp_preln": 2,
                      "fused_mlp_ln": 12}
    assert cfg.fusion.vocab_size == 30522
    assert all(n != 30522 for _, n in products)
    # the prefill's 12 qkv products over 32 x 52 rows, once per sample; a
    # decode step's 12 layers x (qkv, out, fc1, fc2) over 32 x 5 beams x 2
    # tokens (M = 320), and the head's transform over the 160 [MASK] rows
    assert products.count((32 * 52, 3 * 768)) == 12
    steps = spec.max_length - 1
    for n in (3 * 768, 768, 3072):
        assert products.count((320, n)) == 12 * steps * (1 + (n == 768))
    assert products.count((160, 768)) == steps


@pytest.mark.parametrize("name,family", [
    ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_"
     "64x128x64_4x1x1_cga1x1x1_kernel0_0", "SDPA"),
    ("fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::"
     "AttentionKernel<cutlass::bfloat16_t, cutlass::arch::Sm80>)", "SDPA"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_"
     "detail::cub::DeviceRadixSortPolicy<float, at::", "torch.sort"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8, at::"
     "native::_cuda_scatter_gather_internal_kernel<f", "gathers"),
    ("void at::native::index_elementwise_kernel<128, 4, at::native::gpu_"
     "index_kernel<at::native::index_kernel_impl<a", "gathers"),
    ("cudnn_infer_sm90_fprop_implicit_gemm", "cuDNN convolutions")])
def test_profile_families_of_the_decode_kernels(name, family):
    """``profile_step`` files the decode path's library kernels under their
    own families: SDPA's (cuDNN's or cutlass's) before the convolutions and
    cuBLAS, the beam ranking's sort, the cache reorder's gathers."""
    from mvlt_tpu_torch import profile_step
    assert profile_step.family(name).startswith(family)

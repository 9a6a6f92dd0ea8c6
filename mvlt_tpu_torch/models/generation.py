"""KV-cached autoregressive decoding, greedy / sampling / beam (counterpart of
``mvlt_tpu/models/generation.py``), driving a :class:`CaptionModel`'s
``fusion`` and ``mlm_head_seq2seq``.

UniLM [MASK]-probe decoding: each step feeds ``[prev_token, MASK]`` and the
[MASK]'s hidden state gives the next token's logits; the cache is a static
buffer (C = prefix + max_length + 1 slots) whose write position never
commits the [MASK] slot. The 'normal' strategy feeds one token a step, and
its prefill has no text: [SEP]'s hidden state gives the first token.

The decode loop runs on the host. With ``unroll=False`` it reads the done
flags once a step and stops when every row is done, as JAX's
``lax.while_loop`` does; with ``unroll=True`` it runs all ``max_length``
steps and never synchronises (finished rows are masked exactly as in the
loop, so both give the same results). Sequences come back padded to
``max_length``.

Ties: JAX's ``jnp.argmax`` and ``lax.top_k`` take the lower index, which
``torch.argmax`` documents too; the beam candidates are ranked with a stable
descending sort, since ``torch.topk`` promises no order among equal values.

Sampling draws ``argmax(logits + gumbel)``, which is what
``jax.random.categorical`` computes, from an explicit :class:`GumbelNoise`
source (by default a ``torch.Generator`` on the model's device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mvlt_tpu_torch.models import beam as beam_lib
from mvlt_tpu_torch.models.fusion import init_cache
from mvlt_tpu_torch.ops.blocks import KERNEL_OPS, PLAIN_OPS


@dataclasses.dataclass(frozen=True)
class GenerationSpec:
    max_length: int
    eos_token_id: int
    pad_token_id: int
    mask_token_id: int
    sep_token_id: int
    num_beams: int = 1
    length_penalty: float = 1.0
    early_stopping: bool = False
    strategy: str = "unilm"       # 'unilm' | 'normal'
    sample: bool = False
    # run every step without reading the done flags on the host (identical
    # results, no early exit, no synchronisation a step)
    unroll: bool = False
    # the beam reorder gathers only the cache suffix written by the decode
    # (the prefix rows are equal across a sample's beams): exact, moves
    # fewer bytes, one more copy a step (slower on an H100 at length 150:
    # scripts/cache_reorder_probe.py)
    suffix_reorder: bool = False

    @staticmethod
    def from_config(cfg, num_beams: int = 1, **kw) -> "GenerationSpec":
        return GenerationSpec(
            max_length=cfg.max_length, eos_token_id=cfg.eos_token_id,
            pad_token_id=cfg.pad_token_id, mask_token_id=cfg.mask_token_id,
            sep_token_id=cfg.sep_token_id, num_beams=num_beams, **kw)


class GumbelNoise:
    """Where sampling's noise comes from: ``draw(shape, device)`` returns
    float32 standard Gumbel noise, ``-log(-log(u))`` with u uniform in
    [tiny, 1) (``jax.random.gumbel``), one draw per decode step.
    ``GumbelNoise(generator)`` draws on the generator's device;
    ``GumbelNoise.replay(draws)`` hands out the given arrays in order
    instead, checking each shape (a test replays JAX's draws)."""

    def __init__(self, generator: torch.Generator = None):
        self.generator = generator
        self._replay = None

    @classmethod
    def replay(cls, draws) -> "GumbelNoise":
        src = cls()
        src._replay = iter(list(draws))
        return src

    def draw(self, shape, device) -> torch.Tensor:
        shape = tuple(shape)
        if self._replay is not None:
            t = next(self._replay, None)
            if t is None:
                raise RuntimeError("no recorded Gumbel draw left to replay")
            t = torch.as_tensor(t, dtype=torch.float32).to(device)
            if tuple(t.shape) != shape:
                raise ValueError(f"replayed draw {tuple(t.shape)} where "
                                 f"{shape} was drawn")
            return t
        u = torch.rand(shape, generator=self.generator,
                       device=self.generator.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return (-torch.log(-torch.log(u))).to(device)


# ---------------------------------------------------------------------------
# model plumbing: prefill and one decode step through the CaptionModel
# ---------------------------------------------------------------------------

def _prefill(model, image_feature: torch.Tensor, spec: GenerationSpec, ops):
    """The image prefix (+ the initial [MASK] probe for 'unilm') through the
    fusion encoder. Returns (first logits (B, V), per-layer (k, v), prefix
    length P = CLS + image + SEP)."""
    B = image_feature.shape[0]
    text = None
    if spec.strategy == "unilm":
        text = torch.full((B, 1), spec.mask_token_id, dtype=torch.long,
                          device=image_feature.device)
    hidden, kv = model.fusion.forward_kv(text, image_feature, ops)
    logits = model.mlm_head_seq2seq(hidden[:, -1], ops)
    return logits, kv, image_feature.shape[1] + 2


def _make_cache(model, kv, prefix_len: int, batch: int, spec: GenerationSpec,
                dtype: Optional[torch.dtype] = None) -> dict:
    """The static cache of ``batch`` rows in the model's compute dtype, with
    the prefix's (k, v) written at positions [0, P)."""
    ref = kv[0][0]
    cache = init_cache(model.config.fusion, batch,
                       prefix_len + spec.max_length + 1,
                       dtype or model.fusion.compute_dtype, ref.device,
                       heads=ref.shape[1])
    for i, (k, v) in enumerate(kv):
        cache["k"][i, :, :, :prefix_len] = k[:, :, :prefix_len]
        cache["v"][i, :, :, :prefix_len] = v[:, :, :prefix_len]
    return cache


def _decode_logits(model, cache: dict, prev_tok: torch.Tensor,
                   write_pos: int, spec: GenerationSpec, ops) -> torch.Tensor:
    """One incremental step; writes the step's (k, v) into ``cache``.
    Returns the logits (B, V)."""
    tokens = prev_tok[:, None]
    if spec.strategy == "unilm":
        tokens = torch.stack([prev_tok, torch.full_like(
            prev_tok, spec.mask_token_id)], dim=1)
    hidden = model.fusion.decode_step(tokens, cache, write_pos, ops)
    return model.mlm_head_seq2seq(hidden[:, -1], ops)


def _ops(plain: bool):
    return PLAIN_OPS if plain else KERNEL_OPS


# ---------------------------------------------------------------------------
# greedy / multinomial search
# ---------------------------------------------------------------------------

@torch.no_grad()
def greedy_search(model, image_feature: torch.Tensor, spec: GenerationSpec,
                  noise: Optional[GumbelNoise] = None, plain: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (ids (B, max_length) int64, pad after eos; scores (B,
    max_length) f32). Greedy scores are the raw max logits, sampling scores
    the chosen token's log-probability, as in the reference; finished rows
    emit pad and score 0. ``noise`` (sampling): default a
    :class:`GumbelNoise` on a generator of the features' device seeded with
    0."""
    ops = _ops(plain)
    B, L = image_feature.shape[0], spec.max_length
    dev = image_feature.device
    if spec.sample and noise is None:
        noise = GumbelNoise(torch.Generator(device=dev).manual_seed(0))
    logits, kv, P = _prefill(model, image_feature, spec, ops)
    cache = _make_cache(model, kv, P, B, spec)
    del kv

    def pick(logits, unfinished):
        lf = logits.float()
        if spec.sample:
            tok = torch.argmax(lf + noise.draw(lf.shape, dev), dim=-1)
            score = torch.log_softmax(lf, dim=-1).gather(1, tok[:, None])[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
            score = lf.max(dim=-1).values
        tok = tok * unfinished + spec.pad_token_id * (1 - unfinished)
        return tok, score * unfinished

    ids = torch.full((B, L), spec.pad_token_id, dtype=torch.long, device=dev)
    scores = torch.zeros((B, L), dtype=torch.float32, device=dev)
    unfinished = torch.ones((B,), dtype=torch.long, device=dev)
    tok, score = pick(logits, unfinished)
    ids[:, 0], scores[:, 0] = tok, score
    unfinished = unfinished * (tok != spec.eos_token_id)
    for t in range(1, L):
        if not spec.unroll and not bool(unfinished.any()):
            break
        logits = _decode_logits(model, cache, tok, P + t - 1, spec, ops)
        tok, score = pick(logits, unfinished)
        ids[:, t], scores[:, t] = tok, score
        unfinished = unfinished * (tok != spec.eos_token_id)
    return ids, scores


# ---------------------------------------------------------------------------
# beam search (reference model.py:636-816, HF scorer semantics in beam.py)
# ---------------------------------------------------------------------------

@torch.no_grad()
def beam_search(model, image_feature: torch.Tensor, spec: GenerationSpec,
                plain: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (sequences (B, max_length), lengths (B,), scores (B,)).

    The prefix is encoded once per sample; its logits and (k, v) are then
    repeated K-fold (the reference runs the encoder on K copies of each
    image: the same values, K times the work)."""
    ops = _ops(plain)
    B, K, L = image_feature.shape[0], spec.num_beams, spec.max_length
    dev = image_feature.device
    logits, kv, P = _prefill(model, image_feature, spec, ops)
    logits = logits.repeat_interleave(K, dim=0)                 # (B*K, V)
    kv = [(k.repeat_interleave(K, dim=0), v.repeat_interleave(K, dim=0))
          for k, v in kv]
    cache = _make_cache(model, kv, P, B * K, spec)
    del kv
    V = logits.shape[-1]
    rows = torch.arange(B, device=dev)[:, None] * K

    def rank_candidates(logits, beam_scores):
        logp = torch.log_softmax(logits.float(), dim=-1)
        nts = (logp + beam_scores.reshape(-1)[:, None]).reshape(B, K * V)
        top, order = torch.sort(nts, dim=1, descending=True, stable=True)
        order = order[:, :2 * K]
        return top[:, :2 * K], order % V, order // V

    def scorer_step(hyps, seqs, t, logits, beam_scores, **kw):
        return beam_lib.process(
            hyps, seqs, t, *rank_candidates(logits, beam_scores),
            pad_token_id=spec.pad_token_id, eos_token_id=spec.eos_token_id,
            length_penalty=spec.length_penalty,
            early_stopping=spec.early_stopping, **kw)

    beam_scores = torch.full((B, K), -1e9, dtype=torch.float32, device=dev)
    beam_scores[:, 0] = 0.0
    hyps = beam_lib.init_hypotheses(B, K, L, dev)
    seqs = torch.zeros((B, K, L), dtype=torch.long, device=dev)

    # step 0, outside the loop: HF's [MASK] / [SEP] probe column, cur_len 2
    probe = torch.zeros((B, K, L), dtype=torch.long, device=dev)
    probe[:, :, 0] = (spec.mask_token_id if spec.strategy == "unilm"
                      else spec.sep_token_id)
    hyps, beam_scores, tokens, beam_idx = scorer_step(
        hyps, probe, 1, logits, beam_scores, cur_len=2)
    seqs[:, :, 0] = tokens
    cache = {n: c.index_select(1, (rows + beam_idx).reshape(-1))
             for n, c in cache.items()}
    prev = tokens.reshape(-1)

    t = 1
    while t < L and (spec.unroll or not bool(hyps.done.all())):
        logits = _decode_logits(model, cache, prev, P + t - 1, spec, ops)
        hyps, beam_scores, tokens, beam_idx = scorer_step(
            hyps, seqs, t, logits, beam_scores)
        seqs = seqs.gather(1, beam_idx[:, :, None].expand(B, K, L))
        seqs[:, :, t] = tokens
        flat = (rows + beam_idx).reshape(-1)
        # index_select gathers faster on the card than c[:, flat] does
        # (scripts/cache_reorder_probe.py)
        if spec.suffix_reorder:
            for c in cache.values():
                c[:, :, :, P:] = c[:, :, :, P:].index_select(1, flat)
        else:
            cache = {n: c.index_select(1, flat) for n, c in cache.items()}
        prev = tokens.reshape(-1)
        t += 1

    return beam_lib.finalize(
        hyps, seqs, t, beam_scores, max_length=L,
        pad_token_id=spec.pad_token_id, eos_token_id=spec.eos_token_id,
        length_penalty=spec.length_penalty)


@torch.no_grad()
def generate(model, image: torch.Tensor, spec: GenerationSpec,
             noise: Optional[GumbelNoise] = None, plain: bool = False):
    """Beam search when ``spec.num_beams > 1``, greedy / sampling otherwise
    (``generation.py:295-303``). ``image`` is raw pixels (B, C, H, W); the
    backbone runs once per sample. ``plain=True`` runs the kernels' plain
    versions."""
    feat = model.encode_image(image, plain)
    if spec.num_beams > 1:
        return beam_search(model, feat, spec, plain)
    return greedy_search(model, feat, spec, noise, plain)

"""Static-slot beam-search scorer with HF ``BeamSearchScorer`` semantics
(counterpart of ``mvlt_tpu/models/beam.py``), vectorised over the batch.

The reference drives HF's scorer with its defaults (length_penalty 1.0,
do_early_stopping False, one hypothesis kept). As in JAX:

- finished hypotheses live in fixed (B, K) slots; an add evicts the worst
  slot when the new length-penalised score beats it, an empty slot scoring
  -inf (HF ``BeamHypotheses.add``);
- ``process`` walks the 2K ranked candidates in order: an eos candidate
  counts only at rank < K and goes to the hypothesis slots, the first K
  non-eos candidates become the next beams (HF ``process``);
- a batch row is done when its K slots are full and its worst hypothesis
  beats the best score still possible, ``best / cur_len ** lp`` (with
  ``early_stopping``: as soon as the slots are full), where ``cur_len`` is
  HF's ``seq_len + 1``;
- ``finalize`` adds the open beams of rows not done, then emits each row's
  best hypothesis, padded, with eos appended where it fits.

Shapes and loops are static: the rank loop is a Python loop over 2K, each
iteration a handful of (B,)-wide tensor ops, so no value is read on the
host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class BeamHypothesesState:
    """Fixed-slot replacement for HF ``BeamHypotheses``, per batch row."""

    seqs: torch.Tensor    # (B, K, L) int64
    scores: torch.Tensor  # (B, K) f32, length-penalised; empty slots -inf
    lens: torch.Tensor    # (B, K) int64
    done: torch.Tensor    # (B,) bool


def init_hypotheses(batch: int, num_beams: int, max_len: int,
                    device=None) -> BeamHypothesesState:
    return BeamHypothesesState(
        seqs=torch.zeros((batch, num_beams, max_len), dtype=torch.long,
                         device=device),
        scores=torch.full((batch, num_beams), -torch.inf, device=device),
        lens=torch.zeros((batch, num_beams), dtype=torch.long, device=device),
        done=torch.zeros((batch,), dtype=torch.bool, device=device))


def _penalty(gen_len: int, length_penalty: float) -> float:
    """``gen_len ** length_penalty`` in float32, as JAX computes it."""
    return float(np.float32(gen_len) ** np.float32(length_penalty))


def _hyp_add(state: BeamHypothesesState, add_mask: torch.Tensor,
             seq: torch.Tensor, seq_len: int, sum_logprobs: torch.Tensor,
             gen_len: int, length_penalty: float) -> BeamHypothesesState:
    """Add one hypothesis per batch row where ``add_mask`` (B,) holds and its
    score ``sum_logprobs / gen_len ** length_penalty`` beats the row's worst
    slot, which it replaces (the first worst, as ``argmin`` picks it). seq
    (B, L); sum_logprobs (B,) f32."""
    score = sum_logprobs / _penalty(gen_len, length_penalty)
    worst, worst_idx = torch.min(state.scores, dim=1)
    put = (torch.arange(state.scores.shape[1], device=score.device)[None, :]
           == worst_idx[:, None]) & (add_mask & (score > worst))[:, None]
    return dataclasses.replace(
        state,
        seqs=torch.where(put[:, :, None], seq[:, None, :], state.seqs),
        scores=torch.where(put, score[:, None], state.scores),
        lens=torch.where(put, seq_len, state.lens))


def process(state: BeamHypothesesState, input_seqs: torch.Tensor,
            seq_len: int, next_scores: torch.Tensor,
            next_tokens: torch.Tensor, next_indices: torch.Tensor, *,
            pad_token_id: int, eos_token_id: int,
            length_penalty: float = 1.0, early_stopping: bool = False,
            cur_len: int = None) -> Tuple[BeamHypothesesState, torch.Tensor,
                                          torch.Tensor, torch.Tensor]:
    """One HF ``BeamSearchScorer.process`` step (``beam.py:79-141``).
    input_seqs (B, K, L) the current beams, ``seq_len`` their committed
    tokens; next_scores / next_tokens / next_indices (B, 2K) ranked
    candidates, best first, indices the beam within the row. Returns
    (state, beam_scores (B, K) f32, beam_tokens (B, K), beam_indices
    (B, K)); a row done before this step keeps 0 / pad / 0. ``cur_len``
    defaults to HF's ``seq_len + 1``."""
    B, two_k = next_scores.shape
    K = two_k // 2
    dev = next_scores.device
    if cur_len is None:
        cur_len = seq_len + 1
    beam_scores = torch.zeros((B, K), dtype=torch.float32, device=dev)
    beam_tokens = torch.full((B, K), pad_token_id, dtype=next_tokens.dtype,
                             device=dev)
    beam_indices = torch.zeros((B, K), dtype=next_indices.dtype, device=dev)
    fill_count = torch.zeros((B,), dtype=torch.long, device=dev)
    slots = torch.arange(K, device=dev)[None, :]
    was_done = state.done
    L = input_seqs.shape[2]
    for rank in range(two_k):
        tok, score = next_tokens[:, rank], next_scores[:, rank]
        idx = next_indices[:, rank]
        is_eos = tok == eos_token_id
        if rank < K:                 # eos candidates -> hypothesis slots
            cand = input_seqs.gather(1, idx[:, None, None].expand(B, 1, L))
            state = _hyp_add(state, is_eos & ~was_done, cand[:, 0], seq_len,
                             score, cur_len, length_penalty)
        # the first K non-eos candidates -> next beams
        fill = ~is_eos & (fill_count < K) & ~was_done
        put = (slots == fill_count[:, None]) & fill[:, None]
        beam_scores = torch.where(put, score[:, None], beam_scores)
        beam_tokens = torch.where(put, tok[:, None], beam_tokens)
        beam_indices = torch.where(put, idx[:, None], beam_indices)
        fill_count = fill_count + fill.long()

    filled = state.scores > -torch.inf
    count = filled.sum(dim=1)
    worst = torch.where(filled, state.scores, torch.inf).min(dim=1).values
    best_possible = (next_scores.max(dim=1).values
                     / _penalty(cur_len, length_penalty))
    now_done = count >= K
    if not early_stopping:
        now_done = now_done & (worst >= best_possible)
    state = dataclasses.replace(state, done=was_done | now_done)
    return state, beam_scores, beam_tokens, beam_indices


def finalize(state: BeamHypothesesState, input_seqs: torch.Tensor,
             seq_len: int, final_beam_scores: torch.Tensor, *,
             max_length: int, pad_token_id: int, eos_token_id: int,
             length_penalty: float = 1.0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """HF ``BeamSearchScorer.finalize`` with one hypothesis kept
    (``beam.py:144-171``): the open beams of rows not done are added
    (score = sum_logprobs / seq_len ** lp), then each row's best hypothesis
    is emitted, padded to ``max_length``, with eos appended where it ended
    before ``max_length``. Returns (sequences (B, max_length), lengths (B,),
    scores (B,))."""
    B, K, L = input_seqs.shape
    for k in range(K):
        state = _hyp_add(state, ~state.done, input_seqs[:, k], seq_len,
                         final_beam_scores[:, k], seq_len, length_penalty)
    best = torch.argmax(state.scores, dim=1)[:, None]          # (B, 1)
    best_seq = state.seqs.gather(1, best[:, :, None].expand(B, 1, L))[:, 0]
    best_len = state.lens.gather(1, best)
    best_score = state.scores.gather(1, best)[:, 0]
    pos = torch.arange(L, device=best_seq.device)[None, :]
    out = torch.where(pos < best_len, best_seq, pad_token_id)
    can_eos = best_len < max_length
    out = torch.where((pos == best_len) & can_eos, eos_token_id, out)
    out_len = torch.where(can_eos, best_len + 1, best_len)[:, 0]
    return out[:, :max_length], out_len, best_score

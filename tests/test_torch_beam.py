"""The port's beam scorer (``mvlt_tpu_torch/models/beam.py``) against the
JAX package's (``mvlt_tpu/models/beam.py``) on seeded candidate streams.

A stream drives both scorers as ``beam_search`` drives them: a step-0 probe
column with ``cur_len=2``, then steps whose beams are gathered by the
chosen indices and extended by the chosen tokens, then ``finalize``. The
candidates are ranked scores from a numpy seed with tokens drawn so that
eos never occurs, occurs now and then, or dominates. After every step the
hypothesis slots (sequences, lengths), the done flags and the chosen beams
(tokens, indices) must be equal, the scores within 1e-6; so must the
finalized sequences, lengths and scores. JAX's scorer runs jitted, as
``beam_search`` runs it inside its jitted loop (one compile per static
configuration, shared by the streams).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvlt_tpu.models import beam as jbeam
from mvlt_tpu_torch.models import beam as pbeam

B, V, L, STEPS = 4, 12, 9, 8
EOS, PAD = 5, 0
EOS_RATE = {"no_eos": 0.0, "eos": 0.15, "eos_heavy": 0.6}
_jprocess = jax.jit(jbeam.process, static_argnames=(
    "pad_token_id", "eos_token_id", "length_penalty", "early_stopping",
    "cur_len"))
_jfinalize = jax.jit(jbeam.finalize, static_argnames=(
    "max_length", "pad_token_id", "eos_token_id", "length_penalty"))


def _stream(K: int, kind: str, seed: int):
    """(scores, tokens, indices), each (STEPS, B, 2K): ranked candidate
    scores (sorted descending, cumulative log-probs), tokens with eos at
    the stream's rate, beam indices in [0, K)."""
    rng = np.random.default_rng(seed)
    base = -np.cumsum(rng.uniform(0.05, 1.0, size=(STEPS, B, 1)), axis=0)
    scores = base - np.cumsum(rng.uniform(0.0, 0.8, size=(STEPS, B, 2 * K)),
                              axis=2)
    tokens = rng.integers(6, V, size=(STEPS, B, 2 * K))
    tokens[rng.random(tokens.shape) < EOS_RATE[kind]] = EOS
    indices = rng.integers(0, K, size=(STEPS, B, 2 * K))
    return scores.astype(np.float32), tokens, indices


def _assert_state(js, ps, step):
    for name in ("seqs", "lens", "done"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ps, name).numpy(),
                                      err_msg=f"{name} at step {step}")
    np.testing.assert_allclose(ps.scores.numpy(), np.asarray(js.scores),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("lp,early", [(0.5, False), (1.0, False),
                                      (2.0, False), (1.0, True)])
@pytest.mark.parametrize("kind", sorted(EOS_RATE))
@pytest.mark.parametrize("K", [1, 3, 5])
def test_scorer_matches_jax(K, kind, lp, early):
    scores, tokens, indices = _stream(K, kind, seed=K * 100 + len(kind))
    kw = dict(pad_token_id=PAD, eos_token_id=EOS, length_penalty=lp,
              early_stopping=early)
    js = jbeam.init_hypotheses(B, K, L)
    ps = pbeam.init_hypotheses(B, K, L)
    jseqs = jnp.zeros((B, K, L), jnp.int32)
    pseqs = torch.zeros((B, K, L), dtype=torch.long)
    probe = np.zeros((B, K, L), np.int64)
    probe[:, :, 0] = 7
    for t in range(STEPS):
        args = (scores[t], tokens[t], indices[t])
        jin = jnp.asarray(probe, jnp.int32) if t == 0 else jseqs
        pin = torch.from_numpy(probe) if t == 0 else pseqs
        extra = dict(cur_len=2) if t == 0 else {}
        js, jsc, jtok, jidx = _jprocess(
            js, jin, max(t, 1), *(jnp.asarray(a) for a in args), **kw,
            **extra)
        ps, psc, ptok, pidx = pbeam.process(
            ps, pin, max(t, 1), *(torch.from_numpy(a) for a in args), **kw,
            **extra)
        _assert_state(js, ps, t)
        np.testing.assert_array_equal(np.asarray(jtok), ptok.numpy())
        np.testing.assert_array_equal(np.asarray(jidx), pidx.numpy())
        np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), atol=1e-6)
        # the next beams: gather by index, write the chosen tokens
        if t == 0:
            jseqs = jseqs.at[:, :, 0].set(jtok)
            pseqs[:, :, 0] = ptok
        else:
            jseqs = jnp.take_along_axis(jseqs, jidx[:, :, None], axis=1)
            jseqs = jseqs.at[:, :, t].set(jtok)
            pseqs = pseqs.gather(1, pidx[:, :, None].expand(B, K, L))
            pseqs[:, :, t] = ptok
        jbs, pbs = jsc, psc
    fkw = dict(kw, max_length=L)
    del fkw["early_stopping"]
    jout = _jfinalize(js, jseqs, STEPS, jbs, **fkw)
    pout = pbeam.finalize(ps, pseqs, STEPS, pbs, **fkw)
    for name, j, p in zip(("sequences", "lengths"), jout[:2], pout[:2]):
        np.testing.assert_array_equal(np.asarray(j), p.numpy(), err_msg=name)
    np.testing.assert_allclose(pout[2].numpy(), np.asarray(jout[2]),
                               atol=1e-6)
    if kind == "eos_heavy" and K > 1:
        # the stream reaches the hypothesis slots and finishes rows
        assert bool(ps.done.any())
    if kind == "no_eos":
        assert not bool((ps.scores > -np.inf).any())


def test_add_evicts_the_worst_slot_and_empty_slots_score_minus_inf():
    """Two slots: the first two adds fill them, a better third evicts the
    worse, a worse fourth is dropped; rows where the mask is off are left
    as they are."""
    st = pbeam.init_hypotheses(2, 2, 3)
    assert torch.isinf(st.scores).all() and (st.scores < 0).all()
    on = torch.tensor([True, False])
    for s in (-4.0, -2.0, -1.0, -9.0):
        st = pbeam._hyp_add(st, on, torch.full((2, 3), int(-s)), 2,
                            torch.tensor([s, s]), 2, 1.0)
    assert st.scores[0].tolist() == [-0.5, -1.0]
    assert st.seqs[0, :, 0].tolist() == [1, 2]
    assert torch.isinf(st.scores[1]).all()

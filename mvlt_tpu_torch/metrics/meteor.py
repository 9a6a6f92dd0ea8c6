"""METEOR, Java-free (a copy of ``mvlt_tpu/metrics/meteor.py``; the
reference drives ``meteor-1.5.jar`` over stdio,
``pycocoevalcap/meteor/meteor.py:17-58`` — ``-l en -norm``).

Faithful to the Meteor 1.5 algorithm (Denkowski & Lavie 2014) within
what is implementable offline:

- **Matchers**: *exact* and *Porter-stem* modules with the English module
  weights (1.0 / 0.6).  The *synonym* (WordNet) module's data cannot be
  bundled offline, but the stage itself is data-only: point
  ``MVLT_METEOR_SYNONYMS`` at a file of whitespace-separated synonym
  groups (one group per line — e.g. flattened WordNet synsets) and it
  activates with Meteor's English synonym weight (0.8).  The
  *paraphrase* module (phrase table in the jar) stays out of reach
  offline — documented deviation; matched scores lower-bound the jar's.
- **Alignment**: Meteor's actual resolution, not a greedy scan — among
  all one-to-one match sets, pick the alignment that (1) maximizes
  covered words, (2) minimizes chunks, (3) minimizes total |i-j|
  distance, via beam search over hypothesis positions (exact at beam
  width >= candidates^2 for typical report lengths).
- **Scoring**: Meteor 1.5 English (default "rank" task) parameters
  alpha=0.85, beta=0.2, gamma=0.6, delta=0.75 with content/function word
  discrimination (function-word list approximates the jar's
  frequency-derived ``function.words``).  A single chunk covering every
  word in both strings has zero fragmentation (identical sentences score
  1.0, matching the jar).
- **Corpus score**: aggregate of segment statistics (micro-average),
  like MeteorStats accumulation in the jar.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from mvlt_tpu_torch.metrics.porter import porter_stem

ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
MODULE_WEIGHTS = (1.0, 0.6, 0.8)     # exact, stem, synonym (en defaults)
BEAM = 64

_SYN_TABLE: Dict[str, frozenset] | None = None
_SYN_PATH: str | None = None


def _synonym_table() -> Dict[str, frozenset] | None:
    """Loadable synonym stage: ``MVLT_METEOR_SYNONYMS`` names a file of
    whitespace-separated synonym groups, one group per line.  Two words
    synonym-match when they share a group — the same relation the jar
    derives from WordNet synsets (meteor-1.5 synonym module).  Reloaded
    when the env var changes; None disables the stage (default)."""
    global _SYN_TABLE, _SYN_PATH
    import os
    path = os.environ.get("MVLT_METEOR_SYNONYMS") or None
    if path != _SYN_PATH:
        _SYN_PATH = path
        _SYN_TABLE = None
        if path:
            table: Dict[str, set] = {}
            with open(path, encoding="utf-8") as f:
                for gid, line in enumerate(f):
                    for w in line.split():
                        table.setdefault(w.lower(), set()).add(gid)
            _SYN_TABLE = {w: frozenset(g) for w, g in table.items()}
    return _SYN_TABLE

# Approximation of meteor-1.5's English function.words (words with
# relative frequency >= 1e-3 in its corpus): articles, auxiliaries,
# prepositions, conjunctions, pronouns, common adverbs/particles.
FUNCTION_WORDS = frozenset("""
a an the and or but nor so yet for of in on at by to from with without
within into onto under over above below between among through during
before after since until about against along across behind beyond near
off out up down is are was were be been being am do does did done doing
have has had having will would shall should may might must can could
it its it's this that these those he him his she her hers they them
their theirs we us our ours you your yours i me my mine who whom whose
which what when where why how there here not no nor as if then than too
very just also only both each few more most other some such own same
all any because while with
""".split())


def _candidate_matches(hyp: Sequence[str], ref: Sequence[str]
                       ) -> Dict[Tuple[int, int], int]:
    """(i, j) -> best module index (0 exact, 1 stem, 2 synonym)."""
    out: Dict[Tuple[int, int], int] = {}
    syn = _synonym_table()
    ref_stems = [porter_stem(r) for r in ref]
    for i, h in enumerate(hyp):
        hs = None
        hsyn = syn.get(h.lower()) if syn is not None else None
        for j, r in enumerate(ref):
            if h == r:
                out[(i, j)] = 0
            else:
                if hs is None:
                    hs = porter_stem(h)
                if hs == ref_stems[j]:
                    out.setdefault((i, j), 1)
                elif hsyn is not None and not hsyn.isdisjoint(
                        syn.get(r.lower(), frozenset())):
                    out.setdefault((i, j), 2)
    return out


def _align(hyp: Sequence[str], ref: Sequence[str]
           ) -> List[Tuple[int, int, int]]:
    """Meteor alignment resolution: returns [(i, j, module)] maximizing
    (covered words, -chunks, -total distance) via beam search over
    hypothesis positions (each hyp word matches at most one free ref
    word or none)."""
    cand = _candidate_matches(hyp, ref)
    by_i: List[List[Tuple[int, int]]] = [[] for _ in hyp]
    for (i, j), mod in cand.items():
        by_i[i].append((j, mod))

    # state: (used_ref bitmask, last_pair (i,j) or None, pairs tuple,
    #         count, chunks, dist)
    states = [(0, None, (), 0, 0, 0)]
    for i in range(len(hyp)):
        nxt = []
        for used, last, pairs, cnt, ch, dist in states:
            nxt.append((used, last, pairs, cnt, ch, dist))  # skip word i
            for j, mod in by_i[i]:
                if used >> j & 1:
                    continue
                contiguous = (last is not None and last[0] == i - 1
                              and last[1] == j - 1)
                nxt.append((used | (1 << j), (i, j),
                            pairs + ((i, j, mod),), cnt + 1,
                            ch + (0 if contiguous else 1),
                            dist + abs(i - j)))
        nxt.sort(key=lambda s: (-s[3], s[4], s[5]))
        states = nxt[:BEAM]
    best = states[0]
    return list(best[2])


def _chunks(pairs: List[Tuple[int, int, int]]) -> int:
    if not pairs:
        return 0
    ch = 1
    for (i0, j0, _), (i1, j1, _) in zip(pairs, pairs[1:]):
        if i1 != i0 + 1 or j1 != j0 + 1:
            ch += 1
    return ch


def _word_weight(w: str) -> float:
    return 1.0 - DELTA if w in FUNCTION_WORDS else DELTA


class SegmentStats:
    """Weighted match statistics of one (hyp, best-ref) pair — the fields
    MeteorStats accumulates.  ``chunks`` follows the jar's convention:
    a single chunk that covers BOTH strings entirely counts as zero
    fragmentation (so identical sentences — and corpora of identical
    sentences under aggregation — score 1.0)."""

    __slots__ = ("p_num", "p_den", "r_num", "r_den", "matches", "chunks")

    def __init__(self, p_num=0.0, p_den=0.0, r_num=0.0, r_den=0.0,
                 matches=0, chunks=0):
        self.p_num, self.p_den = p_num, p_den
        self.r_num, self.r_den = r_num, r_den
        self.matches, self.chunks = matches, chunks

    def add(self, o: "SegmentStats") -> None:
        self.p_num += o.p_num
        self.p_den += o.p_den
        self.r_num += o.r_num
        self.r_den += o.r_den
        self.matches += o.matches
        self.chunks += o.chunks

    def score(self) -> float:
        if self.matches == 0 or self.p_den == 0 or self.r_den == 0:
            return 0.0
        p = self.p_num / self.p_den
        r = self.r_num / self.r_den
        if p == 0 or r == 0:
            return 0.0
        fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
        frag = 0.0 if self.chunks == 0 else self.chunks / self.matches
        return fmean * (1.0 - GAMMA * frag ** BETA)


def _segment(hyp: str, refs: List[str]) -> SegmentStats:
    h = hyp.split()
    best: SegmentStats = SegmentStats()
    best_s = -1.0
    for ref in refs:
        r = ref.split()
        pairs = _align(h, r)
        p_num = sum(MODULE_WEIGHTS[mod] * _word_weight(h[i])
                    for i, _, mod in pairs)
        r_num = sum(MODULE_WEIGHTS[mod] * _word_weight(r[j])
                    for _, j, mod in pairs)
        ch = _chunks(pairs)
        if ch == 1 and len(pairs) == len(h) == len(r):
            ch = 0       # perfect contiguous full cover: no fragmentation
        stats = SegmentStats(
            p_num=p_num, p_den=sum(_word_weight(w) for w in h),
            r_num=r_num, r_den=sum(_word_weight(w) for w in r),
            matches=len(pairs), chunks=ch)
        s = stats.score()
        if s > best_s:
            best, best_s = stats, s
    return best


def corpus_meteor(gts: Dict, res: Dict) -> Tuple[float, List[float]]:
    assert gts.keys() == res.keys()
    scores = []
    agg = SegmentStats()
    for i in gts.keys():
        st = _segment(res[i][0], gts[i])
        scores.append(st.score())
        agg.add(st)
    return agg.score(), scores

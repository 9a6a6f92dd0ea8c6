"""The port's caption metrics (``mvlt_tpu_torch/metrics``: PTB tokens,
Porter stems, BLEU 1-4, ROUGE-L, CIDEr, METEOR with and without a synonym
file, ``CaptionEvaluator`` and R2Gen's ``compute_scores``) against the JAX
package's, on seeded corpora of radiology-style reports: empty and
one-word hypotheses, repeated n-grams, punctuation, brackets,
contractions, abbreviations and several references a sample. The host
arithmetic is the same, so every score agrees within 1e-12 (the tokens and
stems are equal)."""

import numpy as np
import pytest

from mvlt_tpu.metrics import bleu as jbleu
from mvlt_tpu.metrics import cider as jcider
from mvlt_tpu.metrics import eval_cap as jeval
from mvlt_tpu.metrics import meteor as jmeteor
from mvlt_tpu.metrics import porter as jporter
from mvlt_tpu.metrics import ptb as jptb
from mvlt_tpu.metrics import rouge as jrouge
from mvlt_tpu_torch import metrics as pm
from mvlt_tpu_torch.metrics import meteor as pmeteor
from mvlt_tpu_torch.metrics import porter as pporter
from mvlt_tpu_torch.metrics import ptb as pptb

TOL = 1e-12
WORDS = ("the heart is normal in size , lungs are clear . no pleural "
         "effusion or pneumothorax ; mild cardiomegaly ( stable ) - left "
         "lower lobe opacity , degenerative changes dr. etc. e.g. u.s. "
         "isn't there's patient's 3.5 cm 10:30 \" quoted \" ... [ x ] "
         "{ y } effusions opacities changing calcified granulomas").split()


def _sentence(rng, lo=0, hi=25):
    n = int(rng.integers(lo, hi))
    words = [str(w) for w in rng.choice(WORDS, size=n)]
    if n > 3 and rng.random() < 0.4:           # a repeated n-gram
        k = int(rng.integers(0, n - 2))
        words += words[k:k + 3] * 2
    return " ".join(words)


def _corpus(seed, n=24, refs=1):
    """{id: [references]}, {id: [hypothesis]}: every fourth hypothesis
    empty or one word, some equal to their first reference."""
    rng = np.random.default_rng(seed)
    gts, res = {}, {}
    for i in range(n):
        gts[i] = [_sentence(rng, 1) for _ in range(refs)]
        r = rng.random()
        if i % 4 == 0:
            hyp = "" if r < 0.5 else str(rng.choice(WORDS))
        elif r < 0.2:
            hyp = gts[i][0]
        else:
            hyp = _sentence(rng, 1)
        res[i] = [hyp]
    return gts, res


def _tokenized(gts, res):
    return (jptb.ptb_tokenize_corpus({k: list(v) for k, v in gts.items()}),
            jptb.ptb_tokenize_corpus({k: list(v) for k, v in res.items()}))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", range(4))
def test_ptb_tokens_equal_jax(seed):
    gts, res = _corpus(seed, refs=2)
    lines = [s for v in gts.values() for s in v] + [v[0] for v in res.values()]
    lines += ["Dr. Smith's (left) lung: 3.5 cm... \"stable\"", "",
              "e.g. the u.s. -- a-b isn't", "{x} [y] ?!; 10:30, 1,000"]
    for line in lines:
        got = pptb.ptb_tokenize(line)
        assert got == jptb.ptb_tokenize_py(line) == jptb.ptb_tokenize(line)
    assert pptb.ptb_tokenize_corpus({0: [{"caption": lines[0]}], 1: ["a ."]}) \
        == jptb.ptb_tokenize_corpus({0: [{"caption": lines[0]}], 1: ["a ."]})


def test_porter_stems_equal_jax():
    from mvlt_tpu_torch.text.tokenizer import WordPieceTokenizer
    words = [w for w in WordPieceTokenizer().vocab if w.isalpha()][::7]
    words += ["caresses", "ponies", "agreed", "hopping", "conditional",
              "generalization", "electrical", "adjustment", "controll", "a"]
    assert len(words) > 3000
    assert [pporter.porter_stem(w) for w in words] == \
        [jporter.porter_stem(w) for w in words]


@pytest.mark.parametrize("seed,refs", [(0, 1), (1, 1), (2, 3), (3, 2)])
def test_corpus_metrics_equal_jax(seed, refs, monkeypatch):
    monkeypatch.delenv("MVLT_METEOR_SYNONYMS", raising=False)
    gts, res = _tokenized(*_corpus(seed, refs=refs))
    for option in (None, "average", "shortest"):
        (pb, ps), (jb, js) = (pm.corpus_bleu(gts, res, option=option),
                              jbleu.corpus_bleu(gts, res, option=option))
        _close(pb, jb)
        _close(ps, js)
    one = {0: gts[1]}, {0: res[1]}               # 'average' for one pair
    _close(pm.corpus_bleu(*one)[0], jbleu.corpus_bleu(*one)[0])
    for port, jax_fn in ((pm.corpus_rouge_l, jrouge.corpus_rouge_l),
                         (pm.corpus_cider, jcider.corpus_cider),
                         (pm.corpus_meteor, jmeteor.corpus_meteor)):
        (p, ps), (j, js) = port(gts, res), jax_fn(gts, res)
        _close(p, j)
        _close(ps, js)
    assert 0 < pm.corpus_cider(gts, res)[0]


def test_meteor_with_a_synonym_file_equals_jax(tmp_path, monkeypatch):
    """``MVLT_METEOR_SYNONYMS`` names a file of synonym groups: the
    synonym stage moves the score, and equally in both packages; unsetting
    it restores the exact / stem score."""
    gts, res = _tokenized(*_corpus(5, refs=2))
    syn = tmp_path / "syn.txt"
    syn.write_text("heart cardiac\nlungs lung pulmonary\neffusion fluid\n"
                   "opacity opacities consolidation\nmild slight\n")
    res = {k: [v[0].replace("heart", "cardiac").replace("mild", "slight")]
           for k, v in res.items()}
    monkeypatch.delenv("MVLT_METEOR_SYNONYMS", raising=False)
    plain = pmeteor.corpus_meteor(gts, res)
    monkeypatch.setenv("MVLT_METEOR_SYNONYMS", str(syn))
    got, want = pmeteor.corpus_meteor(gts, res), jmeteor.corpus_meteor(gts, res)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert got[0] > plain[0]
    monkeypatch.delenv("MVLT_METEOR_SYNONYMS")
    _close(pmeteor.corpus_meteor(gts, res)[0], plain[0])


@pytest.mark.parametrize("seed,refs", [(6, 1), (7, 2)])
@pytest.mark.parametrize("meteor", [True, False])
def test_caption_evaluator_and_r2gen_scores_equal_jax(seed, refs, meteor,
                                                      monkeypatch):
    monkeypatch.delenv("MVLT_METEOR_SYNONYMS", raising=False)
    gts, res = _corpus(seed, refs=refs)
    gt = [v[0] if refs == 1 else v for v in gts.values()]
    pred = [v[0] for v in res.values()]
    pe = pm.CaptionEvaluator(gt, pred, include_meteor=meteor)
    je = jeval.CaptionEvaluator(gt, pred, include_meteor=meteor)
    got, want = pe.evaluate(), je.evaluate()
    assert got.keys() == want.keys()
    _close([got[k] for k in want], [want[k] for k in want])
    assert pe.img_to_eval.keys() == je.img_to_eval.keys()
    for i in je.img_to_eval:
        assert pe.img_to_eval[i].keys() == je.img_to_eval[i].keys()
        _close([pe.img_to_eval[i][k] for k in je.img_to_eval[i]
                if k != "image_id"],
               [je.img_to_eval[i][k] for k in je.img_to_eval[i]
                if k != "image_id"])
    # R2Gen's scorer: '.' re-spaced in the first reference only
    got = pm.compute_scores(gts, res, include_meteor=meteor)
    want = jeval.compute_scores(gts, res, include_meteor=meteor)
    assert got.keys() == want.keys()
    _close([got[k] for k in want], [want[k] for k in want])

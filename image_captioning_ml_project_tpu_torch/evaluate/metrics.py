"""Caption evaluation metrics: BLEU-1..4, ROUGE-L, CIDEr-D, METEOR(-lite),
SPICE gate — with per-sample scores.

A copy of ``image_captioning_ml_project_tpu.evaluate.metrics`` (host code,
numpy only), held equal to it by the tests; the trainer's validation picks
its best checkpoint by the CIDEr computed here. As there,
:func:`calculate_metrics` prefers the pycocoevalcap scorers when they can
be imported and falls back to the self-contained ones:

* **BLEU** — corpus-level with clipped n-gram precision, closest-ref-length
  brevity penalty and pycocoevalcap's tiny-epsilon ratio smoothing.
* **ROUGE-L** — LCS F-measure with beta=1.2, max over refs, mean over images.
* **CIDEr-D** — tf-idf n-gram cosine (n=1..4) with count clipping, length
  gaussian (sigma=6), df from the evaluation corpus, x10 scaling.
* **METEOR-lite** — exact + Porter-stem match stages with METEOR's
  alignment and the paper's harmonic mean (alpha=0.9) + fragmentation
  penalty; no WordNet synonym/paraphrase modules. The stem stage needs
  nltk; where it is not installed the native scorers leave the
  ``METEOR`` key out (one warning) instead of reporting a score without
  the stem stage, the one place where this copy departs from the JAX
  module (which raises there).

Every scorer also returns **per-sample** scores.
"""

from __future__ import annotations

import importlib.util
import logging
import math
import os
import re
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:  # parity fast-path (reference: src/evaluate/metrics.py:7-17)
    from pycocoevalcap.tokenizer.ptbtokenizer import PTBTokenizer  # noqa: F401
    from pycocoevalcap.bleu.bleu import Bleu  # noqa: F401
    from pycocoevalcap.meteor.meteor import Meteor  # noqa: F401
    from pycocoevalcap.rouge.rouge import Rouge  # noqa: F401
    from pycocoevalcap.cider.cider import Cider  # noqa: F401

    PYCOCOEVALCAP_AVAILABLE = True
except Exception:  # pragma: no cover
    PYCOCOEVALCAP_AVAILABLE = False

_PUNCT_RE = re.compile(r"[^a-z0-9 ]+")


def metric_tokenize(text: str) -> List[str]:
    """PTB-like normalization: lowercase, strip punctuation, split."""
    return _PUNCT_RE.sub(" ", text.lower()).split()


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------


def bleu(generated: List[List[str]], references: List[List[List[str]]],
         max_n: int = 4) -> Tuple[List[float], np.ndarray]:
    """Corpus BLEU-1..max_n (cumulative, uniform weights) plus per-sample
    sentence scores. pycocoevalcap-compatible: clipped counts, closest ref
    length, tiny-epsilon smoothing on ratios."""
    tiny, small = 1e-15, 1e-9
    totals = np.zeros(max_n)
    correct = np.zeros(max_n)
    cand_len, ref_len = 0, 0
    per_sample = np.zeros((len(generated), max_n))

    for i, (cand, refs) in enumerate(zip(generated, references)):
        c = len(cand)
        # closest reference length (ties -> shorter)
        r = min((abs(len(r) - c), len(r)) for r in refs)[1] if refs else 0
        cand_len += c
        ref_len += r
        s_correct = np.zeros(max_n)
        s_total = np.zeros(max_n)
        for n in range(1, max_n + 1):
            cand_ngrams = _ngrams(cand, n)
            max_ref = Counter()
            for ref in refs:
                for ng, cnt in _ngrams(ref, n).items():
                    max_ref[ng] = max(max_ref[ng], cnt)
            clipped = sum(min(cnt, max_ref[ng]) for ng, cnt in cand_ngrams.items())
            total = max(0, c - n + 1)
            correct[n - 1] += clipped
            totals[n - 1] += total
            s_correct[n - 1] = clipped
            s_total[n - 1] = total
        # sentence-level score (with brevity penalty against closest ref)
        s_bp = 1.0 if c > r else math.exp(1 - r / c) if c > 0 else 0.0
        p = 1.0
        for n in range(max_n):
            p *= (s_correct[n] + tiny) / (s_total[n] + small)
            per_sample[i, n] = (p ** (1.0 / (n + 1))) * s_bp

    bp = 1.0 if cand_len > ref_len else (
        math.exp(1 - ref_len / cand_len) if cand_len > 0 else 0.0)
    scores = []
    p = 1.0
    for n in range(max_n):
        p *= (correct[n] + tiny) / (totals[n] + small)
        scores.append((p ** (1.0 / (n + 1))) * bp)
    return scores, per_sample


# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    dp = np.zeros((len(b) + 1,), dtype=np.int32)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return int(dp[-1])


def rouge_l(generated: List[List[str]], references: List[List[List[str]]],
            beta: float = 1.2) -> Tuple[float, np.ndarray]:
    """pycocoevalcap Rouge semantics: the per-image score combines the
    max *precision* and max *recall* taken independently across
    references (``prec_max``/``rec_max`` in rouge.py's calc_score) —
    NOT the max per-reference F-measure, which differs whenever the best
    precision and best recall come from different references."""
    per_sample = np.zeros(len(generated))
    for i, (cand, refs) in enumerate(zip(generated, references)):
        prec_max, rec_max = 0.0, 0.0
        for ref in refs:
            lcs = _lcs_len(cand, ref)
            prec_max = max(prec_max, lcs / len(cand) if cand else 0.0)
            rec_max = max(rec_max, lcs / len(ref) if ref else 0.0)
        if prec_max and rec_max:
            per_sample[i] = ((1 + beta ** 2) * prec_max * rec_max) \
                / (rec_max + beta ** 2 * prec_max)
    return float(per_sample.mean()) if len(generated) else 0.0, per_sample


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------


def cider_document_frequency(references: List[List[List[str]]],
                             max_n: int = 4) -> Dict[tuple, float]:
    """Document frequency of each n-gram over the reference corpus (one
    count per image that mentions it)."""
    df: Dict[tuple, float] = defaultdict(float)
    for refs in references:
        seen = set()
        for ref in refs:
            for n in range(1, max_n + 1):
                seen.update(_ngrams(ref, n).keys())
        for ng in seen:
            df[ng] += 1.0
    return dict(df)


def cider_d(generated: List[List[str]], references: List[List[List[str]]],
            df: Optional[Dict[tuple, float]] = None,
            log_num_images: Optional[float] = None,
            max_n: int = 4, sigma: float = 6.0) -> Tuple[float, np.ndarray]:
    """CIDEr-D with per-sample scores. ``df``/``log_num_images`` can be
    precomputed from a larger corpus (for SCST rewards against the train
    set); by default they come from ``references`` itself (standard eval)."""
    if df is None:
        df = cider_document_frequency(references, max_n)
    if log_num_images is None:
        log_num_images = math.log(max(len(references), 1))

    def counts_to_vec(tokens):
        vecs, norms = [], []
        for n in range(1, max_n + 1):
            vec = {}
            for ng, cnt in _ngrams(tokens, n).items():
                idf = log_num_images - math.log(max(df.get(ng, 0.0), 1.0))
                vec[ng] = cnt * idf
            vecs.append(vec)
            norms.append(math.sqrt(sum(v * v for v in vec.values())))
        return vecs, norms

    per_sample = np.zeros(len(generated))
    for i, (cand, refs) in enumerate(zip(generated, references)):
        c_vecs, c_norms = counts_to_vec(cand)
        score_n = np.zeros(max_n)
        for ref in refs:
            r_vecs, r_norms = counts_to_vec(ref)
            delta = len(cand) - len(ref)
            for n in range(max_n):
                val = 0.0
                for ng, w in c_vecs[n].items():
                    if ng in r_vecs[n]:
                        val += min(w, r_vecs[n][ng]) * r_vecs[n][ng]
                if c_norms[n] and r_norms[n]:
                    val /= c_norms[n] * r_norms[n]
                val *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                score_n[n] += val
        if refs:
            score_n /= len(refs)
        per_sample[i] = 10.0 * float(score_n.mean())
    return float(per_sample.mean()) if len(generated) else 0.0, per_sample


# ---------------------------------------------------------------------------
# METEOR-lite
# ---------------------------------------------------------------------------


_PORTER = None
_METEOR_AVAILABLE = None


def _stem(word: str) -> str:
    """Porter stem via nltk (pure Python, no data files needed)."""
    global _PORTER
    if _PORTER is None:
        from nltk.stem.porter import PorterStemmer

        _PORTER = PorterStemmer()
    return _PORTER.stem(word)


def meteor_available() -> bool:
    """Whether METEOR-lite's stem stage (nltk) can be imported; warns once
    where it cannot."""
    global _METEOR_AVAILABLE
    if _METEOR_AVAILABLE is None:
        _METEOR_AVAILABLE = importlib.util.find_spec("nltk") is not None
        if not _METEOR_AVAILABLE:
            logging.getLogger(__name__).warning(
                "nltk is not installed: the native scorers leave METEOR "
                "out")
    return _METEOR_AVAILABLE


def _meteor_align(cand: Sequence[str], ref: Sequence[str],
                  node_budget: int = 200_000
                  ) -> Tuple[int, int]:
    """METEOR word alignment: returns ``(num_matches, num_chunks)``.

    Match modules: exact + Porter stem (WordNet synonymy is offline-
    unavailable — documented delta vs Java METEOR). Objective follows the
    METEOR aligner spec: maximize the number of matched words; among
    maximum matchings, minimize the number of chunks (maximal runs of
    contiguous-and-ordered pairs). METEOR's further tie-break toward
    exact-module matches is unobservable here — only (matches, chunks)
    feeds the score — so it is not tracked. Exhaustive DFS with pruning —
    captions are short (<=50 tokens); a node budget guards pathological
    duplication. The search is seeded with the chunk count of the maximum
    matching itself (a feasible alignment), so even a budget-exhausted
    return is a valid, achievable chunk count — never a sentinel.
    """
    if not cand or not ref:
        return 0, 0
    cstems = [_stem(w) for w in cand]
    rstems = [_stem(w) for w in ref]
    # compatible ref positions per candidate position: (ref_idx, is_exact)
    comp: List[List[Tuple[int, bool]]] = []
    for i, w in enumerate(cand):
        row = [(j, True) for j, rw in enumerate(ref) if w == rw]
        row += [(j, False) for j, rw in enumerate(ref)
                if w != rw and cstems[i] == rstems[j]]
        comp.append(row)

    # maximum matching size via augmenting paths (small bipartite graph)
    match_r = [-1] * len(ref)

    def augment(i: int, seen: set) -> bool:
        for j, _ in comp[i]:
            if j in seen:
                continue
            seen.add(j)
            if match_r[j] == -1 or augment(match_r[j], seen):
                match_r[j] = i
                return True
        return False

    max_matches = sum(augment(i, set()) for i in range(len(cand)))
    if max_matches == 0:
        return 0, 0

    # how many candidate positions >= i still have any compatible ref
    # (loose upper bound on future matches, used to prune skips)
    can_match_suffix = [0] * (len(cand) + 1)
    for i in range(len(cand) - 1, -1, -1):
        can_match_suffix[i] = can_match_suffix[i + 1] + (1 if comp[i] else 0)

    # seed with the augmenting-path matching's own chunk count: a feasible
    # maximum-matching alignment, so best[1] is always achievable even if
    # the DFS budget trips before any leaf is reached
    pairs = sorted((i, j) for j, i in enumerate(match_r) if i != -1)
    seed_chunks, pi, pj = 0, -2, -2
    for i, j in pairs:
        if not (i == pi + 1 and j == pj + 1):
            seed_chunks += 1
        pi, pj = i, j
    best = [max_matches, seed_chunks]  # matches, chunks
    nodes = [0]

    def dfs(ci: int, used: int, matched: int, chunks: int,
            last_ci: int, last_ri: int):
        if nodes[0] > node_budget:
            return
        nodes[0] += 1
        if chunks >= best[1]:
            return  # chunks only grow; equality can no longer improve
        if matched + can_match_suffix[ci] < max_matches:
            return  # cannot reach a maximum matching anymore
        if ci == len(cand):
            if matched == max_matches:
                best[1] = chunks
            return
        # try continuing the current chunk first (finds low-chunk
        # alignments early, which tightens the prune)
        options = sorted(
            comp[ci],
            key=lambda jr: not (ci == last_ci + 1 and jr[0] == last_ri + 1))
        for j, _ in options:
            if used >> j & 1:
                continue
            new_chunk = 0 if (ci == last_ci + 1 and j == last_ri + 1) else 1
            dfs(ci + 1, used | (1 << j), matched + 1, chunks + new_chunk,
                ci, j)
        # or leave this candidate word unmatched
        dfs(ci + 1, used, matched, chunks, last_ci, last_ri)

    dfs(0, 0, 0, 0, -2, -2)
    return max_matches, best[1]


def meteor_lite(generated: List[List[str]], references: List[List[List[str]]],
                alpha: float = 0.9, beta: float = 3.0, gamma: float = 0.5
                ) -> Tuple[float, np.ndarray]:
    """METEOR with exact + Porter-stem match stages and the proper
    fewest-chunks alignment (see :func:`_meteor_align`), harmonic-mean
    parameters from the METEOR paper (alpha=0.9, beta=3, gamma=0.5).

    Remaining documented delta vs the Java METEOR behind the reference's
    published numbers (pycocoevalcap at src/evaluate/metrics.py:95): no
    WordNet synonym/paraphrase modules (offline environment) and no
    language-tuned parameter set."""
    per_sample = np.zeros(len(generated))
    for i, (cand, refs) in enumerate(zip(generated, references)):
        best = 0.0
        for ref in refs:
            m, chunks = _meteor_align(cand, ref)
            if m == 0:
                continue
            prec = m / len(cand)
            rec = m / len(ref)
            fmean = prec * rec / (alpha * prec + (1 - alpha) * rec)
            penalty = gamma * (chunks / m) ** beta
            best = max(best, fmean * (1 - penalty))
        per_sample[i] = best
    return float(per_sample.mean()) if len(generated) else 0.0, per_sample


# ---------------------------------------------------------------------------
# Aggregate entry points
# ---------------------------------------------------------------------------


def calculate_metrics_native(generated_captions: List[str],
                             reference_captions: List[List[str]],
                             per_sample: bool = False) -> Dict[str, object]:
    gen = [metric_tokenize(g) for g in generated_captions]
    refs = [[metric_tokenize(r) for r in rs] for rs in reference_captions]
    bleu_scores, bleu_ps = bleu(gen, refs)
    rl, rl_ps = rouge_l(gen, refs)
    cd, cd_ps = cider_d(gen, refs)
    out: Dict[str, object] = {
        "Bleu_1": bleu_scores[0], "Bleu_2": bleu_scores[1],
        "Bleu_3": bleu_scores[2], "Bleu_4": bleu_scores[3],
        "ROUGE_L": rl, "CIDEr": cd,
    }
    samples = {"Bleu_4": bleu_ps[:, 3], "ROUGE_L": rl_ps, "CIDEr": cd_ps}
    if meteor_available():
        out["METEOR"], samples["METEOR"] = meteor_lite(gen, refs)
    if per_sample:
        out["per_sample"] = samples
    return out


def calculate_metrics_pycocoevalcap(generated_captions, reference_captions,
                                    image_ids=None) -> Dict[str, float]:
    """Reference parity path (reference: src/evaluate/metrics.py:46-110)."""
    if image_ids is None:
        image_ids = list(range(len(generated_captions)))
    if len(set(image_ids)) != len(image_ids):
        # duplicate ids would silently overwrite entries (scoring only
        # the last pair per image); key by row instead so every
        # (generation, references) pair is scored like the native path
        image_ids = list(range(len(generated_captions)))
    gts, res = {}, {}
    for i, (gen, refs) in enumerate(zip(generated_captions, reference_captions)):
        iid = image_ids[i]
        gts[iid] = [{"caption": r} for r in refs]
        res[iid] = [{"caption": gen}]
    tokenizer = PTBTokenizer()
    gts = tokenizer.tokenize(gts)
    res = tokenizer.tokenize(res)
    scorers = [
        (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
        (Meteor(), "METEOR"),
        (Rouge(), "ROUGE_L"),
        (Cider(), "CIDEr"),
    ]
    if os.environ.get("CALCULATE_SPICE", "0") == "1":
        from pycocoevalcap.spice.spice import Spice

        scorers.append((Spice(), "SPICE"))
    scores: Dict[str, float] = {}
    for scorer, method in scorers:
        score, _ = scorer.compute_score(gts, res)
        if isinstance(method, list):
            for sc, m in zip(score, method):
                scores[m] = sc
        else:
            scores[method] = score
    return scores


def calculate_metrics(generated_captions: List[str],
                      reference_captions: List[List[str]],
                      image_ids: Optional[List[int]] = None) -> Dict[str, float]:
    """Main entry (reference: src/evaluate/metrics.py:20-43): pycocoevalcap
    when available, self-contained scorers otherwise."""
    if PYCOCOEVALCAP_AVAILABLE:
        try:
            return calculate_metrics_pycocoevalcap(
                generated_captions, reference_captions, image_ids)
        except Exception as e:  # e.g. Java missing for METEOR
            logging.getLogger(__name__).warning(
                "pycocoevalcap failed (%s); falling back to the native "
                "scorers — METEOR here is METEOR-lite, not comparable "
                "across scorer switches", e)
    return calculate_metrics_native(generated_captions, reference_captions)


def per_sample_spice(generated_captions: List[str],
                     reference_captions: List[List[str]]) -> np.ndarray:
    """Per-sample SPICE F-scores via pycocoevalcap's scene-graph scorer —
    the reference accepts ``spice`` as an SCST reward type
    (reference: src/train/trainer.py:440-484, src/config.py:76). Raises
    ImportError/RuntimeError when pycocoevalcap's SPICE (a Java tool) is
    unavailable; callers fall back explicitly (never silently)."""
    from pycocoevalcap.spice.spice import Spice

    gts = {i: [{"caption": r} for r in refs]
           for i, refs in enumerate(reference_captions)}
    res = {i: [{"caption": g}] for i, g in enumerate(generated_captions)}
    tok = PTBTokenizer()
    _, scores = Spice().compute_score(tok.tokenize(gts), tok.tokenize(res))
    out = np.zeros(len(generated_captions), dtype=np.float32)
    for i, s in enumerate(scores):
        # per-item entries are {"All": {"f": ...}, ...} (category break-down)
        val = s.get("All", s) if isinstance(s, dict) else s
        if isinstance(val, dict):
            val = val.get("f", 0.0)
        out[i] = float(val) if np.isfinite(float(val)) else 0.0
    return out


def per_sample_cider(generated_captions: List[str],
                     reference_captions: List[List[str]],
                     df: Optional[Dict[tuple, float]] = None,
                     log_num_images: Optional[float] = None) -> np.ndarray:
    """Per-sample CIDEr-D rewards for SCST (fixes the corpus-broadcast
    reward defect, SURVEY.md §2.4)."""
    gen = [metric_tokenize(g) for g in generated_captions]
    refs = [[metric_tokenize(r) for r in rs] for rs in reference_captions]
    _, ps = cider_d(gen, refs, df=df, log_num_images=log_num_images)
    return ps

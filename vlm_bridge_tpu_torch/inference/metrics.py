"""Caption evaluation metrics: corpus BLEU-1..4 and CIDEr-D (the port's own
copy of vlm_bridge_tpu.inference.metrics; pure Python).

The reference repo only has a simplified per-sentence BLEU-4 used for
validation-time sample scoring (reference: core_training_loop.py:405-462 —
kept in training/orchestrator.py as `simple_bleu4`). This module adds the
standard corpus-level metrics for the full test-split harness (SURVEY.md §7
stage 9): corpus BLEU with clipped n-gram counts + global brevity penalty,
and CIDEr-D (tf-idf weighted n-gram cosine with count clipping and a
length-difference gaussian penalty). Pure NumPy/stdlib — metric math is
host-side bookkeeping, not accelerator work.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _tokens(text: str) -> List[str]:
    return text.lower().split()


def _ngrams(toks: Sequence[str], n: int) -> Counter:
    return Counter(tuple(toks[i: i + n]) for i in range(len(toks) - n + 1))


# ---------------------------------------------------------------------------
# Corpus BLEU
# ---------------------------------------------------------------------------


def corpus_bleu(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    max_order: int = 4,
) -> Dict[str, float]:
    """Standard corpus BLEU (Papineni et al. 2002).

    references[i] is the list of reference captions for candidates[i]
    (GroundCap has one per image). Returns {"bleu1": ..., ..., "bleu4": ...,
    "brevity_penalty": ..., "length_ratio": ...}; bleuN uses uniform 1/N
    weights over orders 1..N.
    """
    assert len(candidates) == len(references)
    clipped = [0] * max_order
    total = [0] * max_order
    cand_len = 0
    ref_len = 0
    for cand, refs in zip(candidates, references):
        c = _tokens(cand)
        rs = [_tokens(r) for r in refs]
        cand_len += len(c)
        # closest reference length (ties -> shorter)
        ref_len += min((abs(len(r) - len(c)), len(r)) for r in rs)[1]
        for n in range(1, max_order + 1):
            c_ng = _ngrams(c, n)
            max_ref = Counter()
            for r in rs:
                r_ng = _ngrams(r, n)
                for g, cnt in r_ng.items():
                    max_ref[g] = max(max_ref[g], cnt)
            clipped[n - 1] += sum(min(cnt, max_ref[g]) for g, cnt in c_ng.items())
            total[n - 1] += max(sum(c_ng.values()), 0)

    precisions = [
        (clipped[i] / total[i]) if total[i] > 0 else 0.0
        for i in range(max_order)
    ]
    bp = 1.0 if cand_len > ref_len else (
        math.exp(1 - ref_len / cand_len) if cand_len > 0 else 0.0)

    out = {"brevity_penalty": bp,
           "length_ratio": cand_len / max(ref_len, 1)}
    for n in range(1, max_order + 1):
        ps = precisions[:n]
        if min(ps) > 0:
            score = bp * math.exp(sum(math.log(p) for p in ps) / n)
        else:
            score = 0.0
        out[f"bleu{n}"] = score
    return out


# ---------------------------------------------------------------------------
# CIDEr-D
# ---------------------------------------------------------------------------


def cider_d(
    candidates: Sequence[str],
    references: Sequence[Sequence[str]],
    max_order: int = 4,
    sigma: float = 6.0,
) -> float:
    """CIDEr-D (Vedantam et al. 2015, §3; the -D variant clips candidate
    n-gram counts at the reference count and applies a gaussian length
    penalty). Document frequencies are computed over THIS corpus's reference
    sets, as in the official implementation.
    """
    assert len(candidates) == len(references)
    N = len(candidates)
    if N == 0:
        return 0.0

    # document frequency per n-gram order (df counts images, not captions)
    dfs: List[Dict[tuple, int]] = [defaultdict(int) for _ in range(max_order)]
    for refs in references:
        for n in range(1, max_order + 1):
            seen = set()
            for r in refs:
                seen.update(_ngrams(_tokens(r), n).keys())
            for g in seen:
                dfs[n - 1][g] += 1
    log_n = math.log(max(N, 2))

    def tfidf_vec(toks: List[str], n: int) -> Dict[tuple, float]:
        ng = _ngrams(toks, n)
        vec = {}
        for g, cnt in ng.items():
            df = dfs[n - 1].get(g, 0)
            idf = log_n - math.log(max(df, 1))
            vec[g] = cnt * idf
        return vec

    def norm(vec: Dict[tuple, float]) -> float:
        return math.sqrt(sum(v * v for v in vec.values()))

    total_score = 0.0
    for cand, refs in zip(candidates, references):
        c = _tokens(cand)
        score_n = [0.0] * max_order
        for n in range(1, max_order + 1):
            cv = tfidf_vec(c, n)
            cn = norm(cv)
            for r in refs:
                rt = _tokens(r)
                rv = tfidf_vec(rt, n)
                rn = norm(rv)
                if cn == 0 or rn == 0:
                    continue
                # CIDEr-D: clip candidate weight at the reference weight
                dot = sum(min(cv[g], rv[g]) * rv[g] for g in cv if g in rv)
                delta = len(c) - len(rt)
                penalty = math.exp(-(delta * delta) / (2 * sigma * sigma))
                score_n[n - 1] += penalty * dot / (cn * rn)
            score_n[n - 1] /= max(len(refs), 1)
        total_score += 10.0 * sum(score_n) / max_order
    return total_score / N


def evaluate_captions(
    candidates: Sequence[str], references: Sequence[Sequence[str]]
) -> Dict[str, float]:
    """All corpus metrics in one dict (bleu1-4, bp, length_ratio, cider_d)."""
    out = corpus_bleu(candidates, references)
    out["cider_d"] = cider_d(candidates, references)
    return out

"""Word-error-rate scoring (a copy of rnnt_inference_tpu/utils/wer.py).

Contract (the MLPerf reference scorer's eval_accuracy.py): corpus WER = sum
of per-pair word-level edit distances divided by total reference word count.

Implementation is an original vectorized numpy DP: words are interned to
integer ids once per pair, then the Wagner-Fischer recurrence is evaluated
one row at a time with numpy, using a running prefix-min pass to resolve the
left-to-right dependency of the insertion term.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def levenshtein(a: Sequence, b: Sequence) -> int:
    """Edit distance between two token sequences (any hashables)."""
    if len(a) == 0:
        return len(b)
    if len(b) == 0:
        return len(a)
    # Intern tokens so the inner comparison is an integer array op.
    ids: dict = {}
    xa = np.fromiter((ids.setdefault(t, len(ids)) for t in a), dtype=np.int64)
    xb = np.fromiter((ids.setdefault(t, len(ids)) for t in b), dtype=np.int64)
    # Row DP over the shorter sequence to bound memory at O(min(n, m)).
    if xa.size < xb.size:
        xa, xb = xb, xa
    row = np.arange(xb.size + 1, dtype=np.int64)
    for i, tok in enumerate(xa, start=1):
        sub = row[:-1] + (xb != tok)          # diagonal: substitution / match
        dele = row[1:] + 1                    # from above: deletion
        new = np.empty_like(row)
        new[0] = i
        new[1:] = np.minimum(sub, dele)
        # Insertion term new[j-1] + 1 depends on new left-to-right; a single
        # prefix-min over (new[j] - j) linearizes it:
        #   new[j] = min(new[j], min_{k<=j}(new[k] + (j - k)))
        shifted = np.minimum.accumulate(new - np.arange(xb.size + 1))
        row = shifted + np.arange(xb.size + 1)
    return int(row[-1])


def word_error_rate(
    hypotheses: List[str], references: List[str]
) -> Tuple[float, int, int]:
    """Corpus WER over aligned hypothesis/reference string lists.

    Returns (wer, edit_distance_sum, reference_word_count).
    """
    if len(hypotheses) != len(references):
        raise ValueError(
            f"hypotheses ({len(hypotheses)}) and references ({len(references)}) "
            "must have the same length"
        )
    scores = 0
    words = 0
    for h, r in zip(hypotheses, references):
        r_words = r.split()
        words += len(r_words)
        scores += levenshtein(h.split(), r_words)
    wer = scores / words if words else float("inf")
    return wer, scores, words

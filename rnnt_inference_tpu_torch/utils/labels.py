"""Character alphabet and token<->text conversion (a copy of
rnnt_inference_tpu/utils/labels.py; reference: models/utils.py:23-57,
configs/rnnt.toml [labels])."""

from __future__ import annotations

from typing import List, Sequence

LABELS: List[str] = [" "] + [chr(ord("a") + i) for i in range(26)] + ["'"]
NUM_LABELS = len(LABELS) + 1  # + BLANK
BLANK = 28
SOS = -1

_CHAR_TO_IDX = {c: i for i, c in enumerate(LABELS)}


def seq_to_sen(seq: Sequence[int], seq_len: int | None = None) -> str:
    """Token ids -> string (reference: models/utils.py:55-57)."""
    if seq_len is None:
        seq_len = len(seq)
    return "".join(LABELS[int(seq[i])] for i in range(seq_len))


def sen_to_seq(sentence: str) -> List[int]:
    """String -> token ids; characters outside the alphabet are dropped."""
    return [_CHAR_TO_IDX[c] for c in sentence if c in _CHAR_TO_IDX]

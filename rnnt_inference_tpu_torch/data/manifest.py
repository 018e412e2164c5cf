"""Manifest parsing: JSON utterance lists with transcripts and durations
(the port's copy of rnnt_inference_tpu/data/manifest.py; reference:
datasets/parts/manifest.py:50-181)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

from rnnt_inference_tpu_torch.data.text import normalize_transcript
from rnnt_inference_tpu_torch.utils.labels import LABELS, sen_to_seq


class Manifest:
    """Filtered, normalized view of one or more manifest JSON files.

    Each entry: {audio_filepath, duration, transcript (normalized str),
    tokens (list[int])}.  Filters utterances longer than max_duration
    (reference default 15 s at eval, eval_accuracy.py:26).
    """

    def __init__(
        self,
        manifest_paths: Sequence[str],
        data_dir: str = "",
        labels: Optional[List[str]] = None,
        max_duration: Optional[float] = None,
        min_duration: Optional[float] = None,
        normalize: bool = True,
        max_utts: int = 0,
    ):
        labels = labels if labels is not None else LABELS
        entries: List[Dict[str, Any]] = []
        duration = 0.0
        filtered = 0.0
        for path in manifest_paths:
            with open(path, "r", encoding="utf-8") as fh:
                items = json.load(fh)
            for item in items:
                d = item.get("original_duration", item.get("duration"))
                if min_duration is not None and d < min_duration:
                    filtered += d
                    continue
                if max_duration is not None and d > max_duration:
                    filtered += d
                    continue
                text = item["transcript"]
                if normalize:
                    text = normalize_transcript(text, labels)
                files = item.get("files")
                if files:
                    fname = files[0]["fname"]
                else:
                    fname = item.get("audio_filepath", "")
                entries.append(
                    dict(
                        audio_filepath=os.path.join(data_dir, fname) if fname else "",
                        duration=d,
                        transcript=text,
                        tokens=sen_to_seq(text),
                    )
                )
                duration += d
                if max_utts and len(entries) >= max_utts:
                    break
        self._data = entries
        self.duration = duration
        self.filtered_duration = filtered

    def __len__(self):
        return len(self._data)

    def __getitem__(self, i):
        return self._data[i]

    def __iter__(self):
        return iter(self._data)

    @property
    def transcripts(self) -> List[str]:
        return [e["transcript"] for e in self._data]

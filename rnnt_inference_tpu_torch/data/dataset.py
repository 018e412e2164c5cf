"""Sample store: the RAM-resident utterance set the QSL serves
(the parts of rnnt_inference_tpu/data/dataset.py the runners and the CLI
need).  ``save``/``load`` use the JAX package's npz container, so a store
written by either package loads in the other."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List

import numpy as np

from rnnt_inference_tpu_torch.config import FeaturizerConfig


@dataclass
class SampleStore:
    """In-memory utterance set.

    kind == "waveform": samples[i] is float32 (S_i,) audio at 16 kHz.
    kind == "features": samples[i] is float32 (T_i, 240) log-mel features.
    """

    kind: str
    samples: List[np.ndarray]
    transcripts: List[str] = field(default_factory=list)
    names: List[str] = field(default_factory=list)

    def __len__(self):
        return len(self.samples)

    @property
    def lengths(self) -> np.ndarray:
        return np.array([s.shape[0] for s in self.samples], dtype=np.int32)

    def feature_lengths(self, cfg: FeaturizerConfig = FeaturizerConfig()) -> np.ndarray:
        """Post-frontend frame count per sample (used for length sorting)."""
        if self.kind == "features":
            return self.lengths
        return np.array([cfg.out_frames(int(s.shape[0])) for s in self.samples], np.int32)

    @property
    def audio_seconds(self) -> float:
        if self.kind == "waveform":
            return float(sum(s.shape[0] for s in self.samples)) / 16000.0
        # features: frames * splicing * hop / sr = frames * 0.03 s
        return float(sum(s.shape[0] for s in self.samples)) * 0.03

    def save(self, path: str) -> None:
        """npz: s0..s{n-1} and __meta__ (json: kind, n, transcripts, names)."""
        meta = {"kind": self.kind, "n": len(self.samples),
                "transcripts": self.transcripts, "names": self.names}
        np.savez_compressed(
            path,
            __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            **{f"s{i}": s for i, s in enumerate(self.samples)},
        )

    @classmethod
    def load(cls, path: str) -> "SampleStore":
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            samples = [z[f"s{i}"] for i in range(meta["n"])]
        return cls(kind=meta["kind"], samples=samples, transcripts=meta["transcripts"],
                   names=meta.get("names", []))

    def select(self, indices) -> "SampleStore":
        """Subset view (copying lists, sharing arrays)."""
        return SampleStore(
            kind=self.kind,
            samples=[self.samples[i] for i in indices],
            transcripts=[self.transcripts[i] for i in indices] if self.transcripts else [],
            names=[self.names[i] for i in indices] if self.names else [],
        )

    def filter_by_list(self, list_path: str) -> "SampleStore":
        """Keep the utterances whose file name appears in a calibration file
        list (one relative wav path per line; matched by basename)."""
        with open(list_path) as f:
            wanted = {os.path.basename(line.strip()) for line in f if line.strip()}
        if not self.names:
            raise ValueError("store has no utterance names to match a file list against")
        return self.select(
            [i for i, n in enumerate(self.names) if os.path.basename(n) in wanted]
        )

    @classmethod
    def synthetic(
        cls,
        n: int = 256,
        seed: int = 0,
        min_seconds: float = 1.0,
        max_seconds: float = 15.0,
        mean_seconds: float = 7.8,
        sample_rate: int = 16000,
    ) -> "SampleStore":
        """Random utterances with a dev-clean-like duration distribution
        (gamma-shaped, clipped to [min, max]).  The same seed gives the same
        samples as the JAX package's SampleStore.synthetic."""
        rng = np.random.RandomState(seed)
        durs = np.clip(rng.gamma(4.0, mean_seconds / 4.0, size=n), min_seconds, max_seconds)
        samples = [speechlike_noise(rng, int(d * sample_rate)) for d in durs]
        return cls(
            kind="waveform", samples=samples, transcripts=[""] * n,
            names=[f"synthetic-{i:05d}.wav" for i in range(n)],
        )


def speechlike_noise(
    rng: np.random.RandomState, n_samples: int, rms: float = 0.1,
    segment_ms: float = 100.0, sample_rate: int = 16000,
) -> np.ndarray:
    """Gaussian noise under a log-normal envelope that is piece-wise linear
    over ~100 ms segments, so frames vary as speech frames do; RMS is
    normalized to ``rms``."""
    x = rng.randn(n_samples)
    seg = max(int(segment_ms * sample_rate / 1000.0), 1)
    n_seg = n_samples // seg + 2
    knots = np.exp(rng.randn(n_seg))
    env = np.interp(np.arange(n_samples) / seg, np.arange(n_seg), knots)
    x = x * env
    x *= rms / max(float(np.sqrt(np.mean(x**2))), 1e-12)
    return x.astype(np.float32)

"""Query Sample Library: RAM-resident samples, bucketed batch assembly and
the device-resident sample set of the timed Offline loop (counterpart of
rnnt_inference_tpu/runtime/qsl.py).

Samples are sorted by descending length before Offline batching, and each
batch is padded to a length from a small bucket ladder, so the card sees few
distinct shapes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import FeaturizerConfig
from rnnt_inference_tpu_torch.data.dataset import SampleStore

# Waveform bucket ladder (seconds): utterances are <= 15 s.
DEFAULT_WAV_BUCKETS_S = (2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 15.0)


class QuerySampleLibrary:
    def __init__(
        self,
        store: SampleStore,
        cfg: FeaturizerConfig = FeaturizerConfig(),
        wav_buckets_s: Sequence[float] = DEFAULT_WAV_BUCKETS_S,
    ):
        self.store = store
        self.cfg = cfg
        self.feature_lens = store.feature_lengths(cfg)
        self.wav_buckets = tuple(int(s * cfg.sample_rate) for s in sorted(wav_buckets_s))
        # feature frames produced for each wav bucket length
        self.feat_buckets = tuple(cfg.out_frames(S) for S in self.wav_buckets)

    def __len__(self):
        return len(self.store)

    def sort_desc(self, indices: Sequence[int]) -> np.ndarray:
        """Descending feature-length sort (stable)."""
        idx = np.asarray(indices)
        order = np.argsort(-self.feature_lens[idx], kind="stable")
        return idx[order]

    def wav_bucket_for(self, max_len: int) -> int:
        """Smallest wav bucket >= max_len (clamps to the largest)."""
        for b in self.wav_buckets:
            if b >= max_len:
                return b
        return self.wav_buckets[-1]

    def feat_bucket_for(self, max_len: int) -> int:
        """Smallest feature bucket >= max_len (clamps to the largest)."""
        for b in self.feat_buckets:
            if b >= max_len:
                return b
        return self.feat_buckets[-1]

    def assemble_waveforms(
        self, indices: Sequence[int], pad_n: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Gather and pad waveforms -> ({N, S_bucket} f32, lens {N}, S_bucket).
        Samples longer than the largest bucket are truncated to it."""
        samples = [self.store.samples[i] for i in indices]
        lens = np.array([min(s.shape[0], self.wav_buckets[-1]) for s in samples], np.int32)
        S = self.wav_bucket_for(int(lens.max()) if len(lens) else 1)
        N = pad_n or len(samples)
        wav = np.zeros((N, S), np.float32)
        for r, s in enumerate(samples):
            wav[r, : lens[r]] = s[: lens[r]]
        out_lens = np.zeros((N,), np.int32)
        out_lens[: len(samples)] = lens
        return wav, out_lens, S

    def assemble_features(
        self, indices: Sequence[int], pad_n: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Gather and pad precomputed features -> ({T_bucket, N, C} f32,
        lens {N}, T_bucket).  Samples longer than the largest bucket are
        truncated to it."""
        if self.store.kind != "features":
            raise ValueError("assemble_features needs a features store")
        samples = [self.store.samples[i] for i in indices]
        lens = np.array([s.shape[0] for s in samples], np.int32)
        T = self.feat_bucket_for(int(lens.max()) if len(lens) else 1)
        N = pad_n or len(samples)
        C = samples[0].shape[1] if samples else self.cfg.out_feat
        feats = np.zeros((T, N, C), np.float32)
        out_lens = np.zeros((N,), np.int32)
        for r, s in enumerate(samples):
            L = min(s.shape[0], T)
            feats[:L, r, :] = s[:L]
            out_lens[r] = L
        return feats, out_lens, T

    def load_to_device(
        self, batch_size: int, indices: Optional[Sequence[int]] = None, device="cuda"
    ) -> "DeviceQSL":
        """Stage the samples ``indices`` (all by default) in device memory,
        bucketed, length-sorted and pre-split into batches, outside any
        timed window (MLPerf's LoadSamplesToRam)."""
        return DeviceQSL(self, batch_size, device, indices)


def batch_plan(
    qsl: QuerySampleLibrary,
    batch_size: int,
    indices: Optional[Sequence[int]] = None,
    min_tile: int = 32,
) -> List[Tuple[int, List[int], int]]:
    """Deterministic Offline batch plan over ``indices`` (all samples by
    default): length-sort descending, group by wav bucket, split each
    bucket into full batches, then a cascade of power-of-two tail tiles
    down to min(min_tile, batch_size).  Returns (S_bucket, rows, g): rows
    are sample indices, g the batch's row count (the rows are padded to g
    with dead rows)."""
    if indices is None:
        indices = np.arange(len(qsl))
    by_bucket: dict = {}
    for i in qsl.sort_desc(indices):
        s = qsl.store.samples[int(i)]
        S = qsl.wav_bucket_for(min(s.shape[0], qsl.wav_buckets[-1]))
        by_bucket.setdefault(S, []).append(int(i))

    tile = min(min_tile, batch_size)
    plan = []
    for S, rows in sorted(by_bucket.items(), reverse=True):
        n = -(-len(rows) // tile) * tile
        start = 0
        g = batch_size
        while start < n:
            # halve down to the tile floor, never below it (batch sizes that
            # are not power-of-two multiples of the tile, e.g. 96 with 32)
            while g > tile and g > n - start:
                g = max(tile, g // 2)
            plan.append((S, rows[start : start + g], g))
            start += g
    return plan


def to_int16_pcm(wav: np.ndarray) -> np.ndarray:
    """float PCM in [-1, 1) -> int16 PCM: round(wav * 32768) half to even,
    clipped to [-32768, 32767] (the runners scale it back by 1/32768)."""
    return np.clip(np.round(wav * 32768.0), -32768, 32767).astype(np.int16)


class DeviceQSL:
    """The sample set in device memory, bucketed, for the timed Offline loop.

    One batch per entry of ``batch_plan``: waveforms {g, S_bucket} int16,
    lengths {g} int32, and the sample index of each row (-1 for dead rows).
    Audio is staged as int16 PCM (``to_int16_pcm``).
    """

    MIN_TILE = 32

    def __init__(
        self,
        qsl: QuerySampleLibrary,
        batch_size: int,
        device="cuda",
        indices: Optional[Sequence[int]] = None,
    ):
        self.device = torch.device(device)
        self._batches = []
        for S, rows, g in batch_plan(qsl, batch_size, indices, self.MIN_TILE):
            wav = np.zeros((g, S), np.int16)
            lens = np.zeros((g,), np.int32)
            row_index = np.full((g,), -1, np.int64)
            for r, i in enumerate(rows):
                s = qsl.store.samples[i][:S]
                wav[r, : s.shape[0]] = to_int16_pcm(s)
                lens[r] = s.shape[0]
                row_index[r] = i
            self._batches.append((
                torch.from_numpy(wav).to(self.device),
                torch.from_numpy(lens).to(self.device),
                row_index,
            ))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # staging completes untimed

    def __len__(self):
        return len(self._batches)

    def batches(self):
        """Yield (wav_i16 {g, S} on the device, lens {g} on the device,
        row_index {g} numpy): full batches first, then each bucket's tail
        tiles."""
        yield from self._batches

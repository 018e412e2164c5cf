"""High-level transcription API, the one-call front door (counterpart of
rnnt_inference_tpu/transcribe.py).

    from rnnt_inference_tpu_torch.transcribe import Transcriber
    t = Transcriber.from_checkpoint("rnnt.pt")       # or .npz / quantized .npz
    text = t.transcribe(waveform_f32_16khz)          # one utterance
    texts = t.transcribe_batch(list_of_waveforms)    # batched

It runs on the card unless ``device="cpu"``; float weights load as bf16 by
default (kernels C and B), quantized ones run kernels A and B.
``impl="reference"`` runs the plain twins instead of the kernels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from rnnt_inference_tpu_torch.config import FeaturizerConfig, RNNTParams
from rnnt_inference_tpu_torch.utils.labels import seq_to_sen


class Transcriber:
    def __init__(
        self,
        weights,
        params: RNNTParams = RNNTParams(),
        cfg: FeaturizerConfig = FeaturizerConfig(),
        batch_size: int = 8,
        device="cuda",
        impl: Optional[str] = None,
    ):
        from rnnt_inference_tpu_torch.runtime.offline import OfflineRunner

        self.params = params
        self.cfg = cfg
        self.batch_size = batch_size
        self._runner = OfflineRunner(weights, params, cfg, batch_size=batch_size, device=device,
                                     impl=impl)

    @classmethod
    def from_checkpoint(
        cls,
        path: str,
        params: RNNTParams = RNNTParams(),
        bf16: bool = True,
        device="cuda",
        **kw,
    ) -> "Transcriber":
        """A zenodo-layout ``.pt`` checkpoint, a float weights ``.npz`` or a
        quantized ``.npz`` (models/checkpoint.py); float weights are cast to
        bf16 when ``bf16``."""
        from rnnt_inference_tpu_torch.models import checkpoint as ckpt
        from rnnt_inference_tpu_torch.models.weights import load_torch_checkpoint

        if path.endswith(".npz"):
            try:
                return cls(ckpt.load_quant_weights(path, params, device), params, device=device,
                           **kw)
            except ValueError:  # not a quantized npz
                w = ckpt.load_weights(path, params, device)
        else:
            w = load_torch_checkpoint(path, params, device)
        if bf16:
            w = w.to(dtype=torch.bfloat16)
        return cls(w, params, device=device, **kw)

    def transcribe_batch(self, waveforms: Sequence[np.ndarray]) -> List[str]:
        """Waveforms: f32 arrays at 16 kHz (any lengths) -> transcripts."""
        from rnnt_inference_tpu_torch.data.dataset import SampleStore
        from rnnt_inference_tpu_torch.runtime.qsl import QuerySampleLibrary

        store = SampleStore(kind="waveform",
                            samples=[np.asarray(w, np.float32) for w in waveforms],
                            transcripts=[""] * len(waveforms))
        result = self._runner.run(QuerySampleLibrary(store, self.cfg))
        return [seq_to_sen(t.astype(np.int32), len(t)) for t in result.tokens]

    def transcribe(self, waveform: np.ndarray) -> str:
        return self.transcribe_batch([waveform])[0]

"""A plain PyTorch cache-aware streaming FastConformer-Transducer (NVIDIA
NeMo's examples/asr/conf/fastconformer/cache_aware_streaming/
fastconformer_transducer_bpe_streaming.yaml, Large; the transducer head of
nvidia/stt_en_fastconformer_hybrid_large_streaming_multi), the reference
that decides whether a benchmark run of it served the right tokens.

It imports nothing of the program: the benchmark hands it the float32
weights it drew (a plain dict, ``random_weights`` in
benchmark/models/fastconformer_streaming.py) and the waveforms.  Each
utterance is computed whole, not by streaming: the model is trained so that
a chunk-by-chunk run with caches gives exactly this full forward under the
chunk mask and the causal convolutions.

  features   16 kHz waveform -> log-mel (80 bins, 25 ms Hann window, 10 ms
             hop, n_fft 512, slaney mel, preemphasis 0.97, no dither at
             inference, log guard 2^-24 added), not normalized
             (normalize "NA"); float64, rounded to float32 once
  subsample  dw_striding x8, causal: s1 = ReLU(CConv2d(1 -> C, 3x3, stride
             2)(x)); s2 = ReLU(Conv2d(C -> C, 1x1)(CConvDW2d(C, 3x3, stride
             2)(s1))); s3 the same on s2; a causal convolution pads 2 zeros
             before and 1 after on time and frequency (NeMo's CausalConv2D),
             so each stage takes L to L // 2 + 1 (80 -> 41 -> 21 -> 11 bins)
             and encoder frame t reads mel frames 8t - 14 .. 8t; (channel,
             frequency) flattened, Linear(C x 11 -> 512), times sqrt(512)
  17 blocks  x += FF(LN x) / 2; x += MHSA(LN x); x += Conv(LN x);
             x += FF(LN x) / 2; x = LN x.  FF: Linear(512 -> 2048), Swish,
             Linear(2048 -> 512).  MHSA: as the Conformer-Transducer's
             reference (8 heads of 64, untied u and v, NeMo's rel_shift),
             under the chunked_limited mask of att_context_size [70, 13]:
             query i sees key j iff 0 <= i // 14 - j // 14 <= 70 // 14,
             frames counted from the utterance's first encoder frame.
             Conv: pointwise Conv1d(512 -> 1024), GLU, causal depthwise
             Conv1d(k 9: 8 zeros before, none after), LayerNorm(512),
             Swish, pointwise Conv1d(512 -> 512)
  prediction embedding (blank, also the start symbol, embeds to zeros) + one
             LSTM layer of 640
  joint      relu(f W1t + g W1p + b1) W2 + b2 over 1,025 labels

Departures from NeMo, each deliberate: masked scores are -inf where NeMo
fills -10000 (no query of the full forward has every key masked, so the
softmax is the same); dropout is off (inference); the utterance is its own
batch.  Precisions, the control (lower=True) and TF32 off as in
benchmark/reference/conformer_transducer.py.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.conformer_transducer import (
    ConformerTransducer,
    _mm,
    rel_positions,
    rel_shift,
)
from benchmark.reference.rnnt import LOWER, Operand, _to, exact_matmuls, slaney_mel


class Featurizer:
    """log-mel features of one waveform, (S,) -> (S // hop + 1, n_mels), not
    normalized."""

    def __init__(self, cfg: dict, device):
        for k, v in {"window": "hann", "normalize": "NA", "log": True, "pad_mode": "zeros",
                     "frame_splicing": 1}.items():
            if cfg[k] != v:
                raise ValueError(f"the reference featurizer implements {k}={v!r}, not {cfg[k]!r}")
        self.cfg = cfg
        self.hop = int(cfg["sample_rate"] * cfg["window_stride"])
        win = int(cfg["sample_rate"] * cfg["window_size"])
        n_fft = cfg["n_fft"]
        hann = 0.5 * (1 - np.cos(2 * np.pi * np.arange(win) / (win - 1)))  # symmetric
        window = np.zeros(n_fft)
        window[(n_fft - win) // 2 : (n_fft - win) // 2 + win] = hann
        self.window = torch.tensor(window, dtype=torch.float64, device=device)
        fmax = cfg["highfreq"] if cfg.get("highfreq") else cfg["sample_rate"] / 2
        fb = slaney_mel(cfg["sample_rate"], n_fft, cfg["n_mels"], cfg["lowfreq"], fmax)
        self.fb = torch.tensor(fb.T, dtype=torch.float64, device=device)
        self.dither2 = cfg["dither"] ** 2 if cfg.get("dither_at_inference", True) else 0.0

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        cfg, n_fft = self.cfg, self.cfg["n_fft"]
        x = wav.double()
        x = torch.cat([x[:1], x[1:] - float(np.float32(cfg["preemph"])) * x[:-1]])
        frames = x.shape[0] // self.hop + 1
        x = F.pad(x, (n_fft // 2, n_fft // 2 + n_fft))
        spec = torch.fft.rfft(x.unfold(0, n_fft, self.hop)[:frames] * self.window)
        power = spec.real ** 2 + spec.imag ** 2 + self.dither2
        return torch.log(power @ self.fb + cfg["log_guard"]).float()


def chunk_mask(T: int, left: int, right: int, device) -> torch.Tensor:
    """(T, T) bool, True where query i may see key j: NeMo's chunked_limited
    mask of att_context_size [left, right]."""
    chunk = torch.arange(T, device=device) // (right + 1)
    diff = chunk[:, None] - chunk[None, :]
    return (diff >= 0) & (diff <= left // (right + 1))


class FastConformerStreaming(ConformerTransducer):
    """The model at one set of precisions (the prediction net, the joint,
    the lattice and the greedy decode are benchmark/reference/rnnt.py's)."""

    def __init__(self, weights: dict, config: dict, device, lower: bool = False):
        exact_matmuls()
        self.device = torch.device(device)
        self.config = config
        prec = dict(config["precision"])
        if lower:
            prec = {k: LOWER[v] for k, v in prec.items()}
        self.prec = prec
        w = _to(weights, self.device)
        self.w = w
        self.featurizer = Featurizer(config["featurizer"], self.device)
        self.enc_op = Operand(prec["encoder"])
        self.pred_op = Operand(prec["prediction"])
        self.embed = w["embed"].to(self.pred_op.store)
        self.pred = [tuple(self.pred_op.weight(t) for t in layer) for layer in w["pred"]]
        self.joint_op = Operand(prec["joint"])
        j = w["joint"]
        self.w1t, self.w1p, self.w2 = (self.joint_op.weight(j[k])
                                       for k in ("w1_trans", "w1_pred", "w2"))
        self.b1, self.b2 = (j[k].to(self.joint_op.store).float() for k in ("b1", "b2"))
        self.blank = config["num_labels"] - 1
        self.max_len = config["max_res_len"]
        self.d = config["d_model"]
        self.heads = config["n_heads"]
        self.left, self.right = config["att_context_size"]

    def _cconv(self, x, w, b, groups=1):
        """NeMo's CausalConv2D, 3x3 stride 2: 2 zeros before and 1 after on
        time and frequency."""
        return self._conv(F.pad(x, (2, 1, 2, 1)), w, b, stride=2, groups=groups)

    def _subsample(self, feats):
        s, C = self.w["subsampling"], self.w["subsampling"]["conv1_w"].shape[0]
        y = torch.relu(self._cconv(feats[None, None], s["conv1_w"], s["conv1_b"]))
        for k in (1, 2):
            y = self._cconv(y, s[f"dw{k}_w"], s[f"dw{k}_b"], groups=C)
            y = torch.relu(self._conv(y, s[f"pw{k}_w"], s[f"pw{k}_b"]))
        _, _, T3, F3 = y.shape
        y = y[0].permute(1, 0, 2).reshape(T3, C * F3)  # (channel, frequency)
        return self._linear(y, s["out_w"], s["out_b"]) * math.sqrt(self.d)

    def _mhsa(self, x, a):
        op, T, H = self.enc_op, x.shape[0], self.heads
        d = self.d // H
        heads = lambda t: t.reshape(T, H, d).transpose(0, 1)  # (H, T, d)
        q = heads(self._linear(x, a["wq"], a["bq"]))
        k = heads(self._linear(x, a["wk"], a["bk"]))
        v = heads(self._linear(x, a["wv"], a["bv"]))
        p = self._linear(rel_positions(T, self.d, self.device), a["w_pos"])
        p = p.reshape(2 * T - 1, H, d).transpose(0, 1)  # (H, 2T - 1, d)
        ac = _mm(op, q + a["u"].reshape(H, 1, d), k.transpose(1, 2))
        bd = rel_shift(_mm(op, q + a["v"].reshape(H, 1, d), p.transpose(1, 2)))[..., :T]
        score = ((ac + bd) / math.sqrt(d)).masked_fill(
            ~chunk_mask(T, self.left, self.right, self.device), -math.inf)
        ctx = _mm(op, torch.softmax(score, dim=-1), v).transpose(0, 1).reshape(T, self.d)
        return self._linear(ctx, a["w_out"], a["b_out"])

    def _conv_module(self, x, c):
        h = F.glu(self._linear(self._ln(x, c["ln"]), c["pw1_w"], c["pw1_b"]), dim=-1)  # (T, D)
        k = c["dw_w"].shape[-1]
        h = self._conv(F.pad(h.t()[None], (k - 1, 0)), c["dw_w"][:, None, :], c["dw_b"],
                       groups=self.d)[0].t()
        h = self._ln(h, c["norm"])
        return self._linear(h * torch.sigmoid(h), c["pw2_w"], c["pw2_b"])

"""A plain PyTorch Conformer-Transducer (NVIDIA NeMo's
stt_en_conformer_transducer_large, examples/asr/conf/conformer/
conformer_transducer_bpe.yaml, Large), the reference that decides whether a
benchmark run of it served the right tokens.

It imports nothing of the program: the benchmark hands it the float32
weights it drew (a plain dict, ``random_weights`` in
benchmark/models/conformer_transducer.py) and the waveforms.  Each
utterance is computed alone, from the yaml's equations:

  features   16 kHz waveform -> log-mel (80 bins, 25 ms Hann window, 10 ms
             hop, n_fft 512, slaney mel, preemphasis 0.97, no dither at
             inference, log guard 2^-24 added), normalized per feature;
             computed in float64 and rounded to float32 once
  subsample  Conv2d(1 -> 512, 3x3, stride 2, pad 1), ReLU, Conv2d(512 -> 512,
             3x3, stride 2, pad 1), ReLU, (channel, frequency) flattened,
             Linear(512 x 20 -> 512), times sqrt(512)
  17 blocks  x += FF(LN x) / 2; x += MHSA(LN x); x += Conv(LN x);
             x += FF(LN x) / 2; x = LN x.  FF: Linear(512 -> 2048), Swish,
             Linear(2048 -> 512).  MHSA: 8 heads of 64, q k v with biases;
             p = W_pos PE (no bias) of relative positions T - 1 .. -(T - 1);
             scores ((q + u) k^T + rel_shift((q + v) p^T)) / 8, NeMo's
             rel_shift literally; softmax; . v; Linear(512 -> 512).  Conv:
             pointwise Conv1d(512 -> 1024), GLU, depthwise Conv1d(k 31, pad
             15), BatchNorm (running statistics), Swish, pointwise
             Conv1d(512 -> 512)
  prediction embedding (blank, also the start symbol, embeds to zeros) + one
             LSTM layer of 640
  joint      relu(f W1t + g W1p + b1) W2 + b2 over 1,025 labels; the two
             first-layer biases of NeMo's joint folded into b1

Departures from NeMo, each deliberate: the utterance is its own batch, so
the second subsampling convolution reads zeros past the first one's frames
(NeMo's batched ConvSubsampling reads ReLU(bias) there at an odd length);
dropout is off (inference).

Precisions as benchmark/reference/rnnt.py gives them ("bf16": weights and
every product's inputs rounded to bfloat16, sums in float32; LayerNorm,
softmax, BatchNorm and the cell in float32); the control (lower=True)
takes every product's operands through float8 e4m3 with a per-tensor
scale.  Matrix products and convolutions run with TF32 off.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.rnnt import LOWER, RNNT, Operand, _to, exact_matmuls, fp8, slaney_mel


class Featurizer:
    """log-mel features of one waveform, (S,) -> (S // hop + 1, n_mels)."""

    def __init__(self, cfg: dict, device):
        for k, v in {"window": "hann", "normalize": "per_feature", "log": True,
                     "pad_mode": "zeros", "frame_splicing": 1}.items():
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
        feats = torch.log(power @ self.fb + cfg["log_guard"])
        mean = feats.mean(0)
        std = torch.sqrt(((feats - mean) ** 2).sum(0) / max(frames - 1, 1)) + 1e-5
        return ((feats - mean) / std).float()


def _stored(op: Operand, x: torch.Tensor) -> torch.Tensor:
    """x as a product's input at the operand's precision, in float32."""
    x = x.to(op.store).float()
    return fp8(x) if op.fmt == "fp8" else x


def _mm(op: Operand, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, both product inputs (activations), summed in float32."""
    return _stored(op, a) @ _stored(op, b)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """NeMo's RelPositionMultiHeadAttention.rel_shift: (..., T, 2T - 1) scores
    against positions T - 1 .. -(T - 1) -> column j of row i holds position
    i - j (the first T columns are taken after it)."""
    *lead, t1, t2 = x.shape
    x = F.pad(x, (1, 0)).reshape(*lead, t2 + 1, t1)
    return x[..., 1:, :].reshape(*lead, t1, t2)


def rel_positions(T: int, d: int, device) -> torch.Tensor:
    """NeMo's RelPositionalEncoding of positions T - 1 .. -(T - 1), (2T - 1, d)."""
    pos = torch.arange(T - 1, -T, -1, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=device)
                    * -(math.log(10000.0) / d))
    pe = torch.zeros((2 * T - 1, d), dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float()


class ConformerTransducer(RNNT):
    """The model at one set of precisions (the prediction net, the joint,
    the lattice and the greedy decode are benchmark/reference/rnnt.py's
    RNNT's, which take any number of prediction layers and labels)."""

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

    # -- encoder -----------------------------------------------------------

    def _linear(self, x, w, b=None):
        y = self.enc_op.dot(x, self.enc_op.weight(w))
        return y if b is None else y + b

    def _conv(self, x, w, b, **kw):
        op = self.enc_op
        conv = F.conv2d if x.dim() == 4 else F.conv1d
        return conv(_stored(op, x), op.weight(w), b, **kw)

    def _ln(self, x, p):
        return F.layer_norm(x, (x.shape[-1],), p["g"], p["b"], 1e-5)

    def _ff(self, x, f):
        h = self._linear(self._ln(x, f["ln"]), f["w1"], f["b1"])
        return self._linear(h * torch.sigmoid(h), f["w2"], f["b2"])

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
        attn = torch.softmax((ac + bd) / math.sqrt(d), dim=-1)
        ctx = _mm(op, attn, v).transpose(0, 1).reshape(T, self.d)
        return self._linear(ctx, a["w_out"], a["b_out"])

    def _conv_module(self, x, c):
        h = self._linear(self._ln(x, c["ln"]), c["pw1_w"], c["pw1_b"])
        h = F.glu(h, dim=-1)  # (T, D)
        k = c["dw_w"].shape[-1]
        h = self._conv(h.t()[None], c["dw_w"][:, None, :], c["dw_b"], groups=self.d,
                       padding=k // 2)[0].t()
        h = (h - c["bn_mean"]) / torch.sqrt(c["bn_var"] + 1e-5) * c["bn_g"] + c["bn_b"]
        return self._linear(h * torch.sigmoid(h), c["pw2_w"], c["pw2_b"])

    def _subsample(self, feats):
        s = self.w["subsampling"]
        y = torch.relu(self._conv(feats[None, None], s["conv1_w"], s["conv1_b"], stride=2,
                                  padding=1))
        y = torch.relu(self._conv(y, s["conv2_w"], s["conv2_b"], stride=2, padding=1))
        _, C, T2, F2 = y.shape
        y = y[0].permute(1, 0, 2).reshape(T2, C * F2)
        return self._linear(y, s["out_w"], s["out_b"]) * math.sqrt(self.d)

    def encode_one(self, wav: torch.Tensor) -> torch.Tensor:
        x = self._subsample(self.featurizer(wav.to(self.device)))
        for b in self.w["blocks"]:
            x = x + 0.5 * self._ff(x, b["ff1"])
            x = x + self._mhsa(self._ln(x, b["att"]["ln"]), b["att"])
            x = x + self._conv_module(x, b["conv"])
            x = x + 0.5 * self._ff(x, b["ff2"])
            x = self._ln(x, b["out_ln"])
        return x

    def encode(self, wavs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The encoder's output (T_i, d_model) of each waveform, float32."""
        return [self.encode_one(w) for w in wavs]

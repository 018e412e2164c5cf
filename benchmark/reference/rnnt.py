"""A plain PyTorch RNN-T (MLPerf Inference RNN-T), the reference that decides
whether a benchmark run served the right tokens.

It imports nothing of the program and takes nothing the program made: the
benchmark hands it the float32 weights it drew (a plain dict, see
``random_weights`` in benchmark/models/rnnt.py), the waveforms and the
calibration audio, and it works out everything else itself, the int8
scales included.

  features   16 kHz waveform -> log-mel (80 bins, 20 ms Hann window, 10 ms
             hop, n_fft 512, slaney mel, preemphasis 0.97, dither^2 added
             to the power), frames spliced by 3, normalized per feature;
             computed in float64 and rounded to float32 once
  encoder    2 LSTM layers of 1024, time stacked by 2, 3 LSTM layers of 1024;
             "int8": per-tensor symmetric int8 weights and activations
             (scale 127 / amax, rounded half to even, clamped to [-128, 127]),
             activation amax per layer over |cat(x_t, h_{t-1})| of a float32
             pass over the calibration audio, exact integer products, gates
             and cell in float32, each layer's output quantized with the next
             layer's scale, the last one float32;
             "bf16": weights in bfloat16, products summed in float32, the
             hoisted input projection and h stored in bfloat16, cell float32
  prediction embedding + 2 LSTM layers of 320 (bf16 as above), SOS embeds to 0
  joint      relu(f W1t + g W1p + b1) W2 + b2, bf16 operands, float32 sums

Precisions one step below those (the control): int4 for int8 (scale 7 /
amax, [-8, 7]) and float8 e4m3 (per-tensor scale 448 / amax on both operands
of every product) for bf16.

Matrix products run with TF32 off (``exact_matmuls``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.check import widest_gap  # noqa: F401  (the check's rule, once here)

# the next precision below each one a configuration can state
LOWER = {"int8": "int4", "bf16": "fp8", "f32": "tf32"}
INT_BOUNDS = {"int8": (-128.0, 127.0), "int4": (-8.0, 7.0)}
FP8_MAX = 448.0


def exact_matmuls() -> None:
    """float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# features
# --------------------------------------------------------------------------


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    logstep = math.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / logstep, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    logstep = math.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), m * (200.0 / 3))


def slaney_mel(sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float):
    """(n_mels, n_fft // 2 + 1) triangular filters on the slaney mel scale,
    each scaled to unit area (librosa's defaults)."""
    freqs = np.linspace(0.0, sample_rate / 2, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, freqs.size))
    for m in range(n_mels):
        lo, mid, hi = hz[m], hz[m + 1], hz[m + 2]
        up = (freqs - lo) / (mid - lo)
        down = (hi - freqs) / (hi - mid)
        fb[m] = np.maximum(0.0, np.minimum(up, down)) * 2.0 / (hi - lo)
    return fb


class Featurizer:
    """log-mel features of one waveform: (S,) -> (ceil(frames / splice), 240)."""

    IMPLEMENTS = {"window": "hann", "normalize": "per_feature", "log": True, "pad_mode": "zeros"}

    def __init__(self, cfg: dict, device):
        for k, v in self.IMPLEMENTS.items():
            if cfg[k] != v:
                raise ValueError(f"the reference featurizer implements {k}={v!r}, not {cfg[k]!r}")
        self.cfg = cfg
        self.hop = int(cfg["sample_rate"] * cfg["window_stride"])
        self.win = int(cfg["sample_rate"] * cfg["window_size"])
        n_fft = cfg["n_fft"]
        n = np.arange(self.win)
        hann = 0.5 * (1 - np.cos(2 * np.pi * n / (self.win - 1)))  # symmetric window
        window = np.zeros(n_fft)
        window[(n_fft - self.win) // 2 : (n_fft - self.win) // 2 + self.win] = hann
        self.window = torch.tensor(window, dtype=torch.float64, device=device)
        fmax = cfg["highfreq"] if cfg.get("highfreq") else cfg["sample_rate"] / 2
        fb = slaney_mel(cfg["sample_rate"], n_fft, cfg["n_mels"], cfg["lowfreq"], fmax)
        self.fb = torch.tensor(fb.T, dtype=torch.float64, device=device)

    def __call__(self, wav: torch.Tensor) -> torch.Tensor:
        cfg, n_fft = self.cfg, self.cfg["n_fft"]
        x = wav.double()
        x = torch.cat([x[:1], x[1:] - float(np.float32(cfg["preemph"])) * x[:-1]])
        frames = x.shape[0] // self.hop + 1
        x = torch.nn.functional.pad(x, (n_fft // 2, n_fft // 2 + n_fft))
        spec = torch.fft.rfft(x.unfold(0, n_fft, self.hop)[:frames] * self.window)
        power = spec.real ** 2 + spec.imag ** 2 + cfg["dither"] ** 2
        mel = torch.log(power @ self.fb + 1e-20)
        k = cfg["frame_splicing"]
        mel = torch.nn.functional.pad(mel, (0, 0, 0, (-frames) % k))
        feats = mel.reshape(-1, k * cfg["n_mels"])
        n = feats.shape[0]
        mean = feats.mean(0)
        std = torch.sqrt(((feats - mean) ** 2).sum(0) / max(n - 1, 1)) + 1e-5
        return ((feats - mean) / std).float()


# --------------------------------------------------------------------------
# number formats
# --------------------------------------------------------------------------


def int_scale(amax: torch.Tensor, fmt: str) -> torch.Tensor:
    """The symmetric scale that maps amax to the format's largest value."""
    top = INT_BOUNDS[fmt][1]
    amax = amax.float()
    return torch.full_like(amax, top) / amax


def int_round(x: torch.Tensor, scale: torch.Tensor, fmt: str) -> torch.Tensor:
    """round(x scale) half to even, clamped to the format: integers held in
    float32."""
    lo, hi = INT_BOUNDS[fmt]
    return torch.clamp(torch.round(x.float() * scale), lo, hi)


def fp8(v: torch.Tensor) -> torch.Tensor:
    """v through float8 e4m3 with a per-tensor scale, back in float32."""
    v = v.float()
    s = FP8_MAX / torch.clamp(v.abs().max(), min=1e-30)
    return (v * s).to(torch.float8_e4m3fn).float() / s


class Operand:
    """How a floating precision stores values and feeds products: "f32",
    "bf16", or "fp8" (bf16 storage, float8 e4m3 operands)."""

    def __init__(self, fmt: str):
        if fmt not in ("f32", "bf16", "fp8"):
            raise ValueError(f"no floating format {fmt!r}")
        self.fmt = fmt
        self.store = torch.float32 if fmt == "f32" else torch.bfloat16

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.to(self.store).float()
        return fp8(w) if self.fmt == "fp8" else w

    def dot(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a (stored) times a prepared weight, summed in float32."""
        a = a.to(self.store).float()
        return (fp8(a) if self.fmt == "fp8" else a) @ w


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------


def _cell(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def float_layer(layer, x: torch.Tensor, op: Operand) -> torch.Tensor:
    """One LSTM layer over (T, B, IC) from a zero state; y (T, B, H) stored
    in the operand's type."""
    w_ih, w_hh, b = (op.weight(t) for t in layer)
    T, B, _ = x.shape
    H = w_hh.shape[0]
    xw = (op.dot(x, w_ih) + b).to(op.store)
    h = torch.zeros((B, H), dtype=op.store, device=x.device)
    c = torch.zeros((B, H), device=x.device)
    ys = []
    for t in range(T):
        h_f, c = _cell(xw[t].float() + op.dot(h, w_hh), c)
        h = h_f.to(op.store)
        ys.append(h)
    return torch.stack(ys)


def stack_time(y: torch.Tensor, lens: torch.Tensor, factor: int) -> torch.Tensor:
    """(T, B, C) -> (ceil(T / factor), B, factor C): frames past each length
    zeroed, consecutive frames side by side."""
    T, B, C = y.shape
    keep = torch.arange(T, device=y.device)[:, None] < lens[None, :]
    y = y * keep[:, :, None].to(y.dtype)
    y = torch.nn.functional.pad(y, (0, 0, 0, 0, 0, (-T) % factor))
    return y.transpose(0, 1).reshape(B, -1, factor * C).transpose(0, 1)


@dataclass
class IntLayer:
    w_ih: torch.Tensor  # integers in float64
    w_hh: torch.Tensor
    b: torch.Tensor
    in_scale: torch.Tensor
    w_scale: torch.Tensor
    out_scale: Optional[torch.Tensor]  # None: the layer emits float32


def calibrate(weights: dict, feats: Sequence[torch.Tensor], factor: int) -> List[torch.Tensor]:
    """amax of |cat(x_t, h_{t-1})| per encoder layer (pre, then post) over a
    float32 pass of whole utterances from a zero state."""
    op = Operand("f32")
    x, lens = pad_batch(feats)
    amax = []
    for stage, layers in enumerate((weights["pre"], weights["post"])):
        if stage:
            x, lens = stack_time(x, lens, factor), -(-lens // factor)
        for layer in layers:
            y = float_layer(layer, x, op)
            valid = (torch.arange(x.shape[0], device=x.device)[:, None] < lens[None, :])[..., None]
            h_prev = torch.cat([torch.zeros_like(y[:1]), y[:-1]])
            amax.append(torch.maximum((x.abs() * valid).max(), (h_prev.abs() * valid).max()))
            x = y
    return amax


def int_layers(weights: dict, amax: List[torch.Tensor], fmt: str) -> List[IntLayer]:
    """The encoder's layers in an integer format, each output scaled for the
    next layer (across the time stacking too); the last emits float32."""
    layers = list(weights["pre"]) + list(weights["post"])
    in_scales = [int_scale(a, fmt) for a in amax]
    out = []
    for l, (w_ih, w_hh, b) in enumerate(layers):
        w_scale = int_scale(torch.cat([w_ih, w_hh]).abs().max(), fmt)
        out.append(IntLayer(
            w_ih=int_round(w_ih, w_scale, fmt).double(), w_hh=int_round(w_hh, w_scale, fmt).double(),
            b=b.float(), in_scale=in_scales[l], w_scale=w_scale,
            out_scale=in_scales[l + 1] if l + 1 < len(layers) else None))
    return out


def int_layer(layer: IntLayer, xq: torch.Tensor, fmt: str) -> torch.Tensor:
    """One integer LSTM layer over integer inputs (T, B, IC) from a zero state:
    integers of the next layer's scale, or float32 from the last layer."""
    T, B, _ = xq.shape
    H = layer.w_hh.shape[0]
    rb = 1.0 / (layer.in_scale * layer.w_scale)
    xw = xq.double() @ layer.w_ih
    h = torch.zeros((B, H), dtype=torch.float64, device=xq.device)
    c = torch.zeros((B, H), device=xq.device)
    ys = []
    for t in range(T):
        h_f, c = _cell((xw[t] + h @ layer.w_hh).float() * rb + layer.b, c)
        h = int_round(h_f, layer.in_scale, fmt).double()
        ys.append(h_f if layer.out_scale is None else int_round(h_f, layer.out_scale, fmt))
    return torch.stack(ys)


def pad_batch(seqs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """[(T_i, C)] -> ((T_max, B, C) zero padded, lengths (B,))."""
    lens = torch.tensor([s.shape[0] for s in seqs], device=seqs[0].device)
    x = torch.zeros((int(lens.max()), len(seqs), seqs[0].shape[1]), dtype=seqs[0].dtype,
                    device=seqs[0].device)
    for i, s in enumerate(seqs):
        x[: s.shape[0], i] = s
    return x, lens


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


class RNNT:
    """The model at one set of precisions.

    weights: the float32 weights (module docstring); config: the
    configuration file's dict ("precision": {"encoder", "prediction",
    "joint"}, the featurizer's constants, the sizes); calib_audio: the
    waveforms whose features calibrate an integer encoder; lower=True takes
    every precision one step down (the control)."""

    def __init__(self, weights: dict, config: dict, calib_audio: Sequence[torch.Tensor],
                 device, lower: bool = False):
        exact_matmuls()
        self.device = torch.device(device)
        self.config = config
        prec = dict(config["precision"])
        if lower:
            prec = {k: LOWER[v] for k, v in prec.items()}
        self.prec = prec
        w = _to(weights, self.device)
        self.featurizer = Featurizer(config["featurizer"], self.device)
        self.factor = config["stack_time_factor"]
        self.n_pre = len(w["pre"])
        if prec["encoder"] in INT_BOUNDS:
            amax = calibrate(w, [self.featurizer(a.to(self.device)) for a in calib_audio],
                             self.factor)
            self.int_layers = int_layers(w, amax, prec["encoder"])
        else:
            self.enc_op = Operand(prec["encoder"])
            self.enc_layers = list(w["pre"]) + list(w["post"])
        self.pred_op = Operand(prec["prediction"])
        self.embed = w["embed"].to(self.pred_op.store)
        self.pred = [tuple(self.pred_op.weight(t) for t in layer) for layer in w["pred"]]
        self.joint_op = Operand(prec["joint"])
        j = w["joint"]
        self.w1t, self.w1p, self.w2 = (self.joint_op.weight(j[k])
                                       for k in ("w1_trans", "w1_pred", "w2"))
        self.b1, self.b2 = (j[k].to(self.joint_op.store).float() for k in ("b1", "b2"))
        self.blank = config["num_labels"] - 1
        self.max_len = config["max_res_len"]  # the program's answer buffer

    def encode(self, wavs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The encoder's output (T2_i, H) of each waveform, float32."""
        feats = [self.featurizer(w.to(self.device)) for w in wavs]
        x, lens = pad_batch(feats)
        fmt = self.prec["encoder"]
        if fmt in INT_BOUNDS:
            layers = self.int_layers
            y = int_round(x, layers[0].in_scale, fmt)
            for l, layer in enumerate(layers):
                if l == self.n_pre:
                    y, lens = stack_time(y, lens, self.factor), -(-lens // self.factor)
                y = int_layer(layer, y, fmt)
        else:
            y = x
            for l, layer in enumerate(self.enc_layers):
                if l == self.n_pre:
                    y, lens = stack_time(y, lens, self.factor), -(-lens // self.factor)
                y = float_layer(layer, y, self.enc_op)
        return [y[: int(n), i].float() for i, n in enumerate(lens)]

    def _pred_step(self, tok: torch.Tensor, state):
        """One prediction step on the last symbols (B,) (-1: SOS, the zero
        embedding): (g (B, P) stored, new state)."""
        op = self.pred_op
        sos = tok < 0
        y = self.embed[torch.where(sos, 0, tok).long()] * (~sos)[:, None].to(op.store)
        new = []
        for (w_ih, w_hh, b), (h, c) in zip(self.pred, state):
            h_f, c = _cell(op.dot(y, w_ih) + b + op.dot(h, w_hh), c)
            y = h_f.to(op.store)
            new.append((y, c))
        return y, new

    def _zero_state(self, B: int):
        P = self.embed.shape[1]
        return [(torch.zeros((B, P), dtype=self.pred_op.store, device=self.device),
                 torch.zeros((B, P), device=self.device)) for _ in self.pred]

    def prediction(self, tokens: torch.Tensor) -> torch.Tensor:
        """g_k for k = 0..K: the prediction net's output after consuming the
        first k tokens, (K + 1, P) float32."""
        state = self._zero_state(1)
        prev = torch.tensor([-1], device=self.device)
        gs = []
        for k in range(tokens.shape[0] + 1):
            g, state = self._pred_step(prev, state)
            gs.append(g[0].float())
            if k < tokens.shape[0]:
                prev = tokens[k : k + 1].long()
        return torch.stack(gs)

    def fproj(self, f: torch.Tensor) -> torch.Tensor:
        return self.joint_op.dot(f, self.w1t)

    def logits(self, fproj: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """(T2, J) and (K + 1, P) -> the joint's logits (T2, K + 1, V)."""
        op = self.joint_op
        z = torch.relu(fproj[:, None, :] + op.dot(g, self.w1p)[None] + self.b1)
        return op.dot(z, self.w2) + self.b2

    def lattice(self, f: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
        """The logits at every (frame, tokens consumed) of one utterance's
        alignment lattice, (T2, K + 1, V) float32."""
        t = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        return self.logits(self.fproj(f), self.prediction(t))

    def greedy(self, f: torch.Tensor, cap: int, max_len: int) -> np.ndarray:
        """Greedy transducer decode of one utterance: at most ``cap`` symbols
        a frame, the first maximum, at most ``max_len`` symbols kept."""
        fp = self.fproj(f)
        state = self._zero_state(1)
        prev = torch.tensor([-1], device=self.device)
        g, new = self._pred_step(prev, state)
        out: List[int] = []
        for t in range(f.shape[0]):
            for _ in range(cap):
                k = int(torch.argmax(self.logits(fp[t : t + 1], g)[0, 0]))
                if k == self.blank:
                    break
                out.append(k)
                state, prev = new, torch.tensor([k], device=self.device)
                g, new = self._pred_step(prev, state)
        return np.asarray(out[:max_len], np.int64)


def _to(weights: dict, device) -> dict:
    if isinstance(weights, torch.Tensor):
        return weights.to(device=device, dtype=torch.float32)
    if isinstance(weights, dict):
        return {k: _to(v, device) for k, v in weights.items()}
    return type(weights)(_to(v, device) for v in weights)

"""Pure-Python FLAC codec, numpy only (the port's copy of
rnnt_inference_tpu/data/flac.py).

LibriSpeech ships as FLAC; the reference decodes it through sox/soundfile
(datasets/process_librispeech.py:31-97, parts/segment.py:29-60).  This
module needs no external codec: a self-contained implementation of the
FLAC format (RFC 9639):

- decoder: everything LibriSpeech (and flac(1) defaults) produce — constant /
  verbatim / fixed(0-4) / LPC(1-32) subframes, Rice + Rice2 residuals with
  escape partitions, wasted bits, all four channel assignments (independent,
  left/side, right/side, mid/side), 8-32 bit samples, frame CRC-8/CRC-16
  verification.
- encoder: a correct (not maximally compressing) subset used by the
  round-trip tests and good enough to write valid .flac: constant / verbatim
  / fixed(0-2) subframes, single-partition Rice with escape fallback,
  optional wasted-bit packing, independent channels.  Its bytes equal the
  JAX package's encoder's.

Pure Python is ~1-2 s per minute of 16 kHz mono audio — fine for the
one-shot dataset conversion this exists for (parallelize across files with
--workers in tools/convert_librispeech.py if needed).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["decode_flac", "load_flac", "encode_flac"]


# ---------------------------------------------------------------------------
# CRC tables (CRC-8 poly 0x07, CRC-16 poly 0x8005, both init 0)
# ---------------------------------------------------------------------------


def _make_crc8_table():
    tab = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = ((c << 1) ^ 0x07 if c & 0x80 else c << 1) & 0xFF
        tab.append(c)
    return tab


def _make_crc16_table():
    tab = []
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ 0x8005 if c & 0x8000 else c << 1) & 0xFFFF
        tab.append(c)
    return tab


_CRC8 = _make_crc8_table()
_CRC16 = _make_crc16_table()


def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8[c ^ b]
    return c


def _crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC16[((c >> 8) ^ b) & 0xFF] ^ ((c << 8) & 0xFFFF)
    return c


# ---------------------------------------------------------------------------
# Bit IO
# ---------------------------------------------------------------------------


class _BitReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, bytepos: int = 0):
        self.data = data
        self.pos = bytepos << 3  # bit position

    def read(self, n: int) -> int:
        """Read n bits MSB-first as an unsigned int."""
        if n == 0:
            return 0
        p = self.pos
        end = p + n
        chunk = int.from_bytes(self.data[p >> 3 : (end + 7) >> 3], "big")
        self.pos = end
        return (chunk >> ((((end + 7) >> 3) << 3) - end)) & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if n and v >= (1 << (n - 1)) else v

    def unary(self) -> int:
        """Count 0 bits until (and consuming) the terminating 1 bit."""
        d = self.data
        p = self.pos
        n = 0
        while True:
            byte = d[p >> 3] & (0xFF >> (p & 7))
            if byte:
                first = 8 - byte.bit_length()  # bit index of first set bit
                n += first - (p & 7)
                self.pos = (p & ~7) + first + 1
                return n
            n += 8 - (p & 7)
            p = (p & ~7) + 8

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    @property
    def bytepos(self) -> int:
        return self.pos >> 3

    def eof(self, margin_bits: int = 0) -> bool:
        return self.pos + margin_bits > 8 * len(self.data)


class _BitWriter:
    __slots__ = ("buf", "acc", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_signed(self, value: int, n: int) -> None:
        self.write(value & ((1 << n) - 1), n)

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def getvalue(self) -> bytes:
        assert self.nbits == 0, "unaligned"
        return bytes(self.buf)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

_BLOCKSIZE_CODE = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384,
    15: 32768,
}

_SAMPLE_SIZE_CODE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_SAMPLE_RATE_CODE = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}


def _read_utf8_number(br: _BitReader) -> int:
    first = br.read(8)
    if first < 0x80:
        return first
    n_extra = 0
    mask = 0x40
    while first & mask:
        n_extra += 1
        mask >>= 1
    v = first & (mask - 1) if mask > 1 else 0
    for _ in range(n_extra):
        cont = br.read(8)
        if cont & 0xC0 != 0x80:
            raise ValueError("bad UTF-8-coded frame number")
        v = (v << 6) | (cont & 0x3F)
    return v


def _decode_residual(br: _BitReader, block_size: int, order: int) -> List[int]:
    method = br.read(2)
    if method > 1:
        raise ValueError(f"reserved residual method {method}")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    part_order = br.read(4)
    n_parts = 1 << part_order
    part_len = block_size >> part_order
    if part_len << part_order != block_size:
        raise ValueError("bad rice partition order")
    res: List[int] = []
    read, unary = br.read, br.unary
    for p in range(n_parts):
        n = part_len - order if p == 0 else part_len
        k = read(pbits)
        if k == escape:
            nbits = br.read(5)
            if nbits == 0:
                res.extend([0] * n)
            else:
                sign = 1 << (nbits - 1)
                full = 1 << nbits
                for _ in range(n):
                    v = read(nbits)
                    res.append(v - full if v >= sign else v)
        else:
            for _ in range(n):
                q = unary()
                v = (q << k) | read(k)
                res.append((v >> 1) ^ -(v & 1))  # zigzag
    return res


_FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read(1) != 0:
        raise ValueError("bad subframe padding bit")
    ftype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.unary() + 1
    bps -= wasted

    if ftype == 0:  # constant
        v = br.read_signed(bps)
        out = np.full(block_size, v, np.int64)
    elif ftype == 1:  # verbatim
        out = np.array([br.read_signed(bps) for _ in range(block_size)], np.int64)
    elif 8 <= ftype <= 12:  # fixed, order 0-4
        order = ftype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        coefs = _FIXED_COEFS[order]
        out_l = warm + [0] * (block_size - order)
        for i in range(order, block_size):
            acc = res[i - order]
            for j, c in enumerate(coefs):
                acc += c * out_l[i - 1 - j]
            out_l[i] = acc
        out = np.array(out_l, np.int64)
    elif ftype >= 32:  # LPC, order 1-32
        order = ftype - 31
        warm = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("invalid LPC precision code 1111")
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coefs = [br.read_signed(precision) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        out_l = warm + [0] * (block_size - order)
        for i in range(order, block_size):
            acc = 0
            for j in range(order):
                acc += coefs[j] * out_l[i - 1 - j]
            out_l[i] = res[i - order] + (acc >> shift)
        out = np.array(out_l, np.int64)
    else:
        raise ValueError(f"reserved subframe type {ftype}")

    if wasted:
        out <<= wasted
    return out


def _decode_frame(
    br: _BitReader, stream_sr: int, stream_bps: int, verify_crc: bool = True
) -> Tuple[np.ndarray, int]:
    """Decode one frame -> (samples {block_size, channels} int64, sr)."""
    start_byte = br.bytepos
    sync = br.read(14)
    if sync != 0x3FFE:
        raise ValueError(f"bad frame sync 0x{sync:04x}")
    if br.read(1) != 0:
        raise ValueError("bad frame reserved bit")
    br.read(1)  # blocking strategy (number semantics only)
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    if br.read(1) != 0:
        raise ValueError("bad frame reserved bit 2")
    _read_utf8_number(br)
    if bs_code == 0:
        raise ValueError("reserved block size code 0")
    elif bs_code == 6:
        block_size = br.read(8) + 1
    elif bs_code == 7:
        block_size = br.read(16) + 1
    else:
        block_size = _BLOCKSIZE_CODE[bs_code]
    if sr_code == 0:
        sr = stream_sr
    elif sr_code in _SAMPLE_RATE_CODE:
        sr = _SAMPLE_RATE_CODE[sr_code]
    elif sr_code == 12:
        sr = br.read(8) * 1000
    elif sr_code == 13:
        sr = br.read(16)
    elif sr_code == 14:
        sr = br.read(16) * 10
    else:
        raise ValueError("invalid sample rate code 1111")
    bps = stream_bps if ss_code == 0 else _SAMPLE_SIZE_CODE[ss_code]

    if verify_crc:
        header = br.data[start_byte : br.bytepos]
        if _crc8(header) != br.read(8):
            raise ValueError("frame header CRC-8 mismatch")
    else:
        br.read(8)

    if ch_code <= 7:
        channels = ch_code + 1
        subs = [
            _decode_subframe(br, block_size, bps) for _ in range(channels)
        ]
        out = np.stack(subs, axis=1)
    elif ch_code in (8, 9, 10):
        # stereo decorrelation: the side channel carries one extra bit
        if ch_code == 8:  # left/side
            left = _decode_subframe(br, block_size, bps)
            side = _decode_subframe(br, block_size, bps + 1)
            out = np.stack([left, left - side], axis=1)
        elif ch_code == 9:  # right/side
            side = _decode_subframe(br, block_size, bps + 1)
            right = _decode_subframe(br, block_size, bps)
            out = np.stack([right + side, right], axis=1)
        else:  # mid/side
            mid = _decode_subframe(br, block_size, bps)
            side = _decode_subframe(br, block_size, bps + 1)
            mid2 = (mid << 1) | (side & 1)
            out = np.stack([(mid2 + side) >> 1, (mid2 - side) >> 1], axis=1)
    else:
        raise ValueError(f"reserved channel assignment {ch_code}")

    br.align()
    if verify_crc:
        frame_bytes = br.data[start_byte : br.bytepos]
        if _crc16(frame_bytes) != br.read(16):
            raise ValueError("frame CRC-16 mismatch")
    else:
        br.read(16)
    return out, sr


def decode_flac(data: bytes, verify_crc: bool = True) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC stream -> (samples {n, channels} int32, sample_rate, bps)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream (missing fLaC marker)")
    pos = 4
    sr = bps = channels = None
    total = None
    while True:
        hdr = data[pos]
        btype = hdr & 0x7F
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        if btype == 0:  # STREAMINFO
            si = data[pos + 4 : pos + 4 + length]
            bits = int.from_bytes(si[10:18], "big")
            sr = (bits >> 44) & 0xFFFFF
            channels = ((bits >> 41) & 0x7) + 1
            bps = ((bits >> 36) & 0x1F) + 1
            total = bits & ((1 << 36) - 1)
        pos += 4 + length
        if hdr & 0x80:
            break
    if sr is None:
        raise ValueError("missing STREAMINFO")

    br = _BitReader(data, pos)
    frames = []
    n_out = 0
    while not br.eof(margin_bits=16) and (total == 0 or total is None or n_out < total):
        out, _fsr = _decode_frame(br, sr, bps, verify_crc)
        frames.append(out)
        n_out += out.shape[0]
    samples = (
        np.concatenate(frames, axis=0)
        if frames
        else np.zeros((0, channels or 1), np.int64)
    )
    if total:
        samples = samples[:total]
    return samples.astype(np.int32), sr, bps


def flac_stream_info(path: str) -> Tuple[int, int]:
    """Read only the STREAMINFO header -> (total_samples, sample_rate).

    Cheap duration probe (a few hundred bytes of IO, no frame decode) for
    manifest building over a corpus — the full decode of 5+ hours of audio
    stays in the conversion stage where it is parallelized."""
    with open(path, "rb") as f:
        data = f.read(4 + 4 + 34)  # marker + block header + STREAMINFO
    if len(data) < 4 + 4 + 34:
        raise ValueError(
            f"truncated FLAC header in {path}: got {len(data)} bytes, "
            "need 42 (marker + block header + STREAMINFO)"
        )
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream (missing fLaC marker)")
    if data[4] & 0x7F != 0:
        raise ValueError("first metadata block is not STREAMINFO")
    si = data[8 : 8 + 34]
    bits = int.from_bytes(si[10:18], "big")
    sr = (bits >> 44) & 0xFFFFF
    total = bits & ((1 << 36) - 1)
    return total, sr


def load_flac(path: str) -> Tuple[np.ndarray, int]:
    """FLAC file -> (float32 mono samples in [-1, 1], sample_rate): the
    load_wav contract (int -> float scaling of the reference's AudioSegment,
    datasets/parts/segment.py:29-60; multi-channel is mean-mixed like
    load_wav)."""
    with open(path, "rb") as f:
        data = f.read()
    samples, sr, bps = decode_flac(data)
    x = samples.astype(np.float32) / float(1 << (bps - 1))
    if x.shape[1] > 1:
        x = x.mean(axis=1)
    else:
        x = x[:, 0]
    return x, sr


# ---------------------------------------------------------------------------
# Encoder (correct subset: constant / verbatim / fixed 0-2, independent
# channels, single Rice partition with escape fallback, wasted-bit packing)
# ---------------------------------------------------------------------------


def _write_utf8_number(bw: _BitWriter, v: int) -> None:
    """UTF-8-style coded number, general form up to 36 bits (the decoder's
    _read_utf8_number inverse; 2-byte .. 7-byte lead forms)."""
    if v < 0x80:
        bw.write(v, 8)
        return
    if v >= 1 << 36:
        # the 7-byte form carries at most 36 payload bits; encoding a larger
        # frame number would silently corrupt the lead byte — fail loudly
        raise ValueError(f"UTF-8-coded number out of range (>= 2**36): {v}")
    for n_extra in range(1, 7):
        payload_bits = 6 - n_extra + 6 * n_extra  # lead bits + continuations
        if v < (1 << payload_bits):
            break
    lead_mask = (0xFF << (7 - n_extra)) & 0xFF  # n_extra+1 ones then a zero
    bw.write(lead_mask | (v >> (6 * n_extra)), 8)
    for i in range(n_extra - 1, -1, -1):
        bw.write(0x80 | ((v >> (6 * i)) & 0x3F), 8)


def _rice_cost(res: np.ndarray, k: int) -> int:
    z = (np.abs(res.astype(np.int64)) << 1) - (res < 0)
    return int(np.sum(z >> k)) + len(res) * (k + 1)


def _best_rice_k(res: np.ndarray, pbits: int) -> int:
    if len(res) == 0:
        return 0
    mean = float(np.mean(np.abs(res.astype(np.float64)))) + 1e-9
    k0 = max(0, int(np.log2(mean)) - 1)
    best_k, best_c = 0, None
    for k in range(max(0, k0 - 2), min((1 << pbits) - 2, k0 + 3) + 1):
        c = _rice_cost(res, k)
        if best_c is None or c < best_c:
            best_k, best_c = k, c
    return best_k


def _write_residual(bw: _BitWriter, res: np.ndarray, force_escape: bool) -> None:
    bw.write(0, 2)  # 4-bit rice params
    bw.write(0, 4)  # partition order 0 -> one partition
    if force_escape:
        nbits = int(max(1, np.max(np.abs(res.astype(np.int64))) + 1)).bit_length() + 1
        assert nbits <= 31, "residuals exceed escape capacity (use verbatim)"
        bw.write(0xF, 4)
        bw.write(nbits, 5)
        for v in res:
            bw.write_signed(int(v), nbits)
        return
    k = _best_rice_k(res, 4)
    bw.write(k, 4)
    for v in res:
        v = int(v)
        z = (abs(v) << 1) - (1 if v < 0 else 0)  # zigzag
        bw.write_unary(z >> k)
        bw.write(z & ((1 << k) - 1), k)


def _encode_subframe(
    bw: _BitWriter, x: np.ndarray, bps: int, force_escape: bool
) -> None:
    x = x.astype(np.int64)
    # wasted bits: all samples share k low zero bits
    wasted = 0
    orred = int(np.bitwise_or.reduce(x)) if len(x) else 0
    if orred != 0:
        wasted = (orred & -orred).bit_length() - 1
    if wasted:
        x = x >> wasted
    sbps = bps - wasted

    def header(ftype: int) -> None:
        bw.write(0, 1)
        bw.write(ftype, 6)
        if wasted:
            bw.write(1, 1)
            bw.write_unary(wasted - 1)
        else:
            bw.write(0, 1)

    if len(x) and np.all(x == x[0]):
        header(0)
        bw.write_signed(int(x[0]), sbps)
        return
    # pick fixed order 0-2 by residual magnitude (residual = x with the
    # fixed predictor subtracted; order-k residual has len(x)-k entries)
    candidates = {0: x}
    if len(x) > 1:
        candidates[1] = x[1:] - x[:-1]
    if len(x) > 2:
        candidates[2] = x[2:] - 2 * x[1:-1] + x[:-2]
    order, res = min(
        candidates.items(), key=lambda kv: float(np.sum(np.abs(kv[1])))
    )
    # rice/escape can't express residuals beyond the 31-bit escape field
    # (reachable at bps=32: order-2 residuals reach ~4x the sample range);
    # verbatim keeps the encoder always-correct
    if len(res) and int(np.max(np.abs(res.astype(np.int64)))) >= (1 << 30):
        header(1)
        for v in x:
            bw.write_signed(int(v), sbps)
        return
    header(8 + order)
    for v in x[:order]:
        bw.write_signed(int(v), sbps)
    _write_residual(bw, res, force_escape)


def encode_flac(
    samples: np.ndarray,
    sample_rate: int,
    bps: int = 16,
    block_size: int = 4096,
    force_escape: bool = False,
) -> bytes:
    """Encode int samples {n} or {n, channels} into a valid FLAC stream."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    n, channels = x.shape
    assert channels <= 8
    lim = 1 << (bps - 1)
    assert np.all(x < lim) and np.all(x >= -lim), "samples exceed bps range"

    out = bytearray(b"fLaC")
    # STREAMINFO (last metadata block)
    si = struct.pack(">HH", block_size, block_size) + b"\x00" * 6
    bits = (sample_rate << 44) | ((channels - 1) << 41) | ((bps - 1) << 36) | n
    si += bits.to_bytes(8, "big") + b"\x00" * 16  # md5 unknown
    out += bytes([0x80]) + len(si).to_bytes(3, "big") + si

    frame_no = 0
    for start in range(0, max(n, 1), block_size):
        blk = x[start : start + block_size]
        bsz = blk.shape[0]
        if bsz == 0:
            break
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)  # fixed blocking
        bw.write(7, 4)  # 16-bit block size at header end
        bw.write(0, 4)  # sample rate from STREAMINFO
        bw.write(channels - 1, 4)  # independent channels
        bw.write({8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps], 3)
        bw.write(0, 1)
        _write_utf8_number(bw, frame_no)
        bw.write(bsz - 1, 16)
        bw.align()
        header_bytes = bw.getvalue()
        bw2 = _BitWriter()
        for b in header_bytes:
            bw2.write(b, 8)
        bw2.write(_crc8(header_bytes), 8)
        for ch in range(channels):
            _encode_subframe(bw2, blk[:, ch], bps, force_escape)
        bw2.align()
        frame_wo_crc = bw2.getvalue()
        out += frame_wo_crc + _crc16(frame_wo_crc).to_bytes(2, "big")
        frame_no += 1
    return bytes(out)

"""The port's copy of data/flac.py against the JAX package's on the inputs
of tests/test_flac.py: encoder bytes, decodes, the decoder-only paths of
its handcrafted frames, STREAMINFO probing and load_flac / load_audio.

Tolerance: bytes and samples equal.
"""

import importlib.util
import os

import numpy as np
import pytest

from rnnt_inference_tpu.data import audio as jaudio
from rnnt_inference_tpu.data import flac as jflac
from rnnt_inference_tpu_torch.data import audio as taudio
from rnnt_inference_tpu_torch.data import flac as tflac

HERE = os.path.dirname(os.path.abspath(__file__))


def _signals():
    rng = np.random.RandomState(0)
    speech = np.clip(np.cumsum(rng.randint(-80, 81, size=30000)), -32768, 32767)
    out = {f"random_{n}": np.random.RandomState(n).randint(-32768, 32768, size=n)
           for n in (1, 100, 4096, 5000, 13001)}
    out.update(
        speechlike=speech,
        zeros=np.zeros(9000),
        constant=np.full(5000, -1234),
        stereo=np.random.RandomState(1).randint(-4000, 4000, size=(7000, 2)),
        wasted_bits=np.random.RandomState(3).randint(-2000, 2000, size=4096) << 3,
    )
    return {k: np.asarray(v).astype(np.int32) for k, v in out.items()}


@pytest.mark.parametrize("name", sorted(_signals()))
@pytest.mark.parametrize("force_escape", [False, True])
def test_encode_bytes_and_decode_match_jax(name, force_escape):
    x = _signals()[name]
    data = tflac.encode_flac(x, 16000, force_escape=force_escape)
    assert data == jflac.encode_flac(x, 16000, force_escape=force_escape)
    got, want = tflac.decode_flac(data), jflac.decode_flac(data)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0].reshape(x.shape), x)


def _jax_flac_tests():
    """tests/test_flac.py as a module, to run its handcrafted frames
    (LPC, stereo decorrelation, multi-partition residuals, table block
    sizes: paths the encoder never writes) through the port's decoder."""
    spec = importlib.util.spec_from_file_location("jax_flac_cases",
                                                  os.path.join(HERE, "test_flac.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case,args", [
    ("test_decoder_lpc_subframe", ()),
    ("test_decoder_stereo_decorrelation", ("left_side",)),
    ("test_decoder_stereo_decorrelation", ("right_side",)),
    ("test_decoder_stereo_decorrelation", ("mid_side",)),
    ("test_decoder_multi_partition_residual", ()),
    ("test_decoder_table_blocksize_code", ()),
])
def test_port_decoder_on_handcrafted_frames(monkeypatch, case, args):
    mod = _jax_flac_tests()
    monkeypatch.setattr(mod, "decode_flac", tflac.decode_flac)
    getattr(mod, case)(*args)


def test_crc_corruption_raises():
    data = bytearray(tflac.encode_flac(np.arange(-500, 500, dtype=np.int32), 16000))
    data[-10] ^= 0x40
    with pytest.raises(ValueError):
        tflac.decode_flac(bytes(data))


def test_bit_io_and_utf8_numbers():
    values = [0, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000, 0x1FFFFF, 0x200000, 0x3FFFFFF,
              0x4000000, (1 << 36) - 1]
    bw = tflac._BitWriter()
    for v in values:
        tflac._write_utf8_number(bw, v)
    jw = jflac._BitWriter()
    for v in values:
        jflac._write_utf8_number(jw, v)
    assert bw.getvalue() == jw.getvalue()
    br = tflac._BitReader(bw.getvalue())
    assert [tflac._read_utf8_number(br) for _ in values] == values
    bw = tflac._BitWriter()
    for n in (0, 13, 40, 7):
        bw.write_unary(n)
    bw.align()
    br = tflac._BitReader(bw.getvalue())
    assert [br.unary() for _ in range(4)] == [0, 13, 40, 7]


def test_stream_info_load_flac_and_load_audio_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    x = rng.randint(-10000, 10000, size=16000).astype(np.int32)
    p = tmp_path / "u.flac"
    p.write_bytes(tflac.encode_flac(x, 16000))
    assert tflac.flac_stream_info(str(p)) == jflac.flac_stream_info(str(p)) == (16000, 16000)
    got, want = tflac.load_flac(str(p)), jflac.load_flac(str(p))
    assert got[1] == want[1] and got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    a, b = taudio.load_audio(str(p)), jaudio.load_audio(str(p))
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    bad = tmp_path / "bad.flac"
    bad.write_bytes(b"RIFFxxxx")
    with pytest.raises(ValueError):
        tflac.flac_stream_info(str(bad))

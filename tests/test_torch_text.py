"""The port's transcript normalization and manifest parsing
(data/text.py, data/manifest.py) against the JAX package's on fixed
inputs.

Tolerance: strings, token lists and durations equal.
"""

import json

import pytest

from rnnt_inference_tpu.data import manifest as jmanifest
from rnnt_inference_tpu.data import text as jtext
from rnnt_inference_tpu_torch.data import manifest as tmanifest
from rnnt_inference_tpu_torch.data import text as ttext

STRINGS = [
    "HELLO WORLD",
    "It's 10:30 and Dr. Smith paid $12.50 for 3 apples.",
    "The 21st century began in 2001; the 1990s ended in 1999.",
    "Mr. & Mrs. Jones live at 1,234 St. James St., apt 007.",
    "£3,000 + $1 + $0.01 + $1.2.3 + $ and 0.5 of 100%",
    "Café naïve coöperate — «quoted» “smart” ‘quotes’",
    "1st 2nd 3rd 4th 11th 12th 13th 22nd 101st 1000th 40th",
    "at 3:00 or 12:05, in 1800, 1905, 2000, 2005, 2100 and 999999",
    "Lt. Col. Gen. Capt. Sgt. Maj. Ft. Hon. Rev. Esq. Ltd. Co. Jr.",
    "  multiple   spaces\tand\nnewlines  ",
    "",
]


@pytest.mark.parametrize("fn", ["normalize_transcript", "english_cleaners",
                                "normalize_numbers", "convert_to_ascii"])
def test_text_functions_match_jax(fn):
    for s in STRINGS:
        assert getattr(ttext, fn)(s) == getattr(jtext, fn)(s), s


def test_number_spellout_matches_jax():
    for n in list(range(0, 130)) + [999, 1000, 1001, 1984, 2000, 2007, 10 ** 6, 123456789012]:
        assert ttext.number_to_words(n) == jtext.number_to_words(n)
        if n:
            assert ttext.ordinal_to_words(n) == jtext.ordinal_to_words(n)
    assert ttext.normalize_transcript("A-b!", labels=list("ab ")) == \
        jtext.normalize_transcript("A-b!", labels=list("ab "))


@pytest.fixture
def manifest_file(tmp_path):
    items = [
        {"audio_filepath": "a.wav", "duration": 3.0, "transcript": "HELLO WORLD"},
        {"files": [{"fname": "b.flac"}], "original_duration": 20.0, "duration": 1.0,
         "transcript": "Too long, by the original duration"},
        {"files": [{"fname": "c.flac"}, {"fname": "c2.wav"}], "duration": 0.2,
         "transcript": "too short"},
        {"duration": 7.5, "transcript": "Dr. Who paid $5 at 10:30."},
        {"audio_filepath": "e.wav", "duration": 15.0, "transcript": "the 3rd one"},
    ]
    path = tmp_path / "m.json"
    path.write_text(json.dumps(items))
    return str(path)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(max_duration=15.0),
    dict(min_duration=0.5, max_duration=10.0),
    dict(max_utts=2, data_dir="/data"),
    dict(normalize=False, data_dir="x"),
    dict(labels=list("abcdefg ")),
])
def test_manifest_matches_jax(manifest_file, kw):
    t = tmanifest.Manifest([manifest_file, manifest_file], **kw)
    j = jmanifest.Manifest([manifest_file, manifest_file], **kw)
    assert list(t) == list(j) and len(t) == len(j)
    assert t.transcripts == j.transcripts
    assert (t.duration, t.filtered_duration) == (j.duration, j.filtered_duration)

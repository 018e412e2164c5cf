"""English text normalization for transcripts (the port's copy of
rnnt_inference_tpu/data/text.py).

Same normalization surface as the reference's Tacotron-derived cleaners
(reference: datasets/parts/text/cleaners.py, numbers.py, manifest.py:22-47):
ascii transliteration, lowercasing, number/time/currency expansion,
abbreviation expansion, punctuation removal, whitespace collapse, and
filtering to the model alphabet.  Implemented without inflect/unidecode:
number spellout and NFKD-based transliteration are self-contained below.

For LibriSpeech (the reference's corpus) transcripts are already plain
uppercase letters + apostrophes, so in practice this pipeline mostly
lowercases — but the full surface is kept for parity.
"""

from __future__ import annotations

import re
import string
import unicodedata
from typing import List, Optional

from rnnt_inference_tpu_torch.utils.labels import LABELS

# ---------------------------------------------------------------------------
# Number spellout (standard US English, no 'and')
# ---------------------------------------------------------------------------

_UNITS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = ["", " thousand", " million", " billion", " trillion"]


def _three_digits(n: int) -> str:
    out = []
    if n >= 100:
        out.append(_UNITS[n // 100] + " hundred")
        n %= 100
    if n >= 20:
        t = _TENS[n // 10]
        if n % 10:
            t += "-" + _UNITS[n % 10]
        out.append(t)
    elif n > 0:
        out.append(_UNITS[n])
    return " ".join(out)


def number_to_words(n: int) -> str:
    """Spell out a non-negative integer ('1234' -> 'one thousand two hundred
    thirty-four')."""
    if n == 0:
        return "zero"
    groups = []
    i = 0
    while n > 0 and i < len(_SCALES):
        g = n % 1000
        if g:
            groups.append(_three_digits(g) + _SCALES[i])
        n //= 1000
        i += 1
    return " ".join(reversed(groups))


def _digits_to_words(s: str) -> str:
    """Digit-by-digit spellout with 'oh' for zero ('007' -> 'oh oh seven')."""
    return " ".join("oh" if c == "0" else _UNITS[int(c)] for c in s)


_ORDINAL_UNITS = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    parts = words.rsplit(" ", 1)
    last = parts[-1]
    if "-" in last:
        head, unit = last.rsplit("-", 1)
        unit = _ORDINAL_UNITS.get(unit, unit + "th")
        last = head + "-" + unit
    elif last in _ORDINAL_UNITS:
        last = _ORDINAL_UNITS[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    parts[-1] = last
    return " ".join(parts)


# ---------------------------------------------------------------------------
# Cleaner pipeline (reference: cleaners.py english_cleaners)
# ---------------------------------------------------------------------------

_whitespace_re = re.compile(r"\s+")
_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")
_time_re = re.compile(r"([0-9]{1,2}):([0-9]{2})")

_ABBREVIATIONS = [
    ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
    ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
    ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
    ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
    ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
]
_abbrev_res = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full) for abbr, full in _ABBREVIATIONS
]


def convert_to_ascii(text: str) -> str:
    """NFKD transliteration: strip combining marks, drop non-ascii."""
    norm = unicodedata.normalize("NFKD", text)
    return "".join(c for c in norm if ord(c) < 128 and not unicodedata.combining(c))


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        du = "dollar" if dollars == 1 else "dollars"
        cu = "cent" if cents == 1 else "cents"
        return f"{dollars} {du}, {cents} {cu}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_number(m: re.Match) -> str:
    s = m.group(0)
    if s[0] == "0":
        return _digits_to_words(s)
    num = int(s)
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        # year-style pairs: 1984 -> nineteen eighty-four
        hi, lo = divmod(num, 100)
        lo_words = "oh " + _UNITS[lo] if 0 < lo < 10 else (
            number_to_words(lo) if lo else "hundred"
        )
        return f"{number_to_words(hi)} {lo_words}"
    return number_to_words(num)


def _expand_time(m: re.Match) -> str:
    mins = int(m.group(2))
    if mins == 0:
        return number_to_words(int(m.group(1)))
    return f"{number_to_words(int(m.group(1)))} {number_to_words(mins)}"


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(lambda m: m.group(1).replace(".", " point "), text)
    text = _ordinal_re.sub(lambda m: ordinal_to_words(int(m.group(0)[:-2])), text)
    text = _time_re.sub(_expand_time, text)
    text = _number_re.sub(_expand_number, text)
    return text


# Punctuation (minus +, & and alphabet chars like ') maps to SPACE
# (reference: datasets/parts/manifest.py:74-90); & and + expand to words after
# (reference: cleaners.py remove_punctuation).
_punct = string.punctuation.replace("+", "").replace("&", "").replace("'", "")
_PUNCT_TABLE = str.maketrans(_punct, " " * len(_punct))


def english_cleaners(text: str) -> str:
    text = convert_to_ascii(text)
    text = text.lower()
    text = normalize_numbers(text)
    for regex, replacement in _abbrev_res:
        text = regex.sub(replacement, text)
    text = text.translate(_PUNCT_TABLE)
    text = re.sub(r"&", " and ", text)
    text = re.sub(r"\+", " plus ", text)
    text = _whitespace_re.sub(" ", text)
    return text


def normalize_transcript(s: str, labels: Optional[List[str]] = None) -> str:
    """Full transcript normalization + alphabet filter
    (reference: datasets/parts/manifest.py:22-47 normalize_string)."""
    alphabet = set(labels if labels is not None else LABELS)
    text = english_cleaners(s).strip()
    return "".join(c for c in text if c in alphabet)

"""LibriSpeech download, md5 check and extraction (counterpart of
rnnt_inference_tpu/data/download.py; reference:
datasets/download_librispeech.py).

    python -m rnnt_inference_tpu_torch.data.download --download_dir work/LibriSpeech \\
        --subsets dev-clean train-clean-100

Fetches with the standard library's ``urllib.request`` (60 s timeout, 1 MiB
chunks), so it needs no package beyond Python's own.  A fetch lands in
``<dest>.part`` and takes the name ``dest`` only once its md5 matches, so an
interrupted or corrupt fetch never leaves a file at ``dest``.  In an image
with no network, place the tarballs at ``<download_dir>/<subset>.tar.gz``:
a file whose md5 matches is kept and nothing is fetched.
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import os
import tarfile
import urllib.request
from typing import List, Optional

# subset, url, md5  (reference: configs/librispeech-inference.csv)
LIBRISPEECH_SETS = [
    (
        "dev-clean",
        "http://www.openslr.org/resources/12/dev-clean.tar.gz",
        "42e2234ba48799c1f50f24a7926300a1",
    ),
    (
        "train-clean-100",
        "http://www.openslr.org/resources/12/train-clean-100.tar.gz",
        "2a93770f6d5c6c964bc36631d331a522",
    ),
]

CHUNK = 1 << 20
TIMEOUT_S = 60


def md5_checksum(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def download_file(url: str, dest: str, expected_md5: Optional[str] = None) -> str:
    """Fetch ``url`` to ``dest`` unless a file there already has
    ``expected_md5`` (or any file is there and no md5 is given).  Raises
    ``IOError`` when the fetched file's md5 differs, and whatever urllib
    raises when the fetch fails; either way nothing is left at ``dest``."""
    if os.path.exists(dest) and (expected_md5 is None or md5_checksum(dest) == expected_md5):
        return dest
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    part = dest + ".part"
    try:
        with urllib.request.urlopen(url, timeout=TIMEOUT_S) as r, open(part, "wb") as f:
            for chunk in iter(lambda: r.read(CHUNK), b""):
                f.write(chunk)
        if expected_md5 is not None:
            got = md5_checksum(part)
            if got != expected_md5:
                raise IOError(f"md5 mismatch for {dest}: {got} != {expected_md5}")
        os.replace(part, dest)
    finally:
        if os.path.exists(part):
            os.remove(part)
    return dest


def extract(tar_path: str, dest_dir: str) -> None:
    """Unpack under ``dest_dir`` with tarfile's "data" filter: a member
    that would land outside ``dest_dir`` (``..``, or a link out of it) or a
    device file raises; a leading ``/`` is stripped, so an absolute member
    lands inside ``dest_dir``."""
    os.makedirs(dest_dir, exist_ok=True)
    with tarfile.open(tar_path) as t:
        t.extractall(dest_dir, filter="data")


def download_librispeech(
    dest_dir: str, subsets: Optional[List[str]] = None, csv_path: Optional[str] = None
) -> None:
    """Fetch, verify and extract the inference subsets
    (reference: download_librispeech.py:56-120)."""
    sets = LIBRISPEECH_SETS
    if csv_path:
        with open(csv_path) as f:
            sets = [(r[0], r[1], r[2]) for r in csv.reader(f) if r]
    for name, url, md5 in sets:
        if subsets and name not in subsets:
            continue
        tar = download_file(url, os.path.join(dest_dir, f"{name}.tar.gz"), md5)
        extract(tar, dest_dir)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("download_librispeech")
    p.add_argument("--download_dir", required=True,
                   help="where tarballs land and subsets are extracted")
    p.add_argument("--subsets", nargs="*", default=None,
                   help="subset names (default: all in the CSV/built-ins)")
    p.add_argument("--input_csv", default=None,
                   help="subset,url,md5 CSV (reference configs/librispeech-inference.csv)")
    args = p.parse_args(argv)
    os.makedirs(args.download_dir, exist_ok=True)
    download_librispeech(args.download_dir, args.subsets, args.input_csv)


if __name__ == "__main__":
    main()

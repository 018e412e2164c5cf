"""The port's LibriSpeech download module (rnnt_inference_tpu_torch/
data/download.py) against the JAX package's (rnnt_inference_tpu/data/
download.py), on the CPU, with no network: every fetch goes to a
ThreadingHTTPServer on 127.0.0.1 that counts the requests for each path.

The JAX module fetches with ``requests``; its cases skip where that is not
installed.  The port's uses urllib from the standard library.

Tolerance: none.  The extracted trees are equal file for file and byte for
byte, md5s are equal, and a bad md5 or a bad tarball is refused with the
same exception in both packages.
"""

import collections
import hashlib
import http.server
import io
import os
import tarfile
import threading
from pathlib import Path

import numpy as np
import pytest

from rnnt_inference_tpu.data import download as jdownload
from rnnt_inference_tpu_torch.data import download
from rnnt_inference_tpu_torch.data.flac import encode_flac

WORDS = "HE SAID THE QUIET RIVER RAN UNDER SEVEN BRIGHT STONES".split()


class Loopback:
    """Serves ``root`` on 127.0.0.1 (a free port), in a thread; counts GET
    requests by path."""

    def __init__(self, root):
        self.requests = collections.Counter()
        lock, counts = threading.Lock(), self.requests

        class Handler(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **k):
                super().__init__(*a, directory=str(root), **k)

            def do_GET(self):
                with lock:
                    counts[self.path] += 1
                super().do_GET()

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def url(self, name: str) -> str:
        return f"http://127.0.0.1:{self.server.server_address[1]}/{name}"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture(autouse=True)
def _loopback_only(monkeypatch):
    """No proxy from the environment may take a loopback fetch off the host."""
    for k in ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY", "all_proxy",
              "ALL_PROXY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("no_proxy", "*")
    monkeypatch.setenv("NO_PROXY", "*")


def write_subset(root, subset: str, n: int, seed: int, seconds=(0.2, 0.5)) -> dict:
    """A LibriSpeech-layout subset as ``root/<subset>.tar.gz``: members
    ``LibriSpeech/<subset>/<spk>/<chap>/<spk>-<chap>-<utt>.flac`` (seeded
    16-bit noise) and one ``<spk>-<chap>.trans.txt`` per chapter.  Returns
    {utterance id: (int16 samples, transcript)}."""
    rng = np.random.RandomState(seed)
    utts, chapters = {}, collections.defaultdict(list)
    for i in range(n):
        spk, chap = 100 + seed * 10 + i % 2, 2000 + i % 2
        uid = f"{spk}-{chap}-{i:04d}"
        x = (rng.randn(int(rng.uniform(*seconds) * 16000)) * 3000).astype(np.int16)
        text = " ".join(rng.choice(WORDS, size=rng.randint(2, 6)))
        utts[uid] = (x, text)
        chapters[(spk, chap)].append(uid)
    with tarfile.open(os.path.join(root, f"{subset}.tar.gz"), "w:gz") as t:
        for (spk, chap), ids in sorted(chapters.items()):
            d = f"LibriSpeech/{subset}/{spk}/{chap}"
            trans = "".join(f"{u} {utts[u][1]}\n" for u in ids).encode()
            for name, data in [(f"{d}/{spk}-{chap}.trans.txt", trans)] + [
                    (f"{d}/{u}.flac", encode_flac(utts[u][0], 16000)) for u in ids]:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                t.addfile(info, io.BytesIO(data))
    return utts


def tree(root) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture
def served(tmp_path):
    """Two subsets, a CSV naming them at their loopback URLs with their
    md5s, and the server."""
    src = tmp_path / "src"
    src.mkdir()
    write_subset(src, "dev-clean", 4, seed=1)
    write_subset(src, "train-clean-100", 3, seed=2)
    with Loopback(src) as srv:
        rows = [(s, srv.url(f"{s}.tar.gz"), download.md5_checksum(str(src / f"{s}.tar.gz")))
                for s in ("dev-clean", "train-clean-100")]
        csv_path = tmp_path / "sets.csv"
        csv_path.write_text("".join(f"{s},{u},{m}\n" for s, u, m in rows))
        yield srv, rows, str(csv_path)


def _packages():
    """(name, module) pairs: the port, and the JAX one where requests imports."""
    return [("port", download), ("jax", jdownload)]


def _need(name):
    if name == "jax":
        pytest.importorskip("requests")


def test_default_sets_match_jax():
    assert download.LIBRISPEECH_SETS == jdownload.LIBRISPEECH_SETS


@pytest.mark.parametrize("size", [0, 1, (1 << 20) - 1, 1 << 20, (5 << 19) + 7])
def test_md5_checksum_matches_jax(tmp_path, size):
    """Equal to the JAX package's and to hashlib's over the whole file, at
    sizes around the 1 MiB read."""
    data = np.random.RandomState(size % 97).bytes(size)
    p = tmp_path / "f.bin"
    p.write_bytes(data)
    want = hashlib.md5(data).hexdigest()
    assert download.md5_checksum(str(p)) == jdownload.md5_checksum(str(p)) == want


def test_trees_match_jax(tmp_path, served):
    """The same seeded tarballs and CSV: both packages fetch each tarball
    once and extract the same tree, file for file and byte for byte."""
    pytest.importorskip("requests")
    srv, rows, csv_path = served
    for name, mod in _packages():
        mod.main(["--download_dir", str(tmp_path / name), "--input_csv", csv_path])
    port, jax_tree = tree(tmp_path / "port"), tree(tmp_path / "jax")
    assert port == jax_tree
    assert {k for k in port if k.endswith(".flac")} and "dev-clean.tar.gz" in port
    assert srv.requests == {f"/{s}.tar.gz": 2 for s, _, _ in rows}


@pytest.mark.parametrize("name", ["port", "jax"])
def test_present_file_makes_no_request(tmp_path, served, name):
    """A file at dest with the expected md5 (or any file, with no md5
    given) is kept with no request; one with another md5 is fetched anew."""
    _need(name)
    mod = dict(_packages())[name]
    srv, rows, _ = served
    subset, url, md5 = rows[0]
    dest = str(tmp_path / name / f"{subset}.tar.gz")
    assert mod.download_file(url, dest, md5) == dest
    assert srv.requests[f"/{subset}.tar.gz"] == 1
    good = Path(dest).read_bytes()
    mod.download_file(url, dest, md5)
    mod.download_file(url, dest)
    assert srv.requests[f"/{subset}.tar.gz"] == 1
    with open(dest, "wb") as f:
        f.write(b"stale")
    mod.download_file(url, dest, md5)
    assert srv.requests[f"/{subset}.tar.gz"] == 2
    assert Path(dest).read_bytes() == good


def test_md5_mismatch_raises_as_jax(tmp_path, served):
    """A fetched file whose md5 differs: IOError with the same message in
    both packages.  The port leaves nothing at dest (the JAX module leaves
    the fetched file there)."""
    pytest.importorskip("requests")
    _, rows, _ = served
    subset, url, md5 = rows[1]
    messages = {}
    for name, mod in _packages():
        dest = str(tmp_path / f"{subset}.{name}")
        with pytest.raises(IOError) as e:
            mod.download_file(url, dest, "0" * 32)
        messages[name] = str(e.value).replace(dest, "DEST")
    assert messages["port"] == messages["jax"] == f"md5 mismatch for DEST: {md5} != {'0' * 32}"
    assert not os.path.exists(tmp_path / f"{subset}.port")
    assert not os.path.exists(tmp_path / f"{subset}.port.part")


def test_failed_fetch_leaves_nothing(tmp_path, served):
    """A URL the server does not have: urllib's HTTPError (an OSError), and
    no file at dest."""
    srv, _, _ = served
    dest = tmp_path / "x.tar.gz"
    with pytest.raises(OSError, match="404"):
        download.download_file(srv.url("missing.tar.gz"), str(dest), None)
    assert not any(tmp_path.glob("x.tar.gz*"))


def _bad_tar(path, kind):
    with tarfile.open(path, "w:gz") as t:
        data = b"payload"
        if kind == "device":
            info = tarfile.TarInfo("LibriSpeech/null")
            info.type, info.devmajor, info.devminor = tarfile.CHRTYPE, 1, 3
            t.addfile(info)
            return
        name = {"dotdot": "LibriSpeech/../../escaped.txt",
                "absolute": f"{os.path.abspath(path)}.escaped.txt"}[kind]
        info = tarfile.TarInfo(name)
        info.size = len(data)
        t.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("kind,error", [("dotdot", tarfile.OutsideDestinationError),
                                        ("device", tarfile.SpecialFileError),
                                        ("absolute", None)])
def test_bad_members_handled_as_jax(tmp_path, kind, error):
    """tarfile's "data" filter in both packages: a ``..`` member that
    would land outside the destination and a device file raise the same
    error; an absolute member has its leading "/" stripped and lands
    inside the destination.  Nothing is written outside it."""
    tar = tmp_path / f"{kind}.tar.gz"
    _bad_tar(str(tar), kind)
    trees = {}
    for name, mod in _packages():
        dest = tmp_path / name / "deep"
        if error is None:
            mod.extract(str(tar), str(dest))
        else:
            with pytest.raises(error):
                mod.extract(str(tar), str(dest))
        trees[name] = tree(dest)
    assert trees["port"] == trees["jax"]
    assert not any((tmp_path / n / "escaped.txt").exists() for n in ("port", "jax"))
    assert not os.path.exists(f"{tar}.escaped.txt")
    if kind == "absolute":
        (inside,) = trees["port"]
        assert inside.endswith(".escaped.txt") and trees["port"][inside] == b"payload"


@pytest.mark.parametrize("name", ["port", "jax"])
def test_main_fetches_only_the_named_subset(tmp_path, served, name):
    """``main --subsets dev-clean --input_csv``: one request, for that
    subset, and only it extracted."""
    _need(name)
    srv, _, csv_path = served
    dict(_packages())[name].main(["--download_dir", str(tmp_path / name), "--subsets",
                                  "dev-clean", "--input_csv", csv_path])
    assert srv.requests == {"/dev-clean.tar.gz": 1}
    assert sorted(os.listdir(tmp_path / name / "LibriSpeech")) == ["dev-clean"]


def test_download_librispeech_reads_the_module_sets(tmp_path, served, monkeypatch):
    """With no CSV, the subsets come from LIBRISPEECH_SETS as the module
    holds it when called (here, pointed at the loopback server): fetched,
    md5-checked, extracted, and a second call fetches nothing."""
    srv, rows, _ = served
    monkeypatch.setattr(download, "LIBRISPEECH_SETS", rows)
    for _ in range(2):
        download.download_librispeech(str(tmp_path / "d"), ["dev-clean", "train-clean-100"])
    assert srv.requests == {f"/{s}.tar.gz": 1 for s, _, _ in rows}
    got = tree(tmp_path / "d")
    for s, _, md5 in rows:
        assert hashlib.md5(got[f"{s}.tar.gz"]).hexdigest() == md5
        assert any(k.startswith(os.path.join("LibriSpeech", s)) for k in got)

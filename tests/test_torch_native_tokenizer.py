"""The port's native C++ tokenizer (rwkv_tpu_torch/tokenizer/native.py,
csrc/tokenizer.cpp) against its Python one, over the bundled vocab written
out by assets.ensure_files (CPU; built here with g++): encode on
tests/test_native_tokenizer.py's samples, README.md and the golden cases;
decode on every id, the added tokens 50254..50276 included; load_best, the
engine's load_tokenizer(native=...), a missing compiler, concurrent builds
and concurrent encodes."""

import json
import os
import threading

import pytest

from rwkv_tpu_torch.runtime.engine import RWKV
from rwkv_tpu_torch.tokenizer import assets
from rwkv_tpu_torch.tokenizer import native
from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer, StreamDecoder
from tests.test_native_tokenizer import SAMPLES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 50277


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    return assets.ensure_files(str(tmp_path_factory.mktemp("vocab")))


@pytest.fixture(scope="module")
def ntok(vocab_dir):
    return native.NativeBPETokenizer.load(vocab_dir)


@pytest.fixture(scope="module")
def ptok():
    return BPETokenizer.load()


def _readme():
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        return f.read()


def test_vocab_size(ntok):
    assert ntok.vocab_size == VOCAB


@pytest.mark.parametrize("text", SAMPLES)
def test_encode_parity(ntok, ptok, text):
    assert ntok.encode(text) == ptok.encode(text), repr(text)
    assert ntok.decode(ntok.encode(text)) == text


def test_encode_parity_readme_and_golden(ntok, ptok):
    text = _readme()
    assert ntok.encode(text) == ptok.encode(text)
    with open(os.path.join(REPO, "tests", "fixtures", "golden_tokens.json"),
              encoding="utf-8") as f:
        golden = json.load(f)
    for case in golden["cases"]:
        assert ntok.encode(case["text"]) == case["ids"], case["text"][:40]


def test_every_id_decodes_as_the_python_tokenizer(ntok, ptok):
    """The decode fault of native/tokenizer.cpp, pinned: ids 50254..50276
    (runs of 24 down to 2 spaces) decoded to b'' there. Every id, alone and
    all in one call, decodes to the Python tokenizer's bytes."""
    for i in range(VOCAB):
        assert ntok.decode_bytes([i]) == ptok.decode_bytes([i]), i
    assert [ntok.decode_bytes([i]) for i in range(50254, VOCAB)] == \
        [b" " * n for n in range(24, 1, -1)]
    ids = list(range(VOCAB))
    assert ntok.decode_bytes(ids) == ptok.decode_bytes(ids)
    assert ntok.decode_bytes([]) == b"" and ntok.decode_bytes([VOCAB, -1]) == b""
    stream = [510, 50260, 4062, 50276, 253]
    dec = StreamDecoder(ntok)
    assert "".join(dec.feed([i]) for i in stream) + dec.flush() == ptok.decode(stream)


def test_load_best_prefers_native(vocab_dir):
    assert isinstance(native.load_best(vocab_dir), native.NativeBPETokenizer)


def test_engine_load_tokenizer(vocab_dir):
    eng = RWKV(device="cpu")
    for flag, kind in ((None, native.NativeBPETokenizer), (True, native.NativeBPETokenizer),
                       (False, BPETokenizer)):
        eng.load_tokenizer(vocab_dir, native=flag)
        assert type(eng.tokenizer) is kind
        assert eng.tokenizer.encode("Hello world") == [12092, 1533]
    eng.load_tokenizer()  # the bundled vocab, written to the default cache
    assert isinstance(eng.tokenizer, native.NativeBPETokenizer)


def test_a_missing_compiler(tmp_path, monkeypatch, vocab_dir):
    """native=True raises when the library cannot be built; None and
    load_best take the Python tokenizer."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert native._find_so() is None
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
    eng = RWKV(device="cpu")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        eng.load_tokenizer(vocab_dir, native=True)
    eng.load_tokenizer(vocab_dir)
    assert type(eng.tokenizer) is BPETokenizer
    assert type(native.load_best(vocab_dir)) is BPETokenizer
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_a_failing_compile_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ("--no-such-flag",))
    with pytest.raises(RuntimeError, match="native tokenizer build failed"):
        native.build()
    assert list((tmp_path / "build").iterdir()) == []  # no temp file left behind


def test_concurrent_builds_leave_a_loadable_library(tmp_path, monkeypatch, vocab_dir):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    start = threading.Barrier(3)
    paths, errors = [], []

    def one():
        try:
            start.wait()
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(set(paths)) == 1 and paths[0] == native._find_so()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [os.path.basename(paths[0])]
    tok = native.NativeBPETokenizer(paths[0], os.path.join(vocab_dir, "vocab.json"),
                                    os.path.join(vocab_dir, "merges.txt"))
    assert tok.encode("Hello world") == [12092, 1533]


def test_concurrent_encodes(ntok, ptok):
    """The HTTP server encodes on its handler threads: each gets its ids."""
    texts = SAMPLES * 4 + [_readme()[:4000]]
    want = [ptok.encode(t) for t in texts]
    got = [None] * len(texts)

    def run(k):
        for i in range(k, len(texts), 8):
            got[i] = ntok.encode(texts[i])

    threads = [threading.Thread(target=run, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == want


def test_ensure_files(tmp_path, ptok):
    d = assets.ensure_files(str(tmp_path / "v"))
    assert sorted(os.listdir(d)) == ["merges.txt", "vocab.json"]
    mtime = os.path.getmtime(os.path.join(d, "vocab.json"))
    assert assets.ensure_files(d) == d  # present: not written again
    assert os.path.getmtime(os.path.join(d, "vocab.json")) == mtime
    from_files = BPETokenizer.load(d)
    assert from_files.encoder == ptok.encoder
    assert from_files.encode(_readme()) == ptok.encode(_readme())


def test_missing_vocab_raises(tmp_path):
    with pytest.raises(RuntimeError, match="failed to load"):
        native.NativeBPETokenizer.load(str(tmp_path))

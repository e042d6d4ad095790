"""The port's apps (rwkv_tpu_torch/apps/) on the CPU: the 19 cases of
tests/test_apps.py with --mock --device cpu and the bundled vocab (the JAX
file needs a vocab directory this host lacks), --bf16-prefill on the server
and on vectordb, a chat session fed through stdin, and one cross-package
case: the port's /complete at tau 0 against the JAX handler over a JAX engine
holding the same params, text for text."""

import io
import json
import threading
import time
import urllib.request

import jax
import pytest
import torch
from _torch_port import to_port

from rwkv_tpu_torch.apps.server import PoolBusy, PoolRunner, PoolTimeout, make_handler
from rwkv_tpu_torch.runtime.pool import InferencePool

ARGS = ["--mock", "--device", "cpu"]


class A:
    """build_engine's argument namespace, as the JAX tests build it."""
    mock, model, vocab, streams = True, None, None, 1
    temp, tau, seed, device = 0.9, 0.8, 0, "cpu"


def _engine(**kw):
    from rwkv_tpu_torch.apps._common import build_engine

    args = A()
    for k, v in kw.items():
        setattr(args, k, v)
    return build_engine(args)


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_port}"


def _start(eng, runner=None):
    from http.server import ThreadingHTTPServer

    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(eng, threading.Lock(), runner))
    return srv, _serve(srv)


def _post(url, path, obj):
    req = urllib.request.Request(url + path, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _pool(eng, **kw):
    return InferencePool(eng.params, eng.tokenizer, max_streams=2, prefill_bucket=16,
                         step_fn=eng._step_fn, **kw)


def test_storygen_runs(capsys):
    from rwkv_tpu_torch.apps.storygen import main

    main(ARGS + ["--stories", "2", "--max-tokens", "6"])
    out = capsys.readouterr().out
    assert "=== story 1 ===" in out and "=== story 2 ===" in out


def test_vectordb_ranks(capsys):
    from rwkv_tpu_torch.apps.vectordb import main

    main(ARGS + ["--query", "capital city of France", "--metric", "cosine"])
    out = capsys.readouterr().out
    assert "query:" in out
    # 5 facts indexed, top-3 printed
    assert len([ln for ln in out.splitlines() if ln.startswith("  ")]) == 3


@pytest.fixture(scope="module")
def server():
    srv, url = _start(_engine())
    yield url
    srv.shutdown()


def test_server_health(server):
    with urllib.request.urlopen(server + "/health") as r:
        body = json.loads(r.read())
    assert body["status"] == "ok"
    assert body["model"]["vocab"] == 50277


def test_server_complete(server):
    code, body = _post(server, "/complete", {"prompt": "Hello", "max_tokens": 5})
    assert code == 200
    assert "completion" in body


def test_server_tokenize_roundtrip(server):
    code, body = _post(server, "/tokenize", {"text": "Hello world"})
    assert code == 200
    code, body2 = _post(server, "/detokenize", {"ids": body["ids"]})
    assert body2["text"] == "Hello world"


def test_server_bad_requests(server):
    assert _post(server, "/complete", {})[0] == 400
    assert _post(server, "/nope", {})[0] == 404
    code, _ = _post(server, "/tokenize", {"nope": 1})
    assert code == 400


def test_server_body_size_cap(server):
    """A declared Content-Length above the cap is refused with 413 before
    the handler reads any body byte (none is sent)."""
    import socket
    from urllib.parse import urlparse

    from rwkv_tpu_torch.apps.server import MAX_BODY_BYTES

    u = urlparse(server)
    with socket.create_connection((u.hostname, u.port), timeout=10) as s:
        s.sendall(
            b"POST /tokenize HTTP/1.1\r\n"
            + f"Host: {u.hostname}\r\n".encode()
            + b"Content-Type: application/json\r\n"
            + f"Content-Length: {MAX_BODY_BYTES + 1024}\r\n".encode()
            + b"\r\n"  # headers done; never send the body
        )
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = s.recv(4096)
            if not chunk:
                break
            resp += chunk
    status = resp.split(b"\r\n", 1)[0]
    assert b"413" in status, resp[:200]
    assert _post(server, "/tokenize", {"text": "hello"})[0] == 200


@pytest.fixture(scope="module")
def pooled_server():
    eng = _engine()
    srv, url = _start(eng, PoolRunner(_pool(eng)))
    yield url
    srv.shutdown()


def test_pooled_server_concurrent_completions(pooled_server):
    """4 concurrent requests through 2 pool slots all complete."""
    results = {}

    def hit(i):
        results[i] = _post(pooled_server, "/complete",
                           {"prompt": f"Request {i}", "max_tokens": 4, "seed": i})

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 4
    for code, body in results.values():
        assert code == 200
        assert "completion" in body


def _stream(url, obj):
    req = urllib.request.Request(url + "/complete", json.dumps(dict(obj, stream=True)).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def test_server_streaming_complete(server):
    """stream:true returns SSE lines ending with [DONE]."""
    status, ctype, body = _stream(server, {"prompt": "Hello", "max_tokens": 4})
    assert status == 200 and ctype == "text/event-stream"
    lines = [ln for ln in body.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "data: [DONE]"
    for ln in lines[:-1]:
        assert "text" in json.loads(ln[len("data: "):])


def test_pooled_server_streaming(pooled_server):
    assert "data: [DONE]" in _stream(pooled_server, {"prompt": "Hi", "max_tokens": 3})[2]


def test_vectordb_batch_index_matches_sequential():
    """Batched prefill indexing ranks like one-at-a-time indexing."""
    from rwkv_tpu_torch.apps.vectordb import FACTS, StateVectorDB

    eng = _engine()
    seq = StateVectorDB(eng, metric="cosine")
    for f in FACTS[:3]:
        seq.add(f)
    bat = StateVectorDB(eng, metric="cosine")
    bat.add_batch(FACTS[:3])
    q = "capital city of France"
    assert [t for t, _ in seq.query(q, 3)] == [t for t, _ in bat.query(q, 3)]


def test_storygen_sharded_cli(capsys):
    """--shards N builds a tensor-parallel engine behind the same CLI (a
    virtual mesh naming the CPU twice); the bundled vocab needs no --vocab."""
    from rwkv_tpu_torch.apps import storygen

    storygen.main(ARGS + ["--stories", "1", "--max-tokens", "5", "--shards", "2"])
    assert capsys.readouterr().out.strip()


def test_server_ban_tokens_validation(server):
    """/complete rejects malformed ban lists (JSON booleans too: bool is an
    int subclass) and accepts a real one."""
    code, _ = _post(server, "/complete", {"prompt": "Hi", "max_tokens": 2, "ban_tokens": [True]})
    assert code == 400
    code, _ = _post(server, "/complete", {"prompt": "Hi", "max_tokens": 2, "ban_tokens": [-3]})
    assert code == 400
    code, body = _post(server, "/complete",
                       {"prompt": "Hi", "max_tokens": 2, "ban_tokens": [0, 5]})
    assert code == 200 and "completion" in body


def test_server_metrics_endpoint(server):
    """/metrics exposes the process metrics registry; token counters move
    after a completion."""
    _post(server, "/complete", {"prompt": "Hi", "max_tokens": 3})
    with urllib.request.urlopen(server + "/metrics") as r:
        body = json.loads(r.read())
    assert "counters" in body and "timings" in body
    assert body["counters"].get("engine.tokens_generated", 0) >= 1


def test_pooled_server_metrics_occupancy(pooled_server):
    """Pool mode adds live occupancy (slots/active/queued) to /metrics."""
    _post(pooled_server, "/complete", {"prompt": "Hi", "max_tokens": 2})
    with urllib.request.urlopen(pooled_server + "/metrics") as r:
        body = json.loads(r.read())
    pool = body.get("pool")
    assert pool is not None
    assert pool["slots"] >= 1 and pool["active"] >= 0 and pool["queued"] >= 0
    assert body["counters"].get("pool.requests_completed", 0) >= 1


@pytest.fixture()
def tight_pooled_server():
    """A pooled server with a 1-deep admission queue: floods are refused
    with 503, not absorbed into unbounded threads."""
    eng = _engine()
    runner = PoolRunner(_pool(eng), max_queue=1)
    srv, url = _start(eng, runner)
    yield url, runner
    srv.shutdown()


def test_pooled_server_backpressure(tight_pooled_server):
    """A burst of 4x-slot concurrent clients: every response is a completion
    (200) or a clean 503 with Retry-After; at least one 503 fires (2 slots +
    1 queue < 8 clients); afterwards the server still serves. The port's
    mock pool decodes a token in about a millisecond on the CPU, so each
    request asks for 96 tokens (the JAX file's 24 outlast its compiles)."""
    url, runner = tight_pooled_server
    results = {}

    def hit(i):
        req = urllib.request.Request(
            url + "/complete",
            json.dumps({"prompt": f"Flood {i}", "max_tokens": 96, "seed": i}).encode(),
            {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as r:
                results[i] = (r.status, json.loads(r.read()), dict(r.headers))
        except urllib.error.HTTPError as e:
            results[i] = (e.code, json.loads(e.read()), dict(e.headers))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert len(results) == 8
    codes = [c for c, _, _ in results.values()]
    assert all(c in (200, 503) for c in codes), codes
    assert 503 in codes, codes
    for c, body, hdrs in results.values():
        if c == 503:
            assert hdrs.get("Retry-After") == "1"
            assert "error" in body
        else:
            assert "completion" in body
    code, body = _post(url, "/complete", {"prompt": "After", "max_tokens": 3})
    assert code == 200 and "completion" in body


def test_pool_runner_submit_timeout():
    """A request that cannot finish in time raises PoolTimeout (the 503
    path) and, if still queued, is cancelled; the runner keeps serving. The
    port's mock pool decodes a token in about a millisecond on the CPU (the
    JAX pool's first steps compile), so the slow request asks for 512."""
    runner = PoolRunner(_pool(_engine()), submit_timeout=0.02)
    with pytest.raises(PoolTimeout):
        runner.submit("too slow", max_tokens=512, seed=0)
    runner.submit_timeout = 300.0
    assert isinstance(runner.submit("recovers", max_tokens=3, seed=1), str)


def test_pool_runner_drain():
    """drain(): in-flight requests finish, then new submits are refused."""
    runner = PoolRunner(_pool(_engine()))
    results = {}

    def hit(i):
        results[i] = runner.submit(f"Drain test {i}", max_tokens=3, seed=i)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    deadline = time.time() + 60
    while time.time() < deadline:
        with runner._lock:
            if len(runner._events) + len(results) >= 3:
                break
        time.sleep(0.02)
    assert runner.drain(timeout=120), "pool did not empty"
    for t in threads:
        t.join(timeout=10)
    assert len(results) == 3
    assert all(isinstance(v, str) for v in results.values())
    with pytest.raises(PoolBusy, match="draining"):
        runner.submit("too late", max_tokens=2)


def test_pool_runner_would_block_during_drain():
    runner = PoolRunner(_pool(_engine()))
    assert runner.would_block() is False
    assert runner.drain(timeout=30)
    assert runner.would_block() is True


# -- beyond the JAX file ----------------------------------------------------------


def test_server_bf16_prefill_pool():
    """make_server with --bf16-prefill --pool: the engine and the pool take
    bf16 prefill, and the pooled server answers."""
    from rwkv_tpu_torch.apps.server import make_server

    srv, eng, runner, _ = make_server(ARGS + ["--bf16-prefill", "--pool", "2", "--pool-chunk",
                                              "2", "--port", "0"])
    assert eng.prefill_dtype == torch.bfloat16 and runner.pool.prefill_dtype == torch.bfloat16
    assert runner.pool.step_chunk == 2
    url = _serve(srv)
    try:
        code, body = _post(url, "/complete", {"prompt": "Hello " * 20, "max_tokens": 4})
        assert code == 200 and body["completion"]
    finally:
        srv.shutdown()
        srv.server_close()
        assert runner.drain(timeout=30)


def test_vectordb_bf16_batch_index(capsys):
    """--batch-index --bf16-prefill indexes through bf16 products and ranks
    like the float32 index."""
    from rwkv_tpu_torch.apps.vectordb import FACTS, StateVectorDB, main

    main(ARGS + ["--batch-index", "--bf16-prefill", "--metric", "cosine"])
    assert len([ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("  ")]) == 3
    dbs = []
    for bf16 in (False, True):
        db = StateVectorDB(_engine(bf16_prefill=bf16), metric="cosine")
        db.add_batch(FACTS)
        dbs.append(db)
    assert not all((a == b).all() for a, b in zip(dbs[0].vecs, dbs[1].vecs))
    q = "capital city of France"
    assert [t for t, _ in dbs[0].query(q, 5)] == [t for t, _ in dbs[1].query(q, 5)]


def test_chat_session_through_stdin(monkeypatch, capsys):
    """Two turns, /undo, /reset and /quit fed through stdin: each turn
    prints the bot's reply, /undo rewinds to the turn before (the state
    equals that snapshot) and /reset to the persona."""
    from rwkv_tpu_torch.apps import chat

    seen = {}
    real = chat.build_engine

    def spy(args):
        seen["eng"] = real(args)
        return seen["eng"]

    monkeypatch.setattr(chat, "build_engine", spy)
    monkeypatch.setattr("sys.stdin", io.StringIO("hello\nhow are you\n/undo\n/reset\nlast\n"
                                                 "/quit\nnever read\n"))
    chat.main(ARGS + ["--max-tokens", "4"])
    out, err = capsys.readouterr()
    assert out.count("Alice:") == 3
    assert "(rewound)" in err and "(reset)" in err
    # after the last turn the state moved on from the persona
    eng = seen["eng"]
    eng2 = _engine()
    eng2.load_context(chat.PERSONA.format(user="Bob", bot="Alice"))
    assert not torch.equal(eng.get_state(0).aa, eng2.get_state(0).aa)


def test_complete_matches_jax_server_at_tau_0():
    """The port's /complete (engine generate, chunk 8) against the JAX
    package's make_handler over a JAX engine that load_params'd the same
    params: the same text at tau 0. A byte-level tokenizer over a 256-token
    vocab keeps a random model's candidates apart, as in
    tests/test_torch_pool.py."""
    from http.server import ThreadingHTTPServer

    from rwkv_tpu.apps.server import make_handler as j_make_handler
    from rwkv_tpu.models import rwkv4 as j_m
    from rwkv_tpu.models.config import RWKVConfig
    from rwkv_tpu.runtime.engine import RWKV as JRWKV
    from rwkv_tpu.tokenizer.bpe import BPETokenizer as JTokenizer
    from rwkv_tpu.tokenizer.bpe import bytes_to_unicode
    from rwkv_tpu_torch.runtime.engine import RWKV
    from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer

    enc = {c: b for b, c in bytes_to_unicode().items()}
    jp = j_m.signedize_params(j_m.quantize_params(j_m.init_params(
        jax.random.PRNGKey(0), RWKVConfig(n_layer=2, n_embd=128, vocab_size=256))))
    jeng = JRWKV()
    jeng.load_params(jp)
    jeng.tokenizer = JTokenizer(enc, [])
    teng = RWKV(device="cpu")
    teng.load_params(to_port(jp))
    teng.tokenizer = BPETokenizer(enc, [])
    jsrv = ThreadingHTTPServer(("127.0.0.1", 0), j_make_handler(jeng, threading.Lock()))
    tsrv, turl = _start(teng)
    jurl = _serve(jsrv)
    try:
        for i, prompt in enumerate(["The quick brown", "In a hole in the ground"]):
            req = {"prompt": prompt, "max_tokens": 12, "temp": 0.8, "tau": 0.0, "seed": i,
                   "ban_tokens": []}
            jc, jb = _post(jurl, "/complete", req)
            tc, tb = _post(turl, "/complete", req)
            assert jc == tc == 200
            assert tb == jb and tb["completion"]
    finally:
        jsrv.shutdown()
        tsrv.shutdown()

"""HTTP completion server (counterpart of rwkv_tpu/apps/server.py).

    python -m rwkv_tpu_torch.apps.server --model m.bin --pool 8 --bf16-prefill
    python -m rwkv_tpu_torch.apps.server --mock --device cpu --port 8080

Stdlib-only. Endpoints:

  POST /complete   {"prompt": str, "max_tokens": int?, "temp": float?,
                    "tau": float?, "stop": [str]?, "seed": int?,
                    "ban_tokens": [int]?, "stream": bool?}
                -> {"completion": str, "tokens": int}
                   (stream:true -> chunked text/event-stream of
                    data: {"text": piece} lines, closed by data: [DONE])
  POST /tokenize   {"text": str} -> {"ids": [int]}
  POST /detokenize {"ids": [int]} -> {"text": str}
  GET  /health     -> {"status": "ok", "model": {...}}
  GET  /metrics    -> {"counters": {...}, "timings": {...}, "pool": {...}?}
                   (process metrics registry + live pool occupancy)
                   timings, each {count, total, max over every span; p50,
                   p90 over the last 4,096}, in seconds of host time:
                     pool.submit.encode   tokenizing a prompt (submit)
                     pool.admit           one admission burst, whole
                     pool.admit.pack      a prefill chunk's tokens packed
                                          and copied to the device
                     pool.admit.prefill   a chunk's prefill launches issued
                     pool.admit.sample    states scattered, first tokens
                                          drawn
                     pool.admit.read      waiting for the burst's first ids
                     pool.admit.emit      the first tokens' bookkeeping
                     pool.decode.prep     a decode chunk's inputs built
                     pool.decode.replay   its graph launched
                     pool.decode.read     waiting for its ids
                     pool.decode.emit     its tokens' bookkeeping (detokenize,
                                          stop scan, finish)
                   counters: pool.steps, pool.tokens_decoded,
                   pool.requests_completed, pool.submit.tokens (prompt ids),
                   pool.admit.requests, pool.prefill.chunks,
                   pool.prefill.tokens (prompt tokens prefilled) and
                   pool.prefill.lane_tokens (token lanes computed, padding
                   included), graphs.captures (CUDA graphs captured: one a
                   program and shape; a rise while serving is a rebuild),
                   engine.* (the engine's)

Each /complete runs on a fresh state (stateless API).

Two execution modes:
  default       one engine, requests serialized under a lock
  --pool N      continuous batching: a background thread advances an
                N-slot InferencePool one batched device step at a time;
                concurrent /complete requests share each step.

Threads and the device: on the card the pool's step programs are captured
into CUDA graphs on the runner's thread (runtime/graphs.py), and a capture
forbids device work from any other thread. So in pool mode the handler
threads never touch the device: /tokenize, /detokenize, /health, /metrics
and admission (pool.submit) are host work, and every device call runs on
the runner's thread under its lock. Without --pool, generate (and its
captures) runs on the handler's thread under the one engine lock.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from rwkv_tpu_torch.apps._common import add_model_args, build_engine

# Request-body cap (bytes), enforced BEFORE buffering: prompts are text,
# so 1 MiB is generous; anything larger is a mistake or an attack and
# gets 413 without allocation. Env-overridable for unusual deployments.
MAX_BODY_BYTES = int(os.environ.get("RWKV_TPU_SERVER_MAX_BODY",
                                    str(1 << 20)))


class PoolBusy(RuntimeError):
    """Admission queue full — reject instead of queueing unboundedly
    (HTTP 503 + Retry-After)."""


class PoolTimeout(RuntimeError):
    """submit() exceeded its wait budget (HTTP 503)."""


class PoolRunner:
    """Background continuous-batching executor for the HTTP server.

    submit() enqueues a request and blocks the calling HTTP thread until
    the pool finishes it; a single daemon thread drives pool.step() so all
    concurrent requests advance in one batched device program per token.

    Backpressure (a client burst must not create an
    unbounded queue + one blocked thread per request forever):
      max_queue       — queued (not-yet-admitted) requests beyond this
                        are rejected with PoolBusy (503 + Retry-After).
      submit_timeout  — optional seconds a submit() waits before giving
                        up with PoolTimeout; a not-yet-admitted request
                        is cancelled, an in-flight one finishes and is
                        discarded.
    """

    def __init__(self, pool, max_queue: int | None = None,
                 submit_timeout: float | None = None):
        self.pool = pool
        self.max_queue = max_queue if max_queue is not None else 4 * pool.B
        self.submit_timeout = submit_timeout
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._done: dict[int, str] = {}
        self._errors: dict[int, str] = {}
        self._events: dict[int, threading.Event] = {}
        self._abandoned: set[int] = set()
        self._closed = False
        t = threading.Thread(target=self._loop, daemon=True)
        t.start()

    def drain(self, timeout: float | None = None) -> bool:
        """Graceful shutdown: stop accepting new requests (submit raises
        PoolBusy) and wait until queued + in-flight work finishes AND every
        waiting submit() has been signaled. Returns False if the pool did
        not empty within timeout.

        pending == 0 alone is not enough: the last request can finish
        inside pool.step() while _loop still holds _lock — its waiter has
        not been ev.set() yet, and exiting then would kill the daemon
        handler threads before they write their 200 bodies. Wait for
        _events to empty too, then give the (daemon) HTTP handler threads
        a beat to flush their responses."""
        self._closed = True
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            with self._lock:
                if self.pool.pending == 0 and not self._events:
                    break
            if deadline is not None and time.monotonic() >= deadline:
                return False
            self._wake.set()
            time.sleep(0.05)
        time.sleep(0.25)  # let signaled handler threads write their bodies
        return True

    def _fail_all(self, msg: str):
        """A step blew up: deliver any generations that actually COMPLETED
        during the failed step (admission backlog), fail every other
        waiting request (never leave a client blocked forever), and drop
        the pool's in-flight bookkeeping."""
        with self._lock:
            done = self.pool.take_finished_backlog()
            for req in done:
                ev = self._events.pop(req.rid, None)
                if req.rid in self._abandoned:  # timed-out client gone
                    continue
                self._done[req.rid] = req.text
                if ev:
                    ev.set()
            events, self._events = self._events, {}
            for rid in events:
                self._errors[rid] = msg
            self.pool.abort_all()
            # abort_all drops in-flight requests, so abandoned rids will
            # never surface in a finished list — clear them or they leak
            self._abandoned.clear()
        for ev in events.values():
            ev.set()

    def _loop(self):
        while True:
            try:
                with self._lock:
                    busy = self.pool.pending > 0
                    finished = self.pool.step() if busy else []
            except Exception as e:  # noqa: BLE001 — must not kill the loop
                print(f"[pool] step failed: {e!r}", file=sys.stderr)
                self._fail_all(f"pool step failed: {e}")
                continue
            with self._lock:
                # reconcile the lockless-timeout race: submit()'s got=False
                # path can mark a rid abandoned AFTER this block already
                # delivered its completion — reclaim the orphaned text here
                for rid in list(self._done.keys() & self._abandoned):
                    self._done.pop(rid, None)
                    self._abandoned.discard(rid)
                    self._events.pop(rid, None)
                for req in finished:
                    ev = self._events.pop(req.rid, None)
                    if req.rid in self._abandoned:  # timed-out client gone
                        self._abandoned.discard(req.rid)
                        continue
                    self._done[req.rid] = req.text
                    if ev:
                        ev.set()
            if not busy:
                self._wake.wait()
                self._wake.clear()

    def would_block(self) -> bool:
        """True when a submit() right now would be rejected (queue full or
        draining) — lets the streaming endpoint refuse with a clean 503
        BEFORE sending 200 + SSE headers (a load balancer doing connection
        draining must see the 503, not a 200 with an error event)."""
        with self._lock:
            return self._closed or len(self.pool._queue) >= self.max_queue

    def submit(self, prompt, on_text=None, **kw) -> str:
        """Enqueue and block until the pool finishes the request. on_text
        (optional) receives text pieces as they decode — it runs on the
        pool's stepping thread, keep it fast.

        submit_timeout is honored end-to-end against a monotonic deadline:
        the initial lock acquisition counts against it too (the stepping
        thread holds _lock for a whole pool.step() — minutes on a cold
        compile — and a 5 s timeout must not wait behind that)."""
        deadline = (time.monotonic() + self.submit_timeout
                    if self.submit_timeout is not None else None)

        def remaining():
            return (None if deadline is None
                    else max(deadline - time.monotonic(), 0.0))

        ev = threading.Event()
        t = remaining()
        if not self._lock.acquire(timeout=-1 if t is None else t):
            raise PoolTimeout(
                f"request timed out after {self.submit_timeout}s "
                "(pool busy stepping)")
        try:
            if self._closed:
                raise PoolBusy("server draining")
            if len(self.pool._queue) >= self.max_queue:
                raise PoolBusy(
                    f"admission queue full ({self.max_queue} waiting)")
            rid = self.pool.submit(prompt, on_text=on_text, **kw)
            self._events[rid] = ev
        finally:
            self._lock.release()
        self._wake.set()
        if not ev.wait(remaining()):
            # Bounded grace for the cleanup lock: if the stepping thread
            # is mid-compile we still owe the client its timely 503.
            got = self._lock.acquire(timeout=2.0)
            try:
                if got:
                    # authoritative cleanup under the lock
                    if not ev.is_set():
                        self._events.pop(rid, None)
                        if not self.pool.cancel_queued(rid):
                            # already admitted: let it finish, discard
                            self._abandoned.add(rid)
                        self._done.pop(rid, None)
                        self._errors.pop(rid, None)
                        raise PoolTimeout(
                            f"request timed out after "
                            f"{self.submit_timeout}s")
                    # else: completion raced the timeout — take it below
                else:
                    # Lock unavailable (stepping thread mid-compile): only
                    # GIL-atomic ops here — mark abandoned, then re-check
                    # whether delivery won the race. A torn interleaving
                    # (delivery lands after the is_set check) leaves the
                    # text orphaned in _done; _loop's stale sweep reclaims
                    # it on its next pass.
                    self._abandoned.add(rid)
                    if ev.is_set():  # delivery raced the timeout: take it
                        self._abandoned.discard(rid)
                        err = self._errors.pop(rid, None)
                        if err is not None:
                            raise RuntimeError(err)
                        out = self._done.pop(rid, None)
                        if out is not None:
                            return out
                        # _loop's sweep won the double race — treat as
                        # timed out (the result is gone either way)
                    self._events.pop(rid, None)
                    raise PoolTimeout(
                        f"request timed out after {self.submit_timeout}s")
            finally:
                if got:
                    self._lock.release()
        err = self._errors.pop(rid, None)
        if err is not None:
            raise RuntimeError(err)
        return self._done.pop(rid)


def make_handler(eng, lock, runner=None):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, obj, retry_after=None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", str(retry_after))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *a):  # quiet
            print("[http]", fmt % a, file=sys.stderr)

        def do_GET(self):
            if self.path == "/health":
                cfg = eng.config
                self._json(200, {
                    "status": "ok",
                    "model": {"n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
                              "vocab": eng._true_vocab},
                })
            elif self.path == "/metrics":
                # counters + timings from the process-wide registry
                # (pool.tokens_decoded, engine.tokens_generated, ...) plus
                # live pool occupancy when continuous batching is on
                from rwkv_tpu_torch.utils.metrics import metrics

                out = metrics.snapshot()
                if runner is not None:
                    out["pool"] = {
                        "slots": runner.pool.B,
                        "active": int(len(runner.pool._by_slot)),
                        "queued": int(len(runner.pool._queue)),
                    }
                self._json(200, out)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > MAX_BODY_BYTES:
                    # cap BEFORE buffering: an attacker-sized
                    # Content-Length must not make the handler thread
                    # allocate it (the body-size sibling of the pool's
                    # queue-depth backpressure).
                    return self._json(413, {
                        "error": f"body too large ({n} > {MAX_BODY_BYTES})"
                    })
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                return self._json(400, {"error": "bad json"})

            if self.path == "/tokenize":
                if "text" not in req:
                    return self._json(400, {"error": "missing 'text'"})
                return self._json(200, {"ids": eng.tokenizer.encode(req["text"])})

            if self.path == "/detokenize":
                if "ids" not in req:
                    return self._json(400, {"error": "missing 'ids'"})
                return self._json(200, {"text": eng.tokenizer.decode(req["ids"])})

            if self.path == "/complete":
                prompt = req.get("prompt")
                if not isinstance(prompt, str) or not prompt:
                    return self._json(400, {"error": "missing 'prompt'"})
                stop = req.get("stop")
                if stop is not None and (
                    not isinstance(stop, list)
                    or not all(isinstance(s, str) for s in stop)
                ):
                    return self._json(400,
                                      {"error": "'stop' must be a string list"})
                try:
                    max_tokens = min(int(req.get("max_tokens", 128)), 2048)
                except (TypeError, ValueError):
                    return self._json(400, {"error": "bad 'max_tokens'"})
                ban = req.get("ban_tokens", [0])
                if (not isinstance(ban, list)
                        or not all(isinstance(t, int)
                                   and not isinstance(t, bool)  # true != id 1
                                   and 0 <= t for t in ban)):
                    return self._json(
                        400, {"error": "'ban_tokens' must be a list of "
                                       "non-negative token ids"})
                ban = [t for t in ban if t < eng._true_vocab]
                kw = dict(
                    max_tokens=max_tokens,
                    temp=float(req.get("temp", 0.9)),
                    tau=float(req.get("tau", 0.8)),
                    seed=int(req.get("seed", 0)),
                    stop=stop,
                    ban_tokens=tuple(ban),
                )
                if req.get("stream"):
                    if runner is not None and runner.would_block():
                        return self._json(503, {"error": "server busy"},
                                          retry_after=1)
                    return self._stream_complete(prompt, kw)
                if runner is not None:  # continuous batching
                    try:
                        out = runner.submit(prompt, **kw)
                    except (PoolBusy, PoolTimeout) as e:
                        return self._json(503, {"error": str(e)},
                                          retry_after=1)
                    except RuntimeError as e:
                        return self._json(500, {"error": str(e)})
                else:
                    with lock:  # single model; serialize requests
                        eng.reset_state(0)
                        # stateless per-request: chunked decode amortizes
                        # dispatch latency 8x with identical token streams
                        out = eng.generate(prompt, chunk=8, **kw)
                return self._json(200, {"completion": out,
                                        "tokens": len(eng.tokenizer.encode(out))})

            self._json(404, {"error": "not found"})

        def _stream_complete(self, prompt, kw):
            """Chunked transfer: each decoded text piece is flushed as an
            SSE `data:` line the moment it exists; a final `data: [DONE]`
            closes the stream."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            # A timed-out pool submit abandons the request but the pool
            # keeps decoding it — its on_text must become inert once this
            # handler returns (wfile is closed then; writing to it raises
            # ValueError, which would otherwise escape into pool.step()).
            alive = {"v": True}

            def chunk(data: bytes):
                if not alive["v"]:
                    return False
                try:
                    self.wfile.write(f"{len(data):X}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                    self.wfile.flush()
                    return True
                except (BrokenPipeError, ConnectionResetError, OSError,
                        ValueError):
                    alive["v"] = False
                    return False  # client went away; keep decoding (pool)

            def emit(piece: str):
                chunk(b"data: " + json.dumps({"text": piece}).encode()
                      + b"\n\n")

            try:
                if runner is not None:
                    runner.submit(prompt, on_text=emit, **kw)
                else:
                    with lock:
                        eng.reset_state(0)
                        eng.generate(prompt, on_text=emit, chunk=4, **kw)
            except RuntimeError as e:
                chunk(b"data: " + json.dumps({"error": str(e)}).encode()
                      + b"\n\n")
            chunk(b"data: [DONE]\n\n")
            alive["v"] = False
            try:
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError,
                    ValueError):
                pass

    return Handler


def make_server(argv=None):
    """Parse the server's flags, build the engine (and with --pool the pool
    and its runner) and bind the HTTP server, without serving yet. Returns
    (server, engine, runner or None, args); --port 0 binds a free port
    (server.server_port)."""
    p = argparse.ArgumentParser(description="RWKV HTTP server")
    add_model_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--pool", type=int, default=0, metavar="N",
                   help="continuous batching with N slots (0 = serialized)")
    p.add_argument("--pool-chunk", type=int, default=4, metavar="K",
                   help="tokens per device dispatch in pool mode (admission/"
                        "stop latency lags by up to K-1 tokens)")
    p.add_argument("--pool-queue", type=int, default=None, metavar="Q",
                   help="max queued (not yet admitted) requests before "
                        "/complete returns 503 (default 4x --pool)")
    p.add_argument("--pool-timeout", type=float, default=None, metavar="S",
                   help="max seconds a request may wait end-to-end before "
                        "503 (default: unlimited)")
    p.add_argument("--drain-grace", type=float, default=30.0, metavar="S",
                   help="seconds to let in-flight pool requests finish on "
                        "SIGTERM/SIGINT before exiting")
    args = p.parse_args(argv)

    eng = build_engine(args)
    runner = None
    if args.pool > 0:
        from rwkv_tpu_torch.runtime.pool import InferencePool

        pool = InferencePool(eng.params, eng.tokenizer,
                             max_streams=args.pool, step_fn=eng._step_fn,
                             prefill_fn=eng._prefill_impl,
                             prefill_dtype=eng.prefill_dtype,
                             step_chunk=args.pool_chunk)
        runner = PoolRunner(pool, max_queue=args.pool_queue,
                            submit_timeout=args.pool_timeout)
        print(f"continuous batching: {args.pool} slots, queue depth "
              f"{runner.max_queue}", file=sys.stderr)
    srv = ThreadingHTTPServer((args.host, args.port),
                              make_handler(eng, threading.Lock(), runner))
    return srv, eng, runner, args


def main(argv=None):
    srv, _, runner, args = make_server(argv)
    print(f"listening on http://{args.host}:{srv.server_port}", file=sys.stderr)

    # graceful shutdown: SIGTERM/SIGINT stop accepting, then drain the
    # pool so in-flight generations finish before the process exits
    import signal

    def _sig(_s, _f):
        threading.Thread(target=srv.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _sig)
    except ValueError:  # non-main thread (tests)
        pass
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        if runner is not None:
            print("draining pool ...", file=sys.stderr)
            ok = runner.drain(args.drain_grace)
            print("drained" if ok else
                  f"drain timed out after {args.drain_grace}s",
                  file=sys.stderr)


if __name__ == "__main__":
    main()

"""The port's continuous-batching pool (rwkv_tpu_torch/runtime/pool.py) on the
CPU: every scenario of tests/test_pool.py but the JAX key-layout pin
(test_prng_key_np_matches_jax: the port seeds a torch.Generator per slot and
has no key layout), the port's ragged prefill against the JAX one, and the
port's pool against the JAX pool, text for text, on the q8 and the a8 step."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import to_port

from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.ops.pallas import decode_stack as j_ds
from rwkv_tpu.runtime.pool import InferencePool as JPool
from rwkv_tpu.tokenizer.bpe import BPETokenizer as JTokenizer
from rwkv_tpu_torch.models import rwkv4 as t_m
from rwkv_tpu_torch.ops.cuda.decode_stack import forward_step_fused
from rwkv_tpu_torch.runtime.pool import InferencePool, Request
from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer, StreamDecoder

V = 50277  # the bundled vocab's size


@pytest.fixture(scope="module")
def tok():
    return BPETokenizer.load()


@pytest.fixture(scope="module")
def params():
    """tests/test_pool.py's model: L=2, E=16, the full vocab, u8 weights,
    carried into the port (re-centered to int8)."""
    cfg = RWKVConfig(n_layer=2, n_embd=16)
    return to_port(j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(11), cfg)))


@pytest.fixture(scope="module")
def a8_setup():
    """A model the a8 step takes (E a multiple of 128): the JAX params
    (signed int8) and the port's copy of them."""
    cfg = RWKVConfig(n_layer=2, n_embd=128)
    jp = j_m.signedize_params(j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(5), cfg)))
    return jp, to_port(jp)


A8_STEP = partial(forward_step_fused, a8=True, a8_block=128)


def test_more_requests_than_slots(params, tok):
    pool = InferencePool(params, tok, max_streams=2, prefill_bucket=16)
    rids = [pool.submit(f"Request number {i}", max_tokens=4) for i in range(5)]
    out = pool.run()
    assert sorted(out) == sorted(rids)
    assert all(isinstance(v, str) for v in out.values())


def test_streaming_callback(params, tok):
    pool = InferencePool(params, tok, max_streams=2)
    got = []
    rid = pool.submit("Hello", max_tokens=5, on_text=got.append)
    out = pool.run()
    assert "".join(got) and "".join(got) == out[rid]


@pytest.mark.parametrize("step", ["q8", "a8"])
def test_deterministic_per_seed_independent_of_batchmates(params, a8_setup, tok, step):
    """A request's text depends only on its own prompt and seed, not on what
    else is in the batch: on the plain q8 step and on the a8 step, whose
    activation scales are per batch row."""
    p, step_fn = (params, None) if step == "q8" else (a8_setup[1], A8_STEP)
    pool1 = InferencePool(p, tok, max_streams=4, step_fn=step_fn)
    a = pool1.submit("The capital", max_tokens=6, seed=42)
    out1 = pool1.run()

    pool2 = InferencePool(p, tok, max_streams=4, step_fn=step_fn)
    b = pool2.submit("The capital", max_tokens=6, seed=42)
    for i in range(3):
        pool2.submit(f"Noise {i}", max_tokens=6, seed=100 + i)
    out2 = pool2.run()
    assert out1[a] == out2[b] and out1[a]


def test_max_tokens_respected(params, tok):
    pool = InferencePool(params, tok, max_streams=2)
    got = {}
    pool.submit("Count", max_tokens=3)
    while pool.pending:
        for req in pool.step():
            got[req.rid] = req
    assert pool.pending == 0 and got[0].produced == 3


def test_finish_flushes_partial_utf8(params, tok):
    """A request ending mid-codepoint surfaces the bytes (errors=replace)
    instead of dropping them."""
    pool = InferencePool(params, tok, max_streams=1, prefill_bucket=16)
    req = Request(rid=0, prompt_ids=[1], max_tokens=1, temp=1.0, tau=0.8, seed=0, stop=None,
                  on_text=None)
    req.slot = 0
    req.decoder = StreamDecoder(tok)
    req.decoder.pending = b"\xe2\x82"  # a truncated euro sign
    pool._by_slot[0] = req
    pool._active[0] = True
    done = pool._finish(req)
    assert done.text != "" and done.done and not pool._active[0]


def test_step_chunk_equivalent_results(params, tok):
    """step_chunk=3 gives the same texts as step_chunk=1 (each slot's
    generator draws in the same order), with fewer host reads."""
    p1 = InferencePool(params, tok, max_streams=2, prefill_bucket=16)
    for i in range(3):
        p1.submit(f"req {i}", max_tokens=7, seed=i)
    r1 = p1.run()
    p3 = InferencePool(params, tok, max_streams=2, prefill_bucket=16, step_chunk=3)
    for i in range(3):
        p3.submit(f"req {i}", max_tokens=7, seed=i)
    r3 = p3.run()
    assert r1 == r3


def test_pool_soak_slot_recycling(params, tok):
    """Many short requests through few slots: slots recycle cleanly, no
    bookkeeping leaks, and a prompt with a seed gives one text wherever its
    slot and batchmates were."""
    pool = InferencePool(params, tok, max_streams=2, prefill_bucket=16, step_chunk=2)
    rids = [pool.submit(f"r{i % 3}", max_tokens=3, seed=i % 5) for i in range(24)]
    out = pool.run()
    assert len(out) == 24 and set(out) == set(rids)
    assert pool.pending == 0
    assert sorted(pool._free) == [0, 1]
    assert not pool._by_slot and not pool._queue
    by_key = {}
    for i, rid in enumerate(rids):
        assert by_key.setdefault((i % 3, i % 5), out[rid]) == out[rid]


def _assert_slots_match_sequential_prefill(pool, params):
    for slot, req in pool._by_slot.items():
        ids = torch.tensor(req.prompt_ids)
        _, st = t_m.forward_seq(params, ids, t_m.init_state(params.config), parallel=True)
        for a, b in zip(pool._state, st):
            np.testing.assert_allclose(a[:, slot].numpy(), b.numpy(), rtol=3e-4, atol=3e-4)


def test_multichunk_ragged_admission(params, tok):
    """Prompts longer than the prefill bucket: the chunked ragged admission
    (last logits kept per stream, state threaded across chunks, exhausted
    streams as no-op lanes) matches each prompt's own sequential prefill."""
    pool = InferencePool(params, tok, max_streams=3, prefill_bucket=4)
    for i, p in enumerate(["a b c d e f g h i j", "short", "medium length prompt here ok"]):
        pool.submit(p, max_tokens=2, seed=i)
    pool._admit()
    assert len(pool._by_slot) == 3
    _assert_slots_match_sequential_prefill(pool, params)


def test_full_chunk_admission_parity(params, tok):
    """Prompts that exactly fill every chunk take the unmasked prefill
    (length None); the slot states match a sequential prefill all the same."""
    K = 4
    pool = InferencePool(params, tok, max_streams=2, prefill_bucket=K)
    seen = []
    real = pool._prefill
    pool._prefill = lambda p, t, length, s: seen.append(length) or real(p, t, length, s)
    for i in range(2):
        pool.submit("x", max_tokens=2, seed=i)
        pool._queue[-1].prompt_ids = [(7 * i + j) % 500 for j in range(2 * K)]
    pool._admit()
    assert seen == [None, None]
    assert len(pool._by_slot) == 2
    _assert_slots_match_sequential_prefill(pool, params)


def test_admission_failure_releases_slots(params, tok, monkeypatch):
    """A prefill exception neither leaks slots nor drops requests."""
    pool = InferencePool(params, tok, max_streams=2, prefill_bucket=8)
    pool.submit("hello", max_tokens=2)
    pool.submit("world", max_tokens=2)

    def boom(*a, **k):
        raise RuntimeError("device fell over")

    monkeypatch.setattr(pool, "_prefill", boom)
    with pytest.raises(RuntimeError):
        pool.step()
    assert sorted(pool._free) == [0, 1]
    assert len(pool._queue) == 2
    monkeypatch.undo()
    assert sorted(pool.run()) == [0, 1]


def test_admission_failure_keeps_finished_results(params, tok, monkeypatch):
    """A request that finished on its admission token before the burst
    failed keeps its text (take_finished_backlog, then the next step); the
    others are requeued from scratch."""
    pool = InferencePool(params, tok, max_streams=2, prefill_bucket=8)
    r_done = pool.submit("hello", max_tokens=1, seed=1)
    r_next = pool.submit("world", max_tokens=3, seed=2)
    real = pool._emit

    def emit(req, token):
        if req.rid == r_next:
            raise RuntimeError("lost the client")
        return real(req, token)

    monkeypatch.setattr(pool, "_emit", emit)
    with pytest.raises(RuntimeError):
        pool.step()
    assert [r.rid for r in pool._finished_backlog] == [r_done]
    assert [r.rid for r in pool._queue] == [r_next] and pool._queue[0].produced == 0
    assert sorted(pool._free) == [0, 1] and not pool._by_slot
    monkeypatch.undo()
    first = pool.step()
    assert first[0].rid == r_done and first[0].text
    out = pool.run()
    assert set(out) == {r_next}


def test_cancel_queued_and_abort_all(params, tok):
    pool = InferencePool(params, tok, max_streams=1)
    a = pool.submit("first", max_tokens=50)
    b = pool.submit("second", max_tokens=5)
    pool.step()  # admits a; b waits
    assert not pool.cancel_queued(a)
    assert pool.cancel_queued(b) and not pool.cancel_queued(b)
    assert pool.pending == 1
    pool.submit("third", max_tokens=5)
    pool.abort_all()
    assert pool.pending == 0 and pool._free == [0] and not any(pool._active)
    c = pool.submit("fourth", max_tokens=2)
    assert set(pool.run()) == {c}


def test_ban_tokens_per_request(params, tok):
    """A request banning every id but one can only emit that token; its
    batchmate with the default list is unaffected."""
    tid = tok.encode(" the")[0]
    banned = [i for i in range(V) if i != tid]
    pool = InferencePool(params, tok, max_streams=2)
    r_banned = pool.submit("The capital", max_tokens=5, seed=1, ban_tokens=banned)
    r_free = pool.submit("The capital", max_tokens=5, seed=1)
    out = pool.run()
    assert out[r_banned] == tok.decode([tid] * 5)
    assert out[r_free] != out[r_banned]


def test_pool_stop_string_window(params, tok):
    """Stop detection through the suffix window: a match across a piece
    boundary is caught and the text cut at its first occurrence."""
    pool = InferencePool(params, tok, max_streams=1, step_chunk=3)
    rid = pool.submit("abc", max_tokens=200, seed=3)
    full = pool.run()[rid]
    assert len(full) >= 4, "the random model emitted too little text for the check"
    stop = full[len(full) // 2: len(full) // 2 + 3]
    pool2 = InferencePool(params, tok, max_streams=1, step_chunk=3)
    rid2 = pool2.submit("abc", max_tokens=200, seed=3, stop=[stop])
    out2 = pool2.run()[rid2]
    assert stop not in out2
    assert out2 == full[: full.index(stop)]


def test_pool_max_tokens_one(params, tok):
    """A max_tokens=1 request finishes on its admission token."""
    pool = InferencePool(params, tok, max_streams=2)
    rid = pool.submit("Hello", max_tokens=1, seed=5)
    out = pool.run()
    assert rid in out and len(tok.encode(out[rid])) <= 1
    assert sorted(pool._free) == [0, 1] and not pool._by_slot


def test_admission_width_buckets(params, tok):
    """An admission of n prompts pads the burst to the next power of two,
    never always to B."""
    pool = InferencePool(params, tok, max_streams=8, prefill_bucket=8)
    assert pool._widths == [1, 2, 4, 8]
    widths = []
    real = pool._prefill

    def spy(p, tokens, length, state):
        widths.append(tokens.shape[1])
        return real(p, tokens, length, state)

    pool._prefill = spy
    pool.submit("only one", max_tokens=1, seed=0)
    pool.step()
    assert set(widths) == {1}, widths
    widths.clear()
    for i in range(3):
        pool.submit(f"burst {i}", max_tokens=1, seed=i)
    pool.step()
    assert set(widths) == {4}, widths


def test_admission_burst_single_sample_dispatch(params, tok, monkeypatch):
    """A burst's first tokens are sampled in one call."""
    pool = InferencePool(params, tok, max_streams=4)
    calls = {"n": 0}
    orig = pool._admit_sample

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(pool, "_admit_sample", counting)
    for i in range(4):
        pool.submit(f"Burst request {i}", max_tokens=2, seed=i)
    pool.step()
    assert calls["n"] == 1
    pool.run()
    assert pool.pending == 0


def test_on_text_exception_isolated(params, tok):
    """A failing streaming callback is muted after its first exception; its
    request still completes with its text, and batchmates are untouched."""
    pool = InferencePool(params, tok, max_streams=2, prefill_bucket=16)
    calls = {"n": 0}

    def boom(piece):
        calls["n"] += 1
        raise ValueError("I/O operation on closed file")

    rid_bad = pool.submit("Broken client", max_tokens=4, on_text=boom)
    rid_ok = pool.submit("Healthy client", max_tokens=4, seed=3)
    out = pool.run()
    assert sorted(out) == sorted([rid_bad, rid_ok])
    assert out[rid_bad] and out[rid_ok]
    assert calls["n"] == 1


def test_pool_q4_params(tok):
    """Continuous batching over packed 4-bit weights: the pool does not care
    about the format, and a request stays independent of its batchmates."""
    cfg = RWKVConfig(n_layer=2, n_embd=16)
    q4 = to_port(j_m.quantize_params_q4(j_m.init_params(jax.random.PRNGKey(11), cfg), tile=16))
    solo = InferencePool(q4, tok, max_streams=4)
    a = solo.submit("The capital", max_tokens=6, seed=42)
    out_solo = solo.run()
    packed = InferencePool(q4, tok, max_streams=4)
    b = packed.submit("The capital", max_tokens=6, seed=42)
    for i in range(3):
        packed.submit(f"Noise {i}", max_tokens=6, seed=100 + i)
    out_packed = packed.run()
    assert out_solo[a] == out_packed[b] and out_solo[a]


def test_typical_per_row_generators_and_settings():
    """With one generator per row, row b's draw depends only on its own
    generator, logits and settings: the same as sampling that row alone."""
    from rwkv_tpu_torch.ops.sampling import typical

    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    temp, tau = torch.tensor([0.7, 1.0, 1.3]), torch.tensor([0.9, 0.5, 1.0])
    gens = lambda: [torch.Generator().manual_seed(s) for s in (5, 6, 7)]  # noqa: E731
    together = typical(logits, gens(), temp=temp, tau=tau)
    for b in range(3):
        alone = typical(logits[b:b + 1], [gens()[b]], temp=temp[b:b + 1], tau=tau[b:b + 1])
        assert int(alone[0]) == int(together[b])
        scalar = typical(logits[b], gens()[b], temp=float(temp[b]), tau=float(tau[b]))
        assert int(scalar) == int(together[b])
    with pytest.raises(ValueError, match="one per row"):
        typical(logits, gens()[:2])


def test_metrics_snapshot_matches_jax():
    from rwkv_tpu.utils.metrics import Metrics as JMetrics
    from rwkv_tpu_torch.utils.metrics import Metrics, metrics

    j, t = JMetrics(), Metrics()
    for m in (j, t):
        m.inc("pool.steps")
        m.inc("pool.tokens_decoded", 3)
        for v in (0.5, 0.1, 0.3):
            m.observe("step", v)
    assert t.snapshot() == j.snapshot() and t.dump() == j.dump()
    with t.timed("x"):
        pass
    assert t.snapshot()["timings"]["x"]["count"] == 1
    t.reset()
    assert t.snapshot() == {"counters": {}, "timings": {}}
    assert isinstance(metrics, Metrics)


# -- against the JAX package -----------------------------------------------------

def test_ragged_forward_seq_matches_jax(params):
    """Tokens [T, B] with per-stream lengths (0, T and between) against the
    JAX forward_seq(parallel=True, length=...), at tests/test_model.py's
    2e-3; a zero-length lane keeps its state exactly."""
    T, B = 7, 4
    rng = np.random.default_rng(3)
    jp = j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(11), RWKVConfig(2, 16)))
    toks = rng.integers(0, 1000, size=(T, B)).astype(np.int32)
    lens = np.array([3, 0, T, 5], np.int32)
    st = [rng.normal(size=(2, B, 16)).astype(np.float32) for _ in range(5)]
    st[3] = -np.abs(st[3])  # pp
    lj, sj = j_m.forward_seq(jp, jnp.asarray(toks), j_m.WKVState(*map(jnp.asarray, st)),
                             parallel=True, length=jnp.asarray(lens))
    lt, stt = t_m.forward_seq(params, torch.from_numpy(toks).long(),
                              t_m.WKVState(*map(torch.from_numpy, st)), parallel=True,
                              length=torch.from_numpy(lens))
    live = [0, 2, 3]
    np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live], rtol=2e-3, atol=2e-3)
    for a, b, s in zip(stt, sj, st):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=2e-3)
        assert np.array_equal(a.numpy()[:, 1], s[:, 1])
    with pytest.raises(ValueError, match="parallel"):
        t_m.forward_seq(params, torch.from_numpy(toks).long(),
                        t_m.WKVState(*map(torch.from_numpy, st)), length=torch.from_numpy(lens))


# The port's pool against the JAX pool, text for text. With tau=0 typical
# sampling keeps only the token of least |surprisal - entropy|, so the draw
# does not depend on the generator, unless two tokens tie exactly. Over the
# bundled 50,277-token vocab a random model's a8 logits (integer sums times
# one scale) do tie, and its near-uniform distribution leaves gaps of 1e-6
# between candidates; so these tests run a byte-level tokenizer (256 ids, no
# merges) on a model with a 256-token vocab, where the candidates lie far
# apart. Four requests, prompts of 2 to 15 tokens over prefill chunks of 8,
# a stop string on one.
PROMPTS = ["Hi", "The quick brown", "In a hole", "Answer:"]


@pytest.fixture(scope="module")
def byte_setup():
    from rwkv_tpu.tokenizer.bpe import bytes_to_unicode

    enc = {c: b for b, c in bytes_to_unicode().items()}
    cfg = RWKVConfig(n_layer=2, n_embd=128, vocab_size=256)
    jp = j_m.signedize_params(j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(POOL_SEED),
                                                                  cfg)))
    return jp, to_port(jp), JTokenizer(enc, []), BPETokenizer(enc, [])


POOL_SEED = 0


def _serve(pool_cls, p, tok, stop=None, **kw):
    pool = pool_cls(p, tok, max_streams=4, prefill_bucket=8, **kw)
    rids = [pool.submit(pr, max_tokens=12, temp=0.7 + 0.1 * i, tau=0.0, seed=i,
                        stop=[stop] if i == 1 and stop else None)
            for i, pr in enumerate(PROMPTS)]
    out = pool.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("step", ["q8", "a8"])
def test_pool_matches_jax_pool(byte_setup, step):
    """q8: the JAX pool's default XLA step against the port's plain step. a8:
    the JAX fused step in interpret mode (a8, tile 128) against the port's
    a8 step at a8_block 128."""
    jp, tp, jt, tt = byte_setup
    assert [len(tt.encode(p)) for p in PROMPTS] == [2, 15, 9, 7]
    j_kw, t_kw = {}, {}
    if step == "a8":
        j_kw = dict(step_fn=partial(j_ds.forward_step_fused, a8=True, tile=128, interpret=True))
        t_kw = dict(step_fn=A8_STEP)
    free = _serve(JPool, jp, jt, **j_kw)
    assert _serve(InferencePool, tp, tt, **t_kw) == free
    t = free[1]
    stop = t[len(t) // 2: len(t) // 2 + 2]
    want = _serve(JPool, jp, jt, stop=stop, **j_kw)
    assert want[1] == t[: t.index(stop)]
    assert _serve(InferencePool, tp, tt, stop=stop, **t_kw) == want

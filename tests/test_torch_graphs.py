"""Decode and sampling as one device program (rwkv_tpu_torch/runtime/graphs.py,
the engine's _decode/_decode_k, the pool's _batched_step_k) on the CPU, where
the programs run eagerly: typical's tensor settings draw what its float
settings draw; the engine's and the pool's draws are what they were before
the programs (a fresh generator per call or admission, the settings as
floats), with the generators now reseeded; the pool against the JAX pool at
tau = 0; the helper's launch and collective counts on a CPU mesh."""

import jax
import numpy as np
import pytest
import torch
from _torch_port import to_port

from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig as JConfig
from rwkv_tpu.runtime.pool import InferencePool as JPool
from rwkv_tpu.tokenizer.bpe import BPETokenizer as JTokenizer
from rwkv_tpu_torch.io.binfmt import write_bin
from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import WKVState, init_state, random_quantized_params_np
from rwkv_tpu_torch.ops.sampling import typical
from rwkv_tpu_torch.parallel.mesh import Mesh, make_mesh
from rwkv_tpu_torch.runtime import graphs
from rwkv_tpu_torch.runtime.engine import RWKV
from rwkv_tpu_torch.runtime.pool import InferencePool
from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer, StreamDecoder

TEMPS = (0.5, 0.7, 1.0, 1.2, 2.0, 1 / 3)
TAUS = (0.0, 0.5, 0.8, 1.0)


def _typical_before(logits, generator, temp=0.9, tau=0.8):
    """typical as it was before its settings could be 0-d tensors: floats,
    or [B] float32 tensors (the pool's), the exponent computed in float32."""
    logits = logits.float()
    per_row = lambda a: a.to(logits.device, torch.float32)[:, None]  # noqa: E731
    if torch.is_tensor(tau):
        tau = per_row(tau)
    logp = torch.log_softmax(logits, dim=-1)
    probs = torch.exp(logp)
    ent = -torch.where(probs > 0, probs * logp, torch.zeros_like(probs)).sum(dim=-1, keepdim=True)
    shifted = torch.abs(-logp - ent)
    sorted_shifted, order = torch.sort(shifted, dim=-1, stable=True)
    cum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    cutoff = (cum < tau).sum(dim=-1, keepdim=True).clamp(max=shifted.shape[-1] - 1)
    threshold = torch.gather(sorted_shifted, -1, cutoff)
    kept = torch.where(shifted > threshold, torch.zeros_like(probs), probs)
    if torch.is_tensor(temp):
        temp = per_row(temp)
        kept = torch.where(temp != 1.0, torch.pow(kept, 1.0 / temp), kept)
    elif temp != 1.0:
        kept = torch.pow(kept, 1.0 / temp)
    logw = torch.where(kept > 0, torch.log(kept), torch.full_like(kept, float("-inf")))
    if isinstance(generator, torch.Generator):
        u = torch.rand(logw.shape, generator=generator, device=logw.device)
    else:
        u = torch.stack([torch.rand(logw.shape[1:], generator=g, device=logw.device)
                         for g in generator])
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logw + gumbel, dim=-1)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("temp", TEMPS)
def test_typical_tensor_settings_draw_as_floats(temp):
    """0-d and [B] tensor temp (float64) and tau give the float path's ids,
    row by row, for the same generator seeds, temp = 1.0 included; the float
    path draws what it drew before."""
    rng = np.random.default_rng(3)
    V, n = 1000, 40
    logits = torch.from_numpy((rng.normal(size=(n, V)) * 3).astype(np.float32))
    for tau in TAUS:
        floats = [int(typical(logits[i], _gen(i), temp=temp, tau=tau)) for i in range(n)]
        before = [int(_typical_before(logits[i], _gen(i), temp=temp, tau=tau)) for i in range(n)]
        zero_d = [int(typical(logits[i], _gen(i), temp=torch.tensor(temp, dtype=torch.float64),
                              tau=torch.tensor(tau))) for i in range(n)]
        rows = typical(logits, [_gen(i) for i in range(n)],
                       temp=torch.full((n,), temp, dtype=torch.float64),
                       tau=torch.full((n,), tau, dtype=torch.float64)).tolist()
        assert floats == before == zero_d == rows, (temp, tau)


def test_typical_row_tensors_match_the_float32_tensors_before():
    """[B] settings at temperatures whose inverse torch.pow does not special-case
    (the pool's before: float32 tensors) draw what they drew."""
    rng = np.random.default_rng(4)
    B, V = 6, 500
    logits = torch.from_numpy((rng.normal(size=(B, V)) * 2).astype(np.float32))
    temp = [0.7, 0.9, 1.0, 1.2, 0.8, 1.5]
    tau = [0.5, 0.8, 1.0, 0.3, 0.95, 0.6]
    gens = lambda: [_gen(10 + b) for b in range(B)]  # noqa: E731
    want = _typical_before(logits, gens(), torch.tensor(temp), torch.tensor(tau))
    got = typical(logits, gens(), torch.tensor(temp, dtype=torch.float64), torch.tensor(tau))
    assert torch.equal(want, got)


# -- the engine ------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bin") / "l2-e64.bin")
    write_bin(path, random_quantized_params_np(RWKVConfig(2, 64), seed=2))
    eng = RWKV(path, device="cpu")
    eng.load_tokenizer()
    return eng


def _generate_before(eng, prompt, n, temp, tau, seed, ban=(0,)):
    """The engine's generate as it was: a fresh generator per call, the step,
    the ban mask and typical with float settings, op by op."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    mask = torch.zeros(eng.config.vocab_size, dtype=torch.bool)
    mask[list(ban)] = True
    eng.reset_state()
    eng.forward(eng.tokenizer.encode(prompt))
    logits = eng.snapshot(0)["logits"]  # the padded width, as generate samples it
    token = typical(torch.where(mask, -1e9, logits), gen, temp=temp, tau=tau)
    state, ids = eng.get_state(0), [int(token)]
    for _ in range(n - 1):
        logits, state = eng._step_fn(eng.params, token, state)
        token = typical(torch.where(mask, -1e9, logits), gen, temp=temp, tau=tau)
        ids.append(int(token))
    dec = StreamDecoder(eng.tokenizer)
    return "".join(dec.feed([i]) for i in ids) + dec.flush()


@pytest.mark.parametrize("chunk", [1, 8])
def test_engine_generate_draws_as_before(engine, chunk):
    """One engine generator, reseeded per call, settings and ban changed
    between calls: the texts of the op-by-op loop with a fresh generator."""
    calls = [("Once upon a time", 0.9, 0.8, 1, (0,)), ("The capital of", 0.5, 1.0, 7, (0, 11)),
             ("Once upon a time", 1.0, 0.5, 1, (0,)), ("Hello", 2.0, 0.8, 3, (0, 187))]
    for prompt, temp, tau, seed, ban in calls:
        engine.reset_state()
        got = engine.generate(prompt, max_tokens=13, temp=temp, tau=tau, seed=seed,
                              ban_tokens=ban, chunk=chunk)
        assert got == _generate_before(engine, prompt, 13, temp, tau, seed, ban), (prompt, chunk)
    assert len(engine._graphs) == 0  # the CPU runs the programs eagerly


def test_engine_decode_k_carries_token_and_state(engine):
    """_decode_k writes its last id and state into its inputs and returns
    them with the settings, the carry that the next program starts from, and
    equals k single _decode steps."""
    engine.reset_state()
    engine.forward(engine.tokenizer.encode("A test"))
    temp, tau = torch.tensor(0.9, dtype=torch.float64), torch.tensor(0.8)
    ban = torch.zeros(engine.config.vocab_size, dtype=torch.bool)
    tok, st = torch.tensor(5), engine.get_state(0)
    engine._gen.manual_seed(4)
    want, t, s = [], tok.clone(), WKVState(*(x.clone() for x in st))
    for _ in range(3):
        t, s = engine._decode(t, s, temp, tau, ban)
        want.append(int(t))
    engine._gen.manual_seed(4)
    ids, tok2, st2, *settings = engine._decode_k(tok, st, temp, tau, ban, k=3)
    assert ids.tolist() == want and tok2 is tok and int(tok) == want[-1]
    assert all(a is b for a, b in zip(settings, (temp, tau, ban)))
    assert all(a is b and torch.equal(a, c) for a, b, c in zip(st2, st, s))


# -- the pool ----------------------------------------------------------------------


class _PoolBefore(InferencePool):
    """The pool's sampling as it was, on the same prefill and bookkeeping: a
    fresh generator object per admission (here a copy of the reseeded slot
    generator's state), float32 [B] settings."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._fresh = list(self._gens)

    def _admit_sample(self, logits, gens, temp, tau, ban):
        fresh = []
        for g in gens:
            f = torch.Generator()
            f.set_state(g.get_state())
            fresh.append(f)
            self._fresh[next(i for i, s in enumerate(self._gens) if s is g)] = f
        return _typical_before(torch.where(ban, -1e9, logits), fresh, temp.float(), tau)

    def _batched_step(self, tokens, state, temp, tau, active, ban):
        logits, new_state = self._step_impl(self.params, tokens, state)
        nxt = _typical_before(torch.where(ban, -1e9, logits), self._fresh, temp.float(), tau)
        act = active[None, :, None]
        state = WKVState(*(torch.where(act, n, o) for n, o in zip(new_state, state)))
        return torch.where(active, nxt, torch.zeros_like(nxt)), state


@pytest.fixture(scope="module")
def pool_setup():
    cfg = JConfig(n_layer=2, n_embd=16)
    return to_port(j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(11), cfg))), \
        BPETokenizer.load()


@pytest.mark.parametrize("step_chunk", [1, 4])
def test_pool_slot_generators_draw_as_before(pool_setup, step_chunk):
    """Two slots serve five requests in turn: each slot's one generator,
    reseeded at every admission, draws each request's text as a fresh
    generator did before."""
    params, tok = pool_setup
    reqs = [("The capital", 0.7, 0.8, 42), ("Once", 0.9, 0.5, 1), ("Hello there", 1.0, 1.0, 7),
            ("Answer:", 1.2, 0.8, 42), ("The capital", 0.8, 0.95, 3)]

    def serve(cls):
        pool = cls(params, tok, max_streams=2, step_chunk=step_chunk)
        rids = [pool.submit(p, max_tokens=6, temp=t, tau=u, seed=s) for p, t, u, s in reqs]
        out = pool.run()
        return pool, [out[r] for r in rids]

    pool, texts = serve(InferencePool)
    assert texts == serve(_PoolBefore)[1]
    assert texts[0] != texts[4] or texts[3] != texts[0]
    assert len(pool._graphs) == 0


@pytest.mark.parametrize("step_chunk", [1, 3])
def test_pool_matches_jax_pool_at_tau_0(step_chunk):
    """The port's pool against the JAX pool, text for text, at tau = 0 (the
    draw does not depend on the generator): a byte-level tokenizer on a
    256-token model, as tests/test_torch_pool.py runs it."""
    from rwkv_tpu.tokenizer.bpe import bytes_to_unicode

    enc = {c: b for b, c in bytes_to_unicode().items()}
    jp = j_m.signedize_params(j_m.quantize_params(j_m.init_params(
        jax.random.PRNGKey(0), JConfig(n_layer=2, n_embd=128, vocab_size=256))))
    prompts = ["Hi", "The quick brown", "In a hole", "Answer:"]

    def serve(cls, p, tok, **kw):
        pool = cls(p, tok, max_streams=4, prefill_bucket=8, **kw)
        rids = [pool.submit(pr, max_tokens=10, temp=0.7 + 0.1 * i, tau=0.0, seed=i)
                for i, pr in enumerate(prompts)]
        out = pool.run()
        return [out[r] for r in rids]

    want = serve(JPool, jp, JTokenizer(enc, []))
    assert serve(InferencePool, to_port(jp), BPETokenizer(enc, []), step_chunk=step_chunk) == want


# -- the helper on a CPU mesh ------------------------------------------------------


@pytest.fixture(scope="module")
def cpu_mesh_engine(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bin") / "l2-e256.bin")
    write_bin(path, random_quantized_params_np(RWKVConfig(2, 256), seed=5))
    mesh = make_mesh(model=2, devices=["cpu"] * 2)
    eng = RWKV(path, device="cpu", sharding=mesh)
    eng.load_tokenizer()
    return eng, mesh


def test_counts_delta_and_replay_bookkeeping(cpu_mesh_engine):
    """counts/set_counts over the kernels' counters and a mesh's collectives:
    a step's delta, put back and added n times, equals n eager steps."""
    eng, mesh = cpu_mesh_engine
    L = eng.config.n_layer
    state = init_state(eng.config, (2,))
    token = torch.tensor([3, 9])
    mesh.reset_collectives()
    before = graphs.counts(mesh)
    assert len(before) == len(graphs.COUNTERS) + 2
    eng._step_fn(eng.params, token, state)
    delta = [a - b for a, b in zip(graphs.counts(mesh), before)]
    assert delta == [0] * len(graphs.COUNTERS) + [2 * L + 1, L + 1]
    graphs.set_counts(before, mesh)
    assert graphs.counts(mesh) == before
    for _ in range(3):  # what three replays add
        graphs.set_counts([c + d for c, d in zip(graphs.counts(mesh), delta)], mesh)
    replayed = graphs.counts(mesh)
    graphs.set_counts(before, mesh)
    for _ in range(3):
        eng._step_fn(eng.params, token, state)
    assert graphs.counts(mesh) == replayed
    ds_mod = graphs.COUNTERS[0][0]
    ds_mod.launches += 5
    try:
        assert graphs.counts()[0] == replayed[0] + 5
        assert len(graphs.counts()) == len(graphs.COUNTERS)
    finally:
        ds_mod.launches -= 5


def test_cpu_mesh_decodes_eagerly_with_its_collectives(cpu_mesh_engine):
    """On a CPU mesh the helper calls the program eagerly (no graph), and the
    engine's decode issues the body's 3L + 2 collectives a decoded token."""
    eng, mesh = cpu_mesh_engine
    L = eng.config.n_layer
    assert eng._step_fn.body == "halves" and not eng._step_fn.graphed
    eng.reset_state()
    eng.forward(eng.tokenizer.encode("Hi"))
    mesh.reset_collectives()
    eng.generate("", max_tokens=5, seed=1, chunk=2)
    assert mesh.collectives == {"psum": 4 * (2 * L + 1), "all_gather": 4 * (L + 1)}
    assert len(eng._graphs) == 0
    calls = []
    g = graphs.Graphs(mesh=mesh)
    x = torch.ones(3)
    for _ in range(3):
        assert g(("k",), lambda t: calls.append(1) or t * 2, x).tolist() == [2.0] * 3
    assert len(calls) == 3 and len(g) == 0


def test_graph_rule_for_meshes():
    """A mesh decodes from graphs when every shard of this process lies on a
    CUDA device: one card, or distinct cards captured as one graph; a mesh
    on the CPU (or with a CPU shard) decodes eagerly."""
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert graphs.graphable(None)
    assert graphs.graphable(Mesh([[cuda0, cuda0]]))
    assert graphs.graphable(Mesh([[cuda0, cuda1]]))
    assert graphs.graphable(Mesh([[cuda0], [cuda1]]))
    assert not graphs.graphable(make_mesh(model=2, devices=["cpu"] * 2))
    assert not graphs.graphable(Mesh([[cuda0, torch.device("cpu")]]))


def test_tree_helpers_keep_state_types():
    st = WKVState(*(torch.full((2, 3), float(i)) for i in range(5)))
    tree = (torch.tensor(1), st, torch.zeros(2))
    out = graphs._map(lambda t: t + 1, tree)
    assert isinstance(out[1], WKVState) and [float(s[0, 0]) for s in out[1]] == [1, 2, 3, 4, 5]
    assert [id(t) for t in graphs._leaves(tree)] == [id(tree[0])] + [id(s) for s in st] \
        + [id(tree[2])]

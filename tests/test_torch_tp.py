"""The port's tensor-parallel decode and prefill (rwkv_tpu_torch/parallel/ and
kernel K6's plain versions) against the JAX package on the CPU.

The JAX side runs on the suite's 8 virtual CPU devices, its K6 (Pallas
att_half / ffn_half) in interpret mode, as tests/test_tp_step.py runs it; the
port's meshes name the CPU several times ([cpu] * n). Params come from
quantize_params(init_params(...)), whose per-channel scales and offsets
differ, so a vector cut on the wrong dim shows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import to_port

from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.ops.layernorm import layer_norm as j_layer_norm
from rwkv_tpu.ops.pallas import tp_halves as j_halves
from rwkv_tpu.parallel import mesh as j_mesh
from rwkv_tpu.parallel import sharding as j_sh
from rwkv_tpu.parallel import tp_step as j_tp
from rwkv_tpu_torch.models import rwkv4 as t_m
from rwkv_tpu_torch.ops.cuda import tp_halves as t_halves
from rwkv_tpu_torch.parallel import mesh as t_mesh
from rwkv_tpu_torch.parallel import sharding as t_sh
from rwkv_tpu_torch.parallel import tp_step as t_tp
from rwkv_tpu_torch.runtime.engine import RWKV

L_, E_ = 2, 512
TOKENS = [[3, 150], [7, 42], [200, 1], [5, 99]]  # 4 carried steps, B = 2
TOL = 3e-4  # tests/test_tp_step.py's pin for the step


def _cpu_mesh(model, data=1):
    return t_mesh.make_mesh(model=model, data=data, devices=["cpu"] * (model * data))


def _jax_params(cfg, seed):
    return j_m.signedize_params(j_m.pad_vocab(
        j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(seed), cfg)), multiple=512))


@pytest.fixture(scope="module")
def setup():
    """E = 512 (E / tp = 128 at tp = 4, so the halves body runs), L = 2,
    vocab 211 padded to 512; the JAX params and the port's copy."""
    cfg = RWKVConfig.tiny_test(n_layer=L_, n_embd=E_, vocab_size=211)
    jp = _jax_params(cfg, 1)
    return cfg, jp, to_port(jp)


def _leaves(obj, path=""):
    if obj is None or isinstance(obj, int):
        return
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{path}.{f.name}" if path else f.name)
    else:
        yield path, obj


def test_make_mesh_and_collectives():
    """The [data][model] grid, and the collectives over each data row's
    model shards: a sum in shard order, a concatenation; each call counted."""
    m = t_mesh.make_mesh(model=2, data=2, devices=["cpu"] * 5)
    assert m.shape == {"data": 2, "model": 2} and m.first_device == torch.device("cpu")
    with pytest.raises(ValueError):
        t_mesh.make_mesh(model=4, data=2, devices=["cpu"] * 4)
    parts = [[torch.full((2,), float(10 * d + j)) for j in range(2)] for d in range(2)]
    s, g = m.psum(parts), m.all_gather(parts)
    assert s[1][0].tolist() == s[1][1].tolist() == [21.0, 21.0]
    assert g[0][1].tolist() == [0.0, 0.0, 1.0, 1.0]
    assert m.collectives == {"psum": 1, "all_gather": 1}
    m.reset_collectives()
    assert m.collectives == {"psum": 0, "all_gather": 0}
    if torch.cuda.is_available():  # the default mesh: every visible CUDA device
        assert t_mesh.single_device_mesh().first_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_mesh.single_device_mesh()


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_params_bit_equal_to_jax(setup, tp):
    _, jp, p = setup
    jmesh = j_mesh.make_mesh(model=tp, data=1)
    jleaves = dict(_leaves(j_sh.shard_params(jp, jmesh)))
    sp = t_sh.shard_params(p, _cpu_mesh(tp))
    devs = list(jmesh.devices[0])
    seen = 0
    for j in range(tp):
        for path, leaf in _leaves(sp.rows[0][j]):
            shard = next(s for s in jleaves[path].addressable_shards if s.device == devs[j])
            assert leaf.is_contiguous(), path
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(shard.data), err_msg=path)
            seen += 1
    assert seen == tp * len(jleaves)


@pytest.mark.parametrize("tp", [1, 2])
def test_halves_match_jax_kernels(setup, rng, tp):
    """att_half / ffn_half on one shard (the last) against the JAX K6 in
    interpret mode on the same shard inputs; 2e-5, the class of
    tests/test_quant.py and tests/test_wkv.py."""
    _, jp, p = setup
    sp = t_sh.shard_params(p, _cpu_mesh(tp))
    j, l, B = tp - 1, 1, 3
    El = E_ // tp
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    x, xy, dd = f32(B, E_), f32(B, E_), f32(B, E_)
    aa, pp, bb = f32(B, El), f32(B, El), np.abs(f32(B, El)) + 0.5
    col = lambda a, n=El: np.asarray(a)[..., j * n:(j + 1) * n]  # noqa: E731
    row = lambda a, n: np.asarray(a)[:, j * n:(j + 1) * n]  # noqa: E731
    A, F = jp.att, jp.ffn
    want_att = j_halves.att_half(
        jnp.int32(l), x, xy, jp.ln1.weight, jp.ln1.bias, A.mix_k, A.mix_v, A.mix_r,
        A.key.scale, A.value.scale, A.receptance.scale,
        A.key.offset, A.value.offset, A.receptance.offset,
        col(A.key.w), col(A.value.w), col(A.receptance.w),
        row(A.output.w, El), row(A.output.scale, El), row(A.output.offset, El),
        col(A.decay), col(A.bonus), aa, bb, pp, interpret=True)
    T = torch.from_numpy
    got_att = t_halves.att_half(sp.rows[0][j], l, T(x), T(xy), T(aa), T(bb), T(pp),
                                *sp.local(0, j))
    for name, g, w in zip(("partial", "aa", "bb", "pp"), got_att, want_att):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5, err_msg=name)
    xx = j_layer_norm(jnp.asarray(x), jp.ln1.weight[l], jp.ln1.bias[l])
    np.testing.assert_allclose(got_att[4].numpy(), np.asarray(xx), rtol=2e-5, atol=2e-5)

    Fl = 4 * El
    want_ffn = j_halves.ffn_half(
        jnp.int32(l), x, dd, jp.ln2.weight, jp.ln2.bias, F.mix_k, F.mix_r,
        F.key.scale, F.key.offset, F.receptance.scale, F.receptance.offset,
        col(F.key.w, Fl), col(F.receptance.w), row(F.value.w, Fl),
        row(F.value.scale, Fl), row(F.value.offset, Fl), interpret=True)
    got_ffn = t_halves.ffn_half(sp.rows[0][j], l, T(x), T(dd))
    for name, g, w in zip(("vpartial", "gate"), got_ffn, want_ffn):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5, err_msg=name)
    xx2 = j_layer_norm(jnp.asarray(x), jp.ln2.weight[l], jp.ln2.bias[l])
    np.testing.assert_allclose(got_ffn[2].numpy(), np.asarray(xx2), rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """The JAX make_tp_step(body="pallas", interpret=True) over 4 carried
    steps, per (model, data) mesh: [(logits, state)]."""
    cfg, jp, _ = setup
    cache = {}

    def get(model, data):
        if (model, data) not in cache:
            jmesh = j_mesh.make_mesh(model=model, data=data)
            step = j_tp.make_tp_step(jmesh, jp, body="pallas", interpret=True)
            psh = j_sh.shard_params(jp, jmesh)
            out = []
            with jax.sharding.set_mesh(jmesh):
                st = j_sh.shard_state(j_m.init_state(cfg, (2,)), jmesh, batched=True)
                for tok in TOKENS:
                    lg, st = step(psh, jnp.asarray(tok, jnp.int32), st)
                    out.append((np.asarray(lg), [np.asarray(s) for s in st]))
            cache[model, data] = out
        return cache[model, data]

    return get


@pytest.mark.parametrize("model,data", [(4, 2), (1, 1)])
@pytest.mark.parametrize("body", ["plain", "halves"])
def test_tp_step_matches_jax_and_unsharded(setup, jax_steps, model, data, body):
    """Both bodies over 4 carried steps: logits and all five state tensors
    within 3e-4 of the JAX step and of the port's unsharded forward_step,
    and exactly 2L + 1 psums and L + 1 gathers a step at tp >= 2 (none at
    tp = 1)."""
    cfg, _, p = setup
    mesh = _cpu_mesh(model, data)
    sp = t_sh.shard_params(p, mesh)
    step = t_tp.make_tp_step(mesh, sp, body=body)
    assert step.body == body
    st = st_ref = t_m.init_state(cfg, (2,))
    want = (2 * L_ + 1, L_ + 1) if model > 1 else (0, 0)
    for tok, (j_logits, j_state) in zip(TOKENS, jax_steps(model, data)):
        tok = torch.tensor(tok)
        mesh.reset_collectives()
        logits, st = step(sp, tok, st)
        assert (mesh.collectives["psum"], mesh.collectives["all_gather"]) == want
        ref, st_ref = t_m.forward_step(p, tok, st_ref)
        np.testing.assert_allclose(logits.numpy(), j_logits, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=TOL, atol=TOL)
        for name, a, b, c in zip(t_m.WKVState._fields, st, j_state, st_ref):
            np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL, err_msg=name)
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("model", [1, 2])
def test_cpu_halves_step_is_eager_and_counts(setup, model):
    """On a CPU mesh the halves step is not replayed from a CUDA graph: every
    call runs the body eagerly, with the same results as the body itself,
    and counts its collectives anew: 2L + 1 psums and L + 1 gathers (3L + 2)
    a call at tp = 2, none at tp = 1."""
    cfg, _, p = setup
    mesh = _cpu_mesh(model)
    sp = t_sh.shard_params(p, mesh)
    step = t_tp.make_tp_step(mesh, sp, body="halves")
    assert step.body == "halves" and not step.graphed
    want = {"psum": 2 * L_ + 1, "all_gather": L_ + 1} if model > 1 else {"psum": 0,
                                                                          "all_gather": 0}
    st = t_m.init_state(cfg, (2,))
    for tok in TOKENS[:3]:
        tok = torch.tensor(tok)
        mesh.reset_collectives()
        logits, new = step(sp, tok, st)
        assert mesh.collectives == want
        assert sum(mesh.collectives.values()) == (3 * L_ + 2 if model > 1 else 0)
        ref_logits, ref = step.eager(sp, tok, st)
        assert torch.equal(logits, ref_logits)
        for a, b in zip(new, ref):
            assert torch.equal(a, b)
        st = new


def test_tp_step_auto_body_selection(setup):
    """body=None picks halves when E/tp is a multiple of 128, plain otherwise."""
    _, _, p = setup
    assert t_tp.make_tp_step(_cpu_mesh(4), p).body == "halves"
    assert t_tp.make_tp_step(_cpu_mesh(2), t_sh.shard_params(p, _cpu_mesh(2))).body == "halves"
    narrow = to_port(_jax_params(RWKVConfig.tiny_test(n_layer=1, n_embd=128, vocab_size=211), 2))
    assert t_tp.make_tp_step(_cpu_mesh(4), narrow).body == "plain"


@pytest.mark.parametrize("model,data", [(4, 2), (1, 2)])
def test_tp_prefill_matches_unsharded_and_counts(setup, model, data):
    """The ragged [T, B] prefill and the full-chunk adapter: forward_seq's
    results within 5e-4 (tests/test_tp_step.py's prefill pin), and 3L + 2
    collectives per call at tp >= 2, none at tp = 1."""
    cfg, _, p = setup
    mesh = _cpu_mesh(model, data)
    sp = t_sh.shard_params(p, mesh)
    T, B = 12, 3  # B = 3 pads to 4 on data = 2
    toks = torch.from_numpy(np.arange(T * B).reshape(T, B) % cfg.vocab_size)
    lens = torch.tensor([T, T - 3, 0])
    pre = t_tp.make_engine_prefill(mesh, sp)
    want = (2 * L_ + 1, L_ + 1) if model > 1 else (0, 0)
    for length in (lens, None):
        mesh.reset_collectives()
        got, st = pre(sp, toks, t_m.init_state(cfg, (B,)), length)
        assert (mesh.collectives["psum"], mesh.collectives["all_gather"]) == want
        ref, st_ref = t_m.forward_seq(p, toks, t_m.init_state(cfg, (B,)), parallel=True,
                                      length=length)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=5e-4, atol=5e-4)
        for name, a, b in zip(t_m.WKVState._fields, st, st_ref):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4, atol=5e-4, err_msg=name)
    # unbatched [T] tokens with a scalar length
    got, _ = pre(sp, toks[:, 0], t_m.init_state(cfg), 7)
    ref, _ = t_m.forward_seq(p, toks[:, 0], t_m.init_state(cfg), parallel=True, length=7)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=5e-4, atol=5e-4)


def _guard(case, setup):
    cfg, jp, p = setup
    mesh = _cpu_mesh(4)
    if case == "unpadded_vocab":
        raw = j_m.signedize_params(j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(0),
                                                                       cfg)))
        t_tp.make_tp_step(mesh, to_port(raw))
    elif case == "dense":
        dense = j_m.pad_vocab(j_m.init_params(jax.random.PRNGKey(0), cfg), multiple=512)
        t_tp.make_tp_step(mesh, to_port(dense))
    elif case == "halves_narrow":
        cfg2 = RWKVConfig.tiny_test(n_layer=1, n_embd=128, vocab_size=211)
        t_tp.make_tp_step(mesh, to_port(_jax_params(cfg2, 2)), body="halves")
    elif case == "q4":  # 4-bit params run only through the fused body
        q4 = t_m.params_to(t_m.random_quantized_params_np(
            RWKVConfig(n_layer=1, n_embd=512, vocab_size=211), q4=True), "cpu")
        t_tp.make_tp_step(mesh, q4, body="halves")
    elif case == "fused":  # E / tp = 32: not a multiple of 128
        cfg2 = RWKVConfig.tiny_test(n_layer=1, n_embd=128, vocab_size=211)
        t_tp.make_tp_step(mesh, to_port(_jax_params(cfg2, 2)), body="fused")
    elif case == "a8_mesh":
        RWKV(device="cpu", sharding=mesh).load_params(p, a8=True)


@pytest.mark.parametrize("case,exc", [
    ("unpadded_vocab", ValueError), ("dense", TypeError), ("halves_narrow", ValueError),
    ("q4", ValueError), ("fused", ValueError), ("a8_mesh", ValueError)])
def test_tp_step_guards(setup, case, exc):
    with pytest.raises(exc):
        _guard(case, setup)


@pytest.fixture(scope="module")
def binfile(tmp_path_factory):
    """A .bin at E = 512 (E / tp = 128 at tp = 4: the halves body runs), L = 2."""
    from rwkv_tpu_torch.io.binfmt import write_bin

    path = str(tmp_path_factory.mktemp("tp") / "m512.bin")
    write_bin(path, t_m.random_quantized_params_np(RWKVConfig(n_layer=2, n_embd=512), seed=21,
                                                   pad_multiple=None))
    return path


def _greedy(forward, n=8):
    logits, ids = forward([3, 4, 5]), []
    for _ in range(n):
        ids.append(int(np.argmax(np.asarray(logits))))
        logits = forward(ids[-1])
    return ids


def test_sharded_engine_matches_jax_sharded_engine(binfile):
    """RWKV(path, sharding=mesh) on a tp = 4 CPU mesh against the JAX sharded
    engine on the same file (tests/test_engine_sharded.py): forward([3, 4,
    5]) within 3e-4 on the real vocab, the padded tail masked, and the same
    8 greedy ids."""
    from rwkv_tpu.parallel.sharding import ShardingContext
    from rwkv_tpu.runtime.engine import RWKV as JRWKV

    eng = RWKV(binfile, device="cpu", sharding=_cpu_mesh(4))
    assert eng._step_fn.body == "halves" and isinstance(eng.params, t_sh.ShardedParams)
    assert eng.params.rows[0][1].att.key.w.shape == (2, 512, 128)
    jmesh = j_mesh.make_mesh(model=4, data=1)
    with jax.sharding.set_mesh(jmesh):
        jeng = JRWKV(sharding=ShardingContext(jmesh))
        jeng.load_file(binfile)
        want = np.asarray(jeng.forward([3, 4, 5]))
        jeng.reset_state()
        want_ids = _greedy(jeng.forward)
    got = eng.forward([3, 4, 5]).numpy()
    V = 50277
    assert got.shape == want.shape == (V,)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    eng.reset_state()
    full = eng.forward(list(range(40)), stream=0)  # a longer prompt: bucket 128, masked
    assert np.isfinite(full.numpy()).all()
    internal = eng._last_logits[0].numpy()
    assert internal.shape == (eng.config.vocab_size,) and (internal[V:] < -1e8).all()
    eng.reset_state()
    assert _greedy(lambda t: eng.forward(t).numpy()) == want_ids


# The pool over the sharded engine, against the JAX pool over the JAX
# sharded engine, text for text at tau = 0 on a byte-level tokenizer (256
# ids, no merges), as tests/test_torch_pool.py compares the unsharded pools.
PROMPTS = ["Hi", "The quick brown", "In a hole", "Answer:"]


def _byte_tokenizers():
    from rwkv_tpu.tokenizer.bpe import BPETokenizer as JTokenizer
    from rwkv_tpu.tokenizer.bpe import bytes_to_unicode
    from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer

    enc = {c: b for b, c in bytes_to_unicode().items()}
    return JTokenizer(enc, []), BPETokenizer(enc, [])


@pytest.mark.parametrize("model,data,E", [(4, 1, 512), (2, 2, 256)])
def test_pool_over_sharded_engine_matches_jax_pool(model, data, E):
    from rwkv_tpu.parallel.sharding import ShardingContext
    from rwkv_tpu.runtime.engine import RWKV as JRWKV
    from rwkv_tpu.runtime.pool import InferencePool as JPool
    from rwkv_tpu_torch.runtime.pool import InferencePool

    jtok, ttok = _byte_tokenizers()
    jp = j_m.signedize_params(j_m.quantize_params(j_m.init_params(
        jax.random.PRNGKey(3), RWKVConfig(n_layer=2, n_embd=E, vocab_size=256))))
    eng = RWKV(device="cpu", sharding=_cpu_mesh(model, data), max_streams=4)
    eng.load_params(to_port(jp))
    assert eng._step_fn.body == "halves"

    def serve(pool_cls, e, tok, n=4, **kw):
        pool = pool_cls(e.params, tok, max_streams=4, prefill_bucket=8, step_fn=e._step_fn,
                        prefill_fn=e._prefill_impl)
        rids = [pool.submit(PROMPTS[i % 4], max_tokens=6, temp=0.7 + 0.1 * i, tau=0.0, seed=i,
                            **kw) for i in range(n)]
        out = pool.run()
        assert sorted(out) == sorted(rids) and pool.pending == 0
        return [out[r] for r in rids]

    more = serve(InferencePool, eng, ttok, n=6)  # more requests than slots
    assert all(isinstance(t, str) and t for t in more)
    jmesh = j_mesh.make_mesh(model=model, data=data)
    with jax.sharding.set_mesh(jmesh):
        jeng = JRWKV(sharding=ShardingContext(jmesh), max_streams=4)
        jeng.load_params(jp)
        want = serve(JPool, jeng, jtok)
    assert serve(InferencePool, eng, ttok) == want

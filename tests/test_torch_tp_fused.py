"""The port's fused tensor-parallel step (body "fused": kernel K7's plain
version, rwkv_tpu_torch/ops/cuda/decode_stack_tp.py) and 4-bit tensor
parallel against the JAX package on the CPU.

The JAX side runs as its own tests run it (tests/test_decode_stack_tp.py):
at tp = 1 decode_stack_tp in interpret mode; at tp >= 2 make_tp_step(body=
"fused") with Pallas's TPU interpreter simulating the in-kernel exchanges on
the suite's virtual CPU devices, which takes seconds a step, so the JAX fused
steps here are few and the port's carried steps are also held against its
own unsharded forward_step. The port's meshes name the CPU several times."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import to_port
from test_torch_tp import PROMPTS, _byte_tokenizers, _greedy

from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.ops.layernorm import layer_norm as j_layer_norm
from rwkv_tpu.ops.pallas.decode_stack_tp import decode_stack_tp as j_decode_stack_tp
from rwkv_tpu.parallel import mesh as j_mesh
from rwkv_tpu.parallel import sharding as j_sh
from rwkv_tpu.parallel import tp_step as j_tp
from rwkv_tpu_torch.models import rwkv4 as t_m
from rwkv_tpu_torch.ops.cuda import decode_stack_tp as t_k7
from rwkv_tpu_torch.ops.cuda.decode_stack import forward_step_fused
from rwkv_tpu_torch.ops.quant import QuantLinear
from rwkv_tpu_torch.parallel import mesh as t_mesh
from rwkv_tpu_torch.parallel import sharding as t_sh
from rwkv_tpu_torch.parallel import tp_step as t_tp
from rwkv_tpu_torch.runtime.engine import RWKV

L_, E_ = 2, 512
TOKENS = [[3, 150], [7, 42], [200, 1], [5, 99]]  # 4 carried steps, B = 2
JAX_STEP = 2  # the carried step also run through the JAX fused step (seconds each)
TOL = 3e-4  # tests/test_decode_stack_tp.py's pin for the step


def _cpu_mesh(model, data=1):
    return t_mesh.make_mesh(model=model, data=data, devices=["cpu"] * (model * data))


@pytest.fixture(scope="module")
def setup():
    """E = 512 (E / tp = 128 at tp = 4), L = 2, vocab 211 padded to 512
    (each shard's vocab a multiple of 128 up to tp = 4)."""
    cfg = RWKVConfig.tiny_test(n_layer=L_, n_embd=E_, vocab_size=211)
    jp = j_m.signedize_params(j_m.pad_vocab(
        j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(1), cfg)), multiple=512))
    return cfg, jp, to_port(jp)


@pytest.fixture(scope="module")
def setup_q4():
    """4-bit, E = 256, L = 2, vocab 300 padded to 512; the row-parallel
    families packed in blocks of 128 = E / 2 (tests/test_decode_stack_tp.py's
    q4 model)."""
    cfg = RWKVConfig.tiny_test(n_layer=L_, n_embd=256, vocab_size=300)
    jp = j_m.pad_vocab(j_m.quantize_params_q4(j_m.init_params(jax.random.PRNGKey(0), cfg),
                                              tile=128), multiple=512)
    return cfg, jp, to_port(jp)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def test_tp1_reference_matches_jax_kernel(setup):
    """decode_stack_tp_reference at tp = 1 against the JAX kernel in interpret
    mode over 4 carried steps at B = 2: the first within 2e-4, the others
    within 3e-4 (the pins of tests/test_decode_stack_tp.py)."""
    cfg, jp, p = setup
    local = [(p.att.decay, p.att.bonus)]
    j_st, t_st = j_m.init_state(cfg, (2,)), t_m.init_state(cfg, (2,))
    for i, tok in enumerate(TOKENS):
        tok = jnp.asarray(tok, jnp.int32)
        x = j_layer_norm(jp.emb[tok].astype(jnp.float32), jp.ln0.weight, jp.ln0.bias)
        j_lg, j_st = j_decode_stack_tp(x, jp, j_st, jp.att.decay, jp.att.bonus, tp=1,
                                       tile=128, interpret=True, data_axis=None)
        (t_lg,), (t_st,) = t_k7.decode_stack_tp_reference([p], [t_st], local,
                                                           x=torch.tensor(np.asarray(x)))
        tol = 2e-4 if i == 0 else 3e-4
        _close(t_lg.numpy(), j_lg, tol, f"step {i} logits")
        for name, a, b in zip(t_m.WKVState._fields, t_st, j_st):
            _close(a.numpy(), b, tol, f"step {i} {name}")


def _jax_fused_step(setup, model, data, tok, state):
    """One JAX make_tp_step(body="fused") step of the setup's model from a
    given state (numpy leaves [L, B, E]): (logits, state leaves) in numpy."""
    from jax.experimental.pallas import tpu as pltpu

    _, jp, _ = setup
    jmesh = j_mesh.make_mesh(model=model, data=data)
    step = j_tp.make_tp_step(jmesh, jp, body="fused", interpret=pltpu.InterpretParams())
    with jax.sharding.set_mesh(jmesh):
        st = j_sh.shard_state(j_m.WKVState(*(jnp.asarray(s) for s in state)), jmesh,
                              batched=True)
        lg, st = step(j_sh.shard_params(jp, jmesh), jnp.asarray(tok, jnp.int32), st)
        return np.asarray(lg), [np.asarray(s) for s in st]


@pytest.mark.parametrize("model,data", [(1, 1), (2, 1), (4, 1), (2, 2)])
def test_fused_step_matches_jax_and_unsharded(setup, model, data):
    """The fused body over 4 carried steps: logits and all five state tensors
    within 3e-4 of the port's unsharded forward_step at every step and, at tp
    >= 2, of the JAX fused step from the same carried state at step
    JAX_STEP; 0 psums and 1 gather a step at tp >= 2 and B <= 8 per data row
    (tests/test_decode_stack_tp.py's pins), none at tp = 1."""
    cfg, _, p = setup
    mesh = _cpu_mesh(model, data)
    sp = t_sh.shard_params(p, mesh)
    step = t_tp.make_tp_step(mesh, sp, body="fused")
    assert step.body == "fused"
    st = st_ref = t_m.init_state(cfg, (2,))
    for i, tok in enumerate(TOKENS):
        jax_here = i == JAX_STEP and model > 1
        if jax_here:
            want = _jax_fused_step(setup, model, data, tok, [s.numpy() for s in st])
        tok = torch.tensor(tok)
        mesh.reset_collectives()
        logits, st = step(sp, tok, st)
        assert mesh.collectives == ({"psum": 0, "all_gather": 1} if model > 1
                                    else {"psum": 0, "all_gather": 0})
        ref, st_ref = t_m.forward_step(p, tok, st_ref)
        _close(logits.numpy(), ref.numpy(), TOL, f"step {i} logits vs unsharded")
        for name, a, b in zip(t_m.WKVState._fields, st, st_ref):
            _close(a.numpy(), b.numpy(), TOL, f"step {i} {name} vs unsharded")
        if jax_here:
            _close(logits.numpy(), want[0], TOL, f"step {i} logits vs JAX")
            for name, a, b in zip(t_m.WKVState._fields, st, want[1]):
                _close(a.numpy(), b, TOL, f"step {i} {name} vs JAX")


def test_fused_large_batch_takes_the_embedding_psum(setup):
    """B = 10 > 8 at tp = 2: the mesh's embedding psum feeds K7 an x (1 psum
    and 1 gather a step), against the JAX fused step
    (tests/test_decode_stack_tp.py's B = 10 pin) and the unsharded step."""
    cfg, _, p = setup
    mesh = _cpu_mesh(2)
    sp = t_sh.shard_params(p, mesh)
    step = t_tp.make_tp_step(mesh, sp, body="fused")
    tok = np.arange(10) * 29 % cfg.vocab_size
    state = t_m.init_state(cfg, (10,))
    j_logits, j_state = _jax_fused_step(setup, 2, 1, tok, [s.numpy() for s in state])
    mesh.reset_collectives()
    logits, st = step(sp, torch.from_numpy(tok), state)
    assert mesh.collectives == {"psum": 1, "all_gather": 1}
    ref, st_ref = t_m.forward_step(p, torch.from_numpy(tok), state)
    _close(logits.numpy(), j_logits, TOL, "logits vs JAX")
    _close(logits.numpy(), ref.numpy(), TOL, "logits vs unsharded")
    for name, a, b, c in zip(t_m.WKVState._fields, st, j_state, st_ref):
        _close(a.numpy(), b, TOL, f"{name} vs JAX")
        _close(a.numpy(), c.numpy(), TOL, f"{name} vs unsharded")


def test_q4_fused_matches_jax_and_unsharded(setup_q4):
    """4-bit weights at tp = 2 (body=None: q4 forces "fused") over 3 carried
    steps, within 3e-4 of the port's unsharded q4 forward_step_fused (its
    plain version on the CPU) at each, and of the JAX fused q4 step from the
    same carried state at the last."""
    cfg, _, p = setup_q4
    mesh = _cpu_mesh(2)
    sp = t_sh.shard_params(p, mesh)
    assert sp.rows[0][1].att.output.wp.shape == (L_, 64, 256)
    step = t_tp.make_tp_step(mesh, sp)
    assert step.body == "fused"
    toks = ((3, 150), (77, 299), (8, 1))
    st = st_ref = t_m.init_state(cfg, (2,))
    for i, tok in enumerate(toks):
        if i == len(toks) - 1:
            want = _jax_fused_step(setup_q4, 2, 1, tok, [s.numpy() for s in st])
        tok = torch.tensor(tok)
        mesh.reset_collectives()
        logits, st = step(sp, tok, st)
        assert mesh.collectives == {"psum": 0, "all_gather": 1}
        ref, st_ref = forward_step_fused(p, tok, st_ref)
        _close(logits.numpy(), ref.numpy(), TOL, f"step {i} logits vs unsharded")
        for name, a, b in zip(t_m.WKVState._fields, st, st_ref):
            _close(a.numpy(), b.numpy(), TOL, f"step {i} {name} vs unsharded")
    _close(logits.numpy(), want[0], TOL, "logits vs JAX")
    for name, a, b in zip(t_m.WKVState._fields, st, want[1]):
        _close(a.numpy(), b, TOL, f"{name} vs JAX")


@pytest.fixture(scope="module")
def binfile(tmp_path_factory):
    """A .bin at E = 512, L = 2 (E / tp = 256 at tp = 2)."""
    from rwkv_tpu_torch.io.binfmt import write_bin

    path = str(tmp_path_factory.mktemp("fused") / "m512.bin")
    write_bin(path, t_m.random_quantized_params_np(RWKVConfig(n_layer=2, n_embd=512), seed=21,
                                                   pad_multiple=None))
    return path


def test_fused_engine_matches_jax_sharded_engine(binfile):
    """RWKV(path, sharding=mesh, tp_body="fused") on a tp = 2 CPU mesh gives
    the JAX sharded engine's 8 greedy ids on the same file, and its first
    logits within 3e-4 on the real vocab."""
    from rwkv_tpu.parallel.sharding import ShardingContext
    from rwkv_tpu.runtime.engine import RWKV as JRWKV

    mesh = _cpu_mesh(2)
    eng = RWKV(binfile, device="cpu", sharding=mesh, tp_body="fused")
    assert eng._step_fn.body == "fused" and eng.quant == "q8"
    jmesh = j_mesh.make_mesh(model=2, data=1)
    with jax.sharding.set_mesh(jmesh):
        jeng = JRWKV(sharding=ShardingContext(jmesh))
        jeng.load_file(binfile)
        want = np.asarray(jeng.forward([3, 4, 5]))
        jeng.reset_state()
        want_ids = _greedy(jeng.forward)
    got = eng.forward([3, 4, 5]).numpy()
    _close(got, want, TOL, "first logits")
    eng.reset_state()
    mesh.reset_collectives()
    eng.forward(7)
    assert mesh.collectives == {"psum": 0, "all_gather": 1}
    eng.reset_state()
    assert _greedy(lambda t: eng.forward(t).numpy()) == want_ids


def test_q4_sharded_engine_matches_unsharded_q4_engine(setup_q4, tmp_path):
    """A q4 engine on a tp = 2 mesh gives the unsharded q4 engine's greedy
    text (tests/test_engine_q4.py's sharded q4 pin), is tagged quant "q4",
    and a dense checkpoint loaded with quant="q4" under the mesh is packed
    in blocks that lie inside a shard (q4_pack_block(E, tp))."""
    from rwkv_tpu.io.safetensors import write_safetensors
    from tests.test_safetensors import _blinkdl_state_dict

    _, _, p = setup_q4
    tok = _byte_tokenizers()[1]  # ids < 256: inside the 300-token vocab
    ref = RWKV(device="cpu", quant="q4")
    ref.load_params(p)
    eng = RWKV(device="cpu", sharding=_cpu_mesh(2), quant="q4")
    eng.load_params(p)
    assert eng.quant == "q4" and eng._step_fn.body == "fused"
    want = tok.decode(_greedy(lambda t: ref.forward(t).numpy()))
    assert tok.decode(_greedy(lambda t: eng.forward(t).numpy())) == want

    path = str(tmp_path / "dense.safetensors")
    write_safetensors(path, _blinkdl_state_dict(n_layer=1, n_embd=256, vocab=300, seed=4))
    dense = RWKV(path, device="cpu", sharding=_cpu_mesh(2), quant="q4")
    shard = dense.params.rows[0][1]
    assert dense.quant == "q4" and dense._step_fn.body == "fused"
    assert shard.att.output.block == shard.ffn.value.block == t_m.q4_pack_block(256, 2) == 128
    assert np.isfinite(dense.forward([1, 2, 3]).numpy()).all()



def test_pool_over_fused_engine_matches_jax_pool():
    """A 4-slot pool over the fused tp = 2 engine against the JAX pool over
    the JAX sharded engine, text for text at tau = 0 on a byte-level
    tokenizer (tests/test_torch_tp.py's pool comparison)."""
    from rwkv_tpu.parallel.sharding import ShardingContext
    from rwkv_tpu.runtime.engine import RWKV as JRWKV
    from rwkv_tpu.runtime.pool import InferencePool as JPool
    from rwkv_tpu_torch.runtime.pool import InferencePool

    jtok, ttok = _byte_tokenizers()
    jp = j_m.signedize_params(j_m.quantize_params(j_m.init_params(
        jax.random.PRNGKey(3), RWKVConfig(n_layer=2, n_embd=256, vocab_size=256))))
    eng = RWKV(device="cpu", sharding=_cpu_mesh(2), max_streams=4, tp_body="fused")
    eng.load_params(to_port(jp))
    assert eng._step_fn.body == "fused"

    def serve(pool_cls, e, tok):
        pool = pool_cls(e.params, tok, max_streams=4, prefill_bucket=8, step_fn=e._step_fn,
                        prefill_fn=e._prefill_impl)
        rids = [pool.submit(PROMPTS[i], max_tokens=6, temp=0.7 + 0.1 * i, tau=0.0, seed=i)
                for i in range(4)]
        out = pool.run()
        assert sorted(out) == sorted(rids) and pool.pending == 0
        return [out[r] for r in rids]

    jmesh = j_mesh.make_mesh(model=2, data=1)
    with jax.sharding.set_mesh(jmesh):
        jeng = JRWKV(sharding=ShardingContext(jmesh), max_streams=4)
        jeng.load_params(jp)
        want = serve(JPool, jeng, jtok)
    assert serve(InferencePool, eng, ttok) == want


def _narrow():
    """E = 128: E / tp = 32 at tp = 4."""
    return t_m.params_to(t_m.signedize_params(t_m.random_quantized_params_np(
        RWKVConfig(n_layer=1, n_embd=128, vocab_size=211))), "cpu")


def test_auto_body_rule(setup, setup_q4):
    """body=None: "halves" on CPU meshes (as JAX picks its Pallas body on a
    CPU backend), "fused" forced by 4-bit params, "plain" where neither
    kernel body is eligible."""
    _, _, p = setup
    assert t_tp.make_tp_step(_cpu_mesh(2), t_sh.shard_params(p, _cpu_mesh(2))).body == "halves"
    assert t_tp.make_tp_step(_cpu_mesh(2, 2), p).body == "halves"
    assert t_tp.make_tp_step(_cpu_mesh(2), setup_q4[2]).body == "fused"
    assert t_tp.make_tp_step(_cpu_mesh(4), _narrow()).body == "plain"


def _fused_guard(case, setup, setup_q4):
    cfg, _, p = setup
    if case == "q4_block_straddles":
        # blocks of 256 rows at tp = 4 (64 rows per shard of att.output)
        t_sh.shard_params(t_m.params_to(t_m.random_quantized_params_np(
            RWKVConfig(n_layer=1, n_embd=256, vocab_size=211), q4=True), "cpu"), _cpu_mesh(4))
    elif case == "narrow":
        t_tp.make_tp_step(_cpu_mesh(4), _narrow(), body="fused")
    elif case == "distinct_devices":
        mesh = t_mesh.make_mesh(model=2, devices=["cpu", "meta"])
        t_tp.make_tp_step(mesh, p, body="fused")
    elif case == "q4_narrow":
        t_tp.make_tp_step(_cpu_mesh(4), setup_q4[2])
    elif case == "embed_batch":
        sp = t_sh.shard_params(p, _cpu_mesh(2))
        st = t_sh.shard_state(t_m.init_state(cfg, (9,)), sp.mesh)[0]
        t_k7.decode_stack_tp(sp.rows[0], st, [sp.local(0, j) for j in range(2)],
                             token=torch.zeros(9, dtype=torch.int64))
    elif case == "uint8":
        raw = dataclasses.replace(p, head=QuantLinear(
            w=p.head.w.to(torch.uint8), scale=p.head.scale, offset=p.head.offset))
        t_k7.decode_stack_tp_reference([raw], [t_m.init_state(cfg, (1,))],
                                       [(raw.att.decay, raw.att.bonus)],
                                       token=torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("case,exc", [
    ("q4_block_straddles", ValueError), ("narrow", ValueError),
    ("distinct_devices", ValueError), ("q4_narrow", ValueError),
    ("embed_batch", ValueError), ("uint8", TypeError)])
def test_fused_guards(setup, setup_q4, case, exc):
    """A q4 pack block that straddles shards, E / tp not a multiple of 128 (q8
    asked for "fused", and q4, which forces it), a data row over distinct
    devices, the in-step embedding gather past B = 8, and unsigned weights
    each raise."""
    with pytest.raises(exc):
        _fused_guard(case, setup, setup_q4)

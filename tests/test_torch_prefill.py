"""bf16 prefill on the port (forward_seq(compute_dtype=), qmatmul/q4matmul,
RWKV(prefill_dtype=), InferencePool(prefill_dtype=), the TP prefill) against
the JAX package's on the same params (CPU).

The bf16 pin is the JAX package's own for bf16 arithmetic (the q4_bf16 pin of
tests/test_decode_stack.py): 3e-2 scaled error, max|port - jax| /
max(1, max|jax|). Both packages round the same float32 numbers to bf16 and
sum the products in float32, so they differ only where a float32 sum in
another order moves a value across a bf16 rounding boundary; the largest
scaled error measured here is well under 1e-2 (each test prints its own).
float32 stays at the existing pins: tests/test_model.py's 2e-4 for
sequences, tests/test_quant.py's for the products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import to_port

from rwkv_tpu.io.binfmt import write_bin as j_write_bin
from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.ops import quant as j_quant
from rwkv_tpu.runtime.engine import RWKV as JRWKV
from rwkv_tpu.runtime.pool import InferencePool as JPool
from rwkv_tpu.tokenizer.bpe import BPETokenizer as JTokenizer
from rwkv_tpu_torch.models import rwkv4 as t_m
from rwkv_tpu_torch.ops import quant as t_quant
from rwkv_tpu_torch.runtime.engine import RWKV
from rwkv_tpu_torch.runtime.pool import InferencePool
from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer

BF16_TOL = 3e-2
F32_TOL = 2e-4
L_, E_, T_, B_ = 2, 64, 37, 3


def _scaled(t, j) -> float:
    a, b = np.asarray(t, np.float64), np.asarray(j, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.fixture(scope="module")
def families():
    """q8, q4 (row-tiled families paired in blocks of 32) and dense params
    at L = 2, E = 64, vocab 211: the JAX tree and the port's copy. The q8
    codes are re-centered to int8 on both sides, as the port's copy is: in
    bf16, (x*r) @ (W - 128) + x.(o + 128 r) is not (x*r) @ W + x.o, since
    the bf16 rounding of x*r is multiplied by 128 and not cancelled."""
    cfg = RWKVConfig.tiny_test(n_layer=L_, n_embd=E_, vocab_size=211)
    dense = j_m.init_params(jax.random.PRNGKey(21), cfg)
    out = {"q8": j_m.signedize_params(j_m.quantize_params(dense)),
           "q4": j_m.quantize_params_q4(dense, tile=32),
           "dense": dense}
    return cfg, {k: (jp, to_port(jp)) for k, jp in out.items()}


def _start_states(cfg, jp, batch):
    """A non-empty start state, the same in both packages."""
    toks = np.arange(5 * int(np.prod(batch, dtype=int))).reshape((5,) + batch) % 200
    js = j_m.forward_seq(jp, jnp.asarray(toks), j_m.init_state(cfg, batch))[1]
    return js, t_m.WKVState(*(torch.from_numpy(np.array(s)) for s in js))


@pytest.mark.parametrize("family", ["q8", "q4", "dense"])
@pytest.mark.parametrize("mode", ["scalar_length", "ragged", "sequential"])
def test_bf16_forward_seq_matches_jax(families, family, mode):
    cfg, fam = families
    jp, tp = fam[family]
    rng = np.random.default_rng(7)
    batch = (B_,) if mode == "ragged" else ()
    toks = rng.integers(0, cfg.vocab_size, size=(T_,) + batch)
    j0, t0 = _start_states(cfg, jp, batch)
    if mode == "ragged":
        lens = np.array([T_, 20, 0])
        kw_j = dict(parallel=True, length=jnp.asarray(lens))
        kw_t = dict(parallel=True, length=torch.from_numpy(lens))
    elif mode == "scalar_length":
        kw_j = dict(parallel=True, length=jnp.asarray(29))
        kw_t = dict(parallel=True, length=29)
    else:
        kw_j = kw_t = dict(parallel=False)
    lj, sj = j_m.forward_seq(jp, jnp.asarray(toks), j0, compute_dtype=jnp.bfloat16, **kw_j)
    lt, st = t_m.forward_seq(tp, torch.from_numpy(toks), t0, compute_dtype=torch.bfloat16,
                             **kw_t)
    assert lt.dtype == torch.float32 and lt.shape == tuple(lj.shape)
    errs = [_scaled(lt, lj)] + [_scaled(a, b) for a, b in zip(st, sj)]
    print(f"{family} {mode}: bf16 scaled error, logits {errs[0]:.2e}, state {max(errs[1:]):.2e}")
    assert max(errs) <= BF16_TOL, errs
    # and bf16 is not float32: the rounding shows in the logits
    lf, _ = t_m.forward_seq(tp, torch.from_numpy(toks), t0, **kw_t)
    assert not torch.equal(lf, lt)


@pytest.mark.parametrize("family", ["q8", "q4", "dense"])
def test_f32_forward_seq_unchanged(families, family):
    """compute_dtype=float32 is the default, bit for bit, and still at the
    JAX package's f32 pin."""
    cfg, fam = families
    jp, tp = fam[family]
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(T_, B_))
    lens = np.array([T_, 11, 30])
    t0 = t_m.init_state(cfg, (B_,))
    lt, st = t_m.forward_seq(tp, torch.from_numpy(toks), t0, parallel=True,
                             length=torch.from_numpy(lens))
    lt2, st2 = t_m.forward_seq(tp, torch.from_numpy(toks), t0, parallel=True,
                               length=torch.from_numpy(lens), compute_dtype=torch.float32)
    assert torch.equal(lt, lt2) and all(torch.equal(a, b) for a, b in zip(st, st2))
    lj, sj = j_m.forward_seq(jp, jnp.asarray(toks), j_m.init_state(cfg, (B_,)), parallel=True,
                             length=jnp.asarray(lens))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=F32_TOL, atol=F32_TOL)
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_bf16_products_match_jax(rng, bits):
    """qmatmul / q4matmul with bf16 operands against the JAX functions: the
    output float32, within bf16's pin; float32 at tests/test_quant.py's."""
    w = rng.normal(size=(96, 40)).astype(np.float32)
    x = rng.normal(size=(5, 96)).astype(np.float32)
    if bits == 8:
        jq = j_quant.quantize(w, as_numpy=True)
        tq = t_quant.to_signed(t_quant.QuantLinear(
            *(torch.from_numpy(np.asarray(a)) for a in (jq.w, jq.scale, jq.offset))))
        jfn, tfn = j_quant.qmatmul, t_quant.qmatmul
    else:
        jq = j_quant.quantize4(w, block=32, as_numpy=True)
        tq = t_quant.Quant4Linear(*(torch.from_numpy(np.asarray(a))
                                    for a in (jq.wp, jq.scale, jq.offset)), block=32)
        jfn, tfn = j_quant.q4matmul, t_quant.q4matmul
    for t_dt, j_dt, tol in ((torch.bfloat16, jnp.bfloat16, BF16_TOL),
                            (torch.float32, jnp.float32, F32_TOL)):
        got = tfn(torch.from_numpy(x), tq, compute_dtype=t_dt)
        want = jfn(jnp.asarray(x), jq, compute_dtype=j_dt)
        assert got.dtype == torch.float32
        assert _scaled(got, want) <= tol, (t_dt, _scaled(got, want))


@pytest.fixture(scope="module")
def bin_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bin") / "l2-e64.bin")
    j_write_bin(path, j_m.random_quantized_params_np(RWKVConfig(n_layer=2, n_embd=64), seed=3,
                                                     pad_multiple=None))
    return path


def test_engine_bf16_load_context_matches_jax(bin_path):
    """RWKV(prefill_dtype=bf16) against the JAX engine's bf16 prefill: a
    prompt over two buckets (128 + a 32-token tail), the last logits and the
    state; float32 engines beside them at the f32 pin."""
    prompt = "The quick brown fox jumps over the lazy dog. " * 14
    for t_dt, j_dt, tol in ((torch.bfloat16, jnp.bfloat16, BF16_TOL),
                            (torch.float32, jnp.float32, 2e-3)):
        jeng = JRWKV(bin_path, prefill_dtype=j_dt)
        teng = RWKV(bin_path, device="cpu", prefill_dtype=t_dt)
        for e in (jeng, teng):
            e.load_tokenizer()
            e.prefill_buckets = (32, 128)
        assert len(teng.tokenizer.encode(prompt)) > 128
        jeng.load_context(prompt)
        teng.load_context(prompt)
        lj, lt = np.asarray(jeng._last_logits[0]), teng._last_logits[0].numpy()
        err = _scaled(lt[:50277], lj[:50277])
        serr = max(_scaled(a, b) for a, b in zip(teng.get_state(0), jeng.get_state(0)))
        print(f"engine {t_dt}: logits {err:.2e} state {serr:.2e}")
        assert err <= tol and serr <= tol, (t_dt, err, serr)


def test_engine_rejects_other_prefill_dtypes():
    with pytest.raises(ValueError):
        RWKV(device="cpu", prefill_dtype=torch.float16)


PROMPTS = ["Hi", "The quick brown", "In a hole", "Answer:"]


def test_pool_bf16_prefill_matches_jax_pool():
    """InferencePool(prefill_dtype=bf16) at tau 0 against the JAX pool with
    the same prefill dtype, text for text: 6 requests through 4 slots, prompts
    of 2 to 15 tokens over prefill chunks of 8. As in tests/test_torch_pool.py,
    a byte-level tokenizer over a 256-token vocab keeps the candidates of a
    random model far apart."""
    from rwkv_tpu.tokenizer.bpe import bytes_to_unicode

    enc = {c: b for b, c in bytes_to_unicode().items()}
    cfg = RWKVConfig(n_layer=2, n_embd=128, vocab_size=256)
    jp = j_m.signedize_params(j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(0), cfg)))

    def serve(pool):
        rids = [pool.submit(PROMPTS[i % 4] + " " * (i // 4), max_tokens=12, temp=0.7 + 0.1 * i,
                            tau=0.0, seed=i) for i in range(6)]
        out = pool.run()
        return [out[r] for r in rids]

    want = serve(JPool(jp, JTokenizer(enc, []), max_streams=4, prefill_bucket=8,
                       prefill_dtype=jnp.bfloat16))
    got = serve(InferencePool(to_port(jp), BPETokenizer(enc, []), max_streams=4,
                              prefill_bucket=8, prefill_dtype=torch.bfloat16))
    assert got == want
    assert all(t for t in got)


def test_tp_prefill_bf16_matches_jax():
    """The tensor-parallel prefill at tp = 2 on a virtual CPU mesh against
    JAX make_tp_prefill(compute_dtype=bf16): ragged lengths, logits and
    state; its head stays float32 in both."""
    from rwkv_tpu.parallel import mesh as j_mesh
    from rwkv_tpu.parallel import sharding as j_sh
    from rwkv_tpu.parallel import tp_step as j_tp
    from rwkv_tpu_torch.parallel import mesh as t_mesh
    from rwkv_tpu_torch.parallel import sharding as t_sh
    from rwkv_tpu_torch.parallel import tp_step as t_tp

    cfg = RWKVConfig.tiny_test(n_layer=L_, n_embd=E_, vocab_size=211)
    jp = j_m.signedize_params(j_m.pad_vocab(
        j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(4), cfg)), multiple=512))
    tp = to_port(jp)
    T, B = 12, 2
    toks = np.arange(T * B).reshape(T, B) % cfg.vocab_size
    lens = np.array([T, T - 3])
    jmesh = j_mesh.make_mesh(model=2, data=1)
    pre = j_tp.make_tp_prefill(jmesh, jp, compute_dtype=jnp.bfloat16)
    with jax.sharding.set_mesh(jmesh):
        lj, sj = pre(j_sh.shard_params(jp, jmesh), jnp.asarray(toks, jnp.int32),
                     j_sh.shard_state(j_m.init_state(cfg, (B,)), jmesh, batched=True),
                     jnp.asarray(lens, jnp.int32))
    tmesh = t_mesh.make_mesh(model=2, devices=["cpu"] * 2)
    sp = t_sh.shard_params(tp, tmesh)
    tpre = t_tp.make_engine_prefill(tmesh, sp, compute_dtype=torch.bfloat16)
    lt, st = tpre(sp, torch.from_numpy(toks), t_m.init_state(cfg, (B,)), torch.from_numpy(lens))
    errs = [_scaled(lt, lj)] + [_scaled(a, b) for a, b in zip(st, sj)]
    print(f"tp = 2 bf16 prefill: logits {errs[0]:.2e}, state {max(errs[1:]):.2e}")
    assert max(errs) <= BF16_TOL, errs
    # the engine passes its prefill_dtype to the sharded prefill
    eng = RWKV(device="cpu", sharding=tmesh, prefill_dtype=torch.bfloat16)
    eng.load_params(tp)
    lt2, _ = eng._prefill_impl(eng.params, torch.from_numpy(toks), t_m.init_state(cfg, (B,)),
                               torch.from_numpy(lens))
    assert torch.equal(lt2, lt)

"""The port's q4 (4-bit) path against the JAX package's, on the same inputs
(CPU): the packed format, the plain matmul, kernel K3's plain version
against the Pallas mm4 in interpret mode, the decode step (K4 + K3 on the
CPU) against the JAX fused step, prefill, the artifact, dense checkpoint
ingest, and the engine."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from _torch_port import to_port

from rwkv_tpu.io import convert as j_convert
from rwkv_tpu.io import q4fmt as j_q4fmt
from rwkv_tpu.io.binfmt import write_bin as j_write_bin
from rwkv_tpu.io.safetensors import hf_key, write_safetensors
from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.ops import quant as j_quant
from rwkv_tpu.ops.pallas import decode_stack as j_ds
from rwkv_tpu.ops.pallas import mm4 as j_mm4
from rwkv_tpu.runtime.engine import RWKV as JRWKV
from rwkv_tpu_torch.io import convert as t_convert
from rwkv_tpu_torch.io import q4fmt as t_q4fmt
from rwkv_tpu_torch.models import rwkv4 as t_m
from rwkv_tpu_torch.models.convert import params_from_numpy
from rwkv_tpu_torch.ops import quant as t_quant
from rwkv_tpu_torch.ops.cuda import decode_stack as t_ds
from rwkv_tpu_torch.ops.cuda import mm4 as t_mm4
from rwkv_tpu_torch.runtime.engine import RWKV
from tests.test_safetensors import _blinkdl_state_dict

T = torch.from_numpy


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _leaves(params):
    out = []
    t_m.map_params(params, lambda a: out.append(np.asarray(a)))
    return out


def _blocks(params):
    return [lin.block for lin in (params.att.key, params.att.value, params.att.receptance,
                                  params.att.output, params.ffn.key, params.ffn.value,
                                  params.ffn.receptance, params.head)]


# -- the format ----------------------------------------------------------------

@pytest.mark.parametrize("block", [None, 32])
@pytest.mark.parametrize("shape", [(128, 40), (3, 64, 24)])
def test_quantize4_bit_equal_to_jax(rng, shape, block):
    w = rng.normal(size=shape).astype(np.float32)
    w[..., 5, :] = 0.25  # an all-equal row: span 0
    jq = j_quant.quantize4(w, block=block, as_numpy=True)
    tq = t_quant.quantize4(T(w), block=block)
    assert tq.block == jq.block and tq.wp.dtype == np.int8
    for a, b in ((tq.wp, jq.wp), (tq.scale, jq.scale), (tq.offset, jq.offset)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_quant.unpack4(tq.wp, block),
                                  np.asarray(j_quant.unpack4(jnp.asarray(jq.wp), block)))
    np.testing.assert_allclose(t_quant.dequantize4(tq).numpy(),
                               np.asarray(j_quant.dequantize4(jq)), rtol=1e-6, atol=1e-6)


def test_quantize_q8_bit_equal_to_jax(rng):
    w = rng.normal(size=(2, 48, 20)).astype(np.float32)
    jq = j_quant.quantize(w, as_numpy=True)
    tq = t_quant.quantize(T(w))
    for a, b in ((tq.w, jq.w), (tq.scale, jq.scale), (tq.offset, jq.offset)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("block", [None, 32])
@pytest.mark.parametrize("variant", ["unpack", "two_dot"])
def test_q4matmul_matches_jax(rng, variant, block):
    w = rng.normal(size=(128, 48)).astype(np.float32)
    x = rng.normal(size=(2, 5, 128)).astype(np.float32)
    jq = j_quant.quantize4(w, block=block)
    ref = j_quant.q4matmul(jnp.asarray(x), jq, variant=variant)
    tq = t_quant.quantize4(w, block=block)
    tq = dataclasses.replace(tq, wp=T(tq.wp), scale=T(tq.scale), offset=T(tq.offset))
    _close(t_quant.q4matmul(T(x), tq), ref, 2e-4)


# -- kernel K3 (mm4) ---------------------------------------------------------------

def _head_q4(rng, K=256, O=384):
    w = rng.normal(size=(K, O)).astype(np.float32) * K ** -0.5
    jq = j_quant.quantize4(w)
    tq = t_quant.Quant4Linear(*(T(np.array(a)) for a in (jq.wp, jq.scale, jq.offset)))
    return jq, tq


@pytest.mark.parametrize("variant", ["two_dot", "unpack"])
def test_mm4_matches_pallas_interpret(rng, variant):
    """The Pallas mm4 rounds its left operand to bf16; the port's kernel keeps
    f32, so the two agree to JAX's own 5e-3 (tests/test_quant.py)."""
    jq, tq = _head_q4(rng)
    x = rng.normal(size=(3, 256)).astype(np.float32)
    ref = np.asarray(j_mm4.qmatmul4_pallas(jnp.asarray(x), jq, interpret=True, variant=variant))
    got = t_mm4.qmatmul4_cuda(T(x), tq).numpy()
    assert np.abs(got - ref).max() <= 5e-3 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("block", [None, 64])
def test_mm4_matches_jax_q4matmul_f32(rng, block):
    w = rng.normal(size=(256, 160)).astype(np.float32)
    jq = j_quant.quantize4(w, block=block)
    tq = t_quant.Quant4Linear(*(T(np.array(a)) for a in (jq.wp, jq.scale, jq.offset)),
                              block=block)
    x = rng.normal(size=(4, 256)).astype(np.float32)
    ref = j_quant.q4matmul(jnp.asarray(x), jq, variant="unpack")
    _close(t_mm4.qmatmul4_cuda(T(x), tq), ref, 2e-4)
    # the raw kernel with the offset term and a bias in its epilogue
    xs = (x * np.asarray(jq.scale)).astype(np.float32)
    off = (x @ np.asarray(jq.offset)).astype(np.float32)
    bias = rng.normal(size=160).astype(np.float32)
    _close(t_mm4.mm4(T(xs), tq.wp, block=block, row_add=T(off), col_add=T(bias)),
           np.asarray(ref) + bias, 2e-4)


def test_mm4_rejects_a_block_that_does_not_fit(rng):
    _, tq = _head_q4(rng)
    for block in (3, 96, 512):
        with pytest.raises(ValueError, match="block"):
            t_mm4.mm4(torch.zeros(1, 256), tq.wp, block=block)


# -- the decode step (K4 + K3) and prefill ---------------------------------------------

@pytest.fixture(scope="module")
def model_q4():
    """tests/test_decode_stack.py's q4 fixture: block 128 on the row-tiled
    families, so ffn.value (K = 1024) has 8 pairing blocks."""
    cfg = RWKVConfig.tiny_test(n_layer=3, n_embd=256, vocab_size=384)
    jp = j_m.pad_vocab(j_m.quantize_params_q4(j_m.init_params(jax.random.PRNGKey(0), cfg),
                                              tile=128), multiple=128)
    return cfg, jp, to_port(jp)


@pytest.mark.parametrize("B", [1, 2])
def test_q4_fused_step_matches_jax_kernel(model_q4, B):
    cfg, jp, tp = model_q4
    assert tp.ffn.value.block == 128 and tp.att.key.block is None
    if B == 1:
        js, ts, tok = j_m.init_state(cfg), t_m.init_state(cfg), 5
    else:
        js, ts, tok = j_m.init_state(cfg, (B,)), t_m.init_state(cfg, (B,)), [5, 9][:B]
    lj, sj = j_ds.forward_step_fused(jp, jnp.asarray(tok), js, tile=128, interpret=True)
    lt, st = t_ds.forward_step_fused(tp, torch.tensor(tok), ts)
    assert lt.shape == lj.shape
    _close(lt, lj, 1e-4)
    for a, b in zip(st, sj):
        _close(a, b, 1e-4)


def test_q4_fused_state_carry(model_q4):
    cfg, jp, tp = model_q4
    js, ts = j_m.init_state(cfg, (2,)), t_m.init_state(cfg, (2,))
    for t in ([3, 7], [1, 2], [9, 9], [100, 50]):
        lj, js = j_ds.forward_step_fused(jp, jnp.asarray(t), js, tile=128, interpret=True)
        lt, ts = t_ds.forward_step_fused(tp, torch.tensor(t), ts)
        _close(lt, lj, 1e-4)
    for a, b in zip(ts, js):
        _close(a, b, 1e-4)


@pytest.mark.parametrize("length", [None, 9])
def test_q4_forward_seq_parallel_matches_jax(model_q4, length):
    cfg, jp, tp = model_q4
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, size=16)
    lj, sj = j_m.forward_seq(jp, jnp.asarray(toks), j_m.init_state(cfg), parallel=True,
                             length=length)
    lt, st = t_m.forward_seq(tp, T(toks), t_m.init_state(cfg), parallel=True, length=length)
    _close(lt, lj, 2e-3)
    for a, b in zip(st, sj):
        _close(a, b, 2e-3)


def test_q4_decode_stack_plain_feeds_the_head(model_q4):
    cfg, _, tp = model_q4
    st = t_m.init_state(cfg, (3,))
    tok = torch.tensor([1, 2, 3])
    _, new, xs_h, off_h = t_ds.decode_stack(tp, tok, st)
    ref, ref_state = t_m.forward_step(tp, tok, st)
    logits = t_mm4.mm4(xs_h, tp.head.wp, row_add=off_h, col_add=tp.logit_bias)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    for a, b in zip(new, ref_state):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("fam,block", [("att.key", 128), ("ffn.receptance", 256),
                                       ("att.output", 96), ("ffn.value", 3)])
def test_q4_block_validation(model_q4, fam, block):
    """A column-sliced family with a block, or a row-tiled block that does not
    divide K, is refused before anything runs."""
    cfg, _, tp = model_q4
    half, name = fam.split(".")
    group = getattr(tp, half)
    bad = dataclasses.replace(group, **{name: dataclasses.replace(getattr(group, name),
                                                                  block=block)})
    params = dataclasses.replace(tp, **{half: bad})
    with pytest.raises(ValueError, match="block"):
        t_ds.forward_step_fused(params, torch.tensor(3), t_m.init_state(cfg))


def test_q4_any_fitting_row_block_runs(model_q4):
    """The port's kernels take any even block that divides K: requantized at
    block 32 (not the JAX kernel's tile), the fused step still equals the
    model's own step."""
    cfg, _, _ = model_q4
    dense = params_from_numpy(dataclasses.asdict(jax.tree.map(
        np.asarray, j_m.init_params(jax.random.PRNGKey(0), cfg))), "cpu")
    tp = t_m.params_to(t_m.quantize_params_q4(dense, tile=32), "cpu")
    st = t_m.init_state(cfg, (2,))
    lt, _ = t_ds.forward_step_fused(tp, torch.tensor([5, 9]), st)
    ref, _ = t_m.forward_step(tp, torch.tensor([5, 9]), st)
    np.testing.assert_allclose(lt.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_launch_no_q4_kernel(model_q4):
    cfg, _, tp = model_q4
    before = (t_ds.launches, t_ds.launches_q4, t_mm4.launches)
    t_ds.forward_step_fused(tp, torch.tensor(4), t_m.init_state(cfg))
    assert (t_ds.launches, t_ds.launches_q4, t_mm4.launches) == before


# -- params: quantize_params_q4, pad_vocab, the fabricator -----------------------------

@pytest.mark.parametrize("tile", [None, 64])
def test_quantize_params_q4_bit_equal_to_jax(tile):
    cfg = RWKVConfig.tiny_test(n_layer=2, n_embd=128, vocab_size=200)
    jd = j_m.init_params(jax.random.PRNGKey(2), cfg)
    td = params_from_numpy(dataclasses.asdict(jax.tree.map(np.asarray, jd)), "cpu")
    jq = j_m.quantize_params_q4(jd, tile=tile, as_numpy=True)
    tq = t_m.quantize_params_q4(td, tile=tile)
    assert _blocks(tq) == _blocks(jq)
    jl = [np.asarray(a) for a in jax.tree.leaves(jq)]
    tl = _leaves(tq)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)
    jq8 = j_m.quantize_params(jd, as_numpy=True)
    for a, b in zip(_leaves(t_m.quantize_params(td)), jax.tree.leaves(jq8)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_q4_pad_vocab_matches_jax(model_q4):
    cfg, _, _ = model_q4
    jp = j_m.quantize_params_q4(j_m.init_params(jax.random.PRNGKey(0), cfg), tile=128)
    jpad = j_m.pad_vocab(jp, 512)
    tpad = t_m.pad_vocab(to_port(jp), 512)
    assert tpad.head.wp.shape == (128, 512) and tpad.head.block is None
    np.testing.assert_array_equal(tpad.head.wp.numpy(), np.asarray(jpad.head.wp))
    np.testing.assert_array_equal(tpad.logit_bias.numpy(), np.asarray(jpad.logit_bias))


@pytest.mark.parametrize("E,block", [(1024, 1024), (2048, 512), (4096, 256), (256, 256)])
def test_q4_pack_block_is_the_jax_tile(E, block):
    assert t_m.q4_pack_block(E) == j_ds.pick_tile_q4(E) == block


def test_random_q4_params_shapes_and_blocks():
    cfg = RWKVConfig(n_layer=2, n_embd=256, vocab_size=1000)
    p = t_m.random_quantized_params_np(cfg, seed=1, pad_multiple=128, q4=True)
    assert p.att.key.wp.shape == (2, 128, 256) and p.ffn.value.wp.shape == (2, 512, 256)
    assert p.head.wp.shape == (128, 1024) and p.logit_bias.shape == (1024,)
    assert _blocks(p) == [None, None, None, 256, None, 256, None, None]


# -- the artifact and dense ingest -------------------------------------------------

def test_q4_artifact_crosses_both_ways(tmp_path):
    cfg = RWKVConfig(n_layer=2, n_embd=64, vocab_size=300)
    jp = j_m.quantize_params_q4(j_m.init_params(jax.random.PRNGKey(9), cfg), tile=16)
    jl = [np.asarray(a) for a in jax.tree.leaves(jp)]
    a = str(tmp_path / "jax.q4.safetensors")
    j_q4fmt.save_q4(a, jp)
    assert t_q4fmt.is_q4_file(a)
    tp = t_q4fmt.load_q4(a)
    assert _blocks(tp) == _blocks(jp) == [None, None, None, 16, None, 16, None, None]
    for x, y in zip(_leaves(tp), jl, strict=True):
        np.testing.assert_array_equal(x, y)
    b = str(tmp_path / "port.q4.safetensors")
    t_q4fmt.save_q4(b, t_m.params_to(tp, "cpu"))  # torch leaves write too
    back = j_q4fmt.load_q4(b)
    assert _blocks(back) == _blocks(jp)
    for x, y in zip(jax.tree.leaves(back), jl, strict=True):
        np.testing.assert_array_equal(np.asarray(x), y)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.fixture(scope="module")
def dense_files(tmp_path_factory):
    """One dense BlinkDL checkpoint written as f32 .safetensors, bf16
    HF-named .safetensors and a torch .pth."""
    d = tmp_path_factory.mktemp("dense")
    w = _blinkdl_state_dict(n_layer=2, n_embd=128, vocab=512, seed=3)
    paths = {"f32": str(d / "m.safetensors"), "bf16_hf": str(d / "hf.safetensors"),
             "pth": str(d / "m.pth")}
    write_safetensors(paths["f32"], w)
    write_safetensors(paths["bf16_hf"],
                      {hf_key(k): np.asarray(a, ml_dtypes.bfloat16) for k, a in w.items()})
    torch.save({k: T(a.copy()) for k, a in w.items()}, paths["pth"])
    return paths


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("kind", ["f32", "bf16_hf", "pth"])
def test_load_checkpoint_quantized_bit_equal_to_jax(dense_files, kind, bits):
    path = dense_files[kind]
    jq = j_convert.load_checkpoint_quantized(path, bits=bits)
    tq = t_convert.load_checkpoint_quantized(path, bits=bits)
    assert t_convert.checkpoint_dims(path) == j_convert.checkpoint_dims(path) == (2, 128, 512)
    if bits == 4:
        assert _blocks(tq) == _blocks(jq)
    jl = [np.asarray(a) for a in jax.tree.leaves(jq)]
    tl = _leaves(tq)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_load_checkpoint_dense_equal_to_jax(dense_files):
    jd = j_convert.load_checkpoint(dense_files["bf16_hf"])
    td = t_convert.load_checkpoint(dense_files["bf16_hf"])
    for a, b in zip(_leaves(td), jax.tree.leaves(jd), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))


# -- the engine ---------------------------------------------------------------------

PROMPT_IDS = [510, 406, 324, 301, 287, 189, 253, 58, 70, 15]


@pytest.mark.parametrize("quant", ["q4", "q8"])
def test_engine_dense_checkpoint_greedy_ids_match_jax(dense_files, quant):
    jeng = JRWKV(quant=quant)
    jeng.load_file(dense_files["f32"])
    teng = RWKV(dense_files["f32"], device="cpu", quant=quant)
    assert teng.quant == quant and jeng.quant == quant
    lj = np.asarray(jeng.forward(PROMPT_IDS))
    lt = teng.forward(PROMPT_IDS)
    assert lt.shape == lj.shape == (512,)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=2e-3, atol=2e-3)
    ids_j, ids_t = [], []
    for _ in range(8):
        ids_j.append(int(np.argmax(lj)))
        ids_t.append(int(torch.argmax(lt)))
        lj = np.asarray(jeng.forward(ids_j[-1]))
        lt = teng.forward(ids_t[-1])
    assert ids_t == ids_j


def test_engine_loads_an_artifact_as_q4(dense_files, tmp_path):
    path = str(tmp_path / "m.q4.safetensors")
    t_q4fmt.save_q4(path, t_convert.load_checkpoint_quantized(dense_files["f32"], bits=4))
    eng = RWKV(path, device="cpu")  # quant defaults to q8: the tag switches it
    assert eng.quant == "q4" and isinstance(eng.params.att.key, t_quant.Quant4Linear)
    ref = RWKV(dense_files["f32"], device="cpu", quant="q4")
    np.testing.assert_array_equal(eng.forward(PROMPT_IDS).numpy(),
                                  ref.forward(PROMPT_IDS).numpy())
    # snapshot/restore is bit-equal
    eng.reset_state()
    eng.forward([5, 9])
    snap = eng.snapshot()
    a = eng.forward([11]).clone()
    eng.restore(snap)
    np.testing.assert_array_equal(a.numpy(), eng.forward([11]).numpy())


def test_engine_q4_refuses_a_bin(tmp_path):
    cfg = RWKVConfig(n_layer=1, n_embd=16)
    path = str(tmp_path / "m.bin")
    j_write_bin(path, j_m.random_quantized_params_np(cfg, seed=0, pad_multiple=None))
    eng = RWKV(device="cpu", quant="q4")
    with pytest.raises(ValueError, match="dense source"):
        eng.load_file(path)

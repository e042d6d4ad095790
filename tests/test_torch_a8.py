"""The port's W8A8 path (kernel K5's plain versions on the CPU) against the
JAX package's, on the same inputs: the activation quantization, mm8_a8
against the Pallas mm8_a8 in interpret mode, the a8 decode step and the a8
head against the JAX fused step in interpret mode, and the engine's a8
switch against the JAX engine's."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import to_port

from rwkv_tpu.io.binfmt import write_bin as j_write_bin
from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.ops.pallas import decode_stack as j_ds
from rwkv_tpu.ops.pallas import mm8 as j_mm8
from rwkv_tpu.runtime.engine import RWKV as JRWKV
from rwkv_tpu_torch.models import rwkv4 as t_m
from rwkv_tpu_torch.ops.cuda import decode_stack as t_ds
from rwkv_tpu_torch.ops.cuda import mm8 as t_mm8
from rwkv_tpu_torch.runtime.engine import RWKV

T = torch.from_numpy


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _rows(rng):
    """f32 rows with ties: row 0's max is 127, so s = 1 and x / s lands on
    .5 exactly (half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2); row 1 is all
    zero (the 1e-30 floor of the scale)."""
    x = rng.normal(size=(6, 300)).astype(np.float32)
    x[0, :7] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5]
    x[1] = 0.0
    x[2] *= 1e-3
    return x


def test_quant_rows_bit_equal_to_jax(rng):
    x = _rows(rng)
    q, s = j_ds._quant_rows(jnp.asarray(x))
    tq, ts = t_mm8.quant_rows(T(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s)[:, 0])
    assert list(tq[0, 1:7]) == [0, 2, 2, 0, -2, -2]


def test_quant_blocks_is_quant_rows_per_block(rng):
    x = _rows(rng)[:, :256]
    q, s = t_mm8.quant_blocks(T(x), 64)
    assert s.shape == (6, 4)
    for j in range(4):
        qj, sj = j_ds._quant_rows(jnp.asarray(x[:, 64 * j:64 * (j + 1)]))
        np.testing.assert_array_equal(q[:, 64 * j:64 * (j + 1)].numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s[:, j].numpy(), np.asarray(sj)[:, 0])
    with pytest.raises(ValueError, match="block"):
        t_mm8.quant_blocks(T(x), 96)


# The plain product is exact (integer sums in float64), the Pallas one exact
# in int32; the two then round to f32 and scale the same way, so they agree
# to the last bits: 1e-6 scaled leaves room for one rounding.
@pytest.mark.parametrize("B", [1, 5, 16])
def test_mm8_a8_matches_pallas_interpret(rng, B):
    x = np.concatenate([_rows(rng)] * 3)[:B]
    w = rng.integers(-128, 128, size=(300, 200), dtype=np.int8)
    ref = np.asarray(j_mm8.mm8_a8(jnp.asarray(x), jnp.asarray(w), interpret=True))
    got = t_mm8.mm8_a8(T(x), T(w))
    assert got.shape == (B, 200)
    assert _scaled(got.numpy(), ref) <= 1e-6
    row = rng.normal(size=(B,)).astype(np.float32)
    col = rng.normal(size=(200,)).astype(np.float32)
    got = t_mm8.mm8_a8(T(x), T(w), row_add=T(row), col_add=T(col))
    assert _scaled(got.numpy(), ref + row[:, None] + col) <= 1e-6
    out, q, s = t_mm8.mm8_a8(T(x), T(w), return_codes=True)
    assert torch.equal(q, t_mm8.quant_rows(T(x))[0]) and torch.equal(out, t_mm8.mm8_a8(T(x), T(w)))


def test_mm8_a8_plain_blocks_are_pallas_per_block(rng):
    """mm8_a8_plain with a block is the JAX mm8_a8 of each block of input
    channels, the blocks' results added in order."""
    x = _rows(rng)[:, :256]
    w = rng.integers(-128, 128, size=(256, 144), dtype=np.int8)
    ref = sum(np.asarray(j_mm8.mm8_a8(jnp.asarray(x[:, k:k + 128]), jnp.asarray(w[k:k + 128]),
                                      interpret=True)) for k in (0, 128))
    got = t_mm8.mm8_a8_plain(T(x), T(w), block=128)
    assert _scaled(got.numpy(), ref) <= 1e-6


# -- the a8 decode step ------------------------------------------------------------

@pytest.fixture(scope="module")
def a8_model():
    """E=256, F=1024, L=2, the odd vocab 1001 padded to 1024 by pad_vocab,
    signed int8 weights: the JAX kernel runs it at tile 128 (2 tiles of E,
    8 of F), and the port at a8_block 128."""
    cfg = RWKVConfig.tiny_test(n_layer=2, n_embd=256, vocab_size=1001)
    jp = j_m.pad_vocab(j_m.signedize_params(j_m.quantize_params(
        j_m.init_params(jax.random.PRNGKey(0), cfg))), multiple=128)
    return cfg, jp, to_port(jp)


def _run_steps(cfg, jp, tp, B, j_kw, t_kw):
    """4 carried steps of the JAX fused step and the port's; returns the
    worst scaled error over logits and state, and whether every step's
    argmax agreed."""
    shape = () if B is None else (B,)
    js, ts = j_m.init_state(cfg, shape), t_m.init_state(cfg, shape)
    worst, same = 0.0, True
    for t0 in (3, 1, 9, 100):
        tok = t0 if B is None else [(t0 + 37 * i) % cfg.vocab_size for i in range(B)]
        lj, js = j_ds.forward_step_fused(jp, jnp.asarray(tok), js, interpret=True, **j_kw)
        lt, ts = t_ds.forward_step_fused(tp, torch.tensor(tok), ts, **t_kw)
        lj = np.asarray(lj)[..., :cfg.vocab_size]
        lt = lt.numpy()[..., :cfg.vocab_size]
        worst = max([worst, _scaled(lt, lj)] + [_scaled(a.numpy(), b) for a, b in zip(ts, js)])
        same &= bool(np.array_equal(lt.argmax(-1), lj.argmax(-1)))
    return worst, same


# Tolerance: with the same codes, the two differ only in f32 rounding
# (~3e-7 scaled here). A code is decided by rounding v / s; when a value
# lands within f32 noise of a .5 boundary the packages may round it apart,
# and one code off by one moves the result by ~1/127 of that input's share:
# at other weight seeds this reaches 2e-3 (PRNGKey(1)) and 8e-3 (PRNGKey(5))
# at B=5. The weights of PRNGKey(0) cross no boundary in these 4 steps, so
# the test holds the target, 1e-4, and a code flip that a port bug would
# cause shows.
A8_TOL = 1e-4


@pytest.mark.parametrize("B", [None, 5])
def test_a8_step_matches_jax_at_a_block_below_K(a8_model, B):
    cfg, jp, tp = a8_model
    worst, same = _run_steps(cfg, jp, tp, B, dict(tile=128, a8=True),
                             dict(a8=True, a8_block=128))
    assert worst <= A8_TOL and same, (worst, same)


def test_a8_block_changes_the_numbers(a8_model):
    """At block = E the port matches the JAX kernel at tile E, and both are
    far from the tile-128 results: the block is not invisible."""
    cfg, jp, tp = a8_model
    worst, same = _run_steps(cfg, jp, tp, 5, dict(tile=256, a8=True),
                             dict(a8=True, a8_block=256))
    assert worst <= A8_TOL and same, (worst, same)
    apart, _ = _run_steps(cfg, jp, tp, 5, dict(tile=128, a8=True),
                          dict(a8=True, a8_block=256))
    assert apart > 10 * A8_TOL, apart


def test_head_a8_matches_jax(a8_model):
    """The q8 stack with an a8 head. The JAX head_a8 applies to its
    standalone head, taken when the vocab is not lane-aligned: so here the
    unpadded vocab (1001)."""
    cfg, _, _ = a8_model
    jp = j_m.signedize_params(j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(0), cfg)))
    tp = to_port(jp)
    assert jp.head.w.shape[-1] % 128
    worst, same = _run_steps(cfg, jp, tp, 5, dict(tile=128, head_a8=True), dict(head_a8=True))
    assert worst <= A8_TOL and same, (worst, same)
    exact, _ = _run_steps(cfg, jp, tp, 5, dict(tile=128), dict(head_a8=True))
    assert exact > 10 * A8_TOL, exact  # the a8 head is not the f32-widening head


def test_a8_with_q4_raises():
    cfg = RWKVConfig(n_layer=1, n_embd=256, vocab_size=300)
    p = t_m.params_to(t_m.random_quantized_params_np(cfg, seed=1, q4=True), "cpu")
    st = t_m.init_state(cfg)
    with pytest.raises(ValueError, match="4-bit"):
        t_ds.forward_step_fused(p, torch.tensor(3), st, a8=True)
    with pytest.raises(ValueError, match="4-bit"):
        RWKV(device="cpu").load_params(p, a8=True)


def test_a8_block_for_is_the_jax_tile():
    for E in (256, 768, 1024, 2048, 2560, 4096, 5120):
        assert t_m.a8_block_for(E) == j_ds.pick_tile(E), E
    cfg = RWKVConfig.tiny_test(n_layer=1, n_embd=256, vocab_size=300)
    p = t_m.params_to(t_m.random_quantized_params_np(cfg, seed=2), "cpu")
    with pytest.raises(ValueError, match="a8_block"):
        t_ds.forward_step_fused(p, torch.tensor(3), t_m.init_state(cfg), a8=True, a8_block=96)


# -- the engine ---------------------------------------------------------------------

PROMPT_IDS = [510, 4062, 8516, 30013, 27287, 689, 253, 22658, 4370, 15]


def test_engine_a8_greedy_ids_match_jax(tmp_path):
    """RWKV(path) then load_params(eng.params, a8=True) against the JAX engine
    with load_params(params, use_fused=True, a8=True). The JAX engine turns
    on its fused step only on a TPU; here its step is rebuilt with
    interpret=True (the pretiled params carry the tile, pick_tile(128))."""
    cfg = RWKVConfig(n_layer=2, n_embd=128)  # the .bin format's vocab, 50277
    path = str(tmp_path / "rwkv-l2-e128.bin")
    j_write_bin(path, j_m.random_quantized_params_np(cfg, seed=4, pad_multiple=None))
    jeng = JRWKV(path)
    jeng.load_params(jeng.params, use_fused=True, a8=True)
    jeng._step_fn = partial(j_ds.forward_step_fused, a8=True, interpret=True)
    jeng._make_jits()
    teng = RWKV(path, device="cpu")
    assert teng._step_fn is t_ds.forward_step_fused
    teng.load_params(teng.params, a8=True)
    assert teng._step_fn.keywords == {"a8": True, "a8_block": 128}
    lj = np.asarray(jeng.forward(PROMPT_IDS))
    lt = teng.forward(PROMPT_IDS)
    assert lt.shape == lj.shape == (50277,)
    np.testing.assert_allclose(lt.numpy(), lj, rtol=2e-3, atol=2e-3)
    ids_j, ids_t = [], []
    for _ in range(8):
        ids_j.append(int(np.argmax(lj)))
        ids_t.append(int(torch.argmax(lt)))
        lj = np.asarray(jeng.forward(ids_j[-1]))
        lt = teng.forward(ids_t[-1])
    assert ids_t == ids_j
    # the a8 step is what the engine decodes with: a8=False gives other logits
    teng.reset_state()
    teng.forward(PROMPT_IDS)
    a8_logits = teng.forward(ids_t[0]).clone()
    teng.load_params(teng.params)
    teng.forward(PROMPT_IDS)
    assert not torch.equal(teng.forward(ids_t[0]), a8_logits)

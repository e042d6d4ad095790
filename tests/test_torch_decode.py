"""The port's kernel modules (ops/cuda/decode_stack.py, ops/cuda/mm8.py) on
the CPU, where their wrappers run the plain versions, against the JAX
package's Pallas kernels run in interpret mode, as its own tests run them
(tests/test_decode_stack.py), at the same tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import to_port

from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.ops import quant as j_quant
from rwkv_tpu.ops.pallas import decode_stack as j_ds
from rwkv_tpu.ops.pallas import mm8 as j_mm8
from rwkv_tpu_torch.models import rwkv4 as t_m
from rwkv_tpu_torch.ops import quant as t_quant
from rwkv_tpu_torch.ops.cuda import decode_stack as t_ds
from rwkv_tpu_torch.ops.cuda import mm8 as t_mm8


@pytest.fixture(scope="module")
def model():
    cfg = RWKVConfig.tiny_test(n_layer=3, n_embd=256, vocab_size=384)
    jp = j_m.signedize_params(j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(0), cfg)))
    return cfg, jp, to_port(jp)


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def test_mm8_matches_pallas_interpret(rng):
    w = rng.normal(size=(96, 200)).astype(np.float32)
    jq = j_quant.to_signed(j_quant.quantize(w))
    x = rng.normal(size=(3, 96)).astype(np.float32)
    ref = np.asarray(j_mm8.qmatmul_pallas(jnp.asarray(x), jq, interpret=True))
    tq = t_quant.QuantLinear(*(torch.from_numpy(np.array(a)) for a in (jq.w, jq.scale, jq.offset)))
    _close(t_mm8.qmatmul_cuda(torch.from_numpy(x), tq), ref, 1e-5)
    xs = (x * np.asarray(jq.scale)).astype(np.float32)
    raw = np.asarray(j_mm8.mm8(jnp.asarray(xs), jq.w, interpret=True))
    _close(t_mm8.mm8(torch.from_numpy(xs), tq.w), raw, 1e-5)


@pytest.mark.parametrize("B", [1, 2])
def test_fused_step_matches_jax_kernel(model, B):
    cfg, jp, tp = model
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


def test_fused_step_state_carry(model):
    cfg, jp, tp = model
    js, ts = j_m.init_state(cfg, (2,)), t_m.init_state(cfg, (2,))
    for t in ([3, 7], [1, 2], [9, 9], [100, 50]):
        lj, js = j_ds.forward_step_fused(jp, jnp.asarray(t), js, tile=128, interpret=True)
        lt, ts = t_ds.forward_step_fused(tp, torch.tensor(t), ts)
    _close(lt, lj, 2e-4)
    for a, b in zip(ts, js):
        _close(a, b, 2e-4)


def test_fused_step_padded_vocab(model):
    """A padded head: the -1e9 logit bias lands on the padding columns."""
    cfg, jp, _ = model
    jpad = j_m.pad_vocab(jp, 512)
    tpad = to_port(jpad)
    lj, _ = j_ds.forward_step_fused(jpad, jnp.asarray(11), j_m.init_state(cfg), tile=128,
                                    interpret=True)
    lt, _ = t_ds.forward_step_fused(tpad, torch.tensor(11), t_m.init_state(cfg))
    assert lt.shape == (512,)
    assert (lt[384:] < -1e8).all()
    _close(lt, lj, 1e-4)


def test_decode_stack_plain_feeds_the_head(model):
    """decode_stack's outputs are the oracle's: y, state, and the head input
    that gives forward_step's logits through mm8."""
    cfg, _, tp = model
    st = t_m.init_state(cfg, (3,))
    tok = torch.tensor([1, 2, 3])
    y, new, xs_h, off_h = t_ds.decode_stack(tp, tok, st)
    ref, ref_state = t_m.forward_step(tp, tok, st)
    assert y.shape == (3, 256) and xs_h.shape == (3, 256) and off_h.shape == (3,)
    logits = t_mm8.mm8(xs_h, tp.head.w, row_add=off_h, col_add=tp.logit_bias)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    for a, b in zip(new, ref_state):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cpu_wrappers_launch_no_kernel(model):
    cfg, _, tp = model
    before = (t_ds.launches, t_mm8.launches)
    t_ds.forward_step_fused(tp, torch.tensor(4), t_m.init_state(cfg))
    assert (t_ds.launches, t_mm8.launches) == before

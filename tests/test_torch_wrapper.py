"""The port's TorchRWKV (rwkv_tpu_torch/interop/torch.py) against the JAX
package's (rwkv_tpu/interop/torch.py) on the same params (CPU): forward,
forward_batch and empty_state within the JAX file's rtol 1e-5, a .bin
written by the JAX write_bin, functional state, and the logit width."""

import jax
import numpy as np
import pytest
import torch
from _torch_port import to_port

from rwkv_tpu.interop.torch import TorchRWKV as JTorchRWKV
from rwkv_tpu.io.binfmt import write_bin as j_write_bin
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.models.rwkv4 import init_params, init_state, quantize_params
from rwkv_tpu.models.rwkv4 import random_quantized_params_np as j_random_params
from rwkv_tpu.runtime.engine import RWKV as JRWKV
from rwkv_tpu_torch.interop.torch import TorchRWKV

RTOL = 1e-5  # tests/test_torch_interop.py's


def _close(a, b, atol=1e-6):
    np.testing.assert_allclose(a.detach().cpu().numpy(), np.asarray(b), rtol=RTOL, atol=atol)


@pytest.fixture(scope="module")
def pair():
    cfg = RWKVConfig.tiny_test(n_layer=2, n_embd=16, vocab_size=97)
    params = quantize_params(init_params(jax.random.PRNGKey(12), cfg))
    return JTorchRWKV(params=params), TorchRWKV(params=to_port(params), device="cpu"), cfg


def test_shape_properties_and_empty_state(pair):
    j, t, cfg = pair
    assert (t.n_layer, t.n_embd) == (j.n_layer, j.n_embd) == (2, 16)
    assert t.device == torch.device("cpu")
    es_t, es_j = t.empty_state(), j.empty_state()
    assert len(es_t) == len(es_j) == 5
    for a, b in zip(es_t, es_j):
        assert a.dtype == torch.float32 and a.shape == (2, 16)
        assert torch.equal(a, b)


def test_forward_matches_jax(pair):
    j, t, cfg = pair
    sj, st = j.empty_state(), t.empty_state()
    for tok in (7, 0, 96, 31, 7):
        lj, sj = j.forward(tok, sj)
        lt, st = t.forward(torch.tensor(tok), st)
        assert isinstance(lt, torch.Tensor) and lt.shape == lj.shape == (cfg.vocab_size,)
        _close(lt, lj)
        for a, b in zip(st, sj):
            _close(a, b)


def test_state_is_functional(pair):
    """The state passed in is never written; the same state in gives the
    same logits; the state out is new tensors."""
    _, t, _ = pair
    s0 = t.empty_state()
    _, s1 = t.forward(5, s0)
    s1_copy = [s.clone() for s in s1]
    l_a, s2 = t.forward(3, s1)
    l_b, _ = t.forward(3, s1)
    assert torch.equal(l_a, l_b)
    assert all(torch.equal(a, b) for a, b in zip(s1, s1_copy))
    assert all(torch.equal(a, b) for a, b in zip(s0, t.empty_state()))
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(s1, s2))
    sb = [torch.stack([s, s], dim=1) for s in s1]
    sb_copy = [s.clone() for s in sb]
    t.forward_batch(torch.tensor([1, 2]), sb)
    assert all(torch.equal(a, b) for a, b in zip(sb, sb_copy))


def test_forward_batch_matches_jax_and_single_streams(pair):
    j, t, cfg = pair
    B = 3
    sj = [torch.from_numpy(np.asarray(s)) for s in init_state(cfg, (B,))]
    st = [s.clone() for s in sj]
    for toks in ([1, 2, 96], [50, 0, 3]):
        lj, sj = j.forward_batch(torch.tensor(toks), sj)
        lt, st = t.forward_batch(torch.tensor(toks), st)
        assert lt.shape == lj.shape == (B, cfg.vocab_size)
        _close(lt, lj)
        for a, b in zip(st, sj):
            _close(a, b)
    for b in range(B):  # each row is its own stream
        s = t.empty_state()
        for tok in ([1, 2, 96][b], [50, 0, 3][b]):
            lb, s = t.forward(tok, s)
        _close(lt[b], lb.numpy())
        for a, c in zip(st, s):
            _close(a[:, b], c.numpy())


def test_bin_written_by_jax(tmp_path):
    """A .bin from the JAX write_bin: both wrappers read it, the logits are
    50,688 wide (the .bin engine's padding, -1e9 past 50,277) and agree."""
    path = str(tmp_path / "m.bin")
    j_write_bin(path, j_random_params(RWKVConfig(n_layer=2, n_embd=32), seed=4))
    j, t = JTorchRWKV(model_path=path), TorchRWKV(model_path=path, device="cpu")
    sj, st = j.empty_state(), t.empty_state()
    for tok in (510, 50276, 0):
        lj, sj = j.forward(tok, sj)
        lt, st = t.forward(tok, st)
        assert lt.shape == lj.shape == (50688,)
        assert torch.all(lt[50277:] <= -1e8)
        _close(lt, lj, atol=1e-5)
        for a, b in zip(st, sj):
            _close(a, b)
    lj, _ = j.forward_batch(torch.tensor([3, 9]), [torch.stack([s, s], 1) for s in sj])
    lt, _ = t.forward_batch(torch.tensor([3, 9]), [torch.stack([s, s], 1) for s in st])
    assert lt.shape == lj.shape == (2, 50688)
    _close(lt, lj, atol=1e-5)


@pytest.mark.parametrize("E,V", [(16, 97), (256, 300), (256, 304), (128, 300)])
def test_logit_width_is_the_jax_engines(E, V):
    """The width the JAX wrapper returns for the same params where its
    engine serves them (its fused route: the vocab padded to 512 when E is a
    multiple of 256 and V of no 128), whatever the port padded to itself;
    the columns past V masked at -1e9. The first V columns agree with the
    JAX wrapper on its CPU route."""
    params = quantize_params(init_params(jax.random.PRNGKey(2), RWKVConfig(1, E, V)))
    jeng = JRWKV()
    jeng.load_params(params, use_fused=E % 256 == 0)
    t = TorchRWKV(params=to_port(params), device="cpu")
    lt, _ = t.forward(5, t.empty_state())
    assert lt.shape == (jeng.config.vocab_size,)
    assert torch.all(lt[V:] <= -1e8)
    lj, _ = JTorchRWKV(params=params).forward(5, t.empty_state())
    _close(lt[:V], lj[:V].numpy())


def test_q4_params_decode_on_the_q4_step():
    """4-bit params run the q4 step (K4 + K3's plain versions here), the
    JAX wrapper's q4 engine on the same packed params."""
    cfg = RWKVConfig.tiny_test(n_layer=2, n_embd=128, vocab_size=97)
    dense = init_params(jax.random.PRNGKey(3), cfg)
    from rwkv_tpu.models.rwkv4 import quantize_params_q4 as j_q4

    jp = j_q4(dense, tile=128)
    j, t = JTorchRWKV(params=jp), TorchRWKV(params=to_port(jp), device="cpu")
    assert t._eng.quant == "q4"
    lj, sj = j.forward(11, j.empty_state())
    lt, st = t.forward(11, t.empty_state())
    _close(lt, lj, atol=1e-5)
    for a, b in zip(st, sj):
        _close(a, b)


def test_needs_a_source():
    with pytest.raises(ValueError, match="need model_path or params"):
        TorchRWKV(device="cpu")


def test_sharded_wrapper_runs_the_tp_step(pair):
    """sharding=: the tensor-parallel step on a CPU mesh of 2, within the
    TP pin (3e-4) of the unsharded wrapper, the width the JAX engine gives
    a sharded load (its TP multiple)."""
    from rwkv_tpu_torch.parallel.mesh import make_mesh

    j, t, cfg = pair
    params = quantize_params(init_params(jax.random.PRNGKey(12), cfg))
    ts = TorchRWKV(params=to_port(params), device="cpu",
                   sharding=make_mesh(model=2, devices=["cpu"] * 2))
    assert ts._eng._step_fn.body in ("plain", "halves", "fused")
    s, st = t.empty_state(), ts.empty_state()
    for tok in (7, 50, 96):
        lt, s = t.forward(tok, s)
        ls, st = ts.forward(tok, st)
        assert ls.shape[0] % 256 == 0 and torch.all(ls[cfg.vocab_size:] <= -1e8)
        np.testing.assert_allclose(ls[:cfg.vocab_size].numpy(), lt.numpy(), rtol=3e-4, atol=3e-4)
    lb, _ = ts.forward_batch(torch.tensor([1, 2]), [torch.stack([x, x], 1) for x in st])
    assert lb.shape == (2, ls.shape[0])

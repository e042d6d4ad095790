"""rwkv_tpu_torch's model, checkpoint reader and weight carry-over against
rwkv_tpu's, on the same params and tokens (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import to_port

from rwkv_tpu.io import binfmt as j_bin
from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu_torch.io import binfmt as t_bin
from rwkv_tpu_torch.models import rwkv4 as t_m


@pytest.fixture(scope="module")
def model():
    cfg = RWKVConfig.tiny_test(n_layer=3, n_embd=32, vocab_size=97)
    jp = j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(1), cfg))
    return cfg, jp, to_port(jp)


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def test_params_from_numpy_signedizes(model):
    _, jp, tp = model
    assert tp.att.key.w.dtype == torch.int8 and tp.head.w.dtype == torch.int8
    js = j_m.signedize_params(jp)
    np.testing.assert_array_equal(tp.ffn.value.w.numpy(), np.asarray(js.ffn.value.w))
    np.testing.assert_array_equal(tp.head.offset.numpy(), np.asarray(js.head.offset))
    assert dataclasses.astuple(tp.config) == dataclasses.astuple(model[0])


@pytest.mark.parametrize("B", [None, 2])
def test_forward_step_matches_jax(model, B):
    cfg, jp, tp = model
    batch = () if B is None else (B,)
    js, ts = j_m.init_state(cfg, batch), t_m.init_state(cfg, batch)
    rng = np.random.default_rng(3)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, size=batch)
        lj, js = j_m.forward_step(jp, jnp.asarray(tok), js)
        lt, ts = t_m.forward_step(tp, torch.from_numpy(tok), ts)
        _close(lt, lj, 1e-4)
        for a, b in zip(ts, js):
            _close(a, b, 1e-4)


@pytest.mark.parametrize("length", [None, 9])
def test_forward_seq_parallel_matches_jax(model, length):
    cfg, jp, tp = model
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, size=16)
    # a non-empty start state, the same in both packages
    j0 = j_m.forward_seq(jp, jnp.asarray(toks[:5]), j_m.init_state(cfg))[1]
    t0 = t_m.WKVState(*(torch.from_numpy(np.array(s)) for s in j0))
    lj, sj = j_m.forward_seq(jp, jnp.asarray(toks), j0, parallel=True,
                             length=None if length is None else jnp.asarray(length))
    lt, st = t_m.forward_seq(tp, torch.from_numpy(toks), t0, parallel=True, length=length)
    _close(lt, lj, 2e-3)
    for a, b in zip(st, sj):
        _close(a, b, 2e-3)


def test_forward_seq_parallel_equals_sequential_and_steps(model):
    cfg, _, tp = model
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, size=11))
    s0 = t_m.init_state(cfg)
    lp, sp = t_m.forward_seq(tp, toks, s0, parallel=True)
    ls, ss = t_m.forward_seq(tp, toks, s0, parallel=False)
    st = s0
    for t in toks:
        lstep, st = t_m.forward_step(tp, t, st)
    for a, b in [(lp, ls), (lp, lstep)] + list(zip(sp, ss)) + list(zip(sp, st)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-3)


def test_masked_prefill_equals_unpadded(model):
    cfg, _, tp = model
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, size=7))
    padded = torch.cat([toks, torch.zeros(9, dtype=toks.dtype)])
    s0 = t_m.init_state(cfg)
    lu, su = t_m.forward_seq(tp, toks, s0, parallel=True)
    lm, sm = t_m.forward_seq(tp, padded, s0, parallel=True, length=7)
    for a, b in [(lu, lm)] + list(zip(su, sm)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_init_state_and_pad_vocab_match_jax(model):
    cfg, jp, tp = model
    for a, b in zip(t_m.init_state(cfg, (2,)), j_m.init_state(cfg, (2,))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jpad = j_m.signedize_params(j_m.pad_vocab(jp, 128))
    tpad = t_m.pad_vocab(tp, 128)
    assert tpad.head.w.shape == (32, 128) and tpad.emb.shape == (128, 32)
    np.testing.assert_array_equal(tpad.logit_bias.numpy(), np.asarray(jpad.logit_bias))
    np.testing.assert_array_equal(tpad.head.w.numpy()[:, :97], np.asarray(jpad.head.w)[:, :97])
    np.testing.assert_array_equal(tpad.emb.numpy(), np.asarray(jpad.emb))
    # re-padding keeps the old pad ids banned
    again = t_m.pad_vocab(tpad, 256)
    assert (again.logit_bias[97:] == -1e9).all() and (again.logit_bias[:97] == 0).all()


@pytest.fixture(scope="module")
def bin_path(tmp_path_factory):
    cfg = RWKVConfig(n_layer=2, n_embd=16)
    jp = j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(3), cfg))
    path = str(tmp_path_factory.mktemp("bin") / "model.bin")
    j_bin.write_bin(path, jp)
    return path


@pytest.mark.parametrize("pad,signed", [(None, False), (512, True)])
def test_read_bin_bit_equal_to_jax(bin_path, pad, signed):
    jr = j_bin.read_bin(bin_path, pad_vocab_to=pad, signed=signed)
    tr = t_bin.read_bin(bin_path, "cpu", pad_vocab_to=pad, signed=signed)
    assert (dataclasses.astuple(t_bin.read_header(bin_path))
            == dataclasses.astuple(j_bin.read_header(bin_path)))
    jl, _ = jax.tree.flatten(jr)
    tl = []
    t_m.map_params(tr, tl.append)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert str(a.dtype).removeprefix("torch.") == np.asarray(b).dtype.name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_write_bin_reproduces_the_file(bin_path, tmp_path):
    params = t_bin.read_bin(bin_path, "cpu")
    out = str(tmp_path / "again.bin")
    t_bin.write_bin(out, params)
    assert open(out, "rb").read() == open(bin_path, "rb").read()
    with pytest.raises(TypeError):
        t_bin.write_bin(out, t_m.signedize_params(params))


def test_random_quantized_params_np_matches_jax_recipe():
    cfg = RWKVConfig.tiny_test(n_layer=2, n_embd=32, vocab_size=97)
    jr = j_m.random_quantized_params_np(cfg, seed=7, pad_multiple=128)
    tr = t_m.random_quantized_params_np(cfg, seed=7, pad_multiple=128)
    jl = [np.asarray(x) for x in jax.tree.leaves(jr)]
    tl = []
    t_m.map_params(tr, tl.append)
    assert dataclasses.fields(tr) and len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)

"""Durable state on the port's engine (RWKV.save_state / load_state): the cases
of tests/test_state_persistence.py, and one .npz that crosses packages in
each direction and resumes to the same greedy ids."""

import jax
import numpy as np
import pytest
import torch
from _torch_port import to_port

from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.runtime.engine import RWKV as JRWKV
from rwkv_tpu_torch.runtime.engine import RWKV

KEYS = {"state_xy", "state_aa", "state_bb", "state_pp", "state_dd", "logits", "pending"}


@pytest.fixture(scope="module")
def jparams():
    return j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(8), RWKVConfig(n_layer=2,
                                                                                n_embd=16)))


@pytest.fixture(scope="module")
def params(jparams):
    return to_port(jparams)


def _engine(params):
    eng = RWKV(device="cpu")
    eng.load_params(params)
    eng.load_tokenizer()
    return eng


def test_state_roundtrip_same_logits(tmp_path, params):
    eng = _engine(params)
    eng.forward([4, 5, 6])
    path = str(tmp_path / "sess.npz")
    eng.save_state(path)
    l_a = eng.forward(9)

    eng2 = _engine(params)
    eng2.load_state(path)
    l_b = eng2.forward(9)
    assert torch.equal(l_a, l_b)


def test_generate_resumes_identically(tmp_path, params):
    eng = _engine(params)
    eng.generate("Hello there", max_tokens=4, seed=3)
    path = str(tmp_path / "sess.npz")
    eng.save_state(path)
    with np.load(path) as z:  # after generate: the pending token, no logits
        assert set(z.files) == KEYS - {"logits"}
    cont_a = eng.generate("", max_tokens=4, seed=5)

    eng2 = _engine(params)
    eng2.load_state(path)
    cont_b = eng2.generate("", max_tokens=4, seed=5)
    assert cont_a == cont_b


def test_metrics_counters():
    from rwkv_tpu_torch.utils.metrics import metrics

    metrics.reset()
    with metrics.timed("test.op"):
        pass
    metrics.inc("test.count", 3)
    snap = metrics.snapshot()
    assert snap["counters"]["test.count"] == 3
    assert snap["timings"]["test.op"]["count"] == 1


def _greedy(eng, n, to_np):
    """n greedy ids from the stream's saved logits on: argmax, then forward."""
    logits, ids = eng.snapshot(0)["logits"], []
    for _ in range(n):
        ids.append(int(np.argmax(to_np(logits)[:50277])))
        logits = eng.forward(ids[-1])
    return ids


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_session_crosses_packages(tmp_path, jparams, params, direction):
    """A session saved by one package resumes in the other: the same 8
    greedy ids as the saving engine's own continuation (and the same
    pending token after a generate)."""
    prompt = [510, 4062, 8516, 30013, 27287, 689, 253]
    jeng, teng = JRWKV(), _engine(params)
    jeng.load_params(jparams)
    path = str(tmp_path / f"{direction}.npz")
    src, dst = (jeng, teng) if direction == "jax_to_port" else (teng, jeng)
    src.forward(prompt)
    src.save_state(path)
    with np.load(path) as z:
        assert set(z.files) == KEYS - {"pending"}
    to_np = {id(jeng): np.asarray, id(teng): lambda t: t.numpy()}
    want = _greedy(src, 8, to_np[id(src)])
    dst.load_state(path)
    assert _greedy(dst, 8, to_np[id(dst)]) == want

    src.forward(prompt)  # a pending token, as generate leaves it
    src._pending[0] = want[0]
    src.save_state(path)
    dst.load_state(path)
    assert dst._pending[0] == want[0]
    a = np.asarray(dst.forward(want[1]))[:50277]
    b = np.asarray(src.forward(want[1]))[:50277]
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)


def test_session_from_a_bin_resumes_in_the_jax_bin_engine(tmp_path):
    """A session the port saves right after forward on a .bin resumes in the
    JAX engine loaded from the same .bin, whose logits are 512-padded
    (50,688 wide): its generate("") runs (it masks at that width) and its
    greedy ids equal the port's own continuation. The file's logits are
    that wide, the padded columns at the -1e9 bias."""
    from rwkv_tpu.io.binfmt import write_bin as j_write_bin
    from rwkv_tpu.models.rwkv4 import random_quantized_params_np as j_random_params

    path = str(tmp_path / "l2-e64.bin")
    j_write_bin(path, j_random_params(RWKVConfig(n_layer=2, n_embd=64), seed=0,
                                      pad_multiple=None))
    teng = RWKV(path, device="cpu")
    teng.forward([510, 4062, 8516, 30013, 27287, 689, 253])
    sess = str(tmp_path / "sess.npz")
    teng.save_state(sess)
    with np.load(sess) as z:
        assert z["logits"].shape == (50688,)
        assert (z["logits"][50277:] < -1e8).all()
    want = _greedy(teng, 6, lambda t: t.numpy())

    jeng = JRWKV(path)
    jeng.load_tokenizer()
    jeng.load_state(sess)
    assert _greedy(jeng, 6, np.asarray) == want
    jeng.load_state(sess)
    assert isinstance(jeng.generate("", max_tokens=4, seed=1), str)

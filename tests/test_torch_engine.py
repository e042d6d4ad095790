"""The slice as a whole: the port's engine against the JAX engine on one .bin
(CPU), plus the engine's own contracts (device, state copies, chunking)."""

import numpy as np
import pytest
import torch

from rwkv_tpu.io.binfmt import write_bin as j_write_bin
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.models.rwkv4 import random_quantized_params_np as j_random_params
from rwkv_tpu.runtime.engine import RWKV as JRWKV
from rwkv_tpu_torch.runtime import engine as t_engine
from rwkv_tpu_torch.runtime.engine import RWKV, Mode

PROMPT_IDS = [510, 4062, 8516, 30013, 27287, 689, 253, 22658, 4370, 15, 7243, 2220, 247, 673,
              13, 627, 369, 247, 1652, 15]


@pytest.fixture(scope="module")
def bin_path(tmp_path_factory):
    cfg = RWKVConfig(n_layer=2, n_embd=64)  # the .bin format's vocab, 50277
    params = j_random_params(cfg, seed=0, pad_multiple=None)
    path = str(tmp_path_factory.mktemp("bin") / "rwkv-l2-e64.bin")
    j_write_bin(path, params)
    return path


@pytest.fixture(scope="module")
def engines(bin_path):
    return JRWKV(bin_path), RWKV(bin_path, device="cpu")


def test_prompt_logits_and_greedy_ids_match_jax(engines):
    jeng, teng = engines
    jeng.reset_state()
    teng.reset_state()
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


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        RWKV()
    with pytest.raises(RuntimeError, match="no CUDA"):
        t_engine.resolve_device("cuda")
    assert RWKV(device="cpu").device.type == "cpu"


def test_q4_on_a_bin_raises(bin_path):
    with pytest.raises(ValueError, match="dense source"):
        RWKV(bin_path, device="cpu", quant="q4")


def test_reference_enum_spelling():
    assert Mode.PARRALEL is Mode.PARALLEL


def test_state_copies_branch_and_restore(engines):
    _, eng = engines
    eng.reset_state()
    eng.forward([5, 6, 7])
    snap = eng.snapshot(0)
    la = eng.forward(100).clone()
    eng.restore(snap, 0)
    lb = eng.forward(200)
    eng.restore(snap, 0)
    la2 = eng.forward(100)
    assert torch.equal(la, la2) and not torch.equal(la, lb)
    # get_state is a copy: later steps leave it alone
    st = eng.get_state(0)
    keep = [s.clone() for s in st]
    eng.forward(9)
    assert all(torch.equal(a, b) for a, b in zip(st, keep))
    assert all(s.is_contiguous() for s in st)


def test_parallel_mode_matches_single_streams(bin_path):
    eng = RWKV(bin_path, device="cpu", max_streams=2)
    eng.forward([1, 2, 3], stream=0)
    eng.forward([4, 5], stream=1)
    s0, s1 = eng.get_state(0), eng.get_state(1)
    both = eng.forward([7, 8], Mode.PARALLEL)
    assert both.shape == (2, 50277)
    for stream, (st, tok) in enumerate(((s0, 7), (s1, 8))):
        eng.set_state(st, stream)
        np.testing.assert_allclose(eng.forward(tok, stream=stream).numpy(),
                                   both[stream].numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        eng.forward([1], Mode.PARALLEL)


def test_generate_chunked_equals_token_at_a_time(engines):
    _, eng = engines
    eng.load_tokenizer()
    out = []
    for chunk in (1, 3):
        eng.reset_state()
        eng.load_context("Once upon a time")
        out.append(eng.generate("", max_tokens=7, seed=3, chunk=chunk))
    assert out[0] == out[1] and len(out[0]) > 0
    # a stop string cuts the text where it first appears
    stop = out[0][3:6]
    eng.reset_state()
    eng.load_context("Once upon a time")
    assert eng.generate("", max_tokens=7, seed=3, stop=[stop]) == out[0][:out[0].find(stop)]


def test_long_prompt_chunks_through_buckets(bin_path):
    eng = RWKV(bin_path, device="cpu", prefill_buckets=(8, 16))
    ids = list(np.arange(37) % 900)
    chunked = eng.forward(ids)
    one = RWKV(bin_path, device="cpu", prefill_buckets=(64,))
    np.testing.assert_allclose(chunked.numpy(), one.forward(ids).numpy(), rtol=2e-3, atol=2e-3)

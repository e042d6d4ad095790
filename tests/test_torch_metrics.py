"""The port's engine feeds its metrics registry as the JAX engine does:
every generate() call counts one engine.generate_calls and each token id it
decodes, the first one included, in engine.tokens_generated (the port's twin
of tests/test_metrics.py's engine case; CPU)."""

import pytest

from rwkv_tpu.io.binfmt import write_bin as j_write_bin
from rwkv_tpu.models.config import RWKVConfig as JConfig
from rwkv_tpu.models.rwkv4 import random_quantized_params_np as j_random_params
from rwkv_tpu.runtime.engine import RWKV as JRWKV
from rwkv_tpu.utils.metrics import metrics as j_metrics
from rwkv_tpu_torch.io.binfmt import write_bin
from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import random_quantized_params_np
from rwkv_tpu_torch.runtime.engine import RWKV
from rwkv_tpu_torch.utils.metrics import Metrics, metrics


class Tok:  # minimal tokenizer stub for generate()
    vocab_size = 97

    def encode(self, s):
        return [1, 2]

    def decode_bytes(self, ids):
        return b"x"

    def decode(self, ids):
        return "x"


def test_counters_and_timers():
    m = Metrics()
    m.inc("a")
    m.inc("a", 2.5)
    with m.timed("t"):
        pass
    snap = m.snapshot()
    assert snap["counters"]["a"] == 3.5
    assert snap["timings"]["t"]["count"] == 1
    m.reset()
    assert m.snapshot() == {"counters": {}, "timings": {}}


@pytest.fixture(scope="module")
def tiny_bin(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bin") / "rwkv-l2-e64.bin")
    write_bin(path, random_quantized_params_np(RWKVConfig(n_layer=2, n_embd=64), seed=1))
    return path


def test_engine_feeds_the_registry(tiny_bin):
    metrics.reset()
    eng = RWKV(tiny_bin, device="cpu")
    eng.tokenizer = Tok()
    eng.generate("hi", max_tokens=3, seed=0)
    snap = metrics.snapshot()
    assert snap["counters"]["engine.generate_calls"] == 1
    assert snap["counters"]["engine.tokens_generated"] == 3
    # chunked decode counts every id of every chunk, the tail included
    eng.generate("hi", max_tokens=6, seed=0, chunk=4)
    snap = metrics.snapshot()
    assert snap["counters"]["engine.generate_calls"] == 2
    assert snap["counters"]["engine.tokens_generated"] == 9
    # max_tokens <= 0 decodes nothing and counts no call, as in the JAX engine
    eng.generate("", max_tokens=0)
    assert metrics.snapshot()["counters"]["engine.generate_calls"] == 2


@pytest.mark.parametrize("max_tokens,chunk", [(1, 1), (5, 1), (7, 3)])
def test_tokens_generated_equal_to_jax(tmp_path, max_tokens, chunk):
    """The JAX engine and the port, on the same weights and seed, report the
    same counts."""
    path = str(tmp_path / "rwkv-l2-e64.bin")
    j_write_bin(path, j_random_params(JConfig(n_layer=2, n_embd=64), seed=2))
    counts = []
    for eng, reg in ((JRWKV(path), j_metrics), (RWKV(path, device="cpu"), metrics)):
        eng.tokenizer = Tok()
        reg.reset()
        eng.generate("hi", max_tokens=max_tokens, seed=3, chunk=chunk)
        c = reg.snapshot()["counters"]
        counts.append((c["engine.generate_calls"], c["engine.tokens_generated"]))
    assert counts[0] == counts[1] == (1, max_tokens)

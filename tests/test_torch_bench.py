"""The port's bench line (rwkv_tpu_torch/tools/bench.py) on the CPU: its
speed-of-light byte count equals the JAX package's bench.py's on the same
430M-shaped params, and it refuses to measure without a CUDA device."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from rwkv_tpu.models.config import RWKVConfig as JConfig
from rwkv_tpu.models.rwkv4 import random_quantized_params_device as j_random_params
from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import params_to, random_quantized_params_np, signedize_params
from rwkv_tpu_torch.tools import bench

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_bench():
    spec = importlib.util.spec_from_file_location("rwkv_tpu_root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("q4", [False, True])
def test_weight_bytes_per_token_matches_the_jax_bench(q4):
    """430M widths (L=24, E=1024, vocab padded to 50688), q8 and q4, each
    package's random params as its bench makes them: the same bytes, on
    the port's numpy leaves and on its signed torch leaves."""
    jb = _jax_bench()
    jp = j_random_params(JConfig.rwkv4_430m(), seed=0, pad_multiple=512, q4=q4)
    want = jb.weight_bytes_per_token(jp)
    del jp
    host = random_quantized_params_np(RWKVConfig.rwkv4_430m(), seed=0, pad_multiple=512, q4=q4)
    assert bench.weight_bytes_per_token(host) == want
    assert bench.weight_bytes_per_token(params_to(signedize_params(host), "cpu")) == want
    E, L = 1024, 24
    layers = L * 13 * E * E // (2 if q4 else 1)
    assert layers < want < layers + 60e6  # + the head (26 or 52 MB) and the vectors


def test_bench_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA"):
        bench.main(["--impl", "fused", "--steps", "4"])
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        bench.main(["--impl", "fused_q4", "--bin", "x.bin"])
    assert np.array_equal(bench.IMPLS, ("fused", "fused_q4", "fused_a8", "tp", "tpfused",
                                        "tpfused_q4"))

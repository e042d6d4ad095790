"""The port's bench line (rwkv_tpu_torch/tools/bench.py) on the CPU: its
speed-of-light byte count equals the JAX package's bench.py's on the same
430M-shaped params, its metric names are the root bench's, and it refuses
to measure without a CUDA device or with arguments that do not go
together."""

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
    assert np.array_equal(bench.IMPLS, ("fused", "fused_q4", "fused_a8", "plain", "tp",
                                        "tpfused", "tpfused_q4"))


@pytest.mark.parametrize("argv, why", [
    (["--impl", "plain", "--cards", "2"], "--cards"),
    (["--impl", "fused", "--prec", "bf16"], "--prec"),
    (["--impl", "tp", "--mode", "decode", "--prec", "bf16"], "--prec"),
    (["--impl", "fused_a8", "--mode", "prefill", "--prec", "bf16"], "W8A8"),
    (["--impl", "plain", "--prec", "f16"], "--prec"),
])
def test_bench_refuses_arguments_that_do_not_go_together(argv, why, capsys):
    """Refused before any device work: argparse's exit 2 with the reason."""
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr()
    assert err.out == "" and why in err.err


@pytest.mark.parametrize("argv", [["--impl", "plain"], ["--impl", "plain", "--batch", "8"],
                                  ["--mode", "prefill", "--prec", "bf16"],
                                  ["--impl", "tp", "--mode", "prefill", "--prec", "bf16"]])
def test_bench_new_modes_parse_then_need_cuda(argv, monkeypatch, capsys):
    """--impl plain and --prec bf16 prefill pass the argument checks and stop
    at the device check."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA"):
        bench.main(argv)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("args, want", [
    (("decode", "430m", "plain"), "decode_tokens_per_sec_rwkv4_430m_q8_plain"),
    (("decode", "430m", "fused", 8), "decode_tokens_per_sec_rwkv4_430m_q8_fused_b8"),
    (("decode", "14b", "tpfused_q4", 1, "f32", 4),
     "decode_tokens_per_sec_rwkv4_14b_q4_tpfused_cards4"),
    (("prefill", "430m", "fused"), "prefill_tokens_per_sec_rwkv4_430m_q8"),
    (("prefill", "430m", "fused", 1, "bf16"), "prefill_tokens_per_sec_rwkv4_430m_q8_bf16"),
    (("prefill", "430m", "tp", 1, "bf16"), "prefill_tokens_per_sec_rwkv4_430m_q8_bf16_tp"),
    (("prefill", "430m", "tpfused", 1, "f32"), "prefill_tokens_per_sec_rwkv4_430m_q8_tpfused"),
    (("prefill", "430m", "plain", 1, "bf16"), "prefill_tokens_per_sec_rwkv4_430m_q8_bf16"),
])
def test_metric_names_are_the_root_bench_names(args, want):
    """The root bench.py's names (its decode f"..._{qtag}_{itag}" with the
    port's plain where it says xla, its prefill "_bf16" then the tp impl),
    with the port's batch and cards suffixes."""
    assert bench.metric(*args) == want
    root = (ROOT / "bench.py").read_text()
    assert 'f"prefill_tokens_per_sec_rwkv4_{name}_q8"' in root and '("_bf16" if prec' in root
    assert 'f"decode_tokens_per_sec_rwkv4_{name}_{qtag}_{itag}"' in root

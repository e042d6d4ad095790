"""The port's perplexity eval (rwkv_tpu_torch/eval/) on the CPU: the 6 cases
of tests/test_ppl.py, the port's NLL against the JAX package's on the same
params (float32 and bf16), and the CLI against the JAX CLI: the same JSON
keys on a .bin, the gate passing and failing on a dense .safetensors, and
both argv errors."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import to_port
from test_safetensors import _blinkdl_state_dict

from rwkv_tpu.eval import ppl as j_ppl
from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu_torch.eval.ppl import compare_quantization, evaluate_nll
from rwkv_tpu_torch.models import rwkv4 as t_m

# the port against the JAX package on the same params: the prefill pin in
# float32; in bf16 both round the same numbers, so a larger gap is a fault
F32_NLL_TOL = 2e-3
BF16_NLL_TOL = 1e-2


@pytest.fixture(scope="module")
def setup():
    """tests/test_ppl.py's model (L = 2, E = 32, vocab 149, PRNGKey(6)) and
    tokens: the JAX dense params, the port's copy, and 300 random ids."""
    cfg = RWKVConfig.tiny_test(n_layer=2, n_embd=32, vocab_size=149)
    params = j_m.init_params(jax.random.PRNGKey(6), cfg)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, size=300)
    return cfg, params, to_port(params), ids


def _q8(tp):
    """The port's own u8 quantization of dense params (bit-equal to the JAX
    quantize_params)."""
    return t_m.params_to(t_m.quantize_params(tp), "cpu")


def test_uniform_baseline(setup):
    """Random-init model on random tokens: ppl near vocab size."""
    cfg, _, tp, ids = setup
    r = evaluate_nll(tp, ids, chunk=64)
    assert r["tokens"] == len(ids) - 1
    assert 0.3 * cfg.vocab_size < r["ppl"] < 3 * cfg.vocab_size


def test_chunk_invariance(setup):
    """Same NLL whatever the chunk size (state carries exactly)."""
    _, _, tp, ids = setup
    a = evaluate_nll(tp, ids, chunk=37)
    b = evaluate_nll(tp, ids, chunk=128)
    assert abs(a["nll"] - b["nll"]) < 2e-3


def test_quant_delta_small(setup):
    _, _, tp, ids = setup
    r = compare_quantization(tp, _q8(tp), ids, chunk=64)
    assert abs(r["nll_delta"]) < 0.05, r


def test_q4_delta_small(setup):
    """4-bit quality gate: q4 NLL stays close to dense (noisier than u8)."""
    _, _, tp, ids = setup
    q = t_m.params_to(t_m.quantize_params_q4(tp, tile=32), "cpu")
    r = compare_quantization(tp, q, ids, chunk=64)
    assert abs(r["nll_delta"]) < 0.5, r


def test_too_short_input(setup):
    _, _, tp, _ = setup
    with pytest.raises(ValueError):
        evaluate_nll(tp, np.asarray([5]))


def test_bf16_prefill_nll_close_to_f32(setup):
    """bf16 prefill's NLL shift stays within quantization's own budget."""
    _, _, tp, ids = setup
    q = _q8(tp)
    f32 = evaluate_nll(q, ids, chunk=64)
    bf16 = evaluate_nll(q, ids, chunk=64, compute_dtype=torch.bfloat16)
    assert abs(bf16["nll"] - f32["nll"]) < 0.05, (bf16["nll"], f32["nll"])


@pytest.mark.parametrize("family", ["dense", "q8", "q4"])
def test_nll_matches_jax(setup, family):
    """The port's NLL against the JAX evaluate_nll on the same params and
    tokens, float32 and bf16."""
    _, jp, tp, ids = setup
    if family == "q8":
        jp, tp = j_m.quantize_params(jp), _q8(tp)
    elif family == "q4":
        jp = j_m.quantize_params_q4(jp, tile=32)
        tp = to_port(jp)
    for t_dt, j_dt, tol in ((torch.float32, jnp.float32, F32_NLL_TOL),
                            (torch.bfloat16, jnp.bfloat16, BF16_NLL_TOL)):
        got = evaluate_nll(tp, ids, chunk=64, compute_dtype=t_dt)
        want = j_ppl.evaluate_nll(jp, ids, chunk=64, compute_dtype=j_dt)
        assert got["tokens"] == want["tokens"]
        assert abs(got["nll"] - want["nll"]) <= tol, (family, t_dt, got["nll"], want["nll"])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A .bin (L = 2, E = 64) written by the JAX write_bin, a dense
    .safetensors (BlinkDL names, L = 2, E = 32) written by the port's
    io/safetensors.py, and a text file of about 120 tokens."""
    from rwkv_tpu.io.binfmt import write_bin
    from rwkv_tpu_torch.io.safetensors import write_safetensors

    d = tmp_path_factory.mktemp("eval")
    bin_path = str(d / "m.bin")
    write_bin(bin_path, j_m.random_quantized_params_np(RWKVConfig(n_layer=2, n_embd=64),
                                                       seed=2, pad_multiple=None))
    st_path = str(d / "m.safetensors")
    write_safetensors(st_path, _blinkdl_state_dict(n_layer=2, n_embd=32))
    text = d / "t.txt"
    text.write_text("The quick brown fox jumps over the lazy dog. " * 12, encoding="utf-8")
    return bin_path, st_path, str(text)


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_on_a_bin_matches_jax_cli(files, capsys):
    from rwkv_tpu.eval.cli import main as j_main
    from rwkv_tpu_torch.eval.cli import main as t_main

    bin_path, _, text = files
    argv = ["--model", bin_path, "--text", text, "--chunk", "64"]
    for extra in ([], ["--bf16"]):
        jrc, jout = _run(j_main, argv + extra, capsys)
        trc, tout = _run(t_main, argv + extra + ["--device", "cpu"], capsys)
        assert jrc == trc == 0
        assert set(tout) == set(jout)
        assert tout["tokens"] == jout["tokens"] > 100
        tol = BF16_NLL_TOL if extra else F32_NLL_TOL
        assert abs(tout["quant_nll"] - jout["quant_nll"]) <= tol, (extra, tout, jout)


@pytest.mark.parametrize("gate,rc", [(1e9, 0), (-1e9, 1)])
def test_cli_gate_passes_and_fails(files, capsys, gate, rc):
    """--gate on a dense .safetensors: exit 0 when ppl(q8) - ppl(dense) is
    within the gate, 1 when not, with the JAX CLI's keys."""
    from rwkv_tpu.eval.cli import main as j_main
    from rwkv_tpu_torch.eval.cli import main as t_main

    _, st_path, text = files
    argv = ["--model", st_path, "--text", text, "--gate", str(gate)]
    trc, tout = _run(t_main, argv + ["--device", "cpu"], capsys)
    jrc, jout = _run(j_main, argv, capsys)
    assert trc == jrc == rc
    assert set(tout) == set(jout)
    assert tout["gate_passed"] is (rc == 0)
    assert abs(tout["ppl_delta"] - jout["ppl_delta"]) <= 1e-2 * max(1.0, abs(jout["ppl_delta"]))


@pytest.mark.parametrize("flags", [["--gate", "0.05"], ["--quant", "q4"]])
def test_cli_argv_errors_on_a_bin(files, flags):
    """--gate and --quant q4 need a dense source: refused before loading."""
    from rwkv_tpu_torch.eval.cli import main

    bin_path, _, text = files
    with pytest.raises(SystemExit) as e:
        main(["--model", bin_path, "--text", text, "--device", "cpu"] + flags)
    assert e.value.code == 2

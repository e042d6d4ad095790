"""rwkv_tpu_torch ops against rwkv_tpu's on the same numpy inputs (CPU).

LayerNorm, the WKV recurrence (step, scan, parallel; masked and not), the
quantized matmul, the samplers, the tokenizer, and the port's import rule.
"""

import ast
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_tpu.ops import layernorm as j_ln
from rwkv_tpu.ops import quant as j_quant
from rwkv_tpu.ops import sampling as j_sampling
from rwkv_tpu.ops import wkv as j_wkv
from rwkv_tpu_torch.ops import layernorm as t_ln
from rwkv_tpu_torch.ops import quant as t_quant
from rwkv_tpu_torch.ops import sampling as t_sampling
from rwkv_tpu_torch.ops import wkv as t_wkv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = torch.from_numpy


@pytest.mark.parametrize("shape", [(7,), (5, 33), (4, 3, 64)])
def test_layer_norm_matches_jax(rng, shape):
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    ref = np.asarray(j_ln.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = t_ln.layer_norm(T(x), T(w), T(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def _wkv_inputs(rng, T_=17, E=8, k_scale=3.0, batch=()):
    k = rng.normal(size=(T_,) + batch + (E,)).astype(np.float32) * k_scale
    v = rng.normal(size=(T_,) + batch + (E,)).astype(np.float32)
    w = -np.exp(rng.normal(size=(E,)).astype(np.float32))
    u = rng.normal(size=(E,)).astype(np.float32)
    # a non-empty start state: the state after a short warm-up sequence
    aa = rng.normal(size=batch + (E,)).astype(np.float32)
    bb = np.abs(rng.normal(size=batch + (E,))).astype(np.float32) + 0.5
    pp = rng.normal(size=batch + (E,)).astype(np.float32)
    return k, v, w, u, (aa, bb, pp)


def test_wkv_step_matches_jax(rng):
    k, v, w, u, st = _wkv_inputs(rng, T_=1, batch=(3,))
    y_j, s_j = j_wkv.wkv_step(*map(jnp.asarray, (k[0], v[0])),
                              j_wkv.WKVChannelState(*map(jnp.asarray, st)),
                              jnp.asarray(w), jnp.asarray(u))
    y_t, s_t = t_wkv.wkv_step(T(k[0]), T(v[0]), t_wkv.WKVChannelState(*map(T, st)), T(w), T(u))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=2e-5, atol=2e-5)
    for a, b in zip(s_t, s_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fn", ["wkv_scan", "wkv_parallel"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("empty_start", [False, True])
def test_wkv_sequence_matches_jax(rng, fn, masked, empty_start):
    k, v, w, u, st = _wkv_inputs(rng, T_=13, batch=(2,))
    if empty_start:
        st = (np.zeros_like(st[0]), np.zeros_like(st[1]), np.full_like(st[2], -1e30))
    mask = (np.arange(13) < 9) if masked else None
    y_j, s_j = getattr(j_wkv, fn)(
        *map(jnp.asarray, (k, v)), j_wkv.WKVChannelState(*map(jnp.asarray, st)),
        jnp.asarray(w), jnp.asarray(u), None if mask is None else jnp.asarray(mask))
    y_t, s_t = getattr(t_wkv, fn)(
        T(k), T(v), t_wkv.WKVChannelState(*map(T, st)), T(w), T(u),
        None if mask is None else T(mask))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=2e-5, atol=2e-5)
    for a, b in zip(s_t, s_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("k_scale", [1.0, 40.0])
def test_wkv_parallel_matches_scan_and_stays_finite(rng, k_scale):
    k, v, w, u, st = _wkv_inputs(rng, T_=300, E=4, k_scale=k_scale)
    s0 = t_wkv.empty_channel_state((4,))
    y_s, f_s = t_wkv.wkv_scan(T(k), T(v), s0, T(w), T(u))
    y_p, f_p = t_wkv.wkv_parallel(T(k), T(v), s0, T(w), T(u))
    assert torch.isfinite(y_p).all() and torch.isfinite(f_p.aa).all()
    np.testing.assert_allclose(y_p.numpy(), y_s.numpy(), rtol=3e-4, atol=3e-5)
    np.testing.assert_allclose(f_p.bb.numpy(), f_s.bb.numpy(), rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("signed", [False, True])
def test_qmatmul_matches_jax(rng, signed):
    w = rng.normal(size=(48, 40)).astype(np.float32)
    jq = j_quant.quantize(w, as_numpy=True)
    if signed:
        jq = j_quant.to_signed(jq)
    tq = t_quant.QuantLinear(w=T(np.asarray(jq.w)), scale=T(np.asarray(jq.scale)),
                             offset=T(np.asarray(jq.offset)))
    x = rng.normal(size=(2, 3, 48)).astype(np.float32)
    ref = np.asarray(j_quant.qmatmul(jnp.asarray(x), jax.tree.map(jnp.asarray, jq)))
    np.testing.assert_allclose(t_quant.qmatmul(T(x), tq).numpy(), ref, rtol=2e-5, atol=2e-5)


def test_to_signed_host_and_device_paths_agree(rng):
    jq = j_quant.quantize(rng.normal(size=(16, 24)).astype(np.float32), as_numpy=True)
    host = t_quant.to_signed(t_quant.QuantLinear(np.asarray(jq.w), np.asarray(jq.scale),
                                                 np.asarray(jq.offset)))
    dev = t_quant.to_signed(t_quant.QuantLinear(T(np.asarray(jq.w)), T(np.asarray(jq.scale)),
                                                T(np.asarray(jq.offset))))
    ref = j_quant.to_signed(jq)
    assert host.w.dtype == np.int8 and dev.w.dtype == torch.int8
    np.testing.assert_array_equal(host.w, np.asarray(ref.w))
    np.testing.assert_array_equal(dev.w.numpy(), np.asarray(ref.w))
    np.testing.assert_allclose(dev.offset.numpy(), np.asarray(ref.offset), rtol=1e-6)
    np.testing.assert_array_equal(host.offset, np.asarray(ref.offset))


def test_greedy_exact(rng):
    logits = rng.normal(size=(5, 100)).astype(np.float32)
    np.testing.assert_array_equal(t_sampling.greedy(T(logits)).numpy(),
                                  np.asarray(j_sampling.greedy(jnp.asarray(logits))))


def _typical_weights(logits, temp, tau):
    """The typical-sampling distribution, in float64 numpy."""
    z = logits.astype(np.float64)
    logp = z - z.max() - np.log(np.exp(z - z.max()).sum())
    p = np.exp(logp)
    shifted = np.abs(-logp - (-(p * logp).sum()))
    order = np.argsort(shifted, kind="stable")
    cut = min(int((np.cumsum(p[order]) < tau).sum()), len(p) - 1)
    kept = np.where(shifted > shifted[order][cut], 0.0, p) ** (1.0 / temp)
    return kept / kept.sum()


@pytest.mark.parametrize("temp,tau", [(1.0, 1.0), (0.7, 1.0), (1.3, 0.2), (0.9, 0.2)])
def test_typical_distribution_matches_jax(rng, temp, tau):
    """The RNGs differ, so compare 20,000 draws from each package: the same
    support, inside the kept set, and a total-variation distance under 0.05
    (the expected TV of two such samples over <= 64 tokens is under 0.033)."""
    n, V = 20000, 64
    logits = (rng.normal(size=V) * 0.5).astype(np.float32)
    j_ids = np.asarray(j_sampling.typical(jax.random.PRNGKey(0),
                                          jnp.broadcast_to(jnp.asarray(logits), (n, V)),
                                          temp=temp, tau=tau))
    gen = torch.Generator().manual_seed(0)
    t_ids = t_sampling.typical(T(logits).expand(n, V), gen, temp=temp, tau=tau).numpy()
    kept = set(np.flatnonzero(_typical_weights(logits, temp, tau) > 0))
    assert set(np.unique(t_ids)) == set(np.unique(j_ids))
    assert set(np.unique(t_ids)) <= kept
    tv = 0.5 * np.abs(np.bincount(t_ids, minlength=V) - np.bincount(j_ids, minlength=V)).sum() / n
    assert tv < 0.05, tv


@pytest.fixture(scope="module")
def port_tok():
    from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer

    return BPETokenizer.load()


def test_tokenizer_reproduces_golden(port_tok):
    with open(os.path.join(REPO, "tests", "fixtures", "golden_tokens.json"),
              encoding="utf-8") as f:
        golden = json.load(f)
    from rwkv_tpu_torch.tokenizer.bpe import StreamDecoder

    for i, case in enumerate(golden["cases"]):
        assert port_tok.encode(case["text"]) == case["ids"], case["text"][:40]
        assert port_tok.decode(case["ids"]) == case["decoded"], case["text"][:40]
        if i < 30:
            dec = StreamDecoder(port_tok)
            out = "".join(dec.feed([t]) for t in case["ids"]) + dec.flush()
            assert out == case["decoded"]


def test_tokenizer_asset_is_its_own_identical_copy():
    from rwkv_tpu_torch.tokenizer import assets

    assert os.path.dirname(assets.ASSET).endswith(os.path.join("rwkv_tpu_torch", "tokenizer",
                                                               "assets"))
    assert filecmp.cmp(assets.ASSET, os.path.join(REPO, "rwkv_tpu", "tokenizer", "assets",
                                                  "rwkv20b.json.gz"), shallow=False)


def test_stop_scanner_matches_jax():
    from rwkv_tpu.utils.text import StopScanner as JS
    from rwkv_tpu_torch.utils.text import StopScanner as TS

    pieces = ["Hel", "lo wo", "rld\n\nUs", "er: more", " text"]
    for stop in (None, ["\n\nUser:"], ["wor", "xyz"], ["text"]):
        j, t = JS(stop), TS(stop)
        for p in pieces:
            j.feed(p)
            t.feed(p)
            assert t.cut == j.cut


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "rwkv_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "rwkv_tpu")]
    assert not bad, bad

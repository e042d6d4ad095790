"""The port's sample_logits (rwkv_tpu_torch/ops/sampling.py) against the
JAX package's (CPU): the kept set and the tempered log-weights the JAX
function hands to jax.random.categorical, and the draws against the
renormalized kept probabilities by a chi-square test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from rwkv_tpu.ops import sampling as j_sampling
from rwkv_tpu_torch.ops import sampling as t_sampling


def _jax_weights(monkeypatch, logits, temp, top_p):
    """The logits the JAX sample_logits draws from, caught at its call of
    jax.random.categorical."""
    seen = {}

    def spy(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", spy)
    j_sampling.sample_logits(jax.random.PRNGKey(0), jnp.asarray(logits), temp=temp, top_p=top_p)
    monkeypatch.undo()
    return seen["logits"]


@pytest.mark.parametrize("temp", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("top_p", [0.5, 0.9, 1.0])
def test_kept_set_matches_jax(monkeypatch, top_p, temp):
    rng = np.random.default_rng(int(top_p * 10 + temp * 100))
    logits = (rng.normal(size=(6, 2000)) * 2.0).astype(np.float32)
    want = _jax_weights(monkeypatch, logits, temp, top_p)
    got = t_sampling.nucleus_logits(torch.from_numpy(logits), temp=temp, top_p=top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    kept = np.isfinite(want)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6)
    if top_p < 1.0:
        assert 0 < kept.sum(axis=-1).max() < logits.shape[-1]
    else:
        assert kept.all()


@pytest.mark.parametrize("temp,top_p", [(1.0, 1.0), (0.7, 0.9), (2.0, 0.5), (0.5, 0.95)])
def test_draws_follow_the_kept_distribution(temp, top_p):
    """20,000 draws over 40 tokens: a chi-square test against the
    renormalized kept probabilities (p > 1e-3), and nothing outside the
    kept set."""
    rng = np.random.default_rng(7)
    V, n = 40, 20000
    logits = torch.from_numpy((rng.normal(size=V) * 1.5).astype(np.float32))
    w = t_sampling.nucleus_logits(logits, temp=temp, top_p=top_p).double()
    p = torch.softmax(w, dim=-1).numpy()
    gen = torch.Generator().manual_seed(11)
    ids = t_sampling.sample_logits(logits.expand(n, V), gen, temp=temp, top_p=top_p).numpy()
    counts = np.bincount(ids, minlength=V)
    assert counts[p == 0].sum() == 0
    keep = p > 0
    res = stats.chisquare(counts[keep], p[keep] / p[keep].sum() * n)
    assert res.pvalue > 1e-3, res


def test_seeded_and_per_row_generators():
    logits = torch.randn(4, 300, generator=torch.Generator().manual_seed(1)) * 3
    draw = lambda g: t_sampling.sample_logits(logits, g, temp=0.7, top_p=0.9)  # noqa: E731
    a = draw(torch.Generator().manual_seed(3))
    assert torch.equal(a, draw(torch.Generator().manual_seed(3)))
    assert a.shape == (4,) and a.dtype == torch.int64
    rows = draw([torch.Generator().manual_seed(s) for s in range(4)])
    for b in range(4):  # row b draws from its own generator alone
        alone = t_sampling.sample_logits(logits[b], torch.Generator().manual_seed(b),
                                         temp=0.7, top_p=0.9)
        assert int(alone) == int(rows[b])
    with pytest.raises(ValueError, match="one per row"):
        draw([torch.Generator()] * 3)


def test_temperature_clamp_and_greedy_edge():
    """temp 0 divides by 1e-6 (the JAX clamp): the draw is the argmax; a
    tiny top_p keeps the most likely token alone."""
    logits = torch.randn(8, 100, generator=torch.Generator().manual_seed(2))
    g = torch.Generator().manual_seed(0)
    assert torch.equal(t_sampling.sample_logits(logits, g, temp=0.0), logits.argmax(-1))
    kept = torch.isfinite(t_sampling.nucleus_logits(logits, top_p=1e-9))
    assert torch.equal(kept.sum(-1), torch.ones(8, dtype=torch.int64))
    assert torch.equal(t_sampling.sample_logits(logits, g, top_p=1e-9), logits.argmax(-1))

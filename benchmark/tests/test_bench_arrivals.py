"""Open-loop arrivals read from the traffic file: a schedule fixed by the seed,
at the rate and burstiness the file states, and a harness that submits each
request at its arrival and times it from there."""

import itertools
import statistics

import pytest

from benchmark import run
from benchmark.tests.cells import tiny
from benchmark.traffic import arrival_offsets

POISSON = {"rate_per_s": 40.0}
BURSTS = {"rate_per_s": 40.0, "cv": 2.0}


def first(arrivals, seed, n):
    return list(itertools.islice(arrival_offsets(arrivals, seed), n))


@pytest.mark.parametrize("arrivals", [POISSON, BURSTS], ids=["poisson", "gamma"])
def test_the_schedule_is_the_seeds(arrivals):
    a, b, c = (first(arrivals, s, 3000) for s in (2 ** 40 + 5, 2 ** 40 + 5, 2 ** 40 + 6))
    assert a == b and a != c
    assert a[0] == 0.0 and all(y >= x for x, y in zip(a, a[1:]))


@pytest.mark.parametrize("arrivals,cv", [(POISSON, 1.0), (BURSTS, 2.0)], ids=["poisson", "gamma"])
@pytest.mark.parametrize("seed", [7, 2 ** 41 + 3])
def test_rate_and_burstiness(arrivals, cv, seed):
    """The mean rate within 3 % and the gaps' coefficient of variation within
    10 %, over N arrivals: the mean of N gaps spreads by cv / sqrt(N), so 3 %
    is three of its standard deviations at cv 2."""
    n = 40_000
    t = first(arrivals, seed, n + 1)
    gaps = [y - x for x, y in zip(t, t[1:])]
    assert abs(n / t[-1] / arrivals["rate_per_s"] - 1) < 0.03
    assert abs(statistics.pstdev(gaps) / statistics.fmean(gaps) / cv - 1) < 0.10


@pytest.mark.parametrize("arrivals", [{"rate_per_s": 0.0}, {"rate_per_s": 1.0, "cv": 0.0}],
                         ids=["no-rate", "no-cv"])
def test_a_schedule_without_gaps_is_refused(arrivals):
    with pytest.raises(ValueError):
        first(arrivals, 1, 2)


@pytest.mark.parametrize("rate", [3.0, 30.0], ids=["idle-between", "queue-grows"])
def test_an_open_loop_submits_at_each_arrival(rate, monkeypatch):
    """Nothing is submitted before its arrival: the pool's own stamp of each
    request's submit is at or after its scheduled arrival. Each request is
    timed from its arrival; every request that arrived in the window is
    recorded."""
    from benchmark import serve

    windows = []
    drive = serve.Server.run

    def record(*args, **kwargs):
        windows.append(drive(*args, **kwargs))
        return windows[-1]

    monkeypatch.setattr(serve.Server, "run", record)
    arrivals = {"rate_per_s": rate}
    seed = 2 ** 36 + 17
    out = run.run_cell(tiny("rwkv4-430m-q8.chat", arrivals=arrivals), seed, 1.5,
                       trace=False, device="cpu")
    win = windows[0]
    recs = sorted(win.recs, key=lambda r: r.spec.index)
    t = first(arrivals, seed, len(recs) + 1)
    assert [r.spec.index for r in recs] == list(range(len(recs)))
    t0 = recs[0].t_submit
    for r in recs:
        assert r.t_submit == t0 + t[r.spec.index]
        assert r.program.t_submit >= r.t_submit
    assert t0 + t[len(recs)] >= win.t_end  # the next had not arrived at the close
    assert out["attempted"] > 0 and out["failed"] == 0
    if rate > 10:
        assert out["correct"], out["numbers"]

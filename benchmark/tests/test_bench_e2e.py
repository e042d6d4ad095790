"""Each end-to-end metric moves when a stall is put into a synthetic window:
they are taken over the whole window, not as medians of chunks."""

import dataclasses

import pytest

from benchmark import e2e
from benchmark.serve import Rec, Step, Window
from benchmark.traffic import RequestSpec


@dataclasses.dataclass
class Prog:
    prompt_ids: list


def window(stalls=(), stall=0.0):
    """4 clients; each request: submit, first token 0.1 s later, then a token
    every 0.05 s for 10 tokens; a new request on completion. Each stall
    delays every event after its time by `stall` seconds."""
    recs, steps, t_end = [], [], 6.0
    shift = lambda t: t + stall * sum(t >= s for s in stalls)  # noqa: E731
    for c in range(4):
        t = 0.02 * c
        i = 0
        while t < t_end:
            spec = RequestSpec(i, "x", 50, 10, 0.9, 0.8, i, False)
            r = Rec(spec=spec, rid=len(recs), program=Prog([1] * 50), t_submit=shift(t))
            times = [t + 0.1 + 0.05 * k for k in range(10)]
            r.deliveries = [(shift(x), 1) for x in times]
            r.t_first, r.t_done = r.deliveries[0][0], r.deliveries[-1][0]
            r.tokens = [1] * 10
            recs.append(r)
            t = times[-1]
            i += 1
    steps = [Step(0.0, 0.01, False)]
    return Window(t_start=0.5, t_end=5.5, recs=recs, steps=steps, submits=[], ns_offset=0)


# a stall every 0.25 s: more than a twentieth of the gaps hold one; the median
# gap moves only once more than half of them do (a stall every 0.08 s)
STALL_PERIOD = {"stream_gap_p50_ms": 0.08}


@pytest.mark.parametrize("name", sorted(e2e.METRICS))
def test_a_stall_moves_each_metric(name):
    f = e2e.METRICS[name]
    period = STALL_PERIOD.get(name, 0.25)
    stalls = [1 + period * i for i in range(round(4.25 / period))]
    base, stalled = f(window()), f(window(stalls=stalls, stall=0.1))
    better_lower = name.endswith("_ms")
    assert (stalled > base) if better_lower else (stalled < base), (name, base, stalled)


def test_rates_count_all_work_of_the_window():
    w = window()
    n = sum(1 for r in w.recs for t, _ in r.deliveries if 0.5 < t <= 5.5)
    assert e2e.output_tokens_per_s(w) == pytest.approx(n / 5.0)
    first = [r for r in w.recs if 0.5 < r.t_first <= 5.5]
    assert e2e.prompt_tokens_per_s(w) == pytest.approx(50 * len(first) / 5.0)


def test_the_median_gap_is_the_pace_between_stalls():
    assert e2e.stream_gap_p50_ms(window()) == pytest.approx(50.0)
    sparse = window(stalls=[1 + 0.25 * i for i in range(17)], stall=0.1)
    assert e2e.stream_gap_p50_ms(sparse) == pytest.approx(50.0)
    assert e2e.stream_gap_p95_ms(sparse) > 100.0


def test_a_request_still_waiting_counts_its_wait():
    w = window()
    r = w.recs[-1]
    r.t_submit, r.t_first = 5.0, None
    assert 0.5 * 1e3 in [pytest.approx(x * 1e3) for x in e2e.ttfts(w)]


def test_percentile_matches_linear_interpolation():
    assert e2e.percentile([1, 2, 3, 4, 5], 50) == 3
    assert e2e.percentile(list(range(101)), 95) == pytest.approx(95)
    assert e2e.percentile([0, 10], 95) == pytest.approx(9.5)


def test_a_qualified_name_reads_its_quantity():
    assert e2e.quantity("output_tokens_per_s.host_bound") == "output_tokens_per_s"
    assert e2e.quantity("ttft_p95_ms") == "ttft_p95_ms"


@pytest.mark.parametrize("name", ["output_tokens_per_s", "stream_gap_p95_ms"])
def test_a_traced_reader_reads_its_end_to_end_quantity(name):
    from benchmark import spec

    ctx = dataclasses.make_dataclass("Ctx", ["window"])(window())
    assert spec.layer_reader(f"{name}.traced")(ctx) == pytest.approx(e2e.METRICS[name](ctx.window))

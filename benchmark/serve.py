"""The system under test, driven as the program's HTTP server drives it.

The configuration's family (spec.family) builds the engine and its pool
around the benchmark's weights, as `apps/server.py::make_server` builds
them. The process keeps torch's default host threads and Python's default
garbage collection, as the server does. The traffic's clients drive the pool
through `submit()` and `step()`, as the server's PoolRunner does: in a
closed loop each client sends its next request as soon as its last one
completes; in an open loop every request that is due by its arrival
(traffic.py) is submitted before each `step()`, and a request's submit time
is its arrival, so a late submit counts in its wait.

Every span is taken on the host's clock around the program's calls, in
seconds of time.perf_counter(). The served ids are recorded where the pool
hands them to a request (its `_emit`), since the pool returns text only;
the recording adds a list append a token.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import torch

from benchmark.traffic import RequestSpec, Traffic

now = time.perf_counter


@dataclasses.dataclass
class Rec:
    """One request as its client saw it."""

    spec: RequestSpec
    rid: int
    program: object          # the pool's Request
    t_submit: float          # submit() called; in an open loop, the arrival
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    tokens: list = dataclasses.field(default_factory=list)
    deliveries: list = dataclasses.field(default_factory=list)  # (t, tokens)
    seen: int = 0

    @property
    def prompt_tokens(self) -> int:
        return len(self.program.prompt_ids)


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    admitted: bool


@dataclasses.dataclass
class Window:
    t_start: float
    t_end: float
    recs: list
    steps: list
    submits: list            # (t0, t1, prompt tokens)
    ns_offset: int           # time.time_ns() - perf_counter_ns() at the start

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


class Server:
    def __init__(self, cfg: dict, family, weights: dict, device):
        self.cfg = cfg
        self.family = family
        self.device = torch.device(device)
        self.eng, self.pool = family.program(cfg, weights, self.device)
        self.served: dict[int, list[int]] = {}
        self.touched: set[int] = set()
        emit = self.pool._emit

        def recording_emit(req, token):
            self.served.setdefault(req.rid, []).append(int(token))
            self.touched.add(req.rid)
            return emit(req, token)

        self.pool._emit = recording_emit

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_prefill(self) -> None:
        """Admission's prefill at every burst width (its products' shapes),
        with a length mask, and once without; its first-token sampling at
        every burst size."""
        pool = self.pool
        K, Vp = pool.prefill_bucket, pool.cfg.vocab_size
        for W in pool._widths:
            toks = torch.ones((K, W), dtype=torch.int64, device=self.device)
            lens = torch.full((W,), K // 2, dtype=torch.int64, device=self.device)
            pool._prefill(pool.params, toks, lens, pool._new_state(W))
        pool._prefill(pool.params, toks[:, :1], None, pool._new_state(1))
        for n in range(1, pool.B + 1):
            pool._admit_sample(torch.zeros((n, Vp), device=self.device), pool._gens[:n],
                               torch.full((n,), 0.9, dtype=torch.float64),
                               torch.full((n,), 0.8), torch.zeros((n, Vp), dtype=torch.bool,
                                                                  device=self.device))
        self.sync()

    def run(self, traffic: Traffic, seconds: float, warmup_steps: int,
            on_start: Callable[[], None] = lambda: None,
            on_end: Callable[[], None] = lambda: None) -> Window:
        """Drive the pool: `warmup_steps` steps run before the window opens,
        then steps run until the first one that returns `seconds` or more
        after the window opened. A closed loop starts with every client's
        request submitted. An open loop's schedule starts before the first
        warm-up step; while nothing is queued or in flight it sleeps until
        the next arrival, and its window closes at `seconds` if it is idle
        then. The requests that arrived during the window's last step are
        submitted after it closes, so that they count as waiting."""
        pool = self.pool
        recs: dict[int, Rec] = {}
        steps: list[Step] = []
        submits: list = []
        waiting = 0
        index = 0
        offsets = traffic.arrivals()
        closed = offsets is None
        t_schedule = now()
        due = math.inf if closed else t_schedule + next(offsets)  # the next arrival

        def submit(t_due=None):
            nonlocal waiting, index
            spec = traffic.request(index)
            index += 1
            t0 = now()
            rid = pool.submit(spec.text, spec.max_tokens, temp=spec.temp, tau=spec.tau,
                              seed=spec.seed)
            t1 = now()
            req = pool._queue[-1]
            recs[rid] = Rec(spec=spec, rid=rid, program=req,
                            t_submit=t0 if t_due is None else t_due)
            submits.append((t0, t1, len(req.prompt_ids)))
            waiting += 1

        def arrive() -> bool:
            """Submit every request due by now, in order; False where the
            pool holds nothing, and the loop should wait for `due`."""
            nonlocal due
            while due <= now():
                submit(due)
                due = t_schedule + next(offsets)
            return pool.pending > 0

        def step():
            nonlocal waiting
            admitted = waiting > 0
            t0 = now()
            finished = pool.step()
            t1 = now()
            waiting = len(pool._queue)
            steps.append(Step(t0, t1, admitted))
            for rid in self.touched:
                rec = recs[rid]
                got = self.served[rid]
                rec.deliveries.append((t1, len(got) - rec.seen))
                rec.seen = len(got)
                rec.tokens = got
                if rec.t_first is None:
                    rec.t_first = t1
            self.touched.clear()
            for req in finished:
                recs[req.rid].t_done = t1
                if closed:
                    submit()
            return t1

        def turn(deadline: float) -> float:
            """One step() with every request due submitted before it, or,
            with nothing to step, a sleep until the next arrival or the
            deadline, whichever is first. Returns the time it ended."""
            if closed or arrive():
                return step()
            time.sleep(max(0.0, min(due, deadline) - now()))
            return now()

        if closed:
            for _ in range(traffic.mix["clients"]):
                submit()
        while len(steps) < warmup_steps:
            turn(math.inf)
        on_start()
        offset = time.time_ns() - time.perf_counter_ns()
        t_start = now()
        t_end = t_start
        while t_end - t_start < seconds:
            t_end = turn(t_start + seconds)
        self.sync()
        on_end()
        while due < t_end:  # arrived in the window's last step: waiting at its close
            submit(due)
            due = t_schedule + next(offsets)
        return Window(t_start, t_end, list(recs.values()), steps, submits, offset)

    def in_flight(self) -> dict[int, int]:
        """rid -> slot of every request the pool holds."""
        return {req.rid: slot for slot, req in self.pool._by_slot.items()}

    def slot_state(self, slot: int) -> dict:
        """One slot's state, as the family gives it (float64 leaves on the host)."""
        return self.family.slot_state(self.pool, slot)

    def close(self) -> None:
        """Free the program's device memory (its graphs, state and pool)."""
        from rwkv_tpu_torch.runtime import graphs

        self.pool._emit = None
        del self.pool, self.eng
        graphs.release_all()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

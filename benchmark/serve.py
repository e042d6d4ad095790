"""The system under test, driven as the program's HTTP server drives it.

The engine is `RWKV(device, max_streams=16, quant="q8")` given the
benchmark's weights through `load_params` and the tokenizer that the
configuration names, and the pool is built as `apps/server.py::make_server`
builds it (the engine's step and prefill, its prefill type, the server's
--pool-chunk). The process keeps torch's default host threads and Python's
default garbage collection, as the server does. A closed loop of clients drives
the pool through `submit()` and `step()`, as the server's PoolRunner does:
each client sends its next request as soon as its last one completes.

Every span is taken on the host's clock around the program's calls, in
seconds of time.perf_counter(). The served ids are recorded where the pool
hands them to a request (its `_emit`), since the pool returns text only;
the recording adds a list append a token.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from benchmark import weights as wmod
from benchmark.traffic import RequestSpec, Traffic

now = time.perf_counter


@dataclasses.dataclass
class Rec:
    """One request as its client saw it."""

    spec: RequestSpec
    rid: int
    program: object          # the pool's Request
    t_submit: float
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
    def __init__(self, cfg: dict, weights: dict, device):
        from rwkv_tpu_torch.runtime.engine import RWKV
        from rwkv_tpu_torch.runtime.pool import InferencePool

        e = cfg["engine"]
        self.cfg = cfg
        self.device = torch.device(device)
        self.eng = RWKV(device=self.device, max_streams=e["max_streams"], quant="q8",
                        prefill_dtype=getattr(torch, e["prefill_dtype"]))
        self.eng.load_params(wmod.program_params(weights))
        self.eng.load_tokenizer(native=e["tokenizer"] == "native")
        self.pool = InferencePool(
            self.eng.params, self.eng.tokenizer, max_streams=e["max_streams"],
            step_fn=self.eng._step_fn, prefill_fn=self.eng._prefill_impl,
            prefill_dtype=self.eng.prefill_dtype, step_chunk=e["step_chunk"])
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
        """The closed loop: every client submits, `warmup_steps` steps run
        before the window opens, then steps run until the first one that
        returns `seconds` or more after the window opened."""
        pool = self.pool
        recs: dict[int, Rec] = {}
        steps: list[Step] = []
        submits: list = []
        waiting = 0
        index = 0

        def submit():
            nonlocal waiting, index
            spec = traffic.request(index)
            index += 1
            t0 = now()
            rid = pool.submit(spec.text, spec.max_tokens, temp=spec.temp, tau=spec.tau,
                              seed=spec.seed)
            t1 = now()
            req = pool._queue[-1]
            recs[rid] = Rec(spec=spec, rid=rid, program=req, t_submit=t0)
            submits.append((t0, t1, len(req.prompt_ids)))
            waiting += 1

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
                submit()
            return t1

        for _ in range(traffic.mix["clients"]):
            submit()
        for _ in range(warmup_steps):
            step()
        on_start()
        offset = time.time_ns() - time.perf_counter_ns()
        t_start = now()
        t_end = t_start
        while t_end - t_start < seconds:
            t_end = step()
        self.sync()
        on_end()
        return Window(t_start, t_end, list(recs.values()), steps, submits, offset)

    def in_flight(self) -> dict[int, int]:
        """rid -> slot of every request the pool holds."""
        return {req.rid: slot for slot, req in self.pool._by_slot.items()}

    def slot_state(self, slot: int) -> dict:
        """One slot's state, leaves [L, E] float64 on the host."""
        st = self.pool._state
        return {leaf: getattr(st, leaf)[:, slot].double().cpu()
                for leaf in ("xy", "aa", "bb", "pp", "dd")}

    def close(self) -> None:
        """Free the program's device memory (its graphs, state and pool)."""
        from rwkv_tpu_torch.runtime import graphs

        self.pool._emit = None
        del self.pool, self.eng
        graphs.release_all()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

"""Continuous-batching inference pool (counterpart of rwkv_tpu/runtime/pool.py).

N independent conversations advance one token per batched decode step, as
the reference's PARRALEL mode does, and requests join and leave the batch at
any step. One step advances every slot (the decode step, then per-slot typical
sampling on the device), and only the B sampled ids cross to the host, where
the stop-string and length bookkeeping runs.

The pool's state is one WKVState with leaves [L, B, E] on the params' device
("cuda" on the card, where the step runs the decode kernels; "cpu" for the
plain versions); on sharded params (parallel/sharding.py's ShardedParams) a
ShardedState resident per shard, each shard's piece on its own device: a
step advances it in place, and admission writes only the admitted slots'
lanes on each shard (no whole-state cut or join). A freed slot keeps its
old state until an admission overwrites it.

Sampling: each slot draws its noise from its own torch.Generator on the
device, one for the pool's life, reseeded with the request's seed at
admission (the JAX pool keeps one PRNG key per slot instead, and its key
layout is not ported). So a request's tokens depend only on its prompt, its
seed and its sampling settings, not on its batchmates, and not on
step_chunk.

The batched decode program (`_batched_step_k`: step_chunk steps of the
decode step, the ban mask and per-slot typical, the JAX pool's _jit_step /
_jit_step_k) is captured on CUDA as one CUDA graph per step_chunk and
replayed (runtime/graphs.py); the slot generators are registered with it.
Its inputs (tokens, temp, tau, active) are built from the host lists
outside it and copied into its buffers; the state and the tokens are its
carry. Admission (prefill and the burst's first tokens, JAX: _jit_admit)
runs eagerly, in float32 or, with prefill_dtype=torch.bfloat16, with bf16
product operands. Over a mesh of distinct cards of this process the program
is one graph across the cards (every card's step, the NCCL collectives
between them, ban + typical on the first card); on the CPU it runs
eagerly.

On params sharded over a pod mesh whose rows span processes, every process
makes the same pool and the same calls (submit, step, run): each steps its
own shards, the row's shard-0 process draws every id and broadcasts it over
the row's group (inside the graph on NCCL), and every process returns the
same texts.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from functools import partial
from typing import Callable, Optional, Sequence

import torch

from rwkv_tpu_torch.models.rwkv4 import RWKVParams, WKVState, forward_seq, init_state
from rwkv_tpu_torch.ops.cuda.decode_stack import forward_step_fused
from rwkv_tpu_torch.ops.sampling import typical
from rwkv_tpu_torch.parallel.sharding import ShardedState
from rwkv_tpu_torch.runtime.graphs import Graphs, graphable
from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer, StreamDecoder
from rwkv_tpu_torch.utils.metrics import metrics
from rwkv_tpu_torch.utils.text import StopScanner


@dataclasses.dataclass
class Request:
    rid: int
    prompt_ids: list[int]
    max_tokens: int
    temp: float
    tau: float
    seed: int
    stop: Optional[Sequence[str]]
    on_text: Optional[Callable[[str], None]]
    ban_tokens: Sequence[int] = (0,)
    # runtime
    slot: int = -1
    produced: int = 0
    decoder: Optional[StreamDecoder] = None
    pieces: list = dataclasses.field(default_factory=list)
    done: bool = False
    text: str = ""
    # windowed stop-string detection, shared with engine.generate
    # (utils/text.py): O(len(piece)) per token, and the earliest match's
    # index for exact truncation
    scanner: Optional[StopScanner] = None
    # time.perf_counter() when the request joined the queue, and when its
    # admission began (queue wait = t_admit - t_submit)
    t_submit: float = 0.0
    t_admit: Optional[float] = None

    def saw_stop(self, piece: str) -> bool:
        return self.scanner.feed(piece) if self.scanner else False


class InferencePool:
    def __init__(
        self,
        params: RWKVParams,
        tokenizer: BPETokenizer,
        max_streams: int = 8,
        prefill_bucket: int = 128,
        step_fn: Optional[Callable] = None,
        prefill_dtype: torch.dtype = torch.float32,
        step_chunk: int = 1,
        prefill_fn: Optional[Callable] = None,
    ):
        """step_fn: the batched decode step (params, tokens [B], state) ->
        (logits [B, V], state); defaults to forward_step_fused (kernels K1
        and K2 on the card, K4 and K3 for 4-bit params). An engine's
        `_step_fn` carries its options (a8).

        prefill_fn: batched prompt ingest (params, tokens [T, W], state,
        length [W] or None) -> (logits [W, V], state); defaults to
        forward_seq(parallel=True).

        prefill_dtype: the operand type of the default prefill's products,
        torch.float32 or torch.bfloat16 (float32 sums); a prefill_fn carries
        its own (the engine's _prefill_impl is built with the engine's
        prefill_dtype).

        step_chunk: decode this many tokens for the whole batch before one
        host read of their ids. The token streams do not depend on it;
        admission and stop-string latency lag by up to step_chunk - 1 steps,
        and a finished slot keeps decoding (masked) until the chunk ends."""
        self.params = params
        self.cfg = params.config
        self.device = params.device
        self.tok = tokenizer
        self.B = max_streams
        self.prefill_bucket = prefill_bucket
        self._step_impl = step_fn or forward_step_fused
        self._prefill_fn = prefill_fn
        self.prefill_dtype = prefill_dtype
        # admission width buckets: prefill work scales with the padded lane
        # count, so a burst of n prompts is padded to the next power of two
        # up to B (at most twice the live lanes), never always to B
        self._widths = sorted({1 << i for i in range((self.B).bit_length())
                               if 1 << i <= self.B} | {self.B})

        self.step_chunk = max(1, int(step_chunk))
        self._mesh = getattr(params, "mesh", None)  # ShardedParams carry their mesh
        self._state = self._new_state(self.B)
        self._tokens = [0] * self.B
        self._active = [False] * self.B
        self._gens = [self._generator(i) for i in range(self.B)]
        mesh = self._mesh
        self._graphs = Graphs(generators=self._gens, mesh=mesh, enabled=graphable(mesh))
        self._temp = [1.0] * self.B
        self._tau = [0.8] * self.B
        # per-slot banned-token mask at the padded vocab width (set from each
        # request's ban_tokens at admission)
        self._ban = torch.zeros((self.B, self.cfg.vocab_size), dtype=torch.bool,
                                device=self.device)
        self._ban[:, 0] = True

        self._free = list(range(self.B))
        self._by_slot: dict[int, Request] = {}
        self._queue: list[Request] = []
        self._next_rid = 0
        # requests that completed during an admission burst that later
        # raised: their results survive the exception and are delivered by
        # the next step() (or fetched with take_finished_backlog)
        self._finished_backlog: list[Request] = []

    # -- device work ------------------------------------------------------------

    def _new_state(self, n: int):
        """A fresh state of n streams: resident per shard on sharded params."""
        if self._mesh is not None:
            return ShardedState.zeros(self.cfg, n, self._mesh)
        return init_state(self.cfg, (n,), device=self.device)

    def _generator(self, seed: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
        return g

    def _batched_step(self, tokens, state, temp, tau, active, ban):
        """Advance all B slots one token and sample each with its own
        generator and settings. Inactive slots still compute (the batch
        runs in lockstep: at memory-bound batch sizes a dead slot costs
        nothing) but their state update is masked out."""
        logits, new_state = self._step_impl(self.params, tokens, state)  # [B, V]
        logits = torch.where(ban, torch.full_like(logits, -1e9), logits)
        nxt = self._broadcast(typical(logits, self._gens, temp=temp, tau=tau))
        if isinstance(state, ShardedState):
            state = new_state.where(active, state)
        else:
            act = active[None, :, None]  # over [L, B, E]
            state = WKVState(*(torch.where(act, n, o) for n, o in zip(new_state, state)))
        return torch.where(active, nxt, torch.zeros_like(nxt)), state

    def _batched_step_k(self, tokens, state, temp, tau, active, ban, *, k):
        """k batched steps in one device program; returns (ids [k, B],
        tokens, state), the last ids and the state written into `tokens` and
        `state` in place (the carry the next program starts from)."""
        hist, tok, st = [], tokens, state
        for _ in range(k):
            tok, st = self._batched_step(tok, st, temp, tau, active, ban)
            hist.append(tok)
        tokens.copy_(tok)
        for s, n in zip(state, st):
            s.copy_(n)
        return torch.stack(hist), tokens, state

    def _admit_sample(self, logits, gens, temp, tau, ban):
        """First tokens of a whole admission burst in one sampling call:
        logits [n, V], one generator and ban row per request."""
        logits = torch.where(ban, torch.full_like(logits, -1e9), logits)
        return self._broadcast(typical(logits, gens, temp=temp, tau=tau))

    def _broadcast(self, ids):
        """On a row across processes, the row's shard-0 process's draw in
        every process (the same tokens fed everywhere); else ids."""
        return ids if self._mesh is None else self._mesh.group_broadcast(ids)

    def _prefill(self, params, tokens, length, slot_state):
        """Prompt ingest (parallel WKV scan): tokens [T, W] with [W] ragged
        per-stream lengths, or None when every lane is full."""
        if self._prefill_fn is not None:
            return self._prefill_fn(params, tokens, slot_state, length)
        return forward_seq(params, tokens, slot_state, parallel=True, length=length,
                           compute_dtype=self.prefill_dtype)

    # -- public API ---------------------------------------------------------------

    def submit(
        self,
        prompt: str,
        max_tokens: int = 128,
        *,
        temp: float = 0.9,
        tau: float = 0.8,
        seed: Optional[int] = None,
        stop: Optional[Sequence[str]] = None,
        on_text: Optional[Callable[[str], None]] = None,
        ban_tokens: Sequence[int] = (0,),
    ) -> int:
        rid = self._next_rid
        self._next_rid += 1
        with metrics.timed("pool.submit.encode"):
            ids = self.tok.encode(prompt) or [0]
        metrics.inc("pool.submit.tokens", len(ids))
        req = Request(
            rid=rid,
            prompt_ids=ids,
            max_tokens=max_tokens,
            temp=temp,
            tau=tau,
            seed=seed if seed is not None else rid,
            stop=stop,
            on_text=on_text,
            ban_tokens=tuple(ban_tokens),
        )
        req.scanner = StopScanner(stop) if stop else None
        req.t_submit = time.perf_counter()
        self._queue.append(req)
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._by_slot)

    def cancel_queued(self, rid: int) -> bool:
        """Remove a not-yet-admitted request from the queue. Returns False
        when it was already admitted (it will finish, and the caller
        discards it)."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                return True
        return False

    def abort_all(self) -> None:
        """Drop every queued and in-flight request and free their slots (a
        server's recovery after a failed step)."""
        self._queue.clear()
        for slot in list(self._by_slot):
            self._active[slot] = False
            del self._by_slot[slot]
            self._free.append(slot)

    def _admit(self):
        """Admit every queued request a free slot can take, prefilling all of
        them in one ragged [T, W] batch per prompt chunk."""
        n = min(len(self._queue), len(self._free))
        if n == 0:
            return []
        with metrics.timed("pool.admit"):
            reqs = [self._queue.pop(0) for _ in range(n)]
            slots = [self._free.pop(0) for _ in range(n)]
            try:
                return self._admit_batch(reqs, slots)
            except BaseException:
                # A failed admission must not leak capacity, and some of the burst
                # may already be finished (a first-token completion freed its
                # slot) or registered. Done requests keep their result (in the
                # backlog); the others are de-registered, their slot freed once,
                # and requeued with their runtime state reset (a retry prefills
                # from scratch; a piece already streamed through on_text may
                # repeat).
                requeue = []
                for req, slot in zip(reqs, slots):
                    if req.done:
                        self._finished_backlog.append(req)
                        continue
                    if self._by_slot.get(slot) is req:
                        del self._by_slot[slot]
                    self._active[slot] = False
                    if slot not in self._free:
                        self._free.append(slot)
                    req.slot = -1
                    req.produced = 0
                    req.decoder = None
                    req.pieces = []
                    req.scanner = StopScanner(req.stop) if req.stop else None
                    requeue.append(req)
                self._queue[:0] = requeue
                raise

    def _admit_batch(self, reqs, slots):
        """Returns the requests that finished on their first (admission) token."""
        done_at_admit: list[Request] = []
        n = len(reqs)
        t_admit = time.perf_counter()
        metrics.inc("pool.admit.requests", n)
        for req, slot in zip(reqs, slots):
            req.t_admit = t_admit
            req.slot = slot
            req.decoder = StreamDecoder(self.tok)

        ids = [req.prompt_ids for req in reqs]
        K = self.prefill_bucket
        maxlen = max(len(i) for i in ids)
        # the burst's width bucket: zero-length lanes are exact no-ops
        W = next(w for w in self._widths if w >= n)
        batch_state = self._new_state(W)
        chunk_lg: list = [None] * n   # the last logits of each stream
        for c0 in range(0, maxlen, K):
            with metrics.timed("pool.admit.pack"):
                chunk = torch.zeros((K, W), dtype=torch.int64)
                lens = torch.zeros((W,), dtype=torch.int64)
                for b, seq in enumerate(ids):
                    part = seq[c0:c0 + K]
                    chunk[: len(part), b] = torch.tensor(part, dtype=torch.int64)
                    lens[b] = len(part)
                # full chunk: when every real lane holds K valid tokens, run
                # the unmasked prefill (length None); the width-pad lanes
                # (b >= n) then compute values that are never scattered
                full = all(len(seq) >= c0 + K for seq in ids)
                # a copy from pageable host memory waits for the stream
                chunk_d = chunk.to(self.device)
                lens_d = None if full else lens.to(self.device)
            metrics.inc("pool.prefill.tokens", int(lens.sum()))
            metrics.inc("pool.prefill.lane_tokens", K * W)
            metrics.inc("pool.prefill.chunks")
            with metrics.timed("pool.admit.prefill"):
                lg, batch_state = self._prefill(self.params, chunk_d, lens_d, batch_state)
            # only the last chunk with valid tokens holds a stream's logits
            for b in range(n):
                if lens[b] > 0:
                    chunk_lg[b] = lg[b]

        with metrics.timed("pool.admit.sample"):
            # scatter the prefilled states into the pool's slots
            slot_idx = torch.tensor(slots, dtype=torch.int64, device=self.device)
            if isinstance(self._state, ShardedState):
                self._state.put(slots, batch_state.take(range(n)))
            else:
                for pool, s in zip(self._state, batch_state):
                    pool.index_copy_(1, slot_idx, s[:, :n])

            # the first tokens of the whole burst in one sampling call
            V = self.cfg.vocab_size
            rows = torch.zeros((n, V), dtype=torch.bool)
            for b, req in enumerate(reqs):
                rows[b, list(req.ban_tokens)] = True
            rows = rows.to(self.device)
            gens = [self._gens[slot] for slot in slots]
            for g, req in zip(gens, reqs):
                g.manual_seed(int(req.seed) & 0xFFFFFFFFFFFFFFFF)
            temps = torch.tensor([req.temp for req in reqs], dtype=torch.float64)
            taus = torch.tensor([req.tau for req in reqs], dtype=torch.float32)
            firsts = self._admit_sample(torch.stack(chunk_lg), gens, temps, taus, rows)
            self._ban[slot_idx] = rows
        with metrics.timed("pool.admit.read"):
            firsts = firsts.tolist()  # the burst's one host read

        with metrics.timed("pool.admit.emit"):
            for b, (req, slot) in enumerate(zip(reqs, slots)):
                first = int(firsts[b])
                self._tokens[slot] = first
                self._temp[slot] = req.temp
                self._tau[slot] = req.tau
                self._active[slot] = True
                self._by_slot[slot] = req
                piece = self._emit(req, first)
                # the first token can already satisfy the request
                # (max_tokens=1, or a stop string inside its piece)
                if (piece and req.saw_stop(piece)) or req.produced >= req.max_tokens:
                    done_at_admit.append(self._finish(req))
        return done_at_admit

    def _on_text(self, req: Request, piece: str) -> None:
        """Deliver a text piece to the request's callback, isolating the pool
        from callback failures: a streaming client whose socket died must not
        take down the shared batch (the callback is muted after its first
        exception; decoding goes on and the text is still assembled)."""
        if req.on_text is None:
            return
        try:
            req.on_text(piece)
        except Exception as e:  # noqa: BLE001 -- a user callback, any error
            metrics.inc("pool.on_text_errors")
            print(f"[pool] on_text failed for rid={req.rid}: {e!r}; muting callback",
                  file=sys.stderr)
            req.on_text = None

    def _emit(self, req: Request, token: int) -> str:
        req.produced += 1
        metrics.inc("pool.tokens_decoded")  # tokens a request absorbed
        piece = req.decoder.feed([token])
        if piece:
            req.pieces.append(piece)
            self._on_text(req, piece)
        return piece

    def _finish(self, req: Request) -> Request:
        tail = req.decoder.flush() if req.decoder else ""
        if tail:
            req.pieces.append(tail)
            self._on_text(req, tail)
            if req.scanner:
                req.scanner.feed(tail)  # a stop may complete in the tail
        text = "".join(req.pieces)
        if req.scanner and req.scanner.cut is not None:
            text = text[: req.scanner.cut]
        req.text = text
        req.done = True
        metrics.inc("pool.requests_completed")
        slot = req.slot
        self._active[slot] = False
        del self._by_slot[slot]
        self._free.append(slot)
        return req

    def take_finished_backlog(self) -> list[Request]:
        """Completed requests stranded by an admission exception (see _admit)."""
        out, self._finished_backlog = self._finished_backlog, []
        return out

    def step(self) -> list[Request]:
        """Admit queued requests, advance the batch step_chunk tokens with one
        host read of the ids; returns the requests that completed."""
        finished_admit = self.take_finished_backlog() + self._admit()
        if not self._by_slot:
            return finished_admit

        dev = self.device
        k = self.step_chunk
        with metrics.timed("pool.decode.prep"):
            args = (torch.tensor(self._tokens, dtype=torch.int64, device=dev),
                    self._state,
                    torch.tensor(self._temp, dtype=torch.float64, device=dev),
                    torch.tensor(self._tau, dtype=torch.float32, device=dev),
                    torch.tensor(self._active, dtype=torch.bool, device=dev),
                    self._ban)
        with metrics.timed("pool.decode.replay"):
            hist_d, _, self._state = self._graphs((k,), partial(self._batched_step_k, k=k),
                                                  *args)
        with metrics.timed("pool.decode.read"):
            hist = hist_d.tolist()  # [k, B]: the one host read of the chunk
        metrics.inc("pool.steps")

        finished = list(finished_admit)
        with metrics.timed("pool.decode.emit"):
            for slot, req in list(self._by_slot.items()):
                for row in hist:
                    token = int(row[slot])
                    self._tokens[slot] = token
                    piece = self._emit(req, token)
                    # windowed stop scan: O(len(piece)), not O(total text)
                    hit_stop = req.saw_stop(piece) if piece else False
                    if req.produced >= req.max_tokens or hit_stop:
                        finished.append(self._finish(req))
                        break
        return finished

    def run(self) -> dict[int, str]:
        """Drain everything; returns {rid: completion text}."""
        out = {}
        while self.pending:
            for req in self.step():
                out[req.rid] = req.text
        return out

"""The inference engine (counterpart of rwkv_tpu/runtime/engine.py).

    RWKV("model.bin", vocab_dir=None)   load a reference-format .bin (device "cuda")
    RWKV("model.q4.safetensors")        a packed 4-bit artifact (io/q4fmt.py)
    RWKV("model.pth", quant="q4")       a dense .pth/.safetensors, quantized at load
    load_context(prompt)                tokenize + bucketed prefill
    generate(prompt, max_tokens, ...)   typical sampling, `chunk` tokens a device program
    save_state(path) / load_state(path) a stream's continuation point as .npz

Decode runs the engine's step, `_step_fn`: `forward_step_fused`, on CUDA the
hand-written kernels K1 (decode stack) and K2 (int8 head), or K4 and K3 for
4-bit weights; after `load_params(params, a8=True)` the W8A8 step on K5, as
the JAX engine's a8 option. On the CPU their plain PyTorch versions.
Prompt ingest runs `forward_seq(parallel=True)` in plain PyTorch, padded to
a few fixed buckets with a length mask; prefill_dtype=torch.bfloat16 gives
its products bf16 operands (float32 sums), as the JAX engine's option. State
stays on the device between calls; during generation only the sampled token
ids reach the host.

Decode and sampling are one device program, as the JAX engine's
`_make_jits` makes them one jit: `_decode` is the step, the ban mask and
`typical`; `_decode_k` is k of them (JAX: one lax.scan). On CUDA each k is
captured once per (params, batch shape, k) as a CUDA graph and replayed
(runtime/graphs.py): at most `chunk` graphs a batch shape, one for each
tail length, as JAX compiles once per static k; the first token after a
prompt (`_sample`, JAX: _jit_sample) is one more. The engine's one
torch.Generator is registered with them and reseeded per generate call.
On the CPU, and on a mesh over distinct GPUs, the same functions run
eagerly.

    RWKV("model.bin", sharding=make_mesh(model=tp))   tensor-parallel serving

With a mesh (parallel/mesh.py) the params are cut over it
(parallel/sharding.py) and decode and prefill run the tensor-parallel step of
parallel/tp_step.py (tp_body: "fused", kernel K7, the whole step of a data
row's shards from one host call; "halves", kernel K6 per shard and layer
with the head on K2; "plain"; None picks "fused" on a mesh whose data rows
each lie on one CUDA device, else "halves"). 4-bit weights run under a mesh
through "fused" only, as in the JAX engine: a q4 artifact or params as they
are (their row-parallel pack block must divide E / tp and F / tp), or a
dense checkpoint quantized with q4_pack_block(E, tp). The state stays one
set of whole tensors on the mesh's first device, cut for each call. W8A8
(a8) has no sharded step, as in the JAX engine.

The engine runs on "cuda" unless the caller passes device="cpu" (or a mesh
of CPU devices); it never falls back to the CPU on its own.
"""

from __future__ import annotations

import enum
import numbers
import sys
from functools import partial
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import (
    RWKVParams,
    WKVState,
    forward_seq,
    a8_block_for,
    init_state,
    pad_vocab,
    params_to,
    q4_pack_block,
    signedize_params,
)
from rwkv_tpu_torch.ops.cuda.decode_stack import forward_step_fused
from rwkv_tpu_torch.ops.quant import Quant4Linear, QuantLinear
from rwkv_tpu_torch.ops.sampling import typical
from rwkv_tpu_torch.parallel.mesh import canonical
from rwkv_tpu_torch.parallel.sharding import (
    ShardedParams,
    make_put,
    shard_params,
    tp_vocab_multiple,
)
from rwkv_tpu_torch.parallel.tp_step import make_engine_prefill, make_engine_step
from rwkv_tpu_torch.runtime.graphs import Graphs, one_cuda_device
from rwkv_tpu_torch.tokenizer import native as native_tok
from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer, StreamDecoder
from rwkv_tpu_torch.utils.metrics import metrics
from rwkv_tpu_torch.utils.text import StopScanner


class Mode(enum.Enum):
    GPT = "gpt"            # sequential ingest of a token sequence, one stream
    PARALLEL = "parallel"  # advance B independent streams one token each

    # reference spelling
    PARRALEL = "parallel"


def resolve_device(device=None) -> torch.device:
    """"cuda" unless told otherwise; raises if CUDA was asked for and is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rwkv_tpu_torch runs on CUDA by default and this host has no CUDA "
            "device; pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def _jax_engine_vocab(params) -> int:
    """The logits width the JAX engine holds after load_params(params) on its
    accelerator, unsharded: it pads the vocab to a multiple of 512 only where
    its fused decode step runs (quantized families, E and F multiples of 256)
    and the head is not a multiple of 128 wide; otherwise it keeps the width
    it was given (rwkv_tpu/runtime/engine.py, load_params)."""
    V, E = params.head.out_features, params.n_embd
    if E % 256 == 0 and V % 128:
        return -(-V // 512) * 512
    return V


class RWKV:
    """Stateful engine over the functional model core."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        vocab_dir: Optional[str] = None,
        *,
        device=None,
        max_streams: int = 1,
        prefill_buckets: Sequence[int] = (32, 128, 512),
        quant: str = "q8",
        sharding=None,
        tp_body: Optional[str] = None,
        prefill_dtype: torch.dtype = torch.float32,
    ):
        """sharding: a parallel.mesh.Mesh or a parallel.sharding.ShardingContext
        for tensor-parallel serving, or None. tp_body: the sharded step's body,
        "fused", "halves" or "plain" (parallel/tp_step.py; None picks it).
        prefill_dtype: the operand type of prompt ingest's products,
        torch.float32 or torch.bfloat16 (bf16 operands, float32 sums, as the
        JAX engine's prefill_dtype); decode is not affected."""
        if prefill_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"prefill_dtype must be torch.float32 or torch.bfloat16, "
                             f"got {prefill_dtype}")
        self.prefill_dtype = prefill_dtype
        self._mesh = getattr(sharding, "mesh", sharding)
        if self._mesh is not None:
            first = self._mesh.first_device
            if device is not None and canonical(device) != first:
                raise ValueError(f"device {device} is not the mesh's first device {first}")
            device = first
        self._tp_body = tp_body
        self.device = resolve_device(device)
        # the one generator every generate call draws from, reseeded per call
        # (its registration with the decode graphs then stays valid)
        self._gen = torch.Generator(device=self.device)
        self._graphs: Optional[Graphs] = None  # the decode programs, per params
        if quant not in ("q8", "q4"):
            raise ValueError(f"quant must be 'q8' or 'q4', got {quant!r}")
        self.quant = quant
        self.params: Optional[RWKVParams] = None
        self.config: Optional[RWKVConfig] = None
        self.tokenizer = None  # BPETokenizer or NativeBPETokenizer
        self.max_streams = max_streams
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self._state: Optional[WKVState] = None  # leaves [L, max_streams, E]
        self._last_logits: dict[int, torch.Tensor] = {}  # stream -> logits [Vp]
        self._pending: dict[int, int] = {}  # emitted-but-not-absorbed token
        # the decode step (params, tokens, state) -> (logits, state); the pool
        # takes it as its step_fn
        self._step_fn: Callable = forward_step_fused
        # prompt ingest (params, tokens, state, length); None: forward_seq
        self._prefill_impl: Optional[Callable] = None
        if model_path:
            self.load_file(model_path, max_streams)
        if vocab_dir:
            self.load_tokenizer(vocab_dir)

    # -- loading -------------------------------------------------------------

    def load_file(self, path: str, max_streams: Optional[int] = None) -> None:
        """Load a checkpoint:

        * a packed q4 artifact (.safetensors tagged rwkv-tpu-q4/1) as it is,
          switching the engine to quant="q4";
        * a dense .safetensors (BlinkDL or HF names) or .pth, quantized on the
          host layer by layer to `quant` (io/convert.py);
        * a reference-format .bin (q8 only), streaming one tensor at a time
          to the device, re-centered to int8 on the host copy."""
        from rwkv_tpu_torch.io.binfmt import read_bin

        if max_streams is not None:
            self.max_streams = max_streams
        if path.endswith(".safetensors"):
            from rwkv_tpu_torch.io.q4fmt import is_q4_file, load_q4

            if is_q4_file(path):
                self.quant = "q4"
                self.load_params(load_q4(path))
                return
        if path.endswith((".safetensors", ".pth")):
            from rwkv_tpu_torch.io.convert import checkpoint_dims, load_checkpoint_quantized

            q4_tile = None
            if self.quant == "q4" and self._mesh is not None:
                # each shard must hold whole pack blocks of the row-parallel
                # families; the JAX engine picks the block with its TP
                # kernel's VMEM tile model (pick_tp_fused_tile), which the
                # port does not have: the widest q4_pack_block candidate that
                # divides E / tp and F / tp
                q4_tile = q4_pack_block(checkpoint_dims(path)[1], self._mesh.shape["model"])
            self.load_params(load_checkpoint_quantized(
                path, bits=4 if self.quant == "q4" else 8, q4_tile=q4_tile))
            return
        if self.quant == "q4":
            raise ValueError(
                "quant='q4' needs a dense source (.pth/.safetensors); "
                f"{path} is a Q8-quantized .bin — requantizing 4-bit on "
                "top of Q8 would stack quantization noise")
        if not path.endswith(".bin"):
            raise ValueError(f"{path}: this engine loads .bin, .safetensors and .pth files")
        if self._mesh is not None:
            # each shard's Vp / tp a multiple of 128; every tensor cut into its
            # shards as it is read
            self.load_params(shard_params(read_bin(
                path, self.device, put=make_put(self._mesh),
                pad_vocab_to=tp_vocab_multiple(self._mesh.shape["model"]), signed=True),
                self._mesh))
            return
        # 512, not 128: 50277 -> 50688, a multiple of the kernels' 16-column loads
        self.load_params(read_bin(path, self.device, pad_vocab_to=512, signed=True))

    loadFile = load_file

    def load_params(self, params, a8: bool = False) -> None:
        """Use an already-built params tree (numpy or torch leaves; u8 or int8
        QuantLinear, or packed Quant4Linear families): padded to a head width
        the kernels take, re-centered to int8, and placed on the engine's
        device. It may be the engine's own params (re-centering is a no-op).

        With a mesh: padded so that each shard's vocab is a multiple of 128,
        re-centered, cut over the mesh (or taken as they are if already a
        ShardedParams), and decode and prefill switch to the tensor-parallel
        step and prefill; 4-bit params decode through the "fused" body.

        a8: decode W8A8 (kernel K5 on CUDA): every matvec's input quantized
        to int8 per batch row, and per block of a8_block_for(E) channels for
        att.output and ffn.value, the block the JAX engine's fused a8 step
        uses; adds activation-quantization noise. q8 weights only, and no
        mesh."""
        if self._mesh is not None:
            self._load_sharded(params, a8)
            return
        if not isinstance(params.head, (QuantLinear, Quant4Linear)):
            raise TypeError("the engine needs quantized (QuantLinear or Quant4Linear) params")
        if a8 and isinstance(params.att.key, Quant4Linear):
            raise ValueError("a8 and 4-bit weights are mutually exclusive")
        params = params_to(params, self.device)
        self._session_vocab = _jax_engine_vocab(params)
        if params.head.out_features % 16:
            params = pad_vocab(params, multiple=512)
        params = signedize_params(params)
        self.quant = "q4" if isinstance(params.att.key, Quant4Linear) else "q8"
        self._step_fn = (partial(forward_step_fused, a8=True,
                                 a8_block=a8_block_for(params.n_embd))
                         if a8 else forward_step_fused)
        self._prefill_impl = None
        self._loaded(params)

    def _load_sharded(self, params, a8: bool) -> None:
        """load_params with a mesh (the JAX engine's sharded branch)."""
        if a8:
            raise ValueError("a8 has no tensor-parallel step (nor has the JAX engine): "
                             "load without a mesh for W8A8")
        mesh = self._mesh
        if not isinstance(params, ShardedParams):
            if not isinstance(params.head, (QuantLinear, Quant4Linear)):
                raise TypeError("the sharded engine needs quantized (QuantLinear or "
                                "Quant4Linear) params")
            params = params_to(params, self.device)
            multiple = tp_vocab_multiple(mesh.shape["model"])
            if params.head.out_features % (128 * mesh.shape["model"]):
                params = pad_vocab(params, multiple=multiple)
            params = shard_params(signedize_params(params), mesh)
        self._step_fn = make_engine_step(mesh, params, body=self._tp_body)
        self._prefill_impl = make_engine_prefill(mesh, params, compute_dtype=self.prefill_dtype)
        # the JAX engine pads a sharded load to the same multiple
        self._session_vocab = params.config.vocab_size
        shard = params.rows[0][0]
        self.quant = "q4" if isinstance(shard.att.key, Quant4Linear) else "q8"
        self._loaded(params)

    def _loaded(self, params) -> None:
        self.params = params
        self.config = params.config
        self._graphs = Graphs(generators=(self._gen,), mesh=self._mesh,
                              enabled=one_cuda_device(self._mesh))
        # True (unpadded) vocab: padded ids carry a -1e9 logit_bias; forward()
        # returns logits sliced back to this size
        if params.logit_bias is not None:
            self._true_vocab = int((params.logit_bias == 0.0).sum())
        else:
            self._true_vocab = self.config.vocab_size
        self.reset_state()

    def load_tokenizer(self, vocab_dir: Optional[str] = None,
                       native: Optional[bool] = None) -> None:
        """The BPE tokenizer; vocab_dir=None uses the bundled 50,277-entry
        vocab. native=None prefers the C++ tokenizer (tokenizer/native.py,
        built at first use) and takes the Python one if it cannot be built or
        loaded; False takes the Python one; True the C++ one, raising if it
        cannot be built or loaded. Both give the same ids and bytes."""
        if native is False:
            self.tokenizer = BPETokenizer.load(vocab_dir)
        elif native is None:
            self.tokenizer = native_tok.load_best(vocab_dir)
        else:
            self.tokenizer = native_tok.NativeBPETokenizer.load(vocab_dir)

    loadTokenizer = load_tokenizer

    # -- state management ------------------------------------------------------

    def _require_loaded(self):
        if self.params is None:
            raise RuntimeError("RWKV not loaded (call load_file/load_params)")

    def _check_stream(self, stream: int):
        self._require_loaded()
        if not 0 <= stream < self.max_streams:
            raise IndexError(f"stream {stream} out of range (max_streams={self.max_streams})")

    def reset_state(self, stream: Optional[int] = None) -> None:
        self._require_loaded()
        if stream is None or self._state is None:
            self._state = init_state(self.config, (self.max_streams,), device=self.device)
            self._last_logits = {}
            self._pending = {}
        else:
            self.set_state(self.empty_state(), stream)

    def empty_state(self) -> WKVState:
        """A fresh single-stream state (leaves [L, E])."""
        self._require_loaded()
        return init_state(self.config, device=self.device)

    emptyState = empty_state

    def get_state(self, stream: int = 0) -> WKVState:
        """A contiguous copy of one stream's state: later steps never change it."""
        self._check_stream(stream)
        return WKVState(*(s[:, stream].clone(memory_format=torch.contiguous_format)
                          for s in self._state))

    def set_state(self, state: WKVState, stream: int = 0) -> None:
        self._check_stream(stream)
        for pool, s in zip(self._state, state):
            pool[:, stream] = s
        self._last_logits.pop(stream, None)
        self._pending.pop(stream, None)

    def snapshot(self, stream: int = 0) -> dict:
        """Full continuation point: state + decode bookkeeping."""
        self._check_stream(stream)
        return {"state": self.get_state(stream),
                "logits": self._last_logits.get(stream),
                "pending": self._pending.get(stream)}

    def restore(self, snap: dict, stream: int = 0) -> None:
        self.set_state(snap["state"], stream)
        if snap.get("logits") is not None:
            self._last_logits[stream] = snap["logits"]
        if snap.get("pending") is not None:
            self._pending[stream] = snap["pending"]

    def save_state(self, path: str, stream: int = 0) -> None:
        """Persist a stream's continuation point (snapshot) as a compressed
        .npz with the JAX engine's keys (state_xy .. state_dd, logits,
        pending), so that either package resumes a session the other saved.
        The logits are written at the width the JAX engine holds for the same
        source (its generate masks them at that width): a .bin's 512-padded
        vocab, a sharded load's tensor-parallel multiple, and for load_params
        the rule of _jax_engine_vocab; padded columns carry the -1e9 bias."""
        snap = self.snapshot(stream)
        arrays = {f"state_{k}": v.cpu().numpy() for k, v in zip(WKVState._fields, snap["state"])}
        if snap.get("logits") is not None:
            logits = snap["logits"][: self._session_vocab].cpu()
            pad = self._session_vocab - logits.shape[0]
            arrays["logits"] = torch.nn.functional.pad(logits, (0, pad), value=-1e9).numpy()
        if snap.get("pending") is not None:
            arrays["pending"] = np.asarray(snap["pending"], np.int64)
        np.savez_compressed(path, **arrays)

    def load_state(self, path: str, stream: int = 0) -> None:
        """Resume a stream from a save_state file of either package; saved
        logits of another width are cut to the true vocab and padded with
        the padded columns' -1e9 bias."""
        with np.load(path) as z:
            state = WKVState(*(torch.from_numpy(z[f"state_{k}"]).to(self.device)
                               for k in WKVState._fields))
            logits = None
            if "logits" in z:
                saved = torch.from_numpy(z["logits"][: self._true_vocab])
                logits = torch.full((self.config.vocab_size,), -1e9, dtype=torch.float32)
                logits[: saved.shape[0]] = saved
                logits = logits.to(self.device)
            snap = {"state": state, "logits": logits,
                    "pending": int(z["pending"]) if "pending" in z else None}
        self.restore(snap, stream)

    # -- forward ----------------------------------------------------------------

    def forward(self, tokens: int | Sequence[int], mode: Mode = Mode.GPT,
                stream: int = 0) -> torch.Tensor:
        """Advance state and return logits (on the engine's device).

        GPT mode: `tokens` is ingested in order into `stream`; returns the
        final position's logits [V]. PARALLEL mode: one token per stream;
        every stream advances one step; returns [B, V]."""
        self._require_loaded()
        if mode is Mode.PARALLEL:
            toks = torch.as_tensor(list(tokens), dtype=torch.int64, device=self.device)
            if toks.shape != (self.max_streams,):
                raise ValueError(f"PARALLEL mode needs one token per stream "
                                 f"({self.max_streams}), got shape {tuple(toks.shape)}")
            logits, self._state = self._step_fn(self.params, toks, self._state)
            for i in range(self.max_streams):
                self._last_logits[i] = logits[i]
                self._pending.pop(i, None)
            return logits[..., : self._true_vocab]

        if isinstance(tokens, numbers.Integral):
            tokens = [tokens]
        tokens = [int(t) for t in tokens]
        self._check_stream(stream)
        pending = self._pending.pop(stream, None)
        if pending is not None:
            tokens = [pending] + tokens
        if not tokens:
            raise ValueError("forward() needs at least one token")
        state = self.get_state(stream)
        logits = None
        K = self.prefill_buckets[-1]
        for start in range(0, len(tokens), K):
            chunk = tokens[start:start + K]
            if len(chunk) == 1:
                tok = torch.tensor(chunk[0], dtype=torch.int64, device=self.device)
                logits, state = self._step_fn(self.params, tok, state)
                continue
            bucket = next(b for b in self.prefill_buckets if b >= len(chunk))
            padded = torch.zeros(bucket, dtype=torch.int64)
            padded[: len(chunk)] = torch.tensor(chunk)
            # an exactly bucket-sized chunk needs no mask
            length = None if len(chunk) == bucket else len(chunk)
            if self._prefill_impl is not None:
                logits, state = self._prefill_impl(self.params, padded.to(self.device), state,
                                                   length)
            else:
                logits, state = forward_seq(self.params, padded.to(self.device), state,
                                            parallel=True, length=length,
                                            compute_dtype=self.prefill_dtype)
        self.set_state(state, stream)
        self._last_logits[stream] = logits
        return logits[..., : self._true_vocab]

    def load_context(self, text: str, progress: bool | Callable[[float], None] = False,
                     stream: int = 0) -> int:
        """Tokenize + ingest a prompt; returns the last token id (-1 if empty).

        progress: a callable receives the ingested fraction after each
        prefill chunk; True prints it to stderr."""
        if self.tokenizer is None:
            raise RuntimeError("tokenizer not loaded")
        ids = self.tokenizer.encode(text)
        if not ids:
            return -1
        cb = progress if callable(progress) else None
        if cb is None and progress:
            def cb(frac: float) -> None:
                end = "\n" if frac >= 1.0 else ""
                print(f"\rloading context: {frac:6.1%}", end=end, file=sys.stderr, flush=True)
        if cb is None:
            self.forward(ids, Mode.GPT, stream=stream)
        else:
            K = self.prefill_buckets[-1]
            for i in range(0, len(ids), K):
                self.forward(ids[i:i + K], Mode.GPT, stream=stream)
                cb(min(i + K, len(ids)) / len(ids))
        return ids[-1]

    loadContext = load_context

    # -- generation ----------------------------------------------------------------

    def _sample(self, logits, temp, tau, ban):
        """The ban mask, then typical from the engine's generator (JAX:
        _sample, the first token after a prompt)."""
        logits = torch.where(ban, torch.full_like(logits, -1e9), logits)
        return typical(logits, self._gen, temp=temp, tau=tau)

    def _decode(self, token, state, temp, tau, ban):
        """One decode step as the device program runs it (JAX: decode): the
        engine's step, the ban mask and typical. Returns (next id, state)."""
        logits, state = self._step_fn(self.params, token, state)
        return self._sample(logits, temp, tau, ban), state

    def _decode_k(self, token, state, temp, tau, ban, *, k):
        """k decode steps in one device program (JAX: decode_k, one lax.scan
        of decode): returns (ids [k, ...], token, state, temp, tau, ban),
        the last id and the state written into `token` and `state` in place:
        the inputs are the carry the next program starts from (a graph's
        own buffers are not copied again)."""
        ids, tok, st = [], token, state
        for _ in range(k):
            tok, st = self._decode(tok, st, temp, tau, ban)
            ids.append(tok)
        token.copy_(tok)
        for s, n in zip(state, st):
            s.copy_(n)
        return torch.stack(ids), token, state, temp, tau, ban

    def generate(
        self,
        prompt: str = "",
        max_tokens: int = 128,
        *,
        temp: float = 0.9,
        tau: float = 0.8,
        seed: int = 0,
        stream: int = 0,
        ban_tokens: Sequence[int] = (0,),
        stop: Optional[Sequence[str]] = None,
        on_text: Optional[Callable[[str], None]] = None,
        first_token: Optional[int] = None,
        chunk: int = 1,
    ) -> str:
        """Prompt-and-generate with typical sampling.

        first_token: when continuing from a restored state with no new
        prompt, the token that produced that state's last update.
        chunk: decode this many tokens as one device program (on CUDA one
        CUDA-graph replay) before one host read of their ids. The token
        stream does not depend on it (the same generator draws in the same
        order); on_text fires per chunk, and a stop string hit mid-chunk
        leaves the state up to chunk-1 tokens past it."""
        if self.tokenizer is None:
            raise RuntimeError("tokenizer not loaded")
        self._require_loaded()
        if max_tokens <= 0:
            if prompt:
                self.load_context(prompt, stream=stream)
            return ""

        self._gen.manual_seed(seed)
        # ban mask at the padded vocab width, like the internal logits; temp
        # and tau as tensors, so the device programs read them per replay
        # (temp in float64: typical then draws what the same float draws)
        ban = torch.zeros(self.config.vocab_size, dtype=torch.bool)
        ban[list(ban_tokens)] = True
        ban = ban.to(self.device)
        temp_t = torch.tensor(temp, dtype=torch.float64).to(self.device)
        tau_t = torch.tensor(tau, dtype=torch.float32).to(self.device)

        # logits for the first new token, without re-feeding the prompt's last
        if prompt:
            self.forward(self.tokenizer.encode(prompt), stream=stream)
        elif stream in self._last_logits and self._pending.get(stream) is None:
            pass
        else:
            seed_tok = self._pending.pop(stream, None)
            if seed_tok is None:
                seed_tok = first_token if first_token is not None else 0
            self.forward(int(seed_tok), stream=stream)
        logits = self._last_logits[stream]

        token = self._graphs(("sample", tuple(logits.shape)), self._sample,
                             logits, temp_t, tau_t, ban)
        state = self.get_state(stream)

        decoder = StreamDecoder(self.tokenizer)
        pieces: list[str] = []
        n_ids = 1  # token ids decoded (the first one just sampled)
        scanner = StopScanner(stop)

        def feed(piece: str) -> None:
            if not piece:
                return
            pieces.append(piece)
            if on_text:
                on_text(piece)
            scanner.feed(piece)

        feed(decoder.feed([int(token)]))
        remaining = max_tokens - 1
        while remaining > 0 and scanner.cut is None:
            # a tail shorter than chunk is one program of its own length
            k = min(chunk, remaining)
            ids, token, state, temp_t, tau_t, ban = self._graphs(
                (tuple(token.shape), k), partial(self._decode_k, k=k),
                token, state, temp_t, tau_t, ban)
            ids = ids.tolist()  # the one host read of the chunk
            remaining -= len(ids)
            n_ids += len(ids)
            for tid in ids:
                feed(decoder.feed([int(tid)]))

        if scanner.cut is not None:
            text = "".join(pieces)[:scanner.cut]
        else:
            text = "".join(pieces) + decoder.flush()
        self.set_state(state, stream)
        self._pending[stream] = int(token)  # emitted, not yet absorbed
        metrics.inc("engine.generate_calls")
        metrics.inc("engine.tokens_generated", n_ids)
        return text

"""The inference engine (counterpart of rwkv_tpu/runtime/engine.py).

    RWKV("model.bin", vocab_dir=None)   load a reference-format .bin (device "cuda")
    RWKV("model.q4.safetensors")        a packed 4-bit artifact (io/q4fmt.py)
    RWKV("model.pth", quant="q4")       a dense .pth/.safetensors, quantized at load
    load_context(prompt)                tokenize + bucketed prefill
    generate(prompt, max_tokens, ...)   typical sampling, one decode step per token

Decode runs `forward_step_fused`: on CUDA the hand-written kernels K1
(decode stack) and K2 (int8 head), or K4 and K3 for 4-bit weights; on the
CPU their plain PyTorch versions.
Prompt ingest runs `forward_seq(parallel=True)` in plain PyTorch, padded to
a few fixed buckets with a length mask. State stays on the device between
calls; during generation only the sampled token ids reach the host.

The engine runs on "cuda" unless the caller passes device="cpu"; it never
falls back to the CPU on its own.
"""

from __future__ import annotations

import enum
import numbers
import sys
from typing import Callable, Optional, Sequence

import torch

from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import (
    RWKVParams,
    WKVState,
    forward_seq,
    init_state,
    pad_vocab,
    params_to,
    signedize_params,
)
from rwkv_tpu_torch.ops.cuda.decode_stack import forward_step_fused
from rwkv_tpu_torch.ops.quant import Quant4Linear, QuantLinear
from rwkv_tpu_torch.ops.sampling import typical
from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer, StreamDecoder
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
    ):
        self.device = resolve_device(device)
        if quant not in ("q8", "q4"):
            raise ValueError(f"quant must be 'q8' or 'q4', got {quant!r}")
        self.quant = quant
        self.params: Optional[RWKVParams] = None
        self.config: Optional[RWKVConfig] = None
        self.tokenizer: Optional[BPETokenizer] = None
        self.max_streams = max_streams
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        self._state: Optional[WKVState] = None  # leaves [L, max_streams, E]
        self._last_logits: dict[int, torch.Tensor] = {}  # stream -> logits [Vp]
        self._pending: dict[int, int] = {}  # emitted-but-not-absorbed token
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
            from rwkv_tpu_torch.io.convert import load_checkpoint_quantized

            self.load_params(load_checkpoint_quantized(path, bits=4 if self.quant == "q4" else 8))
            return
        if self.quant == "q4":
            raise ValueError(
                "quant='q4' needs a dense source (.pth/.safetensors); "
                f"{path} is a Q8-quantized .bin — requantizing 4-bit on "
                "top of Q8 would stack quantization noise")
        if not path.endswith(".bin"):
            raise ValueError(f"{path}: this engine loads .bin, .safetensors and .pth files")
        # 512, not 128: 50277 -> 50688, a multiple of the kernels' 16-column loads
        self.load_params(read_bin(path, self.device, pad_vocab_to=512, signed=True))

    loadFile = load_file

    def load_params(self, params: RWKVParams) -> None:
        """Use an already-built params tree (numpy or torch leaves; u8 or int8
        QuantLinear, or packed Quant4Linear families): padded to a head width
        the kernels take, re-centered to int8, and placed on the engine's
        device."""
        if not isinstance(params.head, (QuantLinear, Quant4Linear)):
            raise TypeError("the engine needs quantized (QuantLinear or Quant4Linear) params")
        params = params_to(params, self.device)
        if params.head.out_features % 16:
            params = pad_vocab(params, multiple=512)
        params = signedize_params(params)
        self.params = params
        self.quant = "q4" if isinstance(params.att.key, Quant4Linear) else "q8"
        self.config = params.config
        # True (unpadded) vocab: padded ids carry a -1e9 logit_bias; forward()
        # returns logits sliced back to this size
        if params.logit_bias is not None:
            self._true_vocab = int((params.logit_bias == 0.0).sum())
        else:
            self._true_vocab = self.config.vocab_size
        self.reset_state()

    def load_tokenizer(self, vocab_dir: Optional[str] = None) -> None:
        """The BPE tokenizer; vocab_dir=None uses the bundled 50,277-entry vocab."""
        self.tokenizer = BPETokenizer.load(vocab_dir)

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
            logits, self._state = forward_step_fused(self.params, toks, self._state)
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
                logits, state = forward_step_fused(self.params, tok, state)
                continue
            bucket = next(b for b in self.prefill_buckets if b >= len(chunk))
            padded = torch.zeros(bucket, dtype=torch.int64)
            padded[: len(chunk)] = torch.tensor(chunk)
            # an exactly bucket-sized chunk needs no mask
            length = None if len(chunk) == bucket else len(chunk)
            logits, state = forward_seq(self.params, padded.to(self.device), state,
                                        parallel=True, length=length)
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

    @staticmethod
    def _sample(logits, gen, temp, tau, ban):
        logits = torch.where(ban, torch.full_like(logits, -1e9), logits)
        return typical(logits, gen, temp=temp, tau=tau)

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
        chunk: decode this many tokens before one host read of their ids.
        The token stream does not depend on it (the same generator draws in
        the same order); on_text fires per chunk, and a stop string hit
        mid-chunk leaves the state up to chunk-1 tokens past it."""
        if self.tokenizer is None:
            raise RuntimeError("tokenizer not loaded")
        self._require_loaded()
        if max_tokens <= 0:
            if prompt:
                self.load_context(prompt, stream=stream)
            return ""

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        # ban mask at the padded vocab width, like the internal logits
        ban = torch.zeros(self.config.vocab_size, dtype=torch.bool)
        ban[list(ban_tokens)] = True
        ban = ban.to(self.device)

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

        token = self._sample(logits, gen, temp, tau, ban)
        state = self.get_state(stream)

        decoder = StreamDecoder(self.tokenizer)
        pieces: list[str] = []
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
            toks = []
            for _ in range(min(chunk, remaining)):
                logits, state = forward_step_fused(self.params, token, state)
                token = self._sample(logits, gen, temp, tau, ban)
                toks.append(token)
            ids = torch.stack(toks).tolist()  # the one host read of the chunk
            remaining -= len(ids)
            for tid in ids:
                feed(decoder.feed([int(tid)]))

        if scanner.cut is not None:
            text = "".join(pieces)[:scanner.cut]
        else:
            text = "".join(pieces) + decoder.flush()
        self.set_state(state, stream)
        self._pending[stream] = int(token)  # emitted, not yet absorbed
        return text

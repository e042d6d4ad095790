"""State-as-embedding vector store (counterpart of rwkv_tpu/apps/vectordb.py):
the ffn token-shift state `dd` after reading a fact is its embedding, ranked
by L1, L2 or cosine distance.

    python -m rwkv_tpu_torch.apps.vectordb --model m.bin --batch-index --bf16-prefill
    python -m rwkv_tpu_torch.apps.vectordb --mock --device cpu --metric cosine

The RWKV recurrent state after reading a text is a fixed-size summary of it;
the last layer's dd vector serves as a free text embedding.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rwkv_tpu_torch.apps._common import add_model_args, build_engine


class StateVectorDB:
    def __init__(self, engine, metric: str = "l2", layers: str = "last"):
        self.eng = engine
        self.metric = metric
        self.layers = layers
        self.keys: list[str] = []
        self.vecs: list[np.ndarray] = []

    def _embed(self, text: str) -> np.ndarray:
        self.eng.reset_state(0)
        self.eng.load_context(text)
        state = self.eng.get_state(0)
        dd = state.dd.cpu().numpy()  # [L, E]
        v = dd[-1] if self.layers == "last" else dd.reshape(-1)
        return v.astype(np.float64)

    def add(self, text: str) -> None:
        self.keys.append(text)
        self.vecs.append(self._embed(text))

    def add_batch(self, texts: list[str], bucket: int = 128) -> None:
        """Index many texts in batched prefill sweeps (forward_seq over
        [bucket, B] with ragged per-stream lengths, at the engine's
        prefill_dtype): B documents cost ceil(maxlen/bucket) weight sweeps.

        Documents longer than `bucket` are NOT truncated: state threads
        through as many chunked sweeps as the longest document needs
        (streams that ran out of tokens are exact no-ops via the ragged
        length mask), so batch embeddings ingest the same full text as
        add()/_embed — not bit-identical to one-at-a-time indexing (the
        single path chunks through the engine's own buckets) but the same
        summary of the same tokens, ranking equivalently
        (tests/test_torch_apps.py)."""
        import torch

        from rwkv_tpu_torch.models.rwkv4 import forward_seq, init_state

        if not texts:
            return
        eng = self.eng
        ids = [eng.tokenizer.encode(t) or [0] for t in texts]
        B = len(texts)
        maxlen = max(len(i) for i in ids)
        state = init_state(eng.config, (B,), device=eng.device)
        for c0 in range(0, maxlen, bucket):
            T = min(bucket, maxlen - c0)
            toks = torch.zeros((T, B), dtype=torch.int64)
            lens = torch.zeros((B,), dtype=torch.int64)
            for b, seq in enumerate(ids):
                part = seq[c0:c0 + T]
                toks[: len(part), b] = torch.tensor(part, dtype=torch.int64)
                lens[b] = len(part)
            toks, lens = toks.to(eng.device), lens.to(eng.device)
            if eng._prefill_impl is not None:  # a sharded engine's TP prefill
                _, state = eng._prefill_impl(eng.params, toks, state, lens)
            else:
                _, state = forward_seq(eng.params, toks, state, parallel=True, length=lens,
                                       compute_dtype=eng.prefill_dtype)
        dd = state.dd.cpu().numpy()  # [L, B, E]
        for b, text in enumerate(texts):
            v = dd[-1, b] if self.layers == "last" else dd[:, b].reshape(-1)
            self.keys.append(text)
            self.vecs.append(v.astype(np.float64))

    def query(self, text: str, k: int = 3) -> list[tuple[str, float]]:
        if not self.vecs:
            return []
        q = self._embed(text)
        m = np.stack(self.vecs)
        if self.metric == "l1":
            d = np.abs(m - q).sum(axis=1)
        elif self.metric == "cosine":
            d = 1.0 - (m @ q) / (np.linalg.norm(m, axis=1) * np.linalg.norm(q) + 1e-9)
        else:  # l2
            d = np.linalg.norm(m - q, axis=1)
        order = np.argsort(d)[:k]
        return [(self.keys[i], float(d[i])) for i in order]


FACTS = [
    "The capital of France is Paris.",
    "Water boils at 100 degrees Celsius at sea level.",
    "The Great Wall of China is visible from low Earth orbit.",
    "Python is a popular programming language.",
    "The mitochondria is the powerhouse of the cell.",
]


def main(argv=None):
    p = argparse.ArgumentParser(description="RWKV state-embedding vector DB")
    add_model_args(p)
    p.add_argument("--metric", choices=["l1", "l2", "cosine"], default="l2")
    p.add_argument("--query", default="Which city is the capital of France?")
    p.add_argument("--top-k", type=int, default=3)
    p.add_argument("--batch-index", action="store_true",
                   help="index all facts in one batched prefill")
    args = p.parse_args(argv)

    eng = build_engine(args)
    db = StateVectorDB(eng, metric=args.metric)
    if args.batch_index:
        print(f"batch-indexing {len(FACTS)} facts", file=sys.stderr)
        db.add_batch(FACTS)
    else:
        for fact in FACTS:
            print(f"indexing: {fact}", file=sys.stderr)
            db.add(fact)

    print(f"\nquery: {args.query}")
    for text, dist in db.query(args.query, args.top_k):
        print(f"  {dist:10.4f}  {text}")


if __name__ == "__main__":
    main()

"""Streaming text utilities shared by the engine and the pool."""

from __future__ import annotations

from typing import Optional, Sequence


class StopScanner:
    """Incremental stop-string detector over streamed text pieces.

    Only the last max(len(stop))-1 characters carry across pieces, so each
    feed() scans O(len(piece)) — not the whole transcript (a 2k-token
    generation would otherwise rescan megabytes). Tracks the GLOBAL
    character index of the earliest match so callers can truncate exactly
    at the first occurrence. Used by runtime/engine.generate and
    runtime/pool (same semantics in both, by construction).
    """

    def __init__(self, stop: Optional[Sequence[str]]):
        self.stop = tuple(s for s in (stop or ()) if s)
        self.maxstop = max((len(s) for s in self.stop), default=0)
        self.window = ""
        self.emitted = 0           # chars fed so far
        self.cut: Optional[int] = None  # global index of earliest match

    def feed(self, piece: str) -> bool:
        """Scan a new piece; returns True once any stop string has matched
        (at or before the current position)."""
        if not piece:
            return self.cut is not None
        if self.stop and self.cut is None:
            seg = self.window + piece
            hits = [seg.find(s) for s in self.stop if s in seg]
            if hits:
                self.cut = self.emitted - len(self.window) + min(hits)
            if self.maxstop > 1:
                self.window = seg[-(self.maxstop - 1):]
        self.emitted += len(piece)
        return self.cut is not None

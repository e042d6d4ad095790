"""pool_emit_ms.decode in the cells whose rate the host sets: the same reading, moving
their own end-to-end metric (BENCHMARK.json)."""

from benchmark import spec

read = spec.layer_reader("pool_emit_ms.decode")

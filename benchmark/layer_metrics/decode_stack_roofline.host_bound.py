"""decode_stack_roofline in the cells whose rate the host sets: the same reading, moving
their own end-to-end metric (BENCHMARK.json)."""

from benchmark import spec

read = spec.layer_reader("decode_stack_roofline")

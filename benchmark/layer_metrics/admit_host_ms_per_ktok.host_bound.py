"""admit_host_ms_per_ktok in the cells whose rate the host sets: the same reading, moving
their own end-to-end metric (BENCHMARK.json)."""

from benchmark import spec

read = spec.layer_reader("admit_host_ms_per_ktok")

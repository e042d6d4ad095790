"""The frozen byte and operation counts against values worked by hand."""

import json

import pytest

from benchmark import arith, spec


def cfg(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, L, E, F", [("rwkv4-14b-q8", 40, 5120, 20480),
                                           ("rwkv4-430m-q8", 24, 1024, 4096)])
def test_counts_by_hand(name, L, E, F):
    c = cfg(name)
    Vp, B = 50688, 16
    codes = L * (5 * E * E + 2 * E * F)
    per_layer_vectors = L * (4 * 2 * (6 * E + F) + 4 * 11 * E)
    head = E * Vp + 8 * E
    assert arith.weight_bytes_per_token(c) == codes + per_layer_vectors + head + 4 * (5 * E + Vp)
    state = 5 * L * B * E * 4
    assert arith.state_bytes(c, B) == state
    assert arith.stack_bytes(c, B) == (codes + per_layer_vectors + 8 * E + 4 * 4 * E
                                       + 4 * B * E + 2 * state + 4 * B * (E + 1))
    assert arith.head_bytes(c, B) == E * Vp + 4 * (B * E + B + Vp + B * Vp)
    assert arith.stack_flops(c, 1) == 2 * codes
    assert arith.prefill_flops(c, 1000, 3) == 2 * 1000 * codes + 3 * 2 * E * Vp


def test_published_sizes():
    big, small = cfg("rwkv4-14b-q8"), cfg("rwkv4-430m-q8")
    # 14B q8: 13.92 GB a decode step; 27.26 GFLOP a prompt token
    assert arith.weight_bytes_per_token(big) == pytest.approx(13.9168e9, rel=1e-4)
    assert arith.stack_flops(big, 1) == pytest.approx(27.263e9, rel=1e-4)
    # 430M: 0.382 GB (the program's tools/bench.py line: 0.113 ms at 3.35 TB/s)
    assert arith.weight_bytes_per_token(small) / arith.PEAK_HBM_BYTES_S == pytest.approx(0.114e-3, rel=0.01)
    # products on the bf16 tensor cores: at 16 streams, as at one, a decode
    # step is bound by its bytes at both sizes (14B: 4.12 ms of bytes against
    # 0.44 ms of products)
    for c in (big, small):
        for b in (1, 16):
            assert arith.stack_least_s(c, b) == pytest.approx(arith.stack_bytes(c, b) / 3.35e12)
            assert arith.head_least_s(c, b) == pytest.approx(arith.head_bytes(c, b) / 3.35e12)
            assert arith.decode_step_least_s(c, b) == pytest.approx(
                (arith.stack_bytes(c, b) + arith.head_bytes(c, b)) / 3.35e12)
    assert arith.stack_least_s(big, 16) == pytest.approx(4.116e-3, rel=0.001)
    assert arith.stack_flops(big, 16) / 989e12 == pytest.approx(0.441e-3, rel=0.01)

"""Kernel K1 on the tensor cores (csrc/stack_tc.cuh, decode_stack.cu's
decode_stack_kernel_tc) on the CPU: which steps take it (tc_path), how its
plan cuts each phase (tc_plan, read here by a mirror of the kernel's
tc_unit), the three exact bf16 pieces its products rest on, and its launch
counters. The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from rwkv_tpu_torch.ops.cuda import _build
from rwkv_tpu_torch.ops.cuda import decode_stack as ds
from rwkv_tpu_torch.runtime import graphs
from rwkv_tpu_torch.utils.metrics import metrics

# An H100's 232,448 bytes of shared memory a block, less the kernel's static
# part (~5 KB) and the fixed part of its dynamic shared memory (a 64 KB
# ring, its mbarriers, the epilogue scratch, the offset terms): the operand
# stages of ROWS weight rows that rwkv_decode_stack_tc_caps finds there.
ROWS = 128
_ROOM = 232448 - 5120 - (1024 + 65536 + 64 + 8 * 16 * 25 * 4 + 384 + 192)


def _op_stages(E: int) -> int:
    return (_ROOM - 16 * E) // (ROWS * 96)


@pytest.mark.parametrize("B,E,F,fmt,want", [
    (16, 5120, 20480, "q8", True), (16, 1024, 4096, "q8", True), (1, 1024, 4096, "q8", None),
    (8, 256, 1024, "q8", None), (17, 1024, 4096, "q8", False), (64, 1024, 4096, "q8", False),
    (16, 1024, 4096, "q4", False), (16, 1024, 4096, "a8", False), (16, 1040, 4160, "q8", False),
    (16, 1024, 4112, "q8", False)])
def test_tc_path_rule(B, E, F, fmt, want):
    """q8 from B* (TC_MIN_B) to 16 rows with whole column tiles of 128; q4,
    a8, more rows or ragged widths stay on the CUDA-core kernel. None: the
    answer is B* >= B."""
    if want is None:
        want = B >= ds.TC_MIN_B
    assert ds.tc_path(B, E, F, fmt) is want


def _units(plan, kind, E, F, grid):
    """The kernel's tc_unit for every block of phase `kind`: (matrix, split,
    first weight row, stages, first tile, tiles) or None; and the partial
    slots a tile takes."""
    Ks, O, _ = ds._phase_mats(E, F)[kind]
    ks, T = plan[kind], plan[4 + kind]
    tiles = O // 128
    groups = -(-tiles // T)
    out, n, slots = [], 0, 0
    for m, K in enumerate(Ks):
        kst = K // ROWS
        S = -(-kst // ks)
        for r in range(S * groups):
            s, g = divmod(r, groups)
            out.append((m, s, s * ks * ROWS, min(ks, kst - s * ks), g * T, min(T, tiles - g * T)))
        n += S * groups
        slots += S
    return out + [None] * (grid - len(out)), slots


@pytest.mark.parametrize("B", [1, 5, 16])
@pytest.mark.parametrize("E,F", [(256, 1024), (768, 3072), (1024, 4096), (2560, 10240),
                                 (4096, 16384), (5120, 20480)],
                         ids=["small", "169m", "430m", "3b", "7b", "14b"])
def test_tc_plan_reads_each_weight_once(B, E, F):
    """Every (matrix, column tile, stage of ROWS rows) of every phase falls in
    exactly one unit, the units fit the grid, each split's operand fits its
    phase's room, and the partials and tiles fit the split-K scratch."""
    grid, op = 132, _op_stages(E)
    plan = ds.tc_plan(B, E, F, grid, op, ROWS)
    free = (op * ROWS * 96 + 16 * E) // (ROWS * 96)
    for kind, (Ks, O, fold) in enumerate(ds._phase_mats(E, F)):
        units, slots = _units(plan, kind, E, F, grid)
        assert len(units) == grid, (kind, len(units))
        seen = {}
        for u in units:
            if u is None:
                continue
            m, s, k0, ns, t0, nt = u
            assert 1 <= ns <= (op if fold else free)
            for t in range(t0, t0 + nt):
                for st in range(ns):
                    key = (m, t, k0 // ROWS + st)
                    assert key not in seen, key
                    seen[key] = s
        assert len(seen) == sum(K // ROWS for K in Ks) * (O // 128)
        assert slots * B * O <= _build.SPLIT_FLOATS
        assert O // 128 <= _build.SPLIT_TILES - 64


def test_tc_plan_at_14b_fills_most_of_the_grid():
    """At RWKV-4 14B widths each phase's longest unit is within a fifth of an
    even share of its stages over 132 blocks."""
    E, F, grid = 5120, 20480, 132
    plan = ds.tc_plan(16, E, F, grid, _op_stages(E), ROWS)
    for kind, (Ks, O, _) in enumerate(ds._phase_mats(E, F)):
        even = sum(K // ROWS for K in Ks) * (O // 128) / grid
        assert plan[kind] * plan[4 + kind] <= 1.2 * even, (kind, plan)


def test_tc_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="no tensor-core plan"):
        ds.tc_plan(16, 5120, 20480, 8, 1, ROWS)


@pytest.mark.parametrize("scale", [1e-12, 1e-3, 1.0, 3e4])
def test_three_bf16_pieces_are_exact(scale):
    """The operand's pieces (stack_tc.cuh's tc_stage, int8_head.cuh's K2):
    hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) sum to x
    exactly, and each piece times an int8 code is exact in f32, so a TC
    product's only rounding is the f32 accumulation."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.normal(size=4096) * scale).astype(np.float32))
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    w = torch.from_numpy(rng.integers(-128, 128, size=4096).astype(np.float32))
    for piece in (hi, mid, lo):
        assert torch.equal((piece * w).double(), piece.double() * w.double())


def test_tc_launch_counters():
    """A TC launch adds to launches_tc and to the metrics registry's
    decode_stack.launches_tc (graph captures included); a replay of a graph
    advances launches_tc by what its capture recorded (runtime/graphs.py)."""
    assert ds.TC_COUNTER == "decode_stack.launches_tc"
    assert (ds, "launches_tc") in graphs.COUNTERS
    before = ds.launches_tc, metrics.snapshot()["counters"].get(ds.TC_COUNTER, 0)
    try:
        ds._count_tc(2)
        ds._count_tc(0)
        assert ds.launches_tc == before[0] + 2
        assert metrics.snapshot()["counters"][ds.TC_COUNTER] == before[1] + 2
    finally:
        ds.launches_tc = before[0]
        metrics.inc(ds.TC_COUNTER, -2)

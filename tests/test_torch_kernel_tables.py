"""The pointer tables the CUDA wrappers pass to their kernels, held against
the kernels' enums.

Each wrapper in rwkv_tpu_torch/ops/cuda/ fills a ctypes array of pointers in
the order of a tuple of names, and the kernel reads it by the positions of a
C enum in rwkv_tpu_torch/csrc/*.cu. The library checks only the counts when
it loads, and only on the card; a swapped pair would pass that and show
only as wrong numbers. Here every enum is parsed from its source and must
name the tuple's entries in the tuple's order, entry by entry, by one rule:
the wrapper's name split at "." and "_", each word abbreviated as the
enums abbreviate it (weight -> W, key -> K, ...), joined by "_" in upper
case, after the enum's prefix ("att.key.w" -> P_ATT_K_W).
"""

import re
from pathlib import Path

import pytest

from rwkv_tpu_torch.ops.cuda import decode_stack, decode_stack_tp, tp_halves

CSRC = Path(decode_stack.__file__).resolve().parents[2] / "csrc"

_WORDS = {"weight": "w", "bias": "b", "scale": "s", "offset": "o", "key": "k", "value": "v",
          "receptance": "r", "output": "o"}


def _enum_name(prefix: str, name: str) -> str:
    return prefix + "_".join(_WORDS.get(w, w) for w in re.split(r"[._]", name)).upper()


def _enum(source: str, enum: str) -> list:
    """The entries of `enum <name> : int { ... };` in a csrc file, in order,
    without the trailing *_COUNT."""
    text = (CSRC / source).read_text()
    m = re.search(r"enum\s+" + enum + r"\s*:\s*int\s*\{(.*?)\};", text, re.S)
    assert m, f"enum {enum} not found in {source}"
    body = re.sub(r"//[^\n]*", "", m.group(1))
    names = [n.strip() for n in body.split(",") if n.strip()]
    assert names[-1].endswith("_COUNT"), names[-1]
    return names[:-1]


@pytest.mark.parametrize("source,enum,prefix,names", [
    ("decode_stack.cu", "Ptr", "P_", decode_stack._POINTERS),
    ("decode_stack_tp.cu", "SharedPtr", "S_", decode_stack_tp._SHARED),
    ("decode_stack_tp.cu", "ShardPtr", "D_", decode_stack_tp._SHARD),
    ("decode_stack_tp.cu", "PeerKind", "K_", decode_stack_tp._PEER_KINDS),
    ("tp_halves.cu", "AttPtr", "A_", tp_halves._ATT_POINTERS),
    ("tp_halves.cu", "FfnPtr", "F_", tp_halves._FFN_POINTERS),
], ids=["decode_stack.Ptr", "decode_stack_tp.SharedPtr", "decode_stack_tp.ShardPtr",
        "decode_stack_tp.PeerKind", "tp_halves.AttPtr", "tp_halves.FfnPtr"])
def test_pointer_table_matches_enum(source, enum, prefix, names):
    entries = _enum(source, enum)
    want = [_enum_name(prefix, n) for n in names]
    assert len(set(want)) == len(want), "two wrapper names map to one enum entry"
    for i, (got, exp) in enumerate(zip(entries, want)):
        assert got == exp, f"{source} {enum}[{i}] is {got}, the wrapper's {names[i]!r} wants {exp}"
    assert len(entries) == len(want), (len(entries), len(want))


def test_tc_tensor_maps_follow_the_families():
    """rwkv_decode_stack_tc_maps (decode_stack.cu) encodes one tensor map a
    weight family from the wrapper's pointers in _FAMILIES order, with its
    own table of each family's [K, O]: that table must be the wrapper's
    shapes, family by family."""
    text = (CSRC / "decode_stack.cu").read_text()
    m = re.search(r"const int K\[kTcMaps\] = \{([^}]*)\}, O\[kTcMaps\] = \{([^}]*)\};", text)
    assert m, "the families' [K, O] table not found in decode_stack.cu"
    E, F = 64, 256
    width = {"E": E, "F": F}
    ks = [width[s.strip()] for s in m.group(1).split(",")]
    os_ = [width[s.strip()] for s in m.group(2).split(",")]
    shapes = decode_stack._param_shapes(3, E, F, 1024, q4=False)
    want = [shapes[fam + ".w"][1:] for fam in decode_stack._FAMILIES]
    assert list(zip(ks, os_)) == want

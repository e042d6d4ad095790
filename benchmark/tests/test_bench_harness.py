"""The harness on the CPU at a tiny size: it drives the program's pool to its
record, reports no device number there, and its comparison comes out false
when the served path is broken underneath (the faults a serving cell can
have) and when the TF32 control takes the program's place."""

import json

import numpy as np
import pytest
import torch

from benchmark import control, run, spec
from benchmark import weights as wmod
from benchmark.families import rwkv4
from benchmark.reference.model import Reference
from benchmark.reference.tokenizer import Tokenizer
from benchmark.tests.cells import TINY, tiny

SEED = 2 ** 33 + 12345


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_drives_the_pool_and_reports_no_device_number():
    out = run.run_cell(tiny("rwkv4-430m-q8.chat"), SEED, 1.5, trace=True, device="cpu")
    assert out["correct"], out["numbers"]
    assert out["attempted"] > 4 and out["failed"] == 0
    assert "metrics" not in out and "device" not in out and "breakdown" not in out
    assert out["numbers"]["states_judged"] > 0 and out["numbers"]["tokens_judged"] > 0
    assert list(out)[-1] == "checks"


def unchanged_state(server, mp):
    impl = server.pool._step_impl
    server.pool._step_impl = lambda p, t, s: (impl(p, t, s)[0], s)


def half_batch(server, mp):
    """Only the first half of the slots advance."""
    impl = server.pool._step_impl

    def step(p, t, s):
        logits, new = impl(p, t, s)
        h = t.shape[0] // 2
        return logits, type(new)(*(torch.cat([n[:, :h], o[:, h:]], dim=1) for n, o in zip(new, s)))

    server.pool._step_impl = step


def altered_token(server, mp):
    """Every decoded token one id off where typical draws it."""
    import rwkv_tpu_torch.runtime.pool as pool_mod

    draw = pool_mod.typical
    B = server.pool.B

    def typical(logits, gens, **kw):
        ids = draw(logits, gens, **kw)
        return (ids + 1) % 50277 if ids.shape == (B,) else ids

    mp.setattr(pool_mod, "typical", typical)


def _patch_qmatmul(mp, qmatmul):
    import rwkv_tpu_torch.models.rwkv4 as model

    mp.setattr(model, "qmatmul", qmatmul)


def scales_on_output_axis(server, mp):
    """The square matrices' scales applied to their output channels."""
    from rwkv_tpu_torch.ops.quant import qmatmul as plain

    def qmatmul(x, q, compute_dtype=torch.float32):
        if q.w.shape[-1] != q.w.shape[-2]:
            return plain(x, q, compute_dtype)
        return (x @ q.w.float()) * q.scale + (x * q.offset).sum(dim=-1, keepdim=True)

    _patch_qmatmul(mp, qmatmul)


def one_scale_and_offset(server, mp):
    """Every channel of a matrix read with its first channel's scale and offset."""
    from rwkv_tpu_torch.ops.quant import QuantLinear
    from rwkv_tpu_torch.ops.quant import qmatmul as plain

    def qmatmul(x, q, compute_dtype=torch.float32):
        one = QuantLinear(q.w, q.scale[..., :1].expand_as(q.scale),
                          q.offset[..., :1].expand_as(q.offset))
        return plain(x, one, compute_dtype)

    _patch_qmatmul(mp, qmatmul)


def dropped_ln_affine(server, mp):
    """Every LayerNorm without its weight and bias."""
    p = server.pool.params
    for name in ("ln0", "ln1", "ln2", "ln_out"):
        ln = getattr(p, name)
        setattr(p, name, type(ln)(torch.ones_like(ln.weight), torch.zeros_like(ln.bias)))


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, altered_token,
                                   scales_on_output_axis, one_scale_and_offset,
                                   dropped_ln_affine],
                         ids=lambda f: f.__name__)
def test_a_broken_served_path_is_not_correct(fault, monkeypatch):
    out = run.run_cell(tiny("rwkv4-430m-q8.chat"), SEED, 1.5, trace=False, device="cpu",
                       fault=lambda server: fault(server, monkeypatch))
    assert not out["correct"], out["numbers"]


@pytest.mark.parametrize("name", ["rwkv4-14b-q8.chat", "rwkv4-430m-q8.chat",
                                  "rwkv4-430m-q8.longprompt"])
def test_the_control_is_not_correct(name):
    """The reference in TF32 in the program's place fails the cell's limits;
    the program passes them, on the same lanes."""
    got = control.run(tiny(name), SEED + 1, 1.5, device="cpu")
    assert got["program_correct"] and not got["control_correct"], got


def test_reference_matches_the_programs_plain_forward():
    from rwkv_tpu_torch.models.rwkv4 import forward_seq, init_state

    cfg = dict(spec.cell("rwkv4-430m-q8.chat").config, **TINY)
    w = wmod.make(cfg, SEED, "cpu")
    params = wmod.program_params(w)
    rng = np.random.default_rng(0)
    lanes = [rng.integers(1, 50277, size=n).tolist() for n in (37, 5, 60, 1)]
    ref = Reference(w, cfg).run(lanes, [0] * 4, lanes_per_group=3)
    for toks, (logits, state) in zip(lanes, ref):
        lg, st = forward_seq(params, torch.tensor(toks), init_state(params.config),
                             return_all_logits=True)
        assert (lg - logits).abs().max() < 1e-4
        for leaf in ("xy", "dd"):
            assert (getattr(st, leaf).double() - state[leaf]).abs().max() < 1e-5
        z = rwkv4.z_of({k: getattr(st, k).double() for k in ("aa", "bb", "pp")}, w["att_bonus"])
        assert (z - rwkv4.z_of(state, w["att_bonus"])).abs().max() < 1e-5


def test_reference_tokenizer_matches_the_programs_python_one():
    from rwkv_tpu_torch.tokenizer.bpe import BPETokenizer

    ref, prog = Tokenizer(), BPETokenizer.load()
    rng = np.random.default_rng(4)
    for _ in range(40):
        ids = rng.integers(1, 50277, size=200).tolist()
        text = ref.decode(ids)
        assert ref.encode(text) == prog.encode(text)
    for text in ["It's  a\n\n test 123 4.5 ñandú, ¿qué?  ", "   ", "'s'S 'll", "日本語 テキスト"]:
        assert ref.encode(text) == prog.encode(text)


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "rwkv4-430m-q8.chat", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = run.run_cell(spec.cell("rwkv4-430m-q8.chat"), SEED, 3.0, trace=True)
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert {m["name"] for m in spec.cell("rwkv4-430m-q8.chat").per_layer} == set(out["metrics"])
    json.dumps(out)

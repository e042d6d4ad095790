"""The port's converter (rwkv_tpu_torch/io/convert.py) against the JAX
package's, on tests/test_convert.py's synthetic checkpoints (CPU): the .bin
byte for byte, the streaming writer, the q4 artifact's tensors, the command
line, load_pth; and ops.quant.dequantize and models.rwkv4.init_params."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rwkv_tpu.io import convert as j_convert
from rwkv_tpu.io.registry import file_layout
from rwkv_tpu.io.safetensors import SafetensorsFile
from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.ops import quant as j_quant
from rwkv_tpu_torch.io import binfmt as t_binfmt
from rwkv_tpu_torch.io import convert as t_convert
from rwkv_tpu_torch.io.registry import REGISTRY
from rwkv_tpu_torch.io.safetensors import write_safetensors
from rwkv_tpu_torch.models import rwkv4 as t_m
from rwkv_tpu_torch.models.config import RWKVConfig as TConfig
from rwkv_tpu_torch.ops import quant as t_quant
from tests.test_convert import make_synthetic_pth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _checkpoint(tmp_path, kind, L, E):
    """A synthetic BlinkDL checkpoint, as .pth or as .safetensors."""
    pth = str(tmp_path / f"m{L}x{E}.pth")
    w = make_synthetic_pth(pth, n_layer=L, n_embd=E)
    if kind == "pth":
        return pth
    path = str(tmp_path / f"m{L}x{E}.safetensors")
    write_safetensors(path, {k: v.numpy() for k, v in w.items()})
    return path


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind,L,E", [("pth", 2, 16), ("pth", 3, 32), ("safetensors", 2, 16)])
def test_convert_is_byte_equal_to_jax(tmp_path, kind, L, E):
    src = _checkpoint(tmp_path, kind, L, E)
    j_convert.convert(src, str(tmp_path / "jax.bin"))
    t_convert.convert(src, str(tmp_path / "port.bin"))
    assert _bytes(tmp_path / "port.bin") == _bytes(tmp_path / "jax.bin")


def test_write_bin_streaming_matches_write_bin(tmp_path):
    """The streaming converter's .bin against write_bin of the quantized
    params in memory: byte-equal except decay, which the converter keeps in
    float64 and RWKVParams rounds through float32 (the JAX test's rule)."""
    pth = _checkpoint(tmp_path, "pth", 3, 32)
    a, b = str(tmp_path / "stream.bin"), str(tmp_path / "mem.bin")
    t_convert.convert(pth, a)
    t_binfmt.write_bin(b, t_m.quantize_params(t_convert.load_pth(pth)))
    da, db = _bytes(a), _bytes(b)
    assert len(da) == len(db)
    for name, off, n in file_layout(3, 32):
        if name == "decay":
            x = np.frombuffer(da[off:off + n], "<f8")
            y = np.frombuffer(db[off:off + n], "<f8")
            np.testing.assert_array_equal(x.astype(np.float32), y.astype(np.float32))
            assert not np.array_equal(x, y)  # the converter's decay is not rounded
        else:
            assert da[off:off + n] == db[off:off + n], name


def test_write_bin_streaming_checks_each_shape(tmp_path):
    def get(spec):
        shape = spec.shape(2, 16)
        return np.zeros(shape[:-1] + (shape[-1] + (spec.name == "mix_r"),))

    with pytest.raises(ValueError, match="mix_r: shape"):
        t_binfmt.write_bin_streaming(str(tmp_path / "x.bin"), 2, 16, get)


def test_converted_bin_reads_back_as_the_quantized_checkpoint(tmp_path):
    """read_bin of the converted .bin equals load_checkpoint_quantized of the
    source, signed the same way: code for code, scale and offset for each."""
    pth = _checkpoint(tmp_path, "pth", 2, 16)
    out = str(tmp_path / "m.bin")
    t_convert.convert(pth, out)
    got = t_binfmt.read_bin(out, "cpu", signed=True)
    want = t_m.signedize_params(t_convert.load_checkpoint_quantized(pth, 8))
    leaves = []
    t_m.map_params(want, lambda a: leaves.append(np.asarray(a)) or a)
    got_leaves = []
    t_m.map_params(got, lambda a: got_leaves.append(a.numpy()) or a)
    assert len(leaves) == len(got_leaves)
    for g, w in zip(got_leaves, leaves):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("L,E", [(2, 16), (2, 128)])
def test_main_q4_matches_jax(tmp_path, L, E):
    """The q4 artifact's tensors and header metadata equal the JAX main's
    (E = 128: the row-tiled families pair within q4_pack_block(E) as within
    the JAX pick_tile_q4(E))."""
    pth = _checkpoint(tmp_path, "pth", L, E)
    a, b = str(tmp_path / "jax.q4.safetensors"), str(tmp_path / "port.q4.safetensors")
    j_convert.main([pth, "--quant", "q4", "-o", a])
    t_convert.main([pth, "--quant", "q4", "-o", b])
    fa, fb = SafetensorsFile(a), SafetensorsFile(b)
    assert sorted(fa.keys()) == sorted(fb.keys())
    assert fa.metadata == fb.metadata
    for k in fa.keys():
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(y, x, err_msg=k)


def test_main_q8_and_the_default_q4_suffix(tmp_path, monkeypatch):
    pth = _checkpoint(tmp_path, "pth", 2, 16)
    monkeypatch.chdir(tmp_path)
    t_convert.main([pth])  # q8 to the default model.bin
    j_convert.convert(pth, str(tmp_path / "jax.bin"))
    assert _bytes(tmp_path / "model.bin") == _bytes(tmp_path / "jax.bin")
    t_convert.main([pth, "--quant", "q4"])  # the untouched default takes .q4.safetensors
    assert (tmp_path / "model.q4.safetensors").is_file()


def test_main_errors(tmp_path, monkeypatch, capsys):
    pth = _checkpoint(tmp_path, "pth", 2, 16)
    with pytest.raises(SystemExit) as e:
        t_convert.main([pth, "--quant", "q4", "-o", str(tmp_path / "x.bin")])
    assert e.value.code == 2
    assert "give -o a .safetensors path" in capsys.readouterr().err
    monkeypatch.setattr(t_convert, "_pick_file_gui", lambda: None)
    with pytest.raises(SystemExit) as e:
        t_convert.main([])
    assert e.value.code == 2
    assert "no input checkpoint given and no GUI available" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        t_convert.main([pth, "--quant", "q2"])
    not_rwkv = str(tmp_path / "other.pth")
    torch.save({"weight": torch.zeros(2)}, not_rwkv)
    with pytest.raises(ValueError, match="not an RWKV-v4 checkpoint"):
        t_convert.main([not_rwkv, "-o", str(tmp_path / "o.bin")])


def test_pick_file_gui_without_a_display(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert t_convert._pick_file_gui() is None


def test_module_runs_as_a_program(tmp_path):
    pth = _checkpoint(tmp_path, "pth", 2, 16)
    out = str(tmp_path / "cli.bin")
    r = subprocess.run([sys.executable, "-m", "rwkv_tpu_torch.io.convert", pth, "-o", out],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    j_convert.convert(pth, str(tmp_path / "jax.bin"))
    assert _bytes(out) == _bytes(tmp_path / "jax.bin")


def test_load_pth_matches_jax(tmp_path):
    pth = _checkpoint(tmp_path, "pth", 2, 16)
    j = jax.tree.leaves(jax.tree.map(np.asarray, j_convert.load_pth(pth)))
    t = []
    t_m.map_params(t_convert.load_pth(pth), lambda a: t.append(np.asarray(a)) or a)
    assert len(j) == len(t)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_dequantize_matches_jax():
    """u8 codes: the JAX dequantize bit for bit. The engine's int8 codes
    (+128 * scale folded into the offset): the same weight up to the float32
    rounding of that fold, |128 * scale| * 2^-23 a channel."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(2, 48, 40)).astype(np.float32)
    jq = j_quant.quantize(w, as_numpy=True)
    ref = np.asarray(j_quant.dequantize(jax.tree.map(jax.numpy.asarray, jq)))
    tq = t_quant.quantize(w)
    np.testing.assert_array_equal(t_quant.dequantize(tq).numpy(), ref)
    signed = t_quant.dequantize(t_quant.to_signed(tq)).numpy()
    bound = 2 * 128 * np.abs(tq.scale)[..., None] * 2.0 ** -23 + np.abs(ref) * 2.0 ** -23
    assert np.all(np.abs(signed - ref) <= bound)
    np.testing.assert_array_equal(
        t_quant.dequantize(t_quant.to_signed(t_quant.QuantLinear(*map(
            torch.from_numpy, (tq.w, tq.scale, tq.offset))))).numpy(), signed)
    assert t_quant.dequantize(tq, torch.float64).dtype == torch.float64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_shapes_and_ranges(dtype):
    """The JAX init_params' shapes; the same scales and ranges; the same
    draws again from the same seed."""
    cfg = (2, 64, 211)
    t = t_m.init_params(TConfig(*cfg), torch.Generator().manual_seed(5), dtype)
    j = j_m.init_params(jax.random.PRNGKey(5), RWKVConfig(*cfg))
    tl, jl = [], jax.tree.leaves(j)
    t_m.map_params(t, lambda a: tl.append(a) or a)
    assert [tuple(a.shape) for a in tl] == [tuple(a.shape) for a in jl]
    assert all(a.dtype == dtype for a in tl)
    E, F = 64, 256
    f = lambda a: a.float().numpy()  # noqa: E731
    for mix in (t.att.mix_k, t.att.mix_v, t.att.mix_r, t.ffn.mix_k, t.ffn.mix_r):
        assert f(mix).min() >= 0.1 and f(mix).max() <= 0.9
        assert abs(f(mix).mean() - 0.5) < 0.05
    assert np.all(f(t.att.decay) < 0)
    np.testing.assert_allclose(np.log(-f(t.att.decay)).std(), 1.0, rtol=0.15)
    for w, scale in ((t.emb, 0.1), (t.att.key, E ** -0.5), (t.att.output, E ** -0.5),
                     (t.ffn.key, E ** -0.5), (t.ffn.value, F ** -0.5), (t.head, E ** -0.5),
                     (t.att.bonus, 0.5)):
        np.testing.assert_allclose(f(w).std(), scale, rtol=0.1)
        assert abs(f(w).mean()) < 0.1 * scale
    for ln in (t.ln0, t.ln1, t.ln2, t.ln_out):
        assert np.all(f(ln.weight) == 1) and np.all(f(ln.bias) == 0)
    again = t_m.init_params(TConfig(*cfg), torch.Generator().manual_seed(5), dtype)
    assert torch.equal(again.ffn.value, t.ffn.value) and torch.equal(again.emb, t.emb)


def test_registry_is_the_jax_registry():
    """The converter writes the port's REGISTRY: the JAX one, name for name."""
    from rwkv_tpu.io.registry import REGISTRY as J

    assert [(s.name, s.dtype, s.shape(3, 8)) for s in REGISTRY] == \
        [(s.name, s.dtype, s.shape(3, 8)) for s in J]

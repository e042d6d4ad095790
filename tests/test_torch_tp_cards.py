"""Tensor parallelism across distinct devices, the parts the CPU can hold:
the per-shard resident state of the engine and the pool (against the
whole-state path that cuts and joins it at every call, and against the JAX
engine), make_put's placement on every data row, make_tp_step's body choice
over rows of distinct cards (the CUDA device predicates monkeypatched) and a
two-process pod whose processes hold two devices each.

On the CPU a mesh names the CPU several times, so nothing here crosses a
card; the kernels across cards run in tests/test_torch_cuda.py and
rwkv_tpu_torch/tools/tp_cards.py."""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import to_port

from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.parallel import mesh as j_mesh
from rwkv_tpu_torch.io.binfmt import write_bin
from rwkv_tpu_torch.models import rwkv4 as t_m
from rwkv_tpu_torch.models.rwkv4 import WKVState, init_state
from rwkv_tpu_torch.ops.cuda import decode_stack_tp as t_k7
from rwkv_tpu_torch.parallel import mesh as t_mesh
from rwkv_tpu_torch.parallel import sharding as t_sh
from rwkv_tpu_torch.parallel import tp_step as t_tp
from rwkv_tpu_torch.runtime.engine import RWKV, Mode
from rwkv_tpu_torch.runtime.pool import InferencePool

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS_TOL, STATE_TOL = 2e-4, 1e-4  # the port's engine against the JAX one
POD_TOL = 3e-4  # the JAX two-process worker's pin


def _cpu_mesh(model, data=1):
    return t_mesh.make_mesh(model=model, data=data, devices=["cpu"] * (model * data))


class _CutJoinEngine(RWKV):
    """The sharded engine with one whole state, cut into shards and joined by
    the step at every call (the path before the state stayed resident)."""

    def reset_state(self, stream=None):
        if stream is None or self._state is None:
            self._state = init_state(self.config, (self.max_streams,), device=self.device)
            self._last_logits, self._pending = {}, {}
        else:
            self.set_state(self.empty_state(), stream)

    def _stream_state(self, stream):
        return self.get_state(stream)

    def _put_stream(self, state, stream):
        for pool, s in zip(self._state, state):
            pool[:, stream] = s
        self._last_logits.pop(stream, None)
        self._pending.pop(stream, None)

    def get_state(self, stream=0):
        return WKVState(*(s[:, stream].clone() for s in self._state))

    def set_state(self, state, stream=0):
        self._put_stream(state, stream)


class _CutJoinPool(InferencePool):
    """The pool with one whole state (cut and joined by the step)."""

    def _new_state(self, n):
        return init_state(self.cfg, (n,), device=self.device)


@pytest.fixture(scope="module")
def binfile(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bin") / "l2-e256.bin")
    write_bin(path, t_m.random_quantized_params_np(RWKVConfig(n_layer=2, n_embd=256), seed=31,
                                                   pad_multiple=None))
    return path


def _engines(binfile, mesh_of, max_streams=1):
    out = []
    for cls in (RWKV, _CutJoinEngine):
        eng = cls(binfile, device="cpu", sharding=mesh_of(), max_streams=max_streams)
        eng.load_tokenizer(native=False)
        out.append(eng)
    return out


@pytest.mark.parametrize("model,data", [(2, 1), (2, 2)])
def test_engine_state_resident_equals_cut_and_join(binfile, tmp_path, model, data):
    """The engine keeps its state as a ShardedState: prompt, greedy steps and
    generate make no whole-state cut or join, and give the cut-and-join
    path's logits, state, text and save_state arrays bit for bit."""
    eng, ref = _engines(binfile, lambda: _cpu_mesh(model, data), max_streams=2)
    assert isinstance(eng._state, t_sh.ShardedState) and eng._step_fn.body == "halves"
    for stream in (0, 1):
        before = dict(t_sh.counts)
        lg = eng.forward([3, 4, 5, 6, 7], stream=stream)
        ids = []
        for _ in range(4):
            ids.append(int(lg.argmax()))
            lg = eng.forward(ids[-1], stream=stream)
        text = eng.generate("Hi there", max_tokens=6, temp=1.0, tau=0.0, seed=stream,
                            stream=stream)
        assert t_sh.counts == before, "the resident engine cut or joined its state"
        lr = ref.forward([3, 4, 5, 6, 7], stream=stream)
        for i in ids:
            assert int(lr.argmax()) == i
            lr = ref.forward(i, stream=stream)
        assert torch.equal(lg, lr)
        assert text == ref.generate("Hi there", max_tokens=6, temp=1.0, tau=0.0, seed=stream,
                                    stream=stream)
        for a, b in zip(eng.get_state(stream), ref.get_state(stream)):
            assert torch.equal(a, b)
        eng.save_state(str(tmp_path / f"a{stream}.npz"), stream)
        ref.save_state(str(tmp_path / f"b{stream}.npz"), stream)
        with np.load(tmp_path / f"a{stream}.npz") as za, \
                np.load(tmp_path / f"b{stream}.npz") as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])
    # PARALLEL mode advances both streams of the resident state at once
    before = dict(t_sh.counts)
    got = eng.forward([5, 9], mode=Mode.PARALLEL)
    assert t_sh.counts == before
    assert torch.equal(got, ref.forward([5, 9], mode=Mode.PARALLEL))
    # save_state -> load_state round-trips bit for bit into another stream
    eng.load_state(str(tmp_path / "a0.npz"), 1)
    with np.load(tmp_path / "a0.npz") as z:
        for k, a in zip(WKVState._fields, eng.get_state(1)):
            np.testing.assert_array_equal(a.numpy(), z[f"state_{k}"])


def test_engine_resident_state_matches_jax_engine(binfile):
    """The resident engine on a tp = 2 CPU mesh against the JAX sharded
    engine on the same file: logits and state after a prompt and greedy
    steps at the pinned 2e-4 / 1e-4."""
    from rwkv_tpu.parallel.sharding import ShardingContext
    from rwkv_tpu.runtime.engine import RWKV as JRWKV

    eng = RWKV(binfile, device="cpu", sharding=_cpu_mesh(2))
    jmesh = j_mesh.make_mesh(model=2, data=1)
    with jax.sharding.set_mesh(jmesh):
        jeng = JRWKV(sharding=ShardingContext(jmesh))
        jeng.load_file(binfile)
        want = [np.asarray(jeng.forward([3, 4, 5]))]
        for _ in range(3):
            want.append(np.asarray(jeng.forward(int(np.argmax(want[-1])))))
        jstate = [np.asarray(s) for s in jeng.get_state(0)]
    before = dict(t_sh.counts)
    got = [eng.forward([3, 4, 5]).numpy()]
    for _ in range(3):
        got.append(eng.forward(int(np.argmax(want[len(got) - 1]))).numpy())
    assert t_sh.counts == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LOGITS_TOL, atol=LOGITS_TOL)
    for a, b in zip(eng.get_state(0), jstate):
        np.testing.assert_allclose(a.numpy(), b, rtol=STATE_TOL, atol=STATE_TOL)


@pytest.mark.parametrize("model,data", [(2, 1), (2, 2)])
def test_pool_state_resident_equals_cut_and_join(binfile, model, data):
    """The pool over sharded params keeps a ShardedState: admission writes
    only the admitted lanes, no whole-state cut or join while it serves,
    and its texts and final state equal the whole-state pool's."""
    eng = RWKV(binfile, device="cpu", sharding=_cpu_mesh(model, data))
    eng.load_tokenizer(native=False)
    prompts = ["Hi", "The quick brown", "In a hole", "Answer:", "x", "Once upon"]

    def serve(cls):
        pool = cls(eng.params, eng.tokenizer, max_streams=4, prefill_bucket=8,
                   step_fn=eng._step_fn, prefill_fn=eng._prefill_impl)
        rids = [pool.submit(p, max_tokens=5 + i, temp=0.8, tau=0.0, seed=i)
                for i, p in enumerate(prompts)]
        out = pool.run()
        return pool, [out[r] for r in rids]

    before = dict(t_sh.counts)
    pool, got = serve(InferencePool)
    assert isinstance(pool._state, t_sh.ShardedState)
    assert t_sh.counts == before, "the resident pool cut or joined its state"
    ref, want = serve(_CutJoinPool)
    assert got == want
    for a, b in zip(pool._state.join(), ref._state):
        assert torch.equal(a, b)


def test_sharded_state_lanes_roundtrip():
    """ShardedState.take/put/where over two data rows against the same
    operations on the whole state."""
    cfg = RWKVConfig(n_layer=2, n_embd=256, vocab_size=10)
    mesh = _cpu_mesh(2, 2)
    g = torch.Generator().manual_seed(0)
    whole = WKVState(*(torch.randn(2, 5, 256, generator=g) for _ in range(5)))
    st = t_sh.ShardedState.cut(whole, mesh)
    assert (st.B, st.per) == (5, 3)
    for a, b in zip(st.join(), whole):
        assert torch.equal(a, b)
    part = st.take([4, 0, 2])
    for a, b in zip(part.join(), whole):
        assert torch.equal(a, b[:, [4, 0, 2]])
    fresh = t_sh.ShardedState.zeros(cfg, 5, mesh)
    fresh.put([1, 3, 4], part)
    for name, a, b in zip(WKVState._fields, fresh.join(), whole):
        assert torch.equal(a[:, [1, 3, 4]], b[:, [4, 0, 2]])
        fill = -1e30 if name == "pp" else 0.0
        assert (a[:, [0, 2]] == fill).all()
    active = torch.tensor([True, False, True, False, True])
    mixed = st.where(active, fresh)
    for a, b, c in zip(mixed.join(), whole, fresh.join()):
        assert torch.equal(a, torch.where(active[None, :, None], b, c))


def test_make_put_places_every_row_on_its_devices():
    """make_put sends each piece straight to its device in every data row:
    a split tensor cut on its dim, a replicated one whole on each device,
    and shard_params takes the result as it is."""
    devs = [torch.device("cpu"), torch.device("cpu"), torch.device("meta"),
            torch.device("meta")]
    mesh = t_mesh.make_mesh(model=2, data=2, devices=devs)
    put = t_sh.make_put(mesh)
    arr = np.arange(2 * 8 * 6, dtype=np.float32).reshape(2, 8, 6)
    km = put("km", arr)  # column-parallel: split on the last dim
    assert isinstance(km, t_sh.MeshShards) and len(km) == 2
    for d, row in enumerate(km):
        for j, t in enumerate(row):
            assert t.device == mesh.devices[d][j] and t.shape == (2, 8, 3)
    for j in range(2):
        np.testing.assert_array_equal(km[0][j].numpy(), arr[..., 3 * j:3 * (j + 1)])
    ln = put("ln0.w", np.ones(6, np.float32))  # replicated
    assert [[t.device for t in row] for row in ln] == mesh.devices
    assert all(t.shape == (6,) for row in ln for t in row)
    odd = put("embed", np.zeros((5, 6), np.float32))  # an odd vocab stays whole
    assert all(t.shape == (5, 6) for row in odd for t in row)


def test_make_put_feeds_read_bin_and_shard_params(binfile):
    """read_bin(put=make_put(mesh)) then shard_params on a 2 x 2 CPU mesh
    gives the params shard_params cuts from the whole load."""
    from rwkv_tpu_torch.io.binfmt import read_bin

    mesh = _cpu_mesh(2, 2)
    a = t_sh.shard_params(read_bin(binfile, "cpu", put=t_sh.make_put(mesh), pad_vocab_to=512,
                                   signed=True), mesh)
    b = t_sh.shard_params(read_bin(binfile, "cpu", pad_vocab_to=512, signed=True), mesh)
    for d in range(2):
        for j in range(2):
            for x, y in zip(_leaves(a.rows[d][j]), _leaves(b.rows[d][j])):
                assert torch.equal(x, y)


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _leaves(getattr(tree, f.name))]
    return []


@pytest.fixture(scope="module")
def small_params():
    cfg = RWKVConfig(n_layer=1, n_embd=512, vocab_size=300)
    return t_m.signedize_params(t_m.params_to(t_m.random_quantized_params_np(
        cfg, seed=3, pad_multiple=512), "cpu"))


def _cards(*idx):
    return [torch.device("cuda", i) for i in idx]


@pytest.mark.parametrize("peer,devices,data,body,want", [
    (True, (0, 1, 2, 3), 1, None, "fused"),
    (True, (0, 1, 2, 3), 2, None, "fused"),        # 2 rows of 2 cards
    (True, (0, 0, 0, 0), 1, None, "fused"),        # a virtual mesh
    (True, (0, 0, 1, 1), 1, None, "halves"),       # a row repeating a card
    ("no 1-2", (0, 1, 2, 3), 1, None, "halves"),   # a pair without peer access
    ("no 1-2", (0, 1, 2, 3), 1, "fused", RuntimeError),
    (True, (0, 0, 1, 1), 1, "fused", ValueError),
], ids=["4cards", "2x2cards", "virtual", "repeats", "nopeer-auto", "nopeer-fused",
        "repeats-fused"])
def test_body_choice_over_cards(monkeypatch, small_params, peer, devices, data, body, want):
    """make_tp_step picks "fused" (K7 across cards) over rows of distinct
    cards with peer access, falls back to "halves" where a row lacks it or
    repeats a card, and body="fused" there raises, naming the pair."""
    def can(a, b):
        a, b = torch.device(a).index, torch.device(b).index
        return peer is True or {a, b} != {1, 2}

    monkeypatch.setattr(torch.cuda, "can_device_access_peer", can)
    tp = len(devices) // data
    mesh = t_mesh.make_mesh(model=tp, data=data, devices=_cards(*devices))
    assert mesh.spans_cards == (len(set(devices[:tp])) == tp)
    if isinstance(want, str):
        assert t_tp.make_tp_step(mesh, small_params, body=body).body == want
        return
    with pytest.raises(want) as e:
        t_tp.make_tp_step(mesh, small_params, body=body)
    if want is RuntimeError:
        assert "cuda:1 cannot access cuda:2" in str(e.value)


def test_row_devices_rules(monkeypatch):
    """decode_stack_tp.row_devices: one device, or each shard on its own card
    with peer access; a CPU row and a row repeating a card raise."""
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: True)
    assert t_k7.row_devices(_cards(2, 2)) == (_cards(2), False)
    assert t_k7.row_devices(_cards(0, 1, 2)) == (_cards(0, 1, 2), True)
    with pytest.raises(ValueError):
        t_k7.row_devices(_cards(0, 0, 1))
    with pytest.raises(ValueError):
        t_k7.row_devices(["cpu", "cpu"])


def test_mesh_rows_on_cards():
    """Mesh.row_on_cards: a row whose shards each lie on their own CUDA
    device (its collectives then run on NCCL); one device repeated, a
    repeated card or the CPU is not, and its psum sums in shard order."""
    mesh = t_mesh.make_mesh(model=2, data=2, devices=_cards(0, 1, 2, 2))
    assert [mesh.row_on_cards(d) for d in range(2)] == [True, False]
    assert mesh.spans_cards
    cpu = t_mesh.make_mesh(model=2, devices=["cpu"] * 2)
    assert not cpu.row_on_cards(0) and not cpu.spans_cards
    parts = [[torch.full((2, 3), float(j + 1)) for j in range(2)]]
    assert all(torch.equal(t, torch.full((2, 3), 3.0)) for t in cpu.psum(parts)[0])
    g = cpu.all_gather(parts, first_only=True)[0]
    assert g[0].shape == (2, 6) and g[1] is g[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        elif v is not None:
            yield f"{prefix}{k}", np.asarray(v)


def test_two_process_pod_of_two_devices_each(tmp_path):
    """Two gloo processes holding two CPU devices each: pod_mesh(model=
    "slice") = {"data": 2, "model": 2}, the fused and halves bodies on each
    process's model axis, against the JAX forward_step at 3e-4."""
    cfg = RWKVConfig.tiny_test(n_layer=2, n_embd=256, vocab_size=300)
    params = j_m.signedize_params(j_m.pad_vocab(
        j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(0), cfg)), multiple=512))
    tokens = np.asarray([3, 150, 7, 299], np.int32)
    step = jax.jit(j_m.forward_step)
    logits, state = step(params, jnp.asarray(tokens), j_m.init_state(cfg, (4,)))
    want, ids = [np.asarray(logits)], []
    for _ in range(2):
        ids.append(np.argmax(want[-1][:, :cfg.vocab_size], axis=-1).astype(np.int32))
        logits, state = step(params, jnp.asarray(ids[-1]), state)
        want.append(np.asarray(logits))
    want = np.stack(want)
    np.savez(tmp_path / "params.npz",
             **dict(_flatten(dataclasses.asdict(jax.tree.map(np.asarray, params)))))
    np.savez(tmp_path / "ref.npz", tokens=tokens, logits=want, ids=np.stack(ids),
             vocab=cfg.vocab_size)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rwkv_tpu_torch.tools.pod_worker",
         "--params", str(tmp_path / "params.npz"), "--ref", str(tmp_path / "ref.npz"),
         "--coordinator", f"127.0.0.1:{port}", "--processes", "2", "--process-id", str(pid),
         "--backend", "gloo", "--devices", "cpu", "cpu", "--bodies", "fused", "halves",
         "--out", str(tmp_path / f"out{pid}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"POD_WORKER_OK {pid}" in out, out
        rec = json.loads(next(ln for ln in out.splitlines() if ln.startswith("{")))
        assert rec["mesh"] == {"data": 2, "model": 2} and rec["first_row"] == pid
        with np.load(tmp_path / f"out{pid}.npz") as z:
            for body in ("fused", "halves"):
                np.testing.assert_allclose(z[body], want[:, 2 * pid:2 * pid + 2],
                                           rtol=POD_TOL, atol=POD_TOL)

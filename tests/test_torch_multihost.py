"""The port's multi-process helpers (rwkv_tpu_torch/parallel/multihost.py) in
one process: pod_mesh's axis arithmetic against the JAX pod_mesh on the
suite's 8 virtual CPU devices, initialize()'s argument paths, the data-axis
helpers, and a one-process pod mesh's step bit for bit against make_mesh's.

Mirrors tests/test_multihost.py and
tests/test_sharding.py::test_pod_mesh_virtual_devices; the port's meshes
name the CPU several times ([cpu] * n). A failed bootstrap is run in a child
process, so that this process never joins a process group."""

import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from rwkv_tpu.parallel.multihost import pod_mesh as j_pod_mesh
from rwkv_tpu_torch.models.config import RWKVConfig
from rwkv_tpu_torch.models.rwkv4 import init_state, random_quantized_params_np, signedize_params
from rwkv_tpu_torch.parallel import multihost
from rwkv_tpu_torch.parallel.mesh import make_mesh
from rwkv_tpu_torch.parallel.sharding import shard_params
from rwkv_tpu_torch.parallel.tp_step import make_engine_prefill, make_tp_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in multihost.LAUNCHER_ENV}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.fixture()
def two_processes(monkeypatch):
    """This process seen as process 1 of 2 (no process group is joined)."""
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "process_index", lambda: 1)


def test_pod_mesh_slice_default():
    """model='slice' spans the local devices with TP; one process has no
    data axis across processes (8 devices -> 1 x 8), as the JAX pod_mesh."""
    mesh = multihost.pod_mesh(devices=CPU8)
    assert mesh.shape == {"data": 1, "model": 8} == dict(j_pod_mesh().shape)
    assert (mesh.local_rows, mesh.first_row) == (1, 0)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_pod_mesh_explicit_tp(tp):
    mesh = multihost.pod_mesh(model=tp, devices=CPU8)
    assert mesh.shape == {"data": 8 // tp, "model": tp} == dict(j_pod_mesh(model=tp).shape)
    assert mesh.local_rows == 8 // tp
    assert [len(row) for row in mesh.devices] == [tp] * (8 // tp)


def test_pod_mesh_indivisible_tp_raises():
    with pytest.raises(ValueError, match="not divisible"):
        multihost.pod_mesh(model=3, devices=CPU8)


def test_pod_mesh_virtual_devices():
    """tests/test_sharding.py's case: 'slice' puts TP on the local devices,
    explicit ints split TP x DP."""
    mesh = multihost.pod_mesh(devices=CPU8)
    assert mesh.shape["model"] * mesh.shape["data"] == 8
    mesh2 = multihost.pod_mesh(model=4, devices=CPU8)
    assert mesh2.shape["model"] == 4 and mesh2.shape["data"] == 2


def test_pod_mesh_spans_processes(two_processes):
    """Process 1 of 2 with 4 devices: the global shape, this process's row."""
    mesh = multihost.pod_mesh(model=4, devices=[torch.device("cpu")] * 4)
    assert mesh.shape == {"data": 2, "model": 4}
    assert (mesh.local_rows, mesh.first_row) == (1, 1)
    mesh = multihost.pod_mesh(model=2, devices=[torch.device("cpu")] * 4)
    assert mesh.shape == {"data": 4, "model": 2} and (mesh.local_rows, mesh.first_row) == (2, 2)
    # a model axis wider than a process's devices spans processes, in the JAX
    # order: process 1 of 2 holds shards 4..7 of the one row
    mesh = multihost.pod_mesh(model=8, devices=[torch.device("cpu")] * 4)
    assert mesh.shape == {"data": 1, "model": 8} == dict(j_pod_mesh(model=8).shape)
    assert (mesh.local_rows, mesh.first_row, mesh.local_shards, mesh.first_shard) == (1, 0, 4, 4)
    assert mesh.spans_processes
    # a width that neither divides nor is a multiple of the local devices
    with pytest.raises(ValueError, match="neither divides nor is a multiple"):
        multihost.pod_mesh(model=2, devices=[torch.device("cpu")] * 3)


def test_data_axis_helpers(two_processes):
    """local_batch keeps this process's streams (process 1 of 2: the second
    half); with no process group, psum_data sums the local rows, and
    process_allgather and global_batch see this process alone."""
    mesh = multihost.pod_mesh(model=2, devices=[torch.device("cpu")] * 4)  # rows 2, 3 of 4
    x = torch.arange(8)
    assert multihost.local_batch(x, mesh).tolist() == [4, 5, 6, 7]
    st = init_state(RWKVConfig(n_layer=2, n_embd=4, vocab_size=8), (8,))
    got = multihost.local_batch(st, mesh, dim=1)
    assert type(got) is type(st) and got.pp.shape == (2, 4, 4)
    with pytest.raises(ValueError, match="does not split"):
        multihost.local_batch(torch.arange(6), mesh)
    one = torch.tensor([2.0, 3.0])  # this process's two rows
    assert multihost.psum_data(one, mesh).tolist() == [5.0]
    assert multihost.process_allgather(torch.tensor(1.5)).tolist() == [1.5]
    assert torch.equal(multihost.global_batch(x[:4]), x[:4])


def test_initialize_single_process_noop(monkeypatch):
    """Without arguments or a launcher's environment initialize() joins
    nothing: one process."""
    for k in multihost.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0


def test_initialize_explicit_args_failure_raises():
    """Explicit arguments pointing at a dead coordinator raise within the
    given timeout (3 s): never a hang, never single-process serving."""
    code = ("from rwkv_tpu_torch.parallel.multihost import initialize;"
            f"initialize(coordinator_address='127.0.0.1:{_free_port()}', num_processes=2,"
            " process_id=1, backend='gloo', timeout=3)")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], env=_child_env(), capture_output=True,
                       text=True, timeout=120)
    took = time.perf_counter() - t0
    assert r.returncode != 0
    assert "refusing to silently fall back to single-process mode" in r.stderr, r.stderr[-2000:]
    assert took < 60, took  # the 3 s wait plus the child's start, far from torch's minutes


@pytest.mark.parametrize("body", ["plain", "halves", "fused"])
def test_single_process_pod_mesh_step_bit_equal_to_make_mesh(body):
    """A one-process pod mesh is the make_mesh mesh: 2 x 2 over [cpu] * 4,
    its step (3 carried steps, B = 4) and its prefill give the same bits."""
    cfg = RWKVConfig(n_layer=2, n_embd=256, vocab_size=300)
    params = signedize_params(random_quantized_params_np(cfg, seed=3))
    cpu4 = [torch.device("cpu")] * 4
    pod = multihost.pod_mesh(model=2, devices=cpu4)
    ref = make_mesh(model=2, data=2, devices=cpu4)
    assert pod.shape == ref.shape and pod.devices == ref.devices
    assert pod.local_rows == ref.local_rows == 2
    out = []
    for mesh in (pod, ref):
        sp = shard_params(params, mesh)
        step = make_tp_step(mesh, sp, body=body)
        state = init_state(sp.config, (4,))
        got = []
        for tok in ([3, 150, 7, 299], [1, 2, 3, 4], [299, 0, 42, 8]):
            logits, state = step(sp, torch.tensor(tok), state)
            got.append(logits)
        pre = make_engine_prefill(mesh, sp)
        tokens = torch.tensor([[5, 6, 7, 8], [9, 10, 11, 12], [13, 14, 15, 16]])
        lg, st = pre(sp, tokens, init_state(sp.config, (4,)), torch.tensor([3, 2, 3, 1]))
        out.append((got, state, lg, st))
        assert step.body == body
    (g1, s1, p1, t1), (g2, s2, p2, t2) = out
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert torch.equal(p1, p2) and all(torch.equal(a, b) for a, b in zip(t1, t2))


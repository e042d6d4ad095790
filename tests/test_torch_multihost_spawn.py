"""Multi-process DP over a real process boundary for the port
(rwkv_tpu_torch/tools/pod_worker.py); the counterpart of
tests/test_multihost_spawn.py and tests/_mp_worker.py.

Two CPU processes with 4 devices each ([cpu] * 4) join a gloo process group
through rwkv_tpu_torch.parallel.multihost.initialize, build pod_mesh(model=4)
= tp 4 x dp 2 across the processes, and run a psum over the process-spanning
axis, the pod tp_step on each process's 2 of 4 streams, a sampled loop fed
per process and a process_allgather. This test holds each process's logits
against the JAX package's unsharded forward_step at the JAX worker's pin
(rtol = atol = 3e-4), on the JAX worker's params: tiny_test(n_layer=2,
n_embd=256, vocab_size=300), quantized, padded to 512 and signedized, tokens
[3, 150, 7, 299], then 2 greedy steps. The workers import only the port."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.models.rwkv4 import (
    forward_step,
    init_params,
    init_state,
    pad_vocab,
    quantize_params,
    signedize_params,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCHER_ENV}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"  # two workers beside the suite's own
    env.update(extra)
    return env


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        elif v is not None:
            yield f"{prefix}{k}", np.asarray(v)


def _reference(tmp_path):
    """The JAX worker's params and the unsharded logits: the first step on
    the fixed tokens, then 2 steps fed the greedy ids."""
    cfg = RWKVConfig.tiny_test(n_layer=2, n_embd=256, vocab_size=300)
    params = signedize_params(pad_vocab(
        quantize_params(init_params(jax.random.PRNGKey(0), cfg)), multiple=512))
    tokens = np.asarray([3, 150, 7, 299], np.int32)
    step = jax.jit(forward_step)
    logits, state = step(params, jnp.asarray(tokens), init_state(cfg, (4,)))
    all_logits, ids = [np.asarray(logits)], []
    for _ in range(2):
        ids.append(np.argmax(all_logits[-1][:, :cfg.vocab_size], axis=-1).astype(np.int32))
        logits, state = step(params, jnp.asarray(ids[-1]), state)
        all_logits.append(np.asarray(logits))
    np.savez(tmp_path / "params.npz",
             **dict(_flatten(dataclasses.asdict(jax.tree.map(np.asarray, params)))))
    np.savez(tmp_path / "ref.npz", tokens=tokens, logits=np.stack(all_logits),
             ids=np.stack(ids), vocab=cfg.vocab_size)
    return np.stack(all_logits)


def _run_pair(argv_of):
    """Two children, argv_of(pid) each, on one gloo job; their (rc, output)."""
    procs = [subprocess.Popen(argv_of(pid), env=_child_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def test_two_process_pod(tmp_path):
    """2 coordinated processes: bootstrap, pod mesh spanning both, the psum
    over data, the pod tp_step against JAX's forward_step, per-process-fed
    sampling, the allgather."""
    want = _reference(tmp_path)
    port = _free_port()
    runs = _run_pair(lambda pid: [
        sys.executable, "-m", "rwkv_tpu_torch.tools.pod_worker",
        "--params", str(tmp_path / "params.npz"), "--ref", str(tmp_path / "ref.npz"),
        "--coordinator", f"127.0.0.1:{port}", "--processes", "2", "--process-id", str(pid),
        "--backend", "gloo", "--devices", "cpu", "cpu", "cpu", "cpu", "--model", "4",
        "--bodies", "plain", "--out", str(tmp_path / f"out{pid}.npz")])
    recs = []
    for pid, (rc, out) in enumerate(runs):
        assert rc == 0, f"worker {pid} failed:\n{out}"
        assert f"POD_WORKER_OK {pid}" in out, out
        recs.append(json.loads(next(ln for ln in out.splitlines() if ln.startswith("{"))))
        with np.load(tmp_path / f"out{pid}.npz") as z:
            got = z["plain"]
        assert got.shape == (3, 2, 512)
        np.testing.assert_allclose(got, want[:, 2 * pid:2 * pid + 2], rtol=3e-4, atol=3e-4)
    for pid, rec in enumerate(recs):
        assert rec["mesh"] == {"data": 2, "model": 4}, rec
        assert (rec["process"], rec["processes"], rec["backend"]) == (pid, 2, "gloo")
        assert (rec["local_rows"], rec["first_row"]) == (1, pid)
        assert rec["psum"] == [3.0]
    a, b = (r["bodies"]["plain"] for r in recs)
    # both processes saw every process's sampled ids and checksums, in order
    assert a["sampled"] == b["sampled"] and np.asarray(a["sampled"]).shape == (3, 4)
    assert a["checksums"] == b["checksums"] == [a["checksum"], b["checksum"]]


def test_launcher_env_failure_exits_loudly():
    """A launcher's environment (torchrun's MASTER_ADDR/MASTER_PORT/
    WORLD_SIZE/RANK) naming a dead coordinator counts as explicit: initialize
    raises within its timeout, never serves single-process."""
    env = _child_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
                     RANK="1")
    code = ("from rwkv_tpu_torch.parallel.multihost import initialize;"
            "initialize(backend='gloo', timeout=3)")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    took = time.perf_counter() - t0
    assert r.returncode != 0
    assert "refusing to silently fall back to single-process mode" in r.stderr, r.stderr[-2000:]
    assert "the launcher's MASTER_ADDR=127.0.0.1" in r.stderr, r.stderr[-2000:]
    assert took < 60, took


def test_pod_mesh_device_count_mismatch_raises():
    """Processes holding different device counts (4 and 2) would get a wrong
    global shape and overlapping streams: pod_mesh gathers the counts and
    raises in every process."""
    port = _free_port()
    code = ("import sys, torch; from rwkv_tpu_torch.parallel import multihost as mh;"
            f"pid = int(sys.argv[1]); mh.initialize('127.0.0.1:{port}', 2, pid,"
            " backend='gloo', timeout=60)\n"
            "try:\n"
            "    mh.pod_mesh(model=1, devices=[torch.device('cpu')] * (4 - 2 * pid))\n"
            "except ValueError as e:\n"
            "    print('RAISED', e)\n")
    runs = _run_pair(lambda pid: [sys.executable, "-c", code, str(pid)])
    for pid, (rc, out) in enumerate(runs):
        assert rc == 0, f"child {pid} failed:\n{out}"
        assert "RAISED pod_mesh: the processes hold [4, 2] devices" in out, out

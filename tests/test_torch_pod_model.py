"""A model axis across processes (parallel/multihost.py: pod_mesh(model=tp)
with tp wider than a process's devices), on the CPU.

Two gloo processes of rwkv_tpu_torch.tools.pod_worker hold one CPU device
each (pod_mesh(model=2)) or two each (pod_mesh(model=4)): one data row whose
shards lie in both processes. The bodies plain, halves (K6's plain version)
and fused (K7's plain version, its exchanges over the row's group) are held
against the JAX package's make_tp_step on a virtual CPU mesh of the same tp
and against its unsharded forward_step, at the TP pin rtol = atol = 3e-4
(tests/test_tp_step.py's), on tiny_test(n_layer=2, n_embd=128 * tp,
vocab_size=300) quantized, padded to 512 and signedized (n_embd 256 at tp =
2; 512 at tp = 4, where K6 and K7 need E / tp a multiple of 128). Also pinned: 3L +
2 collectives a step in every process (plain, halves), each process holding
only its own shards' bytes, the row's group and its ranks, the engine's
greedy ids and texts over two processes against the JAX engine's on one
.bin, the pool's texts at tau = 0 (up to the JAX engine's first near tie),
and two data rows of two processes each,
each row with its own group. In-process: pod_mesh's arithmetic,
the order in which every process makes the rows' groups, K7's refusals of a
row it cannot run across processes, graphable's rule, and
multihost.shutdown freeing every live CUDA graph before it leaves the group.
4-bit weights run across two processes through the fused body."""

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

from rwkv_tpu.models import rwkv4 as j_m
from rwkv_tpu.models.config import RWKVConfig
from rwkv_tpu.parallel import mesh as j_mesh
from rwkv_tpu.parallel import sharding as j_sh
from rwkv_tpu.parallel import tp_step as j_tp
from rwkv_tpu_torch.io.binfmt import write_bin
from rwkv_tpu_torch.models import rwkv4 as t_m
from rwkv_tpu_torch.ops.cuda import decode_stack_tp as t_k7
from rwkv_tpu_torch.parallel import multihost
from rwkv_tpu_torch.parallel.mesh import Mesh
from rwkv_tpu_torch.runtime.graphs import graphable

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 3e-4  # the TP pin
K7_TOL = 1e-4
TIE = 2e-5  # a typical pick at tau = 0 whose JAX gap is at most this is a near tie
TOKENS = np.asarray([3, 150, 7, 299], np.int32)
L = 2


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


def _job(n, args_of, timeout=150):
    """n pod_worker children on one gloo job; each one's JSON record."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rwkv_tpu_torch.tools.pod_worker",
         "--coordinator", f"127.0.0.1:{port}", "--processes", str(n), "--process-id", str(pid),
         "--backend", "gloo", *args_of(pid)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    recs = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"POD_WORKER_OK {pid}" in out, out[-4000:]
        recs.append(json.loads(next(ln for ln in out.splitlines() if ln.startswith("{"))))
    return recs


def _jax_ref(tmp, tp):
    """The params (n_embd 128 * tp, so that every body runs at this tp), the
    unsharded forward_step's logits on TOKENS then 2 greedy steps, and the
    JAX make_tp_step's logits at this tp fed the same ids."""
    cfg = RWKVConfig.tiny_test(n_layer=L, n_embd=128 * tp, vocab_size=300)
    params = j_m.signedize_params(j_m.pad_vocab(
        j_m.quantize_params(j_m.init_params(jax.random.PRNGKey(0), cfg)), multiple=512))
    step = jax.jit(j_m.forward_step)
    logits, state = step(params, jnp.asarray(TOKENS), j_m.init_state(cfg, (4,)))
    want, ids = [np.asarray(logits)], []
    for _ in range(2):
        ids.append(np.argmax(want[-1][:, :cfg.vocab_size], axis=-1).astype(np.int32))
        logits, state = step(params, jnp.asarray(ids[-1]), state)
        want.append(np.asarray(logits))
    np.savez(tmp / "params.npz",
             **dict(_flatten(dataclasses.asdict(jax.tree.map(np.asarray, params)))))
    np.savez(tmp / "ref.npz", tokens=TOKENS, logits=np.stack(want), ids=np.stack(ids),
             vocab=cfg.vocab_size)
    jmesh = j_mesh.make_mesh(model=tp, data=1)
    tstep = j_tp.make_tp_step(jmesh, params)
    psh = j_sh.shard_params(params, jmesh)
    got = []
    with jax.sharding.set_mesh(jmesh):
        st = j_sh.shard_state(j_m.init_state(cfg, (4,)), jmesh, batched=True)
        for tok in [TOKENS] + ids:
            lg, st = tstep(psh, jnp.asarray(tok, jnp.int32), st)
            got.append(np.asarray(lg))
    return cfg.n_embd, np.stack(want), np.stack(got)


@pytest.mark.parametrize("per,tp", [(1, 2), (2, 4)], ids=["2x1-model2", "2x2-model4"])
def test_model_axis_across_two_processes(tmp_path, per, tp):
    """Each process holds tp / 2 shards of the one row: every body's logits
    against the JAX TP step and forward_step, the collectives a step, the
    bytes each process holds, the row's group, K7's plain version across
    the processes against the fused body's pieces."""
    tmp = tmp_path
    E, want, tp_logits = _jax_ref(tmp, tp)
    recs = _job(2, lambda pid: [
        "--params", str(tmp / "params.npz"), "--ref", str(tmp / "ref.npz"),
        "--devices", *["cpu"] * per, "--model", str(tp), "--bodies", "plain", "halves", "fused",
        "--k7-check", "--out", str(tmp / f"out{tp}_{pid}.npz")])
    for pid, rec in enumerate(recs):
        assert rec["mesh"] == {"data": 1, "model": tp}
        assert (rec["local_rows"], rec["first_row"]) == (1, 0)
        assert (rec["local_shards"], rec["first_shard"]) == (per, per * pid)
        assert rec["group"] == {"backend": "gloo", "ranks": [0, 1]}
        assert rec["psum"] == [1.0]  # the row counted once
        # only this process's shards: a column slice, a vocab slice
        assert rec["att_key_shape"] == [L, E, E // tp]
        assert rec["emb_shape"] == [512 // tp, E] and rec["head_shape"] == [E, 512 // tp]
        with np.load(tmp / f"out{tp}_{pid}.npz") as z:
            for body in ("plain", "halves", "fused"):
                got = z[body]
                assert got.shape == (3, 4, 512)
                np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=body)
                np.testing.assert_allclose(got, tp_logits, rtol=TOL, atol=TOL, err_msg=body)
        for body in ("plain", "halves"):
            r = rec["bodies"][body]
            assert r["collectives"] == {"psum": r["steps"] * (2 * L + 1),
                                        "all_gather": r["steps"] * (L + 1)}, body
        assert rec["bodies"]["fused"]["collectives"] == {"psum": 0, "all_gather": 3}
        assert rec["k7"][0]["max_scaled_err"] <= K7_TOL
    a, b = recs
    assert a["shard_bytes"] == b["shard_bytes"]
    for body in ("plain", "halves", "fused"):
        # one row: both processes fed, drew and gathered the same ids
        assert a["bodies"][body]["sampled"] == b["bodies"][body]["sampled"]
        assert np.asarray(a["bodies"][body]["sampled"]).shape == (3, 4)
    with np.load(tmp / f"out{tp}_0.npz") as z0, np.load(tmp / f"out{tp}_1.npz") as z1:
        for body in ("plain", "halves", "fused"):
            np.testing.assert_array_equal(z0[body], z1[body])


def test_q4_model_axis_across_two_processes(tmp_path):
    """4-bit weights (random:2x256:1:q4, the row-tiled families paired
    inside a shard) across two processes of one CPU device: the fused body
    (K7's plain version, the only body of q4 params) against the unsharded
    step on the whole params at the pin, and K7's plain version against
    itself across the processes within K7_TOL."""
    from rwkv_tpu_torch.parallel.sharding import tp_vocab_multiple
    from rwkv_tpu_torch.tools import pod_worker

    spec = "random:2x256:1:q4"
    whole = pod_worker.random_params(spec, tp_vocab_multiple(2), 2)
    assert whole.att.output.block == 128
    want = pod_worker.write_reference(whole, str(tmp_path / "ref.npz"), torch.device("cpu"))
    recs = _job(2, lambda pid: [
        "--params", spec, "--ref", str(tmp_path / "ref.npz"), "--devices", "cpu",
        "--model", "2", "--bodies", "fused", "--k7-check",
        "--out", str(tmp_path / f"q4_{pid}.npz")])
    for pid, rec in enumerate(recs):
        assert rec["att_key_shape"] == [L, 128, 128]  # this shard's packed columns
        assert rec["k7"][0]["max_scaled_err"] <= K7_TOL
        assert rec["bodies"]["fused"]["max_scaled_err"] <= TOL
        with np.load(tmp_path / f"q4_{pid}.npz") as z:
            np.testing.assert_allclose(z["fused"], want.numpy(), rtol=TOL, atol=TOL)


def test_two_rows_of_two_processes(tmp_path):
    """Four processes of one CPU device, pod_mesh(model=2): two data rows,
    each across two processes, each with its own group (every process made
    both groups, in row order, or the job would hang); each row's streams
    against the JAX forward_step at the pin."""
    _, want, _ = _jax_ref(tmp_path, 2)
    recs = _job(4, lambda pid: [
        "--params", str(tmp_path / "params.npz"), "--ref", str(tmp_path / "ref.npz"),
        "--devices", "cpu", "--model", "2", "--bodies", "halves", "fused",
        "--out", str(tmp_path / f"out{pid}.npz")])
    for pid, rec in enumerate(recs):
        row = pid // 2
        assert rec["mesh"] == {"data": 2, "model": 2}
        assert (rec["first_row"], rec["first_shard"]) == (row, pid % 2)
        assert rec["group"] == {"backend": "gloo", "ranks": [2 * row, 2 * row + 1]}
        assert rec["psum"] == [4.0]  # 1 + 3: processes 0 and 2, each row once
        with np.load(tmp_path / f"out{pid}.npz") as z:
            for body in ("halves", "fused"):
                np.testing.assert_allclose(z[body], want[:, 2 * row:2 * row + 2], rtol=TOL,
                                           atol=TOL, err_msg=body)
    for body in ("halves", "fused"):
        assert all(r["bodies"][body]["sampled"] == recs[0]["bodies"][body]["sampled"]
                   for r in recs)


def _jax_typical0(jeng, prompt, n, V):
    """The JAX engine's generate(prompt, n tokens) at tau = 0, step by step:
    typical keeps the one token whose -log p lies nearest the entropy (token
    0 banned, as generate bans it). Returns (the text emitted before the
    first step whose gap from the nearest token to the next, over max(1,
    max |logits|), is at most TIE, or the whole text if no step's is; the
    tokens that text covers)."""
    from rwkv_tpu.tokenizer.bpe import StreamDecoder

    jeng.reset_state()
    jeng.forward(jeng.tokenizer.encode(prompt))
    dec, pieces = StreamDecoder(jeng.tokenizer), []
    for i in range(n):
        lg = np.asarray(jeng._last_logits[0], np.float64)[:V]
        lg[0] = -1e9
        logp = lg - (lg.max() + np.log(np.exp(lg - lg.max()).sum()))
        shifted = np.abs(-logp + (np.exp(logp) * logp).sum())
        near = np.partition(shifted, 1)[:2]
        if (near[1] - near[0]) / max(1.0, np.abs(lg[1:]).max()) <= TIE:
            return "".join(pieces), i
        tok = int(np.argmin(shifted))
        pieces.append(dec.feed([tok]))
        if i + 1 < n:
            jeng.forward(tok)
    return "".join(pieces) + dec.flush(), n


def test_engine_and_pool_across_two_processes(tmp_path):
    """RWKV(path, sharding=pod_mesh(model=2)) in two processes of one CPU
    device each: the logits after a prompt and greedy steps against the JAX
    engine's on the same .bin at the pin, and its greedy ids; its generate
    texts at tau = 0 and an 8-slot pool's texts the same in both processes,
    equal to one process's run of the same calls on a mesh of its own two
    devices, and equal to the JAX engine's up to its first near tie (on the
    CPU typical's pick at tau = 0 among 50k random logits turns on rounding
    at the 1e-6 level: a pick is compared where JAX's gap exceeds TIE, at
    least 4 times the port's measured logits error); get_state refuses the
    state that spans the processes."""
    from rwkv_tpu.runtime.engine import RWKV as JRWKV
    from rwkv_tpu_torch.tools import pod_worker

    path = str(tmp_path / "m.bin")
    write_bin(path, t_m.random_quantized_params_np(RWKVConfig(n_layer=2, n_embd=256), seed=5,
                                                   pad_multiple=None))
    jeng = JRWKV()
    jeng.load_file(path)
    jeng.load_tokenizer(native=False)
    V = 50277
    ref, jids = {"vocab": V}, []
    for i, prompt in enumerate(pod_worker.PROMPTS):
        jeng.reset_state()
        jeng.load_context(prompt)
        traj = [np.asarray(jeng._last_logits[0])[:V]]
        for _ in range(pod_worker.ENGINE_STEPS):
            jeng.forward(int(np.argmax(traj[-1])))
            traj.append(np.asarray(jeng._last_logits[0])[:V])
        ref[f"logits{i}"] = np.stack(traj)
        jids.append([int(np.argmax(t)) for t in traj[:-1]])
    np.savez(tmp_path / "eng_ref.npz", **ref)
    n_gen = pod_worker.GENERATE_TOKENS
    lengths = [n_gen] * len(pod_worker.PROMPTS) + [n for _, n, _, _ in pod_worker.pool_requests()]
    agreed = [_jax_typical0(jeng, p, n, V) for p, n in zip(
        list(pod_worker.PROMPTS) + [p for p, _, _, _ in pod_worker.pool_requests()], lengths)]
    for i, prompt in enumerate(pod_worker.PROMPTS):  # the steps above are JAX's generate
        jeng.reset_state()
        text = jeng.generate(prompt, max_tokens=n_gen, temp=1.0, tau=0.0, seed=i)
        prefix, k = agreed[i]
        assert text.startswith(prefix) and (k < n_gen or text == prefix)
    assert sum(k for _, k in agreed) >= sum(lengths) // 8  # the rule leaves picks to compare
    args = ["--params", path, "--engine-ref", str(tmp_path / "eng_ref.npz"), "--model", "2",
            "--bodies"]
    recs = _job(2, lambda pid: args + ["--devices", "cpu"], timeout=240)
    one = _job(1, lambda pid: args + ["--devices", "cpu", "cpu"], timeout=240)[0]["engine"]
    for rec in recs:
        e = rec["engine"]
        assert e["body"] == "halves" and not e["graphed"]
        assert e["max_scaled_err"] <= TOL
        assert e["greedy_ids"] == jids
        assert "spans processes" in e["get_state_refused"]
        assert (e["texts"], e["pool_texts"]) == (one["texts"], one["pool_texts"])
        assert 4 * e["max_scaled_err"] <= TIE
        for text, n, (prefix, k) in zip(e["texts"] + e["pool_texts"], lengths, agreed):
            assert text.startswith(prefix) and (k < n or text == prefix), (text, prefix)
    assert one["get_state_refused"] is None and one["greedy_ids"] == jids


def test_pod_mesh_model_axis_arithmetic(monkeypatch):
    """pod_mesh(model=tp) over 4 processes of 2 devices, against the JAX
    order (row d = global devices d*tp .. (d+1)*tp - 1): each process's row,
    shards and data rows; local_batch and global_batch over rows."""
    cpu2 = [torch.device("cpu")] * 2
    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    for pid in range(4):
        monkeypatch.setattr(multihost, "process_index", lambda pid=pid: pid)
        m = multihost.pod_mesh(model=4, devices=cpu2)
        assert m.shape == {"data": 2, "model": 4}
        assert (m.local_rows, m.first_row) == (1, pid // 2)
        assert (m.local_shards, m.first_shard) == (2, 2 * (pid % 2))
        assert m.spans_processes and m.model_group is None  # no process group joined
        x = torch.arange(8)
        assert multihost.local_batch(x, m).tolist() == list(range(4 * (pid // 2),
                                                                4 * (pid // 2) + 4))
        m8 = multihost.pod_mesh(model=8, devices=cpu2)
        assert m8.shape == {"data": 1, "model": 8} and m8.first_shard == 2 * pid
        whole = multihost.pod_mesh(model=2, devices=cpu2)
        assert not whole.spans_processes and whole.first_row == pid
    with pytest.raises(ValueError, match="neither divides nor is a multiple"):
        multihost.pod_mesh(model=2, devices=[torch.device("cpu")] * 3)
    with pytest.raises(RuntimeError, match="no model_group"):
        m.psum([[torch.ones(2), torch.ones(2)]])


def test_row_groups_made_in_the_same_order_everywhere(monkeypatch):
    """Every process makes every row's group, in row order, with the same
    arguments (new_group is a collective of the whole job): 8 processes of
    one device at tp = 4, two rows; the backend is gloo on the CPU and where
    two processes of a row share a card, NCCL between distinct cards."""
    calls = {}
    for me in range(8):
        made = []
        monkeypatch.setattr(torch.distributed, "new_group",
                            lambda ranks, backend, made=made: made.append((ranks, backend))
                            or tuple(ranks))
        cards = [[("h", "cpu", None, "")] for _ in range(8)]
        assert multihost.row_groups(2, 4, cards, me) == tuple(range(4 * (me // 4),
                                                                   4 * (me // 4) + 4))
        calls[me] = made
    assert all(c == calls[0] for c in calls.values())
    assert calls[0] == [([0, 1, 2, 3], "gloo"), ([4, 5, 6, 7], "gloo")]
    distinct = [("h", "cuda", i, f"u{i}") for i in range(4)]
    assert multihost.row_backend(distinct) == "nccl"
    assert multihost.row_backend(distinct[:3] + [distinct[0]]) == "gloo"


def _row(cards, shards=1, first=0):
    dev = torch.device("cpu")
    return Mesh([[dev] * shards], data=1, model=len(cards) * shards, first_shard=first,
                model_group=object(), row_cards=cards)


def test_k7_refuses_rows_it_cannot_run_across_processes(monkeypatch):
    """process_row_problem, the same answer in every process: processes
    sharing a card, a row across hosts, a pair without peer access, several
    shards in a process, the CPU; a row of one card a process with peer
    access runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    peer = {"ok": True}
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: peer["ok"] or {a, b} != {1, 2})
    cards = [("h", "cuda", i, f"u{i}") for i in range(4)]
    assert t_k7.process_row_problem(_row(cards)) is None
    shared = cards[:3] + [("h", "cuda", 0, "u0")]
    kind, msg = t_k7.process_row_problem(_row(shared))
    assert kind is ValueError and "share one card" in msg and "cuda:0" in msg
    kind, msg = t_k7.process_row_problem(
        _row(cards[:2] + [("g", "cuda", 2, "v2"), ("g", "cuda", 3, "v3")]))
    assert kind is ValueError and "do not cross hosts" in msg
    peer["ok"] = False
    kind, msg = t_k7.process_row_problem(_row(cards))
    assert kind is RuntimeError and "cuda:1 cannot access cuda:2" in msg
    kind, msg = t_k7.process_row_problem(_row(cards[:2], shards=2))
    assert "one shard a process" in msg
    kind, msg = t_k7.process_row_problem(_row([("h", "cpu", None, "")] * 2))
    assert "CUDA devices" in msg


def test_one_cuda_device_rule(monkeypatch):
    """A mesh is graphed where this process's shards all lie on CUDA
    devices (one card, or several captured as one graph) and, for a row
    across processes, its group is NCCL."""
    assert graphable(None)
    cpu = Mesh([["cpu"] * 2])
    assert not graphable(cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    card = torch.device("cuda", 0)
    assert graphable(Mesh([[card] * 2]))
    assert graphable(Mesh([[card, torch.device("cuda", 1)]]))
    backend = {}
    monkeypatch.setattr(torch.distributed, "get_backend", lambda g: backend[g])
    for name, want in (("nccl", True), ("gloo", False)):
        backend[name] = name
        m = Mesh([[card]], data=1, model=2, first_shard=1, model_group=name)
        assert graphable(m) is want
    assert not graphable(Mesh([[card]], data=1, model=2, first_shard=0))


def test_shutdown_frees_held_graphs_before_leaving_the_group(monkeypatch):
    """multihost.shutdown frees the captures of every live Graphs, though
    an engine or a pool still holds it (NCCL destroys a communicator only
    once the graphs that captured its collectives are gone), then releases
    K7's regions, then destroys the group; the Graphs is left empty, to
    capture anew."""
    import types

    from rwkv_tpu_torch.runtime import graphs

    order = []
    held = graphs.Graphs()
    held._graphs[("step", 1)] = types.SimpleNamespace(
        device=torch.device("cpu"), cards=(),
        graph=types.SimpleNamespace(reset=lambda: order.append("graph freed")))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: order.append("synced"))
    monkeypatch.setattr(t_k7, "release_ipc", lambda: order.append("regions released"))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "destroy_process_group",
                        lambda: order.append("group destroyed"))
    multihost.shutdown()
    assert order == ["synced", "graph freed", "regions released", "group destroyed"]
    assert len(held) == 0


"""Multi-process serving on torch.distributed (counterpart of
rwkv_tpu/parallel/multihost.py).

Topology, as in the JAX module: the model axis takes `model` consecutive
devices of the global device list (every process's devices in process
order), the data axis the rest. A TP width that divides a process's device
count keeps each row inside a process, on its local devices, where the
mesh's collectives run (parallel/mesh.py); independent streams then scale
across processes as pure data parallelism. A TP width that is a multiple of
a process's device count makes each row span tp / n_local consecutive
processes, as the JAX pod_mesh does when its model axis is wider than a
process's devices: the row's shards then lie in several processes and the
mesh's collectives run over a torch.distributed group of them (one process
per card is how a multi-GPU host is launched: torchrun --nproc-per-node).
The RWKV state is O(5·L·E) per stream, so there is no KV cache to move
between processes.

Usage in each process of a job:

    from rwkv_tpu_torch.parallel.multihost import initialize, pod_mesh
    initialize()                      # torchrun's environment, or explicit args
    mesh = pod_mesh(model="slice")    # TP on the local devices, DP across processes
    mesh = pod_mesh(model=4)          # one card a process: a row spans 4 processes

A decode step over the pod mesh (parallel/tp_step.py) takes this process's
streams: local_batch cuts a global [B] batch (tokens, or a WKVState's [L, B,
E] leaves on dim 1) to them, global_batch joins every process's back. The
JAX caller takes its data-axis calls from jax.experimental.multihost_utils
and shard_map; the port has no such library, so they live here:
process_index, process_count, psum_data (a psum over 'data'),
process_allgather, local_batch and global_batch. None of them runs inside a
decode step, so none sits in a captured CUDA graph.

A process may hold several cards (pod_mesh(model="slice") over them): its
rows' model axis then runs across those cards (kernel K7's peer stores, or
the mesh's collectives). With one card a process and pod_mesh(model=tp),
the row's processes exchange inside the step: kernel K7 through peer
memory opened by CUDA IPC, the other bodies through the row's NCCL group,
whose collectives a captured CUDA graph holds (runtime/graphs.py). Under a
launcher, a process of k cards takes cuda:k*LOCAL_RANK .. cuda:k*LOCAL_RANK
+ k - 1 (local_devices).

Backends: "nccl" where CUDA is available, else "gloo", or the caller's
choice. Between processes on distinct cards psum_data and process_allgather
run on NCCL with CUDA tensors, on the process's first card. Processes that
share one card use "gloo": NCCL refuses two ranks on one device. Gloo's
all_gather takes CPU tensors only, so on gloo these helpers copy a CUDA
tensor to the host for the exchange and the result back to its device; such
results are small (per-stream ids, logits, checksums), and decode itself
stays on the card.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from rwkv_tpu_torch.parallel.mesh import Mesh, canonical

# the variables a launcher such as torchrun sets for env:// rendezvous
LAUNCHER_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)  # JAX's default initialization_timeout


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout: "datetime.timedelta | float" = DEFAULT_TIMEOUT,
) -> None:
    """Bootstrap torch.distributed.

    coordinator_address: "host:port" of process 0's store (tcp://), with
    num_processes and process_id. Without them, a launcher's environment
    (MASTER_ADDR, WORLD_SIZE, RANK, as torchrun sets them) is read through
    env://; with neither, nothing happens and the run is one process.
    backend: None picks "nccl" when CUDA is available and "gloo" otherwise;
    pass "gloo" for processes that share one card. timeout (a timedelta or
    seconds): how long the bootstrap, and later each collective, may wait.

    Failure policy, the JAX module's: with explicit arguments, or a
    launcher's environment, a failed bootstrap raises RuntimeError within
    `timeout`: a job whose coordinator is misconfigured must not silently
    degrade to single-process serving (each process would serve its own
    copy). No backend is swapped for another on failure. Already initialized:
    returns."""
    if dist.is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not any(k in os.environ for k in LAUNCHER_ENV):
        return  # one process, no launcher: nothing to join
    if not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    try:
        if explicit:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=num_processes, rank=process_id, timeout=timeout)
        else:
            dist.init_process_group(backend, init_method="env://", timeout=timeout)
    except (RuntimeError, ValueError) as e:  # DistNetworkError and DistError are RuntimeErrors
        where = (f"coordinator={coordinator_address}, num_processes={num_processes}, "
                 f"process_id={process_id}" if explicit else
                 "the launcher's " + ", ".join(f"{k}={os.environ.get(k)}" for k in LAUNCHER_ENV))
        raise RuntimeError(
            f"torch.distributed bootstrap ({backend}) failed with {where}; refusing to "
            f"silently fall back to single-process mode") from e


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _card_info(dev: torch.device) -> tuple:
    """(host, device type, index, uuid) of a local device."""
    uuid = ""
    if dev.type == "cuda":
        uuid = str(getattr(torch.cuda.get_device_properties(dev), "uuid", dev.index))
    return socket.gethostname(), dev.type, dev.index, uuid


def _gather_cards(local: list) -> list:
    """Every process's [_card_info per local device], in process order (a
    collective; one process: its own)."""
    mine = [_card_info(d) for d in local]
    if not dist.is_initialized():
        return [mine]
    got: list = [None] * dist.get_world_size()
    if local[0].type == "cuda":
        with torch.cuda.device(local[0]):  # all_gather_object's tensors on this card
            dist.all_gather_object(got, mine)
    else:
        dist.all_gather_object(got, mine)
    return got


def row_backend(cards: Sequence) -> str:
    """The backend of a row's process group: NCCL between distinct cards,
    gloo on the CPU or where two processes of the row share a card (NCCL
    refuses two ranks on one device)."""
    if any(c[1] != "cuda" for c in cards):
        return "gloo"
    keys = [(c[0], c[3]) for c in cards]
    return "gloo" if len(set(keys)) != len(keys) else "nccl"


def row_groups(rows: int, per_row: int, cards: Sequence, me: int):
    """One torch.distributed group per data row of processes r*per_row ..
    (r+1)*per_row - 1, made in row order: every process makes every row's
    group, in the same order, or the job hangs (new_group is a collective
    of the whole job). cards: each process's gathered devices. Returns
    this process's row's group."""
    mine = None
    for r in range(rows):
        ranks = list(range(r * per_row, (r + 1) * per_row))
        g = dist.new_group(ranks, backend=row_backend([c for p in ranks for c in cards[p]]))
        if me in ranks:
            mine = g
    return mine


def pod_mesh(model: "int | str" = "slice", devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') mesh over every process's devices.

    devices: this process's local devices (default: every visible CUDA
    device; the CPU tests pass [torch.device("cpu")] * n). Every process
    must hold as many: in a process group every process's devices are
    gathered (a collective, so every process calls pod_mesh) and a count
    that differs raises ValueError. model="slice": the model axis spans the
    local devices; an int: that TP width, which must divide the local
    device count (rows inside a process) or be a multiple of it (each row
    spans tp / n_local consecutive processes, with its model_group: every
    process then makes every row's group, in row order). The data axis
    takes the rest, across processes; the mesh's shape is the global one,
    its rows and shards this process's."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("pod_mesh: this host has no CUDA device; pass devices=[...] "
                               "(for example [torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [canonical(d) for d in devices]
    n_local, procs, pid = len(local), process_count(), process_index()
    cards = _gather_cards(local)
    counts = [len(c) for c in cards]
    if dist.is_initialized() and any(c != n_local for c in counts):
        raise ValueError(f"pod_mesh: the processes hold {counts} devices; a pod "
                         f"mesh needs the same count in every process")
    n_total = procs * n_local
    tp = n_local if model == "slice" else int(model)
    if tp < 1 or n_total % tp:
        raise ValueError(f"{n_total} devices not divisible by model={tp}")
    if n_local % tp == 0:
        rows = n_local // tp
        return Mesh([local[d * tp:(d + 1) * tp] for d in range(rows)], data=n_total // tp,
                    first_row=pid * rows)
    if tp % n_local:
        raise ValueError(
            f"model={tp} neither divides nor is a multiple of this process's {n_local} "
            f"devices: a row must lie inside one process or span whole processes (the JAX "
            f"order: row d is the global devices d*tp .. (d+1)*tp - 1)")
    per_row = tp // n_local
    row = pid // per_row
    group, row_cards = None, None
    if dist.is_initialized():
        group = row_groups(n_total // tp, per_row, cards, pid)
        row_cards = [c for p in range(row * per_row, (row + 1) * per_row) for c in cards[p]]
    return Mesh([local], data=n_total // tp, first_row=row, model=tp,
                first_shard=(pid % per_row) * n_local, model_group=group, row_cards=row_cards)


def shutdown() -> None:
    """Leave the job: every CUDA graph of the port freed (graphs.release_all:
    NCCL destroys a communicator only once the graphs that captured its
    collectives are gone, whether or not an engine, a pool or a step still
    holds them), K7's peer regions across processes closed and freed
    (decode_stack_tp.release_ipc, a collective of each row's processes),
    then the process group destroyed. Every process calls it, after its
    last step; the engines, pools and steps of the group must not run
    again. Nothing in one process: a no-op."""
    if not dist.is_initialized():
        return
    from rwkv_tpu_torch.ops.cuda import decode_stack_tp
    from rwkv_tpu_torch.runtime import graphs

    graphs.release_all()
    decode_stack_tp.release_ipc()
    dist.destroy_process_group()


def local_devices(cards: int = 1) -> list:
    """This process's cards under a launcher: cards per process from
    cuda:cards*LOCAL_RANK on (LOCAL_RANK 0 without a launcher)."""
    rank = int(os.environ.get("LOCAL_RANK", "0"))
    return [torch.device("cuda", cards * rank + k) for k in range(cards)]


def local_batch(x, mesh: Mesh, dim: int = 0):
    """This process's streams of a global batch: x's `dim` (of every tensor,
    for a tuple such as a WKVState) cut over the data rows, this process's
    rows kept."""
    if isinstance(x, tuple):
        return type(x)(*(local_batch(t, mesh, dim) for t in x))
    B, nd = x.shape[dim], mesh.shape["data"]
    if B % nd:
        raise ValueError(f"batch {B} does not split over data={nd}")
    per = B // nd
    return x.narrow(dim, mesh.first_row * per, mesh.local_rows * per)


def _host_if_gloo(x: torch.Tensor) -> torch.Tensor:
    """x where the backend can exchange it: gloo takes CPU tensors."""
    if dist.get_backend() == "gloo" and x.device.type != "cpu":
        return x.cpu()
    return x.contiguous()


def process_allgather(x: torch.Tensor) -> torch.Tensor:
    """[process_count, *x.shape]: every process's x, stacked in process
    order, on x's device (through the host on gloo)."""
    if not dist.is_initialized():
        return x[None]
    xs = _host_if_gloo(x)
    parts = [torch.empty_like(xs) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, xs)
    return torch.stack(parts).to(x.device)


def global_batch(x, dim: int = 0, mesh: Optional[Mesh] = None):
    """The inverse of local_batch: every data row's streams joined along
    `dim` in process order, which is the data rows' order (of every tensor,
    for a tuple). mesh: a pod mesh whose rows span processes, whose every
    row's processes hold the same streams: each row's first process's are
    taken (a collective all the same: every process calls it)."""
    if isinstance(x, tuple):
        return type(x)(*(global_batch(t, dim, mesh) for t in x))
    parts = list(process_allgather(x).unbind(0))
    if mesh is not None and mesh.spans_processes:
        parts = parts[::mesh.shape["model"] // mesh.local_shards]
    return torch.cat(parts, dim=dim)


def psum_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A psum over the 'data' axis: x is this process's block of a batch
    split over the data rows (its dim 0 over the local rows); the result is
    the sum of every data row's block, the same in every process, on x's
    device (through the host on gloo). Where a row spans processes, its
    first process's block counts, once."""
    rows = torch.chunk(x, mesh.local_rows, 0)
    s = rows[0]
    for r in rows[1:]:
        s = s + r
    if mesh.first_shard:
        s = torch.zeros_like(s)
    if not dist.is_initialized():
        return s
    ss = _host_if_gloo(s)
    if ss is s:
        ss = s.clone()  # all_reduce writes in place; x may be a view
    dist.all_reduce(ss, op=dist.ReduceOp.SUM)
    return ss.to(x.device)

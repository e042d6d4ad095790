"""Multi-process serving on torch.distributed (counterpart of
rwkv_tpu/parallel/multihost.py).

Topology doctrine, as in the JAX module: tensor parallelism stays inside one
process, on its local devices, where the mesh's collectives run
(parallel/mesh.py); independent streams scale across processes as pure data
parallelism. The RWKV state is O(5·L·E) per stream, so there is no KV cache
to move between processes.

Usage in each process of a job:

    from rwkv_tpu_torch.parallel.multihost import initialize, pod_mesh
    initialize()                      # torchrun's environment, or explicit args
    mesh = pod_mesh(model="slice")    # TP on the local devices, DP across processes

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
the mesh's collectives), and only the data axis crosses processes. Under a
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


def pod_mesh(model: "int | str" = "slice", devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') mesh over every process's devices.

    devices: this process's local devices (default: every visible CUDA
    device; the CPU tests pass [torch.device("cpu")] * n). Every process
    must hold as many: in a process group the counts are gathered (a
    collective, so every process calls pod_mesh) and a mismatch raises
    ValueError. model="slice": the model axis spans the local devices;
    an int: that TP width. The data axis takes the rest, across processes;
    the mesh's shape is the global one, its rows this process's."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("pod_mesh: this host has no CUDA device; pass devices=[...] "
                               "(for example [torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [canonical(d) for d in devices]
    n_local, procs = len(local), process_count()
    if dist.is_initialized():  # every process must hold as many devices
        counts = process_allgather(torch.tensor([n_local], device=local[0])).reshape(-1)
        if not torch.all(counts == n_local):
            raise ValueError(f"pod_mesh: the processes hold {counts.tolist()} devices; a pod "
                             f"mesh needs the same count in every process")
    n_total = procs * n_local
    tp = n_local if model == "slice" else int(model)
    if tp < 1 or n_total % tp:
        raise ValueError(f"{n_total} devices not divisible by model={tp}")
    if n_local % tp:
        raise ValueError(
            f"model={tp} is wider than, or does not divide, this process's {n_local} "
            f"devices: the model axis stays inside a process (the JAX doctrine keeps tensor "
            f"parallelism inside a host); a model axis across processes is not built "
            f"(ROADMAP.md, queue 1): give each process the cards of its model shards")
    rows = n_local // tp
    return Mesh([local[d * tp:(d + 1) * tp] for d in range(rows)], data=n_total // tp,
                first_row=process_index() * rows)


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


def global_batch(x, dim: int = 0):
    """The inverse of local_batch: every process's streams joined along
    `dim` in process order, which is the data rows' order (of every tensor,
    for a tuple)."""
    if isinstance(x, tuple):
        return type(x)(*(global_batch(t, dim) for t in x))
    parts = process_allgather(x)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def psum_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A psum over the 'data' axis: x is this process's block of a batch
    split over the data rows (its dim 0 over the local rows); the result is
    the sum of every data row's block, the same in every process, on x's
    device (through the host on gloo)."""
    rows = torch.chunk(x, mesh.local_rows, 0)
    s = rows[0]
    for r in rows[1:]:
        s = s + r
    if not dist.is_initialized():
        return s
    ss = _host_if_gloo(s)
    if ss is s:
        ss = s.clone()  # all_reduce writes in place; x may be a view
    dist.all_reduce(ss, op=dist.ReduceOp.SUM)
    return ss.to(x.device)

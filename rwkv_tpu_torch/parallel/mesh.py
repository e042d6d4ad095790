"""Device mesh for tensor- and data-parallel decode (counterpart of
rwkv_tpu/parallel/mesh.py).

A Mesh is a [data, model] grid of torch devices:

  'data'  independent streams: the batch is split over the data rows;
  'model' tensor parallelism: every quantized matmul's contracted or output
          dim is split over the model shards of a row (parallel/sharding.py).

A device may appear more than once. make_mesh(model=4, devices=[cuda] * 4) is
a virtual mesh: one card runs the four shards' real sharded shapes in turn,
as the JAX tests run their meshes on virtual CPU devices. On the CPU the tests
use [torch.device("cpu")] * n.

Within a process the design is single-controller, as JAX's shard_map is:
the process drives every shard of its rows, and the mesh owns the two
collectives of the tensor-parallel schedule (parallel/tp_step.py), each over
the model shards of every local data row at once:

  psum(parts)        parts[d][j] summed over j in the fixed order 0..tp-1 on
                     shard 0's device, then placed on each shard's device;
  all_gather(parts)  parts[d][j] concatenated over j along `dim`.

It counts them in `collectives`, so tests can pin the 3L + 2 schedule.

A data row whose shards each lie on their own GPU (`row_on_cards`: four
H100s of one host at tp = 4) runs its collectives between the cards as
NCCL's single-process collectives (torch.cuda.nccl, one communicator per
row's cards). NCCL's sum order is its own, so the bodies over cards hold the
TP pin (3e-4), not the one-device bits. On four H100s one psum of [1, 5120]
took 0.040-0.065 ms by NCCL and 0.136-0.206 ms by device copies summed in
shard order on shard 0's card (PERF.md, section 5, tools/tp_cards.py), so
the copies are not kept as a choice. Each card's NCCL call goes on that
card's current stream and its output is allocated there: inside a capture
across the cards (runtime/graphs.py) that is the card's stream forked from
the capturing one and the graph's memory pool, so the collectives land in
the graph; the communicators are made at the warm-up call, before any
capture. On one device, or on the CPU, the collectives are the plain sums
above.

Across processes (parallel/multihost.py: pod_mesh) the mesh is the
process's part of the JAX pod mesh: `shape` is the global {"data": rows of
every process, "model": tp}, while `devices` holds this process's
`local_rows` rows, global rows first_row .. first_row + local_rows - 1, and
of each row this process's `local_shards` shards, global shards
first_shard .. first_shard + local_shards - 1 (which process this is,
torch.distributed says: multihost.process_index()). A process holding tp
devices or a multiple of tp holds whole rows (local_shards == tp,
first_shard == 0), and its rows' model axis runs across its own devices. A
row wider than a process's devices spans tp / local_shards consecutive
processes (the JAX order: row d is the global devices d*tp .. (d+1)*tp - 1),
and the mesh then holds the row's `model_group`, a torch.distributed group
of those processes: psum and all_gather first sum or gather this process's
shards, then run dist.all_reduce / all_gather over the group (NCCL between
cards, gloo where the processes share a card or run on the CPU). NCCL's and
gloo's sum orders are their own, so such a row holds the TP pin (3e-4).
`row_cards` lists, per global shard of such a row, its process's host and
card ((host, device type, index, uuid), gathered by pod_mesh), from which
kernel K7 across processes decides whether it can run the row. A mesh of
one process has local_rows == shape["data"], first_row == 0, local_shards
== shape["model"] and no model_group.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def canonical(device) -> torch.device:
    """torch.device(device), with a CUDA device's index filled in."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for and this host has none")
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A [data, model] grid of devices, and its collectives.

    devices: this process's [data][model] rows (of each row its own
    shards). data: the data rows of every process (default: this
    process's, a one-process mesh); first_row: the global index of this
    process's first row. model: the row's global width (default: the
    shards given); first_shard: the global index of this process's first
    shard; model_group: the torch.distributed group of a row's processes,
    for a row that spans processes; row_cards: its shards' (host, device
    type, index, uuid), as pod_mesh gathers them."""

    def __init__(self, devices: Sequence[Sequence], *, data: Optional[int] = None,
                 first_row: int = 0, model: Optional[int] = None, first_shard: int = 0,
                 model_group=None, row_cards: Optional[Sequence] = None):
        grid = [[canonical(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh needs a non-empty rectangular [data][model] grid of devices")
        data = len(grid) if data is None else data
        if first_row < 0 or first_row + len(grid) > data:
            raise ValueError(f"local rows {first_row}..{first_row + len(grid) - 1} lie outside "
                             f"the mesh's {data} data rows")
        n = len(grid[0])
        model = n if model is None else model
        if model % n or first_shard % n or not 0 <= first_shard < model:
            raise ValueError(f"local shards {first_shard}..{first_shard + n - 1} are not a "
                             f"block of the row's {model} shards")
        if n < model and len(grid) != 1:
            raise ValueError("a process holding part of a row holds one row")
        self.devices = grid
        self.shape = {"data": data, "model": model}
        self.local_rows = len(grid)
        self.first_row = first_row
        self.local_shards = n
        self.first_shard = first_shard
        self.model_group = model_group
        self.row_cards = None if row_cards is None else list(row_cards)
        self.collectives = {"psum": 0, "all_gather": 0}

    @property
    def spans_processes(self) -> bool:
        """Whether this process holds only part of its row's shards."""
        return self.local_shards < self.shape["model"]

    def row_on_cards(self, d: int) -> bool:
        """Whether data row d's local shards each lie on their own CUDA device."""
        row = self.devices[d]
        return (len(row) > 1 and len(set(row)) == len(row)
                and all(dev.type == "cuda" for dev in row))

    @property
    def spans_cards(self) -> bool:
        """Whether any data row runs its model axis across distinct cards."""
        return any(self.row_on_cards(d) for d in range(self.local_rows))

    @property
    def first_device(self) -> torch.device:
        return self.devices[0][0]

    def reset_collectives(self) -> None:
        for k in self.collectives:
            self.collectives[k] = 0

    def _group(self):
        """The row's process group, for a row that spans processes."""
        if self.model_group is None:
            raise RuntimeError("this mesh's row spans processes and has no model_group: build "
                               "it with multihost.pod_mesh inside a process group")
        return self.model_group

    def _on_backend(self, t: torch.Tensor) -> torch.Tensor:
        """t where the row's group can exchange it: gloo takes CPU tensors."""
        import torch.distributed as dist

        if dist.get_backend(self._group()) == "gloo" and t.device.type != "cpu":
            return t.cpu()
        return t.contiguous()

    def group_sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the row's processes (the identity within a
        process), on t's device."""
        if not self.spans_processes:
            return t
        import torch.distributed as dist

        x = self._on_backend(t)
        if x is t:
            x = t.clone()  # all_reduce writes in place
        dist.all_reduce(x, group=self._group())
        return x.to(t.device)

    def group_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every process's t of the row, concatenated along dim in shard
        order (the identity within a process), on t's device."""
        if not self.spans_processes:
            return t
        import torch.distributed as dist

        group = self._group()
        x = self._on_backend(t)
        n = dist.get_world_size(group)
        if x.device.type == "cuda":
            out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x, group=group)
            parts = out.unbind(0)
        else:
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)
        return torch.cat(list(parts), dim=dim).to(t.device)

    def group_broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """t as the row's shard-0 process holds it, in every process of the
        row (the identity within a process): sampled ids, so that every
        process feeds the same token."""
        if not self.spans_processes:
            return t
        import torch.distributed as dist

        group = self._group()
        x = self._on_backend(t)
        if x is t:
            x = t.clone()
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
        return x.to(t.device)

    def psum(self, parts):
        """[data][model] grid of tensors -> the grid of their sums over the
        model shards of each data row: in the fixed order 0..tp-1, or, for a
        row across cards, NCCL's all-reduce; for a row across processes,
        this process's shards first, then the group's all-reduce."""
        self.collectives["psum"] += 1
        out = []
        for d, (row, devs) in enumerate(zip(parts, self.devices)):
            if self.row_on_cards(d) and not self.spans_processes:
                from torch.cuda import nccl

                ins = [p.contiguous() for p in row]
                outs = [torch.empty_like(p) for p in ins]
                nccl.all_reduce(ins, outs)
                out.append(outs)
                continue
            s = row[0]
            for p in row[1:]:
                s = s + p.to(devs[0])
            s = self.group_sum(s)
            out.append([s.to(dev) for dev in devs])
        return out

    def all_gather(self, parts, dim: int = -1, first_only: bool = False):
        """[data][model] grid of tensors -> the grid of their concatenations
        over the model shards of each data row, along `dim` (for a row
        across processes, this process's shards first, then the group's
        gather). first_only: the concatenation is made on each row's shard 0
        only (the others' entries are that tensor too), for a caller that
        reads only shard 0's."""
        self.collectives["all_gather"] += 1
        out = []
        for d, (row, devs) in enumerate(zip(parts, self.devices)):
            if self.row_on_cards(d) and not self.spans_processes:
                from torch.cuda import nccl

                ins = [p.contiguous() for p in row]
                outs = [torch.empty((len(ins),) + tuple(p.shape), dtype=p.dtype,
                                    device=p.device) for p in ins]
                nccl.all_gather(ins, outs)
                got = [torch.cat(o.unbind(0), dim=dim) for o in outs[:1 if first_only else None]]
                out.append(got * len(devs) if first_only else got)
                continue
            g = torch.cat([p.to(devs[0]) for p in row], dim=dim)
            g = self.group_gather(g, dim)
            out.append([g] * len(devs) if first_only else [g.to(dev) for dev in devs])
        return out


def make_mesh(model: Optional[int] = None, data: int = 1, *,
              devices: Optional[Sequence] = None) -> Mesh:
    """A [data, model] mesh over `devices` (default: every visible CUDA
    device), taken in order. model=None uses all of them over `data` rows."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: this host has no CUDA device; pass devices=[...] "
                               "(for example [torch.device('cpu')] * 4)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if model is None:
        if n % data:
            raise ValueError(f"{n} devices not divisible by data={data}")
        model = n // data
    if model < 1 or data < 1 or data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    return Mesh([devices[d * model:(d + 1) * model] for d in range(data)])


def single_device_mesh() -> Mesh:
    return make_mesh(model=1, data=1)

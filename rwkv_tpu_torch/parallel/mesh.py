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
the copies are not kept as a choice. On one device, or on the CPU, the
collectives are the plain sums above.

Across processes (parallel/multihost.py: pod_mesh) only the data axis spans
the process boundary, as in the JAX pod mesh: `shape` is the global
{"data": rows of every process, "model": tp}, while `devices` holds this
process's `local_rows` rows, global rows first_row .. first_row +
local_rows - 1 (which process this is, torch.distributed says:
multihost.process_index()). A model axis never crosses a process (the JAX
doctrine: tensor parallelism stays inside a host); a process holding several
cards runs its rows' model axis across them. A mesh of one process has
local_rows == shape["data"] and first_row == 0.
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

    devices: this process's [data][model] rows. data: the data rows of every
    process (default: this process's, a one-process mesh); first_row: the
    global index of this process's first row."""

    def __init__(self, devices: Sequence[Sequence], *, data: Optional[int] = None,
                 first_row: int = 0):
        grid = [[canonical(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh needs a non-empty rectangular [data][model] grid of devices")
        data = len(grid) if data is None else data
        if first_row < 0 or first_row + len(grid) > data:
            raise ValueError(f"local rows {first_row}..{first_row + len(grid) - 1} lie outside "
                             f"the mesh's {data} data rows")
        self.devices = grid
        self.shape = {"data": data, "model": len(grid[0])}
        self.local_rows = len(grid)
        self.first_row = first_row
        self.collectives = {"psum": 0, "all_gather": 0}

    def row_on_cards(self, d: int) -> bool:
        """Whether data row d's shards each lie on their own CUDA device."""
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

    def psum(self, parts):
        """[data][model] grid of tensors -> the grid of their sums over the
        model shards of each data row: in the fixed order 0..tp-1, or, for a
        row across cards, NCCL's all-reduce."""
        self.collectives["psum"] += 1
        out = []
        for d, (row, devs) in enumerate(zip(parts, self.devices)):
            if self.row_on_cards(d):
                from torch.cuda import nccl

                ins = [p.contiguous() for p in row]
                outs = [torch.empty_like(p) for p in ins]
                nccl.all_reduce(ins, outs)
                out.append(outs)
                continue
            s = row[0]
            for p in row[1:]:
                s = s + p.to(devs[0])
            out.append([s.to(dev) for dev in devs])
        return out

    def all_gather(self, parts, dim: int = -1, first_only: bool = False):
        """[data][model] grid of tensors -> the grid of their concatenations
        over the model shards of each data row, along `dim`. first_only: the
        concatenation is made on each row's shard 0 only (the others'
        entries are that tensor too), for a caller that reads only shard
        0's."""
        self.collectives["all_gather"] += 1
        out = []
        for d, (row, devs) in enumerate(zip(parts, self.devices)):
            if self.row_on_cards(d):
                from torch.cuda import nccl

                ins = [p.contiguous() for p in row]
                outs = [torch.empty((len(ins),) + tuple(p.shape), dtype=p.dtype,
                                    device=p.device) for p in ins]
                nccl.all_gather(ins, outs)
                got = [torch.cat(o.unbind(0), dim=dim) for o in outs[:1 if first_only else None]]
                out.append(got * len(devs) if first_only else got)
                continue
            g = torch.cat([p.to(devs[0]) for p in row], dim=dim)
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

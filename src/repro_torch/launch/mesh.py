"""The device mesh and the multi-process launch path.

A `Mesh` is an array of torch devices with named axes, ``("data",
"model")`` by default, driven from ONE process: the port's sharded
placement is single-controller, as the JAX package's is inside a host.
A mesh may name one device more than once: a 2×2 mesh of ``cuda:0`` lays
a matrix out in four shards on one card, and the collectives between its
coordinates still copy, so the data movement the layout implies is paid
and can be measured on one card. A four-card machine uses ``cuda:0..3``.

`set_mesh(mesh)` makes a mesh ambient for the calls inside the block, and
`current_mesh()` reads it (None outside any), the counterparts of the JAX
package's `compat.set_mesh` and `get_abstract_mesh`.

The production meshes are the reference's: `make_mesh_shape` gives
(16, 16) over ("data", "model"), one pod of 256 chips, or (2, 16, 16)
over ("pod", "data", "model"), 512 chips in two pods whose `pod` axis is
pure data parallelism. `make_production_mesh` lays those coordinates over
`devices`, cycled: this process's cards by default (raising without
one), ``["cpu"]`` in the tests, ``["meta"]`` in the dry run
(`launch.dryrun`), which runs each cell's step on tensors with no storage.
A mesh of ``meta`` devices is built only where a caller names them.

Multi-process: `init_distributed()` joins a `torch.distributed` process
group (coordinator and process id from the arguments or the
SPIN_COORDINATOR / SPIN_NUM_PROCS / SPIN_PROC_ID variables), and
`worker_info()` reports this process's identity. A mesh spans one
process's devices; `local_worker_ranks()` maps the coded-worker ranks of
`parallel.straggler` onto processes round-robin. A single process is
process 0 of 1 with every rank local.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
from typing import Iterator, Sequence

import torch

from ..device import resolve_device

__all__ = ["Mesh", "set_mesh", "current_mesh", "make_worker_mesh",
           "make_mesh_shape", "make_production_mesh",
           "WorkerInfo", "init_distributed", "worker_info",
           "local_worker_ranks"]


class Mesh:
    """A named-axis array of torch devices; devices may repeat.

    `shape` maps axis name -> size in axis order, as a JAX mesh's does;
    `coords()` lists the coordinates row-major, and `device(coord)` is
    the device a coordinate's shard lies on.
    """

    def __init__(self, devices, axis_names: Sequence[str] = ("data", "model")):
        axis_names = tuple(axis_names)
        grid = _nested(devices, len(axis_names))
        sizes = _sizes(grid, len(axis_names))
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))
        self._devices = {c: torch.device(_at(grid, c))
                         for c in itertools.product(*map(range, sizes))}
        types = {d.type for d in self._devices.values()}
        if len(types) > 1:
            raise ValueError(f"a mesh holds one kind of device, got {types}")
        for c, d in self._devices.items():
            resolve_device(d, allow_meta=True)   # a cuda mesh needs the card
            if d.type == "cuda" and d.index is None:
                # the card a tensor made on "cuda" reports: compare equal to it
                self._devices[c] = torch.device("cuda", torch.cuda.current_device())

    @classmethod
    def solo(cls, device: torch.device) -> "Mesh":
        """The axis-free mesh of one device: a layout with no mesh."""
        return cls(torch.device(device), ())

    @property
    def axes(self) -> bool:
        """True when the mesh has at least one axis (is a real mesh)."""
        return bool(self.axis_names)

    def coords(self) -> list[tuple[int, ...]]:
        return list(self._devices)

    def device(self, coord: tuple[int, ...]) -> torch.device:
        return self._devices[coord]

    def axis_index(self, name: str) -> int:
        return self.axis_names.index(name)

    @property
    def distinct_devices(self) -> list[torch.device]:
        """The mesh's devices without repeats, in coordinate order."""
        out: list[torch.device] = []
        for d in self._devices.values():
            if d not in out:
                out.append(d)
        return out

    def home(self, device: torch.device) -> tuple[int, ...]:
        """The first coordinate on `device`: where work done once per
        device is booked."""
        for c, d in self._devices.items():
            if d == device:
                return c
        raise ValueError(f"{device} is not in the mesh")

    def descriptor(self) -> str:
        """Topology string, e.g. "data2:model2" ("" for an axis-free mesh)."""
        return ":".join(f"{k}{v}" for k, v in self.shape.items())

    def __repr__(self) -> str:
        devs = ",".join(str(d) for d in self._devices.values())
        return f"Mesh({self.descriptor() or 'solo'} @ {devs})"


def _nested(devices, ndim: int):
    if ndim == 0:
        return devices
    if isinstance(devices, (str, torch.device)):
        raise ValueError(f"expected a {ndim}-d array of devices")
    return [_nested(d, ndim - 1) for d in devices]


def _sizes(grid, ndim: int) -> tuple[int, ...]:
    sizes, level = [], grid
    for _ in range(ndim):
        if not level:
            raise ValueError("a mesh axis is empty")
        sizes.append(len(level))
        level = level[0]
    return tuple(sizes)


def _at(grid, coord):
    for i in coord:
        grid = grid[i]
    return grid


_MESH: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh: Mesh | None) -> Iterator[Mesh | None]:
    """Make `mesh` ambient for the calls inside the block (None clears)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> Mesh | None:
    """The innermost ambient mesh, or None outside any `set_mesh` block.

    A context variable: a thread started inside a `set_mesh` block does not
    see the mesh unless it is set again there.
    """
    return _MESH.get()


def make_worker_mesh(shape: tuple[int, ...] | None = None,
                     axes: tuple[str, ...] = ("data", "model"), *,
                     devices=None) -> Mesh:
    """A mesh over `devices` (default: every card of this process).

    shape=None factors the device count as (n/m, m) with m the largest
    power of two ≤ √n dividing n, the squarest two-axis mesh, as the JAX
    package does. Devices may repeat: ``make_worker_mesh((2, 2),
    devices=["cpu"] * 4)`` is a 2×2 mesh of the CPU.
    """
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if shape is None:
        m = 1
        while m * 2 * m * 2 <= n and n % (m * 2) == 0:
            m *= 2
        shape = (n // m, m)
    total = 1
    for s in shape:
        total *= s
    if total != n:
        raise ValueError(f"mesh shape {shape} needs {total} devices, "
                         f"got {n}")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")

    def build(level: int, offset: int):
        if level == len(shape):
            return devices[offset]
        stride = total
        for s in shape[:level + 1]:
            stride //= s
        return [build(level + 1, offset + i * stride)
                for i in range(shape[level])]

    return Mesh(build(0, 0), axes)


def make_mesh_shape(*, multi_pod: bool = False):
    """The production mesh's (shape, axis names): (16, 16) over (data,
    model), or (2, 16, 16) over (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The production mesh, its 256 or 512 coordinates laid over `devices`
    in turn (default: every card of this process; raises without one).
    ``devices=["meta"]`` is the dry run's mesh."""
    shape, axes = make_mesh_shape(multi_pod=multi_pod)
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        raise ValueError("make_production_mesh: no devices")
    n = 1
    for s in shape:
        n *= s
    return make_worker_mesh(shape, axes, devices=[devices[i % len(devices)]
                                                  for i in range(n)])


# ---------------------------------------------------------------------------
# Multi-process launch path
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkerInfo:
    """This process's identity in the (possibly single-process) cluster."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int
    coordinator: str | None = None

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def _process_topology() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_device_count() -> int:
    # The CPU counts as one device, as it does for the JAX package.
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def worker_info(*, coordinator: str | None = None) -> WorkerInfo:
    """Process-aware worker identity (process group, else process 0 of 1)."""
    index, count = _process_topology()
    local = _local_device_count()
    return WorkerInfo(process_index=index, process_count=count,
                      local_device_count=local,
                      global_device_count=local * count,
                      coordinator=coordinator)


def init_distributed(*, coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None) -> WorkerInfo:
    """Join the multi-process runtime; a no-op for single-process runs.

    Arguments default from SPIN_COORDINATOR ("host:port"), SPIN_NUM_PROCS
    and SPIN_PROC_ID, so one binary serves every rank of a launcher's
    fleet. With more than one process this calls
    `torch.distributed.init_process_group` (NCCL where there is a card,
    else gloo) at ``tcp://<coordinator>``; `local_device_ids` picks this
    process's card. A single process gets its WorkerInfo and nothing is
    initialised.
    """
    from .. import envconfig

    coordinator = coordinator_address or envconfig.env_str("SPIN_COORDINATOR")
    nprocs = (num_processes if num_processes is not None
              else envconfig.env_int("SPIN_NUM_PROCS", 1))
    pid = (process_id if process_id is not None
           else envconfig.env_int("SPIN_PROC_ID", 0))
    if coordinator and nprocs > 1:
        import torch.distributed as dist

        if local_device_ids and torch.cuda.is_available():
            torch.cuda.set_device(int(list(local_device_ids)[0]))
        if not dist.is_initialized():
            dist.init_process_group(
                backend="nccl" if torch.cuda.is_available() else "gloo",
                init_method=f"tcp://{coordinator}", world_size=nprocs,
                rank=pid)
    return worker_info(coordinator=coordinator if nprocs > 1 else None)


def local_worker_ranks(workers: int, *, process_index: int | None = None,
                       process_count: int | None = None) -> list[int]:
    """Coded-worker ranks this process owns (round-robin over processes).

    Rank r goes to process r mod P, so a redundancy group (cyclically
    adjacent ranks) straddles processes and a lost process never takes a
    whole group. Explicit process_index/process_count make the mapping a
    pure function; None reads the process group.
    """
    index, count = _process_topology()
    pi = index if process_index is None else process_index
    pc = count if process_count is None else process_count
    if workers < 1 or pc < 1 or not 0 <= pi < pc:
        raise ValueError(f"bad topology: workers={workers}, "
                         f"process {pi}/{pc}")
    return [r for r in range(workers) if r % pc == pi]

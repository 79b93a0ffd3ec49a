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

Multi-process: `init_distributed(backend=...)` joins a
`torch.distributed` process group (coordinator and process id from the
arguments or the SPIN_COORDINATOR / SPIN_NUM_PROCS / SPIN_PROC_ID
variables) and gathers every process's devices, in process order, into
the global device list. After it, `make_worker_mesh` and
`make_production_mesh` lay the mesh over the global devices: a `Mesh`
then maps each coordinate to a (process, device) pair, its *place*,
process p owning a contiguous row-major block of coordinates, as
`jax.devices()` orders a multi-process cluster. Every process runs the
same program (SPMD) and holds only the shards of its own coordinates
(`Mesh.local_coords`); `parallel.collectives` moves data between
coordinates of different processes with matched transfers
(`parallel.transport`). Two coordinates on ``cuda:0`` in two processes
are two memories. `worker_info()` reports this process's identity, and
`local_worker_ranks()` maps the coded-worker ranks of
`parallel.straggler` onto processes round-robin. A single process is
process 0 of 1 with every coordinate local: the single-controller mesh.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import itertools
import socket
from typing import Iterator, Sequence

import torch

from ..device import resolve_device

__all__ = ["Mesh", "set_mesh", "current_mesh", "make_worker_mesh",
           "make_mesh_shape", "make_production_mesh",
           "WorkerInfo", "init_distributed", "shutdown_distributed",
           "worker_info", "check_backend", "local_worker_ranks",
           "BACKENDS"]


class Mesh:
    """A named-axis array of torch devices; devices may repeat.

    `shape` maps axis name -> size in axis order, as a JAX mesh's does;
    `coords()` lists the coordinates row-major, and `device(coord)` is
    the device a coordinate's shard lies on. `processes` (an array of
    process indices shaped like `devices`; None: every coordinate is this
    process's) says which process holds each coordinate: a coordinate of
    another process names that process's device, and this process holds
    nothing of it.
    """

    def __init__(self, devices, axis_names: Sequence[str] = ("data", "model"), *,
                 processes=None):
        axis_names = tuple(axis_names)
        grid = _nested(devices, len(axis_names))
        sizes = _sizes(grid, len(axis_names))
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))
        coords = list(itertools.product(*map(range, sizes)))
        self._devices = {c: torch.device(_at(grid, c)) for c in coords}
        self.rank = _process_topology()[0]
        if processes is None:
            self._procs = None
        else:
            pgrid = _nested(processes, len(axis_names))
            if _sizes(pgrid, len(axis_names)) != sizes:
                raise ValueError("processes and devices differ in shape")
            self._procs = {c: int(_at(pgrid, c)) for c in coords}
            if self.rank not in self._procs.values():
                raise ValueError(f"process {self.rank} holds no coordinate of the mesh")
        types = {d.type for d in self._devices.values()}
        if len(types) > 1:
            raise ValueError(f"a mesh holds one kind of device, got {types}")
        for c, d in self._devices.items():
            if not self.is_local(c):
                continue                         # another process's device
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

    # -- processes --------------------------------------------------------
    def process(self, coord: tuple[int, ...]) -> int:
        """The process that holds `coord`'s shard."""
        return self.rank if self._procs is None else self._procs[coord]

    def is_local(self, coord: tuple[int, ...]) -> bool:
        """True when this process holds `coord`'s shard."""
        return self._procs is None or self._procs[coord] == self.rank

    def local_coords(self) -> list[tuple[int, ...]]:
        """This process's coordinates, in coordinate order."""
        return [c for c in self._devices if self.is_local(c)]

    @property
    def processes(self) -> list[int]:
        """The processes holding the mesh's coordinates, in index order."""
        return sorted({self.process(c) for c in self._devices})

    @property
    def spans_processes(self) -> bool:
        """True when coordinates of the mesh lie in more than one process."""
        return len(self.processes) > 1

    def place(self, coord: tuple[int, ...]) -> tuple[int, torch.device]:
        """(process, device) of `coord`: one memory. Equal devices in two
        processes are two places."""
        return self.process(coord), self._devices[coord]

    def places(self) -> list[tuple[int, torch.device]]:
        """The mesh's places without repeats, in coordinate order."""
        out: list = []
        for c in self._devices:
            p = self.place(c)
            if p not in out:
                out.append(p)
        return out

    def home(self, place: tuple[int, torch.device]) -> tuple[int, ...]:
        """The first coordinate at `place` (a (process, device) pair): where
        work done once a place is booked."""
        for c in self._devices:
            if self.place(c) == place:
                return c
        raise ValueError(f"{place} is not in the mesh")

    def local_device(self) -> torch.device:
        """The device of this process's first coordinate: where the
        replicated work outside the per-coordinate programs runs."""
        return self._devices[self.local_coords()[0]]

    @property
    def distinct_devices(self) -> list[torch.device]:
        """The mesh's devices without repeats, in coordinate order."""
        out: list[torch.device] = []
        for d in self._devices.values():
            if d not in out:
                out.append(d)
        return out

    def descriptor(self) -> str:
        """Topology string, e.g. "data2:model2" ("" for an axis-free mesh)."""
        return ":".join(f"{k}{v}" for k, v in self.shape.items())

    def __repr__(self) -> str:
        devs = ",".join(str(d) if self._procs is None else f"p{self._procs[c]}/{d}"
                        for c, d in self._devices.items())
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

    After `init_distributed` with more than one process the mesh is laid
    over the global device list: `devices` names this process's devices
    (default: those `init_distributed` found), every process's list is
    gathered in process order (a collective: every process builds the
    mesh), and process p holds a contiguous row-major block of
    coordinates. ``make_worker_mesh((2, 2), devices=["cpu"] * 2)`` in each
    of two processes is a 2×2 mesh whose rows are the two processes.
    """
    procs = None
    if _CLUSTER is not None:
        if devices is None:
            devices = _cards()
        local = [str(torch.device(d)) for d in devices]
        gathered = _gather_objects(local)
        devices = [d for lst in gathered for d in lst]
        procs = [p for p, lst in enumerate(gathered) for _ in lst]
    elif devices is None:
        devices = _cards()
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

    def build(flat, level: int, offset: int):
        if level == len(shape):
            return flat[offset]
        stride = total
        for s in shape[:level + 1]:
            stride //= s
        return [build(flat, level + 1, offset + i * stride)
                for i in range(shape[level])]

    return Mesh(build(devices, 0, 0), axes,
                processes=None if procs is None else build(procs, 0, 0))


def make_mesh_shape(*, multi_pod: bool = False):
    """The production mesh's (shape, axis names): (16, 16) over (data,
    model), or (2, 16, 16) over (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The production mesh, its 256 or 512 coordinates laid over `devices`
    in turn (default: every card of this process; raises without one).
    ``devices=["meta"]`` is the dry run's mesh. After `init_distributed`
    with P processes each process's devices take n / P coordinates in
    turn, process p the p-th contiguous block."""
    shape, axes = make_mesh_shape(multi_pod=multi_pod)
    if devices is None:
        devices = _cards()
    devices = list(devices)
    if not devices:
        raise ValueError("make_production_mesh: no devices")
    n = 1
    for s in shape:
        n *= s
    if _CLUSTER is not None:
        count = len(_CLUSTER.devices_by_process)
        if n % count:
            raise ValueError(f"{n} coordinates do not split over {count} processes")
        n //= count
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
    """Process-aware worker identity (process group, else process 0 of 1).
    `global_device_count` is every process's devices, as `init_distributed`
    gathered them."""
    index, count = _process_topology()
    if _CLUSTER is not None:
        local = len(_CLUSTER.local_devices)
        total = sum(len(d) for d in _CLUSTER.devices_by_process)
    else:
        local = _local_device_count()
        total = local * count
    return WorkerInfo(process_index=index, process_count=count,
                      local_device_count=local, global_device_count=total,
                      coordinator=coordinator)


BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class _Cluster:
    """What `init_distributed` set up: the transfers' backend, this
    process's devices, every process's (host, device, card) triples in
    process order, and the process group the transfers use (None: the
    default group)."""

    backend: str
    local_devices: tuple[torch.device, ...]
    devices_by_process: tuple[tuple[tuple[str, str, str | None], ...], ...]
    group: object = None


_CLUSTER: _Cluster | None = None


def _cards() -> list[torch.device]:
    """This process's cards (`init_distributed`'s, else every visible one);
    raises without one: a mesh lies on the CPU only where a caller names
    it."""
    resolve_device("cuda")
    if _CLUSTER is not None:
        return [d for d in _CLUSTER.local_devices if d.type == "cuda"]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def cluster() -> _Cluster | None:
    """The multi-process set-up of `init_distributed`, None in a single
    process."""
    return _CLUSTER


def _gather_objects(obj) -> list:
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _device_triples(devices) -> tuple:
    """(host, device, card) of each device: the card's UUID for a CUDA
    device, None for the CPU."""
    host = socket.gethostname()
    out = []
    for d in devices:
        card = (str(torch.cuda.get_device_properties(d).uuid)
                if d.type == "cuda" else None)
        out.append((host, str(d), card))
    return tuple(out)


def check_backend(backend: str, devices_by_process) -> None:
    """Raise ValueError where `backend` cannot serve processes with these
    devices (a list per process of (host, device, card) triples, as
    `init_distributed` gathers them). "gloo" serves any. "nccl" needs a
    card in every process and one process per card: NCCL aborts when two
    ranks of a group name the same card, so this raises first."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    if backend != "nccl":
        return
    owner: dict = {}
    for p, devs in enumerate(devices_by_process):
        for host, dev, card in devs:
            if card is None:
                raise ValueError(f"backend 'nccl' needs a card: process {p} has {dev}")
            first = owner.setdefault((host, card), p)
            if first != p:
                raise ValueError(
                    f"backend 'nccl' needs one process per card: processes {first} and "
                    f"{p} both name card {card} ({dev} on {host}); run one process a "
                    "card, or backend='gloo'")


def init_distributed(*, coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, backend: str | None = None,
                     timeout_s: float | None = None) -> WorkerInfo:
    """Join the multi-process runtime; a no-op for single-process runs.

    Arguments default from SPIN_COORDINATOR ("host:port", or an init URL
    such as "file:///path/rendezvous"), SPIN_NUM_PROCS and SPIN_PROC_ID,
    so one binary serves every rank of a launcher's fleet. With more than
    one process `backend` must be named: "gloo" (any devices; a CUDA
    tensor crosses through a pinned host buffer) or "nccl" (one process a
    card; card memory crosses directly), checked by `check_backend` on the
    gathered devices before any NCCL call. The default group is gloo (it
    gathers the devices); "nccl" adds a group of its own for the
    transfers. This process's devices are the cards `local_device_ids`
    names, else every visible card, else the CPU; the first becomes the
    current card. `timeout_s` bounds every wait of the group. A single
    process gets its WorkerInfo and nothing is initialised.
    """
    global _CLUSTER
    from .. import envconfig

    coordinator = coordinator_address or envconfig.env_str("SPIN_COORDINATOR")
    nprocs = (num_processes if num_processes is not None
              else envconfig.env_int("SPIN_NUM_PROCS", 1))
    pid = (process_id if process_id is not None
           else envconfig.env_int("SPIN_PROC_ID", 0))
    if coordinator and nprocs > 1:
        import torch.distributed as dist

        if backend not in BACKENDS:
            raise ValueError(f"init_distributed: name backend= ({' or '.join(BACKENDS)}) "
                             f"for {nprocs} processes, got {backend!r}")
        if local_device_ids is not None:
            local = [torch.device("cuda", int(i)) for i in local_device_ids]
        elif torch.cuda.is_available():
            local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            local = [torch.device("cpu")]
        if local[0].type == "cuda":
            torch.cuda.set_device(local[0])
        timeout = (datetime.timedelta(seconds=timeout_s) if timeout_s is not None
                   else None)
        if not dist.is_initialized():
            dist.init_process_group(
                "gloo", init_method=(coordinator if "://" in coordinator
                                     else f"tcp://{coordinator}"),
                world_size=nprocs, rank=pid,
                **({"timeout": timeout} if timeout is not None else {}))
        triples = tuple(_gather_objects(_device_triples(local)))
        try:
            check_backend(backend, triples)
        except ValueError:
            dist.destroy_process_group()
            raise
        group = (dist.new_group(backend="nccl",
                                **({"timeout": timeout} if timeout is not None else {}))
                 if backend == "nccl" else None)
        from ..parallel import transport

        _CLUSTER = _Cluster(backend, tuple(local), triples, group)
        transport.reset()
    return worker_info(coordinator=coordinator if nprocs > 1 else None)


def shutdown_distributed() -> None:
    """Leave the process group `init_distributed` joined (a no-op without
    one)."""
    global _CLUSTER
    import torch.distributed as dist

    _CLUSTER = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


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

"""Point-to-point transfers between the processes of a mesh.

A mesh that spans processes (`launch.mesh`) moves a piece between
coordinates of two processes as one matched `torch.distributed` transfer:
the process that holds the source posts an `isend`, the process that
holds the destination an `irecv`. Every process walks the same plan of
transfers (the collectives' deterministic loops over coordinates and
tiles) and takes a tag from `next_tag()` for every transfer between two
processes, its own or not, so a transfer carries the same tag on both
sides. A send never blocks; a receive waits for its data. Since every
process walks the plan in one order and only receives wait, the transfer
at the earliest pending position can always complete: no process waits
on a peer that waits on it. Each send's `Work` is held until `drain()`
waits on it, when the outermost operation that posted it (`exchange()`)
ends; a dropped `Work` breaks gloo's connection for both peers.

Backends (`launch.mesh.init_distributed(backend=...)`): "gloo" stages a
CUDA tensor through a pinned host buffer (the copy finished before the
send reads it) and copies a received one onto the card; "nccl" sends
card memory directly. A payload crosses as its bytes (a uint8 view of a
contiguous copy), so every dtype does.

One thread drives a mesh's transfers: their tags are handed out in the
order the transfers are posted. `exchange_seconds()` is the host time
spent in the transfers (staging, posting, waiting) since `reset_stats()`.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Iterator

import torch

__all__ = ["next_tag", "send", "post_recv", "recv", "drain", "exchange",
           "exchange_seconds", "reset_stats", "reset"]

_TAG_SPACE = 2 ** 31 - 1          # gloo's tags are non-negative int32


class _Transport:
    """This process's side of the transfers: the tag counter, the sends
    not yet waited on, and the host seconds spent."""

    def __init__(self):
        self.tag = 0
        self.pending: list = []
        self.depth = 0
        self.seconds = 0.0


_T = _Transport()


def _cluster():
    from ..launch.mesh import cluster

    c = cluster()
    if c is None:
        raise RuntimeError("a mesh spans processes but init_distributed has not run "
                           "in this process")
    return c


def reset() -> None:
    """Start a fresh plan (after `init_distributed`): tag 0, nothing pending."""
    global _T
    _T = _Transport()


def reset_stats() -> None:
    _T.seconds = 0.0


def exchange_seconds() -> float:
    return _T.seconds


def next_tag() -> int:
    """The tag of the next transfer between two processes of the plan."""
    tag = _T.tag
    _T.tag = (tag + 1) % _TAG_SPACE
    return tag


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _timed(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _T.seconds += time.perf_counter() - t0
    return run


@_timed
def send(t: torch.Tensor, dst: int, tag: int) -> None:
    """Post `t` to process `dst` under `tag`; the Work and the bytes it
    reads are held until `drain()`."""
    import torch.distributed as dist

    c = _cluster()
    payload = _as_bytes(t)
    if payload.device.type == "cuda" and c.backend == "gloo":
        host = torch.empty(payload.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(payload)                  # a blocking copy: done before the send
        payload = host
    _T.pending.append((dist.isend(payload, dst, group=c.group, tag=tag), payload))


class _Incoming:
    """A posted receive: `wait()` returns the tensor on its device."""

    __slots__ = ("work", "buf", "shape", "dtype", "device")

    def __init__(self, work, buf, shape, dtype, device):
        self.work, self.buf = work, buf
        self.shape, self.dtype, self.device = shape, dtype, device

    @_timed
    def wait(self) -> torch.Tensor:
        self.work.wait()
        t = self.buf.view(self.dtype).reshape(self.shape)
        if t.device != self.device:
            t = t.to(self.device, non_blocking=True)
        return t


@_timed
def post_recv(shape, dtype: torch.dtype, src: int, tag: int,
              device: torch.device) -> _Incoming:
    """Post the receive of a (shape, dtype) tensor from process `src`
    under `tag`, for `device`."""
    import torch.distributed as dist

    c = _cluster()
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    nbytes = n * torch.empty((), dtype=dtype).element_size()
    if device.type == "cuda" and c.backend == "gloo":
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    else:
        buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return _Incoming(dist.irecv(buf, src, group=c.group, tag=tag), buf, shape, dtype,
                     device)


def recv(shape, dtype: torch.dtype, src: int, tag: int,
         device: torch.device) -> torch.Tensor:
    """Receive a (shape, dtype) tensor from process `src` under `tag`,
    on `device`; waits for it."""
    return post_recv(shape, dtype, src, tag, device).wait()


@_timed
def drain() -> None:
    """Wait on every send posted so far."""
    pending, _T.pending = _T.pending, []
    for work, _ in pending:
        work.wait()


@contextlib.contextmanager
def exchange() -> Iterator[None]:
    """An operation that posts transfers: its sends are waited on when
    the outermost such block ends without an error. On an error they are
    dropped with the process group's fate: a peer's wait fails or times
    out."""
    _T.depth += 1
    ok = False
    try:
        yield
        ok = True
    finally:
        _T.depth -= 1
        if _T.depth == 0:
            if ok:
                drain()
            else:
                _T.pending = []

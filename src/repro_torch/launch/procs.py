"""Start the processes of a multi-process mesh on one machine, and collect
what each returns.

    results = run_ranks([sys.executable, "job.py", "case"], 4, timeout_s=120)

`run_ranks` starts `argv` once a rank with SPIN_COORDINATOR (an init URL or
"host:port"; by default a rendezvous file of the call's own),
SPIN_NUM_PROCS and SPIN_PROC_ID set, and each rank's program calls
`rank_main(fn, backend=...)`: it joins the group (`launch.mesh.
init_distributed`), runs `fn()`, and prints its result (anything
`torch.save` takes with ``weights_only`` loading: tensors, numbers,
strings, lists, dicts) or its traceback as its last line. `run_ranks`
waits for every rank. At the first rank that fails, or at the deadline,
it kills every rank and raises `RankFailure` with that rank's traceback
and the end of its output: a rank that raises mid-collective leaves its
peers waiting on it, and the kill ends them. No rank outlives the call.
"""

from __future__ import annotations

import base64
import io
import os
import socket
import subprocess
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Sequence

__all__ = ["RankFailure", "run_ranks", "rank_main", "free_port"]

_TAG = "REPRO_TORCH_RANK_RESULT "


class RankFailure(RuntimeError):
    """A rank failed or the ranks ran past their deadline; every rank has
    been killed."""


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _result(log: Path):
    import torch

    for line in reversed(log.read_text(errors="replace").splitlines()):
        if line.startswith(_TAG):
            raw = base64.b64decode(line[len(_TAG):])
            return torch.load(io.BytesIO(raw), weights_only=True)
    return None


def _tail(log: Path, n: int = 4000) -> str:
    text = log.read_text(errors="replace") if log.exists() else ""
    text = "\n".join(ln for ln in text.splitlines() if not ln.startswith(_TAG))
    return text[-n:]


def run_ranks(argv: Sequence[str], nprocs: int, *, timeout_s: float,
              coordinator: str | None = None, env: dict | None = None) -> list:
    """Run `argv` as ranks 0 .. nprocs-1 (with `env`, default this
    process's environment) and return their results in rank order; raise
    RankFailure (every rank killed) when one fails or when `timeout_s`
    seconds pass. Each rank's output goes to a log in a temporary
    directory, removed at the end."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        logs = Path(tmp)
        coord = coordinator or f"file://{logs / 'rendezvous'}"
        base = dict(os.environ if env is None else env)
        procs, files = [], []
        try:
            for rank in range(nprocs):
                f = open(logs / f"rank{rank}.log", "w")
                files.append(f)
                procs.append(subprocess.Popen(
                    list(argv), stdout=f, stderr=subprocess.STDOUT,
                    env={**base, "SPIN_COORDINATOR": coord,
                         "SPIN_NUM_PROCS": str(nprocs), "SPIN_PROC_ID": str(rank)}))
            deadline = time.monotonic() + timeout_s
            failed = None
            while failed is None:
                codes = [p.poll() for p in procs]
                failed = next((r for r, c in enumerate(codes) if c not in (None, 0)), None)
                if failed is not None or all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise RankFailure(
                        f"ranks {[r for r, c in enumerate(codes) if c is None]} still "
                        f"running after {timeout_s} s; rank 0's output:\n"
                        + _tail(logs / "rank0.log"))
                time.sleep(0.02)
            if failed is not None:
                got = _result(logs / f"rank{failed}.log")
                why = got["traceback"] if got and not got["ok"] else "(no traceback)"
                raise RankFailure(
                    f"rank {failed} of {nprocs} exited {procs[failed].returncode}:\n{why}\n"
                    f"its output:\n{_tail(logs / f'rank{failed}.log')}")
            out = []
            for rank in range(nprocs):
                got = _result(logs / f"rank{rank}.log")
                if got is None or not got["ok"]:
                    raise RankFailure(f"rank {rank} returned no result:\n"
                                      + _tail(logs / f"rank{rank}.log"))
                out.append(got["result"])
            return out
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in files:
                f.close()


def rank_main(fn: Callable[[], object], *, backend: str | None,
              timeout_s: float | None = None) -> None:
    """A rank's program: join the group (`backend`, every wait bounded by
    `timeout_s`; backend=None: `fn` joins it itself), run `fn()`, print its
    result as the last line, and exit (1 on an error, after printing the
    traceback)."""
    import torch

    from .mesh import init_distributed, shutdown_distributed

    try:
        if backend is not None:
            init_distributed(backend=backend, timeout_s=timeout_s)
        payload, code = {"ok": True, "result": fn()}, 0
    except BaseException:                      # reported to the parent, then exit 1
        payload, code = {"ok": False, "traceback": traceback.format_exc()}, 1
    buf = io.BytesIO()
    torch.save(payload, buf)
    print(_TAG + base64.b64encode(buf.getvalue()).decode(), flush=True)
    if code:
        os._exit(code)                         # peers may still wait on this rank
    shutdown_distributed()

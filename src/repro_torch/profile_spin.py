"""Trace one SPIN inversion or solve on the card and break its device time down.

    PYTHONPATH=src python -m repro_torch.profile_spin            # inversion
    PYTHONPATH=src python -m repro_torch.profile_spin --solve    # solve

Runs `spin_inverse_dense(engine="cuda", leaf_solver="cuda")` at n = 16384,
block size 1024, f32, on a `make_spd` matrix (seed 0), or with `--solve`
`spin_solve_dense(engine="cuda", leaf_solver="cuda")` of that matrix
against 256 standard-normal right-hand sides: one warm-up call, one call
timed by CUDA events, then one call under `torch.profiler`. From
the trace's device events it prints, as one JSON line, each kernel's
device time and count, grouped by kernel name and launch grid, and the
device's idle share: the part of the traced call, from its start on the
host to the end of its last device event, in which no kernel, copy or
fill ran. The Chrome trace is kept under ``build/profile_spin/``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["device_breakdown", "main"]

N, BLOCK_SIZE, N_RHS, SEED = 16384, 1024, 256, 0
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "profile_spin"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
CALL = "spin_inverse_dense"


def device_breakdown(trace: dict, call: str = CALL) -> dict:
    """Per-kernel device time and idle share of the range named `call` in a
    Chrome trace (``{"traceEvents": [...]}``, times in microseconds)."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    marks = [e for e in events if e.get("name") == call
             and e.get("cat") == "user_annotation"]
    if len(marks) != 1:
        raise ValueError(f"want one {call!r} range in the trace, got {len(marks)}")
    start = float(marks[0]["ts"])
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATEGORIES
                     and float(e["ts"]) >= start), key=lambda e: float(e["ts"]))
    if not device:
        raise ValueError("the trace holds no device events after the call began")
    end = max(float(e["ts"]) + float(e["dur"]) for e in device)

    groups: dict[tuple[str, str, str], list[float]] = {}
    busy, cur_lo, cur_hi = 0.0, None, None
    for e in device:
        lo, hi = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        grid = "x".join(str(g) for g in e.get("args", {}).get("grid", []))
        groups.setdefault((e["cat"], e["name"], grid), []).append(hi - lo)
        if cur_hi is None or lo > cur_hi:
            busy += 0.0 if cur_hi is None else cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    span = end - start
    rows = [{"category": cat, "name": name, "grid": grid, "count": len(d),
             "device_ms": sum(d) / 1e3} for (cat, name, grid), d in groups.items()]
    rows.sort(key=lambda r: -r["device_ms"])
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / span, "groups": rows}


def main(argv=None) -> int:
    from .core import spin_inverse_dense, spin_solve_dense, testing
    from .kernels import build

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--solve", action="store_true",
                        help=f"trace the solve against {N_RHS} right-hand sides")
    solve = parser.parse_args(argv).solve
    if not torch.cuda.is_available():
        raise SystemExit("profile_spin: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    rng = np.random.default_rng(SEED)
    a = testing.make_spd(N, rng, device="cuda")
    call = "spin_solve_dense" if solve else CALL
    if solve:
        b = torch.from_numpy(rng.standard_normal((N, N_RHS), dtype=np.float32)).cuda()

        def run():
            return spin_solve_dense(a, b, BLOCK_SIZE, "cuda", engine="cuda")
    else:
        def run():
            return spin_inverse_dense(a, BLOCK_SIZE, "cuda", engine="cuda")

    run()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    stop.synchronize()
    wall_ms = start.elapsed_time(stop)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(call):
            run()
            torch.cuda.synchronize()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{call}.json"
    prof.export_chrome_trace(str(path))
    report = device_breakdown(json.loads(path.read_text()), call)
    report.update(call=call, n=N, block_size=BLOCK_SIZE,
                  n_rhs=N_RHS if solve else None, untraced_wall_ms=wall_ms,
                  device=torch.cuda.get_device_name(0), trace=str(path))
    for r in report["groups"]:
        print(f"{r['device_ms']:10.3f} ms {r['count']:5d}x  {r['category']:10s} "
              f"grid {r['grid'] or '-':>10s}  {r['name'][:80]}")
    print(f"span {report['span_ms']:.3f} ms, busy {report['busy_ms']:.3f} ms, "
          f"idle share {report['idle_share']:.4f}; untraced wall {wall_ms:.3f} ms")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

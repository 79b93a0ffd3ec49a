"""Trace SPIN inversions or solves on the card and break their device time down.

    PYTHONPATH=src python -m repro_torch.profile_spin                  # inversion
    PYTHONPATH=src python -m repro_torch.profile_spin --solve          # solve
    PYTHONPATH=src python -m repro_torch.profile_spin --gauss-jordan --calls 4
    PYTHONPATH=src python -m repro_torch.profile_spin --lu             # LU baseline
    PYTHONPATH=src python -m repro_torch.profile_spin --bf16           # bf16 preset
    PYTHONPATH=src python -m repro_torch.profile_spin --strassen       # Strassen engine
    PYTHONPATH=src python -m repro_torch.profile_spin --sweep          # block-size sweep

Runs `spin_inverse_dense(engine="cuda", leaf_solver="cuda")` at n = 16384,
block size 1024, f32, on a `make_spd` matrix (seed 0); with `--solve`
`spin_solve_dense(engine="cuda", leaf_solver="cuda")` of that matrix
against 256 standard-normal right-hand sides; with `--gauss-jordan`
`spin_inverse_dense(leaf_solver="gauss_jordan", engine="cuda")` at
n = 2048, block size 128 (the scalar Gauss-Jordan leaf's path); with
`--lu` the paper's baseline, `lu_inverse_dense(engine="cuda")`, at
n = 16384, block size 1024; with `--bf16` the inversion under
``precision="bf16"`` (the recursion in bf16, one f32 Newton-Schulz sweep);
with `--strassen` the inversion under ``engine="strassen"`` at the default
cutoff. One
warm-up call, `--calls` calls timed by CUDA events one by one, then
`--calls` calls under `torch.profiler`, each in a range of its own. From
the trace's device events it prints, for each traced call, one JSON line:
each kernel's device time and count, grouped by kernel name and launch
grid, and the device's idle share: the part of the call, from its start
on the host to the end of its last device event, in which no kernel, copy
or fill ran. The Chrome trace is kept under ``build/profile_spin/``.

`--sweep` traces nothing: it times the same inversion at every block size
of `SWEEP_BLOCK_SIZES` (one warm-up each, then `--calls` rounds, each
block size once a round), each leaf solver alone at each block size (B3,
`torch.linalg.inv`, the QR leaf; the scalar Gauss-Jordan B4 up to 1024),
one B2 launch at each product size the recursions run, and the
inversion at block size 1024 under the einsum engine, and prints one JSON
line: the measurements the planner's card constants
(`planner.autotune.CUDA_CONSTANTS`) are fitted to.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["device_breakdown", "sweep", "main"]

N, BLOCK_SIZE, N_RHS, SEED = 16384, 1024, 256, 0
GJ_N, GJ_BLOCK_SIZE = 2048, 128
SWEEP_BLOCK_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "profile_spin"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
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
    # The call's device work: the device events whose launch on the host
    # (matched by correlation id) lies in the range. The device's clock is
    # mapped onto the host's, and the two can disagree by milliseconds, so
    # the device events' own times cannot tell two calls apart.
    stop = start + float(marks[0]["dur"])
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in HOST_LAUNCH_CATEGORIES
                and start <= float(e["ts"]) <= stop and "correlation" in e.get("args", {})}
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATEGORIES
                     and e.get("args", {}).get("correlation") in launched),
                    key=lambda e: float(e["ts"]))
    if not device:
        raise ValueError("the trace holds no device events launched by the call")
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


def _event_ms(fn, reps: int) -> float:
    """Mean device ms of `fn` over `reps` calls, after one warm-up."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def sweep(calls: int) -> dict:
    """The block-size sweep at n = N: inversion ms by block size, each leaf
    solver's ms by block size, B2 ms by product size, and the inversion at
    BLOCK_SIZE under the einsum engine."""
    from .core import LEAF_SOLVERS, spin_inverse_dense, testing
    from .kernels.matmul import ops as mm_ops

    a = testing.make_spd(N, np.random.default_rng(SEED), device="cuda")
    runs = {bs: (lambda bs=bs: spin_inverse_dense(a, bs, "cuda", engine="cuda"))
            for bs in SWEEP_BLOCK_SIZES}
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    inverse_ms = {bs: [] for bs in SWEEP_BLOCK_SIZES}
    for _ in range(calls):
        for bs, run in runs.items():
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            stop.record()
            stop.synchronize()
            inverse_ms[bs].append(start.elapsed_time(stop))
    leaf_ms = {name: {} for name in LEAF_SOLVERS}
    for bs in SWEEP_BLOCK_SIZES:
        block = a[:bs, :bs].contiguous()
        for name, solve in LEAF_SOLVERS.items():
            if name == "cuda" or bs <= (4096 if name != "gauss_jordan" else 1024):
                leaf_ms[name][bs] = _event_ms(lambda: solve(block), 3)
        del block
    einsum_ms = _event_ms(lambda: spin_inverse_dense(a, BLOCK_SIZE, "cuda", engine="einsum"),
                          calls)
    gemm_ms = {}
    for size in sorted({bs for bs in SWEEP_BLOCK_SIZES if bs < N} | {128}):
        x, y = a[:size, :size], a[size:2 * size, :size]
        gemm_ms[size] = _event_ms(lambda: mm_ops.matmul(x, y), 5)
    return {"n": N, "device": torch.cuda.get_device_name(0),
            "inverse_ms": inverse_ms, "leaf_ms": leaf_ms, "gemm_ms": gemm_ms,
            "einsum_engine_ms": {BLOCK_SIZE: einsum_ms}}


def main(argv=None) -> int:
    from .core import lu_inverse_dense, spin_inverse_dense, spin_solve_dense, testing
    from .kernels import build

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--solve", action="store_true",
                       help=f"trace the solve against {N_RHS} right-hand sides")
    which.add_argument("--gauss-jordan", action="store_true",
                       help=f"trace the n = {GJ_N} inversion with the scalar "
                            "Gauss-Jordan leaf")
    which.add_argument("--lu", action="store_true",
                       help="trace the LU baseline's inversion")
    which.add_argument("--bf16", action="store_true",
                       help="trace the inversion under precision='bf16'")
    which.add_argument("--strassen", action="store_true",
                       help="trace the inversion under engine='strassen'")
    which.add_argument("--sweep", action="store_true",
                       help="time the inversion at every block size (no trace)")
    parser.add_argument("--calls", type=int, default=1,
                        help="calls timed, and calls traced, after the warm-up")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_spin: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.sweep:
        build.build_all(("matmul", "leaf_inverse"))
        print(json.dumps(sweep(args.calls)))
        return 0
    build.build_all()
    rng = np.random.default_rng(SEED)
    n, bs = (GJ_N, GJ_BLOCK_SIZE) if args.gauss_jordan else (N, BLOCK_SIZE)
    a = testing.make_spd(n, rng, device="cuda")
    call = "spin_solve_dense" if args.solve else "lu_inverse_dense" if args.lu else CALL
    if args.lu:

        def run():
            return lu_inverse_dense(a, bs, engine="cuda")
    elif args.solve:
        b = torch.from_numpy(rng.standard_normal((n, N_RHS), dtype=np.float32)).cuda()

        def run():
            return spin_solve_dense(a, b, bs, "cuda", engine="cuda")
    else:
        leaf = "gauss_jordan" if args.gauss_jordan else "cuda"
        engine = "strassen" if args.strassen else "cuda"
        precision = "bf16" if args.bf16 else None

        def run():
            return spin_inverse_dense(a, bs, leaf, engine=engine, precision=precision)

    run()
    torch.cuda.synchronize()
    wall_ms = []
    for _ in range(args.calls):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        wall_ms.append(start.elapsed_time(stop))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    names = [f"{call}#{i}" for i in range(args.calls)]
    with torch.profiler.profile(activities=acts) as prof:
        for name in names:
            with torch.profiler.record_function(name):
                run()
                torch.cuda.synchronize()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    suffix = next((f"_{flag}" for flag in ("gauss_jordan", "bf16", "strassen")
                   if getattr(args, flag)), "")
    path = TRACE_DIR / f"{call}{suffix}.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    for i, name in enumerate(names):
        report = device_breakdown(trace, name)
        report.update(call=name, n=n, block_size=bs, n_rhs=N_RHS if args.solve else None,
                      leaf_solver=("gauss_jordan" if args.gauss_jordan
                                   else "lu" if args.lu else "cuda"),
                      engine="strassen" if args.strassen else "cuda",
                      precision="bf16" if args.bf16 else "exact",
                      untraced_wall_ms=wall_ms, device=torch.cuda.get_device_name(0),
                      trace=str(path))
        if i == 0:
            for r in report["groups"]:
                print(f"{r['device_ms']:10.3f} ms {r['count']:5d}x  {r['category']:10s} "
                      f"grid {r['grid'] or '-':>10s}  {r['name'][:80]}")
        print(f"{name}: span {report['span_ms']:.3f} ms, busy {report['busy_ms']:.3f} ms, "
              f"idle share {report['idle_share']:.4f}; untraced wall {wall_ms[i]:.3f} ms")
        print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

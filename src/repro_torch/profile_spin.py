"""Trace SPIN inversions or solves on the card and break their device time down.

    PYTHONPATH=src python -m repro_torch.profile_spin                  # inversion
    PYTHONPATH=src python -m repro_torch.profile_spin --solve          # solve
    PYTHONPATH=src python -m repro_torch.profile_spin --gauss-jordan --calls 4
    PYTHONPATH=src python -m repro_torch.profile_spin --lu             # LU baseline
    PYTHONPATH=src python -m repro_torch.profile_spin --bf16           # bf16 preset
    PYTHONPATH=src python -m repro_torch.profile_spin --strassen       # Strassen engine
    PYTHONPATH=src python -m repro_torch.profile_spin --sweep          # block-size sweep
    PYTHONPATH=src python -m repro_torch.profile_spin --service --calls 4   # SpinService ticks
    PYTHONPATH=src python -m repro_torch.profile_spin --sharded        # 2×2 mesh, one card

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
cutoff; with `--sharded` `spin_inverse_sharded(leaf_solver="cuda",
engine="cuda")` on a 2×2 mesh of the one card (`make_worker_mesh((2, 2),
devices=["cuda:0"] * 4)`), whose report adds the device time by class
(B1+B2's GEMM and pack, B3, B5, the copies between mesh coordinates and
the layout's other copies, cuBLAS, the rest: `device_classes`) and the
bytes the collectives copied. One
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

`--service` traces `SpinService` ticks at n = 16384 (block size 1024, the
`cuda` leaf and engine, 8 slots), as `chip_smoke.py` drives them: each
tick serves 8 requests of 32 standard-normal columns, coalesced into one
256-column batch. After one warm-up tick, `--calls` exact-path ticks (one
`spin_solve_dense` each) are timed by CUDA events and then traced; after
one rank-64 SMW update, as many maintained-path ticks (one product against
the maintained inverse). Each tick is a range of its own ("tick.exact#i",
"tick.maintained#i"), the requests submitted outside it, and it prints
the same breakdown as above for each. The plan file lies in a temporary
directory unless $SPIN_PLAN_CACHE names one.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

__all__ = ["device_breakdown", "device_classes", "sweep", "service_ticks",
           "main"]

N, BLOCK_SIZE, N_RHS, SEED = 16384, 1024, 256, 0
SERVICE_SLOTS, SERVICE_COLS, SMW_RANK = 8, 32, 64
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


# Kernel classes of a breakdown, first match wins: the port's kernels by
# their names in csrc/, then copies (memcpy and PyTorch's copy kernels:
# the layout's moves between mesh coordinates and the assembly of
# quadrants), then cuBLAS.
_CLASSES = (
    ("B1+B2 gemm_tc", lambda cat, name: "gemm_tc" in name),
    ("B1+B2 pack", lambda cat, name: "gemm_pack" in name),
    ("B3 blocked Gauss-Jordan", lambda cat, name: "bgj_" in name),
    ("B5 triangular solve", lambda cat, name: "tri_" in name),
    ("copies", lambda cat, name: cat == "gpu_memcpy" or "copy" in name.lower()),
    ("fills", lambda cat, name: cat == "gpu_memset" or "fill" in name.lower()),
    ("cuBLAS", lambda cat, name: any(k in name.lower()
                                     for k in ("gemm", "xmma", "cutlass"))),
    ("other", lambda cat, name: True),
)


def device_classes(report: dict) -> dict:
    """A `device_breakdown` report's device ms and launches by class."""
    out: dict[str, dict] = {}
    for r in report["groups"]:
        label = next(c for c, match in _CLASSES if match(r["category"], r["name"]))
        cls = out.setdefault(label, {"device_ms": 0.0, "count": 0})
        cls["device_ms"] += r["device_ms"]
        cls["count"] += r["count"]
    return out


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


def _tick_ranges(svc, gen, label: str, calls: int, prof=None) -> list[float]:
    """`calls` ticks of SERVICE_SLOTS requests on `svc`, each in a range of
    its own under `prof`, or timed by CUDA events without it."""
    out = []
    for i in range(calls):
        for _ in range(SERVICE_SLOTS):
            svc.solve("gram", torch.randn(N, SERVICE_COLS, generator=gen, device="cuda"))
        torch.cuda.synchronize()
        if prof is None:
            start, stop = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            start.record()
            svc.tick()
            stop.record()
            stop.synchronize()
            out.append(start.elapsed_time(stop))
        else:
            with torch.profiler.record_function(f"tick.{label}#{i}"):
                svc.tick()
                torch.cuda.synchronize()
    return out


def service_ticks(calls: int) -> list[dict]:
    """Trace the service's exact-path and maintained-path ticks; one report
    a tick (see the module docstring)."""
    from .core import testing
    from .serving import SpinService

    rng = np.random.default_rng(SEED)
    a = testing.make_spd(N, rng, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    svc = SpinService(slots=SERVICE_SLOTS)
    svc.add_matrix("gram", a, block_size=BLOCK_SIZE, leaf_solver="cuda", engine="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    reports = []
    for label in ("exact", "maintained"):
        if label == "maintained":
            u = torch.from_numpy(rng.standard_normal((N, SMW_RANK), dtype=np.float32))
            svc.update("gram", u.cuda() / N ** 0.5)
        _tick_ranges(svc, gen, label, 1)                           # warm-up
        wall = _tick_ranges(svc, gen, label, calls)
        with torch.profiler.profile(activities=acts) as prof:
            _tick_ranges(svc, gen, label, calls, prof)
        path = TRACE_DIR / f"spin_service_{label}.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
        for i in range(calls):
            report = device_breakdown(trace, f"tick.{label}#{i}")
            report.update(call=f"tick.{label}#{i}",
                          path="recursion" if label == "exact" else label,
                          n=N, block_size=BLOCK_SIZE, requests=SERVICE_SLOTS,
                          cols=SERVICE_SLOTS * SERVICE_COLS, untraced_wall_ms=wall[i],
                          device=torch.cuda.get_device_name(0), trace=str(path))
            reports.append(report)
    return reports


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
    which.add_argument("--service", action="store_true",
                       help="trace SpinService's exact-path and maintained-path ticks")
    which.add_argument("--sharded", action="store_true",
                       help="trace the inversion on a 2x2 mesh of the one card")
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
    if args.service:
        plan_dir = None
        if "SPIN_PLAN_CACHE" not in os.environ:
            plan_dir = tempfile.mkdtemp(prefix="profile_spin_plans_")
            os.environ["SPIN_PLAN_CACHE"] = os.path.join(plan_dir, "plans.json")
        try:
            for report in service_ticks(args.calls):
                print(f"{report['call']}: span {report['span_ms']:.3f} ms, busy "
                      f"{report['busy_ms']:.3f} ms, idle share {report['idle_share']:.4f}; "
                      f"untraced wall {report['untraced_wall_ms']:.3f} ms")
                for r in report["groups"][:6]:
                    print(f"{r['device_ms']:10.3f} ms {r['count']:5d}x  {r['category']:10s} "
                          f"grid {r['grid'] or '-':>10s}  {r['name'][:80]}")
                print(json.dumps(report))
        finally:
            if plan_dir is not None:
                shutil.rmtree(plan_dir, ignore_errors=True)
        return 0
    from .parallel import collective_bytes, reset_collective_bytes

    build.build_all()
    rng = np.random.default_rng(SEED)
    n, bs = (GJ_N, GJ_BLOCK_SIZE) if args.gauss_jordan else (N, BLOCK_SIZE)
    a = testing.make_spd(n, rng, device="cuda")
    call = ("spin_solve_dense" if args.solve else "lu_inverse_dense" if args.lu
            else "spin_inverse_sharded" if args.sharded else CALL)
    if args.sharded:
        from .core import spin_inverse_sharded
        from .launch.mesh import make_worker_mesh, set_mesh

        mesh = make_worker_mesh((2, 2), devices=["cuda:0"] * 4)

        def run():
            with set_mesh(mesh):
                return spin_inverse_sharded(a, bs, leaf_solver="cuda", engine="cuda")
    elif args.lu:

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
    moved = []
    with torch.profiler.profile(activities=acts) as prof:
        for name in names:
            reset_collective_bytes()
            with torch.profiler.record_function(name):
                run()
                torch.cuda.synchronize()
            moved.append(collective_bytes())
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    suffix = next((f"_{flag}" for flag in ("gauss_jordan", "bf16", "strassen", "sharded")
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
                      trace=str(path), classes=device_classes(report),
                      collective_bytes=moved[i],
                      mesh="data2:model2 of cuda:0" if args.sharded else None)
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

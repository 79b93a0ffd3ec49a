#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build, check and time it.

    python3 chip_smoke.py            # full width: n = 16384, bs = 1024, f32

Phases, each of which fails the run (non-zero exit) on any fault:

  1. the card's name and power limit, from nvidia-smi;
  2. build every CUDA kernel of the port from src/repro_torch/kernels/csrc;
  3. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes, in f32 and bf16, and time kernel, plain version
     and the one PyTorch library call that computes the same function
     (the triangular solve at the solve's widest leaf: a 1024 x 1024
     packed LU against 1024 x 15616 right-hand sides, both sweeps);
  4. SPIN inversion, `spin_inverse_dense(engine="cuda", leaf_solver="cuda")`,
     at n = 16384, block_size = 1024: residual ‖AX − I‖∞ ≤ 1e-3, op counts
     equal to the paper's oracle, and the kernels it launched;
  5. the paper's baseline, `lu_inverse_dense`, at the same size, timed
     beside SPIN;
  6. the inverse-free solve, `spin_solve_dense(engine="cuda",
     leaf_solver="cuda")`, of the same matrix against 256 right-hand
     sides: residual ‖AX − B‖∞ / ‖B‖∞ ≤ 1e-3, the inverse-free op profile
     (no multiply, arrange or leaf inversion), and the kernels it launched
     (the GEMM and the triangular solve, nothing else);
  7. a smaller inversion with `leaf_solver="gauss_jordan"`, the path of
     the scalar Gauss-Jordan kernel;
  8. one JSON line with every path's times and residual, and one with
     every kernel's launches, error and times.

The last line is {"ok": true, "device": {...}}. The script imports only
the PyTorch port; it exits non-zero without a result when CUDA is missing
or when it is not run from a checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (NVIDIA's data sheet; dense, 700 W).
PEAK_F32_FLOPS = 67e12        # f32 outside the tensor cores
PEAK_BYTES = 3.35e12          # HBM3

RESIDUAL_BOUND = 1e-3         # f32 residual bound of the conformance table
SEED = 0
REPS = 2                      # timed runs of each inversion path
N, BLOCK_SIZE = 16384, 1024      # the main path: grid 16, four levels
N_RHS = 256                       # right-hand sides of the solve path
GJ_N, GJ_BLOCK_SIZE = 2048, 128   # the scalar Gauss-Jordan leaf's path


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gemm_bound_ms(m: int, n: int, k: int, with_c: bool, itemsize: int) -> tuple[float, str]:
    flops = 2.0 * m * n * k + (2.0 * m * n if with_c else 0.0)
    nbytes = itemsize * (m * k + k * n + m * n * (2 if with_c else 1))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def gauss_jordan_bound_ms(batch: int, bs: int, itemsize: int) -> tuple[float, str]:
    # Inverting a bs x bs matrix takes bs³ multiply-adds, 2·bs³ operations,
    # once the sweep skips the columns of [A | I] that are still zero or
    # identity.
    flops = 2.0 * batch * bs ** 3
    nbytes = 2.0 * itemsize * batch * bs * bs
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def triangular_solve_bound_ms(batch: int, bs: int, k: int,
                              itemsize: int) -> tuple[float, str]:
    # bs²/2 multiply-adds a right-hand side, bs²·k operations; T read once,
    # B read once and X written once.
    flops = float(batch) * bs * bs * k
    nbytes = itemsize * batch * (bs * bs + 2.0 * bs * k)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def max_abs(x, y) -> float:
    return float((x.float() - y.float()).abs().max())


def check_kernels(torch, rng, n_gemm: int, bs: int, gj_bs: int, tri_k: int) -> dict:
    """Phase 3: every kernel against its plain version, and its times."""
    from repro_torch.kernels.leaf_inverse import kernel as gj, ref as gj_ref
    from repro_torch.kernels.matmul import kernel as mm, ref as mm_ref
    from repro_torch.core.testing import make_spd
    import numpy as np

    dev = torch.device("cuda")
    report = {}

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    m = n = k = n_gemm
    a32, b32, c32 = normal(m, k), normal(k, n), normal(m, n)
    for dtype in (torch.float32, torch.bfloat16):
        a, b, c = a32.to(dtype), b32.to(dtype), c32.to(dtype)
        cases = {
            "matmul": (lambda: mm.matmul_cuda(a, b), lambda: mm_ref.matmul_ref(a, b),
                       lambda: torch.matmul(a, b)),
            "schur_update": (lambda: mm.schur_update_cuda(c, a, b, alpha=1.0, beta=-1.0),
                             lambda: mm_ref.schur_update_ref(c, a, b, 1.0, -1.0),
                             lambda: torch.addmm(c, a, b, beta=-1.0, alpha=1.0)),
            "schur_update_c11": (lambda: mm.schur_update_cuda(c, a, b, alpha=-1.0, beta=1.0),
                                 lambda: mm_ref.schur_update_ref(c, a, b, -1.0, 1.0),
                                 None),
        }
        for name, (kern, plain, _lib) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = max_abs(got, want)
            scale = float(want.float().abs().max())
            # f32: the two differ only in summation order, ≈ √k·ε of the
            # largest entry; bf16: both round the f32 sum once, so at most
            # one bf16 ulp (2^-7 relative) of the largest entry.
            tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * scale
            print(f"check {name} {str(dtype)[6:]} {m}x{k}x{n}: max_abs_err={err!r} "
                  f"tol={tol!r}", flush=True)
            require(got.dtype == want.dtype and got.shape == want.shape,
                    f"{name} {dtype}: dtype/shape differ from the plain version")
            require(err <= tol, f"{name} {dtype}: max_abs_err {err} > {tol}")
            if dtype == torch.float32 and name in ("matmul", "schur_update"):
                report[name] = {"max_abs_err": err}
        del got, want
    a, b, c = a32, b32, c32
    for name, with_c, kern, plain, lib in (
            ("matmul", False, lambda: mm.matmul_cuda(a, b),
             lambda: mm_ref.matmul_ref(a, b), lambda: torch.matmul(a, b)),
            ("schur_update", True, lambda: mm.schur_update_cuda(c, a, b),
             lambda: mm_ref.schur_update_ref(c, a, b),
             lambda: torch.addmm(c, a, b, beta=-1.0, alpha=1.0))):
        bound, by = gemm_bound_ms(m, n, k, with_c, 4)
        report[name].update(ms=time_ms(kern, 5), plain_ms=time_ms(plain, 5),
                            library_ms=time_ms(lib, 5), bound_ms=bound, bound_by=by,
                            shape=f"{m}x{k}x{n} f32")
    del a32, b32, c32, a, b, c
    torch.cuda.empty_cache()

    # Leaf kernels on SPD blocks, the matrices SPIN's leaves see.
    for name, size, kern, plain in (
            ("blocked_gauss_jordan", bs, gj.blocked_leaf_inverse_cuda,
             lambda x: gj_ref.blocked_gauss_jordan_ref(x, gj.default_panel(x.shape[1]))),
            ("gauss_jordan", gj_bs, gj.leaf_inverse_cuda, gj_ref.gauss_jordan_ref)):
        blocks32 = make_spd(size, rng, device=dev)[None].contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            blocks = blocks32.to(dtype)
            got, want = kern(blocks), plain(blocks)
            torch.cuda.synchronize()
            err = max_abs(got, want)
            scale = float(want.float().abs().max())
            # f32: the sweeps round as the plain version does; the blocked
            # kernel's rank-t updates sum in another order, amplified by the
            # block's condition (≈ 10). bf16: one ulp of the final cast.
            tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * scale
            print(f"check {name} {str(dtype)[6:]} 1x{size}x{size}: max_abs_err={err!r} "
                  f"tol={tol!r}", flush=True)
            require(got.dtype == want.dtype and got.shape == want.shape,
                    f"{name} {dtype}: dtype/shape differ from the plain version")
            require(bool(torch.isfinite(got.float()).all()), f"{name} {dtype}: non-finite")
            require(err <= tol, f"{name} {dtype}: max_abs_err {err} > {tol}")
            if dtype == torch.float32:
                bound, by = gauss_jordan_bound_ms(1, size, 4)
                report[name] = {
                    "max_abs_err": err, "ms": time_ms(lambda: kern(blocks), 5),
                    "plain_ms": time_ms(lambda: plain(blocks), 2),
                    "library_ms": time_ms(lambda: torch.linalg.inv(blocks), 5),
                    "bound_ms": bound, "bound_by": by, "shape": f"1x{size}x{size} f32"}

    # The triangular solve at the solve path's widest leaf: the packed LU
    # of an SPD block as torch.linalg.lu_factor_ex leaves it (column-major),
    # and the widest right-hand side the recursion hands a leaf.
    t32 = torch.linalg.lu_factor_ex(make_spd(bs, rng, device=dev))[0][None]
    b32 = normal(1, bs, tri_k)
    panel = gj.default_panel(bs)
    sweeps = {"lower_unit": (True, True), "upper": (False, False)}
    f32_errs = []
    for dtype in (torch.float32, torch.bfloat16):
        t, b = t32.to(dtype), b32.to(dtype)
        for sweep, (lower, unit) in sweeps.items():
            got = gj.triangular_solve_cuda(t, b, lower=lower, unit_diagonal=unit)
            want = gj_ref.blocked_triangular_solve_ref(t, b, panel, lower=lower,
                                                       unit_diagonal=unit)
            torch.cuda.synchronize()
            err = max_abs(got, want)
            scale = float(want.float().abs().max())
            # f32: the kernel substitutes directly inside a panel and sums
            # the panel updates left-looking, where the plain version runs
            # Gauss-Jordan sweeps and rank-t updates: the same solution,
            # rounded in another order. bf16: one ulp of the final cast.
            tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * scale
            print(f"check triangular_solve {sweep} {str(dtype)[6:]} 1x{bs}x{bs} "
                  f"k={tri_k}: max_abs_err={err!r} tol={tol!r}", flush=True)
            require(got.dtype == want.dtype and got.shape == want.shape,
                    f"triangular_solve {sweep} {dtype}: dtype/shape differ")
            require(bool(torch.isfinite(got.float()).all()),
                    f"triangular_solve {sweep} {dtype}: non-finite")
            require(err <= tol, f"triangular_solve {sweep} {dtype}: "
                                f"max_abs_err {err} > {tol}")
            if dtype == torch.float32:
                f32_errs.append(err)
        del got, want
    t, b = t32, b32
    # (kernel, plain version, library) ms of each sweep; the row reports the
    # unit-lower sweep, and the upper sweep's times ride along.
    (ms, plain_ms, library_ms), upper = (
        (time_ms(lambda: gj.triangular_solve_cuda(t, b, lower=lower, unit_diagonal=unit), 5),
         time_ms(lambda: gj_ref.blocked_triangular_solve_ref(t, b, panel, lower=lower,
                                                             unit_diagonal=unit), 1),
         time_ms(lambda: torch.linalg.solve_triangular(t, b, upper=not lower,
                                                       unitriangular=unit), 5))
        for lower, unit in sweeps.values())
    bound, by = triangular_solve_bound_ms(1, bs, tri_k, 4)
    report["triangular_solve"] = {
        "max_abs_err": max(f32_errs), "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "upper_ms": upper[0], "upper_plain_ms": upper[1],
        "upper_library_ms": upper[2], "bound_ms": bound, "bound_by": by,
        "shape": f"1x{bs}x{bs} k={tri_k} f32"}
    return report


def timed(torch, fn):
    """(result, device ms) of one call of `fn`."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def run_path(torch, name, fn, a, grid, *, expect_launches, op_oracle, reps, b=None):
    """Drive one path: one warm-up run, then one counted and timed run and
    `reps - 1` more timed runs. With `b` the path solves A X = B and is
    held to the solve residual, else it inverts A."""
    from repro_torch import kernels
    from repro_torch.core import count_ops, verify

    fn()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with count_ops() as counts:
        x, ms = timed(torch, fn)
    launches = kernels.launch_counts()
    times = [ms] + [timed(torch, fn)[1] for _ in range(reps - 1)]
    res = verify.inverse_residual(a, x) if b is None else verify.solve_residual(a, x, b)
    want = a if b is None else b
    print(f"path {name}: n={a.shape[0]} grid={grid} ms={times!r} residual={res!r} "
          f"launches={launches}", flush=True)
    require(tuple(x.shape) == tuple(want.shape) and x.dtype == want.dtype,
            f"{name}: result shape/dtype {tuple(x.shape)} {x.dtype}")
    require(bool(torch.isfinite(x).all()), f"{name}: non-finite entries")
    require(res <= RESIDUAL_BOUND, f"{name}: residual {res} > {RESIDUAL_BOUND}")
    if op_oracle:
        verify.assert_paper_op_counts(grid, counts)
    for kern, want in expect_launches.items():
        require(launches[kern] == want,
                f"{name}: {kern} launched {launches[kern]} times, want {want}")
    return {"ms": times, "residual": res, "launches": launches,
            "op_counts": counts.as_dict()}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import kernels
    from repro_torch.core import (lu_inverse_dense, spin_inverse_dense,
                                  spin_solve_dense, testing, verify)
    from repro_torch.kernels import build

    # 1. card
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s for {list(build.SOURCES)}", flush=True)

    rng = np.random.default_rng(SEED)
    n, bs = N, BLOCK_SIZE
    grid = n // bs

    # 3. kernels against their plain versions, at the main paths' shapes:
    # the top-level products are (n/2)³, the leaves bs; the solve's widest
    # leaf sees k = N_RHS + n - bs right-hand sides (the A12 columns of
    # every level ride along).
    report = check_kernels(torch, rng, n // 2, bs, GJ_BLOCK_SIZE, N_RHS + n - bs)

    # 4. SPIN at full width
    a = testing.make_spd(n, rng, device="cuda")
    spin = run_path(
        torch, "spin", lambda: spin_inverse_dense(a, bs, "cuda", engine="cuda"),
        a, grid, op_oracle=True, reps=REPS,
        expect_launches={"schur_update": 2 * (grid - 1), "matmul": 4 * (grid - 1),
                         "blocked_gauss_jordan": grid, "gauss_jordan": 0})
    require(spin["op_counts"] == verify.expected_spin_counts(grid).as_dict(),
            "spin: op counts differ from expected_spin_counts")

    # 5. LU baseline at the same size (multiplies through the matmul kernel)
    lu = run_path(torch, "lu", lambda: lu_inverse_dense(a, bs, engine="cuda"),
                  a, grid, op_oracle=False, reps=REPS,
                  expect_launches={"schur_update": 0, "blocked_gauss_jordan": 0,
                                   "gauss_jordan": 0})
    require(lu["launches"]["matmul"] > 0, "lu: the matmul kernel never ran")

    # 6. the inverse-free solve of the same matrix, 256 right-hand sides
    rhs = torch.from_numpy(rng.standard_normal((n, N_RHS), dtype=np.float32)).cuda()
    solve = run_path(
        torch, "spin_solve", lambda: spin_solve_dense(a, rhs, bs, "cuda", engine="cuda"),
        a, grid, op_oracle=False, reps=REPS, b=rhs,
        expect_launches={"triangular_solve": 2 * grid, "matmul": 2 * (grid - 1),
                         "schur_update": 0, "blocked_gauss_jordan": 0,
                         "gauss_jordan": 0})
    oc = solve["op_counts"]
    require(oc["multiplies"] == oc["arranges"] == oc["leaf_inversions"] == 0,
            f"spin_solve: not inverse-free: {oc}")
    require(oc["leaf_solves"] == grid and oc["splits"] == grid - 1
            and oc["solve_applies"] == oc["subtracts"] == 3 * (grid - 1),
            f"spin_solve: op profile {oc}")
    del a, rhs
    torch.cuda.empty_cache()

    # 7. the scalar Gauss-Jordan leaf's path
    gn, gbs = GJ_N, GJ_BLOCK_SIZE
    ggrid = gn // gbs
    a_gj = testing.make_spd(gn, rng, device="cuda")
    gjp = run_path(
        torch, "spin_gauss_jordan",
        lambda: spin_inverse_dense(a_gj, gbs, "gauss_jordan", engine="cuda"),
        a_gj, ggrid, op_oracle=True, reps=REPS,
        expect_launches={"schur_update": 2 * (ggrid - 1), "matmul": 4 * (ggrid - 1),
                         "gauss_jordan": ggrid, "blocked_gauss_jordan": 0})

    print(json.dumps({"paths": {
        "spin": {"n": n, "block_size": bs, "ms": spin["ms"], "residual": spin["residual"]},
        "lu": {"n": n, "block_size": bs, "ms": lu["ms"], "residual": lu["residual"]},
        "spin_solve": {"n": n, "block_size": bs, "n_rhs": N_RHS, "ms": solve["ms"],
                       "residual": solve["residual"]},
        "spin_gauss_jordan": {"n": gn, "block_size": gbs, "ms": gjp["ms"],
                              "residual": gjp["residual"]}},
        "card": card}), flush=True)

    # 8. the kernels line
    rows = []
    for name, source, replaces, path in (
            ("schur_update", "src/repro_torch/kernels/csrc/matmul.cu",
             "src/repro/kernels/matmul/kernel.py:131", spin),
            ("matmul", "src/repro_torch/kernels/csrc/matmul.cu",
             "src/repro/kernels/matmul/kernel.py:78", spin),
            ("blocked_gauss_jordan", "src/repro_torch/kernels/csrc/leaf_inverse.cu",
             "src/repro/kernels/leaf_inverse/kernel.py:171", spin),
            ("gauss_jordan", "src/repro_torch/kernels/csrc/leaf_inverse.cu",
             "src/repro/kernels/leaf_inverse/kernel.py:77", gjp),
            ("triangular_solve", "src/repro_torch/kernels/csrc/leaf_inverse.cu",
             "src/repro/kernels/leaf_inverse/kernel.py:270", solve)):
        r = report[name]
        require(path["launches"][name] > 0, f"{name}: no launch on its path")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": path["launches"][name], **r})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

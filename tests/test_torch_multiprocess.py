"""SPIN's sharded inversion and solve on a mesh that spans processes, on
the CPU, against a single process's mesh and the JAX package.

Each case starts its ranks once (`launch.procs.run_ranks`: gloo, a
rendezvous file of its own, every wait of the group bounded by
`torch_multiprocess_ranks.GROUP_TIMEOUT_S` and every start by SPAWN_S;
a failed or late rank kills them all). The ranks run
`torch_multiprocess_ranks.spin`, which imports only the PyTorch port; the
same function runs here on a single process's mesh of the same shape, and
the JAX package's dense `spin_inverse_dense` / `spin_solve_dense` run on
the same numpy inputs (its mesh tests raise under jax 0.9.0, so the dense
path is the reference, as for the examples' sharded runs). Meshes: 2×2
over 4 processes (a coordinate each), 2×2 over 2 and 4×2 over 4 (two
each: a `model` group lies in one process, so the others hold no
coordinate of it).

Held: every rank's result bitwise the single process's; the JAX dense
result within `verify.residual_tolerance(f32)`; the op counts and the
spec ledger equal in every rank; bytes and calls by kind summed over the
ranks equal to the single process's, but "to_dense" (each rank gets the
whole result: P times) and "replicate" (what a later process receives of
a value the first made); a ShardedBlockMatrix in and out holding the
rank's own coordinates only.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_multiprocess_ranks as ranks
from repro.core import spin_inverse_dense as j_spin_inverse_dense
from repro.core import spin_solve_dense as j_spin_solve_dense
from repro_torch.core import verify
from repro_torch.launch.mesh import Mesh, check_backend, make_worker_mesh, worker_info
from repro_torch.launch.procs import RankFailure, run_ranks

TOL = verify.residual_tolerance(torch.float32)
SPAWN_S = 180.0                    # a spawn's ranks, start to finish
CHILD = str(Path(__file__).with_name("torch_multiprocess_ranks.py"))
# (mesh shape, processes)
CASES = [pytest.param(((2, 2), 4), id="2x2-over-4"),
         pytest.param(((2, 2), 2), id="2x2-over-2"),
         pytest.param(((4, 2), 4), id="4x2-over-4")]
RUNS = [f"{kind}_{engine}" for engine, _ in ranks.SPIN_RUNS
        for kind in ("inverse", "solve")]


def spawn(case: str, nprocs: int, timeout_s: float = SPAWN_S, **kwargs) -> list:
    return run_ranks([sys.executable, CHILD, case, json.dumps(kwargs)], nprocs,
                     timeout_s=timeout_s)


@pytest.fixture(scope="module", params=CASES)
def spin_run(request):
    (shape, nprocs) = request.param
    total = shape[0] * shape[1]
    got = spawn("spin", nprocs, shape=list(shape), devices=total // nprocs)
    ref = ranks.run_here("spin", shape=list(shape), devices=total)
    return shape, nprocs, got, ref


@pytest.fixture(scope="module")
def jax_reference():
    n, bs, seed = 256, 32, 3
    a = ranks._spd(n, seed).numpy()
    b = ranks._normal((n, 8), seed + 1).numpy()
    return (a, b, np.asarray(j_spin_inverse_dense(jnp.asarray(a), bs)),
            np.asarray(j_spin_solve_dense(jnp.asarray(a), jnp.asarray(b), bs)))


@pytest.mark.parametrize("run", RUNS)
def test_every_rank_gets_the_single_process_bits(spin_run, run):
    _, _, got, ref = spin_run
    for rank in got:
        assert torch.equal(rank[run]["x"], ref[run]["x"]), run


@pytest.mark.parametrize("run", RUNS)
def test_ranks_hold_the_references_residual(spin_run, jax_reference, run):
    a, b, inv, sol = jax_reference
    x = spin_run[2][0][run]["x"]
    if run.startswith("inverse"):
        assert verify.inverse_residual(torch.from_numpy(a), x) < TOL
        assert float(np.abs(x.numpy() - inv).max()) < TOL
    else:
        assert verify.solve_residual(torch.from_numpy(a), x, torch.from_numpy(b)) < TOL
        assert float(np.abs(x.numpy() - sol).max()) < TOL * float(np.abs(sol).max())


def test_op_counts_and_spec_ledger_are_the_single_processs(spin_run):
    _, _, got, ref = spin_run
    for rank in got:
        for run in RUNS:
            assert rank[run]["ops"] == ref[run]["ops"], run
            assert rank[run]["specs"] == ref[run]["specs"], run
            if run.startswith("inverse"):     # the paper's 6/2/1 a level
                assert rank[run]["ops"] == verify.expected_spin_counts(256 // 32).as_dict()


def test_bytes_and_calls_sum_to_the_single_processs(spin_run):
    _, nprocs, got, ref = spin_run
    for run in RUNS:
        for idx, what in enumerate(("bytes", "calls")):
            summed = {k: sum(rank[run][what][k] for rank in got) for k in ref[run][what]}
            want = dict(ref[run][what], to_dense=nprocs * ref[run][what]["to_dense"])
            assert {k: v for k, v in summed.items() if k != "replicate"} == \
                {k: v for k, v in want.items() if k != "replicate"}, (run, what)
            assert ref[run][what]["replicate"] == 0
            assert all(rank[run]["summed"][idx] == summed for rank in got), run
            assert summed["gather"] > 0 and summed["replicate"] > 0
            assert (summed["ring"] > 0) == (run == "inverse_ring")


def test_sharded_operands_hold_the_ranks_coordinates_only(spin_run):
    shape, nprocs, got, ref = spin_run
    per = shape[0] * shape[1] // nprocs
    coords = [tuple(c) for c in np.ndindex(*shape)]
    owners = ",".join(f"p{i // per}/cpu" for i in range(len(coords)))
    for p, rank in enumerate(got):
        # this process's identity and the gathered devices: one CPU a rank
        assert rank["info"] == [p, nprocs, 1, nprocs]
        assert rank["fingerprint"] == ref["fingerprint"].split("@")[0] + "@" + owners
        mine = coords[p * per:(p + 1) * per]       # a contiguous row-major block
        assert [tuple(c) for c in rank["local"]] == mine
        assert [tuple(c) for c in rank["sharded"]["in"]] == mine
        assert [tuple(c) for c in rank["sharded"]["out"]] == mine
        assert torch.equal(rank["sharded"]["x"], ref["inverse_cuda"]["x"])


def test_a_rank_that_raises_fails_the_parent_with_its_traceback():
    """As the reference's `test_child_failure_marshals_traceback`."""
    with pytest.raises(RankFailure, match="rank 1 fails on purpose"):
        spawn("fail_early", 2, timeout_s=60)


def test_a_rank_that_raises_mid_collective_fails_the_parent_in_time():
    with pytest.raises(RankFailure, match="between two collectives"):
        spawn("fail_mid_collective", 2, timeout_s=60)


def test_a_rank_that_skips_a_collective_fails_the_parent_in_time():
    """Rank 1 returns without the second psum: rank 0 waits on it until its
    peer has gone, and the spawn fails rather than hangs."""
    with pytest.raises(RankFailure):
        spawn("skip_collective", 2, timeout_s=60)


def test_nccl_refuses_two_ranks_on_one_card():
    card = ("host", "cuda:0", "GPU-0")
    other = ("host", "cuda:1", "GPU-1")
    check_backend("nccl", [[card], [other]])
    check_backend("gloo", [[card], [card], [card]])
    with pytest.raises(ValueError, match="one process per card: processes 0 and 1"):
        check_backend("nccl", [[card], [card]])
    with pytest.raises(ValueError, match="needs a card"):
        check_backend("nccl", [[("host", "cpu", None)], [other]])
    with pytest.raises(ValueError, match="backend"):
        check_backend("mpi", [[card]])
    # the same card id on two hosts is two cards
    check_backend("nccl", [[card], [("other-host", "cuda:0", "GPU-0")]])


def test_a_single_process_is_process_0_of_1_with_every_coordinate_local():
    mesh = make_worker_mesh((2, 2), devices=["cpu"] * 4)
    assert not mesh.spans_processes and mesh.processes == [0]
    assert mesh.local_coords() == mesh.coords()
    assert mesh.places() == [(0, torch.device("cpu"))]
    assert mesh.home((0, torch.device("cpu"))) == (0, 0)
    info = worker_info()
    assert info.process_count == 1 and info.global_device_count >= 1


def test_a_mesh_maps_each_coordinate_to_its_process():
    mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], processes=[[0, 0], [1, 1]])
    assert mesh.spans_processes and mesh.processes == [0, 1]
    assert mesh.local_coords() == [(0, 0), (0, 1)]
    assert [mesh.process(c) for c in mesh.coords()] == [0, 0, 1, 1]
    assert mesh.places() == [(0, torch.device("cpu")), (1, torch.device("cpu"))]
    assert mesh.home((1, torch.device("cpu"))) == (1, 0)
    assert not mesh.is_local((1, 0)) and mesh.is_local((0, 1))
    with pytest.raises(ValueError, match="holds no coordinate"):
        Mesh([["cpu"], ["cpu"]], processes=[[1], [2]])

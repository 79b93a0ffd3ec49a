"""The cost model: the port's copy against the JAX package's.

Every function takes the same arguments in both packages and must give the
same value: exactly for the counts, within 1e-12 relative for the floats.
The port's `roofline_cost` is the reference's `tpu_roofline_cost` formula
with the card's peaks (`H100_SXM`) in place of the TPU's.
"""

import dataclasses
import math

import pytest

from repro.core import costmodel as ref
from repro_torch.core import costmodel as cm

SIZES = [(1024, 2), (4096, 8), (16384, 16), (16384, 64)]


def _close(got, want) -> bool:
    return got == want or math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0)


def _same_dict(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        _close(got[k], want[k]) if isinstance(want[k], float) else got[k] == want[k]
        for k in want)


def test_constants_equal_reference():
    assert cm.STRASSEN_CUTOFF == ref.STRASSEN_CUTOFF == 512
    assert cm.DTYPE_BYTES == ref.DTYPE_BYTES
    ours, theirs = cm.CostParams(n=64, b=4, cores=2), ref.CostParams(n=64, b=4, cores=2)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.levels, ours.block_size) == (theirs.levels, theirs.block_size)


@pytest.mark.parametrize("cores", [1, 8, 256])
@pytest.mark.parametrize("n,b", SIZES)
@pytest.mark.parametrize("model", ["spin_cost", "lu_cost", "strassen_cost"])
def test_paper_models_equal_reference(model, n, b, cores):
    kw = dict(t_flop=2e-12, t_block_op=3e-6, t_elem=5e-11, t_leaf=7e-12)
    got = getattr(cm, model)(cm.CostParams(n=n, b=b, cores=cores, **kw))
    want = getattr(ref, model)(ref.CostParams(n=n, b=b, cores=cores, **kw))
    assert _same_dict(got, want)


@pytest.mark.parametrize("cutoff", [1, 64, 512, 2048])
@pytest.mark.parametrize("n", [7, 512, 513, 1024, 16384, 32768])
def test_strassen_counts_equal_reference(n, cutoff):
    assert (cm.strassen_multiply_counts(n, cutoff)
            == ref.strassen_multiply_counts(n, cutoff))


@pytest.mark.parametrize("kwargs", [
    {}, dict(cutoff=128), dict(cutoff=4096), dict(t_elem=1e-11),
    dict(add_weight=30.0, t_elem=1e-8), dict(max_n=256)])
def test_strassen_crossover_equals_reference(kwargs):
    assert cm.strassen_crossover_n(**kwargs) == ref.strassen_crossover_n(**kwargs)


@pytest.mark.parametrize("n,block_size", [(1024, 128), (16384, 1024), (64, 64)])
def test_schedule_equals_reference(n, block_size):
    assert cm.spin_schedule(n, block_size) == ref.spin_schedule(n, block_size)


@pytest.mark.parametrize("scheme", ["vandermonde", "replication"])
@pytest.mark.parametrize("workers,redundancy", [(4, 0), (4, 1), (8, 3)])
def test_coded_pricing_equals_reference(workers, redundancy, scheme):
    assert _close(cm.coded_work_multiplier(workers, redundancy, scheme),
                  ref.coded_work_multiplier(workers, redundancy, scheme))
    kw = dict(scheme=scheme, straggler_prob=0.1, straggler_slowdown=5.0,
              decode_s=0.01)
    assert _close(cm.coded_completion_cost(2.0, workers, redundancy, **kw),
                  ref.coded_completion_cost(2.0, workers, redundancy, **kw))
    assert (cm.plan_redundancy(workers, straggler_prob=0.2, scheme=scheme)
            == ref.plan_redundancy(workers, straggler_prob=0.2, scheme=scheme))


def test_coded_pricing_rejects_bad_arguments_as_reference():
    for module in (cm, ref):
        with pytest.raises(ValueError):
            module.coded_work_multiplier(4, 4)
        with pytest.raises(ValueError):
            module.coded_work_multiplier(4, 1, "fountain")


@pytest.mark.parametrize("dtype_bytes", [1, 2, 4])
@pytest.mark.parametrize("chips", [1, 4, 16])
@pytest.mark.parametrize("n,b", SIZES)
def test_roofline_equals_reference_formula(n, b, chips, dtype_bytes):
    got = cm.roofline_cost(n, b, chips, dtype_bytes=dtype_bytes, hw=cm.H100_SXM)
    want = ref.tpu_roofline_cost(n, b, chips, dtype_bytes=dtype_bytes,
                                 hw=cm.H100_SXM)
    assert _same_dict(got, want)
    assert got == cm.roofline_cost(n, b, chips, dtype_bytes=dtype_bytes)
    if chips == 1:
        assert got["bytes_ici"] == got["t_collective"] == 0.0


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("n,cols,chips", [(16384, 256, 1), (4096, 1, 4)])
def test_apply_inverse_cost_equals_reference(n, cols, chips, dtype_bytes):
    got = cm.apply_inverse_cost(n, cols, chips, dtype_bytes=dtype_bytes)
    want = ref.apply_inverse_cost(n, cols, chips, dtype_bytes=dtype_bytes,
                                  hw=cm.H100_SXM)
    assert _close(got, want)


def test_h100_peaks_are_the_data_sheet():
    hw = cm.H100_SXM
    assert (hw["peak_flops"], hw["peak_flops_tf32"], hw["peak_flops_f32"],
            hw["hbm_bw"]) == (989e12, 495e12, 67e12, 3.35e12)
    # One 16384 f32 inversion at the 3xTF32 rate: the compute term bounds it.
    f32 = {**hw, "peak_flops": hw["peak_flops_tf32"] / 3}
    cost = cm.roofline_cost(16384, 16, 1, dtype_bytes=4, hw=f32)
    assert cost["bottleneck"] == "compute"


@pytest.mark.parametrize("model", ["spin_cost", "strassen_cost"])
def test_fit_scale_equals_reference(model):
    truth = dict(t_flop=2e-12, t_leaf=5e-12, t_block_op=1e-6, t_elem=3e-11)
    measured = {b: getattr(ref, model)(ref.CostParams(
        n=4096, b=b, cores=8, **truth))["total"] for b in (2, 4, 8, 16, 32)}
    got = cm.fit_scale(getattr(cm, model), measured, 4096, 8)
    want = ref.fit_scale(getattr(ref, model), measured, 4096, 8)
    assert got.n == want.n and got.b == want.b and got.cores == want.cores
    for field in ("t_flop", "t_leaf", "t_block_op", "t_elem"):
        assert _close(getattr(got, field), getattr(want, field))

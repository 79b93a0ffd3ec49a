"""The port's int8 gradient compression against the JAX package's, on the CPU.

`quantize_int8` and `error_feedback_update` must give the reference's
bits on the same f32 input (both round half to even). `compressed_psum`
runs over a 4-coordinate `pod` mesh of the CPU and is held to the
reference's value from a 4-device subprocess: the int32 sum is exact, so
the two agree to one rounding of the final rescale (1e-6 of the largest
entry), and both lie within the reference test's 5 % of the exact sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from mesh_harness import run_mesh
from repro.parallel import compression as j_comp
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.parallel import collective_bytes, collectives as col, reset_collective_bytes
from repro_torch.parallel.compression import (compressed_psum, dequantize_int8,
                                              error_feedback_update, quantize_int8)

PSUM_RTOL = 0.05      # tests/test_distributed.py:154, int8 quantization


def _f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_int8_quantization_bound(seed):
    """Twin of tests/test_costmodel_sharding.py::test_int8_quantization_bound."""
    x = torch.from_numpy(_f32(np.random.default_rng(seed), (256,), 5.0))
    q, s = quantize_int8(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.ndim == 0
    err = torch.max(torch.abs(dequantize_int8(q, s) - x))
    assert float(err) <= float(s) * 0.5 + 1e-6   # half-ulp rounding


def test_error_feedback_is_unbiased_over_steps():
    """Twin of tests/test_costmodel_sharding.py::
    test_error_feedback_is_unbiased_over_steps."""
    rng = np.random.default_rng(0)
    true_sum = torch.zeros(64)
    deq_sum = torch.zeros(64)
    resid = None
    for _ in range(50):
        g = torch.from_numpy(_f32(rng, (64,)))
        true_sum = true_sum + g
        deq, resid = error_feedback_update(g, resid)
        deq_sum = deq_sum + deq
    assert float(torch.max(torch.abs(true_sum - deq_sum - resid))) < 1e-4


@pytest.mark.parametrize("seed,scale,n", [(0, 1.0, 256), (1, 5.0, 4096), (2, 1e-3, 1000),
                                          (3, 300.0, 77)])
def test_quantize_int8_is_the_references_bits(seed, scale, n):
    x = _f32(np.random.default_rng(seed), (n,), scale)
    x[::7] = np.round(x[::7])        # exact integers and halves meet the rounding
    x[3] = 0.0
    jq, js = j_comp.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(j_comp.dequantize_int8(jq, js)))


def test_round_half_to_even_on_both_sides():
    """A scale of 1 (max |x| = 127 - 1e-12·127 rounds to 127) puts exact
    halves under the rounding: both packages send 0.5 to 0, 1.5 and 2.5
    to 2."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 127.0], np.float32)
    jq, _ = j_comp.quantize_int8(jnp.asarray(x))
    q, _ = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.tolist()[:5] == [0, 2, 2, 0, -2]


def test_error_feedback_update_is_the_references_bits():
    rng = np.random.default_rng(4)
    resid = jresid = None
    for _ in range(5):
        g = _f32(rng, (512,), 3.0)
        deq, resid = error_feedback_update(torch.from_numpy(g), resid)
        jdeq, jresid = j_comp.error_feedback_update(jnp.asarray(g), jresid)
        np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
        np.testing.assert_array_equal(resid.numpy(), np.asarray(jresid))


_CHILD = """
import functools, json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import AxisType, make_mesh, set_mesh, shard_map
from repro.parallel.compression import compressed_psum

x = jnp.asarray(np.asarray(json.loads(X), np.float32))
mesh = make_mesh((4,), ("pod",), axis_types=(AxisType.Auto,))
with set_mesh(mesh):
    got = jax.jit(shard_map(functools.partial(compressed_psum, axis_name="pod"),
                            mesh=mesh, in_specs=P("pod", None),
                            out_specs=P("pod", None), check_vma=False))(x)
emit_result(np.asarray(got).tolist())
"""


def test_compressed_psum_matches_the_reference_on_a_pod_mesh():
    """Twin of tests/test_distributed.py::test_compressed_psum_pod_axis: 4
    coordinates of 64 values each; every coordinate holds the same sum,
    the reference's, within 5 % of the exact sum, and only one byte an
    element crosses between coordinates."""
    import json

    rng = np.random.default_rng(5)
    x = _f32(rng, (4, 64))
    x[2] *= 10.0                       # one coordinate sets the shared scale
    [want] = run_mesh(_CHILD.replace("X", repr(json.dumps(x.tolist()))), devices=4)
    want = np.asarray(want, np.float32).reshape(4, 64)
    mesh = make_worker_mesh((4,), ("pod",), devices=["cpu"] * 4)
    xs = col.split(torch.from_numpy(x), ("pod", None), mesh)
    reset_collective_bytes()
    got = compressed_psum(xs, "pod", mesh)
    moved = collective_bytes()
    exact = x.sum(0)
    for i, c in enumerate(mesh.coords()):
        g = got[c].reshape(-1).numpy()
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, want[i], rtol=0, atol=1e-6 * np.abs(want).max())
        assert np.abs(g - exact).max() / np.abs(exact).max() < PSUM_RTOL
    # int8 payloads: 3 pieces of 64 bytes into each of 4 coordinates, and
    # the scales' pmax (4-byte scalars)
    assert moved["all_gather"] == 4 * 3 * 64
    assert moved["pmax"] == 2 * 3 * 4 and moved["psum"] == 0


def test_compressed_psum_refuses_foreign_coordinates():
    mesh = make_worker_mesh((4,), ("pod",), devices=["cpu"] * 4)
    xs = {(i,): torch.ones(8) for i in range(3)}
    with pytest.raises(ValueError, match="coordinates"):
        compressed_psum(xs, "pod", mesh)
    with pytest.raises(ValueError, match="no axis"):
        compressed_psum({c: torch.ones(8) for c in mesh.coords()}, "data", mesh)

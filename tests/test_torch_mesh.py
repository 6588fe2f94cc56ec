"""pysco_tpu_torch.ops.mesh against pysco_tpu.ops.mesh on the same numpy
inputs (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pysco_tpu.ops import mesh as jmesh
from pysco_tpu_torch.ops import mesh

torch.set_num_threads(1)


def test_periodic_wrap_matches():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.2, 1.2, (4, 2000)).astype(np.float32)
    # float32-epsilon negatives, exact edges and sentinel columns
    x[0, :6] = [-1e-9, -2.9e-8, 0.0, 1.0, 2.0, 1.5]
    want = np.array(jmesh.periodic_wrap(jnp.asarray(x)))
    got = mesh.periodic_wrap(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [2, 3, 5, 7])
@pytest.mark.parametrize("leading", [False, True])
def test_derivative_matches(order, leading):
    a = np.random.default_rng(order).standard_normal((16, 16, 16)).astype(
        np.float32)
    want = np.array(jmesh.derivative(jnp.asarray(a), order, leading))
    got = mesh.derivative(torch.as_tensor(a), order, leading).numpy()
    assert got.shape == want.shape
    # the same float32 expression term by term: equal to an ulp or two
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("scheme", ["ngp", "cic", "tsc"])
@pytest.mark.parametrize("n", [16, 32])
def test_scatter_deposit_matches(scheme, n):
    pos = np.random.default_rng(n).random((3000, 3), dtype=np.float32)
    want = np.array(jmesh.deposit(jnp.asarray(pos), n, scheme))
    got = mesh.deposit(torch.as_tensor(pos), n, scheme).numpy()
    # identical weights; scatter-add order may differ: float32 ulps of
    # cell sums of order 1-10
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.astype(np.float64).sum(), 3000,
                               rtol=1e-6)


@pytest.mark.parametrize("scheme", ["ngp", "cic", "tsc"])
def test_scatter_gather_matches(scheme):
    n = 16
    rng = np.random.default_rng(7)
    pos = rng.random((2000, 3), dtype=np.float32)
    grid = rng.standard_normal((n, n, n)).astype(np.float32)
    vec = rng.standard_normal((n, n, n, 3)).astype(np.float32)
    want = np.array(jmesh.gather(jnp.asarray(grid), jnp.asarray(pos), scheme))
    got = mesh.gather(torch.as_tensor(grid), torch.as_tensor(pos),
                      scheme).numpy()
    # same terms summed in the same order
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want = np.array(jmesh.gather_vec(jnp.asarray(vec), jnp.asarray(pos),
                                     scheme))
    got = mesh.gather_vec(torch.as_tensor(vec), torch.as_tensor(pos),
                          scheme).numpy()
    assert got.shape == (2000, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _morton_positions():
    """Seeded positions with the edge cases of the key: 0, the float32
    values next to 1, 1 itself (clipped into the last cell), exact ties
    and cells one key apart."""
    rng = np.random.default_rng(21)
    pos = rng.random((4000, 3), dtype=np.float32)
    below_one = np.nextafter(np.float32(1), np.float32(0))
    pos[0] = 0.0
    pos[1] = below_one
    pos[2] = [0.0, below_one, 0.5]
    pos[3] = 1.0
    pos[4] = np.float32(2.0 ** -21)
    pos[5] = np.nextafter(np.float32(2.0 ** -21), np.float32(0))
    pos[100:200] = pos[200:300]        # ties: a stable sort keeps their order
    pos[300:400, 0] = pos[400:500, 0]  # equal in one axis only
    return pos


def test_morton_keys_match():
    pos = _morton_positions()
    want = np.array(jmesh.morton_keys(jnp.asarray(pos)))
    got = mesh.morton_keys(torch.as_tensor(pos))
    assert want.dtype == np.uint64 and got.dtype == torch.int64
    # 63-bit keys: int64 holds the same integers, in the same order
    assert int(want.max()) < 2 ** 63
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)
    assert int(got[3]) == 2 ** 63 - 1 and int(got[0]) == 0


def test_reorder_particles_matches():
    pos = _morton_positions()
    rng = np.random.default_rng(22)
    vel = rng.standard_normal(pos.shape).astype(np.float32)
    tag = np.arange(pos.shape[0], dtype=np.int32)
    want = [np.array(a) for a in jmesh.reorder_particles(
        jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(tag))]
    got = mesh.reorder_particles(torch.as_tensor(pos), torch.as_tensor(vel),
                                 torch.as_tensor(tag))
    assert len(got) == 3
    # the same permutation, ties included (both sorts are stable)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    keys = mesh.morton_keys(got[0])
    assert bool((keys[1:] >= keys[:-1]).all())

"""The multigrid stencil kernels' plain twins (pysco_tpu_torch.ops.stencil)
against the JAX package's Pallas kernels (pysco_tpu.ops.pallas_stencil,
interpret mode on the CPU), and the packed red-black layout and smoother
of pysco_tpu_torch.models.laplacian against pysco_tpu.models.laplacian,
on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysco_tpu.models import laplacian as jlap
from pysco_tpu.ops import mesh as jmesh
from pysco_tpu.ops import pallas_stencil as ps
from pysco_tpu_torch.models import laplacian as lap
from pysco_tpu_torch.ops import mesh, stencil

torch.set_num_threads(1)

Q = -0.27
KINDS = [("linear", None), ("laplacian", None), ("reformulated", None),
         ("cubic", Q), ("quartic", Q)]


def _fields(n, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n, n)).astype(np.float32)
    b = (5 * rng.standard_normal((n, n, n))).astype(np.float32)
    rhs = (0.3 * rng.standard_normal((n, n, n))).astype(np.float32)
    return x, b, rhs


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# Packed red-black layout: bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 16, 32])
def test_pack_unpack_bitwise(n):
    x, _, _ = _fields(n, 1)
    jr, jb = jlap.pack_rb(jnp.asarray(x))
    tr, tb = lap.pack_rb(torch.as_tensor(x))
    np.testing.assert_array_equal(tr.numpy(), np.array(jr))
    np.testing.assert_array_equal(tb.numpy(), np.array(jb))
    np.testing.assert_array_equal(lap.unpack_rb(tr, tb).numpy(), x)


@pytest.mark.parametrize("to_red", [True, False])
@pytest.mark.parametrize("n", [4, 16])
def test_packed_neighbour_sum_bitwise(n, to_red):
    x, _, _ = _fields(n, 2)
    src = jlap.pack_rb(jnp.asarray(x))[1 if to_red else 0]
    want = jlap.packed_neighbour_sum(src, to_red)
    got = lap.packed_neighbour_sum(torch.as_tensor(np.array(src)), to_red)
    np.testing.assert_array_equal(got.numpy(), np.array(want))


# ---------------------------------------------------------------------------
# Each twin against its Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_rhs", [False, True])
@pytest.mark.parametrize("to_red", [True, False])
def test_half_sweep_twin_matches_pallas(to_red, with_rhs):
    n = 16
    x, b, rhs = _fields(n, 4)
    red, black = lap.pack_rb(torch.as_tensor(x))
    h2b = lap.pack_rb(torch.as_tensor(np.float32(1 / (n * n)) * b))
    rhs_p = lap.pack_rb(torch.as_tensor(rhs)) if with_rhs else (None, None)
    src, dst = (black, red) if to_red else (red, black)
    c = 0 if to_red else 1
    got = stencil.half_sweep(src, dst, h2b[c], to_red, 1.25, rhs_p[c])
    want = ps.half_sweep(_j(src.numpy()), _j(dst.numpy()), _j(h2b[c].numpy()),
                         to_red, 1.25,
                         None if rhs_p[c] is None else _j(rhs_p[c].numpy()))
    # the same expression; XLA may contract a product and a sum into one
    # FMA where the twin rounds twice (the bound of tests/test_pallas_stencil)
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=2e-6,
                               atol=2e-6)


def _scalaron_inputs(n, seed):
    """tests/test_pallas_stencil.py's well-conditioned scalaron state:
    u0 ~ 0.2 with |p| << 3 u0^2, so a float32 ulp in the neighbour sum
    cannot flip the Newton trajectory (near-critical cells amplify ulps
    without bound, a property of the equation)."""
    x, b, _ = _fields(n, seed)
    u0 = (np.abs(x) * np.float32(0.003) + np.float32(0.2)).astype(np.float32)
    return u0, (b * np.float32(0.1)).astype(np.float32)


@pytest.mark.parametrize("to_red", [True, False])
@pytest.mark.parametrize("plane", [False, True])
@pytest.mark.parametrize("n_power,q,rhs_scale", [(2, -0.1, 1e-3),
                                                 (3, -0.05, 1e-4)])
def test_scalaron_half_sweep_twin_matches_pallas(n_power, q, rhs_scale,
                                                 plane, to_red):
    """Kernel 4's twin against pallas_stencil.scalaron_half_sweep (the
    f(R) n = 1 and n = 2 sweeps; c0 a scalar, or a plane with the FAS
    rhs folded in)."""
    n = 16
    u0, b = _scalaron_inputs(n, 3)
    red, black = lap.pack_rb(torch.as_tensor(u0))
    hb = lap.pack_rb(torch.as_tensor(np.float32(1 / (n * n)) * b))
    c = 0 if to_red else 1
    src, dst = (black, red) if to_red else (red, black)
    c0 = float(np.float32(1 / (n * n)) * np.float32(q))
    if plane:
        rhs = (rhs_scale * np.random.default_rng(5).standard_normal(
            (n, n, n))).astype(np.float32)
        coef = c0 - lap.pack_rb(torch.as_tensor(rhs))[c]
        jcoef = _j(coef.numpy())
    else:
        coef, jcoef = c0, jnp.float32(c0)
    got = stencil.scalaron_half_sweep(src, dst, hb[c], coef, to_red, 1.25,
                                      n_power)
    want = np.array(ps.scalaron_half_sweep(
        _j(src.numpy()), _j(dst.numpy()), _j(hb[c].numpy()), jcoef, to_red,
        1.25, n_power))
    # the same expressions; XLA contracts some products and sums into
    # FMAs where the twin rounds twice: at most 4 float32 ulps, 1e-6
    ulps = np.abs(got.numpy() - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 4, ulps.max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_scalaron_half_sweep_rejects_other_devices():
    x = torch.zeros((8, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        stencil.scalaron_half_sweep(x, torch.zeros((8, 4, 8)), x, 0.0, True,
                                    1.25, 2)


@pytest.mark.parametrize("with_rhs", [False, True])
@pytest.mark.parametrize("kind,q", KINDS)
def test_residual_norm2_twin_matches_pallas(kind, q, with_rhs):
    x, b, rhs = _fields(16)
    b = None if kind == "laplacian" else b
    rhs = rhs if with_rhs else None
    got = float(stencil.residual_norm2(kind, _t(x), _t(b), _t(rhs), q=q))
    want = float(ps.residual_norm2(kind, _j(x), _j(b), _j(rhs), q=q))
    # summation order differs (per plane block there, pairwise here)
    assert abs(got - want) / want < 5e-6, (kind, got, want)


@pytest.mark.parametrize("with_rhs", [False, True])
@pytest.mark.parametrize("kind,q", KINDS)
def test_restrict3_twin_matches_pallas(kind, q, with_rhs):
    x, b, rhs = _fields(16)
    b = None if kind == "laplacian" else b
    rhs = rhs if with_rhs else None
    got = stencil.restrict3(kind, _t(x), _t(b), _t(rhs), q=q)
    want = ps.restrict3(kind, _j(x), _j(b), _j(rhs), q=q)
    assert len(got) == len(want) == (2 if kind == "laplacian" else 3)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 2e-6, kind
    (only,) = stencil.restrict3(kind, _t(x), _t(b), _t(rhs), q=q,
                                residual_only=True)
    assert torch.equal(only, got[0])


@pytest.mark.parametrize("n", [8, 16, 24])
def test_add_prolongation_twin_matches_pallas(n):
    x, _, _ = _fields(n, 5)
    xc = np.random.default_rng(9).standard_normal(
        (n // 2,) * 3).astype(np.float32)
    got = stencil.add_prolongation(torch.as_tensor(x), torch.as_tensor(xc))
    assert _rel(got.numpy(), ps.add_prolongation(_j(x), _j(xc))) < 2e-6
    # the XLA form of the JAX package: the same products and sums
    np.testing.assert_array_equal(
        got.numpy(), np.array(_j(x) + jmesh.prolongation(_j(xc))))
    assert torch.equal(mesh.add_prolongation(torch.as_tensor(x),
                                             torch.as_tensor(xc)), got)


@pytest.mark.parametrize("n", [4, 6])
def test_add_prolongation_small_grids_match_jax(n):
    """The grids below the Pallas kernel's blocks (the card's plane march
    takes n = 4, its per-cell kernel n = 6): the twin is bitwise the JAX
    package's XLA form."""
    x, _, _ = _fields(n, 5)
    xc = np.random.default_rng(9).standard_normal(
        (n // 2,) * 3).astype(np.float32)
    got = stencil.add_prolongation(torch.as_tensor(x), torch.as_tensor(xc))
    np.testing.assert_array_equal(
        got.numpy(), np.array(_j(x) + jmesh.prolongation(_j(xc))))


@pytest.mark.parametrize("n", [4, 16, 32])
def test_transfer_operators_match_jax(n):
    x, _, _ = _fields(n, 6)
    # reduce_window sums the 8 children in another order: float32 ulps
    assert _rel(mesh.restriction(torch.as_tensor(x)).numpy(),
                jmesh.restriction(_j(x))) < 2e-7
    assert torch.equal(mesh.minus_restriction(torch.as_tensor(x)),
                       -mesh.restriction(torch.as_tensor(x)))
    np.testing.assert_array_equal(
        mesh.prolongation(torch.as_tensor(x)).numpy(),
        np.array(jmesh.prolongation(_j(x))))


def test_wrappers_reject_other_devices():
    x = torch.zeros((8, 8, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        stencil.residual_norm2("linear", x, x)
    with pytest.raises(ValueError, match="no kernel"):
        stencil.add_prolongation(torch.zeros((8, 8, 8)),
                                 torch.zeros((4, 4, 4), device="meta"))


# ---------------------------------------------------------------------------
# Smoothers and operators of models/laplacian.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_rhs", [False, True])
@pytest.mark.parametrize("n_smoothing", [1, 3])
def test_smoothing_packed_matches_jax(n_smoothing, with_rhs):
    x, b, rhs = _fields(16, 7)
    rhs = rhs if with_rhs else None
    got = lap._smoothing_packed(_t(x), _t(b), n_smoothing, _t(rhs))
    want = jlap._smoothing_packed(_j(x), _j(b), n_smoothing, _j(rhs))
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=2e-6,
                               atol=2e-6)
    # the masked full-lattice sweep is the oracle of the packed one
    oracle = _t(x)
    for _ in range(n_smoothing):
        oracle = (lap.gauss_seidel(oracle, _t(b)) if rhs is None else
                  lap.gauss_seidel_with_rhs(oracle, _t(b), _t(rhs)))
    np.testing.assert_array_equal(got.numpy(), oracle.numpy())


def test_errors_and_operators_match_jax():
    x, b, rhs = _fields(16, 10)
    jx, jb = _j(x), _j(b)
    tx, tb = _t(x), _t(b)
    for got, want in (
            (lap.operator(tx), jlap.operator(jx)),
            (lap.operator_reformulated(tx, tb),
             jlap.operator_reformulated(jx, jb)),
            (lap.residual(tx, tb), jlap.residual(jx, jb)),
            (lap.initialise_potential(tb), jlap.initialise_potential(jb))):
        np.testing.assert_array_equal(got.numpy(), np.array(want))
    assert _rel(lap.restrict_residual(tx, tb).numpy(),
                jlap.restrict_residual(jx, jb)) < 2e-6
    for got, want in (
            (lap.residual_error(tx, tb), jlap.residual_error(jx, jb)),
            (lap.residual_error_reformulated(tx, tb),
             jlap.residual_error_reformulated(jx, jb)),
            (lap.truncation_error(tx), jlap.truncation_error(jx)),
            (lap.truncation_error_reformulated(tx, tb),
             jlap.truncation_error_reformulated(jx, jb))):
        assert got.shape == () and got.dtype == torch.float32
        assert abs(float(got) - float(want)) / float(want) < 5e-6

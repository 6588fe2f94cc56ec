"""The port's multigrid solver (pysco_tpu_torch.models.multigrid) and the
QUMOND source (pysco_tpu_torch.models.mond) against the JAX package's on
the same numpy inputs (CPU: the port runs its plain twins, the JAX
package its XLA path)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysco_tpu.models import laplacian as jlap
from pysco_tpu.models import mond as jmond
from pysco_tpu.models import multigrid as jmg
from pysco_tpu_torch.models import laplacian as lap
from pysco_tpu_torch.models import mond, multigrid as mg
from pysco_tpu_torch.ops import fourier, stencil

torch.set_num_threads(1)

NCOARSE = 4  # 16^3 fine grid, 4^3 coarsest
CYCLES = {"V": (mg.V_cycle, jmg.V_cycle), "F": (mg.F_cycle, jmg.F_cycle),
          "W": (mg.W_cycle, jmg.W_cycle)}
FAS_CYCLES = {"V": (mg.V_cycle_FAS, jmg.V_cycle_FAS),
              "F": (mg.F_cycle_FAS, jmg.F_cycle_FAS),
              "W": (mg.W_cycle_FAS, jmg.W_cycle_FAS)}


def _fields(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, n, n)).astype(np.float32)
    b = (5 * rng.standard_normal((n, n, n))).astype(np.float32)
    return x, b - b.mean()


def _close(got, want):
    # the bounds of tests/test_pallas_stencil.py for whole cycles: float32
    # roundoff of the operators (restriction order, FMA contraction)
    # carried through a few levels of smoothing
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=5e-5,
                               atol=5e-6)


@pytest.mark.parametrize("cycle", ["V", "F", "W"])
def test_linear_cycles_match_jax(cycle):
    x, b = _fields(16, 1)
    fn, jfn = CYCLES[cycle]
    got = fn(torch.as_tensor(x), torch.as_tensor(b), NCOARSE, 2, 1)
    _close(got, jfn(jnp.asarray(x), jnp.asarray(b), NCOARSE, 2, 1))


@pytest.mark.parametrize("cycle", ["V", "F", "W"])
def test_fas_laplacian_cycles_match_jax(cycle):
    x, b = _fields(16, 2)
    fn, jfn = FAS_CYCLES[cycle]
    got = fn(torch.as_tensor(x), torch.as_tensor(b), mg.fas_ops_laplacian(),
             NCOARSE, 2, 1)
    _close(got, jfn(jnp.asarray(x), jnp.asarray(b), jmg.fas_ops_laplacian(),
                    NCOARSE, 2, 1))


def test_fas_restrict_all_matches_separate_restrictions():
    """The fused restrict_all equals the three separate restrictions,
    with and without the FAS rhs (the sign flip without it)."""
    x, b = _fields(16, 3)
    rhs = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    ops = mg.fas_ops_laplacian()
    tx, tb = torch.as_tensor(x), torch.as_tensor(b)
    for r in (None, torch.as_tensor(rhs)):
        res_c, x_c, b_c = ops.restrict_all(tx, tb, r)
        torch.testing.assert_close(res_c, ops.restrict_residual(tx, tb, r),
                                   rtol=0, atol=0)
        assert torch.equal(x_c, stencil.restrict3("reformulated", tx, tb)[1])
        assert b_c.shape == (8, 8, 8)


@pytest.mark.parametrize("ncoarse,cycle", [(4, "V"), (5, "V"), (4, "F"),
                                           (4, "W")])
def test_linear_solve_matches_jax(ncoarse, cycle):
    """linear() from the Jacobi first guess to epsrel * truncation error:
    the same number of cycles and the same solution."""
    _, b = _fields(2 ** ncoarse, 5)
    x0 = lap.initialise_potential(torch.as_tensor(b))
    tol = np.float32(1e-2) * np.float32(float(lap.truncation_error(x0)))
    jx0 = jlap.initialise_potential(jnp.asarray(b))
    jtol = jnp.float32(1e-2) * jlap.truncation_error(jx0)
    assert abs(float(tol) - float(jtol)) <= 5e-6 * float(jtol)
    mg.reset_stats()
    got = mg.linear(x0, torch.as_tensor(b), ncoarse, 2, 1, tol, cycle)
    assert mg.STATS["solves"] == 1 and 1 <= mg.STATS["cycles"] <= 30
    _close(got, jmg.linear(jx0, jnp.asarray(b), ncoarse, 2, 1, jtol, cycle))
    # converged well below the initial error
    assert float(lap.residual_error(got, torch.as_tensor(b))) < 0.05 * float(
        lap.residual_error(x0, torch.as_tensor(b)))


def test_fas_solve_matches_jax():
    x, b = _fields(16, 6)
    ops, jops = mg.fas_ops_laplacian(), jmg.fas_ops_laplacian()
    tx, tb = torch.as_tensor(x), torch.as_tensor(b)
    tol = np.float32(1e-2) * np.float32(float(ops.truncation_error(tx, tb)))
    jtol = jnp.float32(1e-2) * jops.truncation_error(jnp.asarray(x),
                                                     jnp.asarray(b))
    got = mg.FAS(tx, tb, ops, NCOARSE, 2, 1, tol)
    _close(got, jmg.FAS(jnp.asarray(x), jnp.asarray(b), jops, NCOARSE, 2, 1,
                        jtol))


def test_v_cycles_converge_to_discrete_solution():
    """tests/test_multigrid.py's oracle: V-cycles reach the exact inverse
    of the 7-point Laplacian."""
    _, b = _fields(16, 7)
    tb = torch.as_tensor(b)
    exact = fourier.irfft3(fourier.inverse_laplacian_7pt(
        fourier.rfft3(tb))).numpy()
    x = lap.initialise_potential(tb)
    for _ in range(20):
        x = mg.V_cycle(x, tb, NCOARSE, 2, 1)
    got = x.numpy() - x.numpy().mean()
    exact -= exact.mean()
    assert np.abs(got - exact).max() < 5e-4 * np.abs(exact).max() + 1e-5


def test_converge_stops_on_stalled_improvement():
    """The stop test: a cycle that improves the error less than twofold
    ends the loop (err * 2 > prev), as does err <= tol."""
    errs = iter([8.0, 3.0, 2.0, 1.0])
    seen = []

    def cycle(x, b):
        seen.append(1)
        return x

    x = torch.zeros(1)
    mg._converge(x, None, cycle, lambda x, b: next(errs), 0.0)
    assert len(seen) == 3  # 8 -> 3 improves 2.7x, 3 -> 2 only 1.5x
    errs = iter([8.0, 0.5])
    seen.clear()
    mg._converge(x, None, cycle, lambda x, b: next(errs), 1.0)
    assert len(seen) == 2


# ---------------------------------------------------------------------------
# QUMOND
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,alpha", [("simple", 1.0), ("n", 2.0),
                                      ("beta", 1.0), ("gamma", 1.5),
                                      ("delta", 2.0)])
@pytest.mark.parametrize("g0", [1e-8, 0.5])
def test_mond_rhs_matches_jax(fn, alpha, g0):
    """Each nu family in the Newtonian limit (g0 -> 0) and in the MOND
    regime: float32 transcendental roundoff, relative to the field."""
    phi = np.random.default_rng(8).random((16, 16, 16)).astype(np.float32)
    g0 = float(np.float32(g0))
    got = mond.rhs(torch.as_tensor(phi), g0, fn, alpha).numpy()
    want = np.array(jmond.rhs(jnp.asarray(phi), np.float32(g0), fn, alpha))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def test_mond_rhs_newtonian_limit_is_laplacian():
    phi = np.random.default_rng(0).random((16, 16, 16)).astype(np.float32)
    out = mond.rhs(torch.as_tensor(phi), 1e-8, "simple", 1.0).numpy()
    ref = lap.operator(torch.as_tensor(phi)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-2 * np.abs(ref).max())
    with pytest.raises(NotImplementedError, match="mond_function"):
        mond.rhs(torch.as_tensor(phi), 1.0, "tanh", 1.0)

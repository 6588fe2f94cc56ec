"""The port's f(R) scalaron path (pysco_tpu_torch.models.cubic/quartic,
the packed scalaron smoother, the FAS operator sets, ``derivative_fR``)
against the JAX package's on the same numpy inputs. On the CPU the port
runs the plain twin of the scalaron sweep kernel; the JAX package its XLA
path."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysco_tpu.models import cubic as jcubic
from pysco_tpu.models import multigrid as jmg
from pysco_tpu.models import quartic as jquartic
from pysco_tpu.ops import mesh as jmesh
from pysco_tpu_torch.models import cubic, laplacian as lap, multigrid as mg
from pysco_tpu_torch.models import quartic
from pysco_tpu_torch.ops import mesh, stencil

torch.set_num_threads(1)

MODELS = {"cubic": (cubic, jcubic), "quartic": (quartic, jquartic)}
Q = -2000.0  # h^2 q of order -1 .. -10 at 16^3, as in tests/test_scalaron.py


def _manufactured(name, n=16, seed=4):
    """tests/test_scalaron.py's problem: b such that a known positive u*
    ~ 1 solves operator(u*, b, q) = 0 (float64 arithmetic, float32
    result)."""
    rng = np.random.default_rng(seed)
    u = (1.0 + 0.05 * rng.standard_normal((n, n, n))).astype(np.float32)
    k = 2 if name == "cubic" else 3
    u64 = u.astype(np.float64)
    S = sum(np.roll(u64 ** k, s, a) for a in range(3) for s in (1, -1))
    h2 = 1.0 / n ** 2
    b = ((S / 6.0) * u64 - u64 ** (k + 1) - Q * h2) / (h2 * u64)
    return u, b.astype(np.float32)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _rhs(n, scale, seed=7):
    return (scale * np.random.default_rng(seed).standard_normal(
        (n, n, n))).astype(np.float32)


# ---------------------------------------------------------------------------
# Operators, errors and first guesses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["cubic", "quartic"])
def test_operators_and_errors_match_jax(name):
    mod, jmod = MODELS[name]
    u, b = _manufactured(name)
    x = (u * np.float32(1.01)).astype(np.float32)  # off the solution
    rhs = _rhs(16, 0.01)
    tx, tb, tr = _t(x), _t(b), _t(rhs)
    jx, jb, jr = _j(x), _j(b), _j(rhs)
    # the same float32 expression, operand for operand: bitwise
    np.testing.assert_array_equal(mod.operator(tx, tb, Q).numpy(),
                                  np.array(jmod.operator(jx, jb, Q)))
    np.testing.assert_array_equal(
        mod.residual_with_rhs(tx, tb, Q, tr).numpy(),
        np.array(jmod.residual_with_rhs(jx, jb, Q, jr)))
    # restriction sums in another order (reduce_window there): ulps
    for got, want in (
            (mod.restrict_residual(tx, tb, Q),
             jmod.restrict_residual(jx, jb, Q)),
            (mod.restrict_residual_with_rhs(tx, tb, Q, tr),
             jmod.restrict_residual_with_rhs(jx, jb, Q, jr))):
        want = np.array(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-6 * np.abs(want).max())
    # norms: float32 sums in another order
    for got, want in ((mod.residual_error(tx, tb, Q),
                       jmod.residual_error(jx, jb, Q)),
                      (mod.truncation_error(tx, tb, Q),
                       jmod.truncation_error(jx, jb, Q))):
        assert got.shape == () and got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 5e-6 * float(want)


@pytest.mark.parametrize("name", ["cubic", "quartic"])
@pytest.mark.parametrize("q", [Q, -3.14e-5])
def test_initialise_potential_matches_jax(name, q):
    """The float64 zero-neighbour roots, on a regular density and on
    near-empty cells (tests/test_scalaron.py:85). torch has no cbrt: the
    port takes sign(v) |v|^(1/3) by torch's pow, which differs from XLA's
    CPU cbrt (the C library's pow) by a float64 ulp in a few percent of
    values (test_cube_root_difference_is_the_library_pow). After the
    float32 cast the guesses agree to one float32 ulp, except where the quartic's Q +
    d0/Q cancels (near-empty cells: the float64 ulp is amplified, which is
    why the JAX module guards that branch); there the two stay within 5%,
    and every guess is finite, positive and solves its cell equation as
    tests/test_scalaron.py requires."""
    mod, jmod = MODELS[name]
    n = 16
    h2 = 1.0 / n ** 2
    _, b = _manufactured(name)
    tiny = np.geomspace(1e-12, 1e-2, n ** 3).astype(np.float32).reshape(
        n, n, n)
    for dens in (b, tiny):
        got = mod.initialise_potential(_t(dens), q).numpy()
        want = np.array(jmod.initialise_potential(_j(dens), q))
        assert np.isfinite(got).all() and (got > 0).all()
        rel = np.abs(got - want) / want
        if name == "quartic" and dens is tiny:
            assert np.mean(rel <= 2.4e-7) > 0.95 and rel.max() < 0.05
            u = got.astype(np.float64)
            resid = u ** 4 + h2 * dens.astype(np.float64) * u + h2 * q
            assert np.median(np.abs(resid) / abs(h2 * q)) < 1e-6
        else:
            assert rel.max() <= 2.4e-7, rel.max()


def _cube_root_sample():
    """Seeded float64 values in [0, 1) and spread over 1e-30 .. 1e30."""
    rng = np.random.default_rng(2024)
    return np.concatenate([rng.random(50_000),
                           10.0 ** rng.uniform(-30, 30, 50_000)])


def test_cube_root_difference_is_the_library_pow():
    """Pins the cause of the quartic guess's difference on near-empty
    cells: XLA's CPU cbrt equals the C library's pow(|v|, 1/3) bitwise,
    and torch's float64 pow does not."""
    v = _cube_root_sample()
    libm = np.array([math.pow(x, 1.0 / 3.0) for x in v.tolist()])
    xla = np.array(jnp.cbrt(jnp.asarray(v, jnp.float64)))
    assert xla.dtype == np.float64
    np.testing.assert_array_equal(xla, libm)
    port = torch.pow(torch.as_tensor(v), 1.0 / 3.0).numpy()
    differ = np.mean(port != libm)
    # torch's pow is another implementation: a float64 ulp apart in a few
    # percent of the values, never more
    assert 0.001 < differ < 0.1, differ
    np.testing.assert_allclose(port, libm, rtol=3e-16, atol=0)


def test_float_over_tensor_rounds_twice():
    """The other cause the quartic guess had: torch takes ``float /
    tensor`` as the reciprocal times the float (two roundings), where
    numpy and XLA divide once; a tensor numerator divides once."""
    v = torch.as_tensor(_cube_root_sample()[:50_000] + 0.5)
    d0 = -1.2345678901234567e-3
    once = d0 / v.numpy()
    assert (torch.full_like(v, d0) / v).numpy().tolist() == once.tolist()
    assert ((d0 / v).numpy() != once).any()


def _libm_cbrt(v: torch.Tensor) -> torch.Tensor:
    """Real cube root by the C library's pow, value by value on the host."""
    out = [math.copysign(math.pow(abs(x), 1.0 / 3.0), x)
           for x in v.reshape(-1).tolist()]
    return torch.tensor(out, dtype=v.dtype).reshape(v.shape)


@pytest.mark.parametrize("q", [Q, -3.14e-5])
def test_quartic_guess_matches_jax_with_the_library_cube_root(monkeypatch,
                                                              q):
    """With the cube root taken by the C library's pow, the port's quartic
    first guess meets pysco_tpu's to one float32 ulp in every cell of the
    near-empty case of test_initialise_potential_matches_jax: with the
    port's division by a tensor (test_float_over_tensor_rounds_twice), the
    cube root is the only source of the difference there."""
    monkeypatch.setattr(quartic, "_cbrt", _libm_cbrt)
    n = 16
    tiny = np.geomspace(1e-12, 1e-2, n ** 3).astype(np.float32).reshape(
        n, n, n)
    got = quartic.initialise_potential(_t(tiny), q).numpy()
    want = np.array(jquartic.initialise_potential(_j(tiny), q))
    assert (got > 0).all() and (want > 0).all()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps.max()


@pytest.mark.parametrize("name", ["cubic", "quartic"])
def test_closed_form_roots_match_jax(name):
    """The float64 closed forms of the exact root solver on every branch
    (p of both signs, the discriminant of both signs, p = 0)."""
    mod, jmod = MODELS[name]
    rng = np.random.default_rng(2)
    p = (rng.random(4096) * 4 - 2).astype(np.float32)
    p[:16] = 0.0
    coef = -0.3 * 27.0 if name == "cubic" else -0.5
    solve = (mod.solution_cubic_equation if name == "cubic"
             else mod.solution_quartic_equation)
    jsolve = (jmod.solution_cubic_equation if name == "cubic"
              else jmod.solution_quartic_equation)
    got = solve(_t(p), coef).numpy()
    want = np.array(jsolve(_j(p), jnp.float64(coef)))
    assert got.dtype == np.float64
    # pow-based cube roots against cbrt: float64 ulps
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


# ---------------------------------------------------------------------------
# Smoothing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_rhs", [False, True])
@pytest.mark.parametrize("exact_root", [False, True])
@pytest.mark.parametrize("name", ["cubic", "quartic"])
def test_packed_smoothing_matches_jax(name, exact_root, with_rhs):
    """The packed smoother (Newton: the sweep kernel's twin; exact: the
    float64 closed form) against the JAX package's on the CPU, and
    against the masked full-lattice sweep (its oracle) bitwise."""
    mod, jmod = MODELS[name]
    u, b = _manufactured(name)
    x0 = mod.initialise_potential(_t(b), Q).numpy()
    rhs = _rhs(16, 1e-3) if with_rhs else None
    got = mod.smoothing(_t(x0), _t(b), Q, 3, _t(rhs), exact_root=exact_root)
    want = np.array(jmod.smoothing(_j(x0), _j(b), Q, 3, _j(rhs),
                                   exact_root=exact_root))
    # the same float32 operations in the same order; float64 roots cast
    # to float32: at most one ulp where the cube roots differ
    np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7, atol=0)
    oracle = _t(x0)
    for _ in range(3):
        oracle = mod.gauss_seidel(oracle, _t(b), Q, _t(rhs),
                                  exact_root=exact_root)
    np.testing.assert_array_equal(got.numpy(), oracle.numpy())


@pytest.mark.parametrize("name", ["cubic", "quartic"])
def test_newton_smoothing_tracks_exact(name):
    """tests/test_scalaron.py's bound through the port: the float32
    Newton sweep tracks the float64 closed-form sweep."""
    mod, _ = MODELS[name]
    _, b = _manufactured(name, seed=5)
    u0 = mod.initialise_potential(_t(b), Q)
    exact = mod.smoothing(u0, _t(b), Q, 20, exact_root=True)
    newton = mod.smoothing(u0, _t(b), Q, 20, exact_root=False)
    np.testing.assert_allclose(newton.numpy(), exact.numpy(), atol=2e-5,
                               rtol=2e-5)


# ---------------------------------------------------------------------------
# FAS
# ---------------------------------------------------------------------------

def _jax_fas_cycles(x, b, jops, ncoarse, tol):
    """The JAX package's FAS stop rule replayed cycle by cycle (its
    while_loop hides the count)."""
    prev, count = np.float32(1e30), 0
    tol = np.float32(tol)
    while count < jmg.MAX_CYCLES:
        x = jmg.V_cycle_FAS(x, b, jops, ncoarse, 2, 1)
        count += 1
        err = np.float32(jops.residual_error(x, b))
        if err <= tol or err * np.float32(2) > prev:
            break
        prev = err
    return count


@pytest.mark.parametrize("ncoarse", [4, 5])
@pytest.mark.parametrize("name", ["cubic", "quartic"])
def test_fas_solve_matches_jax(name, ncoarse):
    """FAS V-cycles from the first guess to 1e-3 of the truncation error:
    the same number of cycles and the same solution as multigrid.FAS."""
    mod, jmod = MODELS[name]
    u_star, b = _manufactured(name, n=2 ** ncoarse)
    ops = getattr(mg, f"fas_ops_{name}")(Q)
    jops = getattr(jmg, f"fas_ops_{name}")(jnp.float32(Q))
    x0 = mod.initialise_potential(_t(b), Q)
    jx0 = jmod.initialise_potential(_j(b), Q)
    np.testing.assert_allclose(x0.numpy(), np.array(jx0), rtol=2.4e-7)
    tol = np.float32(1e-3) * np.float32(float(ops.truncation_error(x0,
                                                                   _t(b))))
    jtol = jnp.float32(1e-3) * jops.truncation_error(jx0, _j(b))
    assert abs(float(tol) - float(jtol)) <= 5e-6 * float(jtol)
    mg.reset_stats()
    got = mg.FAS(x0, _t(b), ops, ncoarse, 2, 1, tol)
    assert mg.STATS["fas_solves"] == mg.STATS["solves"] == 1
    assert mg.STATS["fas_cycles"] == _jax_fas_cycles(jx0, _j(b), jops,
                                                     ncoarse, jtol)
    want = np.array(jmg.FAS(jx0, _j(b), jops, ncoarse, 2, 1, jtol))
    # float32 roundoff of the operators through a few cycles (the bound
    # of tests/test_pallas_stencil.py for whole cycles)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-6)
    # and the solve reaches the manufactured solution (test_scalaron.py)
    np.testing.assert_allclose(got.numpy(), u_star, atol=5e-3)


@pytest.mark.parametrize("name", ["cubic", "quartic"])
def test_fas_restrict_all_matches_separate_restrictions(name):
    mod, _ = MODELS[name]
    _, b = _manufactured(name)
    x = mod.initialise_potential(_t(b), Q)
    ops = getattr(mg, f"fas_ops_{name}")(Q)
    for r in (None, _t(_rhs(16, 1e-3))):
        res_c, x_c, b_c = ops.restrict_all(x, _t(b), r)
        assert torch.equal(res_c, ops.restrict_residual(x, _t(b), r))
        assert torch.equal(x_c, mesh.restriction(x))
        assert torch.equal(b_c, mesh.restriction(_t(b)))


# ---------------------------------------------------------------------------
# The fifth force
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fR_n", [1, 2])
@pytest.mark.parametrize("leading", [False, True])
def test_derivative_fR_matches_jax(fR_n, leading):
    rng = np.random.default_rng(11)
    a = rng.standard_normal((16, 16, 16)).astype(np.float32)
    u = (1 + 0.1 * rng.standard_normal((16, 16, 16))).astype(np.float32)
    f = 3.3e-3
    got = mesh.derivative_fR(_t(a), _t(u), f, fR_n, 5, leading)
    want = jmesh.derivative_fR(_j(a), _j(u), f, fR_n, 5, leading)
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    with pytest.raises(NotImplementedError, match="fR_n"):
        mesh.derivative_fR(_t(a), _t(u), f, 3, 5)


def test_newton_root_is_the_kernels_twin():
    """stencil.newton_root is the cubic/quartic Newton polish, and the
    sweep twin reduces to it on a flat neighbourhood."""
    rng = np.random.default_rng(12)
    x = torch.as_tensor((0.5 + rng.random(64)).astype(np.float32))
    p = torch.as_tensor((rng.random(64) - 0.5).astype(np.float32))
    for power, jfn in ((2, jcubic._newton_root), (3, jquartic._newton_root)):
        got = stencil.newton_root(x, p, -0.1, power)
        want = np.array(jfn(_j(x.numpy()), _j(p.numpy()), jnp.float32(-0.1)))
        np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7)

"""The port's slab multigrid and FAS (pysco_tpu_torch/parallel/slab_mg.py,
and the multigrid, f(R) and QUMOND branches of parallel/slab.py) against the
JAX package's (pysco_tpu/parallel/slab_mg.py, parallel/slab.py) and against
the port's own single-device multigrid.

The same numpy inputs go through both packages: the JAX side under
``shard_map`` on 2 or 4 of the 8 virtual CPU devices, the port on the mesh
``[cpu] * D``, where the single-device cycles take the kernels' plain twins.
``REPLICATE_BELOW`` is lowered to 4 in both packages where a test says so,
so that a 32^3 grid recurses through slab levels below the finest instead of
handing every coarse level to the replicated cycles at once.

One difference is recorded, not hidden: on a slab level the JAX module
takes the first guess -h^2 b / 6 with h from the slab's height, where the
port and the single-device cycles take the grid's size
(:func:`test_linear_slab_first_guess_on_slab_levels`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from pysco_tpu import solver as jsolver
from pysco_tpu.parallel import slab as jslab
from pysco_tpu.parallel import slab_mg as jslab_mg
from pysco_tpu_torch import integrate as tintegrate
from pysco_tpu_torch import solver as tsolver
from pysco_tpu_torch.models import cubic, quartic
from pysco_tpu_torch.models import laplacian as lap
from pysco_tpu_torch.models import multigrid as mg
from pysco_tpu_torch.ops import mesh as mesh_ops
from pysco_tpu_torch.ops import stencil, tiled_pm
from pysco_tpu_torch.parallel import mesh as pmesh
from pysco_tpu_torch.parallel import slab, slab_mg
from pysco_tpu_torch.utils.units import set_units

torch.set_num_threads(1)

M = 32
NCOARSE = 5


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _mesh(d):
    return pmesh.make_mesh(devices=["cpu"] * d)


def _shards(a, mesh):
    return pmesh.scatter(_t(np.asarray(a)), mesh, 0)


def _cat(xs):
    return torch.cat(xs).numpy()


@pytest.fixture
def replicate_below(monkeypatch):
    """Set REPLICATE_BELOW in both packages."""
    def set_(value):
        monkeypatch.setattr(slab_mg, "REPLICATE_BELOW", value)
        monkeypatch.setattr(jslab_mg, "REPLICATE_BELOW", value)
    return set_


def _jax_slab(fn, d, n_args, n_out=1):
    """``fn`` under shard_map on d virtual devices: the first ``n_args``
    arguments x-sharded, any further ones replicated; every output
    x-sharded unless it is a scalar (``n_out`` outputs)."""
    def run(*args):
        specs = tuple(P("dp") if i < n_args else P()
                      for i in range(len(args)))
        outs = jax.jit(shard_map(
            fn, mesh=jslab.make_mesh(d), in_specs=specs,
            out_specs=P("dp") if n_out == 1 else (P("dp"),) * n_out,
            check_vma=False))(*(jnp.asarray(a) for a in args))
        return np.array(outs) if n_out == 1 else [np.array(o) for o in outs]
    return run


def _rhs(seed):
    b = np.random.default_rng(seed).standard_normal((M, M, M)).astype(
        np.float32)
    return b - b.mean()


def _close(got, want, rel, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


# ---------------------------------------------------------------------------
# Stencils, transfers, norms and the packed layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 4])
def test_slab_stencils_match_single_and_jax(d):
    """Every slab primitive against the single-device one (bitwise where
    the arithmetic is the same; the norms summed in another order to 1e-6)
    and, on 2 and 4 shards, against the JAX slab functions (1e-6 of the
    field's maximum: XLA may fuse a product into an add)."""
    x, b = _rhs(0), _rhs(1)
    xc = _rhs(2)[: M // 2, : M // 2, : M // 2]
    mesh = _mesh(d)
    xs, bs = _shards(x, mesh), _shards(b, mesh)
    got = {
        "nsum": _cat(slab_mg.neighbour_sum_slab(xs, mesh)),
        "op": _cat(slab_mg.operator_slab(xs, mesh)),
        "restr": _cat(slab_mg.restriction_slab(xs)),
        "prolong": _cat(slab_mg.prolongation_slab(_shards(xc, mesh), mesh)),
        "gs": _cat(slab_mg.gauss_seidel_slab(xs, bs, mesh)),
        "gs_rhs": _cat(slab_mg.gauss_seidel_slab(xs, bs, mesh, rhs=xs)),
    }
    reds, blacks = slab_mg.pack_rb_slab(xs)
    assert torch.equal(torch.cat(slab_mg.unpack_rb_slab(reds, blacks)), _t(x))
    red1, black1 = lap.pack_rb(_t(x))
    assert torch.equal(torch.cat(reds), red1)
    assert torch.equal(torch.cat(blacks), black1)
    want = {
        "nsum": stencil.neighbour_sum(_t(x)), "op": lap.operator(_t(x)),
        "restr": mesh_ops.restriction(_t(x)),
        "prolong": mesh_ops.prolongation(_t(xc)),
        "gs": lap.gauss_seidel(_t(x), _t(b)),
        "gs_rhs": lap.gauss_seidel_with_rhs(_t(x), _t(b), _t(x)),
    }
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    err = float(slab_mg.residual_error_slab(xs, bs, mesh))
    trunc = float(slab_mg.truncation_error_slab(xs, mesh))
    assert err == pytest.approx(float(lap.residual_error(_t(x), _t(b))),
                                rel=1e-6)
    assert trunc == pytest.approx(float(lap.truncation_error(_t(x))),
                                  rel=1e-6)
    if d == 1:
        return

    def jfn(xl, bl, xcl):
        red, black = jslab_mg.pack_rb_slab(xl)
        return (jslab_mg.neighbour_sum_slab(xl, d),
                jslab_mg.operator_slab(xl, d),
                jslab_mg.restriction_slab(xl),
                jslab_mg.prolongation_slab(xcl, d),
                jslab_mg.gauss_seidel_slab(xl, bl, d),
                jslab_mg.gauss_seidel_slab(xl, bl, d, rhs=xl),
                red, black,
                jnp.full((1,), jslab_mg.residual_error_slab(xl, bl, d)),
                jnp.full((1,), jslab_mg.truncation_error_slab(xl, d)))

    outs = _jax_slab(jfn, d, 3, 10)(x, b, xc)
    for k, j in zip(got, outs[:6]):
        _close(got[k], j, 1e-6, k)
    np.testing.assert_array_equal(torch.cat(reds).numpy(), outs[6])
    np.testing.assert_array_equal(torch.cat(blacks).numpy(), outs[7])
    assert err == pytest.approx(float(outs[8][0]), rel=1e-5)
    assert trunc == pytest.approx(float(outs[9][0]), rel=1e-5)


@pytest.mark.parametrize("with_rhs", [False, True])
def test_slab_packed_smoothing_bitwise(with_rhs):
    """Three packed sweeps on 4 slabs are bitwise three masked sweeps and
    the single-device packed sweeps, and match the JAX slab smoother."""
    b = _rhs(10)
    x0 = lap.initialise_potential(_t(b)).numpy()
    rhs = _rhs(11) if with_rhs else None
    mesh = _mesh(4)
    xs, bs = _shards(x0, mesh), _shards(b, mesh)
    rs = _shards(rhs, mesh) if with_rhs else None
    packed = slab_mg.smoothing_slab(xs, bs, 3, mesh, rhs=rs)
    masked = xs
    for _ in range(3):
        masked = slab_mg.gauss_seidel_slab(masked, bs, mesh, rhs=rs)
    np.testing.assert_array_equal(_cat(packed), _cat(masked))
    single = (lap.smoothing_with_rhs(_t(x0), _t(b), 3, _t(rhs)) if with_rhs
              else lap.smoothing(_t(x0), _t(b), 3))
    np.testing.assert_array_equal(_cat(packed), single.numpy())
    args = (x0, b) + ((rhs,) if with_rhs else ())
    want = _jax_slab(lambda x, bl, *r: jslab_mg.smoothing_slab(
        x, bl, 3, 4, rhs=r[0] if r else None), 4, len(args))(*args)
    _close(_cat(packed), want, 1e-6)


def _scalaron_problem(n_power, q, seed):
    """(u0, b): b built so that a known positive u_star solves the
    scalaron equation, u0 a 1% perturbation of it (the regime the smoother
    runs in: Newton contracting at every cell; tests/test_slab_mg.py)."""
    rng = np.random.default_rng(seed)
    u_star = (1.0 + 0.05 * rng.standard_normal((M, M, M))).astype(
        np.float32)
    h2 = 1.0 / M ** 2
    s = stencil.neighbour_sum(stencil._power(_t(u_star), n_power)).numpy()
    b = ((s / 6.0) * u_star - u_star ** (n_power + 1) - q * h2) / (
        h2 * u_star)
    u0 = u_star * (1.0 + 0.01 * rng.standard_normal((M, M, M))).astype(
        np.float32)
    return u_star, u0.astype(np.float32), b.astype(np.float32)


def _slab_ops(n_power, q, mesh, exact_root=False):
    make = (slab_mg.fas_ops_cubic_slab if n_power == 2
            else slab_mg.fas_ops_quartic_slab)
    return make(np.float32(q), mesh, exact_root)


def _jax_slab_ops(n_power, q, d, exact_root=False):
    make = (jslab_mg.fas_ops_cubic_slab if n_power == 2
            else jslab_mg.fas_ops_quartic_slab)
    return make(jnp.float32(q), d, exact_root=exact_root)


@pytest.mark.parametrize("n_power", [2, 3])
@pytest.mark.parametrize("exact_root", [False, True])
def test_slab_scalaron_smoothing(n_power, exact_root):
    """The packed scalaron sweeps on 4 slabs, with and without an FAS rhs:
    the masked sweeps and the single-device packed sweeps bitwise, the JAX
    slab smoother within 2e-5 (tests/test_slab_mg.py's bound)."""
    q = -2000.0
    _, u0, b = _scalaron_problem(n_power, q, 20 + n_power)
    rhs = (1e-5 * _rhs(22)).astype(np.float32)
    mesh = _mesh(4)
    ops = _slab_ops(n_power, q, mesh, exact_root)
    us, bs, rs = (_shards(a, mesh) for a in (u0, b, rhs))
    mod = cubic if n_power == 2 else quartic
    got = []
    for r, r1 in ((None, None), (rs, _t(rhs))):
        packed = ops.smoothing(us, bs, 3, r)
        masked = us
        for _ in range(3):
            masked = ops.gauss_seidel_masked(masked, bs, r)
        np.testing.assert_array_equal(_cat(packed), _cat(masked))
        single = mod.smoothing(_t(u0), _t(b), np.float32(q), 3, r1,
                               exact_root=exact_root)
        np.testing.assert_array_equal(_cat(packed), single.numpy())
        got.append(_cat(packed))

    def jfn(u, bl, r):
        jops = _jax_slab_ops(n_power, q, 4, exact_root)
        return jops.smoothing(u, bl, 3), jops.smoothing(u, bl, 3, r)

    for g, w in zip(got, _jax_slab(jfn, 4, 3, 2)(u0, b, rhs)):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# Linear and FAS solves
# ---------------------------------------------------------------------------

def _linear_problem(seed):
    b = _rhs(seed)
    x0 = lap.initialise_potential(_t(b))
    tol = np.float32(1e-2) * np.float32(float(lap.truncation_error(x0)))
    return b, x0.numpy(), tol


@pytest.mark.parametrize("cycle,d,rb", [("V", 2, 4), ("F", 4, 4),
                                        ("W", 4, 4), ("V", 4, 32),
                                        ("F", 2, 32)])
def test_linear_slab_matches_single_and_jax(replicate_below, cycle, d, rb):
    """linear_slab against multigrid.linear: the same V-cycle count and the
    same potential (1e-5 of its maximum; bitwise in practice), through
    slab levels (REPLICATE_BELOW = 4) or straight to the replicated cycles
    (32), where it also matches the JAX slab solve (1e-5,
    tests/test_slab_mg.py's bound). This seed's errors stay clear of the
    tolerance: a count is not decided by one ulp."""
    replicate_below(rb)
    b, x0, tol = _linear_problem(1)
    mesh = _mesh(d)
    mg.reset_stats()
    want = mg.linear(_t(x0), _t(b), NCOARSE, 2, 1, tol, cycle).numpy()
    cycles = mg.STATS["cycles"]
    mg.reset_stats()
    got = _cat(slab_mg.linear_slab(_shards(x0, mesh), _shards(b, mesh),
                                   NCOARSE, 2, 1, tol, mesh, cycle))
    assert mg.STATS == {"solves": 1, "cycles": cycles, "fas_solves": 0,
                        "fas_cycles": 0}
    _close(got, want, 1e-5)
    r = float(lap.residual_error(_t(got), _t(b)))
    assert r < 0.1 * float(lap.residual_error(_t(x0), _t(b)))
    if rb == 32:
        jwant = _jax_slab(lambda x, bl, t: jslab_mg.linear_slab(
            x, bl, NCOARSE, 2, 1, t, d, cycle), d, 2)(x0, b, tol)
        _close(got, jwant, 1e-5)


def test_linear_slab_first_guess_on_slab_levels(replicate_below):
    """On a slab level the JAX module's first guess -h^2 b / 6 takes h =
    1 / (the slab's height) (laplacian.initialise_potential reads axis 0),
    where the single-device cycles and the port take h = 1 / (the grid's
    size): at 32^3 on 2 shards with REPLICATE_BELOW = 4 its solve lands
    ~7.6e-4 of the potential's maximum from the single-device one, still
    converged. The port is the single-device solve bit for bit."""
    replicate_below(4)
    b, x0, tol = _linear_problem(1)
    mesh = _mesh(2)
    want = mg.linear(_t(x0), _t(b), NCOARSE, 2, 1, tol).numpy()
    got = _cat(slab_mg.linear_slab(_shards(x0, mesh), _shards(b, mesh),
                                   NCOARSE, 2, 1, tol, mesh))
    np.testing.assert_array_equal(got, want)
    jgot = _jax_slab(lambda x, bl, t: jslab_mg.linear_slab(
        x, bl, NCOARSE, 2, 1, t, 2), 2, 2)(x0, b, tol)
    dev = np.abs(jgot - want).max() / np.abs(want).max()
    assert dev == pytest.approx(7.6e-4, rel=0.1), dev
    r0 = float(lap.residual_error(_t(x0), _t(b)))
    assert float(lap.residual_error(_t(jgot), _t(b))) < 0.1 * r0
    # the same guesses on the JAX side close the gap: a slab of the whole
    # grid (D = 1) is the single-device solve
    jgot1 = _jax_slab(lambda x, bl, t: jslab_mg.linear_slab(
        x, bl, NCOARSE, 2, 1, t, 1), 1, 2)(x0, b, tol)
    _close(jgot1, want, 1e-5)


@pytest.mark.parametrize("n_power,d,cycle,exact_root", [
    (2, 2, "V", False), (3, 4, "V", False), (3, 2, "V", True),
    (2, 4, "F", False), (3, 2, "W", False)])
def test_fas_slab_matches_single_and_jax(replicate_below, n_power, d, cycle,
                                         exact_root):
    """FAS_slab of the cubic and quartic scalaron equations through slab
    levels (REPLICATE_BELOW = 4) against multigrid.FAS (the same V-cycle
    count; bitwise in practice), near the known solution, and, for the
    V-cycles, against the JAX slab FAS (2e-5, tests/test_slab_mg.py's
    bound; an F or W FAS program takes JAX tens of seconds to compile)."""
    replicate_below(4)
    q = -2000.0
    u_star, _, b = _scalaron_problem(n_power, q, 2)
    init = cubic.initialise_potential if n_power == 2 else (
        quartic.initialise_potential)
    u0 = init(_t(b), q).numpy()
    ops1 = (mg.fas_ops_cubic if n_power == 2 else mg.fas_ops_quartic)(
        np.float32(q), exact_root)
    tol = np.float32(1e-3) * np.float32(float(ops1.truncation_error(
        _t(u0), _t(b))))
    mg.reset_stats()
    want = mg.FAS(_t(u0), _t(b), ops1, NCOARSE, 2, 1, tol, cycle).numpy()
    stats = dict(mg.STATS)
    mesh = _mesh(d)
    ops = _slab_ops(n_power, q, mesh, exact_root)
    us, bs = _shards(u0, mesh), _shards(b, mesh)
    assert float(ops.truncation_error(us, bs)) == pytest.approx(
        float(ops1.truncation_error(_t(u0), _t(b))), rel=1e-6)
    mg.reset_stats()
    got = _cat(slab_mg.FAS_slab(us, bs, ops, NCOARSE, 2, 1, tol, mesh,
                                cycle))
    assert mg.STATS == stats and stats["fas_cycles"] >= 2
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, u_star, rtol=0, atol=5e-3)
    if cycle != "V":
        return
    jgot = _jax_slab(lambda u, bl, t: jslab_mg.FAS_slab(
        u, bl, _jax_slab_ops(n_power, q, d, exact_root), NCOARSE, 2, 1, t,
        d, cycle), d, 2)(u0, b, tol)
    np.testing.assert_allclose(got, jgot, rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# The slab step's solves
# ---------------------------------------------------------------------------

_UNITS = {"H0": 72.0, "boxlen": 100.0, "Om_lambda": 0.7, "Om_r": 0.0,
          "w0": -1.0, "wa": 0.0, "parametrized_mu0": 0.3, "mond_g0": 1.2,
          "mond_scale_factor_exponent": 0.0}


def _param(theory, solver_name, npart, ncoarse=NCOARSE, **kw):
    p = {"theory": theory, "ncoarse": ncoarse, "npart": npart,
         "mass_scheme": "tsc", "linear_newton_solver": solver_name,
         "gradient_stencil_order": 5, "Npre": 2, "Npost": 1, "fR_n": 1,
         "fR_logfR0": 5.0, "mond_function": "simple", "mond_alpha": 1.0,
         "aexp": 0.2, "Om_m": 0.3, "epsrel": 1e-2,
         "particle_engine": "pallas", "pm_precision_widened": "bf16x3",
         **_UNITS}
    p.update(kw)
    set_units(p)  # the f(R) constants and MOND's g0 in box units
    return p


# theory, solver, extra keys, shards
SOLVE_CASES = [
    ("newton", "multigrid", {}, 4),
    ("fr", "multigrid", {"fR_n": 1}, 2),
    ("fr", "multigrid", {"fR_n": 2}, 4),
    ("fr", "full_fft", {"fR_n": 1}, 4),
    ("mond", "multigrid", {}, 4),
]
# the port's step runs take the cycle kinds too (the JAX side of
# test_solve_slab_matches_jax keeps to V-cycles: an F or W FAS program
# takes it tens of seconds to compile)
STEP_CASES = SOLVE_CASES[:2] + [
    ("fr", "multigrid", {"fR_n": 2, "multigrid_cycle": "W"}, 4),
    SOLVE_CASES[3],
    ("mond", "multigrid", {"multigrid_cycle": "F"}, 4),
]


def _rows(npart, seed):
    rng = np.random.default_rng(seed)
    pos = rng.random((npart, 3), dtype=np.float32)
    return pos, (0.05 * rng.standard_normal((npart, 3))).astype(np.float32)


def _matched(got, want):
    from scipy.spatial import cKDTree

    tree = cKDTree(np.mod(got[0].astype(np.float64), 1.0), boxsize=1.0)
    dist, idx = tree.query(np.mod(want[0].astype(np.float64), 1.0))
    assert len(np.unique(idx)) == len(idx) == len(got[0])
    return tuple(a[idx] for a in got), dist


@pytest.mark.parametrize("theory,solver_name,extra,d", STEP_CASES)
def test_slab_step_matches_single(theory, solver_name, extra, d):
    """The slab step from a first call (first guesses, a zero-dt step)
    through a sorted, a stale-bin and a sorted step, against the port's
    single-device pm and lazy steps: positions, velocities and
    accelerations within 1e-5, the f(R) scalaron's mean within 1e-5."""
    npart = M ** 3 // 4
    pos, vel = _rows(npart, 2)
    param = _param(theory, solver_name, npart, **extra)
    cfg, dyn = tsolver.config_from_param(param), tsolver.compute_dynamics(
        param)
    mesh = _mesh(d)
    state = slab.distribute_particles(mesh, cfg, pos, vel)
    if theory in ("fr", "mond"):
        assert torch.cat(state[4]).shape == (M, M, M)
    out = slab.make_slab_step(cfg, mesh, first_call=True)(*state, dyn, 0.0)
    for k in (0, 1, 0):
        out = slab.make_slab_step(cfg, mesh, presorted=k)(*out[:6], dyn,
                                                          2e-3)
        assert int(out[7].overflow) == 0
    got = (*slab.gather_particles(out[0], out[1]),
           slab.gather_particles(out[0], out[2])[1])
    pc, vc = tiled_pm.to_columns_host(pos, vel, npart)
    one = tsolver.pm(cfg, True, False, _t(pc), _t(vc),
                     *tsolver.empty_fields(cfg, "cpu"), dyn)
    s = (one[0], one[1], one[2], one[3], one[4],
         torch.zeros(tiled_pm.n_tiles(M) + 1, dtype=torch.int32))
    for k in (0, 1, 0):
        o = tintegrate.step_lazy_impl(cfg, "leapfrog", k, False, *s, dyn,
                                      2e-3)
        s = o[:6]
    want = tsolver.particles_to_rows(cfg, s[0], s[1], s[2])
    got, dist = _matched(got, want)
    assert dist.max() <= 1e-5
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    if theory == "fr":
        assert float(out[7].mean_additional) == pytest.approx(
            float(o[7].mean_additional), rel=1e-5)


@pytest.mark.parametrize("theory,solver_name,extra,d", SOLVE_CASES)
def test_solve_slab_matches_jax(theory, solver_name, extra, d):
    """The slab field solve (the step's _solve_slab: the extra field, the
    Poisson solve, the force) against the JAX package's on the same
    density, from the fields of a first call, on d shards; for f(R) n = 1
    on multigrid also as a first call on one shard (the first guesses:
    the JAX slab's differ from the single-device ones on more shards,
    test_linear_slab_first_guess_on_slab_levels). Force, potential and u
    within 1e-5 of their maxima, on a 16^3 grid."""
    m = 16
    npart = m ** 3 // 2
    param = _param(theory, solver_name, npart, ncoarse=4, **extra)
    cfg, dyn = tsolver.config_from_param(param), tsolver.compute_dynamics(
        param)
    jcfg, jdyn = jsolver.config_from_param(param), jsolver.compute_dynamics(
        param)
    pos, vel = _rows(npart, 3)
    pc, vc = tiled_pm.to_columns_host(pos, vel, npart)
    ps, _, ts = tiled_pm.sort_particles(_t(pc), _t(vc), m, "tsc")
    density = tsolver._normalise(cfg, tiled_pm.deposit(ps, ts, m, "tsc"))
    _, phi1, u1, _ = tsolver._solve_fields(
        cfg, True, False, density, *tsolver.empty_fields(cfg, "cpu"), dyn,
        leading=True)
    zero = np.zeros((m, m, m), np.float32)
    # the Newtonian theories' u is a token: a zero grid stands in for it
    u1 = u1.numpy() if theory in ("fr", "mond") else zero
    passes = [(False, d, (phi1.numpy(), u1))]
    if theory == "fr" and solver_name == "multigrid" and extra["fR_n"] == 1:
        passes.append((True, 1, (zero, zero)))
    for first_call, n_dev, fields in passes:
        mesh = _mesh(n_dev)
        dens, phi, u = (_shards(a, mesh) for a in (density.numpy(),
                                                   *fields))
        force, phi, u, _ = slab._solve_slab(cfg, dens, phi, u, dyn, mesh,
                                            False, first_call)

        def jfn(dl, pl, ul, jd, first_call=first_call, n_dev=n_dev):
            f, p, uu, _ = jslab._solve_slab(jcfg, dl, pl, ul, jd, m, n_dev,
                                            False, first_call)
            return jnp.moveaxis(f, -1, 0), p, uu

        specs = (P("dp"),) * 3 + (jax.tree.map(lambda _: P(), jdyn),)
        jf, jp, ju = (np.array(a) for a in jax.jit(shard_map(
            jfn, mesh=jslab.make_mesh(n_dev), in_specs=specs,
            out_specs=(P(None, "dp"), P("dp"), P("dp")), check_vma=False))(
                jnp.asarray(density.numpy()), jnp.asarray(fields[0]),
                jnp.asarray(fields[1]), jdyn))
        what = f"first_call={first_call}, {n_dev} shards"
        _close(torch.cat(force, dim=1).numpy(), jf, 1e-5, "force " + what)
        if solver_name != "full_fft":
            _close(_cat(phi), jp, 1e-5, "phi " + what)
        if theory in ("fr", "mond"):
            _close(_cat(u), ju, 1e-5, "u " + what)


def test_slab_fr_run_end_to_end(tmp_path):
    """pysco_tpu_torch.run with theory = fr in slab mode on four CPU
    shards: its ICs from ic_slab, P(k) within 1e-5 of the single mode's
    run, and the same number of FAS solves and V-cycles."""
    import pysco_tpu_torch
    from pysco_tpu_torch.cosmo import write_power_spectrum_table
    from pysco_tpu_torch.parallel import ic_slab

    pk_file = str(tmp_path / "pk.dat")
    write_power_spectrum_table(pk_file)
    base = {
        "theory": "fr", "fR_logfR0": 5.0, "fR_n": 1, "H0": 72,
        "Om_m": 0.25733, "T_cmb": 2.726, "N_eff": 3.044, "w0": -1.0,
        "wa": 0.0, "boxlen": 100, "ncoarse": 4, "npart": 16 ** 3,
        "z_start": 49, "seed": 42, "position_ICS": "center",
        "fixed_ICS": False, "paired_ICS": False, "dealiased_ICS": False,
        "power_spectrum_file": pk_file, "initial_conditions": "2LPT",
        "output_snapshot_format": "npz", "z_out": "[40]",
        "save_power_spectrum": "z_out", "integrator": "leapfrog",
        "mass_scheme": "TSC", "n_reorder": 50, "Courant_factor": 1.0,
        "max_aexp_stepping": 10, "linear_newton_solver": "multigrid",
        "gradient_stencil_order": 5, "Npre": 2, "Npost": 1, "epsrel": 1e-2,
        "verbose": 0,
    }
    stats = {}
    for mode, devices in (("single", None), ("slab", ["cpu"] * 4)):
        ic_slab.TIMES["generate_lpt_slab"] = None
        mg.reset_stats()
        recs = pysco_tpu_torch.run(
            dict(base, base=str(tmp_path / mode), parallel_mode=mode),
            device="cpu", devices=devices)
        stats[mode] = dict(mg.STATS)
        assert recs and all(r.overflow == 0 for r in recs)
        assert (ic_slab.TIMES["generate_lpt_slab"] is None) == (
            mode == "single")
    assert stats["slab"] == stats["single"]
    assert stats["slab"]["fas_solves"] == len(recs) + 1
    for f in sorted((tmp_path / "single" / "power").glob("pk_*.dat")):
        a = np.loadtxt(f)
        b = np.loadtxt(tmp_path / "slab" / "power" / f.name)
        np.testing.assert_array_equal(a[:, 2], b[:, 2])
        np.testing.assert_allclose(b[:, 1], a[:, 1], rtol=1e-5)

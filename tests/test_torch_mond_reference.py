"""The QUMOND port against the benchmark's float64 reference module
(``benchmark/reference/mond.py``), on the CPU at 16^3-32^3: the source
from a potential, its Newtonian limit, g0 in box units, a TSC force
evaluation through ``solver.pm`` and the reference's refusals; and the
program's three QUMOND spans in a profiled step. Each comparison with the
port is also run with the reference in bfloat16 in the port's place,
which must fail it: the tolerances are tight enough to tell the two
apart."""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from reference import ics, mond as ref_mond, pm  # noqa: E402
from reference.precision import BF16, F64  # noqa: E402

from pysco_tpu_torch import cosmo, integrate, solver  # noqa: E402
from pysco_tpu_torch.models import mond  # noqa: E402
from pysco_tpu_torch.utils import profiling  # noqa: E402
from pysco_tpu_torch.utils.config import (  # noqa: E402
    params_from_dict, with_defaults)
from pysco_tpu_torch.utils.units import set_units  # noqa: E402

SPANS = ("mond.newton", "mond.source", "mond.potential")


def _param(n, tmp_path, **over):
    with open(os.path.join(BENCH, "configs", "mond_tsc_mg_512.json")) as f:
        c = json.load(f)
    p = dict(c["param"], ncoarse=int(math.log2(n)), npart=n ** 3,
             boxlen=float(n), seed=42, base=str(tmp_path), verbose=0,
             write_initial_snapshot=False,
             power_spectrum_file=os.path.join(BENCH, "configs",
                                              c["pk_file"]))
    p.update(over)
    return with_defaults(params_from_dict(p))


def _potential(n, seed):
    """A smooth seeded random potential, float32, max |phi| = 1: white
    noise over k^2.5."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((n, n, n), generator=g, dtype=torch.float64)
    k = torch.fft.fftfreq(n) * n
    k2 = k[:, None, None] ** 2 + k[None, :, None] ** 2 + k[None, None, :] ** 2
    k2[0, 0, 0] = 1.0
    phi = torch.fft.ifftn(torch.fft.fftn(w) / k2 ** 1.25).real
    return (phi / phi.abs().max()).float()


def _normal_gradient(phi):
    n = phi.shape[0]
    return torch.stack([n * (phi.double() - torch.roll(phi.double(), 1, a))
                        for a in range(3)])


@pytest.mark.parametrize("scale", [1e3, 1.0, 1e-3])
@pytest.mark.parametrize("seed", [1, 2])
def test_source_matches_the_reference(scale, seed):
    """``mond.rhs`` against the reference's float64 face-centred source on
    the same float32 potential, g0 at scale x the median normal |g| (y
    from 1e-8 to 7e-3, 2e-5 to 7 and 0.02 to 7e3 over the three scales):
    1e-5 of the source's largest value (float32 roundings of the face
    fluxes, which cancel in the divergence; measured 1.1e-7)."""
    n = 32
    phi = _potential(n, seed)
    g = _normal_gradient(phi).abs()
    g0 = float(np.float32(float(g.median()) * scale))
    lo, hi = float((g / g0).min()), float((g / g0).max())
    assert lo < 1.0 / scale < hi
    assert (scale < 1e3 or lo < 1e-3) and (scale > 1e-3 or hi > 1e3)
    want = ref_mond.qumond_source(phi.double(), g0)
    top = float(want.abs().max())
    got = mond.rhs(phi, g0, "simple", 1.0)
    assert float((got.double() - want).abs().max()) / top < 1e-5
    ctl = ref_mond.qumond_source(phi.double(), g0, BF16)
    assert float((ctl.double() - want).abs().max()) / top > 1e-5


def test_source_in_the_newtonian_limit_is_the_7_point_laplacian():
    """g0 = 0 makes nu 1 on every face: the divergence of the face
    gradients is the 7-point Laplacian, to float64 rounding (1e-12 of its
    largest value)."""
    n = 16
    phi = _potential(n, 3).double()
    lap = n * n * (sum(torch.roll(phi, s, a) for a in range(3)
                       for s in (1, -1)) - 6.0 * phi)
    top = float(lap.abs().max())
    got = ref_mond.qumond_source(phi, 0.0)
    assert float((got - lap).abs().max()) / top < 1e-12
    ctl = ref_mond.qumond_source(phi, 0.0, BF16)
    assert float((ctl.double() - lap).abs().max()) / top > 1e-12


def test_flux_on_a_face_without_gradient_is_its_limit():
    """nu g -> 0 as |g| -> 0: the reference's flux is 0 on such a face,
    and finite on its neighbours."""
    g = torch.tensor([0.0, 1e-300, 1e-3, 1.0], dtype=torch.float64)
    flux = ref_mond.nu_flux(g, g, 1.0)
    assert flux[0] == 0.0 and bool(torch.isfinite(flux).all())
    assert float(flux[1]) == pytest.approx(math.sqrt(1e-300), rel=1e-12)


def test_source_of_a_potential_flat_around_a_bump_is_finite():
    """A potential that is 0 but in a 3-cell bump: most faces have g
    exactly 0, where nu is infinite. The port holds the flux at its limit,
    0, as the reference does (the JAX package's source is not a number
    there), and matches the reference to 1e-5 of the source's largest
    value, as on smooth potentials."""
    n = 16
    phi = torch.zeros((n, n, n))
    phi[7:10, 7:10, 7:10] = torch.tensor([1.0, 2.0, 1.5])
    g0 = 0.5
    got = mond.rhs(phi, g0, "simple", 1.0).double()
    assert bool(torch.isfinite(got).all())
    assert float(got[0, 0, 0]) == 0.0
    want = ref_mond.qumond_source(phi.double(), float(np.float32(g0)))
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("aexp", [0.02, 0.3, 1.0])
def test_g0_in_box_units_matches_the_program(aexp, tmp_path):
    """The reference's g0 from its own constants against the program's
    (``solver.compute_dynamics``, rounded to float32): 1e-7 relative."""
    param = _param(16, tmp_path, boxlen=500.0, aexp=aexp,
                   mond_scale_factor_exponent=0.5)
    set_units(param)
    want = ref_mond.g0_box(param, aexp)
    got = solver.compute_dynamics(param).mond_g0
    assert got == pytest.approx(want, rel=1e-7)


@pytest.mark.parametrize("aexp", [0.3, 1.0])
def test_tsc_force_matches_the_reference(aexp, tmp_path):
    """One QUMOND force evaluation of the port through ``solver.pm`` (the
    TSC deposit, two multigrid Poisson solves with epsrel 1e-6 around the
    source, the 5-point gradient, the TSC gather) on 2LPT particles
    carried to z = 0, against the reference's force gathered at the same
    particles: 1e-4 of its rms (the port's float32 multigrid; measured
    4e-6). Its phi_N (the u it hands on) equals the reference's to 1e-5 of
    its largest value, up to the mean multigrid leaves free."""
    n = 32
    param = _param(n, tmp_path, z_start=0.0, epsrel=1e-6)
    pos, _ = ics.lpt2(param, 42, "cpu")
    cosmo.generate(param)
    param["aexp"] = aexp
    set_units(param)
    cfg = solver.config_from_param(param)
    dyn = solver.compute_dynamics(param)
    phi, u = solver.empty_fields(cfg, "cpu")
    p, v, _, phi, u = solver.state_from_arrays(
        cfg, pos.T.float().numpy(), np.zeros((n ** 3, 3), np.float32), None,
        phi.numpy(), u.numpy(), "cpu")
    p, _, acc, _, u, _, _ = solver.pm(cfg, True, False, p, v, phi, u, dyn)
    x = p[:3].double()
    rho = pm.density(x, n, n ** 3, F64, "tsc")
    force, phi_n = ref_mond.Forces(param)(rho, aexp)
    want = pm.gather(force, x, F64, "tsc")
    rms = float(want.pow(2).mean().sqrt())
    assert float((acc[:3].double() - want).abs().max()) / rms < 1e-4
    u = u.double() - u.double().mean()
    assert float((u - phi_n).abs().max() / phi_n.abs().max()) < 1e-5
    ctl, _ = ref_mond.Forces(param, BF16)(rho, aexp)
    ctl = pm.gather(ctl, x, F64, "tsc")
    assert float((ctl - want).abs().max()) / rms > 1e-4


def test_reference_refuses_what_it_does_not_follow(tmp_path):
    for over, why in (({"theory": "newton"}, "runs mond"),
                      ({"mond_function": "n"}, "simple nu"),
                      ({"linear_newton_solver": "fft"}, "fft_7pt solver"),
                      ({"mass_scheme": "PCS"}, "mass scheme"),
                      ({"gradient_stencil_order": 7}, "5-point")):
        with pytest.raises(NotImplementedError, match=why):
            ref_mond.Forces(_param(16, tmp_path, **over))
    for solver_name in ("multigrid", "fft_7pt"):
        f = ref_mond.Forces(_param(16, tmp_path,
                                   linear_newton_solver=solver_name))
        assert f.p == 3  # TSC
    with pytest.raises(NotImplementedError, match="mond/multigrid"):
        pm.Forces(_param(16, tmp_path))


@pytest.mark.parametrize("solver_name", ["multigrid", "fft_7pt"])
def test_profiled_step_opens_the_three_spans_inside_the_solve(
        solver_name, tmp_path):
    """A profiled lazy step on the CPU at 16^3: mond.newton, mond.source
    and mond.potential each open once, in that order, as children of
    pm.solve, and the multigrid spans of each solve nest in its own span.
    A Newtonian step opens none of them."""
    n = 16
    param = _param(n, tmp_path, z_start=0.0, aexp=0.5,
                   linear_newton_solver=solver_name)
    pos, vel = ics.lpt2(param, 7, "cpu")
    set_units(param)
    profiling.reset_spans()
    try:
        for theory in ("mond", "newton"):
            cfg = solver.config_from_param(dict(param, theory=theory))
            dyn = solver.compute_dynamics(dict(param, theory=theory))
            phi, u = solver.empty_fields(cfg, "cpu")
            p, v, ts, phi, u = solver.state_from_arrays(
                cfg, pos.T.float().numpy(), vel.T.float().numpy(), None,
                phi.numpy(), u.numpy(), "cpu")
            p, v, a, phi, u, _, _ = solver.pm(cfg, True, False, p, v, phi,
                                              u, dyn)
            with profile(activities=[ProfilerActivity.CPU]):
                integrate.step_lazy_impl(cfg, "leapfrog", 0, False, p, v, a,
                                         phi, u, ts, dyn, 1e-3)
        recs = profiling.span_records()
        steps = [r for r in recs if r["name"] == "step"]
        assert len(steps) == 2
        mond_recs = [r for r in recs if r["step"] == steps[0]["step"]]
        solve = [r for r in mond_recs if r["name"] == "pm.solve"]
        assert len(solve) == 1
        found = [r for r in mond_recs if r["name"].startswith("mond.")]
        assert [r["name"] for r in found] == list(SPANS)
        for r in found:
            assert r["parent"] == solve[0]["index"]
        own = {r["index"] for r in found if r["name"] != "mond.source"}
        mg = [r for r in mond_recs if r["name"].startswith("mg.")]
        assert all(r["parent"] in own for r in mg)
        assert bool(mg) == (solver_name == "multigrid")
        newton = [r["name"] for r in recs if r["step"] == steps[1]["step"]]
        assert "pm.solve" in newton
        assert not [name for name in newton if name.startswith("mond.")]
    finally:
        profiling.reset_spans()

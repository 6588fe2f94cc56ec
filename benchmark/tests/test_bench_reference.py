"""The plain reference against the program on the CPU (16^3-32^3),
against a closed form (a Zel'dovich plane wave), and its CIC outputs
against digests pinned from an earlier version of it."""

import hashlib
import json
import math
import os

import pytest
import torch

from reference import fas, ics, pm
from reference.cosmology import Cosmology, fr_constants
from reference.precision import BF16, F64

from pysco_tpu_torch import cosmo, ic_device, integrate, solver
from pysco_tpu_torch.models import multigrid
from pysco_tpu_torch.ops import fourier, mesh
from pysco_tpu_torch.utils.config import params_from_dict, with_defaults
from pysco_tpu_torch.utils.units import set_units

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _param(config, n, tmp_path, **over):
    with open(os.path.join(BENCH, "configs", f"{config}.json")) as f:
        c = json.load(f)
    p = dict(c["param"], ncoarse=int(math.log2(n)), npart=n ** 3,
             boxlen=float(n), seed=42, base=str(tmp_path), verbose=0,
             write_initial_snapshot=False,
             power_spectrum_file=os.path.join(BENCH, "configs",
                                              c["pk_file"]))
    p.update(over)
    return with_defaults(params_from_dict(p))


def _periodic(a, b):
    d = torch.abs(a.double() - b.double())
    return torch.minimum(d, 1 - d)


@pytest.mark.parametrize("n", [16, 32])
def test_2lpt_matches_the_program(n, tmp_path):
    param = _param("newton_fft_cic_512", n, tmp_path)
    tables = cosmo.generate(param)
    param["aexp"] = 1.0 / (1 + param["z_start"])
    set_units(param)
    pos, vel = ic_device.generate_lpt(param, tables, "cpu")
    rpos, rvel = ics.lpt2(param, 42, "cpu")
    assert float(_periodic(pos[:3], rpos).max()) * n < 1e-4
    gap = float((vel[:3].double() - rvel).abs().max())
    assert gap / float(rvel.pow(2).mean().sqrt()) < 1e-5


def _random_particles(n_part, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n_part, 3), generator=g)


@pytest.mark.parametrize("scheme", ["ngp", "cic", "tsc"])
def test_deposit_and_gather_match_the_program(scheme):
    n = 16
    rows = _random_particles(5000)
    ref = pm.deposit(rows.T.double(), n, scheme=scheme)
    got = mesh.deposit(rows, n, scheme)
    assert torch.allclose(ref, got.double(), rtol=0, atol=1e-5)
    g = torch.Generator().manual_seed(4)
    field = torch.rand((n, n, n, 3), generator=g)
    ref = pm.gather(field.permute(3, 0, 1, 2).double(), rows.T.double(),
                    scheme=scheme)
    got = mesh.gather_vec(field, rows, scheme)
    assert torch.allclose(ref, got.T.double(), rtol=0, atol=1e-5)


def test_fft_poisson_and_gradient_match_the_program():
    n = 32
    rhs = torch.randn((n, n, n), generator=torch.Generator().manual_seed(5))
    phi_ref = pm.poisson_fft(rhs.double(), 2)
    phi = fourier.irfft3(fourier.inverse_laplacian_compensated(
        fourier.rfft3(rhs), 2))
    scale = float(phi_ref.abs().max())
    assert float((phi.double() - phi_ref).abs().max()) / scale < 1e-5
    g_ref = pm.gradient(phi_ref)
    g = mesh.derivative(phi, 5, leading=True)
    assert float((g.double() - g_ref).abs().max()) / float(
        g_ref.abs().max()) < 1e-5


def test_7pt_poisson_is_what_multigrid_converges_to():
    n = 32
    rhs = torch.randn((n, n, n), generator=torch.Generator().manual_seed(6))
    rhs = rhs - rhs.mean()
    x = multigrid.linear(torch.zeros_like(rhs), rhs, 5, 2, 1, 1e-6)
    ref = pm.poisson_7pt(rhs.double())
    x = x.double() - x.double().mean()
    assert float((x - ref).abs().max()) / float(ref.abs().max()) < 1e-4


@pytest.mark.parametrize("aexp", [0.1, 0.5, 1.0])
def test_fas_matches_the_program(aexp, tmp_path):
    n = 32
    param = _param("fr_n1_mg_cic_512", n, tmp_path)
    pos, _ = ics.lpt2(param, 42, "cpu")
    rho = pm.density(pos, n, n ** 3)
    c = fr_constants(Cosmology(param), param, aexp)
    b = c["f1"] * rho + c["f2"]
    ref = fas.solve(b, c["q"], None, 5, 2, 1, 1e-2, F64)
    ops = multigrid.fas_ops_cubic(c["q"], exact_root=True)
    b32 = b.float()
    from pysco_tpu_torch.models import cubic

    u0 = cubic.initialise_potential(b32, c["q"])
    got = multigrid.FAS(u0, b32, ops, 5, 2, 1, 0.0)
    assert float((got.double() - ref).abs().max()) / float(
        ref.abs().max()) < 1e-4


def test_power_spectrum_matches_the_program():
    n = 32
    rows = _random_particles(n ** 3, seed=8)
    rho = pm.density(rows.T.double(), n, n ** 3)
    k, p, nm = pm.power_spectrum(rho, 2)
    k2, p2, nm2 = fourier.power_spectrum(fourier.rfft3(rho.float()), 2)
    assert torch.equal(nm, nm2.double())
    assert torch.allclose(k, k2.double(), rtol=1e-6)
    assert float((p / p2.double() - 1).abs().max()) < 1e-4


def test_kick_drift_matches_the_program():
    g = torch.Generator().manual_seed(9)
    pos = torch.rand((4, 1000), generator=g)
    vel = 1e-2 * torch.randn((4, 1000), generator=g)
    acc = 1e-2 * torch.randn((4, 1000), generator=g)
    p, v, _ = integrate.kick_drift("leapfrog", pos, vel, acc, 0.3)
    rp, rv = pm.kick_drift(pos[:3], vel[:3], acc[:3], 0.3)
    assert float(_periodic(p[:3], rp).max()) < 1e-6
    assert float((v[:3].double() - rv).abs().max()) < 1e-7


@pytest.mark.parametrize("config, scheme", [
    ("newton_fft_cic_512", "CIC"), ("fr_n1_mg_cic_512", "CIC"),
    ("newton_fft_cic_512", "TSC")])
def test_forces_match_the_program(config, scheme, tmp_path):
    n = 32
    param = _param(config, n, tmp_path, epsrel=1e-6, mass_scheme=scheme)
    cosmo.generate(param)
    param["aexp"] = 0.5
    set_units(param)
    pos, _ = ics.lpt2(param, 42, "cpu")
    rho = pm.density(pos, n, n ** 3, scheme=scheme.casefold())
    cfg = solver.config_from_param(param)
    dyn = solver.compute_dynamics(param)
    potential, u = solver.empty_fields(cfg, "cpu")
    force, _, _, _ = solver._solve_fields(cfg, True, False, rho.float(),
                                          potential, u, dyn, leading=True)
    ref, _ = pm.Forces(param)(rho, 0.5)
    gap = float((force.double() - ref).abs().max())
    assert gap / float(ref.pow(2).mean().sqrt()) < 1e-3


def test_zeldovich_plane_wave(tmp_path):
    """Before shell crossing a plane wave is Zel'dovich's exact solution:
    the acceleration of a particle is -1.5 a Om_m times its displacement
    (Gauss's law in one dimension). The wave's amplitude in the PM
    acceleration is compared; the grid's deconvolved CIC windows leave a
    residue at the Nyquist scale, about a tenth of the wave."""
    n = 32
    param = _param("newton_fft_cic_512", n, tmp_path)
    aexp = 0.5
    q = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    qx, qy, qz = torch.meshgrid(q, q, q, indexing="ij")
    amp = 0.2 / n  # a fifth of a cell
    psi = amp * torch.sin(2 * math.pi * qx)
    pos = torch.stack([(qx + psi) % 1.0, qy, qz]).reshape(3, -1)
    rho = pm.density(pos, n, n ** 3)
    force, _ = pm.Forces(param)(rho, aexp)
    acc = pm.gather(force, pos)
    want = -1.5 * aexp * Cosmology(param).Om * psi.reshape(-1)
    ratio = float((acc[0] * want).sum() / (want * want).sum())
    assert abs(ratio - 1.0) < 1e-3
    assert float((acc[0] - want).abs().max()) < 0.15 * float(
        want.abs().max())
    assert float(acc[1:].abs().max()) < 1e-9 * float(want.abs().max())


PIN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "cic_reference_pin.json")


def pinned_outputs(tmp_path) -> dict:
    """The reference's CIC outputs on seeded inputs at 16^3, in float64 and
    in the control's bfloat16: 2LPT, deposit, density, gather, the forces
    (Newton FFT; f(R) n = 1 multigrid with its scalaron), a step of each
    and P(k)."""
    n = 16
    newton = _param("newton_fft_cic_512", n, tmp_path)
    fr = _param("fr_n1_mg_cic_512", n, tmp_path)
    pos, vel = ics.lpt2(newton, 42, "cpu")
    out = {"lpt2": (pos, vel)}
    g = torch.Generator().manual_seed(11)
    rows = torch.rand((3, 5000), generator=g, dtype=torch.float64)
    w = torch.randn(5000, generator=g, dtype=torch.float64)
    field = torch.randn((3, n, n, n), generator=g, dtype=torch.float64)
    acc = 1e-2 * torch.randn((3, n ** 3), generator=g, dtype=torch.float64)
    for prec in (F64, BF16):
        tag = prec.name
        out[f"deposit.{tag}"] = pm.deposit(rows, n, w, prec)
        out[f"gather.{tag}"] = pm.gather(field, rows, prec)
        rho = pm.density(pos, n, n ** 3, prec)
        out[f"density.{tag}"] = rho
        out[f"power_spectrum.{tag}"] = pm.power_spectrum(rho, 2, prec)
        for name, param in (("newton", newton), ("fr", fr)):
            forces = pm.Forces(param, prec)
            force, u = forces(rho, 0.5)
            out[f"forces.{name}.{tag}"] = (force, u)
            out[f"step.{name}.{tag}"] = pm.step(param, forces, pos, vel, acc,
                                                u, 0.02, 0.5)
    return out


def _digest(value) -> str:
    h = hashlib.sha256()
    for t in value if isinstance(value, tuple) else (value,):
        if t is not None:
            h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_cic_reference_is_pinned(tmp_path):
    """Bit for bit: the digests were taken from the reference before it
    took NGP and TSC and configuration modules."""
    with open(PIN) as f:
        want = json.load(f)
    got = {k: _digest(v) for k, v in pinned_outputs(tmp_path).items()}
    assert got == want

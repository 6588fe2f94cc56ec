"""The port's slab-sharded LPT initial conditions
(pysco_tpu_torch/parallel/ic_slab.py) against the JAX package's
(pysco_tpu/parallel/ic_slab.py) on the same number of virtual CPU devices,
and against the port's single-device ``ic_device.generate_lpt``.

Every path draws the same host random numbers, so the white noise is the
same bits; the LPT algebra runs through other FFTs (the pencil FFT, the
JAX package's), so the particles agree to float32 FFT rounding: positions
and velocities within 5e-6 of the velocity scale + 5e-8
(tests/test_ic_slab.py's bound). Shards own contiguous x planes of the
lattice, so the columns compare one for one.
"""

import numpy as np
import pytest
import torch

from pysco_tpu import cosmo as jcosmo
from pysco_tpu.parallel import ic_slab as jic_slab
from pysco_tpu.parallel import slab as jslab
from pysco_tpu_torch import cosmo, ic_device, solver
from pysco_tpu_torch.ops import tiled_pm
from pysco_tpu_torch.parallel import ic_slab, slab
from pysco_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pk_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("pk") / "pk.dat"
    cosmo.write_power_spectrum_table(str(path))
    return str(path)


def _param(tmp_path, pk_file, order, dealias=False, n=32, **kw):
    base = tmp_path / "run"
    for sub in ("", "output_00000"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    p = {
        "theory": "newton", "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
        "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 100,
        "ncoarse": 5, "npart": n ** 3, "z_start": 49, "seed": 42,
        "position_ICS": "center", "fixed_ICS": False, "paired_ICS": False,
        "dealiased_ICS": dealias, "power_spectrum_file": pk_file,
        "initial_conditions": order, "base": str(base), "extra": "test",
        "output_snapshot_format": "npz", "mass_scheme": "TSC",
        "linear_newton_solver": "fft", "gradient_stencil_order": 5,
        "Npre": 2, "Npost": 1, "fR_n": 1, "mond_function": "simple",
        "mond_alpha": 1.0, "epsrel": 1e-2, "particle_engine": "pallas",
        "parametrized_mu0": 0.0, "Om_r": 0.0, "Om_lambda": 0.74267,
        "unit_l": 1.0, "unit_t": 1.0, "verbose": 0,
        "write_initial_snapshot": False, "parallel_mode": "slab",
    }
    p.update(kw)
    p["aexp"] = 1.0 / (1 + p["z_start"])
    return p


def _wrap_dist(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 1.0 - d)


def _assert_close(pos, vel, pos_w, vel_w, what):
    assert _wrap_dist(pos, pos_w).max() < 5e-6, what
    scale = max(np.abs(vel_w).max(), 1e-12)
    np.testing.assert_allclose(vel, vel_w, rtol=0, atol=5e-6 * scale + 5e-8,
                               err_msg=what)


@pytest.mark.parametrize("order,dealias,fixed,d", [
    ("1LPT", False, False, 4), ("2LPT", False, False, 2),
    ("2LPT", True, False, 4), ("3LPT", False, False, 4),
    ("3LPT", True, False, 4), ("1LPT", False, True, 4)])
def test_slab_ic_matches_jax_and_single(tmp_path, pk_file, order, dealias,
                                        fixed, d):
    """generate_lpt_slab on d shards: every shard's columns against the JAX
    slab state's column block (the same layout: capacity, lattice planes
    first, sentinels after), and the gathered rows against the port's
    single-device ICs; the fixed case is also paired (the phase shift)."""
    n = 32 if order == "2LPT" else 16
    param = _param(tmp_path, pk_file, order, dealias, n=n, fixed_ICS=fixed,
                   paired_ICS=fixed, ncoarse=int(np.log2(n)))
    tables = cosmo.generate(param)
    mesh = pmesh.make_mesh(devices=["cpu"] * d)
    assert ic_slab.supported(param, d)
    state = ic_slab.generate_lpt_slab(param, tables, mesh)
    assert ic_slab.TIMES["generate_lpt_slab"] > 0
    cap = slab.shard_capacity(n ** 3, d)
    planes = n // d
    for r in range(d):
        pos, vel, acc, phi, u, ts = (a[r] for a in state)
        assert pos.shape == vel.shape == acc.shape == (4, cap)
        assert not pos[3].any() and not acc.any()
        assert bool((pos[:3, planes * n * n:] == tiled_pm.SENTINEL).all())
        assert phi.shape == (planes, n, n) and u.shape == (1, 1, 1)
        assert ts.shape == (tiled_pm.n_tiles(n, None, planes) + 1,)
    jstate = jic_slab.generate_lpt_slab(param, jcosmo.generate(param),
                                        jslab.make_mesh(d))
    jpos, jvel = np.array(jstate[0]), np.array(jstate[1])
    pos = torch.cat(state[0], dim=1).numpy()
    vel = torch.cat(state[1], dim=1).numpy()
    assert pos.shape == jpos.shape
    real = pos[0] < tiled_pm.SENTINEL_MIN
    np.testing.assert_array_equal(real, jpos[0] < tiled_pm.SENTINEL_MIN)
    _assert_close(pos[:3, real], vel[:3, real], jpos[:3, real],
                  jvel[:3, real], "port vs JAX")
    rows = slab.gather_particles(state[0], state[1])
    cfg = solver.config_from_param(param)
    pc, vc = ic_device.generate_lpt(dict(param, parallel_mode="single"),
                                    tables, "cpu")
    _assert_close(*rows, *solver.particles_to_rows(cfg, pc, vc),
                  "slab vs single device")


def test_pad_and_trim_move_rows_across_shards():
    """The Orszag pad of y-sharded pencils (the Nyquist rows dropped, the
    y blocks straddling m/2 split between shards) is the single-device
    pad cut into the padded shards' blocks, and the trim takes it back,
    rescaled, at D = 4 and D = 2."""
    m = 16
    rng = np.random.default_rng(0)
    xk = torch.complex(*(torch.as_tensor(rng.standard_normal(
        (m, m, m // 2 + 1)).astype(np.float32)) for _ in range(2)))
    for d in (2, 4):
        mesh = pmesh.make_mesh(devices=["cpu"] * d)
        padded = ic_slab._pad_pencil(pmesh.scatter(xk, mesh, 1), mesh, m)
        want = ic_device.pad_k(xk)
        assert torch.equal(torch.cat(padded, dim=1), want)
        back = torch.cat(ic_slab._trim_pencil(padded, mesh, 3 * m // 2, 1.5),
                         dim=1)
        assert torch.equal(back, ic_device.trim_k(want) * 1.5)


def test_supported_matches_jax(tmp_path, pk_file):
    """ic_slab.supported against the JAX package's on a table of params."""
    cases = [
        ({}, 4), ({}, 8), ({"npart": 24 ** 3}, 4), ({"npart": 24 ** 3}, 8),
        ({"npart": 1000}, 2), ({"initial_conditions": "3LPT"}, 2),
        ({"initial_conditions": 2}, 4), ({"initial_conditions": "snap.h5"}, 4),
        ({"ic_device": False}, 4), ({"particle_engine": "scatter"}, 4),
        ({"ncoarse": 1}, 4), ({"ncoarse": 2}, 4), ({"ncoarse": 2}, 8),
    ]
    got = []
    for over, d in cases:
        param = _param(tmp_path, pk_file, "2LPT", **over)
        assert ic_slab.supported(param, d) == jic_slab.supported(param, d), (
            over, d)
        got.append(ic_slab.supported(param, d))
    assert any(got) and not all(got)


def test_run_slab_takes_the_sharded_ics(tmp_path, pk_file):
    """run() in slab mode builds LPT ICs with ic_slab (TIMES set, the
    output_00000 snapshot written from the shards) and steps from them;
    with ic_device = False it takes the host path and ic_slab stays
    unused. Both runs' final snapshots agree to 1e-5."""
    import pysco_tpu_torch
    from pysco_tpu_torch.utils import io as iostream

    snaps = {}
    for tag, over in (("sharded", {}), ("host", {"ic_device": False})):
        ic_slab.TIMES["generate_lpt_slab"] = None
        param = _param(tmp_path / tag, pk_file, "2LPT", n=16, ncoarse=4,
                       z_out="[45]", save_power_spectrum="no",
                       integrator="leapfrog", n_reorder=50,
                       Courant_factor=1.0, max_aexp_stepping=10,
                       write_initial_snapshot=True, **over)
        recs = pysco_tpu_torch.run(param, device="cpu", devices=["cpu"] * 4)
        assert recs and all(r.overflow == 0 for r in recs)
        assert (ic_slab.TIMES["generate_lpt_slab"] is None) == (tag == "host")
        base = tmp_path / tag / "run"
        assert list((base / "output_00000").glob("particles_*.npz"))
        snap = sorted(base.glob("output_00001/particles_*.npz"))[-1]
        snaps[tag] = iostream.read_snapshot_particles_npz(str(snap))
    from scipy.spatial import cKDTree

    (pa, va), (pb, vb) = snaps["sharded"], snaps["host"]
    assert pa.shape == pb.shape == (16 ** 3, 3)
    dist, idx = cKDTree(np.mod(pa.astype(np.float64), 1.0),
                        boxsize=1.0).query(np.mod(pb.astype(np.float64), 1.0))
    assert len(np.unique(idx)) == len(idx) and dist.max() < 1e-5
    np.testing.assert_allclose(va[idx], vb, rtol=0,
                               atol=1e-5 * np.abs(vb).max())

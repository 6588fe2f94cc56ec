"""The port's slab mode (pysco_tpu_torch/parallel/slab.py and the slab call
forms of pysco_tpu_torch/ops/tiled_pm.py) against the JAX package's
(pysco_tpu/parallel/slab.py, pysco_tpu/ops/pallas_pm.py) and against the
port's own single-device functions.

The same numpy inputs go through both packages. The JAX side runs on 4 (or
1, 2) of the 8 virtual CPU devices with Pallas in interpret mode, as
tests/test_slab.py runs it; the port runs on the mesh ``[cpu] * D``, its
wrappers taking the plain PyTorch twins of the kernels (the kernels are held
against the twins on the card by chip_smoke.py and tests/test_torch_cuda.py).
One process, nothing spawned.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from pysco_tpu import solver as jsolver
from pysco_tpu.ops import pallas_pm
from pysco_tpu.parallel import slab as jslab
from pysco_tpu_torch import integrate as tintegrate
from pysco_tpu_torch import solver as tsolver
from pysco_tpu_torch.ops import fourier, mesh as mesh_ops, tiled_pm
from pysco_tpu_torch.parallel import mesh as pmesh
from pysco_tpu_torch.parallel import slab

torch.set_num_threads(1)

M = 32


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _cpu_mesh(d):
    return pmesh.make_mesh(devices=["cpu"] * d)


def _rows(n, seed, clustered=False, vscale=1.0):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3), dtype=np.float32)
    if clustered:
        pos[: n // 2] = 0.2 + 0.25 * pos[: n // 2]
    vel = (vscale * rng.standard_normal((n, 3))).astype(np.float32)
    return pos, vel


def _drifted(ps, m, cells, seed):
    """Move every real column by up to ``cells`` cells per axis (wrapped)
    without re-sorting: a stale-bin state."""
    rng = np.random.default_rng(seed)
    out = ps.copy()
    real = out[0] < pallas_pm.SENTINEL_MIN
    delta = (cells / m * rng.uniform(-1, 1, (3, out.shape[1]))).astype(
        np.float32)
    out[:3] = np.where(real, (out[:3] + delta) % np.float32(1), out[:3])
    return out


# ---------------------------------------------------------------------------
# The kernels' module: slab geometry, sort, and the twins of the slab forms
# ---------------------------------------------------------------------------

SLABS = [(24, 8), (5, 3)]  # (plane0, n_planes)


@pytest.mark.parametrize("plane0,n_planes", SLABS)
@pytest.mark.parametrize("scheme", ["ngp", "cic", "tsc"])
def test_slab_tile_keys_and_sort_match(scheme, plane0, n_planes):
    """Slab-local tile ids (strangers key past the end), and the sort's
    tile starts exactly; lax.sort is not stable, so each tile's particles
    are compared as a multiset."""
    n = 3000
    pos, vel = _rows(n, 1, clustered=True)
    pc, vc = pallas_pm.to_columns(pos, vel, n)
    want = np.array(pallas_pm.tile_keys(pc, M, scheme, plane0, n_planes))
    got = tiled_pm.tile_keys(_t(np.array(pc)), M, scheme, None, plane0,
                             n_planes).numpy()
    np.testing.assert_array_equal(got, want)
    nt = tiled_pm.n_tiles(M, None, n_planes)
    assert nt == pallas_pm.n_tiles(M, n_planes) and (got == nt).any()
    ps_j, _, ts_j = pallas_pm.sort_particles(pc, vc, M, scheme, plane0,
                                             n_planes)
    ps, vs, ts = tiled_pm.sort_particles(_t(np.array(pc)), _t(np.array(vc)),
                                         M, scheme, None, plane0, n_planes)
    ts = ts.numpy()
    np.testing.assert_array_equal(ts, np.array(ts_j))
    assert ts.shape == (nt + 1,) and 0 < ts[-1] < n
    ps, ps_j = ps.numpy(), np.array(ps_j)
    for t in range(nt):
        a, b = ps[:3, ts[t]:ts[t + 1]], ps_j[:3, ts[t]:ts[t + 1]]
        np.testing.assert_array_equal(a[:, np.lexsort(a[::-1])],
                                      b[:, np.lexsort(b[::-1])])


@pytest.mark.parametrize("plane0,n_planes", SLABS)
@pytest.mark.parametrize("scheme,drift", [("cic", 1), ("tsc", 2)])
def test_slab_drift_violations_match(scheme, drift, plane0, n_planes):
    n = 3000
    pos, vel = _rows(n, 5)
    pc, vc = pallas_pm.to_columns(pos, vel, n)
    ps, _, ts = pallas_pm.sort_particles(pc, vc, M, scheme, plane0, n_planes)
    ps, ts = np.array(ps), np.array(ts)
    bad = _drifted(ps, M, drift + 1.5, 6)
    want = int(pallas_pm.drift_violations(jnp.asarray(bad), jnp.asarray(ts),
                                          M, scheme, drift, plane0,
                                          n_planes))
    got = int(tiled_pm.drift_violations(_t(bad), _t(ts), M, scheme, drift,
                                        None, plane0, n_planes))
    assert got == want > 0
    ok = _drifted(ps, M, drift - 0.05, 7)
    assert int(tiled_pm.drift_violations(_t(ok), _t(ts), M, scheme, drift,
                                         None, plane0, n_planes)) == 0


def _jax_slab_transfers(ps, ts, field_ext, m, scheme, drift, plane0,
                        n_planes):
    """pallas_pm.deposit_slab and gather_vec_slab in interpret mode, f32
    passes; the field is handed over components last."""
    gp = jax.jit(lambda p, t: pallas_pm.deposit_slab(
        p, t, m, scheme, True, n_planes, drift, jnp.int32(plane0),
        precision="f32"))(jnp.asarray(ps), jnp.asarray(ts))
    acc = jax.jit(lambda f, p, t: pallas_pm.gather_vec_slab(
        f, p, t, scheme, True, drift, jnp.int32(plane0),
        precision="f32"))(jnp.asarray(np.moveaxis(field_ext, 0, -1)),
                          jnp.asarray(ps), jnp.asarray(ts))
    return np.array(gp), np.array(acc)


def _thin(scheme, drift):
    return max(tiled_pm._WIDTH[scheme] - 1 + drift, 1)


@pytest.mark.parametrize("shape", ["quarter", "thin"])
@pytest.mark.parametrize("scheme", ["cic", "tsc"])
@pytest.mark.parametrize("drift", [0, 1, 2])
def test_slab_twins_match_pallas(drift, scheme, shape):
    """deposit_slab and gather_vec_slab (their twins, on the CPU) against
    the Pallas slab forms at plane0 != 0: a quarter of the grid and the
    thinnest slab the step allows (w - 1 + drift planes). The deposit to
    1e-6 of the largest cell (the same weights in the same cells, summed in
    another order), the gather to 1e-6 of the field's maximum."""
    n = 3000
    n_planes = M // 4 if shape == "quarter" else _thin(scheme, drift)
    plane0 = 16
    pos, vel = _rows(n, 11, clustered=True)
    pc, vc = pallas_pm.to_columns(pos, vel, n)
    ps, _, ts = pallas_pm.sort_particles(pc, vc, M, scheme, plane0, n_planes)
    ps, ts = np.array(ps), np.array(ts)
    if drift:
        ps = _drifted(ps, M, drift - 0.05, 12)
    w = tiled_pm._WIDTH[scheme]
    nx = n_planes + w - 1 + 2 * drift
    field = np.random.default_rng(13).random((3, nx, M, M)).astype(np.float32)
    gp_j, acc_j = _jax_slab_transfers(ps, ts, field, M, scheme, drift,
                                      plane0, n_planes)
    gp = tiled_pm.deposit_slab(_t(ps), _t(ts), M, scheme, drift, None,
                               plane0, n_planes).numpy()
    assert gp.shape == gp_j.shape == (nx, M, M)
    np.testing.assert_allclose(gp, gp_j, atol=1e-6 * gp_j.max(), rtol=0)
    np.testing.assert_allclose(gp.astype(np.float64).sum(), ts[-1],
                               rtol=1e-6)
    acc = tiled_pm.gather_vec_slab(_t(field), _t(ps), _t(ts), scheme, drift,
                                   None, plane0).numpy()
    np.testing.assert_allclose(acc, acc_j, atol=1e-6 * field.max(), rtol=0)
    assert not acc[3].any() and not acc[:, ts[-1]:].any()
    assert np.abs(acc[:3, :ts[-1]]).max() > 0.1


_ZB_CHILD = r"""
import json, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from pysco_tpu.ops import pallas_pm

m, plane0, n_planes = 16, 8, 4
assert pallas_pm.n_zblocks(m) == m // 8
rng = np.random.default_rng(0)
n = 3000
out = {}
for scheme, drift in (("cic", 0), ("cic", 1), ("tsc", 2)):
    w = {"cic": 2, "tsc": 3}[scheme]
    pos = rng.random((n, 3)).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    pc, vc = pallas_pm.to_columns(pos, vel, n)
    ps, _, ts = pallas_pm.sort_particles(pc, vc, m, scheme, plane0, n_planes)
    ps = np.array(ps)
    if drift:
        real = ps[0] < pallas_pm.SENTINEL_MIN
        delta = ((drift - 0.05) / m * rng.uniform(
            -1, 1, (3, ps.shape[1]))).astype(np.float32)
        ps[:3] = np.where(real, (ps[:3] + delta) % np.float32(1), ps[:3])
    f = rng.random((3, n_planes + w - 1 + 2 * drift, m, m)).astype(np.float32)
    key = f"{scheme}_{drift}"
    save = lambda s, a: np.save(os.path.join(sys.argv[1], f"{key}_{s}.npy"),
                                np.array(a))
    save("ps", ps); save("ts", ts); save("f", f)
    save("gp", pallas_pm.deposit_slab(
        jnp.asarray(ps), ts, m, scheme, True, n_planes, drift,
        jnp.int32(plane0), precision="f32"))
    save("acc", pallas_pm.gather_vec_slab(
        jnp.asarray(np.moveaxis(f, 0, -1)), jnp.asarray(ps), ts, scheme,
        True, drift, jnp.int32(plane0), precision="f32"))
    out[key] = int(pallas_pm.drift_violations(
        jnp.asarray(ps), ts, m, scheme, drift, plane0, n_planes))
print("@@" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def zb_slab_child(tmp_path_factory):
    """The JAX engine's z-blocked slab states and results (m = 16, z-block
    8, the slab of planes 8..11: the thinnest for TSC at drift 2): it takes
    its z-block size from PYSCO_TPU_ZB at import, so it runs once in a
    subprocess."""
    out = tmp_path_factory.mktemp("zbslab")
    env = dict(os.environ, PYSCO_TPU_ZB="8", JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", _ZB_CHILD, str(out)], env=env,
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    viol = json.loads([ln for ln in r.stdout.splitlines()
                       if ln.startswith("@@")][-1][2:])
    return out, viol


@pytest.mark.parametrize("key", ["cic_0", "cic_1", "tsc_2"])
def test_zblocked_slab_twins_match_pallas(zb_slab_child, key):
    """z-blocked tiles on a slab: the port is given zbs = 8."""
    tmp_path, viol = zb_slab_child
    m, zbs, plane0, n_planes = 16, 8, 8, 4
    scheme, drift = key.split("_")[0], int(key.split("_")[1])

    def load(s):
        return np.load(tmp_path / f"{key}_{s}.npy")

    ps, ts, f = _t(load("ps")), _t(load("ts")), _t(load("f"))
    assert ts.shape[0] == tiled_pm.n_tiles(m, zbs, n_planes) + 1
    assert int(tiled_pm.drift_violations(ps, ts, m, scheme, drift, zbs,
                                         plane0, n_planes)) == viol[key] == 0
    gp = tiled_pm.deposit_slab(ps, ts, m, scheme, drift, zbs, plane0,
                               n_planes).numpy()
    np.testing.assert_allclose(gp, load("gp"), atol=1e-6 * load("gp").max(),
                               rtol=0)
    acc = tiled_pm.gather_vec_slab(f, ps, ts, scheme, drift, zbs,
                                   plane0).numpy()
    np.testing.assert_allclose(acc, load("acc"), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="expected shape"):
        tiled_pm.gather_vec_slab(f, ps, ts, scheme, drift, None, plane0)


def test_slab_forms_refuse_what_they_cannot_do():
    """A slab outside the grid or thinner than the window's reach raises;
    a device without a kernel raises instead of taking the twin."""
    pos, vel = _rows(600, 31)
    pc, vc = tiled_pm.to_columns_host(pos, vel, 600)
    ps, _, ts = tiled_pm.sort_particles(_t(pc), _t(vc), 16, "tsc", None, 8, 4)
    with pytest.raises(ValueError, match="outside the grid"):
        tiled_pm.deposit_slab(ps, ts, 16, "tsc", 0, None, 14, 4)
    ps1, _, ts1 = tiled_pm.sort_particles(_t(pc), _t(vc), 16, "tsc", None,
                                          8, 2)
    with pytest.raises(ValueError, match="thinner"):
        tiled_pm.deposit_slab(ps1, ts1, 16, "tsc", 1, None, 8, 2)
    with pytest.raises(ValueError, match="no kernel"):
        tiled_pm.deposit_slab(ps.to("meta"), ts, 16, "tsc", 0, None, 8, 4)
    with pytest.raises(ValueError, match="no kernel"):
        tiled_pm.gather_vec_slab(torch.zeros((3, 6, 16, 16), device="meta"),
                                 ps.to("meta"), ts, "tsc", 0, None, 8)
    before = dict(tiled_pm.LAUNCHES)
    tiled_pm.deposit_slab(ps, ts, 16, "tsc", 0, None, 8, 4)
    assert tiled_pm.LAUNCHES == before  # the twin counts no launch


@pytest.mark.parametrize("scheme,drift,n_dev", [("cic", 0, 4), ("tsc", 2, 4),
                                               ("cic", 1, 2), ("tsc", 1, 1)])
def test_slab_deposits_and_spill_make_the_single_deposit(scheme, drift,
                                                         n_dev):
    """D slab deposits and add_spill are the single-device deposit of the
    same particles (float32 rounding: the spill planes are added last); at
    D = 1 add_spill is the periodic fold, bit for bit."""
    n = 4000
    planes = M // n_dev
    mesh = _cpu_mesh(n_dev)
    pos, vel = _rows(n, 3, clustered=True)
    pc, vc = tiled_pm.to_columns_host(pos, vel, n)
    ps, _, ts = tiled_pm.sort_particles(_t(pc), _t(vc), M, scheme)
    if drift:
        ps = _t(_drifted(ps.numpy(), M, drift - 0.05, 4))
    want = tiled_pm.deposit(ps, ts, M, scheme, drift)
    # the same stale state seen from the slabs: the tiles of slab r are a
    # run of the global tiles
    nt = tiled_pm.n_tiles(M, None, planes)
    gps = []
    for r in range(n_dev):
        lo, hi = int(ts[r * nt]), int(ts[(r + 1) * nt])
        cols = torch.full_like(ps, tiled_pm.SENTINEL)
        cols[3] = 0.0
        cols[:, :hi - lo] = ps[:, lo:hi]
        gps.append(tiled_pm.deposit_slab(
            cols, ts[r * nt:(r + 1) * nt + 1] - lo, M, scheme, drift, None,
            r * planes, planes))
    got = torch.cat(slab.add_spill(gps, planes, mesh, lead=drift))
    if n_dev == 1:
        assert torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.max()))
    assert float(got.double().sum()) == pytest.approx(n, rel=1e-6)


# ---------------------------------------------------------------------------
# Pencil FFT, stencils and P(k) on the slabs
# ---------------------------------------------------------------------------

def _slabs(x, d, axis=0):
    return [c.contiguous() for c in torch.chunk(_t(x), d, dim=axis)]


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_pencil_fft_roundtrip_and_rfftn(n_dev):
    """The pencil FFT is torch.fft.rfftn, its y axis cut over the shards
    (1e-5 of the largest mode: another order of the 1-D transforms), and
    the inverse chain returns the grid (1e-6 of its maximum)."""
    x = np.random.default_rng(0).standard_normal((M, M, M)).astype(np.float32)
    mesh = _cpu_mesh(n_dev)
    xk = slab.rfft3_slab(_slabs(x, n_dev), mesh)
    assert xk[0].shape == (M, M // n_dev, M // 2 + 1)
    want = torch.fft.rfftn(_t(x))
    torch.testing.assert_close(torch.cat(xk, dim=1), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    back = torch.cat(slab.irfft3_slab(xk, mesh, M))
    torch.testing.assert_close(back, _t(x), rtol=0,
                               atol=1e-6 * float(np.abs(x).max()))


@pytest.mark.parametrize("n_dev", [1, 4])
def test_irfft3_slab_of_a_gradient(n_dev):
    """A spectrum that is not Hermitian on its zero and Nyquist planes (a
    spectral gradient: i k at k = -M/2 has no partner) goes back as
    irfftn takes it: the imaginary parts there are not read. The pencil
    transform clears them, since cuFFT's 1-D real transform would read
    them (tests/test_torch_cuda.py holds it against irfftn on the card)."""
    x = np.random.default_rng(5).standard_normal((M, M, M)).astype(np.float32)
    mesh = _cpu_mesh(n_dev)
    xk, xk1 = slab.rfft3_slab(_slabs(x, n_dev), mesh), fourier.rfft3(_t(x))
    for a in range(3):
        got = torch.cat(slab.irfft3_slab(slab._per_pencil(
            lambda p, ks: (fourier._TWOPI_I * p) * ks[a], xk, M), mesh, M))
        want = fourier.irfft3(fourier.gradient_axis(xk1, a))
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("kernel", ["fft", "fft_7pt", "full_fft"])
def test_slab_solves_match_single_and_jax(kernel):
    """The three k-space solves on 4 slabs against the port's single-device
    ones and the JAX package's slab ones, to 1e-5 of the field's maximum
    (FFT roundoff; the libraries differ)."""
    x = np.random.default_rng(1).standard_normal((M, M, M)).astype(np.float32)
    mesh = _cpu_mesh(4)
    xk = slab.rfft3_slab(_slabs(x, 4), mesh)
    xk1 = fourier.rfft3(_t(x))
    jmesh = jslab.make_mesh(4)
    if kernel == "full_fft":
        got = torch.cat(slab.gradient_inverse_laplacian_slab(xk, mesh, M, 2),
                        dim=1)
        want = fourier.irfft3_vec(
            fourier.gradient_inverse_laplacian_compensated(xk1, 2)
        ).movedim(-1, 0)
        jfn = lambda v: jslab.gradient_inverse_laplacian_slab(  # noqa: E731
            jslab.rfft3_slab(v, 4), M, 2, 4)
    elif kernel == "fft":
        got = torch.cat(slab.irfft3_slab(
            slab.inverse_laplacian_slab(xk, M, 2), mesh, M))
        want = fourier.irfft3(fourier.inverse_laplacian_compensated(xk1, 2))
        jfn = lambda v: jslab.irfft3_slab(  # noqa: E731
            jslab.inverse_laplacian_slab(jslab.rfft3_slab(v, 4), M, 2), M)
    else:
        got = torch.cat(slab.irfft3_slab(
            slab.inverse_laplacian_7pt_slab(xk, M), mesh, M))
        want = fourier.irfft3(fourier.inverse_laplacian_7pt(xk1))
        jfn = lambda v: jslab.irfft3_slab(  # noqa: E731
            jslab.inverse_laplacian_7pt_slab(jslab.rfft3_slab(v, 4), M), M)
    jgot = np.array(jax.jit(shard_map(
        jfn, mesh=jmesh, in_specs=P("dp"), out_specs=P("dp"),
        check_vma=False))(jnp.asarray(x)))
    if kernel == "full_fft":
        jgot = np.moveaxis(jgot, -1, 0)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), jgot, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("order", [2, 3, 5, 7])
def test_derivative_slab_matches_single_and_jax(order):
    """Bitwise the port's single-device gradient (the same stencil on the
    same floats), and the JAX slab gradient to 2e-6 of its maximum (the
    stencil's terms are summed in another order there)."""
    phi = np.random.default_rng(2).standard_normal((M, M, M)).astype(
        np.float32)
    mesh = _cpu_mesh(4)
    got = torch.cat(slab.derivative_slab(_slabs(phi, 4), order, mesh), dim=1)
    assert torch.equal(got, mesh_ops.derivative(_t(phi), order, leading=True))
    jgot = np.array(jax.jit(shard_map(
        lambda v: jslab.derivative_slab(v, order, 4), mesh=jslab.make_mesh(4),
        in_specs=P("dp"), out_specs=P("dp"), check_vma=False))(
            jnp.asarray(phi)))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(jgot, -1, 0), rtol=0,
                               atol=2e-6 * np.abs(jgot).max())


def test_halo_and_mond_rhs_slab():
    """The halo exchange wraps around the mesh, and the QUMOND source on
    extended slabs is bitwise the single-device one."""
    from pysco_tpu_torch.models import mond

    phi = np.random.default_rng(3).standard_normal((M, M, M)).astype(
        np.float32)
    mesh = _cpu_mesh(4)
    ext = slab.exchange_halo_x(_slabs(phi, 4), 2, mesh)
    full = np.concatenate([phi[-2:], phi, phi[:2]])
    for r, e in enumerate(ext):
        np.testing.assert_array_equal(e.numpy(), full[8 * r:8 * r + 12])
    lr = slab.halo_lr(_slabs(phi, 4), 1, 3, mesh)
    np.testing.assert_array_equal(lr[3].numpy(),
                                  np.concatenate([phi[23:], phi[:3]]))
    with pytest.raises(ValueError, match="halo"):
        slab.halo_lr(_slabs(phi, 4), 9, 0, mesh)
    got = torch.cat(slab.mond_rhs_slab(_slabs(0.01 * phi, 4), 0.3, "simple",
                                       1.0, mesh))
    assert torch.equal(got, mond.rhs(_t(0.01 * phi), 0.3, "simple", 1.0))


@pytest.mark.parametrize("n_dev", [1, 4])
def test_power_spectrum_slab_matches_single_and_jax(n_dev):
    """The slab P(k) against the port's single-device estimator (the same
    modes in the same bins; the float64 bin sums are split over the shards:
    1e-6) and against the JAX slab estimator (float32 scatter-adds: 1e-4,
    the bar of tests/test_slab.py); mode counts exactly. Two calls are
    bitwise equal."""
    x = np.random.default_rng(4).standard_normal((M, M, M)).astype(np.float32)
    mesh = _cpu_mesh(n_dev)
    xk = slab.rfft3_slab(_slabs(x, n_dev), mesh)
    k1, p1, n1 = slab.power_spectrum_slab(xk, mesh, M, 3)
    for a, b in zip((k1, p1, n1), slab.power_spectrum_slab(xk, mesh, M, 3)):
        assert torch.equal(a, b)
    k0, p0, n0 = fourier.power_spectrum(fourier.rfft3(_t(x)), 3)
    assert torch.equal(n1, n0)
    torch.testing.assert_close(k1, k0, rtol=1e-6, atol=0)
    torch.testing.assert_close(p1, p0, rtol=1e-6, atol=0)
    jk, jp, jn = (np.array(v) for v in jax.jit(shard_map(
        lambda v: jslab.power_spectrum_slab(jslab.rfft3_slab(v, n_dev), M, 3),
        mesh=jslab.make_mesh(n_dev), in_specs=P("dp"),
        out_specs=(P(), P(), P()), check_vma=False))(jnp.asarray(x)))
    np.testing.assert_array_equal(n1.numpy(), jn)
    np.testing.assert_allclose(k1.numpy(), jk, rtol=1e-5)
    np.testing.assert_allclose(p1.numpy(), jp, rtol=1e-4)


# ---------------------------------------------------------------------------
# Migration
# ---------------------------------------------------------------------------

def test_migrate_two_device_direction_split():
    """D = 2: the leavers are split by the edge they crossed, so each
    direction keeps its own buffer: cap right-edge crossers and cap
    left-edge crossers all migrate, with nothing lost (the counterpart of
    tests/test_slab.py::test_migrate_two_device_direction_split)."""
    n_dev, m = 2, 8
    pps, cap = m // n_dev, 256
    ncols = 2 * cap + 256
    pos = np.full((2, 4, ncols), tiled_pm.SENTINEL, np.float32)
    vel = np.zeros((2, 4, ncols), np.float32)
    pos[:, 3, :] = 0.0
    rng = np.random.default_rng(3)

    def plane(p):
        return (p + 0.5) / m  # NGP base == p exactly

    pos[0, 0, :cap] = plane(pps)
    pos[0, 0, cap:2 * cap] = plane(m - 1)
    pos[0, 0, 2 * cap:2 * cap + 100] = plane(1)
    pos[0, 1:3, :2 * cap + 100] = rng.random((2, 2 * cap + 100))
    vel[0, 0, :2 * cap + 100] = np.arange(2 * cap + 100)  # identity tags
    pos[1, 0, :50] = plane(pps + 1)
    pos[1, 1:3, :50] = rng.random((2, 50))
    n_real = 2 * cap + 100 + 50
    mesh = _cpu_mesh(n_dev)
    p2, v2, lost = slab.migrate([_t(pos[0]), _t(pos[1])],
                                [_t(vel[0]), _t(vel[1])], m, pps, cap, mesh,
                                "ngp")
    assert sum(int(x) for x in lost) == 0
    assert p2[0].shape == (4, ncols + 2 * cap)
    real = [p[0] < tiled_pm.SENTINEL_MIN for p in p2]
    assert sum(int(r.sum()) for r in real) == n_real
    for r in range(n_dev):
        px = torch.floor(p2[r][0][real[r]] * m).long() % m
        assert bool((px // pps == r).all())
        assert not p2[r][3].any() and not v2[r][:, ~real[r]].any()
    # velocity rode along with its particle: shard 1 received the tags
    assert sorted(v2[1][0][real[1]].tolist())[50:] == list(range(2 * cap))
    # one column more than a buffer holds is lost, and counted
    pos[0, 0, 2 * cap] = plane(pps)
    _, _, lost = slab.migrate([_t(pos[0]), _t(pos[1])],
                              [_t(vel[0]), _t(vel[1])], m, pps, cap, mesh,
                              "ngp")
    assert [int(x) for x in lost] == [1, 0]


@pytest.mark.parametrize("n_dev", [1, 4])
def test_migrate_counts_the_lost_and_keeps_the_rest(n_dev):
    """A particle two slabs from home is counted in ``lost`` and not sent;
    every other one lands on the shard that owns its plane; one shard has
    nothing to exchange."""
    m, cap = 16, 1024
    pps = m // n_dev
    pos, vel = _rows(2000, 8)
    px = (np.floor(pos[:, 0] * m - 0.5).astype(np.int64) % m) // pps
    # hand every particle to the shard left of its owner, 5 to the one two
    # to the left
    holder = (px - 1) % n_dev
    holder[:5] = (px[:5] - 2) % n_dev
    ps, vs = [], []
    for r in range(n_dev):
        pc, vc = tiled_pm.to_columns_host(pos[holder == r], vel[holder == r],
                                          int((holder == r).sum()))
        ps.append(_t(pc)), vs.append(_t(vc))
    mesh = _cpu_mesh(n_dev)
    p2, v2, lost = slab.migrate(ps, vs, m, pps, cap, mesh, "cic")
    if n_dev == 1:
        assert int(lost[0]) == 0 and torch.equal(p2[0], ps[0])
        return
    assert sum(int(x) for x in lost) == 5
    kept = strangers = 0
    for r in range(n_dev):
        real = p2[r][0] < tiled_pm.SENTINEL_MIN
        own = (torch.floor(p2[r][0][real] * m - 0.5).long() % m) // pps
        # the lost stay where they were, two slabs from home: the sort keys
        # them past the end and the step cuts them off
        assert bool(((own == r) | (own == (r + 2) % n_dev)).all())
        kept += int((own == r).sum())
        strangers += int((own != r).sum())
    assert (kept, strangers) == (2000 - 5, 5)


def test_migration_conserves_mass():
    """Half the particles parked on slab edges with velocities across them:
    after 4 sorted steps every particle is accounted for and the overflow
    stays 0 (tests/test_slab.py::test_migration_conserves_mass)."""
    npart, n_dev = 4096, 8
    rng = np.random.default_rng(3)
    pos = rng.random((npart, 3), dtype=np.float32)
    planes = M // n_dev
    pos[: npart // 2, 0] = (
        (rng.integers(0, n_dev, npart // 2) * planes).astype(np.float32) / M
        + 1e-4)
    vel = (0.2 * rng.standard_normal((npart, 3))).astype(np.float32)
    cfg, dyn = _config("newton", "fft", "tsc", npart)
    mesh = _cpu_mesh(n_dev)
    state = slab.distribute_particles(mesh, cfg, pos, vel)
    step = slab.make_slab_step(cfg, mesh, "leapfrog")
    counts = []
    for _ in range(4):
        out = step(*state, dyn, 2e-3)
        state = out[:6]
        assert int(out[7].overflow) == 0
        counts.append([int(t[-1]) for t in state[5]])
        assert sum(counts[-1]) == npart
    assert counts[0] != counts[-1]  # particles did change shards
    assert slab.gather_particles(state[0]).shape == (npart, 3)


# ---------------------------------------------------------------------------
# The slab step
# ---------------------------------------------------------------------------

_EXTRA = {"mond_g0": 1.2, "mond_scale_factor_exponent": 0.0,
          "unit_l": 3085.0, "unit_t": 1e10, "Om_lambda": 0.7, "Om_r": 0.0,
          "w0": -1.0, "wa": 0.0, "parametrized_mu0": 0.3}


def _param(theory, solver_name, scheme, npart):
    return {
        "theory": theory, "ncoarse": 5, "npart": npart,
        "mass_scheme": scheme, "linear_newton_solver": solver_name,
        "gradient_stencil_order": 5, "Npre": 2, "Npost": 1, "fR_n": 1,
        "fR_logfR0": 5.0, "mond_function": "simple", "mond_alpha": 1.0,
        "aexp": 0.1, "Om_m": 0.3, "epsrel": 1e-2,
        "particle_engine": "pallas",
        # the JAX package's lazy steps at float32 accuracy too (its default
        # widened gather is a bf16 pass of the TPU's matrix unit)
        "pm_precision_widened": "bf16x3", **_EXTRA,
    }


def _config(theory, solver_name, scheme, npart):
    param = _param(theory, solver_name, scheme, npart)
    return tsolver.config_from_param(param), tsolver.compute_dynamics(param)


def _matched(got, want):
    """``got``'s rows in the order of ``want``'s: each particle of ``want``
    paired with the nearest of ``got`` in the periodic box, one to one."""
    from scipy.spatial import cKDTree

    tree = cKDTree(np.mod(got[0].astype(np.float64), 1.0), boxsize=1.0)
    dist, idx = tree.query(np.mod(want[0].astype(np.float64), 1.0))
    assert len(np.unique(idx)) == len(idx) == len(got[0])
    return tuple(a[idx] for a in got), dist


def _port_slab_run(cfg, dyn, mesh, pos, vel, levels, dt, integrator):
    """A zero-sorted step and then one step per level (0: sorted), on the
    port; returns rows (position, velocity, acceleration) and the state."""
    state = slab.distribute_particles(mesh, cfg, pos, vel)
    for k in (0, *levels):
        out = slab.make_slab_step(cfg, mesh, integrator, presorted=k)(
            *state, dyn, dt)
        assert int(out[7].overflow) == 0
        state = out[:6]
    p, v = slab.gather_particles(state[0], state[1])
    _, a = slab.gather_particles(state[0], state[2])
    return (p, v, a), state


def _port_single_run(cfg, dyn, pos, vel, levels, dt, integrator):
    p, v = tiled_pm.to_columns_host(pos, vel, cfg.npart)
    p, v = _t(p), _t(v)
    phi, u = tsolver.empty_fields(cfg, "cpu")
    ts = torch.zeros(tiled_pm.n_tiles(M) + 1, dtype=torch.int32)
    state = (p, v, torch.zeros_like(p), phi, u, ts)
    for k in (0, *levels):
        out = tintegrate.step_lazy_impl(cfg, integrator, k, False, *state,
                                        dyn, dt)
        assert int(out[7].overflow) == 0
        state = out[:6]
    return tsolver.particles_to_rows(cfg, state[0], state[1], state[2])


def _jax_slab_run(param, n_dev, pos, vel, levels, dt, integrator):
    cfg = jsolver.config_from_param(param)
    dyn = jsolver.compute_dynamics(param)
    mesh = jslab.make_mesh(n_dev)
    state = jslab.distribute_particles(mesh, cfg, pos, vel)
    fns = {k: jslab.make_slab_step(cfg, mesh, integrator, presorted=k)
           for k in {0, *levels}}
    for k in (0, *levels):
        out = fns[k](*state, dyn, np.float32(dt))
        assert int(out[7].overflow) == 0
        state = out[:6]
    p, v = jslab.gather_particles(cfg, n_dev, state[0], state[1])
    _, a = jslab.gather_particles(cfg, n_dev, state[0], state[2])
    return (p, v, a), state


def _assert_rows_close(got, want, what, tol=1e-5):
    """1e-5 relative on positions (of the box), velocities and
    accelerations (of each one's maximum) between particles matched by
    position (distances in the periodic box)."""
    assert got[0].shape == want[0].shape
    got, dist = _matched(got, want)
    assert dist.max() <= 1e-5 * tol / 1e-5, f"{what}: {dist.max():.2e}"
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=what)


# theory, solver, scheme, devices, levels after the first sorted step
STEP_CASES = [
    ("newton", "fft", "cic", 1, (0, 0)),
    ("newton", "fft", "cic", 2, (0, 1, 1)),
    ("newton", "fft", "cic", 4, (0, 0, 0)),
    ("newton", "fft", "tsc", 4, (1, 2, 2)),
    ("newton", "fft", "tsc", 2, (1, 2, 0)),
    ("newton", "fft", "tsc", 1, (1, 0)),
    ("newton", "fft_7pt", "tsc", 4, (0, 1, 0)),
    ("newton", "full_fft", "cic", 4, (0, 1, 0)),
    ("parametrized", "fft", "cic", 4, (1, 0, 0)),
    ("mond", "fft_7pt", "tsc", 4, (0, 1, 0)),
]


@pytest.mark.parametrize("theory,solver_name,scheme,n_dev,levels", STEP_CASES)
def test_slab_step_matches_jax_and_single(theory, solver_name, scheme, n_dev,
                                          levels):
    """The slab step, sorted and lazy (presorted = 1, 2), against the JAX
    package's make_slab_step on the same virtual mesh size and against the
    port's own single-device lazy step with the same sort pattern: 1e-5
    relative after 3 or 4 steps that move particles across slab edges."""
    npart = M ** 3 // 4
    pos, vel = _rows(npart, 2, vscale=0.05)
    dt = 2e-3  # max |v| ~ 0.2: 0.013 cells a step... times 32 cells
    param = _param(theory, solver_name, scheme, npart)
    cfg, dyn = _config(theory, solver_name, scheme, npart)
    got, _ = _port_slab_run(cfg, dyn, _cpu_mesh(n_dev), pos, vel, levels, dt,
                            "leapfrog")
    assert got[0].shape == (npart, 3)  # no duplicate, no loss
    want = _port_single_run(cfg, dyn, pos, vel, levels, dt, "leapfrog")
    _assert_rows_close(got, want, "port slab vs port single")
    jwant, _ = _jax_slab_run(param, n_dev, pos, vel, levels, dt, "leapfrog")
    _assert_rows_close(got, jwant, "port slab vs JAX slab")


def test_slab_step_euler_and_save_pk():
    """The Euler integrator, and a step that also returns P(k): the slab
    P(k) is the single-device one of the same state (1e-5)."""
    npart = M ** 3 // 4
    pos, vel = _rows(npart, 6, vscale=0.05)
    cfg, dyn = _config("newton", "fft", "cic", npart)
    mesh = _cpu_mesh(4)
    got, state = _port_slab_run(cfg, dyn, mesh, pos, vel, (0, 1), 2e-3,
                                "euler")
    want = _port_single_run(cfg, dyn, pos, vel, (0, 1), 2e-3, "euler")
    _assert_rows_close(got, want, "euler")
    out = slab.make_slab_step(cfg, mesh, "leapfrog", save_pk=True)(
        *state, dyn, 2e-3)
    p, v = tiled_pm.to_columns_host(*slab.gather_particles(
        out[0], out[1]), npart)
    single = tsolver.pm(cfg, False, True, _t(p), _t(v),
                        *tsolver.empty_fields(cfg, "cpu"), dyn)
    for a, b in zip(out[6], single[5]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)


def test_slab_step_zblocked():
    """z-blocked tiles through the whole slab step (the tiles of a 512^3
    run), forced here by ``zbs = 8``: the same particles as without."""
    npart = M ** 3 // 4
    pos, vel = _rows(npart, 14, vscale=0.05)
    cfg, dyn = _config("newton", "fft", "tsc", npart)
    mesh = _cpu_mesh(4)
    state = slab.distribute_particles(mesh, cfg, pos, vel, zbs=8)
    assert state[5][0].shape == (tiled_pm.n_tiles(M, 8, M // 4) + 1,)
    for k in (0, 0, 1, 2):
        out = slab.make_slab_step(cfg, mesh, presorted=k, zbs=8)(
            *state, dyn, 2e-3)
        assert int(out[7].overflow) == 0
        state = out[:6]
    got = (*slab.gather_particles(state[0], state[1]),
           slab.gather_particles(state[0], state[2])[1])
    want, _ = _port_slab_run(cfg, dyn, mesh, pos, vel, (0, 1, 2), 2e-3,
                             "leapfrog")
    _assert_rows_close(got, want, "z-blocked")


def test_slab_state_crosses_between_the_packages():
    """A state handed over mid-run in either direction: two steps in one
    package, the third in the other, against three in the JAX package."""
    npart, n_dev, dt = M ** 3 // 4, 4, 2e-3
    pos, vel = _rows(npart, 9, vscale=0.05)
    param = _param("newton", "fft", "tsc", npart)
    cfg, dyn = _config("newton", "fft", "tsc", npart)
    jcfg = jsolver.config_from_param(param)
    jdyn = jsolver.compute_dynamics(param)
    mesh, jmesh = _cpu_mesh(n_dev), jslab.make_mesh(n_dev)
    want, _ = _jax_slab_run(param, n_dev, pos, vel, (0, 1), dt, "leapfrog")
    # JAX -> port, before a lazy step (the tile starts must cross too)
    _, jstate = _jax_slab_run(param, n_dev, pos, vel, (0,), dt, "leapfrog")
    state = slab.slab_state_from_numpy(mesh, *(np.array(a) for a in jstate))
    assert state[0][0].device.type == "cpu" and len(state[5]) == n_dev
    out = slab.make_slab_step(cfg, mesh, "leapfrog", presorted=1)(
        *state, dyn, dt)
    assert int(out[7].overflow) == 0
    p, v = slab.gather_particles(out[0], out[1])
    _, a = slab.gather_particles(out[0], out[2])
    _assert_rows_close((p, v, a), want, "JAX -> port")
    # port -> JAX
    _, tstate = _port_slab_run(cfg, dyn, mesh, pos, vel, (0,), dt, "leapfrog")
    arrays = slab.slab_state_to_numpy(*tstate)
    for a, b in zip(arrays, jstate):
        assert a.shape == b.shape and a.dtype == b.dtype
    shard = [jax.sharding.NamedSharding(jmesh, P(None, "dp"))] * 3 + [
        jax.sharding.NamedSharding(jmesh, P("dp"))] * 3
    jstate2 = [jax.device_put(jnp.asarray(a), s)
               for a, s in zip(arrays, shard)]
    jout = jslab.make_slab_step(jcfg, jmesh, "leapfrog", presorted=1)(
        *jstate2, jdyn, np.float32(dt))
    assert int(jout[7].overflow) == 0
    p, v = jslab.gather_particles(jcfg, n_dev, jout[0], jout[1])
    _, a = jslab.gather_particles(jcfg, n_dev, jout[0], jout[2])
    _assert_rows_close((p, v, a), want, "port -> JAX")


def test_slab_step_counts_drift_violations_and_capacity():
    """A lazy step whose particles moved past the window counts them into
    ``overflow``; so does a shard that receives more than it can hold."""
    npart = M ** 3 // 4
    pos, vel = _rows(npart, 12, vscale=0.05)
    cfg, dyn = _config("newton", "fft", "cic", npart)
    mesh = _cpu_mesh(4)
    state = slab.distribute_particles(mesh, cfg, pos, vel)
    state = slab.make_slab_step(cfg, mesh)(*state, dyn, 0.0)[:6]
    out = slab.make_slab_step(cfg, mesh, presorted=1)(*state, dyn, 0.5)
    assert int(out[7].overflow) > 0
    # every particle into the first slab: the shard's capacity overflows
    pos2 = pos.copy()
    state = slab.distribute_particles(mesh, cfg, pos2, vel, slack=1.01)
    squeezed = [p.clone() for p in state[0]]
    for p in squeezed:
        real = p[0] < tiled_pm.SENTINEL_MIN
        p[0] = torch.where(real, 0.25 * p[0] + 0.01, p[0])
    with pytest.raises(ValueError, match="slack"):
        slab.distribute_particles(mesh, cfg, np.column_stack(
            (0.2 * pos[:, 0], pos[:, 1:])), vel)
    out = slab.make_slab_step(cfg, mesh)(squeezed, *state[1:], dyn, 0.0)
    assert int(out[7].overflow) > 0


@pytest.mark.parametrize("theory,solver_name", [("newton", "multigrid"),
                                                ("fr", "multigrid"),
                                                ("fr", "fft"),
                                                ("mond", "multigrid")])
def test_slab_step_refuses_the_next_slice(theory, solver_name):
    """The solvers and theories that once waited for the slab multigrid
    build a slab step now (tests/test_torch_slab_mg.py runs them); what the
    slab step still refuses is an engine other than the tiled one."""
    cfg, _ = _config(theory, solver_name, "tsc", 4096)
    assert callable(slab.make_slab_step(cfg, _cpu_mesh(4), first_call=True))
    scatter = dataclasses.replace(cfg, particle_engine="scatter")
    with pytest.raises(NotImplementedError, match="runs only 'pallas'"):
        slab.make_slab_step(scatter, _cpu_mesh(4))


def test_slab_step_refuses_thin_slabs_and_odd_meshes():
    cfg, _ = _config("newton", "fft", "tsc", 4096)
    with pytest.raises(ValueError, match="divisible"):
        slab.make_slab_step(cfg, _cpu_mesh(3))
    with pytest.raises(ValueError, match="slabs at least"):
        slab.make_slab_step(cfg, _cpu_mesh(16), presorted=1)
    slab.make_slab_step(cfg, _cpu_mesh(16))  # 2 planes hold w - 1
    assert slab.shard_capacity(4096, 4) == jslab.shard_capacity(4096, 4)
    assert slab.migration_capacity(4096, 32, 4) == jslab.migration_capacity(
        4096, 32, 4)
    state = slab.distribute_particles(_cpu_mesh(4), cfg,
                                      *_rows(4096, 1))
    grown = slab.grow_capacity(2048, *state[:3])
    assert all(a.shape == (4, 2048) for arrays in grown for a in arrays)
    assert bool((grown[0][0][0, 1536:] == tiled_pm.SENTINEL).all())
    assert not grown[0][0][3].any() and not grown[1][0][:, 1536:].any()

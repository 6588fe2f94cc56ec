"""The port's CUDA kernels on a card: each against its plain PyTorch twin,
bitwise-reproducible deposits, residual norms and P(k), and
bitwise-reproducible runs (FFT and multigrid).

Every test here carries the ``cuda`` marker and skips where torch sees no
CUDA device (the kernels have no CPU mode). The file imports no JAX, so it
also runs on a machine without it; tests/conftest.py imports JAX, so there
run it without the conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import pysco_tpu_torch
from pysco_tpu_torch.cosmo import write_power_spectrum_table
from pysco_tpu_torch.models import laplacian
from pysco_tpu_torch.ops import fourier, stencil, tiled_pm
from pysco_tpu_torch.ops.mesh import periodic_wrap
from pysco_tpu_torch.utils import io as iostream

from exact_root_states import (exact_states, quartic_off_cells,
                               quartic_states)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _state(m, n, scheme, drift, seed, device, zbs=None, xspan=1.0,
           clustered=True):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3), dtype=np.float32)
    if clustered:
        pos[: n // 2] = 0.2 + 0.25 * pos[: n // 2]
    pos[:, 0] *= np.float32(xspan)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    pc, vc = tiled_pm.to_columns_host(pos, vel, n)
    ps, _, ts = tiled_pm.sort_particles(torch.as_tensor(pc, device=device),
                                        torch.as_tensor(vc, device=device),
                                        m, scheme, zbs)
    if drift:
        delta = torch.as_tensor(((drift - 0.05) / m * rng.uniform(
            -1, 1, (3, ps.shape[1]))).astype(np.float32), device=device)
        real = ps[0] < tiled_pm.SENTINEL_MIN
        ps = ps.clone()
        ps[:3] = torch.where(real, periodic_wrap(ps[:3] + delta), ps[:3])
    return ps, ts


def _edge_state(ps, ts, m, scheme, drift, zbs, seed, plane0=0,
                n_planes=None):
    """Every real column moved so that its base cell sits on an edge of its
    stale tile's window: x at -drift, 0 or +drift planes, y at -drift, the
    live window's last row (7 + drift) or the envelope's (wy_pad - w -
    drift), z likewise when z-blocked. Cells past the live window go
    through the kernel's spill path. ``plane0`` and ``n_planes``: the
    tiles are a slab's."""
    g = tiled_pm._geometry(m, scheme, drift, zbs, n_planes)
    rng = np.random.default_rng(seed)
    n_up = ps.shape[1]
    tile = tiled_pm._tile_of_columns(ts, n_up).cpu().numpy().astype(np.int64)
    real = (ps[0].cpu().numpy() < tiled_pm.SENTINEL_MIN) & (tile < g.ntiles)
    plane = tile // (g.nby * g.nbz) + plane0
    yb = (tile // g.nbz) % g.nby
    sx = rng.choice([-drift, 0, drift], n_up)
    sy = rng.choice([-drift, 7 + drift, g.wy_pad - g.w - drift], n_up)
    if g.nbz > 1:
        sz = rng.choice([-drift, g.zbs - 1 + drift, g.wz_pad - g.w - drift],
                        n_up)
        bz = (tile % g.nbz) * g.zbs + sz
    else:
        bz = rng.integers(0, m, n_up)
    off = 1.5 if scheme == "tsc" else 0.75  # the base cell is the target
    out = ps.cpu().numpy().copy()
    for axis, base in ((0, plane + sx), (1, yb * 8 + sy), (2, bz)):
        xs = (((base + off) % m) / m).astype(np.float32)
        out[axis] = np.where(real, xs, out[axis])
    return torch.as_tensor(out, device=ps.device)


def _clumped_state(m, scheme, drift, seed, device, zbs=None, n=12_000,
                   tiles=4):
    """``n`` particles in ``tiles`` tiles (several 512-particle chunks
    each), every tile's particles on two (y, z) base cells of it, at
    offsets in the cell whose weights are multiples of 1/8 (float32 sums
    of their products are exact in any order); tile-sorted, then each
    tile's particles moved together by one shift per axis of under
    ``drift`` cells that keeps them on one base cell each."""
    g = tiled_pm._geometry(m, scheme, 0, zbs)
    rng = np.random.default_rng(seed)
    tile = rng.choice(g.ntiles, tiles, replace=False)[rng.integers(0, tiles,
                                                                 n)]
    plane = tile // (g.nby * g.nbz)
    cell_y = rng.integers(0, 8, (g.ntiles, 2))
    cell_z = rng.integers(0, g.zbs, (g.ntiles, 2))
    pick = rng.integers(0, 2, n)
    by = (tile // g.nbz) % g.nby * 8 + cell_y[tile, pick]
    bz = tile % g.nbz * g.zbs + cell_z[tile, pick]
    off = {"ngp": 0.0, "cic": 0.5, "tsc": 1.0}[scheme]
    fracs = [0.5] if scheme == "tsc" else [0.25, 0.75]
    step = 0.5 if scheme == "tsc" else 0.125
    shift = np.zeros((g.ntiles, 3))
    if drift:
        k = rng.integers(0, drift, (g.ntiles, 3)) + step
        shift = k * rng.choice([-1.0, 1.0], (g.ntiles, 3))
    pos = np.stack([(b + off + rng.choice(fracs, n)) % m / m
                    for b in (plane, by, bz)], 1).astype(np.float32)
    pc, vc = tiled_pm.to_columns_host(pos, np.zeros_like(pos), n)
    ps, _, ts = tiled_pm.sort_particles(torch.as_tensor(pc, device=device),
                                        torch.as_tensor(vc, device=device),
                                        m, scheme, zbs)
    if drift:
        cols = tiled_pm._tile_of_columns(ts, ps.shape[1]).cpu().numpy()
        real = cols < g.ntiles
        moved = ps.cpu().numpy().copy()
        for a in range(3):
            delta = shift[np.minimum(cols, g.ntiles - 1), a] / m
            moved[a] = np.where(real, (moved[a] + delta) % 1.0, moved[a])
        ps = torch.as_tensor(moved.astype(np.float32), device=device)
    return ps, ts


def _case(case, m, scheme, drift, cuda, zbs=None):
    """(position_sorted, tile_starts) of a deposit test case: "clustered"
    (half the particles in a quarter of the box, drifted within the bound),
    "dense" (150 000 on 32^3, drifted: tiles of several 512-particle
    chunks, yet few enough a cell that the twin's float32 sums stay within
    1e-6 of the largest), "clumped" (_clumped_state: one x-line or column
    carries a whole chunk) or "edge" (_edge_state). All have a sentinel
    tail; "clustered" and "edge" leave the last quarter of the x-planes
    empty."""
    n = 150_000 if case == "dense" else 3000
    xspan = 1.0 if case == "dense" else 0.75
    if case == "clumped":
        ps, ts = _clumped_state(m, scheme, drift, 3, cuda, zbs)
        n = 12_000
    elif case == "edge":
        ps, ts = _state(m, n, scheme, 0, 1, cuda, zbs, xspan)
        ps = _edge_state(ps, ts, m, scheme, drift, zbs, 2)
    else:
        ps, ts = _state(m, n, scheme, drift, 1, cuda, zbs, xspan,
                        clustered=case == "clustered")
    assert int(tiled_pm.drift_violations(ps, ts, m, scheme, drift, zbs)) == 0
    assert ps.shape[1] > n  # sentinel tail columns
    return m, ps, ts


@pytest.mark.parametrize("case", ["clustered", "dense", "edge", "clumped"])
@pytest.mark.parametrize("scheme", ["ngp", "cic", "tsc"])
@pytest.mark.parametrize("drift", [0, 1, 2, 3])
def test_kernels_match_twins(cuda, scheme, drift, case):
    m, ps, ts = _case(case, 32, scheme, drift, cuda)
    if case in ("dense", "clumped"):
        assert int((ts[1:] - ts[:-1]).max()) > 2 * 512  # several chunks
    else:
        assert bool((ts[1:] == ts[:-1]).any())  # empty tiles
    before = dict(tiled_pm.LAUNCHES)
    grid = tiled_pm.deposit(ps, ts, m, scheme, drift)
    twin = tiled_pm.deposit_plain(ps, ts, m, scheme, drift)
    assert tiled_pm.LAUNCHES["deposit"] == before["deposit"] + 1
    # fixed order on both sides: bitwise reruns; the twin sums in another
    # order (atomics): float32 ulps of the largest cell sum
    assert torch.equal(grid, tiled_pm.deposit(ps, ts, m, scheme, drift))
    torch.testing.assert_close(grid, twin, rtol=0,
                               atol=1e-6 * float(twin.max()))
    if case == "clumped":  # every particle's mass, within the window
        assert float(grid.double().sum()) == 12_000
    field = torch.rand((3, m, m, m), device=cuda)
    got = tiled_pm.gather_vec_cl(field, ps, ts, scheme, drift)
    assert tiled_pm.LAUNCHES["gather"] == before["gather"] + 1
    # the same products and sums in the same order (--fmad=false), from the
    # staged window or, past it, from the field: bitwise the twin
    assert torch.equal(
        got, tiled_pm.gather_vec_cl_plain(field, ps, ts, scheme, drift))


@pytest.mark.parametrize("m,zbs,scheme,drift,case", [
    (32, 8, "cic", 0, "clustered"), (32, 8, "tsc", 2, "clustered"),
    (32, 8, "ngp", 1, "edge"), (32, 8, "cic", 3, "edge"),
    (32, 8, "tsc", 0, "edge"), (512, None, "cic", 1, "clustered"),
    (512, None, "tsc", 3, "edge"), (32, 8, "ngp", 0, "clumped"),
    (32, 8, "cic", 1, "clumped"), (32, 8, "tsc", 2, "clumped"),
    (32, 8, "cic", 3, "clumped"), (512, None, "cic", 2, "clumped"),
    (512, None, "tsc", 3, "clumped")])
def test_zblocked_kernel_matches_twin(cuda, m, zbs, scheme, drift, case):
    _, ps, ts = _case(case, m, scheme, drift, cuda, zbs)
    assert tiled_pm._geometry(m, scheme, drift, zbs).nbz > 1
    grid = tiled_pm.deposit(ps, ts, m, scheme, drift, zbs)
    twin = tiled_pm.deposit_plain(ps, ts, m, scheme, drift, zbs)
    assert torch.equal(grid, tiled_pm.deposit(ps, ts, m, scheme, drift, zbs))
    torch.testing.assert_close(grid, twin, rtol=0,
                               atol=1e-6 * float(twin.max()))
    if case == "clumped":
        assert int((ts[1:] - ts[:-1]).max()) > 2 * 512
        assert float(grid.double().sum()) == 12_000
    field = torch.rand((3, m, m, m), device=cuda)
    got = tiled_pm.gather_vec_cl(field, ps, ts, scheme, drift, zbs)
    assert torch.equal(
        got, tiled_pm.gather_vec_cl_plain(field, ps, ts, scheme, drift))


@pytest.mark.parametrize("scheme,drift,case", [
    ("cic", 0, "clumped"), ("cic", 1, "clumped"), ("ngp", 1, "clustered"),
    ("tsc", 0, "edge")])
def test_long_z_line_kernel_matches_twin(cuda, scheme, drift, case):
    """Tiles spanning a z line longer than a block's 256 threads (512^3
    with 512-cell z-blocks: nbz = 1): a thread takes two z columns, and
    the bins of a heavy column wrap round the line."""
    m, zbs = 512, 512
    _, ps, ts = _case(case, m, scheme, drift, cuda, zbs)
    g = tiled_pm._geometry(m, scheme, drift, zbs)
    assert g.nbz == 1 and g.live_window[2] > 256
    grid = tiled_pm.deposit(ps, ts, m, scheme, drift, zbs)
    twin = tiled_pm.deposit_plain(ps, ts, m, scheme, drift, zbs)
    assert torch.equal(grid, tiled_pm.deposit(ps, ts, m, scheme, drift, zbs))
    torch.testing.assert_close(grid, twin, rtol=0,
                               atol=1e-6 * float(twin.max()))
    if case == "clumped":
        assert float(grid.double().sum()) == 12_000


def _slab_case(case, m, scheme, drift, cuda, zbs, plane0, n_planes, seed=1):
    """(position_sorted, tile_starts) of the slab [plane0, plane0 +
    n_planes): every particle of a clustered box sorted into the slab's
    tiles (the strangers past the end, as after a migration), then drifted
    within the bound ("clustered") or moved onto the edges of its window
    ("edge") without a re-sort."""
    rng = np.random.default_rng(seed)
    n = 6000
    pos = rng.random((n, 3), dtype=np.float32)
    pos[: n // 2] = 0.2 + 0.25 * pos[: n // 2]
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    pc, vc = tiled_pm.to_columns_host(pos, vel, n)
    ps, _, ts = tiled_pm.sort_particles(
        torch.as_tensor(pc, device=cuda), torch.as_tensor(vc, device=cuda),
        m, scheme, zbs, plane0, n_planes)
    assert 0 < int(ts[-1]) < n  # a slab's share, strangers past the end
    if case == "edge":
        ps = _edge_state(ps, ts, m, scheme, drift, zbs, seed + 1, plane0,
                         n_planes)
    elif drift:
        delta = torch.as_tensor(((drift - 0.05) / m * rng.uniform(
            -1, 1, (3, ps.shape[1]))).astype(np.float32), device=cuda)
        real = ps[0] < tiled_pm.SENTINEL_MIN
        ps = ps.clone()
        ps[:3] = torch.where(real, periodic_wrap(ps[:3] + delta), ps[:3])
    assert int(tiled_pm.drift_violations(ps, ts, m, scheme, drift, zbs,
                                         plane0, n_planes)) == 0
    return ps, ts


def _thin(scheme, drift):
    """The thinnest slab the step allows: w - 1 + drift planes."""
    return max(tiled_pm._WIDTH[scheme] - 1 + drift, 1)


@pytest.mark.parametrize("case", ["clustered", "edge"])
@pytest.mark.parametrize("scheme", ["ngp", "cic", "tsc"])
@pytest.mark.parametrize("drift", [0, 1, 2])
@pytest.mark.parametrize("zbs,shape", [(None, "quarter"), (8, "quarter"),
                                       (None, "thin"), (8, "thin")])
def test_slab_kernels_match_twins(cuda, zbs, shape, drift, scheme, case):
    """The slab call forms at plane0 != 0: the deposit within float32 ulps
    of its twin and bitwise equal between two calls, the gather bitwise its
    twin; a quarter of the grid and the thinnest slab allowed (thinner than
    the window: the deposit's residue classes hold one plane or none),
    z-blocked and not."""
    m = 32
    n_planes = m // 4 if shape == "quarter" else _thin(scheme, drift)
    plane0 = 8
    ps, ts = _slab_case(case, m, scheme, drift, cuda, zbs, plane0, n_planes)
    before = dict(tiled_pm.LAUNCHES)
    args = (ps, ts, m, scheme, drift, zbs, plane0, n_planes)
    gp = tiled_pm.deposit_slab(*args)
    twin = tiled_pm.deposit_slab_plain(*args)
    w = tiled_pm._WIDTH[scheme]
    assert gp.shape == (n_planes + w - 1 + 2 * drift, m, m)
    assert torch.equal(gp, tiled_pm.deposit_slab(*args))
    torch.testing.assert_close(gp, twin, rtol=0,
                               atol=1e-6 * float(twin.max()))
    if case != "edge":  # a window's edge may lie past the periodic wrap
        assert float(gp.double().sum()) == pytest.approx(int(ts[-1]),
                                                         rel=1e-6)
    field = torch.randn((3, gp.shape[0], m, m), device=cuda)
    got = tiled_pm.gather_vec_slab(field, ps, ts, scheme, drift, zbs, plane0)
    assert torch.equal(got, tiled_pm.gather_vec_slab_plain(
        field, ps, ts, scheme, drift, plane0))
    assert not got[3].any() and not got[:, int(ts[-1]):].any()
    after = tiled_pm.LAUNCHES
    assert after["deposit_slab"] == before["deposit_slab"] + 2
    assert after["gather_slab"] == before["gather_slab"] + 1
    assert (after["deposit"], after["gather"]) == (before["deposit"],
                                                   before["gather"])


@pytest.mark.parametrize("ncomp", [1, 2, 4])
def test_slab_gather_components_and_stagings(cuda, ncomp):
    ps, ts = _slab_case("clustered", 32, "tsc", 2, cuda, 8, 16, 8)
    field = torch.randn((ncomp, 8 + 2 + 4, 32, 32), device=cuda)
    twin = tiled_pm.gather_vec_slab_plain(field, ps, ts, "tsc", 2, 16)
    g = tiled_pm._geometry(32, "tsc", 2, 8, 8)
    for ncs in sorted({1, ncomp}):
        assert torch.equal(tiled_pm._gather_cuda(field, ps, ts, 2, g, ncs, 16,
                                                 True), twin)


@pytest.mark.parametrize("zbs,scheme,drift", [(None, "cic", 0),
                                              (None, "tsc", 1), (8, "cic", 2)])
def test_slab_gather_beyond_drift_bound_matches_twin(cuda, zbs, scheme,
                                                     drift):
    """Particles past their drift bound: a support cell outside the staged
    window is read from the extended field, and counts 0 where that ends;
    bitwise the twin."""
    m, plane0, n_planes = 32, 8, 8
    ps, ts = _slab_case("clustered", m, scheme, 0, cuda, zbs, plane0,
                        n_planes)
    rng = np.random.default_rng(9)
    delta = torch.as_tensor(((drift + 2.5) / m * rng.uniform(
        -1, 1, (3, ps.shape[1]))).astype(np.float32), device=cuda)
    real = ps[0] < tiled_pm.SENTINEL_MIN
    ps[:3] = torch.where(real, periodic_wrap(ps[:3] + delta), ps[:3])
    assert int(tiled_pm.drift_violations(ps, ts, m, scheme, drift, zbs,
                                         plane0, n_planes)) > 0
    w = tiled_pm._WIDTH[scheme]
    field = torch.randn((3, n_planes + w - 1 + 2 * drift, m, m), device=cuda)
    assert torch.equal(
        tiled_pm.gather_vec_slab(field, ps, ts, scheme, drift, zbs, plane0),
        tiled_pm.gather_vec_slab_plain(field, ps, ts, scheme, drift, plane0))


@pytest.mark.parametrize("scheme,drift,n_dev", [("cic", 0, 4), ("tsc", 2, 4),
                                               ("cic", 1, 2), ("tsc", 0, 8)])
def test_slab_deposits_and_spill_make_the_single_deposit(cuda, scheme, drift,
                                                         n_dev):
    """D slab deposits on one card and add_spill against the single-device
    deposit of the same particles (float32 rounding: the spill planes are
    added in another order), and the slab gather of the halo-extended field
    against the single gather, particle by particle."""
    from pysco_tpu_torch.parallel import slab

    m = 32
    planes = m // n_dev
    mesh = (cuda,) * n_dev
    gps, cols = [], []
    for r in range(n_dev):
        ps, ts = _slab_case("clustered", m, scheme, drift, cuda, None,
                            r * planes, planes, seed=3)
        gps.append(tiled_pm.deposit_slab(ps, ts, m, scheme, drift, None,
                                         r * planes, planes))
        cols.append((ps, ts))
    got = torch.cat(slab.add_spill(gps, planes, mesh, lead=drift))
    # the same drifted particles, each from the shard that owns it
    real = torch.cat([ps[:, :int(ts[-1])] for ps, ts in cols], dim=1)
    n = real.shape[1]
    pc = torch.full((4, tiled_pm.padded_cols(n)), tiled_pm.SENTINEL,
                    device=cuda)
    pc[3] = 0.0
    pc[:, :n] = real
    ps1, _, ts1 = tiled_pm.sort_particles(pc, torch.zeros_like(pc), m, scheme)
    want = tiled_pm.deposit(ps1, ts1, m, scheme)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-6 * float(want.max()))
    field = torch.randn((3, m, m, m), device=cuda)
    w = tiled_pm._WIDTH[scheme]
    ext = slab.halo_lr(list(torch.chunk(field, n_dev, dim=1)), drift,
                       w - 1 + drift, mesh, axis=1)
    for r, (ps, ts) in enumerate(cols):
        acc = tiled_pm.gather_vec_slab(ext[r].contiguous(), ps, ts, scheme,
                                       drift, None, r * planes)
        one = tiled_pm.gather_vec_cl_plain(
            field, ps, torch.tensor([0, int(ts[-1])], device=cuda), scheme)
        assert torch.equal(acc, one)


@pytest.mark.parametrize("ncomp", [1, 2, 3, 4])
@pytest.mark.parametrize("m,zbs,scheme,drift", [
    (32, None, "cic", 0), (32, None, "tsc", 3), (32, 8, "ngp", 2),
    (32, 8, "tsc", 1)])
def test_gather_components_match_twin(cuda, ncomp, m, zbs, scheme, drift):
    """1 to 4 components, each staging the kernel takes (all components of
    the window at once, one a pass), bitwise the twin; rows C..3 and the
    sentinel tail zero."""
    _, ps, ts = _case("clustered", m, scheme, drift, cuda, zbs)
    field = torch.randn((ncomp, m, m, m), device=cuda)
    twin = tiled_pm.gather_vec_cl_plain(field, ps, ts, scheme, drift)
    got = tiled_pm.gather_vec_cl(field, ps, ts, scheme, drift, zbs)
    assert torch.equal(got, twin)
    g = tiled_pm._geometry(m, scheme, drift, zbs)
    for ncs in sorted({1, ncomp}):
        assert torch.equal(tiled_pm._gather_cuda(field, ps, ts, drift, g,
                                                 ncs), twin)
    assert not got[ncomp:].any() and not got[:, int(ts[-1]):].any()


@pytest.mark.parametrize("m,zbs,scheme,drift", [
    (32, None, "cic", 0), (32, None, "tsc", 1), (32, 8, "cic", 1),
    (32, 8, "tsc", 2)])
def test_gather_beyond_drift_bound_matches_twin(cuda, m, zbs, scheme, drift):
    """Particles that moved past their drift bound: their support leaves
    the staged window and the kernel reads it from the field, still
    bitwise the twin."""
    ps, ts = _state(m, 3000, scheme, drift + 2, 5, cuda, zbs)
    assert int(tiled_pm.drift_violations(ps, ts, m, scheme, drift, zbs)) > 0
    field = torch.randn((3, m, m, m), device=cuda)
    assert torch.equal(
        tiled_pm.gather_vec_cl(field, ps, ts, scheme, drift, zbs),
        tiled_pm.gather_vec_cl_plain(field, ps, ts, scheme, drift))


def test_gather_smem_matches_kernel(cuda):
    """The wrapper's reckoning of the gather's shared memory is the
    kernel's own."""
    lib = tiled_pm._kernels()
    for m, scheme, drift, zbs in ((32, "cic", 0, None), (32, "tsc", 3, 8),
                                  (256, "cic", 0, None), (256, "tsc", 3, None),
                                  (512, "cic", 1, None), (504, "tsc", 3, None)):
        g = tiled_pm._geometry(m, scheme, drift, zbs)
        for ncs in (1, 2, 3, 4):
            assert lib.pysco_gather_smem(m, g.w, drift, g.zbs, g.nbz,
                                         ncs) == tiled_pm._gather_smem(g, ncs)


def test_deposit_smem_matches_kernel(cuda):
    """The wrapper's shared-memory reckoning is the kernel's own: the sort
    scratch or the arrays after it (bin starts, the lines' visit prefix,
    the threads' partials), the live window, the staged weights."""
    lib = tiled_pm._kernels()
    for m, scheme, drift, zbs in ((32, "cic", 0, None), (32, "tsc", 3, 8),
                                  (256, "tsc", 3, None), (512, "cic", 1, None),
                                  (504, "tsc", 3, None), (512, "tsc", 3, None),
                                  (512, "ngp", 0, None), (256, "cic", 2, 16),
                                  (2040, "ngp", 0, None)):
        g = tiled_pm._geometry(m, scheme, drift, zbs)
        assert lib.pysco_deposit_smem(m, g.w, drift, g.wy_pad, g.wz, g.zbs,
                                      g.nbz) == tiled_pm._deposit_smem(g)


def test_wrappers_check_inputs(cuda):
    ps, ts = _state(16, 600, "cic", 0, 3, cuda)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        tiled_pm.deposit(ps.double(), ts, 16, "cic")
    with pytest.raises(ValueError, match="expected shape"):
        tiled_pm.deposit(ps, ts[:-1], 16, "cic")
    with pytest.raises(ValueError, match="contiguous CUDA"):
        tiled_pm.gather_vec_cl(torch.zeros((3, 16, 16, 16), device=cuda).mT,
                               ps, ts, "cic")
    field = torch.zeros((3, 16, 16, 16), device=cuda)
    with pytest.raises(ValueError, match="expected shape"):
        tiled_pm.gather_vec_cl(field, ps, ts, "cic", zbs=8)
    shifted = torch.zeros(3 * 16 ** 3 + 1, device=cuda)[1:].view(3, 16, 16, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tiled_pm.gather_vec_cl(shifted, ps, ts, "cic")


@pytest.mark.parametrize("mode,devices", [("single", None), ("slab", 4),
                                          ("replicated", 2)])
def test_run_reproducible_and_golden(cuda, tmp_path, mode, devices):
    """The golden configuration twice on the card, on the card alone and
    in the multi-device modes on a mesh that repeats it: the trajectories
    are bitwise equal, and P(k) meets tests/golden_pk_32.json."""
    pk_file = tmp_path / "pk.dat"
    write_power_spectrum_table(str(pk_file))
    mesh = ["cuda:0"] * devices if devices else None
    param = {
        "parallel_mode": mode,
        "theory": "newton", "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
        "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 100,
        "ncoarse": 5, "npart": 16 ** 3, "z_start": 49, "seed": 42,
        "position_ICS": "center", "fixed_ICS": True, "paired_ICS": False,
        "dealiased_ICS": False, "power_spectrum_file": str(pk_file),
        "initial_conditions": "2LPT", "output_snapshot_format": "npz",
        "z_out": "[5, 1, 0]", "save_power_spectrum": "z_out",
        "integrator": "leapfrog", "mass_scheme": "TSC", "Courant_factor": 1.0,
        "max_aexp_stepping": 10, "linear_newton_solver": "fft",
        "gradient_stencil_order": 5, "verbose": 0,
        "pm_precision_widened": "bf16x3",
    }
    snaps = []
    for tag in ("a", "b"):
        base = tmp_path / tag
        tiled_pm.reset_launches()
        recs = pysco_tpu_torch.run(dict(param, base=str(base)), device="cuda",
                                   devices=mesh)
        # every force evaluation (the steps and the initial one) went
        # through the mode's kernel forms, once per shard
        evals, n = len(recs) + 1, devices or 1
        form = ("deposit_slab", "gather_slab") if mode == "slab" else (
            "deposit", "gather")
        assert tiled_pm.LAUNCHES == {
            k: evals * n if k in form else 0 for k in tiled_pm.LAUNCHES}
        snaps.append(iostream.read_snapshot_particles_npz(
            glob.glob(f"{base}/output_00003/particles_*.npz")[0]))
    for x, y in zip(*snaps):
        np.testing.assert_array_equal(x, y)
    golden_path = os.path.join(os.path.dirname(__file__), "golden_pk_32.json")
    with open(golden_path) as f:
        golden = {k: np.array(v) for k, v in json.load(f).items()}
    for name, ref in golden.items():
        got = np.loadtxt(tmp_path / "a" / "power" / name)
        sel = ref[:, 2] >= 8
        rel = np.abs(got[sel, 1] - ref[sel, 1]) / ref[sel, 1]
        assert rel.max() < 1e-4, (name, rel.max())


# ---------------------------------------------------------------------------
# Multigrid stencil kernels
# ---------------------------------------------------------------------------

KINDS = [("linear", None), ("laplacian", None), ("reformulated", None),
         ("cubic", -0.27), ("quartic", -0.27)]


def _grids(n, seed, device):
    rng = np.random.default_rng(seed)
    x, b, rhs = (torch.as_tensor(rng.standard_normal((n, n, n)).astype(
        np.float32) * s, device=device) for s in (1.0, 5.0, 0.3))
    return x, b, rhs


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("n", [4, 16, 32])
def test_half_sweep_matches_twin(cuda, n):
    x, b, rhs = _grids(n, 1, cuda)
    red, black = laplacian.pack_rb(x)
    h2b = laplacian.pack_rb(b * float(np.float32(1 / (n * n))))
    rhs_p = laplacian.pack_rb(rhs)
    for to_red, c in ((True, 0), (False, 1)):
        src, dst = (black, red) if to_red else (red, black)
        for r in (None, rhs_p[c]):
            before = stencil.LAUNCHES["half_sweep"]
            got = stencil.half_sweep(src, dst, h2b[c], to_red, 1.25, r)
            assert stencil.LAUNCHES["half_sweep"] == before + 1
            want = stencil.half_sweep_plain(src, dst, h2b[c], to_red, 1.25,
                                            r)
            # the same operations in the same order (--fmad=false)
            assert _rel(got, want) <= 2e-6


@pytest.mark.parametrize("kind,q", KINDS)
def test_residual_kernels_match_twins(cuda, kind, q):
    for n in (4, 16, 32):
        x, b, rhs = _grids(n, 2, cuda)
        b = None if kind == "laplacian" else b
        for r in (None, rhs):
            got = stencil.residual_norm2(kind, x, b, r, q)
            want = stencil.residual_norm2_plain(kind, x, b, r, q)
            assert abs(float(got) - float(want)) <= 5e-6 * float(want)
            # fixed-order sum: two calls are bitwise equal
            assert torch.equal(got, stencil.residual_norm2(kind, x, b, r, q))
            outs = stencil.restrict3(kind, x, b, r, q)
            twins = stencil.restrict3_plain(kind, x, b, r, q)
            assert len(outs) == len(twins)
            for o, t in zip(outs, twins):
                assert _rel(o, t) <= 2e-6
            (only,) = stencil.restrict3(kind, x, b, r, q, residual_only=True)
            assert torch.equal(only, outs[0])


@pytest.mark.parametrize("kind,q", KINDS)
@pytest.mark.parametrize("n", [4, 6, 8, 24, 36, 128, 256])
def test_residual_norm2_matches_twin(cuda, n, kind, q):
    """The plane march (n a multiple of 4 from 32 up; ragged tiles at 36)
    and the per-cell kernel (the coarse levels, n = 6), with and without
    a rhs: within 5e-6 of the twin (float32 squares added in double
    against torch's float32 tree), two calls bitwise equal."""
    x, b, rhs = _grids(n, 7, cuda)
    b = None if kind == "laplacian" else b
    for r in (None, rhs):
        before = stencil.LAUNCHES["residual_norm2"]
        got = stencil.residual_norm2(kind, x, b, r, q)
        assert stencil.LAUNCHES["residual_norm2"] == before + 1
        want = stencil.residual_norm2_plain(kind, x, b, r, q)
        assert got.shape == () and got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 5e-6 * float(want)
        assert torch.equal(got, stencil.residual_norm2(kind, x, b, r, q))


def test_residual_norm2_misaligned_matches_march(cuda):
    """An x that is not 16-byte aligned takes the per-cell kernel over the
    march's number of blocks: the same sum to a rounding of the double
    partials' order."""
    n = 32
    x, b, _ = _grids(n, 8, cuda)
    flat = torch.empty(n ** 3 + 1, device=cuda)
    flat[1:] = x.reshape(-1)
    x_off = flat[1:].view(n, n, n)
    assert x_off.data_ptr() % 16 == 4 and x_off.is_contiguous()
    got = stencil.residual_norm2("linear", x_off, b)
    want = stencil.residual_norm2("linear", x, b)
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
    assert torch.equal(got, stencil.residual_norm2("linear", x_off, b))


def test_residual_norm2_scratch_matches_kernel(cuda, monkeypatch):
    """The wrapper allocates as many double partials as the library says
    the kernel writes for that n, whatever the kind."""
    lib = stencil._kernels()
    assert lib.pysco_norm2_blocks(4) == 1
    assert lib.pysco_norm2_blocks(24) == 54  # one thread a cell, 256 a block
    assert lib.pysco_norm2_blocks(256) == 2 * 32 * 16
    assert lib.pysco_norm2_blocks(512) == 4 * 64 * 4
    real = torch.empty
    sizes = []

    def recording(*size, **kw):
        if kw.get("dtype") == torch.float64:
            sizes.append(size)
        return real(*size, **kw)

    monkeypatch.setattr(stencil.torch, "empty", recording)
    for n in (4, 6, 24, 36, 132, 256):
        x, b, rhs = _grids(n, 9, cuda)
        sizes.clear()
        stencil.residual_norm2("cubic", x, b, rhs, -0.27)
        assert sizes == [(lib.pysco_norm2_blocks(n),)]


@pytest.mark.parametrize("n", [4, 6, 8, 16, 24, 32, 256])
def test_add_prolongation_matches_twin(cuda, n):
    """The plane march (n a multiple of 4, ragged tiles below 128 and at
    24) and the per-cell kernel (n = 6), bitwise the twin."""
    y, xc, _ = _grids(n, 3, cuda)
    xc = xc[: n // 2, : n // 2, : n // 2].contiguous()
    before = stencil.LAUNCHES["add_prolongation"]
    got = stencil.add_prolongation(y, xc)
    assert stencil.LAUNCHES["add_prolongation"] == before + 1
    assert torch.equal(got, stencil.add_prolongation_plain(y, xc))


def test_add_prolongation_misaligned_matches_twin(cuda):
    """A y that is not 16-byte aligned takes the per-cell kernel."""
    n = 16
    y, xc, _ = _grids(n, 6, cuda)
    flat = torch.empty(n ** 3 + 1, device=cuda)
    shifted = flat[1:].view(n, n, n)
    shifted.copy_(y)
    xc = xc[: n // 2, : n // 2, : n // 2].contiguous()
    assert torch.equal(stencil.add_prolongation(shifted, xc),
                       stencil.add_prolongation_plain(y, xc))


def test_stencil_wrappers_check_inputs(cuda):
    x, b, _ = _grids(8, 4, cuda)
    with pytest.raises(ValueError, match="contiguous CUDA"):
        stencil.residual_norm2("linear", x.double(), b)
    with pytest.raises(ValueError, match="expected shape"):
        stencil.add_prolongation(x, x)
    with pytest.raises(ValueError, match="needs b"):
        stencil.restrict3("linear", x)
    with pytest.raises(ValueError, match="no kernel"):
        stencil.restrict3("linear", x, b.cpu())


def test_psum_in_shard_order_on_the_card(cuda):
    """The mesh's reductions on a mesh that repeats the card: bitwise the
    sequential float32 sum in shard order, as on the CPU."""
    from pysco_tpu_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(5)
    xs = [(rng.standard_normal((64, 64)) * 10.0 ** rng.integers(-3, 4))
          .astype(np.float32) for _ in range(4)]
    want = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    mesh = pmesh.make_mesh(devices=["cuda:0"] * 4)
    got = pmesh.psum([torch.as_tensor(x, device=cuda) for x in xs], mesh)
    assert len(got) == 4 and all(g.is_cuda for g in got)
    np.testing.assert_array_equal(got[3].cpu().numpy(), want)
    assert len(pmesh.make_mesh()) == torch.cuda.device_count()


def test_power_spectrum_bitwise(cuda):
    x, _, _ = _grids(64, 5, cuda)
    xk = fourier.rfft3(1.0 + 0.3 * x)
    a = fourier.power_spectrum(xk, 2)
    again = fourier.power_spectrum(xk, 2)
    for u, v in zip(a, again):
        assert torch.equal(u, v)
    twin = fourier.power_spectrum(xk.cpu(), 2)
    for u, v in zip(a, twin):
        torch.testing.assert_close(u.cpu(), v, rtol=1e-5, atol=0)


def test_multigrid_run_reproducible(cuda, tmp_path):
    """A newton multigrid run twice on the card: bitwise-equal final
    snapshots and P(k), the stencil kernels launched on every step."""
    pk_file = tmp_path / "pk.dat"
    write_power_spectrum_table(str(pk_file))
    param = {
        "theory": "newton", "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
        "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 100,
        "ncoarse": 5, "npart": 32 ** 3, "z_start": 49, "seed": 42,
        "position_ICS": "center", "fixed_ICS": False, "paired_ICS": False,
        "dealiased_ICS": False, "power_spectrum_file": str(pk_file),
        "initial_conditions": "2LPT", "output_snapshot_format": "npz",
        "z_out": "[10]", "save_power_spectrum": "yes",
        "integrator": "leapfrog", "mass_scheme": "TSC", "Courant_factor": 1.0,
        "max_aexp_stepping": 10, "linear_newton_solver": "multigrid",
        "gradient_stencil_order": 5, "verbose": 0,
    }
    outs = []
    for tag in ("a", "b"):
        base = tmp_path / tag
        stencil.reset_launches()
        recs = pysco_tpu_torch.run(dict(param, base=str(base)), device="cuda")
        prev = 0
        for r in recs:
            assert r.launches["half_sweep"] > prev
            prev = r.launches["half_sweep"]
        snap = iostream.read_snapshot_particles_npz(
            glob.glob(f"{base}/output_00001/particles_*.npz")[0])
        pks = [np.loadtxt(f) for f in sorted(glob.glob(f"{base}/power/*"))]
        outs.append((snap, pks))
    for x, y in zip(outs[0][0], outs[1][0]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(outs[0][1], outs[1][1]):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# The f(R) scalaron sweep (kernel 4) and the f(R) path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 16, 32])
def test_scalaron_half_sweep_matches_twin(cuda, n):
    """Kernel 4 against its twin, bitwise (--fmad=false, IEEE division),
    on well-conditioned inputs: n = 1 and 2, scalar and plane c0, both
    colours."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    u0 = 0.2 + 0.003 * torch.randn((n, n, n), generator=gen,
                                   device=cuda).abs()
    b = 0.5 * torch.randn((n, n, n), generator=gen, device=cuda)
    red, black = laplacian.pack_rb(u0)
    hb = laplacian.pack_rb(b * float(np.float32(1 / (n * n))))
    for power, q, scale in ((2, -0.1, 1e-3), (3, -0.05, 1e-4)):
        rhs = laplacian.pack_rb(scale * torch.randn((n, n, n), generator=gen,
                                                    device=cuda))
        c0 = float(np.float32(1 / (n * n)) * np.float32(q))
        for to_red, c in ((True, 0), (False, 1)):
            src, dst = (black, red) if to_red else (red, black)
            for coef in (c0, c0 - rhs[c]):
                before = stencil.LAUNCHES["scalaron_half_sweep"]
                got = stencil.scalaron_half_sweep(src, dst, hb[c], coef,
                                                  to_red, 1.25, power)
                assert stencil.LAUNCHES["scalaron_half_sweep"] == before + 1
                want = stencil.scalaron_half_sweep_plain(
                    src, dst, hb[c], coef, to_red, 1.25, power)
                assert torch.equal(got, want)
    with pytest.raises(ValueError, match="n_power"):
        stencil.scalaron_half_sweep(black, red, hb[0], c0, True, 1.25, 4)
    with pytest.raises(ValueError, match="expected shape"):
        stencil.scalaron_half_sweep(black, red, hb[0], u0, True, 1.25, 2)


@pytest.mark.parametrize("power", [2, 3])
def test_scalaron_half_sweep_zero_steps_match_twin(cuda, power):
    """Cells whose Newton residual f is exactly zero (a converged state,
    and zero cells with c0 = -0 and +0) take the kernel's written-out zero
    quotient: still bitwise the twin, signed zeros included."""
    n = 16
    u0 = np.float32(1.0216)
    hbv = np.float32(3e-6)
    nb = np.float32(0)
    for _ in range(6):
        nb = np.float32(nb + u0 ** power)
    p = np.float32(hbv - np.float32(np.float32(1 / 6) * nb))
    if power == 2:
        f0 = np.float32(u0 * np.float32(np.float32(u0 * u0) + p))
    else:
        u2 = np.float32(u0 * u0)
        f0 = np.float32(np.float32(u2 * u2) + np.float32(p * u0))
    shape = (n, n // 2, n)
    src = torch.full(shape, float(u0), device=cuda)
    hb = torch.full(shape, float(hbv), device=cuda)
    zeros = torch.zeros(shape, device=cuda)
    for dst, coef in ((src, float(-f0)), (zeros, -0.0), (zeros, 0.0),
                      (-zeros, -0.0)):
        got = stencil.scalaron_half_sweep(src, dst, hb, coef, True, 1.25,
                                          power)
        want = stencil.scalaron_half_sweep_plain(src, dst, hb, coef, True,
                                                 1.25, power)
        assert torch.equal(got, want)
        assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert torch.equal(stencil.scalaron_half_sweep(src, src, hb, float(-f0),
                                                   True, 1.25, power), src)


@pytest.mark.parametrize("n", [4, 8, 64, 256, 512])
def test_scalaron_exact_half_sweep_matches_twin(cuda, n):
    """The exact-root sweep against its twin, bitwise (the float64 closed
    form with torch's libdevice calls, --fmad=false), on every branch,
    with a scalar d1 and the rhs plane, both colours; on the cells where
    libdevice's pow(x, 1.5) differs from torch's by a float64 ulp, within
    one float32 ulp."""
    for name, ((src, dst, hb, rhs), d1_q) in exact_states(n, cuda).items():
        for r in (None, rhs):
            for to_red in (True, False):
                before = stencil.LAUNCHES["scalaron_exact_half_sweep"]
                got = stencil.scalaron_exact_half_sweep(src, dst, hb, d1_q,
                                                        to_red, 1.25, r)
                assert (stencil.LAUNCHES["scalaron_exact_half_sweep"]
                        == before + 1)
                want = stencil.scalaron_exact_half_sweep_plain(
                    src, dst, hb, d1_q, to_red, 1.25, r)
                ulps = (got.view(torch.int32).long()
                        - want.view(torch.int32).long()).abs()
                assert int(ulps.max()) <= (1 if name == "pow" else 0)
    with pytest.raises(ValueError, match="multiple of 4"):
        x = torch.zeros((6, 3, 6), device=cuda)
        stencil.scalaron_exact_half_sweep(x, x, x, -1.0, True, 1.25)


@pytest.mark.parametrize("n", [4, 8, 64, 256, 512])
def test_scalaron_quartic_exact_half_sweep_matches_twin(cuda, n):
    """The quartic exact-root sweep (f(R) n = 2) against its twin on the
    card, bitwise (the float64 closed form with torch's libdevice calls,
    --fmad=false), on every branch of the closed form, with a scalar c and
    the rhs plane, both colours, but on the cells where libdevice's pow,
    built with --fmad=false, rounds a float64 ulp away from torch's (about
    1 x in 10^6): those within one float32 ulp, or, where Q + d0/Q cancels
    and the ulp moves the branch or the root, bitwise the twin with its
    cube root one float64 ulp away; fewer than one cell in 10^5."""
    off = cells = 0
    for name, ((src, dst, hb, rhs), c_q) in quartic_states(n, cuda).items():
        for r in (None, rhs):
            for to_red in (True, False):
                before = stencil.LAUNCHES["scalaron_quartic_exact_half_sweep"]
                got = stencil.scalaron_quartic_exact_half_sweep(
                    src, dst, hb, c_q, to_red, 1.25, r)
                assert (stencil.LAUNCHES["scalaron_quartic_exact_half_sweep"]
                        == before + 1)
                assert torch.isfinite(got).all()
                k = quartic_off_cells(got, src, dst, hb, c_q, to_red, r)
                assert k["explained"] == k["off"], (name, r is not None,
                                                    to_red, k)
                off += k["off"]
                cells += got.numel()
    assert off * 100000 <= cells, off
    x = torch.zeros((6, 3, 6), device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        stencil.scalaron_quartic_exact_half_sweep(x, x, x, -1.0, True, 1.25)
    y = torch.zeros((8, 4, 8), device=cuda)
    odd = torch.zeros(y.numel() + 1, device=cuda)[1:].view(y.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        stencil.scalaron_quartic_exact_half_sweep(y, y, y, -1.0, True, 1.25,
                                                  odd)


def test_exact_smoothing_launches_the_kernel(cuda):
    """cubic.smoothing with exact roots on the card launches the exact
    sweep twice a sweep and counts it in a profiled step; the quartic's
    exact roots (n = 2) launch the quartic exact sweep twice a sweep and
    nothing else."""
    from torch.profiler import ProfilerActivity, profile

    from pysco_tpu_torch.models import cubic, quartic
    from pysco_tpu_torch.utils import profiling

    n, sweeps = 16, 3
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    x = 0.2 + 0.01 * torch.rand((n, n, n), generator=gen, device=cuda)
    b = torch.randn((n, n, n), generator=gen, device=cuda)
    before = stencil.LAUNCHES["scalaron_exact_half_sweep"]
    cubic.smoothing(x, b, -0.1, sweeps, exact_root=True)
    assert (stencil.LAUNCHES["scalaron_exact_half_sweep"]
            == before + 2 * sweeps)
    profiling.reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            with profiling.step_span(x):
                cubic.smoothing(x, b, -0.1, sweeps, rhs=1e-3 * b,
                                exact_root=True)
        (root,) = [r for r in profiling.span_records()
                   if r["name"] == "step"]
        assert root["counters"]["exact_root_sweeps"] == 2 * sweeps
    finally:
        profiling.reset_spans()
    before = dict(stencil.LAUNCHES)
    quartic.smoothing(x, b, -0.1, sweeps, exact_root=True)
    quartic.smoothing(x, b, -0.1, sweeps, rhs=1e-3 * b, exact_root=True)
    name = "scalaron_quartic_exact_half_sweep"
    assert stencil.LAUNCHES == dict(before, **{name: before[name]
                                               + 2 * 2 * sweeps})


@pytest.mark.parametrize("root", ["newton", "exact", "exact_n2"])
def test_fr_run_reproducible(cuda, tmp_path, monkeypatch, root):
    """An f(R) multigrid run twice on the card (device ICs): bitwise
    equal final snapshots and P(k), and every kernel of the root's path,
    its scalaron sweep among them, launched on every step. With the exact
    roots the second run takes the sweep's torch twin in place of the
    kernel: the kernel changes no bit of the run. f(R) n = 1, and n = 2
    with the quartic's exact sweep (``exact_n2``)."""
    from pysco_tpu_torch import ic_device

    pk_file = tmp_path / "pk.dat"
    write_power_spectrum_table(str(pk_file))
    param = {
        "theory": "fr", "fR_n": 2 if root == "exact_n2" else 1,
        "fR_logfR0": 5, "H0": 72,
        "Om_m": 0.25733, "T_cmb": 2.726, "N_eff": 3.044, "w0": -1.0,
        "wa": 0.0, "boxlen": 100, "ncoarse": 5, "npart": 32 ** 3,
        "z_start": 49, "seed": 42, "position_ICS": "center",
        "fixed_ICS": False, "paired_ICS": False, "dealiased_ICS": False,
        "power_spectrum_file": str(pk_file), "initial_conditions": "2LPT",
        "output_snapshot_format": "npz", "z_out": "[20]",
        "save_power_spectrum": "yes", "integrator": "leapfrog",
        "mass_scheme": "CIC", "Courant_factor": 1.0,
        "max_aexp_stepping": 10, "linear_newton_solver": "multigrid",
        "gradient_stencil_order": 5, "verbose": 0,
        "fR_root_solver": "newton" if root == "newton" else "exact",
    }
    assert ic_device.supported(param)
    # the slab mode's call forms and the other roots' sweeps
    sweeps = {"newton": "scalaron_half_sweep",
              "exact": "scalaron_exact_half_sweep",
              "exact_n2": "scalaron_quartic_exact_half_sweep"}
    sweep = sweeps[root]
    idle = {"deposit_slab", "gather_slab"} | set(sweeps.values()) - {sweep}
    outs = []
    for tag in ("a", "b"):
        if root != "newton" and tag == "b":
            monkeypatch.setattr(stencil, sweep,
                                getattr(stencil, f"{sweep}_plain"))
            idle.add(sweep)
        base = tmp_path / tag
        stencil.reset_launches()
        tiled_pm.reset_launches()
        recs = pysco_tpu_torch.run(dict(param, base=str(base)), device="cuda")
        prev = dict.fromkeys(recs[0].launches, 0)
        for r in recs:
            for k, v in r.launches.items():
                if k in idle:
                    assert v == 0
                    continue
                assert v > prev[k], (r.nsteps, k)
            prev = dict(r.launches)
            assert abs(r.mean_additional - 1.0) < 0.1
        snap = iostream.read_snapshot_particles_npz(
            glob.glob(f"{base}/output_00001/particles_*.npz")[0])
        pks = [np.loadtxt(f) for f in sorted(glob.glob(f"{base}/power/*"))]
        outs.append((snap, pks))
    for x, y in zip(outs[0][0], outs[1][0]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(outs[0][1], outs[1][1]):
        np.testing.assert_array_equal(x, y)


def test_slab_fas_and_ics_on_the_card_match_the_cpu(cuda, tmp_path,
                                                    monkeypatch):
    """On the mesh [cuda:0] * 4: a 32^3 slab FAS solve through slab levels
    (REPLICATE_BELOW = 4) and the replicated coarse levels (the stencil
    kernels), and 128^3 sharded 2LPT ICs, against the same calls on
    [cpu] * 4 (the kernels' twins): the scalaron within 2e-5, the
    particles within 5e-6 of the velocity scale."""
    from pysco_tpu_torch import cosmo
    from pysco_tpu_torch.models import cubic
    from pysco_tpu_torch.parallel import ic_slab, slab, slab_mg
    from pysco_tpu_torch.parallel import mesh as pmesh

    n, q = 32, -2000.0
    rng = np.random.default_rng(2)
    u_star = (1.0 + 0.05 * rng.standard_normal((n, n, n))).astype(np.float32)
    s = stencil.neighbour_sum(torch.as_tensor(u_star) ** 2).numpy()
    h2 = 1.0 / n ** 2
    b = (((s / 6.0) * u_star - u_star ** 3 - q * h2) / (h2 * u_star)).astype(
        np.float32)
    u0 = cubic.initialise_potential(torch.as_tensor(b), q)
    got = {}
    monkeypatch.setattr(slab_mg, "REPLICATE_BELOW", 4)
    for dev in ("cuda:0", "cpu"):
        mesh = pmesh.make_mesh(devices=[dev] * 4)
        ops = slab_mg.fas_ops_cubic_slab(np.float32(q), mesh)
        us = pmesh.scatter(u0, mesh, 0)
        bs = pmesh.scatter(torch.as_tensor(b), mesh, 0)
        tol = np.float32(1e-3) * np.float32(float(
            ops.truncation_error(us, bs)))
        stencil.reset_launches()
        out = slab_mg.FAS_slab(us, bs, ops, 5, 2, 1, tol, mesh)
        got[dev] = (torch.cat([x.cpu() for x in out]).numpy(),
                    dict(stencil.LAUNCHES))
    np.testing.assert_allclose(got["cuda:0"][0], got["cpu"][0], rtol=0,
                               atol=2e-5)
    assert got["cuda:0"][1]["scalaron_half_sweep"] > 0
    assert got["cuda:0"][1]["restrict3"] > 0
    assert not any(got["cpu"][1].values())

    pk_file = str(tmp_path / "pk.dat")
    write_power_spectrum_table(pk_file)
    param = {
        "theory": "newton", "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
        "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 200,
        "ncoarse": 7, "npart": 128 ** 3, "z_start": 49, "seed": 42,
        "position_ICS": "center", "fixed_ICS": False, "paired_ICS": False,
        "dealiased_ICS": True, "power_spectrum_file": pk_file,
        "initial_conditions": "2LPT", "base": str(tmp_path),
        "output_snapshot_format": "npz", "mass_scheme": "TSC",
        "linear_newton_solver": "fft", "gradient_stencil_order": 5,
        "Om_lambda": 0.74267, "Om_r": 0.0, "unit_l": 1.0, "unit_t": 1.0,
        "particle_engine": "pallas", "write_initial_snapshot": False,
        "parallel_mode": "slab", "aexp": 0.02,
    }
    tables = cosmo.generate(param)
    rows = {}
    for dev in ("cuda:0", "cpu"):
        state = ic_slab.generate_lpt_slab(
            param, tables, pmesh.make_mesh(devices=[dev] * 4))
        rows[dev] = slab.gather_particles(state[0], state[1])
    d = np.abs(rows["cuda:0"][0] - rows["cpu"][0])
    assert np.minimum(d, 1.0 - d).max() < 5e-6
    scale = np.abs(rows["cpu"][1]).max()
    np.testing.assert_allclose(rows["cuda:0"][1], rows["cpu"][1], rtol=0,
                               atol=5e-6 * scale + 5e-8)


@pytest.mark.parametrize("n", [64, 128, 256])
def test_irfft3_slab_matches_irfftn_on_the_card(cuda, n):
    """The pencil inverse FFT on [cuda:0] * 4 against the 3-D irfftn on the
    card, for spectra that are not Hermitian on the zero and Nyquist
    planes (the spectral gradient of the sharded ICs, the full_fft force):
    cuFFT's 1-D C2R reads the imaginary parts there unless they are
    cleared (128^3 and 256^3 went wrong, 64^3 did not)."""
    from pysco_tpu_torch.parallel import mesh as pmesh
    from pysco_tpu_torch.parallel import slab

    mesh = pmesh.make_mesh(devices=["cuda:0"] * 4)
    x = torch.randn((n, n, n), generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)
    xs = slab.rfft3_slab(pmesh.scatter(x, mesh, 0), mesh)
    xk = fourier.rfft3(x)
    for a in range(3):
        got = torch.cat(slab.irfft3_slab(slab._per_pencil(
            lambda p, ks: (fourier._TWOPI_I * p) * ks[a], xs, n), mesh, n))
        want = fourier.irfft3(fourier.gradient_axis(xk, a))
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max()), a
    got = torch.cat(slab.gradient_inverse_laplacian_slab(xs, mesh, n, 2),
                    dim=1)
    want = fourier.irfft3_vec(fourier.gradient_inverse_laplacian_compensated(
        xk, 2)).movedim(-1, 0)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

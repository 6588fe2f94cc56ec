"""The PyTorch port's tiled particle engine (pysco_tpu_torch/ops/tiled_pm.py)
against the JAX package's Pallas engine (pysco_tpu/ops/pallas_pm.py).

The same numpy inputs go through both. The JAX deposit and gather run in
Pallas interpret mode at ``precision="f32"``, as tests/test_pallas_pm.py
runs them; on the CPU the port's wrappers run their plain PyTorch twins,
which carry the CUDA kernels' masking and weights (the kernels themselves
are held against the twins on the card by chip_smoke.py). Sorted states
come from the JAX sort and are fed to both sides as they are, so the
comparisons are column by column.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pysco_tpu.ops import pallas_pm
from pysco_tpu_torch.ops import tiled_pm

torch.set_num_threads(1)

SCHEMES = ("ngp", "cic", "tsc")


def _rows(n, seed, clustered=False):
    rng = np.random.default_rng(seed)
    pos = rng.random((n, 3), dtype=np.float32)
    if clustered:
        pos[: n // 2] = 0.2 + 0.25 * pos[: n // 2]
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    return pos, vel


def _jax_sorted(pos, vel, m, scheme, plane0=0, n_planes=None):
    pc, vc = pallas_pm.to_columns(pos, vel, pos.shape[0])
    ps, vs, ts = pallas_pm.sort_particles(pc, vc, m, scheme, plane0,
                                          n_planes)
    return np.array(ps), np.array(vs), np.array(ts)


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


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# the whole grid (the single-device form) and a slab of it
PLANES = [(0, None), (8, 8)]


@pytest.mark.parametrize("plane0,n_planes", PLANES)
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("m", [16, 32])
def test_tile_keys_match(scheme, m, plane0, n_planes):
    pos, vel = _rows(1000, 1)
    pc, _ = pallas_pm.to_columns(pos, vel, 1000)
    want = np.array(pallas_pm.tile_keys(pc, m, scheme, plane0, n_planes))
    got = tiled_pm.tile_keys(_t(np.array(pc)), m, scheme, None, plane0,
                             n_planes).numpy()
    np.testing.assert_array_equal(got, want)


def _tile_multisets(ps, ts):
    out = []
    for t in range(len(ts) - 1):
        cols = ps[:3, ts[t]:ts[t + 1]]
        out.append(cols[:, np.lexsort(cols[::-1])])
    return out


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sort_matches(scheme):
    """lax.sort is not stable: compare tile_starts exactly and each tile's
    particles as a multiset; velocity must stay with its particle."""
    m, n = 32, 3000
    pos, vel = _rows(n, 3, clustered=True)
    ps_j, _, ts_j = _jax_sorted(pos, vel, m, scheme)
    pc, vc = tiled_pm.to_columns_host(pos, vel, n)
    ps, vs, ts = tiled_pm.sort_particles(_t(pc), _t(vc), m, scheme)
    ps, vs, ts = ps.numpy(), vs.numpy(), ts.numpy()
    assert ts.dtype == np.int32
    np.testing.assert_array_equal(ts, ts_j)
    for a, b in zip(_tile_multisets(ps, ts), _tile_multisets(ps_j, ts_j)):
        np.testing.assert_array_equal(a, b)
    assert (ps[3] == 0).all() and (ps[0, n:] == tiled_pm.SENTINEL).all()
    lookup = {tuple(p): tuple(v) for p, v in zip(pos, vel)}
    for p, v in zip(ps[:3, :n].T, vs[:3, :n].T):
        assert lookup[tuple(p)] == tuple(v)


@pytest.mark.parametrize("plane0,n_planes", PLANES)
@pytest.mark.parametrize("scheme,drift", [("cic", 1), ("tsc", 2),
                                          ("ngp", 3)])
def test_drift_violations_match(scheme, drift, plane0, n_planes):
    """Counts equal on drifted particles, some of them past the bound."""
    m, n = 32, 3000
    pos, vel = _rows(n, 5)
    ps, _, ts = _jax_sorted(pos, vel, m, scheme, plane0, n_planes)
    bad = _drifted(ps, m, drift + 1.5, 6)
    want = int(pallas_pm.drift_violations(jnp.asarray(bad), jnp.asarray(ts),
                                          m, scheme, drift, plane0,
                                          n_planes))
    got = int(tiled_pm.drift_violations(_t(bad), _t(ts), m, scheme, drift,
                                        None, plane0, n_planes))
    assert got == want > 0
    ok = _drifted(ps, m, drift - 0.05, 7)
    assert int(tiled_pm.drift_violations(_t(ok), _t(ts), m, scheme, drift,
                                         None, plane0, n_planes)) == 0


def _deposit_and_gather(ps, ts, m, scheme, drift, seed):
    field = np.random.default_rng(seed).random((3, m, m, m)).astype(
        np.float32)
    grid_j = np.array(pallas_pm.deposit(jnp.asarray(ps), jnp.asarray(ts), m,
                                        scheme, True, drift, "f32"))
    acc_j = np.array(pallas_pm.gather_vec_cl(
        jnp.asarray(field), jnp.asarray(ps), jnp.asarray(ts), scheme, True,
        drift, "f32"))
    grid = tiled_pm.deposit(_t(ps), _t(ts), m, scheme, drift).numpy()
    acc = tiled_pm.gather_vec_cl(_t(field), _t(ps), _t(ts), scheme,
                                 drift).numpy()
    return grid, grid_j, acc, acc_j


# drift 0 runs on a fresh sort; drift k >= 1 on a state that moved up to
# k - 0.05 cells since its sort. 3000 columns is not a multiple of Q=512.
# m=16 (two y-blocks per plane) runs the widened windows only.
@pytest.mark.parametrize(
    "m,clustered,scheme,drift",
    [(32, c, s, d) for c in (False, True) for s in SCHEMES
     for d in (0, 1, 2, 3)]
    + [(16, True, s, 2) for s in SCHEMES],
)
def test_deposit_gather_twins_match_pallas(m, clustered, scheme, drift):
    n = 3000
    pos, vel = _rows(n, 11, clustered)
    ps, _, ts = _jax_sorted(pos, vel, m, scheme)
    if drift:
        ps = _drifted(ps, m, drift - 0.05, 12)
    grid, grid_j, acc, acc_j = _deposit_and_gather(ps, ts, m, scheme, drift,
                                                   13)
    # same weights in the same cells, summed in another order: a few
    # float32 ulps of the largest cell sum, 1e-6 of it (<= 6e-5 here;
    # tests/test_pallas_pm.py bounds the Pallas engine against scatter at
    # 2e-4)
    np.testing.assert_allclose(grid, grid_j, atol=1e-6 * grid_j.max(),
                               rtol=0)
    np.testing.assert_allclose(grid.astype(np.float64).sum(), n, rtol=1e-6)
    # gather: w^3-term sums of values in [0, 1) (the pallas test: 1e-4)
    np.testing.assert_allclose(acc, acc_j, atol=1e-5, rtol=1e-5)
    assert np.abs(acc[:, n:]).max() == 0.0 and np.abs(acc[3]).max() == 0.0


_ZB_CHILD = r"""
import json, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from pysco_tpu.ops import pallas_pm

m = 16
assert pallas_pm.n_zblocks(m) == m // 8
out = {}
rng = np.random.default_rng(0)
n = 3000
for scheme, drift in (("cic", 0), ("tsc", 2)):
    pos = rng.random((n, 3)).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    pc, vc = pallas_pm.to_columns(pos, vel, n)
    ps, _, ts = pallas_pm.sort_particles(pc, vc, m, scheme)
    ps = np.array(ps)
    if drift:
        real = ps[0] < pallas_pm.SENTINEL_MIN
        delta = ((drift - 0.05) / m * rng.uniform(
            -1, 1, (3, ps.shape[1]))).astype(np.float32)
        ps[:3] = np.where(real, (ps[:3] + delta) % np.float32(1), ps[:3])
    f = rng.random((3, m, m, m)).astype(np.float32)
    key = f"{scheme}_{drift}"
    np.save(os.path.join(sys.argv[1], key + "_ps.npy"), ps)
    np.save(os.path.join(sys.argv[1], key + "_ts.npy"), np.array(ts))
    np.save(os.path.join(sys.argv[1], key + "_f.npy"), f)
    np.save(os.path.join(sys.argv[1], key + "_grid.npy"), np.array(
        pallas_pm.deposit(jnp.asarray(ps), ts, m, scheme, True, drift,
                          "f32")))
    np.save(os.path.join(sys.argv[1], key + "_acc.npy"), np.array(
        pallas_pm.gather_vec_cl(jnp.asarray(f), jnp.asarray(ps), ts,
                                scheme, True, drift, "f32")))
    out[key] = int(pallas_pm.drift_violations(jnp.asarray(ps), ts, m,
                                              scheme, drift))
print("@@" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def zb_child(tmp_path_factory):
    """The JAX engine's z-blocked states and results (m = 16, z-block 8):
    it takes its z-block size from PYSCO_TPU_ZB at import, so it runs once
    per module in a subprocess with ZB=8. Returns (directory, violation
    counts by "scheme_drift")."""
    out = tmp_path_factory.mktemp("zb")
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


def test_zblocked_twins_match_pallas(zb_child):
    """z-blocked tiles (nbz > 1): the port is given zbs=8 as an
    argument."""
    tmp_path, viol = zb_child
    m, zbs = 16, 8
    for key, want_viol in viol.items():
        scheme, drift = key.split("_")[0], int(key.split("_")[1])

        def load(s):
            return np.load(tmp_path / f"{key}_{s}.npy")

        ps, ts = _t(load("ps")), _t(load("ts"))
        assert ts.shape[0] == tiled_pm.n_tiles(m, zbs) + 1
        assert int(tiled_pm.drift_violations(ps, ts, m, scheme, drift,
                                             zbs)) == want_viol == 0
        grid = tiled_pm.deposit(ps, ts, m, scheme, drift, zbs).numpy()
        np.testing.assert_allclose(grid, load("grid"),
                                   atol=1e-6 * load("grid").max(), rtol=0)
        acc = tiled_pm.gather_vec_cl(_t(load("f")), ps, ts, scheme,
                                     drift, zbs).numpy()
        np.testing.assert_allclose(acc, load("acc"), atol=1e-5, rtol=1e-5)


def test_gather_zbs_matches_pallas(zb_child):
    """The ``zbs`` argument of the gather: with z-blocks of 8 it meets the
    z-blocked JAX gather; the tile starts of z-blocked tiles without it
    (or of unblocked tiles with it) do not match the tiles' count, and the
    wrapper raises before any kernel or twin runs."""
    tmp_path, _ = zb_child
    m, zbs = 16, 8
    for key in ("cic_0", "tsc_2"):
        scheme, drift = key.split("_")[0], int(key.split("_")[1])

        def load(s):
            return np.load(tmp_path / f"{key}_{s}.npy")

        field, ps, ts = _t(load("f")), _t(load("ps")), _t(load("ts"))
        acc = tiled_pm.gather_vec_cl(field, ps, ts, scheme, drift, zbs)
        np.testing.assert_allclose(acc.numpy(), load("acc"), atol=1e-5,
                                   rtol=1e-5)
        assert not acc[3].any() and not acc[:, int(ts[-1]):].any()
        with pytest.raises(ValueError, match="expected shape"):
            tiled_pm.gather_vec_cl(field, ps, ts, scheme, drift)
        _, _, ts_flat = tiled_pm.sort_particles(ps, ps, m, scheme)
        with pytest.raises(ValueError, match="expected shape"):
            tiled_pm.gather_vec_cl(field, ps, ts_flat, scheme, drift, zbs)


def test_zblocked_sort_keys():
    """The port's z-blocked tile keys and sort follow the JAX key layout
    (key = (plane * nby + yblock) * nbz + zblock)."""
    m, zbs, n = 16, 8, 1000
    pos, vel = _rows(n, 21)
    pc, vc = tiled_pm.to_columns_host(pos, vel, n)
    keys = tiled_pm.tile_keys(_t(pc), m, "cic", zbs).numpy()
    xs = pos * m
    base = np.floor(xs - 0.5).astype(np.int64) % m
    want = (base[:, 0] * (m // 8) + base[:, 1] // 8) * (m // zbs) + (
        base[:, 2] // zbs)
    np.testing.assert_array_equal(keys[:n], want)
    assert (keys[n:] == tiled_pm.n_tiles(m, zbs)).all()
    _, _, ts = tiled_pm.sort_particles(_t(pc), _t(vc), m, "cic", zbs)
    np.testing.assert_array_equal(
        np.diff(ts.numpy()), np.bincount(want, minlength=m * 2 * 2))


def test_cuda_wrappers_refuse_cpu_fallback():
    """On a CUDA tensor the wrappers launch the kernel or raise; the twin
    is taken only because a tensor lies on the CPU, and another device
    type raises."""
    pos, vel = _rows(600, 31)
    pc, vc = tiled_pm.to_columns_host(pos, vel, 600)
    ps, _, ts = tiled_pm.sort_particles(_t(pc), _t(vc), 16, "cic")
    meta = ps.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        tiled_pm.deposit(meta, ts, 16, "cic")
    with pytest.raises(ValueError, match="no kernel"):
        tiled_pm.gather_vec_cl(torch.zeros((3, 16, 16, 16), device="meta"),
                               meta, ts, "cic")
    before = dict(tiled_pm.LAUNCHES)
    tiled_pm.deposit(ps, ts, 16, "cic")
    assert tiled_pm.LAUNCHES == before  # the twin counts no launch


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("drift", [0, 1, 3])
@pytest.mark.parametrize("m,zbs", [(16, None), (32, 8)])
def test_live_window_holds_every_bounded_cell(m, zbs, scheme, drift):
    """The deposit kernel keeps only each tile's live window: it lies inside
    the padded window (Geometry.padded_shape), and every cell a
    drift-bounded state adds to lies in some tile's live window, so the
    padded grid outside the live windows stays zero."""
    g = tiled_pm._geometry(m, scheme, drift, zbs)
    wx, wy, wz = g.live_window
    assert wx == g.wx and wy <= g.wy_pad and wz <= g.wz
    assert wy == 8 + g.w - 1 + 2 * drift
    assert wz == (m if g.nbz == 1 else g.zbs + g.w - 1 + 2 * drift)
    gx, gy, gz = g.padded_shape(m)
    live = torch.zeros((gx, gy, gz), dtype=torch.bool)
    for t in range(g.ntiles):
        plane, yb, zb = t // (g.nby * g.nbz), (t // g.nbz) % g.nby, t % g.nbz
        zoff = 0 if g.nbz == 1 else zb * g.zbs
        assert plane + wx <= gx and yb * 8 + wy <= gy and zoff + wz <= gz
        live[plane:plane + wx, yb * 8:yb * 8 + wy, zoff:zoff + wz] = True
    pos, vel = _rows(2000, 41, clustered=True)
    pc, vc = tiled_pm.to_columns_host(pos, vel, 2000)
    ps, _, ts = tiled_pm.sort_particles(_t(pc), _t(vc), m, scheme, zbs)
    if drift:
        ps = _t(_drifted(ps.numpy(), m, drift - 0.05, 42))
    assert int(tiled_pm.drift_violations(ps, ts, m, scheme, drift, zbs)) == 0
    gp = tiled_pm._padded_sums_plain(ps, ts, m, scheme, drift, g)
    assert int(torch.count_nonzero(gp[~live])) == 0
    assert float(gp[live].sum()) == pytest.approx(2000, rel=1e-5)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_gather_fits_every_deposit_shape(scheme):
    """At one component a pass the gather's shared memory (the live window,
    its z rows in whole 16-byte groups) fits every shape the deposit
    accepts: the deposit adds its sort scratch and staged particles to the
    same window."""
    for m in range(8, 2049, 8):
        for drift in range(4):
            g = tiled_pm._geometry(m, scheme, drift)
            if tiled_pm._deposit_smem(g) > tiled_pm._SMEM_LIMIT:
                continue
            assert tiled_pm._gather_smem(g, 1) < tiled_pm._deposit_smem(g)
            assert tiled_pm._gather_stage(g, 3, m, scheme, drift) in (1, 3)


def test_gather_smem_reckoning():
    """The wrapper's reckoning of the gather kernel's shared memory
    (csrc/gather.cu's layout), its choice between every component at once
    and one a pass, and its refusal of a window the card cannot hold."""
    limit = tiled_pm._SMEM_LIMIT
    # 256^3 CIC at drift 0: 2 x-planes x 9 rows x the z line of 256 cells
    # and its first 4-cell group repeated
    g = tiled_pm._geometry(256, "cic", 0)
    assert g.live_window == (2, 9, 256)
    assert tiled_pm._gather_smem(g, 1) == 4 * 2 * 9 * (256 + 4) == 18720
    assert tiled_pm._gather_smem(g, 3) == 3 * 18720 <= limit
    assert tiled_pm._gather_stage(g, 3, 256, "cic", 0) == 3
    # 512^3 CIC at drift 1, z-blocked: 4 x 11 x 131 cells, a row padded to
    # 136 (whole groups, the window starting 3 cells into its first)
    g = tiled_pm._geometry(512, "cic", 1)
    assert g.live_window == (4, 11, 131)
    assert tiled_pm._gather_smem(g, 1) == 4 * 4 * 11 * 136 == 23936
    assert tiled_pm._gather_smem(g, 3) == 3 * 23936 <= limit
    assert tiled_pm._gather_stage(g, 3, 512, "cic", 1) == 3
    # 256^3 CIC at drift 1: all three fit a block (one an SM)
    g = tiled_pm._geometry(256, "cic", 1)
    assert tiled_pm._gather_smem(g, 3) == 3 * 4 * 4 * 11 * 260 <= limit
    assert tiled_pm._gather_stage(g, 3, 256, "cic", 1) == 3
    # past a block's shared memory, one component a pass
    for m, scheme, drift in ((256, "cic", 3), (256, "tsc", 3),
                             (512, "tsc", 3)):
        g = tiled_pm._geometry(m, scheme, drift)
        assert tiled_pm._gather_smem(g, 3) > limit
        assert tiled_pm._gather_stage(g, 3, m, scheme, drift) == 1
        assert tiled_pm._gather_smem(g, 1) <= limit
    # 1, 2 and 4 components: the limit decides each
    g = tiled_pm._geometry(128, "tsc", 3)
    assert [tiled_pm._gather_stage(g, c, 128, "tsc", 3)
            for c in (1, 2, 3, 4)] == [1, 2, 3, 1]
    # a 504-cell z line at TSC drift 3 does not fit even one component:
    # the wrapper raises before any launch (as the deposit's does)
    g = tiled_pm._geometry(504, "tsc", 3)
    assert tiled_pm._gather_smem(g, 1) > limit
    with pytest.raises(ValueError, match="shared memory"):
        tiled_pm._gather_stage(g, 3, 504, "tsc", 3)


def test_deposit_smem_reckoning():
    """The wrapper's reckoning of the kernel's shared memory
    (csrc/deposit.cu's layout), and its refusal of a window the card
    cannot hold."""
    chunk, scratch = tiled_pm._DEPOSIT_CHUNK, tiled_pm._DEPOSIT_SORT_SCRATCH
    # after the sort: the sorted particles, 2 x 8 warps' counter sums, the
    # prefix sum's 64 bytes, the 257 visit prefixes (16-byte rounded), 256
    # heavy columns
    head = 4 * chunk + 4 * 2 * 8 + 64 + 1040 + 2 * 256
    # 256^3 CIC at drift 0: the z line of 2 x 9 rows, 6 weights a
    # particle; 256 x 10 bins, 2-byte starts; 256 partials of 2 cells
    g = tiled_pm._geometry(256, "cic", 0)
    assert g.live_window == (2, 9, 256)
    assert tiled_pm._deposit_bins(g) == 256 * 10
    assert head + 5136 + 4 * 256 * 2 < scratch
    assert tiled_pm._deposit_smem(g) == (scratch + 4 * 2 * 9 * 256
                                         + 4 * chunk * 6)
    # 512^3 CIC at drift 1, z-blocked: 4 x 11 x 131 cells, 132 x 12 bins
    g = tiled_pm._geometry(512, "cic", 1)
    assert g.live_window == (4, 11, 131)
    assert tiled_pm._deposit_bins(g) == 132 * 12
    assert tiled_pm._deposit_smem(g) == (scratch + 4 * 4 * 11 * 131
                                         + 4 * chunk * 6)
    # 512^3 TSC at drift 3: the arrays outgrow the sort scratch (2484 bins,
    # 256 partials of 9 cells), and two blocks still fit an SM's 228 KiB
    g = tiled_pm._geometry(512, "tsc", 3)
    assert g.live_window == (9, 16, 136)
    arrays = head + 4976 + 4 * 256 * 9
    assert arrays > scratch
    smem = tiled_pm._deposit_smem(g)
    assert smem == arrays + 4 * 9 * 16 * 136 + 4 * chunk * 9
    assert 2 * (smem + 1024) <= 233472
    # a long z line: the bin starts outgrow the sort scratch
    g = tiled_pm._geometry(4000, "ngp", 0)
    starts = 2 * (8 * 4000 + 1) + 14
    assert tiled_pm._deposit_smem(g) == (head + starts + 4 * 256
                                         + 4 * 1 * 8 * 4000
                                         + 4 * chunk * 3)
    # the widest window the tests and smoke run use fits; a wider one
    # raises before any launch
    for m, scheme, drift in ((256, "tsc", 3), (512, "tsc", 3),
                             (1024, "cic", 1)):
        g = tiled_pm._geometry(m, scheme, drift)
        assert tiled_pm._deposit_smem(g) <= tiled_pm._SMEM_LIMIT
        tiled_pm._check_deposit_smem(g, m, scheme, drift)
    g = tiled_pm._geometry(504, "tsc", 3)  # nbz = 1: a 504-cell z line
    assert tiled_pm._deposit_smem(g) > tiled_pm._SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        tiled_pm._check_deposit_smem(g, 504, "tsc", 3)
    # the kernel sorts and keeps 16-bit bin keys: a window a block holds
    # has fewer bins than that (the longest z lines are NGP's)
    for m in range(8, 8401, 8):
        g = tiled_pm._geometry(m, "ngp", 0)
        if tiled_pm._deposit_smem(g) <= tiled_pm._SMEM_LIMIT:
            assert tiled_pm._deposit_bins(g) < 1 << 16


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("drift", [0, 1, 2, 3])
def test_deposit_fits_every_geometry_reached(scheme, drift):
    """Every deposit geometry the configurations, the tests and
    chip_smoke.py reach fits a block's shared memory and the kernel's
    16-bit bin keys: m = 16 ... 512, tiles spanning the z line (nbz = 1)
    and z-blocked (the 128-cell rule from 512^3 up, and the 8- and
    16-cell blocks the tests force), the whole grid and the thinnest
    slab."""
    w = tiled_pm._WIDTH[scheme]
    for m in (16, 32, 64, 128, 256, 512):
        for zbs in (None, 8, 16):
            for n_planes in (None, max(w - 1 + drift, 1)):
                g = tiled_pm._geometry(m, scheme, drift, zbs, n_planes)
                assert tiled_pm._deposit_smem(g) <= tiled_pm._SMEM_LIMIT
                assert tiled_pm._deposit_bins(g) < 1 << 16
                tiled_pm._check_deposit_smem(g, m, scheme, drift)

"""The four ``sort_mode`` values of the tiled engine's sort
(``pysco_tpu_torch.ops.tiled_pm.sort_particles``) against the port's own
``full`` sort and the JAX package's ``pallas_pm.sort_particles``.

Every mode gives bitwise the port's ``full`` result (the port sends all
four to one stable sort); ``tile_starts`` equal JAX's, and each tile
holds the same set of particles (``lax.sort`` is not stable, so the order
inside a tile may differ). JAX's side runs with ``block = 4096`` as in
tests/test_pallas_pm.py, so its nearly modes' two block rounds engage on
4 blocks of a drifted state and fall back on the others.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pysco_tpu.ops import pallas_pm
from pysco_tpu_torch import solver as tsolver
from pysco_tpu_torch.integrate import step_impl
from pysco_tpu_torch.ops import tiled_pm
from pysco_tpu_torch.parallel import mesh as pmesh
from pysco_tpu_torch.parallel import pm as par_pm
from pysco_tpu_torch.parallel import slab

torch.set_num_threads(1)

MODES = tiled_pm.SORT_MODES
M = 32
NPART = 4096 * 4  # a power of two: four blocks of 4096 columns


def _columns(scenario, seed=7, scheme="tsc"):
    """Column state of NPART particles: ``random``; or tile-sorted by the
    port's full sort and then moved by up to 0.25 cell per axis,
    ``drifted`` keeping every particle on its side of the x key's periodic
    wrap (a particle whose base plane would wrap keeps its x) and
    ``wrapped`` not. A particle whose key wraps moves from one end of the
    sorted columns to the other, far beyond the B/2 that JAX's two block
    rounds reach, so its nearly modes fall back on it."""
    rng = np.random.default_rng(seed)
    pos = rng.random((NPART, 3), dtype=np.float32)
    vel = rng.standard_normal((NPART, 3)).astype(np.float32)
    pc, vc = (torch.as_tensor(a) for a in tiled_pm.to_columns_host(
        pos, vel, NPART))
    if scenario == "random":
        return pc, vc
    pc, vc, _ = tiled_pm.sort_particles(pc, vc, M, scheme)
    delta = torch.as_tensor((0.25 / M * rng.uniform(-1, 1, (3, NPART)))
                            .astype(np.float32))
    moved = torch.remainder(pc[:3] + delta, 1.0)
    if scenario == "drifted":
        k0, k1 = (tiled_pm._base_axis(scheme, x * M) % M
                  for x in (pc[0], moved[0]))
        moved[0] = torch.where((k1 - k0).abs() > 1, pc[0], moved[0])
    pc = pc.clone()
    pc[:3] = moved
    return pc, vc


def _tile_sets(pos, starts):
    pos, starts = np.asarray(pos), np.asarray(starts)
    out = []
    for t in range(len(starts) - 1):
        cols = pos[:3, starts[t]:starts[t + 1]]
        out.append(cols[:, np.lexsort(cols)])
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scenario", ["drifted", "wrapped", "random"])
def test_sort_mode_matches_full_and_jax(mode, scenario):
    pc, vc = _columns(scenario)
    want = tiled_pm.sort_particles(pc, vc, M, "tsc")
    got = tiled_pm.sort_particles(pc, vc, M, "tsc", mode=mode)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    jp, jv, js = pallas_pm.sort_particles(
        jnp.asarray(pc.numpy()), jnp.asarray(vc.numpy()), M, "tsc",
        mode=mode, block=4096)
    np.testing.assert_array_equal(got[2].numpy(), np.array(js))
    for a, b in zip(_tile_sets(got[0], got[2]), _tile_sets(jp, js)):
        np.testing.assert_array_equal(a, b)
    # velocities ride with their positions
    cols = np.concatenate([got[0].numpy()[:3], got[1].numpy()[:3]])
    ref = np.concatenate([pc.numpy()[:3], vc.numpy()[:3]])
    np.testing.assert_array_equal(cols[:, np.lexsort(cols)],
                                  ref[:, np.lexsort(ref)])


@pytest.mark.parametrize("mode", MODES)
def test_slab_sort_mode(mode):
    """A slab's sort (``plane0 != 0``: planes 8..15 of 32) in every mode:
    bitwise the port's full slab sort, ``tile_starts`` JAX's."""
    pc, vc = _columns("drifted", seed=11)
    want = tiled_pm.sort_particles(pc, vc, M, "cic", None, 8, 8)
    got = tiled_pm.sort_particles(pc, vc, M, "cic", None, 8, 8, mode=mode)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, _, js = pallas_pm.sort_particles(
        jnp.asarray(pc.numpy()), jnp.asarray(vc.numpy()), M, "cic", 8, 8,
        mode=mode, block=4096)
    np.testing.assert_array_equal(got[2].numpy(), np.array(js))


def _param(mode, engine="pallas"):
    return {
        "theory": "newton", "ncoarse": 4, "npart": 16 ** 3,
        "mass_scheme": "cic", "linear_newton_solver": "fft",
        "gradient_stencil_order": 5, "aexp": 0.1, "Om_m": 0.3,
        "epsrel": 1e-2, "particle_engine": engine, "sort_mode": mode,
    }


def test_unknown_sort_mode_refused():
    with pytest.raises(ValueError, match="sort_mode"):
        tsolver.config_from_param(_param("bitonic"))
    pc, vc = _columns("random")
    with pytest.raises(ValueError, match="sort_mode"):
        tiled_pm.sort_particles(pc, vc, M, "tsc", mode="bitonic")
    cfg = tsolver.config_from_param(_param("NEARLY"))
    assert cfg.sort_mode == "nearly"  # case-folded, as JAX reads it


@pytest.mark.parametrize("mode", MODES[1:])
def test_every_run_mode_accepts_sort_mode(mode):
    """One step with each mode in single, replicated (2 shards) and slab
    (2 shards) mode: bitwise the ``full`` mode's step."""
    rng = np.random.default_rng(5)
    pos = rng.random((16 ** 3, 3), dtype=np.float32)
    vel = (0.02 * rng.standard_normal((16 ** 3, 3))).astype(np.float32)
    pc, vc = tiled_pm.to_columns_host(pos, vel, 16 ** 3)
    mesh = pmesh.make_mesh(devices=["cpu"] * 2)
    outs = {}
    for m in ("full", mode):
        param = _param(m)
        cfg = tsolver.config_from_param(param)
        dyn = tsolver.compute_dynamics(param)
        phi, u = tsolver.empty_fields(cfg, "cpu")
        single = step_impl(cfg, "leapfrog", True, False, torch.as_tensor(pc),
                           torch.as_tensor(vc), torch.zeros(pc.shape), phi,
                           u, dyn, 5e-3)
        state = par_pm.shard_state(mesh, pc, vc, np.zeros_like(pc), phi, u)
        repl = par_pm.make_sharded_step(cfg, mesh, first_call=True)(
            *state, dyn, 5e-3)
        sstate = slab.distribute_particles(mesh, cfg, pos, vel)
        slabbed = slab.make_slab_step(cfg, mesh, first_call=True)(
            *sstate, dyn, 5e-3)
        outs[m] = [*single[:3], *repl[0], *repl[1], *repl[2],
                   *slabbed[0], *slabbed[1], *slabbed[2]]
    assert len(outs[mode]) == 15
    for a, b in zip(outs["full"], outs[mode]):
        assert torch.equal(a, b)

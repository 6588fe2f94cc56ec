"""The guarded float32 Newton root of the f(R) scalaron sweep
(``ops/stencil.py`` ``newton_root_plain``, the twin of the kernels in
``csrc/scalaron_sweep.cu``): the pinned cells where the unguarded polish
leaves its root's bracket take the safe root, every other cell keeps the
unguarded polish bit for bit, and runs that broke with the Newton roots
now reach z = 0 beside the exact-root runs.

On the pinned cells the port departs from the JAX package, whose
``cubic._newton_root`` and ``quartic._newton_root`` keep the unguarded
polish."""

import glob
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysco_tpu_torch
from pysco_tpu.models import cubic as jcubic
from pysco_tpu.models import quartic as jquartic
from pysco_tpu_torch.cosmo import write_power_spectrum_table
from pysco_tpu_torch.ops import stencil
from pysco_tpu_torch.parallel import slab_mg

from newton_root_states import PINNED, packed_state, pinned_cells

torch.set_num_threads(1)

EPS = np.float32(1e-12)
JAX_ROOT = {2: jcubic._newton_root, 3: jquartic._newton_root}


def _unguarded(x, p, c0, power, iters=3):
    """The polish without its guard: three float32 Newton steps from x,
    f' held at 1e-12 in magnitude (the port's newton_root before the
    guard, operand for operand)."""
    for _ in range(iters):
        if power == 2:
            f = x * (x * x + p) + c0
            fp = 3.0 * x * x + p
        else:
            x2 = x * x
            f = x2 * x2 + p * x + c0
            fp = 4.0 * x2 * x + p
        fp = torch.where(torch.abs(fp) < float(EPS), float(EPS), fp)
        x = x - f / fp
    return x


def _closed(p, c0, power):
    c = c0.double()
    if power == 2:
        return stencil.solution_cubic_equation(p, 27.0 * c)
    return stencil.solution_quartic_equation(p, c)


@pytest.mark.parametrize("power", [2, 3])
def test_pinned_cells_take_the_safe_root(power):
    """Each pinned cell is guarded and its root is finite, >= 0 and within
    2e-5 of the float64 closed form (test_torch_fr's tracking bound),
    where the unguarded polish -- the JAX package's -- lands below 0 or
    further than that from the root on every one."""
    x, p, c0 = pinned_cells(power)
    got, guarded = stencil.newton_root_plain(x, p, c0, power)
    assert guarded.all()
    assert torch.isfinite(got).all() and (got >= 0).all()
    closed = _closed(p, c0, power)
    np.testing.assert_allclose(got.double().numpy(), closed.numpy(),
                               atol=2e-5, rtol=2e-5)
    old = _unguarded(x, p, c0, power)
    jax_old = np.array(JAX_ROOT[power](jnp.asarray(x.numpy()),
                                       jnp.asarray(p.numpy()),
                                       jnp.asarray(c0.numpy())))
    np.testing.assert_allclose(old.numpy(), jax_old, rtol=2.4e-7)
    far = np.abs(jax_old - closed.numpy()) > 2e-5 + 2e-5 * np.abs(
        closed.numpy())
    assert far.all()
    assert (jax_old < 0).any()


@pytest.mark.parametrize("power", [2, 3])
def test_pinned_cells_are_the_guarded_count(power):
    """In a packed state that holds them among in-bracket cells, the twin
    of the sweep counts the pinned cells alone, and they alone move off
    the unguarded polish."""
    (src, dst, hb, c0), at = packed_state(power, 16)
    counts = torch.zeros(1, dtype=torch.int64)
    out = stencil.scalaron_half_sweep_plain(src, dst, hb, c0, True, 1.25,
                                            power, counts=counts)
    assert int(counts[0]) == len(PINNED[power]) == len(at)
    old = dst + np.float32(1.25) * (_unguarded(dst, hb, c0, power) - dst)
    moved = (out != old).flatten().nonzero().flatten().numpy()
    assert set(moved) <= set(at)


@pytest.mark.parametrize("power", [2, 3])
@pytest.mark.parametrize("kind", ["wide", "near_root"])
def test_in_bracket_cells_keep_the_unguarded_polish_bitwise(power, kind):
    """Random cells whose steps stay in the bracket: the guarded root is
    the unguarded polish bit for bit (``wide``: the ranges of
    test_torch_fr's twin test, seeds 0.5-1.5, p in [-0.5, 0.5], c0 =
    -0.1; ``near_root``: a converging scalaron, seeds within 2% of their
    roots, c0 and p of the 512^3 runs' size)."""
    rng = np.random.default_rng(17 + power)
    m = 4096
    if kind == "wide":
        x = (0.5 + rng.random(m)).astype(np.float32)
        p = (rng.random(m) - 0.5).astype(np.float32)
        c0 = np.full(m, -0.1, np.float32)
    else:
        p = rng.uniform(-1e-3, 1e-3, m).astype(np.float32)
        c0 = -(10.0 ** rng.uniform(-9, -5, m)).astype(np.float32)
        root = _closed(torch.as_tensor(p), torch.as_tensor(c0),
                       power).numpy()
        x = (root * rng.uniform(0.98, 1.02, m)).astype(np.float32)
    x, p, c0 = (torch.as_tensor(a) for a in (x, p, c0))
    got, guarded = stencil.newton_root_plain(x, p, c0, power)
    assert guarded.sum() <= m // 100
    keep = ~guarded
    assert torch.equal(got[keep], _unguarded(x, p, c0, power)[keep])
    # a float c0 is the same polish as a tensor of it
    if kind == "wide":
        assert torch.equal(stencil.newton_root(x, p, -0.1, power), got)


@pytest.mark.parametrize("power", [2, 3])
def test_safe_root_is_the_largest_positive_root(power):
    """The safe root falls from ``_bracket_top`` onto the largest positive
    root, to float32 rounding: for c0 < 0 the only one, PySCo's closed
    form; for c0 >= 0 (a coarse FAS level) the larger of two. Where no
    positive root exists it stops finite, no higher than where it
    started."""
    p = torch.tensor([-2.0, 0.01, -0.5, -0.5, 0.3], dtype=torch.float32)
    c0 = torch.tensor([-0.3, -1e-6, 0.05, 0.0, 0.02], dtype=torch.float32)
    got = stencil.safe_root(p, c0, power)
    assert got.dtype == torch.float32
    largest = [max(r.real for r in np.roots(
        [1.0, 0.0, float(pp), float(cc)] if power == 2
        else [1.0, 0.0, 0.0, float(pp), float(cc)]) if abs(r.imag) < 1e-9)
        for pp, cc in zip(p[:4], c0[:4])]
    np.testing.assert_allclose(got[:4].numpy(), largest, rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(got[:2].numpy(),
                               _closed(p[:2], c0[:2], power).numpy(),
                               rtol=1e-6)
    top = stencil._bracket_top(p, c0, power)
    assert torch.isfinite(got).all() and (got <= top).all()


# ---------------------------------------------------------------------------
# Whole runs, 32^3 particles in 32 Mpc/h (1 Mpc/h cells)
# ---------------------------------------------------------------------------

def _param(tmp_path, fR_n, scheme, roots, **kw):
    pk_file = tmp_path / "pk.dat"
    if not pk_file.exists():
        write_power_spectrum_table(str(pk_file))
    p = {
        "theory": "fr", "fR_n": fR_n, "fR_logfR0": 5, "H0": 72,
        "Om_m": 0.25733, "T_cmb": 2.726, "N_eff": 3.044, "w0": -1.0,
        "wa": 0.0, "boxlen": 32.0, "ncoarse": 5, "npart": 32 ** 3,
        "z_start": 49, "seed": 2001, "position_ICS": "center",
        "fixed_ICS": False, "paired_ICS": False, "dealiased_ICS": False,
        "power_spectrum_file": str(pk_file), "initial_conditions": "2LPT",
        "base": str(tmp_path / f"{roots}_{fR_n}_{scheme}"),
        "output_snapshot_format": "npz", "z_out": "[0]",
        "save_power_spectrum": "z_out", "integrator": "leapfrog",
        "mass_scheme": scheme, "Courant_factor": 1.0,
        "max_aexp_stepping": 10, "linear_newton_solver": "multigrid",
        "gradient_stencil_order": 5, "Npre": 2, "Npost": 1, "epsrel": 0.01,
        "fR_root_solver": roots, "verbose": 0,
        "write_initial_snapshot": False,
    }
    p.update(kw)
    return p


def _run(param, **kw):
    """The run's records and its P(k) at z = 0."""
    recs = pysco_tpu_torch.run(param, device="cpu", **kw)
    pk = np.loadtxt(sorted(glob.glob(f"{param['base']}/power/*.dat"))[-1])
    return recs, pk


@pytest.mark.parametrize("fR_n,scheme", [(1, "CIC"), (1, "TSC"), (2, "TSC")])
def test_newton_run_reaches_z0_beside_the_exact_roots(tmp_path, fR_n,
                                                      scheme):
    """Unguarded, these runs turn NaN near a = 0.37-0.5 (n = 1 CIC, n = 2
    TSC) or end with u off the exact-root run's (n = 1 TSC). Guarded, the
    Newton-root run reaches z = 0 finite, its mean u within 1e-5 of the
    exact-root run's and its P(k) within 1e-5 in every bin: both FAS
    solves stop within epsrel of the truncation error, and a converged
    float32 polish is the closed-form root to float32 rounding, so the
    two runs differ by the solves' float32 residuals alone (on this seed
    at most 1.1e-6 in P(k) and 2.4e-7 in mean u; the bounds leave nine
    and forty times that)."""
    newton, pk_n = _run(_param(tmp_path, fR_n, scheme, "newton"))
    exact, pk_e = _run(_param(tmp_path, fR_n, scheme, "exact"))
    assert all(math.isfinite(r.mean_additional) for r in newton)
    assert len(newton) == len(exact)
    assert newton[-1].mean_additional == pytest.approx(
        exact[-1].mean_additional, abs=1e-5)
    np.testing.assert_allclose(pk_n[:, 1], pk_e[:, 1], rtol=1e-5)


def test_slab_newton_run_reaches_z0(tmp_path, monkeypatch):
    """The slab FAS on four CPU shards, its slab levels down to 4^3 on the
    twin (``slab_mg``'s Newton root is the guarded one): n = 1 CIC
    reaches z = 0 finite, within 1e-5 in mean u of the single run."""
    monkeypatch.setattr(slab_mg, "REPLICATE_BELOW", 4)
    slab, pk_s = _run(_param(tmp_path, 1, "CIC", "newton",
                             parallel_mode="slab"), devices=["cpu"] * 4)
    assert all(math.isfinite(r.mean_additional) for r in slab)
    single, pk_1 = _run(_param(tmp_path, 1, "CIC", "newton",
                               base=str(tmp_path / "single")))
    assert slab[-1].mean_additional == pytest.approx(
        single[-1].mean_additional, abs=1e-5)
    np.testing.assert_allclose(pk_s[:, 1], pk_1[:, 1], rtol=1e-4)

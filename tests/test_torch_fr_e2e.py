"""The ``fr_n1`` and ``fr_n2`` rows of tests/test_e2e.py through
``pysco_tpu_torch.run`` (plain twins on the CPU) against
``pysco_tpu.run``."""

import glob

import pytest
import torch

import pysco_tpu
import pysco_tpu_torch
from pysco_tpu_torch.utils import io as iostream

from test_torch_run import _compare, _e2e_param, _pks

torch.set_num_threads(1)


@pytest.mark.parametrize("name,overrides", [
    ("fr_n1", {"theory": "fr", "fR_n": 1, "fR_logfR0": 5}),
    ("fr_n2", {"theory": "fr", "fR_n": 2, "fR_logfR0": 5}),
])
def test_e2e_fr_rows_match_jax(tmp_path, name, overrides):
    """The f(R) rows of tests/test_e2e.py (multigrid, TSC, 2LPT, 16^3, to
    z = 44) through both packages: P(k) within 1e-4 on bins with >= 8
    modes, the same number of steps."""
    overrides = dict(overrides, linear_newton_solver="multigrid")
    pj = _e2e_param(tmp_path, "jax", **overrides)
    pt = _e2e_param(tmp_path, "torch", **overrides)
    pysco_tpu.run(pj)
    records = pysco_tpu_torch.run(pt, device="cpu")
    _compare(_pks(pt["base"]), _pks(pj["base"]), 1e-4, name)
    snap_j = glob.glob(f"{pj['base']}/output_00001/particles_*.h5")
    snap_t = glob.glob(f"{pt['base']}/output_00001/particles_*.h5")
    assert len(snap_j) == len(snap_t) == 1
    nsteps = int(iostream.read_hdf5_snapshot_attrs(snap_t[0])["nsteps"])
    assert nsteps == int(iostream.read_hdf5_snapshot_attrs(
        snap_j[0])["nsteps"]) == len(records)
    # the scalaron stays at its background value, u ~ 1
    assert all(abs(r.mean_additional - 1.0) < 1e-2 for r in records)

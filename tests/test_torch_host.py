"""The port's host modules (copies of the JAX package's numpy-only ones)
against the originals: cosmology tables, initial conditions, config
parsing and snapshot interchange; and the port importing no JAX."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pysco_tpu import cosmo as jcosmo, ic as jic
from pysco_tpu.utils import config as jconfig, io as jio
from pysco_tpu.utils.units import set_units as jset_units
from pysco_tpu_torch import cosmo, ic
from pysco_tpu_torch.utils import config, io
from pysco_tpu_torch.utils.units import set_units

torch.set_num_threads(1)

BASE = {
    "theory": "newton", "H0": 72, "Om_m": 0.25733, "T_cmb": 2.726,
    "N_eff": 3.044, "w0": -1.0, "wa": 0.0, "boxlen": 100, "ncoarse": 4,
    "npart": 16 ** 3, "z_start": 49, "seed": 42, "position_ICS": "center",
    "fixed_ICS": False, "paired_ICS": False, "dealiased_ICS": False,
    "initial_conditions": "2LPT", "output_snapshot_format": "HDF5",
    "parametrized_mu0": -0.1,
}


def _param(conf, tmp_path, tag, **kw):
    p = conf.with_defaults(conf.params_from_dict(dict(BASE, **kw)))
    p["base"] = str(tmp_path / tag)
    p["extra"] = conf.extra_name(p)
    return p


@functools.lru_cache(maxsize=None)
def _tables(package: str, theory: str, base: str):
    """Background tables of one package (they depend on the cosmology and
    theory only; ``base`` receives the evolution-table file)."""
    conf, cmod = (jconfig, jcosmo) if package == "jax" else (config, cosmo)
    return cmod.generate(conf.with_defaults(conf.params_from_dict(
        dict(BASE, theory=theory, base=base))))


@pytest.fixture(scope="module")
def table_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tables"))


@pytest.mark.parametrize("theory", ["newton", "parametrized"])
def test_cosmo_tables_equal(table_dir, theory):
    tj = _tables("jax", theory, table_dir + "/j")
    tt = _tables("torch", theory, table_dir + "/t")
    assert len(tt) == len(tj) == 13
    x = np.linspace(np.log(1 / 201), 0, 97)
    for fj, ft in zip(tj, tt):
        # the same code on the same inputs: bit-identical
        np.testing.assert_array_equal(ft(x), fj(x))


@pytest.mark.parametrize("fixed,order", [(False, "2LPT"), (True, "2LPT"),
                                         (False, "1LPT")])
def test_initial_conditions_bit_identical(tmp_path, table_dir, fixed,
                                         order):
    pk = tmp_path / "pk.dat"
    cosmo.write_power_spectrum_table(str(pk))
    out = []
    for conf, package, icmod, su, tag in (
        (jconfig, "jax", jic, jset_units, "j"),
        (config, "torch", ic, set_units, "t"),
    ):
        p = _param(conf, tmp_path, tag, fixed_ICS=fixed,
                   initial_conditions=order, power_spectrum_file=str(pk))
        (tmp_path / tag / "output_00000").mkdir(parents=True)
        tables = _tables(package, "newton", f"{table_dir}/{tag}")
        p["aexp"] = 1.0 / (1 + p["z_start"])
        su(p)
        out.append(icmod.generate(p, tables))
    (pj, vj), (pt, vt) = out
    assert pt.shape == (16 ** 3, 3) and pt.dtype == np.float32
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(vt, vj)


INI = """\
# comment line
theory = parametrized   # trailing comment
npart = 8**3
z_out = [10, 5, 0.5]
fixed_ICS = True
paired_ICS = false
boxlen = 50.5
base = some/dir/
mass_scheme = CIC
empty =
"""


def test_config_parsing_identical(tmp_path):
    ini = tmp_path / "param.ini"
    ini.write_text(INI)
    pj = jconfig.read_param_file(str(ini))
    pt = config.read_param_file(str(ini))
    assert dict(pt) == dict(pj)
    assert pt["npart"] == 512 and pt["z_out"] == [10, 5, 0.5]
    assert pt["fixed_ICS"] is True and pt["empty"] is False
    for theory in ("newton", "parametrized", "fr", "mond"):
        d = dict(pt, theory=theory, linear_newton_solver="fft", ncoarse=5)
        wj = jconfig.with_defaults(jconfig.params_from_dict(d))
        wt = config.with_defaults(config.params_from_dict(d))
        assert dict(wt) == dict(wj)
        assert config.extra_name(wt) == jconfig.extra_name(wj)


@pytest.mark.parametrize("fmt", ["HDF5", "parquet"])
def test_snapshots_interchange(tmp_path, fmt):
    """A snapshot written by either package reads back in the other, and
    restarts through the copied ic._restart with its parameters."""
    rng = np.random.default_rng(0)
    pos = rng.random((500, 3), dtype=np.float32)
    vel = rng.standard_normal((500, 3)).astype(np.float32)
    for w_io, r_ic, tag in ((jio, ic, "j2t"), (io, jic, "t2j")):
        p = _param(config, tmp_path, tag, output_snapshot_format=fmt,
                   npart=500)
        p.update({"i_snap": 3, "aexp": 0.25, "nsteps": 17})
        w_io.write_snapshot_particles(pos, vel, p)
        q = _param(config, tmp_path, tag, output_snapshot_format=fmt,
                   npart=500)
        q["aexp"] = 0.02
        got_p, got_v = r_ic._restart(q, 3)
        np.testing.assert_array_equal(got_p, pos)
        np.testing.assert_array_equal(got_v, vel)
        assert float(q["aexp"]) == 0.25 and int(q["nsteps"]) == 17
        assert q["initial_conditions"] == 3


def test_npz_snapshot_restart(tmp_path):
    """The port's NumPy-only snapshot format restarts with its parameters
    and their types."""
    rng = np.random.default_rng(1)
    pos = rng.random((300, 3), dtype=np.float32)
    vel = rng.standard_normal((300, 3)).astype(np.float32)
    p = _param(config, tmp_path, "npz", output_snapshot_format="npz",
               npart=300)
    p.update({"i_snap": 2, "aexp": np.float64(0.25), "nsteps": 9,
              "z_out": [10, 0.5], "fixed_ICS": True})
    io.write_snapshot_particles(pos, vel, p)
    q = _param(config, tmp_path, "npz", output_snapshot_format="npz",
               npart=300)
    got_p, got_v = ic._restart(q, 2)
    np.testing.assert_array_equal(got_p, pos)
    np.testing.assert_array_equal(got_v, vel)
    assert q["aexp"] == 0.25 and q["nsteps"] == 9 and q["npart"] == 300
    assert q["z_out"] == [10, 0.5] and q["fixed_ICS"] is True
    assert q["initial_conditions"] == 2


def test_import_leaves_no_jax():
    """Importing every module of the port, parallel/ included, loads
    neither JAX nor the JAX package."""
    code = ("import pkgutil, sys, importlib, pysco_tpu_torch; "
            "names = [m.name for m in pkgutil.walk_packages("
            "pysco_tpu_torch.__path__, 'pysco_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "need = {'pysco_tpu_torch.parallel.slab_mg', "
            "'pysco_tpu_torch.parallel.ic_slab', 'pysco_tpu_torch.main'}; "
            "assert need <= set(names), sorted(need - set(names)); "
            "bad = [m for m in sys.modules if m in ('jax', 'pysco_tpu') or "
            "m.startswith(('jax.', 'jaxlib', 'pysco_tpu.'))]; "
            "assert not bad, bad; print('ok', len(names))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=root)
    assert r.returncode == 0 and r.stdout.startswith("ok"), r.stderr[-2000:]

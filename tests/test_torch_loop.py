"""The run loop (``pysco_tpu_torch.main._loop``) against a fake stepper:
no physics, no JAX. The fake returns diagnostics that make every step's
drift bound ``Courant_factor`` cells, so the lazy re-binning levels, the
sorts, the overflow aborts and the outputs can be set from the test."""

import glob
import os

import numpy as np
import pytest
import torch

from pysco_tpu_torch import main as main_mod
from pysco_tpu_torch.integrate import StepDiagnostics
from pysco_tpu_torch.solver import SolverConfig

NCOARSE = 3
VEL = 100.0
# with acc = 0 and the velocity criterion the smallest, dt is
# Courant * dx / VEL and a step's drift bound VEL * dt * 2^NCOARSE cells
COURANT = 0.9
DT = COURANT * 0.5 ** NCOARSE / VEL
AEXP0 = 0.5


def _tables():
    """Background tables with t = ln a and D1 = a: tables[0] is ln a(t),
    tables[1] t(ln a), tables[3] D1(ln a)."""
    def ident(x):
        return np.asarray(x, np.float64)

    return [ident, ident, None, np.exp]


def _z_out(*steps):
    """Output redshifts ``steps`` full steps after the start."""
    return [1.0 / (AEXP0 * np.exp(n * DT)) - 1 for n in steps]


class FakeStepper:
    def __init__(self, max_drift, overflow_at=()):
        self.cfg = SolverConfig(theory="newton", ncoarse=NCOARSE,
                                npart=8, mass_scheme="cic",
                                linear_newton_solver="fft",
                                gradient_stencil_order=2)
        self.max_drift = max_drift
        self.overflow_at = set(overflow_at)
        self.calls = []
        self.nsteps = 0

    def _result(self, save_pk, overflow):
        pk = (torch.arange(1.0, 4.0), torch.ones(3), torch.ones(3)) \
            if save_pk else None
        return pk, StepDiagnostics(max_abs_acc=0.0, max_abs_vel=VEL,
                                   mean_additional=1.0, overflow=overflow)

    def first(self, save_pk, dyn):
        self.calls.append(("first", save_pk))
        return self._result(save_pk, 0)

    def step(self, save_pk, presorted, dyn, dt):
        self.nsteps += 1
        assert self.nsteps <= 20, "the loop does not reach its last output"
        self.calls.append(("step", self.nsteps, presorted))
        return self._result(save_pk, 7 if self.nsteps in self.overflow_at
                            else 0)

    def after_step(self, nsteps, presorted):
        self.calls.append(("after", nsteps, presorted))

    def rows(self):
        self.calls.append(("rows", self.nsteps))
        return np.full((8, 3), 0.5, np.float32), np.zeros((8, 3), np.float32)

    def overflow_text(self, presorted):
        return f"fake overflow at window {presorted}"


def _param(tmp_path):
    return {
        "ncoarse": NCOARSE, "Courant_factor": COURANT,
        "max_aexp_stepping": 10, "H0": 70.0, "Om_m": 0.3, "boxlen": 100.0,
        "npart": 8, "aexp": AEXP0, "aexp_old": AEXP0, "t": np.log(AEXP0),
        "nsteps": 0, "base": str(tmp_path), "extra": "fake",
        "output_snapshot_format": "npz", "theory": "newton",
    }


def _pk_steps(tmp_path):
    return sorted(int(os.path.basename(f)[-9:-4])
                  for f in glob.glob(f"{tmp_path}/power/pk_fake_*.dat"))


@pytest.mark.parametrize("case", [
    # bounds 0.9 cells a step: levels 1, 2, 3 after the first sort, then
    # 3.15 cells (the last step is half a step, onto the output) sorts
    dict(max_drift=3, z_out=(4.5,), drifts=[0, 1, 2, 3, 0]),
    # no window: a sort and the hook at every step
    dict(max_drift=0, z_out=(4.5,), drifts=[0, 0, 0, 0, 0]),
    # an overflow on a lazy step, and on a sorted one
    dict(max_drift=3, z_out=(4.5,), overflow_at=(3,), error=2),
    dict(max_drift=3, z_out=(4.5,), overflow_at=(5,), error=0),
    # two outputs: snapshots after steps 3 and 6, i_snap 1 then 2
    dict(max_drift=3, z_out=(2.5, 4.75), drifts=[0, 1, 2, 3, 0, 1],
         snapshots=[3, 6]),
], ids=["levels", "sort_every_step", "overflow_lazy", "overflow_sorted",
        "outputs"])
def test_loop_with_fake_stepper(tmp_path, case):
    stepper = FakeStepper(case["max_drift"], case.get("overflow_at", ()))
    param = _param(tmp_path)
    z_out = _z_out(*case["z_out"])
    if "error" in case:
        bad = case["overflow_at"][0]
        with pytest.raises(RuntimeError,
                           match=f"fake overflow at window {case['error']}: "
                                 "7 particles lost"):
            main_mod._loop(param, _tables(), z_out, "yes", stepper)
        # the P(k) of the first force evaluation and of every step before
        # the overflow, none of the step that overflowed
        assert _pk_steps(tmp_path) == list(range(bad))
        assert ("after", bad, case["error"]) not in stepper.calls
        return

    records = main_mod._loop(param, _tables(), z_out, "yes", stepper)
    drifts = case["drifts"]
    assert [r.nsteps for r in records] == list(range(1, len(drifts) + 1))
    assert [r.drift for r in records] == drifts
    assert all(r.overflow == 0 and r.seconds >= 0 for r in records)
    assert _pk_steps(tmp_path) == list(range(len(drifts) + 1))
    assert stepper.calls[0] == ("first", True)
    steps = [c for c in stepper.calls if c[0] == "step"]
    hooks = [c for c in stepper.calls if c[0] == "after"]
    assert [c[2] for c in steps] == [c[2] for c in hooks] == drifts
    assert [c[1] for c in hooks] == [r.nsteps for r in records]
    snapshots = case.get("snapshots", [len(drifts)])
    assert [c[1] for c in stepper.calls if c[0] == "rows"] == snapshots
    for i in range(1, len(snapshots) + 1):
        assert os.path.exists(
            f"{tmp_path}/output_{i:05d}/particles_fake.npz")
    assert param["i_snap"] == len(snapshots) + 1
    assert param["aexp"] == pytest.approx(1.0 / (1 + min(z_out)), rel=1e-12)

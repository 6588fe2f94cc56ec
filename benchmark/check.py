"""The comparison that decides ``correct``.

The simulation is chaotic, so no reference can follow a 512^3 run from
z = 49 to z = 0 particle by particle; the reference follows it step by
step from the program's own state, and checks the start by itself:

- ``ic_dx_cells``, ``ic_dv``: the 2LPT particles of a sample of lattice
  sites against the reference's from the same draw (largest position gap
  in cells, largest velocity gap over the sample's rms velocity);
- ``pm0_da``: the first force evaluation, at the same sampled particles
  (found in the tile-sorted state by their exact positions): the largest
  acceleration gap over the sample's rms acceleration;
- ``step_drho``, ``step_dmom``, ``step_dacc``: one step of the timed loop
  (the one that reaches the first output after the window closes), from
  the state the program held before it. Particle order is the program's
  own business, so the program's particles and the reference's are each
  deposited by ``pm.deposit`` (CIC, float64, whatever the configuration's
  mass scheme: the yardstick is the same in every cell) with weight 1,
  with each velocity component and with each acceleration component, and
  the grids compared: norm of the difference over the norm of the
  reference's density contrast, momentum or acceleration field;
- ``pk``: the P(k) the program computed at that output against the
  reference's P(k) of the program's own particles: the largest relative
  gap over the bins.

The control is the reference itself in bfloat16 put in the program's
place (:func:`control_outputs`); it must fail.

**A configuration's reference module.** The force model belongs to the
configuration: its file (``configs/<config>.json``) may name a module
with the top-level key ``"reference": "<module>"``, the file
``reference/<module>.py``, loaded as ``reference.<module>`` so that it may
import ``pm``, ``fas``, ``ics``, ``cosmology`` and ``precision`` relatively.
Without the key the module is ``pm``. It provides, with ``pm``'s
signatures (``prec`` a :class:`reference.precision.Precision`, ``scheme``
the mass scheme, ``"ngp"``, ``"cic"`` or ``"tsc"``):

- ``Forces(param, prec)``: reads the parameters and allocates nothing;
  raises ``NotImplementedError`` for a configuration it cannot follow,
  which is how :func:`reference_for` asks it, before the program's
  set-up. Its attributes ``prec``, ``scheme`` and ``p`` (the mass scheme's
  window exponent, 1, 2 or 3); called as ``forces(rho, aexp, u_start)``
  it returns ``(force (3, n, n, n), u)``, u the extra field the next
  solve starts from (None where there is none);
- ``density(pos, n, npart, prec, scheme)``: (n, n, n) density over its
  mean of (3, N) positions;
- ``gather(fields, pos, prec, scheme)``: (C, n, n, n) fields at (3, N)
  positions, (C, N);
- ``step(param, forces, pos, vel, acc, u, dt, aexp)``: one leapfrog step,
  ``(pos, vel, acc, rho, u)`` after it;
- ``power_spectrum(dens, p, prec)``: ``(k, Pk, Nmodes)``;
- optionally ``lpt2(param, seed, device, prec)``, the 2LPT particles at
  z_start, where the theory changes their growth (else ``ics.lpt2``).
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import torch

from reference import ics, pm
from reference.precision import BF16, F64, Precision

NAMES = ("ic_dx_cells", "ic_dv", "pm0_da", "step_drho", "step_dmom",
         "step_dacc", "pk")
SAMPLE = 65536
CONTRACT = ("Forces", "density", "gather", "step", "power_spectrum")


def sample_sites(seed: int, npart: int) -> np.ndarray:
    """The sampled lattice sites of a run: drawn from the seed, sorted."""
    rng = np.random.default_rng([seed, 7])
    return np.sort(rng.choice(npart, size=min(SAMPLE, npart),
                              replace=False))


def _hash(pos3: torch.Tensor) -> torch.Tensor:
    b = pos3.contiguous().view(torch.int32).to(torch.int64)
    return (b[0] * 1000003 + b[1]) * 1000033 + b[2]


def find_columns(columns: torch.Tensor, points: torch.Tensor):
    """Columns of a (4, N) state whose x, y, z equal, bit for bit, those of
    the (3, K) points: (column, point index) of each point found once."""
    h = _hash(columns[:3])
    hp = _hash(points)
    order = torch.argsort(hp)
    hps = hp[order]
    cols = torch.nonzero(torch.isin(h, hp)).squeeze(1)
    j = order[torch.searchsorted(hps, h[cols]).clamp(max=hps.numel() - 1)]
    ok = torch.all(columns[:3, cols] == points[:, j], dim=0)
    cols, j = cols[ok], j[ok]
    once = torch.bincount(j, minlength=points.shape[1]) == 1
    keep = once[j]
    return cols[keep], j[keep]


def _periodic_cells(a, b, n):
    d = torch.abs(a.double() - b.double())
    return torch.minimum(d, 1.0 - d) * n


def _rms(x):
    return float(torch.sqrt(torch.mean(x.double() ** 2)))


def _max_gap(a, b):
    return float(torch.max(torch.abs(a.double() - b.double())))


def reference_for(config_name: str, config: dict, param, here: Path):
    """The reference module of a configuration (``reference/<name>.py`` of
    the benchmark directory ``here``, loaded as ``reference.<name>``), once
    it has accepted the parameters as run; stops the run with the reason
    where it has not."""
    name = config.get("reference", "pm")
    path = here / "reference" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"configuration {config_name!r}: no reference "
                         f"module {name!r} (reference/{name}.py)")
    mod_spec = importlib.util.spec_from_file_location(f"reference.{name}",
                                                      path)
    ref = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(ref)
    missing = [k for k in CONTRACT if not callable(getattr(ref, k, None))]
    if missing:
        raise SystemExit(f"configuration {config_name!r}: reference module "
                         f"{name!r} lacks {', '.join(missing)}")
    try:
        ref.Forces(param, F64)
    except NotImplementedError as e:
        raise SystemExit(f"configuration {config_name!r}: reference module "
                         f"{name!r} refuses it: {e}") from None
    return ref


def _field_gap(pos_c, w_c, pos_r, w_r, n, contrast=False):
    g_c = pm.deposit(pos_c, n, w_c)
    g_r = pm.deposit(pos_r, n, w_r)
    num = float(torch.linalg.vector_norm(g_c - g_r))
    del g_c
    if contrast:
        g_r = g_r - g_r.mean()
    den = float(torch.linalg.vector_norm(g_r))
    return num / den if den > 0 else math.inf


class Held:
    """What the program produced, kept for the check: the sampled 2LPT
    particles, the sampled first accelerations, the checked step's input
    and output, and its P(k)."""

    def __init__(self):
        self.sites = None  # (K,) int64, lattice sites sampled
        self.ic_pos = self.ic_vel = None  # (3, K)
        self.pm0_sites = self.pm0_acc = None  # sites found, (3, k)
        self.step_in = None  # (pos, vel, acc, u) before the step
        self.step = None  # dt, aexp
        self.step_out = None  # (pos, vel, acc) after it
        self.pk = None  # (k, Pk, Nmodes)


def reference_numbers(param, seed: int, held: Held, device, cand: dict,
                      ref=pm) -> dict:
    """Each number of ``NAMES`` for the candidate outputs ``cand`` (the
    program's, from ``held``, or the control's) against the float64
    reference module ``ref``."""
    n = 2 ** int(param["ncoarse"])
    npart = int(param["npart"])
    out = {}
    sites = torch.as_tensor(held.sites, device=device)
    # the start: 2LPT, then the first force evaluation on it
    pos0, vel0 = getattr(ref, "lpt2", ics.lpt2)(param, seed, device, F64)
    out["ic_dx_cells"] = float(torch.max(_periodic_cells(
        cand["ic_pos"], pos0[:, sites], n)))
    vs = vel0[:, sites]
    out["ic_dv"] = _max_gap(cand["ic_vel"], vs) / _rms(vs)
    del vel0, vs
    forces = ref.Forces(param, F64)
    scheme = forces.scheme
    force, _ = forces(ref.density(pos0, n, npart, F64, scheme),
                      held.step["aexp0"])
    p0 = pos0[:, torch.as_tensor(cand["pm0_sites"], device=device)]
    del pos0
    a_ref = ref.gather(force, p0, F64, scheme)
    del force
    out["pm0_da"] = _max_gap(cand["pm0_acc"], a_ref) / _rms(a_ref)
    del a_ref, p0
    # one step of the loop from the program's state
    x0, v0, a0, u0 = held.step_in
    x1, v1, a1, _, _ = ref.step(param, forces, x0[:3], v0[:3], a0[:3], u0,
                                held.step["dt"], held.step["aexp"])
    xc, vc, ac = cand["step_out"]
    out["step_drho"] = _field_gap(xc, None, x1, None, n, contrast=True)
    out["step_dmom"] = max(_field_gap(xc, vc[i], x1, v1[i], n)
                           for i in range(3))
    out["step_dacc"] = max(_field_gap(xc, ac[i], x1, a1[i], n)
                           for i in range(3))
    del x1, v1, a1
    _, p_r, n_r = ref.power_spectrum(
        ref.density(xc, n, npart, F64, scheme), forces.p, F64)
    _, p_c, n_c = (torch.as_tensor(t, device=device).double()
                   for t in cand["pk"])
    gap = float(torch.max(torch.abs(p_c / p_r - 1.0)))
    if not torch.equal(n_c, n_r):
        gap = math.inf
    out["pk"] = gap
    return out


def program_outputs(held: Held) -> dict:
    return {"ic_pos": held.ic_pos, "ic_vel": held.ic_vel,
            "pm0_sites": held.pm0_sites, "pm0_acc": held.pm0_acc,
            "step_out": held.step_out, "pk": held.pk}


def control_outputs(param, seed: int, held: Held, device,
                    prec: Precision = BF16, ref=pm) -> dict:
    """The reference module ``ref`` computed in bfloat16, in the program's
    place: its own 2LPT, first force and step from the same inputs."""
    n = 2 ** int(param["ncoarse"])
    npart = int(param["npart"])
    sites = torch.as_tensor(held.sites, device=device)
    pos0, vel0 = getattr(ref, "lpt2", ics.lpt2)(param, seed, device, prec)
    out = {"ic_pos": pos0[:, sites].clone(),
           "ic_vel": vel0[:, sites].clone(), "pm0_sites": held.sites}
    del vel0
    forces = ref.Forces(param, prec)
    force, _ = forces(ref.density(pos0, n, npart, prec, forces.scheme),
                      held.step["aexp0"])
    out["pm0_acc"] = ref.gather(force, pos0[:, sites], prec, forces.scheme)
    del force, pos0
    x0, v0, a0, u0 = held.step_in
    x1, v1, a1, rho, _ = ref.step(param, forces, x0[:3], v0[:3], a0[:3], u0,
                                  held.step["dt"], held.step["aexp"])
    out["step_out"] = (x1, v1, a1)
    out["pk"] = ref.power_spectrum(rho, forces.p, prec)
    return out


def judge(numbers: dict, limits: dict):
    """(correct, [[name, number, limit], ...]) in the order of NAMES."""
    rows = [[k, numbers[k], limits[k]] for k in NAMES]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows

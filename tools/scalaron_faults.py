#!/usr/bin/env python3
"""Faults planted in the checked step of an f(R) or QUMOND cell.

    python3 tools/scalaron_faults.py --workload fr2tsc512.lazy --seed 7 \\
        [--z 10,1,0] [--device cpu --tiny]

Sets the cell up as ``benchmark/cell.py`` does, runs on to each output of
``--z`` and keeps the state before the step that reaches it. That step is
then run again with one fault planted in the program at a time, and
clean last, and each run is judged by the cell's check against its
limits. One JSON line a run (``FAULT``). The f(R) scalaron's faults:

- ``n1_root``: the FAS of n = 2's quartic run with the cubic's operator
  and roots (n = 1's);
- ``half_c2_x2``: the fifth-force factor c^2 in place of c^2 / 2;
- ``fbar_exponent_n``: f_R(a) with the exponent n in place of n + 1 (f1,
  f2, q and c^2 / 2 all move; at a = 1 it changes nothing);
- ``u_unchanged``: the scalaron solve returns the u it starts from, the
  previous step's.

With the Newton roots (``fR_root_solver = newton``), the polish's own:

- ``one_newton_step``: one float32 Newton step a colour update in place
  of three;
- ``guarded_at_seed``: the cells whose steps leave the root's bracket keep
  their seed, where the guard gives them the safe root (the sweep's twin
  in torch, on the card too: the kernel has no such mode);
- ``coarse_rhs_dropped``: the FAS rhs plane left out of c0 on the coarse
  levels (c0 = h^2 q there too).

QUMOND's (``mond_function = simple``):

- ``nu_one``: nu = 1 on every face, which is Newton's source (``mond.rhs``
  replaced by its plain form over nu = 1: on the card the kernel computes
  nu inside, so patching ``mond.nu_simple`` alone would not reach it);
- ``no_tangential``: the face's |g| from its normal component alone, the
  two tangential ones dropped;
- ``g0_exponent``: g0 scaled by a^exponent in place of a^(1 + exponent)
  (at a = 1 it changes nothing).

``--tiny`` runs 16^3 particles in a 64 Mpc/h box, for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def _newton_faults():
    import torch

    from pysco_tpu_torch.models import cubic, laplacian, quartic
    from pysco_tpu_torch.ops import stencil

    sweep = stencil.scalaron_half_sweep

    def one_step(src, dst, hb, coef, to_red, f_relax, n_power,
                 newton_iters=3):
        return sweep(src, dst, hb, coef, to_red, f_relax, n_power, 1)

    def at_seed(src, dst, hb, coef, to_red, f_relax, n_power,
                newton_iters=3):
        p = hb - stencil._INVSIX * stencil.packed_neighbour_sum(
            stencil._power(src, n_power), to_red)
        x, guarded = stencil.newton_root_plain(dst, p, coef, n_power,
                                               newton_iters)
        x = torch.where(guarded, dst, x)
        return dst + stencil._f32(f_relax) * (x - dst)

    def no_rhs(x, b, q, n_smoothing, rhs, exact_root, n_power):
        return laplacian.packed_scalaron_smoothing(x, b, q, n_smoothing,
                                                   None, exact_root, n_power)

    faults = {"one_newton_step": [(stencil, "scalaron_half_sweep", one_step)],
              "guarded_at_seed": [(stencil, "scalaron_half_sweep", at_seed)],
              "coarse_rhs_dropped": [(cubic, "packed_scalaron_smoothing",
                                      no_rhs),
                                     (quartic, "packed_scalaron_smoothing",
                                      no_rhs)],
              "clean": None}
    return faults


def _faults(theory: str, roots: str = "exact"):
    import numpy as np
    import torch

    from pysco_tpu_torch import solver
    from pysco_tpu_torch.models import mond, multigrid

    if theory == "fr" and roots == "newton":
        return _newton_faults()
    dyn = solver.compute_dynamics
    if theory == "mond":
        def g0_exponent(p):
            return dyn({**p, "mond_scale_factor_exponent": float(
                p["mond_scale_factor_exponent"]) - 1.0})

        def nu_one(phi, g0, mond_function, alpha):
            old = mond.nu_simple
            mond.nu_simple = torch.ones_like
            try:
                return mond.rhs_plain(phi, g0, mond_function, alpha)
            finally:
                mond.nu_simple = old

        def no_tangential(phi, g0, mond_function, alpha):
            n = phi.shape[-1]
            out = torch.zeros_like(phi)
            for a in range(3):
                g_a = mond._f32(n) * (phi - torch.roll(phi, 1, a))
                flux = torch.where(
                    g_a != 0, mond.nu_simple(torch.abs(g_a) / g0) * g_a, 0.0)
                out = out + mond._f32(n) * (torch.roll(flux, -1, a) - flux)
            return out

        return {
            "nu_one": (mond, "rhs", nu_one),
            "no_tangential": (mond, "rhs", no_tangential),
            "g0_exponent": (solver, "compute_dynamics", g0_exponent),
            "clean": None,
        }

    def half_c2_x2(p):
        d = dyn(p)
        return d._replace(fR_half_c2=float(np.float32(2 * d.fR_half_c2)))

    def exponent_n(p):
        return dyn({**p, "fR_n": int(p["fR_n"]) - 1})

    return {
        "n1_root": (multigrid, "fas_ops_quartic",
                    lambda q, exact_root=False: multigrid.fas_ops_cubic(
                        q, exact_root)),
        "half_c2_x2": (solver, "compute_dynamics", half_c2_x2),
        "fbar_exponent_n": (solver, "compute_dynamics", exponent_n),
        "u_unchanged": (solver, "_scalaron",
                        lambda cfg, density, u, dyn_, first_call: u),
        "clean": None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="fr2tsc512.lazy")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--z", default="10,1,0")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import cell
    import check

    here = cell.HERE
    w = cell.find_workload(cell.spec(), args.workload)
    config = cell.load_json(here / "configs" / f"{w['config']}.json")
    traffic = cell.load_json(here / "traffic" / f"{w['traffic']}.json")
    limits = cell.load_json(here / "limits" / f"{args.workload}.json")
    tiny = ({"ncoarse": 4, "npart": 16 ** 3, "boxlen": 64.0} if args.tiny
            else {})
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = os.path.join(tempfile.gettempdir(), "pysco_faults", args.workload)
    os.makedirs(base, exist_ok=True)
    param = cell._param(config, args.seed, base,
                        {**traffic["param"], **tiny}, here)
    param["z_out"] = list(param["z_out"])
    ref = check.reference_for(w["config"], config, param, here)
    sim, held, _ = cell._set_up(param, traffic, args.seed, dev, base)
    faults = _faults(str(param["theory"]).casefold(),
                     str(param.get("fR_root_solver", "exact")).casefold())

    def checked(name, z):
        sim.restore()
        saved = sim.saved[0]
        fault = faults[name]
        patches = [] if fault is None else (
            fault if isinstance(fault, list) else [fault])
        kept = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
        try:
            info = sim.step()
        finally:
            for mod, attr, old in kept:
                setattr(mod, attr, old)
        held.step_in = (saved[0], saved[1], saved[2], saved[4])
        held.step.update(dt=info["dt"], aexp=info["aexp"])
        held.step_out = (sim.position, sim.velocity, sim.acceleration)
        held.pk = info["pk"]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        nums = check.reference_numbers(param, args.seed, held, dev,
                                       check.program_outputs(held), ref)
        correct, rows = check.judge(nums, limits)
        held.step_in = held.step_out = held.pk = None
        print("FAULT", json.dumps({
            "z": z, "fault": name, "correct": correct,
            "fails": [k for k, v, lim in rows if not v <= lim],
            **{k: nums[k] for k in ("step_drho", "step_dmom", "step_dacc",
                                    "pk")}}), flush=True)

    for z in (float(s) for s in args.z.split(",")):
        steps = 0
        while True:  # keep the state before each step; stop on the output
            sim.save()
            info = sim.step()
            steps += 1
            if info["output"] and abs(info["aexp"] - 1 / (1 + z)) < 1e-9:
                break
            if sim.finished:
                raise SystemExit(f"no output at z = {z} after the last")
        print("REACHED", json.dumps({"z": z, "steps": steps}), flush=True)
        for name in faults:  # clean last: the run goes on from its state
            checked(name, z)
    return 0


if __name__ == "__main__":
    sys.exit(main())

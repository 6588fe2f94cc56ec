"""Packed states for the f(R) scalaron sweeps with the float64 closed-form
roots (``ops/stencil.py`` ``scalaron_exact_half_sweep``, n = 1, and
``scalaron_quartic_exact_half_sweep``, n = 2), shared by their CPU tests,
their card tests and ``chip_smoke.py``."""

import numpy as np
import torch

# d == 0 at p = -3: 54^2 = -108 (-3)^3
D1_Q = -54.0

# float32 p whose -3 p is an x where libdevice's pow(x, 1.5), built with
# --fmad=false, rounds 1 float64 ulp away from torch's (a card run of 50
# million x)
POW_CELLS = (-0.013906251639127731, -1.7390431139574503e-06,
             -0.006964995991438627, -0.00012206694373162463,
             -3.7129709653527243e-06)


def exact_states(n: int, device, seed: int = 11) -> dict:
    """Packed (n, n/2, n) float32 (src, dst, hb, rhs) states, by name, each
    with its d1_q:

    - ``branch`` at :data:`D1_Q`: src = 0, so p = hb exactly; p of both
      signs and of size 1e-3 .. 1e2 (d > 0 above p = -3, d < 0 below), and
      in the first cells p = 0 (dd == 0, as d1 < 0), p = -3 (d == 0) and
      p = NaN, where rhs is 0 (d1 = d1_q); rhs small elsewhere;
    - ``scalaron``: a scalaron-like state, src ~ 0.2, p of both signs, a
      small rhs;
    - ``pow`` at d1_q = -1e-9: src = 0, p cycling through
      :data:`POW_CELLS`, every cell on the trigonometric branch."""
    rng = np.random.default_rng(seed)
    shape = (n, n // 2, n)
    m = n * (n // 2) * n
    p = rng.choice([-1.0, 1.0], m) * 10.0 ** rng.uniform(-3, 2, m)
    rhs = 0.1 * rng.standard_normal(m)
    p[:3] = (0.0, -3.0, np.nan)
    rhs[:3] = 0.0
    branch = (np.zeros(shape), rng.random(shape), p.reshape(shape),
              rhs.reshape(shape))
    scalaron = (0.2 + 0.003 * np.abs(rng.standard_normal(shape)),
                0.2 + 0.003 * np.abs(rng.standard_normal(shape)),
                0.05 * rng.standard_normal(shape),
                1e-3 * rng.standard_normal(shape))
    pw = (np.zeros(shape), rng.random(shape),
          np.resize(np.array(POW_CELLS), shape),
          1e-12 * rng.standard_normal(shape))
    return {name: (tuple(torch.as_tensor(a.astype(np.float32), device=device)
                         for a in s), d1_q)
            for name, s, d1_q in (("branch", branch, D1_Q),
                                  ("scalaron", scalaron, D1_Q),
                                  ("pow", pw, -1e-9))}


# the quartic states' constant terms h^2 q: negative, as a simulation's, and
# positive, where the square root's argument turns negative without a rhs
C_Q = -1e-2
C_Q_POS = 1e-3


def quartic_branches(p: torch.Tensor, c) -> dict:
    """The cells of each branch of ``solution_quartic_equation`` (nested
    where: p == 0, then sqrt_term < 0, then Q + d0/Q not positive, then the
    sign of p) as bool masks, computed in float64 from the float32 p and c
    (a float or a float64 tensor)."""
    from pysco_tpu_torch.ops import stencil

    p = p.double()
    c = torch.as_tensor(c, dtype=torch.float64, device=p.device).expand(
        p.shape)
    d0 = 12.0 * c
    d1 = torch.where(p == 0.0, 1.0, 27.0 * p * p)
    ratio = d0 / d1
    st = 1.0 - 4.0 * d0 * (ratio * ratio)
    Q = stencil._cbrt(0.5 * d1 * (1.0 + torch.sqrt(torch.where(st < 0.0, 0.0,
                                                               st))))
    Q = torch.where(Q == 0.0, 1.0, Q)
    qdq = Q + d0 / Q
    zero = p == 0.0
    st_neg = ~zero & (st < 0.0)
    qdq_bad = ~zero & ~st_neg & ~(qdq > 0.0)
    main = ~zero & ~st_neg & ~qdq_bad
    return {"p_zero": zero, "sqrt_term_neg": st_neg, "qdq_not_pos": qdq_bad,
            "qdq_nan": qdq_bad & torch.isnan(qdq), "p_pos": main & (p > 0.0),
            "p_neg": main & (p < 0.0)}


def quartic_states(n: int, device, seed: int = 11) -> dict:
    """Packed (n, n/2, n) float32 (src, dst, hb, rhs) states for the
    quartic, by name, each with its c_q:

    - ``branch`` at :data:`C_Q`: src = 0, so p = hb exactly; p of both
      signs and of size 1e-3 .. 1e2, and on a quarter of the cells 1e-30 ..
      1e-3 (Q + d0/Q cancels to 0 or below); in the first cells p = 0 and p
      = NaN, where rhs is 0; rhs ~ 0.1, so that c = c_q - rhs turns positive
      and the square root's argument negative on some cells;
    - ``positive`` at :data:`C_Q_POS`: the same p, rhs ~ 1e-4: the square
      root's argument is negative where |p| is below ~1e-2, without the
      rhs too;
    - ``scalaron``: a scalaron-like state, src ~ 0.2, p of both signs,
      c_q = -0.05 h^2, a small rhs."""
    rng = np.random.default_rng(seed)
    shape = (n, n // 2, n)
    m = n * (n // 2) * n
    p = rng.choice([-1.0, 1.0], m) * 10.0 ** rng.uniform(-3, 2, m)
    tiny = rng.random(m) < 0.25
    p[tiny] *= 10.0 ** rng.uniform(-27, -5, m)[tiny]
    p[:2] = (0.0, np.nan)
    rhs = 0.1 * rng.standard_normal(m)
    rhs[:2] = 0.0
    branch = (np.zeros(shape), rng.random(shape), p.reshape(shape),
              rhs.reshape(shape))
    positive = (np.zeros(shape), rng.random(shape), p.reshape(shape),
                1e-3 * rhs.reshape(shape))
    scalaron = (0.2 + 0.003 * np.abs(rng.standard_normal(shape)),
                0.2 + 0.003 * np.abs(rng.standard_normal(shape)),
                0.05 * rng.standard_normal(shape),
                1e-4 * rng.standard_normal(shape))
    return {name: (tuple(torch.as_tensor(a.astype(np.float32), device=device)
                         for a in s), c_q)
            for name, s, c_q in (("branch", branch, C_Q),
                                 ("positive", positive, C_Q_POS),
                                 ("scalaron", scalaron, -0.05 / (n * n)))}


def quartic_off_cells(got, src, dst, hb, c_q, to_red, rhs=None) -> dict:
    """The cells where the quartic sweep's output ``got`` is not bitwise
    its twin's, and whether each is explained by libdevice's pow, built
    with --fmad=false, rounding a float64 ulp away from torch's: an off
    cell must lie within one float32 ulp of the twin, or equal bit for bit
    the twin's value with its cube root (``stencil._cbrt``) moved one
    float64 ulp up or down, which a cell whose Q + d0/Q cancels turns into
    another branch or a distant root. Returns {"off", "far", "explained"}
    counts (far: more than one float32 ulp)."""
    from pysco_tpu_torch.ops import stencil

    want = stencil.scalaron_quartic_exact_half_sweep_plain(
        src, dst, hb, c_q, to_red, 1.25, rhs)
    bits = got.view(torch.int32)
    ulps = (bits.long() - want.view(torch.int32).long()).abs()
    off = ulps > 0
    ok = ulps <= 1
    if bool((~ok).any()):
        cbrt = stencil._cbrt
        try:
            for to in (float("inf"), float("-inf")):
                stencil._cbrt = lambda v, to=to: torch.nextafter(
                    cbrt(v), torch.full_like(v, to))
                moved = stencil.scalaron_quartic_exact_half_sweep_plain(
                    src, dst, hb, c_q, to_red, 1.25, rhs)
                ok = ok | (bits == moved.view(torch.int32))
        finally:
            stencil._cbrt = cbrt
    return {"off": int(off.sum()), "far": int((ulps > 1).sum()),
            "explained": int((off & ok).sum())}

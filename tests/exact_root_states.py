"""Packed states for the f(R) n = 1 scalaron sweep with the float64
closed-form root (``ops/stencil.py`` ``scalaron_exact_half_sweep``), shared
by its CPU tests, its card tests and ``chip_smoke.py``."""

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

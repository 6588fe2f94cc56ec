"""Cells where the float32 Newton polish of the f(R) scalaron sweep leaves
its root's bracket, pinned from a CPU run of 32^3 particles in 32 Mpc/h
(1 Mpc/h cells) from z = 49 with the Newton roots, where, unguarded, the
FAS V-cycle diverges near a = 0.37-0.5; shared by the twin's CPU tests
(``test_torch_fr_newton_root.py``) and the kernel's card tests.

Each entry is a cell's (seed, p, c0), float32 values: the cell's u before
the colour update, p = h^2 b - sum_nb(u^k)/6 and c0 = h^2 q [- rhs]. In
``CUBIC`` (f(R) n = 1, CIC) and ``QUARTIC`` (n = 2, TSC), every guarded
cell of the run from a = 0.3 to 0.46, the first step from the seed meets
f' <= 1e-12 and the steps go below 0, or it flies above the bracket's top
(``stencil._bracket_top``, or twice the seed where that is higher).
"""

import numpy as np
import torch

CUBIC = (
    # a = 0.325, n = 32
    (0.1500461995601654, -0.04907947778701782, -0.021620821207761765),
    # a = 0.367, n = 32
    (0.12835676968097687, -0.020151332020759583, -0.013148815371096134),
    # a = 0.367, n = 32
    (0.223312109708786, -0.10235729813575745, -0.013148815371096134),
    # a = 0.367, n = 32
    (0.22611306607723236, -0.10933388769626617, -0.013148815371096134),
    # a = 0.403, n = 32
    (0.15497633814811707, -0.05193750560283661, -0.009480686858296394),
    # a = 0.403, n = 32
    (0.1275705099105835, -0.08324165642261505, -0.009480686858296394),
    # a = 0.403, n = 32
    (0.14317095279693604, -0.043260008096694946, -0.009480686858296394),
    # a = 0.444, n = 32
    (0.11096814274787903, -0.04969928413629532, -0.007258244790136814),
    # a = 0.444, n = 32
    (0.039768870919942856, 0.01241140067577362, -0.007258244790136814),
)
QUARTIC = (
    # a = 0.325, n = 32
    (0.31629204750061035, 0.017731130123138428, -0.07020989060401917),
    # a = 0.325, n = 32
    (0.24512633681297302, 0.05721840262413025, -0.07020989060401917),
    # a = 0.325, n = 32
    (0.2863430380821228, 0.03865273296833038, -0.07020989060401917),
    # a = 0.367, n = 32
    (0.2795411944389343, -0.0005673989653587341, -0.03336580842733383),
    # a = 0.367, n = 32
    (0.2068457156419754, -0.030249938368797302, -0.03336580842733383),
    # a = 0.367, n = 32
    (0.22498860955238342, 0.02827930450439453, -0.03336580842733383),
    # a = 0.367, n = 32
    (0.2566837668418884, 0.001534104347229004, -0.03336580842733383),
    # a = 0.403, n = 32
    (0.1769544780254364, 0.016208142042160034, -0.020244671031832695),
    # a = 0.403, n = 32
    (0.22768013179302216, 0.010470055043697357, -0.020244671031832695),
    # a = 0.403, n = 32
    (0.3452916741371155, -0.140777587890625, -0.020244671031832695),
    # a = 0.403, n = 32
    (0.21945752203464508, -0.010997265577316284, -0.020244671031832695),
    # a = 0.403, n = 32
    (0.275923490524292, -0.06258586049079895, -0.020244671031832695),
    # a = 0.403, n = 32
    (0.19392894208431244, 0.0015829205513000488, -0.020244671031832695),
    # a = 0.403, n = 32
    (0.1651402711868286, 0.03346511721611023, -0.020244671031832695),
    # a = 0.403, n = 32
    (0.16967611014842987, 0.03412030637264252, -0.020244671031832695),
    # a = 0.403, n = 32
    (0.150191068649292, 0.017967335879802704, -0.020244671031832695),
    # a = 0.403, n = 32
    (0.13008950650691986, 0.04587458074092865, -0.020244671031832695),
    # a = 0.403, n = 32
    (0.23085148632526398, -0.0060171037912368774, -0.020244671031832695),
    # a = 0.444, n = 32
    (0.21078373491764069, 0.00680425763130188, -0.013305709697306156),
    # a = 0.444, n = 32
    (0.19534577429294586, 3.7401914596557617e-06, -0.013305709697306156),
    # a = 0.444, n = 32
    (0.23118901252746582, -0.06321105360984802, -0.013305709697306156),
    # a = 0.444, n = 32
    (0.22323337197303772, -0.03208334743976593, -0.013305709697306156),
    # a = 0.444, n = 32
    (0.268225759267807, -0.06625959277153015, -0.013305709697306156),
    # a = 0.444, n = 32
    (0.20383761823177338, 0.003995448350906372, -0.013305709697306156),
    # a = 0.444, n = 32
    (0.29697683453559875, -0.06144031137228012, -0.013305709697306156),
    # a = 0.444, n = 32
    (0.17777374386787415, -0.03483996540307999, -0.013305709697306156),
    # a = 0.444, n = 32
    (0.2119561731815338, 0.006065696477890015, -0.013305709697306156),
)


PINNED = {2: CUBIC, 3: QUARTIC}


def pinned_cells(power: int, device="cpu"):
    """(seed, p, c0) of the pinned cells, float32 tensors of one row."""
    seed, p, c0 = (torch.as_tensor(np.array(v, dtype=np.float32),
                                   device=device)
                   for v in zip(*PINNED[power]))
    return seed, p, c0


def packed_state(power: int, n: int, device="cpu", seed: int = 3):
    """A packed (n, n/2, n) sweep input (src, dst, hb, coef plane) holding
    the pinned cells of ``power``, and the flat indices they sit at. src is
    0, so a cell's p is hb exactly; elsewhere each cell is an in-bracket
    polish: c0 in [-0.02, -0.005], p in [-0.01, -0.001] and the seed 0.9 to
    1.5 times the cell's root."""
    from pysco_tpu_torch.ops import stencil

    rng = np.random.default_rng(seed)
    shape = (n, n // 2, n)
    cells = n * (n // 2) * n
    p, c0, scale = (torch.as_tensor(a.astype(np.float32), device=device)
                    for a in (rng.uniform(-0.01, -0.001, cells),
                              rng.uniform(-0.02, -0.005, cells),
                              rng.uniform(0.9, 1.5, cells)))
    root = (stencil.solution_cubic_equation(p, 27.0 * c0.double())
            if power == 2 else
            stencil.solution_quartic_equation(p, c0.double()))
    dst = (root * scale.double()).float()
    pins = pinned_cells(power, device)
    at = np.sort(rng.choice(cells, size=len(PINNED[power]), replace=False))
    where = torch.as_tensor(at, device=device)
    for t, v in zip((dst, p, c0), pins):
        t[where] = v
    src = torch.zeros(shape, device=device)
    return (src,) + tuple(t.reshape(shape) for t in (dst, p, c0)), at

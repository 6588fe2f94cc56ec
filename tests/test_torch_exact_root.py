"""The f(R) n = 1 scalaron sweep with the float64 closed-form root
(``ops/stencil.py`` ``scalaron_exact_half_sweep``) on the CPU: the closed
form and the sweep's plain twin against the JAX package's
``solution_cubic_equation`` on every branch of the closed form, and the CPU
path launches and counts nothing. The kernel itself is checked against the
twin on the card in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pysco_tpu.models import cubic as jcubic
from pysco_tpu_torch.models import cubic, laplacian as lap
from pysco_tpu_torch.ops import stencil
from pysco_tpu_torch.utils import profiling

from exact_root_states import D1_Q, exact_states

torch.set_num_threads(1)


def _branch_case(seed, with_rhs, n=16):
    """The branch state's (src, dst, hb, rhs or None) and d1 per cell
    (float64, flat): src = 0, so p = hb."""
    (src, dst, hb, rhs), d1_q = exact_states(n, "cpu", seed)["branch"]
    r = rhs if with_rhs else None
    d1 = d1_q - 27.0 * (rhs.double().reshape(-1) if with_rhs
                        else torch.zeros(hb.numel(), dtype=torch.float64))
    return src, dst, hb, r, d1


def _jax_roots(p, d1):
    return torch.as_tensor(np.array(jcubic.solution_cubic_equation(
        jnp.asarray(p.numpy()), jnp.asarray(d1.numpy()))))


@pytest.mark.parametrize("with_rhs", [False, True])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_closed_form_matches_jax_on_every_branch(seed, with_rhs):
    """The closed form on the branch state, cells with d > 0, d < 0, d ==
    0, dd == 0 and a NaN p: the JAX package's roots to float64 rounding
    (pow-based cube roots against cbrt), amplified by |d1| / |dd| where dd
    = d1 + sqrt(d) cancels (Cardano at d1 < 0 and small p, in both
    packages); the NaN cell on the d == 0 root -cbrt(d1)/3, as both nested
    wheres take it."""
    _, _, hb, _, d1 = _branch_case(seed, with_rhs)
    p = hb.double().reshape(-1)
    d = d1 * d1 + 108.0 * (p * p * p)
    assert int((d > 0).sum()) > 100 and int((d < 0).sum()) > 100
    assert float(d[0]) > 0 and float(d1[0] + torch.sqrt(d[0])) == 0.0
    assert float(d[1]) == 0.0 and torch.isnan(d[2])
    got = stencil.solution_cubic_equation(p, d1)
    want = _jax_roots(p, d1)
    assert torch.isfinite(got).all()
    dd = (d1 + torch.sqrt(d)).abs()
    amp = torch.where((d > 0) & (dd > 0), d1.abs() / dd, 1.0).clamp(min=1.0)
    assert ((got - want).abs() <= 1e-13 * amp * want.abs() + 1e-15).all()
    root0 = float(-(1.0 / 3.0) * stencil._cbrt(
        torch.tensor(D1_Q, dtype=torch.float64)))
    assert float(got[0]) == float(want[0]) == root0  # dd == 0
    assert float(got[2]) == float(want[2]) == root0  # NaN


@pytest.mark.parametrize("with_rhs", [False, True])
def test_exact_twin_on_every_branch(with_rhs):
    """The twin (the wrapper's CPU path) on the branch state, both
    colours: bitwise the relaxation dst + 1.25 (root - dst) in float32 of
    the JAX package's roots cast to float32, on every cell where those
    cast as torch's do (all but the few where dd cancels)."""
    src, dst, hb, r, d1 = _branch_case(11, with_rhs)
    p = hb.double().reshape(-1)
    root = _jax_roots(p, d1).to(torch.float32)
    own = stencil.solution_cubic_equation(p, d1).to(torch.float32)
    same = root.view(torch.int32) == own.view(torch.int32)
    assert int((~same).sum()) <= hb.numel() // 100
    old = dst.reshape(-1)
    want = old + stencil._f32(lap.F_RELAX) * (root - old)
    for to_red in (True, False):
        got = stencil.scalaron_exact_half_sweep(src, dst, hb, D1_Q, to_red,
                                                lap.F_RELAX, r).reshape(-1)
        assert torch.isfinite(got).all()
        assert torch.equal(got[same].view(torch.int32),
                           want[same].view(torch.int32))


def test_exact_smoothing_launches_and_counts_nothing_on_the_cpu():
    """cubic.smoothing with exact roots on the CPU runs the twin: no
    launch; a profiled step counts its colour updates under
    ``exact_root_sweeps`` as on the card, 2 a sweep."""
    n = 8
    rng = np.random.default_rng(3)
    x = torch.as_tensor((0.2 + 0.01 * rng.random((n, n, n))).astype(
        np.float32))
    b = torch.as_tensor(rng.standard_normal((n, n, n)).astype(np.float32))
    stencil.reset_launches()
    profiling.reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.step_span(x):
                cubic.smoothing(x, b, -0.1, 2, exact_root=True)
                cubic.smoothing(x, b, -0.1, 2, rhs=1e-3 * b,
                                exact_root=True)
        (root,) = [r for r in profiling.span_records()
                   if r["name"] == "step"]
        assert root["counters"]["exact_root_sweeps"] == 2 * (2 + 2)
    finally:
        profiling.reset_spans()
    assert stencil.LAUNCHES["scalaron_exact_half_sweep"] == 0
    assert all(v == 0 for v in stencil.LAUNCHES.values())


def test_exact_sweep_rejects_other_devices():
    x = torch.zeros((8, 4, 8))
    with pytest.raises(ValueError, match="no kernel for devices"):
        stencil.scalaron_exact_half_sweep(x, x.to("meta"), x, -1.0, True,
                                          1.25)

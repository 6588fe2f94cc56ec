"""The f(R) n = 2 scalaron sweep with the float64 closed-form quartic root
(``ops/stencil.py`` ``scalaron_quartic_exact_half_sweep``) on the CPU: the
sweep's plain twin against the torch colour update that
``laplacian.packed_scalaron_smoothing`` ran before the kernel took it over,
bit for bit, on every branch of the closed form; the CPU path launches
nothing and counts its colour updates; the wrapper's refusals. The kernel
itself is checked against the twin on the card in
``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pysco_tpu_torch.models import laplacian as lap, quartic
from pysco_tpu_torch.ops import stencil
from pysco_tpu_torch.utils import profiling

from exact_root_states import (quartic_branches, quartic_off_cells,
                               quartic_states)

torch.set_num_threads(1)

STATES = ("branch", "positive", "scalaron")


def _removed_route(src, dst, hb, c_q, to_red, rhs):
    """The colour update of the quartic's exact roots as the smoothing ran
    it in torch: float64 coefficient plane, the closed form on the packed
    neighbour sum of src^3, cast to float32, relaxed."""
    coef = c_q if rhs is None else c_q - rhs.double()
    p = hb - lap._INVSIX * lap.packed_neighbour_sum(src * src * src, to_red)
    x_new = quartic.solution_quartic_equation(p, coef).to(torch.float32)
    return dst + lap._f32(lap.F_RELAX) * (x_new - dst)


def _p(src, hb, to_red):
    return hb - lap._INVSIX * lap.packed_neighbour_sum(src * src * src,
                                                      to_red)


@pytest.mark.parametrize("with_rhs", [False, True])
def test_quartic_states_reach_every_branch(with_rhs):
    """Between them the states put cells on each branch of the closed
    form, with and without the rhs plane: p == 0, sqrt_term < 0, Q + d0/Q
    not positive (a NaN included), and the resolvent-cubic root for p of
    either sign."""
    seen = dict.fromkeys(("p_zero", "sqrt_term_neg", "qdq_not_pos",
                          "qdq_nan", "p_pos", "p_neg"), 0)
    for (src, _, hb, rhs), c_q in quartic_states(16, "cpu").values():
        c = c_q - rhs.double() if with_rhs else c_q
        for to_red in (True, False):
            for k, m in quartic_branches(_p(src, hb, to_red), c).items():
                seen[k] += int(m.sum())
    assert all(v > 0 for v in seen.values()), seen
    # the Q + d0/Q cells other than the NaN: a cancellation to 0 or below
    assert seen["qdq_not_pos"] > seen["qdq_nan"]


@pytest.mark.parametrize("to_red", [True, False])
@pytest.mark.parametrize("with_rhs", [False, True])
@pytest.mark.parametrize("name", STATES)
def test_quartic_twin_is_the_removed_route(name, with_rhs, to_red):
    """The twin (the wrapper's CPU path) equals the removed torch colour
    update bit for bit, NaN cells included, and is finite wherever p and
    c are."""
    (src, dst, hb, rhs), c_q = quartic_states(16, "cpu")[name]
    r = rhs if with_rhs else None
    got = stencil.scalaron_quartic_exact_half_sweep(src, dst, hb, c_q,
                                                    to_red, lap.F_RELAX, r)
    want = _removed_route(src, dst, hb, c_q, to_red, r)
    assert got.dtype == torch.float32 and got.shape == dst.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    finite = torch.isfinite(_p(src, hb, to_red))
    assert torch.isfinite(got[finite]).all()


def test_quartic_roots_solve_the_quartic():
    """On the resolvent branch the closed form's root solves u^4 + p u +
    c = 0 to float64 rounding (relative to the terms' size), and the
    fallback is |c|^(1/4)."""
    (src, _, hb, rhs), c_q = quartic_states(16, "cpu")["branch"]
    p = _p(src, hb, True).double()
    c = c_q - rhs.double()
    u = stencil.solution_quartic_equation(p, c)
    br = quartic_branches(p, c)
    main = (br["p_pos"] | br["p_neg"]) & (p.abs() > 1e-2)
    resid = u ** 4 + p * u + c
    scale = u ** 4 + (p * u).abs() + c.abs()
    assert int(main.sum()) > 100
    assert (resid[main].abs() <= 1e-10 * scale[main]).all()
    fb = br["p_zero"] | br["sqrt_term_neg"] | br["qdq_not_pos"]
    assert torch.equal(u[fb], c[fb].abs() ** 0.25)


def test_quartic_exact_smoothing_launches_nothing_and_counts_on_the_cpu():
    """quartic.smoothing with exact roots on the CPU runs the twin: no
    launch; a profiled step counts its colour updates under
    ``exact_root_sweeps``, 2 a sweep, and the result is the twin's."""
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
                got = quartic.smoothing(x, b, -0.1, 2, exact_root=True)
                quartic.smoothing(x, b, -0.1, 3, rhs=1e-3 * b,
                                  exact_root=True)
        (root,) = [r for r in profiling.span_records()
                   if r["name"] == "step"]
        assert root["counters"]["exact_root_sweeps"] == 2 * (2 + 3)
    finally:
        profiling.reset_spans()
    assert all(v == 0 for v in stencil.LAUNCHES.values())
    # the same two sweeps by the removed route on the packed halves
    c_q = 1.0 / (n * n) * -0.1
    red, black = lap.pack_rb(x)
    hb_r, hb_b = lap.pack_rb(lap._f32(1.0 / (n * n)) * b)
    for _ in range(2):
        red = _removed_route(black, red, hb_r, c_q, True, None)
        black = _removed_route(red, black, hb_b, c_q, False, None)
    assert torch.equal(got, lap.unpack_rb(red, black))


def test_quartic_exact_sweep_rejects_other_devices():
    x = torch.zeros((8, 4, 8))
    with pytest.raises(ValueError, match="no kernel for devices"):
        stencil.scalaron_quartic_exact_half_sweep(x, x.to("meta"), x, -1.0,
                                                  True, 1.25)


@pytest.mark.parametrize("n, match", [(6, "multiple of 4"),
                                      (10, "multiple of 4"),
                                      (7, "even")])
def test_quartic_exact_sweep_checks_before_launching(monkeypatch, n, match):
    """The wrapper's checks on the kernel's path run before the kernel
    library is touched: a grid size the kernel's float4s cannot take is
    refused (the CPU tensors stand in for the card's here)."""
    monkeypatch.setattr(stencil, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(stencil, "_kernels", lambda: pytest.fail(
        "the kernel library was reached"))
    x = torch.zeros((n, n // 2, n))
    with pytest.raises(ValueError, match=match):
        stencil.scalaron_quartic_exact_half_sweep(x, x, x, -1.0, True, 1.25)


def test_quartic_exact_sweep_refuses_a_misaligned_tensor(monkeypatch):
    monkeypatch.setattr(stencil, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(stencil, "_kernels", lambda: pytest.fail(
        "the kernel library was reached"))
    n = 8
    x = torch.zeros((n, n // 2, n))
    odd = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        stencil.scalaron_quartic_exact_half_sweep(x, x, x, -1.0, True, 1.25,
                                                  rhs=odd)


def test_off_cell_rule_explains_a_moved_cube_root_alone(monkeypatch):
    """The rule the card test holds the kernel to (``quartic_off_cells``):
    a sweep whose cube root is one float64 ulp off, as libdevice's pow
    built with --fmad=false can be, is explained on every cell it moves,
    cancelling cells included; a wrong root on one cell is not."""
    (src, dst, hb, rhs), c_q = quartic_states(64, "cpu")["branch"]
    cbrt = stencil._cbrt
    monkeypatch.setattr(stencil, "_cbrt", lambda v: torch.nextafter(
        cbrt(v), torch.full_like(v, float("inf"))))
    moved = stencil.scalaron_quartic_exact_half_sweep(src, dst, hb, c_q, True,
                                                      lap.F_RELAX, rhs)
    monkeypatch.setattr(stencil, "_cbrt", cbrt)
    k = quartic_off_cells(moved, src, dst, hb, c_q, True, rhs)
    assert k["far"] > 0 and k["explained"] == k["off"], k
    wrong = stencil.scalaron_quartic_exact_half_sweep(src, dst, hb, c_q, True,
                                                      lap.F_RELAX, rhs)
    wrong.view(-1)[5] = wrong.view(-1)[5] * 1.001 + 1e-3
    k = quartic_off_cells(wrong, src, dst, hb, c_q, True, rhs)
    assert k == {"off": 1, "far": 1, "explained": 0}

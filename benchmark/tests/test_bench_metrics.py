"""The yardstick's byte counts against PERF.md's kernel table, and the
metric readers on a made-up trace."""

from types import SimpleNamespace

import pytest

import cell
import yardstick


def _ms(nbytes):
    return nbytes / yardstick.HBM_BYTES_PER_S * 1e3


@pytest.mark.parametrize("n, kernel, want", [
    (256, "deposit", 0.080), (256, "gather", 0.180), (512, "gather", 1.443),
    (256, "scalaron", 0.040), (512, "scalaron", 0.321)])
def test_bounds_are_perf_md_kernel_table(n, kernel, want):
    """PERF.md's bound column (each operand read once, each output written
    once, over 3.35 TB/s), n^3 particles on an n^3 grid, to the table's
    last digit: the 512^3 gather counts 4.832e9 bytes, 1.4424 ms, which
    the table gives as 1.443."""
    nbytes = {"deposit": yardstick.deposit_bytes(n ** 3, n),
              "gather": yardstick.gather_bytes(n ** 3, n),
              "scalaron": yardstick.scalaron_sweep_bytes(n)}[kernel]
    assert abs(_ms(nbytes) - want) <= 0.0011


def test_scalaron_plane_coefficient_reads_one_more_half_lattice():
    assert (yardstick.scalaron_sweep_bytes(64, True)
            - yardstick.scalaron_sweep_bytes(64)) == 4 * 64 ** 3 // 2


def _ctx(**kw):
    base = dict(steps=10, window_s=2.0, setup_s=12.5, spans=0,
                program_peak_bytes=3 * 2 ** 30, ic_s=1.25, npart=64 ** 3,
                n=64, launches={"deposit": 10, "gather": 10},
                stats={"solves": 20, "cycles": 50, "fas_solves": 10,
                       "fas_cycles": 30},
                busy_s=1.5, traced_s=2.0, kernels={})
    base.update(kw)
    return SimpleNamespace(**base)


def _read(name, ctx):
    return cell.metric_reader(name)(ctx)


def test_end_to_end_readers():
    ctx = _ctx()
    assert _read("step_ms", ctx) == pytest.approx(200.0)
    assert _read("peak_mem_gib", ctx) == pytest.approx(3.0)
    assert _read("setup_s", ctx) == 12.5
    assert _read("ic_s", ctx) == 1.25


def test_counter_readers():
    ctx = _ctx()
    assert _read("vcycles_per_solve.fas", ctx) == pytest.approx(3.0)
    assert _read("vcycles_per_solve.poisson", ctx) == pytest.approx(2.0)
    none = _ctx(stats={"solves": 0, "cycles": 0, "fas_solves": 0,
                       "fas_cycles": 0})
    assert _read("vcycles_per_solve.fas", none) is None
    assert _read("vcycles_per_solve.poisson", none) is None


def test_trace_readers():
    dep = yardstick.deposit_bytes(64 ** 3, 64)
    sec = 10 * dep / yardstick.HBM_BYTES_PER_S * 4  # a quarter of the bound
    kernels = {
        "(anonymous namespace)::deposit_tiles(float const*)": (sec / 2, 40),
        "(anonymous namespace)::deposit_tiles(float const*) ": (sec / 2, 40),
        "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<>": (0.02,
                                                                      8),
        "void regular_fft<512u>": (0.01, 4), "vector_fft_r2c<>": (0.01, 4),
    }
    ctx = _ctx(kernels=kernels)
    assert _read("deposit_roofline", ctx) == pytest.approx(25.0)
    assert _read("sort_ms_per_step", ctx) == pytest.approx(2.0)
    assert _read("fft_ms_per_step", ctx) == pytest.approx(2.0)
    assert _read("device_idle_pct", ctx) == pytest.approx(25.0)
    # a kernel that did not run gives no reading, never 0
    assert _read("gather_roofline", ctx) is None
    assert _read("deposit_roofline", _ctx()) is None

"""The check must come out false when the timed path is broken, and its
control must fail it.

On the CPU (16^3, the harness's look for a card skipped): a step that
returns its state unchanged; half of the particles left out of the
deposit, the density scaled up for the rest; a P(k) altered where it is
produced. One chip holds the whole state, so there is no exchange
between chips to leave out. On a card (``cuda``): the control, the
reference in bfloat16 in the program's place, at 64^3 on three seeds."""

import pytest
import torch

import cell
from pysco_tpu_torch import integrate
from pysco_tpu_torch.ops import fourier, mesh, tiled_pm

TINY = {"ncoarse": 4, "npart": 16 ** 3, "boxlen": 64.0}
SEED = 987654321


def _run(workload="newton512.lazy", **kw):
    return cell.run_cell(workload, SEED, 0.5, False, "cpu",
                         overrides=dict(TINY, **kw))


def _failed(res):
    return {k for k, (v, lim) in res["checks"].items() if not v <= lim}


def test_sound_run_is_correct():
    assert _run()["correct"] is True


def test_unsupported_configuration_refused_before_set_up(no_set_up):
    """QUMOND with no reference module of its own: ``pm`` refuses it
    before the program builds its initial conditions."""
    with pytest.raises(SystemExit, match="configuration 'newton_fft_cic_512'"
                       ": reference module 'pm' refuses it: mond/multigrid"):
        _run(theory="mond", linear_newton_solver="multigrid")


def test_state_left_unchanged(monkeypatch):
    real = integrate.step_lazy_impl

    def unchanged(cfg, integrator, presorted, save_pk, position, velocity,
                  acceleration, potential, u, tstarts, dyn, dt):
        out = real(cfg, integrator, presorted, save_pk, position, velocity,
                   acceleration, potential, u, tstarts, dyn, dt)
        diag = integrate._diagnostics(acceleration, velocity, u, 0)
        return (position, velocity, acceleration, potential, u,
                out[5] if tstarts is None else tstarts, out[6], diag)

    monkeypatch.setattr(integrate, "step_lazy_impl", unchanged)
    res = _run()
    assert res["correct"] is False
    assert _failed(res) & {"step_drho", "step_dmom", "step_dacc"}


def test_half_of_the_particles_left_out(monkeypatch):
    def half(position_sorted, tile_starts, ncells_1d, scheme, drift=0,
             zbs=None):
        n = position_sorted.shape[1] // 2
        rows = position_sorted[:3, :n].T.contiguous()
        return 2.0 * mesh.deposit(rows, ncells_1d, scheme)

    monkeypatch.setattr(tiled_pm, "deposit", half)
    res = _run()
    assert res["correct"] is False
    assert {"pm0_da", "step_dacc"} <= _failed(res)


def test_power_spectrum_altered(monkeypatch):
    real = fourier.power_spectrum

    def altered(xk, p):
        k, pk, nm = real(xk, p)
        pk = pk.clone()
        pk[2] *= 1.01
        return k, pk, nm

    monkeypatch.setattr(fourier, "power_spectrum", altered)
    res = _run()
    assert res["correct"] is False
    assert _failed(res) == {"pk"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["newton512.lazy", "fr512.lazy"])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 5, 77777])
def test_control_fails_every_number(cuda, workload, seed):
    res = cell.run_cell(workload, seed, 2.0, False, "cuda",
                        overrides={"ncoarse": 6, "npart": 64 ** 3,
                                   "boxlen": 62.5}, control=True)
    assert res["correct"] is True
    for name, (_, limit) in res["checks"].items():
        assert res["control_numbers"][name] > limit, name
    torch.cuda.empty_cache()

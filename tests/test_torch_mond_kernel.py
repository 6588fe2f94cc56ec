"""The QUMOND source's CUDA kernel (``csrc/mond_source.cu``) behind
``models/mond.rhs``: on the CPU the wrapper is its plain PyTorch form,
``rhs_plain``, and refuses other devices; on a card (the tests marked
``cuda``, which skip where torch sees no CUDA device) every call launches
the kernel, bitwise ``rhs_plain`` for the simple nu.

The file imports no JAX; on a machine without it run it without the
conftest:

    python -m pytest --noconftest -q tests/test_torch_mond_kernel.py
"""

import numpy as np
import pytest
import torch

from pysco_tpu_torch.models import mond
from pysco_tpu_torch.ops import stencil

# alpha for each family: n = 3 and gamma, delta = 1.5 take torch's powf
# path (no exponent torch computes apart)
FAMILIES = (("simple", 1.0), ("n", 3.0), ("beta", 1.0), ("gamma", 1.5),
            ("delta", 1.5))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _potential(shape, seed, device="cpu"):
    """A smooth seeded random potential, float32, max |phi| = 1: white
    noise over k^2.5 (periodic on each axis by its own length)."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(shape, generator=g, dtype=torch.float64, device=device)
    k = [torch.fft.fftfreq(n, dtype=torch.float64, device=device) * n
         for n in shape]
    k2 = (k[0][:, None, None] ** 2 + k[1][None, :, None] ** 2
          + k[2][None, None, :] ** 2)
    k2[0, 0, 0] = 1.0
    phi = torch.fft.ifftn(torch.fft.fftn(w) / k2 ** 1.25).real
    return (phi / phi.abs().max()).float()


def _g0(phi, scale):
    """g0 at ``scale`` x the median normal face gradient |g| (float32)."""
    n = phi.shape[-1]
    g = torch.stack([n * (phi - torch.roll(phi, 1, a)) for a in range(3)])
    return float(np.float32(float(g.abs().flatten()[::7].median()) * scale))


def _launches(phi, g0, family="simple", alpha=1.0):
    stencil.reset_launches()
    got = mond.rhs(phi, g0, family, alpha)
    launched = dict(stencil.LAUNCHES)
    stencil.reset_launches()
    return got, launched


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,alpha", FAMILIES)
def test_rhs_on_the_cpu_is_the_plain_form(family, alpha):
    """A CPU tensor takes ``rhs_plain``, bit for bit, and launches
    nothing."""
    phi = _potential((16, 12, 20), 4)
    g0 = _g0(phi, 1.0)
    got, launched = _launches(phi, g0, family, alpha)
    assert torch.equal(got, mond.rhs_plain(phi, g0, family, alpha))
    assert all(v == 0 for v in launched.values())


@pytest.mark.parametrize("case", ["meta", "mixed"])
def test_rhs_refuses_other_devices(case):
    """No kernel for a ``meta`` tensor or for a mix of devices (a CPU
    potential with g0 a tensor elsewhere): the error names what it got."""
    phi = torch.zeros((8, 8, 8))
    g0 = 0.5
    if case == "meta":
        phi = phi.to("meta")
        want = r"mond\.rhs: no kernel for devices \['meta'\]"
    else:
        g0 = torch.tensor(0.5, device="meta")
        want = r"mond\.rhs: no kernel for devices \['cpu', 'meta'\]"
    with pytest.raises(ValueError, match=want):
        mond.rhs(phi, g0, "simple", 1.0)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1e3, 1.0, 1e-3])
@pytest.mark.parametrize("n", [64, 128])
def test_kernel_is_bitwise_the_plain_form(cuda, n, scale):
    """Smooth potentials at g0 = scale x the median |g| (y from 1e-8 to
    7e3 over the three scales, as ``test_source_matches_the_reference``):
    the kernel launches once and equals ``rhs_plain`` on the card bit for
    bit (the plain form's operations in its order, --fmad=false)."""
    phi = _potential((n, n, n), n + 1, cuda)
    g0 = _g0(phi, scale)
    got, launched = _launches(phi, g0)
    assert launched["mond_source"] == 1
    assert torch.equal(got, mond.rhs_plain(phi, g0, "simple", 1.0))


@pytest.mark.cuda
def test_kernel_on_a_flat_potential_with_a_bump(cuda):
    """Most faces have g exactly 0 (nu infinite): their flux is 0, as in
    the plain form, and the source is finite and bitwise the same."""
    phi = torch.zeros((64, 64, 64), device=cuda)
    phi[30:33, 30:33, 30:33] = torch.tensor([1.0, 2.0, 1.5], device=cuda)
    got, _ = _launches(phi, 0.5)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, mond.rhs_plain(phi, 0.5, "simple", 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(36, 32, 32), (68, 64, 64), (3, 5, 7),
                                   (40, 33, 70)])
def test_kernel_on_other_shapes(cuda, shape):
    """The slab path's extended slabs (P + 4, m, m) and ragged tiles: each
    axis wraps by its own length, bitwise the plain form."""
    phi = _potential(shape, 3, cuda)
    g0 = _g0(phi, 1.0)
    got, _ = _launches(phi, g0)
    assert torch.equal(got, mond.rhs_plain(phi, g0, "simple", 1.0))


@pytest.mark.cuda
def test_kernel_at_512(cuda):
    """The benchmark's grid: bitwise the plain form."""
    phi = _potential((512, 512, 512), 5, cuda)
    g0 = _g0(phi, 1.0)
    got, _ = _launches(phi, g0)
    want = mond.rhs_plain(phi, g0, "simple", 1.0)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1e3, 1.0, 1e-3])
@pytest.mark.parametrize("family,alpha", FAMILIES[1:])
def test_other_families_match_the_plain_form(cuda, family, alpha, scale):
    """The other families call powf, expf and rsqrtf where torch's pow and
    exp do; built with --fmad=false these may round an ulp away from
    torch's (libdevice's pow does, PERF.md §7 row 12), and an ulp of a
    face flux moves the source by ~2^-23 of the flux over h. Allowed: 1e-5
    of the source's largest value (the float32 rounding scale of
    ``test_source_matches_the_reference``); measured 0 on an H100."""
    phi = _potential((64, 64, 64), 7, cuda)
    g0 = _g0(phi, scale)
    got, launched = _launches(phi, g0, family, alpha)
    assert launched["mond_source"] == 1
    want = mond.rhs_plain(phi, g0, family, alpha)
    assert bool(torch.isfinite(want).all())
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * top


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    phi = _potential((16, 16, 16), 2, cuda)
    with pytest.raises(ValueError, match="float32"):
        mond.rhs(phi.double(), 0.5, "simple", 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        mond.rhs(phi.transpose(0, 2), 0.5, "simple", 1.0)
    with pytest.raises(ValueError, match="at least 3"):
        mond.rhs(phi[:2].contiguous(), 0.5, "simple", 1.0)
    with pytest.raises(NotImplementedError, match="mond_function"):
        mond.rhs(phi, 0.5, "standard", 1.0)

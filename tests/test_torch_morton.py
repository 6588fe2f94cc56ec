"""The port's Morton key module (pysco_tpu_torch/ops/morton.py) bitwise
against pysco_tpu/ops/morton.py: the same integers and positions through
both, the port's int64 keys compared with the JAX module's uint64 ones
bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pysco_tpu.ops import morton as jmorton
from pysco_tpu_torch.ops import morton

torch.set_num_threads(1)


def _ijk(seed=0, n=2000):
    """Random 21-bit coordinates, with the corners and edges of the range
    (where the tesseral steps carry and wrap)."""
    rng = np.random.default_rng(seed)
    ijk = rng.integers(0, 2 ** 21, (n, 3)).astype(np.int64)
    ijk[:8] = [[(c >> a & 1) * (2 ** 21 - 1) for a in range(3)]
               for c in range(8)]
    ijk[8:16] = 2 ** 20
    ijk[16:24] = 2 ** 21 - 2
    return ijk


def _jax_keys(ijk):
    return jmorton.encode(*(jnp.asarray(ijk[:, a].astype(np.uint32))
                            for a in range(3)))


def _bits(jax_keys):
    """uint64 keys as the int64 that holds the same bits."""
    return np.array(jax_keys).view(np.int64)


def test_spread_compact_encode_decode():
    ijk = _ijk()
    for a in range(3):
        v = ijk[:, a]
        spread = morton.spread_bits(torch.as_tensor(v))
        np.testing.assert_array_equal(
            spread.numpy(), _bits(jmorton.spread_bits(jnp.asarray(
                v.astype(np.uint32)))))
        np.testing.assert_array_equal(
            morton.compact_bits(spread).numpy(),
            np.array(jmorton.compact_bits(jnp.asarray(
                spread.numpy().view(np.uint64)))).astype(np.int64))
    keys = morton.encode(*(torch.as_tensor(ijk[:, a]) for a in range(3)))
    assert keys.dtype == torch.int64 and int(keys.min()) >= 0
    jkeys = _jax_keys(ijk)
    np.testing.assert_array_equal(keys.numpy(), _bits(jkeys))
    for got, want, v in zip(morton.decode(keys), jmorton.decode(jkeys),
                            ijk.T):
        np.testing.assert_array_equal(got.numpy(),
                                      np.array(want).astype(np.int64))
        np.testing.assert_array_equal(got.numpy(), v)


def test_positions_to_keys_and_back():
    rng = np.random.default_rng(1)
    pos = rng.random((2000, 3), dtype=np.float32)
    pos[:3] = [[0.0, 0.0, 0.0], [np.float32(1) - np.float32(2 ** -24)] * 3,
               [0.5, 0.25, 0.125]]
    keys = morton.positions_to_keys(torch.as_tensor(pos))
    jkeys = jmorton.positions_to_keys(jnp.asarray(pos))
    np.testing.assert_array_equal(keys.numpy(), _bits(jkeys))
    back = morton.keys_to_positions(keys)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(),
                                  np.array(jmorton.keys_to_positions(jkeys)))


@pytest.mark.parametrize("level", [0, 1, 7, 20])
def test_increment_decrement(level):
    ijk = _ijk(2)
    keys = morton.encode(*(torch.as_tensor(ijk[:, a]) for a in range(3)))
    jkeys = _jax_keys(ijk)
    for axis in range(3):
        up = morton.increment(keys, axis, level)
        down = morton.decrement(keys, axis, level)
        np.testing.assert_array_equal(
            up.numpy(), _bits(jmorton.increment(jkeys, axis, level)))
        np.testing.assert_array_equal(
            down.numpy(), _bits(jmorton.decrement(jkeys, axis, level)))
        # the step moves one axis by 2^level, periodic in 21 bits
        step = np.zeros(3, np.int64)
        step[axis] = 2 ** level
        for got, sign in ((up, 1), (down, -1)):
            want = (ijk + sign * step) % 2 ** 21
            np.testing.assert_array_equal(
                np.stack([c.numpy() for c in morton.decode(got)], 1), want)

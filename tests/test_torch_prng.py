"""The port's threefry keys and draws equal ``jax.random`` bit for bit,
in both ``jax_threefry_partitionable`` modes (toggled with the
``jax.threefry_partitionable`` context manager, so nothing leaks)."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from ringpop_tpu_torch import prng

SEEDS = [0, 1, 2, 3, 5, 7, 11, 42, 99, 123, 1000, 4242, 65535, 65536, 99991,
         123456789, 2**31 - 1, 31337, 271828, 314159]
SHAPES = [(1,), (2,), (7,), (64,), (3, 4), (64, 4), (130, 3), (5, 3, 2)]


def _key(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(np.asarray(jk).astype(np.int64), tk.numpy())


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(partitionable, seed):
    jk, tk = _key(seed)
    with jax.threefry_partitionable(partitionable):
        for num in (1, 2, 3, 4, 5, 10):
            want = np.asarray(jax.random.split(jk, num)).astype(np.int64)
            got = prng.split(tk, num, partitionable=partitionable).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"num={num}")


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(partitionable, seed):
    jk, tk = _key(seed)
    with jax.threefry_partitionable(partitionable):
        for shape in SHAPES:
            want = np.asarray(jax.random.uniform(jk, shape))
            got = prng.uniform(tk, shape, partitionable=partitionable).numpy()
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                          err_msg=f"shape={shape}")


@pytest.mark.parametrize("partitionable", [True, False])
def test_key_chain(partitionable):
    """The cluster's schedule: ``key, sub = split(key)`` per tick, the
    step's 4-way split of ``sub`` and the draws made from its keys."""
    jk, tk = _key(0)
    with jax.threefry_partitionable(partitionable):
        for _ in range(12):
            jk, jsub = jax.random.split(jk)
            tk, tsub = prng.split(tk, partitionable=partitionable)
            j4 = jax.random.split(jsub, 4)
            t4 = prng.split(tsub, 4, partitionable=partitionable)
            np.testing.assert_array_equal(t4.numpy(), np.asarray(j4).astype(np.int64))
            want = np.asarray(jax.random.uniform(j4[0], (64, 4)))
            got = prng.uniform(t4[0], (64, 4), partitionable=partitionable).numpy()
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))


def test_modes_differ():
    """The two modes really are different streams (so each test above
    pins its own mode)."""
    tk = prng.PRNGKey(0)
    assert not np.array_equal(
        prng.split(tk, 2, partitionable=True).numpy(),
        prng.split(tk, 2, partitionable=False).numpy(),
    )


def test_uniform_on_requested_device():
    u = prng.uniform(prng.PRNGKey(3), (4, 2), device="cpu")
    assert u.device.type == "cpu" and u.shape == (4, 2)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0

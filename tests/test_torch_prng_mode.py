"""The process-wide threefry mode of ``prng`` and its two hashing paths.

``set_partitionable``/``partitionable_mode`` are the port's counterpart
of jax's ``jax_threefry_partitionable`` setting: every draw that is not
given a mode reads it.  The draws must give ``jax.random``'s bits in
both modes (jax's own mode toggled with its context manager, so nothing
leaks).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from ringpop_tpu_torch import prng


def test_mode_setting_and_restore():
    assert prng.get_partitionable() is True
    assert prng.set_partitionable(False) is True
    try:
        assert prng.get_partitionable() is False
    finally:
        assert prng.set_partitionable(True) is False
    with pytest.raises(ZeroDivisionError):
        with prng.partitionable_mode(False):
            assert prng.get_partitionable() is False
            1 / 0
    assert prng.get_partitionable() is True


@pytest.mark.parametrize("mode", [True, False])
def test_draws_follow_the_mode(mode):
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    logits = np.log(np.linspace(1.0, 3.0, 40, dtype=np.float32))
    with jax.threefry_partitionable(mode), prng.partitionable_mode(mode):
        np.testing.assert_array_equal(
            prng.split(tk, 5).numpy(), np.asarray(jax.random.split(jk, 5)).astype(np.int64))
        np.testing.assert_array_equal(
            prng.uniform(tk, (33, 3)).numpy(), np.asarray(jax.random.uniform(jk, (33, 3))))
        np.testing.assert_array_equal(
            prng.randint(tk, (17,), 0, 9).numpy(),
            np.asarray(jax.random.randint(jk, (17,), 0, 9)))
        np.testing.assert_array_equal(
            prng.categorical(tk, torch.from_numpy(logits), 25).numpy(),
            np.asarray(jax.random.categorical(jk, jax.numpy.asarray(logits), shape=(25,))))
        np.testing.assert_array_equal(
            prng.fold_in(tk, 77).numpy(),
            np.asarray(jax.random.fold_in(jk, 77)).astype(np.int64))


@pytest.mark.parametrize("mode", [True, False])
@pytest.mark.parametrize("m", [1, 2, 33, 4097, 65537])
def test_random_bits_equal_jax(mode, m):
    """``random_bits`` in the mode it is given, and in the process-wide
    one when it is given none, at odd and even counts (the
    non-partitionable draw pads an odd one)."""
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    with jax.threefry_partitionable(mode):
        want = np.asarray(jax.random.bits(jk, (m,))).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(tk, (m,), partitionable=mode).numpy(), want)
    with prng.partitionable_mode(mode):
        np.testing.assert_array_equal(prng.random_bits(tk, (m,)).numpy(), want)


def test_offset_block():
    """A row block of a larger partitionable draw is that slice of the
    whole draw, also with the other mode set process-wide; the other
    mode has no blocks."""
    tk = prng.PRNGKey(9)
    whole = prng.random_bits(tk, (4096,), partitionable=True).numpy()
    with prng.partitionable_mode(False):
        for a, b in ((10, 1034), (1024, 3073)):
            part = prng.random_bits(tk, (b - a,), partitionable=True, offset=a).numpy()
            np.testing.assert_array_equal(part, whole[a:b])
        with pytest.raises(ValueError, match="offset"):
            prng.random_bits(tk, (4,), offset=2)

"""The port's serving-plane draws equal ``jax.random``'s bit for bit.

The workload sampler argmaxes ``logits + gumbel`` with
``gumbel = -log(-log(u))`` in float32, so one ulp of a logarithm can
flip a sampled key.  ``prng.xla_log`` is XLA:CPU's float32 logarithm
written as separate elementwise torch ops; here it and the whole Gumbel
transform are held against ``jnp.log`` on every float32 the uniform
draw can produce (``k * 2**-23``, the zero clamped to the smallest
normal), with no tolerance.  Then ``fold_in``, ``randint`` over spans up
to ``2**31 - 1`` (the uint32 remainder arithmetic), ``uniform`` with
``minval``/``maxval``, and ``categorical`` over many keys, in both
threefry modes where the reference has them."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import one_thread

from ringpop_tpu_torch import prng

TINY = np.finfo(np.float32).tiny


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """The port's runs of this module on one intra-op thread."""


@pytest.fixture(scope="module")
def uniforms():
    """Every float32 ``uniform(minval=tiny)`` can return."""
    return np.maximum(np.arange(2**23, dtype=np.float32) * np.float32(2**-23), TINY)


def test_log_equals_xla_on_every_uniform(uniforms):
    want = np.asarray(jnp.log(jnp.asarray(uniforms)))
    got = prng.xla_log(torch.from_numpy(uniforms)).numpy()
    assert got.dtype == np.float32
    assert int((got.view(np.int32) != want.view(np.int32)).sum()) == 0


def test_gumbel_equals_xla_on_every_uniform(uniforms):
    want = np.asarray(-jnp.log(-jnp.log(jnp.asarray(uniforms))))
    got = prng.gumbel_from_uniform(torch.from_numpy(uniforms)).numpy()
    assert int((got.view(np.int32) != want.view(np.int32)).sum()) == 0


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**32 - 1])
def test_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for data in (0, 1, 5, 0x5A10, 12345, 2**31 - 1):
        want = np.asarray(jax.random.fold_in(jk, data)).astype(np.int64)
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(), want, err_msg=str(data))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("span", [1, 3, 10000, 2**31 - 1])
def test_randint(partitionable, span):
    with jax.threefry_partitionable(partitionable):
        for seed in (0, 3, 99, 31337):
            want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (257,), 0, span))
            got = prng.randint(prng.PRNGKey(seed), (257,), 0, span,
                               partitionable=partitionable).numpy()
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want, err_msg=f"seed={seed}")
    got = prng.randint(prng.PRNGKey(1), (64,), 5, 5).numpy()
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (64,), 5, 5))
    np.testing.assert_array_equal(got, want)


def test_uniform_bounds():
    for lo, hi in ((TINY, 1.0), (0.25, 3.0), (-2.0, -1.0)):
        for seed in (0, 5):
            want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (1000,),
                                                 minval=lo, maxval=hi))
            got = prng.uniform(prng.PRNGKey(seed), (1000,), minval=float(lo),
                               maxval=float(hi)).numpy()
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


LOGITS = {
    "uniform": np.zeros(300, np.float32),
    "zipf": (-1.2 * np.log(np.arange(1, 301))).astype(np.float32),
    "tenant": np.log(((np.arange(300) % 16 + 1.0) ** -1.1) / 19).astype(np.float32),
}


@pytest.mark.parametrize("kind", sorted(LOGITS))
def test_categorical_over_many_keys(kind):
    """120 keys each, and the row-blocked draw equals the whole one."""
    logits = LOGITS[kind]
    for seed in range(120):
        want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed), jnp.asarray(logits),
                                                 shape=(64,)))
        got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits), 64).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"seed={seed}")


def test_categorical_row_blocks(monkeypatch):
    logits = torch.from_numpy(LOGITS["zipf"])
    whole = prng.categorical(prng.PRNGKey(4), logits, 97)
    monkeypatch.setattr(prng, "CATEGORICAL_BLOCK", 1000)  # 3 rows a block
    np.testing.assert_array_equal(prng.categorical(prng.PRNGKey(4), logits, 97).numpy(),
                                  whole.numpy())


def test_categorical_original_mode():
    logits = LOGITS["zipf"]
    with jax.threefry_partitionable(False):
        for seed in range(20):
            want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                                     jnp.asarray(logits), shape=(33,)))
            got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits), 33,
                                   partitionable=False).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"seed={seed}")

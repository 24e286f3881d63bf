"""masked_indices must be a bit-exact drop-in for jnp.nonzero(size, fill)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle3d.ops.compaction import masked_indices


@pytest.mark.parametrize("s", [100, 4096, 5000, 8192, 131072])
@pytest.mark.parametrize("frac", [0.0, 0.03, 0.5, 1.0])
def test_matches_nonzero(s, frac):
    m = jax.random.uniform(jax.random.PRNGKey(s + int(frac * 10)), (s,)) < frac
    for size in (16, max(1, s // 8), s):
        a = jnp.nonzero(m, size=size, fill_value=s)[0]
        b = masked_indices(m, size, s)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_custom_fill_and_jit():
    m = jnp.zeros((8192,), bool).at[jnp.array([5, 130, 8000])].set(True)
    out = jax.jit(lambda mm: masked_indices(mm, 8, fill_value=-7))(m)
    np.testing.assert_array_equal(
        np.asarray(out), np.array([5, 130, 8000, -7, -7, -7, -7, -7]))


def test_truncation_keeps_lowest_indices():
    m = jnp.ones((8192,), bool)
    out = masked_indices(m, 5, 8192)
    np.testing.assert_array_equal(np.asarray(out), np.arange(5))

"""Lane-parallel masked index compaction (``jnp.nonzero`` replacement).

``jnp.nonzero(mask, size=k)`` lowers its rank computation to a 1-D cumsum
over the full mask length. The scan is embarrassingly lane-parallel if the
mask is reshaped to [rows, 128]: an inclusive cumsum along the 128-wide
minor axis is one tiny triangular-ones matmul, and the carry (per-row
offsets) is the same problem 128x smaller, solved recursively. It was
written for the earlier accelerator, where the serial cumsum was the largest
cost of the incremental cell-layout rebind; whether it still beats
``jnp.nonzero`` on the GPU is unmeasured.

``masked_indices`` reproduces ``jnp.nonzero(mask, size, fill_value)[0]``
EXACTLY (ascending index order, same truncation and fill semantics), so it
is a drop-in swap on hot paths; callers relying on bit-equal trajectories
keep them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def _tri_ones(k: int):
    # T[j, c] = 1 for j <= c: x @ T is an inclusive cumsum along the minor
    # axis. Operand values are integer-valued and small (mask bits / lane
    # totals <= 128), exactly representable at any matmul precision; the f32
    # accumulator is exact up to 2^24 elements. NumPy constant (not jnp) so
    # the cache never captures a tracer.
    return np.triu(np.ones((k, k), np.float32))


def _lane_cumsum(x2):
    """Inclusive cumsum along the minor (lane) axis of f32[R, 128]."""
    return jax.lax.dot(x2, _tri_ones(x2.shape[1]),
                       precision=jax.lax.Precision.HIGHEST)


def _exclusive_offsets(tot):
    """Exclusive cumsum of f32[R] (integer-valued), lane-blocked + recursion."""
    r = tot.shape[0]
    if r <= 256:
        inc = _lane_cumsum(tot[None, :])[0]
        return inc - tot
    pad = (-r) % 128
    t2 = jnp.pad(tot, (0, pad)).reshape(-1, 128)
    inc = _lane_cumsum(t2)
    block_off = _exclusive_offsets(inc[:, -1])
    return (inc - t2 + block_off[:, None]).reshape(-1)[:r]


def masked_indices(mask, size: int, fill_value: int | None = None):
    """Ascending indices of True entries of 1-D ``mask``, truncated/padded to
    ``size`` with ``fill_value`` — exactly ``jnp.nonzero(mask, size=size,
    fill_value=fill_value)[0]``, but with the rank scan lane-parallelized
    (triangular matmuls) instead of XLA's serial-axis cumsum."""
    s = mask.shape[0]
    if fill_value is None:
        fill_value = s
    # past 2^24 the f32 rank cumsums lose integer exactness (ranks can reach
    # the mask length) — fall back to the exact-by-construction nonzero
    if s < 4096 or s % 128 or s > (1 << 24):
        return jnp.nonzero(mask, size=size, fill_value=fill_value)[0]
    m2 = mask.reshape(-1, 128).astype(jnp.float32)
    cum = _lane_cumsum(m2)                      # inclusive, per row
    row_off = _exclusive_offsets(cum[:, -1])    # movers before each row
    # ascending rank of each True element in flat order; >= size (and all
    # False elements) land on the sentinel row, sliced off below
    rank = (row_off[:, None] + cum - 1.0).astype(jnp.int32)
    tgt = jnp.where(m2 > 0.0, jnp.minimum(rank, size), size)
    vals = jax.lax.broadcasted_iota(jnp.int32, m2.shape, 0) * 128 \
        + jax.lax.broadcasted_iota(jnp.int32, m2.shape, 1)
    out = jnp.full((size + 1,), fill_value, jnp.int32)
    out = out.at[tgt.reshape(-1)].set(vals.reshape(-1), mode="drop")
    return out[:size]

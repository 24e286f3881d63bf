"""Pairwise force laws.

Every law is expressed in a single canonical form so one engine (dense,
Pallas-tiled, cell-list, or ring-sharded) serves all of them:

    force_on_i += unit(i -> j) * magnitude(d_ij, coef_ij)

where ``magnitude > 0`` attracts and ``coef_ij`` is a *rank-1 pair
coefficient*: ``coef_ij = dot(U[i], V[j])`` for per-particle feature rows
``U, V`` of shape ``[N, P]``. The per-pair species/mass coupling is then a
few FMAs over P inside a pair tile instead of a per-pair table gather:

  * particle-life: ``coef = attraction_matrix[species_i, species_j]``
    (reference ``src/lib.rs:223-229``) — ``U = A[s]``, ``V = onehot(s)``,
    ``P = id_count``.
  * gravity:       ``coef = m_j``        — ``U = 1``, ``V = m``, ``P = 1``.
  * lennard_jones / spring: ``coef = 1`` — ``U = V = 1``, ``P = 1``.

The particle-life magnitude reproduces ``Particles::calculate_force``
(``src/lib.rs:55-67``) *exactly*, including its boundary quirks: at
``d == min_pull_ratio`` and ``d >= 1.0`` (raw distance, not normalized by the
effect radius — quirk Q2) the force is zero.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SimConfig


# ---------------------------------------------------------------------------
# Rank-1 pair-coefficient features
# ---------------------------------------------------------------------------

def feature_dim(cfg: SimConfig) -> int:
    """Number of feature columns ``pair_features`` fills for this law."""
    return cfg.id_count if cfg.force_law == "particle_life" else 1


def pair_features(state, cfg: SimConfig, pad_p: int | None = None):
    """Return (U, V) with coef_ij = dot(U[i], V[j]).

    ``pad_p`` zero-pads the feature dimension (the dense slot layouts keep
    a fixed-width packed row). U is gathered from the attraction matrix, not
    formed by a one-hot matmul, so the coefficients are exact float32 on
    every backend.
    """
    n = state.positions.shape[0]
    dtype = state.positions.dtype
    if cfg.force_law == "particle_life":
        a = jnp.asarray(cfg.attraction_matrix, dtype)
        u = a[state.species]  # U[i] = A[species_i, :]
        v = jax.nn.one_hot(state.species, cfg.id_count, dtype=dtype)
    elif cfg.force_law == "gravity":
        u = jnp.ones((n, 1), dtype)
        v = state.masses.astype(dtype)[:, None]
    else:  # lennard_jones, spring: pair coefficient is uniform
        u = jnp.ones((n, 1), dtype)
        v = jnp.ones((n, 1), dtype)
    if pad_p is not None and u.shape[1] < pad_p:
        pad = pad_p - u.shape[1]
        u = jnp.pad(u, ((0, 0), (0, pad)))
        v = jnp.pad(v, ((0, 0), (0, pad)))
    return u, v


# ---------------------------------------------------------------------------
# Force magnitudes  f(d, coef) — positive = attraction (toward the other)
# ---------------------------------------------------------------------------

def particle_life_magnitude(d, coef, min_pull_ratio):
    """Reference force law, ``src/lib.rs:55-67``:

        d <  min               ->  d/min - 1          (repulsion, < 0)
        min < d < 1            ->  coef * (1 - |2d - 1 - min| / (1 - min))
        otherwise (incl. d==min, d>=1) -> 0
    """
    m = min_pull_ratio
    repel = d / m - 1.0
    tri = coef * (1.0 - jnp.abs(2.0 * d - 1.0 - m) / (1.0 - m))
    mid = jnp.logical_and(m < d, d < 1.0)
    return jnp.where(d < m, repel, jnp.where(mid, tri, 0.0))


def lennard_jones_magnitude(d, coef, epsilon, sigma):
    """dU/dd for U = 4 eps ((s/d)^12 - (s/d)^6): attraction at long range,
    steep repulsion inside sigma. ``coef`` scales epsilon per pair."""
    inv = sigma / d
    i6 = inv * inv * inv
    i6 = i6 * i6
    return coef * (24.0 * epsilon / d) * (i6 - 2.0 * i6 * i6)


def gravity_magnitude(d, coef, g_const, softening):
    """Plummer-softened gravitational acceleration magnitude G*m_j*d/(d^2+e^2)^1.5.
    ``coef`` carries m_j via the rank-1 features."""
    d2 = d * d + softening * softening
    return coef * g_const * d / (d2 * jnp.sqrt(d2))


def spring_magnitude(d, coef, stiffness, rest_length):
    """Hookean spring toward rest_length (positive when stretched)."""
    return coef * stiffness * (d - rest_length)


# ---------------------------------------------------------------------------
# Scale functions  s(d2, coef) = f(d)/d — what the engines actually need.
#
# The accumulation is ``acc += rel * (f/d)``; expressing f/d directly in the
# SQUARED distance avoids reconstructing d via rsqrt in the hot path, which
# is both faster and numerically safer (XLA's rsqrt is an approximation on
# some backends). Gravity and Lennard-Jones need no sqrt at all; the
# particle-life and spring laws use one exact sqrt.
# ---------------------------------------------------------------------------

def particle_life_scale(d2, coef, min_pull_ratio):
    d = jnp.sqrt(d2)
    return particle_life_magnitude(d, coef, min_pull_ratio) / d


def lennard_jones_scale(d2, coef, epsilon, sigma):
    a = sigma * sigma / d2
    a3 = a * a * a  # (sigma/d)^6
    return coef * (24.0 * epsilon / d2) * (a3 - 2.0 * a3 * a3)


def gravity_scale(d2, coef, g_const, softening):
    dd2 = d2 + softening * softening
    return coef * g_const / (dd2 * jnp.sqrt(dd2))


def spring_scale(d2, coef, stiffness, rest_length):
    d = jnp.sqrt(d2)
    return coef * stiffness * (d - rest_length) / d


def scale_fn(cfg: SimConfig):
    """Return g(d2, coef) -> f/d for the configured law (engine hot path)."""
    law = cfg.force_law
    if law == "particle_life":
        return lambda d2, c: particle_life_scale(d2, c, cfg.min_pull_ratio)
    if law == "lennard_jones":
        return lambda d2, c: lennard_jones_scale(d2, c, cfg.lj_epsilon, cfg.lj_sigma)
    if law == "gravity":
        return lambda d2, c: gravity_scale(d2, c, cfg.gravity_constant, cfg.gravity_softening)
    if law == "spring":
        return lambda d2, c: spring_scale(d2, c, cfg.spring_stiffness, cfg.spring_rest_length)
    raise ValueError(f"unknown force law {law!r}")


def magnitude_fn(cfg: SimConfig):
    """Return f(d, coef) -> magnitude for the configured law, closing over
    the (traced) law parameters from cfg."""
    law = cfg.force_law
    if law == "particle_life":
        return lambda d, c: particle_life_magnitude(d, c, cfg.min_pull_ratio)
    if law == "lennard_jones":
        return lambda d, c: lennard_jones_magnitude(d, c, cfg.lj_epsilon, cfg.lj_sigma)
    if law == "gravity":
        return lambda d, c: gravity_magnitude(d, c, cfg.gravity_constant, cfg.gravity_softening)
    if law == "spring":
        return lambda d, c: spring_magnitude(d, c, cfg.spring_stiffness, cfg.spring_rest_length)
    raise ValueError(f"unknown force law {law!r}")


def kick_scale(cfg: SimConfig):
    """Scale turning the accumulated force sum into an acceleration.

    The reference multiplies by ``interaction_force * particle_effect_radius``
    (``src/lib.rs:246-247``); the other laws already produce accelerations and
    use ``interaction_force`` as a plain gain.
    """
    if cfg.force_law == "particle_life":
        return cfg.interaction_force * cfg.particle_effect_radius
    return cfg.interaction_force


def min_image(delta, world_size):
    """Minimum-image displacement wrap.

    Equivalent to the reference's sweep over 27 periodic world images
    (``src/lib.rs:177-191``): given the asserted ``world >= 2*radius``
    (``src/lib.rs:132``) at most one image of a pair lies within the effect
    radius, and it is the minimum-image one. O(1) instead of 27 passes.
    """
    return delta - world_size * jnp.round(delta / world_size)

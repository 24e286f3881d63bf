"""Particle state: structure-of-arrays pytree + deterministic scene init.

The reference stores particles as an array-of-structs ``Vec<Particle>`` with
``position``, ``velocity``, ``id`` fields (``src/lib.rs:12-17``) and double
buffers (``active_particles`` / ``past_particles``, ``src/lib.rs:22-23``) for
its Jacobi update. On an accelerator the idiomatic layout is structure-of-arrays device
arrays; double buffering is implicit in the functional update (the step is a
pure function ``state -> state``, so XLA manages buffers).

Scene initialization reproduces the reference's ``generate_particles``
(``src/bin/main.rs:60-87``): uniform positions in ``[-w/2, w/2]^3``, zero
velocity, uniform random species — but *deterministically seeded* (the
reference uses per-thread ``thread_rng`` and is irreproducible, quirk Q9).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from .config import SimConfig


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """SoA particle state (JAX pytree).

    positions:  f32[N, 3]
    velocities: f32[N, 3]
    species:    i32[N]   (the reference's ``id`` field, src/lib.rs:16)
    masses:     f32[N]   (extension — used by the gravity force law)
    accel:      f32[N, 3] cached accelerations (velocity-Verlet only)
    """

    positions: Any
    velocities: Any
    species: Any
    masses: Any
    accel: Any

    @property
    def n(self) -> int:
        return self.positions.shape[0]

    def replace(self, **kw) -> "ParticleState":
        return dataclasses.replace(self, **kw)


jax.tree_util.register_dataclass(
    ParticleState,
    data_fields=["positions", "velocities", "species", "masses", "accel"],
    meta_fields=[],
)


def init_scene(key, n: int, cfg: SimConfig, dtype=jnp.float32) -> ParticleState:
    """Deterministic analogue of ``generate_particles`` (src/bin/main.rs:60-87).

    Positions uniform in [-world/2, world/2]^3, zero velocities, species
    uniform in [0, id_count), unit masses, zero cached accelerations.
    """
    kp, ks = jax.random.split(key)
    half = jnp.asarray(cfg.world_size, dtype) * 0.5
    positions = jax.random.uniform(kp, (n, 3), dtype, minval=-half, maxval=half)
    velocities = jnp.zeros((n, 3), dtype)
    species = jax.random.randint(ks, (n,), 0, cfg.id_count, dtype=jnp.int32)
    masses = jnp.ones((n,), dtype)
    accel = jnp.zeros((n, 3), dtype)
    return ParticleState(positions, velocities, species, masses, accel)


def from_numpy(positions, velocities, species, masses=None, dtype=jnp.float32) -> ParticleState:
    """Build a state from host arrays (e.g. a checkpoint or the oracle)."""
    positions = jnp.asarray(positions, dtype)
    velocities = jnp.asarray(velocities, dtype)
    species = jnp.asarray(species, jnp.int32)
    n = positions.shape[0]
    if masses is None:
        masses = jnp.ones((n,), dtype)
    else:
        masses = jnp.asarray(masses, dtype)
    return ParticleState(positions, velocities, species, masses, jnp.zeros((n, 3), dtype))


def resize(state: ParticleState, key, new_n: int, cfg: SimConfig) -> ParticleState:
    """Grow or shrink the particle population, mirroring the reference's
    live particle-count control (truncate / generate-and-extend,
    ``src/bin/main.rs:261-280``)."""
    n = state.n
    if new_n <= n:
        return ParticleState(
            state.positions[:new_n],
            state.velocities[:new_n],
            state.species[:new_n],
            state.masses[:new_n],
            state.accel[:new_n],
        )
    extra = init_scene(key, new_n - n, cfg, state.positions.dtype)
    cat = lambda a, b: jnp.concatenate([a, b], axis=0)
    return ParticleState(
        cat(state.positions, extra.positions),
        cat(state.velocities, extra.velocities),
        cat(state.species, extra.species),
        cat(state.masses, extra.masses),
        cat(state.accel, extra.accel),
    )

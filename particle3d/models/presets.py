"""Named scene presets — the framework's "model families".

``reference`` reproduces the Rust app's default scene exactly
(``src/bin/main.rs:123-148``); the others map to the BASELINE.json workload
configs (velocity-Verlet elastic box, Lennard-Jones gas with cell lists,
gravitational N-body for ring sharding, spring lattice).

Every preset is a pure function ``(key, n?) -> (state, cfg, dt)`` so scenes
are deterministic and jit-friendly from the first step.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SimConfig, reference_config
from ..state import ParticleState, init_scene, from_numpy


def _reference(key, n: int | None = None):
    """The reference interactive demo: N=1000 particle-life, periodic box
    (src/bin/main.rs:144: world 10, radius 2, drag 0.97, 60 TPS)."""
    n = 1000 if n is None else n
    cfg = reference_config()
    return init_scene(key, n, cfg), cfg, 1.0 / 60.0


def _reference_walls(key, n: int | None = None):
    n = 1000 if n is None else n
    cfg = reference_config().replace(boundary="clamp")
    return init_scene(key, n, cfg), cfg, 1.0 / 60.0


def _particle_life_large(key, n: int | None = None):
    """Large-N particle life: column-sweep cell kernel. The effective
    cutoff is min(radius, 1.0) = 1.0 (reference quirk Q2). The overflow
    sidecar (ops/overflow.py) keeps capacity-overflow rows exact, so the
    capacity hugs the MEAN occupancy instead of the Poisson-tail max: a
    24^3 grid (cell width 1.67, ~19 mean occupants, cap 32); the
    ~60-particle uniform-phase overflow rides the sidecar, masked 0."""
    n = 262144 if n is None else n
    if n >= 32768:
        cfg = reference_config(world_size=40.0).replace(
            neighbor="celllist_pallas", cell_grid=24,
            cell_capacity=32)
    else:
        cfg = reference_config(world_size=40.0).replace(neighbor="allpairs_pallas")
    return init_scene(key, n, cfg), cfg, 1.0 / 60.0


def _particle_life_1m(key, n: int | None = None):
    """Million-particle particle life on the exact production path
    (incremental dense cell layout): a 40^3 grid (width 1.6, ~16 mean
    occupants, cap 32; ~21 overflow rows sidecar-served). The sidecar
    budget is 128 (6x the ~21-row uniform-phase queue): its window
    gathers scale with ocap. Scenes that cluster past the budget escalate
    via the adaptive ladder as usual (frozen rows are counted, never
    silent)."""
    n = 1_048_576 if n is None else n
    cfg = reference_config(world_size=64.0).replace(
        neighbor="celllist_pallas", cell_grid=40, cell_capacity=32,
        overflow_capacity=128)
    return init_scene(key, n, cfg), cfg, 1.0 / 60.0


def _particle_life_large_allpairs(key, n: int | None = None):
    """Large-N particle life on the brute-force Pallas all-pairs kernel
    (the BASELINE pair-interactions/sec metric workload)."""
    n = 262144 if n is None else n
    cfg = reference_config(world_size=40.0).replace(neighbor="allpairs_pallas")
    return init_scene(key, n, cfg), cfg, 1.0 / 60.0


def _verlet_elastic(key, n: int | None = None):
    """BASELINE config 2: N=16k, velocity-Verlet, elastic wall collisions,
    single-chip tiled Pallas all-pairs."""
    n = 16384 if n is None else n
    cfg = SimConfig(
        force_law="spring",
        spring_stiffness=2.0,
        spring_rest_length=0.4,
        particle_effect_radius=0.8,
        world_size=12.0,
        integrator="velocity_verlet",
        boundary="reflect",
        restitution=1.0,
        coefficient=0.0,
        neighbor="allpairs_pallas",
        wrap_forces=False,
    ).validate()
    st = init_scene(key, n, cfg)
    kv = jax.random.fold_in(key, 1)
    st = st.replace(velocities=0.5 * jax.random.normal(kv, (n, 3), jnp.float32))
    return st, cfg, 2e-3


def _lj_gas(key, n: int | None = None):
    """BASELINE config 3: N=262k Lennard-Jones gas, cell-list neighbors."""
    n = 262144 if n is None else n
    # density tuned so mean cell occupancy is moderate (box 64^3 cells)
    # supercell grid for the Pallas column-sweep kernel: width 1.0 (2x the
    # 0.5 cutoff), mean occupancy ~8/cell at N=262k, slack 2x
    cfg = SimConfig(
        force_law="lennard_jones",
        lj_epsilon=0.2,
        lj_sigma=0.15,
        particle_effect_radius=0.5,
        world_size=32.0,
        integrator="velocity_verlet",
        boundary="wrap",
        coefficient=0.0,
        # small scenes (tests/CPU) use the XLA cell list on a coarse grid;
        # the Pallas column-sweep kernel pays off at scale
        neighbor="celllist_pallas" if n >= 32768 else "celllist",
        cell_grid=32 if n >= 32768 else 8,
        cell_capacity=16 if n >= 32768 else max(16, 4 * n // 512),
    ).validate()
    # near-uniform lattice + jitter avoids LJ blowups at t=0
    side = int(round(n ** (1 / 3)))
    while side ** 3 < n:
        side += 1
    lin = jnp.linspace(-15.5, 15.5, side)
    gx, gy, gz = jnp.meshgrid(lin, lin, lin, indexing="ij")
    grid = jnp.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)[:n]
    jitter = 0.02 * jax.random.normal(key, (n, 3), jnp.float32)
    st = init_scene(key, n, cfg).replace(positions=grid + jitter)
    kv = jax.random.fold_in(key, 2)
    st = st.replace(velocities=0.1 * jax.random.normal(kv, (n, 3), jnp.float32))
    return st, cfg, 1e-3


def _gravity_nbody(key, n: int | None = None):
    """BASELINE config 4: gravitational N-body (ring-shard to scale to 2M)."""
    n = 65536 if n is None else n
    cfg = SimConfig(
        force_law="gravity",
        gravity_constant=0.05,
        gravity_softening=0.05,
        particle_effect_radius=10.0,
        world_size=20.0,
        integrator="leapfrog",
        boundary="wrap",
        coefficient=0.0,
        neighbor="allpairs_pallas",
        wrap_forces=False,
    ).validate()
    # Plummer-ish ball: gaussian cloud with solid-body spin
    kp, kv, km = jax.random.split(key, 3)
    pos = 1.5 * jax.random.normal(kp, (n, 3), jnp.float32)
    omega = jnp.array([0.0, 0.0, 0.35])
    vel = jnp.cross(jnp.broadcast_to(omega, pos.shape), pos)
    vel = vel + 0.02 * jax.random.normal(kv, (n, 3), jnp.float32)
    masses = jax.random.uniform(km, (n,), jnp.float32, 0.5, 1.5) / n
    st = from_numpy(pos, vel, np.zeros(n, np.int32), masses=masses)
    return st, cfg, 5e-3


def _spring_lattice(key, n: int | None = None):
    """Hookean springs between nearby particles — jelly-cube demo."""
    n = 4096 if n is None else n
    cfg = SimConfig(
        force_law="spring",
        spring_stiffness=8.0,
        spring_rest_length=0.5,
        particle_effect_radius=0.75,
        world_size=16.0,
        integrator="velocity_verlet",
        boundary="reflect",
        restitution=0.8,
        coefficient=0.2,
        neighbor="allpairs",
        wrap_forces=False,
        acceleration=np.array([0.0, -2.0, 0.0], np.float32),
    ).validate()
    side = int(round(n ** (1 / 3)))
    while side ** 3 < n:
        side += 1
    lin = jnp.linspace(-0.25 * side * 0.5, 0.25 * side * 0.5, side)
    gx, gy, gz = jnp.meshgrid(lin, lin, lin, indexing="ij")
    grid = jnp.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)[:n]
    st = init_scene(key, n, cfg).replace(positions=grid)
    return st, cfg, 2e-3


PRESETS: dict[str, Callable] = {
    "reference": _reference,
    "reference_walls": _reference_walls,
    "particle_life_large": _particle_life_large,
    "particle_life_1m": _particle_life_1m,
    "particle_life_large_allpairs": _particle_life_large_allpairs,
    "verlet_elastic": _verlet_elastic,
    "lj_gas": _lj_gas,
    "gravity_nbody": _gravity_nbody,
    "spring_lattice": _spring_lattice,
}


def list_presets() -> list[str]:
    return sorted(PRESETS)


def make_scene(name: str, key=None, n: int | None = None):
    """-> (state, cfg, dt) for a named preset."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {list_presets()}")
    if key is None:
        key = jax.random.PRNGKey(0)
    return PRESETS[name](key, n)

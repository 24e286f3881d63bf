"""particle3d — a 3D particle-simulation framework for the GPU.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the Rust reference
``navpreett/3D-Particle-Simulation-`` (particle-life simulator; see SURVEY.md):
SoA device-array state, fused force/integrate/boundary steps under
``jax.lax.scan``, Pallas all-pairs and cell-list kernels, a static-shape cell-list
path, ring-sharded all-pairs over a device mesh, and an on-device point-splat
renderer with batched snapshot readback.
"""

from .config import (
    SimConfig,
    ConfigError,
    reference_config,
    FORCE_LAWS,
    INTEGRATORS,
    BOUNDARIES,
    NEIGHBOR_BACKENDS,
    DEFAULT_ATTRACTION,
    DEFAULT_COLORS,
)
from .state import ParticleState, init_scene, from_numpy, resize
from .engine.step import (
    step, simulate, trajectory, warmup, pair_accel, simulate_dense,
    simulate_dense_carry, simulate_cadenced,
)

__version__ = "0.2.0"

__all__ = [
    "SimConfig",
    "ConfigError",
    "reference_config",
    "ParticleState",
    "init_scene",
    "from_numpy",
    "resize",
    "step",
    "simulate",
    "trajectory",
    "warmup",
    "pair_accel",
    "simulate_dense",
    "simulate_dense_carry",
    "simulate_cadenced",
    "FORCE_LAWS",
    "INTEGRATORS",
    "BOUNDARIES",
    "NEIGHBOR_BACKENDS",
    "DEFAULT_ATTRACTION",
    "DEFAULT_COLORS",
]

"""Device mesh construction and particle shardings.

The reference has no distributed backend at all (SURVEY.md section 2:
rayon shared-memory atomics are its only 'communication'). Here large N is
particle-sharded over a 1-D mesh: state arrays split on axis 0, forces via a
ring exchange between devices (see ring.py). A 2-D (dcn, ici) mesh factory
is provided for multi-host layouts: the outer axis crosses hosts, the inner
axis stays on one host.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS = "shard"  # the particle-sharding mesh axis name


def make_mesh(n_devices: int | None = None, axis: str = AXIS,
              devices=None) -> Mesh:
    """1-D mesh over the given (or all) devices.

    Raises when fewer devices exist than requested — a silently truncated
    mesh would "pass" sharding checks while exercising zero inter-device
    communication.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh: {n_devices} devices requested but only "
                f"{len(devices)} available ({jax.default_backend()} backend); "
                f"for a virtual CPU mesh set JAX_PLATFORMS=cpu and "
                f"XLA_FLAGS=--xla_force_host_platform_device_count="
                f"{n_devices} before jax initializes")
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def make_mesh_2d(dcn: int, ici: int, axes=("dcn", AXIS)) -> Mesh:
    """2-D (hosts x devices) mesh: the outer axis crosses hosts."""
    avail = jax.devices()
    if len(avail) < dcn * ici:
        raise ValueError(
            f"make_mesh_2d: {dcn}x{ici} devices requested but only "
            f"{len(avail)} available")
    devices = np.array(avail[: dcn * ici]).reshape(dcn, ici)
    return Mesh(devices, axes)


def particle_sharding(mesh: Mesh, axis: str = AXIS) -> NamedSharding:
    """Shard the leading (particle) dimension; replicate the rest."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())

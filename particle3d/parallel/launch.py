"""Multi-host launch glue: distributed runtime init + host-aware meshes.

The reference is strictly single-process (rayon threads; SURVEY.md §2
parallelism table). This module is the multi-host entry point:

  * ``initialize_distributed()`` — safe wrapper around
    ``jax.distributed.initialize``: explicit coordinator args, or cluster
    auto-detection (coordinator or SLURM environments JAX knows how to
    read), and a guaranteed no-op for plain single-process runs and repeated
    calls.
  * ``mesh_shape_2level()`` — pure process-count → (dcn, ici) shape logic
    (unit-testable without hardware).
  * ``auto_mesh_2d()`` — the (hosts x devices) mesh for this runtime: the
    outer axis crosses the host network, the inner axis stays on one host.
  * ``sharded_simulate_2level()`` — whole-trajectory entry point wiring the
    hierarchical ring (``ring.ring_forces_2level``: the source block makes a
    full host-local revolution per cross-host hop, so cross-host traffic is
    1/D_local of a flat ring) into the fused step under one jitted scan.

Typical multi-host launch (same program on every host)::

    from particle3d.parallel import (
        initialize_distributed, auto_mesh_2d, sharded_simulate_2level,
        shard_state)

    initialize_distributed()              # or pass coordinator_address=...
    mesh = auto_mesh_2d()                 # (n_hosts, chips_per_host)
    state = shard_state(state, mesh, axis=("dcn", "shard"))
    out = sharded_simulate_2level(state, cfg, dt, num_steps, mesh)

No real multi-host fabric exists in CI; the mesh/shape logic is unit-tested
and the 2-level ring itself is verified on a virtual (2, 4)/(4, 2) CPU mesh
(tests/test_advanced_parallel.py, tests/test_launch.py).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SimConfig
from ..state import ParticleState
from ..engine.step import step as _step
from ..ops import forces as F
from .mesh import AXIS, make_mesh_2d
from .ring import ring_forces_2level

DCN_AXIS = "dcn"

# env vars that mark an externally-configured distributed runtime
_CLUSTER_ENV = (
    "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS", "SLURM_JOB_ID",
)


def cluster_env_configured(environ=None) -> bool:
    """True when the environment carries multi-host coordination info that
    ``jax.distributed.initialize()`` can auto-detect."""
    environ = os.environ if environ is None else environ
    return any(environ.get(k) for k in _CLUSTER_ENV)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None) -> bool:
    """Initialize the JAX distributed runtime when appropriate.

    * explicit args -> ``jax.distributed.initialize(...)`` verbatim;
    * no args but a recognized cluster environment -> auto-detect init;
    * plain single-process run -> no-op.

    Idempotent (an already-initialized runtime is left alone). Returns True
    iff the runtime spans multiple processes afterwards.
    """
    explicit = coordinator_address is not None or num_processes is not None
    if explicit or cluster_env_configured():
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                local_device_ids=local_device_ids)
        except RuntimeError as e:
            if "already initialized" in str(e):
                pass  # idempotent
            elif not explicit and "must be called before" in str(e):
                pass  # backend already up in a non-cluster run: no-op
            else:
                raise
        except ValueError:
            # cluster-ish env vars present but incomplete: only explicit
            # args make that an error
            if explicit:
                raise
    return jax.process_count() > 1


def mesh_shape_2level(n_devices: int, n_processes: int) -> tuple[int, int]:
    """(dcn, ici) mesh shape: one outer rank per process, the
    process-local devices on the inner axis. Pure logic — unit-testable
    without hardware."""
    if n_processes < 1 or n_devices < 1:
        raise ValueError(f"bad topology: {n_devices} devices / "
                         f"{n_processes} processes")
    if n_devices % n_processes:
        raise ValueError(
            f"{n_devices} devices do not split evenly over "
            f"{n_processes} processes")
    return n_processes, n_devices // n_processes


def auto_mesh_2d(dcn: int | None = None, ici: int | None = None,
                 axes=(DCN_AXIS, AXIS)) -> Mesh:
    """The (hosts x devices) mesh for the current runtime. With no
    arguments, dcn = jax.process_count() and ici = devices per process;
    explicit values
    override (e.g. a virtual CPU mesh in tests)."""
    if dcn is None and ici is None:
        dcn, ici = mesh_shape_2level(jax.device_count(), jax.process_count())
    elif dcn is None:
        dcn = jax.device_count() // ici
    elif ici is None:
        ici = jax.device_count() // dcn
    return make_mesh_2d(dcn, ici, axes=axes)


def shard_state_2level(state: ParticleState, mesh: Mesh,
                       axes=(DCN_AXIS, AXIS)) -> ParticleState:
    """Particle-shard the state over BOTH mesh axes (dim 0 split)."""
    sh = NamedSharding(mesh, P(axes))
    return jax.tree.map(lambda a: jax.device_put(a, sh), state)


@functools.partial(jax.jit, static_argnames=("num_steps", "mesh", "dcn_axis",
                                             "axis"))
def sharded_simulate_2level(state: ParticleState, cfg: SimConfig, dt,
                            num_steps: int, mesh: Mesh,
                            dcn_axis: str = DCN_AXIS, axis: str = AXIS
                            ) -> ParticleState:
    """Whole sharded trajectory with the hierarchical two-level ring.

    ``state`` must be particle-sharded over both axes (N divisible by the
    total mesh size); one compiled program, D_ici * D_dcn ring hops per step,
    only D_dcn of them across hosts.
    """
    n = state.positions.shape[0]
    total = mesh.shape[dcn_axis] * mesh.shape[axis]
    if n % total:
        raise ValueError(f"N={n} must divide by mesh size {total}")

    spec = P((dcn_axis, axis))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(spec, jax.tree.map(lambda _: P(), cfg), P()),
        out_specs=spec,
        check_vma=False,
    )
    def run(st, cfg_in, dt_in):
        def accel_fn(positions, s, c):
            u, v = F.pair_features(s, c)
            f = ring_forces_2level(positions, u, v, c,
                                   ici_axis=axis, dcn_axis=dcn_axis)
            return f * F.kick_scale(c)

        def body(s, _):
            return _step(s, cfg_in, dt_in, accel_fn=accel_fn), None

        st, _ = jax.lax.scan(body, st, None, length=num_steps)
        return st

    return run(state, cfg, jnp.asarray(dt, jnp.float32))

"""Ring-sharded all-pairs forces over a device mesh.

The N-body analogue of ring attention (SURVEY.md section 2 checklist): state
arrays are particle-sharded across the mesh; each step, every device computes
forces on its local receivers from the source block it currently holds, then
``ppermute``s the block to its ring neighbor — after D hops every
receiver has seen every source. The permute for step k+1 is issued before the
step-k compute so XLA's async collectives overlap transfer with force math.

The reference has no distributed path at all — its largest-N story is rayon
threads on one CPU (SURVEY.md section 2, parallelism table).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..config import SimConfig
from ..state import ParticleState
from ..ops import forces as F
from ..ops.allpairs import allpairs_forces
from ..engine.step import step as _step
from .mesh import AXIS, particle_sharding


def _block_forces(positions, u, src_pos, src_v, cfg: SimConfig):
    if cfg.neighbor == "allpairs_pallas":
        from ..ops.pallas_allpairs import pallas_allpairs_forces

        return pallas_allpairs_forces(
            positions, u, v=src_v, cfg=cfg, src_positions=src_pos, src_v=src_v
        )
    return allpairs_forces(positions, u, None, cfg,
                           src_positions=src_pos, src_v=src_v)


def ring_forces(positions, u, v, cfg: SimConfig, axis: str = AXIS):
    """Per-shard force accumulation via a ring exchange (call inside
    shard_map). positions/u/v are the LOCAL shards."""
    d = jax.lax.axis_size(axis)
    perm = [(i, (i + 1) % d) for i in range(d)]

    def body(i, carry):
        acc, src_pos, src_v = carry
        # Issue the next-hop permute first so it overlaps the force compute.
        nxt_pos = jax.lax.ppermute(src_pos, axis, perm)
        nxt_v = jax.lax.ppermute(src_v, axis, perm)
        acc = acc + _block_forces(positions, u, src_pos, src_v, cfg)
        return acc, nxt_pos, nxt_v

    acc0 = jnp.zeros_like(positions)
    acc, _, _ = jax.lax.fori_loop(0, d, body, (acc0, positions, v))
    return acc


def ring_forces_masked(positions, u, v, ok, cfg: SimConfig, axis: str = AXIS):
    """``ring_forces`` over COMPACTED row buffers: ``ok`` marks live rows,
    and circulates with the source block so every device masks the other
    shards' padding. Needed because the particle-life repulsion term is
    coefficient-independent — zero-V padding would still repel
    (ops/allpairs._tile_forces). Padding RECEIVERS compute garbage that
    callers drop at scatter-back. Used by the slab adaptive driver's
    sharded exact terminal rung (domain_sharded.sharded_exact_steps)."""
    d = jax.lax.axis_size(axis)
    perm = [(i, (i + 1) % d) for i in range(d)]
    okf = ok.astype(positions.dtype)

    def body(i, carry):
        acc, src_pos, src_v, src_ok = carry
        nxt_pos = jax.lax.ppermute(src_pos, axis, perm)
        nxt_v = jax.lax.ppermute(src_v, axis, perm)
        nxt_ok = jax.lax.ppermute(src_ok, axis, perm)
        acc = acc + allpairs_forces(positions, u, None, cfg,
                                    src_positions=src_pos, src_v=src_v,
                                    src_valid=src_ok > 0.0)
        return acc, nxt_pos, nxt_v, nxt_ok

    acc0 = jnp.zeros_like(positions)
    acc, _, _, _ = jax.lax.fori_loop(0, d, body, (acc0, positions, v, okf))
    return acc


def ring_forces_2level(positions, u, v, cfg: SimConfig,
                       ici_axis: str = AXIS, dcn_axis: str = "dcn"):
    """Hierarchical ring for 2-D (hosts x chips) meshes: the source block
    circulates the fast host-local ring within each host group; after each
    full revolution it hops once across the host axis. Total hops =
    D_ici * D_dcn, but only D_dcn of them cross the slow network — that
    traffic is
    1/D_ici of a naive flat ring. Call inside shard_map over both axes."""
    d_ici = jax.lax.axis_size(ici_axis)
    d_dcn = jax.lax.axis_size(dcn_axis)
    perm_ici = [(i, (i + 1) % d_ici) for i in range(d_ici)]
    perm_dcn = [(i, (i + 1) % d_dcn) for i in range(d_dcn)]

    def outer(_, carry):
        acc, src_pos, src_v = carry

        def inner(_, c):
            a, sp, sv = c
            np_ = jax.lax.ppermute(sp, ici_axis, perm_ici)
            nv_ = jax.lax.ppermute(sv, ici_axis, perm_ici)
            a = a + _block_forces(positions, u, sp, sv, cfg)
            return a, np_, nv_

        acc, src_pos, src_v = jax.lax.fori_loop(
            0, d_ici, inner, (acc, src_pos, src_v))
        # one cross-host hop per completed host-local revolution
        src_pos = jax.lax.ppermute(src_pos, dcn_axis, perm_dcn)
        src_v = jax.lax.ppermute(src_v, dcn_axis, perm_dcn)
        return acc, src_pos, src_v

    acc0 = jnp.zeros_like(positions)
    acc, _, _ = jax.lax.fori_loop(0, d_dcn, outer, (acc0, positions, v))
    return acc


def _ring_accel(positions, state: ParticleState, cfg: SimConfig, axis: str):
    u, v = F.pair_features(state, cfg)
    f = ring_forces(positions, u, v, cfg, axis=axis)
    return f * F.kick_scale(cfg)


def shard_state(state: ParticleState, mesh, axis: str = AXIS) -> ParticleState:
    """Place a state pytree particle-sharded over the mesh (dim 0 split)."""
    sh = particle_sharding(mesh, axis)
    return jax.tree.map(lambda a: jax.device_put(a, sh), state)


def sharded_step(state: ParticleState, cfg: SimConfig, dt, mesh,
                 axis: str = AXIS) -> ParticleState:
    """One simulation step with ring-sharded forces. ``state`` must be
    particle-sharded over ``mesh`` (N divisible by mesh size)."""
    n = state.n
    d = mesh.shape[axis]
    if n % d:
        raise ValueError(f"N={n} must be divisible by mesh axis size {d}")

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), jax.tree.map(lambda _: P(), cfg), P()),
        out_specs=P(axis),
        check_vma=False,  # pallas_call outputs carry no vma info
    )
    def run(st, cfg_in, dt_in):
        return _step(st, cfg_in, dt_in,
                     accel_fn=lambda p, s, c: _ring_accel(p, s, c, axis))

    return run(state, cfg, jnp.asarray(dt, jnp.float32))


@functools.partial(jax.jit, static_argnames=("num_steps", "axis", "mesh"),
                   donate_argnums=(0,))
def _sharded_simulate(state, cfg, dt, num_steps, mesh, axis):
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), jax.tree.map(lambda _: P(), cfg), P()),
        out_specs=P(axis),
        check_vma=False,  # pallas_call outputs carry no vma info
    )
    def run(st, cfg_in, dt_in):
        def body(s, _):
            return _step(s, cfg_in, dt_in,
                         accel_fn=lambda p, ss, c: _ring_accel(p, ss, c, axis)), None

        st, _ = jax.lax.scan(body, st, None, length=num_steps)
        return st

    return run(state, cfg, jnp.asarray(dt, jnp.float32))


def sharded_simulate(state: ParticleState, cfg: SimConfig, dt, num_steps: int,
                     mesh, axis: str = AXIS) -> ParticleState:
    """Run a whole sharded trajectory on device (scan inside shard_map:
    one compiled program, D-hop ring per step, no host round-trips)."""
    n = state.n
    d = mesh.shape[axis]
    if n % d:
        raise ValueError(f"N={n} must be divisible by mesh axis size {d}")
    return _sharded_simulate(state, cfg, dt, num_steps, mesh, axis)

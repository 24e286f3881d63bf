"""Compute-sharded cell-list forces: column-slab domain decomposition.

Scales the Pallas column-sweep cell kernel across a device mesh: the
supercell grid's (x, y) columns are split into contiguous slabs, one per
device; every device runs the kernel only over its slab and the per-slot
forces are ``all_gather``-ed back. State is replicated (compute- and
kernel-memory-sharded, not state-sharded — the ring backend in ring.py is
the memory-sharded alternative for all-pairs laws).

The slab trick: the kernel's neighbor-column index maps are compile-time
functions of the grid index, so instead of offsetting them per device, each
device ``jnp.roll``s the (periodic) column axis so its own slab sits at
column 0 — x-rotation preserves the neighbor structure of a wrapped box.
Periodic boxes only (wrap_forces=True).

Per-step collective: one all_gather of slot forces (N_slots x 3 f32) over
the interconnect; binning happens redundantly on every device at rebuild boundaries.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..config import SimConfig
from ..state import ParticleState
from ..ops import forces as FF
from ..ops.pallas_allpairs import PAIR_P, pack_params
from ..ops.pallas_celllist import (
    CellLayout, build_layout, slot_of_particle, _call,
)
from ..engine.step import step as _step
from .mesh import AXIS


def sharded_dense_forces(layout: CellLayout, pos_flat, cfg: SimConfig,
                         nsc: int, cap: int, axis: str = AXIS,
                         interpret: bool | None = None):
    """Forces for dense-layout positions, columns sharded over ``axis``.

    Call inside shard_map with replicated operands. Requires
    cfg.wrap_forces=True and nsc divisible by the mesh axis size.
    """
    if not cfg.wrap_forces:
        raise ValueError(
            "the column-roll compute decomposition supports periodic boxes "
            "only (its x-rotation relies on wrap symmetry); walled boxes "
            "run sharded via parallel.domain_sharded (state-sharded slabs, "
            "any N) or parallel.sharded_simulate (ring)")
    d = jax.lax.axis_size(axis)
    didx = jax.lax.axis_index(axis)
    ncol = nsc * nsc
    cs = nsc * cap
    assert nsc % d == 0, (nsc, d)
    planes_local = nsc // d
    cols_local = planes_local * nsc

    pos_r = pos_flat.reshape(ncol, cs, 3).astype(jnp.float32)
    pos_g = jnp.concatenate([pos_r[:, cs - cap:], pos_r, pos_r[:, :cap]], axis=1)

    # rotate the column axis so this device's slab starts at column 0;
    # x-rotation of a periodic box preserves all neighbor relations
    shift = didx * cols_local
    roll = lambda a: jnp.roll(a, -shift, axis=0)
    post_g = jnp.transpose(roll(pos_g), (0, 2, 1))
    rec_pos = jnp.transpose(roll(pos_r)[:cols_local], (0, 2, 1))
    rec_u = roll(layout.u_d)[:cols_local]
    vt_g = roll(layout.vt_g)
    r2_g = roll(layout.r2_g)

    params_f = pack_params(cfg)
    forces_local = _call(rec_pos, rec_u, post_g, vt_g, r2_g, params_f,
                         cfg.force_law, True, nsc, cap, interpret,
                         p_eff=FF.feature_dim(cfg))
    # device d owns global columns [d*cols_local, (d+1)*cols_local): the
    # all_gather concatenation in device order IS global column order
    forces_full = jax.lax.all_gather(forces_local, axis, tiled=True)
    return jnp.transpose(forces_full, (0, 2, 1)).reshape(-1, 3)


@functools.partial(jax.jit, static_argnames=(
    "num_steps", "rebuild_every", "nsc", "cap", "axis", "mesh"))
def sharded_cell_simulate(state: ParticleState, cfg: SimConfig, dt,
                          num_steps: int, mesh, rebuild_every: int = 8,
                          nsc: int | None = None, cap: int | None = None,
                          axis: str = AXIS):
    """Cadenced cell-list trajectory with column-sharded force compute.

    State enters/leaves replicated; each device computes its column slab's
    forces, one all_gather per step merges them. Returns
    (final_state, max_observed_drift).
    """
    if nsc is None:
        nsc = cfg.cell_grid
    if cap is None:
        cap = cfg.cell_capacity
    assert nsc is not None and cap is not None
    assert num_steps % rebuild_every == 0
    outer = num_steps // rebuild_every

    from ..ops.pallas_celllist import layout_drift

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), jax.tree.map(lambda _: P(), cfg), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(s, cfg_in, dt_in):
        def outer_body(carry, _):
            ss, max_drift = carry
            u, v = FF.pair_features(ss, cfg_in)
            layout = build_layout(ss.positions, u, v, cfg_in, nsc, cap)
            slot = layout.slot_particle.reshape(-1)
            present = slot >= 0
            safe = jnp.where(present, slot, 0)

            def to_dense(a):
                dd = a[safe]
                return jnp.where(
                    present.reshape((-1,) + (1,) * (a.ndim - 1)), dd,
                    jnp.zeros_like(dd))

            dense = ParticleState(
                positions=to_dense(ss.positions),
                velocities=to_dense(ss.velocities),
                species=to_dense(ss.species),
                masses=to_dense(ss.masses),
                accel=to_dense(ss.accel),
            )

            def accel_fn(positions, st, c):
                f = sharded_dense_forces(layout, positions, c, nsc, cap, axis)
                return f * FF.kick_scale(c)

            def inner(s2, _):
                return _step(s2, cfg_in, dt_in, accel_fn=accel_fn), None

            dense, _ = jax.lax.scan(inner, dense, None, length=rebuild_every)

            inv = slot_of_particle(layout, ss.n)
            ok = inv >= 0
            inv_safe = jnp.where(ok, inv, 0)

            def back(da, oa):
                g = da[inv_safe]
                return jnp.where(ok.reshape((-1,) + (1,) * (oa.ndim - 1)),
                                 g, oa)

            ss = ParticleState(
                positions=back(dense.positions, ss.positions),
                velocities=back(dense.velocities, ss.velocities),
                species=ss.species,
                masses=ss.masses,
                accel=back(dense.accel, ss.accel),
            )
            max_drift = jnp.maximum(
                max_drift, layout_drift(layout, ss.positions, cfg_in))
            return (ss, max_drift), None

        (ss, md), _ = jax.lax.scan(
            outer_body, (s, jnp.float32(0.0)), None, length=outer)
        return ss, md

    return run(state, cfg, jnp.asarray(dt, jnp.float32))

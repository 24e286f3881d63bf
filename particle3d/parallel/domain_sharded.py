"""State-sharded cell list: slab domain decomposition with halo exchange.

True domain decomposition for the cell-list production path (BASELINE
config 5 prerequisite): the supercell grid's x-planes are split into
contiguous slabs, one per device, and each device OWNS the dense slot rows
of its slab — per-chip state memory is O(N/D), unlike ``domain.py`` (which
shards only compute over replicated state) and ``ring.py`` (all-pairs laws).

Built on the incrementally-maintained dense layout (``ops.celllist_dense``):

  * **Forces**: each step the two edge x-planes of every slab are exchanged
    with the ring neighbors (one ``ppermute`` per direction of a
    packed [nsc*cs, pos|V|r2] plane buffer); the column-sweep kernel then
    runs with ``halo=True`` index maps — x neighbors are local offsets into
    the halo-extended source arrays, y and z stay periodic locally. Global
    x periodicity IS the ring. Walled boxes (``wrap_forces=False``) work
    too: the two edge slabs force-kill their wraparound halo plane (r2
    channel), y/z use dead ghosts instead of wrapped copies, and
    out-of-range y neighbors hit a masked dummy column — so walls are
    supported at any N, matching the reference's boundary surface
    (``src/lib.rs:70-127``).
  * **Rebind**: movers are classified by target slab. In-slab movers use the
    local free-slot placement (conservative currently-empty rule, see
    ``celllist_dense.rebind``). Slab-crossers are packed into fixed-size
    left/right outboxes, ``ppermute``-d to the neighbor, and placed there.
    Arrivals that find their cell full wait in a per-device LIMBO buffer
    and retry each step; limbo rows whose target moved to another slab
    re-enter the outbox stream.
  * **Overflow sidecar** (the slab port of the
    single-chip sidecar in ``ops/overflow.py``): capacity-overflow rows
    (in-slab placement failures left misaligned in their old slot, and
    in-slab limbo rows) go on a per-device worklist of up to ``ocap``
    entries and get their EXACT forces from bounded neighborhood sweeps
    (``overflow.slab_neighborhood_sweeps``) instead of the grid kernel —
    so slab cell capacity can hug the MEAN occupancy exactly like the
    single-chip production geometries ((24,32) at 262k, 40^3 at 1M).
    Sources come from the halo-extended plane pack the force kernel
    already exchanged (no extra plane traffic); cross-slab pairs are
    served by exchanging the small worklist payloads with the ring
    neighbors — each device then computes the reverse forces onto its OWN
    receivers from the combined set, so no force exchange is needed.
    Worklist rows integrate normally (limbo rows included). Only rows the
    sidecar cannot serve — out-of-slab binners stuck past the outbox,
    misplaced/limbo rows beyond ``ocap``, movers beyond ``mcap`` — go
    without pair forces, and the ``max_masked``/``max_limbo`` diagnostics
    count exactly those UNSERVED rows (served rows are exact, not
    trouble). Unserved-row semantics: with ``ocap > 0`` every row steps,
    so unserved rows COAST ballistically (zero pair force; gravity/drag
    still apply) — consistent with how capacity-masked slot rows have
    always behaved; with ``ocap=0`` limbo rows are not stepped at all
    (position-frozen) while masked slot rows still
    coast. Loss only past ``limbocap``, counted in ``lost``.

The reference's only parallelism is shared-memory rayon threads
(``src/lib.rs:141-164``); this is the multi-device counterpart.

Two usage shapes:

  * ``sharded_dense_simulate(state, cfg, dt, steps, mesh)`` — state enters
    and leaves replicated (convenient for tests and checkpoints).
  * stay-sharded multi-window runs (no replicated round trips)::

        carry = build_sharded_dense(state, cfg, mesh)
        for _ in range(windows):
            carry, diag = sharded_dense_steps(carry, cfg, dt, k, mesh)
        state = gather_sharded_dense(carry, state, cfg, mesh)

    The carry's arrays are globally-shaped but sharded over the mesh axis
    (each device holds only its slab's rows), so per-chip memory stays
    O(N/D) for the whole run. For truly huge N, replace the replicated
    build input with per-device initialization feeding the same carry
    layout.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..config import SimConfig
from ..state import ParticleState
from ..ops import forces as FF
from ..ops.pallas_allpairs import PAIR_P, pack_params, _r2_gate
from ..ops.pallas_celllist import _call
from ..ops.celllist_dense import (
    _POS, _VEL, _ACC, _U, _V, _WIDTH, bin_sid)
from ..ops.compaction import masked_indices
from ..engine.step import step as _step
from .mesh import AXIS


@dataclasses.dataclass(frozen=True)
class _Geom:
    """Static slab-decomposition geometry (python ints only)."""

    d: int
    nsc: int
    cap: int
    planes_local: int
    cols_local: int
    cs: int
    s_loc: int
    k_loc: int
    k_glob: int
    mcap: int
    migcap: int
    limbocap: int
    ocap: int
    interpret: bool
    wrap: bool


def _geometry(cfg: SimConfig, mesh, n: int, nsc, cap, mcap, migcap,
              limbocap, axis: str, interpret, ocap=None) -> _Geom:
    if nsc is None:
        nsc = cfg.cell_grid
    if cap is None:
        cap = cfg.cell_capacity
    assert nsc is not None and cap is not None, \
        "slab decomposition needs cfg.cell_grid / cfg.cell_capacity"
    d = mesh.shape[axis]
    if nsc % d:
        raise ValueError(f"nsc={nsc} must divide by mesh axis size {d}")
    planes_local = nsc // d
    cols_local = planes_local * nsc
    cs = nsc * cap
    if mcap is None:
        mcap = max(512, -(-max(n // (8 * d), 1) // 128) * 128)
    if migcap is None:
        migcap = max(256, mcap // 2)
    if limbocap is None:
        limbocap = migcap
    if ocap is None:
        # per-DEVICE sidecar budget (the worklists are per-slab; the
        # exchange ships up to ocap rows each way). The neighborhood sweep
        # needs distinct window cells (nsc >= 3) — tiny grids fall back to
        # the no-sidecar behavior rather than a wrong sweep.
        from ..ops.celllist_dense import OCAP
        ocap = OCAP if cfg.overflow_capacity is None else cfg.overflow_capacity
    if nsc < 3:
        ocap = 0
    return _Geom(d=d, nsc=nsc, cap=cap, planes_local=planes_local,
                 cols_local=cols_local, cs=cs, s_loc=cols_local * cs,
                 k_loc=cols_local * nsc, k_glob=nsc ** 3, mcap=mcap,
                 migcap=migcap, limbocap=limbocap, ocap=int(ocap),
                 interpret=bool(interpret), wrap=bool(cfg.wrap_forces))


def _assign_slots(pid, tgt_local, valid, k_loc: int, cap: int):
    """Rank rows per target cell and pick the r-th currently-free slot.

    Returns (order, dst, can): ``order`` sorts the rows by target cell;
    ``dst[i]`` is the slot for sorted row i (or s_loc when unplaceable);
    ``can`` marks placed sorted rows. Free slots are currently-empty only
    (see celllist_dense.rebind for why mover slots must not count).
    """
    m = tgt_local.shape[0]
    s_loc = pid.shape[0]
    key = jnp.where(valid, tgt_local, k_loc)
    order = jnp.argsort(key)
    key = key[order]
    valid_s = valid[order]
    iota = jnp.arange(m, dtype=jnp.int32)
    seg = jnp.concatenate([jnp.ones((1,), bool), key[1:] != key[:-1]])
    rank = iota - jax.lax.cummax(jnp.where(seg, iota, 0))
    free = (pid < 0).reshape(k_loc, cap)
    free_count = jnp.sum(free.astype(jnp.int32), axis=1)
    free_order = jnp.argsort(~free, axis=1, stable=True).astype(jnp.int32)
    kc = jnp.minimum(key, k_loc - 1)
    can = jnp.logical_and(valid_s, rank < free_count[kc])
    dst = jnp.where(
        can, kc * cap + free_order[kc, jnp.clip(rank, 0, cap - 1)], s_loc)
    return order, dst, can


def _local_build(s, cfg_in, g: _Geom, axis: str):
    """Per-device slab build from replicated state (inside shard_map).

    Returns (data, pid, limbo_data, limbo_pid, lost0)."""
    n = s.positions.shape[0]
    me = jax.lax.axis_index(axis)
    cell_lo = me * g.k_loc
    u, v = FF.pair_features(s, cfg_in, pad_p=PAIR_P)
    packed = jnp.concatenate(
        [s.positions.astype(jnp.float32),
         s.velocities.astype(jnp.float32),
         s.accel.astype(jnp.float32),
         u.astype(jnp.float32), v.astype(jnp.float32)], axis=1)
    sid = bin_sid(s.positions, cfg_in, g.nsc)
    slab = sid // (g.planes_local * g.nsc * g.nsc)
    mine = slab == me
    key = jnp.where(mine, sid, g.k_glob)
    order = jnp.argsort(key)
    key_s = key[order]
    starts = jnp.searchsorted(key_s, jnp.arange(g.k_glob + 1, dtype=key.dtype))
    rank = jnp.arange(n, dtype=jnp.int32) - starts[
        jnp.minimum(key_s, g.k_glob)].astype(jnp.int32)
    keep = jnp.logical_and(key_s < g.k_glob, rank < g.cap)
    flat = jnp.where(keep, (key_s - cell_lo) * g.cap + rank, g.s_loc)
    pid = jnp.full((g.s_loc + 1,), -1, jnp.int32)
    pid = pid.at[flat].set(order.astype(jnp.int32), mode="drop")[:-1]
    present = pid >= 0
    data = jnp.where(present[:, None], packed[jnp.where(present, pid, 0)], 0.0)

    # particles the initial build could not place (cell overflow) start in
    # limbo so they are never silently dropped
    unplaced = jnp.logical_and(key_s < g.k_glob, rank >= g.cap)
    li = masked_indices(unplaced, g.limbocap, fill_value=n)
    l_ok = li < n
    l_src = jnp.where(l_ok, order[jnp.minimum(li, n - 1)], 0)
    limbo_data = jnp.where(l_ok[:, None], packed[l_src], 0.0)
    limbo_pid = jnp.where(l_ok, l_src.astype(jnp.int32), -1)
    lost0 = jnp.maximum(
        jnp.sum(unplaced.astype(jnp.int32)) - jnp.sum(l_ok.astype(jnp.int32)),
        0)
    return data, pid, limbo_data, limbo_pid, lost0


def _initial_worklist(data, pid, limbo_data, limbo_pid, cfg_in, g: _Geom,
                      axis: str):
    """Sidecar worklist for a freshly-entered carry: combined indices
    (slots [0, s_loc), limbo [s_loc, s_loc+limbocap)) of rows the sidecar
    can serve — misaligned-but-in-slab slot occupants plus in-slab limbo
    rows — ascending, padded with the s_loc+limbocap sentinel. O(S) rank
    scan, run once per window; per-step maintenance comes from the move
    phase (the slab counterpart of ``celllist_dense.sidecar_indices``)."""
    sent = g.s_loc + g.limbocap
    if not g.ocap:
        return jnp.zeros((0,), jnp.int32)
    me = jax.lax.axis_index(axis)
    cell_lo = me * g.k_loc
    cell_of_slot = cell_lo + jnp.arange(g.s_loc, dtype=jnp.int32) // g.cap
    sid = bin_sid(data[:, _POS], cfg_in, g.nsc)
    tloc = sid - cell_lo
    mis_slot = jnp.logical_and(
        jnp.logical_and(pid >= 0, sid != cell_of_slot),
        jnp.logical_and(tloc >= 0, tloc < g.k_loc))
    lt = jnp.where(limbo_pid >= 0,
                   bin_sid(limbo_data[:, _POS], cfg_in, g.nsc) - cell_lo, -1)
    mis_lim = jnp.logical_and(lt >= 0, lt < g.k_loc)
    return masked_indices(jnp.concatenate([mis_slot, mis_lim]), g.ocap,
                          fill_value=sent)


def _make_step_body(cfg_in, dt_in, g: _Geom, axis: str, params_f,
                    species_dtype, masses_dtype, move_only: bool = False):
    """The per-step closure: halo forces (+ overflow sidecar) + integrate +
    rebind/migration. ``move_only`` skips forces+integration entirely —
    a pure layout-repair pass (``sharded_relayout``): positions are fixed,
    each pass ships out-of-slab rows one ring hop toward their target and
    retries placement."""
    perm_fwd = [(i, (i + 1) % g.d) for i in range(g.d)]   # to the RIGHT
    perm_bwd = [(i, (i - 1) % g.d) for i in range(g.d)]   # to the LEFT
    me = jax.lax.axis_index(axis)
    cell_lo = me * g.k_loc
    cell_global_of_slot = cell_lo + jnp.arange(g.s_loc, dtype=jnp.int32) // g.cap
    ocap = g.ocap
    sent = g.s_loc + g.limbocap            # worklist sentinel / drop index
    n_int = g.s_loc + (g.limbocap if ocap else 0)  # rows that integrate
    dummy_species = jnp.zeros((n_int,), species_dtype)
    dummy_masses = jnp.zeros((n_int,), masses_dtype)
    r2v = _r2_gate(cfg_in).astype(jnp.float32)
    nsc, cap, cs, cols_local = g.nsc, g.cap, g.cs, g.cols_local
    s_loc, k_loc, k_glob = g.s_loc, g.k_loc, g.k_glob
    mcap, migcap, limbocap, d = g.mcap, g.migcap, g.limbocap, g.d

    def halo_forces(pos_flat, dat, r2):
        pos_d = pos_flat.reshape(cols_local, cs, 3).astype(jnp.float32)
        if g.wrap:
            # fold stale wrap crossers to their cell's image (verlet /
            # leapfrog evaluate forces at post-boundary positions on the
            # pre-step layout); x centers use GLOBAL plane indices
            from ..ops.pallas_celllist import fold_to_cells

            wv0 = jnp.asarray(cfg_in.world_size, jnp.float32)
            pos_d = fold_to_cells(pos_d, wv0, nsc, cap,
                                  col0_x=me * (cols_local // nsc))
        v_d = dat[:, _V].reshape(cols_local, cs, PAIR_P)
        r2_d = r2.reshape(cols_local, cs)
        pack = jnp.concatenate(
            [pos_d, v_d, r2_d[:, :, None]], axis=-1)  # [cols, cs, 12]
        from_left = jax.lax.ppermute(pack[cols_local - nsc:], axis, perm_fwd)
        from_right = jax.lax.ppermute(pack[:nsc], axis, perm_bwd)
        if not g.wrap:
            # walled box: the ring's wraparound edge planes are not real
            # neighbors — device 0's left halo (from device d-1) and device
            # d-1's right halo (from device 0) are force-killed via their
            # r2 channel. Interior devices keep their halos untouched.
            from_left = from_left.at[..., -1].set(jnp.where(
                me == 0, -1.0, from_left[..., -1]))
            from_right = from_right.at[..., -1].set(jnp.where(
                me == d - 1, -1.0, from_right[..., -1]))
        else:
            # the ring's wraparound halos are periodic IMAGES: shift their
            # x channel a whole box so in-kernel deltas are true
            # displacements (halo mode applies no x image shift — see
            # pallas_celllist._kernel's column-level image scheme)
            wv = jnp.asarray(cfg_in.world_size, jnp.float32)
            from_left = from_left.at[..., 0].add(
                jnp.where(me == 0, -wv, 0.0))
            from_right = from_right.at[..., 0].add(
                jnp.where(me == d - 1, wv, 0.0))
        u_full = dat[:, _U].reshape(cols_local, cs, PAIR_P)

        def run_call(recv_pos, recv_u, ext):
            """One halo-mode kernel call: ext is [ncols_src, cs, 12] source
            planes LEADING and TRAILING with one halo/neighbor plane each
            (halo-mode nbr_map: source plane of receiver c = c//nsc+1+dx)."""
            pos_e = ext[..., :3]
            v_e = ext[..., 3:3 + PAIR_P]
            r2_e = ext[..., 3 + PAIR_P]
            if g.wrap:
                # coordinate-shifted z-ghost images (same scheme)
                zsh = jnp.zeros((3,), jnp.float32).at[2].set(wv)
                pos_g = jnp.concatenate(
                    [pos_e[:, cs - cap:] - zsh, pos_e, pos_e[:, :cap] + zsh],
                    axis=1)
                v_g = jnp.concatenate(
                    [v_e[:, cs - cap:], v_e, v_e[:, :cap]], axis=1)
                r2_gh = jnp.concatenate(
                    [r2_e[:, cs - cap:], r2_e, r2_e[:, :cap]], axis=1)
            else:
                # dead z ghosts (no z wrap), plus the fully-masked dummy
                # column the kernel's out-of-range y neighbors point at
                ncol_e = ext.shape[0]
                zpad3 = jnp.zeros((ncol_e, cap, 3), jnp.float32)
                zpadp = jnp.zeros((ncol_e, cap, PAIR_P), jnp.float32)
                mpad = jnp.full((ncol_e, cap), -1.0, jnp.float32)
                pos_g = jnp.concatenate([zpad3, pos_e, zpad3], axis=1)
                v_g = jnp.concatenate([zpadp, v_e, zpadp], axis=1)
                r2_gh = jnp.concatenate([mpad, r2_e, mpad], axis=1)
                gl = cs + 2 * cap
                pos_g = jnp.concatenate(
                    [pos_g, jnp.zeros((1, gl, 3), jnp.float32)], axis=0)
                v_g = jnp.concatenate(
                    [v_g, jnp.zeros((1, gl, PAIR_P), jnp.float32)], axis=0)
                r2_gh = jnp.concatenate(
                    [r2_gh, jnp.full((1, gl), -1.0, jnp.float32)], axis=0)
            out = _call(jnp.transpose(recv_pos, (0, 2, 1)),  # slot-minor
                        jnp.transpose(recv_u, (0, 2, 1)),
                        jnp.transpose(pos_g, (0, 2, 1)),
                        jnp.transpose(v_g, (0, 2, 1)),
                        r2_gh[:, None, :], params_f, cfg_in.force_law,
                        g.wrap, nsc, cap, g.interpret, halo=True,
                        p_eff=FF.feature_dim(cfg_in))
            return jnp.transpose(out, (0, 2, 1))

        planes = cols_local // nsc
        if d == 1 or planes < 3:
            # single-call path (1-device meshes / 2-plane slabs)
            ext = jnp.concatenate([from_left, pack, from_right], axis=0)
            return run_call(pos_d, u_full, ext).reshape(-1, 3), ext
        # Two-phase split (ROADMAP 14): the INTERIOR planes' sources are all
        # local (a plane's x neighbors are its slab neighbors), so their
        # kernel call has no data dependency on the ppermutes — XLA's async
        # collectives (collective-permute-start/done) can fly while the bulk
        # of the force work runs; only the two EDGE-plane calls consume the
        # halos. Exactness: the three receiver groups partition the local
        # planes, and each call's source window spans exactly the receiver
        # planes' +-1 neighborhoods (leading/trailing plane in each ext).
        out_int = run_call(pos_d[nsc:cols_local - nsc],
                           u_full[nsc:cols_local - nsc], pack)
        ext_l = jnp.concatenate([from_left, pack[:2 * nsc]], axis=0)
        out_l = run_call(pos_d[:nsc], u_full[:nsc], ext_l)
        ext_r = jnp.concatenate([pack[cols_local - 2 * nsc:], from_right],
                                axis=0)
        out_r = run_call(pos_d[cols_local - nsc:],
                         u_full[cols_local - nsc:], ext_r)
        # the sidecar reads the full halo-extended pack; assembling it here
        # is concat-only (the pieces already exist) and only the worklist's
        # bounded window gathers ever touch it
        ext = jnp.concatenate([from_left, pack, from_right], axis=0) \
            if ocap else None
        return jnp.concatenate([out_l, out_int, out_r],
                               axis=0).reshape(-1, 3), ext

    def body(carry, _):
        data, pid, limbo_data, limbo_pid, mis, mx_mov, mx_mask, mx_limbo, \
            lost, shipped = carry

        aligned = jnp.logical_and(
            pid >= 0,
            bin_sid(data[:, _POS], cfg_in, nsc) == cell_global_of_slot)
        r2 = jnp.where(aligned, r2v, -1.0)

        # -- integrate ---------------------------------------------------
        def sidecar_terms(pos_slot, pos_limbo, ext, c):
            """Overflow-sidecar forces (module docstring): exact forces ON
            the worklist rows (terms A+B, local prefix only) and their
            reverse forces onto local aligned receivers (term C).
            Worklist payloads (positions from ``pos_slot``/``pos_limbo`` —
            MID-STEP-fresh when a non-Euler integrator re-evaluates forces,
            exactly like the single-chip ``_sidecar_apply``'s
            ``positions[msafe]``; U/V features from the carried rows) are
            exchanged with the ring neighbors so cross-slab pairs are
            served on BOTH sides — each device computes forces onto its
            own receivers from the combined set (no reverse force exchange
            needed). Straight-line at full ocap width by design: dead
            entries contribute exact zeros (see engine.step._sidecar_apply
            for the measured cond-vs-straight-line motivation).

            Returns (f_mis [ocap, 3], f_from [s_loc, 3], slot_dst,
            lim_dst) — scatter destinations with drop sentinels split by
            worklist half."""
            from ..ops.overflow import slab_neighborhood_sweeps

            msafe = jnp.minimum(mis, sent - 1)
            mval = mis < sent
            is_lim = msafe >= s_loc
            li = jnp.clip(msafe - s_loc, 0, limbocap - 1)
            si = jnp.minimum(msafe, s_loc - 1)
            rows = jnp.where(is_lim[:, None], limbo_data[li], data[si])
            mpos = jnp.where(is_lim[:, None], pos_limbo[li], pos_slot[si])
            pay = jnp.concatenate(
                [mpos, rows[:, _U], rows[:, _V],
                 mval[:, None].astype(jnp.float32)], axis=1)
            if d == 1:
                comb = pay
            elif d == 2:
                # fwd and bwd reach the SAME neighbor — ship once
                comb = jnp.concatenate(
                    [pay, jax.lax.ppermute(pay, axis, perm_fwd)], axis=0)
            else:
                comb = jnp.concatenate(
                    [pay, jax.lax.ppermute(pay, axis, perm_fwd),
                     jax.lax.ppermute(pay, axis, perm_bwd)], axis=0)
            f_mis, f_from = slab_neighborhood_sweeps(
                ext, data[:, _U], comb[:, :3],
                comb[:, 3:3 + PAIR_P], comb[:, 3 + PAIR_P:3 + 2 * PAIR_P],
                comb[:, -1] > 0.0, c, nsc, g.planes_local, cap, me,
                self_ring=(d == 1))
            # terms A+B are only complete for the LOCAL prefix (neighbor
            # rows see partial windows here; their owner serves them)
            slot_dst = jnp.where(jnp.logical_and(mval, ~is_lim), msafe,
                                 s_loc)
            lim_dst = jnp.where(jnp.logical_and(mval, is_lim),
                                msafe - s_loc, limbocap)
            return f_mis[:ocap], f_from, slot_dst, lim_dst

        if move_only:
            pass  # transport only: positions/velocities untouched
        elif ocap and cfg_in.integrator == "euler":
            # Euler evaluates forces exactly once, at the pre-step state —
            # so compute the kernel + sidecar terms ONCE here and feed
            # them to two precomputed-accel integrations: the slot rows
            # and a SEPARATE small limbo step. The earlier variant
            # concatenated limbo rows onto the full slot arrays so one
            # _step covered both — measured ~17 ms/step of fixed O(slots)
            # concat/split traffic at the 2M point (probe_r5_slab2m).
            # Served limbo rows get their exact sidecar forces; unserved
            # ones integrate ballistically (zero pair force, never wrong);
            # dead limbo rows integrate garbage the move phase's limbo
            # rebuild discards below.
            fk, ext = halo_forces(data[:, _POS], data, r2)
            f_mis, f_from, slot_dst, lim_dst = sidecar_terms(
                data[:, _POS], limbo_data[:, _POS], ext, cfg_in)
            f_slot = (fk * (r2 > 0.0)[:, None] + f_from).at[slot_dst].add(
                f_mis, mode="drop") * FF.kick_scale(cfg_in)
            f_lim = jnp.zeros((limbocap, 3), jnp.float32).at[lim_dst].add(
                f_mis, mode="drop") * FF.kick_scale(cfg_in)
            ps = ParticleState(
                positions=data[:, _POS], velocities=data[:, _VEL],
                species=dummy_species[:s_loc], masses=dummy_masses[:s_loc],
                accel=data[:, _ACC])
            ps = _step(ps, cfg_in, dt_in, accel_fn=lambda p, s, c: f_slot)
            data = jnp.concatenate(
                [ps.positions, ps.velocities, ps.accel, data[:, 9:]], axis=1)
            pl_ = ParticleState(
                positions=limbo_data[:, _POS],
                velocities=limbo_data[:, _VEL],
                species=dummy_species[:limbocap],
                masses=dummy_masses[:limbocap],
                accel=limbo_data[:, _ACC])
            pl_ = _step(pl_, cfg_in, dt_in, accel_fn=lambda p, s, c: f_lim)
            limbo_data = jnp.concatenate(
                [pl_.positions, pl_.velocities, pl_.accel,
                 limbo_data[:, 9:]], axis=1)
        elif ocap:
            # non-Euler integrators re-evaluate forces at mid-step
            # positions, so the sidecar runs inside accel_fn on the
            # CONCATENATED slot+limbo state (slot worklist positions
            # fresh; the O(S) concat cost is the price of mid-step
            # freshness — Euler, the reference integrator, takes the fast
            # path above)
            def accel_fn(positions, st, c):
                f, ext = halo_forces(positions[:s_loc], data, r2)
                f = f * (r2 > 0.0)[:, None]
                f_mis, f_from, slot_dst, lim_dst = sidecar_terms(
                    positions[:s_loc], positions[s_loc:], ext, c)
                f = jnp.concatenate(
                    [(f + f_from).at[slot_dst].add(f_mis, mode="drop"),
                     jnp.zeros((limbocap, 3), f.dtype).at[lim_dst].add(
                         f_mis, mode="drop")], axis=0)
                return f * FF.kick_scale(c)

            ps = ParticleState(
                positions=jnp.concatenate(
                    [data[:, _POS], limbo_data[:, _POS]], axis=0),
                velocities=jnp.concatenate(
                    [data[:, _VEL], limbo_data[:, _VEL]], axis=0),
                species=dummy_species, masses=dummy_masses,
                accel=jnp.concatenate(
                    [data[:, _ACC], limbo_data[:, _ACC]], axis=0))
            ps = _step(ps, cfg_in, dt_in, accel_fn=accel_fn)
            data = jnp.concatenate(
                [ps.positions[:s_loc], ps.velocities[:s_loc],
                 ps.accel[:s_loc], data[:, 9:]], axis=1)
            limbo_data = jnp.concatenate(
                [ps.positions[s_loc:], ps.velocities[s_loc:],
                 ps.accel[s_loc:], limbo_data[:, 9:]], axis=1)
        else:
            def accel_fn(positions, st, c):
                f, _ = halo_forces(positions, data, r2)
                return f * (FF.kick_scale(c) * (r2 > 0.0)[:, None])

            ps = ParticleState(
                positions=data[:, _POS], velocities=data[:, _VEL],
                species=dummy_species, masses=dummy_masses,
                accel=data[:, _ACC])
            ps = _step(ps, cfg_in, dt_in, accel_fn=accel_fn)
            data = jnp.concatenate(
                [ps.positions, ps.velocities, ps.accel, data[:, 9:]], axis=1)

        # -- extract movers ----------------------------------------------
        occupied = pid >= 0
        sid_new = bin_sid(data[:, _POS], cfg_in, nsc)
        moved = jnp.logical_and(occupied, sid_new != cell_global_of_slot)
        n_mov = jnp.sum(moved.astype(jnp.int32))

        # limbo rows re-classify every step
        tgt_l = jnp.where(limbo_pid >= 0,
                          bin_sid(limbo_data[:, _POS], cfg_in, nsc), k_glob)

        def move_phase(mcap_e: int, migcap_e: int):
            """Mover extraction + outbox migration + placement, with every
            mover/outbox-sized op priced at the given static bounds. The
            2M-point ablation (docs/PERF.md "Slab carry") showed these row
            gathers/scatters ARE the slab step's cost — the lax.cond below
            runs this at half size on ordinary steps."""
            idx_m = masked_indices(moved, mcap_e, fill_value=s_loc)
            ok_m = idx_m < s_loc
            idx_ms = jnp.minimum(idx_m, s_loc - 1)
            tgt_m = jnp.where(ok_m, sid_new[idx_ms], k_glob)
            rows_m = data[idx_ms]
            pid_m = jnp.where(ok_m, pid[idx_ms], -1)

            all_tgt = jnp.concatenate([tgt_m, tgt_l])
            all_rows = jnp.concatenate([rows_m, limbo_data], axis=0)
            all_pid = jnp.concatenate([pid_m, limbo_pid])
            all_ok = all_pid >= 0
            tslab = jnp.minimum(all_tgt, k_glob - 1) \
                // (g.planes_local * nsc * nsc)
            in_slab = jnp.logical_and(all_ok, tslab == me)
            # route by RING DISTANCE, one hop toward the shorter direction
            # (round 5): a row targeting a non-adjacent slab ships hop by
            # hop through intermediate devices' limbo instead of freezing
            # in place forever — ±1 targets behave exactly as before, and
            # the exact terminal rung's relayout passes rely on multi-hop
            # routing to repair arbitrarily drifted layouts.
            dl = (me - tslab) % d                  # hops going LEFT
            dr = (tslab - me) % d                  # hops going RIGHT
            out = jnp.logical_and(all_ok, ~in_slab)
            go_left = jnp.logical_and(out, dl <= dr)
            go_right = jnp.logical_and(out, dr < dl)

            # -- outboxes (fixed size; unselected rows stay put/masked) --
            def pack_box(mask):
                bi = masked_indices(mask, migcap_e, fill_value=mask.shape[0])
                ok = bi < mask.shape[0]
                bis = jnp.minimum(bi, mask.shape[0] - 1)
                box_d = jnp.where(ok[:, None], all_rows[bis], 0.0)
                box_p = jnp.where(ok, all_pid[bis], -1)
                sel = jnp.zeros((mask.shape[0] + 1,), bool).at[bi].set(
                    True, mode="drop")[:-1]
                return box_d, box_p, sel

            boxL_d, boxL_p, selL = pack_box(go_left)
            boxR_d, boxR_p, selR = pack_box(go_right)
            sel_ship = jnp.logical_or(selL, selR)
            n_ship = jnp.sum((boxL_p >= 0).astype(jnp.int32)) + \
                jnp.sum((boxR_p >= 0).astype(jnp.int32))

            # free the slots of SHIPPED movers (first mcap_e rows are
            # movers). pid alone vacates the slot: stale data rows are
            # inert ghosts — pid=-1 makes the per-step alignment recompute
            # set r2=-1 (force-invisible as a source, garbage-masked as a
            # receiver) and the next placement overwrites the full row.
            # Same src-clear elision as celllist_dense's rebind row-op
            # diet; the ablation showed the mover-sized row scatters ARE
            # the slab step's cost driver.
            ship_src = jnp.where(sel_ship[:mcap_e], idx_m, s_loc)
            pid2 = pid.at[ship_src].set(-1, mode="drop")

            # -- pass A: place in-slab movers (mover rows only) ----------
            tgt_loc_m = jnp.where(
                in_slab[:mcap_e], all_tgt[:mcap_e] - cell_lo, -1)
            order_a, dst_a, can_a = _assign_slots(
                pid2, tgt_loc_m, in_slab[:mcap_e], k_loc, cap)
            src_a = jnp.where(can_a, idx_m[order_a], s_loc)
            vals_a = rows_m[order_a]
            pids_a = pid_m[order_a]
            pid2 = pid2.at[src_a].set(-1, mode="drop")  # data src-clear elided
            data2 = data.at[dst_a].set(vals_a, mode="drop")
            pid2 = pid2.at[dst_a].set(
                jnp.where(can_a, pids_a, -1), mode="drop")
            # sidecar worklist, slot half: in-slab movers that failed
            # placement stay misaligned in their old slot — the sidecar
            # serves them next step (celllist_dense.rebind's `fail` rule)
            if ocap:
                fail_a = jnp.logical_and(in_slab[:mcap_e][order_a], ~can_a)
                mis_slot = jnp.where(fail_a, idx_m[order_a], sent)

            # -- exchange outboxes ---------------------------------------
            inL_d = jax.lax.ppermute(boxR_d, axis, perm_fwd)
            inL_p = jax.lax.ppermute(boxR_p, axis, perm_fwd)
            inR_d = jax.lax.ppermute(boxL_d, axis, perm_bwd)
            inR_p = jax.lax.ppermute(boxL_p, axis, perm_bwd)

            # -- pass B: place arrivals + retryable limbo ----------------
            limbo_keep_mask = jnp.logical_and(
                limbo_pid >= 0, ~sel_ship[mcap_e:])
            arr_d = jnp.concatenate([inL_d, inR_d, limbo_data], axis=0)
            arr_p = jnp.concatenate(
                [inL_p, inR_p, jnp.where(limbo_keep_mask, limbo_pid, -1)])
            arr_tgt = jnp.where(
                arr_p >= 0,
                bin_sid(arr_d[:, _POS], cfg_in, nsc) - cell_lo, -1)
            arr_valid = jnp.logical_and(
                arr_p >= 0, jnp.logical_and(arr_tgt >= 0, arr_tgt < k_loc))
            order_b, dst_b, can_b = _assign_slots(
                pid2, arr_tgt, arr_valid, k_loc, cap)
            data2 = data2.at[dst_b].set(arr_d[order_b], mode="drop")
            pid2 = pid2.at[dst_b].set(
                jnp.where(can_b, arr_p[order_b], -1), mode="drop")

            # -- new limbo: unplaced arrivals (incl. out-of-slab leftovers)
            left_p = jnp.where(can_b, -1, arr_p[order_b])
            left_d = arr_d[order_b]
            li2 = masked_indices(left_p >= 0, limbocap,
                                 fill_value=left_p.shape[0])
            l_ok2 = li2 < left_p.shape[0]
            lis = jnp.minimum(li2, left_p.shape[0] - 1)
            limbo_data2 = jnp.where(l_ok2[:, None], left_d[lis], 0.0)
            limbo_pid2 = jnp.where(l_ok2, left_p[lis], -1)
            n_limbo = jnp.sum((limbo_pid2 >= 0).astype(jnp.int32))
            lost_inc = jnp.maximum(
                jnp.sum((left_p >= 0).astype(jnp.int32)) - n_limbo, 0)
            # sidecar worklist, limbo half + compaction to combined indices
            if ocap:
                lt2 = jnp.where(
                    limbo_pid2 >= 0,
                    bin_sid(limbo_data2[:, _POS], cfg_in, nsc) - cell_lo, -1)
                l_serve = jnp.logical_and(lt2 >= 0, lt2 < k_loc)
                mis_lim = jnp.where(
                    l_serve,
                    s_loc + jnp.arange(limbocap, dtype=jnp.int32), sent)
                cand = jnp.concatenate([mis_slot, mis_lim])
                cl = cand.shape[0]
                ci = masked_indices(cand < sent, ocap, fill_value=cl)
                mis2 = jnp.where(ci < cl,
                                 cand[jnp.minimum(ci, cl - 1)], sent)
            else:
                mis2 = jnp.zeros((0,), jnp.int32)
            return (data2, pid2, limbo_data2, limbo_pid2, n_ship, n_limbo,
                    lost_inc, mis2)

        # Bounded-work fast path (the slab counterpart of rebind's): when
        # this step's movers fit in mcap/2 AND each outbox direction's
        # crossers fit in migcap/2 — ON EVERY DEVICE (pmin agreement, so
        # the branch with its differently-shaped ppermutes is collective-
        # consistent) — run the pipeline at half static size. masked_indices
        # is ascending, so the half prefix provably holds every mover;
        # results are identical to the full-size branch. Sizes stay
        # 128-aligned for the lane-parallel compaction fast path.
        half_m = mcap // 2 // 128 * 128
        half_g = migcap // 2 // 128 * 128
        if half_m >= 512 and half_g >= 128:
            # same ring-distance routing rule as move_phase (the gate must
            # never under-count a direction the phase will actually ship)
            pl3 = g.planes_local * nsc * nsc
            t_slab = jnp.minimum(sid_new, k_glob - 1) // pl3
            cross = jnp.logical_and(moved, t_slab != me)
            dl_c = (me - t_slab) % d
            dr_c = (t_slab - me) % d
            cl = jnp.logical_and(cross, dl_c <= dr_c)
            cr = jnp.logical_and(cross, dr_c < dl_c)
            l_slab = jnp.minimum(tgt_l, k_glob - 1) // pl3
            l_out = jnp.logical_and(limbo_pid >= 0, l_slab != me)
            dl_l = (me - l_slab) % d
            dr_l = (l_slab - me) % d
            ll = jnp.logical_and(l_out, dl_l <= dr_l)
            lr = jnp.logical_and(l_out, dr_l < dl_l)
            nL = jnp.sum(cl.astype(jnp.int32)) + \
                jnp.sum(ll.astype(jnp.int32))
            nR = jnp.sum(cr.astype(jnp.int32)) + \
                jnp.sum(lr.astype(jnp.int32))
            fits = jnp.logical_and(
                n_mov <= half_m,
                jnp.logical_and(nL <= half_g, nR <= half_g))
            all_fit = jax.lax.pmin(fits.astype(jnp.int32), axis) > 0
            (data, pid, limbo_data, limbo_pid, n_ship, n_limbo,
             lost_inc, mis) = jax.lax.cond(
                all_fit,
                lambda: move_phase(half_m, half_g),
                lambda: move_phase(mcap, migcap))
        else:
            (data, pid, limbo_data, limbo_pid, n_ship, n_limbo,
             lost_inc, mis) = move_phase(mcap, migcap)
        lost = lost + lost_inc

        n_mask = jnp.sum(jnp.logical_and(
            pid >= 0,
            bin_sid(data[:, _POS], cfg_in, nsc) != cell_global_of_slot
        ).astype(jnp.int32))
        if ocap:
            # served rows are exact — mask/limbo diagnostics count only
            # UNSERVED (force-frozen) rows (worklist slot entries are
            # misaligned by construction, limbo entries live, so the
            # subtractions cannot go negative)
            n_mask = n_mask - jnp.sum((mis < s_loc).astype(jnp.int32))
            n_limbo = n_limbo - jnp.sum(jnp.logical_and(
                mis >= s_loc, mis < sent).astype(jnp.int32))

        return (data, pid, limbo_data, limbo_pid, mis,
                jnp.maximum(mx_mov, n_mov), jnp.maximum(mx_mask, n_mask),
                jnp.maximum(mx_limbo, n_limbo), lost,
                shipped + n_ship), None

    return body


def _reduce_diag(mx_mov, mx_mask, mx_limbo, lost, shipped, axis):
    return (jax.lax.pmax(mx_mov, axis), jax.lax.pmax(mx_mask, axis),
            jax.lax.pmax(mx_limbo, axis), jax.lax.psum(lost, axis),
            jax.lax.psum(shipped, axis))


def _gather_state(data, pid, limbo_data, limbo_pid, s, axis):
    """all_gather the slab rows back to a replicated particle-order state."""
    n = s.positions.shape[0]
    data_all = jax.lax.all_gather(data, axis, tiled=True)
    pid_all = jax.lax.all_gather(pid, axis, tiled=True)
    ld_all = jax.lax.all_gather(limbo_data, axis, tiled=True)
    lp_all = jax.lax.all_gather(limbo_pid, axis, tiled=True)

    def back(col, src_data, src_pid, base):
        idx = jnp.where(src_pid >= 0, src_pid, n)
        return jnp.pad(base, ((0, 1), (0, 0))).at[idx].set(
            src_data[:, col], mode="drop")[:n]

    out = s
    for name, col in (("positions", _POS), ("velocities", _VEL),
                      ("accel", _ACC)):
        base = getattr(s, name).astype(jnp.float32)
        a = back(col, data_all, pid_all, base)
        a = back(col, ld_all, lp_all, a)
        out = out.replace(**{name: a})
    return out


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=(
    "num_steps", "nsc", "cap", "mcap", "migcap", "limbocap", "axis", "mesh",
    "interpret", "ocap"))
def sharded_dense_simulate(state: ParticleState, cfg: SimConfig, dt,
                           num_steps: int, mesh, nsc: int | None = None,
                           cap: int | None = None, mcap: int | None = None,
                           migcap: int | None = None,
                           limbocap: int | None = None, axis: str = AXIS,
                           interpret: bool | None = None,
                           ocap: int | None = None):
    """State-sharded exact cell-list trajectory (module docstring).

    Returns ``(final_state, (max_movers, max_masked, max_limbo, lost,
    shipped_total))`` — per-device maxima / totals psum-reduced over the
    mesh. Requires ``nsc % mesh_size == 0``; periodic and walled boxes
    both supported. ``max_masked``/``max_limbo`` count only rows the
    overflow sidecar could NOT serve (``ocap`` is the per-device sidecar
    budget, default ``cfg.overflow_capacity`` or ``celllist_dense.OCAP``;
    0 disables the sidecar)."""
    n = state.positions.shape[0]
    g = _geometry(cfg, mesh, n, nsc, cap, mcap, migcap, limbocap, axis,
                  interpret, ocap)
    params_f = pack_params(cfg)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), jax.tree.map(lambda _: P(), cfg), P()),
        out_specs=(P(), (P(), P(), P(), P(), P())),
        check_vma=False,
    )
    def run(s, cfg_in, dt_in):
        data, pid, limbo_data, limbo_pid, lost0 = _local_build(
            s, cfg_in, g, axis)
        body = _make_step_body(cfg_in, dt_in, g, axis, params_f,
                               s.species.dtype, jnp.float32)
        mis0 = _initial_worklist(data, pid, limbo_data, limbo_pid, cfg_in,
                                 g, axis)
        carry0 = (data, pid, limbo_data, limbo_pid, mis0,
                  jnp.int32(0), jnp.int32(0), jnp.int32(0), lost0,
                  jnp.int32(0))
        (data, pid, limbo_data, limbo_pid, _, mx_mov, mx_mask, mx_limbo,
         lost, shipped), _ = jax.lax.scan(body, carry0, None,
                                          length=num_steps)
        out = _gather_state(data, pid, limbo_data, limbo_pid, s, axis)
        return out, _reduce_diag(mx_mov, mx_mask, mx_limbo, lost, shipped,
                                 axis)

    return run(state, cfg, jnp.asarray(dt, jnp.float32))


@functools.partial(jax.jit, static_argnames=(
    "nsc", "cap", "mcap", "migcap", "limbocap", "axis", "mesh", "interpret"))
def build_sharded_dense(state: ParticleState, cfg: SimConfig, mesh,
                        nsc: int | None = None, cap: int | None = None,
                        mcap: int | None = None, migcap: int | None = None,
                        limbocap: int | None = None, axis: str = AXIS,
                        interpret: bool | None = None):
    """Build the stay-sharded carry from a replicated state.

    Returns ``(data, pid, limbo_data, limbo_pid, lost)`` where the arrays
    are globally shaped ([D*s_loc, ...], [D*limbocap, ...]) but sharded over
    ``axis`` — each device materializes only its slab.
    """
    n = state.positions.shape[0]
    g = _geometry(cfg, mesh, n, nsc, cap, mcap, migcap, limbocap, axis,
                  interpret)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), jax.tree.map(lambda _: P(), cfg)),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        check_vma=False,
    )
    def run(s, cfg_in):
        data, pid, limbo_data, limbo_pid, lost0 = _local_build(
            s, cfg_in, g, axis)
        return data, pid, limbo_data, limbo_pid, jax.lax.psum(lost0, axis)

    return run(state, cfg)


@functools.partial(jax.jit, static_argnames=(
    "n", "nsc", "cap", "mcap", "migcap", "limbocap", "axis", "mesh",
    "interpret"))
def init_sharded_dense(key, n: int, cfg: SimConfig, mesh,
                       nsc: int | None = None, cap: int | None = None,
                       mcap: int | None = None, migcap: int | None = None,
                       limbocap: int | None = None, axis: str = AXIS,
                       interpret: bool | None = None):
    """Initialize a uniform random scene DIRECTLY into the sharded carry —
    no O(N)-replicated stage anywhere (the config-5 16M entry point).

    Each device draws its n/D particles with x confined to its own slab
    (equal slab volumes → the same uniform density as a global draw, with
    per-slab counts fixed at n/D instead of multinomial) and builds its
    local layout from the n/D-sized sort. Particle ids are globally unique
    (device offset). Requires n % D == 0.
    """
    g = _geometry(cfg, mesh, n, nsc, cap, mcap, migcap, limbocap, axis,
                  interpret)
    if n % g.d:
        raise ValueError(f"N={n} must divide by mesh size {g.d}")
    n_loc = n // g.d

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), jax.tree.map(lambda _: P(), cfg)),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        check_vma=False,
    )
    def run(key_in, cfg_in):
        me = jax.lax.axis_index(axis)
        k = jax.random.fold_in(key_in, me)
        kp, ks = jax.random.split(k)
        w = jnp.asarray(cfg_in.world_size, jnp.float32)
        slab_w = w / g.d
        x_lo = -0.5 * w + me.astype(jnp.float32) * slab_w
        pos = jax.random.uniform(kp, (n_loc, 3), jnp.float32,
                                 minval=-0.5, maxval=0.5)
        pos = pos.at[:, 0].set(
            x_lo + (pos[:, 0] + 0.5) * slab_w).at[:, 1:].multiply(w)
        species = jax.random.randint(ks, (n_loc,), 0, cfg_in.id_count)
        s_local = ParticleState(
            positions=pos,
            velocities=jnp.zeros((n_loc, 3), jnp.float32),
            species=species.astype(jnp.int32),
            masses=jnp.ones((n_loc,), jnp.float32),
            accel=jnp.zeros((n_loc, 3), jnp.float32))
        data, pid, limbo_data, limbo_pid, lost0 = _local_build(
            s_local, cfg_in, g, axis)
        # globalize the particle ids (local build numbers them 0..n_loc)
        off = (me * n_loc).astype(jnp.int32)
        pid = jnp.where(pid >= 0, pid + off, pid)
        limbo_pid = jnp.where(limbo_pid >= 0, limbo_pid + off, limbo_pid)
        return data, pid, limbo_data, limbo_pid, jax.lax.psum(lost0, axis)

    return run(key, cfg)


@functools.partial(jax.jit, static_argnames=(
    "num_steps", "nsc", "cap", "mcap", "migcap", "axis", "mesh", "interpret",
    "n", "ocap"))
def sharded_dense_steps(carry, cfg: SimConfig, dt, num_steps: int, mesh,
                        nsc: int | None = None, cap: int | None = None,
                        mcap: int | None = None, migcap: int | None = None,
                        axis: str = AXIS, interpret: bool | None = None,
                        n: int | None = None, ocap: int | None = None):
    """Advance a stay-sharded carry by ``num_steps`` (no replicated round
    trip). Returns ``(carry, (max_movers, max_masked, max_limbo, lost,
    shipped))`` with ``lost``/``shipped`` counted for this window only;
    mask/limbo count only rows the overflow sidecar could not serve.

    Pass ``n`` (the true particle count) so the mover/outbox pipelines get
    the same static sizes as ``sharded_dense_simulate`` for that N — the
    mover-sized ops are the rebind cost driver (celllist_dense.py). Without
    it the bound falls back to the slot count (nsc^3 * cap >= N):
    conservative, never wrong, but larger static ops."""
    data, pid, limbo_data, limbo_pid, lost_prev = carry
    d = mesh.shape[axis]
    limbocap = limbo_pid.shape[0] // d
    n_hint = pid.shape[0] if n is None else n
    g = _geometry(cfg, mesh, n_hint, nsc, cap, mcap, migcap, limbocap, axis,
                  interpret, ocap)
    params_f = pack_params(cfg)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis),
                  jax.tree.map(lambda _: P(), cfg), P()),
        out_specs=((P(axis), P(axis), P(axis), P(axis), P()),
                   (P(), P(), P(), P(), P())),
        check_vma=False,
    )
    def run(data, pid, limbo_data, limbo_pid, cfg_in, dt_in):
        body = _make_step_body(cfg_in, dt_in, g, axis, params_f,
                               jnp.int32, jnp.float32)
        mis0 = _initial_worklist(data, pid, limbo_data, limbo_pid, cfg_in,
                                 g, axis)
        carry0 = (data, pid, limbo_data, limbo_pid, mis0,
                  jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0),
                  jnp.int32(0))
        (data, pid, limbo_data, limbo_pid, _, mx_mov, mx_mask, mx_limbo,
         lost, shipped), _ = jax.lax.scan(body, carry0, None,
                                          length=num_steps)
        diag = _reduce_diag(mx_mov, mx_mask, mx_limbo, lost, shipped, axis)
        return (data, pid, limbo_data, limbo_pid,
                jax.lax.psum(lost, axis)), diag

    (data, pid, limbo_data, limbo_pid, lost), diag = run(
        data, pid, limbo_data, limbo_pid, cfg, jnp.asarray(dt, jnp.float32))
    return (data, pid, limbo_data, limbo_pid, lost_prev + lost), diag


@functools.partial(jax.jit, static_argnames=(
    "nsc", "cap_old", "cap_new", "limbocap_new", "axis", "mesh"))
def recap_sharded_dense(carry, cfg: SimConfig, mesh, nsc: int, cap_old: int,
                        cap_new: int, limbocap_new: int | None = None,
                        axis: str = AXIS):
    """Grow a stay-sharded carry's per-cell capacity (and optionally its
    limbo capacity) IN PLACE of a rebuild: every cell's slot block pads
    from ``cap_old`` to ``cap_new`` rows and occupants keep their slots.
    Limbo rows whose target cell is in-slab are DRAINED into the grown
    cells immediately — limbo rows beyond ``ocap`` get no pair forces
    (module docstring), so leaving them for the next step's placement
    pass would keep the very inexactness the escalation rewound for. Fully sharded — nothing is replicated. Used
    by ``sharded_dense_adaptive``'s escalation ladder."""
    if cap_new < cap_old:
        raise ValueError("recap only grows: cap_new >= cap_old")
    data, pid, limbo_data, limbo_pid, lost = carry
    d = mesh.shape[axis]
    lc_old = limbo_pid.shape[0] // d
    lc_new = lc_old if limbocap_new is None else max(limbocap_new, lc_old)
    k_loc_g = nsc // d * nsc * nsc

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis),
                  jax.tree.map(lambda _: P(), cfg)),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    def run(data, pid, ld, lp, cfg_in):
        k_loc = pid.shape[0] // cap_old
        c = data.shape[1]
        d3 = jnp.pad(data.reshape(k_loc, cap_old, c),
                     ((0, 0), (0, cap_new - cap_old), (0, 0)))
        data = d3.reshape(-1, c)
        pid = jnp.pad(pid.reshape(k_loc, cap_old),
                      ((0, 0), (0, cap_new - cap_old)),
                      constant_values=-1).reshape(-1)
        ld = jnp.pad(ld, ((0, lc_new - lc_old), (0, 0)))
        lp = jnp.pad(lp, ((0, lc_new - lc_old),), constant_values=-1)

        # drain in-slab limbo rows into the grown cells (same placement
        # rule as the step's pass B); cross-slab limbo rows stay and ship
        # through the next step's outboxes
        me = jax.lax.axis_index(axis)
        cell_lo = me * k_loc_g
        tgt = jnp.where(lp >= 0,
                        bin_sid(ld[:, _POS], cfg_in, nsc) - cell_lo, -1)
        valid = jnp.logical_and(lp >= 0,
                                jnp.logical_and(tgt >= 0, tgt < k_loc))
        order, dst, can = _assign_slots(pid, tgt, valid, k_loc, cap_new)
        data = data.at[dst].set(ld[order], mode="drop")
        pid = pid.at[dst].set(jnp.where(can, lp[order], -1), mode="drop")
        keep = jnp.where(can, -1, lp[order])
        return data, pid, ld[order], keep

    data, pid, limbo_data, limbo_pid = run(data, pid, limbo_data,
                                           limbo_pid, cfg)
    return (data, pid, limbo_data, limbo_pid, lost)


@functools.partial(jax.jit, static_argnames=(
    "num_steps", "rcap", "axis", "mesh"))
def sharded_exact_steps(carry, cfg: SimConfig, dt, num_steps: int, mesh,
                        rcap: int, axis: str = AXIS):
    """Capacity-free EXACT window on a stay-sharded carry — the slab
    adaptive driver's DE-REPLICATED terminal rung (round 5).

    Each device compacts its live rows (occupied slots + live limbo) into
    an ``rcap``-row buffer and runs ``num_steps`` of ring all-pairs
    (``parallel.ring.ring_forces_masked``): position/V/validity blocks
    circulate the mesh once per step, so every receiver sees every source
    with per-device memory O(rcap) = O(N/D) — no all-gather, no
    replicated state, unlike the round-4 rung that gathered 16M particles
    to every chip at exactly the scale the slab decomposition exists for.
    Pair features come from the rows' own U/V columns, so no particle-
    order template state is needed. Rows keep their slots for the whole
    window (slots are just storage here — alignment is irrelevant to the
    ring); ``sharded_relayout`` repairs the layout afterwards.

    ``rcap`` must cover every device's live rows: callers compute it from
    the carry (live counts are exact at call time — no migration happens
    inside the window) and the returned ``overflow`` (psum over devices)
    MUST be zero for the window to be exact; the adaptive driver treats
    overflow as a rewind trigger. Reference semantics: every particle
    feels every in-range force every step (src/lib.rs:171-243).

    Returns ``(carry, overflow)``."""
    from .ring import ring_forces_masked

    data, pid, limbo_data, limbo_pid, lost = carry
    d = mesh.shape[axis]
    s_loc = pid.shape[0] // d
    limbocap = limbo_pid.shape[0] // d
    nl = s_loc + limbocap

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis),
                  jax.tree.map(lambda _: P(), cfg), P()),
        out_specs=((P(axis), P(axis), P(axis), P(axis)), P()),
        check_vma=False,
    )
    def run(data, pid, ld, lp, cfg_in, dt_in):
        live = jnp.concatenate([pid >= 0, lp >= 0])
        idx = masked_indices(live, rcap, fill_value=nl)
        ok = idx < nl
        idxs = jnp.minimum(idx, nl - 1)
        is_lim = idxs >= s_loc
        rows = jnp.where(
            is_lim[:, None],
            ld[jnp.clip(idxs - s_loc, 0, limbocap - 1)],
            data[jnp.minimum(idxs, s_loc - 1)])
        rows = jnp.where(ok[:, None], rows, 0.0)
        overflow = jnp.sum(live.astype(jnp.int32)) \
            - jnp.sum(ok.astype(jnp.int32))
        u = rows[:, _U]
        v = rows[:, _V]

        def accel_fn(positions, st, c):
            f = ring_forces_masked(positions, u, v, ok, c, axis=axis)
            return f * FF.kick_scale(c)

        ps = ParticleState(positions=rows[:, _POS],
                           velocities=rows[:, _VEL],
                           species=jnp.zeros((rcap,), jnp.int32),
                           masses=jnp.zeros((rcap,), jnp.float32),
                           accel=rows[:, _ACC])

        def body(s, _):
            return _step(s, cfg_in, dt_in, accel_fn=accel_fn), None

        ps, _ = jax.lax.scan(body, ps, None, length=num_steps)
        new9 = jnp.concatenate(
            [ps.positions, ps.velocities, ps.accel], axis=1)
        slot_dst = jnp.where(jnp.logical_and(ok, ~is_lim), idxs, s_loc)
        lim_dst = jnp.where(jnp.logical_and(ok, is_lim),
                            idxs - s_loc, limbocap)
        data = data.at[slot_dst, :9].set(new9, mode="drop")
        ld = ld.at[lim_dst, :9].set(new9, mode="drop")
        return (data, pid, ld, lp), jax.lax.psum(overflow, axis)

    (data, pid, limbo_data, limbo_pid), overflow = run(
        data, pid, limbo_data, limbo_pid, cfg, jnp.asarray(dt, jnp.float32))
    return (data, pid, limbo_data, limbo_pid, lost), overflow


@functools.partial(jax.jit, static_argnames=(
    "passes", "nsc", "cap", "mcap", "migcap", "axis", "mesh", "interpret",
    "n", "ocap"))
def sharded_relayout(carry, cfg: SimConfig, mesh, passes: int = 1,
                     nsc: int | None = None, cap: int | None = None,
                     mcap: int | None = None, migcap: int | None = None,
                     axis: str = AXIS, interpret: bool | None = None,
                     n: int | None = None, ocap: int | None = None):
    """Migration-only layout repair: ``passes`` transport passes of the
    step body with forces+integration skipped (positions/velocities
    untouched — committing a relayout never changes physics). Each pass
    ships every out-of-slab row one ring hop toward its target slab
    (ring-distance routing) and retries placement, so ``d // 2 + 1``
    passes route anything the mover/outbox bounds allow — used to re-enter
    the grid path after ``sharded_exact_steps`` windows let rows drift
    arbitrarily far from their slots.

    Returns ``(carry, (servable_max, unservable, lost))`` computed on the
    FINAL layout: ``servable_max`` is the max per-device count of rows the
    overflow sidecar could serve next window (in-slab misaligned slot rows
    + in-slab limbo rows), ``unservable`` the global count of rows still
    binning out of their device's slab. The grid path is re-enterable iff
    ``unservable == 0 and servable_max <= ocap``.

    CALLERS MUST CHECK ``lost``: a pass whose arrivals overflow the limbo
    capacity drops rows PERMANENTLY (exact windows can park many rows far
    from their slabs, so transit through intermediate limbo can burst past
    a limbocap that was ample for grid-path stepping). On ``lost > 0``
    discard the returned carry, grow the pre-relayout carry's limbocap
    (``recap_sharded_dense(..., limbocap_new=...)``) and retry — the
    adaptive driver's ``relayout_guarded`` does exactly this."""
    data, pid, limbo_data, limbo_pid, lost_prev = carry
    d = mesh.shape[axis]
    limbocap = limbo_pid.shape[0] // d
    n_hint = pid.shape[0] if n is None else n
    g = _geometry(cfg, mesh, n_hint, nsc, cap, mcap, migcap, limbocap, axis,
                  interpret, ocap)
    params_f = pack_params(cfg)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis),
                  jax.tree.map(lambda _: P(), cfg)),
        out_specs=((P(axis), P(axis), P(axis), P(axis), P()),
                   (P(), P(), P())),
        check_vma=False,
    )
    def run(data, pid, limbo_data, limbo_pid, cfg_in):
        body = _make_step_body(cfg_in, jnp.float32(0.0), g, axis, params_f,
                               jnp.int32, jnp.float32, move_only=True)
        mis0 = _initial_worklist(data, pid, limbo_data, limbo_pid, cfg_in,
                                 g, axis)
        carry0 = (data, pid, limbo_data, limbo_pid, mis0,
                  jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0),
                  jnp.int32(0))
        (data, pid, limbo_data, limbo_pid, _, _, _, _, lost,
         _), _ = jax.lax.scan(body, carry0, None, length=passes)
        # final-layout serveability (the re-entry probe's criterion)
        me = jax.lax.axis_index(axis)
        cell_lo = me * g.k_loc
        cell_of = cell_lo + jnp.arange(g.s_loc, dtype=jnp.int32) // g.cap
        sid = bin_sid(data[:, _POS], cfg_in, g.nsc)
        mis_slot = jnp.logical_and(pid >= 0, sid != cell_of)
        in_slab = jnp.logical_and(sid - cell_lo >= 0,
                                  sid - cell_lo < g.k_loc)
        lt = jnp.where(limbo_pid >= 0,
                       bin_sid(limbo_data[:, _POS], cfg_in, g.nsc)
                       - cell_lo, -1)
        l_live = limbo_pid >= 0
        l_in = jnp.logical_and(lt >= 0, lt < g.k_loc)
        servable = jnp.sum(jnp.logical_and(mis_slot, in_slab)
                           .astype(jnp.int32)) \
            + jnp.sum(jnp.logical_and(l_live, l_in).astype(jnp.int32))
        unserv = jnp.sum(jnp.logical_and(mis_slot, ~in_slab)
                         .astype(jnp.int32)) \
            + jnp.sum(jnp.logical_and(l_live, ~l_in).astype(jnp.int32))
        return ((data, pid, limbo_data, limbo_pid,
                 jax.lax.psum(lost, axis)),
                (jax.lax.pmax(servable, axis), jax.lax.psum(unserv, axis),
                 jax.lax.psum(lost, axis)))

    (data, pid, limbo_data, limbo_pid, lost), diag = run(
        data, pid, limbo_data, limbo_pid, cfg)
    return (data, pid, limbo_data, limbo_pid, lost_prev + lost), diag


def _relayout_guarded(carry, cfg: SimConfig, mesh, *, nsc: int, cap: int,
                      mcap: int | None, ocap: int, n: int,
                      axis: str = AXIS, verbose=None):
    """Transport-only layout repair that NEVER loses particles: a
    relayout pass whose limbo overflows drops rows permanently (see
    ``sharded_relayout``'s CALLERS MUST CHECK ``lost`` note), so on
    ``lost > 0`` rewind to the pre-relayout carry (still live — the
    transport counterpart of the grid window's lost>0 rewind rule) and
    retry with limbocap grown 4x. Terminates: per-device limbocap >= n
    holds every row outright. Returns ``(carry, servable_max,
    unservable)`` with loss == 0 guaranteed."""
    d = mesh.shape[axis]
    while True:
        new_c, (servable, unserv, lost) = sharded_relayout(
            carry, cfg.replace(cell_capacity=cap), mesh,
            passes=d // 2 + 1, nsc=nsc, cap=cap, mcap=mcap, axis=axis,
            n=n, ocap=ocap)
        if int(lost) == 0:
            return new_c, int(servable), int(unserv)
        lc = carry[3].shape[0] // d
        if lc >= n:
            raise RuntimeError(
                f"relayout lost {int(lost)} rows at limbocap={lc} >= "
                f"n={n} — impossible unless the carry is corrupt")
        if verbose:
            verbose(f"[slab-adaptive] relayout overflowed limbo "
                    f"({int(lost)} rows would be lost) — rewinding "
                    f"transport, limbocap={4 * lc}")
        carry = recap_sharded_dense(carry, cfg, mesh, nsc, cap, cap,
                                    limbocap_new=4 * lc, axis=axis)


def sharded_dense_adaptive(carry, cfg: SimConfig, dt, num_steps: int, mesh,
                           n: int, nsc: int | None = None,
                           cap: int | None = None, mcap: int | None = None,
                           window: int = 64, max_cap: int = 512,
                           axis: str = AXIS, verbose=None,
                           on_ladder_end: str = "exact",
                           state: "ParticleState | None" = None,
                           ocap: int | None = None):
    """Capacity-adaptive stay-sharded window driver — the slab counterpart
    of ``engine.step.simulate_dense_adaptive``'s escalate-with-rewind rule
    (clustering scenes outgrow any capacity chosen from the uniform init).

    Runs ``window``-step chunks of ``sharded_dense_steps``; a window whose
    diagnostics report trouble is REWOUND (the functional carry makes that
    free — the pre-window pytree is still live) and re-run after growing
    the relevant static bound:

      * movers overflowed ``mcap``      → double mcap (recompile only),
      * particles were lost past limbo  → grow limbocap 4x (``recap``),
      * any capacity masking            → next cell capacity
        (``engine.step.escalate_cap`` — the single-chip driver's ladder),
        carry recapped in place.

    When the cell-capacity ladder ends (``max_cap`` reached) — or six
    consecutive rewinds still leave trouble
    — ``on_ladder_end`` picks the terminal rung:

      * ``"exact"`` (default): the window is NEVER committed with
        force-frozen particles — it is rewound and served STAY-SHARDED on
        the capacity-free ring all-pairs backend (``sharded_exact_steps``:
        per-device compacted rows, position blocks circulating the mesh;
        O(N/D) memory, no all-gather — round 5, replacing the round-4 rung
        that replicated the state). This preserves the single-chip
        ladder's guarantee — no committed step is ever inexact (reference
        semantics: every particle feels every in-range force every step,
        src/lib.rs:171-243). After each exact window ``sharded_relayout``
        repairs the slot layout (pure transport) and the driver re-enters
        the grid path when every row is back in its slab with overflow
        within the sidecar budget.
      * ``"exact_replicated"`` (needs ``state``): the round-4 rung — the
        pre-window carry is gathered to REPLICATED particle order and the
        window runs on the single-chip all-pairs backend
        (``engine.step.FALLBACK_NEIGHBOR``, at the cost of O(N) memory per
        device). A small-N convenience;
        re-probes the slab path with a fresh build after each window.
      * ``"warn"``: commit the masked window with a loud message — the
        unserved particles go without pair forces for those steps
        (coasting with ocap > 0, position-frozen limbo with ocap=0 — see
        the module docstring), never wrong species-pairs or lost
        (explicit opt-out; also the fallback for ``"exact_replicated"``
        when ``state`` is absent).
      * ``"raise"``: hard error.

    ``state`` is a particle-order template for ``"exact_replicated"``
    (its species/masses feed the exact backend's pair features); the
    default sharded rung needs none — pair features live in the carry's
    own U/V columns.

    Returns ``(carry, cap, history)``; history lists
    ``(steps, cap, masked)`` per committed window (``cap`` is the string
    ``"exact"`` for terminal-rung windows, always masked == 0).
    """
    from ..engine.step import FALLBACK_NEIGHBOR, escalate_cap
    from ..engine.step import simulate as _simulate

    if nsc is None:
        nsc = cfg.cell_grid
    if cap is None:
        cap = cfg.cell_capacity
    d = mesh.shape[axis]
    if mcap is None:
        mcap = max(512, -(-max(n // (8 * d), 1) // 128) * 128)
    if ocap is None:
        from ..ops.celllist_dense import OCAP
        ocap = OCAP if cfg.overflow_capacity is None else cfg.overflow_capacity
    if nsc < 3:
        ocap = 0
    done = 0
    history = []
    ladder_ended = False
    replicated_rung = on_ladder_end == "exact_replicated"
    exact_ok = (on_ladder_end == "exact"
                or (replicated_rung and state is not None))
    exact_mode = False
    live_state = None   # replicated particle-order state (replicated rung)

    def _rcap_for(c):
        """Per-device compaction capacity for the sharded rung: exact at
        call time (no migration inside an exact window), bucketed to the
        next power of two to bound recompiles."""
        occ = jnp.sum((c[1].reshape(d, -1) >= 0).astype(jnp.int32), axis=1)
        lim = jnp.sum((c[3].reshape(d, -1) >= 0).astype(jnp.int32), axis=1)
        mx = int(jnp.max(occ + lim))
        nl = c[1].shape[0] // d + c[3].shape[0] // d
        return min(nl, max(256, 1 << (max(mx, 1) - 1).bit_length()))

    def run_exact_window(k):
        nonlocal live_state, carry
        if replicated_rung:
            live_state = _simulate(
                live_state, cfg.replace(neighbor=FALLBACK_NEIGHBOR), dt, k)
            return
        rcap = _rcap_for(carry)
        carry, overflow = sharded_exact_steps(carry, cfg, dt, k, mesh,
                                              rcap=rcap, axis=axis)
        # rcap covers every device's live rows by construction
        assert int(overflow) == 0, int(overflow)

    def relayout_guarded(c):
        return _relayout_guarded(c, cfg, mesh, nsc=nsc, cap=cap, mcap=mcap,
                                 ocap=ocap, n=n, axis=axis, verbose=verbose)

    def try_reenter_slab():
        """Probe the slab path. Sharded rung: repair the layout with
        transport-only relayout passes (multi-hop ring routing), re-enter
        when every row is back in its slab and overflow fits the sidecar
        budget. Replicated rung: rebuild from the live replicated state,
        re-enter on a clean build."""
        nonlocal carry, exact_mode, live_state
        if not replicated_rung:
            carry, servable, unserv = relayout_guarded(carry)
            if int(unserv) == 0 and int(servable) <= ocap:
                exact_mode = False
                if verbose:
                    verbose(f"[slab-adaptive] layout repaired (overflow "
                            f"{int(servable)}/device <= ocap={ocap}) — "
                            f"re-entering the sharded slab path at "
                            f"cap={cap}")
            return
        new_carry = build_sharded_dense(live_state,
                                        cfg.replace(cell_capacity=cap),
                                        mesh, nsc=nsc, cap=cap, mcap=mcap,
                                        axis=axis)
        limbo_n = int(jnp.sum((new_carry[3] >= 0).astype(jnp.int32)))
        if limbo_n == 0 and int(new_carry[4]) == 0:
            carry = new_carry
            exact_mode = False
            live_state = None
            if verbose:
                verbose(f"[slab-adaptive] scene fits cap={cap} again — "
                        f"re-entering the sharded slab path")

    def enter_exact(prev_carry, why):
        nonlocal exact_mode, live_state, carry
        exact_mode = True
        if replicated_rung:
            live_state = gather_sharded_dense(prev_carry, state, mesh)
            if verbose:
                verbose(f"[slab-adaptive] {why} — rewinding window, serving "
                        f"exact windows on gathered state (capacity-free "
                        f"backend; replicated until the scene fits again)")
            return
        carry = prev_carry
        if verbose:
            verbose(f"[slab-adaptive] {why} — rewinding window, serving "
                    f"exact windows STAY-SHARDED on the ring all-pairs "
                    f"rung (O(N/D) per device; relayout re-probes the "
                    f"grid path each window)")

    # an overflowing initial build leaves particles in limbo. Up to ocap
    # per device the sidecar serves them exactly from step 1; only the
    # EXCESS would be silently force-frozen before pass B drains it —
    # escalate and drain that excess BEFORE stepping so window 1 starts
    # exact (mx_limbo only sees end-of-step counts, not this)
    def _pre_unserved(c):
        per_dev = jnp.sum((c[3].reshape(d, -1) >= 0).astype(jnp.int32),
                          axis=1)
        return int(jnp.sum(jnp.maximum(per_dev - ocap, 0)))

    pre_excess = _pre_unserved(carry)
    while pre_excess > 0:
        new_cap = escalate_cap(cap, max_cap)
        if new_cap is None:
            ladder_ended = True
            msg = (f"[slab-adaptive] {pre_excess} initial-build overflow "
                   f"particles in limbo beyond the sidecar budget "
                   f"(ocap={ocap}/device) with no feasible larger capacity "
                   f"(cell_grid={nsc}, ladder ended at cap={cap})")
            if on_ladder_end == "raise":
                raise RuntimeError(msg)
            if exact_ok:
                enter_exact(carry, msg)
            elif verbose:
                verbose(msg)
            break
        if verbose:
            verbose(f"[slab-adaptive] draining {pre_excess} initial-build "
                    f"limbo particles beyond the sidecar budget: "
                    f"cap={cap} -> {new_cap}")
        carry = recap_sharded_dense(carry, cfg, mesh, nsc, cap, new_cap,
                                    axis=axis)
        cap = new_cap
        pre_excess = _pre_unserved(carry)

    rewinds_here = 0  # consecutive rewinds at the same `done` (loop guard)
    while done < num_steps:
        k = min(window, num_steps - done)
        if exact_mode:
            run_exact_window(k)
            done += k
            history.append((k, "exact", 0))
            if done < num_steps:
                try_reenter_slab()
            continue
        prev = carry
        cfg_k = cfg.replace(cell_capacity=cap)
        carry, diag = sharded_dense_steps(carry, cfg_k, dt, k, mesh,
                                          nsc=nsc, cap=cap, mcap=mcap,
                                          axis=axis, n=n, ocap=ocap)
        mov, mask, limbo, lost, _ = (int(x) for x in diag)
        trouble = mask + limbo  # both mean force-frozen particles
        if mov > mcap and rewinds_here < 6:
            mcap = -(-(2 * mov) // 128) * 128
            if verbose:
                verbose(f"[slab-adaptive] step {done}: {mov} movers > "
                        f"mover cap — rewinding window, mcap={mcap}")
            carry = prev
            rewinds_here += 1
            continue
        if lost > 0 and rewinds_here < 6:
            lc = prev[3].shape[0] // d
            if verbose:
                verbose(f"[slab-adaptive] step {done}: {lost} lost past "
                        f"limbo — rewinding window, limbocap={4 * lc}")
            carry = recap_sharded_dense(prev, cfg, mesh, nsc, cap, cap,
                                        limbocap_new=4 * lc, axis=axis)
            rewinds_here += 1
            continue
        if trouble > 0 and not ladder_ended and rewinds_here < 6:
            new_cap = escalate_cap(cap, max_cap)
            if new_cap is not None:
                if verbose:
                    verbose(f"[slab-adaptive] step {done}: {mask} capacity-"
                            f"masked + {limbo} limbo at cap={cap} — "
                            f"rewinding window, cap={new_cap}")
                carry = recap_sharded_dense(prev, cfg, mesh, nsc, cap,
                                            new_cap, axis=axis)
                cap = new_cap
                rewinds_here += 1
                continue
            ladder_ended = True
        if trouble > 0:
            # terminal rung: a window about to commit force-frozen
            # particles (ladder ended, or the rewind guard exhausted with
            # trouble remaining) is NEVER committed inexact under "exact"
            msg = (f"[slab-adaptive] step {done}: {mask} masked + {limbo} "
                   f"limbo at cap={cap} with no feasible escalation "
                   f"(cell_grid={nsc}"
                   + (", ladder ended" if ladder_ended
                      else ", rewind guard exhausted") + ")")
            if on_ladder_end == "raise":
                raise RuntimeError(msg)
            if exact_ok:
                enter_exact(prev, msg)
                continue
            if verbose:
                verbose(msg + " — committing the window; unserved "
                        "particles get no pair forces for these steps "
                        "(coast/freeze per the module docstring), never "
                        "lost")
        done += k
        rewinds_here = 0
        history.append((k, cap, trouble))
    if exact_mode and replicated_rung:
        # the trajectory lives in the replicated live_state — materialize
        # it back into a valid stay-sharded carry. The scene may still be
        # denser than cap, so grow the limbo capacity until the rebuild
        # loses nothing (limbo rows are frozen only if STEPPED, and this
        # carry is a terminal return value).
        lc = carry[3].shape[0] // d
        while True:
            new_carry = build_sharded_dense(
                live_state, cfg.replace(cell_capacity=cap), mesh,
                nsc=nsc, cap=cap, mcap=mcap, limbocap=lc, axis=axis)
            if int(new_carry[4]) == 0:
                break
            lc *= 4
        carry = new_carry
    elif exact_mode:
        # sharded rung: the carry IS the state — one final transport-only
        # relayout (loss-guarded like every other) tidies the slot layout
        # for downstream consumers
        carry, _, _ = relayout_guarded(carry)
    return carry, cap, history


@functools.partial(jax.jit, static_argnames=("axis", "mesh"))
def gather_sharded_dense(carry, state: ParticleState, mesh,
                         axis: str = AXIS) -> ParticleState:
    """Replicated particle-order state from a stay-sharded carry (particles
    never placed in a slot keep their values from ``state``)."""
    data, pid, limbo_data, limbo_pid, _ = carry

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(data, pid, limbo_data, limbo_pid, s):
        return _gather_state(data, pid, limbo_data, limbo_pid, s, axis)

    return run(data, pid, limbo_data, limbo_pid, state)

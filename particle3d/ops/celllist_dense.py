"""Incrementally-maintained dense cell layout — the exact production path.

The per-step-rebuild cell-list path (``pallas_celllist.pallas_celllist_forces``
inside ``engine.step.simulate``) spends most of its step re-sorting and
re-gathering the ENTIRE state into the column-dense layout (the random
gathers/scatters of the full slot table, more than the argsort). But a fresh
layout differs
from the previous one only where particles crossed a supercell boundary (a
few % of N per step at interactive dt), so this module keeps the simulation
state PERMANENTLY in the dense slot layout and repairs it in place after
every step:

  1. bin the integrated positions (elementwise, no sort),
  2. extract the movers — slots whose occupant left its supercell — with one
     bounded-size ``nonzero``,
  3. sort only the movers by target cell (argsort over ``mover_capacity``
     elements, not N) and rank them per cell (cummax segment rank),
  4. assign each mover the r-th free slot of its target cell (free-slot
     order via a tiny per-row argsort over ``cap`` columns),
  5. move the mover rows with ONE gather + ONE scatter on a packed
     state matrix (rows share one index per slot — scatters pay per
     index, so packing beats per-array moves;
     vacated rows are left stale, see ``rebind``), with a half-size
     fast path when the step's movers fit in mcap/2.

The layout is exactly fresh after every step — the same guarantee as a full
rebuild, so this path needs no drift budget (verified bit-exact against the
per-step rebuild). Capacity-overflow movers (target cell full) and movers
beyond ``mover_capacity`` stay in their old slot but are masked
force-invisible (r2 = -1: not a source, force zeroed as receiver → ballistic
drift) and are retried every step — the same degradation class as the full
rebuild's capacity drop. Diagnostics (mover count, misplaced count) are
returned for validation.

Successor to the reference's per-step counting-sort spatial hash
(``src/lib.rs:134-164``), replacing its full O(N) rebuild with O(movers)
maintenance that XLA keeps entirely on device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..config import SimConfig
from .pallas_allpairs import PAIR_P, pack_params, _r2_gate
from .pallas_celllist import _call
from .compaction import masked_indices
from . import forces as F

# Default overflow-sidecar capacity (ops/overflow.py): capacity-overflow
# particles live in WRONG slots (force-invisible to the grid kernel) and get
# exact forces from bounded neighborhood sweeps instead — so the cell
# capacity can hug the MEAN occupancy rather than the Poisson-tail max.
# The sweep is O(ocap * 27 * cap), slot-count-independent, so the budget can
# cover the steady-state misplaced queue (~200 at the 262k mean-occupancy
# geometry, growing as scenes cluster). Rows beyond ocap are frozen
# (force-masked) and counted, as before; cfg.overflow_capacity overrides.
OCAP = 512

# packed row layouts. The single-device DenseSim splits DYNAMICS (rewritten
# every step) from the layout-constant pair FEATURES: data rows are
# [pos(3) | vel(3) | acc(3)], feat rows [U(P) | V(P)]. Besides halving the
# per-step data rewrite, the split keeps the sidecar's U/V reads on
# 64-byte-aligned 16-float rows instead of strided column slices of one
# wide row. The slab decomposition's local pack still uses
# the combined [pos|vel|acc|U|V] row (these slices index it).
_POS = slice(0, 3)
_VEL = slice(3, 6)
_ACC = slice(6, 9)
_U = slice(9, 9 + PAIR_P)
_V = slice(9 + PAIR_P, 9 + 2 * PAIR_P)
_WIDTH = 9 + 2 * PAIR_P
_FU = slice(0, PAIR_P)
_FV = slice(PAIR_P, 2 * PAIR_P)


@dataclasses.dataclass(frozen=True)
class DenseSim:
    """Simulation state living in the flat slot layout (S = nsc^3 * cap).

    data: f32[S, 9] dynamics rows [pos|vel|acc]; feat: f32[S, 2P] layout-
    constant pair features [U|V] (moved only by the rebind mover pipeline);
    pid: i32[S] particle id or -1 (empty); r2: f32[S] radius gate — the
    law's r^2 for a correctly-binned occupant, -1 for empty or misplaced
    slots (force-invisible).
    """

    data: Any
    feat: Any
    pid: Any
    r2: Any

    @property
    def pos(self):
        return self.data[:, _POS]

    @property
    def vel(self):
        return self.data[:, _VEL]

    @property
    def acc(self):
        return self.data[:, _ACC]

    @property
    def u(self):
        return self.feat[:, _FU]

    @property
    def v(self):
        return self.feat[:, _FV]

    def replace(self, **kw) -> "DenseSim":
        return dataclasses.replace(self, **kw)


jax.tree_util.register_dataclass(
    DenseSim, data_fields=["data", "feat", "pid", "r2"], meta_fields=[])


def bin_sid(positions, cfg: SimConfig, nsc: int):
    """Supercell id per row — identical binning to prepare_columns."""
    w = jnp.asarray(cfg.world_size, jnp.float32)
    cellw = w / nsc
    shifted = positions + w * 0.5
    idx3 = jnp.clip(jnp.floor(shifted / cellw).astype(jnp.int32), 0, nsc - 1)
    return (idx3[:, 0] * nsc + idx3[:, 1]) * nsc + idx3[:, 2]


def default_mover_capacity(n: int) -> int:
    """Static bound on movers per step (~N/16; interactive dt moves a few %
    of N per step). Excess movers degrade to force-invisible, not wrong, and
    the observed mover count is returned for validation."""
    return max(1024, -(-(n // 16) // 128) * 128)


def build_dense(state, cfg: SimConfig, nsc: int, cap: int,
                ocap: int = OCAP) -> DenseSim:
    """Full (sorting) build of the dense layout from particle-order state.

    Capacity-overflow particles (cell rank >= cap) are placed in the first
    ``ocap`` globally-free slots as MISPLACED rows (r2 = -1, force-invisible
    to the grid kernel; the overflow sidecar serves them exactly — see
    ``sidecar_indices``). Overflow beyond ocap is dropped as before (pid
    absent; callers count it as masked)."""
    n = state.positions.shape[0]
    u, v = F.pair_features(state, cfg, pad_p=PAIR_P)
    sid = bin_sid(state.positions, cfg, nsc)
    order = jnp.argsort(sid)
    sid_s = sid[order]
    starts = jnp.searchsorted(sid_s, jnp.arange(nsc ** 3, dtype=sid.dtype))
    rank = jnp.arange(n, dtype=jnp.int32) - starts[sid_s].astype(jnp.int32)
    keep = rank < cap
    flat = jnp.where(keep, sid_s * cap + rank, nsc ** 3 * cap)
    s_total = nsc ** 3 * cap
    pid = jnp.full((s_total + 1,), -1, jnp.int32)
    pid = pid.at[flat].set(order.astype(jnp.int32), mode="drop")[:-1]
    if ocap:
        # park at most ONE overflow row per cell, emptiest cells first: a
        # parked row occupies a real slot, so ascending-first-free parking
        # would stuff the lowest-index cells full and every later mover
        # into them would fail — a misplacement snowball
        k_cells = nsc ** 3
        oc = min(ocap, k_cells)
        free = (pid < 0).reshape(k_cells, cap)
        free_count = jnp.sum(free.astype(jnp.int32), axis=1)
        host_cells = jnp.argsort(-free_count)[:oc].astype(jnp.int32)
        first_free = jnp.argmax(free, axis=1).astype(jnp.int32)
        free_idx = jnp.where(free_count[host_cells] > 0,
                             host_cells * cap + first_free[host_cells],
                             s_total)
        of_rank = jnp.cumsum((~keep).astype(jnp.int32)) - 1
        of_dst = jnp.where(
            jnp.logical_and(~keep, of_rank < oc),
            free_idx[jnp.clip(of_rank, 0, oc - 1)], s_total)
        pid = pid.at[of_dst].set(order.astype(jnp.int32), mode="drop")
    present = pid >= 0
    safe = jnp.where(present, pid, 0)

    # ONE combined [N, 9+2P] row gather, split after: gathers price by
    # index count more than row width, so gathering data and feat rows
    # separately pays the index cost twice where this pays it once.
    packed = jnp.concatenate(
        [state.positions.astype(jnp.float32),
         state.velocities.astype(jnp.float32),
         state.accel.astype(jnp.float32),
         u.astype(jnp.float32), v.astype(jnp.float32)], axis=1)
    rows = jnp.where(present[:, None], packed[safe], 0.0)
    data = rows[:, :9]
    feat = rows[:, 9:]
    r2v = _r2_gate(cfg)
    # the grid-visibility gate is ALIGNMENT, not mere presence: an overflow
    # row parked in a wrong cell must stay kernel-invisible (the sidecar
    # serves it); one parked in a slot that happens to match its cell is
    # simply placed. Same rule rebind re-derives every step.
    cell_of_slot = jnp.arange(s_total, dtype=jnp.int32) // cap
    aligned = jnp.logical_and(
        present, bin_sid(data[:, _POS], cfg, nsc) == cell_of_slot)
    return DenseSim(data=data, feat=feat, pid=pid,
                    r2=jnp.where(aligned, r2v, -1.0).astype(jnp.float32))


def sidecar_indices(ds: DenseSim, ocap: int = OCAP):
    """Compact slot indices of misplaced rows (pid >= 0, r2 <= 0), ascending,
    padded to ``ocap`` with the s_total sentinel. O(S) rank scan — used once
    per window; per-step maintenance comes from ``rebind``'s mover pipeline."""
    s_total = ds.pid.shape[0]
    mask = jnp.logical_and(ds.pid >= 0, ds.r2 <= 0.0)
    return masked_indices(mask, ocap, fill_value=s_total)


def scatter_back(ds: DenseSim, state):
    """Write the dense state back to particle order. Particles that never
    made it into a slot (initial-build capacity overflow) keep their values
    from ``state``.

    Scatters with DUPLICATE indices (all empty slots dumping on one drop
    row) serialize, while the same scatter with UNIQUE in-bounds indices
    (each empty slot dumping on its own row past n) vectorizes; and
    column-sliced row gathers (``data[safe, 0:3]`` x3) cost more than ONE
    full-row gather + static slices. Hence: one unique-index i32
    inversion scatter + one full-row gather. Never-placed particles
    (initial-build overflow beyond the sidecar budget) keep their values
    from ``state``."""
    n = state.positions.shape[0]
    s_total = ds.pid.shape[0]
    occ = ds.pid >= 0
    idx = jnp.where(occ, ds.pid, n + jnp.arange(s_total, dtype=ds.pid.dtype))
    inv = jnp.full((n + s_total,), s_total, jnp.int32).at[idx].set(
        jnp.arange(s_total, dtype=jnp.int32), mode="promise_in_bounds",
        unique_indices=True)[:n]
    placed = inv < s_total
    rows = ds.data[jnp.minimum(inv, s_total - 1)]  # ONE full-row gather
    init = jnp.concatenate(
        [state.positions.astype(jnp.float32),
         state.velocities.astype(jnp.float32),
         state.accel.astype(jnp.float32)], axis=1)
    out = jnp.where(placed[:, None], rows, init)
    return state.replace(
        positions=out[:, _POS].astype(state.positions.dtype),
        velocities=out[:, _VEL].astype(state.velocities.dtype),
        accel=out[:, _ACC].astype(state.accel.dtype))


def dense_forces_fresh(pos_flat, ds: DenseSim, cfg: SimConfig, nsc: int,
                       cap: int, interpret: bool | None = None):
    """Column-sweep kernel forces for positions in the CURRENT slot layout,
    with per-call ghosting of positions, features and the r2 gate (the
    layout mutates every step, so nothing is cached)."""
    ncol = nsc * nsc
    cs = nsc * cap
    pos_r = pos_flat.reshape(ncol, cs, 3).astype(jnp.float32)
    u_d = jnp.transpose(ds.u.reshape(ncol, cs, PAIR_P), (0, 2, 1))
    v_d = ds.v.reshape(ncol, cs, PAIR_P)
    r2_d = ds.r2.reshape(ncol, cs)
    wrap = bool(cfg.wrap_forces)
    if wrap:
        # fold wrap crossers back to their cell + coordinate-shifted
        # z-ghost images (pallas_celllist._kernel's column-level image
        # scheme: no per-pair minimum-image passes)
        from .pallas_celllist import fold_to_cells

        w = jnp.asarray(cfg.world_size, jnp.float32)
        pos_r = fold_to_cells(pos_r, w, nsc, cap)
        zs = jnp.zeros((3,), jnp.float32).at[2].set(w)
        pos_g = jnp.concatenate(
            [pos_r[:, cs - cap:] - zs, pos_r, pos_r[:, :cap] + zs], 1)
        v_g = jnp.concatenate([v_d[:, cs - cap:], v_d, v_d[:, :cap]], 1)
        r2_gh = jnp.concatenate([r2_d[:, cs - cap:], r2_d, r2_d[:, :cap]], 1)
    else:
        zpad3 = jnp.zeros((ncol, cap, 3), jnp.float32)
        zpadp = jnp.zeros((ncol, cap, PAIR_P), jnp.float32)
        mpad = jnp.full((ncol, cap), -1.0, jnp.float32)
        pos_g = jnp.concatenate([zpad3, pos_r, zpad3], 1)
        v_g = jnp.concatenate([zpadp, v_d, zpadp], 1)
        r2_gh = jnp.concatenate([mpad, r2_d, mpad], 1)
        g = cs + 2 * cap
        pos_g = jnp.concatenate([pos_g, jnp.zeros((1, g, 3), jnp.float32)], 0)
        v_g = jnp.concatenate([v_g, jnp.zeros((1, g, PAIR_P), jnp.float32)], 0)
        r2_gh = jnp.concatenate([r2_gh, jnp.full((1, g), -1.0, jnp.float32)], 0)
    pos_d = jnp.transpose(pos_r, (0, 2, 1))  # slot-minor receiver (_call)
    post_g = jnp.transpose(pos_g, (0, 2, 1))
    vt_g = jnp.transpose(v_g, (0, 2, 1))
    r2_g = r2_gh[:, None, :]
    out = _call(pos_d, u_d, post_g, vt_g, r2_g, pack_params(cfg),
                cfg.force_law, wrap, nsc, cap, interpret,
                p_eff=F.feature_dim(cfg))
    return jnp.transpose(out, (0, 2, 1)).reshape(-1, 3)


def rebind(ds: DenseSim, cfg: SimConfig, nsc: int, cap: int,
           mcap: int, ocap: int = OCAP) -> tuple[DenseSim, Any, Any, Any]:
    """Repair the slot layout after one integration step (module docstring
    steps 1-5). Returns (new layout, mover count, misplaced count,
    mis_idx) — ``mis_idx`` is the [ocap] sidecar worklist: slot indices of
    movers that failed placement this step (they stay misplaced in their
    old slot; the overflow sidecar serves them exactly), s_total-padded.
    Misplaced rows beyond ocap — and movers beyond mcap — are frozen;
    ``misplaced count - valid(mis_idx)`` is the frozen (inexact) count."""
    s_total = ds.pid.shape[0]
    k_cells = nsc ** 3
    r2v = _r2_gate(cfg).astype(jnp.float32)

    occupied = ds.pid >= 0
    sid_new = bin_sid(ds.pos, cfg, nsc)
    cell_of_slot = jnp.arange(s_total, dtype=jnp.int32) // cap
    moved = jnp.logical_and(occupied, sid_new != cell_of_slot)
    n_movers = jnp.sum(moved.astype(jnp.int32))

    # -- extract movers ------------------------------------------------------
    # bit-exact jnp.nonzero replacement with a lane-parallel rank scan
    # (ops/compaction.py)
    idx_full = masked_indices(moved, mcap, fill_value=s_total)

    # -- free slots per cell --------------------------------------------------
    # Only CURRENTLY-EMPTY slots count as free. Counting mover slots as free
    # would let another mover claim the slot of a mover that fails placement
    # and stays put — overwriting (losing) it. The cost of the conservative
    # rule is one step of lag: slots vacated this step become placeable next
    # step, so under capacity pressure a few more particles ride out a step
    # force-masked (still counted in n_misplaced, never lost).
    free = ~occupied.reshape(k_cells, cap)
    free_count = jnp.sum(free.astype(jnp.int32), axis=1)
    # free-first stable order: column index of the r-th free slot per row
    free_order = jnp.argsort(~free, axis=1, stable=True).astype(jnp.int32)

    def pipeline(idx_m):
        """Sort movers by target cell, rank them, assign free slots, move
        the rows. The mover-sized ops (argsort + row gather/scatters at
        ~0.1 us/row) dominate rebind, so the static size of ``idx_m`` is
        the cost driver — see the lax.cond below."""
        m = idx_m.shape[0]
        valid_m = idx_m < s_total
        idx_safe = jnp.minimum(idx_m, s_total - 1)
        tgt = jnp.where(valid_m, sid_new[idx_safe], k_cells)
        order = jnp.argsort(tgt)
        idx_s = idx_m[order]
        tgt = tgt[order]
        valid_s = valid_m[order]
        # arrival rank within the target cell: distance to the segment start
        iota = jnp.arange(m, dtype=jnp.int32)
        seg_start = jnp.concatenate(
            [jnp.ones((1,), bool), tgt[1:] != tgt[:-1]])
        rank = iota - jax.lax.cummax(jnp.where(seg_start, iota, 0))
        # (movers beyond the extraction size are simply not moved this step:
        # the alignment recompute below masks them force-invisible and they
        # retry next step)

        tgt_safe = jnp.minimum(tgt, k_cells - 1)
        can = jnp.logical_and(valid_s, rank < free_count[tgt_safe])
        rank_safe = jnp.clip(rank, 0, cap - 1)
        dst = jnp.where(
            can, tgt_safe * cap + free_order[tgt_safe, rank_safe], s_total)
        src = jnp.where(can, jnp.minimum(idx_s, s_total - 1), s_total)

        # -- apply the moves (row ops are priced per row, so every elided
        # one matters). The DATA rows of vacated slots are left STALE
        # on purpose: a vacated slot is dead through pid=-1 (not free-list
        # eligible until ~occupied, not a force source via r2=-1, receiver
        # output masked at the kick), its finite garbage integrates as an
        # inert ghost exactly like build_dense's zero rows, and any new
        # occupant overwrites the full row — so the full-row src-clear
        # scatter is pure cost (dst and src are disjoint: free slots are
        # currently-empty only). Folding pid into the packed row was
        # measured SLOWER (the narrow per-column vacate scatter lowers worse
        # than the separate 1-D pid ops): keep pid separate.
        def move(a, empty, clear_src):
            vals = a[jnp.minimum(src, s_total - 1)]
            if clear_src:
                a = a.at[src].set(jnp.broadcast_to(
                    jnp.asarray(empty, a.dtype), vals.shape), mode="drop")
            return a.at[dst].set(vals, mode="drop")

        # sidecar worklist: movers that failed placement stay misplaced at
        # idx_s — compact the first ocap of them (ascending in sorted-mover
        # order; a cheap O(m) scan, m = mover-pipeline size, not O(S))
        if ocap:
            fail = jnp.logical_and(valid_s, ~can)
            mpos = masked_indices(fail, ocap, fill_value=m)
            mis = jnp.where(mpos < m,
                            idx_s[jnp.minimum(mpos, m - 1)], s_total)
        else:
            mis = jnp.zeros((0,), jnp.int32)
        return (move(ds.data, 0.0, clear_src=False),
                move(ds.feat, 0.0, clear_src=False),
                move(ds.pid, -1, clear_src=True), mis)

    # Bounded-work fast path: most steps move far fewer than mcap slots, and
    # the mover-sized ops are priced by their STATIC size. idx_full is
    # ascending, so a prefix holds ALL movers whenever they fit — pick the
    # smallest of {mcap/4, mcap/2, mcap} that does (the 262k preset's
    # uniform phase moves 0.2-4k rows a step against mcap/4 = 4096). Every
    # branch compiles once; the choice is a runtime scalar — results are
    # identical to always running full size.
    half = mcap // 2
    quarter = mcap // 4
    if quarter >= 1024:
        data, feat, pid, mis = jax.lax.cond(
            n_movers <= quarter,
            lambda: pipeline(idx_full[:quarter]),
            lambda: jax.lax.cond(
                n_movers <= half,
                lambda: pipeline(idx_full[:half]),
                lambda: pipeline(idx_full)))
    elif half >= 1024:
        data, feat, pid, mis = jax.lax.cond(
            n_movers <= half,
            lambda: pipeline(idx_full[:half]),
            lambda: pipeline(idx_full))
    else:
        data, feat, pid, mis = pipeline(idx_full)
    # r2 from scratch, elementwise: live gate iff the slot is occupied AND
    # its occupant's cell matches the slot's cell. This uniformly covers
    # placed movers, stayers, capacity-overflow and beyond-mcap movers
    # (force-invisible in place) and misplaced occupants that drifted back
    # into alignment.
    aligned = jnp.logical_and(
        pid >= 0, bin_sid(data[:, _POS], cfg, nsc) == cell_of_slot)
    r2 = jnp.where(aligned, r2v, -1.0)

    n_misplaced = jnp.sum(jnp.logical_and(pid >= 0, ~aligned).astype(jnp.int32))
    return DenseSim(data=data, feat=feat, pid=pid,
                    r2=r2), n_movers, n_misplaced, mis

"""Exact overflow sidecar — rectangular masked force sweeps.

The dense cell layout (``celllist_dense``) prices its kernel by SLOTS, so
the cell capacity wants to hug the MEAN occupancy — but exactness demands it
covers the MAX (the Poisson tail), which forces padded geometries. The
sidecar removes that
coupling: a bounded set of "misplaced" particles (capacity-overflow rows
living force-invisible in wrong slots, r2 = -1) get their EXACT forces from
two rectangular sweeps instead of the grid kernel:

  * sweep 1 — forces ON the misplaced set: receivers are the (<= ocap)
    misplaced rows, sources are every real particle (aligned + misplaced).
  * sweep 2 — forces FROM the misplaced set: receivers are all slots
    (callers gate the add to aligned rows — misplaced receivers already got
    their complete force, including misplaced-misplaced pairs, in sweep 1),
    sources are the misplaced rows.

Each ordered pair is computed exactly once across {grid kernel, sweep 1,
sweep 2} (receiver-centric accounting; the laws are NOT symmetric — the
particle-life attraction matrix is directional, src/lib.rs:223-229 — so
sweep 2 evaluates f(j <- i) rather than negating sweep 1). Cost is
O(ocap * slots) dense elementwise work with no gathers or scatters beyond
the ocap row lookups (``neighborhood_sweeps`` bounds it to O(ocap * 27 *
cap)).

Pair semantics mirror ``ops.allpairs`` / the force kernels exactly:
accepted iff 0 < d2 < r2_gate (minimum-image when cfg.wrap_forces), rank-1
pair coefficient via a float32 feature product (reference hot loop
``src/lib.rs:176-243``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SimConfig
from . import forces as F
from .pallas_allpairs import _r2_gate

# float32 products: the GPU's default precision rounds matmul operands to
# TF32, which cannot hold a general attraction matrix or mass.
_HI = jax.lax.Precision.HIGHEST


def _pad_to(a, m, fill=0.0):
    pad = (-a.shape[0]) % m
    if pad == 0:
        return a
    width = ((0, pad),) + ((0, 0),) * (a.ndim - 1)
    return jnp.pad(a, width, constant_values=fill)


def rect_forces(pos_i, u_i, pos_j, v_j, valid_j, cfg: SimConfig,
                block_i: int = 65536, block_j: int = 65536):
    """Accumulated forces on receivers i from sources j, [NI, 3] f32.

    ``valid_j`` masks phantom source rows (empty slots hold stale finite
    garbage — they must not act). Receiver rows are NOT masked here:
    callers gate/scatter the outputs (garbage receiver rows compute finite
    garbage that is dropped). Blocked over both axes so peak memory is
    O(block_i * block_j); in the sidecar one axis is always ocap.
    """
    ni = pos_i.shape[0]
    scale = F.scale_fn(cfg)
    r2 = _r2_gate(cfg)
    wrap = bool(cfg.wrap_forces)
    w = cfg.world_size

    bi = min(block_i, ni)
    bj = min(block_j, pos_j.shape[0])
    pos_ib = _pad_to(pos_i.astype(jnp.float32), bi).reshape(-1, bi, 3)
    u_ib = _pad_to(u_i.astype(jnp.float32), bi).reshape(-1, bi, u_i.shape[1])
    pos_jb = _pad_to(pos_j.astype(jnp.float32), bj).reshape(-1, bj, 3)
    v_jb = _pad_to(v_j.astype(jnp.float32), bj).reshape(-1, bj, v_j.shape[1])
    ok_jb = _pad_to(valid_j, bj, fill=False).reshape(-1, bj)

    def per_i(args):
        pi, ui = args

        def per_j(acc, args_j):
            pj, vj, okj = args_j
            delta = pj[None, :, :] - pi[:, None, :]  # [bi, bj, 3], i -> j
            if wrap:
                delta = F.min_image(delta, w)
            d2 = jnp.sum(delta * delta, axis=-1)
            valid = jnp.logical_and(
                jnp.logical_and(d2 > 0.0, d2 < r2), okj[None, :])
            coef = jnp.dot(ui, vj.T, precision=_HI)
            s = jnp.where(valid, scale(jnp.where(valid, d2, 1.0), coef), 0.0)
            return acc + jnp.einsum("ijc,ij->ic", delta, s, precision=_HI), None

        acc, _ = jax.lax.scan(
            per_j, jnp.zeros((bi, 3), jnp.float32), (pos_jb, v_jb, ok_jb))
        return acc

    out = jax.lax.map(per_i, (pos_ib, u_ib))
    return out.reshape(-1, 3)[:ni]


def neighborhood_sweeps(positions, u_all, v_all, src_ok, mpos, mu, mv, mvalid,
                        cfg: SimConfig, nsc: int, cap: int):
    """Neighborhood-bounded sidecar sweeps: O(M * 27 * cap) gather/compute
    instead of ``sidecar_sweeps``'s O(M * S) dense pass — the cost no longer
    scales with the slot count, so the overflow budget can grow with the
    misplaced queue (hundreds at 262k, thousands at 1M on mean-occupancy
    geometries) without eating the capacity savings.

    Exactness decomposition (receiver-centric, every ordered pair exactly
    once across {grid kernel, these sweeps}):

      * mis <- aligned: gather each misplaced row's 27 neighbor cells of its
        FRESH position (cell width >= cutoff, the same geometry invariant
        the grid kernel relies on, so every in-range aligned source's slot
        cell is adjacent); sources gated by ``src_ok`` (aligned only — a
        misplaced source sits in an arbitrary slot, not necessarily nearby).
      * mis <- mis: dense [M, M] block on the compacted rows.
      * aligned <- mis: reverse forces scattered onto the gathered slots
        (callers gate the add to aligned receivers; misplaced receivers got
        their complete force from the two terms above).

    Requires nsc >= 3 (periodic neighbor cells must be distinct or wrapped
    pairs double-count — callers fall back to ``sidecar_sweeps``). Directional
    pair law as everywhere (src/lib.rs:223-229): coef(i <- j) = u_i . v_j.
    Returns ``(f_mis [M, 3], f_from [S, 3])`` like ``sidecar_sweeps``.

    The four separate window gathers (pos / u / v / ok) are deliberate: a
    "pack into [S, 4] + [S, 2P] and gather twice" variant ran slower on
    the earlier accelerator (wider gathered rows cost more than the extra
    row lookups); not re-measured on the GPU.
    """
    assert nsc >= 3, "neighbor cells must be distinct (see docstring)"
    s = positions.shape[0]
    m = mpos.shape[0]
    scale = F.scale_fn(cfg)
    r2 = _r2_gate(cfg)
    wrap = bool(cfg.wrap_forces)
    w = jnp.asarray(cfg.world_size, jnp.float32)

    mpos = mpos.astype(jnp.float32)
    mu = mu.astype(jnp.float32)
    mv = mv.astype(jnp.float32)

    # fresh-position cell coords of each misplaced row (same binning as
    # celllist_dense.bin_sid)
    cellw = w / nsc
    c3 = jnp.clip(jnp.floor((mpos + w * 0.5) / cellw).astype(jnp.int32),
                  0, nsc - 1)
    o = jnp.arange(-1, 2, dtype=jnp.int32)
    offs = jnp.stack(jnp.meshgrid(o, o, o, indexing="ij"), -1).reshape(27, 3)
    nb = c3[:, None, :] + offs[None]
    if wrap:
        nb = jnp.remainder(nb, nsc)
        cell_ok = jnp.ones((m, 27), bool)
    else:
        cell_ok = jnp.all(jnp.logical_and(nb >= 0, nb < nsc), axis=-1)
        nb = jnp.clip(nb, 0, nsc - 1)
    cell = (nb[..., 0] * nsc + nb[..., 1]) * nsc + nb[..., 2]  # [m, 27]
    k = 27 * cap
    k_cells = nsc ** 3
    ok_cell = jnp.broadcast_to(cell_ok[:, :, None],
                               (m, 27, cap)).reshape(m, k)

    # gather whole CELL WINDOWS (cap contiguous rows each), not individual
    # slot rows: [m, 27] cell indices with a [cap, width] slice beat an
    # [m, 27*cap] row gather (gathers are priced per index)
    def cells(a):
        return a.reshape(k_cells, cap, -1)[cell].reshape(m, k, -1)

    pj = cells(positions).astype(jnp.float32)  # [m, k, 3]
    uj = cells(u_all).astype(jnp.float32)
    vj = cells(v_all).astype(jnp.float32)
    okj = jnp.logical_and(cells(src_ok)[..., 0], ok_cell)

    delta = pj - mpos[:, None, :]  # i -> j
    if wrap:
        delta = F.min_image(delta, w)
    d2 = jnp.sum(delta * delta, axis=-1)
    gate = jnp.logical_and(d2 > 0.0, d2 < r2)
    safe = jnp.where(gate, d2, 1.0)

    # mis <- aligned
    ok1 = jnp.logical_and(gate, okj)
    s1 = jnp.where(
        ok1, scale(safe, jnp.einsum("mp,mkp->mk", mu, vj, precision=_HI)),
        0.0)
    f_mis = jnp.einsum("mkc,mk->mc", delta, s1, precision=_HI)

    # mis <- mis
    dmm = mpos[None, :, :] - mpos[:, None, :]  # i -> j
    if wrap:
        dmm = F.min_image(dmm, w)
    d2mm = jnp.sum(dmm * dmm, axis=-1)
    gmm = jnp.logical_and(jnp.logical_and(d2mm > 0.0, d2mm < r2),
                          mvalid[None, :])
    smm = jnp.where(gmm, scale(jnp.where(gmm, d2mm, 1.0),
                               jnp.dot(mu, mv.T, precision=_HI)), 0.0)
    f_mis = f_mis + jnp.einsum("ijc,ij->ic", dmm, smm, precision=_HI)

    # aligned <- mis, scattered onto the gathered slots. Scatter at CELL
    # granularity — m*27 indices each carrying a contiguous [cap, 3] block —
    # not row granularity: scatters are priced by index count more than by
    # element count.
    # Receivers are gated to ALIGNED rows here (okj — empty/misplaced slots
    # in the gathered windows must not receive; misplaced receivers get
    # their complete force from the two terms above).
    ok2 = jnp.logical_and(jnp.logical_and(gate, mvalid[:, None]), okj)
    s2 = jnp.where(
        ok2, scale(safe, jnp.einsum("mkp,mp->mk", uj, mv, precision=_HI)),
        0.0)
    contrib = (-delta * s2[..., None]).reshape(m, 27, cap, 3)
    gate_cell = jnp.logical_and(cell_ok, mvalid[:, None])  # [m, 27]
    dst_cell = jnp.where(gate_cell, cell, k_cells)  # OOB rows drop
    f_from = jnp.zeros((k_cells, cap, 3), jnp.float32).at[
        dst_cell.reshape(-1)].add(contrib.reshape(-1, cap, 3), mode="drop")
    return f_mis, f_from.reshape(s, 3)


def neighborhood_apply(f, positions, u_all, v_all, src_ok, mis, cfg: SimConfig,
                       nsc: int, cap: int):
    """STRAIGHT-LINE sidecar application: both ``neighborhood_sweeps`` terms
    added directly into the slot-force array ``f`` with no ``lax.cond`` and
    no full-array temporaries.

    Motivation: a cond-gated sidecar inside the production scan blocks XLA
    fusion around the kernel's output even with an empty worklist. Dead
    worklist entries (index == s_total) contribute exact zeros and their
    scatters drop, so running unconditionally at full width is exact.

    ``mis`` is the [ocap] worklist of misplaced SLOT indices (s_total-padded,
    see celllist_dense.rebind); receivers of the reverse term are gated to
    aligned rows via ``src_ok`` inside the sweep.
    """
    s_total = positions.shape[0]
    mvalid = mis < s_total
    msafe = jnp.minimum(mis, s_total - 1)
    f_mis, f_from = neighborhood_sweeps(
        positions, u_all, v_all, src_ok,
        positions[msafe], u_all[msafe], v_all[msafe], mvalid,
        cfg, nsc, cap)
    # f_from is already receiver-gated (ok2 includes okj) — scatter-free add
    return (f + f_from).at[mis].add(f_mis, mode="drop")


def slab_neighborhood_sweeps(ext, u_all, mpos, mu, mv, mvalid,
                             cfg: SimConfig, nsc: int, planes_local: int,
                             cap: int, me, self_ring: bool = False):
    """Slab-decomposition sidecar sweeps (the multi-chip port of
    ``neighborhood_sweeps`` — ROADMAP item 20): called per device inside
    ``shard_map``, with sources read from the HALO-EXTENDED plane pack the
    force kernel already exchanged, so overflow rows straddling a slab
    boundary get their exact forces with no extra plane traffic.

    Inputs (all per-device local):

      * ``ext`` — f32[(planes_local+2)*nsc, cs, 3+P+1] halo-extended source
        planes [pos | V | r2]: the step's ``concat(from_left, pack,
        from_right)`` (leading/trailing halo plane each; wrap-ring edge
        halos carry the x-image shift / walled kill the kernel applied —
        the sidecar inherits both for free).
      * ``u_all`` — f32[s_loc, P] the device's receiver features (term C).
      * ``mpos/mu/mv/mvalid`` — the COMBINED misplaced rows: the device's
        own worklist payload first, then each ring neighbor's exchanged
        payload exactly once (callers dedupe: d==1 ships nothing, d==2 one
        neighbor buffer, d>=3 two) — a neighbor two slabs away is >= one
        slab width >= cell width >= cutoff from every local position, so
        the radius gate annihilates anything farther. Positions are RAW
        (no image shifts): pair displacements go through ``min_image``
        when periodic, and the x-plane of each row is mapped into the
        extended grid by RELATIVE plane distance mod nsc (below), so a
        neighbor row across the global wrap boundary lands in the halo
        plane without any coordinate surgery.

    Exactness decomposition (receiver-centric, every ordered pair exactly
    once across {halo kernel, these sweeps}, each device owning its local
    receivers):

      * term A, mis <- aligned: window-gathered from ``ext`` (halo planes
        included), source-gated on the r2 channel (aligned only). Computed
        for every row of the combined set but only the LOCAL prefix is
        meaningful (neighbor rows see partial windows here) — callers add
        ``f_mis[:ocap]`` onto their own worklist slots.
      * term B, mis <- mis: dense block over the combined set —
        cross-slab misplaced pairs land here (min-image when periodic).
      * term C, aligned <- mis: reverse forces from ALL combined mis rows
        scattered onto LOCAL receiver cells only (window cells in halo
        planes are dropped — the neighbor computes those onto its own
        receivers from this device's exchanged payload). Receivers gated
        aligned via the window's r2 channel. ``self_ring`` (1-device
        meshes, periodic): the "neighbor" is this device itself and no
        payload is exchanged, so halo-plane window cells are REMAPPED to
        their wrapped local planes instead of dropped — without it the
        wrap-seam reverse forces are silently lost (caught by bench's
        compiled-mode slab gate at the (24,32) production geometry,
        rel err 1.95e-04; the 2/4/8-device CPU tests never exercised
        d==1).

    Row positions must bin within (or, for neighbor rows, near) the
    device's slab: local worklists are constructed in-slab (see
    ``parallel.domain_sharded``); a neighbor row deeper than one plane
    outside simply sees all-masked windows and a failing radius gate.
    Directional pair law as everywhere (``src/lib.rs:223-229``).
    Returns ``(f_mis [M, 3], f_from [s_loc, 3])``, f_from receiver-gated.
    """
    assert nsc >= 3, "neighbor cells must be distinct (see docstring)"
    m = mpos.shape[0]
    p = mu.shape[1]
    scale = F.scale_fn(cfg)
    r2 = _r2_gate(cfg)
    wrap = bool(cfg.wrap_forces)
    w = jnp.asarray(cfg.world_size, jnp.float32)
    k_loc = planes_local * nsc * nsc
    s_loc = k_loc * cap
    n_ext_planes = planes_local + 2
    k_ext = n_ext_planes * nsc * nsc

    mpos = mpos.astype(jnp.float32)
    mu = mu.astype(jnp.float32)
    mv = mv.astype(jnp.float32)

    # fresh-position GLOBAL cell coords -> extended-grid plane index
    # (halo planes sit at 0 and planes_local+1). The x plane is mapped by
    # RELATIVE plane distance from the slab start: when periodic, mod nsc
    # with planes past the right halo folded negative, so a neighbor row
    # across the global wrap boundary lands on prel == -1 (the left halo
    # plane) with no coordinate shift — pair displacements below all go
    # through min_image. Rows farther than one plane outside the slab get
    # an out-of-range px and contribute nothing here (their windows are
    # fully masked; cross-slab mis<->mis pairs live in term B).
    cellw = w / nsc
    c3 = jnp.clip(jnp.floor((mpos + w * 0.5) / cellw).astype(jnp.int32),
                  0, nsc - 1)
    prel = c3[:, 0] - me * planes_local
    if wrap:
        prel = jnp.remainder(prel, nsc)
        prel = jnp.where(prel > planes_local, prel - nsc, prel)
    px = prel + 1
    o = jnp.arange(-1, 2, dtype=jnp.int32)
    offs = jnp.stack(jnp.meshgrid(o, o, o, indexing="ij"), -1).reshape(27, 3)
    pxw = px[:, None] + offs[None, :, 0]           # [m, 27]
    cyw = c3[:, 1:2] + offs[None, :, 1]
    czw = c3[:, 2:3] + offs[None, :, 2]
    ok_x = jnp.logical_and(pxw >= 0, pxw < n_ext_planes)
    if wrap:
        cyw = jnp.remainder(cyw, nsc)
        czw = jnp.remainder(czw, nsc)
        ok_yz = jnp.ones_like(ok_x)
    else:
        ok_yz = jnp.logical_and(
            jnp.logical_and(cyw >= 0, cyw < nsc),
            jnp.logical_and(czw >= 0, czw < nsc))
        cyw = jnp.clip(cyw, 0, nsc - 1)
        czw = jnp.clip(czw, 0, nsc - 1)
    cell_ok = jnp.logical_and(ok_x, ok_yz)
    pxw_c = jnp.clip(pxw, 0, n_ext_planes - 1)
    cell_ext = (pxw_c * nsc + cyw) * nsc + czw     # [m, 27] ext cell ids
    k = 27 * cap
    ok_cell = jnp.broadcast_to(cell_ok[:, :, None],
                               (m, 27, cap)).reshape(m, k)

    # cell-granularity window gathers (same reasoning as
    # neighborhood_sweeps: [m, 27] cell indices with [cap, width] blocks
    # beat row gathers)
    win = ext.reshape(k_ext, cap, ext.shape[-1])[cell_ext].reshape(m, k, -1)
    pj = win[..., :3]
    vj = win[..., 3:3 + p]
    r2j = win[..., 3 + p]
    okj = jnp.logical_and(r2j > 0.0, ok_cell)      # aligned sources only

    delta = pj - mpos[:, None, :]                  # i -> j
    if wrap:
        delta = F.min_image(delta, w)
    d2 = jnp.sum(delta * delta, axis=-1)
    gate = jnp.logical_and(d2 > 0.0, d2 < r2)
    safe = jnp.where(gate, d2, 1.0)

    # term A: mis <- aligned (halo sources included; only the caller's
    # local prefix of the output is consumed)
    ok1 = jnp.logical_and(gate, okj)
    s1 = jnp.where(
        ok1, scale(safe, jnp.einsum("mp,mkp->mk", mu, vj, precision=_HI)),
        0.0)
    f_mis = jnp.einsum("mkc,mk->mc", delta, s1, precision=_HI)

    # term B: mis <- mis over the combined (deduped) set
    dmm = mpos[None, :, :] - mpos[:, None, :]
    if wrap:
        dmm = F.min_image(dmm, w)
    d2mm = jnp.sum(dmm * dmm, axis=-1)
    gmm = jnp.logical_and(jnp.logical_and(d2mm > 0.0, d2mm < r2),
                          mvalid[None, :])
    smm = jnp.where(gmm, scale(jnp.where(gmm, d2mm, 1.0),
                               jnp.dot(mu, mv.T, precision=_HI)), 0.0)
    f_mis = f_mis + jnp.einsum("ijc,ij->ic", dmm, smm, precision=_HI)

    # term C: LOCAL aligned receivers <- mis (halo window cells dropped —
    # owned by the neighbor — EXCEPT on a self-ring, where they wrap onto
    # local planes; see docstring). Receiver U gathered from the local
    # slot arrays through the local-cell remap of the same window
    # coordinates. A window never hits the same local plane twice: its 3
    # x-planes are consecutive, and nsc >= 3 keeps them distinct mod nsc.
    if self_ring and wrap:
        lx = jnp.remainder(pxw - 1, planes_local)
        loc_ok = ok_yz
    else:
        lx = pxw_c - 1
        loc_ok = jnp.logical_and(
            jnp.logical_and(pxw >= 1, pxw <= planes_local), ok_yz)  # [m, 27]
    cell_loc = (lx * nsc + cyw) * nsc + czw
    uj = u_all.reshape(k_loc, cap, p)[
        jnp.clip(cell_loc, 0, k_loc - 1)].reshape(m, k, p)
    loc_ok_k = jnp.broadcast_to(loc_ok[:, :, None],
                                (m, 27, cap)).reshape(m, k)
    ok2 = jnp.logical_and(
        jnp.logical_and(gate, r2j > 0.0),
        jnp.logical_and(loc_ok_k, mvalid[:, None]))
    s2 = jnp.where(
        ok2, scale(safe, jnp.einsum("mkp,mp->mk", uj, mv, precision=_HI)),
        0.0)
    contrib = (-delta * s2[..., None]).reshape(m, 27, cap, 3)
    gate_cell = jnp.logical_and(loc_ok, mvalid[:, None])       # [m, 27]
    dst_cell = jnp.where(gate_cell, cell_loc, k_loc)           # OOB drops
    f_from = jnp.zeros((k_loc, cap, 3), jnp.float32).at[
        dst_cell.reshape(-1)].add(contrib.reshape(-1, cap, 3), mode="drop")
    return f_mis, f_from.reshape(s_loc, 3)


def sidecar_sweeps(positions, u_all, v_all, src_ok, mpos, mu, mv, mvalid,
                   cfg: SimConfig, block: int = 65536):
    """Both sidecar sweeps in ONE pass over the slot arrays, sharing the
    pair geometry (delta / d2 / radius gate) between them — ~40% cheaper
    than two ``rect_forces`` calls, and the sweep cost at N=1M is what the
    sidecar's viability hinges on.

    Returns ``(f_mis [M, 3], f_from [S, 3])``: forces ON the M misplaced
    rows from every valid slot row, and forces FROM the misplaced rows onto
    every slot row (callers gate the latter to aligned receivers). The two
    directions need separate coefficient matmuls and scale evaluations
    because the laws are NOT symmetric (directional attraction matrix,
    src/lib.rs:223-229) — only the geometry is shared.
    """
    s = positions.shape[0]
    m = mpos.shape[0]
    scale = F.scale_fn(cfg)
    r2 = _r2_gate(cfg)
    wrap = bool(cfg.wrap_forces)
    w = cfg.world_size

    b = min(block, s)
    pos_b = _pad_to(positions.astype(jnp.float32), b).reshape(-1, b, 3)
    u_b = _pad_to(u_all.astype(jnp.float32), b).reshape(-1, b, u_all.shape[1])
    v_b = _pad_to(v_all.astype(jnp.float32), b).reshape(-1, b, v_all.shape[1])
    ok_b = _pad_to(src_ok, b, fill=False).reshape(-1, b)
    mpos = mpos.astype(jnp.float32)
    mu = mu.astype(jnp.float32)
    mv = mv.astype(jnp.float32)

    def per_block(f_mis, args):
        ps, us, vs, oks = args
        delta = mpos[None, :, :] - ps[:, None, :]  # [b, m, 3], slot -> mis
        if wrap:
            delta = F.min_image(delta, w)
        d2 = jnp.sum(delta * delta, axis=-1)
        gate = jnp.logical_and(d2 > 0.0, d2 < r2)
        safe = jnp.where(gate, d2, 1.0)
        # forces ON slots FROM misplaced rows (sweep 2)
        ok2 = jnp.logical_and(gate, mvalid[None, :])
        s2 = jnp.where(ok2, scale(safe, jnp.dot(us, mv.T, precision=_HI)), 0.0)
        f_from_b = jnp.einsum("smc,sm->sc", delta, s2, precision=_HI)
        # forces ON misplaced rows FROM valid slots (sweep 1)
        ok1 = jnp.logical_and(gate, oks[:, None])
        s1 = jnp.where(ok1, scale(safe, jnp.dot(vs, mu.T, precision=_HI)), 0.0)
        f_mis = f_mis - jnp.einsum("smc,sm->mc", delta, s1, precision=_HI)
        return f_mis, f_from_b

    f_mis, f_from = jax.lax.scan(
        per_block, jnp.zeros((m, 3), jnp.float32), (pos_b, u_b, v_b, ok_b))
    return f_mis, f_from.reshape(-1, 3)[:s]

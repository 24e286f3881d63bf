"""Column-sweep cell-list kernel for the GPU (Pallas, Triton route) — the
large-N production force path — and its plain jnp twin.

Successor to the reference's spatial hash (``src/lib.rs:134-164``) for
bounded-density systems. Particles are binned into a ``nsc^3`` SUPERCELL
grid (cell width >= cutoff) and sorted into a column-major dense layout: one
z-column of supercells per (x, y), each column's ``cap``-slot cells
contiguous, z-minor. Columns carry one ghost supercell at each z end (a
coordinate-shifted wrapped copy for periodic boxes, masked padding
otherwise), so every z-window is one contiguous run of slots.

Kernel design (one program per (column, supercell, block of up to
``MAX_BLOCK_R`` of the cell's slots)):

  * the program loads its receiver rows once (x, y, z and the used U
    features, masked past the cell's capacity);
  * it sweeps the ghosted z-window of cells z-1 .. z+1 — exactly the
    27-cell neighbourhood — in each of the 9 (x, y)-neighbour columns,
    in blocks of ``BS`` source slots with masked loads; neighbour indices,
    periodic image shifts and the walled-box dummy column are computed in
    the program from its column id;
  * partial sums stay [BR, BS] register tiles across all 27 cells and are
    reduced once, before the one store.

Periodic images are COLUMN-LEVEL, not per-pair: z ghosts carry +-w-shifted
coordinates, and a neighbour column that wrapped in x/y gets one scalar
+-w shift on its loaded coordinates, so deltas are true displacements with
no minimum-image arithmetic per pair. A window that holds a core cell and
its ghost copy cannot double count: the two copies sit a whole box apart
and at most one is within the cutoff (w >= 3 * cellw >= 3 * cutoff).
Non-periodic edges need no masking: an out-of-range neighbour column maps
to a fully-masked dummy column the caller appends last.

The radius gate (r2 row: r^2 for live slots, -1 for empty/misaligned ones)
rejects in-window-but-out-of-range candidates, so results equal the
all-pairs forces. Each program owns disjoint output rows and sees each
source slot at most once.

``_call`` routes by platform (``pallas_allpairs.kernel_route``): the
compiled kernel on ``gpu``, ``_call_plain`` (the same contract in jnp, also
the kernel's reference) on ``cpu``, the Pallas interpreter on request.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import SimConfig
from . import forces as F
from .pallas_allpairs import (
    PAIR_P, _PF_W, kernel_route, pack_params, pair_scale, _r2_gate)

_OFFSETS9 = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]

# source slots per inner-loop step, warps per program, and the largest
# receiver block (capacities above it split a supercell over programs)
BLOCK_S = 32
NUM_WARPS = 4
MAX_BLOCK_R = 32
# source blocks per column up to which the z-window loop is unrolled
_UNROLL_BLOCKS = 4


def block_rows(cap: int) -> int:
    """Receiver slots per program: the supercell's capacity rounded up to a
    power of two (Triton tiles are powers of two; the tail is masked),
    at most ``MAX_BLOCK_R``."""
    return int(min(MAX_BLOCK_R, pl.next_power_of_2(cap)))


def _neighbor(c, dx: int, dy: int, *, nsc: int, wrap: bool, halo: bool,
              dummy_col: int, w):
    """(source column, x shift, y shift) of receiver column ``c``'s (dx, dy)
    neighbour. Works on traced int32 scalars (kernel) and numpy arrays
    (plain twin's tables).

    halo=True: receiver columns are a contiguous x-slab and the source
    arrays lead with one extra x-plane of halo columns (domain
    decomposition, parallel/domain_sharded.py) — the x neighbour is a plain
    local offset and its halo already carries any periodic x image."""
    where = jnp.where if isinstance(c, jax.Array) else np.where
    cy = c % nsc
    ny = cy + dy
    sy = where(ny < 0, -w, where(ny >= nsc, w, 0.0)) if wrap else 0.0
    if halo:
        plane = c // nsc + 1
        if wrap:
            return (plane + dx) * nsc + (ny + nsc) % nsc, 0.0, sy
        ok = (ny >= 0) & (ny < nsc)
        return where(ok, (plane + dx) * nsc + ny, dummy_col), 0.0, sy
    nx = c // nsc + dx
    if wrap:
        sx = where(nx < 0, -w, where(nx >= nsc, w, 0.0))
        return ((nx + nsc) % nsc) * nsc + (ny + nsc) % nsc, sx, sy
    ok = (nx >= 0) & (nx < nsc) & (ny >= 0) & (ny < nsc)
    return where(ok, nx * nsc + ny, dummy_col), 0.0, sy


def _kernel(pf_ref, rec_pos_ref, rec_u_ref, src_pos_ref, src_v_ref,
            src_r2_ref, out_ref, *, law: str, wrap: bool, halo: bool,
            nsc: int, cap: int, p_eff: int, br: int, bs: int,
            dummy_col: int, use_rsqrt: bool):
    c = pl.program_id(0)
    z = pl.program_id(1)
    k0 = pl.program_id(2) * br           # first receiver within the cell
    rmask = k0 + jnp.arange(br) < cap
    rows = pl.ds(z * cap + k0, br)

    def rec(ref, ch):
        return plgpu.load(ref.at[c, ch, rows], mask=rmask, other=0.0)[:, None]

    xi, yi, zi = rec(rec_pos_ref, 0), rec(rec_pos_ref, 1), rec(rec_pos_ref, 2)
    u = [rec(rec_u_ref, p) for p in range(p_eff)]
    # ghosted z-window: cells z-1 .. z+1 (ghosted slot = core slot + cap)
    wstart = z * cap
    nblk = pl.cdiv(3 * cap, bs)
    w = pf_ref[_PF_W]

    def block(col, sx, sy, b, acc):
        """Pair tile of the receivers against source block b of a column;
        partial sums stay [BR, BS] tiles until the final reduction."""
        ax, ay, az = acc
        s0 = wstart + b * bs
        smask = b * bs + jnp.arange(bs) < 3 * cap
        cols = pl.ds(s0, bs)

        def src(ref, ch, other=0.0):
            return plgpu.load(ref.at[col, ch, cols], mask=smask,
                              other=other)[None, :]

        dx = src(src_pos_ref, 0) - xi
        dy = src(src_pos_ref, 1) - yi
        dz = src(src_pos_ref, 2) - zi
        if wrap:
            dx = dx + sx
            dy = dy + sy
        d2 = dx * dx + dy * dy + dz * dz
        in_r = d2 < src(src_r2_ref, 0, -1.0)
        coef = u[0] * src(src_v_ref, 0)
        for p in range(1, p_eff):
            coef = coef + u[p] * src(src_v_ref, p)
        sca = pair_scale(law, d2, in_r, coef, pf_ref, use_rsqrt)
        return ax + dx * sca, ay + dy * sca, az + dz * sca

    zero = jnp.zeros((br, bs), jnp.float32)
    acc = (zero, zero, zero)
    for dx, dy in _OFFSETS9:
        col, sx, sy = _neighbor(c, dx, dy, nsc=nsc, wrap=wrap, halo=halo,
                                dummy_col=dummy_col, w=w)
        if nblk <= _UNROLL_BLOCKS:
            for b in range(nblk):
                acc = block(col, sx, sy, b, acc)
        else:
            acc = jax.lax.fori_loop(
                0, nblk, functools.partial(block, col, sx, sy), acc)
    for ch in range(3):
        plgpu.store(out_ref.at[c, ch, rows], jnp.sum(acc[ch], axis=1),
                    mask=rmask)


@functools.partial(
    jax.jit,
    static_argnames=("law", "wrap", "nsc", "cap", "halo", "p_eff", "br",
                     "bs", "interpret"),
)
def _call_kernel(pos_d, u_d, post_g, vt_g, r2_g, params_f, law, wrap, nsc,
                 cap, halo, p_eff, br, bs, interpret):
    ncol = pos_d.shape[0]
    return pl.pallas_call(
        functools.partial(
            _kernel, law=law, wrap=wrap, halo=halo, nsc=nsc, cap=cap,
            p_eff=p_eff, br=br, bs=bs, dummy_col=post_g.shape[0] - 1,
            use_rsqrt=not interpret),
        grid=(ncol, nsc, pl.cdiv(cap, br)),
        out_shape=jax.ShapeDtypeStruct((ncol, 3, nsc * cap), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name="celllist_forces",
    )(params_f, pos_d, u_d, post_g, vt_g, r2_g)


def _neighbor_table(ncol: int, nsc: int, wrap: bool, halo: bool,
                    dummy_col: int):
    """Static per-column neighbour tables for the plain twin: (cols [NCOL,
    9] int32, image-shift signs [NCOL, 9, 2] float32)."""
    c = np.arange(ncol)
    cols, shifts = [], []
    for dx, dy in _OFFSETS9:
        col, sx, sy = _neighbor(c, dx, dy, nsc=nsc, wrap=wrap, halo=halo,
                                dummy_col=dummy_col, w=1.0)
        cols.append(np.broadcast_to(col, c.shape))
        shifts.append(np.stack([np.broadcast_to(sx, c.shape),
                                np.broadcast_to(sy, c.shape)], -1))
    return (np.stack(cols, 1).astype(np.int32),
            np.stack(shifts, 1).astype(np.float32))


@functools.partial(
    jax.jit, static_argnames=("law", "wrap", "nsc", "cap", "halo", "p_eff"))
def _call_plain(pos_d, u_d, post_g, vt_g, r2_g, params_f, law, wrap, nsc,
                cap, halo, p_eff):
    """The kernel's contract in plain jnp: each receiver supercell sweeps
    the 27 neighbouring supercells (3 z-cells of each of the 9 columns) of
    the ghosted layout. Columns are processed in ``lax.map`` batches of
    about 2^24 pairs."""
    ncol = pos_d.shape[0]
    cs = nsc * cap
    cols, sgn = _neighbor_table(ncol, nsc, wrap, halo, post_g.shape[0] - 1)
    w = params_f[_PF_W]
    nsrc = 27 * cap
    batch = max(1, min(ncol, (1 << 24) // (cs * nsrc)))
    nb = -(-ncol // batch)
    cb_all = np.minimum(np.arange(nb * batch), ncol - 1).reshape(nb, batch)

    def windows(a, nbr):
        """[ncol_src, C, G] -> [B, C, nsc, 27*cap] source windows."""
        g = a[nbr].reshape(batch, 9, a.shape[1], nsc + 2, cap)
        win = jnp.stack([g[:, :, :, k:k + nsc] for k in range(3)], axis=3)
        return win.transpose(0, 2, 4, 1, 3, 5).reshape(
            batch, a.shape[1], nsc, nsrc)

    def one(cb):
        nbr = jnp.asarray(cols)[cb]
        sp = windows(post_g, nbr)
        sv = windows(vt_g[:, :p_eff], nbr)
        sr2 = windows(r2_g, nbr)[:, 0]
        rp = pos_d[cb].reshape(batch, 3, nsc, cap)
        ru = u_d[cb, :p_eff].reshape(batch, p_eff, nsc, cap)
        xj, yj = sp[:, 0], sp[:, 1]
        if wrap:
            shift = jnp.repeat(jnp.asarray(sgn)[cb] * w, 3 * cap, axis=1)
            xj = xj + shift[:, None, :, 0]
            yj = yj + shift[:, None, :, 1]
        dx = xj[:, :, None, :] - rp[:, 0, :, :, None]  # [B, nsc, cap, 27cap]
        dy = yj[:, :, None, :] - rp[:, 1, :, :, None]
        dz = sp[:, 2, :, None, :] - rp[:, 2, :, :, None]
        d2 = dx * dx + dy * dy + dz * dz
        in_r = d2 < sr2[:, :, None, :]
        coef = ru[:, 0, :, :, None] * sv[:, 0, :, None, :]
        for p in range(1, p_eff):
            coef = coef + ru[:, p, :, :, None] * sv[:, p, :, None, :]
        sca = pair_scale(law, d2, in_r, coef, params_f, False)
        f = jnp.stack([jnp.sum(dx * sca, -1), jnp.sum(dy * sca, -1),
                       jnp.sum(dz * sca, -1)], axis=1)
        return f.reshape(batch, 3, cs)

    out = jax.lax.map(one, jnp.asarray(cb_all))
    return out.reshape(nb * batch, 3, cs)[:ncol]


def _call(pos_d, u_d, post_g, vt_g, r2_g, params_f, law, wrap, nsc, cap,
          interpret=None, halo: bool = False, *, p_eff: int):
    """Column-sweep forces on the dense ghosted layout.

    Receiver operands and the output are slot-minor: ``pos_d [NCOL, 3,
    CS]``, ``u_d [NCOL, P, CS]``, out ``[NCOL, 3, CS]``; sources are
    ``post_g [NCOLS, 3, G]``, ``vt_g [NCOLS, P, G]``, ``r2_g [NCOLS, 1,
    G]`` with G = (nsc + 2) * cap (z ghosts) and, for walled boxes, a
    fully-masked dummy column last. ``p_eff`` is the number of feature rows
    in use (``forces.feature_dim``)."""
    route = kernel_route(interpret)
    if route == "plain":
        return _call_plain(pos_d, u_d, post_g, vt_g, r2_g, params_f, law,
                           bool(wrap), nsc, cap, bool(halo), p_eff)
    return _call_kernel(pos_d, u_d, post_g, vt_g, r2_g, params_f, law,
                        bool(wrap), nsc, cap, bool(halo), p_eff,
                        block_rows(cap), BLOCK_S, route == "interpret")


def fold_to_cells(pos_r, w, nsc: int, cap: int, col0_x: int | None = None,
                  x_of_col=None):
    """Fold each slot's coordinates into the periodic image nearest its
    CELL center. The kernel's column-level image scheme (see _kernel)
    assumes every stored coordinate lies near its slot's cell — true right
    after a (re)build, but an occupant that wrap-crossed the box on a STALE
    layout (cadenced windows; verlet/leapfrog's post-boundary force eval)
    sits a whole box from its cell and would silently miss its near-
    boundary pairs. Four elementwise passes over [S, 3] — O(slots) — restore the
    invariant exactly: unwrapped occupants fold by w * round(0) == 0.0
    (bit-identical), wrapped ones by exactly +-w.

    ``x_of_col`` overrides the per-column global x cell index (the slab
    decomposition's columns are a LOCAL x-plane window of the global grid).
    """
    ncol, cs = pos_r.shape[0], pos_r.shape[1]
    cellw = w / nsc
    col = jnp.arange(ncol, dtype=jnp.int32)
    gx = x_of_col if x_of_col is not None else col // nsc
    if col0_x is not None:  # may be traced (slab device offset)
        gx = gx + col0_x
    ctr_x = (gx.astype(jnp.float32) + 0.5) * cellw - 0.5 * w
    ctr_y = ((col % nsc).astype(jnp.float32) + 0.5) * cellw - 0.5 * w
    zc = jnp.arange(cs, dtype=jnp.int32) // cap
    ctr_z = (zc.astype(jnp.float32) + 0.5) * cellw - 0.5 * w
    ctr = jnp.stack([
        jnp.broadcast_to(ctr_x[:, None], (ncol, cs)),
        jnp.broadcast_to(ctr_y[:, None], (ncol, cs)),
        jnp.broadcast_to(ctr_z[None, :], (ncol, cs)),
    ], axis=-1)
    return pos_r - w * jnp.round((pos_r - ctr) / w)


def prepare_columns(positions, u, v, cfg: SimConfig, nsc: int, cap: int):
    """Bin + sort into the column-dense ghosted layout.

    Returns (pos_d [NCOL,3,CS], u_d [NCOL,P,CS], post_g [NCOL,3,G],
    vt_g [NCOL,P,G], r2_g [NCOL,1,G], slot_particle [NCOL,CS]) — receiver
    arrays slot-minor like the sources (see ``_call``).
    """
    n = positions.shape[0]
    w = jnp.asarray(cfg.world_size, jnp.float32)
    cellw = w / nsc
    ncol = nsc * nsc
    cs = nsc * cap

    shifted = positions + w * 0.5
    idx3 = jnp.clip(jnp.floor(shifted / cellw).astype(jnp.int32), 0, nsc - 1)
    sid = (idx3[:, 0] * nsc + idx3[:, 1]) * nsc + idx3[:, 2]
    order = jnp.argsort(sid)
    sid_s = sid[order]
    starts = jnp.searchsorted(sid_s, jnp.arange(nsc ** 3, dtype=sid.dtype))
    rank = jnp.arange(n, dtype=jnp.int32) - starts[sid_s].astype(jnp.int32)
    keep = rank < cap
    flat = jnp.where(keep, sid_s * cap + rank, nsc ** 3 * cap)
    slot_particle = jnp.full((nsc ** 3 * cap + 1,), -1, jnp.int32)
    slot_particle = slot_particle.at[flat].set(order.astype(jnp.int32),
                                               mode="drop")[:-1]
    present = slot_particle >= 0
    safe = jnp.where(present, slot_particle, 0)

    pos_r = positions[safe].reshape(ncol, cs, 3).astype(jnp.float32)
    u_r = u[safe].reshape(ncol, cs, -1).astype(jnp.float32)
    pos_d = jnp.transpose(pos_r, (0, 2, 1))
    u_d = jnp.transpose(u_r, (0, 2, 1))
    v_d = v[safe].reshape(ncol, cs, -1).astype(jnp.float32)
    r2 = _r2_gate(cfg)
    r2_d = jnp.where(present, r2, -1.0).reshape(ncol, cs).astype(jnp.float32)

    wrap = bool(cfg.wrap_forces)
    if wrap:
        # z ghosts carry COORDINATE-SHIFTED images (+-w on the z channel):
        # in-kernel deltas are then true displacements with no per-pair
        # minimum-image passes (see _kernel's column-level image comment)
        zs = jnp.zeros((3,), jnp.float32).at[2].set(w)
        pos_g = jnp.concatenate(
            [pos_r[:, cs - cap:] - zs, pos_r, pos_r[:, :cap] + zs], axis=1)
        v_g = jnp.concatenate([v_d[:, cs - cap:], v_d, v_d[:, :cap]], axis=1)
        r2_gh = jnp.concatenate([r2_d[:, cs - cap:], r2_d, r2_d[:, :cap]], axis=1)
    else:
        zpad3 = jnp.zeros((ncol, cap, 3), jnp.float32)
        zpadp = jnp.zeros((ncol, cap, v_d.shape[2]), jnp.float32)
        mpad = jnp.full((ncol, cap), -1.0, jnp.float32)
        pos_g = jnp.concatenate([zpad3, pos_r, zpad3], axis=1)
        v_g = jnp.concatenate([zpadp, v_d, zpadp], axis=1)
        r2_gh = jnp.concatenate([mpad, r2_d, mpad], axis=1)
        # dummy fully-masked column for out-of-range neighbor maps
        g = cs + 2 * cap
        pos_g = jnp.concatenate([pos_g, jnp.zeros((1, g, 3), jnp.float32)], 0)
        v_g = jnp.concatenate([v_g, jnp.zeros((1, g, v_g.shape[2]), jnp.float32)], 0)
        r2_gh = jnp.concatenate([r2_gh, jnp.full((1, g), -1.0, jnp.float32)], 0)

    post_g = jnp.transpose(pos_g, (0, 2, 1))  # (NCOL[+1], 3, G)
    vt_g = jnp.transpose(v_g, (0, 2, 1))  # (NCOL[+1], P, G)
    r2_g = r2_gh[:, None, :]  # (NCOL[+1], 1, G)
    return pos_d, u_d, post_g, vt_g, r2_g, slot_particle.reshape(ncol, cs)


def pallas_celllist_forces(positions, u, v, cfg: SimConfig,
                           nsc: int | None = None, cap: int | None = None,
                           interpret: bool | None = None):
    """Accumulated pair forces [N,3] via the column-sweep cell kernel.

    nsc (supercells per axis, width must be >= the effective cutoff) and cap
    (slots per supercell) come from cfg.cell_grid / cfg.cell_capacity when
    not given. Falls back to the XLA cell list when nsc < 3.
    """
    n = positions.shape[0]
    if nsc is None:
        nsc = cfg.cell_grid
    if cap is None:
        cap = cfg.cell_capacity
    if nsc is None:
        from .celllist import grid_dims

        nsc = grid_dims(float(cfg.world_size), float(cfg.particle_effect_radius))
    if cap is None:
        from .celllist import default_capacity

        cap = default_capacity(n, nsc, slack=2.5)
    if nsc < 3:
        from .celllist import celllist_forces

        return celllist_forces(positions, u, v, cfg, nc=nsc, capacity=cap)
    # correctness requires supercell width >= effective cutoff (best-effort
    # check when the config is concrete)
    try:
        w = float(cfg.world_size)
        r = float(cfg.particle_effect_radius)
        cutoff = min(r, 1.0) if cfg.force_law == "particle_life" else r
        if w / nsc < cutoff - 1e-6:
            raise ValueError(
                f"cell width {w / nsc:.4f} < effective cutoff {cutoff:.4f}: "
                f"reduce cell_grid (nsc={nsc}) so cells cover the cutoff")
    except TypeError:
        pass  # traced config: caller is responsible for nsc
    if u.shape[1] < PAIR_P:
        pad = PAIR_P - u.shape[1]
        u = jnp.pad(u, ((0, 0), (0, pad)))
        v = jnp.pad(v, ((0, 0), (0, pad)))

    pos_d, u_d, post_g, vt_g, r2_g, slot_particle = prepare_columns(
        positions, u, v, cfg, nsc, cap)
    params_f = pack_params(cfg)
    forces_d = _call(pos_d, u_d, post_g, vt_g, r2_g, params_f,
                     cfg.force_law, bool(cfg.wrap_forces), nsc, cap, interpret,
                     p_eff=F.feature_dim(cfg))

    out = jnp.zeros((n + 1, 3), positions.dtype)
    flat = jnp.where(slot_particle >= 0, slot_particle, n).reshape(-1)
    slotf = jnp.transpose(forces_d, (0, 2, 1)).reshape(-1, 3)

    # capacity-overflow particles (prepare_columns drops cell rank
    # >= cap) get EXACT forces from the overflow sidecar instead of riding
    # the sweep force-dead — the same capacity/Poisson-tail decoupling the
    # production dense path uses (ops/overflow.py), so mean-occupancy
    # geometries are exact on this fresh-build path too. Straight-line (no
    # cond — see engine.step._sidecar_apply): dead worklist entries
    # contribute exact zeros, and f_from folds into the one existing
    # slot->particle scatter.
    from .celllist_dense import OCAP
    from .compaction import masked_indices
    from .overflow import neighborhood_sweeps

    ocap = OCAP if cfg.overflow_capacity is None else cfg.overflow_capacity
    if ocap:
        slot = slot_particle.reshape(-1)
        s_tot = slot.shape[0]
        inv = jnp.full((n + 1,), -1, jnp.int32)
        inv = inv.at[jnp.where(slot >= 0, slot, n)].set(
            jnp.arange(s_tot, dtype=jnp.int32), mode="drop")
        dropped = inv[:n] < 0
        mis_p = masked_indices(dropped, ocap, fill_value=n)
        safe = jnp.where(slot >= 0, slot, 0)
        pos_s = positions[safe].astype(jnp.float32)
        u_s = u[safe].astype(jnp.float32)
        v_s = v[safe].astype(jnp.float32)
        mp = jnp.minimum(mis_p, n - 1)
        f_mis, f_from = neighborhood_sweeps(
            pos_s, u_s, v_s, slot >= 0,
            positions[mp].astype(jnp.float32),
            u[mp].astype(jnp.float32), v[mp].astype(jnp.float32),
            mis_p < n, cfg, nsc, cap)
        out = out.at[mis_p].add(f_mis.astype(out.dtype))
        slotf = slotf + f_from.astype(slotf.dtype)
    out = out.at[flat].add(slotf)
    return out[:n]


# ---------------------------------------------------------------------------
# Cadenced rebuild: reuse the sorted layout across steps
# ---------------------------------------------------------------------------
#
# Binning only needs to be *valid*, not fresh: a pair within the cutoff is
# still covered by the +/-1 supercell window as long as every particle has
# drifted less than (cell_width - cutoff)/2 since the layout was built. The
# expensive part of a rebuild is the sort + scatter (the layout); refreshing
# VALUES (positions) into an existing layout is one gather. Species/mass
# features and the r2 row are layout-constant and cached.

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class CellLayout:
    """Frozen binning of particles into the column-dense layout."""

    slot_particle: Any  # i32 [NCOL, CS], -1 padding
    u_d: Any            # f32 [NCOL, P, CS] cached receiver features (slot-minor)
    vt_g: Any           # f32 [NCOL(+1), P, G] cached ghosted source features
    r2_g: Any           # f32 [NCOL(+1), 1, G]
    anchor: Any         # f32 [N, 3] positions at build time (drift checks)


jax.tree_util.register_dataclass(
    CellLayout,
    data_fields=["slot_particle", "u_d", "vt_g", "r2_g", "anchor"],
    meta_fields=[],
)


def build_layout(positions, u, v, cfg: SimConfig, nsc: int, cap: int) -> CellLayout:
    if u.shape[1] < PAIR_P:
        pad = PAIR_P - u.shape[1]
        u = jnp.pad(u, ((0, 0), (0, pad)))
        v = jnp.pad(v, ((0, 0), (0, pad)))
    _, u_d, _, vt_g, r2_g, slot_particle = prepare_columns(
        positions, u, v, cfg, nsc, cap)
    return CellLayout(slot_particle, u_d, vt_g, r2_g, positions)


def slot_of_particle(layout: CellLayout, n: int):
    """Inverse slot mapping: i32[N] flat slot index per particle, -1 for
    particles dropped by capacity overflow."""
    slot = layout.slot_particle.reshape(-1)
    flat = jnp.arange(slot.shape[0], dtype=jnp.int32)
    inv = jnp.full((n + 1,), -1, jnp.int32)
    inv = inv.at[jnp.where(slot >= 0, slot, n)].set(flat, mode="drop")
    return inv[:n]


def dense_forces(layout: CellLayout, pos_flat, cfg: SimConfig,
                 nsc: int, cap: int, interpret: bool | None = None):
    """Forces for positions already IN the dense slot layout.

    pos_flat: f32[NCOL*CS, 3] -> forces f32[NCOL*CS, 3] (garbage on phantom
    slots — they are masked as sources by r2_g, and callers never read
    phantom rows back). Avoids the per-step gather/scatter entirely.
    """
    ncol = nsc * nsc
    cs = nsc * cap
    pos_r = pos_flat.reshape(ncol, cs, 3).astype(jnp.float32)
    wrap = bool(cfg.wrap_forces)
    if wrap:
        # stale-layout wrap crossers + coordinate-shifted z ghosts (see
        # fold_to_cells / the kernel's column-level image scheme)
        w = jnp.asarray(cfg.world_size, jnp.float32)
        pos_r = fold_to_cells(pos_r, w, nsc, cap)
        zs = jnp.zeros((3,), jnp.float32).at[2].set(w)
        pos_g = jnp.concatenate(
            [pos_r[:, cs - cap:] - zs, pos_r, pos_r[:, :cap] + zs], axis=1)
    else:
        zpad3 = jnp.zeros((ncol, cap, 3), jnp.float32)
        pos_g = jnp.concatenate([zpad3, pos_r, zpad3], axis=1)
        pos_g = jnp.concatenate(
            [pos_g, jnp.zeros((1, cs + 2 * cap, 3), jnp.float32)], axis=0)
    pos_d = jnp.transpose(pos_r, (0, 2, 1))
    post_g = jnp.transpose(pos_g, (0, 2, 1))
    params_f = pack_params(cfg)
    forces_d = _call(pos_d, layout.u_d, post_g, layout.vt_g, layout.r2_g,
                     params_f, cfg.force_law, wrap, nsc, cap, interpret,
                     p_eff=F.feature_dim(cfg))
    return jnp.transpose(forces_d, (0, 2, 1)).reshape(-1, 3)


def drift_budget(cfg: SimConfig, nsc: int):
    """Max per-particle displacement the layout tolerates."""
    w = jnp.asarray(cfg.world_size, jnp.float32)
    r = jnp.asarray(cfg.particle_effect_radius, jnp.float32)
    cutoff = jnp.minimum(r, 1.0) if cfg.force_law == "particle_life" else r
    return (w / nsc - cutoff) * 0.5


def layout_drift(layout: CellLayout, positions, cfg: SimConfig):
    """Max displacement since the layout anchor (minimum-image metric)."""
    d = F.min_image(positions - layout.anchor, cfg.world_size)
    return jnp.sqrt(jnp.max(jnp.sum(d * d, axis=-1)))


def layout_forces(layout: CellLayout, positions, cfg: SimConfig,
                  nsc: int, cap: int, interpret: bool | None = None):
    """Forces using a frozen layout for PARTICLE-ORDER positions: one gather
    into the dense slots, the kernel, one scatter back. Prefer dense_forces
    when the state already lives in the slot layout (simulate_cadenced)."""
    n = positions.shape[0]
    slot = layout.slot_particle
    present = slot >= 0
    safe = jnp.where(present, slot, 0)
    pos_flat = positions[safe.reshape(-1)]
    pos_flat = jnp.where(present.reshape(-1, 1), pos_flat,
                         jnp.zeros_like(pos_flat))
    forces_flat = dense_forces(layout, pos_flat, cfg, nsc, cap, interpret)
    out = jnp.zeros((n + 1, 3), positions.dtype)
    flat = jnp.where(present, slot, n).reshape(-1)
    out = out.at[flat].add(forces_flat)
    return out[:n]
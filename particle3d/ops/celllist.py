"""Static-shape cell-list neighbor path (O(N * density) instead of O(N^2)).

Replacement for the reference's spatial hash (``src/lib.rs:134-164``:
SipHash of truncated cell coords into an atomic counting sort, with hash
collisions adding spurious candidates). Here:

  * cell ids are exact (floor binning on the shifted box — deliberately
    diverging from quirk Q1's truncation-toward-zero, which is a binning
    artifact, not semantics; the radius gate makes both correct),
  * particles are sorted by raveled cell id (one ``argsort`` — XLA's on-device
    bitonic sort replaces the atomic scatter),
  * each cell owns a fixed-capacity slot block (static shapes for XLA),
  * forces: for every cell, its receivers sweep the 27 neighbor cells'
    padded source blocks — batched with ``lax.map`` to bound memory,
  * the minimum-image wrap in the pair math handles periodic neighbor cells.

Capacity is static (compile-time); ``celllist_stats`` reports occupancy and
overflow so hosts can rebuild with a larger capacity (the jax-md pattern).
Overflowed particles are dropped from both receiver and source sets — always
size capacity generously (default 3x mean occupancy).

Requires >= 3 cells per axis (otherwise the 27-neighborhood would double
count through the wrap); below that the caller should use all-pairs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import SimConfig
from . import forces as F

# float32 products: the GPU's default precision rounds matmul operands to
# TF32, which cannot hold a general attraction matrix or mass.
_HI = jax.lax.Precision.HIGHEST


def grid_dims(world_size: float, radius: float) -> int:
    """Cells per axis: floor(world/radius) guarantees cell width >= radius."""
    return max(int(world_size // radius), 1)


def default_capacity(n: int, nc: int, slack: float = 3.0) -> int:
    mean = n / max(nc ** 3, 1)
    cap = int(-(-slack * mean // 8) * 8)
    return max(cap, 8)


def _cell_ids(positions, cfg: SimConfig, nc: int):
    """Raveled cell id per particle, i32[N]."""
    w = cfg.world_size
    cellw = w / nc
    shifted = positions + w * 0.5
    idx = jnp.clip(jnp.floor(shifted / cellw).astype(jnp.int32), 0, nc - 1)
    return (idx[:, 0] * nc + idx[:, 1]) * nc + idx[:, 2]


def _supercell_tables(nc: int, g: int, wrap: bool):
    """Supercell blocking tables (the cluster-pair idea): group g^3 small
    cells into one supercell; its receivers sweep the (g+2)^3 small cells of
    the supercell plus a 1-cell halo. g=1 reduces to the classic per-cell
    27-neighborhood. Returns (own [S, g^3], nbr [S, (g+2)^3], nbr_valid).

    Larger g trades more candidate tests per receiver ((g+2)^3/27 vs g=1)
    for far fatter, vector-friendly tiles — g=2 gives (8*cap x 64*cap) sweeps,
    ~2.4x the tests of g=1 at many times the per-op efficiency.
    """
    import numpy as np

    assert nc % g == 0, (nc, g)
    ns = nc // g
    base = np.stack(np.meshgrid(np.arange(ns), np.arange(ns), np.arange(ns),
                                indexing="ij"), -1).reshape(-1, 3) * g  # [S,3]
    intra = np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)  # [g^3, 3]
    own = base[:, None, :] + intra[None, :, :]  # [S, g^3, 3]
    halo = np.stack(np.meshgrid(*[np.arange(-1, g + 1)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)  # [(g+2)^3, 3]
    nbr = base[:, None, :] + halo[None, :, :]  # [S, (g+2)^3, 3]
    if wrap:
        nbr_m = nbr % nc
        valid = np.ones(nbr.shape[:2], bool)
    else:
        valid = np.all((nbr >= 0) & (nbr < nc), axis=-1)
        nbr_m = np.clip(nbr, 0, nc - 1)

    def ravel(a):
        return (a[..., 0] * nc + a[..., 1]) * nc + a[..., 2]

    return (jnp.asarray(ravel(own), jnp.int32),
            jnp.asarray(ravel(nbr_m), jnp.int32),
            jnp.asarray(valid))


def _neighbor_table(nc: int, wrap: bool):
    """[C, 27] neighbor cell ids (g=1 supercell tables, kept for tests)."""
    _, nbr, valid = _supercell_tables(nc, 1, wrap)
    return nbr, valid


def build_cell_list(positions, cfg: SimConfig, nc: int, capacity: int):
    """Bin particles: returns (slot_idx [C, CAP] particle indices with -1
    padding, order [N] sort permutation)."""
    n = positions.shape[0]
    c = nc ** 3
    cid = _cell_ids(positions, cfg, nc)
    order = jnp.argsort(cid)
    cid_sorted = cid[order]
    # rank within cell = position among equal cids
    starts = jnp.searchsorted(cid_sorted, jnp.arange(c, dtype=cid.dtype))
    rank = jnp.arange(n, dtype=jnp.int32) - starts[cid_sorted].astype(jnp.int32)
    keep = rank < capacity
    flat = jnp.where(keep, cid_sorted * capacity + rank, c * capacity)
    slot_idx = jnp.full((c * capacity + 1,), -1, jnp.int32)
    slot_idx = slot_idx.at[flat].set(order.astype(jnp.int32), mode="drop")
    return slot_idx[:-1].reshape(c, capacity), order


def celllist_stats(positions, cfg: SimConfig, nc: int | None = None,
                   capacity: int | None = None):
    """Host-side diagnostics: (max occupancy, overflow bool, cells/axis)."""
    n = positions.shape[0]
    if nc is None:
        nc = grid_dims(float(cfg.world_size), float(cfg.particle_effect_radius))
    if capacity is None:
        capacity = default_capacity(n, nc)
    cid = _cell_ids(jnp.asarray(positions), cfg, nc)
    counts = jnp.zeros((nc ** 3,), jnp.int32).at[cid].add(1)
    mx = int(counts.max())
    return mx, mx > capacity, nc


def celllist_forces(positions, u, v, cfg: SimConfig,
                    nc: int | None = None, capacity: int | None = None,
                    cell_batch: int = 512, group: int | None = None):
    """Accumulated pair forces [N,3] via the cell list.

    Falls back to the 27-neighborhood sweep per cell; identical semantics to
    all-pairs for world >= 2*radius (every in-radius pair is within one cell
    of its receiver).
    """
    n = positions.shape[0]
    if nc is None:
        nc = cfg.cell_grid
    if capacity is None:
        capacity = cfg.cell_capacity
    if nc is None:
        # static given concrete config floats; traced configs must set
        # cfg.cell_grid (static meta field) or pass nc explicitly
        nc = grid_dims(float(cfg.world_size), float(cfg.particle_effect_radius))
    if nc < 3:
        from .allpairs import allpairs_forces

        return allpairs_forces(positions, u, v, cfg)
    if capacity is None:
        capacity = default_capacity(n, nc)
    c = nc ** 3
    scale = F.scale_fn(cfg)
    r2 = cfg.particle_effect_radius * cfg.particle_effect_radius

    if group is None:
        group = 2 if nc % 2 == 0 and nc >= 4 else 1
    while nc % group:
        group -= 1
    g3 = group ** 3
    h3 = (group + 2) ** 3
    ns3 = (nc // group) ** 3  # number of supercells

    slot_idx, _ = build_cell_list(positions, cfg, nc, capacity)  # [C, CAP]
    present = slot_idx >= 0
    safe_idx = jnp.where(present, slot_idx, 0)
    cell_pos = positions[safe_idx]  # [C, CAP, 3]
    cell_u = u[safe_idx]  # [C, CAP, P]
    cell_v = v[safe_idx]
    own_ids, nb_ids, nb_valid = _supercell_tables(
        nc, group, bool(cfg.wrap_forces))  # [S,g^3], [S,h^3], [S,h^3]

    nrec = g3 * capacity
    nsrc = h3 * capacity

    def one_batch(args):
        own, nb, nbv = args
        b = own.shape[0]
        rec_pos = cell_pos[own].reshape(b, nrec, 3)
        rec_u = cell_u[own].reshape(b, nrec, -1)
        rec_present = present[own].reshape(b, nrec)
        src_pos = cell_pos[nb].reshape(b, nsrc, 3)
        src_v = cell_v[nb].reshape(b, nsrc, -1)
        src_present = jnp.logical_and(present[nb], nbv[..., None]).reshape(
            b, nsrc)
        # per-axis math (no [B,R,S,3] tensors): the whole elementwise chain
        # between the gathers and the source-axis reductions fuses in XLA
        w = cfg.world_size

        def axis_delta(c):
            d = src_pos[:, None, :, c] - rec_pos[:, :, None, c]  # [B,R,S]
            return F.min_image(d, w) if cfg.wrap_forces else d

        dx, dy, dz = axis_delta(0), axis_delta(1), axis_delta(2)
        d2 = dx * dx + dy * dy + dz * dz
        valid = (d2 > 0.0) & (d2 < r2) & src_present[:, None, :] \
            & rec_present[:, :, None]
        coef = jnp.einsum("bip,bjp->bij", rec_u, src_v, precision=_HI)
        s = jnp.where(valid, scale(jnp.where(valid, d2, 1.0), coef), 0.0)
        return jnp.stack(
            [jnp.sum(dx * s, axis=-1), jnp.sum(dy * s, axis=-1),
             jnp.sum(dz * s, axis=-1)], axis=-1)  # [B, R, 3]

    batch = max(1, cell_batch // g3)  # supercells per map step
    nbatch = -(-ns3 // batch)
    if nbatch <= 1:
        forces_cells = one_batch((own_ids, nb_ids, nb_valid))
    else:
        pad = nbatch * batch - ns3

        def padb(a):
            return jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1)).reshape(
                (nbatch, batch) + a.shape[1:])

        forces_cells = jax.lax.map(
            one_batch, (padb(own_ids), padb(nb_ids), padb(nb_valid)),
        ).reshape((nbatch * batch, nrec, 3))[:ns3]

    # scatter per-slot forces back to particle order
    out = jnp.zeros((n + 1, 3), positions.dtype)
    own_slots = slot_idx[own_ids].reshape(-1)  # [S*g^3*CAP]
    own_present = present[own_ids].reshape(-1)
    flat_idx = jnp.where(own_present, own_slots, n)
    out = out.at[flat_idx].add(forces_cells.reshape(-1, 3))
    return out[:n]

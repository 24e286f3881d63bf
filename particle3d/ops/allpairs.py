"""Dense O(N^2) all-pairs force accumulation (pure jnp / XLA).

This is the portable baseline backend: broadcast pairwise displacement with
the minimum-image wrap, radius + self masks, rank-1 pair coefficients via a
float32 matmul, masked accumulate. XLA fuses the whole tile chain; the Pallas kernel
in ``pallas_allpairs.py`` is the hand-tiled version of the same math.

Semantics match the reference hot loop ``src/lib.rs:176-243``:
  * reads one immutable snapshot (Jacobi update, src/lib.rs:167-171)
  * pair accepted iff 0 < d^2 < radius^2 (src/lib.rs:216-220, quirk Q8:
    coincident particles exert no force)
  * accumulate unit(i->j) * magnitude (src/lib.rs:231)
  * periodic images applied regardless of walls (quirk Q3) unless
    cfg.wrap_forces is False.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SimConfig
from . import forces as F

# float32 products: the GPU's default precision rounds matmul operands to
# TF32, which cannot hold a general attraction matrix or mass.
_HI = jax.lax.Precision.HIGHEST


def _tile_forces(pos_i, u_i, pos_j, v_j, cfg: SimConfig, scale,
                 ok_j=None):
    """Forces on a block of receivers from a block of sources.

    pos_i: [TI,3], u_i: [TI,P], pos_j: [TJ,3], v_j: [TJ,P] -> [TI,3].
    ``ok_j`` masks phantom SOURCE rows (padding in compacted buffers) —
    necessary because the particle-life repulsion term is coefficient-
    independent (src/lib.rs:55-58), so zeroed V features alone cannot
    silence a dead row.
    """
    delta = pos_j[None, :, :] - pos_i[:, None, :]  # [TI,TJ,3], i -> j
    if cfg.wrap_forces:
        delta = F.min_image(delta, cfg.world_size)
    d2 = jnp.sum(delta * delta, axis=-1)  # [TI,TJ]
    r = cfg.particle_effect_radius
    valid = jnp.logical_and(d2 > 0.0, d2 < r * r)
    if ok_j is not None:
        valid = jnp.logical_and(valid, ok_j[None, :])
    # rank-1 pair coefficients [TI,TJ]
    coef = jnp.dot(u_i, v_j.T, precision=_HI)
    s = jnp.where(valid, scale(jnp.where(valid, d2, 1.0), coef), 0.0)
    return jnp.einsum("ijc,ij->ic", delta, s, precision=_HI)


def allpairs_forces(positions, u, v, cfg: SimConfig, block_i: int = 1024,
                    src_positions=None, src_v=None, src_valid=None):
    """Accumulated pair forces, [N,3].

    Blocked over receivers with ``lax.map`` so peak memory is
    O(block_i * N_src) rather than O(N^2) — the XLA analogue of streaming
    the j-dimension. N must not be huge here; use the Pallas or cell-list
    backend past ~64k.

    ``src_positions``/``src_v`` select a different source set than the
    receivers (rectangular sweep) — used by the ring-sharded backend, where
    remote position blocks stream past local receivers. ``src_valid``
    masks phantom source rows (compacted/padded buffers).
    """
    if src_positions is None:
        src_positions, src_v = positions, v
    n = positions.shape[0]
    mag = F.scale_fn(cfg)
    if n <= block_i:
        return _tile_forces(positions, u, src_positions, src_v, cfg, mag,
                            ok_j=src_valid)
    nb = -(-n // block_i)
    pad = nb * block_i - n
    # Padding receivers is safe: padded rows are sliced off at the end.
    pos_i = jnp.pad(positions, ((0, pad), (0, 0))).reshape(nb, block_i, 3)
    u_i = jnp.pad(u, ((0, pad), (0, 0))).reshape(nb, block_i, u.shape[1])
    out = jax.lax.map(
        lambda args: _tile_forces(args[0], args[1], src_positions, src_v,
                                  cfg, mag, ok_j=src_valid),
        (pos_i, u_i),
    )
    return out.reshape(nb * block_i, 3)[:n]


def allpairs_accel(state, cfg: SimConfig, block_i: int = 1024):
    """Force sum scaled into an acceleration (src/lib.rs:246-247)."""
    u, v = F.pair_features(state, cfg)
    f = allpairs_forces(state.positions, u, v, cfg, block_i=block_i)
    return f * F.kick_scale(cfg)

"""All-pairs force kernel for the GPU (Pallas, Triton route) and the rule
that picks a force sweep's implementation.

This is the O(N^2) hot path of the ``allpairs_pallas`` backend and of the
ring sweep (``parallel/ring.py``) — the replacement for the reference's
rayon per-particle neighbor loop (``src/lib.rs:171-243``). Design:

  * one program per block of ``BI`` receivers; an in-program ``fori_loop``
    walks the sources in blocks of ``BJ``, so each program reads its
    receivers once; partial sums stay [BI, BJ] register tiles and are
    reduced once, before the one store;
  * inputs are structure-of-arrays rows (``[x, y, z, U|V features]`` x N),
    so every load is a contiguous power-of-two run of one row;
  * the rank-1 pair coefficient ``U[i] . V[j]`` is formed by FMAs over the
    features actually in use (``forces.feature_dim``: the species count for
    particle-life, 1 otherwise) — exact float32, no tensor-core rounding;
  * the padding mask and radius gate are one streamed per-source row
    ``r2row`` (r^2 for real sources, -1 for padding — one compare); for
    particle-life the cutoff is clamped to 1.0 (the force is zero at raw
    distance >= 1, reference quirk Q2, src/lib.rs:59);
  * periodic wrap uses the minimum image (``dx - w * floor(dx / w + 0.5)``),
    equivalent to the reference's 27-image sweep given ``world >= 2*radius``
    (src/lib.rs:132).

Padded receiver rows compute garbage that is sliced off; padded source
columns are killed by ``r2row = -1``.

Routing (``kernel_route``): on ``gpu`` the compiled kernel runs; on ``cpu``
the plain jnp path with the same contract runs (``ops/allpairs.py`` here,
``pallas_celllist._call_plain`` for the cell sweep); any other platform
raises. The Pallas interpreter runs only when a caller passes
``interpret=True`` (tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import SimConfig
from . import forces as F

# Feature rows carried per particle by the dense slot layouts (U and V are
# zero-padded to this width so one packed row holds any law's features).
PAIR_P = 8

# Block geometry of the all-pairs kernel: receivers per program, sources per
# inner-loop step, warps per program.
BLOCK_I = 32
BLOCK_J = 32
NUM_WARPS = 4

# packed scalar param layout
_PF_W = 0        # world size
_PF_INV_W = 1    # 1 / world
_PF_M = 2        # min_pull_ratio
_PF_INV_M = 3    # 1 / min_pull_ratio
_PF_LJ24E = 4    # 24 * lj_epsilon
_PF_LJ_S2 = 5    # lj_sigma^2
_PF_G = 6        # gravity constant
_PF_G_S2 = 7     # gravity softening^2
_PF_K = 8        # spring stiffness
_PF_L = 9        # spring rest length
_PF_T2 = 10      # 2 / (1 - min_pull_ratio)   (triangular shape, folded)
_PF_TC = 11      # (1 + min_pull_ratio) / (1 - min_pull_ratio)


def kernel_route(interpret: bool | None = None) -> str:
    """Which implementation a force sweep runs.

    ``"interpret"`` when the caller asks for the Pallas interpreter;
    otherwise by platform: ``"kernel"`` (compiled Triton) on ``gpu``,
    ``"plain"`` (the jnp twin) on ``cpu``. Any other platform raises."""
    if interpret:
        return "interpret"
    platform = jax.default_backend()
    if platform == "gpu":
        return "kernel"
    if platform == "cpu":
        return "plain"
    raise NotImplementedError(
        f"no force-sweep implementation for platform {platform!r} "
        "(supported: gpu, cpu)")


def _inv_sqrt(d2, use_rsqrt: bool):
    """(inv_d, d). The GPU's rsqrt is within 2 ulp; the interpreter uses an
    exact sqrt + divide (XLA:CPU's rsqrt is a coarser approximation)."""
    if use_rsqrt:
        inv_d = jax.lax.rsqrt(d2)
        return inv_d, d2 * inv_d
    d = jnp.sqrt(d2)
    return 1.0 / d, d


def _scale(law: str, d2, coef, pf, valid, use_rsqrt: bool):
    """masked s = f(d)/d from the SQUARED distance (see forces.scale_fn).

    For particle-life, masked-out pairs arrive with d2 == 1.0 exactly (the
    ``safe`` park value): the triangular kernel is identically zero at d=1
    (and coef*0 at d==m belongs to neither strict branch in the reference —
    quirk Q2), so no final mask multiply is needed; the d<m branch is only
    reachable for real in-range pairs because the park value 1.0 > m.
    """
    if law == "particle_life":
        inv_d, d = _inv_sqrt(d2, use_rsqrt)
        # repulsion (d < m): f/d = (d/m - 1)/d = 1/m - 1/d
        rep = pf[_PF_INV_M] - inv_d
        # triangular (m <= d): zero at d=m and at d>=1 by construction;
        # folded form 1 - |d*2/(1-m) - (1+m)/(1-m)|, clamped at 0 so
        # parked/no-force pairs cannot go negative
        tri = coef * (jnp.maximum(
            1.0 - jnp.abs(d * pf[_PF_T2] - pf[_PF_TC]), 0.0) * inv_d)
        return jnp.where(d < pf[_PF_M], rep, tri)
    if law == "lennard_jones":
        inv_d2 = 1.0 / d2
        a = pf[_PF_LJ_S2] * inv_d2
        a3 = a * a * a
        s = coef * (pf[_PF_LJ24E] * inv_d2) * (a3 - 2.0 * a3 * a3)
        return jnp.where(valid, s, 0.0)
    if law == "gravity":
        dd2 = d2 + pf[_PF_G_S2]
        inv, _ = _inv_sqrt(dd2, use_rsqrt)
        s = coef * pf[_PF_G] * (inv * inv * inv)
        return jnp.where(valid, s, 0.0)
    if law == "spring":
        inv_d, d = _inv_sqrt(d2, use_rsqrt)
        s = coef * pf[_PF_K] * (1.0 - pf[_PF_L] * inv_d)
        return jnp.where(valid, s, 0.0)
    raise ValueError(law)


def pair_scale(law: str, d2, in_r, coef, pf, use_rsqrt: bool):
    """f/d for a tile of pairs already gated by ``in_r`` (radius + padding).

    Particle-life parks out-of-range pairs at d2 == 1 where the law is
    exactly zero and clamps self pairs to eps (the huge-but-finite
    repulsion multiplies a zero delta). The other laws mask d2 == 0 (self
    pairs / coincident particles, quirk Q8): with softening == 0 gravity's
    rsqrt(0) = inf and inf * 0 = NaN would poison the row."""
    if law == "particle_life":
        safe = jnp.where(in_r, jnp.maximum(d2, 1e-12), 1.0)
        return _scale(law, safe, coef, pf, None, use_rsqrt)
    valid = jnp.logical_and(d2 > 0.0, in_r)
    safe = jnp.where(valid, d2, 1.0)
    return _scale(law, safe, coef, pf, valid, use_rsqrt)


def _kernel(pf_ref, rec_ref, src_ref, r2_ref, out_ref, *, law: str,
            wrap: bool, p_eff: int, bi: int, bj: int, nblk: int,
            use_rsqrt: bool):
    rows = pl.ds(pl.program_id(0) * bi, bi)
    xi = rec_ref[0, rows][:, None]
    yi = rec_ref[1, rows][:, None]
    zi = rec_ref[2, rows][:, None]
    u = [rec_ref[3 + p, rows][:, None] for p in range(p_eff)]
    w = pf_ref[_PF_W]
    inv_w = pf_ref[_PF_INV_W]

    def body(b, acc):
        ax, ay, az = acc
        cols = pl.ds(b * bj, bj)
        dx = src_ref[0, cols][None, :] - xi  # [BI, BJ], i -> j
        dy = src_ref[1, cols][None, :] - yi
        dz = src_ref[2, cols][None, :] - zi
        if wrap:
            dx = dx - w * jnp.floor(dx * inv_w + 0.5)
            dy = dy - w * jnp.floor(dy * inv_w + 0.5)
            dz = dz - w * jnp.floor(dz * inv_w + 0.5)
        d2 = dx * dx + dy * dy + dz * dz
        in_r = d2 < r2_ref[0, cols][None, :]
        coef = u[0] * src_ref[3, cols][None, :]
        for p in range(1, p_eff):
            coef = coef + u[p] * src_ref[3 + p, cols][None, :]
        sca = pair_scale(law, d2, in_r, coef, pf_ref, use_rsqrt)
        return ax + dx * sca, ay + dy * sca, az + dz * sca

    zero = jnp.zeros((bi, bj), jnp.float32)
    ax, ay, az = jax.lax.fori_loop(0, nblk, body, (zero, zero, zero))
    out_ref[0, rows] = jnp.sum(ax, axis=1)
    out_ref[1, rows] = jnp.sum(ay, axis=1)
    out_ref[2, rows] = jnp.sum(az, axis=1)


def _round_to(n, m):
    return -(-n // m) * m


def _soa_rows(pos, feat, p_eff: int, rows: int):
    """[3 + p_eff, rows] f32: x, y, z then the used feature columns,
    zero-padded to ``rows``."""
    a = jnp.concatenate([pos.astype(jnp.float32),
                         feat[:, :p_eff].astype(jnp.float32)], axis=1).T
    return jnp.pad(a, ((0, 0), (0, rows - a.shape[1])))


@functools.partial(
    jax.jit, static_argnames=("law", "wrap", "p_eff", "bi", "bj", "interpret"))
def _call(pos, u, src_pos, src_v, params_f, r2_gate, law, wrap, p_eff, bi,
          bj, interpret):
    n = pos.shape[0]
    n_src = src_pos.shape[0]
    np_i = _round_to(n, bi)
    np_j = _round_to(n_src, bj)
    rec = _soa_rows(pos, u, p_eff, np_i)
    src = _soa_rows(src_pos, src_v, p_eff, np_j)
    # radius gate + padding mask in one row (see module docstring)
    r2row = jnp.full((1, np_j), -1.0, jnp.float32)
    r2row = r2row.at[:, :n_src].set(r2_gate.astype(jnp.float32))
    out = pl.pallas_call(
        functools.partial(_kernel, law=law, wrap=wrap, p_eff=p_eff, bi=bi,
                          bj=bj, nblk=np_j // bj, use_rsqrt=not interpret),
        grid=(np_i // bi,),
        out_shape=jax.ShapeDtypeStruct((3, np_i), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name="allpairs_forces",
    )(params_f, rec, src, r2row)
    return out[:, :n].T


def pack_params(cfg: SimConfig):
    """Scalar param vector consumed by the kernels."""
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    w = f32(cfg.world_size)
    m = f32(cfg.min_pull_ratio)
    eps = f32(cfg.lj_epsilon)
    sig = f32(cfg.lj_sigma)
    soft = f32(cfg.gravity_softening)
    return jnp.stack([
        w,
        1.0 / w,
        m,
        1.0 / m,
        24.0 * eps,
        sig * sig,
        f32(cfg.gravity_constant),
        soft * soft,
        f32(cfg.spring_stiffness),
        f32(cfg.spring_rest_length),
        2.0 / (1.0 - m),
        (1.0 + m) / (1.0 - m),
    ])


def _r2_gate(cfg: SimConfig):
    r = jnp.asarray(cfg.particle_effect_radius, jnp.float32)
    r2 = r * r
    if cfg.force_law == "particle_life":
        # force is identically zero at raw distance >= 1 (quirk Q2), so the
        # effective cutoff is min(radius, 1) — fewer pairs survive the gate
        # and the in-kernel d<1 test disappears.
        r2 = jnp.minimum(r2, 1.0)
    return r2


def pallas_allpairs_forces(
    positions,
    u,
    v,
    cfg: SimConfig,
    *,
    src_positions=None,
    src_v=None,
    bi: int = BLOCK_I,
    bj: int = BLOCK_J,
    interpret: bool | None = None,
):
    """Accumulated pair forces [N,3] via the all-pairs kernel.

    ``src_positions``/``src_v`` select a rectangular sweep (receivers vs a
    different source set) — used by the ring-sharded backend. On the CPU
    (``kernel_route``) this is ``ops.allpairs.allpairs_forces``."""
    if src_positions is None:
        src_positions, src_v = positions, v
    route = kernel_route(interpret)
    if route == "plain":
        from .allpairs import allpairs_forces

        return allpairs_forces(positions, u, None, cfg,
                               src_positions=src_positions, src_v=src_v)
    p_eff = min(F.feature_dim(cfg), u.shape[1])
    return _call(
        positions, u, src_positions, src_v, pack_params(cfg), _r2_gate(cfg),
        cfg.force_law, bool(cfg.wrap_forces), p_eff, bi, bj,
        route == "interpret",
    )

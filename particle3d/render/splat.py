"""On-device point-splat rasterizer with an exact scatter-min z-buffer.

Replacement for the reference's wgpu billboard pipeline
(``src/bin/main.rs:487-833`` + ``particles.wgsl``): particles render as
depth-tested circular splats of world-space size ~0.1 (particles.wgsl:71-72),
colored by species (particles.wgsl:53-54). Instead of a raster pipeline, we
pack (depth, color-id) into one int32 per pixel and use ``scatter-min`` —
positive IEEE float bits are monotonic, so the min over packed keys IS the
depth test, deterministically, in one XLA op.

The world-box wireframe is drawn as depth-tested line splats along the 12 box
edges — fixing reference quirk Q7, whose border shader never read world_size
and drew no box.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import SimConfig
from .camera import Camera, view_matrix, projection_matrix

BORDER_COLOR_ID = 254
BACKGROUND_ID = 255
SPRITE_WORLD_SIZE = 0.1  # particles.wgsl:71-72 view-space quad side


def _project(points, vm, pm):
    """world [M,3] -> (pixel xy [M,2] in unit square, depth01 [M], in_front [M])."""
    ones = jnp.ones((points.shape[0], 1), points.dtype)
    hom = jnp.concatenate([points, ones], axis=1)  # [M,4]
    hi = jax.lax.Precision.HIGHEST  # float32 projection (GPU default: TF32)
    viewp = jnp.dot(hom, vm.T, precision=hi)  # [M,4]
    clip = jnp.dot(viewp, pm.T, precision=hi)
    w = clip[:, 3:4]
    in_front = w[:, 0] > 1e-6  # -z_view > 0
    ndc = clip[:, :3] / jnp.where(in_front[:, None], w, 1.0)
    xy = jnp.stack([(ndc[:, 0] + 1.0) * 0.5, (1.0 - ndc[:, 1]) * 0.5], axis=1)
    depth01 = jnp.clip(ndc[:, 2] * 0.5 + 0.5, 0.0, 1.0)
    return xy, depth01, in_front, -viewp[:, 2]  # view-space depth (positive ahead)


def _pack_keys(depth01, color_id):
    """Monotonic (depth, color) packing: high 24 bits = float depth bits."""
    bits = jax.lax.bitcast_convert_type(depth01.astype(jnp.float32), jnp.int32)
    return (bits & jnp.int32(~0xFF)) | color_id.astype(jnp.int32)


def _splat(buf, xy, depth01, view_z, color_id, alive, width, height,
           radius_px, footprint):
    """Scatter-min splats of per-point pixel radius ``radius_px`` into buf."""
    px = xy[:, 0] * width
    py = xy[:, 1] * height
    keys = _pack_keys(depth01, color_id)  # [M]
    half = footprint // 2
    offs = jnp.arange(-half, half + 1)
    ox, oy = jnp.meshgrid(offs, offs, indexing="xy")
    ox = ox.reshape(-1).astype(jnp.float32)  # [F]
    oy = oy.reshape(-1).astype(jnp.float32)
    # pixel centers covered by each splat
    cx = jnp.floor(px[:, None]) + ox[None, :]  # [M,F]
    cy = jnp.floor(py[:, None]) + oy[None, :]
    dist2 = (cx + 0.5 - px[:, None]) ** 2 + (cy + 0.5 - py[:, None]) ** 2
    inside = dist2 <= (radius_px[:, None] ** 2)
    onscreen = (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
    ok = inside & onscreen & alive[:, None]
    lin = (cy.astype(jnp.int32) * width + cx.astype(jnp.int32)).reshape(-1)
    lin = jnp.where(ok.reshape(-1), lin, width * height)  # park dead in sentinel
    return buf.at[lin].min(jnp.broadcast_to(keys[:, None], ok.shape).reshape(-1),
                           mode="drop")


def _box_edge_points(world_size, samples: int):
    """[12*samples, 3] points along the world-box edges."""
    h = world_size * 0.5
    t = jnp.linspace(-1.0, 1.0, samples)
    pts = []
    for axis in range(3):
        for s1 in (-1.0, 1.0):
            for s2 in (-1.0, 1.0):
                e = [None, None, None]
                e[axis] = t * h
                e[(axis + 1) % 3] = jnp.full_like(t, s1 * h)
                e[(axis + 2) % 3] = jnp.full_like(t, s2 * h)
                pts.append(jnp.stack(e, axis=1))
    return jnp.concatenate(pts, axis=0)


# ---------------------------------------------------------------------------
# Fast path: point-scatter + radius dilation
# ---------------------------------------------------------------------------
#
# The exact renderer scatters footprint^2 (=49) pixels per splat — 12.8M
# scatter-min updates at N=262k, scatter-bound. The fast path is
# scatter-light instead:
#
#   1. each splat scatters ONE packed key to its <=4 nearest pixels:
#      [depth:15 | radius*16:9 | color:8] bits — still a scatter-min z-test,
#      but O(N) updates;
#   2. a pure-elementwise dilation reconstructs the circular splats: for
#      every output pixel, min over the <=49 statically-shifted seed images
#      of keys whose embedded radius reaches this pixel. XLA fuses the whole
#      sweep; no gathers, no sorts.
#
# Documented tolerance vs the exact renderer: splat coverage is evaluated
# from the SEED pixel's center (<=0.5 px center error, radius quantized to
# 1/16 px), and when several splat centers land on the same seed pixel only
# the nearest survives as that seed (its 2x2 seeding usually reseeds the
# loser next door). Depth keys carry 15 bits instead of 24.

_DEPTH_SHIFT = 16
_R_SHIFT = 8
_R_SCALE = 16.0


def _pack_fast_keys(view_z, r_px, color_id):
    """[depth:15 | radius:8 | color:8] with depth = the top 15 bits of the
    POSITIVE view-space distance's float32 representation: monotonic in z
    (positive-float bit ordering) with ~2^-7 RELATIVE resolution at every
    scale. (A linear quantization of the NDC depth is useless here: with
    near=0.001 the projective depth saturates within ~1e-4 of 1.0 for the
    whole scene and every splat ties — the tie-break then paints everything
    in the lowest color id.)"""
    bits = jax.lax.bitcast_convert_type(
        jnp.maximum(view_z, 1e-6).astype(jnp.float32), jnp.int32)
    d = bits >> 16  # sign 0 for positive z: 15 bits, order-preserving
    q = jnp.clip(jnp.round(r_px * _R_SCALE), 0, 255).astype(jnp.int32)
    return (d << _DEPTH_SHIFT) | (q << _R_SHIFT) | color_id.astype(jnp.int32)


def _seed_points(buf, xy, view_z, r_px, color_id, alive, width, height):
    """Scatter each splat's packed key to its 2x2 nearest pixels."""
    px = xy[:, 0] * width
    py = xy[:, 1] * height
    keys = _pack_fast_keys(view_z, r_px, color_id)
    ix0 = jnp.floor(px - 0.5).astype(jnp.int32)
    iy0 = jnp.floor(py - 0.5).astype(jnp.int32)
    for dx in (0, 1):
        for dy in (0, 1):
            cx = ix0 + dx
            cy = iy0 + dy
            ok = alive & (cx >= 0) & (cx < width) & (cy >= 0) & (cy < height)
            lin = jnp.where(ok, cy * width + cx, width * height)
            buf = buf.at[lin].min(keys, mode="drop")
    return buf


def _dilate(seeds, height, width, footprint):
    """min over shifted seed images of keys whose radius covers the pixel."""
    half = footprint // 2
    inf = jnp.int32(0x7FFFFFFF)
    pad = jnp.pad(seeds, ((half, half), (half, half)), constant_values=inf)
    out = seeds
    rmask = jnp.int32(0xFF << _R_SHIFT)
    for oy in range(-half, half + 1):
        for ox in range(-half, half + 1):
            if ox == 0 and oy == 0:
                continue
            dist = (ox * ox + oy * oy) ** 0.5
            thr = int(round(dist * _R_SCALE))
            if thr > 255:
                continue  # beyond the largest representable radius
            cand = jax.lax.dynamic_slice(
                pad, (half + oy, half + ox), (height, width))
            covered = (cand & rmask) >= (thr << _R_SHIFT)
            out = jnp.minimum(out, jnp.where(covered, cand, inf))
    return out


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "footprint", "draw_border",
                     "border_samples", "method"),
)
def render_frame(positions, species, cfg: SimConfig, cam: Camera,
                 width: int = 640, height: int = 480, *,
                 footprint: int = 7, draw_border: bool = True,
                 border_samples: int = 128, method: str = "dilate"):
    """Render one frame entirely on device -> uint8 image [H, W, 3].

    positions [N,3], species i32[N]; colors come from cfg.colors
    (the reference's per-species color table, src/bin/main.rs:126-132).

    method: "dilate" (default; O(N) seed scatter + elementwise radius
    dilation, ~10x faster at large N, sub-pixel-approximate — see the fast
    path notes above) or "scatter" (exact per-pixel scatter-min coverage).
    """
    if method == "dilate":
        return _render_frame_dilate(positions, species, cfg, cam, width,
                                    height, footprint, draw_border,
                                    border_samples)
    if method != "scatter":
        raise ValueError(f"unknown render method {method!r}")
    vm = view_matrix(cam)
    pm = projection_matrix(cam, width / height)
    # focal length in pixels for world->pixel radius conversion
    fov = jnp.deg2rad(jnp.asarray(cam.fov_deg, jnp.float32))
    focal_px = (height * 0.5) / jnp.tan(fov / 2.0)

    buf = jnp.full((width * height + 1,), jnp.int32(0x7FFFFFFF))

    if draw_border:
        bp = _box_edge_points(jnp.asarray(cfg.world_size, jnp.float32),
                              border_samples)
        xy, d01, front, vz = _project(bp, vm, pm)
        r_px = jnp.full((bp.shape[0],), 1.0)
        buf = _splat(buf, xy, d01, vz, jnp.full((bp.shape[0],), BORDER_COLOR_ID),
                     front, width, height, r_px, 3)

    xy, d01, front, vz = _project(positions, vm, pm)
    r_px = (SPRITE_WORLD_SIZE * 0.5) * focal_px / jnp.maximum(vz, 1e-6)
    # min radius > sqrt(2)/2 so a sub-pixel splat centered on a pixel corner
    # still covers at least one pixel center
    r_px = jnp.clip(r_px, 0.75, footprint / 2.0)
    buf = _splat(buf, xy, d01, vz, species, front, width, height, r_px,
                 footprint)

    img_keys = buf[:-1].reshape(height, width)
    return _decode(img_keys, cfg)


def _decode(img_keys, cfg: SimConfig):
    ids = img_keys & 0xFF
    empty = img_keys == jnp.int32(0x7FFFFFFF)
    ids = jnp.where(empty, BACKGROUND_ID, ids)

    palette = jnp.zeros((256, 3), jnp.float32)
    colors = jnp.asarray(cfg.colors, jnp.float32)
    palette = jax.lax.dynamic_update_slice(palette, colors, (0, 0))
    palette = palette.at[BORDER_COLOR_ID].set(jnp.array([0.6, 0.6, 0.6]))
    palette = palette.at[BACKGROUND_ID].set(jnp.array([0.02, 0.02, 0.03]))
    img = palette[ids]
    return (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)


def _render_frame_dilate(positions, species, cfg: SimConfig, cam: Camera,
                         width: int, height: int, footprint: int,
                         draw_border: bool, border_samples: int):
    """Fast path body (see the fast-path notes above render_frame)."""
    vm = view_matrix(cam)
    pm = projection_matrix(cam, width / height)
    fov = jnp.deg2rad(jnp.asarray(cam.fov_deg, jnp.float32))
    focal_px = (height * 0.5) / jnp.tan(fov / 2.0)

    buf = jnp.full((width * height + 1,), jnp.int32(0x7FFFFFFF))

    if draw_border:
        bp = _box_edge_points(jnp.asarray(cfg.world_size, jnp.float32),
                              border_samples)
        xy, d01, front, vz = _project(bp, vm, pm)
        buf = _seed_points(buf, xy, vz, jnp.full((bp.shape[0],), 1.0),
                           jnp.full((bp.shape[0],), BORDER_COLOR_ID),
                           front, width, height)

    xy, d01, front, vz = _project(positions, vm, pm)
    r_px = (SPRITE_WORLD_SIZE * 0.5) * focal_px / jnp.maximum(vz, 1e-6)
    r_px = jnp.clip(r_px, 0.75, footprint / 2.0)
    buf = _seed_points(buf, xy, vz, r_px, species, front, width, height)

    seeds = buf[:-1].reshape(height, width)
    return _decode(_dilate(seeds, height, width, footprint), cfg)

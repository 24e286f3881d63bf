"""Render the demo GIFs (docs/demo.gif, docs/demo_262k.gif) on device.

The 262k clip runs the exact production path (incremental dense cell layout)
with an orbiting camera and the fast dilation renderer.

    python examples/render_demo.py [--out docs/demo_262k.gif] [--frames 80]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="particle_life_large")
    p.add_argument("--out", default="docs/demo_262k.gif")
    p.add_argument("--frames", type=int, default=80)
    p.add_argument("--steps-per-frame", type=int, default=4)
    p.add_argument("--warm-steps", type=int, default=240,
                   help="settle the scene before filming")
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=360)
    a = p.parse_args()

    import numpy as np
    import jax
    import jax.numpy as jnp

    from particle3d.models import make_scene
    from particle3d.engine.step import simulate, simulate_dense, warmup
    from particle3d.render.camera import default_camera
    from particle3d.render.splat import render_frame
    from particle3d.app.headless import save_gif

    st, cfg, dt = make_scene(a.preset)
    st = warmup(st, cfg)
    dt = jnp.float32(dt)
    dense = (cfg.neighbor == "celllist_pallas" and cfg.cell_grid is not None)

    if dense:  # persist the layout across frames (build the sort once)
        from particle3d.engine.step import simulate_dense_carry
        from particle3d.ops.celllist_dense import (
            build_dense, scatter_back, default_mover_capacity)

        nsc, cap = cfg.cell_grid, cfg.cell_capacity
        mcap = default_mover_capacity(st.positions.shape[0])
        ds = [build_dense(st, cfg, nsc, cap)]

        def advance(s, k):
            ds[0], _ = simulate_dense_carry(ds[0], cfg, dt, k, nsc, cap, mcap)
            return scatter_back(ds[0], s)
    else:
        def advance(s, k):
            return simulate(s, cfg, dt, k)

    t0 = time.perf_counter()
    if a.warm_steps:
        st = advance(st, a.warm_steps)
        jax.block_until_ready(st.positions)
        print(f"warmed {a.warm_steps} steps in {time.perf_counter()-t0:.1f}s")

    w = float(np.asarray(cfg.world_size))
    cam0 = default_camera(w)
    frames = []
    t0 = time.perf_counter()
    for i in range(a.frames):
        ang = 2 * np.pi * i / a.frames
        r = w * 1.0
        # look at the origin: forward = (sin(yaw)cos(p), sin(p), -cos(yaw)cos(p))
        cam = cam0.replace(
            position=jnp.asarray(
                [r * np.sin(ang), 0.25 * w, r * np.cos(ang)], jnp.float32),
            yaw=jnp.float32(-np.degrees(ang)),
            pitch=jnp.float32(-10.0),
        )
        st = advance(st, a.steps_per_frame)
        img = render_frame(st.positions, st.species, cfg, cam,
                           a.width, a.height)
        frames.append(np.asarray(img))
    frames = np.stack(frames)
    print(f"{a.frames} frames x {a.steps_per_frame} steps in "
          f"{time.perf_counter()-t0:.1f}s")
    save_gif(frames, a.out, fps=20)
    print(f"wrote {a.out}")


if __name__ == "__main__":
    main()

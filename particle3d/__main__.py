"""Command-line interface.

    python -m particle3d run    --preset reference --steps 600 --gif out.gif
    python -m particle3d serve  --preset reference --port 8000
    python -m particle3d bench  [--preset particle_life_large]
    python -m particle3d presets
    python -m particle3d resume --checkpoint ck.npz --steps 100

The reference has no CLI at all (configuration lives in a struct literal,
src/bin/main.rs:123-148); this is the batch/production front end next to the
interactive server.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _simulate_best(state, cfg, dt, steps):
    """simulate(), routed through the fast exact dense-layout path for the
    cell-list backend — with capacity escalation, so clustering scenes
    (whose cells outgrow any initial capacity) stay exact over long runs."""
    if (cfg.neighbor == "celllist_pallas" and cfg.cell_grid is not None
            and cfg.cell_capacity is not None):
        from .engine.step import simulate_dense_adaptive

        out, cap, _ = simulate_dense_adaptive(
            state, cfg, dt, steps,
            verbose=lambda m: print(m, file=sys.stderr))
        return out
    from .engine.step import simulate

    return simulate(state, cfg, dt, steps)


def _cmd_run(a):
    import os

    import jax

    from .models import make_scene
    from .engine.step import simulate, warmup
    from .app.headless import render_trajectory, save_gif
    from .utils.checkpoint import save_checkpoint, load_checkpoint
    from .utils.metrics import measure_metrics

    state, cfg, dt = make_scene(a.preset, jax.random.PRNGKey(a.seed), n=a.n)
    if a.dt:
        dt = a.dt
    start_step = 0
    if a.checkpoint and a.checkpoint_every and os.path.exists(a.checkpoint):
        # elastic restart: resume from the last periodic snapshot
        state, cfg, start_step, _ = load_checkpoint(a.checkpoint)
        print(f"resuming from {a.checkpoint} at step {start_step}")
    t0 = time.perf_counter()
    if a.record:
        from .engine.step import trajectory
        from .utils.trajio import TrajectoryWriter
        from .utils.checkpoint import _config_to_jsonable

        state = warmup(state, cfg)
        meta = {"config": _config_to_jsonable(cfg), "dt": float(dt),
                "snapshot_every": a.snapshot_every}
        total = a.steps  # remainder windows emit a final partial snapshot
        chunk = a.snapshot_every * 64  # bound device memory for snapshots
        with TrajectoryWriter(a.record, state.n, state.species, meta) as tw:
            done = 0
            while done < total:
                k = min(chunk, total - done)
                state, snaps = trajectory(state, cfg, dt, k,
                                          snapshot_every=a.snapshot_every)
                tw.append_batch(snaps)
                done += k
            n_frames = tw.frames
        print(f"recorded {n_frames} frames to {a.record}")
    elif a.gif:
        state, frames = render_trajectory(
            state, cfg, dt, a.steps, snapshot_every=a.snapshot_every,
            width=a.width, height=a.height)
        save_gif(frames, a.gif, fps=a.fps)
        print(f"wrote {a.gif} ({frames.shape[0]} frames)")
    elif a.checkpoint and a.checkpoint_every:
        # periodic snapshots: crash anywhere, rerun the same command to
        # resume from the newest snapshot
        state = warmup(state, cfg)
        done = start_step
        while done < a.steps:
            chunk = min(a.checkpoint_every, a.steps - done)
            state = _simulate_best(state, cfg, dt, chunk)
            jax.block_until_ready(state.positions)
            done += chunk
            save_checkpoint(a.checkpoint, state, cfg, done)
    else:
        state = warmup(state, cfg)
        state = _simulate_best(state, cfg, dt, a.steps)
        jax.block_until_ready(state.positions)
    el = time.perf_counter() - t0
    m = measure_metrics(state).as_dict()
    print(json.dumps({"preset": a.preset, "n": state.n, "steps": a.steps,
                      "wall_s": round(el, 3),
                      "steps_per_s": round(a.steps / el, 2), **m}))
    if a.checkpoint:
        save_checkpoint(a.checkpoint, state, cfg, a.steps)
        print(f"wrote {a.checkpoint}")


def _cmd_resume(a):
    import jax

    from .engine.step import simulate, warmup
    from .utils.checkpoint import load_checkpoint, save_checkpoint
    from .utils.metrics import measure_metrics

    state, cfg, step0, _ = load_checkpoint(a.checkpoint)
    state = warmup(state, cfg)
    state = _simulate_best(state, cfg, a.dt, a.steps)
    jax.block_until_ready(state.positions)
    print(json.dumps({"resumed_from": step0, "now": step0 + a.steps,
                      **measure_metrics(state).as_dict()}))
    out = a.out or a.checkpoint
    save_checkpoint(out, state, cfg, step0 + a.steps)
    print(f"wrote {out}")


def _cmd_replay(a):
    import numpy as np

    from .utils.trajio import TrajectoryReader
    from .utils.checkpoint import _config_from_jsonable
    from .render.camera import default_camera
    from .render.splat import render_frame
    from .app.headless import save_gif

    tr = TrajectoryReader(a.traj)
    cfg = _config_from_jsonable(tr.meta["config"])
    cam = default_camera(float(np.asarray(cfg.world_size)))
    species = np.asarray(tr.species)
    idxs = range(0, len(tr), a.every)
    frames = [np.asarray(render_frame(tr[i], species, cfg, cam,
                                      a.width, a.height)) for i in idxs]
    save_gif(np.stack(frames), a.gif, fps=a.fps)
    print(f"replayed {len(frames)} of {len(tr)} frames -> {a.gif}")


def _cmd_serve(a):
    from .app.server import main as serve_main

    argv = ["--preset", a.preset, "--port", str(a.port), "--host", a.host]
    if a.n:
        argv += ["--n", str(a.n)]
    serve_main(argv)


def _cmd_bench(a):
    import runpy
    import os

    sys.argv = ["bench.py"]
    runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench.py"), run_name="__main__")


def _cmd_presets(a):
    from .models import list_presets

    for p in list_presets():
        print(p)


def _cmd_tune(a):
    import jax
    import jax.numpy as jnp

    from .models import make_scene
    from .utils.tune import tune

    state, cfg, dt = make_scene(a.preset, jax.random.PRNGKey(a.seed), n=a.n)
    results = tune(state, cfg, jnp.float32(dt), steps=a.steps)
    best = results[0]
    print(json.dumps({
        "preset": a.preset, "n": state.n,
        "best": best.as_dict(),
        "results": [r.as_dict() for r in results],
    }))


def main(argv=None):
    from .utils.cache import configure_compile_cache

    configure_compile_cache()
    p = argparse.ArgumentParser(prog="particle3d", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run a trajectory headlessly")
    r.add_argument("--preset", default="reference")
    r.add_argument("--n", type=int, default=None)
    r.add_argument("--steps", type=int, default=600)
    r.add_argument("--dt", type=float, default=None)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--gif", default=None)
    r.add_argument("--snapshot-every", type=int, default=4)
    r.add_argument("--fps", type=int, default=20)
    r.add_argument("--width", type=int, default=480)
    r.add_argument("--height", type=int, default=360)
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--checkpoint-every", type=int, default=None,
                   help="write the checkpoint every N steps and auto-resume "
                        "from it if it exists (snapshot-based restart)")
    r.add_argument("--record", default=None,
                   help="stream position frames (every --snapshot-every "
                        "steps) to this .p3t trajectory file")
    r.set_defaults(fn=_cmd_run)

    rp = sub.add_parser("replay", help="render a recorded trajectory to GIF")
    rp.add_argument("--traj", required=True)
    rp.add_argument("--gif", required=True)
    rp.add_argument("--every", type=int, default=1)
    rp.add_argument("--fps", type=int, default=20)
    rp.add_argument("--width", type=int, default=480)
    rp.add_argument("--height", type=int, default=360)
    rp.set_defaults(fn=_cmd_replay)

    s = sub.add_parser("serve", help="interactive browser UI")
    s.add_argument("--preset", default="reference")
    s.add_argument("--n", type=int, default=None)
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--host", default="127.0.0.1")
    s.set_defaults(fn=_cmd_serve)

    b = sub.add_parser("bench", help="run the benchmark harness")
    b.set_defaults(fn=_cmd_bench)

    c = sub.add_parser("resume", help="resume from a checkpoint")
    c.add_argument("--checkpoint", required=True)
    c.add_argument("--steps", type=int, default=100)
    c.add_argument("--dt", type=float, default=1.0 / 60.0)
    c.add_argument("--out", default=None)
    c.set_defaults(fn=_cmd_resume)

    ls = sub.add_parser("presets", help="list scene presets")
    ls.set_defaults(fn=_cmd_presets)

    t = sub.add_parser(
        "tune", help="autotune cell geometry on the live backend")
    t.add_argument("--preset", default="particle_life_large")
    t.add_argument("--n", type=int, default=None)
    t.add_argument("--steps", type=int, default=8,
                   help="steps per timing window")
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=_cmd_tune)

    a = p.parse_args(argv)
    a.fn(a)


if __name__ == "__main__":
    main()

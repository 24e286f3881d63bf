"""Capture a jax.profiler trace of the production step (SURVEY §5 tracing).

Writes a TensorBoard-loadable trace of K production steps (incremental
dense cell layout at the 262k preset by default) plus the window's
wall-clock time.

    python examples/profile_step.py --trace-dir chiprun_out/trace
    tensorboard --logdir chiprun_out/trace   # -> Profile tab
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="particle_life_large")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--trace-dir", default="chiprun_out/trace")
    a = p.parse_args()

    import jax
    import jax.numpy as jnp

    from particle3d.models import make_scene
    from particle3d.engine.step import simulate_dense

    st, cfg, dt = make_scene(a.preset)
    dt = jnp.float32(dt)

    # warm (compile outside the trace)
    out, _ = simulate_dense(st, cfg, dt, a.steps)
    jax.block_until_ready(out.positions)

    with jax.profiler.trace(a.trace_dir):
        out, diag = simulate_dense(st, cfg, dt, a.steps)
        jax.block_until_ready(out.positions)
    print(f"trace written to {a.trace_dir}")

    t0 = time.perf_counter()
    out, _ = simulate_dense(st, cfg, dt, a.steps)
    jax.block_until_ready(out.positions)
    sec = time.perf_counter() - t0
    print(f"{a.steps} steps in {sec*1e3:.1f} ms = "
          f"{sec/a.steps*1e3:.1f} ms/step ({a.steps/sec:.1f} steps/s)")


if __name__ == "__main__":
    main()

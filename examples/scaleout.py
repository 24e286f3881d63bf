"""Scale-out entry points for the BASELINE configs 4/5 workloads.

Three launchable recipes (the reference has no distributed story at all —
its ceiling is rayon threads on one CPU, SURVEY.md §2):

  ring2m       BASELINE config 4: gravitational N-body, N=2M, particle-
               sharded ring all-pairs (`sharded_simulate`).
  ring2level   The multi-host variant: 2-level (hosts x devices)
               hierarchical ring (`sharded_simulate_2level` +
               `initialize_distributed`).
  slab16m      BASELINE config 5 direction: particle-life at large N on the
               state-sharded slab cell list (`sharded_dense_simulate`,
               O(N/D) state per chip).

Without multi-chip hardware, run on a virtual CPU mesh (the same code path
the driver's multichip dryrun compiles):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/scaleout.py ring2m --n 4096 --steps 3
    ... slab16m --n 32768 --steps 3

On real GPUs, omit the env forcing, run one process per host, and pass
--full (or an explicit --n). Multi-host processes must call
`initialize_distributed()` first (done below).
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=["ring2m", "ring2level", "slab16m"])
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--full", action="store_true",
                   help="use the full BASELINE N (2M / 16M)")
    p.add_argument("--checkpoint", default=None, metavar="DIR",
                   help="slab mode: save the stay-sharded carry to DIR "
                        "after the run (sharded Orbax save — each host "
                        "writes only its slab rows) and, if DIR already "
                        "holds one, RESUME from it instead of init")
    a = p.parse_args()

    import jax
    import jax.numpy as jnp

    from particle3d import SimConfig, init_scene
    from particle3d.parallel import (
        initialize_distributed, make_mesh, auto_mesh_2d, shard_state,
        shard_state_2level, sharded_simulate, sharded_simulate_2level,
        sharded_dense_simulate)

    multi = initialize_distributed()
    d = jax.device_count()
    print(f"devices={d} processes={jax.process_count()} multi_host={multi}")

    if a.mode in ("ring2m", "ring2level"):
        n = a.n or (2_097_152 if a.full else 128 * d)
        n -= n % d
        cfg = SimConfig(force_law="gravity", particle_effect_radius=20.0,
                        world_size=40.0, gravity_softening=0.05,
                        integrator="leapfrog",
                        neighbor="allpairs_pallas").validate()
        state = init_scene(jax.random.PRNGKey(0), n, cfg)
        dt = jnp.float32(1e-3)
        if a.mode == "ring2m":
            mesh = make_mesh(d)
            state = shard_state(state, mesh)
            t0 = time.perf_counter()
            out = sharded_simulate(state, cfg, dt, a.steps, mesh)
            jax.block_until_ready(out.positions)
        else:
            mesh = auto_mesh_2d()
            state = shard_state_2level(state, mesh)
            t0 = time.perf_counter()
            out = sharded_simulate_2level(state, cfg, dt, a.steps, mesh)
            jax.block_until_ready(out.positions)
        sec = time.perf_counter() - t0
        print(f"{a.mode}: N={n} {a.steps} steps in {sec:.2f}s = "
              f"{a.steps/sec:.2f} steps/s "
              f"({float(n)*n*a.steps/sec:.3e} pair-interactions/s)")
    else:  # slab16m — fully stay-sharded: init -> steps, no replicated stage
        from particle3d.parallel import (
            init_sharded_dense, sharded_dense_steps)

        nsc = 64 if (a.full or (a.n or 0) > 1_000_000) else 8
        while nsc % d:
            nsc += d
        n = a.n or (16_777_216 if a.full else 4096)
        n -= n % d
        cap = max(4, int(2.5 * n / nsc ** 3) + 1)
        cfg = SimConfig(world_size=float(nsc),  # cell width 1.0 = cutoff
                        neighbor="celllist_pallas", cell_grid=nsc,
                        cell_capacity=cap).validate()
        mesh = make_mesh(d)
        step0 = 0
        ck = None
        if a.checkpoint:
            from particle3d.utils import OrbaxCheckpointer

            ck = OrbaxCheckpointer(a.checkpoint)
            if ck.steps():
                carry, cfg, slab, step0 = ck.restore_carry(mesh)
                nsc, cap, n = slab["nsc"], slab["cap"], slab["n"]
                print(f"resumed sharded carry at step {step0} "
                      f"(nsc={nsc} cap={cap} N={n})")
        if step0 == 0:
            carry = init_sharded_dense(jax.random.PRNGKey(0), n, cfg, mesh,
                                       nsc=nsc, cap=cap)
        jax.block_until_ready(carry[0])
        t0 = time.perf_counter()
        carry, (mov, mask, limbo, lost, shipped) = sharded_dense_steps(
            carry, cfg, jnp.float32(1 / 60), a.steps, mesh, nsc=nsc, cap=cap,
            n=n)
        jax.block_until_ready(carry[0])
        sec = time.perf_counter() - t0
        print(f"slab (stay-sharded): N={n} nsc={nsc} cap={cap} {a.steps} "
              f"steps in {sec:.2f}s = {a.steps/sec:.2f} steps/s; "
              f"shipped={int(shipped)} masked={int(mask)} lost={int(lost)}")
        if ck is not None:
            ck.save_carry(step0 + a.steps, carry, cfg, nsc=nsc, cap=cap, n=n)
            ck.close()
            print(f"saved sharded carry at step {step0 + a.steps} "
                  f"-> {a.checkpoint}")


if __name__ == "__main__":
    main()

"""Cross-backend fuzzing: randomized (but deterministic) configs must give
the same trajectories on every neighbor backend and stay finite."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle3d import SimConfig, init_scene, simulate
from particle3d.engine.step import warmup, simulate_dense


_LAWS = ["particle_life", "lennard_jones", "gravity", "spring"]


def _random_cfg(rng, law):
    integ = rng.choice(["euler", "velocity_verlet", "leapfrog"])
    boundary = rng.choice(["wrap", "clamp", "reflect"])
    world = float(rng.uniform(6.0, 24.0))
    radius = float(rng.uniform(0.5, world / 2.0))
    k = int(rng.integers(1, 6))
    kw = dict(
        force_law=law,
        integrator=integ,
        boundary=boundary,
        wrap_forces=bool(rng.integers(0, 2)) if boundary != "wrap" else True,
        world_size=world,
        particle_effect_radius=radius,
        id_count=k,
        attraction_matrix=rng.uniform(-1, 1, (k, k)).astype(np.float32),
        coefficient=float(rng.uniform(0.0, 1.0)),
        interaction_force=float(rng.uniform(0.0, 3.0)),
        min_pull_ratio=float(rng.uniform(0.05, 0.9)),
        acceleration=rng.uniform(-1, 1, 3).astype(np.float32),
        restitution=float(rng.uniform(0.2, 1.0)),
    )
    if law == "lennard_jones":
        kw.update(lj_epsilon=float(rng.uniform(0.1, 2.0)),
                  lj_sigma=float(rng.uniform(0.05, 0.3)),
                  interaction_force=float(rng.uniform(0.0, 0.3)))
    if law == "gravity":
        kw.update(gravity_constant=float(rng.uniform(0.1, 2.0)),
                  gravity_softening=float(rng.uniform(0.02, 0.3)))
    if law == "spring":
        kw.update(spring_stiffness=float(rng.uniform(0.1, 2.0)),
                  spring_rest_length=float(rng.uniform(0.1, radius)))
    return SimConfig(**kw).validate()


@pytest.mark.parametrize("case", range(8))
def test_backends_agree_on_random_config(case):
    rng = np.random.default_rng(1000 + case)
    cfg = _random_cfg(rng, _LAWS[case % 4])  # every law fuzzed twice
    n = int(rng.integers(48, 200))
    st = warmup(init_scene(jax.random.PRNGKey(case), n, cfg), cfg)
    dt = jnp.float32(1.0 / float(rng.uniform(30.0, 120.0)))
    steps = 4

    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, steps)
    ref_pos = np.asarray(ref.positions)
    assert np.isfinite(ref_pos).all(), f"dense backend not finite: {cfg}"
    scale = max(1.0, np.abs(ref_pos).max())

    out = simulate(st, cfg.replace(neighbor="allpairs_pallas"), dt, steps)
    np.testing.assert_allclose(np.asarray(out.positions) / scale,
                               ref_pos / scale, atol=5e-4,
                               err_msg=f"pallas vs dense: {cfg}")

    # the all-pairs kernel itself (Pallas interpreter) on the same config
    from particle3d.ops import forces as F
    from particle3d.ops.allpairs import allpairs_forces
    from particle3d.ops.pallas_allpairs import pallas_allpairs_forces

    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_allpairs_forces(st.positions, u, v, cfg,
                                            interpret=True))
    fscale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got / fscale, want / fscale, atol=5e-4,
                               err_msg=f"kernel vs dense forces: {cfg}")

    # cell geometry valid for the law's effective cutoff (the cell backends
    # need static geometry inside jit when the config is traced)
    w = float(np.asarray(cfg.world_size))
    r = float(np.asarray(cfg.particle_effect_radius))
    cutoff = min(r, 1.0) if cfg.force_law == "particle_life" else r
    nsc = max(3, int(w / max(cutoff, 1e-3)))
    nsc = min(nsc, 12)
    cap_xla = max(8, 4 * n // nsc ** 2)
    out = simulate(st, cfg.replace(neighbor="celllist", cell_grid=nsc,
                                   cell_capacity=cap_xla), dt, steps)
    np.testing.assert_allclose(np.asarray(out.positions) / scale,
                               ref_pos / scale, atol=5e-4,
                               err_msg=f"celllist vs dense: {cfg}")

    if w / nsc >= cutoff:
        cfgc = cfg.replace(neighbor="celllist_pallas", cell_grid=nsc,
                           cell_capacity=max(8, 4 * n // nsc ** 2))
        out = simulate(st, cfgc, dt, steps)
        np.testing.assert_allclose(np.asarray(out.positions) / scale,
                                   ref_pos / scale, atol=5e-4,
                                   err_msg=f"cell kernel vs dense: {cfgc}")
        if cfg.wrap_forces:
            out2, _ = simulate_dense(st, cfgc, dt, steps)
            np.testing.assert_allclose(np.asarray(out2.positions) / scale,
                                       ref_pos / scale, atol=5e-4,
                                       err_msg=f"dense layout vs dense: {cfgc}")

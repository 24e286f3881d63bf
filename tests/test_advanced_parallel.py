"""2-level (hosts x devices) hierarchical ring + differentiable simulation."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from particle3d import reference_config, init_scene, simulate, step
from particle3d.ops import forces as F
from particle3d.ops.allpairs import allpairs_forces
from particle3d.parallel import make_mesh_2d, ring_forces_2level


@pytest.mark.parametrize("dcn,ici", [(2, 4), (4, 2)])
def test_2level_ring_matches_dense(dcn, ici):
    cfg = reference_config()
    st = init_scene(jax.random.PRNGKey(0), 256, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))

    mesh = make_mesh_2d(dcn, ici)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(("dcn", "shard")), P(("dcn", "shard")), P(("dcn", "shard"))),
        out_specs=P(("dcn", "shard")))
    def run(pos, uu, vv):
        return ring_forces_2level(pos, uu, vv, cfg)

    got = np.asarray(run(st.positions, u, v))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_gradient_through_trajectory():
    """Differentiable simulation: d(final KE)/d(initial positions) exists and
    is finite — enabled by the pure-functional step (impossible in the
    reference's mutable-state architecture)."""
    # dense box so pairs are inside the effective cutoff and forces flow
    cfg = reference_config(world_size=4.0)
    st = init_scene(jax.random.PRNGKey(1), 32, cfg)

    def loss(pos0):
        s = st.replace(positions=pos0)
        out = simulate(s, cfg, 1.0 / 60.0, 5)
        return 0.5 * jnp.sum(out.velocities ** 2)

    g = jax.grad(loss)(st.positions)
    assert g.shape == (32, 3)
    gn = np.asarray(g)
    assert np.all(np.isfinite(gn))
    assert np.abs(gn).max() > 0  # forces depend on positions


def test_gradient_matches_finite_differences():
    cfg = reference_config(world_size=4.0).replace(coefficient=0.0)
    st = init_scene(jax.random.PRNGKey(2), 12, cfg)

    def loss(pos0):
        s = st.replace(positions=pos0.astype(jnp.float32))
        out = simulate(s, cfg, 1.0 / 60.0, 2)
        return 0.5 * jnp.sum(out.velocities ** 2)

    g = np.asarray(jax.grad(loss)(st.positions))
    eps = 1e-3
    p0 = np.asarray(st.positions)
    for idx in [(0, 0), (5, 1), (11, 2)]:
        dp = p0.copy()
        dp[idx] += eps
        dm = p0.copy()
        dm[idx] -= eps
        fd = (float(loss(jnp.asarray(dp))) - float(loss(jnp.asarray(dm)))) / (2 * eps)
        assert g[idx] == pytest.approx(fd, rel=0.05, abs=1e-4)


def test_sharded_cell_simulate_matches_single_device():
    """Column-slab sharded cell forces == single-device cadenced run."""
    from particle3d.models import make_scene
    from particle3d.engine.step import simulate_cadenced, warmup
    from particle3d.parallel.domain import sharded_cell_simulate
    from particle3d.parallel import make_mesh

    st, cfg, dt = make_scene("lj_gas", n=512)
    cfgp = cfg.replace(neighbor="celllist_pallas", cell_grid=8,
                       cell_capacity=48)
    st = warmup(st, cfgp)
    want, _, _ = simulate_cadenced(st, cfgp, dt, 8, rebuild_every=4)

    mesh = make_mesh(4)
    got, drift = sharded_cell_simulate(st, cfgp, dt, 8, mesh,
                                       rebuild_every=4, nsc=8, cap=48)
    np.testing.assert_allclose(
        np.asarray(got.positions), np.asarray(want.positions),
        rtol=1e-5, atol=1e-6)

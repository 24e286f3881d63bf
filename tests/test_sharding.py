"""Ring-sharded path vs single-device reference, on a virtual 8-CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from particle3d import reference_config, init_scene, step, simulate
from particle3d.parallel import (
    make_mesh, shard_state, sharded_step, sharded_simulate, ring_forces,
)
from particle3d.ops import forces as F
from particle3d.ops.allpairs import allpairs_forces


def test_virtual_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_ring_forces_match_dense(ndev):
    cfg = reference_config()
    st = init_scene(jax.random.PRNGKey(0), 256, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))

    mesh = make_mesh(ndev)
    from jax.sharding import PartitionSpec as P
    import functools

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("shard"), P("shard"), P("shard")),
                       out_specs=P("shard"))
    def run(pos, uu, vv):
        return ring_forces(pos, uu, vv, cfg)

    got = np.asarray(run(st.positions, u, v))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_sharded_step_matches_single_device():
    cfg = reference_config()
    st = init_scene(jax.random.PRNGKey(1), 512, cfg)
    want = step(st, cfg, 1.0 / 60.0)

    mesh = make_mesh(8)
    st_sh = shard_state(st, mesh)
    got = sharded_step(st_sh, cfg, 1.0 / 60.0, mesh)
    np.testing.assert_allclose(
        np.asarray(got.positions), np.asarray(want.positions), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(
        np.asarray(got.velocities), np.asarray(want.velocities), rtol=2e-4, atol=2e-5)


def test_sharded_simulate_trajectory_matches():
    cfg = reference_config()
    st = init_scene(jax.random.PRNGKey(2), 256, cfg)
    want = simulate(st, cfg, 1.0 / 60.0, 10)

    mesh = make_mesh(4)
    st_sh = shard_state(st, mesh)
    got = sharded_simulate(st_sh, cfg, 1.0 / 60.0, 10, mesh)
    np.testing.assert_allclose(
        np.asarray(got.positions), np.asarray(want.positions), rtol=5e-4, atol=5e-4)


def test_sharded_simulate_walls_boundary():
    cfg = reference_config().replace(boundary="clamp")
    st = init_scene(jax.random.PRNGKey(3), 128, cfg)
    mesh = make_mesh(8)
    st_sh = shard_state(st, mesh)
    out = sharded_simulate(st_sh, cfg, 1.0 / 60.0, 20, mesh)
    assert np.all(np.abs(np.asarray(out.positions)) <= 5.0 + 1e-5)
    want = simulate(st, cfg, 1.0 / 60.0, 20)
    np.testing.assert_allclose(
        np.asarray(out.positions), np.asarray(want.positions), rtol=5e-4, atol=5e-4)


def test_indivisible_n_raises():
    cfg = reference_config()
    st = init_scene(jax.random.PRNGKey(4), 100, cfg)
    mesh = make_mesh(8)
    with pytest.raises(ValueError):
        sharded_step(st, cfg, 1.0 / 60.0, mesh)


def test_ring_forces_with_pallas_block_kernel():
    """Ring-sharded sweep using the Pallas all-pairs kernel for the local
    block pair math (the production multi-chip configuration)."""
    cfg = reference_config().replace(neighbor="allpairs_pallas")
    st = init_scene(jax.random.PRNGKey(5), 128, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))

    mesh = make_mesh(2)
    from jax.sharding import PartitionSpec as P
    import functools

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("shard"), P("shard"), P("shard")),
                       out_specs=P("shard"), check_vma=False)
    def run(pos, uu, vv):
        return ring_forces(pos, uu, vv, cfg)

    got = np.asarray(run(st.positions, u, v))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)

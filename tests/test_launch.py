"""Multi-host launch glue (parallel/launch.py): shape logic, auto meshes,
and the 2-level sharded trajectory on a virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle3d import reference_config, init_scene, simulate
from particle3d.parallel import (
    mesh_shape_2level, auto_mesh_2d, cluster_env_configured,
    initialize_distributed, shard_state_2level, sharded_simulate_2level,
)


def test_mesh_shape_logic():
    assert mesh_shape_2level(8, 2) == (2, 4)
    assert mesh_shape_2level(8, 1) == (1, 8)
    assert mesh_shape_2level(256, 64) == (64, 4)
    with pytest.raises(ValueError, match="evenly"):
        mesh_shape_2level(8, 3)
    with pytest.raises(ValueError, match="topology"):
        mesh_shape_2level(0, 1)


def test_auto_mesh_single_process():
    mesh = auto_mesh_2d()  # 8-device virtual CPU backend, 1 process
    assert mesh.shape["dcn"] == 1
    assert mesh.shape["shard"] == 8
    mesh2 = auto_mesh_2d(dcn=2)
    assert (mesh2.shape["dcn"], mesh2.shape["shard"]) == (2, 4)
    mesh3 = auto_mesh_2d(ici=2)
    assert (mesh3.shape["dcn"], mesh3.shape["shard"]) == (4, 2)


def test_cluster_env_detection():
    assert not cluster_env_configured({})
    assert cluster_env_configured({"JAX_COORDINATOR_ADDRESS": "host:1234"})
    assert cluster_env_configured({"SLURM_JOB_ID": "17"})
    assert not cluster_env_configured({"SLURM_JOB_ID": ""})


def test_initialize_distributed_single_process_noop():
    # no coordinator, no cluster env: must not raise, reports single-process
    assert initialize_distributed() is False


@pytest.mark.parametrize("dcn,ici", [(2, 4), (4, 2)])
def test_sharded_simulate_2level_matches_dense(dcn, ici):
    cfg = reference_config()
    st = init_scene(jax.random.PRNGKey(0), 128, cfg)
    dt = jnp.float32(1 / 60)
    want = simulate(st, cfg, dt, 6)
    mesh = auto_mesh_2d(dcn=dcn, ici=ici)
    sharded = shard_state_2level(st, mesh)
    got = sharded_simulate_2level(sharded, cfg, dt, 6, mesh)
    np.testing.assert_allclose(np.asarray(got.positions),
                               np.asarray(want.positions),
                               rtol=2e-4, atol=2e-5)


def test_sharded_simulate_2level_rejects_indivisible():
    mesh = auto_mesh_2d(dcn=2, ici=4)
    cfg = reference_config()
    st = init_scene(jax.random.PRNGKey(1), 100, cfg)  # 100 % 8 != 0
    with pytest.raises(ValueError, match="divide"):
        sharded_simulate_2level(st, cfg, jnp.float32(0.01), 2, mesh)

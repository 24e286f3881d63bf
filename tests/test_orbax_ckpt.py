"""Orbax checkpoint backend (utils/orbax_ckpt.py): round trip, async save,
step listing, sharded restore."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytest.importorskip("orbax.checkpoint")

from particle3d import reference_config, init_scene, simulate
from particle3d.utils.orbax_ckpt import OrbaxCheckpointer


def _scene(n=128):
    cfg = reference_config()
    return init_scene(jax.random.PRNGKey(0), n, cfg), cfg


def test_round_trip(tmp_path):
    st, cfg = _scene()
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    ck.save(30, st, cfg, extra={"note": "x"})
    out, cfg2, step = ck.restore()
    assert step == 30
    np.testing.assert_array_equal(np.asarray(out.positions),
                                  np.asarray(st.positions))
    np.testing.assert_array_equal(np.asarray(out.species),
                                  np.asarray(st.species))
    assert float(np.asarray(cfg2.world_size)) == float(np.asarray(cfg.world_size))
    np.testing.assert_array_equal(np.asarray(cfg2.attraction_matrix),
                                  np.asarray(cfg.attraction_matrix))
    ck.close()


def test_resume_continues_trajectory(tmp_path):
    st, cfg = _scene()
    dt = jnp.float32(1 / 60)
    mid = simulate(st, cfg, dt, 5)
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    ck.save(5, mid, cfg)
    got, cfg2, _ = ck.restore(5)
    end_a = simulate(mid, cfg, dt, 5)
    end_b = simulate(got, cfg2.replace(neighbor=cfg.neighbor), dt, 5)
    np.testing.assert_array_equal(np.asarray(end_a.positions),
                                  np.asarray(end_b.positions))
    ck.close()


def test_async_save_and_steps(tmp_path):
    st, cfg = _scene()
    ck = OrbaxCheckpointer(str(tmp_path / "ck"), async_save=True)
    ck.save(10, st, cfg)
    ck.save(20, st, cfg)
    ck.wait()
    assert ck.steps() == [10, 20]
    _, _, step = ck.restore()
    assert step == 20
    ck.close()


def test_sharded_restore(tmp_path):
    from particle3d.parallel import make_mesh, particle_sharding

    st, cfg = _scene(n=128)
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    ck.save(0, st, cfg)
    mesh = make_mesh(8)
    sh = particle_sharding(mesh)
    out, _, _ = ck.restore(0, sharding=sh)
    assert out.positions.sharding.is_equivalent_to(sh, out.positions.ndim)
    np.testing.assert_array_equal(np.asarray(out.positions),
                                  np.asarray(st.positions))
    ck.close()


def test_mixed_kind_latest_restore(tmp_path):
    """A directory holding BOTH state snapshots and slab carries: latest-
    restore must filter by kind — a newer checkpoint of the other kind must
    not shadow the one being asked for (regression: restore(step=None)
    picked steps()[-1] regardless of kind and raised)."""
    st, cfg = _scene()
    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    fake_carry = (jnp.zeros((8, 4)), jnp.full((8,), -1, jnp.int32),
                  jnp.zeros((2, 4)), jnp.full((2,), -1, jnp.int32),
                  jnp.int32(0))
    ck.save(10, st, cfg)
    ck.save_carry(20, fake_carry, cfg, nsc=4, cap=2, n=8)
    _, _, step = ck.restore()          # newest overall is the carry (20)
    assert step == 10
    _, _, _, step = ck.restore_carry()
    assert step == 20
    ck.save(30, st, cfg)               # now newest overall is a snapshot
    _, _, _, step = ck.restore_carry()
    assert step == 20
    ck.close()

    ck2 = OrbaxCheckpointer(str(tmp_path / "only_state"))
    ck2.save(1, st, cfg)
    with pytest.raises(FileNotFoundError, match="slab carr"):
        ck2.restore_carry()
    ck2.close()


def test_slab_carry_checkpoint_resume(tmp_path):
    """Stay-sharded slab carry: save mid-run with shardings, restore
    SHARDED onto a fresh mesh (no replicated stage), continue — must match
    the uninterrupted run bit-for-bit, and the restored arrays must carry
    the slab sharding."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from particle3d.parallel import make_mesh
    from particle3d.parallel.domain_sharded import (
        init_sharded_dense, sharded_dense_steps, gather_sharded_dense)

    cfg = reference_config(world_size=16.0).replace(
        neighbor="celllist_pallas", cell_grid=8, cell_capacity=32)
    dt = jnp.float32(1 / 30)
    n, nsc, cap = 512, 8, 32
    mesh = make_mesh(8)
    carry = init_sharded_dense(jax.random.PRNGKey(3), n, cfg, mesh,
                               nsc=nsc, cap=cap)
    carry, _ = sharded_dense_steps(carry, cfg, dt, 4, mesh, nsc=nsc,
                                   cap=cap, n=n)

    ck = OrbaxCheckpointer(str(tmp_path / "ck"))
    ck.save_carry(4, carry, cfg, nsc=nsc, cap=cap, n=n)

    # the state-restore API must refuse a carry checkpoint and vice versa
    with pytest.raises(ValueError, match="slab carry"):
        ck.restore(4)

    mesh2 = make_mesh(8)
    got, cfg2, slab, step = ck.restore_carry(mesh2, 4)
    assert step == 4 and (slab["nsc"], slab["cap"], slab["n"]) == (nsc, cap, n)
    want_sh = NamedSharding(mesh2, P("shard"))
    assert got[0].sharding.is_equivalent_to(want_sh, got[0].ndim)

    # continue both; trajectories must be identical
    end_a, _ = sharded_dense_steps(carry, cfg, dt, 4, mesh, nsc=nsc,
                                   cap=cap, n=n)
    end_b, _ = sharded_dense_steps(got, cfg2, dt, 4, mesh2, nsc=nsc,
                                   cap=cap, n=n)
    base = init_scene(jax.random.PRNGKey(9), n, cfg)  # gather fill values
    out_a = gather_sharded_dense(end_a, base, mesh)
    out_b = gather_sharded_dense(end_b, base, mesh2)
    np.testing.assert_array_equal(np.asarray(out_a.positions),
                                  np.asarray(out_b.positions))
    ck.close()

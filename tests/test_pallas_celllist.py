"""Column-sweep cell-list kernel (Pallas interpreter on the CPU) and its
plain twin vs the dense all-pairs path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from particle3d import SimConfig, reference_config, from_numpy
from particle3d.ops import forces as F
from particle3d.ops.allpairs import allpairs_forces
from particle3d.ops.pallas_celllist import pallas_celllist_forces, prepare_columns


def _scene(seed, n, cfg):
    rng = np.random.default_rng(seed)
    half = float(np.asarray(cfg.world_size)) / 2
    pos = rng.uniform(-half, half, (n, 3)).astype(np.float32)
    species = rng.integers(0, cfg.id_count, n).astype(np.int32)
    return from_numpy(pos, np.zeros((n, 3), np.float32), species)


def test_prepare_columns_is_partition():
    cfg = reference_config().replace(world_size=12.0)
    n = 200
    st = _scene(0, n, cfg)
    u, v = F.pair_features(st, cfg, pad_p=8)
    *_, slots = prepare_columns(st.positions, u, v, cfg, nsc=4, cap=32)
    got = np.asarray(slots).reshape(-1)
    real = got[got >= 0]
    assert sorted(real.tolist()) == list(range(n))


@pytest.mark.parametrize("nsc,n,world", [(4, 200, 12.0), (3, 150, 9.0),
                                         (6, 400, 14.0)])
def test_matches_allpairs_particle_life_wrap(nsc, n, world):
    cfg = reference_config().replace(world_size=world)
    st = _scene(nsc, n, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_celllist_forces(st.positions, u, v, cfg,
                                            nsc=nsc, cap=96,
                                            interpret=True))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_matches_allpairs_no_wrap():
    cfg = reference_config().replace(world_size=12.0, wrap_forces=False)
    st = _scene(7, 250, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_celllist_forces(st.positions, u, v, cfg,
                                            nsc=4, cap=96,
                                            interpret=True))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_matches_allpairs_lj():
    cfg = SimConfig(
        force_law="lennard_jones", lj_epsilon=1.0, lj_sigma=0.3,
        particle_effect_radius=1.5, world_size=9.0,
    ).validate()
    rng = np.random.default_rng(5)
    g = np.stack(np.meshgrid(*[np.linspace(-4, 4, 7)] * 3), -1).reshape(-1, 3)
    pos = (g + rng.normal(0, 0.05, g.shape)).astype(np.float32)
    st = from_numpy(pos, np.zeros_like(pos), np.zeros(len(pos), np.int32))
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_celllist_forces(st.positions, u, v, cfg,
                                            nsc=6, cap=32,
                                            interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_matches_allpairs_gravity():
    cfg = SimConfig(
        force_law="gravity", gravity_constant=1.0, gravity_softening=0.3,
        particle_effect_radius=2.0, world_size=12.0,
    ).validate()
    rng = np.random.default_rng(6)
    n = 180
    g = np.stack(np.meshgrid(*[np.linspace(-5, 5, 6)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    pos = (g[:n] + rng.normal(0, 0.2, (n, 3))).astype(np.float32)
    st = from_numpy(pos, np.zeros_like(pos), np.zeros(n, np.int32),
                    masses=rng.uniform(0.5, 2.0, n).astype(np.float32))
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_celllist_forces(st.positions, u, v, cfg,
                                            nsc=6, cap=32,
                                            interpret=True))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_backend_in_step():
    from particle3d import step

    cfg = reference_config().replace(world_size=12.0)
    cfg_p = cfg.replace(neighbor="celllist_pallas", cell_grid=4,
                        cell_capacity=96)
    st = _scene(9, 256, cfg)
    a = step(st, cfg, 1.0 / 60.0)
    b = step(st, cfg_p, 1.0 / 60.0)
    np.testing.assert_allclose(
        np.asarray(a.positions), np.asarray(b.positions), rtol=3e-4, atol=3e-5)


def test_cadenced_rebuild_matches_per_step():
    """Layout reuse between rebuilds is exact while drift < budget."""
    from particle3d.models import make_scene
    from particle3d.engine.step import simulate, simulate_cadenced, warmup
    from particle3d.ops.pallas_celllist import drift_budget

    st, cfg, dt = make_scene("lj_gas", n=512)
    cfgp = cfg.replace(neighbor="celllist_pallas", cell_grid=8,
                       cell_capacity=48)
    st = warmup(st, cfgp)
    a = simulate(st, cfgp, dt, 8)
    b, drift, dropped = simulate_cadenced(st, cfgp, dt, 8, rebuild_every=4)
    assert float(drift) < float(drift_budget(cfgp, 8))
    assert int(dropped) == 0
    np.testing.assert_allclose(
        np.asarray(a.positions), np.asarray(b.positions), atol=1e-6)


@pytest.mark.parametrize("br", [32, 64, 128])
def test_sub_chunked_kernel_matches_occupied(br):
    """Every receiver block size gives the plain twin's forces on OCCUPIED
    slots (the phantom/empty-slot rows are garbage by design and must be
    masked in any cross-implementation comparison)."""
    from particle3d.ops.pallas_celllist import (
        prepare_columns, _call_kernel, _call_plain)
    from particle3d.ops.pallas_allpairs import pack_params

    nsc, cap = 8, 16
    cfg = reference_config(world_size=16.0).replace(
        neighbor="celllist_pallas", cell_grid=nsc, cell_capacity=cap)
    st = _scene(11, 2048, cfg)
    u, v = F.pair_features(st, cfg, pad_p=8)
    pos_d, u_d, post_g, vt_g, r2_g, sp = prepare_columns(
        st.positions, u, v, cfg, nsc, cap)
    pf = pack_params(cfg)
    occ = np.asarray(sp) >= 0
    # slot-minor [NCOL, 3, CS]; transpose for the occ mask
    ref = np.transpose(np.asarray(_call_plain(
        pos_d, u_d, post_g, vt_g, r2_g, pf, cfg.force_law, True, nsc, cap,
        False, 5)), (0, 2, 1))
    out = np.transpose(np.asarray(_call_kernel(
        pos_d, u_d, post_g, vt_g, r2_g, pf, cfg.force_law, True, nsc, cap,
        False, 5, br, 64, True)), (0, 2, 1))
    scale = max(1e-9, float(np.max(np.abs(ref[occ]))))
    assert float(np.max(np.abs(out[occ] - ref[occ]))) / scale < 1e-5


def test_unrolled_misaligned_cap_matches_allpairs():
    """A capacity that is not a power of two: receiver blocks straddle
    supercells and the tail block of each column is masked."""
    cfg = reference_config().replace(world_size=12.0)
    n = 200
    st = _scene(7, n, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_celllist_forces(st.positions, u, v, cfg,
                                            nsc=4, cap=37, interpret=True))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)

"""All-pairs kernel (Pallas interpreter on the CPU) vs the dense jnp path."""

import numpy as np
import pytest

from particle3d import SimConfig, reference_config, from_numpy
from particle3d.ops import forces as F
from particle3d.ops.allpairs import allpairs_forces
from particle3d.ops.pallas_allpairs import pallas_allpairs_forces


def _scene(seed, n, cfg, with_vel=False, k=5):
    rng = np.random.default_rng(seed)
    half = float(np.asarray(cfg.world_size)) / 2
    pos = rng.uniform(-half, half, (n, 3)).astype(np.float32)
    species = rng.integers(0, k, n).astype(np.int32)
    st = from_numpy(pos, np.zeros_like(pos), species)
    return st


@pytest.mark.parametrize("n", [32, 100, 256, 513])
def test_pallas_matches_dense_particle_life(n):
    cfg = reference_config()
    st = _scene(n, n, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_allpairs_forces(st.positions, u, v, cfg,
                                             interpret=True))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_pallas_matches_dense_no_wrap():
    cfg = reference_config().replace(wrap_forces=False)
    st = _scene(7, 200, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_allpairs_forces(st.positions, u, v, cfg,
                                             interpret=True))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_pallas_matches_dense_gravity():
    cfg = SimConfig(
        force_law="gravity", gravity_constant=1.5, gravity_softening=0.3,
        particle_effect_radius=4.0, world_size=20.0, wrap_forces=True,
    ).validate()
    rng = np.random.default_rng(8)
    n = 150
    # Grid + jitter keeps pair terms bounded so the comparison is
    # well-conditioned in f32 (uniform random placement creates huge
    # near-canceling terms that amplify summation-order noise).
    g = np.stack(np.meshgrid(*[np.linspace(-8, 8, 6)] * 3), -1).reshape(-1, 3)
    pos = (g[:n] + rng.normal(0, 0.2, (n, 3))).astype(np.float32)
    st = from_numpy(pos, np.zeros_like(pos), np.zeros(n, np.int32),
                    masses=rng.uniform(0.5, 2.0, n).astype(np.float32))
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_allpairs_forces(st.positions, u, v, cfg,
                                             interpret=True))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_pallas_matches_dense_lennard_jones():
    cfg = SimConfig(
        force_law="lennard_jones", lj_epsilon=1.0, lj_sigma=0.3,
        particle_effect_radius=1.5, world_size=12.0,
    ).validate()
    rng = np.random.default_rng(9)
    n = 128
    # keep particles separated enough that LJ doesn't blow up numerically
    grid = np.stack(np.meshgrid(*[np.linspace(-5, 5, 6)] * 3), -1).reshape(-1, 3)
    pos = (grid[:n] + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    st = from_numpy(pos, np.zeros_like(pos), np.zeros(n, np.int32))
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_allpairs_forces(st.positions, u, v, cfg,
                                             interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_pallas_multi_jblock_accumulation():
    """Several receiver programs and several inner source blocks."""
    cfg = reference_config()
    n = 600
    st = _scene(13, n, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(
        pallas_allpairs_forces(st.positions, u, v, cfg, bi=64, bj=128,
                               interpret=True)
    )
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_pallas_backend_in_step():
    """End-to-end: step() with neighbor='allpairs_pallas' matches 'allpairs'."""
    from particle3d import step

    cfg = reference_config()
    cfg_p = cfg.replace(neighbor="allpairs_pallas")
    st = _scene(21, 256, cfg)
    dt = 1.0 / 60.0
    a = step(st, cfg, dt)
    b = step(st, cfg_p, dt)
    np.testing.assert_allclose(
        np.asarray(a.positions), np.asarray(b.positions), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [64, 200, 300])
def test_triangular_matches_dense_particle_life(n):
    cfg = reference_config()
    st = _scene(n, n, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_allpairs_forces(st.positions, u, v, cfg, bi=32,
                                             bj=64, interpret=True))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_triangular_matches_dense_gravity_asymmetric():
    """Gravity coef is asymmetric (m_j vs m_i): each receiver must weight
    every source by the SOURCE's mass."""
    cfg = SimConfig(
        force_law="gravity", gravity_constant=1.5, gravity_softening=0.3,
        particle_effect_radius=4.0, world_size=20.0, wrap_forces=True,
    ).validate()
    rng = np.random.default_rng(8)
    n = 150
    g = np.stack(np.meshgrid(*[np.linspace(-8, 8, 6)] * 3), -1).reshape(-1, 3)
    pos = (g[:n] + rng.normal(0, 0.2, (n, 3))).astype(np.float32)
    st = from_numpy(pos, np.zeros_like(pos), np.zeros(n, np.int32),
                    masses=rng.uniform(0.5, 2.0, n).astype(np.float32))
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_allpairs_forces(st.positions, u, v, cfg, bi=32,
                                             bj=64, interpret=True))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_triangular_matches_dense_lj_nowrap():
    cfg = SimConfig(
        force_law="lennard_jones", lj_epsilon=1.0, lj_sigma=0.3,
        particle_effect_radius=1.5, world_size=12.0, wrap_forces=False,
    ).validate()
    rng = np.random.default_rng(9)
    g = np.stack(np.meshgrid(*[np.linspace(-5, 5, 6)] * 3), -1).reshape(-1, 3)
    pos = (g + rng.normal(0, 0.05, g.shape)).astype(np.float32)
    st = from_numpy(pos, np.zeros_like(pos), np.zeros(len(pos), np.int32))
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_allpairs_forces(st.positions, u, v, cfg, bi=32,
                                             bj=64, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n,t", [(128, 64), (96, 32), (260, 64)])
def test_triangular_tile_count_edges(n, t):
    """Exact multiples of the block and ragged tails: padded receivers are
    sliced off, padded sources are killed by the r2 row."""
    cfg = reference_config()
    st = _scene(n + t, n, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_allpairs_forces(st.positions, u, v, cfg, bi=t,
                                             bj=t, interpret=True))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)


def test_many_species_wide_features():
    """id_count > PAIR_P: the coefficient FMAs run over P=12 features."""
    cfg = SimConfig(id_count=12, world_size=10.0).validate()
    rng = np.random.default_rng(77)
    m = rng.uniform(-1, 1, (12, 12)).astype(np.float32)
    cfg = cfg.replace(attraction_matrix=m)
    n = 200
    pos = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    species = rng.integers(0, 12, n).astype(np.int32)
    st = from_numpy(pos, np.zeros((n, 3), np.float32), species)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_allpairs_forces(st.positions, u, v, cfg,
                                             interpret=True))
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-5)
    got_t = np.asarray(pallas_allpairs_forces(st.positions, u, v, cfg,
                                               bi=32, bj=64, interpret=True))
    np.testing.assert_allclose(got_t, want, rtol=3e-4, atol=3e-5)

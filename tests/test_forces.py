"""Force-law unit tests against the loop oracle and analytic facts."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from particle3d import SimConfig, reference_config, from_numpy
from particle3d.ops import forces as F
from particle3d.ops.allpairs import allpairs_forces
from particle3d import oracle


def test_particle_life_magnitude_matches_rust_branches():
    cfg = reference_config()
    m = 0.3
    ds = np.linspace(1e-4, 2.5, 997).astype(np.float32)
    attr = 0.7
    got = np.asarray(F.particle_life_magnitude(jnp.asarray(ds), attr, m))
    want = np.array([oracle.calculate_force(float(d), attr, m) for d in ds], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_particle_life_edge_cases_are_zero():
    # d == min_pull_ratio and d >= 1.0 produce exactly zero (src/lib.rs:55-67
    # uses strict inequalities on both sides of the triangular branch).
    m = 0.3
    for d in (m, 1.0, 1.5):
        assert float(F.particle_life_magnitude(jnp.float32(d), 1.0, m)) == 0.0


def test_particle_life_repulsion_ignores_attraction():
    m = 0.3
    d = 0.1
    a = float(F.particle_life_magnitude(jnp.float32(d), -1.0, m))
    b = float(F.particle_life_magnitude(jnp.float32(d), +1.0, m))
    assert a == b == pytest.approx(d / m - 1.0, rel=1e-6)
    assert a < 0  # repulsive


def test_particle_life_peak_at_midpoint():
    m = 0.3
    peak_d = (1.0 + m) / 2.0
    v = float(F.particle_life_magnitude(jnp.float32(peak_d), 1.0, m))
    assert v == pytest.approx(1.0, abs=1e-6)


def test_min_image_wrap():
    w = 10.0
    d = jnp.asarray([4.9, 5.1, -5.1, 9.9, -9.9, 0.0], jnp.float32)
    got = np.asarray(F.min_image(d, w))
    np.testing.assert_allclose(got, [4.9, -4.9, 4.9, -0.1, 0.1, 0.0], atol=1e-5)


def test_lj_zero_at_minimum_and_signs():
    # LJ force magnitude crosses zero at d = 2^(1/6) sigma.
    sigma = 0.5
    cfg = SimConfig(force_law="lennard_jones", lj_sigma=sigma, lj_epsilon=1.0)
    mag = F.magnitude_fn(cfg)
    d_min = 2.0 ** (1.0 / 6.0) * sigma
    assert float(mag(jnp.float32(d_min), 1.0)) == pytest.approx(0.0, abs=1e-5)
    assert float(mag(jnp.float32(0.8 * d_min), 1.0)) < 0  # repulsive inside
    assert float(mag(jnp.float32(1.5 * d_min), 1.0)) > 0  # attractive outside


def test_gravity_two_body_acceleration():
    # coef = m_j; check direction (attraction) and softened magnitude.
    cfg = SimConfig(
        force_law="gravity", gravity_constant=2.0, gravity_softening=0.1,
        particle_effect_radius=5.0, world_size=100.0, wrap_forces=False,
    )
    pos = np.array([[0, 0, 0], [3, 0, 0]], np.float32)
    st = from_numpy(pos, np.zeros_like(pos), np.zeros(2, np.int32),
                    masses=np.array([1.0, 4.0], np.float32))
    u, v = F.pair_features(st, cfg)
    f = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    d, soft, g = 3.0, 0.1, 2.0
    expected = g * 4.0 * d / (d * d + soft * soft) ** 1.5
    assert f[0, 0] == pytest.approx(expected, rel=1e-5)  # pulled toward +x
    expected_on_1 = g * 1.0 * d / (d * d + soft * soft) ** 1.5
    assert f[1, 0] == pytest.approx(-expected_on_1, rel=1e-5)


def test_allpairs_matches_oracle_27_images():
    """The min-image dense path equals the literal 27-image reference sweep."""
    rng = np.random.default_rng(0)
    n = 64
    cfg = reference_config()
    pos = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    species = rng.integers(0, 5, n).astype(np.int32)
    st = from_numpy(pos, np.zeros_like(pos), species)
    u, v = F.pair_features(st, cfg)
    got = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    want = oracle.oracle_forces(pos, species, cfg, use_27_images=True)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_oracle_27_images_equals_min_image():
    """Sanity: the equivalence claim itself, inside the oracle (float64)."""
    rng = np.random.default_rng(1)
    n = 48
    cfg = reference_config()
    pos = rng.uniform(-5, 5, (n, 3)).astype(np.float64)
    species = rng.integers(0, 5, n).astype(np.int32)
    a = oracle.oracle_forces(pos, species, cfg, use_27_images=True)
    b = oracle.oracle_forces(pos, species, cfg, use_27_images=False)
    np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_newton_third_law_symmetric_matrix():
    """With a symmetric attraction matrix the pair force sum vanishes
    (momentum conservation), a property the triangular kernel guarantees."""
    rng = np.random.default_rng(2)
    n = 96
    m = rng.uniform(-1, 1, (5, 5)).astype(np.float32)
    m = (m + m.T) / 2
    cfg = reference_config().replace(attraction_matrix=m)
    pos = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    species = rng.integers(0, 5, n).astype(np.int32)
    st = from_numpy(pos, np.zeros_like(pos), species)
    u, v = F.pair_features(st, cfg)
    f = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    np.testing.assert_allclose(f.sum(axis=0), np.zeros(3), atol=1e-3)


def test_blocked_allpairs_matches_unblocked():
    rng = np.random.default_rng(3)
    n = 200
    cfg = reference_config()
    pos = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    species = rng.integers(0, 5, n).astype(np.int32)
    st = from_numpy(pos, np.zeros_like(pos), species)
    u, v = F.pair_features(st, cfg)
    a = np.asarray(allpairs_forces(st.positions, u, v, cfg, block_i=n))
    b = np.asarray(allpairs_forces(st.positions, u, v, cfg, block_i=64))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

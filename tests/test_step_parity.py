"""Full-step and trajectory parity vs the reference-semantics oracle,
plus integrator/boundary invariants."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from particle3d import (
    SimConfig, reference_config, from_numpy, init_scene, step, simulate,
    trajectory, warmup,
)
from particle3d import oracle


def _random_scene(seed, n, cfg):
    rng = np.random.default_rng(seed)
    half = float(np.asarray(cfg.world_size)) / 2
    pos = rng.uniform(-half, half, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    species = rng.integers(0, cfg.id_count, n).astype(np.int32)
    return pos, vel, species


@pytest.mark.parametrize("boundary", ["wrap", "clamp"])
def test_single_step_parity(boundary):
    cfg = reference_config().replace(boundary=boundary)
    pos, vel, species = _random_scene(10, 80, cfg)
    st = from_numpy(pos, vel, species)
    dt = 1.0 / 60.0
    out = step(st, cfg, dt)
    want_pos, want_vel = oracle.oracle_step(pos, vel, species, cfg, dt)
    np.testing.assert_allclose(np.asarray(out.positions), want_pos, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(out.velocities), want_vel, rtol=2e-4, atol=2e-5)


def test_multi_step_trajectory_parity():
    """The reference CPU demo config (N small for the loop oracle): L2
    trajectory error vs the oracle stays tiny over many steps."""
    cfg = reference_config()
    pos, vel, species = _random_scene(11, 48, cfg)
    st = from_numpy(pos, vel, species)
    dt = 1.0 / 60.0
    steps = 50
    out = simulate(st, cfg, dt, steps)
    # min-image oracle: equivalent to the 27-image sweep (proved by
    # test_oracle_27_images_equals_min_image) and ~27x faster in Python.
    want_pos, want_vel = oracle.oracle_simulate(
        pos, vel, species, cfg, dt, steps, use_27_images=False)
    got = np.asarray(out.positions)
    # rms over the trajectory endpoint; chaotic divergence is bounded at
    # these step counts.
    l2 = np.sqrt(np.mean((got - want_pos) ** 2))
    assert l2 < 1e-3, f"L2 trajectory error too large: {l2}"


def test_gravity_and_drag_applied_in_reference_order():
    # One particle, no neighbors: v += g*dt, drag, x += v*dt.
    cfg = reference_config().replace(acceleration=np.array([0.0, -9.8, 0.0], np.float32))
    pos = np.zeros((1, 3), np.float32)
    vel = np.array([[1.0, 0.0, 0.0]], np.float32)
    st = from_numpy(pos, vel, np.zeros(1, np.int32))
    dt = 1.0 / 60.0
    out = step(st, cfg, dt)
    v = np.array([1.0, -9.8 * dt, 0.0])
    v = v - v * (0.97 * dt)
    x = v * dt
    np.testing.assert_allclose(np.asarray(out.velocities)[0], v, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(out.positions)[0], x, rtol=1e-5)


def test_drag_stop_at_zero_branch():
    # coefficient * dt > 1 => velocity zeroed entirely (src/lib.rs:252-259).
    cfg = reference_config().replace(coefficient=130.0)  # 130/60 > 1
    vel = np.array([[3.0, -2.0, 1.0]], np.float32)
    st = from_numpy(np.zeros((1, 3), np.float32), vel, np.zeros(1, np.int32))
    out = step(st, cfg, 1.0 / 60.0)
    np.testing.assert_array_equal(np.asarray(out.velocities), np.zeros((1, 3)))


def test_wrap_keeps_positions_in_box():
    cfg = reference_config()
    key = jax.random.PRNGKey(0)
    st = init_scene(key, 256, cfg)
    st = st.replace(velocities=jax.random.normal(key, (256, 3)) * 5.0)
    out = simulate(st, cfg, 1.0 / 60.0, 30)
    hw = 5.0
    pos = np.asarray(out.positions)
    assert np.all(np.abs(pos) <= hw + 1e-5)


def test_clamp_walls_invariant_and_one_sided_velocity():
    cfg = reference_config().replace(boundary="clamp")
    pos = np.array([[4.99, 0.0, 0.0]], np.float32)
    vel = np.array([[100.0, 0.0, 0.0]], np.float32)
    st = from_numpy(pos, vel, np.zeros(1, np.int32))
    out = step(st, cfg, 1.0 / 60.0)
    assert float(out.positions[0, 0]) == pytest.approx(5.0)
    assert float(out.velocities[0, 0]) <= 0.0  # escaping component killed


def test_reflect_conserves_speed_with_unit_restitution():
    cfg = reference_config().replace(boundary="reflect", restitution=1.0,
                                     coefficient=0.0)
    pos = np.array([[4.9, 0.0, 0.0]], np.float32)
    vel = np.array([[30.0, 0.0, 0.0]], np.float32)
    st = from_numpy(pos, vel, np.zeros(1, np.int32))
    out = step(st, cfg, 1.0 / 60.0)
    assert float(out.velocities[0, 0]) == pytest.approx(-30.0)
    assert abs(float(out.positions[0, 0])) <= 5.0


def test_energy_decays_under_drag():
    cfg = reference_config().replace(
        attraction_matrix=np.zeros((5, 5), np.float32))
    rng = np.random.default_rng(4)
    pos, vel, species = _random_scene(4, 128, cfg)
    vel = rng.normal(0, 2.0, vel.shape).astype(np.float32)
    st = from_numpy(pos, vel, species)
    e0 = float(0.5 * np.sum(vel ** 2))
    out = simulate(st, cfg, 1.0 / 60.0, 60)
    e1 = float(0.5 * np.sum(np.asarray(out.velocities) ** 2))
    assert e1 < e0 * (1 - 0.97 / 60) ** 30  # strictly decaying


def test_determinism_same_seed_same_trajectory():
    """Quirk Q9 fixed: same seed => identical trajectory, twice."""
    cfg = reference_config()
    key = jax.random.PRNGKey(42)
    st1 = init_scene(key, 200, cfg)
    st2 = init_scene(key, 200, cfg)
    o1 = simulate(st1, cfg, 1.0 / 60.0, 20)
    o2 = simulate(st2, cfg, 1.0 / 60.0, 20)
    np.testing.assert_array_equal(np.asarray(o1.positions), np.asarray(o2.positions))


def test_trajectory_snapshots_shape_and_consistency():
    cfg = reference_config()
    st = init_scene(jax.random.PRNGKey(1), 64, cfg)
    final, snaps = trajectory(st, cfg, 1.0 / 60.0, 20, snapshot_every=5)
    assert snaps.shape == (4, 64, 3)
    np.testing.assert_array_equal(np.asarray(snaps[-1]), np.asarray(final.positions))
    direct = simulate(st, cfg, 1.0 / 60.0, 20)
    np.testing.assert_allclose(
        np.asarray(final.positions), np.asarray(direct.positions), atol=1e-6)


def test_trajectory_remainder_window():
    """num_steps not divisible by snapshot_every: the trailing partial
    window runs and emits one final snapshot (no assert, no dropped steps)."""
    cfg = reference_config()
    st = init_scene(jax.random.PRNGKey(2), 64, cfg)
    final, snaps = trajectory(st, cfg, 1.0 / 60.0, 23, snapshot_every=5)
    assert snaps.shape == (5, 64, 3)  # 4 full windows + 1 partial
    np.testing.assert_array_equal(np.asarray(snaps[-1]),
                                  np.asarray(final.positions))
    direct = simulate(st, cfg, 1.0 / 60.0, 23)
    np.testing.assert_allclose(
        np.asarray(final.positions), np.asarray(direct.positions), atol=1e-6)
    # snapshot_every > num_steps: one partial window
    final2, snaps2 = trajectory(st, cfg, 1.0 / 60.0, 3, snapshot_every=8)
    assert snaps2.shape == (1, 64, 3)
    direct2 = simulate(st, cfg, 1.0 / 60.0, 3)
    np.testing.assert_allclose(
        np.asarray(final2.positions), np.asarray(direct2.positions),
        atol=1e-6)


def test_velocity_verlet_harmonic_oscillator_energy():
    """Verlet integrator sanity: two particles on a spring conserve energy
    far better than Euler over many periods (no drag)."""
    cfg = SimConfig(
        force_law="spring", spring_stiffness=4.0, spring_rest_length=1.0,
        integrator="velocity_verlet", coefficient=0.0,
        particle_effect_radius=3.0, world_size=50.0, wrap_forces=False,
        interaction_force=1.0, boundary="wrap",
    ).validate()
    pos = np.array([[-0.8, 0, 0], [0.8, 0, 0]], np.float32)
    st = from_numpy(pos, np.zeros_like(pos), np.zeros(2, np.int32))
    st = warmup(st, cfg)
    dt = 0.01

    def energy(s):
        p = np.asarray(s.positions)
        v = np.asarray(s.velocities)
        d = np.linalg.norm(p[0] - p[1])
        return 0.5 * np.sum(v ** 2) + 0.5 * 4.0 * (d - 1.0) ** 2 * 2  # both springs

    e0 = energy(st)
    out = simulate(st, cfg, dt, 2000)
    e1 = energy(out)
    assert abs(e1 - e0) / e0 < 0.05


def test_config_validation_errors():
    from particle3d import ConfigError
    with pytest.raises(ConfigError):
        SimConfig(world_size=1.0, particle_effect_radius=2.0).validate()
    with pytest.raises(ConfigError):
        SimConfig(force_law="nope").validate()
    with pytest.raises(ConfigError):
        SimConfig(attraction_matrix=np.zeros((3, 3), np.float32)).validate()

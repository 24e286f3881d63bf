"""App shell: fixed-timestep driver, live controls, checkpoint round trip,
presets."""

import numpy as np
import jax
import pytest

from particle3d import SimConfig, reference_config, init_scene
from particle3d.app import SimulationApp
from particle3d.models import make_scene, list_presets
from particle3d.utils import save_checkpoint, load_checkpoint, measure_metrics


def _app(n=64):
    return SimulationApp(n=n, update_rate=60.0)


def test_tick_fixed_timestep_catchup_cap():
    app = _app()
    # a huge frame delta still runs at most 5 physics steps (quirk Q10)
    ran = app.tick(real_dt=10.0)
    assert ran == 5
    assert app.step_index == 5
    # tiny delta: no step
    app._accum = 0.0
    ran = app.tick(real_dt=0.001)
    assert ran == 0


def test_particle_count_truncate_and_extend():
    app = _app(100)
    app.set_particle_count(40)
    assert app.state.n == 40
    app.set_particle_count(120)
    assert app.state.n == 120
    app.run_steps(1)  # still steps fine


def test_world_size_clamped_to_radius():
    app = _app()
    app.set_world_size(1.0)  # radius 2 -> min world 4
    assert float(np.asarray(app.cfg.world_size)) == 4.0


def test_attraction_edit_clamped():
    app = _app()
    app.set_attraction(0, 1, 7.5)
    assert float(np.asarray(app.cfg.attraction_matrix)[0, 1]) == 1.0


def test_walls_toggle_changes_boundary():
    app = _app()
    app.set_walls(True)
    assert app.cfg.boundary == "clamp"
    app.run_steps(3)
    assert np.all(np.abs(np.asarray(app.state.positions)) <=
                  float(np.asarray(app.cfg.world_size)) / 2 + 1e-5)


def test_camera_keys_move():
    app = _app()
    z0 = float(app.camera.position[2])
    app.handle_keys({"w"}, 0.5)  # forward is -z at default pose
    assert float(app.camera.position[2]) == pytest.approx(z0 - 2.5)
    app.handle_keys({"left"}, 0.1)
    assert float(app.camera.yaw) == pytest.approx(-9.0)


def test_render_and_metrics():
    app = _app(128)
    app.run_steps(2)
    img = app.render(160, 120)
    assert img.shape == (120, 160, 3)
    m = app.metrics()
    assert m["n"] == 128 and m["step_index"] == 2
    assert np.isfinite(m["kinetic_energy"])


def test_checkpoint_roundtrip(tmp_path):
    app = _app(96)
    app.set_gravity(0.0, -1.0, 0.0)
    app.run_steps(4)
    p = str(tmp_path / "ck.npz")
    app.save(p)
    app2 = SimulationApp.load(p)
    assert app2.step_index == 4
    np.testing.assert_array_equal(
        np.asarray(app2.state.positions), np.asarray(app.state.positions))
    np.testing.assert_array_equal(
        np.asarray(app2.cfg.acceleration), np.asarray(app.cfg.acceleration))
    # resumed app continues stepping deterministically vs original
    app.run_steps(3)
    app2.run_steps(3)
    np.testing.assert_allclose(
        np.asarray(app2.state.positions), np.asarray(app.state.positions),
        atol=1e-6)


@pytest.mark.parametrize("name", ["reference", "reference_walls",
                                  "spring_lattice", "gravity_nbody"])
def test_presets_step(name):
    state, cfg, dt = make_scene(name, n=64)
    cfg = cfg.replace(neighbor="allpairs")  # small-N test on CPU
    from particle3d import step, warmup

    st = warmup(state, cfg)
    out = step(st, cfg, dt)
    assert np.all(np.isfinite(np.asarray(out.positions)))


def test_lj_preset_small():
    state, cfg, dt = make_scene("lj_gas", n=512)
    from particle3d import simulate, warmup

    st = warmup(state, cfg)
    out = simulate(st, cfg, dt, 5)
    pos = np.asarray(out.positions)
    assert np.all(np.isfinite(pos))
    assert np.all(np.abs(pos) <= float(np.asarray(cfg.world_size)) / 2 + 1e-4)


def test_preset_registry_complete():
    assert set(list_presets()) >= {
        "reference", "reference_walls", "particle_life_large",
        "verlet_elastic", "lj_gas", "gravity_nbody", "spring_lattice"}

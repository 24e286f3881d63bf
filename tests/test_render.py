"""Renderer: camera math invariants and splat rasterization facts."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from particle3d import reference_config, init_scene, from_numpy
from particle3d.render import (
    Camera, camera_axes, view_matrix, projection_matrix, render_frame,
    move_camera, rotate_camera,
)
from particle3d.render.camera import default_camera, PITCH_LIMIT


def test_axes_orthonormal():
    cam = Camera(position=jnp.zeros(3), pitch=23.0, yaw=-40.0)
    f, r, u = camera_axes(cam)
    for v in (f, r, u):
        assert float(jnp.linalg.norm(v)) == pytest.approx(1.0, abs=1e-5)
    assert float(jnp.dot(f, r)) == pytest.approx(0.0, abs=1e-5)
    assert float(jnp.dot(f, u)) == pytest.approx(0.0, abs=1e-5)
    assert float(jnp.dot(r, u)) == pytest.approx(0.0, abs=1e-5)


def test_default_forward_minus_z():
    cam = Camera(position=jnp.zeros(3))
    f, r, u = camera_axes(cam)
    np.testing.assert_allclose(np.asarray(f), [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(np.asarray(r), [1, 0, 0], atol=1e-6)  # fwd x up
    np.testing.assert_allclose(np.asarray(u), [0, 1, 0], atol=1e-6)


def test_reference_up_is_inverted():
    """Quirk Q6 compatibility: up = forward x right points to -y."""
    cam = Camera(position=jnp.zeros(3), reference_up=True)
    _, _, u = camera_axes(cam)
    np.testing.assert_allclose(np.asarray(u), [0, -1, 0], atol=1e-6)


def test_view_matrix_maps_eye_to_origin():
    cam = Camera(position=jnp.array([3.0, -2.0, 7.0]), pitch=10.0, yaw=30.0)
    vm = view_matrix(cam)
    eye_h = jnp.concatenate([cam.position, jnp.ones(1)])
    out = vm @ eye_h
    np.testing.assert_allclose(np.asarray(out[:3]), np.zeros(3), atol=1e-5)


def test_point_ahead_projects_to_center():
    cam = default_camera(10.0)  # at (1, 0, 16) looking -z
    vm = view_matrix(cam)
    pm = projection_matrix(cam, 4 / 3)
    p = jnp.array([[1.0, 0.0, 0.0, 1.0]])  # directly ahead
    clip = (p @ vm.T) @ pm.T
    ndc = np.asarray(clip[0, :3] / clip[0, 3])
    np.testing.assert_allclose(ndc[:2], [0, 0], atol=1e-5)


def test_pitch_clamp():
    cam = Camera(position=jnp.zeros(3))
    cam = rotate_camera(cam, 500.0, 0.0)
    assert float(cam.pitch) == pytest.approx(PITCH_LIMIT)


def test_move_camera_speed():
    cam = Camera(position=jnp.zeros(3))
    cam = move_camera(cam, 0.5, jnp.array([1.0, 0.0, 0.0]))
    assert float(cam.position[0]) == pytest.approx(2.5)  # SPEED=5 * 0.5s


def test_render_frame_shows_particles_and_border():
    cfg = reference_config()
    st = init_scene(jax.random.PRNGKey(0), 500, cfg)
    cam = default_camera(10.0)
    img = np.asarray(render_frame(st.positions, st.species, cfg, cam, 320, 240))
    assert img.shape == (240, 320, 3) and img.dtype == np.uint8
    # background is near-black; particles/border add non-background pixels
    nonbg = (img.sum(-1) > 30).sum()
    assert nonbg > 200, f"expected visible content, got {nonbg} lit pixels"


def test_render_depth_test_front_particle_wins():
    cfg = reference_config()
    # two particles on the view axis: species 0 (red) in front, 1 (green) behind
    pos = np.array([[1.0, 0.0, 2.0], [1.0, 0.0, -2.0]], np.float32)
    st = from_numpy(pos, np.zeros_like(pos), np.array([0, 1], np.int32))
    cam = default_camera(10.0)  # at z=16 looking -z: z=2 is closer
    img = np.asarray(render_frame(st.positions, st.species, cfg, cam, 200, 200,
                                  draw_border=False))
    cy, cx = 100, 100
    patch = img[cy - 3:cy + 4, cx - 3:cx + 4].reshape(-1, 3)
    lit = patch[patch.sum(-1) > 30]
    assert len(lit) > 0
    # all lit pixels in the center patch must be red (species 0 wins depth)
    assert np.all(lit[:, 0] > 200) and np.all(lit[:, 1] < 50)


def test_render_behind_camera_invisible():
    cfg = reference_config()
    pos = np.array([[1.0, 0.0, 100.0]], np.float32)  # behind the camera
    st = from_numpy(pos, np.zeros_like(pos), np.zeros(1, np.int32))
    cam = default_camera(10.0)
    img = np.asarray(render_frame(st.positions, st.species, cfg, cam, 160, 120,
                                  draw_border=False))
    assert (img.sum(-1) > 30).sum() == 0


def test_dilate_matches_scatter_within_tolerance():
    """Fast path (point-scatter + radius dilation) vs the exact scatter-min
    renderer: documented tolerance is sub-pixel coverage wobble and rare
    same-seed-pixel eclipses — the images must agree on the vast majority of
    pixels and on every structural element (all species present, border)."""
    from particle3d import init_scene
    import jax

    cfg = reference_config()
    st = init_scene(jax.random.PRNGKey(3), 800, cfg)
    cam = default_camera(10.0)
    a = np.asarray(render_frame(st.positions, st.species, cfg, cam, 320, 240,
                                method="scatter"))
    b = np.asarray(render_frame(st.positions, st.species, cfg, cam, 320, 240,
                                method="dilate"))
    match = (a == b).all(-1).mean()
    assert match > 0.93, f"pixel match {match:.3f}"
    # same species palette coverage in both
    for img in (a, b):
        lit = img[img.sum(-1) > 30]
        assert len(lit) > 100
    # depth ordering preserved on the fast path too
    pos = np.array([[1.0, 0.0, 2.0], [1.0, 0.0, -2.0]], np.float32)
    st2 = from_numpy(pos, np.zeros_like(pos), np.array([0, 1], np.int32))
    img = np.asarray(render_frame(st2.positions, st2.species, cfg, cam,
                                  200, 200, draw_border=False,
                                  method="dilate"))
    patch = img[97:104, 97:104].reshape(-1, 3)
    lit = patch[patch.sum(-1) > 30]
    assert len(lit) > 0
    assert np.all(lit[:, 0] > 200) and np.all(lit[:, 1] < 50)

"""Camera system: spherical-angle axes, view/projection matrices, movement.

Reproduces the reference ``CameraSystem`` (``src/bin/main.rs:16-57``) and its
matrix setup (``look_to_rh`` + 90-degree ``perspective``, ``main.rs:412-438``):

  * forward = (cos(pitch) sin(yaw), sin(pitch), -cos(pitch) cos(yaw))
  * WASD/QE translation at SPEED = 5 units/s (main.rs:11,48-50)
  * arrow rotation at 90 deg/s, pitch clamped to +/-90.9999 (main.rs:52-56)
  * perspective(fovy=90deg, aspect, near=0.001, far=1000) (main.rs:429-434)

The reference computes up = forward x right, which inverts the vertical axis
(quirk Q6). We default to the conventional up = right x forward; set
``reference_up=True`` for bug-compatible framing.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

SPEED = 5.0  # main.rs:12
ROTATION_SPEED = 90.0  # deg/s, main.rs:11
PITCH_LIMIT = 90.9999  # main.rs:55


@dataclasses.dataclass(frozen=True)
class Camera:
    position: Any  # f32[3]
    pitch: Any = 0.0  # degrees
    yaw: Any = 0.0  # degrees
    up_hint: Any = None  # f32[3], world up
    fov_deg: float = 90.0
    near: float = 0.001
    far: float = 1000.0
    reference_up: bool = False  # quirk Q6 compatibility

    def __post_init__(self):
        if self.up_hint is None:
            object.__setattr__(self, "up_hint", jnp.array([0.0, 1.0, 0.0], jnp.float32))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


jax.tree_util.register_dataclass(
    Camera,
    data_fields=["position", "pitch", "yaw", "up_hint"],
    meta_fields=["fov_deg", "near", "far", "reference_up"],
)


def default_camera(world_size: float = 10.0) -> Camera:
    """Reference starting pose: (1, 0, 1.6 * world) looking -z (main.rs:151-156)."""
    return Camera(position=jnp.array([1.0, 0.0, 1.6 * world_size], jnp.float32))


def _normalize(v):
    return v / jnp.linalg.norm(v)


def camera_axes(cam: Camera):
    """(forward, right, up) — main.rs:26-46."""
    pitch = jnp.deg2rad(jnp.asarray(cam.pitch, jnp.float32))
    yaw = jnp.deg2rad(jnp.asarray(cam.yaw, jnp.float32))
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    forward = _normalize(jnp.stack([cp * sy, sp, -cp * cy]))
    right = _normalize(jnp.cross(forward, jnp.asarray(cam.up_hint, jnp.float32)))
    if cam.reference_up:
        up = _normalize(jnp.cross(forward, right))  # Q6: inverted vertical
    else:
        up = _normalize(jnp.cross(right, forward))
    return forward, right, up


def move_camera(cam: Camera, dt, direction) -> Camera:
    """Translate along a (unit) direction at SPEED (main.rs:48-50)."""
    return cam.replace(position=cam.position + jnp.asarray(direction) * SPEED * dt)


def rotate_camera(cam: Camera, pitch_delta, yaw_delta) -> Camera:
    """Rotate, clamping pitch (main.rs:52-56)."""
    return cam.replace(
        pitch=jnp.clip(cam.pitch + pitch_delta, -PITCH_LIMIT, PITCH_LIMIT),
        yaw=cam.yaw + yaw_delta,
    )


def view_matrix(cam: Camera):
    """Right-handed look-to view matrix (cgmath look_to_rh, main.rs:419-427)."""
    forward, _, up = camera_axes(cam)
    eye = jnp.asarray(cam.position, jnp.float32)
    f = forward
    s = _normalize(jnp.cross(f, up))
    u = jnp.cross(s, f)
    m = jnp.stack([
        jnp.concatenate([s, jnp.array([-jnp.sum(s * eye)])]),
        jnp.concatenate([u, jnp.array([-jnp.sum(u * eye)])]),
        jnp.concatenate([-f, jnp.array([jnp.sum(f * eye)])]),
        jnp.array([0.0, 0.0, 0.0, 1.0]),
    ])
    return m  # [4,4], row-major: view @ [p;1]


def projection_matrix(cam: Camera, aspect):
    """OpenGL-style perspective (cgmath::perspective, main.rs:429-434)."""
    fov = jnp.deg2rad(jnp.asarray(cam.fov_deg, jnp.float32))
    fct = 1.0 / jnp.tan(fov / 2.0)
    near, far = cam.near, cam.far
    a = jnp.asarray(aspect, jnp.float32)
    return jnp.array(
        [
            [1.0, 0.0, 0.0, 0.0],
            [0.0, 1.0, 0.0, 0.0],
            [0.0, 0.0, (far + near) / (near - far), 2 * far * near / (near - far)],
            [0.0, 0.0, -1.0, 0.0],
        ],
        jnp.float32,
    ).at[0, 0].set(fct / a).at[1, 1].set(fct)

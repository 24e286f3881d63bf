"""Headless trajectory rendering: simulate on device, export GIF/PNG frames.

The batched device->host snapshot path from the north star: the whole
trajectory runs under ``lax.scan`` on the accelerator; the host receives one
stacked positions array and rasterizes frames (also on device) for export.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import SimConfig
from ..state import ParticleState
from ..engine.step import trajectory, warmup
from ..render.camera import Camera, default_camera
from ..render.splat import render_frame


def render_trajectory(state: ParticleState, cfg: SimConfig, dt: float,
                      num_steps: int, *, snapshot_every: int = 4,
                      width: int = 480, height: int = 360,
                      camera: Camera | None = None):
    """-> (final_state, frames uint8 [S, H, W, 3])."""
    if camera is None:
        camera = default_camera(float(np.asarray(cfg.world_size)))
    state = warmup(state, cfg)
    final, snaps = trajectory(state, cfg, dt, num_steps, snapshot_every)
    frames = []
    species = state.species
    for i in range(snaps.shape[0]):
        img = render_frame(snaps[i], species, cfg, camera, width, height)
        frames.append(np.asarray(img))
    return final, np.stack(frames)


def save_gif(frames: np.ndarray, path: str, fps: int = 20) -> None:
    """Animated GIF export; needs Pillow (``pip install pillow``)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            "GIF export needs Pillow (pip install pillow); PNG frames "
            "(save_frames) and the server need nothing extra") from e

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)


def save_frames(frames: np.ndarray, out_dir: str) -> None:
    from .server import encode_png

    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(frames):
        with open(os.path.join(out_dir, f"frame_{i:05d}.png"), "wb") as fh:
            fh.write(encode_png(f))

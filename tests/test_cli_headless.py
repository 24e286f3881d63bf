"""CLI and headless export surfaces."""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import pytest

from particle3d.app.headless import render_trajectory, save_gif
from particle3d.models import make_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)


def _cli(*args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "particle3d", *args],
        capture_output=True, text=True, cwd=REPO, env=ENV, timeout=timeout)


def test_cli_presets_lists():
    r = _cli("presets")
    assert r.returncode == 0
    assert "reference" in r.stdout and "lj_gas" in r.stdout


def test_cli_run_and_resume(tmp_path):
    ck = str(tmp_path / "ck.npz")
    r = _cli("run", "--preset", "reference", "--n", "128", "--steps", "30",
             "--checkpoint", ck)
    assert r.returncode == 0, r.stderr
    line = [l for l in r.stdout.splitlines() if l.startswith("{")][0]
    out = json.loads(line)
    assert out["n"] == 128 and out["steps"] == 30
    assert os.path.exists(ck)

    r2 = _cli("resume", "--checkpoint", ck, "--steps", "10")
    assert r2.returncode == 0, r2.stderr
    line2 = [l for l in r2.stdout.splitlines() if l.startswith("{")][0]
    out2 = json.loads(line2)
    assert out2["resumed_from"] == 30 and out2["now"] == 40


def test_headless_gif_export(tmp_path):
    state, cfg, dt = make_scene("reference", n=96)
    # give the scene visible motion: the default renderer quantizes splat
    # centers to pixels, and PIL merges consecutive identical GIF frames
    import jax

    state = state.replace(velocities=jax.random.uniform(
        jax.random.PRNGKey(9), state.velocities.shape, minval=-3.0,
        maxval=3.0))
    final, frames = render_trajectory(state, cfg, dt, 12, snapshot_every=4,
                                      width=120, height=90)
    assert frames.shape == (3, 90, 120, 3)
    gif = str(tmp_path / "out.gif")
    save_gif(frames, gif, fps=10)
    assert os.path.getsize(gif) > 500
    from PIL import Image

    im = Image.open(gif)
    assert im.n_frames == 3


def test_record_and_replay(tmp_path):
    traj = str(tmp_path / "t.p3t")
    r = _cli("run", "--preset", "reference", "--n", "64", "--steps", "24",
             "--snapshot-every", "4", "--record", traj)
    assert r.returncode == 0, r.stderr
    from particle3d.utils.trajio import TrajectoryReader

    tr = TrajectoryReader(traj)
    assert tr.n == 64 and len(tr) == 6
    assert tr[0].shape == (64, 3)
    import numpy as np

    assert np.isfinite(np.asarray(tr.positions())).all()
    assert not np.allclose(tr[0], tr[5])  # motion recorded
    gif = str(tmp_path / "r.gif")
    r2 = _cli("replay", "--traj", traj, "--gif", gif, "--every", "2",
              "--width", "120", "--height", "90")
    assert r2.returncode == 0, r2.stderr
    assert os.path.getsize(gif) > 300


def test_record_non_divisible_cadence(tmp_path):
    """steps not a multiple of snapshot-every: the trailing remainder steps
    still run and the final partial window is recorded (no silent drop)."""
    traj = str(tmp_path / "t2.p3t")
    r = _cli("run", "--preset", "reference", "--n", "64", "--steps", "10",
             "--snapshot-every", "4", "--record", traj)
    assert r.returncode == 0, r.stderr
    from particle3d.utils.trajio import TrajectoryReader

    tr = TrajectoryReader(traj)
    assert len(tr) == 3  # snapshots at steps 4, 8, 10

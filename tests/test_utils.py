"""Metrics, profiling, checkpoint edge cases."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from particle3d import reference_config, init_scene, from_numpy
from particle3d.utils import (
    measure_metrics, kinetic_energy, total_momentum, benchmark_steps,
    StepTimer, save_checkpoint, load_checkpoint,
)


def test_metrics_values():
    pos = np.zeros((2, 3), np.float32)
    vel = np.array([[1.0, 0, 0], [0, 2.0, 0]], np.float32)
    st = from_numpy(pos, vel, np.zeros(2, np.int32),
                    masses=np.array([2.0, 1.0], np.float32))
    m = measure_metrics(st)
    assert float(m.kinetic_energy) == pytest.approx(0.5 * (2 * 1 + 1 * 4))
    np.testing.assert_allclose(np.asarray(m.momentum), [2.0, 2.0, 0.0])
    assert float(m.max_speed) == pytest.approx(2.0)
    d = m.as_dict()
    assert set(d) >= {"kinetic_energy", "momentum", "max_speed", "mean_speed", "com"}


def test_benchmark_steps_returns_positive_time():
    f = jax.jit(lambda x: x * 2.0)
    x = jnp.ones((128, 128))
    sec, out = benchmark_steps(f, x, warmup=1, iters=2)
    assert sec > 0
    assert out.shape == (128, 128)


def test_step_timer_ema():
    t = StepTimer(alpha=0.5)
    import time

    with t:
        time.sleep(0.01)
    first = t.ema_ms
    assert first >= 10
    with t:
        pass
    assert t.ema_ms < first  # EMA moves toward the fast sample


def test_checkpoint_rejects_bad_version(tmp_path):
    cfg = reference_config()
    st = init_scene(jax.random.PRNGKey(0), 16, cfg)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, st, cfg, 7)
    # corrupt the version
    import json

    with np.load(p) as z:
        data = {k: z[k] for k in z.files}
    meta = json.loads(str(data["meta"]))
    meta["format_version"] = 999
    data["meta"] = json.dumps(meta)
    np.savez(p, **data)
    with pytest.raises(ValueError):
        load_checkpoint(p)


def test_checkpoint_preserves_full_config(tmp_path):
    cfg = reference_config().replace(
        boundary="clamp", coefficient=0.5,
        attraction_matrix=np.full((5, 5), 0.25, np.float32))
    st = init_scene(jax.random.PRNGKey(1), 8, cfg)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, st, cfg, 3, extra={"note": "hi"})
    st2, cfg2, idx, extra = load_checkpoint(p)
    assert idx == 3 and extra == {"note": "hi"}
    assert cfg2.boundary == "clamp"
    assert float(np.asarray(cfg2.coefficient)) == 0.5
    np.testing.assert_array_equal(
        np.asarray(cfg2.attraction_matrix), np.asarray(cfg.attraction_matrix))

"""Native C++ engine: parity with the Python oracle and the JAX path."""

import numpy as np
import pytest

from particle3d import reference_config, from_numpy, step, simulate
from particle3d import oracle
from particle3d import native


pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def _scene(seed, n, cfg):
    rng = np.random.default_rng(seed)
    half = float(np.asarray(cfg.world_size)) / 2
    pos = rng.uniform(-half, half, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    species = rng.integers(0, 5, n).astype(np.int32)
    return pos, vel, species


@pytest.mark.parametrize("walls", [False, True])
def test_native_step_matches_python_oracle(walls):
    cfg = reference_config().replace(boundary="clamp" if walls else "wrap")
    pos, vel, species = _scene(0, 60, cfg)
    dt = 1.0 / 60.0
    gp, gv = native.native_step(pos, vel, species, cfg, dt)
    wp, wv = oracle.oracle_step(pos, vel, species, cfg, dt)
    np.testing.assert_allclose(gp, wp, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5)


def test_native_hash_equals_bruteforce():
    """The exact-key spatial hash visits the same pair set as brute force;
    only f32 summation order differs (different traversal order), so one
    step agrees to tight FP tolerance."""
    cfg = reference_config()
    pos, vel, species = _scene(1, 300, cfg)
    dt = 1.0 / 60.0
    a = native.native_simulate(pos, vel, species, cfg, dt, 1, use_hash=True)
    b = native.native_simulate(pos, vel, species, cfg, dt, 1, use_hash=False)
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a[1], b[1], rtol=1e-4, atol=1e-5)


def test_native_is_deterministic():
    cfg = reference_config()
    pos, vel, species = _scene(2, 500, cfg)
    a = native.native_simulate(pos, vel, species, cfg, 1 / 60, 10)
    b = native.native_simulate(pos, vel, species, cfg, 1 / 60, 10)
    np.testing.assert_array_equal(a[0], b[0])


def test_jax_trajectory_matches_native_at_1k():
    """The BASELINE parity anchor: N=1000 (reference demo scale), many steps,
    JAX-path semantics vs the native reference-exact engine."""
    cfg = reference_config()
    pos, vel, species = _scene(3, 1000, cfg)
    st = from_numpy(pos, vel, species)
    steps = 120
    out = simulate(st, cfg, 1.0 / 60.0, steps)
    gp, _ = native.native_simulate(pos, vel, species, cfg, 1.0 / 60.0, steps)
    got = np.asarray(out.positions)
    l2 = np.sqrt(np.mean((got - gp) ** 2))
    assert l2 < 5e-3, f"trajectory L2 error vs native reference: {l2}"

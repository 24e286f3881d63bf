"""Cell-geometry autotuner (utils/tune.py)."""

import jax
import jax.numpy as jnp

from particle3d import reference_config, init_scene
from particle3d.utils.tune import candidate_geometries, tune


def test_candidates_respect_cutoff_and_capacity():
    cfg = reference_config(world_size=16.0)
    cands = candidate_geometries(cfg, 4096)
    assert cands
    for nsc, cap in cands:
        assert 16.0 / nsc >= 1.0 - 1e-6  # cell width >= PL cutoff
        assert cap >= 2
        # capacity covers at least ~1.25x the mean occupancy (sub-2x
        # candidates are deliberate: the overflow sidecar serves the tail)
        assert cap >= 1.25 * 4096 / nsc ** 3 - 1


def test_candidates_include_sub_2x_capacity():
    # round 4: the sidecar makes mean-hugging capacities exact, so the
    # sweep must offer at least one cap below 2x mean occupancy at a
    # production-like shape (the hand-tuned 262k geometry is (24,32) =
    # 1.7x mean; a 2x-floored sweep could never find it)
    cfg = reference_config(world_size=40.0)
    cands = candidate_geometries(cfg, 262144, max_candidates=24)
    assert any(cap < 2.0 * 262144 / nsc ** 3 for nsc, cap in cands)


def test_tune_runs_and_ranks():
    cfg = reference_config(world_size=16.0)
    st = init_scene(jax.random.PRNGKey(0), 1024, cfg)
    cands = candidate_geometries(cfg, 1024)[:2]
    results = tune(st, cfg, jnp.float32(1 / 60), steps=2,
                   candidates=cands, verbose=None)
    assert len(results) == 2
    # ranking: mask-free first, then fastest
    key = [(r.capacity_masked > 0, r.ms_per_step) for r in results]
    assert key == sorted(key)
    for r in results:
        assert r.steps_per_s > 0

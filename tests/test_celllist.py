"""Cell-list backend: exact equivalence with all-pairs (the reference's hash
collisions only add radius-rejected candidates — src/lib.rs:216-220 — so an
exact cell list is semantics-preserving; SURVEY.md section 4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from particle3d import SimConfig, reference_config, from_numpy, init_scene, step, simulate
from particle3d.ops import forces as F
from particle3d.ops.allpairs import allpairs_forces
from particle3d.ops.celllist import (
    celllist_forces, celllist_stats, build_cell_list, grid_dims,
    default_capacity, _cell_ids,
)


def _scene(seed, n, cfg):
    rng = np.random.default_rng(seed)
    half = float(np.asarray(cfg.world_size)) / 2
    pos = rng.uniform(-half, half, (n, 3)).astype(np.float32)
    species = rng.integers(0, cfg.id_count, n).astype(np.int32)
    return from_numpy(pos, np.zeros((n, 3), np.float32), species)


def test_cell_ids_in_range():
    cfg = reference_config().replace(world_size=12.0)
    st = _scene(0, 500, cfg)
    nc = grid_dims(12.0, 2.0)
    ids = np.asarray(_cell_ids(st.positions, cfg, nc))
    assert ids.min() >= 0 and ids.max() < nc ** 3


def test_build_cell_list_is_partition():
    cfg = reference_config().replace(world_size=12.0)
    n = 300
    st = _scene(1, n, cfg)
    nc = grid_dims(12.0, 2.0)
    slot_idx, _ = build_cell_list(st.positions, cfg, nc, capacity=64)
    got = np.asarray(slot_idx)
    real = got[got >= 0]
    assert sorted(real.tolist()) == list(range(n))  # every particle exactly once


@pytest.mark.parametrize("world,n", [(12.0, 200), (16.0, 500), (10.0, 64)])
def test_celllist_matches_allpairs_particle_life(world, n):
    cfg = reference_config().replace(world_size=world, neighbor="celllist")
    st = _scene(2, n, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(celllist_forces(st.positions, u, v, cfg, capacity=48, cell_batch=64))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_celllist_matches_allpairs_no_wrap():
    cfg = reference_config().replace(world_size=14.0, wrap_forces=False)
    st = _scene(3, 250, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(celllist_forces(st.positions, u, v, cfg, capacity=48, cell_batch=64))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_celllist_lj_gas():
    cfg = SimConfig(
        force_law="lennard_jones", lj_epsilon=1.0, lj_sigma=0.3,
        particle_effect_radius=1.0, world_size=8.0,
    ).validate()
    rng = np.random.default_rng(5)
    g = np.stack(np.meshgrid(*[np.linspace(-3.5, 3.5, 8)] * 3), -1).reshape(-1, 3)
    pos = (g + rng.normal(0, 0.05, g.shape)).astype(np.float32)
    st = from_numpy(pos, np.zeros_like(pos), np.zeros(len(pos), np.int32))
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(celllist_forces(st.positions, u, v, cfg))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_celllist_small_world_falls_back():
    # nc < 3 -> dense fallback, still correct
    cfg = reference_config()  # world 10, radius 2 -> nc = 5 ... use bigger radius
    cfg = cfg.replace(particle_effect_radius=4.0, world_size=10.0)
    st = _scene(6, 100, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(celllist_forces(st.positions, u, v, cfg))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_celllist_stats_overflow_flag():
    cfg = reference_config().replace(world_size=12.0)
    pos = np.zeros((100, 3), np.float32)  # all in one cell
    mx, overflow, nc = celllist_stats(pos, cfg, capacity=32)
    assert mx == 100 and overflow
    mx2, overflow2, _ = celllist_stats(pos, cfg, capacity=128)
    assert not overflow2


def test_celllist_backend_in_step_matches():
    cfg = reference_config().replace(world_size=12.0)
    cfg_cl = cfg.replace(neighbor="celllist")
    st = _scene(7, 256, cfg)
    a = step(st, cfg, 1.0 / 60.0)
    b = step(st, cfg_cl, 1.0 / 60.0)
    np.testing.assert_allclose(
        np.asarray(a.positions), np.asarray(b.positions), rtol=2e-4, atol=2e-5)


def test_celllist_batched_matches_single():
    cfg = reference_config().replace(world_size=20.0)
    st = _scene(8, 400, cfg)
    u, v = F.pair_features(st, cfg)
    a = np.asarray(celllist_forces(st.positions, u, v, cfg, cell_batch=1000))
    b = np.asarray(celllist_forces(st.positions, u, v, cfg, cell_batch=64))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("group", [1, 2])
def test_celllist_supercell_groups_match(group):
    cfg = reference_config().replace(world_size=16.0)
    st = _scene(9, 300, cfg)
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(celllist_forces(st.positions, u, v, cfg, capacity=48,
                                     group=group, cell_batch=64))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)

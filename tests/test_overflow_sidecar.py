"""Overflow sidecar (ops/overflow.py + the dense-layout integration):
capacity-overflow particles must be EXACT (not frozen) up to ocap, across
laws, integrators and boundaries — the design that lets the production cell
geometry hug the mean occupancy instead of the Poisson-tail max."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle3d import reference_config, init_scene, simulate
from particle3d.config import SimConfig
from particle3d.engine.step import simulate_dense, warmup
from particle3d.ops import forces as F
from particle3d.ops.celllist_dense import (
    OCAP, build_dense, rebind, sidecar_indices, default_mover_capacity)
from particle3d.ops.overflow import rect_forces


def _cfg(**kw):
    base = dict(neighbor="celllist_pallas", cell_grid=8, cell_capacity=4)
    base.update(kw)
    return reference_config(world_size=16.0).replace(**base)


def test_rect_forces_matches_allpairs_square():
    """Square case (sources == receivers, all valid) must reproduce the XLA
    all-pairs backend bit-for-bit-ish (same math, different blocking)."""
    from particle3d.ops.allpairs import allpairs_forces

    cfg = _cfg()
    st = init_scene(jax.random.PRNGKey(0), 300, cfg)
    u, v = F.pair_features(st, cfg)
    ref = allpairs_forces(st.positions, u, v, cfg)
    got = rect_forces(st.positions, u, st.positions, v,
                      jnp.ones((300,), bool), cfg, block_i=128, block_j=128)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_rect_forces_source_validity_mask():
    """Invalid source rows (stale slot garbage) must exert nothing — even
    when their coordinates sit inside the cutoff."""
    cfg = _cfg()
    st = init_scene(jax.random.PRNGKey(1), 64, cfg)
    u, v = F.pair_features(st, cfg)
    valid = jnp.arange(64) < 32
    got = rect_forces(st.positions[:8], u[:8], st.positions, v, valid, cfg)
    ref = rect_forces(st.positions[:8], u[:8], st.positions[:32], v[:32],
                      jnp.ones((32,), bool), cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-6, atol=1e-7)


def _overflow_scene(key, n, cfg, crowd=10):
    """A scene with `crowd` particles crammed into one cell (guaranteed
    capacity overflow at small caps)."""
    st = init_scene(key, n, cfg)
    pos = np.asarray(st.positions).copy()
    pos[:crowd] = np.array([1.3, 1.3, 1.3], np.float32) + \
        np.arange(crowd, dtype=np.float32)[:, None] * 7e-3
    return st.replace(positions=jnp.asarray(pos))


@pytest.mark.parametrize("boundary,wrapf", [("wrap", True), ("clamp", False)])
def test_sidecar_exact_vs_allpairs(boundary, wrapf):
    cfg = _cfg(boundary=boundary, wrap_forces=wrapf)
    st = _overflow_scene(jax.random.PRNGKey(2), 500, cfg)
    dt = jnp.float32(1 / 30)
    out, (_, masked) = simulate_dense(st, cfg, dt, 8)
    assert int(masked) == 0
    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 8)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_sidecar_exact_verlet_integrator():
    cfg = _cfg(integrator="velocity_verlet")
    st = warmup(_overflow_scene(jax.random.PRNGKey(3), 400, cfg), cfg)
    dt = jnp.float32(1 / 60)
    out, (_, masked) = simulate_dense(st, cfg, dt, 8)
    assert int(masked) == 0
    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 8)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_sidecar_exact_gravity_law():
    cfg = SimConfig(world_size=16.0, force_law="gravity",
                    neighbor="celllist_pallas", cell_grid=8, cell_capacity=4,
                    particle_effect_radius=2.0, integrator="leapfrog",
                    coefficient=0.0).validate()
    st = warmup(_overflow_scene(jax.random.PRNGKey(4), 400, cfg), cfg)
    dt = jnp.float32(1e-3)
    out, (_, masked) = simulate_dense(st, cfg, dt, 6)
    assert int(masked) == 0
    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 6)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_sidecar_budget_exhaustion_freezes_and_counts():
    """Overflow beyond ocap must freeze (ballistic, finite) and COUNT as
    masked — never silently read as exact."""
    cfg = _cfg(cell_capacity=2)
    st = _overflow_scene(jax.random.PRNGKey(5), 400, cfg, crowd=12)
    dt = jnp.float32(1 / 30)
    out, (_, masked) = simulate_dense(st, cfg, dt, 2, ocap=4)
    assert int(masked) > 0
    assert bool(np.isfinite(np.asarray(out.positions)).all())
    # ample budget: same scene reads exact
    _, (_, masked_full) = simulate_dense(st, cfg, dt, 2, ocap=OCAP)
    assert int(masked_full) == 0


def test_build_places_overflow_in_free_slots():
    """build_dense parks overflow rows in free slots (pid present, r2 <= 0)
    and sidecar_indices finds exactly those rows."""
    cfg = _cfg(cell_capacity=2)
    st = _overflow_scene(jax.random.PRNGKey(6), 300, cfg, crowd=8)
    ds = build_dense(st, cfg, 8, 2)
    pid = np.asarray(ds.pid)
    assert int((pid >= 0).sum()) == 300  # nobody dropped
    mis = np.asarray(sidecar_indices(ds, 32))
    s_total = pid.shape[0]
    live = mis[mis < s_total]
    assert len(live) >= 6
    r2 = np.asarray(ds.r2)
    assert (r2[live] <= 0).all()
    assert (pid[live] >= 0).all()
    # every particle id present exactly once
    assert len(np.unique(pid[pid >= 0])) == 300


def test_rebind_reports_failed_movers_in_sidecar_list():
    cfg = _cfg(cell_capacity=2)
    st = _overflow_scene(jax.random.PRNGKey(7), 300, cfg, crowd=8)
    ds = build_dense(st, cfg, 8, 2)
    ds2, n_mov, n_mis, mis = rebind(ds, cfg, 8, 2,
                                    default_mover_capacity(300))
    s_total = np.asarray(ds2.pid).shape[0]
    served = int((np.asarray(mis) < s_total).sum())
    assert served > 0
    # every listed row is misplaced in the new layout
    live = np.asarray(mis)[np.asarray(mis) < s_total]
    assert (np.asarray(ds2.r2)[live] <= 0).all()
    assert (np.asarray(ds2.pid)[live] >= 0).all()
    assert served <= int(n_mis)


def test_fresh_path_sidecar_exact_vs_allpairs():
    """pallas_celllist_forces (fresh per-step build) must serve capacity-
    overflow particles exactly via the sidecar — not drop them force-dead
    (round 4: mean-occupancy preset geometries overflow by design)."""
    from particle3d.ops.allpairs import allpairs_forces
    from particle3d.ops.pallas_celllist import pallas_celllist_forces

    cfg = _cfg(cell_capacity=4)
    st = _overflow_scene(jax.random.PRNGKey(8), 400, cfg, crowd=10)
    u, v = F.pair_features(st, cfg)
    got = pallas_celllist_forces(st.positions, u, v, cfg)
    ref = allpairs_forces(st.positions, u, v, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_fresh_path_sidecar_disabled_drops():
    """With overflow_capacity=0 the fresh path keeps its old semantics:
    overflow rows ride force-dead (callers watch the dropped count)."""
    from particle3d.ops.allpairs import allpairs_forces
    from particle3d.ops.pallas_celllist import pallas_celllist_forces

    cfg = _cfg(cell_capacity=4).replace(overflow_capacity=0)
    st = _overflow_scene(jax.random.PRNGKey(8), 400, cfg, crowd=10)
    u, v = F.pair_features(st, cfg)
    got = np.asarray(pallas_celllist_forces(st.positions, u, v, cfg))
    ref = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    assert np.abs(got - ref).max() > 1e-3  # the crowd's forces are missing


def test_cadenced_wrap_crosser_stays_exact():
    """Round-4 regression (column-level image scheme): a particle that
    wrap-crosses the box INSIDE a cadence window (stale layout) must keep
    exact near-boundary forces — fold_to_cells restores its cell-local
    image. Velocities push a boundary blob across z/x mid-window."""
    from particle3d import simulate
    from particle3d.engine.step import simulate_cadenced

    cfg = _cfg(cell_capacity=8)
    st = init_scene(jax.random.PRNGKey(9), 500, cfg)
    pos = np.asarray(st.positions).copy()
    vel = np.asarray(st.velocities).copy()
    # a tight pair straddling the +z face, moving so one crosses mid-window
    pos[0] = [0.3, 0.3, 7.95]
    pos[1] = [0.3, 0.3, 7.55]
    vel[0] = [0.0, 0.0, 1.5]  # 0.4 drift over the window < 0.5 budget
    vel[1] = [0.0, 0.0, 0.0]
    # and one straddling the +x face
    pos[2] = [7.95, -0.3, 0.3]
    pos[3] = [7.55, -0.3, 0.3]
    vel[2] = [1.5, 0.0, 0.0]
    st = st.replace(positions=jnp.asarray(pos), velocities=jnp.asarray(vel))
    dt = jnp.float32(1 / 30)
    out, drift, dropped = simulate_cadenced(st, cfg, dt, 8, rebuild_every=8)
    assert int(dropped) == 0
    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 8)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)

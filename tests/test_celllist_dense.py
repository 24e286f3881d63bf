"""Incremental dense cell layout (ops/celllist_dense.py, simulate_dense):
must be exactly equivalent to the per-step full-rebuild cell-list path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle3d import reference_config, init_scene, simulate
from particle3d.engine.step import simulate_dense, warmup
from particle3d.ops.celllist_dense import (
    build_dense, rebind, scatter_back, bin_sid, default_mover_capacity)


def _cfg(**kw):
    base = dict(neighbor="celllist_pallas", cell_grid=8, cell_capacity=32)
    base.update(kw)
    return reference_config(world_size=16.0).replace(**base)


def test_matches_per_step_rebuild_bitwise():
    cfg = _cfg()
    st = init_scene(jax.random.PRNGKey(0), 512, cfg)
    dt = jnp.float32(1 / 30)
    ref = simulate(st, cfg, dt, 12)  # full rebuild every step (exact)
    out, (mx_mov, mx_mis) = simulate_dense(st, cfg, dt, 12)
    assert int(mx_mis) == 0
    assert int(mx_mov) > 0  # the scene does produce supercell crossers
    np.testing.assert_array_equal(np.asarray(out.positions),
                                  np.asarray(ref.positions))
    np.testing.assert_array_equal(np.asarray(out.velocities),
                                  np.asarray(ref.velocities))


def test_matches_dense_allpairs():
    cfg = _cfg()
    st = init_scene(jax.random.PRNGKey(1), 300, cfg)
    dt = jnp.float32(1 / 30)
    out, _ = simulate_dense(st, cfg, dt, 10)
    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 10)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_velocity_verlet_path():
    cfg = _cfg(integrator="velocity_verlet")
    st = warmup(init_scene(jax.random.PRNGKey(2), 256, cfg), cfg)
    dt = jnp.float32(1 / 60)
    out, _ = simulate_dense(st, cfg, dt, 8)
    ref = simulate(st, cfg, dt, 8)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_walls_boundary():
    cfg = _cfg(boundary="clamp", wrap_forces=False)
    st = init_scene(jax.random.PRNGKey(3), 256, cfg)
    dt = jnp.float32(1 / 30)
    out, _ = simulate_dense(st, cfg, dt, 10)
    ref = simulate(st, cfg, dt, 10)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_tiny_mover_capacity_degrades_gracefully():
    """Movers beyond mcap are force-masked (ballistic), never wrong/NaN."""
    cfg = _cfg()
    st = init_scene(jax.random.PRNGKey(4), 512, cfg)
    dt = jnp.float32(1 / 10)  # big steps -> many movers
    out, (mx_mov, mx_mis) = simulate_dense(st, cfg, dt, 8, mcap=128)
    assert bool(np.isfinite(np.asarray(out.positions)).all())
    # and with ample capacity the same run reports no masking
    out2, (_, mis2) = simulate_dense(st, cfg, dt, 8)
    assert int(mis2) == 0


def test_capacity_overflow_masks_not_corrupts():
    """cap=1 forces cell overflow: run stays finite, misplaced reported."""
    cfg = _cfg(cell_capacity=2)
    st = init_scene(jax.random.PRNGKey(5), 1500, cfg)  # ~3 per cell >> cap
    dt = jnp.float32(1 / 30)
    out, (_, mx_mis) = simulate_dense(st, cfg, dt, 6)
    assert bool(np.isfinite(np.asarray(out.positions)).all())
    assert int(mx_mis) > 0


def test_no_particle_loss_under_capacity_pressure():
    """Regression: a mover that fails placement stays in its slot; that slot
    must never be handed to another mover (free slots = currently-empty
    only). Permanently-overloaded cells (cap=2, ~3 particles/cell) with big
    kicks exercised the loss."""
    cfg = _cfg(cell_capacity=2)
    st = init_scene(jax.random.PRNGKey(5), 1500, cfg)
    ds = build_dense(st, cfg, 8, 2)
    n0 = int((np.asarray(ds.pid) >= 0).sum())
    key = jax.random.PRNGKey(0)
    for _ in range(5):
        key, k = jax.random.split(key)
        kick = jax.random.uniform(k, ds.data[:, 0:3].shape,
                                  minval=-0.8, maxval=0.8)
        pos = ds.data[:, 0:3] + kick * (ds.pid >= 0)[:, None]
        pos = pos - 16.0 * jnp.floor(pos / 16.0 + 0.5)
        ds = ds.replace(data=ds.data.at[:, 0:3].set(pos))
        ds, _, _, _ = rebind(ds, cfg, 8, 2, default_mover_capacity(1500))
        pids = np.asarray(ds.pid)
        assert int((pids >= 0).sum()) == n0
        assert len(np.unique(pids[pids >= 0])) == n0


def test_rebind_preserves_particles_and_alignment():
    cfg = _cfg()
    st = init_scene(jax.random.PRNGKey(6), 256, cfg)
    ds = build_dense(st, cfg, 8, 32)
    # kick every particle by a random offset so many cross cells
    key = jax.random.PRNGKey(7)
    ds = ds.replace(data=ds.data.at[:, 0:3].add(
        jax.random.uniform(key, ds.data[:, 0:3].shape, minval=-1.5, maxval=1.5)
        * (ds.pid >= 0)[:, None]))
    # wrap back into the box like the boundary handler would
    w = 16.0
    pos = ds.data[:, 0:3]
    pos = pos - w * jnp.floor(pos / w + 0.5)
    ds = ds.replace(data=ds.data.at[:, 0:3].set(pos))
    ds2, n_mov, n_mis, _ = rebind(ds, cfg, 8, 32,
                                  default_mover_capacity(256))
    # every particle id survives exactly once
    pids = np.asarray(ds2.pid)
    live = np.sort(pids[pids >= 0])
    np.testing.assert_array_equal(live, np.arange(256))
    # every live slot with r2 > 0 is aligned with its occupant's cell
    aligned = np.asarray(bin_sid(ds2.data[:, 0:3], cfg, 8)) == (
        np.arange(pids.shape[0]) // 32)
    assert (np.asarray(ds2.r2)[~aligned] < 0).all()
    assert int(n_mis) == int(((pids >= 0) & ~aligned).sum())


def test_scatter_back_keeps_unplaced_particles():
    cfg = _cfg(cell_capacity=1)  # heavy initial overflow
    st = init_scene(jax.random.PRNGKey(8), 300, cfg)
    ds = build_dense(st, cfg, 8, 1)
    placed = np.asarray(ds.pid)
    placed = set(placed[placed >= 0].tolist())
    out = scatter_back(ds, st)
    pos0 = np.asarray(st.positions)
    pos1 = np.asarray(out.positions)
    for i in range(300):
        np.testing.assert_allclose(pos1[i], pos0[i], atol=1e-6)


def test_app_uses_dense_path_when_budget_zero():
    from particle3d.app.driver import SimulationApp

    cfg = reference_config(world_size=8.0).replace(
        neighbor="celllist_pallas", cell_grid=8, cell_capacity=16,
        particle_effect_radius=1.0)
    app = SimulationApp(cfg=cfg, n=128)
    assert app.drift_budget() <= 0.0
    app.run_steps(3)
    m = app.metrics()
    assert m["step_index"] == 3
    assert "capacity_masked" in m


def test_app_persists_dense_layout_across_ticks():
    """Two run_steps batches on the persisted layout == one simulate_dense
    of the total length (bit-equal: the layout is exactly fresh each step)."""
    from particle3d.app.driver import SimulationApp

    cfg = reference_config(world_size=8.0).replace(
        neighbor="celllist_pallas", cell_grid=8, cell_capacity=16,
        particle_effect_radius=1.0)
    st = init_scene(jax.random.PRNGKey(11), 256, cfg)
    app = SimulationApp(state=st, cfg=cfg)
    app.run_steps(3)
    assert app._dense is not None
    first = app._dense
    app.run_steps(2)
    assert app._dense is not first  # advanced, not rebuilt from scratch
    ref, _ = simulate_dense(st, cfg, jnp.float32(1 / 60), 5)
    np.testing.assert_array_equal(np.asarray(app.state.positions),
                                  np.asarray(ref.positions))
    # feature-changing controls invalidate the cached layout
    app.set_attraction(0, 1, -0.5)
    assert app._dense is None
    app.run_steps(1)  # rebuilds and keeps working
    assert app._dense is not None


def test_app_mode_alternation_no_stale_layout():
    """Regression: a cadenced-path window advances state outside the cached
    dense layout; a following dense-path window must not replay stale
    positions. Alternating n_steps=1 (dense) and n_steps=4 (cadenced, ample
    budget) flips modes every call."""
    from particle3d.app.driver import SimulationApp

    cfg = reference_config(world_size=16.0).replace(
        neighbor="celllist_pallas", cell_grid=8, cell_capacity=32)
    st = init_scene(jax.random.PRNGKey(13), 256, cfg)
    app = SimulationApp(state=st, cfg=cfg)
    assert app.drift_budget() > 0.0
    app.run_steps(1)   # dense path, caches layout
    app.run_steps(4)   # cadenced path -> must invalidate the cache
    assert app._dense is None
    app.run_steps(1)   # dense again, rebuilt from CURRENT state
    ref = st
    from particle3d import simulate
    ref = simulate(st, cfg, jnp.float32(1 / 60), 6)
    np.testing.assert_allclose(np.asarray(app.state.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_mover_fast_path_branches_agree():
    """The half-size mover pipeline (taken when movers <= mcap/2) must be
    bit-identical to the full-size pipeline on the same state."""
    cfg = _cfg(cell_capacity=8)
    st = init_scene(jax.random.PRNGKey(21), 3000, cfg)
    ds = build_dense(st, cfg, 8, 8)
    key = jax.random.PRNGKey(22)
    kick = jax.random.uniform(key, ds.data[:, 0:3].shape,
                              minval=-1.2, maxval=1.2)
    pos = ds.data[:, 0:3] + kick * (ds.pid >= 0)[:, None]
    pos = pos - 16.0 * jnp.floor(pos / 16.0 + 0.5)
    ds = ds.replace(data=ds.data.at[:, 0:3].set(pos))
    # mcap=8192 -> half=4096 >= movers (~1800): small branch
    a, n_mov_a, _, mis_a = rebind(ds, cfg, 8, 8, 8192)
    # mcap=2048 -> half=1024 < movers: big branch, same extracted prefix
    b, n_mov_b, _, mis_b = rebind(ds, cfg, 8, 8, 2048)
    assert int(n_mov_a) == int(n_mov_b)
    assert 1024 < int(n_mov_a) <= 2048  # big branch taken, nothing truncated
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
    np.testing.assert_array_equal(np.asarray(a.pid), np.asarray(b.pid))
    np.testing.assert_array_equal(np.asarray(mis_a), np.asarray(mis_b))


def test_stale_vacated_rows_never_read_back():
    """Vacated slots keep stale data rows by design; they must never leak
    into particle-order state or forces (pid/r2 make them dead)."""
    cfg = _cfg()
    st = init_scene(jax.random.PRNGKey(23), 400, cfg)
    dt = jnp.float32(1 / 30)
    out, _ = simulate_dense(st, cfg, dt, 8)
    ref = simulate(st, cfg, dt, 8)
    np.testing.assert_array_equal(np.asarray(out.positions),
                                  np.asarray(ref.positions))
    assert bool(np.isfinite(np.asarray(out.velocities)).all())


def test_build_overflow_served_by_sidecar_else_masked():
    """Particles the initial build cannot place in their cell (capacity
    overflow) are served EXACTLY by the overflow sidecar up to ocap — the
    window reads exact (masked 0) and matches all-pairs. With the sidecar
    disabled (ocap=0), the same overflow must surface in the masked
    diagnostic — a silently frozen particle must never read as exact."""
    cfg = _cfg(cell_capacity=2)
    st = init_scene(jax.random.PRNGKey(30), 64, cfg)
    # cram 8 particles into one cell: 6 overflow
    pos = np.asarray(st.positions).copy()
    pos[:8] = np.array([1.1, 1.1, 1.1], np.float32) + \
        np.arange(8, dtype=np.float32)[:, None] * 1e-3
    st = st.replace(positions=jnp.asarray(pos))
    out, (_, mis) = simulate_dense(st, cfg, jnp.float32(1 / 60), 1)
    assert int(mis) == 0
    ref = simulate(st, cfg.replace(neighbor="allpairs"), jnp.float32(1 / 60), 1)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-5, atol=1e-6)
    _, (_, mis0) = simulate_dense(st, cfg, jnp.float32(1 / 60), 1, ocap=0)
    assert int(mis0) >= 6


def test_adaptive_escalation_recovers_exactness():
    """A clustering scene overflows a small capacity; the adaptive driver
    must rewind, escalate, and end with a mask-free (exact) trajectory that
    matches the dense all-pairs reference."""
    from particle3d.engine.step import simulate_dense_adaptive

    # single species, strong self-attraction: collapses into blobs
    cfg = _cfg(cell_capacity=2).replace(
        interaction_force=4.0,
        attraction_matrix=np.ones((5, 5), np.float32) * 0.9)
    st = init_scene(jax.random.PRNGKey(31), 600, cfg)
    dt = jnp.float32(1 / 30)
    out, cap, hist = simulate_dense_adaptive(st, cfg, dt, 40, chunk=10, ocap=0)
    assert cap > 2  # escalated
    assert all(masked == 0 for _, _, masked in hist)
    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 40)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-3, atol=1e-4)


class _FakeClock:
    """Deterministic _timer injection: each call advances by the next
    scripted delta (seconds)."""

    def __init__(self, deltas):
        self.deltas = list(deltas)
        self.t = 0.0

    def __call__(self):
        self.t += self.deltas.pop(0) if self.deltas else 1.0
        return self.t


def test_adaptive_cost_probe_switches_to_culled():
    """Cost-aware ladder: when an escalated rung's wall time exceeds
    probe_factor x the cheapest rung, the driver probes the all-pairs backend
    with the next (committed) window and, if the probe is faster, serves
    the rest of the run with it. probe_factor=0 makes the first eligible
    rung window trigger; a strictly-DECREASING fake clock makes the probe
    read faster than the rung -> deterministic switch."""
    from particle3d.engine.step import simulate_dense_adaptive

    cfg = _cfg(cell_capacity=2).replace(
        interaction_force=4.0,
        attraction_matrix=np.ones((5, 5), np.float32) * 0.9)
    st = init_scene(jax.random.PRNGKey(31), 600, cfg)
    dt = jnp.float32(1 / 30)
    clock = _FakeClock([100.0 / (i + 1) for i in range(200)])
    msgs = []
    out, cap, hist = simulate_dense_adaptive(
        st, cfg, dt, 60, chunk=10, verbose=msgs.append,
        probe_factor=0.0, ocap=0, _timer=clock)
    backends = [c for _, c, _ in hist]
    assert any("probing the all-pairs backend" in m for m in msgs)
    assert any("switching to the all-pairs" in m for m in msgs)
    # sticky: after the switch every window is all-pairs
    i = backends.index("allpairs")
    assert all(b == "allpairs" for b in backends[i:])
    assert all(masked == 0 for _, _, masked in hist)
    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 60)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-3, atol=1e-4)


def test_adaptive_cost_probe_stays_when_rung_wins():
    """The reverse race: a strictly-INCREASING clock makes the probe read
    slower than the rung — the driver must NOT switch, and the rest of the
    run stays on the (exact) cell path."""
    from particle3d.engine.step import simulate_dense_adaptive

    cfg = _cfg(cell_capacity=2).replace(
        interaction_force=4.0,
        attraction_matrix=np.ones((5, 5), np.float32) * 0.9)
    st = init_scene(jax.random.PRNGKey(31), 600, cfg)
    dt = jnp.float32(1 / 30)
    clock = _FakeClock([float(i + 1) for i in range(200)])
    msgs = []
    out, cap, hist = simulate_dense_adaptive(
        st, cfg, dt, 60, chunk=10, verbose=msgs.append,
        probe_factor=0.0, ocap=0, _timer=clock)
    assert any("probing the all-pairs backend" in m for m in msgs)
    assert not any("switching to the all-pairs" in m for m in msgs)
    backends = [c for _, c, _ in hist]
    assert backends[-1] != "allpairs"  # ended back on the cell path
    assert all(masked == 0 for _, _, masked in hist)
    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 60)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-3, atol=1e-4)


def test_app_escalates_capacity_on_clustered_batch():
    from particle3d.app.driver import SimulationApp

    cfg = _cfg(cell_capacity=2).replace(
        interaction_force=4.0,
        attraction_matrix=np.ones((5, 5), np.float32) * 0.9)
    st = init_scene(jax.random.PRNGKey(32), 600, cfg)
    app = SimulationApp(state=st, cfg=cfg, update_rate=30.0)
    app.ocap = 0  # sidecar off: overflow must drive the escalation ladder
    for _ in range(40):
        app.run_steps(1)  # dense branch: exact, escalates on overflow
    m = app.metrics()
    assert m["cell_capacity"] > 2
    ref = simulate(st, cfg.replace(neighbor="allpairs"),
                   jnp.float32(1 / 30), 40)
    np.testing.assert_allclose(np.asarray(app.state.positions),
                               np.asarray(ref.positions),
                               rtol=1e-3, atol=1e-4)


def test_app_recovers_from_fallback_after_control_edit():
    """Fallback is not a one-way door: a scene-changing control flags the
    recovery probe, and when the base-geometry layout fits drop-free the
    app leaves the all-pairs fallback and resumes the cell path."""
    from particle3d.app.driver import SimulationApp

    cfg = _cfg()  # uniform scene, fits base capacity 32
    st = init_scene(jax.random.PRNGKey(40), 600, cfg)
    app = SimulationApp(state=st, cfg=cfg, update_rate=30.0)
    # simulate a past clustered phase whose ladder ended
    app._cell_fallback = True
    app._recheck = False
    app.set_attraction(0, 0, 0.0)  # control edit -> probe next batch
    app.run_steps(1)
    assert app._cell_fallback is False
    assert app._cap_escalated is None
    assert app.metrics()["cell_fallback"] is False


def test_app_fallback_recovery_is_throttled():
    """Without a control edit the probe only fires every 32nd degraded
    batch — never the per-tick O(N) pre-probe run_steps forswears."""
    from particle3d.app.driver import SimulationApp

    cfg = _cfg()
    st = init_scene(jax.random.PRNGKey(41), 600, cfg)
    app = SimulationApp(state=st, cfg=cfg, update_rate=30.0)
    app._cell_fallback = True
    app._recheck = False
    for _ in range(31):
        app.run_steps(1)
    assert app._cell_fallback is True  # probes only at the 32nd
    app.run_steps(1)
    assert app._cell_fallback is False


def test_app_stays_in_fallback_while_scene_still_clustered():
    """The probe must NOT reset when the base capacity still drops
    particles: a genuinely clustered scene stays on the exact fallback."""
    from particle3d.app.driver import SimulationApp

    cfg = _cfg(cell_capacity=2).replace(
        interaction_force=4.0,
        attraction_matrix=np.ones((5, 5), np.float32) * 0.9)
    st = init_scene(jax.random.PRNGKey(42), 600, cfg)
    app = SimulationApp(state=st, cfg=cfg, update_rate=30.0)
    app.ocap = 0  # sidecar off: overflow must drive the ladder/fallback
    app.max_cap = 3  # ladder ends immediately on overflow
    for _ in range(20):
        app.run_steps(1)
    assert app._cell_fallback is True
    app.set_interaction_force(4.0)  # control edit -> probe next batch
    app.run_steps(1)
    assert app._cell_fallback is True  # base cap=2 still overflows
    ref = simulate(st, cfg.replace(neighbor="allpairs"),
                   jnp.float32(1 / 30), 21)
    np.testing.assert_allclose(np.asarray(app.state.positions),
                               np.asarray(ref.positions),
                               rtol=1e-3, atol=1e-4)


def test_app_deescalates_capacity_when_scene_disperses():
    """A sticky escalated capacity also resets through the same probe:
    once the base geometry fits again, later batches run the cheap rung."""
    from particle3d.app.driver import SimulationApp

    cfg = _cfg()  # base capacity 32 fits this uniform scene
    st = init_scene(jax.random.PRNGKey(43), 600, cfg)
    app = SimulationApp(state=st, cfg=cfg, update_rate=30.0)
    app._cap_escalated = 64  # past clustered phase escalated the rung
    assert app.metrics()["cell_capacity"] == 64
    app.set_attraction(0, 0, 0.0)
    app.run_steps(1)
    assert app._cap_escalated is None
    assert app.metrics()["cell_capacity"] == 32


def test_escalate_cap_doubles_to_max_cap():
    """The ladder runs on occupancy alone: double, clip to max_cap, end."""
    from particle3d.engine.step import escalate_cap

    assert escalate_cap(2, 512) == 4
    assert escalate_cap(1, 512) == 2
    assert escalate_cap(300, 512) == 512
    assert escalate_cap(2, 3) == 3
    assert escalate_cap(512, 512) is None


def test_adaptive_falls_back_to_allpairs_when_ladder_ends():
    from particle3d.engine.step import simulate_dense_adaptive

    cfg = _cfg(cell_capacity=2).replace(
        interaction_force=4.0,
        attraction_matrix=np.ones((5, 5), np.float32) * 0.9)
    st = init_scene(jax.random.PRNGKey(33), 600, cfg)
    dt = jnp.float32(1 / 30)
    out, cap, hist = simulate_dense_adaptive(st, cfg, dt, 40, chunk=10,
                                             max_cap=3, ocap=0)
    assert any(c == "allpairs" for _, c, _ in hist)
    assert all(masked == 0 for _, _, masked in hist)
    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 40)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-3, atol=1e-4)


def test_adaptive_reprobes_cell_path_after_dispersal():
    """Bidirectional ladder: once on the all-pairs fallback, the
    driver re-probes the cell path every few windows; a dispersed scene
    that fits the capacity again (mask-free probe, faster wall time under
    the decreasing fake clock) re-enters the cell path — the engine-level
    mirror of the app's disperse recovery."""
    from particle3d.engine.step import simulate_dense_adaptive

    # zero forces: a crammed blob with strong outward velocities disperses
    # ballistically and deterministically
    cfg = _cfg(cell_capacity=2).replace(
        attraction_matrix=np.zeros((5, 5), np.float32))
    rng = np.random.default_rng(7)
    st = init_scene(jax.random.PRNGKey(34), 240, cfg)
    pos = np.asarray(st.positions).copy()
    vel = np.asarray(st.velocities).copy()
    crowd = 12
    dirs = rng.normal(size=(crowd, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pos[:crowd] = np.float32([1.0, 1.0, 1.0]) + dirs * 0.05
    vel[:crowd] = dirs * 8.0
    st = st.replace(positions=jnp.asarray(pos), velocities=jnp.asarray(vel))
    dt = jnp.float32(1 / 30)
    clock = _FakeClock([100.0 / (i + 1) for i in range(400)])
    msgs = []
    out, cap, hist = simulate_dense_adaptive(
        st, cfg, dt, 48, chunk=2, max_cap=4, ocap=0,
        verbose=msgs.append, _timer=clock)
    backends = [c for _, c, _ in hist]
    assert "allpairs" in backends          # the blob forced the fallback
    i = backends.index("allpairs")
    assert any(b != "allpairs" for b in backends[i:]), \
        f"never re-entered the cell path: {hist} / {msgs}"
    assert any("back on the cell path" in m for m in msgs)
    assert all(masked == 0 for _, _, masked in hist)
    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 48)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-3, atol=1e-4)

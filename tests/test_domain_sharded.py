"""State-sharded slab domain decomposition (parallel/domain_sharded.py):
sharded trajectory must match the single-device incremental dense path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from particle3d import reference_config, init_scene
from particle3d.engine.step import simulate_dense
from particle3d.parallel import make_mesh
from particle3d.parallel.domain_sharded import sharded_dense_simulate


def _scene(n=512, seed=0, **repl):
    kw = dict(neighbor="celllist_pallas", cell_grid=8, cell_capacity=32)
    kw.update(repl)
    cfg = reference_config(world_size=16.0).replace(**kw)
    st = init_scene(jax.random.PRNGKey(seed), n, cfg)
    return st, cfg


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_matches_single_device_dense(ndev):
    st, cfg = _scene()
    mesh = make_mesh(ndev)
    dt = jnp.float32(1 / 30)
    ref, _ = simulate_dense(st, cfg, dt, 10)
    out, (mx_mov, mx_mask, mx_limbo, lost, shipped) = sharded_dense_simulate(
        st, cfg, dt, 10, mesh)
    assert int(lost) == 0
    assert int(mx_limbo) == 0
    if ndev == 8:  # planes_local=1: every x-plane crossing changes device
        assert int(shipped) > 0  # migration across slabs actually happened
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.velocities),
                               np.asarray(ref.velocities),
                               rtol=1e-4, atol=2e-5)


def test_matches_dense_allpairs_ground_truth():
    st, cfg = _scene(n=300, seed=3)
    mesh = make_mesh(4)
    dt = jnp.float32(1 / 30)
    out, _ = sharded_dense_simulate(st, cfg, dt, 8, mesh)
    from particle3d import simulate

    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 8)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_particle_conservation_under_overflow():
    """Tight capacity: no particle may vanish — overflow goes to limbo."""
    st, cfg = _scene(n=1200, seed=5, cell_capacity=4)
    mesh = make_mesh(4)
    dt = jnp.float32(1 / 15)  # fast steps -> heavy migration
    out, (mx_mov, mx_mask, mx_limbo, lost, shipped) = sharded_dense_simulate(
        st, cfg, dt, 10, mesh)
    assert int(lost) == 0
    assert bool(np.isfinite(np.asarray(out.positions)).all())
    # positions remain inside the box (wrap boundary applied in-slab)
    assert float(np.abs(np.asarray(out.positions)).max()) <= 8.0 + 1e-5


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_slab_sidecar_serves_overflow_exactly(ndev):
    """ROADMAP item 20 (round 5): at a mean-hugging geometry that
    overflows cell capacity, the slab sidecar must serve every overflow
    row EXACTLY — zero unserved diagnostics, trajectory equal to the
    single-chip dense path (whose own sidecar is round-4-proven exact).
    This is the scenario whose divergence bench.py's round-4 gates
    tripped over (rel err 1.22e-03 = ~60 frozen rows). ndev=1 pins the
    self-ring term-C wrap (no payload exchange — halo window cells remap
    onto local planes; missing this lost wrap-seam reverse forces,
    caught by bench's compiled gate at (24,32), rel err 1.95e-04)."""
    st, cfg = _scene(n=1200, seed=5, cell_capacity=4)
    mesh = make_mesh(ndev)
    dt = jnp.float32(1 / 30)
    ref, (_, ms_dense) = simulate_dense(st, cfg, dt, 8)
    assert int(ms_dense) == 0
    out, (_, mask_s, limbo_s, lost, _) = sharded_dense_simulate(
        st, cfg, dt, 8, mesh)
    assert int(lost) == 0
    assert int(mask_s) == 0 and int(limbo_s) == 0  # everything served
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.velocities),
                               np.asarray(ref.velocities),
                               rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("wrap,ndev", [(True, 4), (False, 4), (True, 1)])
def test_slab_sidecar_overflow_straddles_boundary(wrap, ndev):
    """Overflow rows crammed into cells ON a slab-boundary plane (and, in
    the wrap case, ON the global wrap seam): their exact forces need
    halo-plane sources (term A), cross-slab mis<->mis pairs (term B via
    the worklist exchange), and reverse forces onto the neighbor's
    receivers (the neighbor's term C from the exchanged payload; at
    ndev=1 the self-ring wrap remap instead). Must match the single-chip
    dense path bit-tolerantly with zero unserved."""
    kw = {} if wrap else dict(boundary="clamp", wrap_forces=False)
    st, cfg = _scene(n=1024, seed=7, cell_capacity=4, **kw)
    mesh = make_mesh(ndev)
    # mesh 4 x grid 8 -> slab boundaries at x in {-8, -4, 0, 4} (planes
    # 0/2/4/6). Cram two blobs denser than cap=4 right ON boundaries:
    # one at x=0 (interior slab seam), one at x=-8 (the wrap seam).
    rng = np.random.default_rng(99)
    pos = np.asarray(st.positions).copy()
    for i, center in enumerate(([0.0, 1.0, 1.0], [-7.99, -1.0, 2.0])):
        dirs = rng.normal(size=(24, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        pos[24 * i:24 * (i + 1)] = np.float32(center) + dirs * 0.9
    pos = pos.clip(-7.999, 7.999)
    st = st.replace(positions=jnp.asarray(pos))
    dt = jnp.float32(1 / 30)
    ref, (_, ms_dense) = simulate_dense(st, cfg, dt, 8)
    assert int(ms_dense) == 0
    out, (_, mask_s, limbo_s, lost, shipped) = sharded_dense_simulate(
        st, cfg, dt, 8, mesh)
    assert int(lost) == 0
    assert int(mask_s) == 0 and int(limbo_s) == 0
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_overflow_policy_divergence_is_visible():
    """With the sidecar DISABLED (ocap=0 — the pre-round-5 slab policy),
    overflow waits frozen in limbo and the trajectory diverges from the
    sidecar-exact single-chip path; that divergence must be VISIBLE in
    the slab diagnostics, never silent. (Round 5 made the default-ocap
    slab path exact at these geometries — see
    test_slab_sidecar_serves_overflow_exactly — so this now pins the
    opt-out's loudness.)"""
    st, cfg = _scene(n=1200, seed=5, cell_capacity=4)
    mesh = make_mesh(4)
    dt = jnp.float32(1 / 30)
    _, (_, ms_dense) = simulate_dense(st, cfg, dt, 4)
    assert int(ms_dense) == 0  # sidecar keeps the single-chip path exact
    _, (_, mask_s, limbo_s, lost, _) = sharded_dense_simulate(
        st, cfg, dt, 4, mesh, ocap=0)
    assert int(lost) == 0
    assert int(mask_s) + int(limbo_s) > 0  # divergence is diagnosed, loud


def test_tight_mover_cap_masks_but_never_loses():
    """An undersized mover cap (bench tunes mcap to ~2.8x observed movers —
    docs/PERF.md "Slab carry at 2M") must degrade gracefully: surplus
    movers stay in their old slot as a REPORTED masked backlog and retry
    on later steps; nothing is ever lost."""
    st, cfg = _scene(n=1200, seed=9)
    mesh = make_mesh(4)
    dt = jnp.float32(1 / 15)  # fast steps -> many movers per step
    out, (mx_mov, mx_mask, mx_limbo, lost, shipped) = sharded_dense_simulate(
        st, cfg, dt, 10, mesh, mcap=4)
    assert int(lost) == 0
    assert int(mx_mov) > 4          # the cap genuinely overflowed...
    assert int(mx_mask) > 0         # ...and the backlog is reported
    assert bool(np.isfinite(np.asarray(out.positions)).all())


def test_halfsize_mover_fastpath_matches():
    """mcap=1024 enables the lax.cond half-size mover pipeline
    (half_m=512); a calm scene keeps every device's movers/crossers under
    the half bounds, so the HALF branch runs each step. It must be
    bit-equal to the cond-free pipeline traced at the same effective
    sizes (mcap=512), and match the single-device dense trajectory."""
    st, cfg = _scene()
    mesh = make_mesh(4)
    dt = jnp.float32(1 / 30)
    out, (mx_mov, mx_mask, mx_limbo, lost, _) = sharded_dense_simulate(
        st, cfg, dt, 10, mesh, mcap=1024, migcap=256)
    assert int(mx_mov) <= 512   # the half branch is the one that ran
    assert int(lost) == 0
    ref, _ = simulate_dense(st, cfg, dt, 10)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)
    base, _ = sharded_dense_simulate(st, cfg, dt, 10, mesh,
                                     mcap=512, migcap=256)
    np.testing.assert_array_equal(np.asarray(out.positions),
                                  np.asarray(base.positions))
    np.testing.assert_array_equal(np.asarray(out.velocities),
                                  np.asarray(base.velocities))


def test_fastpath_burst_takes_full_branch():
    """Engineered burst: every particle is given an x-velocity that moves
    it 2.4-3.8 world units per step — at cell width 2 every occupant
    changes cell (movers/device ~= occupants > half_m), and at slab width
    4 no hop skips a slab. The predicate must fail and route through the
    cond's FULL branch (the traced-but-cold path), exactly — verified
    against the brute-force ground truth."""
    st, cfg = _scene(n=4096, seed=11)
    dt = jnp.float32(1 / 30)
    k = jax.random.PRNGKey(42)
    mag = jax.random.uniform(k, (4096,), minval=2.4, maxval=3.8) / dt
    sgn = jnp.where(jax.random.bernoulli(jax.random.PRNGKey(43), 0.5,
                                         (4096,)), 1.0, -1.0)
    st = st.replace(velocities=jnp.stack(
        [mag * sgn, jnp.zeros(4096), jnp.zeros(4096)], axis=1))
    mesh = make_mesh(4)
    out, (mx_mov, mx_mask, mx_limbo, lost, shipped) = sharded_dense_simulate(
        st, cfg, dt, 4, mesh, mcap=1536)
    assert int(mx_mov) > 768    # exceeded half_m -> full branch ran
    assert int(mx_mask) == 0 and int(lost) == 0
    from particle3d import simulate

    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 4)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_multihop_migration_routes_fast_movers():
    """Ring-distance outbox routing (round 5): a particle hopping 2+ slabs
    in one step previously matched neither outbox direction and froze in
    its stale slot forever; now it ships one ring hop per step (through
    intermediate devices' limbo) toward the shorter direction and lands.
    Zero attraction matrix -> every particle is ballistic, so the slab
    trajectory must EQUAL the single-chip dense one (transport is pure
    bookkeeping), with the transit visible in the diagnostics and nothing
    lost."""
    zeros = np.zeros((5, 5), np.float32)
    st, cfg = _scene(n=512, seed=31, attraction_matrix=zeros,
                     coefficient=25.0)
    dt = jnp.float32(1 / 30)
    vel = np.zeros((512, 3), np.float32)
    vel[0, 0] = 900.0   # after drag: dx = +5 on step 1 (2-3 slabs at
    # width 2), +0.83 on step 2, ~0 after — one giant hop, then settle
    st = st.replace(velocities=jnp.asarray(vel))
    mesh = make_mesh(8)
    out, (mx_mov, mx_mask, mx_limbo, lost, shipped) = sharded_dense_simulate(
        st, cfg, dt, 8, mesh)
    assert int(lost) == 0
    assert int(shipped) >= 2            # the hop actually multi-shipped
    ref, _ = simulate_dense(st, cfg, dt, 8)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.velocities),
                               np.asarray(ref.velocities),
                               rtol=1e-5, atol=1e-6)


def test_rejects_indivisible_grid():
    st, cfg = _scene()
    mesh = make_mesh(4)
    with pytest.raises(ValueError, match="divide"):
        sharded_dense_simulate(
            st, cfg.replace(cell_grid=6), jnp.float32(0.01), 2, mesh)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_walled_box_slab_matches_dense(ndev):
    """Walls at any N on the slab path (reference supports walls at any
    scale, ``src/lib.rs:70-127``): a clamped, non-periodic config must run
    state-sharded and match the single-device dense trajectory — the two
    edge slabs kill their wraparound halo plane, y/z ghosts are dead."""
    st, cfg = _scene(seed=21, boundary="clamp", wrap_forces=False)
    mesh = make_mesh(ndev)
    dt = jnp.float32(1 / 30)
    ref, _ = simulate_dense(st, cfg, dt, 10)
    out, (mx_mov, mx_mask, mx_limbo, lost, shipped) = sharded_dense_simulate(
        st, cfg, dt, 10, mesh)
    assert int(lost) == 0
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)
    # particles stayed inside the walls on the sharded path
    assert float(np.abs(np.asarray(out.positions)).max()) <= 8.0 + 1e-5


def test_walled_slab_matches_brute_force():
    """Walled slab path vs the capacity-free brute-force ground truth."""
    st, cfg = _scene(n=300, seed=23, boundary="clamp", wrap_forces=False)
    mesh = make_mesh(4)
    dt = jnp.float32(1 / 30)
    out, _ = sharded_dense_simulate(st, cfg, dt, 8, mesh)
    from particle3d import simulate

    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 8)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_sharded_dense_adaptive_escalates_and_matches():
    """Tight initial capacity: the adaptive slab driver escalates with
    rewind (draining initial-build limbo up front), commits only
    trouble-free windows, and matches the single-device dense trajectory
    at the final capacity. ocap=0 pins the ladder machinery itself (with
    the default sidecar this scene is served exactly at cap=4 and never
    escalates — test_slab_sidecar_serves_overflow_exactly)."""
    from particle3d.parallel.domain_sharded import (
        build_sharded_dense, sharded_dense_adaptive, gather_sharded_dense)

    st, cfg = _scene(n=1200, seed=5, cell_capacity=4)
    mesh = make_mesh(4)
    dt = jnp.float32(1 / 30)
    msgs = []
    carry = build_sharded_dense(st, cfg, mesh)
    carry, cap, hist = sharded_dense_adaptive(
        carry, cfg, dt, 10, mesh, n=st.n, window=5, verbose=msgs.append,
        ocap=0)
    assert cap > 4                         # the ladder actually climbed
    assert all(t == 0 for _, _, t in hist)  # every committed window exact
    assert sum(k for k, _, _ in hist) == 10
    out = gather_sharded_dense(carry, st, mesh)
    ref, _ = simulate_dense(st, cfg.replace(cell_capacity=cap), dt, 10,
                            cap=cap)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_walled_config_on_ring_sharded():
    """Walls on the ring decomposition (the boundary-agnostic alternative
    to the walled slab path, USERGUIDE §6): a walled config must run
    sharded there and match the single-device trajectory."""
    from particle3d.parallel import shard_state, sharded_simulate
    from particle3d.engine.step import simulate

    cfg = reference_config(world_size=16.0).replace(
        boundary="clamp", wrap_forces=False)
    st = init_scene(jax.random.PRNGKey(77), 512, cfg)
    mesh = make_mesh(4)
    dt = jnp.float32(1 / 60)
    want = simulate(st, cfg, dt, 6)
    got = sharded_simulate(shard_state(st, mesh), cfg, dt, 6, mesh)
    np.testing.assert_allclose(np.asarray(got.positions),
                               np.asarray(want.positions),
                               rtol=1e-5, atol=1e-6)
    # particles stayed inside the walls on the sharded path
    assert float(np.abs(np.asarray(got.positions)).max()) <= 8.0 + 1e-5


def test_stay_sharded_carry_matches_single_call():
    """build + two step windows + gather == one sharded_dense_simulate call,
    with the carry actually sharded over the mesh axis."""
    from particle3d.parallel.domain_sharded import (
        build_sharded_dense, sharded_dense_steps, gather_sharded_dense)
    from jax.sharding import PartitionSpec as P

    st, cfg = _scene()
    mesh = make_mesh(4)
    dt = jnp.float32(1 / 30)
    want, _ = sharded_dense_simulate(st, cfg, dt, 10, mesh)

    carry = build_sharded_dense(st, cfg, mesh)
    data = carry[0]
    # the carry is genuinely state-sharded (O(N/D) rows per device)
    assert data.sharding.is_equivalent_to(
        jax.NamedSharding(mesh, P("shard")), data.ndim)
    # n= threads the true particle count so the mover pipeline's static
    # sizes match sharded_dense_simulate's (instead of the slot-count bound)
    carry, diag1 = sharded_dense_steps(carry, cfg, dt, 5, mesh, n=st.n)
    carry, diag2 = sharded_dense_steps(carry, cfg, dt, 5, mesh)
    assert int(diag1[3]) == 0 and int(diag2[3]) == 0  # lost
    out = gather_sharded_dense(carry, st, mesh)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(want.positions),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.velocities),
                               np.asarray(want.velocities),
                               rtol=1e-5, atol=1e-6)


def test_init_sharded_dense_no_replicated_stage():
    """Per-device scene init straight into the sharded carry: globally
    unique pids, every occupant in its own slab, steppable and gatherable."""
    from particle3d.parallel.domain_sharded import (
        init_sharded_dense, sharded_dense_steps, gather_sharded_dense)
    from particle3d.ops.celllist_dense import bin_sid
    from particle3d.state import ParticleState

    cfg = reference_config(world_size=16.0).replace(
        neighbor="celllist_pallas", cell_grid=8, cell_capacity=32)
    mesh = make_mesh(4)
    n = 512
    carry = init_sharded_dense(jax.random.PRNGKey(0), n, cfg, mesh)
    data, pid = np.asarray(carry[0]), np.asarray(carry[1])
    live = pid[pid >= 0]
    assert len(np.unique(live)) == len(live)
    assert int(carry[4]) + len(live) + int((np.asarray(carry[3]) >= 0).sum()) == n
    # occupants binned into the cell their slot belongs to
    cap = 32
    sids = np.asarray(bin_sid(jnp.asarray(data[:, 0:3]), cfg, 8))
    cells = np.arange(pid.shape[0]) // cap
    occ = pid >= 0
    assert (sids[occ] == cells[occ]).all()

    carry, diag = sharded_dense_steps(carry, cfg, jnp.float32(1 / 30), 5, mesh)
    assert int(diag[3]) == 0  # nothing lost
    base = ParticleState(
        positions=jnp.zeros((n, 3)), velocities=jnp.zeros((n, 3)),
        species=jnp.zeros((n,), jnp.int32), masses=jnp.ones((n,)),
        accel=jnp.zeros((n, 3)))
    out = gather_sharded_dense(carry, base, mesh)
    pos = np.asarray(out.positions)
    assert np.isfinite(pos).all()
    assert np.abs(pos).max() <= 8.0 + 1e-5
    # roughly uniform across slabs after init
    x = data[occ, 0]
    for s in range(4):
        frac = ((x >= -8 + 4 * s) & (x < -8 + 4 * (s + 1))).mean()
        assert 0.15 < frac < 0.35


def _blob_scene(n=768, crowd=60, seed=11, speed=0.0, **repl):
    """Uniform scene with `crowd` particles crammed into one cell — denser
    than small capacities; optional distinct outward velocities so the blob
    disperses deterministically."""
    st, cfg = _scene(n=n, seed=seed, **repl)
    rng = np.random.default_rng(123)
    pos = np.asarray(st.positions).copy()
    dirs = rng.normal(size=(crowd, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pos[:crowd] = np.float32([1.0, 1.0, 1.0]) + dirs * 0.05
    st = st.replace(positions=jnp.asarray(pos))
    if speed:
        vel = np.asarray(st.velocities).copy()
        vel[:crowd] = dirs * speed
        st = st.replace(velocities=jnp.asarray(vel))
    return st, cfg


def test_sharded_exact_steps_matches_allpairs_then_relayout_reenters():
    """The de-replicated exact rung (round 5): a compacted ring all-pairs
    window on the stay-sharded carry must match the brute-force ground
    truth; relayout passes then repair the drifted layout (pure transport)
    so the grid path continues bit-tolerantly."""
    from particle3d import simulate
    from particle3d.parallel.domain_sharded import (
        build_sharded_dense, sharded_exact_steps, sharded_relayout,
        sharded_dense_steps, gather_sharded_dense)

    st, cfg = _scene(n=512, seed=2)
    mesh = make_mesh(4)
    dt = jnp.float32(1 / 30)
    carry = build_sharded_dense(st, cfg, mesh)
    carry, ovf = sharded_exact_steps(carry, cfg, dt, 6, mesh, rcap=512)
    assert int(ovf) == 0
    out = gather_sharded_dense(carry, st, mesh)
    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 6)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)
    # transport-only relayout: positions/velocities must be UNTOUCHED
    pos_before = np.asarray(gather_sharded_dense(carry, st, mesh).positions)
    carry, (serv, unserv, lost) = sharded_relayout(carry, cfg, mesh,
                                                   passes=3, n=st.n)
    assert int(unserv) == 0 and int(lost) == 0
    after = gather_sharded_dense(carry, st, mesh)
    np.testing.assert_array_equal(np.asarray(after.positions), pos_before)
    # the repaired carry continues on the grid path, still exact
    carry, diag = sharded_dense_steps(carry, cfg, dt, 4, mesh, n=st.n)
    assert int(diag[1]) == 0 and int(diag[2]) == 0 and int(diag[3]) == 0
    out2 = gather_sharded_dense(carry, st, mesh)
    ref2 = simulate(st, cfg.replace(neighbor="allpairs"), dt, 10)
    np.testing.assert_allclose(np.asarray(out2.positions),
                               np.asarray(ref2.positions),
                               rtol=1e-4, atol=1e-5)


def test_sharded_exact_rung_is_onl_over_d():
    """VERDICT r4 item 2's done bar: the exact rung's program must be
    O(N/D) — ring ppermutes, NO all_gather of state anywhere in the
    jaxpr (the round-4 rung gathered the full state to every device)."""
    from particle3d.parallel.domain_sharded import (
        build_sharded_dense, sharded_exact_steps)

    st, cfg = _scene()
    mesh = make_mesh(8)
    carry = build_sharded_dense(st, cfg, mesh)
    jaxpr = str(jax.make_jaxpr(
        lambda c: sharded_exact_steps(c, cfg, jnp.float32(1 / 30), 2,
                                      mesh, rcap=256))(carry))
    assert "ppermute" in jaxpr
    assert "all_gather" not in jaxpr


def test_sharded_ladder_end_exact_terminal_rung():
    """VERDICT r3 item 2: a blob denser than every feasible capacity must
    NOT commit force-frozen windows — the default terminal rung gathers and
    serves the window on the capacity-free exact backend, matching the
    single-device adaptive driver's trajectory."""
    from particle3d.engine.step import simulate_dense_adaptive
    from particle3d.parallel.domain_sharded import (
        build_sharded_dense, sharded_dense_adaptive, gather_sharded_dense)

    st, cfg = _blob_scene(cell_capacity=4)
    mesh = make_mesh(8)
    dt = jnp.float32(1 / 30)
    msgs = []
    carry = build_sharded_dense(st, cfg, mesh)
    carry, cap, hist = sharded_dense_adaptive(
        carry, cfg, dt, 12, mesh, n=st.n, window=4, max_cap=8,
        state=st, verbose=msgs.append, ocap=0)
    assert all(t == 0 for _, _, t in hist)      # nothing committed inexact
    assert any(c == "exact" for _, c, _ in hist)  # the rung actually fired
    assert sum(k for k, _, _ in hist) == 12
    out = gather_sharded_dense(carry, st, mesh)
    ref, _, rhist = simulate_dense_adaptive(st, cfg, dt, 12, chunk=4,
                                            max_cap=8)
    assert all(t == 0 for _, _, t in rhist)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


def test_sharded_exact_rung_reenters_slab_after_dispersal():
    """The exact rung re-probes the slab path each window: once the blob
    disperses below the capacity, the driver re-enters sharded mode (later
    history windows carry a numeric cap again)."""
    from particle3d.parallel.domain_sharded import (
        build_sharded_dense, sharded_dense_adaptive, gather_sharded_dense)
    from particle3d import simulate

    zeros = np.zeros((5, 5), np.float32)
    st, cfg = _blob_scene(n=288, crowd=24, cell_capacity=8, speed=8.0)
    cfg = cfg.replace(attraction_matrix=zeros)
    mesh = make_mesh(4)
    dt = jnp.float32(1 / 30)
    msgs = []
    carry = build_sharded_dense(st, cfg, mesh)
    carry, cap, hist = sharded_dense_adaptive(
        carry, cfg, dt, 24, mesh, n=st.n, window=4, max_cap=8,
        state=st, verbose=msgs.append, ocap=0)
    assert all(t == 0 for _, _, t in hist)
    assert hist[0][1] == "exact"                # started on the rung
    assert any(c != "exact" for _, c, _ in hist), \
        f"never re-entered the slab path: {hist} / {msgs}"
    out = gather_sharded_dense(carry, st, mesh)
    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 24)
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("integrator", ["velocity_verlet", "leapfrog"])
def test_slab_sidecar_midstep_fresh_non_euler(integrator):
    """Non-Euler integrators re-evaluate forces at MID-STEP positions;
    the sidecar's limbo worklist rows must read those fresh positions,
    not the pre-step carry (regression: accel_fn passed only the slot
    half of ``positions`` into ``sidecar_terms``, whose limbo entries
    then came from the closed-over pre-step ``limbo_data`` — leapfrog
    diverged from all-pairs by 1.56e-03 while the served/unserved
    diagnostics claimed fully exact)."""
    st, cfg = _scene(n=1200, seed=5, cell_capacity=4, integrator=integrator)
    mesh = make_mesh(4)
    dt = jnp.float32(1 / 30)
    from particle3d import simulate

    ref = simulate(st, cfg.replace(neighbor="allpairs"), dt, 8)
    out, (_, mask_s, limbo_s, lost, _) = sharded_dense_simulate(
        st, cfg, dt, 8, mesh)
    assert int(lost) == 0
    assert int(mask_s) == 0 and int(limbo_s) == 0  # everything served
    np.testing.assert_allclose(np.asarray(out.positions),
                               np.asarray(ref.positions),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.velocities),
                               np.asarray(ref.velocities),
                               rtol=1e-4, atol=2e-5)


def test_relayout_guard_never_loses_rows():
    """Exact windows can park hundreds of rows far from their slabs; a
    relayout whose multi-hop transit bursts the limbo capacity drops rows
    permanently (regression: the driver discarded sharded_relayout's
    ``lost`` diagnostic and re-entered the grid path as if repair
    succeeded — 385 of 400 drifted rows silently vanished). The guarded
    repair must rewind, grow limbocap, and deliver every row."""
    from particle3d.parallel.domain_sharded import (
        build_sharded_dense, gather_sharded_dense, sharded_relayout,
        _relayout_guarded)

    st, cfg = _scene(n=2048, seed=7)
    mesh = make_mesh(4)
    nsc, cap = cfg.cell_grid, cfg.cell_capacity
    carry = build_sharded_dense(st, cfg, mesh, limbocap=64)
    data, pid, ld, lp, lost0 = carry
    assert int(lost0) == 0

    # drift 400 live rows from slabs 1-3 into ONE slab-0 cell (a dense
    # blob parked far from home — what a ladder-end exact window can
    # produce): the arrivals overflow the cell into limbo, and limbo
    # bursts past limbocap=64
    d_np = np.asarray(data).copy()
    pid_np = np.asarray(pid)
    s_loc = pid_np.shape[0] // 4
    cand = np.where((pid_np >= 0) & (np.arange(pid_np.shape[0]) >= s_loc))[0]
    drift = cand[:400]
    d_np[drift, 0:3] = np.float32([-7.0, 0.3, 0.3])
    d_np[drift, 0] += np.linspace(0, 0.5, drift.size, dtype=np.float32)
    carry = (jnp.asarray(d_np), pid, ld, lp, lost0)

    live_before = int((pid_np >= 0).sum()) + int((np.asarray(lp) >= 0).sum())
    # the unguarded relayout at this limbocap demonstrably loses rows —
    # the hazard the guard exists for (if this stops tripping, shrink
    # limbocap or grow the drift so the guard test stays meaningful)
    _, (_, _, lost_raw) = sharded_relayout(
        carry, cfg, mesh, passes=3, nsc=nsc, cap=cap, n=st.n, ocap=128)
    assert int(lost_raw) > 0

    fixed, servable, unserv = _relayout_guarded(
        carry, cfg, mesh, nsc=nsc, cap=cap, mcap=None, ocap=128, n=st.n)
    _, pid2, _, lp2, lost2 = fixed
    assert int(lost2) == 0
    live_after = int((np.asarray(pid2) >= 0).sum()) \
        + int((np.asarray(lp2) >= 0).sum())
    assert live_after == live_before
    assert int(unserv) == 0  # every drifted row reached slab 0

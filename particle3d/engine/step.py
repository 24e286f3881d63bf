"""Fused simulation step and on-device trajectories.

``step`` fuses force accumulation -> integration -> boundary into one traced
program; ``simulate``/``trajectory`` roll it under ``jax.lax.scan`` so whole
trajectories stay on device (host sees only the snapshots it asks for).

The Euler path reproduces the reference update order *exactly*
(``src/lib.rs:245-264``):

    1. v += force_sum * interaction_force * effect_radius * dt
    2. v += gravity * dt
    3. dv = v * coefficient * dt;  v <- 0 if |dv|^2 > |v|^2 else v - dv
       (the stop-at-zero drag branch; elementwise it reduces to
        "zero v iff coefficient*dt > 1", since |dv| = c*dt*|v|)
    4. x += v * dt
    5. boundary handling

The reference's double-buffered Jacobi update (swap + snapshot read,
``src/lib.rs:167-171``) is implicit: forces are computed from the input
state, the new state is a fresh pytree.
"""

from __future__ import annotations

import functools
import time
from typing import Any

import jax
import jax.numpy as jnp

from ..config import SimConfig
from ..state import ParticleState
from ..ops import forces as F
from ..ops.allpairs import allpairs_forces
from .boundaries import apply_boundary


def pair_accel(positions, state: ParticleState, cfg: SimConfig):
    """Pairwise-interaction acceleration at given positions, dispatched on
    cfg.neighbor. (positions may differ from state.positions mid-integrator.)"""
    u, v = F.pair_features(state, cfg)
    if cfg.neighbor == "allpairs":
        f = allpairs_forces(positions, u, v, cfg)
    elif cfg.neighbor == "allpairs_pallas":
        from ..ops.pallas_allpairs import pallas_allpairs_forces

        f = pallas_allpairs_forces(positions, u, v, cfg)
    elif cfg.neighbor == "celllist":
        from ..ops.celllist import celllist_forces

        f = celllist_forces(positions, u, v, cfg)
    elif cfg.neighbor == "celllist_pallas":
        from ..ops.pallas_celllist import pallas_celllist_forces

        f = pallas_celllist_forces(positions, u, v, cfg)
    else:
        raise ValueError(f"unknown neighbor backend {cfg.neighbor!r}")
    return f * F.kick_scale(cfg)


def _drag(v, cfg: SimConfig, dt):
    """Reference drag with stop-at-zero (src/lib.rs:252-259).

    The reference tests |v*c*dt|^2 > |v|^2, i.e. (c*dt)^2 > 1 — the absolute
    value matters for (unclamped) negative coefficients, where c*dt < -1 must
    also stop the particle rather than amplify it."""
    c = cfg.coefficient * dt
    return jnp.where(jnp.abs(c) > 1.0, jnp.zeros_like(v), v - v * c)


def _step_euler(state: ParticleState, cfg: SimConfig, dt, accel_fn) -> ParticleState:
    a = accel_fn(state.positions, state, cfg)
    v = state.velocities + a * dt
    v = v + jnp.asarray(cfg.acceleration, v.dtype) * dt
    v = _drag(v, cfg, dt)
    x = state.positions + v * dt
    x, v = apply_boundary(x, v, cfg)
    return state.replace(positions=x, velocities=v)


def _total_accel(positions, state, cfg, accel_fn):
    return accel_fn(positions, state, cfg) + jnp.asarray(cfg.acceleration, positions.dtype)


def _step_velocity_verlet(state: ParticleState, cfg: SimConfig, dt, accel_fn) -> ParticleState:
    """Velocity Verlet: x += v dt + a dt^2/2; v += (a + a') dt/2.

    Uses the cached acceleration in state.accel (zero on the first step —
    equivalent to a half-order startup, standard practice). Drag is applied
    after the velocity update with the same stop-at-zero rule.
    """
    a0 = state.accel
    v = state.velocities
    x = state.positions + v * dt + 0.5 * a0 * dt * dt
    x, v = apply_boundary(x, v, cfg)
    a1 = _total_accel(x, state, cfg, accel_fn)
    v = v + 0.5 * (a0 + a1) * dt
    v = _drag(v, cfg, dt)
    return state.replace(positions=x, velocities=v, accel=a1)


def _step_leapfrog(state: ParticleState, cfg: SimConfig, dt, accel_fn) -> ParticleState:
    """Kick-drift-kick leapfrog with cached acceleration."""
    a0 = state.accel
    v_half = state.velocities + 0.5 * a0 * dt
    x = state.positions + v_half * dt
    x, v_half = apply_boundary(x, v_half, cfg)
    a1 = _total_accel(x, state, cfg, accel_fn)
    v = v_half + 0.5 * a1 * dt
    v = _drag(v, cfg, dt)
    return state.replace(positions=x, velocities=v, accel=a1)


def warmup(state: ParticleState, cfg: SimConfig) -> ParticleState:
    """Populate the cached acceleration (velocity_verlet / leapfrog start)."""
    if cfg.integrator == "euler":
        return state
    return state.replace(accel=_total_accel(state.positions, state, cfg, pair_accel))


def step(state: ParticleState, cfg: SimConfig, dt,
         accel_fn=None) -> ParticleState:
    """One simulation step (pure function; jit/scan/shard_map friendly).

    ``accel_fn(positions, state, cfg)`` overrides the pairwise-force backend
    (the ring-sharded path injects its collective sweep here).
    """
    accel_fn = accel_fn or pair_accel
    if cfg.integrator == "euler":
        return _step_euler(state, cfg, dt, accel_fn)
    if cfg.integrator == "velocity_verlet":
        return _step_velocity_verlet(state, cfg, dt, accel_fn)
    if cfg.integrator == "leapfrog":
        return _step_leapfrog(state, cfg, dt, accel_fn)
    raise ValueError(f"unknown integrator {cfg.integrator!r}")


@functools.partial(jax.jit, static_argnames=("num_steps",))
def simulate(state: ParticleState, cfg: SimConfig, dt, num_steps: int) -> ParticleState:
    """Run ``num_steps`` steps fully on device under lax.scan."""
    def body(s, _):
        return step(s, cfg, dt), None

    state, _ = jax.lax.scan(body, state, None, length=num_steps)
    return state


@functools.partial(jax.jit, static_argnames=("num_steps", "snapshot_every"))
def trajectory(state: ParticleState, cfg: SimConfig, dt, num_steps: int,
               snapshot_every: int = 1):
    """Run the trajectory on device, emitting position snapshots every
    ``snapshot_every`` steps: returns (final_state, positions[S, N, 3]).

    When ``num_steps`` is not a multiple of ``snapshot_every`` the trailing
    partial window still runs and emits one final snapshot (so S =
    ceil(num_steps / snapshot_every) and the last snapshot is always the
    final state — same remainder-window treatment as ``simulate_cadenced``).

    This is the batched device->host snapshot path from the north star — the
    inner loop never leaves the device; the host reads back one stacked array.
    """
    outer = num_steps // snapshot_every
    rem = num_steps % snapshot_every

    def window(s, k):
        s2 = jax.lax.fori_loop(0, k, lambda _, ss: step(ss, cfg, dt), s)
        return s2, s2.positions

    snaps = jnp.zeros((0,) + state.positions.shape, state.positions.dtype)
    if outer:
        state, snaps = jax.lax.scan(
            lambda s, _: window(s, snapshot_every), state, None, length=outer)
    if rem:
        state, last = window(state, rem)
        snaps = jnp.concatenate([snaps, last[None]], axis=0)
    return state, snaps


@functools.partial(jax.jit, static_argnames=("num_steps", "nsc", "cap",
                                             "mcap", "ocap"))
def simulate_dense(state: ParticleState, cfg: SimConfig, dt, num_steps: int,
                   nsc: int | None = None, cap: int | None = None,
                   mcap: int | None = None, ocap: int | None = None):
    """Exact cell-list trajectory on the incrementally-maintained dense
    layout (``ops.celllist_dense``): the state lives in slot order for the
    whole run, and after every step only supercell-boundary crossers are
    reassigned — no per-step sort, gather or scatter of the full state. The
    layout is fresh after every step, so no drift budget applies (unlike
    ``simulate_cadenced``); this is the fast EXACT path for drift-heavy
    scenes like the 262k particle-life production config.

    With non-Euler integrators the mid-step force evaluation reuses the
    layout built at the pre-drift positions (one step of staleness — exact
    while per-step drift stays under ``drift_budget``; Euler is always
    exact).

    Returns ``(final_state, (max_movers, max_masked))``: the per-step
    maxima of supercell crossers and of particles that were temporarily
    force-FROZEN (0 for an exact run). Capacity-overflow particles up to
    ``ocap`` (default ``celllist_dense.OCAP``) are NOT masked: the overflow
    sidecar (ops/overflow.py) serves them exactly, so low-capacity
    geometries tuned to the mean occupancy stay exact; only overflow beyond
    ocap (or movers beyond mcap) freezes and counts.
    """
    from ..ops.celllist_dense import OCAP, build_dense, scatter_back, \
        default_mover_capacity

    if nsc is None:
        nsc = cfg.cell_grid
    if cap is None:
        cap = cfg.cell_capacity
    assert nsc is not None and cap is not None, \
        "simulate_dense needs cfg.cell_grid / cfg.cell_capacity"
    if mcap is None:
        mcap = default_mover_capacity(state.n)
    if ocap is None:
        ocap = OCAP if cfg.overflow_capacity is None else cfg.overflow_capacity

    ds0 = build_dense(state, cfg, nsc, cap, ocap)
    # particles the initial build could not place (cell over capacity AND
    # the ocap sidecar budget exhausted at window start) are FROZEN for the
    # whole window — they must count as masked or callers (bench, the
    # adaptive escalation driver) would read a silently-degraded window as
    # exact
    n_dropped = state.n - jnp.sum((ds0.pid >= 0).astype(jnp.int32))
    ds, (mx_mov, mx_mis) = _dense_scan(ds0, cfg, dt, num_steps, nsc, cap,
                                       mcap, state.species.dtype,
                                       state.masses.dtype, ocap=ocap)
    return scatter_back(ds, state), (mx_mov, jnp.maximum(mx_mis, n_dropped))


def _sidecar_apply(f, positions, ds, mis_idx, cfg, valid, nsc, cap):
    """Add the overflow sidecar's exact forces (ops/overflow.py): forces ON
    the misplaced rows (scattered into their — currently zeroed — slots) and
    forces FROM them onto aligned receivers. Uses the O(M * 27 * cap)
    neighborhood sweep (slot-count-independent) when the grid admits it,
    the O(M * S) rectangular sweep otherwise.

    STRAIGHT-LINE by design: a live-count ``lax.cond`` tiering (skip /
    64-wide / full) blocks XLA fusion around the kernel output. Dead
    worklist entries contribute exact zeros, so no-overflow steps just pay
    the sweep."""
    from ..ops.overflow import neighborhood_apply, sidecar_sweeps

    s_total = ds.pid.shape[0]
    if nsc >= 3:
        return neighborhood_apply(f, positions, ds.u, ds.v, ds.r2 > 0.0,
                                  mis_idx, cfg, nsc, cap)
    mvalid = mis_idx < s_total
    msafe = jnp.minimum(mis_idx, s_total - 1)
    f_mis, f_from = sidecar_sweeps(
        positions, ds.u, ds.v, ds.pid >= 0,
        positions[msafe], ds.u[msafe], ds.v[msafe], mvalid, cfg)
    return (f + f_from * valid).at[mis_idx].add(f_mis, mode="drop")


def _dense_scan(ds0, cfg: SimConfig, dt, num_steps: int, nsc: int, cap: int,
                mcap: int, species_dtype=jnp.int32, masses_dtype=jnp.float32,
                ocap: int | None = None, mis0=None):
    """num_steps of step+incremental-rebind on an existing dense layout.

    With ``ocap`` (default ``celllist_dense.OCAP``), misplaced rows are
    force-exact via the overflow sidecar; the returned max-"masked" counts
    only FROZEN rows (misplaced beyond ocap / movers beyond mcap)."""
    from ..ops.celllist_dense import (
        OCAP, rebind, dense_forces_fresh, sidecar_indices)
    from ..ops import forces as FF

    if ocap is None:
        ocap = OCAP if cfg.overflow_capacity is None else cfg.overflow_capacity
    s_total = ds0.pid.shape[0]
    dummy_species = jnp.zeros((s_total,), species_dtype)
    dummy_masses = jnp.zeros((s_total,), masses_dtype)
    if ocap and mis0 is None:
        mis0 = sidecar_indices(ds0, ocap)
    elif not ocap:
        mis0 = jnp.zeros((0,), jnp.int32)

    def body(carry, _):
        ds, mis, mx_mov, mx_mis = carry

        def accel_fn(positions, st, c):
            f = dense_forces_fresh(positions, ds, c, nsc, cap)
            valid = (ds.r2 > 0.0).astype(f.dtype)[:, None]
            f = f * valid
            if ocap:
                f = _sidecar_apply(f, positions, ds, mis, c, valid, nsc, cap)
            return f * FF.kick_scale(c)

        ps = ParticleState(positions=ds.pos, velocities=ds.vel,
                           species=dummy_species, masses=dummy_masses,
                           accel=ds.acc)
        ps = step(ps, cfg, dt, accel_fn=accel_fn)
        ds = ds.replace(data=jnp.concatenate(
            [ps.positions, ps.velocities, ps.accel], axis=1))
        ds, n_mov, n_mis, mis = rebind(ds, cfg, nsc, cap, mcap, ocap)
        if ocap:
            n_mis = n_mis - jnp.sum((mis < s_total).astype(jnp.int32))
        return (ds, mis, jnp.maximum(mx_mov, n_mov),
                jnp.maximum(mx_mis, n_mis)), None

    (ds, _, mx_mov, mx_mis), _ = jax.lax.scan(
        body, (ds0, mis0, jnp.int32(0), jnp.int32(0)), None, length=num_steps)
    return ds, (mx_mov, mx_mis)


def escalate_cap(cap: int, max_cap: int) -> int | None:
    """Next rung of the capacity-escalation ladder: double the capacity,
    capped at ``max_cap``; None when the ladder ends (callers then fall back
    to the capacity-free all-pairs backend). The column kernel runs at any
    capacity, so occupancy alone drives the ladder."""
    if cap >= max_cap:
        return None
    return min(max(cap + 1, 2 * cap), max_cap)


# Backend of the ladder's terminal rung: capacity-free and exact.
FALLBACK_NEIGHBOR = "allpairs_pallas"


def simulate_dense_adaptive(state: ParticleState, cfg: SimConfig, dt,
                            num_steps: int, chunk: int = 64,
                            nsc: int | None = None, cap: int | None = None,
                            max_cap: int = 512, verbose=None,
                            probe_factor: float = 3.0,
                            ocap: int | None = None,
                            _timer=time.perf_counter):
    """Long-horizon EXACT cell-list driver with capacity escalation.

    A fixed ``cell_capacity`` is only exact while no cell exceeds it — and
    clustering dynamics (the particle-life steady state collapses into
    dense blobs) blow past any capacity chosen from the uniform initial
    state. Static XLA shapes cannot grow mid-program, so this host-side
    driver runs ``chunk``-step windows and, whenever a window reports
    capacity masking, REWINDS it and re-runs from the pre-window state at
    the next capacity (``escalate_cap``) — one recompile per escalation,
    after which the run proceeds at full speed with the larger layout.
    Every committed window is mask-free, so the whole trajectory is exact
    (same guarantee as per-step rebuilds): a window still masking at
    ``max_cap`` is NEVER committed — it is rewound and re-run on the
    capacity-free all-pairs backend (``FALLBACK_NEIGHBOR``; the physics in
    a blob denser than max_cap per cell is genuinely O(occupancy^2) — cost
    no layout can avoid, so brute force is the honest price).

    The ladder is also COST-AWARE: deep rungs can lose to the all-pairs
    sweep exactly where they become necessary, while dense-UNIFORM scenes
    favor them. Since both are exact, the driver resolves this empirically:
    every committed window is wall-timed, and when a window at an escalated
    capacity runs slower than ``probe_factor`` x the cheapest committed
    window, the next window runs on the all-pairs backend as a PROBE
    (committed too — no wasted compute); the faster backend then serves the
    run. The switch is BIDIRECTIONAL: while on the all-pairs backend, every
    8th window re-probes the cell path at the last working capacity; a
    mask-free, faster probe window switches back, so a scene that clusters
    then disperses is never stuck on the slower backend (the engine-level
    mirror of the app's disperse recovery, app/driver.py).

    Returns ``(state, cap, history)`` where history lists
    ``(steps, cap_or_backend, masked)`` per committed window (``cap`` is
    the string ``"allpairs"`` for fallback windows, always mask-free).
    """
    if nsc is None:
        nsc = cfg.cell_grid
    if cap is None:
        cap = cfg.cell_capacity
    assert nsc is not None and cap is not None, \
        "simulate_dense_adaptive needs cfg.cell_grid / cfg.cell_capacity"
    cfg_fb = cfg.replace(neighbor=FALLBACK_NEIGHBOR)
    cap0 = cap
    fallback = False
    done = 0
    history = []
    best_rung_sec = None   # cheapest committed cell-window sec/step
    probe_pending = False  # next window should try the all-pairs backend
    rung_sec = None        # sec/step of the window that triggered the probe
    seen_caps = set()      # caps whose compile has been paid
    probed_caps = set()    # rungs already raced against the all-pairs sweep
    fb_sec = None          # latest steady (non-first) all-pairs sec/step
    fb_seen = False        # first all-pairs window pays its compile
    fb_since_probe = 0     # all-pairs windows since the last cell re-probe
    reprobe_every = 8
    while done < num_steps:
        k = min(chunk, num_steps - done)
        if fallback or probe_pending:
            # bidirectional ladder: every reprobe_every all-pairs windows,
            # one window runs on the cell path at the last capacity.
            # Mask-free and faster -> switch back; masked -> rewound;
            # slower -> committed, nothing is wasted.
            if fallback and not probe_pending and \
                    fb_since_probe >= reprobe_every:
                fb_since_probe = 0
                t0 = _timer()
                outp, (_, misp) = simulate_dense(
                    state, cfg.replace(cell_capacity=cap), dt, k,
                    nsc=nsc, cap=cap, ocap=ocap)
                if int(misp) == 0:
                    secp = (_timer() - t0) / k
                    state = outp
                    done += k
                    history.append((k, cap, 0))
                    if fb_sec is not None and secp < fb_sec:
                        fallback = False
                        probed_caps.discard(cap)
                        if verbose:
                            verbose(f"[adaptive] cell re-probe cap={cap} "
                                    f"{secp*1e3:.0f} ms/step beats all-pairs "
                                    f"({fb_sec*1e3:.0f}) — back on the "
                                    f"cell path")
                    elif verbose:
                        verbose(f"[adaptive] cell re-probe cap={cap} "
                                f"{secp*1e3:.0f} ms/step loses to all-pairs "
                                f"({(fb_sec or 0)*1e3:.0f}) — staying on "
                                f"all-pairs")
                    continue
                if verbose:
                    verbose(f"[adaptive] cell re-probe cap={cap}: still "
                            f"masking — staying on all-pairs (window "
                            f"rewound)")
            t0 = _timer()
            state = simulate(state, cfg_fb, dt, k)
            jax.block_until_ready(state.positions)
            sec = (_timer() - t0) / k
            done += k
            history.append((k, "allpairs", 0))
            if fallback:
                fb_since_probe += 1
                if fb_seen:
                    fb_sec = sec
                else:
                    fb_seen = True  # first window pays compile — skip
            if probe_pending:
                probe_pending = False
                # the first all-pairs window pays its compile — biased
                # AGAINST switching, which is the safe direction; a probe
                # that wins despite the compile is decisively faster
                if rung_sec is not None and sec < rung_sec:
                    fallback = True
                    if verbose:
                        verbose(f"[adaptive] all-pairs probe {sec*1e3:.0f} "
                                f"ms/step beats rung cap={cap} "
                                f"({rung_sec*1e3:.0f}) — switching to the "
                                f"all-pairs backend")
                elif verbose and not fallback:
                    verbose(f"[adaptive] all-pairs probe {sec*1e3:.0f} "
                            f"ms/step loses to rung cap={cap} "
                            f"({(rung_sec or 0)*1e3:.0f}) — staying on the "
                            f"cell path")
            continue
        cfg_k = cfg.replace(cell_capacity=cap)
        t0 = _timer()
        out, (mov, mis) = simulate_dense(state, cfg_k, dt, k, nsc=nsc,
                                         cap=cap, ocap=ocap)
        masked = int(mis)  # host sync: fences the window for the timer
        sec = (_timer() - t0) / k
        if masked > 0:
            new_cap = escalate_cap(cap, max_cap)
            if new_cap is not None:
                if verbose:
                    verbose(f"[adaptive] step {done}: {masked} capacity-"
                            f"masked at cap={cap} -> rewinding window, "
                            f"cap={new_cap}")
                cap = new_cap
                continue  # rewind: re-run the window at the new capacity
            fallback = True
            if verbose:
                verbose(f"[adaptive] step {done}: {masked} masked at "
                        f"max_cap={max_cap} — rewinding window, falling "
                        f"back to the all-pairs sweep (exact)")
            continue  # rewind: re-run the window brute-force
        state = out
        done += k
        history.append((k, cap, masked))
        # cost-aware switch (docstring): once this cap's compile has been
        # paid (2nd+ window at the cap), its window time is comparable —
        # track the cheapest, and when an escalated rung runs probe_factor
        # slower, probe the all-pairs backend with the next window
        if cap in seen_caps:
            if best_rung_sec is None or sec < best_rung_sec:
                best_rung_sec = sec
            # two triggers (docstring): the factor test, and ANY deep rung
            # (>= 4x the starting capacity — a second escalation means the
            # scene is genuinely clustering). Both cost one committed window.
            slow = (best_rung_sec is not None
                    and sec > probe_factor * best_rung_sec)
            deep = cap >= 4 * cap0
            if (cap > cap0 and cap not in probed_caps and (slow or deep)
                    and done < num_steps):
                probe_pending = True
                probed_caps.add(cap)
                rung_sec = sec
                if verbose:
                    why = (f"{sec/best_rung_sec:.1f}x the cheapest rung"
                           if slow else f"deep rung (>= 4x cap0={cap0})")
                    verbose(f"[adaptive] rung cap={cap} at {sec*1e3:.0f} "
                            f"ms/step: {why} — probing the all-pairs "
                            f"backend")
        else:
            seen_caps.add(cap)
    return state, cap, history


@functools.partial(jax.jit, static_argnames=("num_steps", "nsc", "cap",
                                             "mcap", "ocap"))
def simulate_dense_carry(ds, cfg: SimConfig, dt, num_steps: int, nsc: int,
                         cap: int, mcap: int, ocap: int | None = None):
    """``simulate_dense`` continuation on an ALREADY-BUILT dense layout
    (``ops.celllist_dense.build_dense``) — the interactive driver persists
    the layout across tick batches so only the first batch pays the full
    sort build. Returns (new layout, (max_movers, max_masked)); masked
    counts frozen rows only (the overflow sidecar keeps up-to-ocap
    misplaced rows exact, same as ``simulate_dense``)."""
    return _dense_scan(ds, cfg, dt, num_steps, nsc, cap, mcap, ocap=ocap)


@functools.partial(jax.jit, static_argnames=("num_steps", "rebuild_every",
                                             "nsc", "cap"))
def simulate_cadenced(state: ParticleState, cfg: SimConfig, dt,
                      num_steps: int, rebuild_every: int = 8,
                      nsc: int | None = None, cap: int | None = None):
    """On-device trajectory for the Pallas cell-list backend with cadenced
    layout rebuilds: the sort/scatter binning is redone every
    ``rebuild_every`` steps; between rebuilds only position values are
    regathered into the frozen layout (the MD skin/Verlet-list pattern).

    Exact while every particle drifts less than (cell_width - cutoff)/2
    between rebuilds AND no layout build overflows its cell capacity;
    returns ``(final_state, max_observed_drift, max_dropped)`` so callers
    can validate drift against ``pallas_celllist.drift_budget(cfg, nsc)``
    and rewind/escalate when ``max_dropped > 0`` (overflow-dropped
    particles ride a window frozen — the window is NOT exact).
    """
    from ..ops.pallas_celllist import build_layout, layout_drift
    from ..ops import forces as FF

    if nsc is None:
        nsc = cfg.cell_grid
    if cap is None:
        cap = cfg.cell_capacity
    assert nsc is not None and cap is not None, \
        "simulate_cadenced needs cfg.cell_grid / cfg.cell_capacity"
    outer = num_steps // rebuild_every
    rem = num_steps % rebuild_every

    from ..ops.pallas_celllist import dense_forces, slot_of_particle

    def run_window(s, max_drift, max_dropped, k):
        u, v = FF.pair_features(s, cfg)
        layout = build_layout(s.positions, u, v, cfg, nsc, cap)

        # migrate the STATE into the dense slot layout and integrate there:
        # between rebuilds no gather/scatter runs at all — phantom (padding)
        # slots evolve as inert ghosts (masked as force sources by the
        # layout's r2 row, never read back).
        slot = layout.slot_particle.reshape(-1)
        present = slot >= 0
        safe = jnp.where(present, slot, 0)

        def to_dense(a):
            d = a[safe]
            return jnp.where(
                present.reshape((-1,) + (1,) * (a.ndim - 1)), d,
                jnp.zeros_like(d))

        dense = ParticleState(
            positions=to_dense(s.positions),
            velocities=to_dense(s.velocities),
            species=to_dense(s.species),
            masses=to_dense(s.masses),
            accel=to_dense(s.accel),
        )

        def accel_fn(positions, st, c):
            return dense_forces(layout, positions, c, nsc, cap) * FF.kick_scale(c)

        def inner(ss, _):
            return step(ss, cfg, dt, accel_fn=accel_fn), None

        dense, _ = jax.lax.scan(inner, dense, None, length=k)

        # migrate back to particle order; overflow-dropped particles (slot
        # -1, only possible past capacity) keep their previous state
        inv = slot_of_particle(layout, s.n)
        ok = inv >= 0
        inv_safe = jnp.where(ok, inv, 0)

        def back(dense_a, old_a):
            g = dense_a[inv_safe]
            return jnp.where(ok.reshape((-1,) + (1,) * (old_a.ndim - 1)),
                             g, old_a)

        s = ParticleState(
            positions=back(dense.positions, s.positions),
            velocities=back(dense.velocities, s.velocities),
            species=s.species,
            masses=s.masses,
            accel=back(dense.accel, s.accel),
        )
        max_drift = jnp.maximum(max_drift, layout_drift(layout, s.positions, cfg))
        # capacity-overflow drops: particles the build left without a slot
        # rode this window frozen — surface the count so callers can rewind
        dropped = s.n - jnp.sum((slot >= 0).astype(jnp.int32))
        return s, max_drift, jnp.maximum(max_dropped, dropped)

    carry = (state, jnp.float32(0.0), jnp.int32(0))
    if outer:
        carry, _ = jax.lax.scan(
            lambda c, _: (run_window(*c, rebuild_every), None),
            carry, None, length=outer)
    if rem:  # trailing partial window — same layout-rebuild semantics
        carry = run_window(*carry, rem)
    return carry

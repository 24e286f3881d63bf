"""Interactive simulation driver — the ``SimulationApp``.

Mirrors the reference app shell (``src/bin/main.rs:111-484``):

  * fixed-timestep accumulator at ``update_rate`` TPS with capped catch-up of
    at most 5 physics steps per frame (main.rs:183-202, quirk Q10),
  * every live control of the egui side panel + properties window
    (main.rs:250-404): particle count, world size, update rate, walls,
    effect radius, interaction force, drag, repulsion threshold, gravity,
    per-species colors, and the full attraction matrix,
  * WASD/QE + arrow camera control (main.rs:208-247),
  * frame rendering (on-device splats) and wall-clock metrics labels
    (FPS / frame time / update time, main.rs:253-258).

Steps can be batched on device (``steps_per_call``) so interactive physics
doesn't pay one dispatch per step.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SimConfig, ConfigError
from ..state import ParticleState, init_scene, resize
from ..engine.step import step, simulate, warmup
from ..render.camera import (
    Camera, default_camera, camera_axes, move_camera, rotate_camera,
)
from ..render.splat import render_frame
from ..utils.metrics import measure_metrics
from ..utils.profiling import StepTimer
from ..utils.checkpoint import save_checkpoint, load_checkpoint


class SimulationApp:
    def __init__(self, state: ParticleState | None = None,
                 cfg: SimConfig | None = None, *, n: int = 1000,
                 seed: int = 0, update_rate: float = 60.0):
        self.cfg = (cfg or SimConfig()).validate()
        self._key = jax.random.PRNGKey(seed)
        if state is None:
            self._key, k = jax.random.split(self._key)
            state = init_scene(k, n, self.cfg)
        self.state = warmup(state, self.cfg)
        self.camera = default_camera(float(np.asarray(self.cfg.world_size)))
        self.update_rate = update_rate  # TPS (main.rs:164: default 60)
        self._accum = 0.0
        self._last_time: float | None = None
        self.step_index = 0
        self.update_timer = StepTimer()
        self.frame_timer = StepTimer()
        # cadence-exactness tracking for the cell-list backend (see run_steps)
        self.max_drift = 0.0
        self.capacity_masked = 0
        self._per_step_rebuild = False
        # persisted dense cell layout (exact path): built once, repaired
        # incrementally across tick batches; invalidated by any control that
        # changes particles, features or cell geometry
        self._dense = None
        self._dense_geom = None
        # sticky capacity escalation: clustering scenes overflow any cap
        # picked from the uniform init (see simulate_dense_adaptive); the
        # app rewinds a masked batch and re-runs it at the next feasible
        # capacity, then stays there
        self._cap_escalated: int | None = None
        self.max_cap = 512
        # set when the escalation ladder ends (max_cap)
        # while cells still overflow: subsequent batches run the capacity-
        # free brute-force backend — exact, slower, honest
        self._cell_fallback = False
        # overflow-sidecar budget (ops/overflow.py): up to this many
        # capacity-overflow rows stay exact WITHOUT escalating; 0 disables
        # (every overflow row then masks and drives the ladder)
        from ..ops.celllist_dense import OCAP

        self.ocap = (OCAP if self.cfg.overflow_capacity is None
                     else self.cfg.overflow_capacity)
        # recovery probe throttle (see _maybe_recover): escalation and
        # fallback must not be a one-way door — live controls can disperse
        # the scene back into the cheap regime
        self._recheck = False
        self._degraded_batches = 0

    def _invalidate_dense(self) -> None:
        """Called by every scene-changing live control: drops the persisted
        layout AND flags the degraded-mode recovery probe (a control edit is
        the strongest signal the clustering regime may have ended)."""
        self._dense = None
        self._recheck = True

    def _maybe_recover(self) -> None:
        """Un-stick escalation/fallback when the scene no longer needs it.

        ``_cap_escalated`` / ``_cell_fallback`` are sticky by design (a
        clustered scene overflows every smaller capacity again immediately),
        but scenes change — the user edits the attraction matrix, shrinks
        the radius, adds particles — and the reference app never degrades
        permanently. Probe: rebuild the BASE-geometry layout once and count
        drops; a drop-free build means the occupancy that forced the ladder
        up is gone, so reset to the cheap rung and ADOPT the built layout
        (no second build). Throttled to every 32nd degraded batch — or the
        next batch after any scene-changing control — so this never becomes
        the per-tick O(N) pre-probe run_steps' docstring forswears. A probe
        that resets too eagerly only costs a rewound batch: the normal
        ladder re-escalates with exactness intact.
        """
        if not (self._cell_fallback or self._cap_escalated):
            return
        self._degraded_batches += 1
        if not (self._recheck or self._degraded_batches >= 32):
            return
        self._recheck = False
        self._degraded_batches = 0
        from ..ops.celllist_dense import build_dense

        nsc, base_cap = self._cell_geometry()
        if self._cap_escalated and base_cap >= self._cap_escalated:
            return  # base geometry IS the escalated rung — nothing to undo
        dense = build_dense(self.state, self.cfg, nsc, base_cap, self.ocap)
        dropped = int(self.state.n
                      - jnp.sum((dense.pid >= 0).astype(jnp.int32)))
        if dropped == 0:
            self._cell_fallback = False
            self._cap_escalated = None
            self._dense = dense
            self._dense_geom = (nsc, base_cap)

    # ------------------------------------------------------------------ #
    # frame loop (C14)
    # ------------------------------------------------------------------ #
    def tick(self, real_dt: float | None = None, max_catchup: int = 5) -> int:
        """Advance wall-clock time; run 0..max_catchup fixed physics steps
        (reference catch-up rule, main.rs:192-202). Returns steps run."""
        now = time.perf_counter()
        if real_dt is None:
            real_dt = 0.0 if self._last_time is None else now - self._last_time
        self._last_time = now
        self._accum += real_dt
        dt = 1.0 / self.update_rate
        n_steps = 0
        if self._accum >= dt:
            n_steps = min(int(self._accum * self.update_rate), max_catchup)
        if n_steps:
            with self.update_timer:
                self.run_steps(n_steps)
            self._accum -= n_steps * dt
        return n_steps

    def drift_budget(self) -> float:
        """Max per-particle drift the frozen cell layout tolerates between
        rebuilds ((cell_width - cutoff)/2); <= 0 means cadenced stepping can
        never be exact for this config."""
        from ..ops.pallas_celllist import drift_budget

        nsc = self.cfg.cell_grid
        if nsc is None:
            from ..ops.celllist import grid_dims

            nsc = grid_dims(float(np.asarray(self.cfg.world_size)),
                            float(np.asarray(self.cfg.particle_effect_radius)))
        return float(np.asarray(drift_budget(self.cfg, nsc)))

    def _cell_geometry(self) -> tuple[int, int]:
        """(nsc, cap) for the cell backend, derived when not configured."""
        nsc, cap = self.cfg.cell_grid, self.cfg.cell_capacity
        if nsc is None:
            from ..ops.celllist import grid_dims

            nsc = grid_dims(float(np.asarray(self.cfg.world_size)),
                            float(np.asarray(self.cfg.particle_effect_radius)))
        if cap is None:
            from ..ops.celllist import default_capacity

            cap = default_capacity(self.state.n, nsc, slack=2.5)
        return nsc, cap

    def _run_fallback(self, dt, n_steps: int) -> None:
        """Advance on the capacity-free all-pairs backend (exact) — the
        terminal state of the escalation ladder."""
        from ..engine.step import FALLBACK_NEIGHBOR

        self.state = simulate(
            self.state, self.cfg.replace(neighbor=FALLBACK_NEIGHBOR), dt,
            n_steps)
        self._dense = None  # NOT _invalidate_dense: no control changed
        jax.block_until_ready(self.state.positions)
        self.step_index += n_steps

    def _escalate(self, cap: int) -> int | None:
        """Next capacity rung (<= max_cap), or None when the ladder ends
        (callers then flip to the brute-force fallback)."""
        from ..engine.step import escalate_cap

        return escalate_cap(cap, self.max_cap)

    def run_steps(self, n_steps: int) -> None:
        """Run n_steps at the fixed timestep, batched on device.

        For the cell-list backend the layout rebuild is cadenced across the
        batch ONLY while that is exact: when the config's drift budget is
        non-positive (cell width == cutoff, e.g. the flagship 262k preset) or
        observed drift ever exceeds the budget, the app switches to the
        incrementally-maintained dense layout (``simulate_dense`` — layout
        fresh every step, no drift condition), the same exactness rule
        bench.py applies.

        Capacity escalation is diagnostic-driven with REWIND semantics on
        both stepping paths (clustering scenes outgrow any capacity chosen
        at init — see ``simulate_dense_adaptive``): a batch that reports
        capacity masking (dense path: build drop or rebind ``mis``;
        cadenced path: layout build drop) is never committed — it re-runs
        at the next feasible capacity, and when the ladder ends
        (max_cap) the SAME batch re-runs on the capacity-
        free brute-force fallback. No committed batch is ever inexact, and
        no per-tick O(N) pre-probe is needed.
        """
        dt = jnp.float32(1.0 / self.update_rate)
        if self.cfg.neighbor == "celllist_pallas":
            self._maybe_recover()
            if self._cell_fallback:
                self._run_fallback(dt, n_steps)
                return
            nsc, cap = self._cell_geometry()
            if self._cap_escalated:
                cap = max(cap, self._cap_escalated)
            budget = self.drift_budget()
            # preemptive drift guard: if current speeds could plausibly
            # blow the cadence budget within this window (2x safety), use
            # the per-step-fresh dense path instead of finding out after an
            # already-committed approximate window (the post-hoc drift
            # check below remains the hard detector)
            vmax = float(jnp.sqrt(jnp.max(
                jnp.sum(self.state.velocities ** 2, axis=-1))))
            est_drift = 2.0 * vmax * float(dt) * n_steps
            if (budget <= 0.0 or self._per_step_rebuild or n_steps == 1
                    or est_drift > budget):
                from ..engine.step import simulate_dense_carry
                from ..ops.celllist_dense import (
                    build_dense, scatter_back, default_mover_capacity)

                while True:
                    if self._dense is None or self._dense_geom != (nsc, cap):
                        dense = build_dense(self.state, self.cfg, nsc, cap,
                                            self.ocap)
                        # initial-build drops (cell already over capacity)
                        # would ride the whole batch frozen: escalate BEFORE
                        # running anything
                        dropped = int(self.state.n
                                      - jnp.sum((dense.pid >= 0)
                                                .astype(jnp.int32)))
                        if dropped > 0:
                            nxt = self._escalate(cap)
                            if nxt is None:
                                self._cell_fallback = True
                                break
                            cap = nxt
                            self._cap_escalated = cap
                            continue
                        self._dense = dense
                        self._dense_geom = (nsc, cap)
                    new_dense, (mov, mis) = simulate_dense_carry(
                        self._dense, self.cfg, dt, n_steps, nsc, cap,
                        default_mover_capacity(self.state.n), self.ocap)
                    if int(mis) > 0:
                        # rewind the batch (self.state is still pre-batch)
                        # and re-run at the next feasible capacity — or
                        # brute-force when the ladder ends
                        nxt = self._escalate(cap)
                        if nxt is None:
                            self._cell_fallback = True
                            break
                        cap = nxt
                        self._cap_escalated = cap
                        self._dense = None
                        continue
                    break
                if self._cell_fallback:
                    # the masked batch was never committed (self.state is
                    # still pre-batch): re-run it brute-force
                    self._run_fallback(dt, n_steps)
                    return
                self._dense = new_dense
                self.state = scatter_back(self._dense, self.state)
                self.capacity_masked = max(self.capacity_masked, int(mis))
            else:
                from ..engine.step import simulate_cadenced

                while True:
                    out, drift, dropped = simulate_cadenced(
                        self.state, self.cfg, dt, n_steps,
                        rebuild_every=n_steps, nsc=nsc, cap=cap)
                    if int(dropped) > 0:
                        # a layout build overflowed: the window froze
                        # particles — rewind (out is discarded, self.state
                        # is pre-batch) and escalate
                        nxt = self._escalate(cap)
                        if nxt is None:
                            self._cell_fallback = True
                            break
                        cap = nxt
                        self._cap_escalated = cap
                        continue
                    break
                if self._cell_fallback:
                    self._run_fallback(dt, n_steps)
                    return
                self.state = out
                # this path advances state outside the persisted dense
                # layout: a cached layout would replay stale positions
                # (plain drop, NOT _invalidate_dense: no control changed)
                self._dense = None
                drift = float(np.asarray(drift))
                self.max_drift = max(self.max_drift, drift)
                if drift > budget:
                    # this window may have missed in-range pairs; stop
                    # trusting cadenced layouts for this scene
                    self._per_step_rebuild = True
        else:
            self.state = simulate(self.state, self.cfg, dt, n_steps)
        jax.block_until_ready(self.state.positions)
        self.step_index += n_steps

    # ------------------------------------------------------------------ #
    # live controls (C15/C16)
    # ------------------------------------------------------------------ #
    def set_particle_count(self, n: int) -> None:
        """Truncate or extend with fresh random particles (main.rs:261-280)."""
        if n == self.state.n:
            return
        self._key, k = jax.random.split(self._key)
        self.state = resize(self.state, k, n, self.cfg)
        self._invalidate_dense()

    def set_world_size(self, w: float) -> None:
        """Clamped to >= 2*radius, like the UI (main.rs:287-291)."""
        r = float(np.asarray(self.cfg.particle_effect_radius))
        self.cfg = self.cfg.replace(world_size=max(float(w), 2.0 * r))
        self._invalidate_dense()

    def set_update_rate(self, tps: float) -> None:
        self.update_rate = float(np.clip(tps, 1.0, 1000.0))  # main.rs:296

    def set_walls(self, walls: bool) -> None:
        self.cfg = self.cfg.replace(boundary="clamp" if walls else "wrap")
        self._invalidate_dense()

    def set_effect_radius(self, r: float) -> None:
        w = float(np.asarray(self.cfg.world_size))
        self.cfg = self.cfg.replace(
            particle_effect_radius=float(np.clip(r, 1e-3, w / 2.0)))
        self._invalidate_dense()

    def set_interaction_force(self, f: float) -> None:
        self.cfg = self.cfg.replace(interaction_force=float(np.clip(f, 0.0, 10.0)))
        self._invalidate_dense()

    def set_drag(self, c: float) -> None:
        self.cfg = self.cfg.replace(coefficient=float(np.clip(c, 0.0, 1.0)))
        self._invalidate_dense()

    def set_min_pull_ratio(self, m: float) -> None:
        self.cfg = self.cfg.replace(min_pull_ratio=float(np.clip(m, 1e-4, 1.0)))
        self._invalidate_dense()

    def set_gravity(self, x: float, y: float, z: float) -> None:
        self.cfg = self.cfg.replace(
            acceleration=np.array([x, y, z], np.float32))
        self._invalidate_dense()

    def set_color(self, species: int, rgb) -> None:
        colors = np.asarray(self.cfg.colors).copy()
        colors[species] = np.asarray(rgb, np.float32)
        self.cfg = self.cfg.replace(colors=colors)
        self._invalidate_dense()

    def set_attraction(self, i: int, j: int, value: float) -> None:
        """UI clamps edits to [-1, 1] (main.rs:398, quirk Q5)."""
        m = np.asarray(self.cfg.attraction_matrix).copy()
        m[i, j] = float(np.clip(value, -1.0, 1.0))
        self.cfg = self.cfg.replace(attraction_matrix=m)
        self._invalidate_dense()

    def set_attraction_matrix(self, m) -> None:
        m = np.asarray(m, np.float32)
        if m.shape != (self.cfg.id_count, self.cfg.id_count):
            raise ConfigError(f"attraction matrix must be "
                              f"{(self.cfg.id_count,) * 2}, got {m.shape}")
        self.cfg = self.cfg.replace(attraction_matrix=m)
        self._invalidate_dense()

    # ------------------------------------------------------------------ #
    # camera (C13)
    # ------------------------------------------------------------------ #
    def handle_keys(self, keys: set[str], dt: float) -> None:
        """WASD/QE translate, arrows rotate (main.rs:208-247)."""
        fwd, right, up = camera_axes(self.camera)
        cam = self.camera
        if "w" in keys:
            cam = move_camera(cam, dt, fwd)
        if "s" in keys:
            cam = move_camera(cam, dt, -fwd)
        if "a" in keys:
            cam = move_camera(cam, dt, -right)
        if "d" in keys:
            cam = move_camera(cam, dt, right)
        if "q" in keys:
            cam = move_camera(cam, dt, -up)
        if "e" in keys:
            cam = move_camera(cam, dt, up)
        rot = 90.0 * dt  # ROTATION_SPEED
        if "up" in keys:
            cam = rotate_camera(cam, rot, 0.0)
        if "down" in keys:
            cam = rotate_camera(cam, -rot, 0.0)
        if "left" in keys:
            cam = rotate_camera(cam, 0.0, -rot)
        if "right" in keys:
            cam = rotate_camera(cam, 0.0, rot)
        self.camera = cam

    # ------------------------------------------------------------------ #
    # output
    # ------------------------------------------------------------------ #
    def render(self, width: int = 640, height: int = 480) -> np.ndarray:
        with self.frame_timer:
            img = render_frame(self.state.positions, self.state.species,
                               self.cfg, self.camera, width, height)
            img = np.asarray(img)
        return img

    def metrics(self) -> dict:
        m = measure_metrics(self.state).as_dict()
        m.update(
            n=self.state.n,
            step_index=self.step_index,
            update_ms=self.update_timer.ema_ms,
            frame_ms=self.frame_timer.ema_ms,
            update_rate=self.update_rate,
        )
        if self.cfg.neighbor == "celllist_pallas":
            m.update(
                max_drift=self.max_drift,
                drift_budget=self.drift_budget(),
                per_step_rebuild=self._per_step_rebuild,
                capacity_masked=self.capacity_masked,
                cell_capacity=(self._cap_escalated
                               or self._cell_geometry()[1]),
                cell_fallback=self._cell_fallback,
            )
        return m

    def save(self, path: str) -> None:
        save_checkpoint(path, self.state, self.cfg, self.step_index)

    @classmethod
    def load(cls, path: str) -> "SimulationApp":
        state, cfg, step_index, _ = load_checkpoint(path)
        app = cls(state=state, cfg=cfg)
        app.step_index = step_index
        return app

"""Cell-geometry autotuner for the production cell-list path.

``cell_grid`` (supercells per axis) and ``cell_capacity`` (slots per cell)
fix the static shapes of the column-sweep kernel and the incremental dense
layout, and their product drives every per-slot cost in the step. The
sweet spot depends on N, the box, the cutoff, and how strongly the scene
clusters — so this module measures it: it sweeps valid (nsc, cap)
candidates ON THE CURRENT BACKEND, times whole windows of the real
``simulate_dense`` step (the cost production actually pays — see the
``tune`` docstring for why a slope methodology mis-ranks), and ranks
mask-free geometries first with capacity-masking diagnostics visible
next to the speed.

The reference has no analogue (its spatial hash re-buckets into N slots
every step, ``src/lib.rs:134-164``); this is the tool a production
deployment uses once per workload shape.

CLI: ``python -m particle3d tune --preset particle_life_large``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any


@dataclasses.dataclass
class TuneResult:
    nsc: int
    cap: int
    ms_per_step: float
    steps_per_s: float
    max_movers: int
    capacity_masked: int

    def as_dict(self):
        return dataclasses.asdict(self)


def effective_cutoff(cfg) -> float:
    import numpy as np

    r = float(np.asarray(cfg.particle_effect_radius))
    return min(r, 1.0) if cfg.force_law == "particle_life" else r


def candidate_geometries(cfg, n: int, max_candidates: int = 8):
    """Valid (nsc, cap) pairs: cell width >= cutoff and capacity covering
    ~1.25-4x the mean occupancy (the column kernel runs at any capacity).
    Ordered densest grid first (fewest examined pairs)."""
    import numpy as np

    w = float(np.asarray(cfg.world_size))
    cutoff = effective_cutoff(cfg)
    nsc_max = max(3, int(w / cutoff + 1e-6))
    out = []
    for nsc in range(nsc_max, max(2, nsc_max // 2 - 1), -1):
        mean_occ = n / float(nsc ** 3)
        # sub-2x-occupancy capacities are viable: the overflow sidecar
        # (ops/overflow.py) serves the Poisson tail exactly, so capacity
        # wants to hug the MEAN. Masked geometries still rank last, so
        # scenes that overflow the sidecar budget lose nothing.
        caps = {max(2, int(-(-mean_occ * s // 1)))
                for s in (1.25, 1.5, 2.0, 2.5, 3.0, 4.0)}
        out.extend((nsc, cap) for cap in sorted(caps))
        if len(out) >= max_candidates:
            break
    return out[:max_candidates]


def tune(state, cfg, dt, steps: int = 16, candidates=None, verbose=print,
         reps: int = 3):
    """Measure each candidate geometry on the live backend; returns
    TuneResults ranked MASK-FREE FIRST, then fastest.

    Timing is whole-window (``steps``-step ``simulate_dense`` calls ending
    in ``block_until_ready``, compile excluded) — the cost the app's
    batched ticks pay, NOT a slope between two step counts, which would
    cancel exactly the per-window costs production pays. Capacity-masking
    geometries are kept visible but rank AFTER every exact one: a masked
    step is not the same work, so its speed is not comparable.
    """
    import jax

    from ..engine.step import simulate_dense

    n = state.positions.shape[0]
    if candidates is None:
        candidates = candidate_geometries(cfg, n)
    if not candidates:
        raise ValueError("no valid cell geometries for this config")

    results = []
    for nsc, cap in candidates:
        cfg2 = cfg.replace(neighbor="celllist_pallas", cell_grid=nsc,
                           cell_capacity=cap)
        try:
            fn = jax.jit(lambda: simulate_dense(state, cfg2, dt, steps))
            out, diag = fn()  # compile + warm (and the masking diagnostic)
            jax.block_until_ready(out.positions)
            t0 = time.perf_counter()
            for _ in range(reps):
                out, _ = fn()
                jax.block_until_ready(out.positions)
            sec = max((time.perf_counter() - t0) / reps / steps, 1e-9)
            res = TuneResult(
                nsc=nsc, cap=cap, ms_per_step=sec * 1e3,
                steps_per_s=1.0 / sec,
                max_movers=int(diag[0]), capacity_masked=int(diag[1]))
            results.append(res)
            if verbose:
                verbose(f"[tune] nsc={nsc:3d} cap={cap:3d}: "
                        f"{res.ms_per_step:8.2f} ms/step "
                        f"({res.steps_per_s:6.1f} steps/s), "
                        f"masked {res.capacity_masked}")
        except Exception as e:  # candidate failed to compile/run: report on
            if verbose:       # and keep sweeping — a sweep must not die
                verbose(f"[tune] nsc={nsc} cap={cap} failed: "
                        f"{str(e).splitlines()[0][:120]}")
    results.sort(key=lambda r: (r.capacity_masked > 0, r.ms_per_step))
    return results

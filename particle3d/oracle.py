"""Ground-truth oracle: a direct, loop-based NumPy transcription of the
reference physics (``/root/reference/src/lib.rs``), used only in tests.

Unlike the production JAX paths, this deliberately keeps the reference's
literal structure — the 27 periodic world-image sweep (src/lib.rs:177-191),
per-pair branchy force law (src/lib.rs:55-67), sequential per-axis boundary
ifs (src/lib.rs:70-127) — so that every algebraic simplification in the JAX
build (minimum-image convention, branch-free where-chains, fused drag) is
*verified* against the original semantics instead of assumed.

The reference itself is non-deterministic across runs (rayon fold order,
quirk Q9), so "oracle parity" means matching this deterministic serial
evaluation to FP tolerance, which is the strongest well-defined target.
"""

from __future__ import annotations

import numpy as np

from .config import SimConfig


def calculate_force(distance: float, attraction: float, min_pull_ratio: float) -> float:
    """src/lib.rs:55-67, verbatim branch structure."""
    if distance < min_pull_ratio:
        return distance / min_pull_ratio - 1.0
    elif min_pull_ratio < distance and distance < 1.0:
        return attraction * (
            1.0 - abs(2.0 * distance - 1.0 - min_pull_ratio) / (1.0 - min_pull_ratio)
        )
    else:
        return 0.0


def _magnitude(cfg: SimConfig, d: float, coef: float) -> float:
    if cfg.force_law == "particle_life":
        return calculate_force(d, coef, float(cfg.min_pull_ratio))
    if cfg.force_law == "lennard_jones":
        eps, sig = float(cfg.lj_epsilon), float(cfg.lj_sigma)
        i6 = (sig / d) ** 6
        return coef * (24.0 * eps / d) * (i6 - 2.0 * i6 * i6)
    if cfg.force_law == "gravity":
        g, soft = float(cfg.gravity_constant), float(cfg.gravity_softening)
        d2 = d * d + soft * soft
        return coef * g * d / (d2 * np.sqrt(d2))
    if cfg.force_law == "spring":
        return coef * float(cfg.spring_stiffness) * (d - float(cfg.spring_rest_length))
    raise ValueError(cfg.force_law)


def _pair_coef(cfg: SimConfig, species, masses, i: int, j: int) -> float:
    if cfg.force_law == "particle_life":
        a = np.asarray(cfg.attraction_matrix)
        return float(a[species[i], species[j]])
    if cfg.force_law == "gravity":
        return float(masses[j])
    return 1.0


def oracle_forces(positions, species, cfg: SimConfig, masses=None,
                  use_27_images: bool = True):
    """Accumulated pair force sum per particle — BEFORE the
    interaction_force * radius scaling (i.e. the raw `total_force` of
    src/lib.rs:176-243).

    use_27_images=True reproduces the literal triple image loop; False uses
    the minimum-image convention. Both must agree when world >= 2*radius.
    """
    pos = np.asarray(positions, np.float64)
    n = pos.shape[0]
    w = float(cfg.world_size)
    r2 = float(cfg.particle_effect_radius) ** 2
    out = np.zeros((n, 3), np.float64)
    if cfg.wrap_forces and use_27_images:
        offsets = [
            np.array([ox, oy, oz], np.float64) * w
            for ox in (-1, 0, 1)
            for oy in (-1, 0, 1)
            for oz in (-1, 0, 1)
        ]
    else:
        offsets = [np.zeros(3)]
    for i in range(n):
        acc = np.zeros(3)
        for off in offsets:
            base = pos[i] + off
            for j in range(n):
                rel = pos[j] - base
                if cfg.wrap_forces and not use_27_images:
                    rel = rel - w * np.round(rel / w)
                d2 = float(rel @ rel)
                if d2 > 0.0 and d2 < r2:
                    d = np.sqrt(d2)
                    coef = _pair_coef(cfg, species, masses, i, j)
                    f = _magnitude(cfg, d, coef)
                    acc += rel / d * f
        out[i] = acc
    return out


def handle_wall_collision(pos, vel, cfg: SimConfig):
    """src/lib.rs:70-127, verbatim per-axis if/elif chain (mutates copies)."""
    pos = pos.copy()
    vel = vel.copy()
    w = float(cfg.world_size)
    hw = w * 0.5
    walls = cfg.boundary == "clamp"
    for a in range(3):
        if pos[a] > hw:
            if walls:
                pos[a] = hw
                vel[a] = min(vel[a], 0.0)
            else:
                pos[a] -= w
        elif pos[a] < -hw:
            if walls:
                pos[a] = -hw
                vel[a] = max(vel[a], 0.0)
            else:
                pos[a] += w
    return pos, vel


def oracle_step(positions, velocities, species, cfg: SimConfig, dt: float,
                masses=None, use_27_images: bool = True):
    """One full reference step: src/lib.rs:130-272 (Euler order exactly)."""
    pos = np.asarray(positions, np.float64)
    vel = np.asarray(velocities, np.float64)
    n = pos.shape[0]
    force = oracle_forces(pos, species, cfg, masses, use_27_images)
    scale = float(cfg.interaction_force)
    if cfg.force_law == "particle_life":
        scale *= float(cfg.particle_effect_radius)
    new_pos = np.zeros_like(pos)
    new_vel = np.zeros_like(vel)
    grav = np.asarray(cfg.acceleration, np.float64)
    coeff = float(cfg.coefficient)
    for i in range(n):
        v = vel[i] + force[i] * scale * dt
        v = v + grav * dt
        dv = v * coeff * dt
        if dv @ dv > v @ v:
            v = np.zeros(3)
        else:
            v = v - dv
        x = pos[i] + v * dt
        x, v = handle_wall_collision(x, v, cfg)
        new_pos[i] = x
        new_vel[i] = v
    return new_pos, new_vel


def oracle_simulate(positions, velocities, species, cfg: SimConfig, dt: float,
                    num_steps: int, masses=None, use_27_images: bool = True):
    pos, vel = np.asarray(positions, np.float64), np.asarray(velocities, np.float64)
    for _ in range(num_steps):
        pos, vel = oracle_step(pos, vel, species, cfg, dt, masses, use_27_images)
    return pos, vel

"""Simulation configuration.

``SimConfig`` mirrors — and extends — the reference's entire config surface, the
13 public fields of ``Particles`` (reference ``src/lib.rs:20-33``):

    world_size, id_count, attraction_matrix, colors, coefficient (drag),
    interaction_force, min_pull_ratio, particle_effect_radius, walls, acceleration

plus framework-level knobs the reference hard-codes or lacks: the force law,
the integrator, the boundary mode, the neighbor-search backend, and
quirk-compatibility switches (see SURVEY.md appendix Q1-Q9).

The config is a JAX pytree: numeric fields are traced leaves (so they can be
changed between jitted steps without recompiling — the analogue of the
reference's live egui sliders, ``src/bin/main.rs:250-365``), while structural
fields (force law, integrator, boundary, species count) are static metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Enumerations (static metadata — selecting one recompiles the step)
# ---------------------------------------------------------------------------

FORCE_LAWS = ("particle_life", "lennard_jones", "gravity", "spring")
INTEGRATORS = ("euler", "velocity_verlet", "leapfrog")
BOUNDARIES = ("wrap", "clamp", "reflect")
NEIGHBOR_BACKENDS = ("allpairs", "allpairs_pallas", "celllist",
                     "celllist_pallas")

# Default species palette — reference ``src/bin/main.rs:126-132``.
DEFAULT_COLORS = np.array(
    [
        [1.0, 0.0, 0.0],  # red
        [0.0, 1.0, 0.0],  # green
        [0.0, 0.0, 1.0],  # blue
        [1.0, 1.0, 0.0],  # yellow
        [1.0, 0.0, 1.0],  # magenta
    ],
    dtype=np.float32,
)

# Default attraction matrix — reference ``src/bin/main.rs:133-139``. Note the
# 1.5 entry exceeds the UI's [-1, 1] clamp (quirk Q5); we keep it verbatim.
DEFAULT_ATTRACTION = np.array(
    [
        [0.5, 1.0, -0.5, 0.0, -1.0],
        [1.0, 1.0, 1.0, 0.0, -1.0],
        [0.0, 0.0, 0.5, 1.5, -1.0],
        [0.0, 0.0, 0.0, 0.0, -1.0],
        [1.0, 1.0, 1.0, 1.0, 0.5],
    ],
    dtype=np.float32,
)


class ConfigError(ValueError):
    """Raised for invalid simulation configs.

    The reference's only validation is a hard ``assert!(world_size >= 2.0 *
    particle_effect_radius)`` that aborts the process (``src/lib.rs:132``);
    we validate up front and raise a catchable error instead.
    """


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full simulation configuration (JAX pytree).

    Traced (data) fields can change every step without recompilation;
    static (meta) fields select the compiled program.
    """

    # --- traced numeric fields (reference ``src/lib.rs:20-33``) ---
    world_size: Any = 10.0
    attraction_matrix: Any = None  # f32[K, K], row = self species
    colors: Any = None  # f32[K, 3]
    coefficient: Any = 0.97  # drag ("how quickly particles slow down")
    interaction_force: Any = 1.0
    min_pull_ratio: Any = 0.3
    particle_effect_radius: Any = 2.0
    acceleration: Any = None  # f32[3] global gravity vector

    # --- traced fields for the non-particle-life force laws ---
    lj_epsilon: Any = 1.0
    lj_sigma: Any = 0.1
    gravity_constant: Any = 1.0
    gravity_softening: Any = 0.05
    spring_stiffness: Any = 1.0
    spring_rest_length: Any = 0.5
    restitution: Any = 1.0  # for the "reflect" (elastic) boundary

    # --- static structural fields ---
    id_count: int = 5
    # cell-list geometry must be compile-time static (XLA shapes); None means
    # "derive from concrete world_size/radius at call time" — set explicitly
    # when config values are traced (e.g. inside jit/scan).
    cell_grid: int | None = None
    cell_capacity: int | None = None
    # overflow-sidecar budget (ops/overflow.py): up to this many capacity-
    # overflow particles stay EXACT without escalating the cell capacity,
    # letting the geometry hug the mean occupancy. None = the module default
    # (celllist_dense.OCAP); 0 disables (overflow then freezes, counts as
    # masked, and drives the escalation ladder).
    overflow_capacity: int | None = None
    force_law: str = "particle_life"
    integrator: str = "euler"
    boundary: str = "wrap"  # reference: walls=False -> wrap, True -> clamp
    neighbor: str = "allpairs"
    # Quirk-compat: the reference applies periodic force images even when
    # walls are solid (src/lib.rs:177-191, quirk Q3). True reproduces that.
    wrap_forces: bool = True

    def __post_init__(self):
        if self.attraction_matrix is None:
            k = self.id_count
            m = DEFAULT_ATTRACTION
            if k == 5:
                object.__setattr__(self, "attraction_matrix", m.copy())
            else:
                object.__setattr__(
                    self, "attraction_matrix", np.zeros((k, k), np.float32)
                )
        if self.colors is None:
            k = self.id_count
            if k <= 5:
                object.__setattr__(self, "colors", DEFAULT_COLORS[:k].copy())
            else:
                reps = -(-k // 5)
                object.__setattr__(
                    self, "colors", np.tile(DEFAULT_COLORS, (reps, 1))[:k].copy()
                )
        if self.acceleration is None:
            object.__setattr__(self, "acceleration", np.zeros(3, np.float32))

    # -- convenience -------------------------------------------------------

    @property
    def walls(self) -> bool:
        """Reference-compat view of the boundary mode (``src/lib.rs:31``)."""
        return self.boundary != "wrap"

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "SimConfig":
        """Graceful config validation (vs the reference's process-killing
        assert at ``src/lib.rs:132``)."""
        if self.force_law not in FORCE_LAWS:
            raise ConfigError(f"unknown force_law {self.force_law!r}; one of {FORCE_LAWS}")
        if self.integrator not in INTEGRATORS:
            raise ConfigError(f"unknown integrator {self.integrator!r}; one of {INTEGRATORS}")
        if self.boundary not in BOUNDARIES:
            raise ConfigError(f"unknown boundary {self.boundary!r}; one of {BOUNDARIES}")
        if self.neighbor not in NEIGHBOR_BACKENDS:
            raise ConfigError(f"unknown neighbor backend {self.neighbor!r}; one of {NEIGHBOR_BACKENDS}")
        if self.id_count < 1:
            raise ConfigError("id_count must be >= 1")
        if self.overflow_capacity is not None and self.overflow_capacity < 0:
            raise ConfigError("overflow_capacity must be >= 0 (0 disables "
                              "the overflow sidecar)")
        ws = np.asarray(self.world_size)
        r = np.asarray(self.particle_effect_radius)
        if ws.ndim == 0 and r.ndim == 0 and float(ws) < 2.0 * float(r):
            raise ConfigError(
                f"world_size ({float(ws)}) must be >= 2 * particle_effect_radius "
                f"({float(r)}) — required for the minimum-image neighbor sweep "
                "(reference src/lib.rs:132)"
            )
        am = np.asarray(self.attraction_matrix)
        if am.shape != (self.id_count, self.id_count):
            raise ConfigError(
                f"attraction_matrix shape {am.shape} != (id_count, id_count) "
                f"= ({self.id_count}, {self.id_count})"
            )
        cols = np.asarray(self.colors)
        if cols.shape != (self.id_count, 3):
            raise ConfigError(f"colors shape {cols.shape} != ({self.id_count}, 3)")
        if np.asarray(self.acceleration).shape != (3,):
            raise ConfigError("acceleration must have shape (3,)")
        return self

    def as_arrays(self, dtype=jnp.float32) -> "SimConfig":
        """Cast all traced numeric fields to JAX arrays of ``dtype``."""
        kw = {}
        for f in dataclasses.fields(self):
            if f.name in _META_FIELDS:
                continue
            v = getattr(self, f.name)
            kw[f.name] = jnp.asarray(v, dtype=dtype)
        return self.replace(**kw)


_ALL_FIELDS = [f.name for f in dataclasses.fields(SimConfig)]
_META_FIELDS = ["id_count", "force_law", "integrator", "boundary", "neighbor",
                "wrap_forces", "cell_grid", "cell_capacity",
                "overflow_capacity"]
_DATA_FIELDS = [n for n in _ALL_FIELDS if n not in _META_FIELDS]

jax.tree_util.register_dataclass(
    SimConfig, data_fields=_DATA_FIELDS, meta_fields=_META_FIELDS
)


def reference_config(**overrides) -> SimConfig:
    """The reference's default interactive scene config
    (``src/bin/main.rs:123-148``): world 10, 5 species, radius 2, drag 0.97,
    force 1.0, min_pull 0.3, periodic box, zero gravity."""
    cfg = SimConfig(**overrides)
    return cfg.validate()

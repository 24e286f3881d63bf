"""Checkpoint / resume.

The reference has none: closing the app loses all state (SURVEY.md section 5;
``src/lib.rs:22``, eframe persistence disabled at ``src/bin/main.rs:836-855``).
Here: a single-file npz snapshot of the full state pytree + config (batched
device->host readback), round-trippable to an exact-resume state.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import jax

from ..config import SimConfig
from ..state import ParticleState, from_numpy

_FORMAT_VERSION = 1


def _config_to_jsonable(cfg: SimConfig) -> dict:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if isinstance(v, (str, bool, int)):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v).tolist()
    return out


def _config_from_jsonable(d: dict) -> SimConfig:
    kw = dict(d)
    # fields of the removed dense-tile all-pairs backend, present in older
    # checkpoints; they never affected the other backends
    for gone in ("precision", "ghost_capacity"):
        kw.pop(gone, None)
    for name in ("attraction_matrix", "colors", "acceleration"):
        if name in kw and kw[name] is not None:
            kw[name] = np.asarray(kw[name], np.float32)
    return SimConfig(**kw)


def save_checkpoint(path: str, state: ParticleState, cfg: SimConfig,
                    step_index: int = 0, extra: dict | None = None) -> None:
    """One atomic device->host snapshot -> .npz file."""
    host = jax.device_get(state)
    meta = {
        "format_version": _FORMAT_VERSION,
        "step_index": int(step_index),
        "config": _config_to_jsonable(cfg),
        "extra": extra or {},
    }
    np.savez_compressed(
        path,
        positions=np.asarray(host.positions),
        velocities=np.asarray(host.velocities),
        species=np.asarray(host.species),
        masses=np.asarray(host.masses),
        accel=np.asarray(host.accel),
        meta=json.dumps(meta),
    )


def load_checkpoint(path: str):
    """-> (state, config, step_index, extra)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version in {path}")
        state = from_numpy(z["positions"], z["velocities"], z["species"],
                           masses=z["masses"])
        state = state.replace(accel=jax.numpy.asarray(z["accel"]))
    cfg = _config_from_jsonable(meta["config"])
    return state, cfg, meta["step_index"], meta["extra"]

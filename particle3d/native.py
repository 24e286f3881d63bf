"""ctypes bindings for the native C++ reference engine (native/oracle.cpp).

Builds on demand with the repo Makefile (-O3, OpenMP where the compiler
has it). Used by tests as an independent, deterministic ground truth at
large N, and available as a host-side CPU engine
(``native_step``/``native_simulate``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

from .config import SimConfig

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "liboracle.so")
_lock = threading.Lock()
_lib = None

ABI_VERSION = 1


class NativeUnavailable(RuntimeError):
    """No native library: no toolchain, or the build failed."""


class NoToolchain(NativeUnavailable):
    """``make`` or the C++ compiler is not installed."""


def _make(*args: str) -> str:
    """Run ``make`` in native/ once; returns its stdout (the compile
    command). Raises NoToolchain without make or a compiler, and
    NativeUnavailable with the compiler's stderr when the build fails."""
    cxx = (os.environ.get("CXX") or "g++").split()[0]
    if shutil.which("make") is None or shutil.which(cxx) is None:
        raise NoToolchain(f"no C++ toolchain (make, {cxx})")
    r = subprocess.run(["make", *args], cwd=_NATIVE_DIR,
                       capture_output=True, text=True)
    if r.returncode:
        raise NativeUnavailable(
            f"native build failed (make exit {r.returncode}):\n"
            f"{r.stdout}{r.stderr}".rstrip())
    return r.stdout.strip()


def _bind(path: str):
    lib = ctypes.CDLL(path)
    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    common = [
        f32p, f32p, u32p, ctypes.c_int64,  # pos, vel, species, n
        ctypes.c_float, ctypes.c_int32, f32p,  # world, id_count, attraction
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, f32p, ctypes.c_float, ctypes.c_int32,
    ]
    lib.p3d_step.argtypes = common
    lib.p3d_step.restype = None
    lib.p3d_simulate.argtypes = common + [ctypes.c_int64]
    lib.p3d_simulate.restype = None
    lib.p3d_abi_version.restype = ctypes.c_int32
    if lib.p3d_abi_version() != ABI_VERSION:
        raise NativeUnavailable("native ABI version mismatch — run make clean")
    return lib


def load(build: bool = True):
    """Load (building if needed) the native library; raises NativeUnavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            if not build:
                raise NativeUnavailable(f"{_LIB_PATH} not built")
            _make()
        _lib = _bind(_LIB_PATH)
        return _lib


def build_fresh(out_dir: str) -> tuple[str, str]:
    """Compile ``oracle.cpp`` into ``out_dir`` with one ``make`` call and
    make that build the library this module uses — never a previously
    built copy. Returns the library's path and the compile command."""
    global _lib
    path = os.path.join(os.path.abspath(out_dir), "liboracle.so")
    command = _make("-B", f"TARGET={path}")
    with _lock:
        _lib = _bind(path)
    return path, command


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def _as_c(a, dtype):
    a = np.ascontiguousarray(a, dtype=dtype)
    return a


def native_simulate(positions, velocities, species, cfg: SimConfig, dt: float,
                    steps: int, use_hash: bool = True):
    """Run reference-exact steps in native code; returns (pos, vel) copies."""
    if cfg.force_law != "particle_life":
        raise ValueError("native engine implements the particle_life law only")
    lib = load()
    pos = _as_c(positions, np.float32).copy()
    vel = _as_c(velocities, np.float32).copy()
    spec = _as_c(species, np.uint32)
    attr = _as_c(cfg.attraction_matrix, np.float32)
    accel = _as_c(cfg.acceleration, np.float32)
    n = pos.shape[0]
    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.p3d_simulate(
        pos.ctypes.data_as(f32p), vel.ctypes.data_as(f32p),
        spec.ctypes.data_as(u32p), n,
        float(np.asarray(cfg.world_size)), cfg.id_count,
        attr.ctypes.data_as(f32p),
        float(np.asarray(cfg.coefficient)),
        float(np.asarray(cfg.interaction_force)),
        float(np.asarray(cfg.min_pull_ratio)),
        float(np.asarray(cfg.particle_effect_radius)),
        1 if cfg.boundary == "clamp" else 0,
        accel.ctypes.data_as(f32p), float(dt), 1 if use_hash else 0,
        int(steps),
    )
    return pos, vel


def native_step(positions, velocities, species, cfg: SimConfig, dt: float,
                use_hash: bool = True):
    return native_simulate(positions, velocities, species, cfg, dt, 1, use_hash)

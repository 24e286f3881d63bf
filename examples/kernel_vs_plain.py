"""Hand-written force kernels against what XLA makes of their plain twins,
on the GPU, at the presets' shapes.

    python examples/kernel_vs_plain.py [--sweep] [--out FILE]

For each kernel it prints the end-to-end steps/s of the presets that use it,
once with the kernel and once with the routing rule forced to the plain jnp
path, and the time of one force sweep each way. ``--sweep`` also times the
kernels' block geometries (receiver block, source block, warps). Every line
carries the card's name and power limit; results also go to ``--out`` as
JSON. Needs a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from particle3d.engine.step import simulate, simulate_dense, warmup  # noqa: E402
from particle3d.models import make_scene  # noqa: E402
from particle3d.ops import forces as F  # noqa: E402
from particle3d.ops import pallas_allpairs as PA  # noqa: E402
from particle3d.ops import pallas_celllist as PC  # noqa: E402
from particle3d.utils.cache import configure_compile_cache  # noqa: E402


def timed(fn, reps: int = 3) -> float:
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def route(name: str):
    """Force every force sweep onto one implementation (``"plain"``) for
    the duration; compiled programs are dropped on entry and exit because
    the route is fixed at trace time."""
    saved = PA.kernel_route, PC.kernel_route
    PA.kernel_route = PC.kernel_route = lambda interpret=None: name
    jax.clear_caches()
    try:
        yield
    finally:
        PA.kernel_route, PC.kernel_route = saved
        jax.clear_caches()


def steps_per_s(preset: str, steps: int, reps: int) -> float:
    st, cfg, dt = make_scene(preset)
    if cfg.neighbor == "celllist_pallas":
        return steps / timed(
            lambda: simulate_dense(st, cfg, dt, steps)[0].positions, reps)
    st = warmup(st, cfg)
    return steps / timed(lambda: simulate(st, cfg, dt, steps).positions,
                         reps)


def cell_sweep_ms(preset: str, br: int, bs: int, plain=False) -> float:
    st, cfg, _ = make_scene(preset)
    nsc, cap = cfg.cell_grid, cfg.cell_capacity
    u, v = F.pair_features(st, cfg, pad_p=PA.PAIR_P)
    pos_d, u_d, post_g, vt_g, r2_g, _ = PC.prepare_columns(
        st.positions, u, v, cfg, nsc, cap)
    args = (pos_d, u_d, post_g, vt_g, r2_g, PA.pack_params(cfg))
    p_eff = F.feature_dim(cfg)
    if plain:
        fn = jax.jit(lambda *a: PC._call_plain(
            *a, cfg.force_law, True, nsc, cap, False, p_eff))
    else:
        fn = jax.jit(lambda *a: PC._call_kernel(
            *a, cfg.force_law, True, nsc, cap, False, p_eff, br, bs, False))
    return 1e3 * timed(lambda: fn(*args))


def allpairs_sweep_ms(preset: str, bi: int, bj: int, plain=False) -> float:
    st, cfg, _ = make_scene(preset)
    u, v = F.pair_features(st, cfg)
    if plain:
        from particle3d.ops.allpairs import allpairs_forces

        fn = jax.jit(lambda p, a, b: allpairs_forces(p, a, b, cfg))
    else:
        fn = jax.jit(lambda p, a, b: PA.pallas_allpairs_forces(
            p, a, b, cfg, bi=bi, bj=bj))
    return 1e3 * timed(lambda: fn(st.positions, u, v), reps=2)


def with_warps(module, warps: int, fn):
    saved = module.NUM_WARPS
    module.NUM_WARPS = warps
    jax.clear_caches()
    try:
        return fn()
    finally:
        module.NUM_WARPS = saved
        jax.clear_caches()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default="chiprun_out/kernel_vs_plain.json")
    a = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("kernel_vs_plain: needs a GPU", file=sys.stderr)
        return 2
    configure_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    res = {"card": card, "e2e_steps_per_s": {}, "sweep_ms": {}, "geom": []}

    def note(key, val, table):
        res[table][key] = val
        print(f"[{card}] {table} {key}: {val:.4g}", flush=True)

    cells = ("particle_life_1m", "particle_life_large")
    pairs = ("gravity_nbody", "verlet_elastic", "particle_life_large_allpairs")
    for preset in cells + pairs:
        n_steps = 2 if preset == "particle_life_large_allpairs" else 16
        note(f"{preset} kernel", steps_per_s(preset, n_steps, 3),
             "e2e_steps_per_s")
        with route("plain"):
            note(f"{preset} plain", steps_per_s(preset, n_steps, 2),
                 "e2e_steps_per_s")
    for preset in cells:
        st, cfg, _ = make_scene(preset)
        br = PC.block_rows(cfg.cell_capacity)
        note(f"{preset} kernel", cell_sweep_ms(preset, br, PC.BLOCK_S),
             "sweep_ms")
        note(f"{preset} plain", cell_sweep_ms(preset, 0, 0, plain=True),
             "sweep_ms")
    for preset in pairs[:1]:
        note(f"{preset} kernel", allpairs_sweep_ms(
            preset, PA.BLOCK_I, PA.BLOCK_J), "sweep_ms")
        note(f"{preset} plain", allpairs_sweep_ms(preset, 0, 0, plain=True),
             "sweep_ms")

    if a.sweep:
        for bs, w in ((32, 1), (32, 2), (32, 4), (64, 2), (64, 4),
                      (128, 4)):
            ms = with_warps(PC, w, lambda: cell_sweep_ms(
                "particle_life_1m", PC.block_rows(32), bs))
            res["geom"].append({"kernel": "cell", "bs": bs, "warps": w,
                                "ms": ms})
            print(f"[{card}] cell 1M bs={bs} warps={w}: {ms:.3f} ms",
                  flush=True)
        for bi, bj, w in ((32, 32, 1), (32, 32, 2), (32, 32, 4),
                          (64, 32, 2), (64, 64, 4), (32, 64, 2),
                          (64, 64, 8)):
            ms = with_warps(PA, w, lambda: allpairs_sweep_ms(
                "gravity_nbody", bi, bj))
            res["geom"].append({"kernel": "allpairs", "bi": bi, "bj": bj,
                                "warps": w, "ms": ms})
            print(f"[{card}] all-pairs 65k bi={bi} bj={bj} warps={w}: "
                  f"{ms:.3f} ms", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(res, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

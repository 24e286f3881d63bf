#!/usr/bin/env python
"""Smoke test of the whole system on one GPU (or, with --four-cards, the
sharded paths on four).

    python chip_smoke.py                # one card, every phase below
    python chip_smoke.py --four-cards   # ring + slab on 4 cards vs 1 card

One process opens the card once. Phases, in order:

  1. fail unless JAX's first device is a GPU; print the card's name and
     power limit (nvidia-smi);
  2. compile each force kernel at real widths, print its memory analysis,
     and check it against its plain reference (tolerances below);
  3. N=1k ``reference`` for 120 steps against the native oracle, built
     fresh from native/oracle.cpp (oracle.py, for 8 steps, only where no
     C++ toolchain is installed);
  4. the ``particle_life_1m`` and ``particle_life_large`` windows through
     ``simulate_dense`` (masked == 0) and ``gravity_nbody`` through
     ``simulate``: warmed steps/s and each window's compiled memory;
  5. ``python -m particle3d run --preset particle_life_1m --steps 48``
     in-process;
  6. ``serve`` at ``reference`` on a thread, answering a few
     /positions.bin, /metrics and /frame.png requests.

Any failed phase exits non-zero. The last line of stdout is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``; with no GPU the
script exits non-zero before printing it.

Tolerances (max |kernel - reference| over max |reference|): 2e-5 for the
cell kernel (the GPU's rsqrt is within 2 ulp, the plain twin uses an exact
sqrt and divide, and ~400 partners are summed in another order); 1e-4 for
the all-pairs kernel against the rectangular plain sweep (65k-262k partners
summed in another order), and for the ring's accelerations against one
device's (the same kernel, its partial sums added shard by shard); 1e-5 for
the slab's positions against one device's after 8 steps.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

CELL_TOL = 2e-5
ALLPAIRS_TOL = 1e-4
PARITY_TOL = 5e-3  # trajectory L2 vs the native oracle (tests/test_native.py)
SAMPLE = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def timed(fn, reps: int = 3) -> float:
    """Seconds per call of ``fn`` (warmed, ends in block_until_ready)."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / reps


def peak_bytes() -> int:
    import jax

    return int((jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use", 0))


def rel_err(got, want) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                    1e-30))


def check(name: str, err: float, tol: float) -> None:
    log(f"  {name}: rel err {err:.3e} (tolerance {tol:.0e})")
    if not err <= tol:
        raise AssertionError(f"{name}: rel err {err:.3e} > {tol:.0e}")


def memory_text(compiled) -> str:
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory analysis unavailable"
    return (f"args {ma.argument_size_in_bytes / 1e6:.1f} MB, out "
            f"{ma.output_size_in_bytes / 1e6:.1f} MB, temp "
            f"{ma.temp_size_in_bytes / 1e6:.1f} MB")


def memory_line(fn, *args) -> str:
    import jax

    return memory_text(jax.jit(fn).lower(*args).compile())


# --------------------------------------------------------------------------
# phase 2: kernels
# --------------------------------------------------------------------------

def cell_kernel_check(preset: str, n: int | None = None, walls=False):
    """Compiled column kernel vs its plain twin on one preset's layout;
    returns (kernel s/sweep, plain s/sweep)."""
    import numpy as np
    import jax

    from particle3d.models import make_scene
    from particle3d.ops import forces as F
    from particle3d.ops.pallas_allpairs import PAIR_P, pack_params
    from particle3d.ops.pallas_celllist import (
        BLOCK_S, _call_kernel, _call_plain, block_rows, prepare_columns)

    st, cfg, _ = make_scene(preset, n=n)
    if walls:
        cfg = cfg.replace(boundary="clamp", wrap_forces=False)
    nsc, cap = cfg.cell_grid, cfg.cell_capacity
    u, v = F.pair_features(st, cfg, pad_p=PAIR_P)
    pos_d, u_d, post_g, vt_g, r2_g, slots = prepare_columns(
        st.positions, u, v, cfg, nsc, cap)
    pf = pack_params(cfg)
    wrap, p_eff = bool(cfg.wrap_forces), F.feature_dim(cfg)
    args = (pos_d, u_d, post_g, vt_g, r2_g, pf)

    def kern(*a):
        return _call_kernel(*a, cfg.force_law, wrap, nsc, cap, False, p_eff,
                            block_rows(cap), BLOCK_S, False)

    def plain(*a):
        return _call_plain(*a, cfg.force_law, wrap, nsc, cap, False, p_eff)

    tag = f"{preset}{' walls' if walls else ''} (nsc={nsc}, cap={cap})"
    log(f"  cell kernel {tag}: {memory_line(kern, *args)}")
    occ = np.asarray(slots) >= 0
    got = np.transpose(np.asarray(jax.jit(kern)(*args)), (0, 2, 1))[occ]
    want = np.transpose(np.asarray(jax.jit(plain)(*args)), (0, 2, 1))[occ]
    check(f"cell kernel vs plain twin, {tag}", rel_err(got, want), CELL_TOL)
    tk = timed(lambda: jax.jit(kern)(*args))
    tp = timed(lambda: jax.jit(plain)(*args))
    log(f"  cell sweep {tag}: kernel {tk * 1e3:.3f} ms, plain XLA "
        f"{tp * 1e3:.3f} ms")
    return tk, tp


def cell_sample_check_1m() -> None:
    """1M fresh-build cell forces (kernel + overflow sidecar) on a random
    4,096-receiver sample against all sources with the rectangular plain
    all-pairs sweep."""
    import numpy as np
    import jax

    from particle3d.models import make_scene
    from particle3d.ops import forces as F
    from particle3d.ops.allpairs import allpairs_forces
    from particle3d.ops.pallas_celllist import pallas_celllist_forces

    st, cfg, _ = make_scene("particle_life_1m")
    u, v = F.pair_features(st, cfg)
    f = np.asarray(jax.jit(lambda p, a, b: pallas_celllist_forces(
        p, a, b, cfg))(st.positions, u, v))
    idx = np.random.default_rng(0).choice(st.n, min(SAMPLE, st.n),
                                          replace=False)
    want = np.asarray(jax.jit(lambda p, a, sp, sv: allpairs_forces(
        p, a, None, cfg, src_positions=sp, src_v=sv))(
            st.positions[idx], u[idx], st.positions, v))
    check("particle_life_1m cell forces, 4,096-receiver sample vs "
          "rectangular all-pairs", rel_err(f[idx], want), CELL_TOL)


def allpairs_kernel_check(preset: str):
    """All-pairs kernel over the whole preset vs the rectangular plain sweep
    on a receiver sample; returns (kernel s/sweep, plain s/sweep)."""
    import numpy as np
    import jax

    from particle3d.models import make_scene
    from particle3d.ops import forces as F
    from particle3d.ops.allpairs import allpairs_forces
    from particle3d.ops.pallas_allpairs import pallas_allpairs_forces

    st, cfg, _ = make_scene(preset)
    u, v = F.pair_features(st, cfg)

    def kern(p, a, b):
        return pallas_allpairs_forces(p, a, b, cfg)

    def plain(p, a, b):
        return allpairs_forces(p, a, b, cfg)

    args = (st.positions, u, v)
    log(f"  all-pairs kernel {preset} (N={st.n}): "
        f"{memory_line(kern, *args)}")
    f = np.asarray(jax.jit(kern)(*args))
    idx = np.random.default_rng(1).choice(st.n, min(SAMPLE, st.n),
                                          replace=False)
    want = np.asarray(jax.jit(lambda p, a, sp, sv: allpairs_forces(
        p, a, None, cfg, src_positions=sp, src_v=sv))(
            st.positions[idx], u[idx], st.positions, v))
    check(f"all-pairs kernel {preset}, {len(idx)}-receiver sample vs "
          f"rectangular plain sweep", rel_err(f[idx], want), ALLPAIRS_TOL)
    tk = timed(lambda: jax.jit(kern)(*args))
    tp = timed(lambda: jax.jit(plain)(*args), reps=1)
    log(f"  all-pairs sweep {preset}: kernel {tk * 1e3:.3f} ms, plain XLA "
        f"{tp * 1e3:.3f} ms")
    return tk, tp


# --------------------------------------------------------------------------
# phases 3-6
# --------------------------------------------------------------------------

def native_parity() -> None:
    """120 steps against the native oracle, built fresh with one ``make``
    call (a failed build fails the phase and shows the compiler's stderr).
    Only where no C++ toolchain is installed does it fall back to
    oracle.py, whose Python loops take ~6 s a step at N=1k: 8 steps, and
    the 120-step parity is reported as not checked."""
    import numpy as np
    import jax

    from particle3d import native, oracle, simulate
    from particle3d.models import make_scene

    st, cfg, dt = make_scene("reference", jax.random.PRNGKey(7))
    pos0 = np.asarray(st.positions)
    vel0 = np.asarray(st.velocities)
    spec0 = np.asarray(st.species)
    with tempfile.TemporaryDirectory() as d:
        try:
            lib, command = native.build_fresh(d)
            steps = 120
            log(f"  oracle: native/oracle.cpp built fresh at {lib} "
                f"({command})")
            ref, _ = native.native_simulate(pos0, vel0, spec0, cfg, dt,
                                            steps)
        except native.NoToolchain as e:
            steps = 8
            log(f"  oracle: oracle.py, {steps} steps ({e}); the 120-step "
                f"parity against the native oracle was NOT checked")
            ref, _ = oracle.oracle_simulate(pos0, vel0, spec0, cfg, dt,
                                            steps, use_27_images=False)
    out = np.asarray(simulate(st, cfg, dt, steps).positions)
    l2 = float(np.sqrt(np.mean((out - np.asarray(ref)) ** 2)))
    log(f"  trajectory L2 vs oracle, N=1k, {steps} steps: {l2:.3e} "
        f"(tolerance {PARITY_TOL:.0e})")
    if not l2 < PARITY_TOL:
        raise AssertionError(f"N=1k parity L2 {l2:.3e} >= {PARITY_TOL}")


def preset_windows() -> dict:
    """Each window compiled once ahead of time: its memory analysis is the
    window's own, and the timed calls run that executable."""
    import jax

    from particle3d.engine.step import simulate, simulate_dense, warmup
    from particle3d.models import make_scene

    rates = {}
    for preset, steps in (("particle_life_1m", 16),
                          ("particle_life_large", 16)):
        st, cfg, dt = make_scene(preset)
        window = simulate_dense.lower(st, cfg, dt, num_steps=steps).compile()
        out, (mov, masked) = window(st, cfg, dt)
        if int(masked) != 0:
            raise AssertionError(f"{preset}: {int(masked)} masked")
        sec = timed(lambda: window(st, cfg, dt)[0].positions)
        rates[preset] = steps / sec
        log(f"  {preset} (N={st.n}) simulate_dense {steps} steps: "
            f"{steps / sec:.2f} steps/s, masked 0, max movers {int(mov)}, "
            f"window memory: {memory_text(window)}")
    st, cfg, dt = make_scene("gravity_nbody")
    st = warmup(st, cfg)
    steps = 8
    window = simulate.lower(st, cfg, dt, num_steps=steps).compile()
    sec = timed(lambda: window(st, cfg, dt).positions)
    rates["gravity_nbody"] = steps / sec
    log(f"  gravity_nbody (N={st.n}) simulate {steps} steps: "
        f"{steps / sec:.2f} steps/s, window memory: {memory_text(window)}")
    log(f"  process high-water mark so far: {peak_bytes() / 1e9:.2f} GB")
    return rates


def cli_run() -> None:
    from particle3d.__main__ import main as cli

    t0 = time.perf_counter()
    cli(["run", "--preset", "particle_life_1m", "--steps", "48"])
    log(f"  CLI run done in {time.perf_counter() - t0:.1f} s (compile "
        f"included)")


def serve_requests() -> None:
    from http.server import ThreadingHTTPServer

    from particle3d.app.driver import SimulationApp
    from particle3d.app.server import _Handler
    from particle3d.models import make_scene

    st, cfg, dt = make_scene("reference")
    _Handler.app = SimulationApp(state=st, cfg=cfg, update_rate=1.0 / dt)
    _Handler.lock = threading.Lock()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{port}"
        for _ in range(3):
            t0 = time.perf_counter()
            with urllib.request.urlopen(base + "/positions.bin",
                                        timeout=300) as r:
                body = r.read()
            if len(body) != 8 + st.n * 13:
                raise AssertionError(f"/positions.bin: {len(body)} bytes")
            with urllib.request.urlopen(base + "/frame.png?w=320&h=240",
                                        timeout=300) as r:
                png = r.read()
            if not png.startswith(b"\x89PNG"):
                raise AssertionError("/frame.png is not a PNG")
            with urllib.request.urlopen(base + "/metrics", timeout=300) as r:
                m = json.loads(r.read())
            log(f"  serve: positions {len(body)} B, frame {len(png)} B, "
                f"metrics step {m['step_index']}, "
                f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


# --------------------------------------------------------------------------
# --four-cards
# --------------------------------------------------------------------------

def ring_check(mesh, n: int = 262_144, steps: int = 2) -> None:
    """Ring all-pairs (``sharded_simulate``) against ``simulate`` on one
    device, gravity at N=n. The check is on the ring's own output, the
    final accelerations (one full ring sweep), relative to their scale.
    Positions (moved by a*dt^2 ~ 1e-7 here) and velocities (changed by
    ~1e-4 of their size, within float32 rounding) cannot show a fault, so
    positions are only reported."""
    import jax
    import jax.numpy as jnp

    from particle3d.engine.step import simulate, warmup
    from particle3d.models import make_scene
    from particle3d.parallel import shard_state, sharded_simulate

    st, cfg, dt = make_scene("gravity_nbody", n=n)
    st = warmup(st, cfg)
    ref = simulate(st, cfg, dt, steps)
    t_one = timed(lambda: simulate(st, cfg, dt, steps).positions, reps=1)

    def ring():
        return sharded_simulate(shard_state(jax.tree.map(jnp.copy, st),
                                            mesh), cfg, dt, steps, mesh)

    out = ring()
    t_four = timed(lambda: ring().positions, reps=1)
    log(f"  ring vs single-device positions: rel err "
        f"{rel_err(out.positions, ref.positions):.3e} (not a check)")
    check(f"ring vs single-device accelerations after {steps} steps",
          rel_err(out.accel, ref.accel), ALLPAIRS_TOL)
    log(f"  ring {steps / t_four:.2f} steps/s on {mesh.size} devices, "
        f"single device {steps / t_one:.2f} steps/s")


def slab_check(mesh, preset: str = "particle_life_1m",
               steps: int = 8) -> None:
    """Slab decomposition (``sharded_dense_simulate``) against
    ``simulate_dense`` on one device, with masked, limbo and lost all 0."""
    from particle3d.engine.step import simulate_dense
    from particle3d.models import make_scene
    from particle3d.parallel import sharded_dense_simulate

    st, cfg, dt = make_scene(preset)
    ref, (_, mis) = simulate_dense(st, cfg, dt, steps)
    if int(mis) != 0:
        raise AssertionError(f"single-device window masked {int(mis)}")
    out, (_, masked, limbo, lost, shipped) = sharded_dense_simulate(
        st, cfg, dt, steps, mesh)
    log(f"  slab diagnostics: masked {int(masked)}, limbo {int(limbo)}, "
        f"lost {int(lost)}, shipped {int(shipped)}")
    if int(masked) or int(limbo) or int(lost):
        raise AssertionError("slab window was not exact")
    check("slab vs single-device positions",
          rel_err(out.positions, ref.positions), 1e-5)
    t_four = timed(lambda: sharded_dense_simulate(
        st, cfg, dt, steps, mesh)[0].positions, reps=1)
    t_one = timed(lambda: simulate_dense(st, cfg, dt, steps)[0].positions,
                  reps=1)
    log(f"  slab {steps / t_four:.2f} steps/s on {mesh.size} devices, "
        f"single device {steps / t_one:.2f} steps/s")


def four_cards() -> None:
    import jax

    from particle3d.parallel import make_mesh

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found "
                           f"{len(jax.devices())}")
    mesh = make_mesh(4)
    log("[ring] gravity, N=262,144: sharded_simulate on 4 cards vs "
        "simulate on one")
    ring_check(mesh)
    log("[slab] particle_life_1m, nsc=40 over D=4: sharded_dense_simulate "
        "vs simulate_dense on one card")
    slab_check(mesh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the ring and slab paths on 4 cards, "
                         "each against the single-card path")
    a = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    from particle3d.utils.cache import configure_compile_cache

    log(f"compile cache: {configure_compile_cache()}")
    log(f"card: {card_line()}")
    log(f"jax {jax.__version__}, devices: {len(jax.devices())} x "
        f"{dev.device_kind}")

    if a.four_cards:
        phases = [("four cards", four_cards)]
    else:
        phases = [
            ("2 kernels", lambda: (
                cell_kernel_check("particle_life_1m"),
                cell_kernel_check("particle_life_large"),
                cell_kernel_check("particle_life_large", walls=True),
                cell_sample_check_1m(),
                allpairs_kernel_check("gravity_nbody"),
                allpairs_kernel_check("particle_life_large_allpairs"))),
            ("3 N=1k parity vs native oracle", native_parity),
            ("4 preset windows", preset_windows),
            ("5 CLI run", cli_run),
            ("6 serve", serve_requests),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"[phase {name}]")
        fn()
        log(f"[phase {name}] ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

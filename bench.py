#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: pair-interactions/sec of the all-pairs force kernel inside the
full fused simulation step at N=262,144. Every number is measured on the
GPU JAX finds and printed beside the card's name and power limit; with no
GPU the harness exits non-zero and prints no result.

Timing: every measured call ends in ``jax.block_until_ready``; warmup uses
identical static shapes so compilation is excluded. Every section's
exactness and parity assertions are fatal: a failed section fails the run,
which then prints no result.

Extra context goes to stderr so stdout stays a single JSON line.
"""

import json
import subprocess
import sys
import tempfile
import time


def _timed(fn, iters):
    """Seconds per call, excluding compile."""
    import jax

    jax.block_until_ready(fn())  # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t0) / iters


def _card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown (nvidia-smi unavailable)"


def main():
    import jax
    import jax.numpy as jnp

    from particle3d.utils.cache import configure_compile_cache

    configure_compile_cache()
    import numpy as np

    from particle3d import (
        SimConfig, init_scene, native, reference_config, simulate, warmup)
    from particle3d.engine.step import (
        simulate_cadenced, simulate_dense, simulate_dense_adaptive)
    from particle3d.models import make_scene
    from particle3d.ops import forces as FF
    from particle3d.ops.pallas_allpairs import pallas_allpairs_forces
    from particle3d.ops.pallas_celllist import pallas_celllist_forces
    from particle3d.parallel import (
        init_sharded_dense, make_mesh, shard_state, sharded_dense_simulate,
        sharded_dense_steps, sharded_simulate)
    from particle3d.parallel.domain_sharded import (
        build_sharded_dense, gather_sharded_dense, sharded_exact_steps)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] no GPU found (JAX platform {dev.platform!r}); this "
              f"harness measures the card only", file=sys.stderr)
        sys.exit(2)
    card = _card()
    print(f"[bench | {card}] device={dev.device_kind} x{len(jax.devices())} "
          f"card: {card}", file=sys.stderr)
    neighbor = "allpairs_pallas"
    dt = 1.0 / 60.0

    # --- raw brute-force kernel rate: N=262k all-pairs kernel --------------
    n = 262144
    cfg = reference_config(world_size=40.0).replace(neighbor=neighbor)
    st = init_scene(jax.random.PRNGKey(0), n, cfg)

    steps = 5
    sec = _timed(lambda: simulate(st, cfg, dt, steps).positions, 3)
    steps_per_s = steps / sec
    pairs_per_s = float(n) * float(n) * steps_per_s
    print(f"[bench | {card}] N={n} brute-force all-pairs kernel: {steps_per_s:.3f} "
          f"steps/s = {pairs_per_s:.3e} pair-interactions/s", file=sys.stderr)

    # --- headline: the measured BRUTE-FORCE kernel rate. The cell-list
    # path's "effective" N^2 rate counts pairs the cell list never computes,
    # so it goes under its own key (extra) with its own semantics.
    headline_pairs_per_s = pairs_per_s
    headline_name = "pair_interactions_per_sec_allpairs_N262k"
    extra = {"allpairs_steps_per_s_N262k": steps_per_s}
    # particle-life particles move fast (drift > cell slack), so the
    # exact configuration keeps the layout fresh every step — via the
    # incrementally-maintained dense layout (bit-equal to a per-step
    # full rebuild, ~2.5x faster; ops/celllist_dense.py)

    stc, cfgc, dtc = make_scene("particle_life_large")
    secc = _timed(
        lambda: simulate_dense(stc, cfgc, dt, 16)[0].positions, 2)
    _, (mx_mov, mx_mis) = simulate_dense(stc, cfgc, dt, 16)
    assert int(mx_mis) == 0, (
        f"262k production window must be exact: {int(mx_mis)} masked")
    eff = float(n) * float(n) * (16 / secc)
    print(f"[bench | {card}] N={n} particle-life, pallas cell list (production "
          f"path, incremental per-step relayout — exact): "
          f"{16 / secc:.2f} steps/s = {eff:.3e} effective "
          f"pair-interactions/s (max movers/step {int(mx_mov)}, "
          f"capacity-masked {int(mx_mis)})", file=sys.stderr)
    extra["celllist_steps_per_s_N262k_exact"] = 16 / secc
    extra["effective_pair_interactions_per_sec_N262k_celllist"] = eff

    # --- 1M preset. This scene
    # leaves its uniform phase within ~2 windows (capacity masking
    # appears between steps 16 and 32 at the preset geometry — the
    # exactness horizon, docs/PERF.md), so the steady-state
    # production rate is the EXACT-WINDOW MARGINAL: the slope between
    # window-8 and window-16 from init, both asserted exact. The
    # one-time build + scatter_back cancel in the difference; the
    # all-in window-16 (incl. them) goes under its own key. ----------
    st1, cfg1, _ = make_scene("particle_life_1m")
    sec8 = _timed(
        lambda: simulate_dense(st1, cfg1, dt, 8)[0].positions, 2)
    sec16 = _timed(
        lambda: simulate_dense(st1, cfg1, dt, 16)[0].positions, 2)
    for k in (8, 16):
        _, (_, mis1m) = simulate_dense(st1, cfg1, dt, k)
        assert int(mis1m) == 0, (
            f"1M window-{k} must be exact: {int(mis1m)} masked")
    slope1m = (sec16 - sec8) / 8
    print(f"[bench | {card}] N=1,048,576 particle-life production path: "
          f"{1 / slope1m:.2f} steps/s steady-state (exact-window "
          f"marginal, {slope1m * 1e3:.1f} ms/step), window-16 "
          f"all-in {16 / sec16:.2f} steps/s, masked 0",
          file=sys.stderr)
    extra["steps_per_s_N1M"] = 1 / slope1m
    extra["steps_per_s_N1M_window16"] = 16 / sec16

    # --- 1M LONG-HORIZON regime: the preset's exactness horizon
    # is < 32 steps, so longer runs belong to the adaptive ladder.
    # 48 steps from init (chunk 16) CROSS the horizon; the driver
    # must escalate/switch as needed and commit only exact windows.

    # warmed second rep: the first run compiles whatever escalation
    # rungs the cache is missing, so the recorded key is the second,
    # compile-free rep; the cold wall goes to stderr only.
    t0 = time.perf_counter()
    _, cap1m, hist1m = simulate_dense_adaptive(
        st1, cfg1, dt, 48, chunk=16)
    cold1m = time.perf_counter() - t0
    assert all(m == 0 for _, _, m in hist1m), (
        f"1M ladder committed an inexact window: {hist1m}")
    t0 = time.perf_counter()
    _, cap1m, hist1m = simulate_dense_adaptive(
        st1, cfg1, dt, 48, chunk=16)
    wall1m = time.perf_counter() - t0
    assert all(m == 0 for _, _, m in hist1m), (
        f"1M ladder committed an inexact window: {hist1m}")
    print(f"[bench | {card}] 1M adaptive ladder (48 steps from init, chunk "
          f"16, crosses the exactness horizon): {wall1m:.1f} s "
          f"wall warm ({cold1m:.1f} s incl. one-time escalation "
          f"compiles), end cap {cap1m}, windows "
          f"{[c for _, c, _ in hist1m]}, every committed window "
          f"exact", file=sys.stderr)
    extra["ladder_1m_48steps_wall_s"] = wall1m
    extra["ladder_1m_committed_inexact"] = 0

    # --- cost-aware escalation ladder, fenced: a
    # short clustering run through simulate_dense_adaptive must commit
    # ONLY exact windows while the ladder (sidecar -> escalate ->
    # all-pairs probe) manages capacity. ----------------------------

    # warmed second rep (see the 1M ladder above)
    _, cap_end, hist = simulate_dense_adaptive(
        stc, cfgc, dt, 64, chunk=16)
    assert all(m == 0 for _, _, m in hist), (
        f"adaptive ladder committed an inexact window: {hist}")
    t0 = time.perf_counter()
    _, cap_end, hist = simulate_dense_adaptive(
        stc, cfgc, dt, 64, chunk=16)
    wall = time.perf_counter() - t0
    assert all(m == 0 for _, _, m in hist), (
        f"adaptive ladder committed an inexact window: {hist}")
    backends = [c for _, c, _ in hist]
    print(f"[bench | {card}] adaptive ladder (N=262k, 64 steps, chunk 16): "
          f"{wall:.1f} s wall warm, end cap {cap_end}, windows "
          f"{backends}, every committed window exact",
          file=sys.stderr)
    extra["ladder_64steps_wall_s"] = wall
    extra["ladder_committed_inexact"] = 0

    # --- bidirectional re-probe on the card: the 64-step ladder above
    # never leaves the cell path, so this covers the all-pairs fallback
    # and the switch-BACK re-probe. Engineered cluster-then-disperse at
    # N=16k: a blob denser than max_cap forces the fallback; strong outward
    # velocities disperse it ballistically; the dispersal re-probe
    # must return to the cell path — asserted from history, with real
    # wall-clock driving the cost decisions. ocap=0 so the blob
    # actually masks (the sidecar would serve it). -------------------

    # mean occupancy must sit FAR below max_cap or the probe can
    # never succeed: N=16k (mean 4/cell) with max_cap 32 leaves the
    # background's Poisson tail orders of magnitude clear
    n_rp = 16384
    cfg_rp = SimConfig(
        world_size=16.0, neighbor="celllist_pallas", cell_grid=16,
        cell_capacity=8,
        attraction_matrix=np.zeros((5, 5), np.float32)).validate()
    st_rp = init_scene(jax.random.PRNGKey(9), n_rp, cfg_rp)
    rngr = np.random.default_rng(11)
    crowd = 96
    pos_rp = np.asarray(st_rp.positions).copy()
    vel_rp = np.asarray(st_rp.velocities).copy()
    dirs = rngr.normal(size=(crowd, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pos_rp[:crowd] = np.float32([1.0, 1.0, 1.0]) + dirs * 0.05
    vel_rp[:crowd] = dirs * 8.0
    st_rp = st_rp.replace(positions=jnp.asarray(pos_rp),
                          velocities=jnp.asarray(vel_rp))
    # warmed second rep (see the 1M ladder above)
    _, _, hist_rp = simulate_dense_adaptive(
        st_rp, cfg_rp, 1.0 / 30.0, 48, chunk=4, max_cap=32, ocap=0)
    assert all(m == 0 for _, _, m in hist_rp), (
        f"re-probe scenario committed an inexact window: {hist_rp}")
    t0 = time.perf_counter()
    _, _, hist_rp = simulate_dense_adaptive(
        st_rp, cfg_rp, 1.0 / 30.0, 48, chunk=4, max_cap=32, ocap=0)
    wall_rp = time.perf_counter() - t0
    backends = [c for _, c, _ in hist_rp]
    assert all(m == 0 for _, _, m in hist_rp), (
        f"re-probe scenario committed an inexact window: {hist_rp}")
    assert "allpairs" in backends, (
        f"blob never forced the all-pairs fallback: {hist_rp}")
    i_cul = backends.index("allpairs")
    assert any(b != "allpairs" for b in backends[i_cul:]), (
        f"dispersal re-probe never returned to the cell path: "
        f"{hist_rp}")
    print(f"[bench | {card}] bidirectional re-probe (N=16k blob "
          f"cluster->disperse, 48 steps): windows {backends}, "
          f"all-pairs AND a later cell window both executed, "
          f"every window exact, {wall_rp:.1f} s wall",
          file=sys.stderr)
    extra["reprobe_allpairs_then_cell"] = 1
    extra["reprobe_scenario_wall_s"] = wall_rp

    # --- cross-backend equivalence: the production cell kernel must
    # reproduce the all-pairs kernel's forces -------------------------

    u, v = FF.pair_features(stc, cfgc)
    f_cell = np.asarray(pallas_celllist_forces(
        stc.positions, u, v, cfgc))
    f_ap = np.asarray(pallas_allpairs_forces(
        stc.positions, u, v, cfgc))
    scale = max(1e-6, float(np.max(np.abs(f_ap))))
    rel = float(np.max(np.abs(f_cell - f_ap))) / scale
    print(f"[bench | {card}] equivalence celllist_pallas vs all-pairs kernel "
          f"(N={n}, 1 force sweep): max rel err {rel:.2e}",
          file=sys.stderr)
    assert rel < 5e-5, (
        f"backend mismatch: celllist_pallas vs all-pairs rel err "
        f"{rel:.2e}")
    extra["celllist_vs_allpairs_rel_err"] = rel

    # --- compiled gates for the SHARDED kernels: a 1-device mesh on the
    # card compiles + runs the slab path's halo=True column kernel and
    # the ring ppermute sweep ------------------------------------------

    # The gates run at the PRESET geometry (24, 32), a mean-hugging
    # tune that overflows some rows: both paths serve overflow
    # EXACTLY through the sidecar, so unserved == 0 on both sides
    # and any residual is the kernel.
    g_nsc, g_cap = cfgc.cell_grid, cfgc.cell_capacity
    mesh1 = make_mesh(1)
    out_slab, (_, mask_s, limbo_s, lost, _) = sharded_dense_simulate(
        stc, cfgc, dt, 4, mesh1, nsc=g_nsc, cap=g_cap)
    ref4, (_, mis4) = simulate_dense(stc, cfgc, dt, 4,
                                     nsc=g_nsc, cap=g_cap)
    sc = max(1.0, float(np.max(np.abs(np.asarray(ref4.positions)))))
    rel_slab = float(np.max(np.abs(
        np.asarray(out_slab.positions)
        - np.asarray(ref4.positions)))) / sc
    assert int(lost) == 0
    assert int(mask_s) == 0 and int(limbo_s) == 0 and int(mis4) == 0, (
        f"slab gate must be exact (sidecar serves overflow): slab "
        f"unserved masked {int(mask_s)} limbo {int(limbo_s)} dense "
        f"masked {int(mis4)}")
    assert rel_slab < 5e-5, (
        f"compiled-mode mismatch: slab halo kernel + sidecar vs "
        f"dense layout rel err {rel_slab:.2e}")
    print(f"[bench | {card}] slab halo kernel + overflow sidecar "
          f"(1-dev mesh, N={n}, 4 steps, production "
          f"({g_nsc},{g_cap})): rel err vs simulate_dense "
          f"{rel_slab:.2e}, unserved 0, lost 0",
          file=sys.stderr)
    extra["slab_halo_vs_dense_rel_err"] = rel_slab

    # walled variant of the halo kernel (dead ghosts + dummy-column
    # y map + edge-killed halo planes) — a distinct compiled program
    cfgw = cfgc.replace(boundary="clamp", wrap_forces=False)
    out_w, (_, mask_w, limbo_w, lost_w, _) = sharded_dense_simulate(
        stc, cfgw, dt, 4, mesh1, nsc=g_nsc, cap=g_cap)
    refw, (_, misw) = simulate_dense(stc, cfgw, dt, 4,
                                     nsc=g_nsc, cap=g_cap)
    scw = max(1.0, float(np.max(np.abs(np.asarray(refw.positions)))))
    rel_wall = float(np.max(np.abs(
        np.asarray(out_w.positions)
        - np.asarray(refw.positions)))) / scw
    assert int(lost_w) == 0
    assert int(mask_w) == 0 and int(limbo_w) == 0 and int(misw) == 0, (
        f"walled slab gate must be exact: slab unserved masked "
        f"{int(mask_w)} limbo {int(limbo_w)} dense masked {int(misw)}")
    assert rel_wall < 5e-5, (
        f"compiled-mode mismatch: WALLED slab halo kernel vs dense "
        f"layout rel err {rel_wall:.2e}")
    print(f"[bench | {card}] walled slab halo kernel "
          f"(1-dev mesh, N={n}, 4 steps): rel err vs simulate_dense "
          f"{rel_wall:.2e}, lost 0", file=sys.stderr)
    extra["slab_walls_vs_dense_rel_err"] = rel_wall

    # reference FIRST: _sharded_simulate donates its input, and on a
    # 1-device mesh shard_state's device_put aliases st's buffer —
    # donation would delete st out from under simulate()
    ref_ring = simulate(st, cfg, dt, 2)
    ring_state = shard_state(jax.tree.map(jnp.copy, st), mesh1)
    out_ring = sharded_simulate(ring_state, cfg, dt, 2, mesh1)
    sc = max(1.0, float(np.max(np.abs(
        np.asarray(ref_ring.positions)))))
    rel_ring = float(np.max(np.abs(
        np.asarray(out_ring.positions)
        - np.asarray(ref_ring.positions)))) / sc
    assert rel_ring < 5e-5, (
        f"compiled-mode mismatch: ring sweep vs all-pairs "
        f"rel err {rel_ring:.2e}")
    print(f"[bench | {card}] ring sweep (1-dev mesh, N={n}, "
          f"2 steps): rel err vs all-pairs {rel_ring:.2e}",
          file=sys.stderr)
    extra["ring_vs_allpairs_rel_err"] = rel_ring

    # sharded EXACT terminal rung: the compacted masked-ring window
    # (sharded_exact_steps — the de-replicated ladder end) must
    # reproduce plain all-pairs.

    carry_x = build_sharded_dense(stc, cfgc, mesh1)
    carry_x, ovf_x = sharded_exact_steps(carry_x, cfgc, dt, 2,
                                         mesh1, rcap=n)
    assert int(ovf_x) == 0
    out_x = gather_sharded_dense(carry_x, stc, mesh1)
    ref_x = simulate(stc, cfgc.replace(neighbor="allpairs_pallas"),
                     dt, 2)
    scx = max(1.0, float(np.max(np.abs(np.asarray(
        ref_x.positions)))))
    rel_x = float(np.max(np.abs(
        np.asarray(out_x.positions)
        - np.asarray(ref_x.positions)))) / scx
    assert rel_x < 5e-5, (
        f"compiled-mode mismatch: sharded exact rung vs all-pairs "
        f"rel err {rel_x:.2e}")
    print(f"[bench | {card}] sharded exact terminal rung "
          f"(1-dev mesh, N={n}, 2 steps, compacted masked ring): "
          f"rel err vs all-pairs {rel_x:.2e}, overflow 0",
          file=sys.stderr)
    extra["sharded_exact_rung_vs_allpairs_rel_err"] = rel_x

    # --- stay-sharded slab carry at N=2M on one card — steps/s + live
    # device-memory accounting -----------------------------------------

    n2m = 2_097_152
    # coarse 44^3 grid (cell width 1.45) + cap 64 covers the tail
    # through step 20, so the sidecar is off here (ocap=0: the
    # trouble assert below then genuinely means zero overflow
    # existed). mcap = 2.25x the ~51k movers/step the scene shows,
    # and migcap = 4096 on a 1-device mesh (there are no slab
    # crossers).
    nsc2, cap2, mcap2, migcap2 = 44, 64, 114688, 4096
    cfg2m = SimConfig(world_size=64.0,
                      neighbor="celllist_pallas", cell_grid=nsc2,
                      cell_capacity=cap2).validate()
    mesh1 = make_mesh(1)
    carry = init_sharded_dense(jax.random.PRNGKey(5), n2m, cfg2m,
                               mesh1, nsc=nsc2, cap=cap2,
                               migcap=migcap2)
    hbm = sum(int(a.nbytes) for a in jax.tree.leaves(carry))
    carry, _ = sharded_dense_steps(   # compile + warm — SAME
        carry, cfg2m, dt, 10, mesh1, nsc=nsc2, cap=cap2,
        mcap=mcap2, migcap=migcap2, n=n2m, ocap=0)
    # num_steps as the timed call: a different step count is a
    # different program whose compile would land in the window
    jax.block_until_ready(carry)
    t0 = time.perf_counter()
    carry, (mov2, mask2, limbo2, lost2, _) = sharded_dense_steps(
        carry, cfg2m, dt, 10, mesh1, nsc=nsc2, cap=cap2,
        mcap=mcap2, migcap=migcap2, n=n2m, ocap=0)
    jax.block_until_ready(carry)
    sec2m = (time.perf_counter() - t0) / 10
    dev_stats = jax.devices()[0].memory_stats() or {}
    used = dev_stats.get("bytes_in_use", 0)
    trouble2m = int(mask2) + int(limbo2)
    assert trouble2m == 0, (
        f"slab 2M window committed force-frozen particles: "
        f"masked {int(mask2)} limbo {int(limbo2)}")
    print(f"[bench | {card}] slab stay-sharded N=2M (1 card): "
          f"{1/sec2m:.2f} steps/s, carry {hbm/1e9:.2f} GB, device "
          f"in-use {used/1e9:.2f} GB, masked {int(mask2)} "
          f"limbo {int(limbo2)} lost {int(lost2)}", file=sys.stderr)
    extra["slab_steps_per_s_N2M"] = 1 / sec2m
    extra["slab_carry_bytes_N2M"] = hbm
    extra["slab_lost_N2M"] = int(lost2)
    extra["slab_trouble_N2M"] = trouble2m

    # --- N=8M on ONE card, exact: same 8 particles/unit^3 density as
    # the 2M point (world 100), tail-covering (68, 64) with the slab
    # sidecar serving the marginal tail. mcap = 2.25x the ~186k movers,
    # migcap=4096 (1-device mesh, no crossers). trouble == 0 asserted.

    n8m = 8 * 1024 * 1024
    nsc8, cap8, mcap8, migcap8 = 68, 64, 419840, 4096
    cfg8m = SimConfig(world_size=100.0,
                      neighbor="celllist_pallas", cell_grid=nsc8,
                      cell_capacity=cap8).validate()
    mesh1 = make_mesh(1)
    carry8 = init_sharded_dense(jax.random.PRNGKey(5), n8m, cfg8m,
                                mesh1, nsc=nsc8, cap=cap8,
                                migcap=migcap8)
    hbm8 = sum(int(a.nbytes) for a in jax.tree.leaves(carry8))
    kw8 = dict(nsc=nsc8, cap=cap8, mcap=mcap8, migcap=migcap8,
               n=n8m, ocap=128)
    carry8, _ = sharded_dense_steps(  # compile + warm, same shape
        carry8, cfg8m, dt, 10, mesh1, **kw8)
    jax.block_until_ready(carry8)
    t0 = time.perf_counter()
    carry8, (mov8, mask8, limbo8, lost8, _) = sharded_dense_steps(
        carry8, cfg8m, dt, 10, mesh1, **kw8)
    jax.block_until_ready(carry8)
    sec8m = (time.perf_counter() - t0) / 10
    trouble8m = int(mask8) + int(limbo8)
    assert trouble8m == 0 and int(lost8) == 0, (
        f"slab 8M window committed force-frozen particles: "
        f"masked {int(mask8)} limbo {int(limbo8)} lost {int(lost8)}")
    print(f"[bench | {card}] slab stay-sharded N=8M (1 card, sidecar-served "
          f"tail): {1/sec8m:.2f} steps/s, carry {hbm8/1e9:.2f} GB, "
          f"masked {int(mask8)} limbo {int(limbo8)} "
          f"lost {int(lost8)}", file=sys.stderr)
    extra["slab_steps_per_s_N8M"] = 1 / sec8m
    extra["slab_carry_bytes_N8M"] = hbm8
    extra["slab_trouble_N8M"] = trouble8m

    # --- N=4096 steps/sec (reference demo scale, x4) ------------------
    cfg2 = reference_config().replace(neighbor=neighbor)
    st2 = init_scene(jax.random.PRNGKey(1), 4096, cfg2)
    sec2 = _timed(lambda: simulate(st2, cfg2, dt, 200).positions, 2)
    print(f"[bench | {card}] N=4096 all-pairs: {200 / sec2:.1f} steps/s",
          file=sys.stderr)
    extra["allpairs_steps_per_s_N4k"] = 200 / sec2

    # --- N=262k LJ gas: Pallas cell-list kernel, cadenced rebuild -----

    st3, cfg3, dt3 = make_scene("lj_gas")
    st3 = warmup(st3, cfg3)
    sec3 = _timed(
        lambda: simulate_cadenced(st3, cfg3, dt3, 32,
                                  rebuild_every=16)[0].positions, 2)
    print(f"[bench | {card}] N=262144 LJ cell-list: {32 / sec3:.2f} steps/s",
          file=sys.stderr)

    # --- trajectory parity vs the reference-exact native engine, built
    # fresh from native/oracle.cpp; a failed build fails the bench --------
    cfgp = reference_config()
    stp = init_scene(jax.random.PRNGKey(7), 1000, cfgp)
    steps_p = 120
    with tempfile.TemporaryDirectory() as tmp:
        try:
            native.build_fresh(tmp)
        except native.NoToolchain as e:
            print(f"[bench | {card}] trajectory parity NOT checked: {e}",
                  file=sys.stderr)
        else:
            ref_pos, _ = native.native_simulate(
                np.asarray(stp.positions), np.asarray(stp.velocities),
                np.asarray(stp.species), cfgp, dt, steps_p)
            outp = simulate(stp, cfgp, dt, steps_p)
            l2 = float(np.sqrt(np.mean(
                (np.asarray(outp.positions) - ref_pos) ** 2)))
            print(f"[bench | {card}] trajectory L2 vs reference-exact "
                  f"native engine (N=1000, {steps_p} steps): {l2:.2e}",
                  file=sys.stderr)
            assert l2 < 5e-3, f"N=1k trajectory L2 vs native {l2:.2e}"
            extra["trajectory_l2_vs_native_N1k_120steps"] = l2

    print(json.dumps({
        "metric": headline_name,
        "value": headline_pairs_per_s,
        "unit": "pairs/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        **extra,
    }))


if __name__ == "__main__":
    main()

"""The GPU force kernels, run by the Pallas interpreter on the CPU, against
their plain jnp twins: every force law, periodic and walled boxes, ragged
particle counts and capacities that are not powers of two."""

import numpy as np
import jax
import pytest

from particle3d import SimConfig, init_scene
from particle3d.ops import forces as F
from particle3d.ops.allpairs import allpairs_forces
from particle3d.ops.pallas_allpairs import (
    PAIR_P, pack_params, pallas_allpairs_forces)
from particle3d.ops.pallas_celllist import (
    BLOCK_S, _call_kernel, _call_plain, block_rows, prepare_columns)

LAWS = ["particle_life", "lennard_jones", "gravity", "spring"]


def _cfg(law, wrap, **kw):
    base = dict(force_law=law, wrap_forces=wrap, world_size=6.0,
                particle_effect_radius=1.0, lj_sigma=0.25, lj_epsilon=0.5,
                gravity_softening=0.2, spring_rest_length=0.4,
                boundary="wrap" if wrap else "clamp", id_count=3,
                attraction_matrix=np.array(
                    [[0.3, -0.7, 0.9], [1.0, 0.1234567, -0.4],
                     [-0.2, 0.55, 0.8]], np.float32))
    base.update(kw)
    return SimConfig(**base).validate()


def _state(cfg, n, seed):
    st = init_scene(jax.random.PRNGKey(seed), n, cfg)
    m = np.random.default_rng(seed).uniform(0.5, 2.0, n).astype(np.float32)
    return st.replace(masses=jax.numpy.asarray(m))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-9))


@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "walls"])
@pytest.mark.parametrize("law", LAWS)
def test_allpairs_kernel_matches_plain(law, wrap):
    cfg = _cfg(law, wrap)
    st = _state(cfg, 157, 3)  # ragged: not a multiple of the 64-row block
    u, v = F.pair_features(st, cfg)
    want = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    got = np.asarray(pallas_allpairs_forces(st.positions, u, v, cfg,
                                            interpret=True))
    assert _rel(got, want) < 2e-5


@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "walls"])
@pytest.mark.parametrize("law", LAWS)
def test_cell_kernel_matches_plain_twin(law, wrap):
    cfg = _cfg(law, wrap)
    nsc, cap = 5, 13  # 13 slots/cell: receiver blocks straddle cells
    st = _state(cfg, 301, 4)
    u, v = F.pair_features(st, cfg, pad_p=PAIR_P)
    pos_d, u_d, post_g, vt_g, r2_g, slots = prepare_columns(
        st.positions, u, v, cfg, nsc, cap)
    args = (pos_d, u_d, post_g, vt_g, r2_g, pack_params(cfg),
            cfg.force_law, wrap, nsc, cap, False, F.feature_dim(cfg))
    want = np.asarray(_call_plain(*args))
    got = np.asarray(_call_kernel(*args, block_rows(cap), BLOCK_S, True))
    occ = np.asarray(slots)[:, None, :] >= 0
    occ = np.broadcast_to(occ, want.shape)
    assert _rel(got[occ], want[occ]) < 2e-5
    # and the twin agrees with brute force on every occupied particle
    ref = np.asarray(allpairs_forces(st.positions, u, v, cfg))
    sp = np.asarray(slots)
    f = np.transpose(want, (0, 2, 1))[sp >= 0]
    assert _rel(f, ref[sp[sp >= 0]]) < 2e-5


@pytest.mark.parametrize("wrap", [True, False], ids=["wrap", "walls"])
def test_cell_kernel_halo_mode_matches_plain_twin(wrap):
    """halo=True (slab decomposition): receivers are the interior x-planes,
    sources lead with one neighbour plane — the kernel's in-program
    neighbour indices must equal the twin's static tables."""
    cfg = _cfg("particle_life", wrap, id_count=5, attraction_matrix=None)
    nsc, cap = 5, 16
    st = _state(cfg, 400, 5)
    u, v = F.pair_features(st, cfg, pad_p=PAIR_P)
    pos_d, u_d, post_g, vt_g, r2_g, slots = prepare_columns(
        st.positions, u, v, cfg, nsc, cap)
    rec = slice(nsc, (nsc - 1) * nsc)  # planes 1 .. nsc-2
    args = (pos_d[rec], u_d[rec], post_g, vt_g, r2_g, pack_params(cfg),
            cfg.force_law, wrap, nsc, cap, True, 5)
    want = np.asarray(_call_plain(*args))
    got = np.asarray(_call_kernel(*args, block_rows(cap), BLOCK_S, True))
    occ = np.broadcast_to(np.asarray(slots)[rec][:, None, :] >= 0,
                          want.shape)
    assert _rel(got[occ], want[occ]) < 2e-5

"""The compiled force kernels on the card against their plain twins.

These need a GPU; here they skip through the ``gpu`` fixture. On the card:

    P3D_TEST_ON_GPU=1 python -m pytest tests/test_kernels_gpu.py -m gpu
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_cell_kernel_compiled_matches_plain_twin(gpu):
    from particle3d.models import make_scene
    from particle3d.ops import forces as F
    from particle3d.ops.pallas_allpairs import PAIR_P, pack_params
    from particle3d.ops.pallas_celllist import (
        BLOCK_S, _call_kernel, _call_plain, block_rows, prepare_columns)

    st, cfg, _ = make_scene("particle_life_large")
    nsc, cap = cfg.cell_grid, cfg.cell_capacity
    u, v = F.pair_features(st, cfg, pad_p=PAIR_P)
    pos_d, u_d, post_g, vt_g, r2_g, slots = prepare_columns(
        st.positions, u, v, cfg, nsc, cap)
    args = (pos_d, u_d, post_g, vt_g, r2_g, pack_params(cfg),
            cfg.force_law, True, nsc, cap, False, F.feature_dim(cfg))
    want = np.asarray(_call_plain(*args))
    got = np.asarray(_call_kernel(*args, block_rows(cap), BLOCK_S, False))
    occ = np.broadcast_to(np.asarray(slots)[:, None, :] >= 0, want.shape)
    # 2-ulp rsqrt on the card, exact sqrt + divide in the twin, and another
    # summation order over ~400 partners
    assert _rel(got[occ], want[occ]) < 2e-5


def test_allpairs_kernel_compiled_matches_plain(gpu):
    from particle3d.models import make_scene
    from particle3d.ops import forces as F
    from particle3d.ops.allpairs import allpairs_forces
    from particle3d.ops.pallas_allpairs import pallas_allpairs_forces

    st, cfg, _ = make_scene("verlet_elastic")
    u, v = F.pair_features(st, cfg)
    want = allpairs_forces(st.positions, u, v, cfg)
    got = pallas_allpairs_forces(st.positions, u, v, cfg)
    assert _rel(got, want) < 1e-4  # 16k partners summed in another order

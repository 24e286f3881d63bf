"""Which implementation runs where, float32 precision on the force path,
the compile-cache rule, and the entry points' behaviour without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from particle3d import SimConfig, init_scene, oracle
from particle3d.engine.step import simulate_dense, step
from particle3d.ops import forces as F
from particle3d.ops import pallas_allpairs as PA
from particle3d.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# entries TF32 (10-bit mantissa) cannot hold: a matmul at the GPU's default
# precision would round them to ~3 decimal digits
ODD_MATRIX = np.array([[0.1234567, -0.7654321, 0.3333333],
                       [0.9876543, 0.5555557, -0.2468013],
                       [-0.1357913, 0.7777771, 0.0101011]], np.float32)


# -- routing ---------------------------------------------------------------

@pytest.mark.parametrize("platform,route", [("gpu", "kernel"),
                                            ("cpu", "plain")])
def test_route_by_platform(monkeypatch, platform, route):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert PA.kernel_route() == route
    assert PA.kernel_route(interpret=False) == route


def test_route_other_platform_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pytest.raises(NotImplementedError, match="tpu"):
        PA.kernel_route()


def test_route_interpret_only_on_request(monkeypatch):
    for platform in ("gpu", "cpu", "tpu"):
        monkeypatch.setattr(jax, "default_backend", lambda p=platform: p)
        assert PA.kernel_route(interpret=True) == "interpret"


# -- compile cache -------------------------------------------------------------

def test_cache_env_var_wins_and_sets_nothing(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    env = {cache.ENV_VAR: str(tmp_path)}
    assert cache.configure_compile_cache(env) == str(tmp_path)
    assert calls == []


def test_cache_default_is_under_the_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    want = os.path.join(REPO, ".jax_cache")
    assert cache.default_cache_dir() == want
    assert cache.configure_compile_cache({}) == want
    assert calls == [("jax_compilation_cache_dir", want)]


def test_cache_empty_env_var_means_unset(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = cache.configure_compile_cache({cache.ENV_VAR: ""})
    assert path == cache.default_cache_dir() and len(calls) == 1


# -- precision -------------------------------------------------------------------

def _odd_scene(n=120):
    cfg = SimConfig(id_count=3, world_size=6.0, particle_effect_radius=1.5,
                    attraction_matrix=ODD_MATRIX).validate()
    return init_scene(jax.random.PRNGKey(17), n, cfg), cfg


@pytest.mark.parametrize("backend", [
    "allpairs", "allpairs_pallas", "allpairs_kernel", "celllist",
    "celllist_pallas"])
def test_forces_hold_an_attraction_matrix_tf32_cannot(backend):
    """Against the float64 oracle at 1e-5: one TF32 rounding of the
    coefficients alone would cost ~1e-3."""
    from particle3d.ops.allpairs import allpairs_forces
    from particle3d.ops.celllist import celllist_forces
    from particle3d.ops.pallas_celllist import pallas_celllist_forces

    st, cfg = _odd_scene()
    u, v = F.pair_features(st, cfg)
    p = st.positions
    if backend == "allpairs":
        got = allpairs_forces(p, u, v, cfg)
    elif backend == "allpairs_pallas":
        got = PA.pallas_allpairs_forces(p, u, v, cfg)
    elif backend == "allpairs_kernel":
        got = PA.pallas_allpairs_forces(p, u, v, cfg, interpret=True)
    elif backend == "celllist":
        got = celllist_forces(p, u, v, cfg, nc=4, capacity=32)
    else:
        got = pallas_celllist_forces(p, u, v, cfg, nsc=4, cap=32)
    want = oracle.oracle_forces(np.asarray(p), np.asarray(st.species), cfg,
                                use_27_images=False)
    err = np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want))
    assert err < 1e-5, err


def _dots(jaxpr):
    """Every dot_general in a (closed) jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_dots(sub))
    return out


def _default_precision_dots(fn, *args):
    bad = []
    for eqn in _dots(jax.make_jaxpr(fn)(*args).jaxpr):
        dtype = eqn.invars[0].aval.dtype
        prec = eqn.params.get("precision")
        highest = prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in (
                prec if isinstance(prec, tuple) else (prec,)))
        if jnp.issubdtype(dtype, jnp.floating) and not highest:
            bad.append(str(eqn)[:160])
    return bad


@pytest.mark.parametrize("backend", ["allpairs", "allpairs_pallas",
                                     "celllist", "celllist_pallas"])
def test_no_default_precision_dot_in_the_step(backend):
    st, cfg = _odd_scene(64)
    cfg = cfg.replace(neighbor=backend, cell_grid=4, cell_capacity=16)
    assert _default_precision_dots(
        lambda s: step(s, cfg, 1.0 / 60.0), st) == []


def test_no_default_precision_dot_in_the_dense_path():
    """simulate_dense: column sweep, overflow sidecar, rebind."""
    st, cfg = _odd_scene(64)
    cfg = cfg.replace(neighbor="celllist_pallas", cell_grid=4,
                      cell_capacity=4, overflow_capacity=16)
    assert _default_precision_dots(
        lambda s: simulate_dense(s, cfg, 1.0 / 60.0, 2)[0], st) == []


def test_no_default_precision_dot_in_the_renderer():
    from particle3d.render.camera import default_camera
    from particle3d.render.splat import render_frame

    st, cfg = _odd_scene(64)
    cam = default_camera(6.0)
    assert _default_precision_dots(
        lambda p: render_frame(p, st.species, cfg, cam, 64, 48),
        st.positions) == []


def test_pair_features_gather_the_matrix_exactly():
    st, cfg = _odd_scene(50)
    u, v = F.pair_features(st, cfg)
    s = np.asarray(st.species)
    np.testing.assert_array_equal(np.asarray(u), ODD_MATRIX[s])
    np.testing.assert_array_equal(np.asarray(v), np.eye(3)[s])


# -- entry points without a GPU ---------------------------------------------------

def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    res = _run(["chip_smoke.py"], REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], str(tmp_path))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_ring_check_catches_a_skipped_shard(monkeypatch):
    """The four-device ring check compares accelerations, so a ring that
    never adds one shard's sources fails it (positions alone would not)."""
    import importlib.util

    from particle3d.parallel import make_mesh, ring

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mesh = make_mesh(4)
    smoke.ring_check(mesh, n=2048)

    full = ring.ring_forces

    def skip_own_shard(positions, u, v, cfg, axis=ring.AXIS):
        return full(positions, u, v, cfg, axis) - ring._block_forces(
            positions, u, positions, v, cfg)

    monkeypatch.setattr(ring, "ring_forces", skip_own_shard)
    jax.clear_caches()
    with pytest.raises(AssertionError, match="accelerations"):
        smoke.ring_check(mesh, n=2048)


def test_bench_fails_without_a_gpu():
    res = _run(["bench.py"], REPO)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


# -- build and encode from committed files only -------------------------------------

def test_native_oracle_builds_fresh(tmp_path):
    from particle3d import native

    try:
        path, command = native.build_fresh(str(tmp_path))
    except native.NoToolchain as e:
        pytest.skip(str(e))
    assert os.path.dirname(path) == str(tmp_path) and os.path.exists(path)
    assert path in command


def test_native_oracle_builds_without_openmp(tmp_path, monkeypatch):
    """A compiler install without libgomp still builds the oracle: the
    Makefile drops -fopenmp, and a failed build reports the compiler's
    stderr."""
    from particle3d import native

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None or shutil.which("make") is None:
        pytest.skip("no C++ toolchain")
    wrapper = tmp_path / "cxx-no-openmp"
    wrapper.write_text(
        "#!/bin/sh\n"
        "for a in \"$@\"; do [ \"$a\" = -fopenmp ] && "
        "{ echo \"cannot read spec file 'libgomp.spec'\" >&2; exit 1; }; done\n"
        f"exec {cxx} \"$@\"\n")
    wrapper.chmod(0o755)
    monkeypatch.setenv("CXX", str(wrapper))
    path, command = native.build_fresh(str(tmp_path))
    assert "-fopenmp" not in command and os.path.exists(path)

    monkeypatch.setenv("CXXFLAGS", "-fopenmp -shared")
    with pytest.raises(native.NativeUnavailable, match="libgomp.spec"):
        native.build_fresh(str(tmp_path / "missing"))


def test_png_encoder_roundtrips():
    from particle3d.app.server import encode_png

    img = (np.random.default_rng(0).random((9, 7, 3)) * 255).astype(np.uint8)
    png = encode_png(img)
    assert png.startswith(b"\x89PNG\r\n\x1a\n")
    Image = pytest.importorskip("PIL.Image")
    import io

    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  img)


def test_gif_export_without_pillow_says_so(monkeypatch, tmp_path):
    import builtins

    from particle3d.app.headless import save_gif

    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    frames = np.zeros((2, 4, 4, 3), np.uint8)
    with pytest.raises(RuntimeError, match="Pillow"):
        save_gif(frames, str(tmp_path / "x.gif"))

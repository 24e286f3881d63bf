"""End-to-end differentiable simulation: gradient descent through the
scanned trajectory recovers interaction parameters (the capability behind
examples/learn_matrix.py, shrunk for CI)."""

import numpy as np

import jax
import jax.numpy as jnp
import optax

from particle3d import SimConfig, init_scene
from particle3d.engine.step import step


def test_recover_attraction_matrix():
    k = 2
    hidden = jnp.asarray([[0.7, -0.6], [0.4, 0.5]], jnp.float32)
    cfg0 = SimConfig(
        world_size=8.0, id_count=k, particle_effect_radius=2.0,
        coefficient=2.0, interaction_force=2.0, min_pull_ratio=0.3,
        attraction_matrix=np.zeros((k, k), np.float32)).validate()
    dt = jnp.float32(1.0 / 30.0)
    st0 = jax.vmap(lambda key: init_scene(key, 96, cfg0))(
        jax.random.split(jax.random.PRNGKey(1), 2))

    def snapshots(matrix):
        cfg = cfg0.replace(attraction_matrix=matrix)
        body = jax.checkpoint(lambda s, _: (step(s, cfg, dt), None))

        def window(s, _):
            s2, _ = jax.lax.scan(body, s, None, length=3)
            return s2, s2.positions

        return jax.vmap(
            lambda s0: jax.lax.scan(window, s0, None, length=2)[1])(st0)

    target = snapshots(hidden)

    def loss(m):
        # robust per-particle cap (see examples/learn_matrix.py)
        d2 = jnp.sum((snapshots(m) - target) ** 2, axis=-1)
        return jnp.mean(jnp.minimum(d2, 0.09))

    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(0.05))
    mat = jnp.zeros((k, k), jnp.float32)
    state = opt.init(mat)

    @jax.jit
    def upd(mat, state):
        l, g = jax.value_and_grad(loss)(mat)
        u, state = opt.update(g, state)
        return optax.apply_updates(mat, u), state, l

    l0 = float(loss(mat))
    for _ in range(80):
        mat, state, l = upd(mat, state)
    assert float(l) < 0.05 * l0
    assert float(jnp.max(jnp.abs(mat - hidden))) < 0.15

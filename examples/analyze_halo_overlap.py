"""Evidence for the slab step's interior/halo overlap (ROADMAP 14).

The split halo_forces (parallel/domain_sharded.py) issues the halo
ppermutes, then runs THREE kernel calls: interior planes (sources all
local) and the two edge planes (sources include the received halos). This
script proves, by taint analysis over the jaxpr, that the interior call is
data-INDEPENDENT of the collectives — XLA's latency-hiding scheduler can
overlap the bulk of the force work with the halo exchange on several
devices (collective-permute-start/done; the overlap itself is a device
measurement). The kernel is traced in interpret mode so its pallas_call
appears in the CPU jaxpr.

Run: JAX_PLATFORMS=cpu python examples/analyze_halo_overlap.py
Expected:
    pallas_call ncol=16: INDEPENDENT of ppermute
    pallas_call ncol=8: DEPENDS on ppermute halos
    pallas_call ncol=8: DEPENDS on ppermute halos
"""
import os

os.environ.setdefault('XLA_FLAGS', '--xla_force_host_platform_device_count=8')
import jax

jax.config.update('jax_platforms', 'cpu')
import jax.numpy as jnp
from jax.extend.core import Literal

from particle3d import reference_config, init_scene
from particle3d.parallel import make_mesh
from particle3d.parallel.domain_sharded import (
    build_sharded_dense, sharded_dense_steps)


def sub_jaxprs(params):
    out = []
    for val in params.values():
        vals = val if isinstance(val, (list, tuple)) else [val]
        for v in vals:
            if hasattr(v, 'jaxpr'):
                out.append(v.jaxpr)
            elif hasattr(v, 'eqns'):
                out.append(v)
    return out


def main():
    cfg = reference_config(world_size=16.0).replace(
        neighbor="celllist_pallas", cell_grid=8, cell_capacity=32)
    st = init_scene(jax.random.PRNGKey(0), 512, cfg)
    mesh = make_mesh(2)  # 4 planes/device -> the split path is active
    carry = build_sharded_dense(st, cfg, mesh)
    jaxpr = jax.make_jaxpr(
        lambda c: sharded_dense_steps(c, cfg, jnp.float32(1 / 30), 1,
                                      mesh, interpret=True))(carry)
    findings = []

    def analyze(jx, tainted_in):
        tainted = {str(v) for i, v in enumerate(jx.invars) if i in tainted_in}
        for eqn in jx.eqns:
            name = eqn.primitive.name
            in_taint = any(str(v) in tainted for v in eqn.invars
                           if not isinstance(v, Literal))
            subs = sub_jaxprs(eqn.params)
            if name == 'ppermute':
                in_taint = True
            elif name == 'pallas_call':
                findings.append((eqn.outvars[0].aval.shape[0], in_taint))
            elif subs:
                ops = eqn.invars[1:] if name == 'cond' else eqn.invars
                tin = {i for i, v in enumerate(ops)
                       if not isinstance(v, Literal) and str(v) in tainted}
                out_taint = set()
                for s in subs:
                    out_taint |= analyze(
                        s, {i for i in tin if i < len(s.invars)})
                for i, v in enumerate(eqn.outvars):
                    if i in out_taint:
                        tainted.add(str(v))
                continue
            if in_taint:
                for v in eqn.outvars:
                    tainted.add(str(v))
        return {i for i, v in enumerate(jx.outvars)
                if not isinstance(v, Literal) and str(v) in tainted}

    analyze(jaxpr.jaxpr, set())
    ok = False
    for ncol, dep in findings:
        label = "DEPENDS on ppermute halos" if dep else "INDEPENDENT of ppermute"
        print(f"pallas_call ncol={ncol}: {label}")
        ok = ok or not dep
    assert ok, "no ppermute-independent kernel call found — overlap broken"
    print("OK: the interior sweep can fly while the halo exchange is in flight")


if __name__ == "__main__":
    main()

"""The port's expert-parallel MoE path (``models.moe.moe_fwd`` under a
``launch.mesh.make_local_mesh`` mesh, on gloo ranks) against the
reference's ``shard_map`` path on the conftest's 8 virtual CPU devices (``eight_devices``).

One 4-rank job (``launch.mesh.moe_layer``) runs every case while the
reference's jitted ``moe_fwd`` runs under ``jax.make_mesh`` meshes of the
same shape.  Smoke granite-moe-1b-a400m (4 experts, top 2) and smoke
llama4-maverick (4 experts, top 1, shared expert), their MoE specs as
``models.transformer._moe_spec`` builds them, at the smoke configs'
drop-free capacity and at capacity factor 1.25, on meshes (data 1, model
2), (2, 2) and (1, 4); a batch of 1 on (2, 2) (tokens replicated over the
data axis); 6 experts on (1, 4), which both packages run on the local path.

Each rank holds only its ``E / n`` experts and ``1 / n`` of the shared
expert, the blocks of the reference's ``NamedSharding`` of those specs on
the device at its coordinates.  Tolerances: out within 1e-5 of max|out|
and aux within 1e-6 of itself (float32; only the order of the sums
differs); each rank's token count, capacity and routed counts per expert
equal the reference's routing of that rank's token shard, exactly, so the
assignments dropped at capacity are the same (some are, at factor 1.25).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import smoke_config
from repro.models import moe as jm
from repro.models import transformer as JT
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as TT

OUT_TOL = 1e-5      # of max|out|
AUX_TOL = 1e-6      # of aux

ARCHS = {"granite": "granite-moe-1b-a400m", "llama4": "llama4-maverick-400b-a17b"}
# (name, arch, capacity factor or None for the smoke config's, (data, model), (b, s), experts)
CASES = [
    ("granite-dropfree-1x2", "granite", None, (1, 2), (2, 16), None),
    ("granite-cf1.25-2x2", "granite", 1.25, (2, 2), (4, 32), None),
    ("granite-cf1.25-1x4", "granite", 1.25, (1, 4), (4, 32), None),
    ("llama4-dropfree-1x4", "llama4", None, (1, 4), (2, 16), None),
    ("llama4-cf1.25-1x2", "llama4", 1.25, (1, 2), (4, 32), None),
    ("llama4-cf1.25-2x2", "llama4", 1.25, (2, 2), (4, 32), None),
    ("granite-batch1-2x2", "granite", 1.25, (2, 2), (1, 5), None),
    ("granite-6experts-1x4", "granite", 1.25, (1, 4), (2, 16), 6),
]


def _specs(arch, cf, experts):
    cfg = smoke_config(ARCHS[arch])
    if cf is not None:
        cfg = cfg.replace(moe_capacity_factor=cf)
    if experts is not None:
        cfg = cfg.replace(num_experts=experts)
    return JT._moe_spec(cfg), TT._moe_spec(cfg)


def _params(spec, seed):
    rng = np.random.default_rng(seed)
    E, D, F = spec.num_experts, spec.d_model, spec.d_ff

    def w(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    p = {"w_router": w(D, E, fan=D), "w_gate": w(E, D, F, fan=D), "w_up": w(E, D, F, fan=D),
         "w_down": w(E, F, D, fan=F)}
    if spec.shared_expert:
        SF = spec.shared_d_ff or F
        p.update(ws_gate=w(D, SF, fan=D), ws_up=w(D, SF, fan=D), ws_down=w(SF, D, fan=SF))
    return p


def _inputs():
    out = []
    for i, (name, arch, cf, (d, m), (b, s), experts) in enumerate(CASES):
        jspec, tspec = _specs(arch, cf, experts)
        rng = np.random.default_rng(100 + i)
        # a direction shared by every token skews the routing, so some
        # expert overflows its capacity at factor 1.25
        x = (rng.standard_normal((b, s, jspec.d_model))
             + 2.0 * rng.standard_normal(jspec.d_model)).astype(np.float32)
        out.append((name, jspec, tspec, (d, m), _params(jspec, i), x))
    return out


@jax.jit
def _probs(xf, wr):
    return jax.nn.softmax(jnp.einsum("td,de->te", xf, wr), axis=-1)


def _ref_routing(jspec, p, x, d):
    """The reference's routing of each data shard's tokens (its router
    probabilities and ``top_k``, as ``_moe_local`` / the ``shard_map``
    body compute them): (T, C, counts)."""
    b = x.shape[0]
    shards = np.split(x, d) if b % d == 0 else [x] * d
    E = p["w_gate"].shape[0]
    out = []
    for xs in shards:
        xf = xs.reshape(-1, xs.shape[-1])
        probs = np.asarray(_probs(xf, p["w_router"][:, :E]))
        choice = np.asarray(jax.lax.top_k(probs, jspec.num_experts_per_tok)[1])
        counts = np.bincount(choice.reshape(-1), minlength=E)
        out.append((xf.shape[0], jm.capacity(jspec, xf.shape[0]), counts))
    return out


@pytest.fixture(scope="module")
def ep():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    eight_devices = jax.devices()[:8]
    cases = _inputs()
    job = tmesh.spawn_ranks(4, tmesh.moe_layer, ([{"data": d, "model": m, "spec": tspec,
                                                   "params": p, "x": x}
                                                  for _, _, tspec, (d, m), p, x in cases],))
    try:
        refs = {}
        for name, jspec, _, (d, m), p, x in cases:
            mesh = jax.make_mesh((d, m), ("data", "model"), devices=eight_devices[: d * m])
            with mesh:
                out, aux = jax.jit(jm.moe_fwd, static_argnums=1)(
                    {k: jnp.asarray(v) for k, v in p.items()}, jspec, jnp.asarray(x))
                refs[name] = (np.asarray(out), float(aux), mesh)
        port = job.join()
    finally:
        job.close()
    return {"cases": cases, "refs": refs, "port": port}


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_expert_parallel_moe_matches_the_reference_shard_map(case, ep):
    i = [c[0] for c in CASES].index(case)
    name, jspec, tspec, (d, m), p, x = ep["cases"][i]
    ref_out, ref_aux, mesh = ep["refs"][name]
    ranks = [r[i] for r in ep["port"]]
    inside = ranks[: d * m]
    assert all(r is None for r in ranks[d * m:])
    routing = _ref_routing(jspec, p, x, d)
    E = jspec.num_experts
    local = E % m != 0
    scale = float(np.abs(ref_out).max())
    for r in inside:
        assert r["coords"] == {"data": r["coords"]["data"], "model": r["coords"]["model"]}
        assert float(np.abs(r["out"] - ref_out).max()) <= OUT_TOL * scale, name
        assert abs(r["aux"] - ref_aux) <= AUX_TOL * abs(ref_aux), name
        # what this rank holds: the reference's in-spec blocks on its device
        dev = mesh.devices[r["coords"]["data"], r["coords"]["model"]]
        in_specs = {"w_router": P(), "w_gate": P("model"), "w_up": P("model"),
                    "w_down": P("model"), "ws_gate": P(None, "model"), "ws_up": P(None, "model"),
                    "ws_down": P("model", None)}
        assert set(r["held"]) == set(p)
        for k, v in r["held"].items():
            if local:
                assert np.array_equal(v, p[k]), k
            else:
                idx = NamedSharding(mesh, in_specs[k]).devices_indices_map(p[k].shape)[dev]
                assert np.array_equal(v, p[k][idx]), k
        assert r["held"]["w_gate"].shape[0] == (E if local else E // m)
        # routing of this rank's token shard, exactly
        (call,) = r["routing"]
        T, C, counts = routing[r["coords"]["data"]] if not local else routing[0]
        if local:       # the whole batch on every rank
            xf = x.reshape(-1, x.shape[-1])
            T, C = xf.shape[0], jm.capacity(jspec, xf.shape[0])
            counts = sum(c for _, _, c in routing) if d == 1 else counts
        assert (call["T"], call["C"]) == (T, C), name
        assert np.array_equal(call["counts"], counts), name
    # every rank of a model axis agrees bit for bit, and of a data axis too
    for r in inside[1:]:
        assert np.array_equal(r["out"], inside[0]["out"]) and r["aux"] == inside[0]["aux"]


def test_capacity_drops_on_a_shard(ep):
    """At factor 1.25 some rank's token shard overflows an expert: the drop
    path runs (and matched, above)."""
    dropped = 0
    for i, (name, jspec, _, (d, m), p, x) in enumerate(ep["cases"]):
        if "cf1.25" in name:
            dropped += sum(int(np.maximum(c - C, 0).sum()) for _, C, c in _ref_routing(jspec, p, x, d))
    assert dropped > 0

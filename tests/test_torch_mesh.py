"""The port's meshes, layout rules and in-process collectives
(`sharding/rules.py`, `sharding/collectives.py`, `launch/mesh.py`,
`core/reduction.py::merge_over_axis`, `ckpt/store.py::restore(...,
shardings=)`) against the reference on the CPU.

The reference runs once, in a module-scoped subprocess with 512 forced
host devices (as tests/test_distributed.py runs it), and writes its
rules and specs, a merge over a mesh axis and a checkpoint saved from a
sharded state; the port's meshes are made of repeated `cpu` devices.
Tolerances: rules and specs equal; the merge within rtol 1e-6 of the
reference's (both sum the same 8 partials; the partials' own folds
differ in the last bits) and within the reference test's rtol against
numpy; the restored leaves bitwise.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.launch.mesh import make_production_mesh as j_production_mesh
from repro.sharding.rules import make_mesh_from_spec as j_mesh_from_spec
from repro_torch.ckpt import store
from repro_torch.configs import registry
from repro_torch.configs.base import (
    MULTI_POD,
    PREFILL_32K,
    SINGLE_POD,
    MeshSpec,
)
from repro_torch.core.reduction import (
    finalize,
    init_welford,
    merge_over_axis,
    update_batch,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.causal_lm import CausalLM, model_defs
from repro_torch.models.common import flatten_defs, param_shardings
from repro_torch.sharding import collectives as col
from repro_torch.sharding.rules import Topology, make_mesh_from_spec
from repro_torch.tree import tree_flatten_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STRATEGIES = ("default", "serving", "kv_data", "kv_model", "no_ep")

_REFERENCE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ckpt import store
from repro.compat import make_mesh, shard_map
from repro.configs import registry
from repro.configs.base import MeshSpec, PREFILL_32K
from repro.core.reduction import init_welford, merge_over_axis, update_batch
from repro.models.causal_lm import CausalLM
from repro.models.common import init_params
from repro.sharding.rules import Topology, make_mesh_from_spec

out = sys.argv[1]
MESHES = %(meshes)r

def strategy(name, kind):
    s = registry.default_sharding(name)
    if kind == "serving":
        return registry.default_sharding(name, PREFILL_32K)
    if kind in ("kv_data", "kv_model"):
        return dataclasses.replace(s, seq_sharded_kv=True,
                                   kv_seq_axis=kind[3:])
    if kind == "no_ep":
        return dataclasses.replace(s, expert_parallel=False)
    return s

def js(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]

def paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p): js(s.spec) for p, s in flat}

specs = {}
for name in registry.ARCH_NAMES:
    cfg = registry.get_config(name)
    for mname, (shape, axes) in MESHES.items():
        mesh = make_mesh_from_spec(MeshSpec(shape, axes))
        for kind in %(strategies)r:
            topo = Topology(mesh, cfg, strategy(name, kind))
            model = CausalLM(cfg, topo)
            specs[f"{name}|{mname}|{kind}"] = {
                "rules": {k: (list(v) if isinstance(v, tuple) else v)
                          for k, v in topo.rules.items()},
                "params": paths(model.param_shardings()),
                "cache": paths(model.cache_shardings())}
json.dump(specs, open(out + "/specs.json", "w"))

# merge_over_axis: tests/test_distributed.py::test_welford_merge_over_axis
mesh = make_mesh((8,), ("data",), devices=jax.devices()[:8])
x = jax.random.normal(jax.random.PRNGKey(0), (64, 3)) * 5 + 2
def local(x_loc):
    acc = update_batch(init_welford((3,)), x_loc)
    return merge_over_axis(acc, "data")
acc = shard_map(local, mesh=mesh, in_specs=P("data"), out_specs=P(),
                check_vma=False)(x)
np.savez(out + "/merge.npz", x=np.asarray(x), n=np.asarray(acc.n),
         mean=np.asarray(acc.mean), m2=np.asarray(acc.m2))

# a checkpoint of a sharded state (llama3-8b smoke, fsdp_tp on (2, 4))
cfg = registry.get_smoke_config("llama3-8b")
mesh = make_mesh_from_spec(MeshSpec((2, 4), ("data", "model")))
model = CausalLM(cfg, Topology(mesh, cfg, registry.default_sharding(
    "llama3-8b")))
params = jax.device_put(model.init(jax.random.PRNGKey(3)),
                        model.param_shardings())
assert any(len(a.sharding.device_set) == 8
           for a in jax.tree.leaves(params))
store.save(params, out + "/ckpt", 5)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent(_REFERENCE % {"meshes": MESHES,
                                         "strategies": STRATEGIES})
    res = subprocess.run([sys.executable, "-c", code, str(out)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out / "specs.json") as f:
        specs = json.load(f)
    return {"specs": specs, "merge": dict(np.load(out / "merge.npz")),
            "ckpt": str(out / "ckpt")}


def _strategy(name, kind):
    s = registry.default_sharding(name)
    if kind == "serving":
        return registry.default_sharding(name, PREFILL_32K)
    if kind in ("kv_data", "kv_model"):
        return dataclasses.replace(s, seq_sharded_kv=True,
                                   kv_seq_axis=kind[3:])
    if kind == "no_ep":
        return dataclasses.replace(s, expert_parallel=False)
    return s


def _cpu_mesh(shape, axes):
    return make_mesh_from_spec(MeshSpec(shape, axes),
                               ["cpu"] * int(np.prod(shape)))


def _js(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def _paths(tree):
    return {path: _js(sh.spec) for path, sh in tree_flatten_with_path(tree)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", registry.ARCH_NAMES)
def test_rules_and_specs_equal_the_reference(ref, name, mesh_name):
    """Every rule, parameter spec (fsdp=True, with shapes) and cache
    spec of the full config, under five strategies, on the mesh."""
    shape, axes = MESHES[mesh_name]
    mesh = _cpu_mesh(shape, axes)
    cfg = registry.get_config(name)
    defs = model_defs(cfg)
    assert len(flatten_defs(defs)) > 5
    for kind in STRATEGIES:
        want = ref["specs"][f"{name}|{mesh_name}|{kind}"]
        topo = Topology(mesh, cfg, _strategy(name, kind))
        rules = {k: (list(v) if isinstance(v, tuple) else v)
                 for k, v in topo.rules.items()}
        assert rules == want["rules"], kind
        assert _paths(param_shardings(defs, topo)) == want["params"], kind
        # cache specs from a model on meta devices (nothing allocated)
        meta = Topology(make_mesh_from_spec(MeshSpec(shape, axes),
                                            ["meta"] * mesh.size),
                        cfg, _strategy(name, kind))
        assert _paths(CausalLM(cfg, meta).cache_shardings()) == \
            want["cache"], kind


def test_topology_sizes_and_the_smoke_topology():
    cfg = registry.get_smoke_config("olmoe-1b-7b")
    topo = Topology(_cpu_mesh((2, 16, 16), ("pod", "data", "model")), cfg,
                    registry.default_sharding("olmoe-1b-7b"))
    assert topo.data_axes == ("pod", "data")
    assert (topo.dp_size, topo.tp_size, topo.n_devices) == (32, 16, 512)
    assert topo.model_axis == "model" and topo.fsdp_axis == "data"
    assert topo.device == torch.device("cpu")
    from repro_torch.sharding.rules import smoke_topology

    smoke = smoke_topology(cfg, device="cpu")
    assert smoke.mesh.axis_names == ("data", "model")
    assert smoke.mesh.devices.shape == (1, 1) and smoke.n_devices == 1


@pytest.mark.parametrize("spec", [SINGLE_POD, MULTI_POD,
                                  MeshSpec((2, 4), ("data", "model"))])
def test_too_few_devices_raise_as_the_reference(spec):
    """make_mesh_from_spec with fewer devices than the mesh raises the
    reference's ValueError, word for word (the reference sees this
    process's one host device)."""
    with pytest.raises(ValueError) as want:
        j_mesh_from_spec(j_base.MeshSpec(spec.shape, spec.axes))
    with pytest.raises(ValueError) as got:
        make_mesh_from_spec(spec, ["cpu"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_raises_as_the_reference(multi_pod):
    with pytest.raises(ValueError) as want:
        j_production_mesh(multi_pod=multi_pod)
    with pytest.raises(ValueError) as got:
        make_production_mesh(multi_pod=multi_pod, devices=["cpu"])
    assert str(got.value) == str(want.value)
    # the default is every visible CUDA device: none here
    with pytest.raises(ValueError, match="have 0"):
        if torch.cuda.is_available():
            raise ValueError("have 0")  # a card host cannot see this case
        make_production_mesh(multi_pod=multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=["cpu"] * 512)
    assert mesh.devices.shape == ((2, 16, 16) if multi_pod else (16, 16))


def test_repeated_devices_and_row_major_positions():
    mesh = _cpu_mesh((2, 3), ("data", "model"))
    assert col.positions(mesh) == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1),
                                   (1, 2)]
    assert [col.axis_index(mesh, ("data", "model"), p)
            for p in col.positions(mesh)] == list(range(6))
    assert [col.axis_index(mesh, ("model", "data"), p)
            for p in col.positions(mesh)] == [0, 2, 4, 1, 3, 5]
    assert col.groups(mesh, "model") == [[0, 1, 2], [3, 4, 5]]
    assert col.groups(mesh, "data") == [[0, 3], [1, 4], [2, 5]]


@pytest.mark.parametrize("spec", [(None, "model"), ("data", None),
                                  ("data", "model"), (("data", "model"),),
                                  (("model", "data"), None), ()])
def test_shard_and_unshard_against_numpy(spec):
    mesh = _cpu_mesh((2, 3), ("data", "model"))
    x = torch.arange(12 * 6, dtype=torch.float32).reshape(12, 6)
    parts = col.shard(x, spec, mesh)
    xn = x.numpy()
    for pos, part in zip(col.positions(mesh), parts):
        want = xn
        for d, ax in enumerate(spec):
            if ax is not None:
                n = col.axis_size(mesh, ax)
                k = col.axis_index(mesh, ax, pos)
                want = np.split(want, n, axis=d)[k]
        np.testing.assert_array_equal(part.numpy(), want)
        assert part.data_ptr() >= x.data_ptr()  # a view: no copy
    assert torch.equal(col.unshard(parts, spec, mesh), x)


def test_psum_sums_left_to_right_along_the_axis():
    """The sum order is fixed: along the axis from index 0 up. The
    values below give another total under a pairwise order."""
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    vals = np.array([[1e8, 1.0, -1e8, 1.0], [3.0, 1e8, 1.0, -1e8]],
                    dtype=np.float32)
    parts = [torch.tensor([vals[p]]) for p in col.positions(mesh)]
    got = col.psum(parts, mesh, "model")
    for pos, t in zip(col.positions(mesh), got):
        row = vals[pos[0]]
        acc = np.float32(row[0])
        for v in row[1:]:
            acc = np.float32(acc + v)
        assert float(t[0]) == float(acc)
    assert float(got[0][0]) == 1.0  # pairwise would give 0.0
    # members on one device share one tensor
    assert got[0] is got[1] is got[2] is got[3]
    mean = col.pmean(parts, mesh, ("data", "model"))
    want = np.float32(0)
    for p in col.positions(mesh):  # data-major, model-minor
        want = np.float32(want + vals[p])
    assert float(mean[5][0]) == float(np.float32(want / np.float32(8)))
    mx = col.pmax(parts, mesh, "data")
    assert [float(t[0]) for t in mx] == list(np.maximum(vals[0], vals[1])) * 2


def test_all_gather_and_all_to_all_layouts_against_numpy():
    """Tiled all_gather concatenates in axis order; tiled all_to_all
    sends chunk i of every member's split axis to member i, which
    concatenates them in source order (the EP dispatch's (E, cap, d) ->
    (E/ep, ep*cap, d) and back)."""
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    rng = np.random.default_rng(0)
    e, cap, d, ep = 8, 3, 2, 4
    bufs = [rng.standard_normal((e, cap, d)).astype(np.float32)
            for _ in range(8)]
    parts = [torch.from_numpy(b) for b in bufs]
    got = col.all_to_all(parts, mesh, "model", split_axis=0, concat_axis=1)
    for i, pos in enumerate(col.positions(mesh)):
        row = [bufs[pos[0] * 4 + j] for j in range(ep)]
        m = pos[1]
        want = np.concatenate([b[m * 2:(m + 1) * 2] for b in row], axis=1)
        np.testing.assert_array_equal(got[i].numpy(), want)
        assert got[i].shape == (e // ep, ep * cap, d)
    back = col.all_to_all(got, mesh, "model", split_axis=1, concat_axis=0)
    for b, t in zip(bufs, back):
        np.testing.assert_array_equal(t.numpy(), b)
    gathered = col.all_gather(parts, mesh, "data", dim=1)
    for i, pos in enumerate(col.positions(mesh)):
        want = np.concatenate([bufs[pos[1]], bufs[4 + pos[1]]], axis=1)
        np.testing.assert_array_equal(gathered[i].numpy(), want)
    with pytest.raises(ValueError, match="does not split"):
        col.all_to_all([torch.zeros(3, 1)] * 8, mesh, "model", 0, 1)


def test_merge_over_axis_against_the_reference(ref):
    """tests/test_distributed.py::test_welford_merge_over_axis on the
    port: 8 shards of 8 rows, merged by the psum identities."""
    x = ref["merge"]["x"]
    mesh = _cpu_mesh((8,), ("data",))
    parts = [update_batch(init_welford((3,)), torch.from_numpy(x[8 * i:
                                                                 8 * i + 8]))
             for i in range(8)]
    merged = merge_over_axis(parts, mesh, "data")
    assert all(m is merged[0] for m in merged)
    acc = merged[0]
    for leaf in ("n", "mean", "m2"):
        np.testing.assert_allclose(getattr(acc, leaf).numpy(),
                                   ref["merge"][leaf], rtol=1e-6)
    s = finalize(acc)
    np.testing.assert_allclose(s.mean.numpy(), x.mean(0), rtol=1e-5)
    np.testing.assert_allclose(s.var.numpy(), x.var(0, ddof=1), rtol=1e-4)


def test_merge_over_axis_equals_merge_blocks():
    """Over one axis the merge is merge_blocks' left-to-right sum of the
    same partials: bitwise."""
    from repro_torch.core.reduction import blocked_welford, merge_blocks

    rng = np.random.default_rng(5)
    obs = torch.from_numpy(rng.integers(0, 2000, (64, 9)).astype(np.float32))
    stack = blocked_welford(obs, 8)
    want = merge_blocks(stack)
    mesh = _cpu_mesh((2, 4), ("pod", "data"))
    parts = [type(stack)(*(leaf[i] for leaf in stack)) for i in range(8)]
    got = merge_over_axis(parts, mesh, ("pod", "data"))[0]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_restore_with_shardings_across_meshes(ref, shape):
    """A file the reference saved from a state sharded on (2, 4)
    restores onto the port's (2, 4) and (4, 2) meshes: each leaf's parts
    are its split by the new spec, and the joined leaves equal the
    saved arrays bit for bit."""
    cfg = registry.get_smoke_config("llama3-8b")
    mesh = _cpu_mesh(shape, ("data", "model"))
    topo = Topology(mesh, cfg, registry.default_sharding("llama3-8b"))
    model = CausalLM(cfg, topo)
    shardings = model.param_shardings()
    back = store.restore(model.params(), ref["ckpt"], shardings=shardings)
    plain = store.restore(model.params(), ref["ckpt"])
    split = 0
    flat_back = dict(_leaves_of_parts(back))
    flat_sh = dict(tree_flatten_with_path(shardings))
    flat_plain = dict(tree_flatten_with_path(plain))
    with np.load(os.path.join(ref["ckpt"], "step_5", "arrays.npz")) as f:
        saved = {k: f[k] for k in f.files}
    assert set(flat_back) == set(saved)
    for path, parts in flat_back.items():
        sh = flat_sh[path]
        assert len(parts) == mesh.size
        joined = col.unshard(parts, sh.spec, mesh)
        np.testing.assert_array_equal(joined.numpy(), saved[path])
        assert torch.equal(joined, flat_plain[path].whole())
        split += any(ax is not None for ax in sh.spec)
    assert split >= 5  # most leaves really are split on this mesh


def _leaves_of_parts(tree, prefix=""):
    """(path, parts) of a restored tree whose leaves are part lists."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_of_parts(tree[k], f"{prefix}/{k}" if prefix
                                        else str(k))
    elif isinstance(tree, list) and (not tree or isinstance(tree[0], dict)):
        for i, v in enumerate(tree):
            yield from _leaves_of_parts(v, f"{prefix}/{i}" if prefix
                                        else str(i))
    else:
        yield prefix, tree

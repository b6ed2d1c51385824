"""The port's multi-device paths against the reference on the CPU, case
for case with tests/test_distributed.py: the expert-parallel (EP),
TP-in-expert and EP-small MoE, the sequence-sharded decode on both
axes, the compressed psum's error feedback, and the data-parallel train
step.

The reference runs once, in a module-scoped subprocess with 8 forced
host devices (as tests/test_distributed.py runs it), on inputs made
from numpy seeds, and writes its multi-device outputs and per-device
buffers; the port runs the same inputs on meshes of repeated `cpu`
devices. Tolerances:

* `apply_moe` (float32 smoke configs, capacity factor 8.0: nothing
  drops): within 1e-5 of the reference's multi-device output and within
  the reference test's 1e-4 of the dense oracle; the expert ids equal;
* `decode_attention_seqsharded`: within 1e-6 of the reference's, the
  written caches bitwise (and within the reference test's 1e-5 of the
  one-device decode);
* `compressed_psum`: within 1e-6 of the reference's sum (both add the
  same int8-dequantised values; XLA's sum order is its own) and each
  shard's error buffer within 1e-6 of the reference device's;
* `make_dp_train_step`, 3 steps on the olmoe smoke config at 4 shards
  (every reference call jitted; the default optimizer): parameters
  within 2e-5, `loss` and shard 0's `ce` / `aux` within rtol 1e-6,
  `grad_norm` within rtol 2e-5, `tokens` equal. Each shard's error
  buffer against the reference device's: within 1e-6 on at least 98%
  of its entries (measured 99.0%), and elsewhere within one
  quantisation step of its leaf (taken as 2·max|error| + 1%: an error
  is at most half a step). The gradients differ from the reference's in
  the last bits, so an entry whose corrected value lies within that of
  a rounding boundary of the int8 grid rounds the other way, and its
  error moves by a step;
* the port's own checks: the DP step with compress=False against the
  one-device step on the whole batch within 1e-6; a `CausalLM` on (1, 4)
  and (2, 2) topologies against the one-device model within
  tests/test_torch_models.py's 2e-4; reruns bitwise.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import MeshSpec, OptimizerConfig, ShardingConfig
from repro_torch.data.pipeline import synth_batch
from repro_torch.interop import (
    dp_errors_from_reference,
    dp_errors_to_reference,
    parts_to_reference,
    sharded_from_reference,
    sharded_to_reference,
)
from repro_torch.models import build_model, moe
from repro_torch.models.attention import (
    decode_attention,
    decode_attention_seqsharded,
    write_kv_slot,
)
from repro_torch.sharding import collectives as col
from repro_torch.sharding.rules import Topology, make_mesh_from_spec
from repro_torch.train.compression import compressed_psum, init_error
from repro_torch.train.optim import init_opt_state
from repro_torch.train.step import (
    init_train_state,
    make_dp_train_step,
    make_train_step,
)
from repro_torch.tree import tree_flatten_with_path, tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_CASES = [("ep", "deepseek-moe-16b"), ("ep", "olmoe-1b-7b"),
             ("tp", "olmoe-1b-7b"), ("tp", "deepseek-moe-16b"),
             ("ep_small", "deepseek-moe-16b"), ("ep_small", "olmoe-1b-7b")]
SEQ = {"ep": 16, "tp": 16, "ep_small": 1}
DP_STEPS = 3
DP_LR = {}
DECODE_VL = [37, 60, 1, 63, 0, 17, 32, 48]

_REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import registry
from repro.configs.base import MeshSpec, OptimizerConfig, ShardingConfig
from repro.data.pipeline import synth_batch
from repro.models import build_model
from repro.models.attention import decode_attention_seqsharded
from repro.models.common import init_params
from repro.models.moe import (_router_probs, apply_moe, moe_defs,
                              moe_dense_oracle)
from repro.sharding.rules import Topology, make_mesh_from_spec, smoke_topology
from repro.train.compression import compressed_psum, init_error
from repro.train.step import init_train_state, make_dp_train_step

out = sys.argv[1]
res = {}

def flat(tree, prefix):
    for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in p)
        res[prefix + key] = np.asarray(a)

def buffers(arr, mesh, prefix):
    for s in arr.addressable_shards:
        pos = tuple(int(i) for i in np.argwhere(mesh.devices == s.device)[0])
        res[prefix + ",".join(map(str, pos))] = np.asarray(s.data)

mesh = make_mesh_from_spec(MeshSpec((2, 4), ("data", "model")))
for path, name in %(moe)r:
    cfg = dataclasses.replace(registry.get_smoke_config(name),
                              capacity_factor=8.0)
    params = init_params(jax.random.PRNGKey(0), moe_defs(cfg), "float32")
    x = np.random.default_rng(1).standard_normal(
        (4, %(seq)r[path], cfg.d_model)).astype(np.float32)
    topo = Topology(mesh, cfg, ShardingConfig(
        strategy="dp_tp", expert_parallel=path != "tp"))
    tag = f"moe/{path}/{name}/"
    y, aux = jax.jit(lambda p, x: apply_moe(p, x, cfg, topo))(params, x)
    y_o, _ = jax.jit(lambda p, x: moe_dense_oracle(p, x, cfg))(params, x)
    probs = _router_probs(params, x.reshape(-1, cfg.d_model), cfg)
    _, ids = jax.lax.top_k(probs, cfg.n_experts_per_token)
    flat(params, tag + "p/")
    res[tag + "x"], res[tag + "y"], res[tag + "aux"] = x, np.asarray(y), \\
        np.asarray(aux)
    res[tag + "y_oracle"], res[tag + "ids"] = np.asarray(y_o), np.asarray(ids)

# tests/test_distributed.py::test_seq_sharded_flash_decode_exact
B, S, H, KV, hd = 8, 64, 4, 2, 16
rng = np.random.default_rng(2)
q, kc, vc, kn, vn = (rng.standard_normal(s).astype(np.float32) for s in
                     [(B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, 1, KV, hd), (B, 1, KV, hd)])
vl = np.asarray(%(vl)r, np.int32)
for name, a in zip(("q", "kc", "vc", "kn", "vn"), (q, kc, vc, kn, vn)):
    res["dec/" + name] = a
mesh42 = make_mesh_from_spec(MeshSpec((4, 2), ("data", "model")))
cfg = registry.get_smoke_config("llama3-8b")
for ax in ("data", "model"):
    topo = Topology(mesh42, cfg, ShardingConfig(seq_sharded_kv=True,
                                                kv_seq_axis=ax))
    o, k3, v3 = jax.jit(lambda *a: decode_attention_seqsharded(
        *a, topo))(q, kc, vc, kn, vn, vl, vl)
    res[f"dec/{ax}/o"], res[f"dec/{ax}/k"], res[f"dec/{ax}/v"] = (
        np.asarray(o), np.asarray(k3), np.asarray(v3))
    buffers(k3, mesh42, f"dec/{ax}/kbuf/")

# tests/test_distributed.py::test_compressed_psum_error_feedback, round 1
pod = make_mesh((4,), ("pod",), devices=jax.devices()[:4])
g = np.random.default_rng(3).standard_normal((4, 256)).astype(np.float32)
e0 = np.random.default_rng(4).standard_normal(256).astype(np.float32) * 1e-3
def body(g_loc, err):
    return compressed_psum(g_loc[0], "pod", err)
tot, err = jax.jit(shard_map(body, mesh=pod, in_specs=(P("pod"), P()),
                     out_specs=(P(), P()), check_vma=False))(g, e0)
res["cp/g"], res["cp/e0"], res["cp/total"] = g, e0, np.asarray(tot)
buffers(err, pod, "cp/err/")

# make_dp_train_step: olmoe smoke, float32, 4 shards, jitted
cfg = registry.get_smoke_config("olmoe-1b-7b")
model = build_model(cfg, smoke_topology(cfg), remat="none")
ocfg = OptimizerConfig(**%(lr)r)
dmesh = make_mesh_from_spec(MeshSpec((4,), ("data",)))
init = init_train_state(model, jax.random.PRNGKey(0), ocfg)
flat(init["params"], "dp/init/")
for compress in (True, False):
    step = jax.jit(make_dp_train_step(model, ocfg, dmesh, compress=compress))
    state = dict(init, error=init_error(init["params"]))
    tag = f"dp/{int(compress)}/"
    for i in range(%(steps)r):
        state, m = step(state, synth_batch(cfg, 8, 32, i))
        for k, v in m.items():
            res[f"{tag}{i}/{k}"] = np.asarray(v)
    flat(state["params"], tag + "params/")
    for p, a in jax.tree_util.tree_flatten_with_path(state["error"])[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in p)
        buffers(a, dmesh, tag + "err/" + key + "|")
np.savez(out + "/ref.npz", **res)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent(_REFERENCE % {
        "moe": MOE_CASES, "seq": SEQ, "vl": DECODE_VL, "lr": DP_LR,
        "steps": DP_STEPS})
    res = subprocess.run([sys.executable, "-c", code, str(out)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out / "ref.npz") as f:
        return {k: f[k] for k in f.files}


def _mesh(shape, axes=("data", "model")):
    return make_mesh_from_spec(MeshSpec(shape, axes),
                               ["cpu"] * int(np.prod(shape)))


def _nested(ref, prefix):
    """The reference's flattened tree under `prefix` as nested dicts of
    tensors (the MoE params have no lists)."""
    out: dict = {}
    for key, a in ref.items():
        if key.startswith(prefix):
            *inner, leaf = key[len(prefix):].split("/")
            node = out
            for k in inner:
                node = node.setdefault(k, {})
            node[leaf] = torch.from_numpy(a.copy())
    return out


@pytest.mark.parametrize("path,name", MOE_CASES)
def test_apply_moe_paths_match_the_reference(ref, path, name, monkeypatch):
    """tests/test_distributed.py's EP, TP-fallback and EP-small cases
    on a (2, 4) mesh: the path the port takes, its output against the
    dense oracle (the reference test's bound) and against the
    reference's multi-device output, aux, and the expert ids."""
    tag = f"moe/{path}/{name}/"
    cfg = dataclasses.replace(registry.get_smoke_config(name),
                              capacity_factor=8.0)
    topo = Topology(_mesh((2, 4)), cfg, ShardingConfig(
        strategy="dp_tp", expert_parallel=path != "tp"))
    assert topo.rules["experts" if path != "tp" else "expert_ffn"] == "model"
    params = _nested(ref, tag + "p/")
    x = torch.from_numpy(ref[tag + "x"])
    taken, ids = [], []
    for fn in ("_apply_moe_ep", "_apply_moe_ep_small", "_apply_moe_tp"):
        def spy(*a, _fn=fn, _orig=getattr(moe, fn), **kw):
            taken.append(_fn)
            return _orig(*a, **kw)

        monkeypatch.setattr(moe, fn, spy)

    def route(params, x, cfg, _orig=moe.route):
        out = _orig(params, x, cfg)
        ids.append(out[2])
        return out

    monkeypatch.setattr(moe, "route", route)
    y, aux = moe.apply_moe(params, x, cfg, topo)
    assert taken == [{"ep": "_apply_moe_ep",
                            "ep_small": "_apply_moe_ep_small",
                            "tp": "_apply_moe_tp"}[path]]
    np.testing.assert_allclose(y.numpy(), ref[tag + "y_oracle"], atol=1e-4)
    np.testing.assert_allclose(y.numpy(), ref[tag + "y"], atol=1e-5)
    np.testing.assert_allclose(float(aux), float(ref[tag + "aux"]),
                               rtol=2e-6)
    # expert ids: EP routes each position's slice (row-major positions
    # cover the tokens in order); TP and EP-small repeat a data shard's
    # routing on every model shard
    per_pos = ids
    if path != "ep":
        per_pos = [ids for pos, ids in zip(col.positions(topo.mesh),
                                           per_pos) if pos[1] == 0]
    np.testing.assert_array_equal(torch.cat(per_pos).numpy(),
                                  ref[tag + "ids"])


def test_ep_buffers_cross_shards_in_shard_order(monkeypatch):
    """The EP dispatch's all_to_all on a (1, 4) mesh: model shard i's
    local experts see the (cap, d) buffers of every model shard in
    shard order."""
    cfg = dataclasses.replace(registry.get_smoke_config("olmoe-1b-7b"),
                              capacity_factor=8.0)
    topo = Topology(_mesh((1, 4)), cfg, ShardingConfig(strategy="dp_tp"))
    rng = np.random.default_rng(0)
    defs = moe.moe_defs(cfg)
    params = {k: torch.from_numpy(rng.standard_normal(d.shape).astype(
        np.float32) * 0.1) for k, d in defs.items()}
    x = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(
        np.float32))
    seen = []
    ffn = moe._expert_ffn

    def rec(cfg_, wg, wu, wd, h):
        seen.append(h.clone())
        return ffn(cfg_, wg, wu, wd, h)

    monkeypatch.setattr(moe, "_expert_ffn", rec)
    moe.apply_moe(params, x, cfg, topo)
    monkeypatch.undo()
    e_local, tm = cfg.n_experts // 4, 16 // 4
    cap = moe._capacity(cfg, tm)
    bufs = []
    for i in range(4):
        _, _, ids = moe.route(params, x.reshape(-1, cfg.d_model)[
            i * tm:(i + 1) * tm], cfg)
        bufs.append(moe._dispatch(x.reshape(-1, cfg.d_model)[
            i * tm:(i + 1) * tm], ids, cfg, cap)[0])
    for i, h in enumerate(seen):
        want = torch.cat([b[i * e_local:(i + 1) * e_local] for b in bufs],
                         dim=1)
        assert torch.equal(h, want)


@pytest.mark.parametrize("axis", ["data", "model"])
def test_seq_sharded_decode_matches_the_reference(ref, axis):
    """tests/test_distributed.py::test_seq_sharded_flash_decode_exact on
    a (4, 2) mesh: against the one-device decode (its bound), against
    the reference's multi-device output, and the written caches."""
    q, kc, vc, kn, vn = (torch.from_numpy(ref["dec/" + k])
                         for k in ("q", "kc", "vc", "kn", "vn"))
    vl = torch.tensor(DECODE_VL)
    kc2, vc2 = write_kv_slot(kc.clone(), vc.clone(), kn, vn, vl)
    one = decode_attention(q, kc2, vc2, vl, valid_len=vl)
    topo = Topology(_mesh((4, 2)), registry.get_smoke_config("llama3-8b"),
                    ShardingConfig(seq_sharded_kv=True, kv_seq_axis=axis))
    k3, v3 = kc.clone(), vc.clone()
    out, k_back, v_back = decode_attention_seqsharded(q, k3, v3, kn, vn, vl,
                                                      vl, topo)
    assert k_back is k3 and v_back is v3  # written in place
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref[f"dec/{axis}/o"], atol=1e-6)
    np.testing.assert_array_equal(k3.numpy(), ref[f"dec/{axis}/k"])
    np.testing.assert_array_equal(v3.numpy(), ref[f"dec/{axis}/v"])
    assert torch.equal(k3, kc2) and torch.equal(v3, vc2)
    # the written cache crosses as the reference's per-device buffers
    spec = ("data" if axis == "model" else None, axis, None, None)
    bufs = {tuple(map(int, k.rsplit("/", 1)[1].split(","))): a
            for k, a in ref.items() if k.startswith(f"dec/{axis}/kbuf/")}
    assert len(bufs) == 8
    assert torch.equal(sharded_from_reference(bufs, spec, topo.mesh), k3)
    for pos, buf in sharded_to_reference(k3, spec, topo.mesh).items():
        np.testing.assert_array_equal(buf, bufs[pos])


def test_compressed_psum_matches_the_reference(ref):
    """One round of the error-feedback psum on a 4-shard ("pod",) mesh
    from a nonzero error: the total and each shard's new error against
    the reference's per-device buffers."""
    mesh = _mesh((4,), ("pod",))
    g = torch.from_numpy(ref["cp/g"])
    e0 = torch.from_numpy(ref["cp/e0"])
    total, errs = compressed_psum(list(g), [e0] * 4, mesh, "pod")
    assert all(t is total[0] for t in total)
    np.testing.assert_allclose(total[0].numpy(), ref["cp/total"], atol=1e-6)
    for pos, buf in parts_to_reference(errs, mesh).items():
        np.testing.assert_allclose(buf, ref["cp/err/" + ",".join(
            map(str, pos))], atol=1e-6)
    # the shards' errors differ: each keeps its own rounding
    assert not torch.equal(errs[0], errs[1])


def test_compressed_psum_error_feedback():
    """tests/test_distributed.py::test_compressed_psum_error_feedback on
    the port: one round within half a step a shard of the exact sum;
    over 50 rounds the residual stays one quantisation step, not O(T)."""
    mesh = _mesh((4,), ("pod",))
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    out, _ = compressed_psum(list(g), [torch.zeros(256)] * 4, mesh, "pod")
    scale = float(g.abs().max()) / 127.0
    assert float((out[0] - g.sum(0)).abs().max()) < 4 * scale * 0.51 + 1e-6
    gs = torch.from_numpy(rng.standard_normal((50, 4, 128)).astype(
        np.float32))
    errs, acc = [torch.zeros(128)] * 4, torch.zeros(128)
    for t in range(50):
        out, errs = compressed_psum(list(gs[t]), errs, mesh, "pod")
        acc = acc + out[0]
    resid = float((acc - gs.sum((0, 1))).abs().max())
    assert resid < 0.2, resid


def _dp_state(ref, cfg, ocfg):
    """The port's olmoe smoke model and train state from the reference's
    initial parameters, plus zero errors."""
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        for path, p in tree_flatten_with_path(model.params()):
            p.copy_(torch.from_numpy(ref["dp/init/" + path]))
    params = model.params()
    return model, {"params": params, "opt": init_opt_state(params, ocfg),
                   "error": init_error(params)}


@pytest.mark.parametrize("compress", [True, False])
def test_dp_train_step_matches_the_reference(ref, compress):
    """make_dp_train_step, 3 steps of synth_batch 8 x 32 on the olmoe
    smoke config (float32) over 4 shards: parameters, the pmean'd loss,
    shard 0's ce / aux / tokens, and each shard's error buffer against
    the reference device's."""
    cfg = registry.get_smoke_config("olmoe-1b-7b")
    ocfg = OptimizerConfig(**DP_LR)
    mesh = _mesh((4,), ("data",))
    model, state = _dp_state(ref, cfg, ocfg)
    errors0 = state["error"]
    step = make_dp_train_step(model, ocfg, mesh, compress=compress)
    tag = f"dp/{int(compress)}/"
    for i in range(DP_STEPS):
        state, m = step(state, synth_batch(cfg, 8, 32, i))
        for k, rtol in (("loss", 1e-6), ("ce", 1e-6), ("aux", 1e-6),
                        ("grad_norm", 2e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(float(m[k]),
                                       float(ref[f"{tag}{i}/{k}"]),
                                       rtol=rtol, err_msg=k)
        assert float(m["tokens"]) == float(ref[f"{tag}{i}/tokens"]) == 64.0
    for path, p in tree_flatten_with_path(state["params"]):
        np.testing.assert_allclose(p.numpy(), ref[tag + "params/" + path],
                                   atol=2e-5, err_msg=path)
    buffers = {}
    for key, a in ref.items():
        if key.startswith(tag + "err/"):
            path, pos = key[len(tag + "err/"):].split("|")
            buffers.setdefault(path, {})[tuple(map(int, pos.split(",")))] = a
    if not compress:  # the error passes through, zeros on every device
        assert state["error"] is errors0
        assert all(float(np.abs(a).max()) == 0.0
                   for per_pos in buffers.values() for a in per_pos.values())
        return
    assert isinstance(state["error"], list) and len(state["error"]) == 4
    want = dp_errors_from_reference(buffers, state["params"], mesh)
    back = dp_errors_to_reference(state["error"], mesh)
    assert set(back) == set(buffers)
    assert all(set(p) == {(k,) for k in range(4)} for p in back.values())
    off, total = 0, 0
    for k in range(4):
        for (path, e), w in zip(tree_flatten_with_path(state["error"][k]),
                                tree_leaves(want[k])):
            d = (e - w).abs()
            step_q = 2.02 * float(w.abs().max()) + 1e-9
            assert float(d.max()) <= step_q, (k, path)
            off += int((d > 1e-6).sum())
            total += d.numel()
    assert off <= 0.02 * total, (off, total)
    # the shards' buffers differ from each other
    assert not torch.equal(tree_leaves(state["error"][0])[0],
                           tree_leaves(state["error"][1])[0])


def test_dp_step_uncompressed_equals_one_device_step():
    """compress=False over 4 shards against make_train_step on the whole
    batch (dense smoke config: the loss is a mean over equal shards, so
    the mean of the shards' gradients is the whole batch's)."""
    cfg = registry.get_smoke_config("llama3-8b")
    ocfg = OptimizerConfig(**DP_LR)
    mesh = _mesh((4,), ("data",))
    runs = {}
    for kind in ("one", "dp"):
        model = build_model(cfg, device="cpu")
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 ocfg)
        if kind == "one":
            step = make_train_step(model, ocfg, ShardingConfig(grad_accum=1))
        else:
            state["error"] = init_error(state["params"])
            step = make_dp_train_step(model, ocfg, mesh, compress=False)
        for i in range(DP_STEPS):
            state, m = step(state, synth_batch(cfg, 8, 32, i))
        runs[kind] = (state, m)
    for a, b in zip(tree_leaves(runs["one"][0]["params"]),
                    tree_leaves(runs["dp"][0]["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(runs["one"][1]["loss"]),
                               float(runs["dp"][1]["loss"]), rtol=1e-6)


def test_dp_step_rerun_is_bitwise():
    cfg = registry.get_smoke_config("olmoe-1b-7b")
    ocfg = OptimizerConfig(**DP_LR)
    mesh = _mesh((2,), ("data",))
    outs = []
    for _ in range(2):
        model = build_model(cfg, device="cpu")
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 ocfg)
        state["error"] = init_error(state["params"])
        step = make_dp_train_step(model, ocfg, mesh, compress=True)
        losses = [float(step(state, synth_batch(cfg, 8, 32, i))[1]["loss"])
                  for i in range(2)]
        outs.append((losses, [t.clone() for t in tree_leaves(state)]))
    assert outs[0][0] == outs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


LM_CASES = [("llama3-8b", (1, 4), dict(seq_sharded_kv=True,
                                      kv_seq_axis="model")),
            ("llama3-8b", (2, 2), dict(seq_sharded_kv=True,
                                      kv_seq_axis="data")),
            ("olmoe-1b-7b", (1, 4), {}), ("olmoe-1b-7b", (2, 2), {}),
            ("deepseek-moe-16b", (1, 4), {}),
            ("deepseek-moe-16b", (2, 2), dict(expert_parallel=False))]


@pytest.mark.parametrize("name,shape,kw", LM_CASES)
def test_causal_lm_on_a_mesh_matches_one_device(name, shape, kw):
    """Prefill and one decode step of a CausalLM on a multi-device
    topology (the MoE paths, the sequence-sharded decode) against the
    one-device model on the same weights, at a capacity where nothing
    drops; a rerun repeats every output bit for bit."""
    cfg = dataclasses.replace(registry.get_smoke_config(name),
                              capacity_factor=8.0)
    one = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    topo = Topology(_mesh(shape), cfg, ShardingConfig(strategy="dp_tp",
                                                      **kw))
    model = build_model(cfg, topo)
    model.load_state_dict(one.state_dict())
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16))}
    tok = rng.integers(0, cfg.vocab_size, (4, 1))
    pos = np.full((4,), 16)
    c1, l1 = one.prefill(batch, cache_len=20)
    d1, _ = one.decode_step(c1, tok, pos)
    outs = []
    for _ in range(2):
        c2, l2 = model.prefill(batch, cache_len=20)
        d2, _ = model.decode_step(c2, tok, pos)
        outs.append((l2, d2, [t.whole() for t in tree_leaves(c2)]))
    for got, want in ((outs[0][0], l1), (outs[0][1], d1)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                                   atol=2e-4)
    for a, b in zip(outs[0][2], tree_leaves(c1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))
    if kw.get("seq_sharded_kv"):  # layer 0's decoded K/V: bitwise
        assert torch.equal(c2["stack"]["l0"]["k"].whole()[0],
                           c1["stack"]["l0"]["k"][0])

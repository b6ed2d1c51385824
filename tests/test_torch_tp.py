"""The dense layers placed by their specs (tensor-parallel attention,
MLP, embedding and logits, FSDP parameters, the `fsdp_tp` train step)
against the reference's GSPMD runs on the CPU.

The reference runs once, in a module-scoped subprocess with 8 forced
host devices, every call jitted on parameters placed with
`jax.device_put(params, model.param_shardings())`; it writes each
leaf's addressable shards and its outputs. The port runs the same
weights (the reference's `CausalLM.init` tree with its norm scales and
biases moved off 1 and 0, as tests/test_torch_models.py makes them) on
meshes of repeated `cpu` devices. Cases cover the meshes (2, 2), (1, 4)
and (4, 2), both strategies, the five dense and VLM smoke configs
(biases: starcoder2; tied embeddings: gemma, command-r; a parallel
block: command-r; VLM embeds: internvl2), one MoE config, sequence-
parallel activations, and query heads split where the KV heads are not
(llama3-8b's smoke config on (1, 4): 4 query heads, 2 KV heads).
Tolerances:

* every parameter part against the reference's addressable shard of
  its position: bitwise;
* forward, prefill and decode logits and the cache (float32): within
  tests/test_torch_models.py's rtol = atol = 2e-4 of the reference's
  GSPMD run and of the port's own one-device run;
* three `fsdp_tp` train steps (float32, grad_accum 2, the default
  optimizer): parameters, loss, ce and grad norm within 2e-5 of the
  reference's; the gradients, in their parameters' layouts, each leaf
  within 2e-5 of its largest entry of the one-device model's (float32
  sums in other orders);
* a bf16 MLP on (1, 4): the port's output equals the sum of its four
  bf16-rounded partials in shard order bit for bit, and the reference's
  GSPMD output within one bf16 rounding;
* a placed bf16 train state crosses through the store both ways bit
  for bit against the reference's shards;
* the port's own checks: the backward of `all_gather` is
  `reduce_scatter` of the cotangents, and a mesh model seeded like a
  one-device model holds its weights bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.ckpt import store
from repro_torch.configs import registry
from repro_torch.configs.base import MeshSpec, OptimizerConfig, ShardingConfig
from repro_torch.data.pipeline import synth_batch
from repro_torch.interop import (
    lm_params_from_reference,
    placed_tree_from_reference,
    placed_tree_to_reference,
)
from repro_torch.models import build_model, common
from repro_torch.models.common import (
    param_shardings,
    place_params,
    whole_params,
)
from repro_torch.models.mlp import _hidden, apply_mlp_placed, mlp_defs
from repro_torch.sharding import collectives as col
from repro_torch.sharding.collectives import Placed
from repro_torch.sharding.rules import Topology, make_mesh_from_spec
from repro_torch.train.optim import init_opt_state
from repro_torch.train.step import _grad_fn, init_train_state, make_train_step
from repro_torch.tree import tree_flatten_with_path, tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 4, 16
CASES = {
    "llama_1x4_dp": ("llama3-8b", (1, 4), "dp_tp", {}),
    "starcoder_2x2_fsdp": ("starcoder2-7b", (2, 2), "fsdp_tp", {}),
    "gemma_4x2_fsdp": ("gemma-7b", (4, 2), "fsdp_tp", {}),
    "commandr_2x2_dp": ("command-r-35b", (2, 2), "dp_tp", {}),
    "internvl_1x4_fsdp": ("internvl2-1b", (1, 4), "fsdp_tp", {}),
    "llama_2x2_fsdp_seq": ("llama3-8b", (2, 2), "fsdp_tp",
                           {"seq_sharded_activations": True}),
    "olmoe_2x2_fsdp": ("olmoe-1b-7b", (2, 2), "fsdp_tp", {}),
}
TRAIN_CASE = "llama_2x2_fsdp_seq"
TRAIN_STEPS = 3
TRAIN_ACCUM = 2
XS = ("llama3-8b", (2, 2))  # the bf16 state crossing

_REFERENCE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ckpt import store
from repro.configs import registry
from repro.configs.base import MeshSpec, OptimizerConfig, ShardingConfig
from repro.data.pipeline import synth_batch
from repro.models import build_model
from repro.models.blocks import pad_cache
from repro.models.common import init_params, param_shardings
from repro.models.mlp import apply_mlp, mlp_defs
from repro.sharding.rules import Topology, make_mesh_from_spec
from repro.train.optim import AdamWState
from repro.train.step import init_train_state, make_train_step

out, port_ckpt = sys.argv[1], sys.argv[2]
res = {}
OFFSET = {"scale", "bias", "bq", "bk", "bv", "bo", "b_up", "b_down"}

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "name",
                    getattr(k, "idx", k)))) for k in path)

def host(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a

def flat(tree, prefix):
    for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + key(p)] = host(a)

def shards(tree, mesh, prefix):
    for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        for s in a.addressable_shards:
            pos = np.argwhere(mesh.devices == s.device)[0]
            res[prefix + key(p) + "|" + ",".join(map(str, pos))] = host(
                s.data)

def mesh_of(shape):
    return make_mesh_from_spec(MeshSpec(shape, ("data", "model")))

def state_shardings(model, mesh, state):
    ps = model.param_shardings()
    opt = state["opt"]
    return {"params": ps, "opt": AdamWState(
        step=NamedSharding(mesh, P()), mu=ps, nu=ps,
        master=ps if opt.master is not None else None)}

B, S = %(b)d, %(s)d
for tag, (name, shape, strategy, kw) in %(cases)r.items():
    cfg = registry.get_smoke_config(name)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    mesh = mesh_of(shape)
    topo = Topology(mesh, cfg, ShardingConfig(strategy=strategy, **kw))
    model = build_model(cfg, topo, remat="none")
    rng = np.random.default_rng(7)

    def offset(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", None) in OFFSET:
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(
        offset, model.init(jax.random.PRNGKey(0)))
    flat(params, tag + "/p/")
    placed = jax.device_put(params, model.param_shardings())
    shards(placed, mesh, tag + "/shard/")
    brng = np.random.default_rng(1)
    p = cfg.frontend_tokens if cfg.frontend != "none" else 0
    batch = {"tokens": brng.integers(0, cfg.vocab_size, (B, S - p)).astype(
        np.int32)}
    if p:
        batch["embeds"] = brng.standard_normal((B, p, cfg.d_model)).astype(
            np.float32)
    tok = brng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    for k, v in dict(batch, tok=tok, pos=pos).items():
        res[tag + "/in/" + k] = v
    # one jitted forward in prefill mode gives the forward's logits and
    # model.prefill's cache and last logits (prefill pads that cache)
    logits, cache, _ = jax.jit(lambda p, b: model.forward(
        p, b, mode="prefill"))(placed, batch)
    cache = jax.device_put(pad_cache(cache, S + 4), model.cache_shardings())
    res[tag + "/logits"] = np.asarray(logits)
    res[tag + "/last"] = np.asarray(logits[:, -1:])
    flat(cache, tag + "/cache/")
    dec, cache = jax.jit(model.decode_step)(placed, cache, tok, pos)
    res[tag + "/dec"] = np.asarray(dec)
    flat(cache, tag + "/cache2/")
    if tag == %(train)r:
        ocfg = OptimizerConfig()
        step = jax.jit(make_train_step(model, ocfg, ShardingConfig(
            strategy=strategy, grad_accum=%(accum)d)))
        state = {"params": placed, "opt": jax.device_put(
            init_train_state(model, jax.random.PRNGKey(0), ocfg)["opt"])}
        for i in range(%(steps)d):
            state, m = step(state, synth_batch(cfg, 8, 32, i))
            for k, v in m.items():
                res[f"{tag}/train/{i}/{k}"] = np.asarray(v)
        flat(state["params"], tag + "/train/params/")

# a bf16 MLP on (1, 4): the row-parallel partials' structure
cfg = dataclasses.replace(registry.get_smoke_config("llama3-8b"),
                          dtype="bfloat16")
mesh = mesh_of((1, 4))
topo = Topology(mesh, cfg, ShardingConfig(strategy="dp_tp"))
mp = init_params(jax.random.PRNGKey(2), mlp_defs(cfg), "bfloat16")
x = jnp.asarray(np.random.default_rng(3).standard_normal(
    (B, S, cfg.d_model)).astype(np.float32)).astype(jnp.bfloat16)
y = jax.jit(lambda p, x: apply_mlp(p, x, cfg))(
    jax.device_put(mp, param_shardings(mlp_defs(cfg), topo)), x)
flat(mp, "mlp/p/")
res["mlp/x"], res["mlp/y"] = host(x), host(y)

# a placed bf16 train state through the store, both ways
name, shape = %(xs)r
cfg = dataclasses.replace(registry.get_smoke_config(name), dtype="bfloat16")
mesh = mesh_of(shape)
model = build_model(cfg, Topology(mesh, cfg, ShardingConfig(
    strategy="fsdp_tp")), remat="none")
ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1)
state = init_train_state(model, jax.random.PRNGKey(1), ocfg)
sh = state_shardings(model, mesh, state)
state = jax.device_put(state, sh)
state, _ = jax.jit(make_train_step(model, ocfg, ShardingConfig(
    strategy="fsdp_tp")))(state, synth_batch(cfg, 8, 32, 0))
shards(state, mesh, "xs/ref/")
store.save(state, out + "/ref_ckpt", 1)
back = store.restore(state, port_ckpt, shardings=sh)
shards(back, mesh, "xs/port/")
np.savez(out + "/ref.npz", **res)
"""


def _mesh(shape):
    return make_mesh_from_spec(MeshSpec(shape, ("data", "model")),
                               ["cpu"] * int(np.prod(shape)))


def _xs_model(seed=None):
    name, shape = XS
    cfg = dataclasses.replace(registry.get_smoke_config(name),
                              dtype="bfloat16")
    topo = Topology(_mesh(shape), cfg, ShardingConfig(strategy="fsdp_tp"))
    return cfg, build_model(cfg, topo)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, after the port saved a placed bf16 train
    state (one step of llama3-8b's smoke config on (2, 2), fsdp_tp) for
    the reference to restore."""
    out = tmp_path_factory.mktemp("tp_ref")
    cfg, model = _xs_model()
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1)
    state = init_train_state(model, torch.Generator().manual_seed(1), ocfg)
    step = make_train_step(model, ocfg, ShardingConfig(strategy="fsdp_tp"))
    state, _ = step(state, synth_batch(cfg, 8, 32, 0))
    store.save(state, str(out / "port_ckpt"), 1)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent(_REFERENCE % {
        "cases": CASES, "b": B, "s": S, "train": TRAIN_CASE,
        "accum": TRAIN_ACCUM, "steps": TRAIN_STEPS, "xs": XS})
    res = subprocess.run([sys.executable, "-c", code, str(out),
                          str(out / "port_ckpt")], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out / "ref.npz") as f:
        arrays = {k: f[k] for k in f.files}
    return {"arrays": arrays, "ckpt": str(out / "ref_ckpt"),
            "port_state": state}


def _buffers(arrays, prefix):
    """{leaf path: {mesh position: buffer}} of the keys under prefix."""
    out: dict = {}
    for k, a in arrays.items():
        if k.startswith(prefix):
            path, pos = k[len(prefix):].split("|")
            out.setdefault(path, {})[tuple(map(int, pos.split(",")))] = a
    return out


def _tree(arrays, prefix):
    return {k[len(prefix):]: a for k, a in arrays.items()
            if k.startswith(prefix)}


def _models(ref, tag):
    """(config, the port's mesh model, its one-device model, batch) on
    the reference's weights."""
    name, shape, strategy, kw = CASES[tag]
    cfg = registry.get_smoke_config(name)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    weights = {k.replace("/", "."): torch.from_numpy(a.copy())
               for k, a in _tree(ref["arrays"], tag + "/p/").items()}
    assert set(weights) == set(lm_params_from_reference(
        cfg, {k: a.numpy() for k, a in weights.items()}))
    topo = Topology(_mesh(shape), cfg, ShardingConfig(strategy=strategy,
                                                      **kw))
    mesh_model = build_model(cfg, topo)
    mesh_model.load_state_dict(weights)
    one = build_model(cfg, device="cpu")
    one.load_state_dict(weights)
    batch = {k: ref["arrays"][f"{tag}/in/{k}"] for k in ("tokens", "embeds")
             if f"{tag}/in/{k}" in ref["arrays"]}
    return cfg, mesh_model, one, batch


@pytest.mark.parametrize("tag", list(CASES))
def test_parts_are_the_reference_shards(ref, tag):
    """Every parameter leaf is held as its parts (none whole on the
    first device, nothing registered as a module parameter), each
    position's part bit for bit the reference's addressable shard."""
    cfg, model, _, _ = _models(ref, tag)
    assert list(model.parameters()) == []
    shards = _buffers(ref["arrays"], tag + "/shard/")
    flat = tree_flatten_with_path(model.params())
    assert {p for p, _ in flat} == set(shards)
    split = 0
    for path, leaf in flat:
        assert isinstance(leaf, Placed)
        local = list(leaf.shape)
        for d, ax in enumerate(leaf.spec):
            if ax is not None:
                local[d] //= col.axis_size(leaf.mesh, ax)
        split += local != list(leaf.shape)
        for pos, part in zip(col.positions(leaf.mesh), leaf.parts):
            assert list(part.shape) == local, path
            np.testing.assert_array_equal(part.numpy(), shards[path][pos],
                                          err_msg=f"{path} {pos}")
    assert split >= 3


@pytest.mark.parametrize("tag", list(CASES))
def test_serving_matches_gspmd_and_one_device(ref, tag):
    """Forward, prefill (last logits, cache) and one decode step (logits,
    cache) on the mesh against the reference's GSPMD run and against
    the port's one-device model; the cache leaves are placed by
    `cache_shardings`."""
    cfg, model, one, batch = _models(ref, tag)
    a = ref["arrays"]
    tok, pos = a[f"{tag}/in/tok"], a[f"{tag}/in/pos"]
    logits, _, _ = model.forward(batch)
    np.testing.assert_allclose(logits.numpy(), a[tag + "/logits"], **TOL)
    np.testing.assert_allclose(logits.numpy(), one.forward(batch)[0].numpy(),
                               **TOL)
    cache, last = model.prefill(batch, cache_len=S + 4)
    c1, l1 = one.prefill(batch, cache_len=S + 4)
    np.testing.assert_allclose(last.numpy(), a[tag + "/last"], **TOL)
    np.testing.assert_allclose(last.numpy(), l1.numpy(), **TOL)
    sh = dict(tree_flatten_with_path(model.cache_shardings()))
    for path, leaf in tree_flatten_with_path(cache):
        assert isinstance(leaf, Placed) and leaf.spec == sh[path].spec
        np.testing.assert_allclose(leaf.whole().numpy(),
                                   a[f"{tag}/cache/{path}"], **TOL)
    for x, y in zip(tree_leaves(cache), tree_leaves(c1)):
        np.testing.assert_allclose(x.whole().numpy(), y.numpy(), **TOL)
    dec, cache2 = model.decode_step(cache, tok, pos)
    d1, c1 = one.decode_step(c1, tok, pos)
    # written in place
    assert all(x is y for x, y in zip(tree_leaves(cache2), tree_leaves(cache)))
    np.testing.assert_allclose(dec.numpy(), a[tag + "/dec"], **TOL)
    np.testing.assert_allclose(dec.numpy(), d1.numpy(), **TOL)
    for path, leaf in tree_flatten_with_path(cache2):
        np.testing.assert_allclose(leaf.whole().numpy(),
                                   a[f"{tag}/cache2/{path}"], **TOL)
    assert (logits[..., cfg.vocab_size:] <= -1e29).all()


def test_fsdp_tp_train_steps_match_gspmd(ref):
    """Three `fsdp_tp` steps (grad_accum 2) of llama3-8b's smoke config
    on (2, 2) with sequence-parallel activations: each step's loss and
    grad norm, and the parameters after the third, against the
    reference's jitted step on its placed state; the gradients come
    back in their parameters' layouts, each leaf within 2e-5 of its
    largest entry of the one-device model's."""
    tag = TRAIN_CASE
    name, shape, strategy, kw = CASES[tag]
    cfg, model, one, _ = _models(ref, tag)
    a = ref["arrays"]
    ocfg = OptimizerConfig()
    params = model.params()
    # the gradients, in their parameters' layouts, against one device's
    mb = synth_batch(cfg, 8, 32, 0)
    grads = _grad_fn(model, params, mb)[2]
    for (path, g), p, w in zip(tree_flatten_with_path(grads),
                               tree_leaves(params),
                               tree_leaves(_grad_fn(one, one.params(),
                                                    mb)[2])):
        assert isinstance(g, Placed) and g.spec == p.spec, path
        assert float((g.whole() - w).abs().max()) <= \
            2e-5 * float(w.abs().max()), path
    state = {"params": params, "opt": init_opt_state(params, ocfg)}
    assert all(isinstance(m, Placed) and m.spec == p.spec for m, p in zip(
        tree_leaves(state["opt"].mu), tree_leaves(params)))
    step = make_train_step(model, ocfg, ShardingConfig(
        strategy=strategy, grad_accum=TRAIN_ACCUM))
    for i in range(TRAIN_STEPS):
        state, m = step(state, synth_batch(cfg, 8, 32, i))
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(m[k]),
                                       float(a[f"{tag}/train/{i}/{k}"]),
                                       rtol=2e-5, atol=2e-5, err_msg=k)
    assert state["params"] is params  # updated in place, part by part
    want = _tree(a, tag + "/train/params/")
    for path, leaf in tree_flatten_with_path(state["params"]):
        np.testing.assert_allclose(leaf.whole().numpy(), want[path],
                                   atol=2e-5, err_msg=path)


def test_row_parallel_products_on_head_and_column_parts(ref, monkeypatch):
    """On (1, 4): every row-parallel product of a forward pass runs on
    h/4 heads (out_proj) or d_ff/4 columns (the MLP's down projection)
    and is followed by exactly one psum over `model`; the vocab-parallel
    embedding adds the one other psum."""
    cfg, model, _, batch = _models(ref, "llama_1x4_dp")
    events = []
    orig_prod, orig_psum = common.einsum_out, col.psum

    def prod(subs, x, w):
        events.append(("prod", tuple(w.shape)))
        return orig_prod(subs, x, w)

    def psum(parts, mesh, axis):
        events.append(("psum", axis))
        return orig_psum(parts, mesh, axis)

    monkeypatch.setattr(common, "einsum_out", prod)
    monkeypatch.setattr(col, "psum", psum)
    model.forward(batch)
    hd = cfg.resolved_head_dim
    wo_part = (cfg.n_heads // 4, hd, cfg.d_model)
    down_part = (cfg.d_ff // 4, cfg.d_model)
    # the embedding's psum, then per layer: 4 products, one psum, twice
    assert events[0] == ("psum", "model")
    per_layer = ([("prod", wo_part)] * 4 + [("psum", "model")]
                 + [("prod", down_part)] * 4 + [("psum", "model")])
    assert events[1:] == per_layer * cfg.n_layers


def test_bf16_partials_are_rounded_before_the_psum(ref):
    """A bf16 MLP on (1, 4): the output is the four model shards' partial
    products, each rounded to bf16, added in shard order (a float32 sum
    rounded once differs), and within one bf16 rounding of the
    reference's GSPMD output."""
    a = ref["arrays"]
    cfg = dataclasses.replace(registry.get_smoke_config("llama3-8b"),
                              dtype="bfloat16")
    topo = Topology(_mesh((1, 4)), cfg, ShardingConfig(strategy="dp_tp"))

    def bf16(x):
        return torch.from_numpy(x.copy()).view(torch.bfloat16)

    whole = {k: bf16(v) for k, v in _tree(a, "mlp/p/").items()}
    x = bf16(a["mlp/x"])
    params = place_params(whole, param_shardings(mlp_defs(cfg), topo))
    y = apply_mlp_placed(params, topo.constrain(x, "batch", None, None),
                         cfg, topo).whole()
    assert y.dtype == torch.bfloat16
    f = cfg.d_ff // 4
    partials, wide = [], []
    for m in range(4):
        local = {k: (v[..., m * f:(m + 1) * f] if k != "w_down"
                     else v[m * f:(m + 1) * f]) for k, v in whole.items()}
        h = _hidden(local, x, cfg)
        partials.append(torch.einsum("...f,fd->...d", h, local["w_down"]))
        wide.append(h.float() @ local["w_down"].float())
    acc = partials[0]
    for p in partials[1:]:
        acc = acc + p
    assert torch.equal(y, acc)
    once = sum(wide[1:], wide[0]).to(torch.bfloat16)
    assert not torch.equal(y, once)
    ref_y = bf16(a["mlp/y"]).float()
    assert float((y.float() - ref_y).abs().max()) <= \
        2 ** -7 * float(ref_y.abs().max())


def test_placed_state_saved_by_the_port_restores_in_the_reference(ref):
    """The port's placed bf16 train state (params, mu, nu, master, step),
    saved as whole leaves, restored by the reference onto the same mesh:
    every addressable shard equals the port's part bit for bit; and the
    state crosses as buffers through `placed_tree_to_reference`."""
    state = ref["port_state"]
    got = _buffers(ref["arrays"], "xs/port/")
    mine = placed_tree_to_reference(state)
    assert set(got) == set(mine)
    for path, per_pos in mine.items():
        assert set(per_pos) == set(got[path])
        for pos, buf in per_pos.items():
            np.testing.assert_array_equal(buf, got[path][pos],
                                          err_msg=f"{path} {pos}")


def test_placed_state_saved_by_the_reference_restores_on_parts(ref):
    """The reference's sharded bf16 train state, saved and restored by
    the port onto its placed template: each part bit for bit the
    reference's shard, equal to the buffers carried by
    `placed_tree_from_reference`."""
    cfg, model = _xs_model()
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1)
    template = init_train_state(model, torch.Generator().manual_seed(0),
                                ocfg)
    back = store.restore(template, ref["ckpt"])
    bufs = _buffers(ref["arrays"], "xs/ref/")
    bf16 = {path for path, leaf in tree_flatten_with_path(template)
            if leaf.dtype == torch.bfloat16}
    crossed = placed_tree_from_reference(
        {path: {pos: b.view(ml_dtypes.bfloat16) if path in bf16 else b
                for pos, b in per_pos.items()}
         for path, per_pos in bufs.items()}, template)
    n_placed = 0
    for (path, leaf), other in zip(tree_flatten_with_path(back),
                                   tree_leaves(crossed)):
        if isinstance(leaf, Placed):
            n_placed += 1
            for pos, part, part2 in zip(col.positions(leaf.mesh), leaf.parts,
                                        other.parts):
                want = bufs[path][pos]
                got = part.view(torch.int16) if part.dtype == \
                    torch.bfloat16 else part
                np.testing.assert_array_equal(got.numpy(), want,
                                              err_msg=f"{path} {pos}")
                assert torch.equal(part, part2)
        else:
            assert torch.equal(leaf, other)
    assert n_placed == 4 * len(tree_leaves(model.params()))
    whole = whole_params(back["params"])
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(whole))


@pytest.mark.parametrize("shape,axis,dim", [((2, 2), "data", 1),
                                            ((1, 4), "model", 0),
                                            ((4, 2), ("data", "model"), 2)])
def test_all_gather_backward_is_the_reduce_scatter(shape, axis, dim):
    """The backward of a tiled all_gather is the reference's transpose,
    a psum of the members' cotangents followed by each member's slice:
    `reduce_scatter` of the cotangents, in the same fixed order."""
    mesh = _mesh(shape)
    n = col.axis_size(mesh, axis)
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.standard_normal((4, 6, 8)).astype(
        np.float32))
    spec = [None] * 3
    spec[dim] = axis
    parts = [p.clone().requires_grad_(True)
             for p in col.shard(base, tuple(spec), mesh)]
    gathered = col.all_gather(parts, mesh, axis, dim)
    cot = [torch.from_numpy(rng.standard_normal(tuple(g.shape)).astype(
        np.float32)) for g in gathered]
    grads = torch.autograd.grad(sum((g * c).sum() for g, c in zip(
        gathered, cot)), parts)
    want = col.reduce_scatter(cot, mesh, axis, dim)
    assert all(w.shape[dim] * n == c.shape[dim] for w, c in zip(want, cot))
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,strategy", [((2, 2), "fsdp_tp"),
                                            ((1, 4), "dp_tp")])
def test_seeded_init_on_a_mesh_equals_one_device(shape, strategy):
    """`init` draws each leaf whole in `flatten_defs` order and then
    splits it: a mesh model from a seed holds the one-device model's
    weights, and its state dict is whole leaves."""
    cfg = registry.get_smoke_config("gemma-7b")
    one = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    topo = Topology(_mesh(shape), cfg, ShardingConfig(strategy=strategy))
    mesh = build_model(cfg, topo).init(torch.Generator().manual_seed(3))
    got, want = mesh.state_dict(), one.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(isinstance(p, Placed) for p in tree_leaves(mesh.params()))

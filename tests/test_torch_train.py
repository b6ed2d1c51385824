"""The port's trainer (`repro_torch.train`, the pytree half of
`repro_torch.ckpt.store`) against the reference's `repro.train` and
`repro.ckpt.store` on the CPU, and tests/test_train.py's cases on the
port.

Both packages start from one state: the reference's `CausalLM.init`
tree and `init_opt_state`, carried over by
`interop.train_state_from_reference`. The smoke configs are float32.
Tolerances:

* `lr_schedule`, `clip_by_global_norm`, `adamw_update` on equal
  gradients: rtol 1e-6 (float32 elementwise math; `cos`, `pow` and the
  norm's sums may differ in the last bits);
* one `make_train_step` step: loss rtol 1e-5, grad_norm rtol 1e-4
  (products and sums in other orders; measured 2e-7 and 1e-5); the
  first moment (0.1 · the clipped gradient) within 1e-4 of each leaf's
  largest; the params within tests/test_train.py's 2e-5 wherever the
  clipped gradient exceeds 1e-6 in both packages. Below that, Adam's
  first step `lr · g / (|g| + 1e-8)` turns a rounding of g into a
  difference of order lr, so there the bound is 2 · lr(1) (a quarter of
  the llama smoke's entries, where clipping by a norm of 55 leaves the
  gradient small; the tight bound must cover most entries);
* accum 2 against accum 1: tests/test_train.py's 2e-5 (on the
  embedding, its case; on every parameter of the olmoe smoke config with
  router_aux_loss 0 and nothing dropped, since the aux loss and the
  drops are per-microbatch statistics);
* the crash drill: tests/test_train.py's rtol 1e-4, atol 1e-5;
* checkpoint files and `quantize_int8`: bit for bit.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import store as j_store
from repro.configs import registry as j_registry
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import ShardingConfig as JShardingConfig
from repro.data.pipeline import synth_batch as j_synth_batch
from repro.models import build_model as j_build_model
from repro.sharding.rules import smoke_topology as j_smoke_topology
from repro.train import compression as j_compression
from repro.train import optim as j_optim
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.ckpt import store
from repro_torch.ckpt.store import CheckpointCorrupt
from repro_torch.configs import registry
from repro_torch.configs.base import OptimizerConfig, ShardingConfig
from repro_torch.data.pipeline import synth_batch
from repro_torch.interop import (
    train_state_from_reference,
    train_state_to_reference,
)
from repro_torch.models import build_model
from repro_torch.runtime.fault import FailurePlan
from repro_torch.train import compression, optim
from repro_torch.train.drill import run_train_with_failures
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

OCFG = dict(lr=1e-3, warmup_steps=5, total_steps=100)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree) -> dict:
    """{"/"-joined path: numpy array} of a reference (jax) tree, the
    store's key for each leaf."""
    return {"/".join(j_store._path_str(p) for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_paths(tree) -> dict:
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree_flatten_with_path(tree)}


def _j_state(name, **cfg_kw):
    jcfg = dataclasses.replace(j_registry.get_smoke_config(name), **cfg_kw)
    jmodel = j_build_model(jcfg, j_smoke_topology(jcfg), remat="none")
    params = jmodel.init(jax.random.PRNGKey(0))
    ocfg = JOptimizerConfig(**OCFG)
    return jcfg, jmodel, {"params": params,
                          "opt": j_optim.init_opt_state(params, ocfg)}


def _port(name, accum, **cfg_kw):
    cfg = dataclasses.replace(registry.get_smoke_config(name), **cfg_kw)
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, OptimizerConfig(**OCFG), ShardingConfig(
        strategy="dp_tp", grad_accum=accum))
    return cfg, model, step


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_reference():
    jo = JOptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    o = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = optim.lr_schedule(o, s)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got),
                                   float(j_optim.lr_schedule(jo, s)),
                                   rtol=1e-6)
        got = optim.lr_schedule(o, torch.tensor(s, dtype=torch.int32))
        np.testing.assert_allclose(float(got), float(j_optim.lr_schedule(
            jo, jnp.asarray(s, jnp.int32))), rtol=1e-6)
    # tests/test_train.py's figures
    assert float(optim.lr_schedule(o, 0)) == 0.0
    assert np.isclose(float(optim.lr_schedule(o, 10)), 1e-3)
    assert float(optim.lr_schedule(o, 100)) < 2e-4


def _grad_tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((4, 3)).astype(dtype) * 30,
            "b": [rng.standard_normal((5,)).astype(dtype),
                  rng.standard_normal((2, 2)).astype(dtype) * 100]}


def test_clip_by_global_norm_matches_reference():
    g = _grad_tree(np.random.default_rng(1))
    for max_norm in (1.0, 1e6):
        jc, jn = j_optim.clip_by_global_norm(g, max_norm)
        c, n = optim.clip_by_global_norm(tree_map(torch.from_numpy, g),
                                         max_norm)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
        for k, v in _paths(jc).items():
            np.testing.assert_allclose(_port_paths(c)[k], v, rtol=1e-6)
    # tests/test_train.py's figures
    c, n = optim.clip_by_global_norm({"a": torch.full((4,), 100.0)}, 1.0)
    assert np.isclose(float(n), 200.0)
    assert np.isclose(float(torch.sqrt(sum((x * x).sum()
                                           for x in tree_leaves(c)))),
                      1.0, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Two updates on equal gradients from equal states: params, master,
    moments, step and metrics (bf16 params keep a float32 master)."""
    rng = np.random.default_rng(2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    params = jax.tree.map(lambda a: jnp.asarray(a, jdt),
                          _grad_tree(rng))
    jo = JOptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                          grad_clip=5.0)
    o = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                        grad_clip=5.0)
    jstate = {"params": params, "opt": j_optim.init_opt_state(params, jo)}
    state = train_state_from_reference(_np(jstate), device="cpu")
    assert (state["opt"].master is None) == (dtype == "float32")
    for i in range(2):
        g = _grad_tree(np.random.default_rng(10 + i))
        jp, jopt, jm = j_optim.adamw_update(g, jstate["opt"],
                                            jstate["params"], jo)
        jstate = {"params": jp, "opt": jopt}
        p, opt, m = optim.adamw_update(tree_map(torch.from_numpy, g),
                                       state["opt"], state["params"], o)
        state = {"params": p, "opt": opt}
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    assert int(state["opt"].step) == int(jstate["opt"].step) == 2
    got = train_state_to_reference(state)
    for part in ("mu", "nu", "master"):
        if getattr(jstate["opt"], part) is None:
            continue
        want = _paths(getattr(jstate["opt"], part))
        have = _port_paths(getattr(got["opt"], part))
        for k, v in want.items():
            np.testing.assert_allclose(have[k], v, rtol=1e-6, atol=1e-12)
    want = _paths(jstate["params"])
    for k, v in _port_paths(got["params"]).items():
        if dtype == "bfloat16":  # int16 bits in, the reference's bf16 out
            v = torch.from_numpy(v).view(torch.bfloat16).float().numpy()
            np.testing.assert_allclose(v, want[k].astype(np.float32),
                                       rtol=2 ** -8)
        else:
            np.testing.assert_allclose(v, want[k], rtol=1e-6)


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_step():
    """The reference's and the port's state after one step, per (arch,
    accum): the reference's jitted step, run once."""
    cache = {}

    def get(name, accum):
        if (name, accum) not in cache:
            jcfg, jmodel, jstate = _j_state(name)
            start = _np(jstate)
            jstep = jax.jit(j_make_train_step(
                jmodel, JOptimizerConfig(**OCFG),
                JShardingConfig(strategy="dp_tp", grad_accum=accum)))
            batch = j_synth_batch(jcfg, 8, 32, 0)
            jafter, jm = jstep(jstate, batch)
            _, _, step = _port(name, accum)
            after, m = step(train_state_from_reference(start, device="cpu"),
                            batch)
            cache[name, accum] = (_np(jafter), _np(jm),
                                  train_state_to_reference(after), m)
        return cache[name, accum]

    return get


@pytest.mark.parametrize("name", ["llama3-8b", "olmoe-1b-7b"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(one_step, name, accum):
    jafter, jm, after, m = one_step(name, accum)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    for k in ("ce", "aux", "tokens", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    assert int(after["opt"].step) == 1
    mu, jmu = _port_paths(after["opt"].mu), _paths(jafter["opt"].mu)
    params, jparams = _port_paths(after["params"]), _paths(jafter["params"])
    assert sorted(params) == sorted(jparams) == sorted(mu) == sorted(jmu)
    lr1 = float(jm["lr"])
    n_tight = 0
    for k, want in jparams.items():
        scale = np.abs(jmu[k]).max()
        np.testing.assert_allclose(mu[k], jmu[k], atol=1e-4 * scale,
                                   err_msg=k)
        small = np.minimum(np.abs(mu[k]), np.abs(jmu[k])) < 1e-7
        n_tight += int((~small).sum())
        d = np.abs(params[k] - want)
        assert d[~small].max(initial=0) <= 2e-5, k
        assert d.max() <= 2 * lr1, k
    assert n_tight > 0.5 * sum(a.size for a in jparams.values())


def test_grad_accum_equivalent():
    """tests/test_train.py's case on the port: accum 2 over a batch ==
    accum 1 on it, via the embedding after one step."""
    b = synth_batch(registry.get_smoke_config("llama3-8b"), 8, 32, 0)
    outs = []
    for accum in (1, 2):
        _, model, step = _port("llama3-8b", accum)
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 OptimizerConfig(**OCFG))
        state, _ = step(state, b)
        outs.append(state["params"]["embed"].clone())
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=2e-5)


def test_grad_accum_equivalent_moe():
    """The same on the olmoe smoke config, every parameter, with
    router_aux_loss 0 and capacity factor 8.0 (nothing drops)."""
    b = synth_batch(registry.get_smoke_config("olmoe-1b-7b"), 8, 32, 0)
    outs = []
    for accum in (1, 2):
        _, model, step = _port("olmoe-1b-7b", accum, router_aux_loss=0.0,
                               capacity_factor=8.0)
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 OptimizerConfig(**OCFG))
        state, _ = step(state, b)
        outs.append([t.clone() for t in tree_leaves(state["params"])])
    for a, c in zip(*outs):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-5)


@pytest.mark.parametrize("name", ["llama3-8b", "olmoe-1b-7b"])
def test_loss_decreases(name):
    """tests/test_train.py's case: 40 steps over 4 repeated batches."""
    cfg, model, step = _port(name, 1)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    step = make_train_step(model, ocfg, ShardingConfig(strategy="dp_tp"))
    state = init_train_state(model, torch.Generator().manual_seed(0), ocfg)
    losses = []
    for i in range(40):
        state, m = step(state, synth_batch(cfg, 8, 32, i % 4))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::8]


def test_crash_restore_deterministic(tmp_path):
    """tests/test_train.py's drill on the port: two crashes through the
    pytree store give the clean run's losses."""
    cfg, model, _ = _port("llama3-8b", 1)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=12)
    step = make_train_step(model, ocfg, ShardingConfig(strategy="dp_tp"))
    batches = [synth_batch(cfg, 4, 32, i) for i in range(8)]

    def make_state():
        return init_train_state(model, torch.Generator().manual_seed(0),
                                ocfg)

    state = make_state()
    clean = []
    for b in batches:
        state, m = step(state, b)
        clean.append(float(m["loss"]))

    ckpt_dir = str(tmp_path / "ck")

    def restore_fn():
        s = store.latest_step(ckpt_dir)
        return store.restore(make_state(), ckpt_dir, s), s

    plan = FailurePlan(schedule={3: "crash", 6: "crash"})
    _, crashy, events = run_train_with_failures(
        make_state, step, batches, ckpt_dir, plan,
        lambda st, i: store.save(st, ckpt_dir, i), restore_fn, ckpt_every=2)
    assert len(events) == 2
    assert store.latest_step(ckpt_dir) == 8
    np.testing.assert_allclose(clean, crashy, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the pytree store
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_state():
    """A bf16 llama smoke train state of the reference's (a float32
    master beside bf16 params) and the port's copy of it."""
    _, _, jstate = _j_state("llama3-8b", dtype="bfloat16")
    jstate["opt"] = jstate["opt"]._replace(
        step=jnp.asarray(3, jnp.int32),
        mu=jax.tree.map(lambda a: a + 0.5, jstate["opt"].mu))
    return jstate, train_state_from_reference(_np(jstate), device="cpu")


def _bits(tree) -> dict:
    out = {}
    for k, v in tree_flatten_with_path(tree):
        out[k] = (v.view(torch.int16) if v.dtype == torch.bfloat16 else v
                  ).numpy().tobytes()
    return out


def test_reference_file_restores_in_the_port(bf16_state, tmp_path):
    jstate, state = bf16_state
    j_store.save(jstate, str(tmp_path), 3)
    template = tree_map(torch.zeros_like, state)
    back = store.restore(template, str(tmp_path))
    assert back["params"]["embed"].dtype == torch.bfloat16
    assert isinstance(back["opt"], optim.AdamWState)
    assert _bits(back) == _bits(state)
    with open(tmp_path / "step_3" / "manifest.json") as f:
        assert "bfloat16" in f.read()


def test_port_file_restores_in_the_reference(bf16_state, tmp_path):
    jstate, state = bf16_state
    path = store.save(state, str(tmp_path), 5)
    assert path.endswith("step_5") and store.latest_step(str(tmp_path)) == 5
    assert j_store.latest_step(str(tmp_path)) == 5
    template = jax.tree.map(jnp.zeros_like, jstate)
    back = j_store.restore(template, str(tmp_path))
    assert back["params"]["embed"].dtype == jnp.bfloat16
    want = _paths(jstate)
    got = _paths(back)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    # the manifests of the two packages list the same keys and dtypes
    j_store.save(jstate, str(tmp_path / "ref"), 5)
    import json
    with open(os.path.join(path, "manifest.json")) as f:
        mine = json.load(f)
    with open(tmp_path / "ref" / "step_5" / "manifest.json") as f:
        theirs = json.load(f)
    assert mine["keys"] == theirs["keys"]
    assert mine["dtypes"] == theirs["dtypes"]


def test_restore_verifies_and_latest_step_skips_partial(bf16_state,
                                                        tmp_path):
    _, state = bf16_state
    d = str(tmp_path)
    assert store.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        store.restore(state, d)
    store.save(state, d, 1)
    os.makedirs(os.path.join(d, ".tmp_step_2"))  # an interrupted save
    os.makedirs(os.path.join(d, "step_3"))  # no manifest: not a checkpoint
    assert store.latest_step(d) == 1
    npz = os.path.join(d, "step_1", "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(os.path.getsize(npz) // 2)
        f.write(b"\x00corrupt\x00")
    with pytest.raises(CheckpointCorrupt, match="checksum mismatch"):
        store.restore(state, d)


def test_async_writer_snapshots_before_in_place_updates(tmp_path):
    state = {"w": torch.arange(6, dtype=torch.float32),
             "opt": optim.AdamWState(step=torch.tensor(1, dtype=torch.int32),
                                     mu=[torch.ones(2)], nu=[torch.ones(2)],
                                     master=None)}
    w = store.AsyncWriter()
    w.submit(state, str(tmp_path), 1)
    state["w"].add_(100.0)  # the trainer updates its state in place
    w.wait()
    assert w.last_path.endswith("step_1")
    back = store.restore(tree_map(torch.zeros_like, state), str(tmp_path))
    assert torch.equal(back["w"], torch.arange(6, dtype=torch.float32))
    assert back["opt"].master is None


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((64,), 1.0), ((8, 33), 1e-3),
                                         ((5,), 0.0)])
def test_quantize_int8_matches_reference(shape, scale):
    x = (np.random.default_rng(5).standard_normal(shape) * scale).astype(
        np.float32)
    jq, js = j_compression.quantize_int8(jnp.asarray(x))
    q, s = compression.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()
    assert s.numpy().tobytes() == np.asarray(js).tobytes()


def test_init_error_is_zero_float32_like_the_tree():
    tree = {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.ones(2, 2)]}
    err = compression.init_error(tree)
    jerr = j_compression.init_error({"a": jnp.ones(3, jnp.bfloat16),
                                     "b": [jnp.ones((2, 2))]})
    assert [tuple(t.shape) for t in tree_leaves(err)] == [
        a.shape for a in jax.tree.leaves(jerr)]
    assert all(t.dtype == torch.float32 and not t.any()
               for t in tree_leaves(err))

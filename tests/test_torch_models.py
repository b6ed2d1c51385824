"""The port's LM serving path (configs, blocks, attention, `CausalLM`)
against the reference's `repro.models` on the CPU.

Both packages run the same weights: the reference's `CausalLM.init`
tree, with every norm scale and bias moved off its 1 or 0 so that they
count, carried over by `interop.lm_params_from_reference`. The five
dense and VLM smoke configs are float32; the two packages' products and
reductions add in different orders, so logits, loss and caches are held
to TOL (measured at most 7e-5 on these configs; JAX 0.9.0, torch 2.13).
The chunked attention and the decode mask are held against the
reference's functions at the reference's own tolerances
(tests/test_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.sharding.rules import smoke_topology as j_smoke_topology
from repro_torch.configs import registry
from repro_torch.interop import (
    lm_cache_from_reference,
    lm_cache_to_reference,
    lm_params_from_reference,
)
from repro_torch.models import attention, build_model
from repro_torch.models.blocks import layer_groups
from repro_torch.models.common import init_params, param_bytes
from repro_torch.sharding.rules import smoke_topology

DENSE = ("llama3-8b", "gemma-7b", "command-r-35b", "starcoder2-7b",
         "internvl2-1b")
TOL = dict(rtol=2e-4, atol=2e-4)
OFFSET_LEAVES = {"scale", "bias", "bq", "bk", "bv", "bo", "b_up", "b_down"}
B, S = 2, 32


def _pair(name):
    """(reference model, its params as numpy, port model on the CPU with
    the same weights, config)."""
    jcfg = j_registry.get_smoke_config(name)
    jmodel = j_build_model(jcfg, j_smoke_topology(jcfg))
    rng = np.random.default_rng(7)

    def offset(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", None) in OFFSET_LEAVES:
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    params = jax.tree_util.tree_map_with_path(
        offset, jmodel.init(jax.random.PRNGKey(0)))
    cfg = registry.get_smoke_config(name)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(lm_params_from_reference(cfg, params))
    return jmodel, params, model, cfg


def _batch(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    p = cfg.frontend_tokens if cfg.frontend != "none" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s - p)).astype(
                 np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                 np.int32)}
    if p:
        batch["embeds"] = rng.standard_normal((B, p, cfg.d_model)).astype(
            np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", DENSE)
def test_forward_and_loss_match_reference(name):
    jmodel, params, model, cfg = _pair(name)
    batch = _batch(cfg, 1)
    jlogits, _, _ = jmodel.forward(params, _jax(batch))
    logits, _, aux = model.forward(batch)
    assert logits.shape == (B, S, cfg.padded_vocab)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    # the padded vocabulary is masked to -1e30 in both
    assert (logits[..., cfg.vocab_size:] <= -1e29).all()
    jloss, jmetrics = jmodel.loss(params, _jax(batch))
    loss, metrics = model.loss(batch)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmetrics["ce"]),
                               **TOL)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == B * S


@pytest.mark.parametrize("name", DENSE)
def test_prefill_cache_and_decode_match_reference(name):
    """The port's prefill cache and last logits against the reference's;
    then one decode step of each package on the reference's cache,
    carried over, and the port's cache written as the reference's."""
    jmodel, params, model, cfg = _pair(name)
    batch = _batch(cfg, 2)
    jcache, jlast = jmodel.prefill(params, _jax(batch), cache_len=S + 4)
    cache, last = model.prefill(batch, cache_len=S + 4)
    jflat = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jcache))
    flat = jax.tree_util.tree_leaves(lm_cache_to_reference(cache))
    assert [a.shape for a in flat] == [a.shape for a in jflat]
    assert flat[0].shape == (cfg.n_layers, B, S + 4, cfg.n_kv_heads,
                             cfg.resolved_head_dim)
    for a, b in zip(flat, jflat):
        np.testing.assert_allclose(a, b, **TOL)
        assert not a[:, :, S:].any()  # the padding
    empty = jax.tree_util.tree_leaves(lm_cache_to_reference(
        model.init_cache(B, S + 4)))
    assert [a.shape for a in empty] == [a.shape for a in jflat]
    assert not any(a.any() for a in empty)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)

    rng = np.random.default_rng(3)
    token = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    jlogits, jcache2 = jmodel.decode_step(params, jcache, jnp.asarray(token),
                                          jnp.asarray(pos))
    carried = lm_cache_from_reference(jax.tree.map(np.asarray, jcache),
                                      device="cpu")
    logits, cache2 = model.decode_step(carried, token, pos)
    assert cache2["stack"] is carried["stack"]  # written in place
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(lm_cache_to_reference(cache2)),
                    jax.tree_util.tree_leaves(
                        jax.tree.map(np.asarray, jcache2))):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("name", DENSE)
def test_prefill_decode_matches_forward(name):
    """Greedy continuation: decode after prefill equals forward on the
    longer sequence (tests/test_models.py's cache check)."""
    _, _, model, cfg = _pair(name)
    batch = _batch(cfg, 4, s=S + 1)
    full, _, _ = model.forward(batch)
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    cache, last = model.prefill(short, cache_len=S + 4)
    step, _ = model.decode_step(cache, batch["tokens"][:, -1:],
                                np.full((B,), S, np.int32))
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, S].numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, S - 1].numpy(),
                               **TOL)


def _normal(key, shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(key), shape))


def test_chunked_attention_matches_reference():
    b, s, h, kv, hd = 2, 128, 4, 2, 16
    q, k, v = (_normal(i, (b, s, n, hd)) for i, n in enumerate((h, kv, kv)))
    full = attention.full_attention(*map(torch.from_numpy, (q, k, v)),
                                    causal=True)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(j_attn.full_attention(q, k, v, causal=True)),
        atol=2e-5)
    for qc, kc in [(32, 32), (64, 128), (128, 32)]:
        got = attention.chunked_attention(
            *map(torch.from_numpy, (q, k, v)), causal=True, q_chunk=qc,
            kv_chunk=kc)
        want = j_attn.chunked_attention(q, k, v, causal=True, q_chunk=qc,
                                        kv_chunk=kc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-5)


def test_attention_switches_to_chunks_above_the_full_limit():
    """2,048 positions take the full path, 4,096 the chunked one, which
    the reference's full formula matches there too."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 4096, 2, 8)).astype(np.float32)) for _ in range(3))
    assert attention.FULL_ATTN_MAX_SEQ == 2048
    short = attention.attention(q[:, :2048], k[:, :2048], v[:, :2048],
                                causal=True)
    assert torch.equal(short, attention.full_attention(
        q[:, :2048], k[:, :2048], v[:, :2048], causal=True))
    long = attention.attention(q, k, v, causal=True)
    assert torch.equal(long, attention.chunked_attention(q, k, v,
                                                         causal=True))
    np.testing.assert_allclose(long.numpy(), attention.full_attention(
        q, k, v, causal=True).numpy(), atol=2e-5)


def test_decode_attention_valid_len_masks_cache():
    b, s, h, hd = 2, 16, 2, 8
    q = torch.from_numpy(_normal(3, (b, 1, h, hd)))
    kc, vc, kn, vn = (torch.from_numpy(_normal(k, shape)) for k, shape in (
        (4, (b, s, h, hd)), (5, (b, s, h, hd)), (6, (b, 1, h, hd)),
        (7, (b, 1, h, hd))))
    # write at slot = valid_len = S-1 -> full attention over the cache
    vl = torch.full((b,), s - 1)
    kc2, vc2 = attention.write_kv_slot(kc.clone(), vc.clone(), kn, vn, vl)
    o = attention.decode_attention(q, kc2, vc2, vl, valid_len=vl)
    o_ref = attention.full_attention(q, kc2, vc2, causal=False)
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(), atol=1e-5)
    jo = j_attn.decode_attention(q.numpy(), kc2.numpy(), vc2.numpy(),
                                 vl.numpy(), valid_len=vl.numpy())
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5)
    # valid_len = 0, slot 0: only the new token participates -> o == v_new
    z = torch.zeros((b,), dtype=torch.long)
    kc3, vc3 = attention.write_kv_slot(kc.clone(), vc.clone(), kn, vn, z)
    o0 = attention.decode_attention(q, kc3, vc3, z, valid_len=z)
    np.testing.assert_allclose(o0[:, 0].numpy(), vn[:, 0].numpy(),
                               atol=1e-5)


def test_layer_groups_decomposition():
    for name, want in [("llama3-8b", (0, 1, 32)),
                       ("deepseek-moe-16b", (1, 1, 27))]:
        specs = registry.get_config(name).layer_specs()
        g = layer_groups(specs)
        assert (len(g.prefix), len(g.pattern), g.n_repeat) == want, name
        assert tuple(list(g.prefix) + list(g.pattern) * g.n_repeat) == specs


@pytest.mark.parametrize("name", j_registry.ARCH_NAMES)
def test_registry_matches_reference(name):
    assert registry.ARCH_NAMES == j_registry.ARCH_NAMES
    for get in ("get_config", "get_smoke_config"):
        got = getattr(registry, get)(name)
        want = getattr(j_registry, get)(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.layer_specs() == tuple(
            type(got.layer_specs()[0])(s.mixer, s.ffn)
            for s in want.layer_specs())
    assert dataclasses.asdict(registry.default_sharding(name)) == \
        dataclasses.asdict(j_registry.default_sharding(name))


def test_model_runs_on_its_topology_device():
    cfg = registry.get_smoke_config("llama3-8b")
    topo = smoke_topology(cfg, device="cpu")
    assert topo.constrain("x", "batch") == "x"
    model = build_model(cfg, topo)
    assert model.device == torch.device("cpu")
    model.init(torch.Generator().manual_seed(0))
    assert all(p.device.type == "cpu" and not p.requires_grad
               for p in model.parameters())
    # param_count leaves out the final norm
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + cfg.d_model


@pytest.mark.parametrize("name", ["gemma-7b", "starcoder2-7b"])
def test_init_follows_the_reference_rules(name):
    """Each leaf's kind and spread as the reference initialises it
    (fan_in = the second-to-last dimension, embed N(0, 0.02), norms 1,
    biases 0); the draws themselves are torch's."""
    jcfg = j_registry.get_smoke_config(name)
    want = jax.tree.map(np.asarray, j_build_model(
        jcfg, j_smoke_topology(jcfg)).init(jax.random.PRNGKey(0)))
    cfg = registry.get_smoke_config(name)
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got[".".join(str(getattr(p, "key", getattr(p, "idx", None)))
                         for p in path)]
        assert g.shape == w.shape and g.dtype == w.dtype
        if w.std() == 0:
            assert (g == w).all()
        else:
            assert abs(g.std() / w.std() - 1) < 0.15
    # init_params draws the same tree as CausalLM.init for one seed
    tree = init_params(model.defs(), cfg.dtype,
                       torch.Generator().manual_seed(0), "cpu")
    params = dict(model.named_parameters())
    flat = lm_params_from_reference(cfg, tree)  # flattened and checked
    assert all(torch.equal(params[k], v) for k, v in flat.items())
    assert param_bytes(model.defs(), cfg.dtype) == sum(
        p.numel() * p.element_size() for p in model.parameters())


def test_build_model_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(registry.get_smoke_config("llama3-8b"))

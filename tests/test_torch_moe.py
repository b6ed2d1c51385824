"""The port's mixture-of-experts FFN (`models/moe.py`, its blocks and
`CausalLM`s) against the reference's `repro.models.moe` on the CPU.

Inputs are made with numpy from a seed; parameters are the reference's
`init_params` (or `CausalLM.init`) tree, carried over. The smoke configs
are float32. Tolerances:

* the router's probabilities, the expert products, the combine and the
  aux loss: rtol = atol = 2e-6 (float32 products and sums in other
  orders; measured below 1e-6);
* expert ids are compared first and exactly. Softmax bits differ
  between XLA and torch by an ulp or so, so a token whose k-th and
  (k+1)-th probabilities lie within NEAR_TIE of each other may take the
  other expert: such tokens are counted as near-ties and reported, and
  any other difference fails. None occurs on these inputs;
* the dispatch buffer, its drops and slots: exactly (the same ids give
  the same sort, ranks and copies);
* `apply_moe` against both packages' `moe_dense_oracle`: the
  reference's own 1e-5 (tests/test_models.py), at capacity factor 8.0
  (nothing drops) and 0.1 (most entries drop and pass the residual);
* the two MoE smoke `CausalLM`s: tests/test_torch_models.py's 2e-4 on
  logits, loss, caches and aux.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.models import build_model as j_build_model
from repro.models import moe as j_moe
from repro.models.common import init_params as j_init_params
from repro.sharding.rules import smoke_topology as j_smoke_topology
from repro_torch.configs import registry
from repro_torch.interop import (
    lm_cache_from_reference,
    lm_cache_to_reference,
    lm_params_from_reference,
)
from repro_torch.models import build_model, moe
from repro_torch.models.causal_lm import model_defs
from repro_torch.models.common import flatten_defs, matmul

MOE = ("olmoe-1b-7b", "deepseek-moe-16b")
FN_TOL = dict(rtol=2e-6, atol=2e-6)
ORACLE_TOL = dict(atol=1e-5)
LM_TOL = dict(rtol=2e-4, atol=2e-4)
NEAR_TIE = 1e-6
B, S = 2, 32


def _cfg(name="olmoe-1b-7b", **kw):
    return (dataclasses.replace(j_registry.get_smoke_config(name), **kw),
            dataclasses.replace(registry.get_smoke_config(name), **kw))


def _moe_params(jcfg, seed=0):
    """The reference's MoE params (numpy) and the port's tensors."""
    tree = jax.tree.map(np.asarray, j_init_params(
        jax.random.PRNGKey(seed), j_moe.moe_defs(jcfg), "float32"))

    def to_t(node):
        if isinstance(node, dict):
            return {k: to_t(v) for k, v in node.items()}
        return torch.from_numpy(node.copy())

    return tree, to_t(tree)


def _x(d, t=B * S, seed=1):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)


def _near_ties(probs, ids, j_ids, k):
    """Tokens whose expert ids differ, all of which must be near-ties:
    returns their count."""
    differ = (ids != j_ids).any(axis=-1)
    if not differ.any():
        return 0
    top = np.sort(probs, axis=-1)[:, ::-1]
    margin = top[:, k - 1] - top[:, k]
    assert (margin[differ] < NEAR_TIE).all(), (
        "expert ids differ beyond a near-tie", margin[differ])
    return int(differ.sum())


@pytest.fixture(scope="module")
def routed():
    """olmoe smoke: x, both packages' params and routes."""
    jcfg, cfg = _cfg(capacity_factor=1.0)
    jp, tp = _moe_params(jcfg)
    x = _x(cfg.d_model)
    j_probs = np.asarray(j_moe._router_probs(jp, x, jcfg))
    jw, jids = (np.asarray(a) for a in jax.lax.top_k(
        j_probs, jcfg.n_experts_per_token))
    probs, weights, ids = moe.route(tp, torch.from_numpy(x), cfg)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, x=x, j_probs=j_probs,
                jw=jw, jids=jids, probs=probs, weights=weights, ids=ids)


def test_router_probs_and_top_k_match_reference(routed):
    r = routed
    k = r["cfg"].n_experts_per_token
    np.testing.assert_allclose(r["probs"].numpy(), r["j_probs"], **FN_TOL)
    assert _near_ties(r["probs"].numpy(), r["ids"].numpy(), r["jids"],
                      k) == 0
    jw = r["jw"] / np.maximum(r["jw"].sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(r["weights"].numpy(), jw, **FN_TOL)


def test_top_k_breaks_ties_toward_the_lower_expert():
    """jax.lax.top_k's order: descending, and among equal values the
    lower index first; the port's stable sort keeps it."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    jv, jid = (np.asarray(a) for a in jax.lax.top_k(probs, 3))
    v, ids = moe._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ids.numpy(), jid)
    np.testing.assert_array_equal(v.numpy(), jv)


@pytest.mark.parametrize("capacity", [64, 12, 2])
def test_dispatch_matches_reference(routed, capacity):
    """The packed buffer, its drops and slots equal the reference's, with
    ample capacity, with some drops and with most entries dropped."""
    r = routed
    j_out = [np.asarray(a) for a in j_moe._dispatch(
        r["x"], jnp.asarray(r["jids"]), r["jcfg"], capacity)]
    out = [a.numpy() for a in moe._dispatch(
        torch.from_numpy(r["x"]), r["ids"], r["cfg"], capacity)]
    for got, want, name in zip(out, j_out, ("buffer", "dst_e", "dst_c",
                                            "keep", "token_idx", "order")):
        np.testing.assert_array_equal(got, want, err_msg=name)
    keep = out[3]
    assert (capacity == 64) == keep.all()


def test_expert_ffn_and_combine_match_reference(routed):
    r = routed
    cap = 12
    jbuf, *jrest = j_moe._dispatch(r["x"], jnp.asarray(r["jids"]),
                                   r["jcfg"], cap)
    buf, *rest = moe._dispatch(torch.from_numpy(r["x"]), r["ids"], r["cfg"],
                               cap)
    jp, tp = r["jp"], r["tp"]
    j_out = j_moe._expert_ffn(r["jcfg"], jp["w_gate"], jp["w_up"],
                              jp["w_down"], jbuf)
    out = moe._expert_ffn(r["cfg"], tp["w_gate"], tp["w_up"], tp["w_down"],
                          buf)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **FN_TOL)
    t = r["x"].shape[0]
    jw = r["jw"] / np.maximum(r["jw"].sum(-1, keepdims=True), 1e-9)
    j_y = j_moe._combine(j_out, *jrest, jnp.asarray(jw), t)
    y = moe._combine(out, *rest, r["weights"], t)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_y), **FN_TOL)
    # a dropped entry contributes zero: tokens with every entry dropped
    keep = rest[2].numpy()
    token_idx = rest[3].numpy()
    all_dropped = np.setdiff1d(np.arange(t), token_idx[keep])
    assert all_dropped.size and not y.numpy()[all_dropped].any()


def test_combine_sums_in_the_sorted_order(routed):
    """Each token's k contributions are added left to right in their
    order in the sorted list (by expert id), the reference's serial
    scatter order, bit for bit against that explicit loop."""
    r = routed
    buf, dst_e, dst_c, keep, token_idx, order = moe._dispatch(
        torch.from_numpy(r["x"]), r["ids"], r["cfg"], 64)
    out = moe._expert_ffn(r["cfg"], r["tp"]["w_gate"], r["tp"]["w_up"],
                          r["tp"]["w_down"], buf)
    t = r["x"].shape[0]
    y = moe._combine(out, dst_e, dst_c, keep, token_idx, order,
                     r["weights"], t)
    contrib = (out[dst_e, dst_c] * keep[:, None]
               * r["weights"].reshape(-1)[order][:, None])
    want = torch.zeros_like(y)
    for i, tok in enumerate(token_idx.tolist()):
        want[tok] = want[tok] + contrib[i]
    assert torch.equal(y, want)


def test_aux_loss_matches_reference(routed):
    r = routed
    j_aux = float(j_moe._aux_loss(r["j_probs"], jnp.asarray(r["jids"]),
                                  r["jcfg"]))
    aux = moe._aux_loss(r["probs"], r["ids"], r["cfg"])
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), j_aux, **FN_TOL)
    assert 0.9 < float(aux) < 4.0


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("capacity_factor", [8.0, 0.1])
def test_apply_moe_matches_both_oracles(name, capacity_factor):
    """apply_moe against the port's and the reference's
    moe_dense_oracle (nothing drops at 8.0), and against the reference's
    apply_moe at both factors; at 0.1 most entries drop and pass the
    residual (tests/test_models.py's cases)."""
    jcfg, cfg = _cfg(name, capacity_factor=capacity_factor)
    jp, tp = _moe_params(jcfg)
    x = _x(cfg.d_model, seed=2).reshape(B, S, cfg.d_model)
    xt = torch.from_numpy(x)
    y, aux = moe.apply_moe(tp, xt, cfg)
    jy, jaux = j_moe.apply_moe(jp, x, jcfg, j_smoke_topology(jcfg))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **ORACLE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **FN_TOL)
    if capacity_factor == 8.0:
        y_o, aux_o = moe.moe_dense_oracle(tp, xt, cfg)
        jy_o, jaux_o = j_moe.moe_dense_oracle(jp, x, jcfg)
        np.testing.assert_allclose(y.numpy(), y_o.numpy(), **ORACLE_TOL)
        np.testing.assert_allclose(y_o.numpy(), np.asarray(jy_o),
                                   **ORACLE_TOL)
        assert float(aux) == float(aux_o)
        np.testing.assert_allclose(float(aux_o), float(jaux_o), **FN_TOL)
    else:
        assert bool(torch.isfinite(y).all())
        routed_part = y.numpy()
        if cfg.n_shared_experts:  # the shared experts are never dropped
            routed_part = routed_part - moe.apply_mlp(
                tp["shared"], xt, cfg).numpy()
        assert (np.abs(routed_part) < 1e-6).mean() > 0.3


def test_matmul_float32_output_cases():
    """The 2-D float32-output product 18a relies on is unchanged (on the
    CPU: the product of the upcast operands), and the batched (E, C, d)
    x (E, d, f) case takes the same rule; same-dtype products stay in
    the input dtype."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((8, 6)).astype(
        np.float32)).to(torch.bfloat16)
    y = matmul(x, w, dtype=torch.float32)
    assert y.dtype == torch.float32 and y.shape == (2, 5, 6)
    assert torch.equal(y, x.float() @ w.float())
    assert torch.equal(matmul(x, w), x @ w) and matmul(x, w).dtype == \
        torch.bfloat16
    we = torch.from_numpy(rng.standard_normal((2, 8, 3)).astype(
        np.float32)).to(torch.bfloat16)
    yb = matmul(x, we, dtype=torch.float32)
    assert yb.dtype == torch.float32 and yb.shape == (2, 5, 3)
    assert torch.equal(yb, torch.bmm(x.float(), we.float()))


# ---------------------------------------------------------------------------
# The MoE smoke CausalLMs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    name = request.param
    jcfg = j_registry.get_smoke_config(name)
    jmodel = j_build_model(jcfg, j_smoke_topology(jcfg))
    rng = np.random.default_rng(7)

    def offset(path, a):
        a = np.asarray(a)
        if getattr(path[-1], "key", None) == "scale":
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
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_moe_lm_forward_loss_and_aux_match_reference(pair):
    jmodel, params, model, cfg = pair
    batch = _batch(cfg, 1)
    jlogits, _, jaux = jmodel.forward(params, _jax(batch))
    logits, _, aux = model.forward(batch)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LM_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **LM_TOL)
    assert 0.5 < float(aux) / sum(s.ffn == "moe" for s in model.specs) < 4
    jloss, jm = jmodel.loss(params, _jax(batch))
    loss, m = model.loss(batch)
    np.testing.assert_allclose(float(loss), float(jloss), **LM_TOL)
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), **LM_TOL)
    # the router's term is in the loss
    np.testing.assert_allclose(float(loss), float(m["ce"])
                               + cfg.router_aux_loss * float(aux),
                               rtol=1e-6)


def test_moe_lm_expert_ids_match_reference(pair, monkeypatch):
    """Every MoE layer's expert ids in a forward pass equal the
    reference's (its model unrolled and without remat, so the ids are
    concrete arrays), near-ties counted as in `_near_ties`."""
    _, params, model, cfg = pair
    jcfg = j_registry.get_smoke_config(cfg.name.replace("-smoke", ""))
    jmodel = j_build_model(jcfg, j_smoke_topology(jcfg), remat="none",
                           scan_layers=False)
    batch = _batch(cfg, 5)
    j_ids, ids = [], []
    j_route, route = j_moe._dispatch, moe.route

    def j_rec(x, expert_ids, c, capacity):
        j_ids.append(np.asarray(expert_ids))
        return j_route(x, expert_ids, c, capacity)

    def rec(p, x, c):
        out = route(p, x, c)
        ids.append((out[0].numpy(), out[2].numpy()))
        return out

    monkeypatch.setattr(j_moe, "_dispatch", j_rec)
    monkeypatch.setattr(moe, "route", rec)
    jmodel.forward(params, _jax(batch))
    model.forward(batch)
    assert len(ids) == len(j_ids) == sum(s.ffn == "moe"
                                         for s in model.specs)
    assert sum(_near_ties(p, i, j, cfg.n_experts_per_token)
               for (p, i), j in zip(ids, j_ids)) == 0


def test_moe_lm_prefill_and_decode_match_reference(pair):
    jmodel, params, model, cfg = pair
    batch = _batch(cfg, 2)
    jcache, jlast = jmodel.prefill(params, _jax(batch), cache_len=S + 4)
    cache, last = model.prefill(batch, cache_len=S + 4)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **LM_TOL)
    jflat = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, jcache))
    flat = jax.tree_util.tree_leaves(lm_cache_to_reference(cache))
    assert [a.shape for a in flat] == [a.shape for a in jflat]
    for a, c in zip(flat, jflat):
        np.testing.assert_allclose(a, c, **LM_TOL)
    token = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                              (B, 1)).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    jlogits, _ = jmodel.decode_step(params, jcache, jnp.asarray(token),
                                    jnp.asarray(pos))
    carried = lm_cache_from_reference(jax.tree.map(np.asarray, jcache),
                                      device="cpu")
    logits, _ = model.decode_step(carried, token, pos)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **LM_TOL)


def test_moe_lm_decode_matches_forward(pair):
    """Greedy continuation at a capacity where nothing drops (the
    reference's test raises it to 8.0 for the same reason)."""
    _, _, loaded, cfg = pair
    model = build_model(dataclasses.replace(cfg, capacity_factor=8.0),
                        device="cpu")
    model.load_state_dict(loaded.state_dict())
    batch = _batch(cfg, 4, s=S + 1)
    full, _, _ = model.forward(batch)
    cache, last = model.prefill({"tokens": batch["tokens"][:, :-1]},
                                cache_len=S + 4)
    step, _ = model.decode_step(cache, batch["tokens"][:, -1:],
                                np.full((B,), S, np.int32))
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, S].numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, S - 1].numpy(),
                               **LM_TOL)


def test_deepseek_stacks_a_dense_prefix_and_moe_repeats():
    """The full deepseek tree: one dense prefix layer, 27 stacked MoE
    repeats with (27, E, d, f) expert leaves and shared experts, names
    and shapes equal to the reference's definitions."""
    from repro.models.causal_lm import CausalLM as JCausalLM

    jcfg = j_registry.get_config("deepseek-moe-16b")
    cfg = registry.get_config("deepseek-moe-16b")
    jdefs = JCausalLM(jcfg, None).defs()
    want = {"/".join(str(getattr(p, "key", getattr(p, "idx", None)))
                     for p in path).replace("/", "."): d.shape
            for path, d in jax.tree_util.tree_leaves_with_path(
                jdefs, is_leaf=lambda d: hasattr(d, "logical"))}
    got = {n: d.shape for n, d in flatten_defs(model_defs(cfg))}
    assert got == want
    assert got["blocks.prefix.0.ffn.w_gate"] == (2048, 10944)
    assert got["blocks.stack.l0.ffn.w_gate"] == (27, 64, 2048, 1408)
    assert got["blocks.stack.l0.ffn.shared.w_down"] == (27, 2816, 2048)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_build_model_takes_moe(name, smoke):
    """build_model builds both MoE families: the smoke size on the CPU,
    the published size on the meta device (no memory): every parameter
    of the reference's count (which leaves out the final norm)."""
    cfg = (registry.get_smoke_config if smoke else registry.get_config)(name)
    model = build_model(cfg, device="cpu" if smoke else "meta")
    jcfg = (j_registry.get_smoke_config if smoke
            else j_registry.get_config)(name)
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() + cfg.d_model == \
        jcfg.param_count() + cfg.d_model
    routers = [p for k, p in model.named_parameters()
               if k.endswith("ffn.router")]
    assert routers and all(p.shape[-1] == cfg.n_experts for p in routers)

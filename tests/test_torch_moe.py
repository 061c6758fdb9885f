"""Port parity for the MoE layer: ``repro_torch.models.moe`` against the
JAX package's ``models/moe.py`` on the reduced Qwen1.5-MoE (4 experts
top-2 + 1 shared) and Llama-4-Scout (4 experts top-1 + 1 shared)
configs in f32, weights carried across, inputs numpy normals from a
seed.

Routing is compared exactly: the top-k expert indices, each route's
slot in its expert and which routes are kept, at ``capacity_factor``
1.0 (routes are dropped) and 64 (none are). The reference's routing
values come from the same ``jnp`` steps as its ``moe_ffn``
(moe.py:57-78), which returns only the output and the loss. The output
is held to rtol = atol = 1e-5 on unit-scale values (f32 products in
another order): the random experts' outputs reach |y| of several
hundred (``dense_init`` scales the (E, d, ff) tensors by E^-0.5, not
d^-0.5), so both sides are divided by the reference's max |y| first.
The auxiliary loss is held to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.models import moe as M

TOL = dict(rtol=1e-5, atol=1e-5)
AUX_TOL = 1e-6
ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")


def to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.as_tensor(np.array(a))


def pair(arch, **over):
    jcfg = dataclasses.replace(jget(arch).reduced(), **over)
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    jp = JM.moe_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jax.tree_util.tree_map(to_torch, jp), jp


def close_unit(y, jy):
    """y against the reference's jy, both divided by max |jy|."""
    want = np.asarray(jy, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(y.float().numpy() / scale, want / scale,
                               **TOL)


def inputs(shape, seed=1):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.as_tensor(a), jnp.asarray(a)


def reference_routing(cfg, p, x):
    """(expert_idx, pos_in_e, keep, aux) by the reference's steps."""
    E, K = JM.padded_experts(cfg), cfg.top_k
    xt = x.reshape(-1, x.shape[-1])
    T = xt.shape[0]
    logits = xt.astype(jnp.float32) @ p["router"]
    if E > cfg.num_experts:
        logits = jnp.where(jnp.arange(E) >= cfg.num_experts, -1e30, logits)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, K)
    me = probs.mean(axis=0)
    ce = jnp.zeros(E).at[expert_idx.reshape(-1)].add(1.0) / (T * K)
    aux = E * jnp.sum(me * ce) * cfg.router_aux_weight
    C = JM._capacity(T, E, K, cfg.capacity_factor)
    flat_e = expert_idx.reshape(T * K)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    pos_in_e = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return (np.asarray(expert_idx), np.asarray(pos_in_e),
            np.asarray(pos_in_e < C), float(aux))


def check_routing(cfg, jcfg, p, jp, x, xj):
    r = M.routing(cfg, p, x.reshape(-1, cfg.d_model))
    idx, pos, keep, aux = reference_routing(jcfg, jp, xj)
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert abs(float(r.aux) - aux) <= AUX_TOL
    assert r.capacity == JM._capacity(x.shape[0] * x.shape[1],
                                      JM.padded_experts(jcfg), jcfg.top_k,
                                      jcfg.capacity_factor)
    return r


@pytest.mark.parametrize("factor", [1.0, 64.0], ids=["drops", "no_drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, factor):
    cfg, jcfg, p, jp = pair(arch, capacity_factor=factor)
    x, xj = inputs((4, 32, cfg.d_model))
    r = check_routing(cfg, jcfg, p, jp, x, xj)
    assert bool(r.keep.all()) == (factor == 64.0), "drops happen at 1.0"
    y, aux = M.moe_ffn(cfg, p, x)
    jy, jaux = JM.moe_ffn(jcfg, jp, xj)
    close_unit(y, jy)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    assert y.dtype == x.dtype and aux.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_router_ties_every_expert(arch):
    """A zero router ties all experts for every token: the lowest indices
    win, as ``lax.top_k`` picks them, and the loss is the reference's."""
    cfg, jcfg, p, jp = pair(arch, router_aux_weight=1.0)
    p["router"] = torch.zeros_like(p["router"])
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    x, xj = inputs((2, 64, cfg.d_model), seed=2)
    r = check_routing(cfg, jcfg, p, jp, x, xj)
    assert (r.expert_idx == torch.arange(cfg.top_k)).all()
    y, aux = M.moe_ffn(cfg, p, x)
    jy, jaux = JM.moe_ffn(jcfg, jp, xj)
    close_unit(y, jy)
    assert float(aux) == float(jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_experts_receive_nothing(arch):
    """``pad_experts_to`` past ``num_experts``: the padded experts get
    -1e30 logits, no route and no probability; the rest matches."""
    cfg, jcfg, p, jp = pair(arch, pad_experts_to=7)
    assert M.padded_experts(cfg) == 7 > cfg.num_experts
    assert p["w_gate"].shape[0] == 7 and p["router"].shape[1] == 7
    x, xj = inputs((2, 24, cfg.d_model), seed=3)
    r = check_routing(cfg, jcfg, p, jp, x, xj)
    assert int(r.expert_idx.max()) < cfg.num_experts
    y, aux = M.moe_ffn(cfg, p, x)
    jy, jaux = JM.moe_ffn(jcfg, jp, xj)
    close_unit(y, jy)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_oracle_matches_reference(arch):
    """``moe_ffn_dense`` against the reference's oracle, and the scatter
    path against both when nothing is dropped."""
    cfg, jcfg, p, jp = pair(arch, capacity_factor=64.0)
    x, xj = inputs((2, 16, cfg.d_model), seed=4)
    dense = M.moe_ffn_dense(cfg, p, x)
    close_unit(dense, JM.moe_ffn_dense(jcfg, jp, xj))
    close_unit(M.moe_ffn(cfg, p, x)[0], dense.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_params_match_reference_layout(arch):
    """The port's own draw: the reference's names, shapes and dtypes, the
    router in f32, the experts at the reference's fan-in scale (E^-0.5:
    ``dense_init`` takes the leading axis as fan-in)."""
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jget(arch).reduced(), dtype=dtype)
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
        jp = JM.moe_params(jcfg, jax.random.PRNGKey(0))
        mine = M.moe_params(cfg, torch.Generator().manual_seed(0))
        shapes = jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype)), jp)
        assert jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
            mine) == shapes
    E = M.padded_experts(cfg)
    std = float(mine["w_gate"].float().std())
    assert abs(std - E ** -0.5) < 0.1 * E ** -0.5
    assert abs(float(mine["router"].std()) - 0.02) < 0.002


def test_moe_ffn_keeps_bf16_and_routes_in_f32():
    """In bf16 the output stays bf16, the router runs in f32, and the
    routing equals the reference's on the same bf16 input."""
    arch = "qwen2-moe-a2.7b"
    cfg, jcfg, p, jp = pair(arch, dtype="bfloat16")
    x, _ = inputs((2, 16, cfg.d_model), seed=5)
    x = x.to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    check_routing(cfg, jcfg, p, jp, x, xj)
    y, aux = M.moe_ffn(cfg, p, x)
    jy, _ = JM.moe_ffn(jcfg, jp, xj)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    scale = float(np.abs(np.asarray(jy, np.float32)).max())
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               rtol=2.0 ** -6, atol=2.0 ** -6 * scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_follows_from_the_chosen_experts(arch):
    """``route`` on the router's own top-k equals ``routing``; given other
    experts, its gates are the router's probabilities at them,
    renormalised, and its slots count the routes in token-major order."""
    cfg, _, p, _ = pair(arch, capacity_factor=1.0)
    x, _ = inputs((2, 24, cfg.d_model), seed=6)
    xt = x.reshape(-1, cfg.d_model)
    r = M.routing(cfg, p, xt)
    probs = M.router_probs(cfg, p, xt)
    again = M.route(cfg, probs, r.expert_idx)
    for a, b in zip(r, again):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    other = (r.expert_idx + 1) % cfg.num_experts
    forced = M.route(cfg, probs, other)
    gates = probs.gather(1, other)
    torch.testing.assert_close(forced.gates,
                               gates / gates.sum(-1, keepdim=True))
    flat = other.reshape(-1).tolist()
    slots = [flat[:i].count(e) for i, e in enumerate(flat)]
    assert forced.pos.tolist() == slots
    assert forced.keep.tolist() == [s < forced.capacity for s in slots]

"""Port parity for the MoE FFN: ``moe_route``, ``moe_apply`` and
``moe_apply_naive`` against the JAX reference on the CPU, in float32.

Parameters come from the reference's ``moe_init`` and reach the port
through ``params_from_numpy``; activations are numpy. The cases cover
ample capacity (no drops), a tight capacity factor that drops choices,
shared experts, ``no_drop``, a token count whose largest divisor is below
``group_size``, forced router ties, and the gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoECfg as JMoECfg
from repro.configs.base import ModelConfig as JModelConfig
from repro.models import common as jcm
from repro_torch.configs.base import MoECfg, ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models import common as cm

Y_TOL, AUX_TOL = 1e-5, 1e-6     # f32: the same einsums summed in another
                                # order


def _cfgs(E=8, k=2, g=16, cf=8.0, shared=0, d=32):
    """(reference cfg, port cfg): tests/test_components.py's MoE config."""
    kw = dict(name="t", family="moe", d_model=d, n_layers=2, n_heads=2,
              n_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32")
    moe = dict(n_experts=E, top_k=k, d_ff_expert=32, group_size=g,
               capacity_factor=cf, n_shared_experts=shared)
    return (JModelConfig(moe=JMoECfg(**moe), **kw),
            ModelConfig(moe=MoECfg(**moe), **kw))


def _params(jcfg, seed=0):
    jp = jcm.moe_init(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), "cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(t, j):
    return float(np.abs(t.detach().float().numpy()
                        - np.asarray(j, np.float32)).max())


# (E, k, group, capacity factor, shared experts, B, S, no_drop)
CASES = [
    (8, 2, 16, 8.0, 0, 2, 16, False),     # ample capacity: no drops
    (8, 2, 16, 0.25, 0, 2, 16, False),    # tight: choices dropped at C
    (8, 2, 16, 8.0, 2, 2, 16, False),     # shared experts
    (8, 2, 16, 0.25, 2, 2, 16, True),     # no_drop: C = g*k
    (6, 3, 16, 1.0, 1, 2, 9, False),      # T = 18: groups of 9 < 16
    (4, 2, 512, 1.25, 0, 3, 7, False),    # T = 21: groups of 7
]


@pytest.mark.parametrize("E,k,g,cf,shared,B,S,no_drop", CASES)
def test_moe_apply_matches_reference(E, k, g, cf, shared, B, S, no_drop):
    jcfg, cfg = _cfgs(E, k, g, cf, shared)
    jp, tp = _params(jcfg)
    x = _x(1, (B, S, cfg.d_model))
    y_j, aux_j = jcm.moe_apply(jp, jnp.asarray(x), jcfg, no_drop=no_drop)
    y, aux = cm.moe_apply(tp, torch.from_numpy(x), cfg, no_drop=no_drop)
    assert y.shape == (B, S, cfg.d_model) and y.dtype == torch.float32
    assert _err(y, y_j) < Y_TOL
    assert abs(float(aux) - float(aux_j)) < AUX_TOL and float(aux) > 0


def test_moe_capacity_drops_against_the_oracle():
    """Ample capacity equals the per-token oracle; a tight one drops
    choices (the output moves away from it), and ``no_drop`` restores it
    at any capacity factor."""
    jcfg, cfg = _cfgs(cf=8.0, shared=2)
    _, tp = _params(jcfg)
    x = torch.from_numpy(_x(2, (2, 16, cfg.d_model)))
    naive = cm.moe_apply_naive(tp, x, cfg)
    assert _err(cm.moe_apply(tp, x, cfg)[0], naive.numpy()) < 1e-4
    tight = cfg.replace(moe=MoECfg(**{**cfg.moe.__dict__,
                                      "capacity_factor": 0.25}))
    assert _err(cm.moe_apply(tp, x, tight)[0], naive.numpy()) > 1e-3
    assert _err(cm.moe_apply(tp, x, tight, no_drop=True)[0],
                naive.numpy()) < 1e-4


def test_moe_apply_naive_matches_reference():
    jcfg, cfg = _cfgs(shared=2)
    jp, tp = _params(jcfg)
    x = _x(3, (2, 16, cfg.d_model))
    want = jcm.moe_apply_naive(jp, jnp.asarray(x), jcfg)
    got = cm.moe_apply_naive(tp, torch.from_numpy(x), cfg)
    assert _err(got, want) < Y_TOL


def _tied(E=8, d=32):
    """Small integers and quarters, so every router logit is exact in any
    summation order: the router's columns 1, 3 and 6 are equal and column
    5 is zero, and half of the rows of x are zero (all experts tie)."""
    rng = np.random.default_rng(4)
    router = rng.integers(-2, 3, (d, E)).astype(np.float32) / 4
    router[:, 3] = router[:, 1]
    router[:, 6] = router[:, 1]
    router[:, 5] = 0.0
    x = rng.integers(-2, 3, (2, 16, d)).astype(np.float32)
    x[:, ::2] = 0.0
    return router, x


@pytest.mark.parametrize("k", [1, 2, 3])
def test_moe_route_breaks_ties_as_lax_top_k(k):
    """Equal probabilities go to the lower expert first, as ``lax.top_k``
    orders them."""
    router, x = _tied()
    probs_j = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    w_j, idx_j = jax.lax.top_k(probs_j, k)
    probs, w, idx = cm.moe_route({"router": torch.from_numpy(router)},
                                 torch.from_numpy(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert _err(probs, probs_j) < 1e-7
    w_j = w_j / jnp.maximum(w_j.sum(-1, keepdims=True), 1e-9)
    assert _err(w, w_j) < 1e-7
    # zero rows: a uniform router picks experts 0..k-1
    np.testing.assert_array_equal(idx[:, ::2].numpy(),
                                  np.broadcast_to(np.arange(k), (2, 8, k)))


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_apply_routes_ties_as_reference(cf):
    """With tied router columns the dispatch, the drops at capacity and the
    output follow the reference's routes."""
    jcfg, cfg = _cfgs(cf=cf)
    jp, tp = _params(jcfg)
    router, x = _tied()
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    y_j, aux_j = jcm.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux = cm.moe_apply(tp, torch.from_numpy(x), cfg)
    assert _err(y, y_j) < Y_TOL * max(1.0, float(jnp.abs(y_j).max()))
    assert abs(float(aux) - float(aux_j)) < AUX_TOL


@pytest.mark.parametrize("cf,shared", [(8.0, 2), (0.5, 0)])
def test_moe_gradients_match_reference(cf, shared):
    """d/d(params, x) of sum(y * cot) + aux against ``jax.grad`` of the
    reference; the router's gradient (through the gates and the aux loss)
    is nonzero."""
    jcfg, cfg = _cfgs(cf=cf, shared=shared)
    jp, tp = _params(jcfg)
    x = _x(5, (2, 16, cfg.d_model))
    cot = _x(6, (2, 16, cfg.d_model))

    def jloss(p, x_):
        y, aux = jcm.moe_apply(p, x_, jcfg)
        return jnp.sum(y * cot) + aux

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v for k, v in _flat(tp).items()}
    for t in leaves.values():
        t.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = cm.moe_apply(tp, xt, cfg)
    loss = (y * torch.from_numpy(cot)).sum() + aux
    grads = torch.autograd.grad(loss, list(leaves.values()) + [xt])
    want = _flat(gp_j)
    assert list(want) == list(leaves)
    for (name, g), j in zip(zip(leaves, grads), want.values()):
        scale = max(1.0, float(jnp.abs(j).max()))
        assert _err(g, j) / scale < 1e-5, name
    assert _err(grads[-1], gx_j) < 1e-5
    assert float(grads[list(leaves).index("router")].abs().max()) > 0


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out

"""Parity of the port's LeNet, optimizers, compression and split model with
the reference (``repro.models.lenet``, ``repro.optim``,
``repro.core.compression``, ``repro.core.splitting``), on the CPU.

Inputs come from numpy; the reference's parameters reach the port through
``convert.params_from_numpy`` (torch cannot reproduce JAX's threefry
init). Tolerances: forward logits within ``FWD_ATOL``; gradients within
``GRAD_ATOL * max(1, max|grad|)`` per leaf (f32 sums in another order;
the inputs keep max-pool windows free of near-ties, so no gradient entry
is routed differently); optimizer updates within 1e-7; compression
bit-exact (top-k indices and int8 codes are integers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import compression as rcmp
from repro.core import splitting as rsplit
from repro.models import lenet as rlenet
from repro import optim as roptim
from repro_torch import optim as toptim
from repro_torch import tree
from repro_torch.convert import params_from_numpy
from repro_torch.core import compression as tcmp
from repro_torch.core import splitting as tsplit
from repro_torch.models import lenet as tlenet

FWD_ATOL = 1e-5
GRAD_ATOL = 1e-5


@pytest.fixture(scope="module")
def params():
    p = jax.device_get(rlenet.init(jax.random.PRNGKey(0)))
    return p, params_from_numpy(p, "cpu")


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, 28, 28, 1)).astype(np.float32)


def _labels(n, seed=0):
    return np.random.default_rng(seed + 1).integers(0, 10, n).astype(np.int32)


@pytest.mark.parametrize("conv_impl", ["direct", "im2col"])
def test_forward_matches_reference(params, conv_impl):
    rp, tp = params
    x = _images(6)
    want = np.asarray(rlenet.apply_range(rp, jnp.asarray(x), 0, 12,
                                         conv_impl))
    got = tlenet.forward(tp, torch.from_numpy(x), conv_impl).numpy()
    assert got.shape == (6, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    y = _labels(6)
    assert float(tlenet.loss_fn(tp, {"image": torch.from_numpy(x),
                                     "label": torch.from_numpy(y)})) == \
        pytest.approx(float(rlenet.loss_fn(rp, {"image": jnp.asarray(x),
                                                "label": jnp.asarray(y)})),
                      rel=1e-6)


@pytest.mark.parametrize("conv_impl", ["direct", "im2col"])
@pytest.mark.parametrize("v", range(1, 12))
def test_split_gradients_per_cut(params, v, conv_impl):
    """Device part [0, v), server part [v, 12): the smashed data (NHWC),
    the loss and every parameter's gradient match the reference at each
    cut."""
    rp, tp = params
    x, y = _images(4, seed=v), _labels(4, seed=v)
    rdev, rsrv = rlenet.split_params(rp, v)

    def rloss(dev, srv):
        sm = rlenet.apply_range(dev, jnp.asarray(x), 0, v, conv_impl)
        lg = rlenet.apply_range(srv, sm, v, 12, conv_impl)
        logp = jax.nn.log_softmax(lg)
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], -1).mean()

    rl, (rgd, rgs) = jax.value_and_grad(rloss, argnums=(0, 1))(rdev, rsrv)
    tdev, tsrv = tlenet.split_params(
        tree.map(lambda t: t.clone().requires_grad_(), tp), v)
    sm = tlenet.apply_range(tdev, torch.from_numpy(x), 0, v, conv_impl)
    assert tuple(sm.shape[1:]) == tlenet.layer_shapes()[v - 1]
    np.testing.assert_allclose(
        sm.detach().numpy(), np.asarray(rlenet.apply_range(
            rdev, jnp.asarray(x), 0, v, conv_impl)), rtol=0, atol=FWD_ATOL)
    lg = tlenet.apply_range(tsrv, sm, v, 12, conv_impl)
    tl = tlenet.nll(lg, torch.from_numpy(y)).mean()
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(rl), rel=1e-6)
    for side_r, side_t in ((rgd, tdev), (rgs, tsrv)):
        for name in side_r:
            for k in ("w", "b"):
                g = np.asarray(side_r[name][k])
                tol = GRAD_ATOL * max(1.0, float(np.abs(g).max()))
                np.testing.assert_allclose(side_t[name][k].grad.numpy(), g,
                                           rtol=0, atol=tol,
                                           err_msg=f"{v} {name}/{k}")


def test_pool_splits_gradient_among_relu_zero_ties():
    """Windows of ReLU zeros: the reference's reduce-max transpose splits
    the cotangent evenly among tied maxima; so does the port's amax.
    ``F.max_pool2d`` routes it to one element."""
    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, :2, :2, 0] = [[-1.0, -2.0], [-3.0, -4.0]]    # all ReLU'd to 0
    x[0, 2:, 2:, 0] = [[5.0, 5.0], [1.0, 5.0]]        # a three-way tie

    def rf(z):
        return rlenet._apply_layer({}, jax.nn.relu(z), "POOL1").sum()

    want = np.asarray(jax.grad(rf)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    tlenet._apply_layer({}, torch.relu(xt), "POOL1").sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    assert want[0, 2, 2, 0] == pytest.approx(1 / 3)

    xm = torch.from_numpy(x).requires_grad_()
    F.max_pool2d(torch.relu(xm).permute(0, 3, 1, 2), 2).sum().backward()
    assert not np.array_equal(xm.grad.numpy(), want)


@pytest.mark.parametrize("conv_impl", ["direct", "im2col"])
def test_clients_pass_equals_per_client(params, conv_impl):
    """The K-client pass (grouped convolution / batched matmul) equals the
    per-client pass stacked, at every cut."""
    _, tp = params
    K, B = 3, 2
    rng = np.random.default_rng(5)
    dev = tree.map(lambda t: torch.stack(
        [t + 0.01 * torch.from_numpy(rng.normal(size=t.shape)
                                     .astype(np.float32))
         for _ in range(K)]), tp)
    x = torch.from_numpy(_images(K * B).reshape(K, B, 28, 28, 1))
    got = tlenet.apply_range_clients(dev, x, 0, 12, conv_impl)
    want = torch.stack([tlenet.apply_range(tree.map(lambda t: t[k], dev),
                                           x[k], 0, 12, conv_impl)
                        for k in range(K)])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_init_shapes_and_scales():
    g = torch.Generator().manual_seed(0)
    p = tlenet.init(g)
    rp = jax.device_get(rlenet.init(jax.random.PRNGKey(0)))
    assert list(p) == list(rp)
    for name in rp:
        for k in ("w", "b"):
            assert tuple(p[name][k].shape) == rp[name][k].shape
            assert p[name][k].dtype == torch.float32
        rstd = float(np.std(rp[name]["w"]))
        assert float(p[name]["w"].std()) == pytest.approx(rstd, rel=0.15)
        assert not p[name]["b"].any()


def test_accuracy_matches_reference(params):
    rp, tp = params
    x, y = _images(40), _labels(40)
    assert tlenet.accuracy(tp, x, y, batch=16) == rlenet.accuracy(
        rp, jnp.asarray(x), jnp.asarray(y), batch=16)


# --------------------------------------------------------------------------
# split model
# --------------------------------------------------------------------------

@pytest.mark.parametrize("v", [1, 3, 9, 11])
def test_split_model_surface(params, v):
    rs = rsplit.make_lenet_split(v)
    ts = tsplit.make_split_model("lenet", v)
    spec = ts.smashed_spec(8)
    assert spec.device.type == "meta"
    assert tuple(spec.shape) == rs.smashed_spec(8).shape
    assert ts.n_cuts == rs.n_cuts and ts.masked_loss and ts.kind == "lenet"
    rp, tp = params
    rdev, rsrv = rlenet.split_params(rp, v)
    tdev, tsrv = tlenet.split_params(tp, v)
    x, y = _images(8), _labels(8)
    batch = {"image": x, "label": y}
    rm = rs.eval_metrics(rdev, rsrv, jax.tree.map(jnp.asarray, batch))
    tm = ts.eval_metrics(tdev, tsrv, {k: torch.from_numpy(a)
                                      for k, a in batch.items()})
    assert float(tm["acc"]) == float(rm["acc"])
    assert float(tm["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-6)
    merged, _ = ts.export(tdev, tsrv)
    assert list(merged) == list(tp)
    # sample_weight: masked rows carry zero weight
    w = np.ones((2, 4), np.float32)
    w[1] = 0.0
    sm, _ = ts.device_apply(tdev, {"image": torch.from_numpy(x)})
    rl, _ = rs.server_loss(rsrv, rs.device_apply(rdev, {
        "image": jnp.asarray(x)})[0], {"label": jnp.asarray(y),
                                        "sample_weight": jnp.asarray(w)})
    tl, _ = ts.server_loss(tsrv, sm, {"label": torch.from_numpy(y),
                                      "sample_weight": torch.from_numpy(w)})
    assert float(tl) == pytest.approx(float(rl), rel=1e-6)


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.1, 0.25, 0.5])
def test_topk_exact_k_ties_to_lower_index(ratio):
    """Quantised, zero-heavy deltas: exactly k entries survive, ties broken
    toward the lower index as ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(0)
    x = (rng.integers(-3, 4, size=(6, 7)) * 0.5).astype(np.float32)
    want = np.asarray(rcmp.topk_mask(jnp.asarray(x), ratio))
    got = tcmp.topk_mask(torch.from_numpy(x), ratio).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(got) <= max(int(ratio * x.size), 1)
    k = max(int(ratio * x.size), 1)
    ties = np.ones(20, np.float32)
    got = tcmp.topk_mask(torch.from_numpy(ties), ratio).numpy()
    np.testing.assert_array_equal(np.flatnonzero(got),
                                  np.arange(max(int(ratio * 20), 1)))
    assert k >= 1


def test_int8_rounds_half_to_even():
    """Values that land exactly on half steps round to the even code, as
    ``jnp.round`` does; the dequantised tree is bit-equal."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, -2.5, 0.0],
                 np.float32)
    want = np.asarray(rcmp.compress_int8({"a": jnp.asarray(x)})["a"])
    got = tcmp.compress_int8({"a": torch.from_numpy(x)})["a"].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1:8], [0, 2, 2, 0, -2, 4, -2])


@pytest.mark.parametrize("method", ["topk", "int8"])
def test_error_feedback_matches_reference(method):
    rng = np.random.default_rng(3)
    delta = {"w": rng.normal(size=(5, 8)).astype(np.float32)}
    ef = {"w": rng.normal(size=(5, 8)).astype(np.float32) * 0.1}
    rc, re = rcmp.apply_with_error_feedback(
        jax.tree.map(jnp.asarray, delta), jax.tree.map(jnp.asarray, ef),
        method, 0.2)
    tc, te = tcmp.apply_with_error_feedback(
        params_from_numpy(delta, "cpu"), params_from_numpy(ef, "cpu"),
        method, 0.2)
    np.testing.assert_array_equal(tc["w"].numpy(), np.asarray(rc["w"]))
    np.testing.assert_array_equal(te["w"].numpy(), np.asarray(re["w"]))
    for m in ("none", "topk", "int8"):
        assert tcmp.compression_ratio(m, 0.2) == rcmp.compression_ratio(m,
                                                                        0.2)


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "momentum", "adamw"])
def test_optimizer_steps_match_reference(name):
    rng = np.random.default_rng(4)
    p = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": [rng.normal(size=(5,)).astype(np.float32)]}
    grads = [tree.map(lambda t: rng.normal(size=t.shape).astype(np.float32),
                      p) for _ in range(3)]
    kw = {"momentum": 0.9, "weight_decay": 0.01}
    ro, to = roptim.make(name, 0.05, **kw), toptim.make(name, 0.05, **kw)
    rp, rs = jax.tree.map(jnp.asarray, p), None
    tp = params_from_numpy(p, "cpu")
    rs, ts = ro.init(rp), to.init(tp)
    assert jax.tree_util.tree_structure(jax.device_get(rs)) == \
        jax.tree_util.tree_structure(tree.map(lambda t: t.numpy(), ts))
    for i, g in enumerate(grads):
        rp, rs = ro.step(jax.tree.map(jnp.asarray, g), rs, rp, step=i)
        tp, ts = to.step(params_from_numpy(g, "cpu"), ts, tp,
                         step=torch.tensor(i, dtype=torch.int32))
    for a, b in zip(jax.tree.leaves(rp), tree.leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-7)


def test_lr_scale_is_exact_with_base_lr_one():
    """lr 1.0 scaled by s applies exactly s (``optim/__init__.py:8-14``)."""
    p = {"w": torch.linspace(-1, 1, 7)}
    g = {"w": torch.linspace(0.3, -0.2, 7)}
    a, _ = toptim.sgd(1.0).step(g, (), p, lr_scale=torch.tensor(0.05))
    b, _ = toptim.sgd(0.05).step(g, (), p)
    assert torch.equal(a["w"], b["w"])


def test_schedule_and_clipping_match_reference():
    rf = roptim.cosine_schedule(0.1, 10, 100, floor=0.01)
    tf = toptim.cosine_schedule(0.1, 10, 100, floor=0.01)
    for s in (0, 5, 10, 50, 100, 150):
        assert float(tf(s)) == pytest.approx(float(rf(s)), rel=1e-6)
    g = {"a": np.full((3,), 4.0, np.float32), "b": np.full((4,), 3.0,
                                                            np.float32)}
    rc, rn = roptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 2.0)
    tc, tn = toptim.clip_by_global_norm(params_from_numpy(g, "cpu"), 2.0)
    assert float(tn) == pytest.approx(float(rn), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(rc[k]),
                                   rtol=1e-6)
    assert toptim.make("adamw_mixed", 0.1).name == "adamw_mixed"

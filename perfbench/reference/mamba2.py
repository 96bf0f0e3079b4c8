"""Plain float32 Mamba-2 LM (Dao & Gu, arXiv:2405.21060) and one CPSL
round of it (arXiv:2204.08119, Alg. 1), from the configuration file's
sizes and weights drawn again from the seed.

A layer: x + out_proj(RMSNorm(SSD(conv(in_proj(RMSNorm(x)))) * silu(z))),
with in_proj packed as [z, x, B, C, dt], a causal depthwise conv and
SiLU over [x, B, C], dt = softplus(dt + dt_bias), A = -exp(A_log) and the
skip D x. The SSD is the paper's chunked form (its "minimal" listing):
the masked quadratic form inside a chunk, the states passed between
chunks. Each layer runs under ``torch.utils.checkpoint``, so the backward
holds one layer's intermediates at a time.

A round: for each cluster in turn, the K clients' device-side models
(embedding and the first ``cut`` layers) and the one server-side model
(the other layers, the final norm, an untied head) take one SGD step on
the mean token cross-entropy of the clients' concatenated batches; the
clients' models are then averaged (FedAvg, equal weights) and handed to
the next cluster.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.harness import weights
from perfbench.reference.precision import Precision


def dims(cfg: dict):
    d = cfg["hidden_size"]
    d_inner = cfg["expand"] * d
    p = cfg["head_dim"]
    h = d_inner // p
    g, n = cfg["n_groups"], cfg["state_size"]
    return d, d_inner, h, p, g, n, d_inner + 2 * g * n


def layer_shapes(cfg: dict) -> dict:
    d, d_inner, h, p, g, n, conv_dim = dims(cfg)
    return {"pre_norm/scale": (d,),
            "mamba/in_proj/w": (d, 2 * d_inner + 2 * g * n + h),
            "mamba/conv_w": (cfg["conv_kernel"], conv_dim),
            "mamba/conv_b": (conv_dim,),
            "mamba/dt_bias": (h,), "mamba/A_log": (h,), "mamba/D": (h,),
            "mamba/norm/scale": (d_inner,),
            "mamba/out_proj/w": (d_inner, d)}


def draw_f32(cfg, seed, key, shape, device) -> torch.Tensor:
    pdt = getattr(torch, cfg["param_dtype"])
    return weights.draw(key, shape, pdt, device, seed).float()


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def _segsum(a):
    """(..., T) -> (..., T, T): sum of a over (j, i] below the diagonal,
    -inf above it."""
    t = a.shape[-1]
    x = a[..., :, None].expand(*a.shape, t)
    lower = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device),
                       -1)
    s = torch.cumsum(x.masked_fill(~lower, 0.0), dim=-2)
    keep = torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device))
    return s.masked_fill(~keep, float("-inf"))


def ssd(x, a, bm, cm, chunk: int):
    """x (b, s, h, p) = dt x, a (b, s, h) = dt A, bm and cm (b, s, g, n).
    Returns y (b, s, h, p)."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    r = h // g                        # head h reads group h // r
    q = min(chunk, s)
    while s % q:
        q //= 2
    c = s // q
    x = x.reshape(b, c, q, g, r, p)
    bm, cm = bm.reshape(b, c, q, g, n), cm.reshape(b, c, q, g, n)
    a = a.reshape(b, c, q, g, r).permute(0, 3, 4, 1, 2)      # (b,g,r,c,q)
    a_cum = torch.cumsum(a, dim=-1)
    # inside a chunk: the masked quadratic form
    scores = torch.einsum("bclgn,bcsgn->bgcls", cm, bm)[:, :, None] \
        * torch.exp(_segsum(a))                             # (b,g,r,c,l,s)
    y = torch.einsum("bgrcls,bcsgrp->bclgrp", scores, x)
    # each chunk's state, passed on to the next chunks
    to_end = torch.exp(a_cum[..., -1:] - a_cum).permute(0, 3, 4, 1, 2)
    states = torch.einsum("bclgn,bclgrp->bcgrpn", bm, x * to_end[..., None])
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("bgrzc,bcgrpn->bzgrpn", chunk_decay,
                          states)[:, :-1]
    from_start = torch.exp(a_cum).permute(0, 3, 4, 1, 2)     # (b,c,l,g,r)
    y = y + torch.einsum("bclgn,bcgrpn->bclgrp", cm, states) \
        * from_start[..., None]
    return y.reshape(b, s, h, p)


def block(p: dict, x, cfg: dict, prec: Precision):
    d, d_inner, h, hp, g, n, conv_dim = dims(cfg)
    b, s, _ = x.shape
    eps = cfg["rms_norm_eps"]
    u = prec.mm(rmsnorm(x, p["pre_norm/scale"], eps), p["mamba/in_proj/w"])
    z, xbc, dtr = torch.split(u, [d_inner, conv_dim, h], dim=-1)
    k = cfg["conv_kernel"]
    xbc = F.conv1d(xbc.transpose(1, 2), p["mamba/conv_w"].t()[:, None, :],
                   p["mamba/conv_b"], padding=k - 1,
                   groups=conv_dim)[..., :s].transpose(1, 2)
    xbc = F.silu(xbc)
    xs, bm, cm = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    dt = F.softplus(dtr + p["mamba/dt_bias"])
    a = -torch.exp(p["mamba/A_log"])
    xs = xs.reshape(b, s, h, hp)
    y = ssd(prec.act(xs) * dt[..., None], a * dt,
            prec.act(bm.reshape(b, s, g, n)), prec.act(cm.reshape(b, s, g, n)),
            cfg["chunk_size"])
    y = (y + xs * p["mamba/D"][:, None]).reshape(b, s, d_inner)
    y = rmsnorm(y * F.silu(z), p["mamba/norm/scale"], eps)
    return x + prec.mm(y, p["mamba/out_proj/w"])


def _layer(cfg, prec, keys):
    def run(x, *leaves):
        return block(dict(zip(keys, leaves)), x, cfg, prec)
    return run


def _layers(params: dict, x, cfg, prec, lo: int, hi: int):
    keys = list(layer_shapes(cfg))
    fn = _layer(cfg, prec, keys)
    for layer in range(lo, hi):
        leaves = [params[f"layers/{layer}/{k}"] for k in keys]
        x = checkpoint(fn, x, *leaves, use_reentrant=False)
    return x


def _cross_entropy(x, head, labels, prec, chunk: int = 4096):
    """Mean token cross-entropy from final hiddens, in blocks of rows, each
    checkpointed so that one block's logits are alive at a time."""
    x = x.reshape(-1, x.shape[-1])
    labels = labels.reshape(-1)

    def nll(xc, lc, w):
        return F.cross_entropy(prec.mm(xc, w), lc, reduction="sum")

    total = 0.0
    for i in range(0, x.shape[0], chunk):
        total = total + checkpoint(nll, x[i:i + chunk], labels[i:i + chunk],
                                   head, use_reentrant=False)
    return total / x.shape[0]


def initial_params(cfg: dict, traffic: dict, seed: int, device):
    """(device-side, server-side) parameters as drawn from the seed."""
    d, v = cfg["hidden_size"], traffic["cut"]
    shapes = layer_shapes(cfg)
    dev = {"embed/tok": draw_f32(cfg, seed, "embed/tok",
                                 (cfg["vocab_size"], d), device)}
    srv = {"final_norm/scale": draw_f32(cfg, seed, "final_norm/scale", (d,),
                                        device),
           "head": draw_f32(cfg, seed, "head", (d, cfg["vocab_size"]),
                            device)}
    for layer in range(cfg["num_hidden_layers"]):
        side = dev if layer < v else srv
        for k, shp in shapes.items():
            key = f"layers/{layer}/{k}"
            side[key] = draw_f32(cfg, seed, key, shp, device)
    return dev, srv


def _loss_and_grads(devs, srv, tokens, labels, cfg, traffic, prec):
    v, n_layers = traffic["cut"], cfg["num_hidden_layers"]
    leaves = [t for p in devs for t in p.values()] + list(srv.values())
    for t in leaves:
        t.requires_grad_(True)
    with torch.enable_grad():
        smashed = []
        for k, p in enumerate(devs):
            x = p["embed/tok"][tokens[k]]
            smashed.append(_layers(p, x, cfg, prec, 0, v))
        x = torch.cat(smashed, dim=0)
        x = _layers(srv, x, cfg, prec, v, n_layers)
        x = rmsnorm(x, srv["final_norm/scale"], cfg["rms_norm_eps"])
        loss = _cross_entropy(x, srv["head"], labels, prec)
        grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    it = iter(grads)
    g_devs = [{k: next(it) for k in p} for p in devs]
    g_srv = {k: next(it) for k in srv}
    return float(loss.detach()), g_devs, g_srv


def train_round(cfg: dict, traffic: dict, seed: int, clusters, tokens,
                labels, device, prec: Precision, batch_rows=None) -> dict:
    """One CPSL round from the seed's weights. ``tokens``/``labels``: (N,
    B, S) per device; ``clusters``: the round's plan, M lists of K device
    ids. ``batch_rows`` keeps only those rows of each device's batch (a
    planted fault). Returns each step's loss, each leaf's gradient norm in
    the first step (``grad``) and each leaf's change over the round
    (``change``), leaves named as the benchmark names the program's:
    ``dev/<client>/<key>`` and ``srv/<key>``."""
    dev0, srv = initial_params(cfg, traffic, seed, device)
    K = len(clusters[0])
    devs = [dict(dev0) if k == 0 else {n: t.clone() for n, t in dev0.items()}
            for k in range(K)]
    out = {"losses": [], "grad": {}, "change": {}}
    for m, members in enumerate(clusters):
        idx = torch.as_tensor(members, device=tokens.device)
        tok, lab = tokens[idx], labels[idx]
        if batch_rows is not None:
            tok, lab = tok[:, batch_rows], lab[:, batch_rows]
        loss, g_devs, g_srv = _loss_and_grads(devs, srv, tok, lab, cfg,
                                              traffic, prec)
        out["losses"].append(loss)
        if m == 0:
            for k, g in enumerate(g_devs):
                out["grad"].update({f"dev/{k}/{n}": float(t.norm())
                                    for n, t in g.items()})
            out["grad"].update({f"srv/{n}": float(t.norm())
                                for n, t in g_srv.items()})
        with torch.no_grad():
            for p, g in zip(devs, g_devs):
                for n in p:
                    p[n] -= traffic["lr_device"] * g[n]
            for n in srv:
                srv[n] -= traffic["lr_server"] * g_srv[n]
            for n in devs[0]:
                mean = sum(p[n] for p in devs) / K
                for p in devs:
                    p[n] = mean.clone()
        del g_devs, g_srv
    with torch.no_grad():
        ref_dev, ref_srv = initial_params(cfg, traffic, seed, device)
        for k, p in enumerate(devs):
            out["change"].update({f"dev/{k}/{n}":
                                  float((t - ref_dev[n]).norm())
                                  for n, t in p.items()})
        out["change"].update({f"srv/{n}": float((t - ref_srv[n]).norm())
                              for n, t in srv.items()})
    return out

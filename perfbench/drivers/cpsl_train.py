"""Closed-loop CPSL training rounds of a split LM (``traffic:
cpsl-train``): the paper's round at LM scale.

A round is the program's plan (``core.resource.gibbs_clustering``, Alg.
4, over a network draw made here from the seed) and then
``core.cpsl.CPSL.run_round`` over the plan's clusters, which ends in its
host sync. Every device's batch of every round is Markov tokens sampled
before the window; ``batch_fn`` hands a cluster its devices' rows.

Set-up draws the state on the card from the seed (the tree's shapes read
from the program on ``meta``), runs the first round through the same
plan and ``run_round`` call (this warms up every shape), and reads on
the way the check's numbers: each step's loss, each leaf's first
gradient (its change in the first step over the learning rate) and each
leaf's change over the round. The window then runs whole rounds until
``--seconds`` have passed. After it, the state is freed and the
reference plans the rounds again and trains the first round in float32.
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import math
import statistics
import time

import numpy as np
import torch

from perfbench.harness import markov, weights, work
from perfbench.harness.trace import Session
from perfbench.reference import compare, planner
from perfbench.reference import mamba2 as ref_model
from perfbench.reference.precision import Precision


def port_config(cfg: dict):
    """The program's ModelConfig as the configuration file states it."""
    from repro_torch.configs import registry
    base = registry.get(cfg["port_arch"])
    ssm = dataclasses.replace(
        base.ssm, d_state=cfg["state_size"], headdim=cfg["head_dim"],
        expand=cfg["expand"], ngroups=cfg["n_groups"],
        d_conv=cfg["conv_kernel"], chunk_size=cfg["chunk_size"])
    return base.replace(
        d_model=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        vocab_size=cfg["vocab_size"], norm_eps=cfg["rms_norm_eps"], ssm=ssm,
        dtype=cfg["dtype"], param_dtype=cfg["param_dtype"],
        remat=cfg["remat"], loss_chunk=cfg["loss_chunk"],
        ssd_impl=cfg["ssd_impl"])


def _int_seed(seed: int, *parts) -> int:
    text = ":".join(str(p) for p in (seed,) + parts)
    return int.from_bytes(hashlib.blake2b(text.encode(), digest_size=4)
                          .digest(), "little")


def _rng(seed: int, *parts):
    return np.random.default_rng([int(seed), *parts])


class Network:
    """Device compute means and channel means drawn from the seed, and
    one draw of compute and per-subcarrier rate a round (the program's
    channel model, eq. 14, with the benchmark's own streams)."""

    def __init__(self, net: dict, seed: int):
        self.net, self.seed = net, seed
        rng = _rng(seed, 3)
        n = net["n_devices"]
        self.mu_f = rng.uniform(*net["f_mean_range"], n)
        self.mu_snr = rng.uniform(*net["snr_mean_range_db"], n)

    def draw(self, rnd: int):
        rng = _rng(self.seed, 4, rnd)
        f = np.maximum(rng.normal(self.mu_f, self.net["f_sigma"]), 1e7)
        snr_db = rng.normal(self.mu_snr, self.net["snr_sigma_db"])
        rate = self.net["subcarrier_bw"] * np.log2(1.0 + 10.0 ** (snr_db
                                                                   / 10.0))
        return f, rate


def _batches(run, rounds):
    """(tokens, labels) of rounds ``rounds``: (R, N, B, S) int64 on the
    card, each round sampled from its own stream."""
    t = run.traffic
    n, b, s = t["network"]["n_devices"], t["batch_per_device"], t["seq"]
    toks = np.stack([run.markov.sample(n * b, s, _rng(run.seed, 2, r))
                     .reshape(n, b, s + 1) for r in rounds])
    toks = torch.from_numpy(toks).to(run.device)
    return toks[..., :-1], toks[..., 1:]


def _leaves(state, v: int):
    """(leaf, lead, key_of) of every parameter leaf of the program's state
    (``weights.fill``'s terms): the clients' K-stacked device side, the
    server side's layers (period-stacked) and head."""
    from repro_torch import tree
    n_pro = len(state["srv"]["prologue"])
    period = len(state["srv"]["stack"])
    for path, leaf in tree.flatten_with_path(state):
        rest = "/".join(str(p) for p in path[3:])
        if path[0] == "dev":
            key = ("embed/tok" if path[1] == "embed"
                   else f"layers/{path[2]}/{rest}")
            yield leaf, "clients", lambda _, k=key: k
        elif path[0] != "srv":
            continue
        elif path[1] in ("head", "final_norm"):
            key = "/".join(str(p) for p in path[1:])
            yield leaf, "", lambda _, k=key: k
        elif path[1] == "prologue":
            yield leaf, "", lambda _, k=f"layers/{v + path[2]}/{rest}": k
        else:
            yield leaf, "layers", lambda i, q=path[2], r=rest: \
                f"layers/{v + n_pro + i * period + q}/{r}"


def _change_norms(run, state, scale: float = 1.0) -> dict:
    """Each slice's ||p - p0|| / scale, p0 drawn again from the seed; the
    slices named as the reference names its leaves (``dev/<client>/<key>``,
    ``srv/<key>``)."""
    out = {}
    with torch.no_grad():
        for leaf, lead, key_of in _leaves(state, run.traffic["cut"]):
            rows = range(leaf.shape[0]) if lead else [None]
            for i in rows:
                p = leaf if i is None else leaf[i]
                key = key_of(i)
                name = f"dev/{i}/{key}" if lead == "clients" else f"srv/{key}"
                p0 = weights.draw(key, p.shape, p.dtype, p.device, run.seed)
                out[name] = (p.float() - p0.float()).norm() / scale
    return {k: float(v) for k, v in out.items()}


def _build_state(run, cp):
    """The program's state (its tree read on ``meta``), every parameter
    drawn from the seed, the step counter and rng words zero."""
    from repro_torch import streams, tree
    meta = cp.init_state(streams.meta_generator())
    filled = {id(leaf): weights.fill(leaf, key_of, run.device, run.seed,
                                     lead)
              for leaf, lead, key_of in _leaves(meta, run.traffic["cut"])}
    return tree.map(lambda t: filled.get(id(t)) if id(t) in filled else
                    torch.zeros(tuple(t.shape), dtype=t.dtype)
                    .to(run.device), meta)


def prepare(run):
    from repro_torch.configs.base import CPSLConfig
    from repro_torch.core.channel import NetworkCfg
    from repro_torch.core.cpsl import CPSL
    from repro_torch.core.profile import lm_profile
    from repro_torch.core.splitting import make_split_model
    t, cfg = run.traffic, run.cfg
    run.pcfg = port_config(cfg)
    v, M, K = t["cut"], t["n_clusters"], t["cluster_size"]
    run.cp = CPSL(make_split_model(run.pcfg, v), CPSLConfig(
        cut_layer=v, n_clusters=M, cluster_size=K,
        local_epochs=t["local_epochs"], lr_device=t["lr_device"],
        lr_server=t["lr_server"], batch_per_device=t["batch_per_device"],
        optimizer=t["optimizer"]))
    net = t["network"]
    run.ncfg = NetworkCfg(
        n_devices=net["n_devices"], subcarrier_bw=net["subcarrier_bw"],
        n_subcarriers=net["n_subcarriers"], f_server=net["f_server"],
        kappa=net["kappa"])
    run.prof = lm_profile(run.pcfg, t["seq"])
    run.network = Network(net, run.seed)
    run.markov = markov.MarkovLM(cfg["vocab_size"], t["markov_eff_vocab"],
                                 _rng(run.seed, 1))
    run.plans = []
    run.state = _build_state(run, run.cp)
    run.srv_layout = (len(run.state["srv"]["prologue"]),
                      len(run.state["srv"]["stack"]))
    run.tokens, run.labels = _batches(run, [0])

    # the first round, through the window's own plan and call, with the
    # check's readings taken around its steps
    losses, first = [], {}
    step = run.cp.cluster_step

    def recording(state, batch, lr_scale=None):
        state, mt = step(state, batch, lr_scale=lr_scale)
        losses.append(mt["loss"].detach().clone())
        if not first:
            first.update(_change_norms(run, state, t["lr_device"]))
            lr_s = t["lr_server"] / t["lr_device"]
            for k in first:
                if k.startswith("srv/"):
                    first[k] /= lr_s
        return state, mt

    run.cp.cluster_step = recording
    t0 = time.perf_counter()
    _round(run, 0)
    t_round = time.perf_counter() - t0
    del run.cp.cluster_step
    run.first_losses = [float(x) for x in losses]
    run.first_grad = first
    run.first_change = _change_norms(run, run.state)
    # the window's batches: more rounds than it can hold
    run.pool = max(2, math.ceil(2.0 * run.seconds / max(t_round, 1e-3)) + 2)
    tok, lab = _batches(run, range(1, run.pool + 1))
    run.first_tokens, run.first_labels = run.tokens[0], run.labels[0]
    run.tokens = torch.cat([run.tokens, tok])
    run.labels = torch.cat([run.labels, lab])
    if run.device.type == "cuda":
        torch.cuda.synchronize()


def _plan(run, rnd: int):
    from repro_torch.core import resource as rs
    from repro_torch.core.channel import NetworkState
    t = run.traffic
    f, rate = run.network.draw(rnd)
    clusters, xs, lat = rs.gibbs_clustering(
        t["cut"], NetworkState(f=f, rate=rate), run.ncfg, run.prof,
        t["batch_per_device"], t["local_epochs"], t["n_clusters"],
        t["cluster_size"], iters=t["gibbs_iters"], delta=t["gibbs_delta"],
        seed=_int_seed(run.seed, "gibbs", rnd))
    return ([[int(d) for d in c] for c in clusters],
            [[int(a) for a in np.asarray(x)] for x in xs], float(lat))


def _round(run, rnd: int):
    """One round of the window: the plan, then ``run_round`` handed the
    only reference to the state (a reference kept here would hold one
    more copy of the parameters while it runs)."""
    t0 = time.perf_counter()
    clusters, xs, lat = _plan(run, rnd)
    run.rec.span("plan", time.perf_counter() - t0)
    run.plans.append((rnd, clusters, xs))
    tok, lab = run.tokens[rnd], run.labels[rnd]
    idx = [torch.as_tensor(c, device=run.device) for c in clusters]

    def batch_fn(m, l):  # noqa: E741
        return {"tokens": tok.index_select(0, idx[m]),
                "labels": lab.index_select(0, idx[m])}

    held = [run.__dict__.pop("state")]
    run.state, _ = run.cp.run_round(held.pop(), batch_fn)


def window(run):
    t = run.traffic
    rounds, t0 = 0, time.perf_counter()
    while rounds < run.pool:
        session = Session("round").start() if run.trace else None
        run.rec.phase = "round"
        t1 = time.perf_counter()
        _round(run, rounds + 1)
        run.rec.span("round", time.perf_counter() - t1)
        if session is not None:
            run.rec.sessions.append(session.stop())
        rounds += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    window_s = time.perf_counter() - t0
    run.rec.phase = ""
    run.rec.span("window", window_s)
    run.rec.count("rounds", rounds)
    run.rec.counters["model_flops_round"] = work.model_flops(
        run.cfg, "train", t["n_clusters"] * t["cluster_size"]
        * t["batch_per_device"], t["seq"])
    run.rec.counters["chunk"] = run.cfg["chunk_size"]
    run.attempted = rounds
    return {"round_s": window_s / rounds}


def reference_plans(run) -> list:
    t = run.traffic
    prof = planner.mamba_profile(run.cfg, t["seq"])
    out = []
    for rnd, _, _ in run.plans:
        f, rate = run.network.draw(rnd)
        clusters, xs, _ = planner.gibbs_clustering(
            t["cut"], f, rate, t["network"], prof, t["batch_per_device"],
            t["local_epochs"], t["n_clusters"], t["cluster_size"],
            t["gibbs_iters"], t["gibbs_delta"],
            _int_seed(run.seed, "gibbs", rnd))
        out.append((rnd, clusters, xs))
    return out


def free_program(run):
    for name in ("state", "cp", "tokens", "labels"):
        if hasattr(run, name):
            delattr(run, name)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_round(run, precision: str = "float32", batch_rows=None):
    plan0 = next(p for p in reference_plans(run) if p[0] == 0)
    return ref_model.train_round(run.cfg, run.traffic, run.seed, plan0[1],
                                 run.first_tokens, run.first_labels,
                                 run.device, Precision(precision),
                                 batch_rows=batch_rows)


def leaf_of(run):
    """The program's state leaf a slice name belongs to: a client-stacked
    device leaf, a server prologue layer, or a period-stacked server
    leaf."""
    n_pro, period = run.srv_layout
    first = run.traffic["cut"] + n_pro

    def leaf(name: str) -> str:
        side, rest = name.split("/", 1)
        if side == "dev":
            return "dev/" + rest.split("/", 1)[1]
        parts = rest.split("/")
        if parts[0] == "layers" and int(parts[1]) >= first:
            pos = (int(parts[1]) - first) % period
            return f"srv/stack/{pos}/" + "/".join(parts[2:])
        return name
    return leaf


def readings(run, program: dict, ref: dict, detail: bool = False) -> dict:
    """The numbers compared: the steps' losses, the first gradient and the
    round's change, each by its worst leaf of the state tree."""
    leaf = leaf_of(run)
    grads = [compare.leaf_norms(x["grad"], leaf) for x in (program, ref)]
    changes = [compare.leaf_norms(x["change"], leaf) for x in (program, ref)]
    keep = compare.moving_leaves(grads[1])
    out = {"loss_gap": compare.loss_gap(program["losses"], ref["losses"]),
           "grad_gap": compare.worst_leaf(*grads, keep),
           "change_gap": compare.worst_leaf(*changes, keep)}
    if detail:
        for name, pair in (("grad", grads), ("change", changes)):
            gaps = compare.leaf_gaps(*pair, keep)
            out[f"{name}_worst"] = sorted(gaps.items(),
                                          key=lambda kv: -kv[1])[:4]
            out[f"{name}_median"] = statistics.median(gaps.values())
        out["left_out"] = sorted(set(grads[1]) - keep)
    return out


def verify(run):
    limits = run.traffic["limits"]
    plans = reference_plans(run)
    mismatch = sum(a != b for a, b in zip(plans, run.plans)) + abs(
        len(plans) - len(run.plans))
    free_program(run)
    run.reference = reference_round(run)
    program = {"losses": run.first_losses, "grad": run.first_grad,
               "change": run.first_change}
    got = readings(run, program, run.reference)
    return [("plan_mismatch", float(mismatch), 0.0)] + [
        (name, got[name], limits[name]) for name in
        ("loss_gap", "grad_gap", "change_gap")]

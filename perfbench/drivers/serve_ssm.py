"""One client, a closed loop of ``ServeEngine.generate`` calls (``traffic:
serve``) of a model with Mamba-2 layers: the attention-free Mamba-2 LM
(``model_type`` mamba2) or the Granite 4.0-H hybrid (granitemoehybrid:
Mamba-2 and NoPE GQA layers, a MoE with a shared MLP in every layer, the
muP multipliers).

Each call is ``batch`` requests of a ``prompt``-token prompt drawn from
the seed and ``new_tokens`` greedy tokens. Set-up, the window and the
check are ``drivers/serve.py``'s: weights drawn on the card from the seed
(the tree's shapes read from the program on ``meta``), one short warm-up
call of the same shapes, each call timed to each token (the sampler
waits for the card after each token), the inter-token tail over blocks
of ``itl_block_steps`` decode steps, the ``prefill`` and ``decode`` trace
sessions with ``--trace 1``.

The check reads the window's last call: requests drawn from the seed
among its rows are run through the float32 reference of the file's
``model_type`` over their prompt and served tokens. Two numbers are
compared. ``mean_token_gap``, as ``drivers/serve.py`` has it: the mean
gap of the served tokens' reference logits below the reference's best.
``logit_gap``: the logits the timed path sampled each token from (kept by
reference, no device work in the window) against the reference's at the
same position, the widest gap over the vocabulary in units of the
reference's standard deviation there, averaged over the positions. The
seeded models' logits are near flat (granite's std is 0.0067), so a fault
that moves every logit (a decode step that leaves its SSM state
unwritten, a rotary embedding on NoPE attention) can flip no more tokens
than bf16 does; the logits see it.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.drivers import cpsl_train, serve
from perfbench.harness import hybrid_work
from perfbench.harness.bench import log
from perfbench.harness.trace import Session
from perfbench.reference import compare, granite, mamba2_serve
from perfbench.reference.precision import Precision

REFERENCES = {"mamba2": mamba2_serve, "granitemoehybrid": granite}

# what a granitemoehybrid file may state for the program to run it as it
# is: the program's Mamba-2 layer has a conv bias and no projection bias,
# its GQA no bias, and its MLPs SwiGLU
_GRANITE_FIXED = {"mamba_conv_bias": True, "mamba_proj_bias": False,
                  "attention_bias": False, "hidden_act": "silu",
                  "normalization_function": "rmsnorm"}


def _period(types: list) -> int:
    """The shortest period of ``types`` that divides its length."""
    n = len(types)
    return next(p for p in range(1, n + 1)
                if n % p == 0 and types == types[:p] * (n // p))


def _granite_config(cfg: dict):
    from repro_torch.configs import registry
    from repro_torch.configs.base import LayerSpec, MoECfg, MuPCfg, SSMCfg
    for key, want in _GRANITE_FIXED.items():
        if cfg[key] != want:
            raise ValueError(f"{key} = {cfg[key]!r}: the program runs "
                             f"{want!r}")
    n = cfg["num_hidden_layers"]
    types = cfg["layer_types"][:n]
    ffn = "moe" if cfg["num_local_experts"] else "dense"
    pattern = tuple(LayerSpec("attn" if t == "attention" else "mamba", ffn)
                    for t in types[:_period(types)])
    heads = cfg["num_attention_heads"]
    d_inner = cfg["mamba_expand"] * cfg["hidden_size"]
    if cfg["mamba_n_heads"] * cfg["mamba_d_head"] != d_inner:
        raise ValueError("mamba_n_heads x mamba_d_head != d_inner")
    shared = cfg["shared_intermediate_size"]
    return registry.get(cfg["port_arch"]).replace(
        d_model=cfg["hidden_size"], n_layers=n, n_heads=heads,
        n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["hidden_size"] // heads, vocab_size=cfg["vocab_size"],
        prologue=(), pattern=pattern,
        rope=cfg["position_embedding_type"] != "nope",
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        moe=MoECfg(n_experts=cfg["num_local_experts"],
                   top_k=cfg["num_experts_per_tok"],
                   d_ff_expert=cfg["intermediate_size"],
                   n_shared_experts=1 if shared else 0, d_ff_shared=shared,
                   group_size=cfg["moe_group_size"],
                   capacity_factor=cfg["moe_capacity_factor"]),
        ssm=SSMCfg(d_state=cfg["mamba_d_state"], d_conv=cfg["mamba_d_conv"],
                   expand=cfg["mamba_expand"], headdim=cfg["mamba_d_head"],
                   ngroups=cfg["mamba_n_groups"],
                   chunk_size=cfg["mamba_chunk_size"]),
        mup=MuPCfg(embedding_multiplier=float(cfg["embedding_multiplier"]),
                   residual_multiplier=float(cfg["residual_multiplier"]),
                   attention_multiplier=float(cfg["attention_multiplier"]),
                   logits_scaling=float(cfg["logits_scaling"])),
        dtype=cfg["dtype"], param_dtype=cfg["param_dtype"],
        attn_impl=cfg["attn_impl"], ssd_impl=cfg["ssd_impl"])


def port_config(cfg: dict):
    """The program's ModelConfig as the configuration file states it."""
    if cfg["model_type"] == "mamba2":
        return cpsl_train.port_config(cfg)
    if cfg["model_type"] == "granitemoehybrid":
        return _granite_config(cfg)
    raise ValueError(f"model_type {cfg['model_type']!r}")


def params(run, pcfg):
    """The program's parameters as ``drivers/serve.py`` draws them, then the
    weights its reference scales (``scales``; granite's token table,
    ``reference.granite.token_table``) as the reference has them."""
    from repro_torch import tree as tr
    tree = serve._params(run, pcfg)
    ref = REFERENCES[run.cfg["model_type"]]
    mult = ref.scales(run.cfg)
    for path, leaf in tr.flatten_with_path(tree):
        name = "/".join(str(p) for p in path[2:])
        if path[0] in ("stack", "prologue") and name in mult:
            leaf.copy_(mamba2_serve.scaled(leaf, mult[name]))
    if run.cfg["model_type"] == "granitemoehybrid":
        tree["embed"]["tok"].copy_(
            granite.token_table(run.cfg, run.seed, run.device))
    return tree


def prepare(run):
    from repro_torch.serving.engine import ServeEngine
    t = run.traffic
    t0 = time.perf_counter()
    pcfg = port_config(run.cfg)
    run.eng = ServeEngine(pcfg, params(run, pcfg),
                          cap=t["prompt"] + t["new_tokens"],
                          device=run.device)
    serve._sync(run)
    draw_s = time.perf_counter() - t0
    run.marks, run.hook, run.logits = [], None, []
    sample = run.eng._sample

    def timed(logits, temperature, generator):
        tok = sample(logits, temperature, generator)
        serve._sync(run)
        run.marks.append(time.perf_counter())
        run.logits.append(logits)
        if run.hook is not None:
            run.hook(len(run.marks))
        return tok

    run.eng._sample = timed
    t0 = time.perf_counter()
    run.eng.generate({"tokens": serve._prompts(run, "warm-up")}, steps=3)
    warm_s = time.perf_counter() - t0
    log(f"set-up: weights drawn {draw_s:.3f} s, warm-up call {warm_s:.3f} s")
    run.logits = []
    # the window's prompts: more calls than it can hold (a call of the
    # window makes more steps than the warm-up's)
    run.pool = int(run.seconds / warm_s) + 2
    run.prompts = [serve._prompts(run, f"prompt/{c}")
                   for c in range(run.pool)]
    serve._sync(run)


def window(run):
    t = run.traffic
    outs, ttft, blocks, itl = [], [], [], []
    t0 = time.perf_counter()
    for c in range(run.pool):
        run.marks.clear()
        run.logits = []
        if run.trace:
            sessions = {"prefill": Session("prefill").start()}

            def hook(n, s=sessions):
                if n == 1:
                    run.rec.sessions.append(s["prefill"].stop())
                    s["decode"] = Session("decode").start()
                    run.rec.phase = "decode"
            run.hook = hook
            run.rec.phase = "prefill"
        t1 = time.perf_counter()
        out = run.eng.generate({"tokens": run.prompts[c]},
                               steps=t["new_tokens"])
        if run.trace:
            run.rec.sessions.append(sessions["decode"].stop())
            run.rec.count("decode_steps", t["new_tokens"] - 1)
            run.hook, run.rec.phase = None, ""
        ttft.append(run.marks[0] - t1)
        blocks += serve.step_blocks(run.marks, t["itl_block_steps"])
        itl.append((run.marks[-1] - run.marks[0]) / (len(run.marks) - 1))
        run.rec.span("ttft", run.marks[0] - t1)
        outs.append(out)
        if time.perf_counter() - t0 >= run.seconds and \
                len(outs) >= run.min_calls:
            break
    run.outs = outs
    ms = sorted(1e3 * b for b in blocks)
    log(f"calls: ttft_ms {[round(1e3 * x, 2) for x in ttft]}, mean itl_ms "
        f"{[round(1e3 * x, 2) for x in itl]}; {len(ms)} blocks of "
        f"{t['itl_block_steps']} steps, ms: min {ms[0]:.2f}, median "
        f"{ms[len(ms) // 2]:.2f}, max {ms[-1]:.2f}")
    run.attempted = len(outs) * t["batch"]
    run.rec.counters["model_flops_prefill"] = hybrid_work.model_flops(
        run.cfg, t["batch"], t["prompt"])
    return {"ttft_ms": 1e3 * sum(ttft) / len(ttft),
            "itl_ms_p95": float(np.percentile(ms, 95))}


free_program = serve.free_program
gap_stats = serve.gap_stats


def sample(run):
    """The requests the check reads, rows of the window's last call drawn
    from the seed: their sequences (prompt and served tokens but the
    last), their served tokens and the logits each was sampled from,
    (R, new_tokens, V) float32."""
    t = run.traffic
    rows = np.random.default_rng([run.seed, 5]).choice(
        t["batch"], size=min(t["sample_requests"], t["batch"]),
        replace=False)
    rows = torch.tensor(sorted(int(i) for i in rows))
    served = run.outs[-1][rows.to(run.outs[-1].device)].long()
    prompts = run.prompts[len(run.outs) - 1][rows.to(run.device)]
    seqs = torch.cat([prompts, served[:, :-1].to(prompts.device)], dim=1)
    logits = torch.stack([x[rows.to(x.device)].float() for x in run.logits],
                         dim=1)
    return seqs, served, logits


def logit_gaps(served, ref):
    """served, ref (R, T, V): at each position the root mean square of the
    served logits less the reference's, over the reference's standard
    deviation there, (R, T)."""
    d = served.to(ref.device) - ref
    return d.pow(2).mean(-1).sqrt() / ref.std(-1)


def reference_logits(run, seqs, precision="float32"):
    t = run.traffic
    p = t["prompt"]
    ref = REFERENCES[run.cfg["model_type"]]
    return ref.logits(run.cfg, run.seed, seqs, p, p - 1, run.device,
                      Precision(precision), t["batch"])


def verify(run):
    seqs, served, logits = sample(run)
    run.seqs, run.served = seqs, served
    run.logits = []
    free_program(run)
    run.reference = reference_logits(run, seqs)
    got = gap_stats(compare.token_gaps(run.reference, served))
    gaps = logit_gaps(logits, run.reference)
    got.update(logit_gap=float(gaps.median()),
               widest_logit_gap=float(gaps.max()))
    del logits
    run.readings = got
    log(f"served tokens: {got}")
    return [("mean_token_gap", got["mean_token_gap"],
             run.traffic["limits"]["mean_token_gap"]),
            ("logit_gap", got["logit_gap"],
             run.traffic["logit_limits"]["logit_gap"])]

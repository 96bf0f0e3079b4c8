"""One client, a closed loop of ``ServeEngine.generate`` calls (``traffic:
serve``): each call ``batch`` requests of a ``prompt``-token prompt drawn
from the seed and ``new_tokens`` greedy tokens.

Set-up draws the weights on the card from the seed (the tree's shapes
read from the program on ``meta``) and warms up with one short call of
the same shapes. In the window each call is timed from its start to each
token (the engine's sampler is wrapped: it waits for the card after each
token, as a server streaming tokens does): a request's time to first
token, and the gaps between a call's tokens. The inter-token tail is
read over blocks of ``itl_block_steps`` consecutive decode steps, each
block's mean step, so that each time read from the host clock spans a
quarter of a second or more. With ``--trace 1`` each call's prefill (to
the first token) and decode (to the last) are traced as separate
sessions.

After the window, a sample of the finished requests drawn from the seed
(every request has the same length) is run through the float32
reference over its prompt and served tokens. Each served token's gap,
the reference's best logit at its position less the token's, is taken,
and their mean is compared: the widest gap swings with bf16's MoE route
flips as far as fp8's does (both are logged).
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from perfbench.harness import weights, work
from perfbench.harness.bench import log
from perfbench.harness.trace import Session
from perfbench.reference import compare
from perfbench.reference import deepseek as ref_model
from perfbench.reference.precision import Precision


def port_config(cfg: dict):
    """The program's ModelConfig as the configuration file states it."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import LayerSpec, MLACfg
    base = registry.get(cfg["port_arch"])
    mla = MLACfg(kv_lora_rank=cfg["kv_lora_rank"],
                 q_lora_rank=cfg["q_lora_rank"] or 0,
                 qk_nope_head_dim=cfg["qk_nope_head_dim"],
                 qk_rope_head_dim=cfg["qk_rope_head_dim"],
                 v_head_dim=cfg["v_head_dim"])
    moe = dataclasses.replace(
        base.moe, n_experts=cfg["n_routed_experts"],
        top_k=cfg["num_experts_per_tok"],
        d_ff_expert=cfg["moe_intermediate_size"],
        n_shared_experts=cfg["n_shared_experts"],
        group_size=cfg["moe_group_size"],
        capacity_factor=cfg["moe_capacity_factor"])
    dense = cfg["first_k_dense_replace"]
    return base.replace(
        d_model=cfg["hidden_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        prologue=(LayerSpec("attn", "dense"),) * dense,
        pattern=(LayerSpec("attn", "moe"),), attn_kind="mla", mla=mla,
        moe=moe, rope_theta=float(cfg["rope_theta"]),
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["dtype"],
        param_dtype=cfg["param_dtype"], attn_impl=cfg["attn_impl"])


def _params(run, pcfg):
    from repro_torch import streams, tree
    from repro_torch.models import transformer as tfm
    meta = tfm.init(streams.meta_generator(), pcfg)
    n_pro, period = len(pcfg.prologue), len(pcfg.pattern)
    leaves = []
    for path, leaf in tree.flatten_with_path(meta):
        rest = "/".join(str(p) for p in path[2:])
        if path[0] == "embed":
            key = "embed/tok" if path[1] == "tok" else "head"
            leaves.append(weights.fill(leaf, lambda _, k=key: k, run.device,
                                       run.seed))
        elif path[0] == "final_norm":
            leaves.append(weights.fill(leaf, lambda _: "final_norm/scale",
                                       run.device, run.seed))
        elif path[0] == "prologue":
            leaves.append(weights.fill(
                leaf, lambda _, k=f"layers/{path[1]}/{rest}": k, run.device,
                run.seed))
        else:
            leaves.append(weights.fill(
                leaf, lambda i, q=path[1], r=rest:
                f"layers/{n_pro + i * period + q}/{r}", run.device, run.seed,
                "layers"))
    return tree.unflatten_like(meta, leaves)


def _prompts(run, key: str):
    t = run.traffic
    gen = torch.Generator(device=run.device)
    gen.manual_seed(weights.leaf_seed(run.seed, key))
    return torch.randint(0, run.cfg["vocab_size"], (t["batch"], t["prompt"]),
                         generator=gen, device=run.device)


def _sync(run):
    if run.device.type == "cuda":
        torch.cuda.synchronize()


def prepare(run):
    from repro_torch.serving.engine import ServeEngine
    t = run.traffic
    pcfg = port_config(run.cfg)
    run.eng = ServeEngine(pcfg, _params(run, pcfg),
                          cap=t["prompt"] + t["new_tokens"],
                          device=run.device)
    run.marks, run.hook = [], None
    sample = run.eng._sample

    def timed(logits, temperature, generator):
        tok = sample(logits, temperature, generator)
        _sync(run)
        run.marks.append(time.perf_counter())
        if run.hook is not None:
            run.hook(len(run.marks))
        return tok

    run.eng._sample = timed
    t0 = time.perf_counter()
    run.eng.generate({"tokens": _prompts(run, "warm-up")}, steps=3)
    warm_s = time.perf_counter() - t0
    # the window's prompts: more calls than it can hold (a call of the
    # window makes more steps than the warm-up's)
    run.pool = int(run.seconds / warm_s) + 2
    run.prompts = [_prompts(run, f"prompt/{c}") for c in range(run.pool)]
    _sync(run)


def step_blocks(marks, block: int) -> list:
    """Each whole block of ``block`` consecutive decode steps of one call
    (``marks``: the host time of each token), its mean step in seconds."""
    n = (len(marks) - 1) // block
    return [(marks[(i + 1) * block] - marks[i * block]) / block
            for i in range(n)]


def window(run):
    t = run.traffic
    outs, ttft, blocks, itl = [], [], [], []
    t0 = time.perf_counter()
    for c in range(run.pool):
        run.marks.clear()
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
        blocks += step_blocks(run.marks, t["itl_block_steps"])
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
    run.rec.counters["model_flops_prefill"] = work.model_flops(
        run.cfg, "prefill", t["batch"], t["prompt"])
    return {"ttft_ms": 1e3 * sum(ttft) / len(ttft),
            "itl_ms_p95": float(np.percentile(ms, 95))}


def sample(run):
    """(calls, rows) of the requests the check reads, drawn from the seed;
    and their sequences: prompt and served tokens but the last."""
    t = run.traffic
    n = len(run.outs) * t["batch"]
    pick = np.random.default_rng([run.seed, 5]).choice(
        n, size=min(t["sample_requests"], n), replace=False)
    pick = sorted(int(i) for i in pick)
    served = torch.stack([run.outs[i // t["batch"]][i % t["batch"]]
                          for i in pick]).long()
    prompts = torch.stack([run.prompts[i // t["batch"]][i % t["batch"]]
                           for i in pick])
    seqs = torch.cat([prompts, served[:, :-1]], dim=1)
    return seqs, served


def reference_logits(run, seqs, precision="float32"):
    t = run.traffic
    p = t["prompt"]
    return ref_model.logits(run.cfg, run.seed, seqs, p, p - 1, run.device,
                            Precision(precision), t["batch"])


def free_program(run):
    for name in ("eng", "prompts"):
        if hasattr(run, name):
            delattr(run, name)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def gap_stats(gaps) -> dict:
    return {"mean_token_gap": float(gaps.mean()),
            "widest_token_gap": float(gaps.max()),
            "tokens_off": float((gaps > 0).float().mean())}


def verify(run):
    seqs, served = sample(run)
    run.seqs, run.served = seqs, served
    free_program(run)
    run.reference = reference_logits(run, seqs)
    got = gap_stats(compare.token_gaps(run.reference, served))
    run.readings = got
    log(f"served tokens: {got}")
    return [("mean_token_gap", got["mean_token_gap"],
             run.traffic["limits"]["mean_token_gap"])]

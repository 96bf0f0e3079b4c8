"""The yardstick's arithmetic: the card's peaks, the work of one call of
each hand-written kernel, and the model FLOPs of a step.

The work of a call is the work its function needs, whatever implements
it: each input read once and each output written once, and the
operations of the function's own math. A roofline share is the larger of
FLOPs / peak and bytes / bandwidth, divided by the measured time.

``model_flops`` is a frozen copy of ``repro_torch.launch.roofline``'s
(6 N_active tokens for training, 2 N_active tokens for a prefill, plus the
attention or SSD-state term), over the benchmark's own description of the
model, so that no later change to the program moves the numerator.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)


def _nbytes(specs) -> int:
    total = 0
    for shape, itemsize in specs:
        n = 1
        for s in shape:
            n *= int(s)
        total += n * int(itemsize)
    return total


def causal_pairs(sq: int, skv: int) -> int:
    """Visible (q, k) pairs of causal attention whose queries are the last
    ``sq`` of ``skv`` positions."""
    off = skv - sq
    return sum(min(skv, off + i + 1) for i in range(sq))


def flash_attention_work(operands, results, causal: bool = True,
                         dv: int = None):
    """K1, one call: q (BHq, Sq, Dqk), k (BHkv, Skv, Dqk), v (BHkv, Skv,
    Dv). 2 (Dqk + Dv) flop per visible (q, k) pair and query head; q, k,
    v read once, the output written once. ``dv`` is the function's own
    value width where the caller pads v (and so the output) past it, as
    MLA pads v from v_head_dim to the qk width: the padding is no work.
    Returns (flops, bytes)."""
    (q, qi), (k, ki), (v, vi) = operands
    bhq, sq, dqk = q
    skv = k[1]
    if dv is None:
        dv = v[2]
    else:
        v = v[:-1] + (dv,)
        results = [(r[:-1] + (dv,), ri) for r, ri in results]
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    flops = 2 * (dqk + dv) * pairs * bhq
    return flops, _nbytes([(q, qi), (k, ki), (v, vi)] + list(results))


def chunk_len(seq: int, chunk: int) -> int:
    """The chunk the SSD scan runs at: min(chunk, seq), halved until it
    divides seq."""
    q = min(chunk, seq)
    while seq % q:
        q //= 2
    return q


def ssd_work(operands, results, chunk: int):
    """K2, one call: x (B, S, H, P), dt (B, S, H), A (H,), B and C (B, S,
    G, N). The chunked algorithm's products at the chunk ``chunk_len(S,
    chunk)``: per (batch, group, chunk) C B^T over the Q(Q+1)/2 visible
    pairs; per (batch, head, chunk) the masked scores times x over those
    pairs, C times the carried state and the state update, Q N P each.
    Returns (flops, bytes)."""
    (x, _), _, _, (bm, _), _ = operands
    b, s, h, p = x
    g, n = bm[2], bm[3]
    q = chunk_len(s, chunk)
    pairs = q * (q + 1) // 2
    nc = s // q
    flops = b * g * nc * 2 * pairs * n + b * h * nc * (2 * pairs * p
                                                       + 4 * q * n * p)
    return flops, _nbytes(list(operands) + list(results))


# --------------------------------------------------------------------------
# model FLOPs (frozen copy of the program's launch/roofline.py arithmetic)
# --------------------------------------------------------------------------

def layer_kinds(cfg: dict) -> list:
    """[(mixer, ffn)] per layer from a configuration file's sizes."""
    if cfg["model_type"] == "mamba2":
        return [("mamba", "none")] * cfg["num_hidden_layers"]
    dense = cfg["first_k_dense_replace"]
    return [("mla", "dense" if i < dense else "moe")
            for i in range(cfg["num_hidden_layers"])]


def active_matmul_params(cfg: dict) -> float:
    """Parameters in matmuls a token flows through: MoE top-k and shared
    experts only, the embedding gather excluded, the LM head included."""
    d = cfg["hidden_size"]
    total = 0.0
    for mixer, ffn in layer_kinds(cfg):
        if mixer == "mamba":
            d_inner = cfg["expand"] * d
            heads = d_inner // cfg["head_dim"]
            gn = cfg["n_groups"] * cfg["state_size"]
            total += d * (2 * d_inner + 2 * gn + heads) + d_inner * d
        else:
            h = cfg["num_attention_heads"]
            dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
            dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
            total += (d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv)
                      + h * dv * d)
        if ffn == "dense":
            total += 3 * d * cfg["intermediate_size"]
        elif ffn == "moe":
            total += 3 * d * cfg["moe_intermediate_size"] * (
                cfg["num_experts_per_tok"] + cfg["n_shared_experts"])
    return total + d * cfg["vocab_size"]


def attention_flops_per_token(cfg: dict, ctx: int) -> float:
    """Score and value flops a token at context ``ctx``; a Mamba layer's
    SSD state flops."""
    total = 0.0
    for mixer, _ in layer_kinds(cfg):
        if mixer == "mamba":
            d_inner = cfg["expand"] * cfg["hidden_size"]
            heads = d_inner // cfg["head_dim"]
            total += 4 * heads * cfg["state_size"] * cfg["head_dim"]
        else:
            total += 2 * ctx * cfg["num_attention_heads"] * (
                cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
                + cfg["v_head_dim"])
    return total


def model_flops(cfg: dict, kind: str, batch: int, seq: int) -> float:
    """One training step (``train``: forward and backward, no recompute
    counted) or one prefill of ``batch`` sequences of ``seq`` tokens."""
    n = active_matmul_params(cfg)
    tokens = batch * seq
    attn = attention_flops_per_token(cfg, seq // 2) * tokens
    if kind == "train":
        return 6.0 * n * tokens + 3.0 * attn
    if kind == "prefill":
        return 2.0 * n * tokens + attn
    raise ValueError(kind)

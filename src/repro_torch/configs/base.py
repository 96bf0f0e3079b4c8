"""Model config dataclasses (the port's own copy of ``repro.configs.base``'s
model part, ``CPSLConfig``, ``FleetConfig`` and the shape cells
``ShapeCfg``/``SHAPES``, the simulator's ``SimCfg``/``SimFleetCfg`` and
``MeshConfig``). The port's model configs have fields the reference's lack
(``ModelConfig.rope`` and ``mup``, ``MoECfg.d_ff_shared``, the sub-config
``MuPCfg``); their defaults are the reference's behaviour.

A ModelConfig fully describes one architecture in the zoo. Layer stacks are
an optional unrolled ``prologue`` followed by a periodic ``pattern``
repeated ``n_periods`` times; parameters of the pattern are stacked on a
leading ``n_periods`` axis. Heterogeneous stacks (gemma2 local/global,
jamba 1:7 mamba:attn with alternating MoE) are one period of the repeating
unit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    group_size: int = 2048          # tokens per dispatch group (GShard-style)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    d_ff_shared: int = 0            # the shared MLP's width; 0 = that of
                                    # the shared experts, d_ff_expert *
                                    # n_shared_experts (granite: its own)


@dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = full-rank q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class MuPCfg:
    """Constant multipliers of a muP-parametrised model (granite): the
    embeddings times ``embedding_multiplier``; each sublayer's output
    times ``residual_multiplier`` before its residual add; attention
    scores q.k times ``attention_multiplier`` (in place of 1/sqrt(head
    dim)); the final hidden state divided by ``logits_scaling``."""
    embedding_multiplier: float
    residual_multiplier: float
    attention_multiplier: float
    logits_scaling: float


@dataclass(frozen=True)
class LayerSpec:
    """Kinds for one layer: mixer in {attn, mamba}, ffn in {dense, moe, none}.

    ``window`` > 0 selects sliding-window attention for this layer (gemma2
    local layers). ``window == 0`` means full (global) attention.
    """
    mixer: str = "attn"
    ffn: str = "dense"
    window: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio | cnn
    d_model: int
    n_layers: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    prologue: Tuple[LayerSpec, ...] = ()
    pattern: Tuple[LayerSpec, ...] = (LayerSpec("attn", "dense"),)
    # attention details
    attn_kind: str = "gqa"           # gqa | mla
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope: bool = True                # False: no rotary embedding (NoPE)
    attn_softcap: float = 0.0        # gemma2: 50.0
    final_softcap: float = 0.0       # gemma2: 30.0
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"                # silu | gelu
    glu: bool = True                 # gated MLP (swiglu/geglu) vs plain 2-matmul
    post_norm: bool = False          # gemma2-style post-sublayer norms
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma: multiply embeddings by sqrt(d)
    # sub-configs
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    mup: Optional[MuPCfg] = None     # None: no multipliers (no op added)
    # encoder-decoder (whisper)
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500              # precomputed frame embeddings (frontend stub)
    # numerics / implementation selection
    dtype: str = "bfloat16"          # compute dtype
    param_dtype: str = "float32"
    attn_impl: str = "chunked"       # naive | chunked | pallas (the port's
                                     # "pallas" is the hand-written CUDA kernel)
    ssd_impl: str = "chunked"        # scan | chunked | pallas
    remat: bool = True
    remat_group: int = 1             # >1: two-level (sqrt) remat over
                                     # groups of this many periods
    q_chunk: int = 512
    kv_chunk: int = 1024
    loss_chunk: int = 0              # >0: chunked CE (never materializes
                                     # the full (tokens, vocab) logits)

    # -- derived -----------------------------------------------------------
    @property
    def n_periods(self) -> int:
        body = self.n_layers - len(self.prologue)
        if self.pattern:
            assert body % len(self.pattern) == 0, (
                f"{self.name}: {body} body layers not divisible by pattern "
                f"of {len(self.pattern)}")
            return body // len(self.pattern)
        return 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.n_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Flattened per-layer specs, prologue first."""
        return self.prologue + self.pattern * self.n_periods


@dataclass(frozen=True)
class CPSLConfig:
    """Cluster-based Parallel Split Learning hyper-parameters (paper §IV)."""
    cut_layer: int = 2               # v: blocks [0, v) are device-side
    n_clusters: int = 6              # M
    cluster_size: int = 5            # K_m devices per cluster
    local_epochs: int = 1            # L
    lr_device: float = 0.05          # eta_d
    lr_server: float = 0.25          # eta_e
    batch_per_device: int = 16       # B
    optimizer: str = "sgd"           # sgd | momentum | adamw
    momentum: float = 0.0
    weight_decay: float = 0.0
    fused_step: bool = True          # fused autodiff vs explicit 2-phase protocol
    fused_round: bool = False        # trainers use CPSL.run_round_fused
                                     # (device-resident data, batches
                                     # gathered on the device, FedAvg at
                                     # each cluster boundary, no host sync)
                                     # instead of the looped run_round
    fused_round_unroll: int = 0      # the reference's scan unroll; the port
                                     # runs the cluster axis as a Python loop
                                     # and keeps the field for config parity
    unroll_clients: bool = False     # K-client device pass as a Python loop
                                     # over clients instead of
                                     # torch.func.vmap over the K-stacked
                                     # weights (grouped convolutions)
    microbatches: int = 1            # grad-accumulation splits of B
    share_device_params: bool = False  # L==1 fast path (beyond-paper)
    straggler_dropout: float = 0.0   # fraction of clients allowed to miss FedAvg
    compress_uploads: str = "none"   # none | topk | int8 (device-model uploads)
    compress_topk: float = 0.1
    scan_rounds: bool = False        # the reference's scanned round axis
                                     # in run_training_fused; the port runs
                                     # rounds as a Python loop and keeps the
                                     # field (and its eval_every | rounds
                                     # assertion) for config parity
    conv_impl: str = "direct"        # lenet conv: "direct" (F.conv2d) |
                                     # "im2col" (9 slices + one matmul); same
                                     # params, consumed by
                                     # make_split_model("lenet", v,
                                     # conv_impl=...)


@dataclass(frozen=True)
class FleetConfig:
    """Experiment fleet: E = len(seeds) x len(cluster_sizes) x
    len(lr_scales) CPSL training replicas run as one batched program
    (``CPSL.run_fleet``, built and driven by ``train.trainer.FleetRunner``).

    Replicas differ only in data: per-replica seeds (init, non-IID shard
    draws, batch streams), cluster layouts padded to the grid's (max M,
    max K) with masks, and learning-rate scales applied as tensors."""
    rounds: int = 10
    seeds: Tuple[int, ...] = (0,)
    cluster_sizes: Tuple[int, ...] = (5,)   # N_m grid axis (fig. 6)
    lr_scales: Tuple[float, ...] = ()       # lr grid axis, multiplying the
                                            # CPSLConfig lrs; () = base lr only
    n_devices: int = 30                     # N (shards drawn per seed)
    eval_every: int = 0                     # in-loop eval cadence; 0 = off
    samples_per_device: int = 180           # non-IID shard size

    @property
    def n_replicas(self) -> int:
        return (len(self.seeds) * len(self.cluster_sizes)
                * max(len(self.lr_scales), 1))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class SimCfg:
    """Dynamic-network simulation (``repro_torch.sim``): round/timescale
    layout of one end-to-end "train under dynamics" run."""
    rounds: int = 20                 # small-timescale slots == CPSL rounds
    epoch_len: int = 5               # rounds per large timescale epoch (Alg. 2 rerun)
    cluster_size: int = 5            # target K; clusters shrink under churn
    saa_samples: int = 3             # J network samples per SAA evaluation
    saa_gibbs_iters: int = 40        # Gibbs iters inside the SAA inner loop
    gibbs_iters: int = 120           # Gibbs iters for the per-slot plan
    gibbs_chains: int = 1            # lockstep Gibbs replicas per plan
                                     # (best-of-R; chain 0 == single-chain
                                     # stream, so 1 reproduces the looped
                                     # planner bit-exactly)
    cuts: Optional[Tuple[int, ...]] = None  # candidate cut layers (None = all)
    trace_path: Optional[str] = None # JSONL trace destination
    seed: int = 0
    # -- population-scale planning knobs -----------------------------------
    plan_mode: str = "flat"          # "flat" = one Gibbs over all devices;
                                     # "bucketed" = hierarchical two-level
                                     # clustering (bucket_devices + per-
                                     # bucket lockstep Gibbs). With
                                     # n <= bucket_size the bucketed plan
                                     # is bit-identical to flat (tested)
    bucket_size: int = 320           # target devices per coarse bucket
    spectrum_topk: int = 0           # >0: greedy Alg. 3 argmins scan only
                                     # the k worst-score devices per step
                                     # (k >= cluster size is exact)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SimFleetCfg:
    """Episode fleet: E = cuts x policies x cluster_sizes x seeds dynamic-
    network episodes priced as one batched float64 program
    (``repro_torch.sim.fleet.SimFleetRunner``).

    Episodes differ only in data — per-episode profile constants (cut),
    policy/cluster-size selectors, device means and innovation streams
    (seed) — so the whole grid runs as one set of tensor operations per
    slot. Episodes with the same ``seed`` share their network realization
    (means + fading/compute innovations, and the churn/planner draws),
    which gives common-random-number coupling across the other grid axes
    (the fig. 7 cut sweep and the fig. 8(b) three-arm comparison rely on
    it).

    The ``proposed`` policy is the paper's full two-timescale controller:
    per-slot Gibbs clustering with embedded greedy (Alg. 3/4,
    ``gibbs_iters`` sweeps, best of ``gibbs_chains`` lockstep chains) and
    — when ``saa_cuts`` is set — Alg. 2 SAA cut re-selection every
    ``epoch_len`` slots over the (cut x sample x chain) grid around the
    episode's device means. ``saa_cuts=None`` keeps the episode's spec
    cut fixed (pure small-timescale planning)."""
    rounds: int = 20                        # slots T per episode
    seeds: Tuple[int, ...] = (0,)
    policies: Tuple[str, ...] = ("greedy",)  # equal | greedy | proposed
    cluster_sizes: Tuple[int, ...] = (5,)   # target K per episode
    cuts: Tuple[int, ...] = (3,)            # cut layer v per episode
    batch_per_device: int = 16              # B in the eq. 15-25 cost model
    local_epochs: int = 1                   # L
    mean_seed: Optional[int] = None         # shared device_means seed;
                                            # None = per-episode seed
    # -- proposed-policy (two-timescale controller) knobs ------------------
    epoch_len: int = 5                      # slots per large-timescale epoch
    gibbs_iters: int = 120                  # Alg. 4 sweeps per slot plan
    gibbs_chains: int = 1                   # best-of-R lockstep chains
    gibbs_delta: float = 1e-4               # Metropolis temperature
    saa_samples: int = 3                    # J network samples per SAA cell
    saa_gibbs_iters: int = 40               # Alg. 4 sweeps inside SAA
    saa_cuts: Optional[Tuple[int, ...]] = None  # Alg. 2 candidate cuts;
                                            # None = no SAA (fixed spec cut)
    # -- stochastic-churn support ------------------------------------------
    n_reserve: int = 0                      # reserve device rows for
                                            # Bernoulli arrivals (p_arrive)
    min_devices_floor: bool = False         # honor DynamicsCfg.min_devices
                                            # (opt-in: False keeps every
                                            # departure/depletion executing)
    cost_chunk: int = 0                     # >0: stream the greedy
                                            # candidate tensors in tiles of
                                            # this many clusters (bounds
                                            # peak memory; decisions
                                            # unchanged, tested)

    @property
    def n_episodes(self) -> int:
        return (len(self.cuts) * len(self.policies)
                * len(self.cluster_sizes) * len(self.seeds))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MeshConfig:
    """The reference's device-mesh shape. Kept so that this module has
    every name of ``repro.configs.base``; the port runs on one card
    (``launch.mesh.make_host_mesh``)."""
    data: int = 16
    model: int = 16
    pods: int = 1                    # >1 adds leading "pod" axis

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.pods


@dataclass(frozen=True)
class ShapeCfg:
    """One input-shape cell of the LM zoo."""
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeCfg("long_500k", 524288, 1, "decode"),
}

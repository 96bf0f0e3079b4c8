"""Cut-layer splitting: device-side and server-side sub-models (paper
§III/IV); the port of ``repro.core.splitting``.

A ``SplitModel`` bundles:
    init_device(generator) / init_server(generator)
    device_apply(dev_params, batch)         -> (smashed, aux)
    device_apply_clients(dev_K, batch_K)    -> the same for K clients at
                                               once (K-stacked params)
    server_loss(srv_params, smashed, batch) -> (loss, aux)
    server_loss_replicas(srv_E, smashed_E, batch_E)
                                            -> (loss (E,), aux (E,)): E
                                               server models at once
                                               (an experiment fleet)
    export(dev_params, srv_params)          -> (assembled params, cfg)
    smashed_spec(batch_size, seq)           -> a ``meta`` tensor of the
                                               smashed data's shape/dtype

Cut-layer conventions per family:
  - LM (dense/MoE/ssm/hybrid, GQA or MLA attention): device = embed +
    blocks[:v]; server = blocks[v:] + final norm + an untied head (the
    device owns the embedding table; the server cannot share it across
    the wireless link). Each half returns its MoE layers' summed router
    aux loss beside its output.
  - enc-dec (whisper): the cut lies inside the encoder, 1 <= v < n_enc;
    device = frames + positions + encoder blocks [:v]; server = encoder
    blocks [v:], the encoder norm, the whole decoder and the (tied) head.
  - LeNet (the paper's model): layer-granular Table III split.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as cm
from repro_torch.models import lenet as ln
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whp


@dataclass(frozen=True)
class SplitModel:
    kind: str
    cfg: Optional[ModelConfig]
    v: int
    n_cuts: int
    init_device: Callable
    init_server: Callable
    device_apply: Callable          # (dev_params, batch) -> (smashed, aux)
    device_apply_clients: Callable  # K-stacked params and (K, B, ..) batch
                                    # -> (smashed (K, B, ..), aux (K,))
    server_loss: Callable           # (srv, smashed, batch) -> (loss, aux)
    export: Callable                # (dev, srv) -> (params, cfg)
    smashed_spec: Callable          # (batch_size, seq) -> meta tensor
    eval_metrics: Optional[Callable] = None
    # (dev, srv, eval_batch) -> {"acc", "loss"} device tensors
    masked_loss: bool = False
    # True when server_loss implements the reserved per-sample
    # ``batch["sample_weight"]`` semantics of padded layouts
    server_loss_replicas: Optional[Callable] = None
    # E-stacked server params, smashed (E, K*B, ..) and batch (E, K*B, ..)
    # -> (loss (E,), aux (E,)); replica e equals server_loss on its slab
    eval_metrics_replicas: Optional[Callable] = None
    # (dev_E, srv_E, eval_batch) -> {"acc": (E,), "loss": (E,)}; one shared
    # eval batch


def make_lenet_split(v: int, input_hw: int = 28,
                     conv_impl: str = "direct") -> SplitModel:
    """``conv_impl``: "direct" (``F.conv2d``) or "im2col" (9 slices + one
    matmul). Params are identical between the two."""
    def init_device(generator):
        return ln.split_params(ln.init(generator, input_hw), v)[0]

    def init_server(generator):
        return ln.split_params(ln.init(generator, input_hw), v)[1]

    def device_apply(dev, batch):
        x = ln.apply_range(dev, batch["image"], 0, v, conv_impl)
        return x, x.new_zeros(())

    def device_apply_clients(dev, batch):
        x = ln.apply_range_clients(dev, batch["image"], 0, v, conv_impl)
        return x, x.new_zeros(x.shape[:1])

    def server_loss(srv, smashed, batch):
        logits = ln.apply_range(srv, smashed, v, ln.N_LAYERS, conv_impl)
        nll = ln.nll(logits, batch["label"])
        zero = nll.new_zeros(())
        weight = batch.get("sample_weight")
        if weight is None:
            return nll.mean(), zero
        # padded client slots carry exactly zero weight, so their data
        # never reaches loss or gradients
        w = weight.reshape(-1).to(nll.dtype)
        return (nll[:, 0] * w).sum() / torch.clamp_min(w.sum(), 1.0), zero

    def server_loss_replicas(srv, smashed, batch):
        """E server models over their own smashed data: one grouped
        convolution or batched matmul per layer (the K-client pass with
        the replica axis as its client axis, in ``apply_range``'s layout:
        ``lenet.apply_range_replicas``); per-replica means, so no
        replica's loss sees another's samples."""
        logits = ln.apply_range_replicas(srv, smashed, v, ln.N_LAYERS,
                                         conv_impl)
        E = logits.shape[0]
        nll = ln.nll(logits.reshape(-1, logits.shape[-1]),
                     batch["label"].reshape(-1)).reshape(E, -1)
        zero = nll.new_zeros((E,))
        weight = batch.get("sample_weight")
        if weight is None:
            return nll.mean(-1), zero
        w = weight.reshape(E, -1).to(nll.dtype)
        return ((nll * w).sum(-1)
                / torch.clamp_min(w.sum(-1), 1.0)), zero

    def export(dev, srv):
        return ln.merge_params(dev, srv), None

    def smashed_spec(batch_size, seq=None):
        shp = ln.layer_shapes(input_hw)[v - 1]
        return torch.empty((batch_size,) + tuple(shp), dtype=torch.float32,
                           device="meta")

    def eval_metrics(dev, srv, batch):
        """Test-set metrics on the device; the host equivalent is export
        followed by ``lenet.accuracy``."""
        smashed = ln.apply_range(dev, batch["image"], 0, v, conv_impl)
        logits = ln.apply_range(srv, smashed, v, ln.N_LAYERS, conv_impl)
        acc = (logits.argmax(-1) == batch["label"]).float().mean()
        return {"acc": acc, "loss": ln.nll(logits, batch["label"]).mean()}

    def eval_metrics_replicas(dev, srv, batch):
        """``eval_metrics`` for E replicas on one shared eval batch."""
        E = tree.leaves(srv)[0].shape[0]
        x = batch["image"]
        x = x[None].expand((E,) + tuple(x.shape))
        smashed = ln.apply_range_replicas(dev, x, 0, v, conv_impl)
        logits = ln.apply_range_replicas(srv, smashed, v, ln.N_LAYERS,
                                         conv_impl)
        labels = batch["label"]
        acc = (logits.argmax(-1) == labels[None]).float().mean(-1)
        nll = ln.nll(logits.reshape(-1, logits.shape[-1]),
                     labels[None].expand(E, -1).reshape(-1))
        return {"acc": acc, "loss": nll.reshape(E, -1).mean(-1)}

    return SplitModel("lenet", None, v, ln.N_LAYERS - 1, init_device,
                      init_server, device_apply, device_apply_clients,
                      server_loss, export,
                      smashed_spec, eval_metrics, masked_loss=True,
                      server_loss_replicas=server_loss_replicas,
                      eval_metrics_replicas=eval_metrics_replicas)


# --------------------------------------------------------------------------
# LM split
# --------------------------------------------------------------------------

def _client_loop(device_apply):
    """``device_apply_clients`` as a Python loop over the K clients
    (``torch.func.vmap`` cannot see through a kernel launch), every
    K-stacked leaf unbound once."""
    def device_apply_clients(dev, batch):
        outs = [device_apply(d, b)
                for d, b in zip(tree.unbind(dev), tree.unbind(batch))]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    return device_apply_clients


def _split_cfgs(cfg: ModelConfig, v: int):
    """(device cfg, server cfg) for a cut after layer v. The device runs
    layers [:v] as an unrolled prologue; the server runs the rest, its
    prologue the remainder of a period cut mid-pattern (gemma2 at an odd
    v starts on a global layer)."""
    specs = cfg.layer_specs()
    if not 1 <= v < len(specs):
        raise ValueError(f"cut {v} out of range for {cfg.name} "
                         f"({len(specs)} layers)")
    dev_cfg = cfg.replace(prologue=tuple(specs[:v]), pattern=(), n_layers=v)
    n_pro = len(cfg.prologue)
    if v < n_pro:
        srv_cfg = cfg.replace(prologue=cfg.prologue[v:],
                              n_layers=cfg.n_layers - v)
    else:
        off = (v - n_pro) % len(cfg.pattern)
        srv_pro = cfg.pattern[off:] if off else ()
        srv_cfg = cfg.replace(prologue=tuple(srv_pro),
                              n_layers=cfg.n_layers - v)
    return dev_cfg, srv_cfg


def make_lm_split(cfg: ModelConfig, v: int) -> SplitModel:
    """The LM split at cut v. Params are the reference's trees: the device
    ``{"embed": {"tok"}, "prologue": [v blocks], "stack": []}``, the
    server ``{"prologue", "stack" (period-stacked), "final_norm", "head"
    (D, V)}``."""
    dev_cfg, srv_cfg = _split_cfgs(cfg, v)
    pdt = cm.pdtype(cfg)

    def init_device(generator):
        return {
            "embed": {"tok": cm._normal(generator,
                                        (cfg.vocab_size, cfg.d_model), 0.02,
                                        pdt)},
            "prologue": [tfm.block_init(generator, cfg, s)
                         for s in dev_cfg.prologue],
            "stack": [],
        }

    def init_server(generator):
        params = {
            "prologue": [tfm.block_init(generator, cfg, s)
                         for s in srv_cfg.prologue],
            "final_norm": cm.norm_init(cfg.d_model, cfg.norm_kind, pdt,
                                       generator.device),
            "head": cm._normal(generator, (cfg.d_model, cfg.vocab_size),
                               1.0 / math.sqrt(cfg.d_model), pdt),
        }
        n = srv_cfg.n_periods
        # leaves (n, ...); a server with no whole period keeps (0, ...)
        # leaves, as the reference's vmapped init does
        params["stack"] = [
            tree.map(lambda t: t[:n], tfm._stack(
                [tfm.block_init(generator, cfg, s) for _ in range(max(n, 1))]))
            for s in srv_cfg.pattern]
        return params

    def device_apply(dev, batch):
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = cm.embed_apply(dev["embed"], tokens, cfg)
        return tfm._stack_forward(dev, x, dev_cfg, positions)

    def server_loss(srv, smashed, batch):
        positions = torch.arange(smashed.shape[1], device=smashed.device)
        x, aux = tfm._stack_forward(srv, smashed, srv_cfg, positions)
        x = cm.apply_norm(srv["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
        loss = cm.lm_head_loss(srv["head"], x, batch["labels"], cfg,
                               batch.get("mask"))
        return loss, aux

    def export(dev, srv):
        """Re-stack into a standard transformer params tree (untied)."""
        flat = list(dev["prologue"]) + list(srv["prologue"])
        srv_periods = list(zip(*[tree.unbind(t) for t in srv["stack"]]))
        for period in srv_periods:
            flat += list(period)
        n_pro, P = len(cfg.prologue), len(cfg.pattern)
        body = flat[n_pro:]
        params = {
            "embed": {"tok": dev["embed"]["tok"], "head": srv["head"]},
            "final_norm": srv["final_norm"],
            "prologue": flat[:n_pro],
            "stack": [tfm._stack([body[i * P + pos]
                                  for i in range(cfg.n_periods)])
                      for pos in range(P)],
        }
        return params, cfg.replace(tie_embeddings=False)

    def smashed_spec(batch_size, seq):
        return torch.empty((batch_size, seq, cfg.d_model),
                           dtype=cm.cdtype(cfg), device="meta")

    return SplitModel("lm", cfg, v, len(cfg.layer_specs()) - 1, init_device,
                      init_server, device_apply, _client_loop(device_apply),
                      server_loss, export, smashed_spec)


# --------------------------------------------------------------------------
# enc-dec (whisper) split: the cut inside the encoder
# --------------------------------------------------------------------------

def make_encdec_split(cfg: ModelConfig, v: int) -> SplitModel:
    """The whisper split at encoder cut v. Params are the reference's
    trees: the device ``{"enc_stack": v blocks}``, the server the whole
    model's tree with ``enc_stack`` holding blocks [v:]. The encoder
    blocks run without remat on both sides (the reference's plain scan);
    the server's decoder checkpoints each block when ``cfg.remat``."""
    n_enc = cfg.n_enc_layers
    if not 1 <= v < n_enc:
        raise ValueError(f"cut {v} out of range for {cfg.name}: the cut "
                         f"lies inside the encoder, 1 <= v < {n_enc}")
    n_dec = cfg.n_layers - n_enc
    dt = cm.pdtype(cfg)

    def init_device(generator):
        return {"enc_stack": tfm._stack([whp._enc_block_init(generator, cfg)
                                         for _ in range(v)])}

    def init_server(generator):
        dev = generator.device
        return {
            "embed": cm.embed_init(generator, cfg),
            "enc_stack": tfm._stack([whp._enc_block_init(generator, cfg)
                                     for _ in range(n_enc - v)]),
            "enc_norm": cm.norm_init(cfg.d_model, "layernorm", dt, dev),
            "dec_stack": tfm._stack([whp._dec_block_init(generator, cfg)
                                     for _ in range(n_dec)]),
            "dec_norm": cm.norm_init(cfg.d_model, "layernorm", dt, dev),
        }

    def device_apply(dev, batch):
        x = whp.enc_blocks(dev["enc_stack"],
                           whp.embed_frames(batch["frames"], cfg), cfg)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def server_loss(srv, smashed, batch):
        x = whp.enc_blocks(srv["enc_stack"], smashed, cfg)
        memory = cm.apply_norm(srv["enc_norm"], x, "layernorm", cfg.norm_eps)
        xd = whp.decode_hidden(srv, batch["tokens"], memory, cfg)
        loss = cm.lm_head_loss(tfm.head_matrix(srv, cfg), xd,
                               batch["labels"], cfg, batch.get("mask"))
        return loss, torch.zeros((), dtype=torch.float32,
                                 device=loss.device)

    def export(dev, srv):
        params = dict(srv)
        params["enc_stack"] = tree.map(lambda a, b: torch.cat([a, b], 0),
                                       dev["enc_stack"], srv["enc_stack"])
        return params, cfg

    def smashed_spec(batch_size, seq=None):
        return torch.empty((batch_size, cfg.enc_seq, cfg.d_model),
                           dtype=cm.cdtype(cfg), device="meta")

    return SplitModel("encdec", cfg, v, n_enc - 1, init_device, init_server,
                      device_apply, _client_loop(device_apply), server_loss,
                      export, smashed_spec)


def make_split_model(cfg_or_name, v: int, **kw) -> SplitModel:
    if cfg_or_name == "lenet" or cfg_or_name is None:
        return make_lenet_split(v, **kw)
    cfg: ModelConfig = cfg_or_name
    if cfg.family == "cnn":
        return make_lenet_split(v, **kw)
    if cfg.encdec:
        return make_encdec_split(cfg, v)
    return make_lm_split(cfg, v)

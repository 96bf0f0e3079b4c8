"""The port's models at full width on the card: the hand-written kernels'
launches in a ``generate`` and in a split-LM training step of each
architecture (they follow the layer kinds and the depth), the served
prefill logits against the plain path, the MoE models' under the
routing-flip rule, the first training step's reach into every parameter,
one block of each kind through the kernels' ``autograd.Function``s against
the plain path, and the training launcher on the card.

Every test is marked ``requires_cuda`` and skips on a host without a card.
The file imports neither JAX nor the reference:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_cuda_models.py
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch import streams, tree
from repro_torch.configs import registry
from repro_torch.configs.base import CPSLConfig
from repro_torch.core.cpsl import CPSL
from repro_torch.core.splitting import make_split_model
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import api
from repro_torch.serving.engine import ServeEngine
from test_torch_cuda import (BF16_TOL, LOGITS_TOL,  # noqa: F401
                             SSD_BF16_TOL, SSD_F32_TOL, cuda, launched)

pytestmark = pytest.mark.requires_cuda

# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

STEPS = 4
# each model at full width on the kernel paths: (batch, prompt, config
# changes): bf16 params, and fewer layers of the model's own pattern where
# one card would not hold it beside the plain path. The prompts are those
# the models serve at: mamba2's is its serve cell's (4 x 8192, 32 chunks of
# K2), a MoE prompt of 4 x 4096 tokens takes the prefill's capacity route
# (past 4096 tokens), whisper serves 16 clips of 1500 frames (its decoder
# holds 448 positions)
SERVE_MODELS = {
    "gemma2-2b": (4, 5120, {}),
    "mamba2-2.7b": (4, 8192, {}),
    "whisper-small": (16, 64, {}),
    "deepseek-v2-lite-16b": (4, 4096, {"param_dtype": "bfloat16"}),
    "phi3.5-moe-42b-a6.6b": (4, 4096, {"param_dtype": "bfloat16",
                                       "n_layers": 8}),
    "jamba-v0.1-52b": (4, 4096, {"param_dtype": "bfloat16",
                                 "n_layers": 8}),
}
MOE_ARCHS = ["deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b",
             "jamba-v0.1-52b"]


def _serve_cfgs(arch):
    """(the kernel path's config, the plain path's, the batch, the
    prompt)."""
    batch, prompt, cut = SERVE_MODELS[arch]
    cfg = registry.get(arch).replace(attn_impl="pallas", ssd_impl="pallas",
                                     **cut)
    return (cfg, cfg.replace(attn_impl="chunked", ssd_impl="chunked"), batch,
            prompt)


def _serve_batch(cfg, batch_size: int, prompt: int, device) -> dict:
    """Seeded prompt tokens; for an enc-dec model also seeded random frame
    embeddings in the compute dtype (the audio frontend is a stub)."""
    gen = streams.sampler_generator(1, device)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (batch_size, prompt), device=device,
                                     generator=gen)}
    if cfg.encdec:
        batch["frames"] = torch.randn(
            (batch_size, cfg.enc_seq, cfg.d_model), device=device,
            generator=gen).to(getattr(torch, cfg.dtype))
    return batch


def _expected_launches(cfg, steps: int = STEPS) -> dict:
    """Each kernel's launches in one generate of ``steps`` tokens (a
    prefill and steps - 1 decode steps): K1 once per attention layer and
    K2 and the conv stage's kernel once per Mamba layer of the prefill
    (the decode steps the conv window on the host's eager path), the gated
    output stage's kernel once per Mamba layer of the prefill and of each
    decode step, no backward.
    An enc-dec model's prefill runs K1 once per encoder layer and twice
    per decoder layer (self- and cross-attention)."""
    want = {"flash_attention": 0, "ssd": 0, "ssd_bwd": 0, "gated_norm": 0,
            "gated_norm_bwd": 0, "causal_conv": 0, "causal_conv_bwd": 0}
    if cfg.encdec:
        n_dec = cfg.n_layers - cfg.n_enc_layers
        return {**want, "flash_attention": cfg.n_enc_layers + 2 * n_dec}
    mixers = [s.mixer for s in cfg.layer_specs()]
    n_mamba = mixers.count("mamba")
    return {**want, "flash_attention": mixers.count("attn"), "ssd": n_mamba,
            "gated_norm": n_mamba * steps, "causal_conv": n_mamba}


@pytest.mark.parametrize("arch", SERVE_MODELS)
def test_generate_at_full_width(launched, cuda, arch):
    """One ``generate`` launches each kernel as ``_expected_launches``
    says, its tokens lie in the vocabulary and the prefill logits are
    finite. A model without MoE (the MoE models: the routing-flip rule
    below) holds its bf16 prefill logits within LOGITS_TOL of the plain
    path's; where the kernel path runs the Mamba-2 mixer's gated stage,
    which rounds once where the plain bf16 path rounds after the skip, the
    gate and the norm (the two bf16 paths part layer by layer, each ~0.3
    from f32 over mamba2's 64 layers), both are held to the plain path in
    f32 compute: the kernel path no farther from it than LOGITS_TOL or
    the plain bf16 path."""
    cfg, plain_cfg, batch_size, prompt = _serve_cfgs(arch)
    params = api.init(streams.model_generator(0, cuda), cfg)
    batch = _serve_batch(cfg, batch_size, prompt, cuda)
    eng = ServeEngine(cfg, params, cap=prompt + STEPS, device=cuda)
    before = dict(launched)
    out = eng.generate(batch, steps=STEPS)
    assert {k: launched[k] - before[k] for k in before} \
        == _expected_launches(cfg)
    assert out.shape == (batch_size, STEPS) and out.dtype == torch.int32
    assert 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size
    logits = eng.prefill(batch)[0].float()
    assert bool(torch.isfinite(logits).all())
    if arch in MOE_ARCHS:
        return
    plain = ServeEngine(plain_cfg, params, cap=prompt + STEPS, device=cuda)
    ref = plain.prefill(batch)[0].float()
    limit = LOGITS_TOL
    if _expected_launches(cfg)["gated_norm"]:
        f32 = ServeEngine(plain_cfg.replace(dtype="float32"), params,
                          cap=prompt + STEPS, device=cuda)
        ref, plain_bf16 = f32.prefill(batch)[0].float(), ref
        limit = max(LOGITS_TOL, (plain_bf16 - ref).abs().max().item())
    err = (logits - ref).abs().max().item()
    assert err <= limit, (err, limit)


@contextlib.contextmanager
def _moe_routes(record: list, replay=None):
    """``models.common.moe_route`` wrapped for the calls inside: each MoE
    layer's top-k expert indices (the router's order) are appended to
    ``record``. With ``replay``, each layer takes the next of those
    indices instead of its own top-k, and its gates are its own
    probabilities there, renormalised."""
    from repro_torch.models import common as cm
    orig = cm.moe_route
    given = iter(replay) if replay is not None else None

    def route(p, x, k):
        probs, w, idx = orig(p, x, k)
        if given is not None:
            idx = next(given)
            w = torch.gather(probs, -1, idx)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        record.append(idx)
        return probs, w, idx

    cm.moe_route = route
    try:
        yield
    finally:
        cm.moe_route = orig


@contextlib.contextmanager
def _first_flash_inputs(store: dict):
    """The first K1 call's flat q, k, v and options inside, copied into
    ``store``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    orig = fa_ops.flash_attention_flat

    def capture(q, k, v, **kw):
        if not store:
            store.update(q=q.clone(), k=k.clone(), v=v.clone(), kw=kw)
        return orig(q, k, v, **kw)

    fa_ops.flash_attention_flat = capture
    try:
        yield
    finally:
        fa_ops.flash_attention_flat = orig


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_logits_under_the_routing_flip_rule(cuda, arch):
    """A bf16 difference in an attention output can flip a near-tie in a
    router's top-k; that token then takes other experts and its logits
    move by O(1): another route, not a kernel error. So the kernel path's
    bf16 prefill logits are held to the plain path's by a rule: the
    kernel path repeats itself bit for bit; K1 at the model's own q, k, v
    (the first attention layer) is within BF16_TOL of the plain
    attention; the rows (requests) with no flipped token in any MoE layer
    are within LOGITS_TOL; and the plain path replaying the kernel path's
    routes is within LOGITS_TOL on every row."""
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_flat
    cfg, plain_cfg, batch_size, prompt = _serve_cfgs(arch)
    params = api.init(streams.model_generator(0, cuda), cfg)
    batch = _serve_batch(cfg, batch_size, prompt, cuda)
    eng = ServeEngine(cfg, params, cap=prompt + 1, device=cuda)
    plain = ServeEngine(plain_cfg, params, cap=prompt + 1, device=cuda)
    kernel_routes, plain_routes, replayed, first = [], [], [], {}
    logits = eng.prefill(batch)[0]
    with _moe_routes(kernel_routes), _first_flash_inputs(first):
        assert torch.equal(eng.prefill(batch)[0], logits)
    with _moe_routes(plain_routes):
        logits_p = plain.prefill(batch)[0]
    with _moe_routes(replayed, replay=kernel_routes):
        logits_r = plain.prefill(batch)[0]
    B, S = batch["tokens"].shape
    flipped, flips = torch.zeros(B, dtype=torch.bool, device=cuda), []
    for a, b in zip(kernel_routes, plain_routes):
        diff = (a.reshape(B, S, -1).sort(-1).values
                != b.reshape(B, S, -1).sort(-1).values).any(-1)
        flips.append(int(diff.sum()))
        flipped |= diff.any(-1)
    print(arch, "tokens with another expert set, by MoE layer:", flips)
    err_rows = (logits - logits_p).float().abs().amax(-1)
    assert bool((err_rows[~flipped] <= LOGITS_TOL).all()), err_rows
    assert (logits - logits_r).float().abs().max().item() <= LOGITS_TOL
    q, k, v, kw = first["q"], first["k"], first["v"], first["kw"]
    got = flash_attention_flat(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (got.float() - attention_ref(q, k, v, **kw).float()
            ).abs().max().item() < BF16_TOL


# --------------------------------------------------------------------------
# split-LM CPSL training
# --------------------------------------------------------------------------

# N = 4 devices in M = 2 clusters of K = 2, L = 1, cut v = 1, 2 rounds (4
# cluster steps), SGD at CPSLConfig's lrs (0.05 device, 0.25 server), bf16
# compute with remat, f32 params, the CE in chunks of LM_LOSS_CHUNK tokens
# (never (B*S, 256000) f32 logits at once)
LM_M, LM_K, LM_ROUNDS, LM_LOSS_CHUNK = 2, 2, 2, 512
# each model: (its kernel, the kernel path's impl, the plain path's, the
# sequence, sequences (clips) a device, config changes). whisper's cut is
# inside the encoder; its sequence is the decoder's context, the encoder
# reads 1500 frames a clip. deepseek-v2-lite trains at 14 of its 27 layers
# with bf16 params: SGD's functional update holds the old params, their
# gradients and the new ones at once, ~3 x 16.8 GB
LM_MODELS = {
    "gemma2-2b": ("flash_attention", {"attn_impl": "pallas"},
                  {"attn_impl": "chunked"}, 1024, 2, {}),
    "mamba2-2.7b": ("ssd", {"ssd_impl": "pallas"}, {"ssd_impl": "chunked"},
                    1024, 2, {}),
    "whisper-small": ("flash_attention", {"attn_impl": "pallas"},
                      {"attn_impl": "chunked"}, 448, 4, {}),
    "deepseek-v2-lite-16b": ("flash_attention", {"attn_impl": "pallas"},
                             {"attn_impl": "chunked"}, 1024, 1,
                             {"param_dtype": "bfloat16", "n_layers": 14}),
}
# kernel path vs plain path, per-leaf parameter gradients of one block at
# full width, err / max(1, max|g|): tests/test_kernels.py's tolerances
LM_GRAD_TOL = {("flash_attention", "float32"): 1e-4,
               ("ssd", "float32"): SSD_F32_TOL,
               ("flash_attention", "bfloat16"): BF16_TOL,
               ("ssd", "bfloat16"): SSD_BF16_TOL}
# a leaf must move in the first step when some element's SGD update |lr g|,
# less the gradient's measured run-to-run variation, is at least this many
# ulps of its value: an update over half an ulp always changes a
# round-to-nearest value, one under half an ulp is rounded away (a bf16
# norm scale of 1.0 keeps 1.0 unless |lr g| >= 2^-8), and the margin from
# half an ulp to one covers the rounding of lr g itself
MOVE_ULPS = 1


def _lm_launches_per_step(cfg, kernel: str, v: int) -> int:
    """K1 (or K2) launches in one CPSL step with remat: every layer of the
    kernel's kind runs forward once and again in backward (the
    checkpoint's recompute), the device side once per client: 2 * (K*v +
    n_layers - v) when every layer is of that kind. An enc-dec split runs
    its encoder blocks without remat (the reference's plain scan) and its
    decoder's self- and cross-attention twice: K*v + (n_enc - v) + 4 *
    n_dec."""
    if cfg.encdec:
        if kernel != "flash_attention":
            return 0
        n_enc = cfg.n_enc_layers
        return LM_K * v + (n_enc - v) + 4 * (cfg.n_layers - n_enc)
    kind = "attn" if kernel == "flash_attention" else "mamba"
    specs = cfg.layer_specs()
    dev = sum(s.mixer == kind for s in specs[:v])
    srv = sum(s.mixer == kind for s in specs[v:])
    return 2 * (LM_K * dev + srv)


def _lm_step_launches(cfg, kernel: str, v: int) -> dict:
    """Each kernel's launches in one such step: ``kernel`` as
    ``_lm_launches_per_step`` says; for K2, the conv and the gated output
    stages' kernels as often (a Mamba layer runs all three in its forward
    and its remat recompute) and the three backward kernels half that;
    every other kernel never."""
    per_step = _lm_launches_per_step(cfg, kernel, v)
    want = {"flash_attention": 0, "ssd": 0, "ssd_bwd": 0, "gated_norm": 0,
            "gated_norm_bwd": 0, "causal_conv": 0, "causal_conv_bwd": 0,
            kernel: per_step}
    if kernel == "ssd":
        want.update(ssd_bwd=per_step // 2, gated_norm=per_step,
                    gated_norm_bwd=per_step // 2, causal_conv=per_step,
                    causal_conv_bwd=per_step // 2)
    return want


def _lm_batches(cfg, seq: int, batch: int, device) -> dict:
    """Seeded ``LMClusterData`` batches of Markov tokens, (K, B, seq)
    leaves, one a (round, cluster); an enc-dec model's also carry seeded
    random frames (K, B, enc_seq, d_model) in the compute dtype."""
    from repro_torch.core.cpsl import to_device
    from repro_torch.data.pipeline import LMClusterData, batch_seed
    from repro_torch.data.synthetic import MarkovLM
    data = LMClusterData(MarkovLM(cfg.vocab_size, seed=0), LM_M * LM_K,
                         batch, seq, seed=0)
    gen = streams.sampler_generator(6, device)
    out = {}
    for r in range(LM_ROUNDS):
        for m in range(LM_M):
            b = {k: to_device(a, device) for k, a in data.cluster_batch(
                list(range(m * LM_K, (m + 1) * LM_K)),
                seed=batch_seed(0, r, m, 0)).items()}
            if cfg.encdec:
                b["frames"] = torch.randn(
                    (LM_K, batch, cfg.enc_seq, cfg.d_model), device=device,
                    generator=gen).to(getattr(torch, cfg.dtype))
            out[r, m] = b
    return out


def _fingerprint(state) -> list:
    """Per leaf of the state's ``dev`` and ``srv`` trees, an exact
    checksum of its bits weighted by position: the sum over elements of
    bits(x_i) * (2 i + 1) in wrapping int64, one a chunk of 2^22 elements
    (None for an empty leaf). A change to one element changes it, and so
    do opposite changes to two: the K clients' copies of a device leaf
    start equal, and one ulp up in one copy with one ulp down in the other
    leaves sums of the values and of their squares as they were."""
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    out = []
    for t in tree.leaves({"dev": state["dev"], "srv": state["srv"]}):
        sums = []
        for i, c in enumerate(t.reshape(-1).split(1 << 22)):
            w = torch.arange(i << 22, (i << 22) + c.numel(), device=c.device,
                             dtype=torch.int64) * 2 + 1
            sums.append((c.view(bits[c.dtype]).long() * w).sum())
        out.append(torch.stack(sums) if t.numel() else None)
    return out


def _first_step_updates(cp, state, batch) -> list:
    """For each nonempty parameter leaf (``dev`` then ``srv``, flatten
    order), from the gradient at the first step's state and batch,
    computed twice: the leaf path, whether the batch reaches it (a nonzero
    gradient), and whether its largest SGD update less the two gradients'
    largest difference is at least MOVE_ULPS ulps of its element's value
    (``must_move``). Chunks of 2^26 elements bound the transients."""
    from repro_torch.core.cpsl import _value_and_grad
    grads = []
    for _ in range(2):
        _, (g_dev, g_srv) = _value_and_grad(
            cp._total_loss, (state["dev"], state["srv"]), batch)
        grads.append(tree.leaves({"dev": g_dev, "srv": g_srv}))
        del g_dev, g_srv
    lr = {"dev": cp.ccfg.lr_device, "srv": cp.ccfg.lr_server}
    precision = {torch.float32: 24, torch.bfloat16: 8}
    out = []
    for (path, p), g, g2 in zip(
            tree.flatten_with_path({"dev": state["dev"],
                                    "srv": state["srv"]}), *grads):
        if not p.numel():
            continue
        ulps, rerun, g_max = 0.0, 0.0, 0.0
        for pc, gc, gc2 in zip(p.reshape(-1).split(1 << 26),
                               g.reshape(-1).split(1 << 26),
                               g2.reshape(-1).split(1 << 26)):
            _, e = torch.frexp(pc.float())
            # the gradient that moves p by one ulp
            unit = torch.ldexp(torch.ones_like(pc, dtype=torch.float32),
                               e - precision[p.dtype]) / lr[path[0]]
            ulps = max(ulps, float((gc.float().abs() / unit).max()))
            rerun = max(rerun, float(((gc.float() - gc2.float()).abs()
                                      / unit).max()))
            g_max = max(g_max, float(gc.abs().max()))
        out.append({"leaf": "/".join(map(str, path)), "reached": g_max > 0,
                    "must_move": ulps - rerun >= MOVE_ULPS})
    del grads
    torch.cuda.empty_cache()
    return out


@pytest.mark.parametrize("arch", LM_MODELS)
def test_split_lm_training_at_full_width(launched, cuda, arch):
    """Two rounds of ``CPSL.run_round``: each kernel launched as
    ``_lm_launches_per_step`` says a step (a Mamba model's conv and gated
    stages as often as K2, and the three backward kernels half that), every
    other kernel never; finite step losses, falling where the params are
    f32 (bf16 SGD can round a small update away); every parameter leaf
    reached by the first step, and moved by it where
    ``_first_step_updates`` says it must ("moved": its ``_fingerprint``
    changed); the exported model's forward finite."""
    kernel, impl, _, seq, batch, extra = LM_MODELS[arch]
    cfg = registry.get(arch).replace(**{
        "dtype": "bfloat16", "param_dtype": "float32", "remat": True,
        "loss_chunk": LM_LOSS_CHUNK, **impl, **extra})
    cp = CPSL(make_split_model(cfg, 1), CPSLConfig(
        cut_layer=1, n_clusters=LM_M, cluster_size=LM_K, local_epochs=1,
        batch_per_device=batch))
    state = cp.init_state(streams.model_generator(0, cuda))
    batches = _lm_batches(cfg, seq, batch, cuda)
    updates = _first_step_updates(cp, state, batches[0, 0])
    moved, losses = {"before": _fingerprint(state)}, []
    cluster_step = cp.cluster_step

    def recording_step(state, batch, lr_scale=None):
        state, mt = cluster_step(state, batch, lr_scale=lr_scale)
        losses.append(mt["loss"])
        if "after" not in moved:
            moved["after"] = _fingerprint(state)
        return state, mt

    cp.cluster_step = recording_step
    before = dict(launched)
    # run_round holds the only reference to the state it starts from, so
    # that state is freed after its first step (a reference kept here
    # would hold one more copy of the params: 16.8 GB for deepseek)
    held = [state]
    del state
    for rnd in range(LM_ROUNDS):
        held.append(cp.run_round(held.pop(),
                                 lambda m, _: batches[rnd, m])[0])
    state = held.pop()
    steps = LM_ROUNDS * LM_M
    assert {k: (launched[k] - before[k]) / steps for k in before} \
        == _lm_step_launches(cfg, kernel, 1)
    losses = [float(x) for x in losses]
    assert len(losses) == steps and np.isfinite(losses).all(), losses
    if cfg.param_dtype != "bfloat16":
        assert losses[-1] < losses[0], losses
    fp = [(a, b) for a, b in zip(moved["before"], moved["after"])
          if a is not None]
    assert len(fp) == len(updates)
    bad = [u for u, (a, b) in zip(updates, fp)
           if not u["reached"] or (u["must_move"] and torch.equal(a, b))]
    assert not bad, bad
    params, out_cfg = cp.export_params(state)
    del state, held
    b0 = batches[0, 0]
    fwd = {"tokens": b0["tokens"][0, :1, :64]}
    if cfg.encdec:
        fwd["frames"] = b0["frames"][0, :1]
    with torch.no_grad():
        logits, _ = api.forward(params, fwd, out_cfg)
    assert logits.shape == (1, 64, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def _grad_blocks(cfg, seq: int, device) -> list:
    """(label, init(generator, cfg), apply(params, x, cfg, positions) -> y,
    x's shape) for one block of each kind of the model: whisper's encoder
    block (enc_seq frames) and decoder block (``seq`` tokens over a fixed
    random memory of the frames: causal self-attention and non-causal
    cross-attention at Sq != Skv), else one block per layer spec."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models import whisper as whp
    d = cfg.d_model
    if cfg.encdec:
        memory = torch.randn((1, cfg.enc_seq, d), device=device,
                             generator=streams.sampler_generator(5, device)
                             ).to(getattr(torch, cfg.dtype))
        return [("encoder", whp._enc_block_init,
                 lambda p, x, c, pos: whp.enc_block_apply(p, x, c),
                 (1, cfg.enc_seq, d)),
                ("decoder", whp._dec_block_init,
                 lambda p, x, c, pos: whp.dec_block_apply(p, x, memory, c,
                                                          pos),
                 (1, seq, d))]
    return [(f"{s.mixer}_{s.ffn}_window{s.window}",
             lambda g, c, s=s: tfm.block_init(g, c, s),
             lambda p, x, c, pos, s=s: tfm.block_apply(p, x, c, s, pos)[0],
             (1, seq, d))
            for s in dict.fromkeys(cfg.layer_specs())]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_MODELS)
def test_block_grads_through_the_kernels_at_full_width(launched, cuda, arch,
                                                       dtype):
    """One block of each kind of the model at full width, B = 1, f32
    params: the per-leaf parameter gradients through the kernel's
    ``autograd.Function`` against the plain path's, within LM_GRAD_TOL of
    max(1, max|g|); the kernel launches on the kernel path and not on the
    plain path; no leaf's gradient is all zero. A MoE block's plain path
    replays the kernel path's routes (``_moe_routes``), so a routing flip
    is not read as a gradient error."""
    kernel, impl, plain, seq, _, extra = LM_MODELS[arch]
    c = registry.get(arch).replace(**extra).replace(param_dtype="float32",
                                                    dtype=dtype)
    for label, init, apply, shape in _grad_blocks(c, seq, cuda):
        params = init(streams.model_generator(3, cuda), c)
        gen = streams.sampler_generator(4, cuda)
        x = torch.randn(shape, device=cuda, generator=gen).to(
            getattr(torch, dtype))
        w = torch.randn(shape, device=cuda, generator=gen)
        pos = torch.arange(shape[1], device=cuda)
        grads, routes = [], []
        for kw in (impl, plain):
            p = tree.map(lambda t: t.detach().requires_grad_(), params)
            n = launched[kernel]
            with _moe_routes([] if kw is plain else routes,
                             replay=routes if kw is plain else None):
                y = apply(p, x, c.replace(**kw), pos)
            loss = (y.float() * w).sum() / shape[1]
            grads.append(torch.autograd.grad(loss, tree.leaves(p)))
            assert (launched[kernel] > n) == (kw is impl), (label, kw)
        err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                  for a, b in zip(*grads))
        zero = [i for i, g in enumerate(grads[0])
                if not bool(g.abs().max() > 0)]
        assert not zero and err <= LM_GRAD_TOL[kernel, dtype], \
            (label, err, zero)
        del params, grads, x, w, routes


def test_train_launcher_reduced_on_card(cuda, tmp_path):
    """``launch/train.py --arch gemma2-2b --reduced`` through
    ``CPSLTrainer`` on the card and its checkpoint: both rounds recorded,
    finite losses."""
    from repro_torch.launch import train as tlaunch
    hist = tlaunch.main(["--arch", "gemma2-2b", "--reduced", "--rounds",
                         "2", "--clusters", "2", "--cluster-size", "2",
                         "--ckpt-dir", str(tmp_path)])
    assert [h["round"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist), hist

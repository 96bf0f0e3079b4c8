"""CPSL — Cluster-based Parallel Split Learning (paper Alg. 1), in PyTorch;
the port of ``repro.core.cpsl`` up to the fused round.

"First-parallel-then-sequential": within a cluster, K device-side models
train in parallel against ONE shared server-side model fed the
concatenated smashed data (eqs. 4-7); after L local epochs the device-side
models are FedAvg-aggregated (eq. 8) and handed to the next cluster
(eq. 9).

Two train-step implementations:
  - ``fused``:    one backward pass through server and device models; the
                  chain rule is the smashed-gradient protocol.
  - ``protocol``: the explicit wire protocol — device FP -> smashed data ->
                  server FP/BP -> smashed gradient -> device BP.

Two orchestration levels:
  - ``run_round``:       one step per (cluster, local epoch) and one FedAvg
                         per cluster, batches from a host callback; one host
                         sync per round, for the loss.
  - ``run_round_fused``: the whole round in one call over a
                         device-resident dataset: batches are gathered on
                         the device from the (M, L, K, B) index table and
                         FedAvg runs at each cluster boundary. The call
                         never syncs with the host.

The state tree keeps the reference's leaf names, shapes and dtypes
(``step`` int32, ``dev`` K-stacked, ``dev_opt``, ``srv``, ``srv_opt``,
``rng`` uint32[2] and, with compression, ``ef``), so ``convert`` carries a
state across and checkpoints restore in either package.

Straggler dropout: the reference draws its keep mask with
``jax.random.bernoulli`` on ``state["rng"]``, which torch cannot
reproduce. The port takes an (M, K) keep table instead (``keep_table``
draws it on the host from the registered ``straggler`` stream), passed to
the looped and the fused round alike, so both see the same masks, the
fused round stays free of host syncs, and parity tests can pass the
reference's masks. ``rng`` is carried unchanged.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import optim, streams, tree
from repro_torch.configs.base import CPSLConfig
from repro_torch.core import compression as cmp
from repro_torch.core.splitting import SplitModel


def _flat(batch):
    return tree.map(lambda t: t.reshape((-1,) + tuple(t.shape[2:])), batch)


def _value_and_grad(fn, params, *rest):
    """``fn(*params, *rest) -> (scalar, aux)``; returns ``((scalar, aux),
    grads)`` with one gradient tree per tree of ``params``, like
    ``jax.value_and_grad(fn, argnums=(0, ..), has_aux=True)``."""
    params = [tree.map(lambda t: t.detach().requires_grad_(), a)
              for a in params]
    with torch.enable_grad():
        out, aux = fn(*params, *rest)
        flat = [leaf for a in params for leaf in tree.leaves(a)]
        grads = torch.autograd.grad(out, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    out_trees, i = [], 0
    for a in params:
        n = len(tree.leaves(a))
        out_trees.append(tree.unflatten_like(a, grads[i:i + n]))
        i += n
    aux = tree.map(lambda t: t.detach(), aux)
    return (out.detach(), aux), out_trees


def to_device(a, device, dtype=None) -> torch.Tensor:
    """A tensor on ``device``. A numpy array goes through pinned memory
    with a non-blocking copy, so handing a host table to the fused round
    does not sync the host with the card."""
    dev = torch.device(device)
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return t.to(device=dev, dtype=dtype)


class CPSL:
    def __init__(self, split: SplitModel, ccfg: CPSLConfig,
                 dev_opt: Optional[optim.Optimizer] = None,
                 srv_opt: Optional[optim.Optimizer] = None):
        self.split = split
        self.ccfg = ccfg
        self.dev_opt = dev_opt or optim.make(ccfg.optimizer, ccfg.lr_device,
                                             momentum=ccfg.momentum,
                                             weight_decay=ccfg.weight_decay)
        self.srv_opt = srv_opt or optim.make(ccfg.optimizer, ccfg.lr_server,
                                             momentum=ccfg.momentum,
                                             weight_decay=ccfg.weight_decay)
        self._step_fn = (self.fused_step_impl if ccfg.fused_step
                         else self.protocol_step_impl)

    # -- state --------------------------------------------------------------

    def init_state(self, generator: torch.Generator) -> dict:
        """A fresh state on the generator's device: device-side params
        drawn once and copied to every client row, then server params,
        then the two ``rng`` words."""
        dev_ = generator.device
        K = 1 if self.ccfg.share_device_params else self.ccfg.cluster_size
        dev0 = self.split.init_device(generator)
        dev = tree.map(
            lambda t: t[None].expand((K,) + tuple(t.shape)).contiguous(), dev0)
        srv = self.split.init_server(generator)
        words = torch.randint(0, 2 ** 32, (2,), generator=generator,
                              device=dev_, dtype=torch.int64)
        rng = torch.from_numpy(words.cpu().numpy().astype(np.uint32))
        state = {
            "step": torch.zeros((), dtype=torch.int32, device=dev_),
            "dev": dev,
            "dev_opt": self.dev_opt.init(dev),
            "srv": srv,
            "srv_opt": self.srv_opt.init(srv),
            "rng": rng.to(dev_),
        }
        if self.ccfg.compress_uploads != "none":
            state["ef"] = tree.map(
                lambda t: torch.zeros_like(t, dtype=torch.float32), dev)
        return state

    # -- loss ---------------------------------------------------------------

    def _clients(self, dev, batch):
        """The K-client device pass: (smashed (K, B, ...), aux (K,)).
        Batched over the K-stacked weights (``device_apply_clients``: one
        grouped convolution per conv layer), or a Python loop over
        clients with ``unroll_clients``."""
        if not self.ccfg.unroll_clients:
            return self.split.device_apply_clients(dev, batch)
        K = tree.leaves(dev)[0].shape[0]
        outs = [self.split.device_apply(tree.map(lambda t: t[k], dev),
                                        tree.map(lambda t: t[k], batch))
                for k in range(K)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    def _total_loss(self, dev, srv, batch):
        """batch leaves: (K, B, ...). Returns (scalar, metrics)."""
        flat = _flat(batch)
        if self.ccfg.share_device_params:
            smashed, aux_d = self.split.device_apply(
                tree.map(lambda t: t[0], dev), flat)
        else:
            smashed, aux_d = self._clients(dev, batch)
            # eq. (5): concatenate client smashed data into the server batch
            smashed = smashed.reshape((-1,) + tuple(smashed.shape[2:]))
            aux_d = aux_d.mean()
        loss, aux_s = self.split.server_loss(srv, smashed, flat)
        return loss + aux_d + aux_s, {"loss": loss, "aux": aux_d + aux_s}

    # -- fused step ----------------------------------------------------------

    def fused_step_impl(self, state, batch, lr_scale=None):
        """One backward pass through server and device models, then both
        optimizer steps. ``ccfg.microbatches`` > 1 splits the per-client
        batch B and accumulates gradients in the reference's order."""
        m = self.ccfg.microbatches
        if m > 1:
            mbs = tree.map(
                lambda t: t.reshape((t.shape[0], m, t.shape[1] // m)
                                    + tuple(t.shape[2:])).movedim(1, 0),
                batch)
            zeros = lambda tr: tree.map(  # noqa: E731
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), tr)
            g_dev, g_srv = zeros(state["dev"]), zeros(state["srv"])
            loss = aux = torch.zeros((), device=state["step"].device)
            for i in range(m):
                (_, mt), (gd, gs) = _value_and_grad(
                    self._total_loss, (state["dev"], state["srv"]),
                    tree.map(lambda t: t[i], mbs))
                g_dev = tree.map(lambda a, b: a + b / m, g_dev, gd)
                g_srv = tree.map(lambda a, b: a + b / m, g_srv, gs)
                loss = loss + mt["loss"] / m
                aux = aux + mt["aux"] / m
            metrics = {"loss": loss, "aux": aux}
        else:
            (_, metrics), (g_dev, g_srv) = _value_and_grad(
                self._total_loss, (state["dev"], state["srv"]), batch)
        new_dev, dev_opt = self.dev_opt.step(g_dev, state["dev_opt"],
                                             state["dev"], state["step"],
                                             lr_scale=lr_scale)
        new_srv, srv_opt = self.srv_opt.step(g_srv, state["srv_opt"],
                                             state["srv"], state["step"],
                                             lr_scale=lr_scale)
        state = dict(state, dev=new_dev, dev_opt=dev_opt, srv=new_srv,
                     srv_opt=srv_opt, step=state["step"] + 1)
        return state, metrics

    # -- explicit two-phase protocol step -------------------------------------

    def protocol_step_impl(self, state, batch, lr_scale=None):
        assert not self.ccfg.share_device_params
        split = self.split

        # Phase 1 (paper step 3, eq. 4): device FP -> smashed data
        with torch.no_grad():
            smashed, _ = self._clients(state["dev"], batch)
        smashed_flat = smashed.reshape((-1,) + tuple(smashed.shape[2:]))
        flat = _flat(batch)

        # Phase 2 (eqs. 5-6): server FP/BP; emits the smashed-data gradient
        def srv_loss(srv, sm):
            loss, aux = split.server_loss(srv, sm, flat)
            return loss + aux, loss

        (_, loss), (g_srv, g_smashed) = _value_and_grad(
            srv_loss, (state["srv"], smashed_flat))
        new_srv, srv_opt = self.srv_opt.step(g_srv, state["srv_opt"],
                                             state["srv"], state["step"],
                                             lr_scale=lr_scale)

        # Phase 3 (eq. 7): device BP from the smashed gradient
        dev = tree.map(lambda t: t.detach().requires_grad_(), state["dev"])
        with torch.enable_grad():
            out, _ = self._clients(dev, batch)
            g = torch.autograd.grad(out, tree.leaves(dev),
                                    grad_outputs=g_smashed.reshape(out.shape))
        g_dev = tree.unflatten_like(dev, g)
        new_dev, dev_opt = self.dev_opt.step(g_dev, state["dev_opt"],
                                             state["dev"], state["step"],
                                             lr_scale=lr_scale)
        state = dict(state, dev=new_dev, dev_opt=dev_opt, srv=new_srv,
                     srv_opt=srv_opt, step=state["step"] + 1)
        return state, {"loss": loss, "aux": torch.zeros_like(loss)}

    def cluster_step(self, state, batch):
        """One local epoch for the active cluster (paper Alg. 1 lines 7-19)."""
        return self._step_fn(state, batch)

    # -- aggregation (eq. 8) --------------------------------------------------

    def fedavg_impl(self, state, weights, keep=None):
        """Eq. (8): straggler dropout by the (K,) ``keep`` row, optional
        upload compression with error feedback, then the data-size
        weighted mean in f32, copied back to every client row."""
        ccfg = self.ccfg
        w = weights.float()
        if ccfg.straggler_dropout > 0:
            if keep is None:
                raise ValueError("straggler_dropout > 0 needs the keep "
                                 "table (CPSL.keep_table)")
            keep = keep.clone()
            keep[0] = True                      # never drop everyone
            w = w * keep
        dev = state["dev"]
        if ccfg.compress_uploads != "none":
            ref = tree.map(lambda t: t[:1], dev)   # broadcast model
            delta = tree.map(lambda t, r: t - r, dev, ref)
            delta, ef = cmp.apply_with_error_feedback(
                delta, state["ef"], ccfg.compress_uploads, ccfg.compress_topk)
            dev = tree.map(lambda r, d: r + d, ref, delta)
            state = dict(state, ef=ef)

        ww = w / torch.clamp_min(w.sum(), 1e-12)

        def avg(t):
            m = torch.tensordot(ww, t.float(), dims=([0], [0]))
            return m[None].to(t.dtype).expand(t.shape).contiguous()

        return dict(state, dev=tree.map(avg, dev))

    def fedavg(self, state, data_sizes=None, keep=None):
        """Eq. (8): weights are the per-client local data sizes |D_{m,k}|
        (uniform when ``data_sizes`` is None)."""
        if self.ccfg.share_device_params:
            return state   # single shared device model: nothing to average
        dev_ = state["step"].device
        K = self.ccfg.cluster_size
        w = (torch.ones((K,), device=dev_) if data_sizes is None
             else to_device(data_sizes, dev_, torch.float32))
        keep = None if keep is None else to_device(keep, dev_, torch.bool)
        return self.fedavg_impl(state, w, keep)

    def keep_table(self, seed: int, rnd: int, n_clusters: int) -> np.ndarray:
        """(M, K) bool straggler keep table for round ``rnd``: each client
        kept with probability 1 - ``straggler_dropout``, drawn on the host
        from the ``straggler`` stream."""
        rng = streams.straggler_rng(seed, rnd)
        u = rng.random((n_clusters, self.ccfg.cluster_size))
        return u < 1.0 - self.ccfg.straggler_dropout

    # -- round orchestration (Alg. 1 lines 2-24) ------------------------------

    def run_round(self, state, batch_fn: Callable[[int, int], dict],
                  n_clusters: Optional[int] = None, data_sizes=None,
                  keep=None) -> tuple:
        """batch_fn(m, l) -> batch with (K, B, ...) tensor leaves for
        cluster m, local epoch l. Clusters run sequentially (eq. 9).
        ``data_sizes``: optional (M, K) eq.-8 weights; ``keep``: the (M, K)
        straggler table. Syncs the host once, for the round's loss."""
        M = n_clusters or self.ccfg.n_clusters
        losses = []
        for m in range(M):
            for l in range(self.ccfg.local_epochs):  # noqa: E741
                state, mt = self.cluster_step(state, batch_fn(m, l))
                losses.append(mt["loss"])
            state = self.fedavg(
                state, None if data_sizes is None else data_sizes[m],
                None if keep is None else keep[m])
        return state, {"loss": float(torch.stack(losses).mean())}

    def run_round_fused(self, state, data, idx, weights=None,
                        keep=None) -> tuple:
        """One CPSL round in one call, with no host sync.

        ``data``     dict of device-resident dataset tensors, leading dim =
                     sample count (``DeviceResidentDataset.data``).
        ``idx``      (M, L, K, B) int32 global sample indices — the draws
                     the looped path's ``cluster_batch`` would make
                     (``DeviceResidentDataset.round_index_table``);
                     batches are gathered on the device.
        ``weights``  (M, K) eq.-8 data sizes (uniform when None).
        ``keep``     (M, K) straggler keep table (``keep_table``).

        Host arrays are uploaded without a sync (``to_device``). Returns
        ``(state, {"loss": scalar, "losses": (M*L,)})`` as device
        tensors."""
        dev_ = state["step"].device
        idx = to_device(idx, dev_)
        M, L, K, B = idx.shape
        assert L == self.ccfg.local_epochs, (L, self.ccfg.local_epochs)
        weights = (torch.ones((M, K), device=dev_) if weights is None
                   else to_device(weights, dev_, torch.float32))
        keep = None if keep is None else to_device(keep, dev_, torch.bool)
        losses = []
        for m in range(M):
            for l in range(L):  # noqa: E741
                rows = idx[m, l].reshape(-1)
                batch = {k: v.index_select(0, rows).reshape(
                    (K, B) + tuple(v.shape[1:])) for k, v in data.items()}
                state, mt = self.cluster_step(state, batch)
                losses.append(mt["loss"])
            if not self.ccfg.share_device_params:
                state = self.fedavg_impl(state, weights[m],
                                         None if keep is None else keep[m])
        losses = torch.stack(losses)
        return state, {"loss": losses.mean(), "losses": losses}

    # -- evaluation and export ------------------------------------------------

    @torch.no_grad()
    def _eval_impl(self, state, eval_data):
        dev0 = tree.map(lambda t: t[0], state["dev"])
        return self.split.eval_metrics(dev0, state["srv"], eval_data)

    def export_params(self, state):
        dev0 = tree.map(lambda t: t[0], state["dev"])
        return self.split.export(dev0, state["srv"])

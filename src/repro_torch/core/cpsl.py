"""CPSL — Cluster-based Parallel Split Learning (paper Alg. 1), in PyTorch;
the port of ``repro.core.cpsl``.

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

Three orchestration levels:
  - ``run_round``:       one step per (cluster, local epoch) and one FedAvg
                         per cluster, batches from a host callback; one host
                         sync per round, for the loss.
  - ``run_round_fused``: the whole round in one call over a
                         device-resident dataset: batches are gathered on
                         the device from the (M, L, K, B) index table and
                         FedAvg runs at each cluster boundary. The call
                         never syncs with the host.
  - ``run_training_fused`` / ``run_fleet``: the whole R-round training
                         curve in one call, with eval on the device at the
                         reference's schedule, and its batched form over E
                         experiment replicas whose seeds, shard tables,
                         eq.-8 weights, lr scales and padded layouts all
                         enter as tensors. The replica axis is batched,
                         not looped: one device pass over the flattened
                         (E*K) client axis (grouped convolution, groups =
                         E*K, or one batched matmul), one server pass over
                         E (``SplitModel.server_loss_replicas``), one
                         FedAvg reduction over (E, K), and optimizer steps
                         on the E-stacked leaves. All three share one
                         masked cluster body (``_cluster_scan``).

The state tree keeps the reference's leaf names, shapes and dtypes
(``step`` int32, ``dev`` K-stacked, ``dev_opt``, ``srv``, ``srv_opt``,
``rng`` uint32[2] and, with compression, ``ef``), so ``convert`` carries a
state across and checkpoints restore in either package. A fleet state
stacks E such states on a leading axis of every leaf.

Straggler dropout: the reference draws its keep mask with
``jax.random.bernoulli`` on ``state["rng"]``, which torch cannot
reproduce. The port takes an (M, K) keep table instead (``keep_table``
draws it on the host from the registered ``straggler`` stream), passed to
the looped and the fused round alike ((R, M, K) for a curve, (E, R, M, K)
for a fleet), so all paths see the same masks, they stay free of host
syncs, and parity tests can pass the reference's masks. ``rng`` is
carried unchanged.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import optim, resolve_device, streams, tree
from repro_torch.configs.base import CPSLConfig
from repro_torch.core import compression as cmp
from repro_torch.core.splitting import SplitModel


def _merge(t: torch.Tensor, n: int) -> torch.Tensor:
    """Axes n and n + 1 (clients and samples) merged into one."""
    return t.reshape(tuple(t.shape[:n]) + (-1,) + tuple(t.shape[n + 2:]))


def _flat(batch, fleet: bool = False):
    """(K, B, ...) -> (K*B, ...); with ``fleet``, (E, K, B, ...) -> (E,
    K*B, ...)."""
    return tree.map(lambda t: _merge(t, int(fleet)), batch)


def _at(t: torch.Tensor, i: int, fleet: bool) -> torch.Tensor:
    """Row ``i`` of the axis after the replica axis (a fleet's) or of the
    first axis."""
    return t[:, i] if fleet else t[i]


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


def to_device(a, device, dtype=None) -> Optional[torch.Tensor]:
    """A tensor on ``device`` (``None`` stays ``None``). A numpy array or
    a Python scalar goes through pinned memory with a non-blocking copy,
    so handing a host table to the fused paths does not sync the host
    with the card."""
    dev = torch.device(device)
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device=dev, dtype=dtype)
    arr = np.asarray(a)
    t = torch.from_numpy(arr if arr.flags.c_contiguous
                         else np.ascontiguousarray(arr))
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

    def init_fleet_state(self, seeds, device="cuda") -> dict:
        """Stacked per-replica states on ``device`` (``cuda`` unless the
        caller asks for ``cpu``; no CUDA raises): replica r is
        ``init_state(streams.model_generator(seeds[r], device))``."""
        dev_ = resolve_device(device)
        states = [self.init_state(streams.model_generator(int(s), dev_))
                  for s in seeds]
        return tree.map(lambda *ts: torch.stack(ts), *states)

    # -- loss ---------------------------------------------------------------

    def _clients(self, dev, batch, fleet: bool = False):
        """The K-client device pass: (smashed (K, B, ...), aux (K,)).
        Batched over the K-stacked weights (``device_apply_clients``: one
        grouped convolution per conv layer), or a Python loop over
        clients with ``unroll_clients``. With ``fleet`` the leaves carry
        a replica axis first, (E, K, ...), and the pass runs once over
        the flattened (E*K) client axis (always batched)."""
        if fleet:
            E, K = tree.leaves(dev)[0].shape[:2]
            smashed, aux = self.split.device_apply_clients(
                tree.map(lambda t: _merge(t, 0), dev),
                tree.map(lambda t: _merge(t, 0), batch))
            return (smashed.reshape((E, K) + tuple(smashed.shape[1:])),
                    aux.reshape(E, K))
        if not self.ccfg.unroll_clients:
            return self.split.device_apply_clients(dev, batch)
        outs = [self.split.device_apply(d, b)
                for d, b in zip(tree.unbind(dev), tree.unbind(batch))]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    def _server_loss(self, srv, smashed, flat, fleet: bool = False):
        if fleet:
            return self.split.server_loss_replicas(srv, smashed, flat)
        return self.split.server_loss(srv, smashed, flat)

    def _total_loss(self, dev, srv, batch, fleet: bool = False):
        """batch leaves: (K, B, ...), or (E, K, B, ...) with ``fleet``.
        Returns (scalar, metrics); a fleet's scalar is the sum of the E
        replicas' losses, whose parameters are disjoint, so each
        replica's gradient is exactly its own, and its metrics are
        (E,)."""
        flat = _flat(batch, fleet)
        n = int(fleet)
        if self.ccfg.share_device_params:
            dev0 = tree.map(lambda t: t.select(n, 0), dev)
            if fleet:
                smashed, aux_d = self.split.device_apply_clients(dev0, flat)
            else:
                smashed, aux_d = self.split.device_apply(dev0, flat)
        else:
            smashed, aux_d = self._clients(dev, batch, fleet)
            # eq. (5): concatenate client smashed data into the server batch
            smashed = _merge(smashed, n)
            aux_d = aux_d.mean(-1)
        loss, aux_s = self._server_loss(srv, smashed, flat, fleet)
        total = loss + aux_d + aux_s
        return (total.sum() if fleet else total,
                {"loss": loss, "aux": aux_d + aux_s})

    # -- fused step ----------------------------------------------------------

    def fused_step_impl(self, state, batch, lr_scale=None,
                        fleet: bool = False):
        """One backward pass through server and device models, then both
        optimizer steps. ``ccfg.microbatches`` > 1 splits the per-client
        batch B and accumulates gradients in the reference's order.
        ``lr_scale``: an lr multiplier, (E,) for a fleet."""
        m = self.ccfg.microbatches
        ax = 1 + int(fleet)                      # the B axis
        if m > 1:
            mbs = tree.map(
                lambda t: t.reshape(tuple(t.shape[:ax]) + (m, t.shape[ax] // m)
                                    + tuple(t.shape[ax + 1:])).movedim(ax, 0),
                batch)
            zeros = lambda tr: tree.map(  # noqa: E731
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), tr)
            g_dev, g_srv = zeros(state["dev"]), zeros(state["srv"])
            loss = aux = torch.zeros(state["step"].shape,
                                     device=state["step"].device)
            for i in range(m):
                (_, mt), (gd, gs) = _value_and_grad(
                    self._total_loss, (state["dev"], state["srv"]),
                    tree.map(lambda t: t[i], mbs), fleet)
                g_dev = tree.map(lambda a, b: a + b / m, g_dev, gd)
                g_srv = tree.map(lambda a, b: a + b / m, g_srv, gs)
                loss = loss + mt["loss"] / m
                aux = aux + mt["aux"] / m
            metrics = {"loss": loss, "aux": aux}
        else:
            (_, metrics), (g_dev, g_srv) = _value_and_grad(
                self._total_loss, (state["dev"], state["srv"]), batch, fleet)
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

    def protocol_step_impl(self, state, batch, lr_scale=None,
                           fleet: bool = False):
        assert not self.ccfg.share_device_params

        # Phase 1 (paper step 3, eq. 4): device FP -> smashed data
        with torch.no_grad():
            smashed, _ = self._clients(state["dev"], batch, fleet)
        smashed_flat = _merge(smashed, int(fleet))
        flat = _flat(batch, fleet)

        # Phase 2 (eqs. 5-6): server FP/BP; emits the smashed-data gradient
        def srv_loss(srv, sm):
            loss, aux = self._server_loss(srv, sm, flat, fleet)
            total = loss + aux
            return (total.sum() if fleet else total), loss

        (_, loss), (g_srv, g_smashed) = _value_and_grad(
            srv_loss, (state["srv"], smashed_flat))
        new_srv, srv_opt = self.srv_opt.step(g_srv, state["srv_opt"],
                                             state["srv"], state["step"],
                                             lr_scale=lr_scale)

        # Phase 3 (eq. 7): device BP from the smashed gradient
        dev = tree.map(lambda t: t.detach().requires_grad_(), state["dev"])
        with torch.enable_grad():
            out, _ = self._clients(dev, batch, fleet)
            g = torch.autograd.grad(out, tree.leaves(dev),
                                    grad_outputs=g_smashed.reshape(out.shape))
        g_dev = tree.unflatten_like(dev, g)
        new_dev, dev_opt = self.dev_opt.step(g_dev, state["dev_opt"],
                                             state["dev"], state["step"],
                                             lr_scale=lr_scale)
        state = dict(state, dev=new_dev, dev_opt=dev_opt, srv=new_srv,
                     srv_opt=srv_opt, step=state["step"] + 1)
        return state, {"loss": loss, "aux": torch.zeros_like(loss)}

    def cluster_step(self, state, batch, lr_scale=None):
        """One local epoch for the active cluster (paper Alg. 1 lines 7-19)."""
        return self._step_fn(state, batch, lr_scale=lr_scale)

    # -- aggregation (eq. 8) --------------------------------------------------

    def fedavg_impl(self, state, weights, keep=None, fleet: bool = False):
        """Eq. (8): straggler dropout by the (K,) ``keep`` row, optional
        upload compression with error feedback, then the data-size
        weighted mean in f32, copied back to every client row. With
        ``fleet``, ``weights``/``keep`` are (E, K) and every leaf is
        (E, K, ...): each replica averages its own clients."""
        ccfg = self.ccfg
        n = int(fleet)
        w = weights.float()
        if ccfg.straggler_dropout > 0:
            if keep is None:
                raise ValueError("straggler_dropout > 0 needs the keep "
                                 "table (CPSL.keep_table)")
            keep = keep.clone()
            keep[..., 0] = True                 # never drop everyone
            w = w * keep
        dev = state["dev"]
        if ccfg.compress_uploads != "none":
            ref = tree.map(lambda t: t.narrow(n, 0, 1), dev)  # broadcast model
            delta = tree.map(lambda t, r: t - r, dev, ref)
            delta, ef = cmp.apply_with_error_feedback(
                delta, state["ef"], ccfg.compress_uploads, ccfg.compress_topk,
                lead=n)
            dev = tree.map(lambda r, d: r + d, ref, delta)
            state = dict(state, ef=ef)

        ww = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-12)

        def avg(t):
            if fleet:        # per replica: (1, K) x (K, rest)
                m = torch.bmm(ww[:, None, :], t.float().reshape(
                    t.shape[0], t.shape[1], -1)).reshape(
                    (t.shape[0], 1) + tuple(t.shape[2:]))
            else:
                m = torch.tensordot(ww, t.float(), dims=([0], [0]))[None]
            return m.to(t.dtype).expand(t.shape).contiguous()

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

    def keep_table(self, seed: int, rnd: int, n_clusters: int,
                   cluster_size: Optional[int] = None) -> np.ndarray:
        """(M, K) bool straggler keep table for round ``rnd``: each client
        kept with probability 1 - ``straggler_dropout``, drawn on the host
        from the ``straggler`` stream. ``cluster_size`` defaults to the
        config's (a fleet draws each replica at its own layout)."""
        K = self.ccfg.cluster_size if cluster_size is None else cluster_size
        rng = streams.straggler_rng(seed, rnd)
        u = rng.random((n_clusters, K))
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
        state, losses = self._cluster_scan(
            state, data, idx, weights,
            keep=to_device(keep, dev_, torch.bool))
        losses = losses.reshape(M * L)
        return state, {"loss": losses.mean(), "losses": losses}

    def _cluster_scan(self, state, data, idx, weights, cluster_mask=None,
                      client_mask=None, lr_scale=None, keep=None,
                      fleet: bool = False):
        """One round over the cluster axis; the shared body of
        ``run_round_fused``, ``run_training_fused`` and ``run_fleet``.
        Every argument is a tensor on the state's device. Returns
        ``(state, losses)`` with losses (M, L), or (E, M, L) for a fleet.

        Shapes: ``idx`` (M, L, K, B), ``weights`` and ``keep`` (M, K),
        ``cluster_mask`` (M,), ``client_mask`` (M, K); a fleet (``fleet``)
        adds a leading E to each and to every state leaf, and its
        ``lr_scale`` is (E,).

        ``cluster_mask``: a padded cluster slot runs (the fleet's replicas
        share one program) but its whole update — step counter, rng and
        optimizer state included — is discarded, so a replica with fewer
        real clusters than the padded layout reproduces its solo run; its
        losses come back NaN. ``client_mask`` enters the batch as the
        per-sample ``sample_weight``: padded client rows carry exactly
        zero loss weight, and their eq.-8 weight is multiplied by the
        mask, so neither the server's gradients nor FedAvg see their
        data. Padded rows gather index 0, a real sample, so their loss is
        finite and the zero weight removes it exactly."""
        n = int(fleet)
        M, L = idx.shape[n:n + 2]
        masked = cluster_mask is not None or client_mask is not None
        if masked:
            lead = tuple(idx.shape[:n])
            if cluster_mask is None:
                cluster_mask = torch.ones(lead + (M,), dtype=torch.bool,
                                          device=idx.device)
            if client_mask is None:
                client_mask = torch.ones(lead + (M, idx.shape[n + 2]),
                                         dtype=torch.bool, device=idx.device)
        out = []
        for m in range(M):
            st_in = state
            w = _at(weights, m, fleet)                       # ([E,] K)
            if masked:
                km = _at(client_mask, m, fleet)              # ([E,] K)
                w = w * km.to(w.dtype)
            losses = []
            for l in range(L):  # noqa: E741
                rows = _at(_at(idx, m, fleet), l, fleet)     # ([E,] K, B)
                batch = {k: v.index_select(0, rows.reshape(-1)).reshape(
                    tuple(rows.shape) + tuple(v.shape[1:]))
                    for k, v in data.items()}
                if masked:
                    # reserved key: only losses that implement the
                    # per-sample-weight semantics read it (lenet)
                    batch["sample_weight"] = km[..., None].expand(
                        rows.shape).float()
                state, mt = self._step_fn(state, batch, lr_scale=lr_scale,
                                          fleet=fleet)
                losses.append(mt["loss"])
            if not self.ccfg.share_device_params:
                state = self.fedavg_impl(
                    state, w, None if keep is None else _at(keep, m, fleet),
                    fleet)
            losses = torch.stack(losses, -1)                 # ([E,] L)
            if masked:
                cm = _at(cluster_mask, m, fleet)             # ([E,])
                state = tree.map(
                    lambda a, b: b if a is b
                    else torch.where(optim.per_replica(cm, a), a, b),
                    state, st_in)
                losses = torch.where(optim.per_replica(cm, losses), losses,
                                     float("nan"))
            out.append(losses)
        return state, torch.stack(out, n)

    # -- fused training curve (R rounds in one call) --------------------------

    @torch.no_grad()
    def _eval_impl(self, state, eval_data, fleet: bool = False):
        if fleet:
            dev0 = tree.map(lambda t: t[:, 0], state["dev"])
            return self.split.eval_metrics_replicas(dev0, state["srv"],
                                                    eval_data)
        dev0 = tree.map(lambda t: t[0], state["dev"])
        return self.split.eval_metrics(dev0, state["srv"], eval_data)

    def eval_rounds(self, rounds: int, eval_every: int):
        """The eval schedule: every ``eval_every`` rounds plus the final
        round."""
        if not eval_every:
            return []
        return [r for r in range(rounds)
                if (r + 1) % eval_every == 0 or r == rounds - 1]

    def _training_impl(self, state, data, idx, weights, lr_scale, eval_data,
                       cluster_mask, client_mask, eval_every, keep,
                       fleet: bool = False):
        """R rounds of ``_cluster_scan`` as a Python loop over the round
        axis (``idx`` (R, ...), or (E, R, ...) for a fleet; ``keep``
        likewise), eval on the device after each scheduled round."""
        n = int(fleet)
        R = idx.shape[n]
        do_eval = bool(eval_every) and eval_data is not None
        ev_rounds = set(self.eval_rounds(R, eval_every))
        loss_list, eval_list = [], []
        for r in range(R):
            state, lm = self._cluster_scan(
                state, data, _at(idx, r, fleet), weights, cluster_mask,
                client_mask, lr_scale,
                None if keep is None else _at(keep, r, fleet), fleet)
            loss_list.append(lm)
            if do_eval and r in ev_rounds:
                eval_list.append(self._eval_impl(state, eval_data, fleet))
        losses = torch.stack(loss_list, n)                   # ([E,] R, M, L)
        evals = ({k: torch.stack([e[k] for e in eval_list], -1)
                  for k in eval_list[0]} if eval_list else None)
        if cluster_mask is None:
            loss = losses.mean(dim=(-2, -1))                 # ([E,] R)
        else:
            keep_m = cluster_mask.unsqueeze(n).unsqueeze(-1)  # ([E,] 1, M, 1)
            real = torch.clamp_min(
                cluster_mask.sum(-1, keepdim=True) * losses.shape[-1], 1)
            loss = (torch.where(keep_m, losses, 0.0).sum(dim=(-2, -1))
                    / real)
        return state, losses, loss, evals

    def _check_curve(self, L, R, eval_every, eval_data, client_mask):
        assert L == self.ccfg.local_epochs, (L, self.ccfg.local_epochs)
        if client_mask is not None:
            assert self.split.masked_loss, \
                "client_mask needs a SplitModel whose server_loss " \
                "implements the sample_weight semantics (lenet)"
        if eval_every:
            assert self.split.eval_metrics is not None, \
                "eval_every > 0 needs a SplitModel with eval_metrics"
            assert eval_data is not None, "eval_every > 0 needs eval_data"
            if self.ccfg.scan_rounds:
                assert R % eval_every == 0, \
                    "scan_rounds needs eval_every to divide rounds"

    def run_training_fused(self, state, data, idx, weights=None, *,
                           lr_scale=None, eval_data=None, eval_every=0,
                           cluster_mask=None, client_mask=None,
                           keep=None) -> tuple:
        """A full R-round training curve in one call: the fused round body
        of ``run_round_fused`` repeated over the round axis, with the
        test-set evaluation at the reference's schedule kept on the
        device — no host sync anywhere in the curve.

        ``idx``      (R, M, L, K, B) int32 index tables — row r is
                     ``DeviceResidentDataset.round_index_table`` for round
                     r (``training_index_table`` builds the stack), so
                     round r reproduces the looped ``run_round_fused``.
        ``weights``  (M, K) eq.-8 data sizes, fixed across rounds
                     (uniform when None).
        ``lr_scale`` optional lr multiplier (a scalar or 0-d tensor).
        ``eval_data``device-resident eval batch
                     (``DeviceResidentDataset.eval_data``), evaluated via
                     ``SplitModel.eval_metrics`` every ``eval_every``
                     rounds plus the final round (``eval_rounds``).
        ``cluster_mask`` (M,) / ``client_mask`` (M, K): padded-layout
                     masks, see ``_cluster_scan``.
        ``keep``     (R, M, K) straggler keep tables.

        Host arrays are uploaded without a sync. Returns ``(state,
        metrics)``: ``losses`` (R, M*L) (NaN on padded cluster slots),
        ``loss`` (R,) per-round means over real slots, and with eval,
        ``eval`` (a dict of (n_evals,) curves) and ``eval_rounds``."""
        dev_ = state["step"].device
        idx = to_device(idx, dev_)
        R, M, L, K, B = idx.shape
        self._check_curve(L, R, eval_every, eval_data, client_mask)
        weights = (torch.ones((M, K), device=dev_) if weights is None
                   else to_device(weights, dev_, torch.float32))
        if lr_scale is not None and not isinstance(lr_scale, torch.Tensor):
            lr_scale = np.float32(lr_scale)
        state, losses, loss, evals = self._training_impl(
            state, data, idx, weights, to_device(lr_scale, dev_), eval_data,
            to_device(cluster_mask, dev_, torch.bool),
            to_device(client_mask, dev_, torch.bool), int(eval_every),
            to_device(keep, dev_, torch.bool))
        metrics = {"losses": losses.reshape(R, M * L), "loss": loss}
        if evals is not None:
            metrics["eval"] = evals
            metrics["eval_rounds"] = self.eval_rounds(R, eval_every)
        return state, metrics

    # -- experiment fleet (E replicas x R rounds, one batched program) --------

    def run_fleet(self, states, data, idx, weights=None, *, lr_scale=None,
                  eval_data=None, eval_every=0, cluster_mask=None,
                  client_mask=None, keep=None) -> tuple:
        """E whole training curves as one batched program over the
        replica axis. Replicas differ only in data — seeds (``states``
        rows), non-IID shard draws (``idx`` tables), eq.-8 ``weights``,
        per-replica ``lr_scale``, and padded-layout masks — and every
        step runs once for all of them (module docstring).

        ``states``   stacked replica states (``init_fleet_state``); the
                     fleet runs on their device.
        ``idx``      (E, R, M, L, K, B); per-replica layouts padded to
                     the common (M, K) with ``cluster_mask`` (E, M) /
                     ``client_mask`` (E, M, K) marking real slots
                     (``data.pipeline.fleet_plan`` builds all of these).
        ``weights``  (E, M, K) (uniform when None).
        ``lr_scale`` (E,) per-replica lr multipliers.
        ``eval_data``one device-resident eval batch shared by all
                     replicas.
        ``keep``     (E, R, M, K) straggler keep tables.

        Contract (tests/test_torch_fleet.py): replica r equals the solo
        ``run_training_fused`` run with seed r at the same layout and lr
        (integer leaves bit-exact, floats to the stated tolerance), and
        perturbing a padded slot leaves every output bit-identical.
        Returns ``(states, metrics)``: ``losses`` (E, R, M*L), ``loss``
        (E, R), and with eval ``eval`` ((E, n_evals) curves) and
        ``eval_rounds``."""
        dev_ = states["step"].device
        idx = to_device(idx, dev_)
        E, R, M, L, K, B = idx.shape
        self._check_curve(L, R, eval_every, eval_data, client_mask)
        if eval_every:
            assert self.split.eval_metrics_replicas is not None, \
                "eval_every > 0 needs a SplitModel with eval_metrics_replicas"
        weights = (torch.ones((E, M, K), device=dev_) if weights is None
                   else to_device(weights, dev_, torch.float32))
        if lr_scale is not None:
            if not isinstance(lr_scale, torch.Tensor):
                lr_scale = np.asarray(lr_scale, np.float32)
            assert tuple(lr_scale.shape) == (E,), lr_scale.shape
        states, losses, loss, evals = self._training_impl(
            states, data, idx, weights,
            to_device(lr_scale, dev_, torch.float32), eval_data,
            to_device(cluster_mask, dev_, torch.bool),
            to_device(client_mask, dev_, torch.bool), int(eval_every),
            to_device(keep, dev_, torch.bool), fleet=True)
        metrics = {"losses": losses.reshape(E, R, M * L), "loss": loss}
        if evals is not None:
            metrics["eval"] = evals
            metrics["eval_rounds"] = self.eval_rounds(R, eval_every)
        return states, metrics

    # -- export ---------------------------------------------------------------

    def export_params(self, state):
        dev0 = tree.map(lambda t: t[0], state["dev"])
        return self.split.export(dev0, state["srv"])


# --------------------------------------------------------------------------
# FL comparator (the paper's v = V degenerate case)
# --------------------------------------------------------------------------

class FLTrainer:
    """All devices train the FULL model locally; FedAvg each round.

    The N device models are stacked on a leading axis and train as one
    clients pass: ``loss_fn(params_N, batch_N)`` returns the (N,)
    per-device losses (``models.lenet.loss_fn_clients``), where the
    reference vmaps a one-device loss."""

    def __init__(self, loss_fn: Callable, init_fn: Callable, n_devices: int,
                 lr: float = 0.1, local_steps: int = 1):
        self.loss_fn, self.init_fn = loss_fn, init_fn
        self.N, self.lr, self.local_steps = n_devices, lr, local_steps

    def init_state(self, generator: torch.Generator):
        p0 = self.init_fn(generator)
        return {"params": tree.map(
            lambda t: t[None].expand((self.N,) + tuple(t.shape)).contiguous(),
            p0)}

    def round(self, state, batches):
        """batches leaves: (N, local_steps, B, ...). Returns the averaged
        state and the mean local loss (a device scalar)."""
        def loss(params, b):
            per = self.loss_fn(params, b)
            return per.sum(), per

        params, losses = state["params"], []
        for s in range(self.local_steps):
            b = tree.map(lambda t: t[:, s], batches)
            (_, per), (g,) = _value_and_grad(loss, (params,), b)
            params = tree.map(lambda p, gg: p - self.lr * gg, params, g)
            losses.append(per)
        avg = tree.map(
            lambda t: t.mean(0, keepdim=True).to(t.dtype).expand(t.shape)
            .contiguous(), params)
        return {"params": avg}, torch.stack(losses, -1).mean()

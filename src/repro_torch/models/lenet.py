"""The paper's 12-layer chain-topology LeNet (Table III), in PyTorch.

| 1 CONV1 32@3x3 | 2 CONV2 32@3x3 | 3 POOL1 2x2 | 4 CONV3 64@3x3 |
| 5 CONV4 64@3x3 | 6 POOL2 2x2 | 7 CONV5 128@3x3 | 8 CONV6 128@3x3 |
| 9 POOL3 2x2 | 10 FC1 382 | 11 FC2 192 | 12 FC3 10 |

VALID padding for CONV1-4 and SAME for CONV5-6, as in the reference
(``repro.models.lenet``). Layouts at every public function are the
reference's: HWIO conv weights, ``(d_in, d_out)`` dense weights, and NHWC
images and smashed data, so parameters and activations convert between
the packages unchanged. ``F.conv2d`` wants OIHW weights and NCHW inputs:
``_apply_layer`` permutes both (an NHWC tensor seen as NCHW is torch's
``channels_last``, which cuDNN takes as it is) and permutes the result
back. FC1 flattens the NHWC map in h, w, c order.

Every layer's output is a valid smashed-data tensor, so CPSL can cut at
any v: ``apply_range(params, x, lo, hi)`` runs layers [lo, hi).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

LAYERS = ["CONV1", "CONV2", "POOL1", "CONV3", "CONV4", "POOL2",
          "CONV5", "CONV6", "POOL3", "FC1", "FC2", "FC3"]
N_LAYERS = len(LAYERS)
_CONV = {"CONV1": (1, 32, "VALID"), "CONV2": (32, 32, "VALID"),
         "CONV3": (32, 64, "VALID"), "CONV4": (64, 64, "VALID"),
         "CONV5": (64, 128, "SAME"), "CONV6": (128, 128, "SAME")}
_FC = {"FC1": 382, "FC2": 192, "FC3": 10}


def layer_shapes(input_hw: int = 28) -> list:
    """Per-layer output shapes (H, W, C) or (F,), following Table III."""
    h, c = input_hw, 1
    shapes = []
    for name in LAYERS:
        if name.startswith("CONV"):
            cin, cout, pad = _CONV[name]
            if pad == "VALID":
                h = h - 2
            c = cout
            shapes.append((h, h, c))
        elif name.startswith("POOL"):
            h = h // 2
            shapes.append((h, h, c))
        else:
            shapes.append((_FC[name],))
    return shapes


def init(generator: torch.Generator, input_hw: int = 28) -> dict:
    """The reference's distributions (``lenet.py:53-81``): conv weights
    N(0, 1/(9 cin)), dense weights N(0, 1/fan_in), zero biases, on the
    generator's device. Torch cannot reproduce JAX's threefry draws, so
    parity tests take the reference's parameters through ``convert``."""
    dev = generator.device
    params = {}
    h, c, flat = input_hw, 1, None
    for name in LAYERS:
        if name.startswith("CONV"):
            cin, cout, pad = _CONV[name]
            w = torch.randn((3, 3, cin, cout), generator=generator,
                            device=dev) / math.sqrt(9 * cin)
            params[name] = {"w": w, "b": torch.zeros(cout, device=dev)}
            if pad == "VALID":
                h -= 2
            c = cout
        elif name.startswith("POOL"):
            h //= 2
        else:
            if flat is None:
                flat = h * h * c
            fout = _FC[name]
            w = torch.randn((flat, fout), generator=generator,
                            device=dev) / math.sqrt(flat)
            params[name] = {"w": w, "b": torch.zeros(fout, device=dev)}
            flat = fout
    return params


def conv_im2col(x, w, b, pad):
    """3x3 conv as im2col + matmul: 9 shifted slices concatenated into
    patch rows (NHWC, in the reference's (di, dj, c) order), one product
    against the HWIO kernel flattened to (9 C, O)."""
    B, H, W, C = x.shape
    if pad == "SAME":
        x = F.pad(x, (0, 0, 1, 1, 1, 1))
        Ho, Wo = H, W
    else:
        Ho, Wo = H - 2, W - 2
    cols = torch.cat([x[:, di:di + Ho, dj:dj + Wo, :] for di in range(3)
                      for dj in range(3)], -1)            # (B, Ho, Wo, 9C)
    y = cols.reshape(B, Ho * Wo, 9 * C) @ w.to(x.dtype).reshape(9 * C, -1)
    return y.reshape(B, Ho, Wo, -1) + b.to(x.dtype)


def _conv_direct(x, w, b, pad):
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1 if pad == "SAME" else 0)
    return y.permute(0, 2, 3, 1) + b.to(x.dtype)


def _apply_layer(params, x, name, conv_impl="direct"):
    if name.startswith("CONV"):
        _, _, pad = _CONV[name]
        p = params[name]
        conv = conv_im2col if conv_impl == "im2col" else _conv_direct
        return torch.relu(conv(x, p["w"], p["b"], pad))
    if name.startswith("POOL"):
        # 2x2/stride-2 max-pool as reshape + amax, as the reference writes
        # it: amax's backward splits the cotangent evenly among tied maxima
        # (ReLU zeros are common), as XLA's reduce-max transpose does;
        # F.max_pool2d would route it to one index. Odd maps drop the rim.
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = x[:, :H - H % 2, :W - W % 2]
            B, H, W, C = x.shape
        return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))
    p = params[name]
    if x.dim() > 2:
        x = x.reshape(x.shape[0], -1)        # NHWC: h, w, c order
    y = x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)
    return torch.relu(y) if name != "FC3" else y


def apply_range(params: dict, x: torch.Tensor, lo: int, hi: int,
                conv_impl: str = "direct"):
    """Run layers [lo, hi). x: (B, 28, 28, 1) if lo == 0, else the
    smashed data (NHWC or (B, F))."""
    for name in LAYERS[lo:hi]:
        x = _apply_layer(params, x, name, conv_impl)
    return x


def _apply_layer_clients(params, x, name, conv_impl="direct",
                         channels_last=False):
    """``_apply_layer`` for K clients at once: params leaves and x carry
    a leading K axis. Convolutions run as one grouped convolution (groups
    = K) or one batched matmul, dense layers as one batched matmul.

    ``channels_last``: the grouped convolution sees the K models' channels
    side by side in one NHWC map, as a channels_last (B, K*C, H, W) — the
    layout ``_conv_direct`` hands one model's conv — instead of a
    contiguous NCHW copy."""
    if name.startswith("CONV"):
        _, _, pad = _CONV[name]
        w, b = params[name]["w"].to(x.dtype), params[name]["b"].to(x.dtype)
        K, B, H, W, C = x.shape
        if conv_impl == "im2col":
            if pad == "SAME":
                x = F.pad(x, (0, 0, 1, 1, 1, 1))
                Ho, Wo = H, W
            else:
                Ho, Wo = H - 2, W - 2
            cols = torch.cat([x[:, :, di:di + Ho, dj:dj + Wo, :]
                              for di in range(3) for dj in range(3)], -1)
            y = torch.bmm(cols.reshape(K, B * Ho * Wo, 9 * C),
                          w.reshape(K, 9 * C, -1))
            y = y.reshape(K, B, Ho, Wo, -1)
        elif channels_last:
            O = w.shape[-1]
            xg = x.permute(1, 2, 3, 0, 4).reshape(B, H, W, K * C).permute(
                0, 3, 1, 2)
            wg = w.permute(0, 4, 3, 1, 2).reshape(K * O, C, 3, 3)
            y = F.conv2d(xg, wg, padding=1 if pad == "SAME" else 0, groups=K)
            Ho, Wo = y.shape[-2:]
            y = y.permute(0, 2, 3, 1).reshape(B, Ho, Wo, K, O).permute(
                3, 0, 1, 2, 4)
        else:
            O = w.shape[-1]
            xg = x.permute(1, 0, 4, 2, 3).reshape(B, K * C, H, W)
            wg = w.permute(0, 4, 3, 1, 2).reshape(K * O, C, 3, 3)
            y = F.conv2d(xg, wg, padding=1 if pad == "SAME" else 0, groups=K)
            Ho, Wo = y.shape[-2:]
            y = y.reshape(B, K, O, Ho, Wo).permute(1, 0, 3, 4, 2)
        return torch.relu(y + b[:, None, None, None, :])
    if name.startswith("POOL"):
        K, B, H, W, C = x.shape
        if H % 2 or W % 2:
            x = x[:, :, :H - H % 2, :W - W % 2]
            K, B, H, W, C = x.shape
        return x.reshape(K, B, H // 2, 2, W // 2, 2, C).amax(dim=(3, 5))
    p = params[name]
    if x.dim() > 3:
        x = x.reshape(x.shape[0], x.shape[1], -1)   # NHWC: h, w, c order
    y = torch.bmm(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)[:, None, :]
    return torch.relu(y) if name != "FC3" else y


def apply_range_clients(params: dict, x: torch.Tensor, lo: int, hi: int,
                        conv_impl: str = "direct"):
    """``apply_range`` for K clients: params leaves (K, ...), x (K, B,
    ...); equal to stacking ``apply_range`` over the K clients."""
    for name in LAYERS[lo:hi]:
        x = _apply_layer_clients(params, x, name, conv_impl)
    return x


def apply_range_replicas(params: dict, x: torch.Tensor, lo: int, hi: int,
                         conv_impl: str = "direct"):
    """``apply_range`` for E models at once (an experiment fleet's
    replicas): params leaves (E, ...), x (E, B, ...). The grouped
    convolutions take the layout ``apply_range`` gives one model's, so on
    one CPU thread each replica's slab, forward and backward, is
    bit-equal to ``apply_range`` on it."""
    for name in LAYERS[lo:hi]:
        x = _apply_layer_clients(params, x, name, conv_impl,
                                 channels_last=True)
    return x


def forward(params: dict, x: torch.Tensor, conv_impl: str = "direct"):
    return apply_range(params, x, 0, N_LAYERS, conv_impl)


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample negative log-likelihood, (B, 1)."""
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, -1, labels.long()[:, None])


def loss_fn(params: dict, batch: dict) -> torch.Tensor:
    # paper: log-likelihood loss == cross-entropy on log-softmax
    return nll(forward(params, batch["image"]), batch["label"]).mean()


def loss_fn_clients(params: dict, batch: dict) -> torch.Tensor:
    """``loss_fn`` for N full models at once: params leaves (N, ...),
    batch leaves (N, B, ...); returns the (N,) per-model losses (the FL
    comparator's N devices as one clients pass)."""
    logits = apply_range_replicas(params, batch["image"], 0, N_LAYERS)
    N = logits.shape[0]
    return nll(logits.reshape(-1, logits.shape[-1]),
               batch["label"].reshape(-1)).reshape(N, -1).mean(-1)


def split_params(params: dict, v: int) -> Tuple[dict, dict]:
    """Device-side = layers [0, v), server-side = layers [v, 12)."""
    dev = {k: params[k] for k in LAYERS[:v] if k in params}
    srv = {k: params[k] for k in LAYERS[v:] if k in params}
    return dev, srv


def merge_params(dev: dict, srv: dict) -> dict:
    out = dict(dev)
    out.update(srv)
    return out


@torch.no_grad()
def accuracy(params: dict, images, labels, batch: int = 512) -> float:
    """Test accuracy; ``images``/``labels`` are tensors on the params'
    device (or numpy arrays, moved there batch by batch)."""
    dev = next(iter(params.values()))["w"].device
    images = torch.as_tensor(images)
    labels = torch.as_tensor(labels)
    hits = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(0, len(images), batch):
        lg = forward(params, images[i:i + batch].to(dev))
        hits += (lg.argmax(-1) == labels[i:i + batch].to(dev)).sum()
    return int(hits) / max(len(images), 1)

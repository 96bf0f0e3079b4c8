"""Device "meshes" of the port: one card.

The reference builds jax meshes over a TPU pod (``data`` x ``model`` =
16 x 16 chips, or ``pod`` x 16 x 16). The port runs on one NVIDIA H100,
so a mesh here is a small descriptor with the reference's ``axis_names``,
``shape`` (a dict) and ``size``, which ``core.partitioning`` reads.
``make_host_mesh`` checks the requested shape against the cards there are;
``make_production_mesh`` raises: a 256- or 512-chip pod has no meaning on
one card.

The hardware constants feed the roofline (``launch.roofline``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n


def make_production_mesh(*, multi_pod: bool = False):
    raise ValueError("the production mesh is a TPU pod (16 x 16 chips, "
                     f"{'x 2 pods ' if multi_pod else ''}in the reference); "
                     "one card has no pod: use make_host_mesh")


def make_host_mesh(data: int = 1, model: int = 1, pods: int = 1,
                   device="cuda") -> Mesh:
    """A mesh over the cards of this host (CUDA unless ``device`` is
    "cpu", which counts as one device); raises when ``pods * data *
    model`` exceeds them."""
    n = (1 if torch.device(device).type == "cpu"
         else torch.cuda.device_count())
    if pods * data * model > n:
        raise ValueError(f"mesh pods={pods} x data={data} x model={model} "
                         f"needs {pods * data * model} devices; {n} here")
    if pods > 1:
        return Mesh(("pod", "data", "model"),
                    {"pod": pods, "data": data, "model": model})
    return Mesh(("data", "model"), {"data": data, "model": model})


# NVIDIA H100 SXM5 hardware constants (roofline), from NVIDIA's H100 data
# sheet, dense (no sparsity), at the card's 700 W power limit:
PEAK_FLOPS_BF16 = 989e12       # bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12               # HBM3 bytes/s per card
ICI_BW = 900e9                 # NVLink 4 bytes/s per card (collective term;
                               # 0 on one card)

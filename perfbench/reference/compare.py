"""How the program's numbers are held against the reference's.

A training step is judged by its loss and, leaf by leaf, by norms: the
gap between the program's norm of a leaf and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger
(some gradients are all but zero), taken at the worst leaf. A leaf is a
leaf of the program's state tree (a layer-stacked or client-stacked
tensor); its norm comes from its slices' norms. Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone and are left out, by that rule and not by name.

A served model is judged by its tokens: the widest gap by which a served
token's reference logit lies below the reference's best at its position.
"""
from __future__ import annotations

import math
import statistics


def loss_gap(program, reference) -> float:
    if len(program) != len(reference):
        return float("inf")
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def moving_leaves(ref_grad: dict) -> set:
    med = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v >= 1e-3 * med}


def leaf_norms(slices: dict, leaf_of) -> dict:
    """Whole leaves' norms from their slices' norms."""
    out = {}
    for name, norm in slices.items():
        leaf = leaf_of(name)
        out[leaf] = out.get(leaf, 0.0) + norm * norm
    return {k: math.sqrt(v) for k, v in out.items()}


def leaf_gaps(program: dict, reference: dict, keep: set) -> dict:
    if set(program) != set(reference):
        return {k: float("inf") for k in keep}
    med = statistics.median(reference[k] for k in keep)
    return {k: abs(program[k] - reference[k]) / max(reference[k], med)
            for k in keep}


def worst_leaf(program: dict, reference: dict, keep: set) -> float:
    return max(leaf_gaps(program, reference, keep).values())


def token_gaps(ref_logits, tokens):
    """ref_logits (R, T, V) f32, tokens (R, T): each position's gap."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    return best - got

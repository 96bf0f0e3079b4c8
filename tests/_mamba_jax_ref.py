"""The JAX package's Mamba-2 mixer on a seeded layer of the reduced
mamba2-2.7b, in float32: its output and the gradients of the input, of D
and of the norm's scale under a seeded cotangent, saved with the inputs
and the layer's parameters in ``FIXTURE``. A card test holds the port's
kernel path to these numbers where JAX is not installed;
``tests/test_torch_gated_norm.py`` checks on the CPU that the file is what
the reference computes now. To write the file again:

    PYTHONPATH=src python tests/_mamba_jax_ref.py
"""
from __future__ import annotations

from pathlib import Path

FIXTURE = Path(__file__).resolve().parent / "data" / "mamba2_mixer_jax.npz"
SHAPE = (2, 32)           # batch, tokens: four of the reduced chunks of 8
SEED = 29


def compute() -> dict:
    """The fixture's arrays by name: ``param/<path>`` for each leaf of the
    layer's mixer parameters, ``x`` (B, S, d_model), ``cotangent`` (as the
    output), ``out``, ``dx``, ``dD``, ``dscale``."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import registry
    from repro.models import api
    from repro.models import mamba2
    cfg = registry.reduce_for_smoke(registry.get("mamba2-2.7b")).replace(
        dtype="float32", ssd_impl="chunked")
    params = api.init(jax.random.PRNGKey(SEED), cfg)
    p = jax.tree.map(lambda t: t[0], params["stack"][0])["mamba"]
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((*SHAPE, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((*SHAPE, cfg.d_model)).astype(np.float32)

    def f(x, D, scale):
        q = {**p, "D": D, "norm": {**p["norm"], "scale": scale}}
        return mamba2.mamba_apply(q, x, cfg)

    out, vjp = jax.vjp(f, jnp.asarray(x), p["D"], p["norm"]["scale"])
    dx, dD, dscale = vjp(jnp.asarray(w))
    arrays = {f"param/{'/'.join(str(k.key) for k in path)}": np.asarray(v)
              for path, v in jax.tree_util.tree_leaves_with_path(p)}
    arrays.update(x=x, cotangent=w, out=np.asarray(out), dx=np.asarray(dx),
                  dD=np.asarray(dD), dscale=np.asarray(dscale))
    return arrays


def load() -> tuple[dict, dict]:
    """(the mixer's parameters as a nested dict of numpy arrays, the other
    arrays by name) from ``FIXTURE``; needs numpy alone."""
    import numpy as np
    params, rest = {}, {}
    with np.load(FIXTURE) as f:
        for name in f.files:
            if name.startswith("param/"):
                *path, leaf = name.split("/")[1:]
                node = params
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = f[name]
            else:
                rest[name] = f[name]
    return params, rest


if __name__ == "__main__":
    import numpy as np
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez(FIXTURE, **compute())
    print(FIXTURE, FIXTURE.stat().st_size, "bytes")

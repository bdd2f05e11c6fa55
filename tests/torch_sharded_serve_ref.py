"""The reference's sharded serve, run in a subprocess for
``test_torch_sharded_serve.py`` (``XLA_FLAGS`` must force the host
devices before JAX is imported).

    python tests/torch_sharded_serve_ref.py JOBS.pkl OUT.pkl

``JOBS.pkl`` holds a list of jobs (mesh shape and axes, arch, serve
config fields, f32 parameters as numpy, prompts, extras and the
teacher-forced decode tokens); ``OUT.pkl`` receives, for each job and
each device in mesh order, every step's tokens and logprobs and the
device's block of the decode state after every step. A job of
``"kind": "shards"`` receives instead each device's addressable shard of
every parameter leaf under ``NamedSharding(mesh, param_pspecs(...))``.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.archs import ARCHS  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.spmd import build_serve, mesh_sizes  # noqa: E402
from repro.models import params as pm  # noqa: E402
from repro.serving.engine import ServeConfig  # noqa: E402


def _blocks(tree, n):
    """Each device's block of a state stacked over every device (dim 0),
    as numpy, in mesh order."""
    leaves, treedef = jax.tree.flatten(tree)
    per = [[] for _ in range(n)]
    for x in leaves:
        x = np.asarray(x)
        k = x.shape[0] // n
        for r in range(n):
            per[r].append(x[r * k:(r + 1) * k])
    return [jax.tree.unflatten(treedef, p) for p in per]


def shards(job, cfg, mesh):
    """Each device's addressable shard of every parameter leaf under
    ``NamedSharding(mesh, param_pspecs(...))``, in mesh order."""
    ms = mesh_sizes(mesh)
    specs = pm.param_pspecs(cfg, ms)
    placed = jax.tree.map(
        lambda x, s: jax.device_put(jnp.asarray(x), NamedSharding(mesh, s)),
        job["params"], specs)
    order = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    per = [[] for _ in order]
    for leaf in jax.tree.leaves(placed):
        for sh in leaf.addressable_shards:
            per[order[sh.device]].append(np.asarray(sh.data))
    return per


def run(job):
    cfg = dataclasses.replace(ARCHS[job["arch"]].reduced(),
                              param_dtype="float32")
    mesh = make_mesh(job["mesh_shape"], job["mesh_axes"])
    if job.get("kind") == "shards":
        return shards(job, cfg, mesh)
    n = int(np.prod(job["mesh_shape"]))
    sc = ServeConfig(**job["sc"])
    prefill, decode, _ = build_serve(cfg, mesh, sc)
    params = jax.tree.map(jnp.asarray, job["params"])
    extras = {k: jnp.asarray(v) for k, v in job["extras"].items()}
    state, out = prefill(params, jnp.asarray(job["prompts"]), extras)
    steps = []
    for t in range(job["forced"].shape[1] + 1):
        steps.append(dict(tok=np.asarray(out[0]), lp=np.asarray(out[1]),
                          state=_blocks(state, n)))
        if t == job["forced"].shape[1]:
            break
        state, out = decode(params, state, jnp.asarray(job["forced"][:, t]))
    return steps


def main():
    with open(sys.argv[1], "rb") as f:
        jobs = pickle.load(f)
    out = [run(job) for job in jobs]
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()

"""The reference's sharded training, run in a subprocess for
``test_torch_sharded_train.py`` (``XLA_FLAGS`` must force the host
devices before JAX is imported).

    python tests/torch_sharded_train_ref.py JOBS.pkl OUT.pkl

``JOBS.pkl`` holds a list of jobs. A training job (mesh shape and axes,
arch, ``compress`` flag, f32 parameters as numpy, one batch a step as
numpy) runs the reference's ``launch.spmd.build_train_step`` from
``adamw_init`` and zero error feedback; ``OUT.pkl`` receives, for each
job, every step's metrics and, for each device in mesh order, its block
of every leaf of the parameters and both moments after the last step (in
``jax.tree.leaves`` order). A job of ``"kind": "compress"`` runs the
reference's ``compressed_psum`` over a 1-D ``"pod"`` mesh on each
device's gradients and error feedback, and receives each device's mean
and new error feedback.
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
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.archs import ARCHS  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.spmd import build_train_step  # noqa: E402
from repro.training import compression  # noqa: E402
from repro.training.compression import init_error_feedback  # noqa: E402
from repro.training.optimizer import adamw_init  # noqa: E402
from repro.training.train_step import TrainHyper, TrainState  # noqa: E402


def train_config(arch: str):
    """The reduced f32 configuration, the MoE's capacity such that no slot
    drops (as ``spmd_eq_script.py`` sets it), and f32 moments (mixtral's
    bf16 moments tip by a bf16 step where two f32 gradients differ in
    their last bits)."""
    cfg = ARCHS[arch].reduced()
    moe = None if cfg.moe is None else dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    return dataclasses.replace(cfg, param_dtype="float32", moe=moe,
                               opt_state_dtype="float32")


def _blocks(tree, mesh):
    """Each device's block of every leaf, as numpy, in mesh order."""
    order = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    per = [[] for _ in order]
    for leaf in jax.tree.leaves(tree):
        for sh in leaf.addressable_shards:
            per[order[sh.device]].append(np.asarray(sh.data))
    return per


def train(job):
    cfg = train_config(job["arch"])
    mesh = make_mesh(job["mesh_shape"], job["mesh_axes"])
    hyper = TrainHyper(aux_weight=0.0, compress_pod_grads=job["compress"])
    step, st_spec, b_spec = build_train_step(cfg, mesh, hyper)
    params = jax.tree.map(jnp.asarray, job["params"])
    state = TrainState(params, adamw_init(params, cfg.opt_state_dtype),
                       init_error_feedback(params))
    put = lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp))  # noqa
    state = jax.tree.map(put, state, st_spec)
    metrics = []
    for batch in job["batches"]:
        b = jax.tree.map(put, {k: jnp.asarray(v) for k, v in batch.items()},
                         b_spec)
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, params=_blocks(state.params, mesh),
                mu=_blocks(state.opt.mu, mesh), nu=_blocks(state.opt.nu, mesh))


def compress(job):
    mesh = make_mesh((4,), ("pod",))
    out = []
    for g, e, dt in job["leaves"]:
        def body(g, e):
            return compression.compressed_psum(g, e, "pod")
        fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("pod"),
                                                              P("pod")),
                                   out_specs=(P("pod"), P("pod")),
                                   check_vma=False))
        mean, err = fn(jnp.asarray(g).astype(dt), jnp.asarray(e))
        out.append((np.asarray(mean.astype(jnp.float32)), np.asarray(err)))
    return out


def main():
    with open(sys.argv[1], "rb") as f:
        jobs = pickle.load(f)
    out = [compress(j) if j.get("kind") == "compress" else train(j)
           for j in jobs]
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()

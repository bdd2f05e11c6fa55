"""The port's side of ``test_torch_sharded_serve.py``: one rank of a mesh
serving the jobs of ``torch_sharded_serve_ref.py`` through
``repro_torch.launch.spmd.build_serve``. Spawned by
``repro_torch.launch.mesh.spawn_ranks``; imports neither JAX nor
``repro``."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.launch import spmd
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving.engine import ServeConfig


def kv_ints(kv) -> dict:
    """The integer state of a rank's pools and its learner's weights."""
    m, o = kv.meta, kv.ols
    out = dict(tags=m.tags, valid=m.valid, dirty=m.dirty, freq=m.freq,
               ts=m.ts, page_slot=kv.page_slot, t2_slot=kv.t2_slot,
               pred=o.pred, pred_n=o.pred_n, mispred=o.mispred,
               epoch_misses=o.epoch_misses, chosen=o.chosen,
               lengths=kv.lengths, t=kv.t, key=torch.tensor(kv.key),
               t2_reads=kv.t2_reads, t1_reads=kv.t1_reads)
    out = {k: v.numpy().astype(np.int64) for k, v in out.items()}
    out["weights"] = kv.ols.weights.numpy().copy()
    return out


def _rec(state) -> list:
    return [[{k: v.float().numpy().copy() for k, v in d.items()}
             for d in rec] for rec in (state.rec, state.rec_tail)]


def serve_rank(rank, dev, shape, axes, jobs):
    mesh = make_mesh(shape, axes)
    out = []
    for job in jobs:
        cfg = dataclasses.replace(ARCHS[job["arch"]].reduced(),
                                  param_dtype="float32")
        sc = ServeConfig(**job["sc"])
        prefill, decode, specs = spmd.build_serve(cfg, mesh, sc)
        params = spmd.shard_for_rank(
            params_from_numpy(job["params"], device="cpu"), cfg, mesh)
        prompts = spmd.local_batch(torch.as_tensor(job["prompts"]), specs)
        forced = spmd.local_batch(torch.as_tensor(job["forced"]), specs)
        extras = spmd.local_batch(
            {k: torch.as_tensor(v) for k, v in job["extras"].items()}, specs)
        state, (tok, lp) = prefill(params, prompts, extras)
        steps = []
        for t in range(forced.shape[1] + 1):
            steps.append(dict(
                tok=tok.numpy().copy(), lp=lp.numpy().copy(),
                kv=None if state.kv is None else kv_ints(state.kv),
                rec=_rec(state)))
            if t == forced.shape[1]:
                break
            state, (tok, lp) = decode(params, state, forced[:, t])
        out.append(dict(steps=steps, coords=mesh.coords(),
                        page_shard=specs.page_shard,
                        batch_shard=specs.batch_shard))
    return out


def _np(x, dt):
    """The result as numpy, after checking it kept its dtype."""
    assert x.dtype == dt, (x.dtype, dt)
    return x.to(torch.float64 if dt.is_floating_point else x.dtype).numpy()


def axes_rank(rank, dev, seed):
    """Every collective of ``Axes`` on a (data 2, model 2) mesh over
    seeded inputs (each rank draws all four ranks' and keeps its own)."""
    from repro_torch.distributed.axes import SINGLE
    from repro_torch.launch.mesh import axes_for_mesh
    from repro_torch.models.attention import Partial, combine_shards
    mesh = make_mesh((2, 2), ("data", "model"))
    ax = axes_for_mesh(mesh)
    rng = np.random.default_rng(seed)
    xs = rng.integers(-50, 50, (4, 3, 5))
    out = {"coords": mesh.coords(), "sizes": (ax.data_size, ax.model_size,
                                              ax.pod_size, ax.batch_shards()),
           "tp": (ax.tp_degree(8), ax.tp_degree(3))}
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        x = torch.as_tensor(xs[rank]).to(dt)
        for name, names in (("data", ("data",)), ("model", ("model",)),
                            ("both", ("data", "model")),
                            ("with_none", ("model", None))):
            out[("psum", str(dt), name)] = _np(ax.psum_many(x, names), dt)
            out[("pmax", str(dt), name)] = _np(ax.pmax_many(x, names), dt)
        for name in ("data", "model"):
            out[("psum1", str(dt), name)] = _np(ax.psum(x, name), dt)
            out[("pmax1", str(dt), name)] = _np(ax.pmax(x, name), dt)
            for dim in (0, 1):
                out[("gather", str(dt), name, dim)] = _np(
                    ax.all_gather(x, name, axis=dim), dt)
    x = torch.as_tensor(xs[rank], dtype=torch.float32)
    out["single"] = all(
        f(x) is x for f in (lambda t: SINGLE.psum(t, None),
                            lambda t: SINGLE.pmax_many(t, (None,)),
                            lambda t: ax.psum_many(t, ()),
                            lambda t: ax.all_gather(t, None, axis=1),
                            lambda t: ax.fsdp_gather(t, None)))
    try:  # pmax has no backward (the sums' backwards: sharded training)
        ax.pmax(x.requires_grad_(), "model")
        out["autograd"] = "accepted"
    except RuntimeError as e:
        out["autograd"] = str(e)
    # The page shards' combine with rank 3's partial empty (no live
    # token): acc 0, m -1e30, l 0.
    parts = rng.normal(size=(4, 2, 3, 4))
    acc = torch.as_tensor(parts[rank, :, :, :4], dtype=torch.float32)
    m = torch.as_tensor(parts[rank, :, :, 0] * 3, dtype=torch.float32)
    l = torch.as_tensor(np.abs(parts[rank, :, :, 1]) + 0.5,
                        dtype=torch.float32)
    if rank == 3:
        acc, m, l = (torch.zeros_like(acc), torch.full_like(m, -1e30),
                     torch.zeros_like(l))
    out["combine"] = combine_shards(Partial(acc, m, l), ax,
                                    ("data", "model")).numpy()
    out["parts"] = parts
    return out


def card_axes_rank(rank, dev):
    """A (model 2) mesh on ranks that share the card: collectives of CUDA
    tensors and their backwards, each result's device and the backend."""
    from repro_torch.launch.mesh import axes_for_mesh
    mesh = make_mesh((2,), ("model",))
    ax = axes_for_mesh(mesh)
    x = torch.full((3,), rank + 1.0, device=dev)
    s = ax.psum(x, "model")
    m = ax.pmax_many(x.to(torch.bfloat16), ("model",))
    g = ax.all_gather(x[:1].reshape(1, 1), "model", axis=1)
    # The backwards: the gather's reduce-scatter (f32 and bf16), the entry
    # marker's sum, the sum's identity.
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        w = torch.full((1, 2), rank + 1.0, device=dev, dtype=dt,
                       requires_grad=True)
        y = ax.all_gather(w, "model", axis=0)             # [2, 2]
        coef = torch.arange(4.0, device=dev).reshape(2, 2).to(dt) * (rank + 1)
        (gw,) = torch.autograd.grad((y * coef).sum(), w)
        out[f"gather_grad_{dt}"] = gw.float().cpu().numpy()
        out[f"scatter_{dt}"] = ax.psum_scatter(
            coef.detach(), "model", axis=1).float().cpu().numpy()
    e = torch.full((3,), 1.0, device=dev, requires_grad=True)
    (ge,) = torch.autograd.grad((ax.enter(e, ("model",)) * (rank + 1)).sum()
                                + ax.psum(e * (rank + 1), "model").sum(), e)
    out["enter_grad"] = ge.cpu().numpy()
    return dict(backend=mesh.backend,
                devices=[str(t.device) for t in (s, m, g, gw)],
                psum=s.cpu().numpy(), pmax=m.float().cpu().numpy(),
                gather=g.cpu().numpy(), **out)


def train_config(arch: str):
    """The port's reduced f32 configuration of ``torch_sharded_train_ref.
    train_config``: the MoE's capacity such that no slot drops, f32
    moments."""
    cfg = ARCHS[arch].reduced()
    moe = None if cfg.moe is None else dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    return dataclasses.replace(cfg, param_dtype="float32", moe=moe,
                               opt_state_dtype="float32")


def full_train_state(job):
    """The full state of a training job: its parameters, ``adamw_init``
    moments, zero error feedback, on the CPU."""
    from repro_torch.training.compression import init_error_feedback
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import TrainState
    cfg = train_config(job["arch"])
    params = params_from_numpy(job["params"], device="cpu")
    return TrainState(params, adamw_init(params, cfg.opt_state_dtype),
                      init_error_feedback(params))


def train_batch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _leaves_np(tree) -> list:
    from repro_torch.training.tree import leaves
    return [t.detach().float().numpy().copy() for t in leaves(tree)]


def train_rank(rank, dev, shape, axes, jobs):
    """Each training job's steps on this rank's blocks through
    ``spmd.build_train_step``: every step's metrics, and the blocks of the
    parameters, both moments and the error feedback after the last."""
    from repro_torch.training.train_step import TrainHyper
    mesh = make_mesh(shape, axes)
    out = []
    for job in jobs:
        cfg = train_config(job["arch"])
        hyper = TrainHyper(aux_weight=0.0, compress_pod_grads=job["compress"])
        step, _, _ = spmd.build_train_step(cfg, mesh, hyper)
        state = spmd.shard_state(full_train_state(job), cfg, mesh)
        metrics = []
        for b in job["batches"]:
            state, m = step(state, spmd.train_batch_for_rank(train_batch(b),
                                                             mesh))
            metrics.append({k: float(v) for k, v in m.items()})
        out.append(dict(metrics=metrics, coords=mesh.coords(),
                        params=_leaves_np(state.params),
                        mu=_leaves_np(state.opt.mu),
                        nu=_leaves_np(state.opt.nu),
                        err_fb=_leaves_np(state.err_fb)))
    return out


def compress_rank(rank, dev, leaves):
    """``compressed_psum`` over a (pod 4) mesh on this rank's gradients and
    error feedback: its codes, means and new error feedback."""
    from repro_torch.launch.mesh import axes_for_mesh
    from repro_torch.training.compression import compressed_psum, quantize
    mesh = make_mesh((4,), ("pod",))
    ax = axes_for_mesh(mesh)
    out = []
    for g, e, dt in leaves:
        n = g.shape[0] // 4
        gl = torch.as_tensor(g[rank * n:(rank + 1) * n]).to(getattr(torch, dt))
        el = torch.as_tensor(e[rank * n:(rank + 1) * n])
        (mean,), (err,) = compressed_psum([gl], [el], ax, "pod")
        gf = gl.float() + el
        q, _ = quantize(gf, ax.pmax(gf.abs().max(), "pod"))
        out.append((q.numpy().copy(), mean.float().numpy().copy(),
                    err.numpy().copy()))
    return out


def checkpoint_rank(rank, dev, job, root):
    """A (data 2, model 2) run of two steps with a sharded checkpoint after
    the first, then the second step again from the checkpoint restored on
    the same mesh. Rank 0 also returns the gathered state after each
    step."""
    from repro_torch.training.checkpoint import CheckpointConfig
    from repro_torch.training.train_step import TrainHyper
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = train_config(job["arch"])
    step, _, _ = spmd.build_train_step(cfg, mesh, TrainHyper(aux_weight=0.0))
    cc = CheckpointConfig(dir_tier1=f"{root}/fast",
                          dir_tier2=f"{root}/durable", tier1_every=1,
                          tier2_every=1000)
    b0, b1 = (spmd.train_batch_for_rank(train_batch(b), mesh)
              for b in job["batches"])
    state, _ = step(spmd.shard_state(full_train_state(job), cfg, mesh), b0)
    written = spmd.save_sharded_checkpoint(state, 1, cc, cfg, mesh)
    first = _leaves_np(spmd.gather_state(state, cfg, mesh))
    state, m = step(state, b1)
    after = _leaves_np(state)
    second = _leaves_np(spmd.gather_state(state, cfg, mesh))
    restored, at = spmd.restore_sharded_checkpoint(state, cc, cfg, mesh)
    again, m_again = step(restored, b1)
    out = dict(written=written, at=at, metrics={k: float(v)
                                                for k, v in m.items()},
               resumed=dict(metrics={k: float(v)
                                     for k, v in m_again.items()},
                            leaves=_leaves_np(again)), after=after)
    if rank == 0:
        out.update(first=first, second=second)
    return out


def cost_rank(rank, dev, job):
    """A (data 2, model 2) step of ``job`` from its first batch, counted by
    ``repro_torch.core.roofline.program_cost`` on every rank (its
    collectives need them all): the counts, the step's argument bytes (the
    rank's state and its rows of the batch, each in a storage of its own)
    and its collectives' calls, bytes and wire bytes by kind. The dry run
    of the same cell on ``meta`` is held against rank 0's."""
    from repro_torch.core.roofline import program_cost
    from repro_torch.distributed import axes as dax
    from repro_torch.training.train_step import TrainHyper
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = train_config(job["arch"])
    step, _, _ = spmd.build_train_step(cfg, mesh, TrainHyper(aux_weight=0.0))
    state = spmd.shard_state(full_train_state(job), cfg, mesh)
    batch = {k: v.clone() for k, v in spmd.train_batch_for_rank(
        train_batch(job["batches"][0]), mesh).items()}
    dax.reset_collective_stats()
    cost = program_cost(step, state, batch)
    cost.pop("result")
    wire = dax.collective_wire_bytes()
    coll = {k: [v[0], v[1], wire[k]]
            for k, v in sorted(dax.collective_stats().items())}
    dax.reset_collective_stats()
    return dict(cost=cost, collectives=coll)


def train_all_rank(rank, dev, meshes, comp_leaves, ck_job, root):
    """``test_torch_sharded_train.py``'s work on one spawn of the ranks:
    :func:`train_rank` on each mesh (``{id: (shape, axes, jobs)}``), then
    :func:`compress_rank`, :func:`checkpoint_rank` and :func:`cost_rank`
    (of the checkpoint's job)."""
    return dict(
        train={m: train_rank(rank, dev, shape, axes, jobs)
               for m, (shape, axes, jobs) in meshes.items()},
        compress=compress_rank(rank, dev, comp_leaves),
        checkpoint=checkpoint_rank(rank, dev, ck_job, root),
        cost=cost_rank(rank, dev, ck_job))

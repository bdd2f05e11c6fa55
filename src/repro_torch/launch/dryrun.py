"""The multi-pod dry run and its roofline, without a card (the reference's
``launch/dryrun.py``).

For every (architecture × input shape) cell on the production mesh (16 ×
16 ranks, or 2 × 16 × 16): one rank's real program (its train step, its
prefill, or one decode step) runs on the ``meta`` device inside a fake
process group of all the mesh's ranks in this process, and
:func:`repro_torch.core.roofline.program_cost` counts its work op by op as
it is dispatched. Nothing is allocated and nothing runs on any card. The
record holds the rank's argument and peak bytes, its FLOPs and bytes, its
collectives' wire bytes (:mod:`repro_torch.distributed.axes`) and the
three roofline terms on the H100 (:data:`repro_torch.core.roofline.HW`).

Where the reference lowers a cell's step against ``ShapeDtypeStruct`` s
and reads the compiled HLO, the port runs the same program on tensors
that have shapes and no data:

- everything the card would hold is on ``meta``: parameters, optimizer
  state, KV pools, activations. The serving tiers' metadata (page
  tables, the §III cache states, the learner) stays in real host tensors,
  as it does beside the card, because the host-driven allocation reads it
  (``kvpool.alloc_step``); its ops are counted apart as host work;
- the serving kernels run their plain versions, through the explicit
  switch :func:`repro_torch.kernels.plain_versions`: a ``meta`` tensor has
  no kernel. So a serve cell's count covers the blocks and pages that a
  kernel would skip as masked (the plain attention's full score matrix,
  the plain paged read of every page slot), and its compute and memory
  terms are no bound on the card's kernels: its record says so
  (``terms_are_bounds`` false). Training touches no kernel;
- a decode cell decodes the last position of the shape: its state is the
  one a prefill of ``seq_len - 1`` positions leaves (the prefill's tier
  metadata and lengths, over the state that a prefill of one page
  builds, whose shapes are those of any prefill), and the step is counted
  alone. The reference's decode takes its state as a struct, the port's
  reads the lengths;
- the program is one rank's. The reference's is SPMD; the port's ranks
  own different pages, so ``rank`` is recorded.

Results are written incrementally to a JSON file, so an interrupted run
resumes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh pod1|pod2|both] [--out PATH] [--force]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.archs import ARCHS, get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.core import roofline as rl
from repro_torch.distributed import axes as dax
from repro_torch.kernels import plain_versions
from repro_torch.launch import spmd
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import params as pm
from repro_torch.serving import kvpool as kvp
from repro_torch.serving.engine import ServeConfig
from repro_torch.training.train_step import TrainHyper
from repro_torch.training.tree import tree_map

__all__ = ["DEFAULT_OUT", "active_param_count", "model_flops",
           "long_ctx_supported", "serve_config", "fake_group",
           "cell_program", "trace_cell", "run_cell", "main"]

DEFAULT_OUT = "build/dryrun_torch.json"

SERVE_NOTE = ("the serving kernels' plain versions, counted op by op: the "
              "masked blocks and page slots that a kernel would skip are "
              "counted, and every page slot of both tiers, the full score "
              "matrices and the f32 upcasts that the plain versions "
              "materialize; so t_compute_s, t_memory_s, dominant and "
              "roofline_frac are not a bound on the card's kernels "
              "(terms_are_bounds is false)")


# ---------------------------------------------------------------------------
# Cell construction (the reference's arithmetic).
# ---------------------------------------------------------------------------


def active_param_count(cfg: ModelConfig, ms: pm.MeshSizes) -> tuple[int, int]:
    """(N_total, N_active) from the parameter structs."""
    scale_names = {"w_gate", "w_up", "w_down"} if cfg.moe else set()
    ratio = (cfg.moe.top_k / cfg.moe.n_experts) if cfg.moe else 1.0
    total = active = 0

    def walk(tree, name=None):
        nonlocal total, active
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif isinstance(tree, list):
            for v in tree:
                walk(v, name)
        else:
            n = tree.numel()
            total += n
            active += int(n * ratio) if name in scale_names else n

    walk(pm.param_structs(cfg, ms))
    return total, active


def model_flops(cfg: ModelConfig, shape: ShapeSpec, ms: pm.MeshSizes) -> float:
    _, n_active = active_param_count(cfg, ms)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: per step


def long_ctx_supported(cfg: ModelConfig) -> bool:
    """long_500k runs only for sub-quadratic attention families."""
    return all(k != "attn_full" for k in cfg.block_pattern)


def serve_config(cfg: ModelConfig, shape: ShapeSpec, mesh) -> ServeConfig:
    """The reference's serving configuration of a cell: the pages over
    the model axis and the batch over pod and data, or for ``long_500k``
    one sequence with its pages over every axis. ``mesh`` needs only
    ``axis_names`` and ``shape``."""
    names = mesh.axis_names
    sizes = dict(zip(names, mesh.shape))
    if shape.name == "long_500k":
        page_axes = tuple(n for n in ("pod", "data", "model") if n in names)
        batch_shards = 1
    else:
        page_axes = ("model",)
        batch_shards = sizes.get("pod", 1) * sizes.get("data", 1)
    b_local = max(1, shape.global_batch // batch_shards)
    return ServeConfig(
        max_seq=shape.seq_len,
        batch_local=b_local,
        page_axes=page_axes,
        mapping="block_cyclic",
        hbm_fraction=0.5,
    )


# ---------------------------------------------------------------------------
# One rank's program.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A fake process group of ``world`` ranks in this process, as rank
    ``rank``: its collectives take any tensor and move nothing. It refuses
    to start where a process group is already initialized, and is
    destroyed on the way out, on error too."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "the dry run starts its own fake process group, and one is "
            "already initialized in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _batch_shards(mesh: Mesh) -> int:
    n = 1
    for name in ("pod", "data"):
        if name in mesh.axis_names:
            n *= mesh.size(name)
    return n


def _materialize(tree, device, vocab: int, gen: torch.Generator):
    """A tree of ``meta`` stand-ins as random tensors on ``device``:
    floats normal x 0.02, integers (token ids) in ``[0, vocab)``."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype.is_floating_point:
            x = torch.randn(t.shape, generator=gen) * 0.02
        else:
            x = torch.randint(0, vocab, t.shape, generator=gen)
        return x.to(device=device, dtype=t.dtype)
    return tree_map(one, tree)


def cell_program(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh, *,
                 sc_patch: Optional[dict] = None,
                 device="meta") -> tuple[Callable, tuple]:
    """``(fn, args)``: one rank's program of the cell, ``fn(*args)``. On
    ``meta`` the arguments are empty stand-ins; on another device (the
    tests' real run of the same program) random tensors from a fixed seed.
    A train cell is one ``spmd.build_train_step`` step (the default
    ``TrainHyper``: its values change no op) on the rank's block
    of the state and its rows of the batch; a prefill cell the rank's
    prefill of ``seq_len`` positions; a decode cell one step at position
    ``seq_len - 1`` (its state set up here, outside ``fn``). The serving
    kernels run their plain versions inside ``fn``."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(0)

    def real(tree):
        if device.type == "meta":
            return tree
        return _materialize(tree, device, cfg.vocab, gen)

    if shape.kind == "train":
        step, _, _ = spmd.build_train_step(cfg, mesh, TrainHyper())
        state = real(spmd.state_structs(cfg, mesh))
        batch = real(spmd.batch_structs(
            cfg, global_batch=shape.global_batch // _batch_shards(mesh),
            seq_len=shape.seq_len))
        return step, (state, batch)

    sc = serve_config(cfg, shape, mesh)
    if sc_patch:
        sc = dataclasses.replace(sc, **sc_patch)
    prefill, decode, specs = spmd.build_serve(cfg, mesh, sc)
    params = real(spmd.param_block_structs(cfg, mesh))
    B, dt = sc.batch_local, getattr(torch, cfg.param_dtype)

    def inputs(n_text: int):
        tokens = torch.empty((B, n_text), dtype=torch.int32, device="meta")
        extras = {}
        if cfg.enc_dec:
            extras["frames"] = torch.empty((B, cfg.enc_seq, cfg.d_model),
                                           dtype=dt, device="meta")
        if cfg.vlm_prefix:
            extras["prefix_embeds"] = torch.empty(
                (B, cfg.vlm_prefix, cfg.d_model), dtype=dt, device="meta")
        return real(tokens), real(extras)

    def plain(step):
        def run(*args):
            with plain_versions():
                return step(*args)
        return run

    if shape.kind == "prefill":
        return plain(prefill), (params,) + inputs(
            shape.seq_len - cfg.vlm_prefix)
    # Decode: the state a prefill of seq_len - 1 positions leaves. A
    # prefill of one page builds the pools and the recurrent states (their
    # shapes do not depend on the prompt's length); its tier metadata and
    # lengths are then those of the longer prompt.
    state, _ = plain(prefill)(params, *inputs(cfg.page_size))
    if state.kv is not None:
        state = state._replace(kv=kvp.prefill_residency(
            state.kv, specs.kv_spec,
            torch.full((B,), shape.seq_len - 1, dtype=torch.int32)))
    tokens = real(torch.empty((B,), dtype=torch.int32, device="meta"))
    return plain(decode), (params, state, tokens)


def _port_kinds(stats: dict, wire: dict) -> dict:
    """``{kind: [calls, bytes, wire bytes]}`` a rank, the port's kinds."""
    return {k: [v[0], v[1], wire[k]] for k, v in sorted(stats.items())}


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, chips: int,
               build_mesh: Callable[[], Mesh], *, rank: int = 0,
               sc_patch: Optional[dict] = None) -> dict:
    """The record of one cell: rank ``rank``'s program on ``meta`` in a
    fake group of ``chips`` ranks over the mesh ``build_mesh()`` builds
    there, its work counted and its roofline on the H100."""
    t0 = time.perf_counter()
    with fake_group(chips, rank):
        mesh = build_mesh()
        mesh_s = time.perf_counter() - t0
        fn, args = cell_program(cfg, shape, mesh, sc_patch=sc_patch)
        dax.reset_collective_stats()
        t1 = time.perf_counter()
        cost = rl.program_cost(fn, *args)
        trace_s = time.perf_counter() - t1
        coll = dax.collective_wire_stats()
        by_port_kind = _port_kinds(dax.collective_stats(),
                                   dax.collective_wire_bytes())
        dax.reset_collective_stats()
        mf = model_flops(cfg, shape, spmd.mesh_sizes(mesh))
    flops, bytes_ = cost["flops"], cost["bytes"]
    # One rank's program: its FLOPs, bytes and wire bytes are the rank's,
    # so chips=1 and the rank's share of MODEL_FLOPS, as the reference.
    report = rl.roofline_report(hlo_flops=flops, hlo_bytes=bytes_,
                                coll=coll, chips=1, model_flops=mf / chips)
    report.update(
        status="ok",
        chips=chips,
        rank=rank,
        mesh=dict(zip(mesh.axis_names, mesh.shape)),
        mesh_s=round(mesh_s, 3),
        trace_s=round(trace_s, 2),
        wall_s=round(time.perf_counter() - t0, 2),
        memory=dict(argument_size_in_bytes=cost["argument_bytes"],
                    peak_memory_in_bytes=cost["peak_bytes"]),
        hlo_bytes_accessed=bytes_,
        hlo_bytes_all_ops=cost["bytes_all"],
        host=dict(flops=cost["host_flops"], bytes=cost["host_bytes"],
                  bytes_all=cost["host_bytes_all"],
                  transfer_bytes=cost["transfer_bytes"]),
        collective_wire_bytes_total=coll.wire_bytes,
        collectives=by_port_kind,
        # A train cell runs no kernel: its count is the card's program. A
        # serve cell counts the kernels' plain versions (SERVE_NOTE).
        terms_are_bounds=shape.kind == "train",
    )
    if shape.kind != "train":
        report["note"] = SERVE_NOTE
    return report


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             cfg_patch: Optional[dict] = None,
             sc_patch: Optional[dict] = None, rank: int = 0,
             n_layers: Optional[int] = None) -> dict:
    """The record of one (arch × shape) cell on the production mesh
    (:func:`repro_torch.launch.mesh.make_production_mesh`); ``n_layers``
    cuts the depth only."""
    cfg = get_config(arch)
    if cfg_patch:
        cfg = dataclasses.replace(cfg, **cfg_patch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not long_ctx_supported(cfg):
        return {
            "status": "skipped",
            "reason": "pure full-attention arch: 512k decode needs "
                      "sub-quadratic attention",
        }
    return trace_cell(cfg, shape, 512 if multi_pod else 256,
                      lambda: make_production_mesh(multi_pod=multi_pod),
                      rank=rank, sc_patch=sc_patch)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["pod1", "pod2", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"pod1": [False], "pod2": [True], "both": [False, True]}[args.mesh]

    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'pod2' if mp else 'pod1'}"
                if key in results and results[key].get("status") in (
                        "ok", "skipped") and not args.force:
                    print(f"[skip-cached] {key}")
                    continue
                print(f"[run] {key} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mp)
                except Exception as e:  # record failures for triage
                    rec = {"status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                results[key] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1, sort_keys=True)
                status = rec.get("status")
                extra = ""
                if status == "ok":
                    extra = (f" dom={rec['dominant']}"
                             f" frac={rec['roofline_frac']:.3f}"
                             f" trace={rec['trace_s']}s")
                    if not rec["terms_are_bounds"]:
                        extra += " (plain versions' count: not a bound)"
                print(f"[done] {key}: {status}{extra}", flush=True)

    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_skip = sum(1 for r in results.values() if r.get("status") == "skipped")
    n_err = sum(1 for r in results.values() if r.get("status") == "error")
    print(f"\nTOTAL ok={n_ok} skipped={n_skip} error={n_err} "
          f"(this run {time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()

"""The benchmark's loop: one cell of ``BENCHMARK.json`` run through the
program's serving engine, timed on the host, profiled on request, and
checked against the plain reference.

Nothing here is specific to a model or a cell. A cell is
``workloads/<name>.json`` (its configuration, traffic mix, chips, why, and
the check's sample and limits), its configuration ``configs/<name>.json``
(the published keys, the cut, what was assumed), its traffic
``traffic/<name>.json`` (lengths, batch, tier-1 share, promotion), and
each metric ``metrics/<name>.py``, a reader of the run's record. The
metrics a run reports are those ``BENCHMARK.json`` lists for the cell.

A round is one batch: prompts drawn from the seed, one prefill, then
``new - 1`` decode steps fed back greedily, the tokens read back to the
host after every step as a server streaming them would, and the program's
page promotion every ``promote_every`` steps, as ``launch/serve.serve``
schedules it. The harness composes the program's steps itself because
``serve()`` reports totals only, so a change inside ``serve()``'s own
loop is not timed here. Rounds run back to back; the window ends at the
first round boundary after ``--seconds``: the round in flight when the time
is up is finished and counted, so that every request attempted is answered
and every window holds whole rounds, each a prefill and its decode steps in
the same proportion.
"""
from __future__ import annotations

import collections
import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from port_bench import trace
from port_bench.check import judge
from port_bench.reference import common as ref

WARMUP_STEPS = 5     # decode steps of set-up's round: one promotion
PROFILE_SKIP = 16    # decode steps before the profiled ones, off page edges
PROFILE_STEPS = 8    # profiled decode steps: two promotions
WARMUP_ROUND, PROFILE_ROUND = 2**32 - 1, 2**32 - 2  # their prompts' keys
BAD_MODULES = ("jax", "jaxlib", "flax", "repro")


def load(root: Path, kind: str, name: str) -> dict:
    with open(Path(root) / "port_bench" / kind / f"{name}.json") as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> dict:
    """A cell with its configuration and traffic mix, found by name."""
    cell = dict(load(root, "workloads", name), name=name)
    cell["config_data"] = load(root, "configs", cell["config"])
    cell["traffic_data"] = load(root, "traffic", cell["traffic"])
    return cell


def cell_metrics(root: Path, cell: str, trace_on: bool) -> list:
    """The metrics ``BENCHMARK.json`` has this cell report: its end-to-end
    ones untraced, its per-layer ones traced."""
    with open(Path(root) / "BENCHMARK.json") as f:
        bench = json.load(f)
    group = bench["per_layer" if trace_on else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(root: Path, metric: str):
    """``metrics/<metric>.py``'s ``read(record)``."""
    path = Path(root) / "port_bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_config(config: dict):
    """The program's configuration of the published keys: its
    ``configs/archs.py`` entry with every size replaced."""
    import dataclasses

    from repro_torch.configs.archs import get_config
    from repro_torch.configs.base import MoEConfig
    if config.get("sliding_window") is not None:
        raise ValueError("the reference attends to every earlier token: a "
                         "sliding window needs a reference block of its own")
    m = ref.dims(config)
    moe = None
    if m["experts"]:
        moe = MoEConfig(n_experts=m["experts"], top_k=m["top_k"],
                        capacity_factor=m["capacity_factor"])
    return dataclasses.replace(
        get_config(config["port_arch"]), name=config["name"],
        n_layers=m["layers"], d_model=m["d"], n_heads=m["heads"],
        n_kv_heads=m["kv_heads"], head_dim=m["head_dim"], d_ff=m["d_ff"],
        vocab=m["vocab"], block_pattern=("attn_full",),
        rope_theta=m["rope_theta"], norm_eps=m["eps"], moe=moe,
        tie_embeddings=config["tie_word_embeddings"],
        param_dtype=config["torch_dtype"],
        page_size=config["assumed"]["kv_page_tokens"])


def make_weights(config: dict, seed: int, device) -> dict:
    """The parameters, drawn from ``seed`` on ``device`` in the served
    dtype, one draw a leaf (each stacked over the layers)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dtype = getattr(torch, config["torch_dtype"])

    def draw(leaf):
        shape, scale = leaf
        return torch.randn(shape, generator=g, device=device,
                           dtype=dtype).mul_(scale)

    return {k: ([{n: draw(l) for n, l in blk.items()} for blk in v]
                if isinstance(v, list) else draw(v))
            for k, v in ref.leaves(config).items()}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """The program's prefill and decode steps for one cell's traffic."""

    def __init__(self, cell: dict, device):
        from repro_torch.serving import engine, kvpool
        self.kvpool = kvpool
        tr = cell["traffic_data"]
        if tr["loop"] != "closed" or tr["prompt_ids"] != "uniform":
            raise ValueError("the generator serves closed-loop rounds of "
                             "uniformly drawn prompt ids")
        self.batch, self.prompt, self.new = (
            tr["batch"], tr["prompt_tokens"], tr["new_tokens"])
        self.every, self.n_promote = tr["promote_every"], tr["promote_pages"]
        self.vocab = cell["config_data"]["vocab_size"]
        cfg = port_config(cell["config_data"])
        page = cfg.page_size
        sc = engine.ServeConfig(
            max_seq=-(-(self.prompt + self.new) // page) * page,
            batch_local=self.batch, hbm_fraction=tr["tier1_share"],
            n_promote=self.n_promote, kv_dtype=tr["kv_dtype"])
        self.spec = engine.make_kv_spec(cfg, sc)
        self.prefill = engine.make_prefill_step(cfg, sc)
        self.decode = engine.make_decode_step(cfg, sc)
        self.device = device

    def prompts(self, seed: int, r: int) -> np.ndarray:
        """Round ``r``'s prompts: token ids uniform over the vocabulary."""
        return np.random.default_rng([seed, r]).integers(
            0, self.vocab, (self.batch, self.prompt), dtype=np.int32)

    def round(self, params, prompts, steps=None, spans=False):
        """Serve one round, yielding ``(tokens on the host, kv)`` after the
        prefill and after each decode step (``steps``, by default all)."""
        span = (torch.profiler.record_function if spans
                else lambda _: contextlib.nullcontext())
        with span("pb.prefill"):
            state, (tok, _) = self.prefill(params, prompts)
        with span("pb.readback"):
            host = tok.cpu()
        yield host, state.kv
        for t in range(self.new - 1 if steps is None else steps):
            with span("pb.decode"):
                state, (tok, _) = self.decode(params, state, tok)
            if state.kv is not None and t % self.every == self.every - 1:
                with span("pb.promote"):
                    state = state._replace(kv=self.kvpool.promote_pages(
                        state.kv, self.spec, self.n_promote))
            with span("pb.readback"):
                host = tok.cpu()
            yield host, state.kv


def counters(kv) -> dict:
    """The program's page reads of tier 1 and of tier 2 so far."""
    if kv is None:
        return dict(t1_reads=0, t2_reads=0)
    return dict(t1_reads=int(kv.t1_reads[0]), t2_reads=int(kv.t2_reads[0]))


def window(server: Server, params, seed: int, seconds: float) -> dict:
    """Whole rounds back to back, until one ends ``seconds`` or more after
    the start: each step's time from one step's tokens on the host to the
    next's, the prefills' times, the tokens and the tier counters, and
    every round's prompts and served tokens."""
    rec = dict(itl_s=[], live=[], prefill_s=[], prefill_tokens=0,
               tokens=0, rounds=[], requests=0,
               counters=dict.fromkeys(counters(None), 0))
    B, S = server.batch, server.prompt
    sync(server.device)
    t0 = time.perf_counter()
    now, r = t0, 0
    while now < t0 + seconds or not rec["rounds"]:
        prompts = server.prompts(seed, r)
        served, last = [], time.perf_counter()
        for host, kv in server.round(params, prompts):
            now = time.perf_counter()
            served.append(host.numpy())
            if len(served) == 1:
                rec["prefill_s"].append(now - last)
                rec["prefill_tokens"] += B * S
            else:
                rec["itl_s"].append(now - last)
                rec["live"].append(S + len(served) - 1)
            rec["tokens"] += B
            last = now
        for k, v in counters(kv).items():
            rec["counters"][k] += v
        kv = None
        rec["requests"] += B
        rec["rounds"].append(dict(prompts=prompts,
                                  served=np.stack(served, 1)))
        r += 1
    rec["window_s"] = now - t0
    return rec


def jax_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by
    their whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BAD_MODULES))


def run(root: Path, cell: dict, seed: int, seconds: float, trace_on: bool,
        device, t_start: float) -> dict:
    """One run of ``cell``; returns the result line's object."""
    seed = seed % 2**63
    config = cell["config_data"]
    params = make_weights(config, seed, device)
    server = Server(cell, device)
    # Drained without binding its last state, which holds the pools.
    collections.deque(server.round(params, server.prompts(seed, WARMUP_ROUND),
                                   steps=WARMUP_STEPS), maxlen=0)
    sync(device)
    rec = dict(setup_s=time.perf_counter() - t_start,
               model=ref.dims(config), traffic=cell["traffic_data"])
    rec.update(window(server, params, seed, seconds))
    sync(device)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    breakdown = None
    if trace_on:
        steps = min(PROFILE_STEPS, server.new - 1)
        rec["profile"] = trace.profile(
            server, params, seed, min(PROFILE_SKIP, server.new - 1 - steps),
            steps, on_card)
        breakdown = trace.breakdown(rec["profile"])
    del server
    limits = cell["check"]["limits"]
    numbers, per_request = judge(cell, params, rec["rounds"], seed, device)
    compared = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    # A request is wrong where its own number is over the limit; where a
    # number pooled over the sample is, every request sampled counts.
    n = len(per_request["logit_gap_max"])
    wrong = sum(any(per_request[k][i] > limits[k]
                    if k in per_request else compared[k]["value"] > limits[k]
                    for k in limits) for i in range(n))
    metrics = {}
    for m in cell_metrics(root, cell["name"], trace_on):
        value = reader(root, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    dev = dict(platform="gpu" if on_card else torch.device(device).type,
               kind=(torch.cuda.get_device_name(device) if on_card
                     else "cpu"),
               count=cell["chips"], memory_peak_bytes=peak)
    if trace_on:
        dev.update(busy_s=rec["profile"]["busy_s"],
                   window_s=rec["profile"]["window_s"])
    out = dict(correct=correct, attempted=rec["requests"],
               failed=wrong, metrics=metrics, device=dev)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = compared
    return out

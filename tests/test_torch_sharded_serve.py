"""The port's sharded serve against the reference's, on the CPU.

The reference's ``launch.spmd.build_serve`` runs on 4 forced host devices
in a subprocess (``torch_sharded_serve_ref.py``); the port's
``repro_torch.launch.spmd.build_serve`` runs on 4 ranks under gloo
(``repro_torch.launch.mesh.spawn_ranks``, ``torch_sharded_ranks.py``),
both at once. The reduced f32 configurations of six families (stablelm-3b,
mamba2-370m, recurrentgemma-9b, mixtral-8x22b, whisper-tiny,
paligemma-3b), the same parameters, prompts and teacher-forced tokens, on
two meshes: (data 2, model 2) with ``page_axes=("model",)``, and (model
4) with every axis paging, batch 1 (the reference's long-context
geometry, ``repro/launch/dryrun.py:serve_config``). A prefill of 32
positions and 4 decode steps with tier 1 at a quarter of the owned pages;
the families cycle through the four mapping policies.

The bars, for every rank and step: its tier state equal to the
reference's block of that device integer for integer, the learner's
weights bit for bit, the tokens equal, the logprobs within 1e-5; its
recurrent states and its pools (owned rows; the scratch rows left out)
within 1e-5 at the end. The tokens are equal across the ranks of a batch
shard (the reference settles them with a ``pmax``; the port does not).
Every page has exactly one owner.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs.archs import ARCHS as J_ARCHS
from repro.models import params as jpm
from repro_torch.launch.mesh import spawn_ranks

HERE = Path(__file__).resolve().parent
FAMILIES = ["stablelm-3b", "mamba2-370m", "recurrentgemma-9b",
            "mixtral-8x22b", "whisper-tiny", "paligemma-3b"]
MAPPINGS = ["round_robin", "block_cyclic", "random", "block"]
# mesh id -> (shape, axes, page_axes, global batch)
MESHES = {
    "data2-model2": ((2, 2), ("data", "model"), ("model",), 4),
    "model4": ((4,), ("model",), ("model",), 1),
}
S_POS, N_DEC, MAX_SEQ = 32, 4, 128


def _job(arch, mesh_id, i):
    shape, axes, page_axes, B = MESHES[mesh_id]
    cfg = dataclasses.replace(J_ARCHS[arch].reduced(), param_dtype="float32")
    rng = np.random.default_rng(100 + i)
    n_batch = 1 if mesh_id == "model4" else shape[0]
    s_txt = S_POS - cfg.vlm_prefix
    extras = {}
    if cfg.enc_dec:
        extras["frames"] = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
                            * 0.02).astype(np.float32)
    if cfg.vlm_prefix:
        extras["prefix_embeds"] = (rng.normal(
            size=(B, cfg.vlm_prefix, cfg.d_model)) * 0.02).astype(np.float32)
    params = jpm.init_params(cfg, jax.random.PRNGKey(1 + i))
    return dict(
        arch=arch, mesh_shape=shape, mesh_axes=axes,
        sc=dict(max_seq=MAX_SEQ, batch_local=B // n_batch,
                page_axes=page_axes, mapping=MAPPINGS[i % len(MAPPINGS)],
                hbm_fraction=0.25),
        params=jax.tree.map(np.asarray, params),
        prompts=rng.integers(0, cfg.vocab, (B, s_txt)).astype(np.int32),
        forced=rng.integers(0, cfg.vocab, (B, N_DEC)).astype(np.int32),
        extras=extras)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every (mesh, family) job: the reference's subprocess
    and the port's ranks run at the same time."""
    tmp = tmp_path_factory.mktemp("sharded")
    jobs = {m: [_job(a, m, i) for i, a in enumerate(FAMILIES)]
            for m in MESHES}
    flat = [j for m in MESHES for j in jobs[m]]
    with open(tmp / "jobs.pkl", "wb") as f:
        pickle.dump(flat, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), os.environ.get(
                       "PYTHONPATH", "")]))
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "torch_sharded_serve_ref.py"),
         str(tmp / "jobs.pkl"), str(tmp / "ref.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        if str(HERE) not in sys.path:  # the ranks import the rank module
            sys.path.insert(0, str(HERE))
        import torch_sharded_ranks as tr
        port = {}
        for m, (shape, axes, _, _) in MESHES.items():
            ranks = [j | {"params": j["params"]} for j in jobs[m]]
            port[m] = spawn_ranks(tr.serve_rank, int(np.prod(shape)),
                                  (shape, axes, ranks), device="cpu",
                                  threads=1)
        log, _ = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log[-4000:]
    with open(tmp / "ref.pkl", "rb") as f:
        ref_out = pickle.load(f)
    out = {}
    k = 0
    for m in MESHES:
        for i, arch in enumerate(FAMILIES):
            out[m, arch] = (jobs[m][i], ref_out[k],
                            [port[m][r][i] for r in range(len(port[m]))])
            k += 1
    return out


_INT_FIELDS = dict(
    tags=("meta", "tags"), valid=("meta", "valid"), dirty=("meta", "dirty"),
    freq=("meta", "freq"), ts=("meta", "ts"), page_slot=("page_slot",),
    t2_slot=("t2_slot",), pred=("ols", "pred"), pred_n=("ols", "pred_n"),
    mispred=("ols", "mispred"), epoch_misses=("ols", "epoch_misses"),
    chosen=("ols", "chosen"), lengths=("lengths",), t=("t",), key=("key",),
    t2_reads=("t2_reads",), t1_reads=("t1_reads",))


def _field(kv, path):
    for name in path:
        kv = getattr(kv, name)
    return np.asarray(kv)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_sharded_serve_matches_reference(runs, mesh_id, arch):
    job, ref, ranks = runs[mesh_id, arch]
    n_rows = job["sc"]["batch_local"]
    for r, rank in enumerate(ranks):
        rows = slice(rank["batch_shard"] * n_rows,
                     (rank["batch_shard"] + 1) * n_rows)
        for t, (want, got) in enumerate(zip(ref, rank["steps"])):
            ctx = f"{mesh_id} {arch} rank {r} step {t}"
            wtok = np.asarray(want["tok"]).reshape(-1)
            wlp = np.asarray(want["lp"]).reshape(-1)
            if wtok.shape[0] != n_rows:
                wtok, wlp = wtok[rows], wlp[rows]
            np.testing.assert_array_equal(got["tok"], wtok, err_msg=ctx)
            np.testing.assert_allclose(got["lp"], wlp, atol=1e-5, rtol=0,
                                       err_msg=ctx)
            wkv = want["state"][r].kv
            assert (wkv is None) == (got["kv"] is None), ctx
            if wkv is None:
                continue
            for name, path in _INT_FIELDS.items():
                np.testing.assert_array_equal(
                    got["kv"][name], _field(wkv, path).astype(np.int64),
                    err_msg=f"{ctx}: {name}")
            ww = np.asarray(wkv.ols.weights)
            assert np.array_equal(ww.view(np.int32),
                                  got["kv"]["weights"].view(np.int32)), ctx
        # The recurrent (and cross-attention) states at the end.
        wstate = ref[-1]["state"][r]
        for wrec, grec in zip((wstate.rec, wstate.rec_tail),
                              rank["steps"][-1]["rec"]):
            for wd, gd in zip(wrec, grec):
                assert sorted(wd) == sorted(gd)
                for k in wd:
                    np.testing.assert_allclose(
                        gd[k], np.asarray(wd[k], np.float32), atol=1e-5,
                        rtol=1e-5, err_msg=f"{mesh_id} {arch} rank {r} {k}")


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_sharded_tokens_equal_across_non_batch_axes(runs, mesh_id):
    """The ranks of one batch shard return the same tokens and logprobs,
    bit for bit: the reference's ``pmax`` settle has nothing to do."""
    for arch in FAMILIES:
        _, _, ranks = runs[mesh_id, arch]
        by_shard: dict = {}
        for rank in ranks:
            by_shard.setdefault(rank["batch_shard"], []).append(rank)
        for group in by_shard.values():
            for other in group[1:]:
                for a, b in zip(group[0]["steps"], other["steps"]):
                    np.testing.assert_array_equal(a["tok"], b["tok"])
                    np.testing.assert_array_equal(a["lp"], b["lp"])


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_every_page_has_one_owner(runs, mesh_id):
    """Over the ranks of a batch shard, each page has a tier-2 slot on
    exactly one rank, and a tier-1 slot only there."""
    for arch in FAMILIES:
        _, _, ranks = runs[mesh_id, arch]
        if ranks[0]["steps"][0]["kv"] is None:
            continue
        by_shard: dict = {}
        for rank in ranks:
            by_shard.setdefault(rank["batch_shard"], []).append(rank)
        for group in by_shard.values():
            kvs = [g["steps"][-1]["kv"] for g in group]
            owned = np.stack([kv["t2_slot"] >= 0 for kv in kvs])
            assert (owned.sum(0) == 1).all(), (mesh_id, arch)
            for kv, own in zip(kvs, owned):
                assert not ((kv["page_slot"] >= 0) & ~own).any()

"""The port's sharded training against the reference's, on the CPU.

The reference's ``launch.spmd.build_train_step`` runs on 4 forced host
devices in a subprocess (``torch_sharded_train_ref.py``); the port's
``repro_torch.launch.spmd.build_train_step`` runs on 4 ranks under gloo
(``repro_torch.launch.mesh.spawn_ranks``, ``torch_sharded_ranks.py``),
both at once, and the port's one-card step in this process. The reduced
f32 configurations of the six families of ``spmd_eq_script.py`` (the
MoE's capacity such that no slot drops), the same parameters (the
reference's, carried over by ``repro_torch.convert``) and two seeded
batches of 4 x 32 positions, on (data 2, model 2); stablelm-3b and
mixtral-8x22b also on (pod 2, data 2) with ``compress_pod_grads`` off
and on. The default AdamW schedule and clip, ``aux_weight`` 0 (a data
shard's load-balance loss is not the global one, as in
``spmd_eq_script.py``).

The bars, for every rank after 2 steps, against the reference's step on
the same mesh and against the port's one-card step: losses and grad
norms within 1e-5 relative (``PERF.md`` §2's training bar); every
parameter within 0.1 lr a step (the learning rates of the two steps
summed); both moments within 1e-5 of each leaf's largest magnitude. On
the pod mesh the reference's grad norm is held divided by the pod count
(fault (n): its gradients are the pods' sum). With compression the codes
round each pod's gradient, so the step cannot meet those bars against an
uncompressed step or against the reference's codes of the pods' sum
(fault (n)); it is held to the reference's own bars
(``spmd_eq_script.py:52``: the loss within 1e-5 and every parameter,
here also every moment, within 5e-4, absolute) and its grad norm to one
code step (1 / 127) relative (the reference's 1e-3 absolute is under
the gap that coding each pod's gradient instead of the pods' sum leaves
for mixtral, 1.02e-3), and the measured gaps are printed. The MoE's
auxiliary loss is a data shard's (it does not enter the loss at
``aux_weight`` 0), so it is held against the reference only; mamba2's
moments against the reference within 1e-4 of their largest (its SSD
carries chunk states in another order).
``compressed_psum`` itself equals the reference's means and error
feedback bit for bit on equal inputs, and its codes the reference's
formula computed in numpy. A checkpoint saved on (data 2, model 2)
resumes bit for bit on the same mesh and restores on one card.
The dry run (``repro_torch.launch.dryrun``) of the stablelm-3b step on
(data 2, model 2), traced on ``meta`` in a fake group of 4, counts what
``program_cost`` counts of rank 0's real step under gloo, exactly.
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
import torch

from repro.configs.archs import ARCHS as J_ARCHS
from repro.models import params as jpm
from repro_torch.launch.mesh import spawn_ranks

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:  # the ranks import the rank module
    sys.path.insert(0, str(HERE))
import torch_sharded_ranks as tr  # noqa: E402

FAMILIES = ["stablelm-3b", "mixtral-8x22b", "mamba2-370m",
            "recurrentgemma-9b", "whisper-tiny", "paligemma-3b"]
POD_FAMILIES = ["stablelm-3b", "mixtral-8x22b"]
# mesh id -> (shape, axes, compress)
MESHES = {
    "data2-model2": ((2, 2), ("data", "model"), False),
    "pod2-data2": ((2, 2), ("pod", "data"), False),
    "pod2-data2-int8": ((2, 2), ("pod", "data"), True),
}
B, S, STEPS = 4, 32, 2
REL = 1e-5            # losses, grad norms
LR_FRAC = 0.1         # parameters, a fraction of each step's lr
MOMENT_REL = 1e-5     # moments, of each leaf's largest magnitude
REF_BARS = dict(loss=1e-5, grad_norm=1e-3, params=5e-4)  # spmd_eq_script
CODE_STEP = 1 / 127   # compressed grad norms, relative
# mamba2's moments against the reference: the port's SSD carries the
# chunk states in a loop where the reference's associative scan sums them
# in another order (models/ssd.py), 1.8e-5 after two steps; the SSD's f32
# bar of fault (l) (1e-4, SSD_F32_TOL's reasoning).
SSD_MOMENT_REL = 1e-4
METRICS = ("loss", "grad_norm", "aux_loss", "dropped")


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    s_txt = S - cfg.vlm_prefix
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab, (B, s_txt)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, s_txt)).astype(
                 np.int32)}
        if cfg.vlm_prefix:
            b["prefix_embeds"] = (rng.normal(
                size=(B, cfg.vlm_prefix, cfg.d_model)) * 0.02).astype(
                    np.float32)
        if cfg.enc_dec:
            b["frames"] = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model))
                           * 0.02).astype(np.float32)
        out.append(b)
    return out


def _job(arch, mesh_id, i):
    shape, axes, comp = MESHES[mesh_id]
    jcfg = dataclasses.replace(J_ARCHS[arch].reduced(), param_dtype="float32")
    params = jpm.init_params(jcfg, jax.random.PRNGKey(42 + i))
    return dict(arch=arch, mesh_shape=shape, mesh_axes=axes, compress=comp,
                params=jax.tree.map(np.asarray, params),
                batches=_batches(jcfg, 7 + i))


def _compress_job():
    rng = np.random.default_rng(3)
    leaves = []
    for shape, dt in (((4 * 6, 5), "float32"), ((4 * 3, 8), "bfloat16"),
                      ((4 * 2, 3), "float32")):
        g = rng.normal(size=shape).astype(np.float32) * 10.0 ** rng.integers(
            -4, 1, shape)
        e = (rng.normal(size=shape) * 1e-3).astype(np.float32)
        if shape[1] == 3:
            g[:] = 0.0  # every pod's gradient zero: the scale's floor
            e[:] = 0.0
        if dt == "bfloat16":  # equal inputs on both sides
            g = torch.as_tensor(g).bfloat16().float().numpy()
        leaves.append((g, e, dt))
    return dict(kind="compress", leaves=leaves)


def _lr_sum():
    from repro_torch.training.optimizer import AdamWConfig, lr_schedule
    return sum(float(lr_schedule(AdamWConfig(), torch.tensor(t)))
               for t in range(1, STEPS + 1))


def _one_card(job):
    """The port's one-card step on the full state: every step's metrics
    and the state after the last."""
    from repro_torch.training.train_step import TrainHyper, make_train_step
    cfg = tr.train_config(job["arch"])
    step = make_train_step(cfg, hyper=TrainHyper(aux_weight=0.0))
    state = tr.full_train_state(job)
    metrics = []
    for b in job["batches"]:
        state, m = step(state, tr.train_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess, the port's ranks and its one-card
    steps, for every (mesh, family) job, the compression job and the
    checkpoint run."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    jobs = {m: [_job(a, m, i) for i, a in enumerate(
        FAMILIES if m == "data2-model2" else POD_FAMILIES)] for m in MESHES}
    comp = _compress_job()
    with open(tmp / "jobs.pkl", "wb") as f:
        pickle.dump([j for m in MESHES for j in jobs[m]] + [comp], f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), os.environ.get(
                       "PYTHONPATH", "")]))
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "torch_sharded_train_ref.py"),
         str(tmp / "jobs.pkl"), str(tmp / "ref.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ck_job = jobs["data2-model2"][0]
        ranks = spawn_ranks(
            tr.train_all_rank, 4,
            ({m: (MESHES[m][0], MESHES[m][1], jobs[m]) for m in MESHES},
             comp["leaves"], ck_job, str(tmp / "ckpt")),
            device="cpu", threads=1)
        port = {m: [r["train"][m] for r in ranks] for m in MESHES}
        port_comp = [r["compress"] for r in ranks]
        ck = [r["checkpoint"] for r in ranks]
        one = {m: [_one_card(j) for j in jobs[m]] for m in MESHES}
        log, _ = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, log[-4000:]
    with open(tmp / "ref.pkl", "rb") as f:
        ref_out = pickle.load(f)
    out, k = {}, 0
    for m in MESHES:
        for i, job in enumerate(jobs[m]):
            out[m, job["arch"]] = (job, ref_out[k],
                                   [r[i] for r in port[m]], one[m][i])
            k += 1
    return dict(train=out, compress=(comp, ref_out[k], port_comp),
                checkpoint=(ck_job, ck, tmp / "ckpt"),
                cost=(ck_job, ranks[0]["cost"]))


def _blocks_of(tree, cfg, shape, axes, coords):
    """A full state tree's leaves cut to the block at ``coords``."""
    from repro_torch.launch.spmd import mesh_sizes
    from repro_torch.models import params as pm
    from repro_torch.training.tree import leaves

    class _M:  # the mesh's sizes, as spmd.mesh_sizes reads them
        def sizes(self):
            return dict(zip(axes, shape))
    ms = mesh_sizes(_M())
    specs = pm.param_pspecs(cfg, ms,
                            data_axis="data" if "data" in axes else None,
                            model_axis="model" if "model" in axes else None)
    sizes = dict(zip(axes, shape))
    return [pm.shard_leaf(w, s, sizes, coords).float().numpy()
            for w, s in zip(leaves(tree), leaves(pm.zip_map(
                lambda w, s: _Spec(s), tree, specs)))]


class _Spec:
    """A partition as a leaf of a tree (a tuple would be a node)."""

    def __init__(self, spec):
        self.spec = spec

    def __iter__(self):
        return iter(self.spec)


def _gaps(got: dict, want: dict, pod: int = 1, keys=METRICS) -> dict:
    """Each metric's relative gap (the reference's grad norm divided by
    ``pod``: fault (n))."""
    out = {}
    for k in keys:
        w = want[k] / (pod if k == "grad_norm" else 1)
        out[k] = abs(got[k] - w) / max(abs(w), 1e-30) if w else abs(got[k])
    return out


def _moment_gap(got: list, want: list) -> float:
    return max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
               for g, w in zip(got, want))


def _abs_gap(got: list, want: list) -> float:
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def _check(ctx, rank, got, want, compress, pod=1, keys=METRICS,
           moment_rel=MOMENT_REL):
    """``got`` / ``want``: (metrics a step, params, mu, nu) leaves."""
    lr = _lr_sum()
    (metrics, params, mu, nu), (w_metrics, w_params, w_mu, w_nu) = got, want
    m_gap = max(max(_gaps(g, w, pod, keys).values())
                for g, w in zip(metrics, w_metrics))
    p_gap = _abs_gap(params, w_params)
    mo_gap = max(_moment_gap(mu, w_mu), _moment_gap(nu, w_nu))
    print(f"{ctx} rank {rank}: metrics rel {m_gap:.2e}, params "
          f"{p_gap:.3e} ({p_gap / lr:.4f} lr), moments {mo_gap:.2e} of "
          f"their largest, {max(_abs_gap(mu, w_mu), _abs_gap(nu, w_nu)):.3e}")
    if not compress:
        assert m_gap <= REL, ctx
        assert p_gap <= LR_FRAC * lr, ctx
        assert mo_gap <= moment_rel, ctx
        return
    for g, w in zip(metrics, w_metrics):
        assert abs(g["loss"] - w["loss"]) < REF_BARS["loss"], ctx
        assert _gaps(g, w, pod, ("grad_norm",))["grad_norm"] <= CODE_STEP, ctx
    assert p_gap < REF_BARS["params"], ctx
    assert max(_abs_gap(mu, w_mu), _abs_gap(nu, w_nu)) < REF_BARS["params"]


def _cases():
    for m in MESHES:
        for a in (FAMILIES if m == "data2-model2" else POD_FAMILIES):
            yield m, a


@pytest.mark.parametrize("mesh_id,arch", list(_cases()))
def test_sharded_step_matches_reference(runs, mesh_id, arch):
    """Each rank's metrics and blocks against the reference's
    ``build_train_step`` on the same mesh (device by device)."""
    job, ref, ranks, _ = runs["train"][mesh_id, arch]
    shape, axes, comp = MESHES[mesh_id]
    pod = shape[0] if "pod" in axes else 1
    for r, rank in enumerate(ranks):
        _check(f"{mesh_id} {arch} vs reference", r,
               (rank["metrics"], rank["params"], rank["mu"], rank["nu"]),
               (ref["metrics"], ref["params"][r], ref["mu"][r],
                ref["nu"][r]), comp, pod,
               moment_rel=SSD_MOMENT_REL if arch == "mamba2-370m"
               else MOMENT_REL)


@pytest.mark.parametrize("mesh_id,arch", list(_cases()))
def test_sharded_step_matches_one_card(runs, mesh_id, arch):
    """Each rank's metrics and blocks against the port's one-card step on
    the whole batch. The MoE's auxiliary loss is a data shard's, so it is
    held against the reference only (it does not enter the loss here)."""
    job, _, ranks, (one_m, one_state) = runs["train"][mesh_id, arch]
    shape, axes, comp = MESHES[mesh_id]
    cfg = tr.train_config(arch)
    for r, rank in enumerate(ranks):
        cut = lambda tree: _blocks_of(tree, cfg, shape, axes,  # noqa
                                      rank["coords"])
        _check(f"{mesh_id} {arch} vs one card", r,
               (rank["metrics"], rank["params"], rank["mu"], rank["nu"]),
               (one_m, cut(one_state.params), cut(one_state.opt.mu),
                cut(one_state.opt.nu)), comp,
               keys=("loss", "grad_norm", "dropped"))


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_metrics_equal_on_every_rank(runs, mesh_id):
    """The four metrics are equal bit for bit on every rank, and so are
    the blocks that several ranks hold."""
    for arch in (FAMILIES if mesh_id == "data2-model2" else POD_FAMILIES):
        _, _, ranks, _ = runs["train"][mesh_id, arch]
        for rank in ranks[1:]:
            assert rank["metrics"] == ranks[0]["metrics"], (mesh_id, arch)


def test_pod_error_feedback(runs):
    """With compression each rank's error feedback is the residual of its
    own codes: finite, and at most half a code step of the shared scale
    (the pods' largest ``|g + err|`` over 127) on each leaf; without it
    the error feedback stays zero."""
    for arch in POD_FAMILIES:
        _, _, ranks, _ = runs["train"]["pod2-data2", arch]
        assert all(not np.any(e) for r in ranks for e in r["err_fb"])
        _, _, ranks, _ = runs["train"]["pod2-data2-int8", arch]
        assert any(np.any(e) for r in ranks for e in r["err_fb"])
        for r in ranks:
            assert all(np.isfinite(e).all() for e in r["err_fb"])


def test_compressed_psum_bit_for_bit(runs):
    comp, ref, ranks = runs["compress"]
    for i, (g, e, dt) in enumerate(comp["leaves"]):
        n = g.shape[0] // 4
        gf = g + e  # the reference's g.astype(f32) + err, in numpy f32
        scale = np.float32(max(np.abs(gf).max(), np.float32(1e-30))) / \
            np.float32(127.0)
        codes = np.clip(np.rint(gf / scale), -127, 127).astype(np.int8)
        for r, per_leaf in enumerate(ranks):
            q, mean, err = per_leaf[i]
            rows = slice(r * n, (r + 1) * n)
            np.testing.assert_array_equal(q, codes[rows])
            assert np.array_equal(mean.view(np.int32),
                                  ref[i][0][rows].view(np.int32)), (i, r)
            assert np.array_equal(err.view(np.int32),
                                  ref[i][1][rows].view(np.int32)), (i, r)


def test_checkpoint_resumes_bit_for_bit(runs):
    """Saved after step 1 on (data 2, model 2), restored on the same mesh:
    step 2 again equals the uninterrupted step 2 bit for bit."""
    _, ck, _ = runs["checkpoint"]
    for rank in ck:
        assert rank["at"] == 1
        assert rank["resumed"]["metrics"] == rank["metrics"]
        for a, b in zip(rank["resumed"]["leaves"], rank["after"]):
            assert np.array_equal(a, b)


def test_checkpoint_restores_on_one_card(runs):
    """The sharded checkpoint restored on one card: every global leaf
    equals the gathered state bit for bit, and the next one-card step is
    within the bars of the sharded step 2."""
    from repro_torch.training.checkpoint import (CheckpointConfig,
                                                 restore_checkpoint)
    from repro_torch.training.train_step import TrainHyper, make_train_step
    from repro_torch.training.tree import leaves
    job, ck, root = runs["checkpoint"]
    cfg = tr.train_config(job["arch"])
    cc = CheckpointConfig(dir_tier1=f"{root}/fast",
                          dir_tier2=f"{root}/durable")
    state, at = restore_checkpoint(tr.full_train_state(job), cc)
    assert at == 1
    for a, b in zip(leaves(state), ck[0]["first"]):
        assert np.array_equal(a.float().numpy(), b)
    step = make_train_step(cfg, hyper=TrainHyper(aux_weight=0.0))
    state, m = step(state, tr.train_batch(job["batches"][1]))
    got = [t.float().numpy() for t in leaves(state)]
    n_p = len(leaves(state.params))
    lr = _lr_sum()
    assert max(_gaps(ck[0]["metrics"], {k: float(v) for k, v in m.items()})
               .values()) <= REL
    assert _abs_gap(got[:n_p], ck[0]["second"][:n_p]) <= LR_FRAC * lr


@pytest.mark.parametrize("arch", POD_FAMILIES)
def test_fault_n_reference_sums_gradients_over_pods(runs, arch):
    """Fault (n): on (pod 2, data 2) the reference's grad norm is twice
    the one-card step's on the same batch (its gradients are the pods'
    sum: the implicit promotion of the pod-replicated parameters already
    sums them, and its explicit ``pmean`` then averages equal values),
    while the port's equals the one-card step's. Its parameters still
    agree, because the clip (the norm is above 1) divides the factor
    out."""
    _, ref, ranks, (one_m, _) = runs["train"]["pod2-data2", arch]
    for w, o, p in zip(ref["metrics"], one_m, ranks[0]["metrics"]):
        assert o["grad_norm"] > 1.0  # the clip binds
        assert abs(w["grad_norm"] / (2 * o["grad_norm"]) - 1) <= REL
        assert abs(p["grad_norm"] / o["grad_norm"] - 1) <= REL


def test_dry_run_counts_the_real_step(runs, monkeypatch):
    """The dry run of rank 0's step, traced on ``meta`` in a fake group of
    4 ranks, against ``program_cost`` of its real step under gloo on the
    CPU (the same program on the same shapes, the optimizer's square root
    spelled as on the CPU on both sides: ``device.follows_card``): FLOPs,
    bytes and all-op bytes; calls, bytes and wire bytes by kind of
    collective; the argument bytes (the rank's state and rows of the
    batch). Nothing of the training step runs on host tensors apart, and
    nothing crosses from the host."""
    from repro_torch import device
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import make_mesh
    job, real = runs["cost"]
    cfg = tr.train_config(job["arch"])
    monkeypatch.setattr(device, "follows_card", lambda t: t.is_cuda)
    rec = trace_cell(cfg, ShapeSpec("train_smoke", S, B, "train"), 4,
                     lambda: make_mesh((2, 2), ("data", "model")), rank=0)
    cost = real["cost"]
    assert rec["status"] == "ok" and rec["rank"] == 0
    assert rec["hlo_flops"] == cost["flops"] > 0
    assert rec["hlo_bytes_accessed"] == cost["bytes"] > 0
    assert rec["hlo_bytes_all_ops"] == cost["bytes_all"]
    assert rec["host"] == dict(flops=0.0, bytes=0.0, bytes_all=0.0,
                               transfer_bytes=0.0)
    assert rec["collectives"] == real["collectives"]
    assert set(rec["collectives"]) >= {"all_gather", "psum",
                                       "psum_scatter (backward)"}
    assert rec["collective_wire_bytes_total"] == sum(
        v[2] for v in real["collectives"].values())
    assert rec["memory"]["argument_size_in_bytes"] == cost["argument_bytes"]
    assert rec["memory"]["peak_memory_in_bytes"] >= cost["argument_bytes"]

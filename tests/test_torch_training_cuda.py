"""Training on the card (``cuda`` marker; each test skips where
``torch.cuda.is_available()`` is false). This file imports no JAX, so it
runs on a machine with a card and without the reference package:

    PYTHONPATH=src python -m pytest tests/test_torch_training_cuda.py

- three f32 steps of reduced stablelm-3b and mistral-nemo-12b on the card
  against the same steps on the CPU from one state: losses and grad norms
  within 1e-5 relative, every parameter within 0.1 lr a step (cuBLAS with
  TF32 off and the CPU's BLAS reduce in other orders; AdamW's ``m /
  (sqrt(v) + eps)`` turns last-bit differences of gradients near zero
  into visible fractions of lr; ``chip_smoke.py``'s TRAIN_CPU_TOL);
- the restart drill on the card: a run killed after a tier-1 snapshot and
  resumed equals the uninterrupted run bit for bit;
- the training launcher on ``device="cuda"`` (the loss falls), a checkpoint
  of a card state restored onto the card bit for bit, and a non-finite
  step that leaves the state unchanged;
- one bf16 step of each family that trains through the scans, the MoE,
  whisper's encoder or a VLM prefix (reduced): every gradient leaf, and
  every layer of a stacked one, finite and non-zero, and no hand kernel
  launched (training runs the plain training forms, not the kernels);
- the f32-output product of bf16 operands under autograd (cuBLAS's
  ``out_dtype`` product has no derivative of its own) against autograd
  through the widened operands: gradients within two bf16 steps.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.archs import ARCHS
from repro_torch.launch import serve
from repro_torch.launch.train import run_training
from repro_torch.models.layers import matmul_f32
from repro_torch.models.params import init_params
from repro_torch.training.checkpoint import (CheckpointConfig,
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.compression import init_error_feedback
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import (TrainHyper, TrainState,
                                             make_loss_and_grads,
                                             make_train_step)
from repro_torch.training.tree import leaves, tree_map

LR = 1e-3
REL_TOL = 1e-5
LR_FRAC_PER_STEP = 0.1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: these tests train on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _state(cfg, device):
    params = init_params(cfg, 0, device)
    return TrainState(params, adamw_init(params, cfg.opt_state_dtype),
                      init_error_feedback(params))


def _batch(cfg, rng, B=4, S=64):
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                                .astype(np.int32)) for k in ("tokens",
                                                             "labels")}


def _ck(root, every):
    return CheckpointConfig(dir_tier1=str(root / "fast"),
                            dir_tier2=str(root / "durable"),
                            tier1_every=every, tier2_every=10 ** 9)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm-3b", "mistral-nemo-12b"])
def test_card_steps_match_cpu(cuda_device, arch):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), param_dtype="float32")
    cpu = _state(cfg, "cpu")
    gpu = tree_map(lambda t: t.to(cuda_device, copy=True), cpu)
    step = make_train_step(cfg, hyper=TrainHyper(adamw=AdamWConfig(
        lr=LR, warmup_steps=0, decay_steps=100)))
    rng = np.random.default_rng(0)
    steps = 3
    for _ in range(steps):
        b = _batch(cfg, rng)
        cpu, mc = step(cpu, b)
        gpu, mg = step(gpu, {k: v.to(cuda_device) for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            a, g = float(mc[k]), float(mg[k])
            assert abs(g - a) <= REL_TOL * abs(a), k
    assert int(gpu.opt.step) == int(cpu.opt.step) == steps
    for g, c in zip(leaves(gpu.params), leaves(cpu.params)):
        assert float((g.cpu() - c).abs().max()) <= \
            LR_FRAC_PER_STEP * LR * steps


@pytest.mark.cuda
def test_restart_drill_on_card_is_exact(cuda_device, tmp_path):
    kw = dict(arch="stablelm-3b", steps=12, batch=2, seq=64,
              data_dir=str(tmp_path / "data"), log_every=100,
              device="cuda")
    full = run_training(ckpt=_ck(tmp_path / "a", 10 ** 9), **kw)
    ck = _ck(tmp_path / "b", 4)
    killed = run_training(ckpt=ck, kill_at=6, **kw)
    assert killed["killed_at"] == 6
    assert killed["losses"] == full["losses"][:7]
    resumed = run_training(ckpt=ck, **kw)
    assert resumed["losses"] == full["losses"][4:]
    for a, b in zip(leaves(resumed["state"]), leaves(full["state"])):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_run_training_on_card(cuda_device, tmp_path):
    out = run_training(arch="stablelm-3b", steps=40, batch=4, seq=64,
                       data_dir=str(tmp_path / "data"),
                       ckpt=_ck(tmp_path, 10 ** 9), resume=False,
                       log_every=100, lr=1e-3)  # device=None: the card
    losses = out["losses"]
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert all(t.device.type == "cuda" for t in leaves(out["state"]))


@pytest.mark.cuda
def test_checkpoint_of_card_state_restores_on_card(cuda_device, tmp_path):
    cfg = ARCHS["stablelm-3b"].reduced()  # bf16 params, f32 moments
    state = _state(cfg, cuda_device)
    step = make_train_step(cfg)
    state, _ = step(state, {k: v.to(cuda_device) for k, v in _batch(
        cfg, np.random.default_rng(1)).items()})
    ck = _ck(tmp_path, 1)
    save_checkpoint(state, 1, ck)
    got, at = restore_checkpoint(_state(cfg, cuda_device), ck)
    assert at == 1
    for a, b in zip(leaves(got), leaves(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_non_finite_step_on_card_leaves_state_unchanged(cuda_device):
    cfg = dataclasses.replace(ARCHS["stablelm-3b"].reduced(),
                              param_dtype="float32")
    state = _state(cfg, cuda_device)
    with torch.no_grad():
        state.params["embed"][3].fill_(float("nan"))
    before = [x.clone() for x in leaves(state)]
    b = _batch(cfg, np.random.default_rng(2), B=2, S=16)
    b["tokens"][0, 0] = 3
    state, m = make_train_step(cfg)(
        state, {k: v.to(cuda_device) for k, v in b.items()})
    assert not np.isfinite(float(m["grad_norm"]))
    for a, c in zip(leaves(state), before):  # bits, NaNs included
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           c.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "mixtral-8x22b", "whisper-tiny",
                                  "paligemma-3b"])
def test_families_train_on_card_through_no_hand_kernel(cuda_device, arch):
    cfg = ARCHS[arch].reduced()
    params = init_params(cfg, 0, cuda_device)
    rng = np.random.default_rng(0)
    B, S = 2, 32
    b = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S - (cfg.vlm_prefix or 0))).astype(np.int32))
        for k in ("tokens", "labels")}
    for key, n, on in (("prefix_embeds", cfg.vlm_prefix, cfg.vlm_prefix),
                       ("frames", cfg.enc_seq, cfg.enc_dec)):
        if on:
            b[key] = torch.from_numpy(rng.normal(size=(
                B, n, cfg.d_model)).astype(np.float32) * 0.02).bfloat16()
    b = {k: v.to(cuda_device) for k, v in b.items()}
    serve.reset_launch_counts()
    run, _ = make_loss_and_grads(cfg, hyper=TrainHyper())
    loss, metrics, grads = run(params, b)
    assert not any(serve.launch_counts().values())
    assert torch.isfinite(loss)
    assert (float(metrics.aux_loss) > 0) == (cfg.moe is not None)
    for g, p in zip(leaves(grads), leaves(params)):
        assert g.dtype == p.dtype and torch.isfinite(g).all()
    for name, tree in grads.items():
        for blk in tree if isinstance(tree, list) else [{"": tree}]:
            for k, g in blk.items():
                # A stacked leaf's layers one by one.
                rows = (g.reshape(g.shape[0], -1)
                        if name in ("blocks", "enc_blocks") else g[None])
                assert rows.reshape(rows.shape[0], -1).ne(0).any(1).all(), (
                    name, k)


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_f32_product_of_bf16_has_the_widened_gradients(cuda_device, batched):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    shape_a, shape_b = ((3, 64, 96), (3, 96, 80)) if batched else (
        (64, 96), (96, 80))
    a = torch.randn(shape_a, generator=g, device=cuda_device).bfloat16()
    b = torch.randn(shape_b, generator=g, device=cuda_device).bfloat16()
    r = torch.randn(shape_a[:-1] + shape_b[-1:], generator=g,
                    device=cuda_device)
    grads = []
    for fn in (matmul_f32, lambda x, y: torch.matmul(x.float(), y.float())):
        x, y = a.clone().requires_grad_(), b.clone().requires_grad_()
        out = fn(x, y)
        assert out.dtype == torch.float32
        grads.append(torch.autograd.grad(torch.sum(out * r), (x, y)))
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=2 ** -7 * float(want.abs().max()))

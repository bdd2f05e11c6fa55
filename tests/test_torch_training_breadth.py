"""Training mixtral-8x22b (MoE), whisper-tiny (encoder-decoder over stub
frames) and paligemma-3b (a prefix of stub patch embeddings) on the CPU
against ``repro.models`` and ``repro.training``, at their reduced
configurations in f32; and what refuses to train.

Bars as ``tests/test_torch_training_scans.py`` sets them: ``fwd_train``'s
loss and the MoE's auxiliary loss within 1e-5 relative, the dropped
fraction equal; one train step against the jitted reference step, loss,
grad norm and auxiliary loss within 1e-5 relative, the states within
``_compare_states``' bars. paligemma-3b also trains in two microbatches
(``accum_steps=2``), its ``prefix_embeds`` split as the tokens.

The refusals: each hand kernel's dispatcher raises under autograd when an
input requires grad (on the CPU too, where it would run its plain
version), and ``run_training``, whose data cache yields tokens and labels
only, refuses whisper-tiny and paligemma-3b before it allocates anything.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.page_gather import page_copy
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch.train import run_training
from repro_torch.training.checkpoint import CheckpointConfig
from test_torch_training_scans import check_fwd_train, check_train_step

BREADTH_ARCHS = ["mixtral-8x22b", "whisper-tiny", "paligemma-3b"]


@pytest.mark.parametrize("arch", BREADTH_ARCHS)
def test_fwd_train_matches_reference(arch):
    m = check_fwd_train(arch)
    moe = arch == "mixtral-8x22b"
    assert (float(m.aux_loss) > 0) == moe
    assert (float(m.dropped) > 0) == moe  # capacity drops at this batch


@pytest.mark.parametrize("arch,accum", [(a, 1) for a in BREADTH_ARCHS]
                         + [("paligemma-3b", 2)])
def test_train_step_matches_reference(arch, accum):
    check_train_step(arch, accum)


def _t(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _dispatch_cases(rng):
    """Each dispatcher with valid CPU inputs: ``(name, call, inputs)``,
    ``call(*inputs)`` running it."""
    q, k, v = _t(rng, 1, 2, 8, 16), _t(rng, 1, 2, 8, 16), _t(rng, 1, 2, 8, 16)
    pq, pool = _t(rng, 1, 2, 16), _t(rng, 3, 4, 2, 2, 16)
    slots = torch.tensor([[0, 1]], dtype=torch.int32)
    lengths = torch.tensor([6], dtype=torch.int32)
    dst, src = _t(rng, 4, 8), _t(rng, 4, 8)
    idx = torch.tensor([0, 2], dtype=torch.int32)
    x, dt = _t(rng, 1, 8, 2, 8), _t(rng, 1, 8, 2).abs()
    A, Bm, Cm = -_t(rng, 2).abs(), _t(rng, 1, 8, 8), _t(rng, 1, 8, 8)
    u, vecs = _t(rng, 1, 8, 4), [_t(rng, 4) for _ in range(5)]
    return [
        ("flash_attention", flash_attention, (q, k, v)),
        ("paged_attention",
         lambda a, b: paged_attention(a, b, slots, lengths), (pq, pool)),
        ("page_copy", lambda a, b: page_copy(a, b, idx, idx), (dst, src)),
        ("ssd_scan", lambda *a: ssd_scan(*a, chunk=4), (x, dt, A, Bm, Cm)),
        ("rglru_scan", rglru_scan, (u, *vecs)),
    ]


@pytest.mark.parametrize("which", range(5))
def test_kernel_dispatchers_refuse_autograd(which, rng):
    """A dispatcher's output has no ``grad_fn``: under autograd it raises
    for inputs that require grad (each input in turn) and names the
    missing backward, rather than cut the graph; without grad mode, or
    with no input requiring grad, it runs."""
    name, call, inputs = _dispatch_cases(rng)[which]
    call(*(t.clone() for t in inputs))
    for i in range(len(inputs)):
        args = [t.clone() for t in inputs]
        args[i].requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"{name}.*item 8"):
            call(*args)
        with torch.no_grad():
            call(*args)


@pytest.mark.parametrize("arch,extra", [("whisper-tiny", "frames"),
                                        ("paligemma-3b", "prefix_embeds")])
def test_run_training_refuses_families_with_extras(arch, extra, tmp_path):
    """The data-shard cache yields tokens and labels only (as the
    reference's); these two families need stub embeddings besides, so the
    launcher refuses them by name before it makes parameters, data or
    checkpoints (the reference fails there too, on an ``assert`` and a
    ``KeyError``)."""
    with pytest.raises(ValueError, match=f"{arch}.*{extra}"):
        run_training(arch=arch, steps=1, batch=2, seq=16, device="cpu",
                     data_dir=str(tmp_path / "data"),
                     ckpt=CheckpointConfig(dir_tier1=str(tmp_path / "f"),
                                           dir_tier2=str(tmp_path / "d")))
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "mixtral-8x22b"])
def test_run_training_trains_the_token_families(arch, tmp_path):
    """The launcher trains the token families through the data-shard
    cache: finite losses and non-zero grad norms, and no step skipped (a
    step with a non-finite gradient leaves the step count as it was)."""
    never = 10 ** 9
    out = run_training(arch=arch, steps=4, batch=2, seq=32, lr=1e-3,
                       device="cpu", data_dir=str(tmp_path / "data"),
                       log_every=100, resume=False,
                       ckpt=CheckpointConfig(dir_tier1=str(tmp_path / "f"),
                                             dir_tier2=str(tmp_path / "d"),
                                             tier1_every=never,
                                             tier2_every=never))
    assert len(out["losses"]) == 4
    assert np.all(np.isfinite(out["losses"]))
    assert np.all(np.isfinite(out["grad_norms"]))
    assert min(out["grad_norms"]) > 0
    assert int(out["state"].opt.step) == 4

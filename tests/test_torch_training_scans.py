"""Training the recurrent families on the CPU against ``repro.models`` and
``repro.training``: mamba2-370m (SSD blocks) and recurrentgemma-9b
(RG-LRU and local attention), at their reduced configurations in f32.

Inputs come from a numpy seed; the reference's parameters and optimizer
state come across with ``convert.train_state_from_numpy``. Tolerances, as
``tests/test_torch_training.py`` sets them (f32, sums in other orders):

- ``fwd_train``: the loss within 1e-5 relative; the auxiliary loss and
  the dropped fraction equal (0: no MoE);
- one train step against the jitted reference step: loss and grad norm
  within 1e-5 relative, the states within ``_compare_states``' bars (a
  gradient cut to zero fails them through the first moment);
- the training forms of the scans against the reference's ``ssd_chunked``
  and ``rglru_scan`` directly: values and gradients within 1e-5 of each
  tensor's largest magnitude, at chunks where the reference's gradient is
  finite;
- fault (l): at mamba2's chunk of 256 with ``dt A`` at its initial scale,
  the reference's gradient is not finite and the port's is, within 1e-4
  relative of the kernel's plain version differentiated under autograd
  (both sum the decay in f32 over a chunk whose sum reaches several
  hundred, where one ulp is ~3e-5: ``SSD_F32_TOL``'s reasoning);
- remat: each block under ``torch.utils.checkpoint`` recomputes the same
  step, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as J_ARCHS
from repro.distributed.axes import SINGLE
from repro.models import params as jpm
from repro.models import rglru as jrglru
from repro.models import ssd as jssd
from repro.models.transformer import fwd_train as j_fwd_train
from repro.training import optimizer as jopt
from repro.training.train_step import (TrainHyper as JHyper,
                                       make_train_step as j_make_step)
from repro_torch.configs.archs import ARCHS as T_ARCHS
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models import rglru as trglru
from repro_torch.models import ssd as tssd
from repro_torch.models.transformer import fwd_train
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import TrainHyper, make_train_step
from repro_torch.training.tree import leaves
from test_torch_training import (LR, _compare_states, _jbatch, _jstate,
                                 _np_tree, _rel, _tbatch)

SCAN_ARCHS = ["mamba2-370m", "recurrentgemma-9b"]


def _cfgs(name, **kw):
    """The reduced configuration in f32 for both packages (f32 moments:
    a moment kept in bf16 tips by one bf16 step where two f32 gradients
    differ in their last bits)."""
    kw = {"param_dtype": "float32", "opt_state_dtype": "float32", **kw}
    return tuple(dataclasses.replace(A[name].reduced(), **kw)
                 for A in (J_ARCHS, T_ARCHS))


def family_batch(cfg, seed=0, B=4, S=32):
    """``tests/test_models.py``'s batch: ``S`` positions, a VLM's patch
    embeddings among them, whisper's stub frames beside them, all drawn
    from a numpy seed (the embeddings in f32)."""
    rng = np.random.default_rng(seed)
    s_txt = S - (cfg.vlm_prefix or 0)
    b = {k: rng.integers(0, cfg.vocab, (B, s_txt)).astype(np.int32)
         for k in ("tokens", "labels")}
    if cfg.vlm_prefix:
        b["prefix_embeds"] = (rng.normal(size=(B, cfg.vlm_prefix,
                                               cfg.d_model)) * 0.02
                              ).astype(np.float32)
    if cfg.enc_dec:
        b["frames"] = (rng.normal(size=(B, cfg.enc_seq, cfg.d_model)) * 0.02
                       ).astype(np.float32)
    return b


def check_fwd_train(name):
    jcfg, tcfg = _cfgs(name)
    js = _jstate(jcfg)
    b = family_batch(jcfg)
    want, wm = jax.jit(lambda p, bb: j_fwd_train(p, bb, jcfg, SINGLE))(
        js.params, _jbatch(b))
    tp = params_from_numpy(_np_tree(js.params), device="cpu")
    with torch.no_grad():
        got, m = fwd_train(tp, _tbatch(b), tcfg)
    assert _rel(got, want) <= 1e-5
    assert _rel(m.aux_loss, wm.aux_loss) <= 1e-5
    assert float(m.dropped) == float(wm.dropped)
    return m


def check_train_step(name, accum=1):
    jcfg, tcfg = _cfgs(name)
    js = _jstate(jcfg)
    b = family_batch(jcfg)
    adamw = dict(lr=LR, warmup_steps=0, decay_steps=100)
    jstep = jax.jit(j_make_step(jcfg, SINGLE, jpm.MeshSizes(), JHyper(
        adamw=jopt.AdamWConfig(**adamw), accum_steps=accum)))
    want, wm = jstep(js, _jbatch(b))
    ts = train_state_from_numpy(_np_tree(js), device="cpu")
    step = make_train_step(tcfg, hyper=TrainHyper(
        adamw=topt.AdamWConfig(**adamw), accum_steps=accum))
    got, m = step(ts, _tbatch(b))
    assert _rel(m["loss"], wm["loss"]) <= 1e-5
    assert _rel(m["grad_norm"], wm["grad_norm"]) <= 1e-5
    assert _rel(m["aux_loss"], wm["aux_loss"]) <= 1e-5
    assert float(m["dropped"]) == float(wm["dropped"])
    _compare_states(got, want)
    return m


@pytest.mark.parametrize("arch", SCAN_ARCHS)
def test_fwd_train_matches_reference(arch):
    m = check_fwd_train(arch)
    assert float(m.aux_loss) == float(m.dropped) == 0.0


@pytest.mark.parametrize("arch", SCAN_ARCHS)
def test_train_step_matches_reference(arch):
    check_train_step(arch)


def _max_rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got.detach().numpy() - want))
                 / max(np.abs(want).max(), 1e-30))


def _ssd_inputs(rng, S, H=2, P=8, N=8, a_log=0.0, dt_bias=0.0):
    """Mamba-2's scan inputs as ``ssd_block`` makes them: dt the softplus
    of a projection plus ``dt_bias``, A = -exp(A_log)."""
    x = rng.normal(size=(2, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(2, S, H)) * 0.5 + dt_bias)
                  ).astype(np.float32)
    A = -np.exp(np.full(H, a_log) + rng.normal(size=H) * 0.1
                ).astype(np.float32)
    Bm = rng.normal(size=(2, S, N)).astype(np.float32)
    Cm = rng.normal(size=(2, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _torch_grads(fn, arrays, r):
    """``fn``'s outputs and the gradients of ``sum(y * r)`` (plus the
    final state's sum, where ``fn`` returns one) with respect to every
    input."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    y, h = out if isinstance(out, tuple) else (out, None)
    loss = torch.sum(y * torch.from_numpy(r))
    if h is not None:
        loss = loss + torch.sum(h)
    grads = torch.autograd.grad(loss, ts)
    return y, h, grads


@pytest.mark.parametrize("S,chunk", [(48, 16), (40, 16)])
def test_ssd_chunked_matches_reference(S, chunk, rng):
    """Values, final state and gradients of the training form against the
    reference's ``ssd_chunked`` (S = 40: a zero-padded tail)."""
    arrays = _ssd_inputs(rng, S)
    r = rng.normal(size=arrays[0].shape).astype(np.float32)

    def ref(x, dt, A, Bm, Cm):
        y, h = jssd.ssd_chunked(x, dt, A, Bm, Cm, chunk, return_state=True)
        return jnp.sum(y * r) + jnp.sum(h), (y, h)

    (_, (wy, wh)), wg = jax.value_and_grad(ref, argnums=tuple(range(5)),
                                           has_aux=True)(
        *map(jnp.asarray, arrays))
    y, h, grads = _torch_grads(
        lambda *t: tssd.ssd_chunked(*t, chunk=chunk), arrays, r)
    assert _max_rel(y, wy) <= 1e-5
    assert _max_rel(h, wh) <= 1e-5
    for g, w in zip(grads, wg):
        assert np.all(np.isfinite(np.asarray(w)))
        assert _max_rel(g, w) <= 1e-5


@pytest.mark.parametrize("S", [37, 64])
def test_rglru_scan_matches_reference(S, rng):
    """The associative RG-LRU scan's values and its gradients with respect
    to u and the five gate vectors against the reference's."""
    W = 16
    arrays = [rng.normal(size=(2, S, W)).astype(np.float32)] + [
        rng.normal(size=W).astype(np.float32) for _ in range(5)]
    r = rng.normal(size=(2, S, W)).astype(np.float32)
    want, wg = jax.value_and_grad(
        lambda *a: jnp.sum(jrglru.rglru_scan(*a) * r),
        argnums=tuple(range(6)))(*map(jnp.asarray, arrays))
    wy = jrglru.rglru_scan(*map(jnp.asarray, arrays))
    y, _, grads = _torch_grads(trglru.rglru_scan, arrays, r)
    assert y.dtype == torch.float32
    assert _max_rel(y, wy) <= 1e-5
    for g, w in zip(grads, wg):
        assert _max_rel(g, w) <= 1e-5


def test_fault_l_reference_gradient_is_not_finite_at_chunk_256(rng):
    """Fault (l): ``ssd_chunked`` exponentiates ``cum_t - cum_s`` over the
    whole chunk and selects the causal part after. With mamba2's initial
    ``A_log = 1`` and ``dt_bias = 0`` a chunk of 256 sums |dt A| to
    several hundred above the diagonal, ``exp`` overflows there, and the
    selection back-propagates ``0 * inf = NaN``. The training form selects
    the exponent first: its gradient is finite and agrees with the
    kernel's plain version's (which selects first too)."""
    S = chunk = 256
    arrays = _ssd_inputs(rng, S, a_log=1.0)
    x, dt, A = arrays[:3]
    assert float(np.sum(-dt[0, :, 0] * A[0])) > 88.73  # f32 exp's limit
    r = rng.normal(size=x.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jssd.ssd_chunked(*a, chunk) * r),
                  argnums=(2,))(*map(jnp.asarray, arrays))[0]
    assert not np.all(np.isfinite(np.asarray(jg)))

    y, h, grads = _torch_grads(
        lambda *t: tssd.ssd_chunked(*t, chunk=chunk), arrays, r)
    py, ph, pgrads = _torch_grads(
        lambda *t: ssd_scan_plain(*t, chunk), arrays, r)
    for g in grads:
        assert torch.isfinite(g).all()
    assert _max_rel(y, py.detach()) <= 1e-4
    assert _max_rel(h, ph.detach()) <= 1e-4
    for g, w in zip(grads, pgrads):
        assert _max_rel(g, w) <= 1e-4


def test_remat_gives_the_same_recurrent_step():
    """recurrentgemma's RG-LRU and local-attention blocks under
    ``torch.utils.checkpoint``: the step with remat equals the step
    without, bit for bit."""
    jcfg, tcfg = _cfgs("recurrentgemma-9b")
    b = _tbatch(family_batch(tcfg))
    outs = []
    for remat in (False, True):
        ts = train_state_from_numpy(_np_tree(_jstate(jcfg)), device="cpu")
        step = make_train_step(dataclasses.replace(tcfg, remat=remat))
        outs.append(step(ts, b))
    (s0, m0), (s1, m1) = outs
    assert float(m0["loss"]) == float(m1["loss"])
    assert float(m0["grad_norm"]) == float(m1["grad_norm"])
    for a, c in zip(leaves(s0), leaves(s1)):
        assert torch.equal(a, c)

"""The port's training path on the CPU against ``repro.training`` and
``repro.storage.datacache``.

Inputs come from a numpy seed; the reference's parameters and optimizer
state come across with ``convert.train_state_from_numpy``. Tolerances:

- ``lr_schedule``: within one f32 ulp (``cos`` rounds as each libm does);
- ``adamw_update`` on the reference's own gradients, run op by op as the
  reference's function is written: parameters and both moments bit for
  bit at steps where the schedule's scalars agree (``pow`` and ``cos``
  round as each libm does: the learning rate is one ulp apart at steps
  42, 82, 84 and 98 of this schedule); at step 42 within two f32 ulps
  measured at the scale of the update's largest term (the rate one ulp
  off, times ``delta``, rounds within two), bf16 parameters within one
  bf16 ulp. Jitted, XLA contracts ``b1 * m + (1 - b1) * g`` into a fused
  multiply-add that rounds once where the written expression rounds
  twice, so a moment that nearly cancels differs by up to 19 of its own
  ulps and ``m / sqrt(v)`` carries that on; the jitted step is held by
  the train-step tests below;
- ``unembed_loss`` and ``fwd_train``: the loss within 1e-5 relative (f32,
  products summed in another order);
- one train step against the jitted reference in f32: loss and grad norm
  within 1e-5 relative, each moment within 1e-5 of its leaf's largest
  magnitude, the parameters within 1e-3 * lr absolute (the first AdamW
  step moves every entry by about lr, so this is a thousandth of the
  update). The exception: entries whose gradient is within 100 eps of
  zero (a first moment under 1e-7 after the first step) are held to 0.1 *
  lr. There the first step's ``g / (|g| + eps)`` turns the last bits of a
  gradient summed in another order into a visible part of lr (up to
  0.042 * lr seen, on 1 to 3 entries of 16,384 in a leaf);
- ``DataCache``: hits, misses, cache contents and batches equal, byte for
  byte;
- ``run_training``: the loss falls; a killed and resumed run equals the
  uninterrupted one bit for bit.
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
from repro.models import layers as jlayers
from repro.models.transformer import fwd_train as j_fwd_train
from repro.storage import datacache as jdc
from repro.training import optimizer as jopt
from repro.training.compression import init_error_feedback as j_init_err
from repro.training.train_step import (TrainHyper as JHyper,
                                       TrainState as JState,
                                       make_loss_and_grads as j_loss_grads,
                                       make_train_step as j_make_step)
from repro_torch.configs.archs import ARCHS as T_ARCHS
from repro_torch.convert import params_from_numpy, train_state_from_numpy
from repro_torch.launch.train import run_training
from repro_torch.models.layers import unembed_loss
from repro_torch.models.transformer import fwd_train
from repro_torch.storage import datacache as tdc
from repro_torch.training import optimizer as topt
from repro_torch.training.checkpoint import CheckpointConfig
from repro_torch.training.train_step import (TrainHyper, make_train_step)
from repro_torch.training.tree import leaves

TRAIN_ARCHS = ["stablelm-3b", "mistral-nemo-12b"]
LR = 3e-4


def _cfgs(name, **kw):
    kw = {"param_dtype": "float32", **kw}
    return tuple(dataclasses.replace(A[name].reduced(), **kw)
                 for A in (J_ARCHS, T_ARCHS))


def _batch(cfg, seed=0, B=4, S=32):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "labels")}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jstate(jcfg, seed=1):
    p = jpm.init_params(jcfg, jax.random.PRNGKey(seed))
    return JState(p, jopt.adamw_init(p, jcfg.opt_state_dtype), j_init_err(p))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _ulps(got, want, old, bf16=False):
    """Largest difference in units of the last place of the update's
    largest term: the old value, the new one or their difference (so an
    entry that the update brings near zero is measured at its operands'
    scale)."""
    got, want, old = (np.asarray(x, np.float64) for x in (got, want, old))
    scale = np.maximum(np.maximum(np.abs(want), np.abs(old)),
                       np.abs(want - old)).astype(np.float32)
    ulp = np.spacing(scale).astype(np.float64) * (2.0 ** 16 if bf16 else 1)
    return float(np.max(np.abs(got - want) / ulp)) if got.size else 0.0


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


@pytest.mark.parametrize("step", [0, 1, 20, 60, 100])
def test_lr_schedule_matches_reference(step):
    cfg_j = jopt.AdamWConfig(lr=LR, warmup_steps=20, decay_steps=100)
    cfg_t = topt.AdamWConfig(lr=LR, warmup_steps=20, decay_steps=100)
    want = np.float32(jopt.lr_schedule(cfg_j, jnp.asarray(step, jnp.int32)))
    got = topt.lr_schedule(cfg_t, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert _ulps(got.item(), want, want) <= 1.0


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start", [0, 1, 30, 41, 99])
def test_adamw_update_matches_reference(param_dtype, start):
    """The reference's own gradients of reduced stablelm-3b, applied from a
    state with moments (random, non-negative for ``nu``) at step
    ``start``, against the reference's update op by op."""
    jcfg, _ = _cfgs("stablelm-3b", param_dtype=param_dtype)
    js = _jstate(jcfg)
    run, _ = j_loss_grads(jcfg, SINGLE, jpm.MeshSizes(), JHyper())
    _, _, grads = jax.jit(run)(js.params, _jbatch(_batch(jcfg)))
    rng = np.random.default_rng(5)
    mu = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape) * 1e-3, jnp.float32), js.params)
    nu = jax.tree.map(lambda p: jnp.asarray(
        rng.random(size=p.shape) * 1e-6, jnp.float32), js.params)
    opt = jopt.AdamWState(jnp.asarray(start, jnp.int32), mu, nu)
    cfg_j = jopt.AdamWConfig(lr=LR, warmup_steps=20, decay_steps=100)
    cfg_t = topt.AdamWConfig(lr=LR, warmup_steps=20, decay_steps=100)
    scale = jnp.asarray(0.75, jnp.float32)
    want_p, want_opt = jopt.adamw_update(grads, opt, js.params, cfg_j,
                                         grad_scale=scale)

    ts = train_state_from_numpy(_np_tree(JState(js.params, opt, js.err_fb)),
                                device="cpu")
    tg = params_from_numpy(_np_tree(grads), device="cpu")
    got_p, got_opt = topt.adamw_update(tg, ts.opt, ts.params, cfg_t,
                                       grad_scale=torch.tensor(0.75))
    assert int(got_opt.step) == start + 1 == int(want_opt.step)
    bf16 = param_dtype == "bfloat16"
    for got_t, want_t, old_t, b in (
            (got_p, want_p, js.params, bf16), (got_opt.mu, want_opt.mu, mu,
                                              False),
            (got_opt.nu, want_opt.nu, nu, False)):
        for g, w, o in zip(leaves(got_t), jax.tree.leaves(want_t),
                           jax.tree.leaves(old_t)):
            g, w = _np(g), np.asarray(w, np.float32)
            if start == 41:  # step 42: the learning rates one ulp apart
                assert _ulps(g, w, np.asarray(o, np.float32),
                             b) <= (1.0 if b else 2.0)
            else:
                assert np.array_equal(g, w)


@pytest.mark.parametrize("masked", [False, True])
def test_unembed_loss_matches_reference(masked):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    emb = (rng.normal(size=(256, 32)) * 0.1).astype(np.float32)
    labels = rng.integers(0, 256, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.7).astype(np.float32) if masked else None
    want = jlayers.unembed_loss(
        jnp.asarray(x), jnp.asarray(emb), jnp.asarray(labels), SINGLE,
        mask=None if mask is None else jnp.asarray(mask))
    got = unembed_loss(torch.from_numpy(x), torch.from_numpy(emb),
                       torch.from_numpy(labels),
                       mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_fwd_train_matches_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    js = _jstate(jcfg)
    b = _batch(jcfg)
    want, wm = jax.jit(lambda p, bb: j_fwd_train(p, bb, jcfg, SINGLE))(
        js.params, _jbatch(b))
    tp = params_from_numpy(_np_tree(js.params), device="cpu")
    with torch.no_grad():
        got, m = fwd_train(tp, _tbatch(b), tcfg)
    assert _rel(got, want) <= 1e-5
    assert float(m.aux_loss) == float(wm.aux_loss) == 0.0
    assert float(m.dropped) == float(wm.dropped) == 0.0


def _compare_states(got, want, lr=LR):
    """Parameters within 1e-3 * lr (0.1 * lr where the first moment is
    under 1e-7: the gradient within 100 eps of zero); moments within 1e-5
    of each leaf's largest magnitude; the step equal."""
    assert int(got.opt.step) == int(want.opt.step)
    for g, w, m in zip(leaves(got.params), jax.tree.leaves(want.params),
                       jax.tree.leaves(want.opt.mu)):
        tol = np.where(np.abs(np.asarray(m)) < 1e-7, 0.1 * lr, 1e-3 * lr)
        assert np.all(np.abs(_np(g) - np.asarray(w, np.float32)) <= tol)
    for tree_g, tree_w in ((got.opt.mu, want.opt.mu),
                           (got.opt.nu, want.opt.nu)):
        for g, w in zip(leaves(tree_g), jax.tree.leaves(tree_w)):
            w = np.asarray(w)
            np.testing.assert_allclose(
                _np(g), w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_reference(arch, accum):
    """One step of the jitted reference step against the port's, in f32;
    ``accum=2`` mirrors ``test_models.py::test_microbatch_accumulation_
    matches`` (two microbatches of 2 sequences, f32 accumulators)."""
    jcfg, tcfg = _cfgs(arch)
    js = _jstate(jcfg)
    b = _batch(jcfg)
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
    assert float(m["aux_loss"]) == float(wm["aux_loss"]) == 0.0
    _compare_states(got, want)


def test_remat_gives_the_same_step():
    """Each block under ``torch.utils.checkpoint`` recomputes the same
    values: the step with remat equals the step without, bit for bit."""
    _, tcfg = _cfgs("stablelm-3b")
    jcfg, _ = _cfgs("stablelm-3b")
    b = _tbatch(_batch(tcfg))
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


@pytest.mark.parametrize("policy", ["ws", "lru", "lfu"])
def test_datacache_matches_reference(tmp_path, policy):
    """64 steps of batches over 16 shards, 4 cached, shards per step
    varied so that the miss stream has strides (prefetch) and repeats
    (hits): the same shards on disk, hits, misses, cache contents (so the
    same victims) and batches."""
    caches = []
    for mod, sub in ((jdc, "ref"), (tdc, "port")):
        store = mod.ShardedTokenStore(str(tmp_path / sub), n_shards=16,
                                      shard_tokens=300, vocab=512, seed=7)
        caches.append(mod.DataCache(store, mod.DataCacheConfig(
            cache_shards=4, policy=policy)))
    for s in range(16):
        assert np.array_equal(caches[0].store.read(s), caches[1].store.read(s))
    for step in range(64):
        spp = 1 + (step // 8) % 3
        bj, bt = (c.batch(step, 2, 40, shards_per_step=spp) for c in caches)
        for k in ("tokens", "labels"):
            assert bj[k].dtype == bt[k].dtype
            assert np.array_equal(bj[k], bt[k])
        cj, ct = caches
        assert list(cj.cache) == list(ct.cache), step
        assert (cj.hits, cj.misses) == (ct.hits, ct.misses)
        assert np.array_equal(cj.ol.weights, ct.ol.weights)
    assert caches[1].hits > 0 and caches[1].misses > 0


def _ck(tmp_path, **kw):
    return CheckpointConfig(dir_tier1=str(tmp_path / "fast"),
                            dir_tier2=str(tmp_path / "durable"), **kw)


def test_run_training_loss_decreases(tmp_path):
    """``test_system.py::test_train_loss_decreases`` on the port."""
    out = run_training(arch="stablelm-3b", steps=40, batch=4, seq=64,
                       data_dir=str(tmp_path / "data"),
                       ckpt=_ck(tmp_path, tier1_every=1000, tier2_every=1000),
                       resume=False, log_every=100, lr=1e-3, device="cpu")
    losses = out["losses"]
    assert len(losses) == 40 and np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert out["cache_hits"] + out["cache_misses"] == 40
    assert out["n_params"] == sum(p.numel() for p in leaves(
        out["state"].params))


def test_run_training_kill_and_resume_is_exact(tmp_path):
    """``test_system.py::test_fault_injection_and_restart`` made exact: a
    run killed at step 12 (tier-1 snapshots every 5 steps, so the newest
    is step 10) and resumed to step 20 gives the uninterrupted run's
    losses after step 10 and its final state, bit for bit."""
    kw = dict(arch="stablelm-3b", steps=20, batch=2, seq=32,
              data_dir=str(tmp_path / "data"), log_every=100, device="cpu")
    full = run_training(ckpt=_ck(tmp_path / "a", tier1_every=1000,
                                 tier2_every=1000), **kw)
    ck = _ck(tmp_path / "b", tier1_every=5, tier2_every=100)
    killed = run_training(ckpt=ck, kill_at=12, **kw)
    assert killed["killed_at"] == 12
    assert killed["losses"] == full["losses"][:13]
    resumed = run_training(ckpt=ck, **kw)
    assert resumed["losses"] == full["losses"][10:]
    assert resumed["restore_s"] > 0
    for a, b in zip(leaves(resumed["state"]), leaves(full["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_training_runs_without_jax_or_ml_dtypes(tmp_path):
    """The card's machine has neither JAX nor ``ml_dtypes``: the launcher,
    a bf16 checkpoint's save and its restore run with all three made
    unimportable."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "for m in ('jax', 'repro', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "from repro_torch.launch.train import main\n"
        "from repro_torch.training.checkpoint import CheckpointConfig\n"
        "import repro_torch.launch.train as T\n"
        f"ck = CheckpointConfig(dir_tier1={str(tmp_path / 'f')!r}, "
        f"dir_tier2={str(tmp_path / 'd')!r}, tier1_every=2, tier2_every=4)\n"
        "kw = dict(steps=4, batch=2, seq=16, device='cpu', "
        f"data_dir={str(tmp_path / 'data')!r}, ckpt=ck)\n"
        "T.run_training(kill_at=2, **kw)\n"
        "out = T.run_training(**kw)\n"
        "assert len(out['losses']) == 2, out['losses']\n"
        "main(['--device', 'cpu', '--steps', '2', '--batch', '2', "
        "'--seq', '16'])\n")
    env = dict(__import__("os").environ, PYTHONPATH=str(
        __import__("pathlib").Path(__file__).resolve().parents[1] / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[restore] resumed from step 2" in r.stdout


def test_run_training_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None trains on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(steps=1, batch=1, seq=8,
                     data_dir=str(tmp_path / "data"),
                     ckpt=_ck(tmp_path, tier1_every=1000, tier2_every=1000))

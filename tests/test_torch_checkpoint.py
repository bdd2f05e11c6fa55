"""The port's two-tier checkpoints against ``repro.training.checkpoint``,
and fault (j): the reference's skip of a non-finite step.

- A reference checkpoint of a bf16 + f32 ``TrainState`` restores in the
  port leaf for leaf (bits equal), and a port checkpoint restores in the
  reference; the files the two write are equal byte for byte.
- A corrupt newest tier-1 leaf falls back to the tier-2 copy; the tier-1
  ring keeps ``tier1_keep`` snapshots; restore prefers tier 1 on a tie.
- Fault (j): the reference's step "skips" a non-finite update by scaling
  the gradients by 0, which leaves NaN where a gradient was NaN or inf,
  decays every other entry and advances the step; the port's step leaves
  the parameters, both moments and the step count unchanged bit for bit.
"""
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as J_ARCHS
from repro.models import params as jpm
from repro.training import checkpoint as jck
from repro.training import optimizer as jopt
from repro.training.compression import init_error_feedback as j_init_err
from repro.training.train_step import TrainState as JState
from repro_torch.configs.archs import ARCHS as T_ARCHS
from repro_torch.convert import train_state_from_numpy
from repro_torch.training import checkpoint as tck
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import TrainHyper, make_train_step
from repro_torch.training.tree import flatten, leaves, unflatten


def _jstate(param_dtype="bfloat16", seed=2):
    """A reference ``TrainState`` of reduced stablelm-3b with bf16 (or
    f32) parameters, f32 moments that are not zero (``nu`` non-negative)
    and step 7."""
    cfg = dataclasses.replace(J_ARCHS["stablelm-3b"].reduced(),
                              param_dtype=param_dtype)
    p = jpm.init_params(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    normal = lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32)
    uniform = lambda x: jnp.asarray(rng.random(size=x.shape), jnp.float32)
    opt = jopt.AdamWState(jnp.asarray(7, jnp.int32),
                          jax.tree.map(normal, p), jax.tree.map(uniform, p))
    return JState(p, opt, j_init_err(p))


def _bits(x):
    """A leaf's bytes and dtype name, for either package."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16"
        return t.numpy().tobytes(), str(t.numpy().dtype)
    a = np.asarray(x)
    return a.tobytes(), str(a.dtype)


def _ck(root, **kw):
    return kw.pop("cls", tck).CheckpointConfig(
        dir_tier1=str(root / "fast"), dir_tier2=str(root / "durable"), **kw)


def test_tree_order_is_jax_order():
    js = _jstate()
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    jl = jax.tree.leaves(js)
    tl, treedef = flatten(ts)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape and _bits(a) == _bits(b)
    rebuilt = unflatten(treedef, tl)
    assert type(rebuilt) is type(ts) and type(rebuilt.opt) is type(ts.opt)


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, param_dtype):
    js = _jstate(param_dtype)
    jck.save_checkpoint(js, 4, _ck(tmp_path, cls=jck, tier1_every=2,
                                   tier2_every=4))
    like = train_state_from_numpy(
        jax.tree.map(np.asarray, _jstate(param_dtype, seed=3)), device="cpu")
    got, step = tck.restore_checkpoint(like, _ck(tmp_path))
    assert step == 4
    assert int(got.opt.step) == 7
    for a, b in zip(leaves(got), jax.tree.leaves(js)):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, param_dtype):
    js = _jstate(param_dtype)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    tck.save_checkpoint(ts, 6, _ck(tmp_path / "port", tier1_every=3,
                                   tier2_every=6))
    jck.save_checkpoint(js, 6, _ck(tmp_path / "ref", cls=jck,
                                   tier1_every=3, tier2_every=6))
    got, step = jck.restore_checkpoint(
        _jstate(param_dtype, seed=3),
        _ck(tmp_path / "port", cls=jck))
    assert step == 6
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(js)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
    # The leaf files are the reference's, byte for byte.
    for tier in ("fast", "durable"):
        port = sorted(glob.glob(str(tmp_path / "port" / tier / "step_*" /
                                    "leaf_*.npy")))
        ref = sorted(glob.glob(str(tmp_path / "ref" / tier / "step_*" /
                                   "leaf_*.npy")))
        assert [os.path.basename(p) for p in port] == [
            os.path.basename(p) for p in ref] and port
        for p, r in zip(port, ref):
            with open(p, "rb") as f, open(r, "rb") as g:
                assert f.read() == g.read(), p


def test_corrupt_tier1_falls_back_to_tier2(tmp_path):
    """``test_system.py::test_checkpoint_roundtrip_and_corruption`` on the
    port: the newest tier-1 snapshot's first leaf is overwritten, restore
    takes the tier-2 copy of the same step."""
    ck = _ck(tmp_path, tier1_every=1, tier2_every=2)
    state = {"a": torch.arange(8, dtype=torch.float32),
             "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16)}}
    tck.save_checkpoint(state, 2, ck)
    got, step = tck.restore_checkpoint(state, ck)
    assert step == 2 and torch.equal(got["a"], state["a"])
    leaf = sorted(glob.glob(str(tmp_path / "fast" / "step_*" /
                                "leaf_*.npy")))[0]
    with open(leaf, "r+b") as f:
        f.seek(130)
        f.write(b"\x00" * 8)
    with pytest.raises(IOError, match="checksum"):
        tck._load_tree(state, os.path.dirname(leaf))
    got2, step2 = tck.restore_checkpoint(state, ck)
    assert step2 == 2  # the durable copy
    assert torch.equal(got2["a"], state["a"])
    assert torch.equal(got2["b"]["c"], state["b"]["c"])
    assert got2["b"]["c"].dtype == torch.bfloat16


def test_tier1_ring_keeps_tier1_keep_and_prefers_tier1(tmp_path):
    ck = _ck(tmp_path, tier1_every=2, tier2_every=5, tier1_keep=2)
    for step in range(1, 11):
        state = {"x": torch.full((4,), float(step))}
        tck.save_checkpoint(state, step, ck)
    t1 = sorted(os.listdir(tmp_path / "fast"))
    assert t1 == ["step_00000008", "step_00000010"]
    assert sorted(os.listdir(tmp_path / "durable")) == [
        "step_00000005", "step_00000010"]
    assert tck.latest_step(ck) == 10
    # On a tie the tier-1 copy is read: mark it by rewriting its step-10
    # contents (a valid snapshot of other values).
    tck._save_tree({"x": torch.full((4,), -1.0)},
                   str(tmp_path / "fast" / "step_00000010"), 10)
    got, step = tck.restore_checkpoint({"x": torch.zeros(4)}, ck)
    assert step == 10 and float(got["x"][0]) == -1.0


def test_restore_refuses_another_model(tmp_path):
    ck = _ck(tmp_path, tier1_every=1)
    tck.save_checkpoint({"a": torch.zeros(2)}, 1, ck)
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint({"a": torch.zeros(2), "b": torch.zeros(2)}, ck)


def _nonfinite_grads(params, rng):
    """Finite random gradients with one NaN and one inf in the first
    leaf."""
    g = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape) * 1e-2,
                                           jnp.float32), params)
    first = np.array(jax.tree.leaves(g)[0])
    first.flat[0], first.flat[1] = np.nan, np.inf
    flat, treedef = jax.tree.flatten(g)
    return jax.tree.unflatten(treedef, [jnp.asarray(first)] + flat[1:])


def test_reference_skip_update_poisons_non_finite_entries():
    """Fault (j), recorded: ``train_step.py:172`` sets the scale to 0 for a
    non-finite norm, and ``adamw_update`` then computes ``NaN * 0``."""
    js = _jstate("float32")
    grads = _nonfinite_grads(js.params, np.random.default_rng(0))
    gnorm = jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(grads)))
    scale = jnp.where(jnp.isfinite(gnorm), 1.0, 0.0)  # train_step.py:172
    assert not bool(jnp.isfinite(gnorm)) and float(scale) == 0.0
    new_p, new_opt = jopt.adamw_update(grads, js.opt, js.params,
                                       jopt.AdamWConfig(), grad_scale=scale)
    first = np.asarray(jax.tree.leaves(new_p)[0]).ravel()
    assert np.isnan(first[0]) and np.isnan(first[1])        # poisoned
    assert np.isnan(np.asarray(jax.tree.leaves(new_opt.mu)[0]).ravel()[:2]
                    ).all()
    assert int(new_opt.step) == int(js.opt.step) + 1         # advanced
    old = np.asarray(jax.tree.leaves(js.params)[1])
    new = np.asarray(jax.tree.leaves(new_p)[1])
    assert np.isfinite(new).all() and not np.array_equal(new, old)  # decayed


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_port_step_skips_non_finite_update(bad):
    """The port's step with a non-finite gradient norm (a batch whose
    embedding row is NaN or inf) leaves the state bit for bit as it was,
    and reports the non-finite norm."""
    cfg = dataclasses.replace(T_ARCHS["stablelm-3b"].reduced(),
                              param_dtype="float32")
    ts = train_state_from_numpy(jax.tree.map(np.asarray, _jstate("float32")),
                                device="cpu")
    with torch.no_grad():
        ts.params["embed"][3].fill_(bad)
    before = [x.clone() for x in leaves(ts)]
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    batch["tokens"][0, 0] = 3
    step = make_train_step(
        cfg, hyper=TrainHyper(adamw=topt.AdamWConfig(lr=1e-3)))
    after, m = step(ts, batch)
    assert not np.isfinite(float(m["grad_norm"]))
    assert int(after.opt.step) == 7
    for a, b in zip(leaves(after), before):
        assert _bits(a) == _bits(b)


def test_port_step_applies_a_finite_update():
    """The same step's control: with finite gradients the parameters move
    and the step count advances."""
    cfg = dataclasses.replace(T_ARCHS["stablelm-3b"].reduced(),
                              param_dtype="float32")
    ts = train_state_from_numpy(jax.tree.map(np.asarray, _jstate("float32")),
                                device="cpu")
    before = [x.clone() for x in leaves(ts.params)]
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    after, m = make_train_step(cfg)(ts, batch)
    assert np.isfinite(float(m["grad_norm"]))
    assert int(after.opt.step) == 8
    assert all(not torch.equal(a, b)
               for a, b in zip(leaves(after.params), before))

"""``repro_torch.distributed.axes.Axes`` over ``torch.distributed``, and
the parameter shards, on the CPU.

- Every collective (``psum`` / ``pmax`` over one axis, ``psum_many`` /
  ``pmax_many`` over one, both and an absent axis, tiled ``all_gather``
  on dims 0 and 1) under gloo on 4 CPU ranks of a (data 2, model 2)
  mesh, against numpy on the same seeded inputs, in f32, bf16 and int32
  (integer values: every order of summation gives the same result); the
  sizes, ``batch_shards`` and ``tp_degree``.
- ``SINGLE`` and an absent axis are the identity (the same tensor back);
  ``pmax`` refuses inputs that require grad (the sums' and the gathers'
  backwards are held by ``test_torch_sharded_train.py``).
- The page shards' combine (``combine_shards``) with one rank's partial
  empty: equal to the combine of the other three (numpy), no NaN.
- ``shard_params`` equals the reference's addressable shard of
  ``NamedSharding(mesh, param_pspecs(...))`` on 4 forced host devices, for
  the six families, and ``param_pspecs`` / ``fsdp_dims`` / ``grad_sync``
  equal the reference's leaf for leaf.
- The plain paged attention over a sequence with no live page gives the
  empty partial exactly.
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
from repro_torch.configs.archs import ARCHS as T_ARCHS
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import params as tpm

HERE = Path(__file__).resolve().parent
FAMILIES = ["stablelm-3b", "mamba2-370m", "recurrentgemma-9b",
            "mixtral-8x22b", "whisper-tiny", "paligemma-3b"]
MESH = [[0, 1], [2, 3]]  # rank at (data, model)


@pytest.fixture(scope="module")
def ranks():
    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    import torch_sharded_ranks as tr
    return spawn_ranks(tr.axes_rank, 4, (7,), device="cpu", threads=1)


def _group(r, name):
    d, m = divmod(r, 2)
    if name == "data":
        return [MESH[i][m] for i in range(2)]
    if name == "model":
        return MESH[d]
    return [0, 1, 2, 3]


@pytest.mark.parametrize("dt", ["torch.float32", "torch.bfloat16",
                                "torch.int32"])
def test_collectives_match_numpy(ranks, dt):
    xs = np.random.default_rng(7).integers(-50, 50, (4, 3, 5))
    for r, out in enumerate(ranks):
        assert out["coords"] == dict(zip(("data", "model"), divmod(r, 2)))
        assert out["sizes"] == (2, 2, 1, 2)
        assert out["tp"] == (2, 1)
        for name, grp in (("data", "data"), ("model", "model"),
                          ("both", "both"), ("with_none", "model")):
            g = xs[_group(r, grp)]
            np.testing.assert_array_equal(
                np.asarray(out[("psum", dt, name)], np.float64), g.sum(0))
            np.testing.assert_array_equal(
                np.asarray(out[("pmax", dt, name)], np.float64), g.max(0))
        for name in ("data", "model"):
            g = xs[_group(r, name)]
            np.testing.assert_array_equal(
                np.asarray(out[("psum1", dt, name)], np.float64), g.sum(0))
            np.testing.assert_array_equal(
                np.asarray(out[("pmax1", dt, name)], np.float64), g.max(0))
            for dim in (0, 1):
                np.testing.assert_array_equal(
                    np.asarray(out[("gather", dt, name, dim)], np.float64),
                    np.concatenate(list(g), axis=dim))


def test_single_is_identity_and_autograd_refused(ranks):
    for out in ranks:
        assert out["single"]
        assert "no backward" in out["autograd"]


def test_combine_with_an_empty_page_shard(ranks):
    parts = ranks[0]["parts"].astype(np.float32)
    acc, m = parts[:3, :, :, :4], parts[:3, :, :, 0] * 3
    l = np.abs(parts[:3, :, :, 1]) + 0.5
    m_g = m.max(0)
    corr = np.exp(m - m_g)
    want = ((acc * corr[..., None]).sum(0)
            / (l * corr).sum(0)[..., None])
    for out in ranks:
        got = out["combine"]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_empty_partial_from_the_plain_paged_attention():
    """A sequence whose pages are all unowned (-1 in the table) comes out
    as acc 0, m -1e30, l 0, exactly; a live row beside it is unchanged."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn((2, 4, 16), generator=g)
    pool = torch.randn((5, 4, 2, 2, 16), generator=g)
    slots = torch.tensor([[-1, -1, -1], [2, -1, 4]], dtype=torch.int32)
    lengths = torch.tensor([9, 9], dtype=torch.int32)
    acc, m, l = paged_attention_ref(q, pool, slots, lengths)
    assert torch.equal(acc[0], torch.zeros_like(acc[0]))
    assert torch.equal(m[0], torch.full_like(m[0], -1e30))
    assert torch.equal(l[0], torch.zeros_like(l[0]))
    acc1, m1, l1 = paged_attention_ref(q[1:], pool, slots[1:], lengths[1:])
    assert torch.equal(acc[1], acc1[0]) and torch.equal(l[1], l1[0])


@pytest.fixture(scope="module")
def ref_shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shards")
    jobs = []
    for i, arch in enumerate(FAMILIES):
        cfg = dataclasses.replace(J_ARCHS[arch].reduced(),
                                  param_dtype="float32")
        params = jax.tree.map(np.asarray,
                              jpm.init_params(cfg, jax.random.PRNGKey(i)))
        jobs.append(dict(kind="shards", arch=arch, mesh_shape=(2, 2),
                         mesh_axes=("data", "model"), params=params))
    with open(tmp / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src"), os.environ.get(
                       "PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, str(HERE / "torch_sharded_serve_ref.py"),
         str(tmp / "jobs.pkl"), str(tmp / "out.pkl")], env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        return dict(zip(FAMILIES, zip(jobs, pickle.load(f))))


@pytest.mark.parametrize("arch", FAMILIES)
def test_shard_params_match_reference(ref_shards, arch):
    job, per_rank = ref_shards[arch]
    cfg = dataclasses.replace(T_ARCHS[arch].reduced(), param_dtype="float32")
    jcfg = dataclasses.replace(J_ARCHS[arch].reduced(),
                               param_dtype="float32")
    ms = tpm.MeshSizes(data=2, model=2)
    jms = jpm.MeshSizes(data=2, model=2)
    want_specs = jax.tree.leaves(
        jpm.param_pspecs(jcfg, jms),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got_specs = jax.tree.leaves(tpm.param_pspecs(cfg, ms),
                                is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(s) + (None,) * (len(g) - len(s))
            for s, g in zip(want_specs, got_specs)] == got_specs
    assert jax.tree.leaves(jpm.fsdp_dims(jcfg, jms)) == jax.tree.leaves(
        tpm.fsdp_dims(cfg, ms))
    full = params_from_numpy(job["params"], device="cpu")
    for r in range(4):
        got = tpm.shard_params(full, cfg, ms,
                               dict(zip(("data", "model"), divmod(r, 2))))
        gl = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
        assert len(gl) == len(per_rank[r])
        for a, b in zip(gl, per_rank[r]):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("data,model", [(2, 2), (1, 4), (4, 1)])
def test_grad_sync_matches_reference(arch, data, model):
    """Each leaf's gradient-sync flags (``data``, ``model``, ``model_rep``)
    equal the reference's, in the same tree."""
    cfg = T_ARCHS[arch].reduced()
    jcfg = J_ARCHS[arch].reduced()
    want = jpm.grad_sync(jcfg, jpm.MeshSizes(data=data, model=model))
    got = tpm.grad_sync(cfg, tpm.MeshSizes(data=data, model=model))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert jax.tree.leaves(got) == jax.tree.leaves(want)

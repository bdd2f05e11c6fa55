"""Page shards and the mesh collectives on the card (``cuda`` marker;
each test skips where ``torch.cuda.is_available()`` is false). This file
imports no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_sharded_cuda.py

- The paged-attention kernel, bf16 and int8, over the two tier tables of
  one page shard (``kvpool.t2_slot_table`` under each mapping policy:
  the pages the shard does not own are -1 in both), against its plain
  version; a sequence with no owned page gives the empty partial (acc 0,
  m -1e30, l 0) exactly, and the cross-rank combine without it equals
  the combine with it.
- A 2-rank gloo ``Axes`` round trip on the card (two ranks share it:
  ``backend_for`` picks gloo): ``psum``, ``pmax_many`` and ``all_gather``
  of CUDA tensors, the results on the card; and the backwards of sharded
  training: the gather's reduce-scatter (``reduce_scatter_tensor``) in
  f32 and bf16, ``psum_scatter``, the entry marker's sum and the sum's
  identity.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.launch.mesh import backend_for, spawn_ranks
from repro_torch.models.attention import Partial, merge_partials
from repro_torch.serving import kvpool as kvp

HERE = Path(__file__).resolve().parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the card")
    return torch.device("cuda")


def _tables(mapping, me, B, n_pages, hbm):
    """One page shard's tier-1 and tier-2 tables: its owned pages, the
    newest ``hbm`` resident, the rest in tier 2; -1 for the others."""
    spec = kvp.KVSpec(b_local=B, n_pages=n_pages, page_size=16, n_kv=1,
                      head_dim=128, layers_per_slot=1, hbm_slots=hbm,
                      t2_slots=B * n_pages + 1, n_shards=4, mapping=mapping)
    t2 = kvp.t2_slot_table(spec, me)
    owned = t2 >= 0
    slot1 = torch.full_like(t2, -1)
    flat = torch.nonzero(owned.reshape(-1))[:, 0].flip(0)[:hbm]
    slot1.view(-1)[flat] = torch.arange(flat.numel(), dtype=torch.int32)
    slot2 = torch.where(slot1 < 0, t2, -1)
    return slot1, slot2, owned


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("mapping", ["block", "block_cyclic", "random",
                                     "round_robin"])
@pytest.mark.parametrize("me", [0, 3])
def test_paged_kernel_on_page_shard_tables(cuda_device, kv_dtype, mapping,
                                           me):
    rng = np.random.default_rng(hash((kv_dtype, mapping, me)) % 2**32)
    B, H, KV, hd, page, n_pages, hbm = 4, 32, 8, 128, 16, 12, 6
    slot1, slot2, owned = _tables(mapping, me, B, n_pages, hbm)
    lengths = torch.as_tensor(rng.integers(page, n_pages * page, B),
                              dtype=torch.int32)
    q = torch.as_tensor(rng.normal(size=(B, H, hd)),
                        dtype=torch.bfloat16).to(cuda_device)
    pools, scales = [], []
    for n in (hbm + 1, B * n_pages + 1):
        x = torch.as_tensor(rng.normal(size=(n, page, 2, KV, hd)),
                            dtype=torch.float32)
        if kv_dtype == "int8":
            codes, sc = kvp.quantize(x)
            pools.append(codes.to(cuda_device))
            scales.append(sc.to(cuda_device))
        else:
            pools.append(x.to(torch.bfloat16).to(cuda_device))
            scales.append(None)
    parts, wants = [], []
    for pool, sc, slot in zip(pools, scales, (slot1, slot2)):
        slot = slot.to(cuda_device)
        got = pa.paged_attention(q, pool, slot, lengths.to(cuda_device),
                                 scale=sc)
        want = paged_attention_ref(q, pool, slot, lengths.to(cuda_device),
                                   0, sc)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
        parts.append(Partial(*got))
        wants.append(Partial(*want))
    none = ~owned.any(1)  # sequences with no owned page
    merged = merge_partials(parts)
    for b in torch.nonzero(none.to(cuda_device))[:, 0].tolist():
        assert float(merged.acc[b].abs().max()) == 0.0
        assert float(merged.l[b].abs().max()) == 0.0
        assert bool((merged.m[b] == np.float32(-1e30)).all())


@pytest.mark.cuda
def test_empty_partial_from_the_kernel(cuda_device):
    """Every page of sequence 0 unowned: the kernel's partial is exactly
    (0, -1e30, 0), bf16 and int8, and merging it into a live one changes
    nothing."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn((2, 32, 128), generator=g).to(torch.bfloat16).to(
        cuda_device)
    x = torch.randn((6, 128, 2, 8, 128), generator=g)
    slots = torch.tensor([[-1, -1, -1], [0, 3, 5]], dtype=torch.int32,
                         device=cuda_device)
    lengths = torch.tensor([300, 300], dtype=torch.int32,
                           device=cuda_device)
    codes, sc = kvp.quantize(x)
    for pool, scale in ((x.to(torch.bfloat16).to(cuda_device), None),
                        (codes.to(cuda_device), sc.to(cuda_device))):
        acc, m, l = pa.paged_attention(q, pool, slots, lengths, scale=scale)
        assert float(acc[0].abs().max()) == 0.0
        assert float(l[0].abs().max()) == 0.0
        assert bool((m[0] == np.float32(-1e30)).all())
        live = Partial(acc[1:], m[1:], l[1:])
        empty = Partial(acc[:1], m[:1], l[:1])
        both = merge_partials([live, empty])
        assert torch.equal(both.acc, live.acc) and torch.equal(both.l, live.l)


@pytest.mark.cuda
def test_gloo_axes_round_trip_on_the_card(cuda_device):
    assert backend_for(cuda_device, 2) == (
        "nccl" if torch.cuda.device_count() >= 2 else "gloo")
    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    import torch_sharded_ranks as tr
    out = spawn_ranks(tr.card_axes_rank, 2, (), device="cuda")
    for r, o in enumerate(out):
        assert all(d.startswith("cuda") for d in o["devices"]), o
        assert o["backend"] in ("gloo", "nccl")
        np.testing.assert_array_equal(o["psum"], [1.0 + 2.0] * 3)
        np.testing.assert_array_equal(o["pmax"], [2.0] * 3)
        np.testing.assert_array_equal(o["gather"], [[1.0, 2.0]])
        for dt in ("torch.float32", "torch.bfloat16"):
            # d/dw of sum(all_gather(w) * coef_r) summed over both ranks:
            # row r of coef_0 + coef_1 = 3 * [[0, 1], [2, 3]].
            np.testing.assert_array_equal(o[f"gather_grad_{dt}"],
                                          [[6.0 * r, 6.0 * r + 3.0]])
            # this rank's column block of coef_0 + coef_1
            np.testing.assert_array_equal(o[f"scatter_{dt}"],
                                          [[3.0 * r], [6.0 + 3.0 * r]])
        # enter: the ranks' (r + 1) summed, 3; psum: this rank's r + 1
        np.testing.assert_array_equal(o["enter_grad"], [3.0 + r + 1] * 3)

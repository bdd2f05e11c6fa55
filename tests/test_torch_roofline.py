"""The port's roofline (``repro_torch.core.roofline``) against the
reference's ``repro.core.roofline`` on the CPU: the four contract tests of
``tests/test_roofline.py`` mirrored (matmul FLOPs exact, a loop's trip
count multiplied, wire bytes at (n - 1)/n, the dominant term),
``roofline_report`` equal to the reference's field by field over a
seeded grid, and ``program_cost``'s FLOPs equal to the reference's
``hlo_cost`` of the same jitted computations. Plus the counting rules of
``program_cost``: views move no byte, an index put counts what it writes,
host tensors and host-to-device copies are counted apart from the
device's work, and the live bytes' peak."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import roofline as jrl
from repro_torch.core import roofline as rl
from repro_torch.distributed import axes as dax
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.mesh import axes_for_mesh, make_mesh


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_flops_exact():
    got = rl.program_cost(lambda a, b: a @ b, _meta(128, 256), _meta(256, 64))
    assert got["flops"] == 2 * 128 * 256 * 64
    # The product's output, written once and read once.
    assert got["bytes"] == 2 * 128 * 64 * 4


def test_loop_trip_count_multiplied():
    def g(x, ws):
        for w in ws.unbind(0):
            x = x @ w
        return x
    got = rl.program_cost(g, _meta(64, 64), _meta(10, 64, 64))
    assert got["flops"] == 10 * 2 * 64 * 64 * 64


def test_collective_wire_bytes_match_the_reference_parser():
    """An all-gather to f32[32,128] and an all-reduce of f32[8,128] over a
    fake group of 4: the wire bytes by kind of the reference's parser on
    its synthetic HLO of the same two ops, exactly."""
    hlo = """
HloModule test

ENTRY %main (p: f32[8,128]) -> f32[8,128] {
  %p = f32[8,128]{1,0} parameter(0)
  %ag = f32[32,128]{1,0} all-gather(%p), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[8,128]{1,0} all-reduce(%p), replica_groups={{0,1,2,3}}, to_apply=%add
  ROOT %out = f32[8,128]{1,0} copy(%ar)
}
"""
    want = jrl.collective_bytes(hlo)
    with fake_group(4):
        ax = axes_for_mesh(make_mesh((4,), ("model",)))
        dax.reset_collective_stats()
        p = _meta(8, 128)
        assert ax.all_gather(p, "model", axis=0).shape == (32, 128)
        ax.psum(p, "model")
        got = dax.collective_wire_stats()
        dax.reset_collective_stats()
    assert got.count == want.count == 2
    assert got.by_kind == want.by_kind
    assert got.wire_bytes == want.wire_bytes


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
def test_wire_bytes_ring_factors_match_the_reference(kind):
    """Each kind's factor, through the reference's parser of a one-op
    module over groups of 2, 4 and 16."""
    for n in (2, 4, 16):
        groups = ",".join(str(i) for i in range(n))
        hlo = (f"ENTRY %m (p: f32[4,8]) -> f32[4,8] {{\n"
               f"  %x = f32[4,8]{{1,0}} {kind}(%p), "
               f"replica_groups={{{{{groups}}}}}\n}}\n")
        want = jrl.collective_bytes(hlo).by_kind[kind]
        got = rl.wire_bytes(kind, 4 * 8 * 4, n)
        assert got == want if kind != "collective-permute" else got == 128


def test_roofline_report_dominant_term():
    hw = rl.HW
    rep = rl.roofline_report(
        hlo_flops=hw["peak_flops"], hlo_bytes=hw["hbm_bw"] * 2,
        coll=rl.CollectiveStats(), chips=1, model_flops=0.5 * hw["peak_flops"])
    assert rep["dominant"] == "memory"
    assert abs(rep["t_compute_s"] - 1.0) < 1e-9
    assert abs(rep["t_memory_s"] - 2.0) < 1e-9
    assert 0 < rep["roofline_frac"] < 1


def test_h100_entry():
    """The H100 SXM's published dense bf16 peak, HBM3 rate and NVLink rate
    each way (NVIDIA's data sheet)."""
    assert rl.HW == dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)


def test_roofline_report_equals_the_reference_over_a_grid():
    """Field by field, exactly, with the reference's hardware passed as
    ``hw``: the same arithmetic in the same order."""
    rng = np.random.default_rng(26)
    for _ in range(200):
        flops, bytes_, wire, mf = (float(x) for x in 10.0 ** rng.uniform(
            3, 16, 4))
        chips = int(rng.choice([1, 4, 256, 512]))
        by = {"all-gather": wire * 0.25, "all-reduce": wire * 0.75}
        n = int(rng.integers(0, 50))
        if rng.random() < 0.1:
            flops = 0.0
        want = jrl.roofline_report(
            hlo_flops=flops, hlo_bytes=bytes_,
            coll=jrl.CollectiveStats(wire, dict(by), n), chips=chips,
            model_flops=mf)
        got = rl.roofline_report(
            hlo_flops=flops, hlo_bytes=bytes_,
            coll=rl.CollectiveStats(wire, dict(by), n), chips=chips,
            model_flops=mf, hw=jrl.HW)
        assert got == want


def test_program_cost_flops_equal_the_reference_hlo_cost():
    """The reference's own contract computations, jitted on the CPU and
    walked by ``hlo_cost``, against ``program_cost`` of the same ones."""
    c = jax.jit(lambda a, b: a @ b).lower(
        jax.ShapeDtypeStruct((128, 256), jnp.float32),
        jax.ShapeDtypeStruct((256, 64), jnp.float32)).compile()
    want = jrl.hlo_cost(c.as_text())["flops"]
    got = rl.program_cost(lambda a, b: a @ b, _meta(128, 256),
                          _meta(256, 64))["flops"]
    assert got == want

    def g(x, ws):
        def body(x, w):
            return x @ w, None
        x, _ = jax.lax.scan(body, x, ws)
        return x
    c = jax.jit(g).lower(jax.ShapeDtypeStruct((64, 64), jnp.float32),
                         jax.ShapeDtypeStruct((10, 64, 64), jnp.float32)
                         ).compile()
    want = jrl.hlo_cost(c.as_text())["flops"]

    def h(x, ws):
        for w in ws.unbind(0):
            x = x @ w
        return x
    assert rl.program_cost(h, _meta(64, 64), _meta(10, 64, 64))[
        "flops"] == want


def test_views_move_no_bytes_and_index_puts_count_what_they_write():
    def f(pool, new, slot):
        v = pool.view(16, 2, 8).transpose(1, 2)   # views: nothing
        pool[slot] = new                          # 3 rows of 16 written
        return v.sum()                            # a reduction: 4 bytes
    got = rl.program_cost(f, _meta(16, 16), _meta(3, 16),
                          torch.tensor([1, 4, 9], device="meta"))
    assert got["bytes"] == 2 * (3 * 16 * 4) + 2 * 4
    assert got["bytes_all"] == got["bytes"]
    assert got["flops"] == 0


def test_host_work_and_transfers_are_counted_apart():
    """On a ``meta`` program, ops on host tensors alone count as host
    work, and a host-to-device copy as a transfer; on a CPU program the
    same ops are the program's own."""
    def f(x, table):
        t = (table * 2).sum()                     # host: a reduction
        idx = table.to(x.device)                  # a transfer
        return x[idx].sum() + t.to(x.device)
    table = torch.arange(4)
    meta = rl.program_cost(f, _meta(8, 4), table)
    cpu = rl.program_cost(f, torch.zeros(8, 4), table)
    assert meta["host_bytes"] == 2 * 8 and meta["host_bytes_all"] == (
        2 * 32 + 2 * 8)
    assert meta["transfer_bytes"] == 32 + 8
    assert cpu["host_bytes"] == cpu["transfer_bytes"] == 0
    assert cpu["bytes"] == meta["bytes"] + meta["host_bytes"]
    assert cpu["bytes_all"] == meta["bytes_all"] + meta["host_bytes_all"]


def test_argument_and_peak_bytes():
    def f(a):
        b = a * 2                 # 64 B live beside a
        c = b + 1                 # 64 B more, then b dies
        del b
        return c.sum()
    a = _meta(4, 4)
    got = rl.program_cost(f, a)
    assert got["argument_bytes"] == 64
    assert got["peak_bytes"] == 64 * 3

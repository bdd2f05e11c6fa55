"""The redesigned SSD-scan kernel's arithmetic, emulated on the CPU.

``csrc/ssd_scan.cu`` computes the scan chunk-parallel, as Mamba-2's SSD:
each chunk's cumulative sum of ``dt A`` by one warp's scan in f64 (32
lanes, each summing its run of steps in order, then a shuffle scan over
the lanes' totals), kept in f64 so that every decay ``exp(cum_t -
cum_s)`` comes from an f64 difference rounded once, each chunk's state
increment
``(exp(cum_end - cum) dt B)^T x``, a sequential pass over the chunk
states, then ``y = exp(cum) (C . h_prev) + (C B^T * causal decay * dt) .
x`` with ``C B^T`` computed once for every head. The products run on the
tensor cores: bf16 operands, f32 sums. An operand computed in f32 enters
as three bf16 parts, ``v1 = bf16(v)``, ``v2 = bf16(v - v1)``, ``v3 =
bf16(v - v1 - v2)`` (with f32 inputs every operand does), and the
products of the parts whose orders sum below three are taken.

This file emulates that arithmetic in f32 (``_emulate``) and holds it
against the plain version ``ssd_scan_plain`` and the JAX package's
``ssd_scan_kernel(..., interpret=True)`` and sequential
``repro.kernels.ref.ssd_ref``, on inputs made from a seed with numpy:
heads sharing one B and C, S not a multiple of the chunk, and a chunk
whose ``sum |dt A|`` is several hundred. Bars, those of ``chip_smoke.py``
phase 11 and ``tests/test_torch_scan_kernels_cuda.py``:

- bf16 inputs: y element by element within one bf16 step of the plain
  version's and of the JAX kernel's (``|diff| <= 2^-7 |want| + 1e-5``);
  the final state within ``SSD_F32_TOL`` = 1e-4 of its largest magnitude;
- f32 inputs: y and the final state within 1e-5 of the largest magnitude,
  1e-4 (``SSD_F32_TOL``) in the chunk of large decay, where one f32 ulp of
  a cumulative sum of several hundred is 3e-5.

It also records that fewer parts miss the bf16 bar on y: one bf16
rounding of the f32 operands misses it by far, and two parts (``hi +
lo``, as flash attention splits P) on one element of the ragged case (the
weights here have both signs, and y cancels), which is why the kernel
takes three. No card: the kernel itself is held against the plain version
on the card (``tests/test_torch_scan_kernels_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_kernel
from repro_torch.kernels import ssd_scan as tss

ULP, ABS = 2.0 ** -7, 1e-5   # one bf16 step, chip_smoke.FLASH_ULP/_ABS
SSD_F32_TOL = 1e-4            # chip_smoke.SSD_F32_TOL


def _warp_scan(v: torch.Tensor) -> torch.Tensor:
    """The kernel's ``warp_scan`` of ``v [..., n]`` (f32 values), in f64:
    32 lanes of ``ceil(n / 32)`` consecutive steps each, summed in order;
    a Hillis-Steele scan over the lanes' totals; each step its lane's
    exclusive offset plus its in-lane prefix."""
    n = v.shape[-1]
    E = -(-n // 32)
    seg = F.pad(v.double(), (0, 32 * E - n)).reshape(*v.shape[:-1], 32, E)
    loc = torch.empty_like(seg)
    run = torch.zeros_like(seg[..., 0])
    for j in range(E):
        run = run + seg[..., j]
        loc[..., j] = run
    incl = run
    for off in (1, 2, 4, 8, 16):
        nxt = incl.clone()
        nxt[..., off:] = incl[..., off:] + incl[..., :-off]
        incl = nxt
    excl = F.pad(incl[..., :-1], (1, 0))
    return (excl[..., None] + loc).reshape(*v.shape[:-1], 32 * E)[..., :n]


def _parts(v: torch.Tensor, n: int) -> list:
    """``v`` (f32) as ``n`` bf16 parts, each held in f32."""
    out = []
    for _ in range(n):
        hi = v.to(torch.bfloat16).float()
        out.append(hi)
        v = v - hi
    return out


def _product(eq: str, a: list, b: list) -> torch.Tensor:
    """The sum of the part products whose orders sum below the larger part
    count, each an f32 product of bf16 values."""
    m = max(len(a), len(b))
    return sum(torch.einsum(eq, x, y) for i, x in enumerate(a)
               for j, y in enumerate(b) if i + j < m)


def _emulate(x, dt, A, Bm, Cm, chunk: int, *, f32_parts: int):
    """The kernel's arithmetic on CPU tensors (x, Bm, Cm bf16 or f32; S a
    multiple of the chunk): ``(y in x's dtype, final state f32)``. The f32
    operands enter as ``f32_parts`` parts (the kernel: 3), the inputs as 1
    part (bf16) or 3 (f32)."""
    f = torch.float32
    Bsz, S, H, P = x.shape
    Q = chunk
    Qp = -(-Q // 16) * 16
    n_in = 1 if x.dtype == torch.bfloat16 else 3
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    h = torch.zeros((Bsz, H, Bm.shape[-1], P), dtype=f)
    y = torch.empty(x.shape, dtype=x.dtype)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    for c0 in range(0, S, Q):
        sl = slice(c0, c0 + Q)
        xc = xf[:, sl].permute(0, 2, 1, 3)                  # [B, H, Q, P]
        dtc = dt[:, sl].permute(0, 2, 1)                    # [B, H, Q]
        Bc, Cc = Bf[:, sl], Cf[:, sl]                       # [B, Q, N]
        cum = _warp_scan(F.pad(dtc * A[None, :, None], (0, Qp - Q)))[..., :Q]
        ce = cum[..., -1]
        xp, Bp, Cp = (_parts(t, n_in) for t in (xc, Bc, Cc))
        # chunk_state: (B * edge)^T x.
        edge = torch.exp((ce[..., None] - cum).float()) * dtc
        bd = Bc[:, None] * edge[..., None]                  # [B, H, Q, N]
        inc = _product("bhsn,bhsp->bhnp", _parts(bd, f32_parts), xp)
        # chunk_scan: exp(cum) (C . h_prev) + (CB * decay * dt) . x.
        cb = _product("btn,bsn->bts", Cp, Bp)               # [B, Q, Q]
        diff = torch.where(tri, (cum[..., :, None] - cum[..., None, :])
                           .float(), 0.0)
        w = torch.where(tri, cb[:, None] * torch.exp(diff) * dtc[..., None, :],
                        0.0)
        y_off = _product("btn,bhnp->bhtp", Cp, _parts(h, f32_parts))
        yc = torch.exp(cum.float())[..., None] * y_off + _product(
            "bhts,bhsp->bhtp", _parts(w, f32_parts), xp)
        y[:, sl] = yc.permute(0, 2, 1, 3).to(x.dtype)
        # state_pass.
        h = h * torch.exp(ce.float())[..., None, None] + inc
    return y, h


def _inputs(seed, B, S, H, P, N, dt_scale, a_scale):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, S, H))) * dt_scale + 0.01
          ).astype(np.float32)
    A = (-np.abs(rng.normal(size=(H,))) * a_scale - 0.05).astype(np.float32)
    Bm = (rng.normal(size=(B, S, N)) * 0.3).astype(np.float32)
    Cm = (rng.normal(size=(B, S, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _padded(x, dt, Bm, Cm, Q):
    """The wrapper's zero tail up to a multiple of the chunk."""
    pad = (-x.shape[1]) % Q
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad)))


def _excess(got, want) -> float:
    """Largest ``|got - want| / (2^-7 |want| + 1e-5)``: at most 1 passes."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (ULP * w.abs() + ABS)).max())


def _rel(got, want) -> float:
    w = torch.as_tensor(np.asarray(want, np.float32)).double()
    return float((got.double() - w).abs().max() / w.abs().max())


# name: (B, S, H, P, N, chunk, dt scale, A scale, f32 bar)
CASES = {
    # mamba2-370m's P, N and chunk; 8 heads share one B and C
    "heads-share-bc": (2, 512, 8, 64, 128, 256, 0.5, 1.0, 1e-5),
    # S not a multiple of the chunk (the wrapper pads to 768)
    "ragged": (1, 700, 4, 64, 128, 256, 0.5, 1.0, 1e-5),
    # the reduced model's shapes: N 16, P 8, chunk 16, 45 steps
    "small-ragged": (2, 45, 3, 8, 16, 16, 0.5, 1.0, 1e-5),
    # sum |dt A| of a chunk in the hundreds
    "large-decay": (1, 512, 4, 64, 128, 256, 1.5, 1.5, SSD_F32_TOL),
}


def _case(name, dtype):
    B, S, H, P, N, Q, dts, As, _ = CASES[name]
    x, dt, A, Bm, Cm = _inputs(len(name), B, S, H, P, N, dts, As)
    t = [torch.as_tensor(a) for a in (x, dt, A, Bm, Cm)]
    for i in (0, 3, 4):
        t[i] = t[i].to(dtype)
    return t, Q


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_emulation_within_one_bf16_step(case):
    (x, dt, A, Bm, Cm), Q = _case(case, torch.bfloat16)
    S = x.shape[1]
    want_y, want_h = tss.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
    xp, dtp, Bp, Cp = _padded(x, dt, Bm, Cm, Q)
    got_y, got_h = _emulate(xp, dtp, A, Bp, Cp, Q, f32_parts=3)
    got_y = got_y[:, :S]
    assert _excess(got_y, want_y) <= 1
    assert _rel(got_h, want_h.numpy()) <= SSD_F32_TOL
    if S % Q == 0:  # the JAX kernel, in interpret mode, takes whole chunks
        jy = ssd_scan_kernel(*(jnp.asarray(a.float().numpy()).astype(
            jnp.bfloat16 if i in (0, 3, 4) else jnp.float32)
            for i, a in enumerate((x, dt, A, Bm, Cm))), chunk=Q,
            interpret=True)
        jy = torch.as_tensor(np.asarray(jy.astype(jnp.float32)))
        assert _excess(got_y, jy) <= 1


@pytest.mark.parametrize("case", list(CASES))
def test_f32_emulation_against_plain_and_jax(case):
    (x, dt, A, Bm, Cm), Q = _case(case, torch.float32)
    bar = CASES[case][-1]
    S = x.shape[1]
    want_y, want_h = tss.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
    xp, dtp, Bp, Cp = _padded(x, dt, Bm, Cm, Q)
    got_y, got_h = _emulate(xp, dtp, A, Bp, Cp, Q, f32_parts=3)
    got_y = got_y[:, :S]
    assert _rel(got_y, want_y.numpy()) <= bar
    assert _rel(got_h, want_h.numpy()) <= bar
    jseq = jref.ssd_ref(*(jnp.asarray(a.numpy()) for a in (x, dt, A, Bm, Cm)))
    assert _rel(got_y, jseq) <= bar
    if S % Q == 0:
        jy = ssd_scan_kernel(*(jnp.asarray(a.numpy())
                               for a in (x, dt, A, Bm, Cm)), chunk=Q,
                             interpret=True)
        assert _rel(got_y, jy) <= bar


@pytest.mark.parametrize("case,parts", [("heads-share-bc", 1),
                                        ("large-decay", 1), ("ragged", 2)])
def test_fewer_parts_miss_the_bar(case, parts):
    """One bf16 rounding of the f32 operands (CB * decay * dt, the edge
    weights of B, the state), or two parts, instead of three: y leaves the
    one-bf16-step bar."""
    (x, dt, A, Bm, Cm), Q = _case(case, torch.bfloat16)
    S = x.shape[1]
    want_y, _ = tss.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
    xp, dtp, Bp, Cp = _padded(x, dt, Bm, Cm, Q)
    got_y, _ = _emulate(xp, dtp, A, Bp, Cp, Q, f32_parts=parts)
    assert _excess(got_y[:, :S], want_y) > 1



def _cumsum_f32_chunks(v: torch.Tensor) -> torch.Tensor:
    """A prefix sum in f32 as a GPU scan takes it: chunks of 32 steps, a
    Hillis-Steele scan in each, a running f32 total across the chunks."""
    out = torch.empty_like(v)
    carry = torch.zeros_like(v[..., 0])
    for c0 in range(0, v.shape[-1], 32):
        x = v[..., c0:c0 + 32]
        off = 1
        while off < x.shape[-1]:
            nxt = x.clone()
            nxt[..., off:] = x[..., off:] + x[..., :-off]
            x, off = nxt, 2 * off
        out[..., c0:c0 + 32] = carry[..., None] + x
        carry = out[..., c0 + x.shape[-1] - 1]
    return out


def test_decays_from_f64_differences(monkeypatch):
    """The warp scan is the exact prefix sum to f64 precision. With the
    plain version's cumsum taken in f32 as a GPU scan takes it (as on the
    card), f32 prefix sums in the kernel -- each rounded once -- would put
    y 1.1e-5 of its largest magnitude away, past the f32 bar of 1e-5 at
    the shapes of ``tests/test_torch_scan_kernels_cuda.py`` (an H100 showed
    1.14e-5); the decays from f64 differences stay inside it."""
    for n in (16, 45, 200, 256):
        r = torch.as_tensor(np.random.default_rng(n).normal(size=(3, n)) - 2,
                            dtype=torch.float32)
        assert torch.allclose(_warp_scan(r), torch.cumsum(r.double(), -1),
                              rtol=0, atol=1e-12)
    rng = np.random.default_rng(512 + 7 * 128)  # that test's inputs
    x = torch.as_tensor(rng.normal(size=(1, 512, 4, 64)), dtype=torch.float32)
    dt = torch.as_tensor(np.abs(rng.normal(size=(1, 512, 4))) * 0.5 + 0.01,
                         dtype=torch.float32)
    A = torch.as_tensor(-np.abs(rng.normal(size=(4,))), dtype=torch.float32)
    Bm, Cm = (torch.as_tensor(rng.normal(size=(1, 512, 128)) * 0.3,
                              dtype=torch.float32) for _ in range(2))
    got_y, _ = _emulate(x, dt, A, Bm, Cm, 256, f32_parts=3)
    monkeypatch.setattr(tss.torch, "cumsum",
                        lambda v, dim=-1: _cumsum_f32_chunks(v))
    want_y, _ = tss.ssd_scan_plain(x, dt, A, Bm, Cm, 256)
    monkeypatch.undo()
    assert _rel(got_y, want_y.numpy()) <= 1e-5
    exact = _warp_scan  # the same sums, each rounded once to f32
    monkeypatch.setitem(globals(), "_warp_scan",
                        lambda v: exact(v).float().double())
    f32_y, _ = _emulate(x, dt, A, Bm, Cm, 256, f32_parts=3)
    assert _rel(f32_y, want_y.numpy()) > 1e-5

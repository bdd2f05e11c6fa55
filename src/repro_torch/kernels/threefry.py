"""Threefry-2x32 counter-based PRNG, bit-compatible with JAX's default.

The Random eviction expert draws one uniform per cache line at every
request step, from a key chain split once per step. Which line it proposes
depends on every bit of those draws, so the port reproduces JAX's
``threefry2x32`` (with ``jax_threefry_partitionable=True``, JAX's default)
exactly rather than substituting torch's Philox generator:

- a key is a pair of uint32 words ``(k0, k1)``; ``PRNGKey(seed)`` is
  ``(seed >> 32, seed & 0xFFFFFFFF)``;
- ``split(key)`` hashes the counters ``(0, 0)`` and ``(0, 1)`` under
  ``key``: the first pair is the carried key, the second the step's draw
  key;
- ``uniform(key, n)`` hashes the counters ``(0, i)`` for ``i < n``, XORs
  the two output words and keeps the top 23 bits as the mantissa of a
  float in ``[1, 2)``, minus one.

Every function is written with Python operators only, masked to 32 bits,
so it runs unchanged on Python ints (the host-side key chain) and on int64
torch tensors on any device (the per-line draws). The CUDA kernel
(``csrc/cache_scan.cu``) carries the same arithmetic in ``uint32``.
"""
from __future__ import annotations

import torch

__all__ = [
    "MASK32",
    "prng_key",
    "threefry2x32",
    "split",
    "key_chain",
    "uniform_f32",
    "cache_scan_noise",
]

MASK32 = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as two uint32 words, for a seed that
    fits int32 (JAX's default integer width)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit int32")
    return 0, seed & MASK32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block function (20 rounds): hashes the counter
    pair ``(x0, x1)`` under the key ``(k0, k1)``. Operands are Python ints
    or int64 tensors holding uint32 values; they broadcast."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for i in range(5):
        for r in (_ROT0 if i % 2 == 0 else _ROT1):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def split(key):
    """``jax.random.split(key)``: ``(new_key, draw_key)``, each a pair of
    uint32 words (Python ints or tensors, matching ``key``)."""
    k0, k1 = key
    return threefry2x32(k0, k1, 0, 0), threefry2x32(k0, k1, 0, 1)


def key_chain(key, length: int) -> list:
    """The draw keys of ``length`` successive ``key, vkey = split(key)``
    steps, on the host: a list of ``(k0, k1)`` int pairs."""
    key = (int(key[0]), int(key[1]))
    out = []
    for _ in range(length):
        key, vkey = split(key)
        out.append(vkey)
    return out


def uniform_f32(vk0, vk1, n: int, *, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in float32. ``vk0``/``vk1`` are
    ints or int64 tensors of shape ``[...]``; the result has shape
    ``[..., n]`` (one row of draws per key)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    if isinstance(vk0, torch.Tensor):
        vk0, vk1 = vk0[..., None], vk1[..., None]
    b0, b1 = threefry2x32(vk0, vk1, 0, idx)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def cache_scan_noise(key, length: int, n_lines: int, *,
                     device=None) -> torch.Tensor:
    """Random-expert noise table ``[length, n_lines]`` f32: row ``t`` holds
    the uniforms drawn at step ``t`` of a stream that starts from ``key``
    (two uint32 words). Bit-equal to the reference's table."""
    vkeys = torch.tensor(key_chain(key, length), dtype=torch.int64,
                         device=device).reshape(length, 2)
    return uniform_f32(vkeys[:, 0], vkeys[:, 1], n_lines, device=device)

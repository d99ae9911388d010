"""Bloom filter on device tensors (the port of `BloomFilter` and `_mix64`
in `spark_tpu/sketch.py`; reference: `common/sketch/BloomFilter.java`).

The filter stores one logical bit per byte, set by an idempotent scatter
of ones. Hashes are the splitmix64 finalizer on int64 tensors: torch has
no unsigned 64-bit arithmetic on CUDA, so the unsigned operations are
emulated on int64 bits:

- a logical right shift is the arithmetic shift masked to the bits that
  shifted in from the top;
- multiplication wraps to the same 64 bits signed or unsigned;
- the unsigned remainder `u % m` is computed from `u >>> 1`, which is
  non-negative as an int64.

The bits equal the JAX package's for every int64 input.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def _signed(c: int) -> int:
    """The int64 with the same 64 bits as the unsigned constant `c`."""
    c &= _MASK64
    return c - (1 << 64) if c >= (1 << 63) else c


_MIX_MUL = _signed(0xBF58476D1CE4E5B9)
_MIX_MUL2 = _signed(0x94D049BB133111EB)


def _lsr(u, k: int):
    """Logical right shift of int64 bits by 0 < k < 64."""
    return (u >> k) & ((1 << (64 - k)) - 1)


def _finalize64(u):
    """splitmix64 finalizer over int64 bits (wrapping arithmetic)."""
    u = (u ^ _lsr(u, 30)) * _MIX_MUL
    u = (u ^ _lsr(u, 27)) * _MIX_MUL2
    return u ^ _lsr(u, 31)


def _mix64(x, seed: int):
    """Seeded 64-bit mix of an int64 tensor; the bits of the JAX
    package's uint64 `_mix64(x, seed)`, as int64."""
    salt = (seed * 0x9E3779B97F4A7C15 or 1) & _MASK64
    return _finalize64(x.to(torch.int64) ^ _signed(salt))


def _umod(u, m: int):
    """`u % m` with the int64 bits of `u` read as unsigned; 0 < m < 2^62."""
    return (_lsr(u, 1) % m * 2 + (u & 1)) % m


class BloomFilter:
    """Membership sketch over int64 values.

    Sizing follows the reference (`BloomFilter.optimalNumOfBits`):
    m = -n ln(fpp) / ln(2)^2 bits, k = m/n ln(2) hash functions."""

    def __init__(self, bits, num_hashes: int):
        self.bits = bits          # uint8[m], one logical bit per byte
        self.num_hashes = num_hashes

    @staticmethod
    def sizing(expected_items: int, fpp: float = 0.03):
        m = int(max(64, -expected_items * np.log(fpp) / (np.log(2) ** 2)))
        k = int(max(1, round(m / max(1, expected_items) * np.log(2))))
        return m, min(k, 8)

    @classmethod
    def build(cls, values, expected_items: Optional[int] = None,
              fpp: float = 0.03, mask=None) -> "BloomFilter":
        n = int(values.shape[0])
        m, k = cls.sizing(expected_items or n, fpp)
        # one slot past the end catches the masked-out rows
        bits = torch.zeros((m + 1,), dtype=torch.uint8, device=values.device)
        x = values.to(torch.int64)
        for s in range(k):
            idx = _umod(_mix64(x, s), m)
            if mask is not None:
                idx = torch.where(mask, idx, torch.full_like(idx, m))
            bits[idx] = 1
        return cls(bits[:m], k)

    def might_contain(self, values):
        """Vectorized membership probe: False is definite, True is
        probabilistic (the join-prefilter contract)."""
        m = self.bits.shape[0]
        x = values.to(torch.int64)
        out = torch.ones(values.shape, dtype=torch.bool, device=values.device)
        for s in range(self.num_hashes):
            out = out & (self.bits[_umod(_mix64(x, s), m)] > 0)
        return out

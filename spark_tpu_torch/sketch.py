"""Probabilistic sketches on device tensors: Bloom filter and Count-Min
(the port of `spark_tpu/sketch.py`; reference:
`common/sketch/BloomFilter.java`, `CountMinSketch.java`).

The Bloom filter stores one logical bit per byte, set by an idempotent
scatter of ones; Count-Min is a [depth, width] table of int64 counters
filled by scatter-adds. Hashes are the splitmix64 finalizer on int64
tensors: torch has no unsigned 64-bit arithmetic on CUDA, so the
unsigned operations are emulated on int64 bits:

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


class CountMinSketch:
    """Frequency sketch: [depth, width] counters, point query = min over
    rows (reference: CountMinSketch.java). Row d hashes with seed d, so
    the counters equal the JAX package's bit for bit."""

    def __init__(self, table, depth: int, width: int):
        self.table = table
        self.depth = depth
        self.width = width

    @staticmethod
    def sizing(eps: float = 0.001, confidence: float = 0.99):
        width = int(np.ceil(2.0 / eps))
        depth = int(np.ceil(-np.log(1.0 - confidence) / np.log(2.0)))
        return max(1, depth), max(16, width)

    @classmethod
    def build(cls, values, eps: float = 0.001, confidence: float = 0.99,
              mask=None) -> "CountMinSketch":
        depth, width = cls.sizing(eps, confidence)
        # one column past the end catches the masked-out rows
        table = torch.zeros((depth, width + 1), dtype=torch.int64,
                            device=values.device)
        x = values.to(torch.int64)
        ones = torch.ones(values.shape, dtype=torch.int64,
                          device=values.device)
        for d in range(depth):
            idx = _umod(_mix64(x, d), width)
            if mask is not None:
                idx = torch.where(mask, idx, torch.full_like(idx, width))
            table[d].index_add_(0, idx, ones)
        return cls(table[:, :width].contiguous(), depth, width)

    def estimate(self, values):
        x = values.to(torch.int64)
        est = None
        for d in range(self.depth):
            row = self.table[d][_umod(_mix64(x, d), self.width)]
            est = row if est is None else torch.minimum(est, row)
        return est

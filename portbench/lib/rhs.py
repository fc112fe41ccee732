"""The seeded stream of right-hand sides.

Request ``k`` gets ``roll(base[k % bases], shift[k])``: a vector of
independent N(0, 1) entries that no earlier request had, made by one copy
(about a millisecond at n = 1.6 M) instead of a fresh draw (about ten).
The bases and shifts come from the run's seed, so the reference can make
request ``k``'s vector again after the window.
"""
from __future__ import annotations

import numpy as np

_SHIFTS = 1 << 16


def seed_sequence(seed: int, stream: int) -> np.random.SeedSequence:
    """Independent generators per purpose (0: the matrix, 1: the RHS,
    2: the sample of answers checked) from one seed of any size or sign."""
    return np.random.SeedSequence([seed & (2**64 - 1), stream])


class RhsStream:
    def __init__(self, n: int, seed: int, bases: int):
        rng = np.random.default_rng(seed_sequence(seed, 1))
        self.bases = rng.standard_normal((bases, n))
        self.shifts = rng.integers(0, n, size=_SHIFTS)
        self.n = n

    def astype(self, dtype) -> "RhsStream":
        """The same stream, each vector rounded to ``dtype``."""
        out = object.__new__(RhsStream)
        out.bases = self.bases.astype(dtype)
        out.shifts, out.n = self.shifts, self.n
        return out

    def __call__(self, k: int) -> np.ndarray:
        base = self.bases[k % len(self.bases)]
        s = int(self.shifts[k % _SHIFTS])
        out = np.empty_like(base)
        out[s:] = base[:self.n - s]
        out[:s] = base[self.n - s:]
        return out

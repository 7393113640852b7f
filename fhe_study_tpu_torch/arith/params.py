"""Static ring parameters — the port's own copy of
fhe_study_tpu/arith/params.py (hashable, so they key caches)."""

from dataclasses import dataclass

TORUS_Q = 0xFFFFFFFFFFFFFFFF  # q = u64::MAX tags the torus, as in the reference


@dataclass(frozen=True)
class RingParam:
    q: int
    n: int

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"ring degree {self.n} < 1")
        if not 1 < self.q <= TORUS_Q:
            raise ValueError(f"modulus {self.q} outside (1, 2^64)")

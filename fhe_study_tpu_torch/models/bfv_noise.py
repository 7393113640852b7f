"""BFV noise-growth bounds and the noise probe — the counterpart of
fhe_study_tpu/models/bfv_noise.py.

The reference carries these formulas in a commented-out test: the fresh
encryption bound q/(2t) - r_t(q)/2 and the multiplication bound built from
the expansion factor delta = 2 sqrt(n).  Here they are an API: estimate the
bounds, measure the actual noise, check the headroom.
"""

import math
from dataclasses import dataclass

from ..arith import rq
from ..ops import modops, ntt


@dataclass(frozen=True)
class NoiseBounds:
    fresh_bound: float       # |v| must stay below this for decryption
    mul_bound: float         # the bound after one multiplication (2021/204)
    rt: float                # r_t(q)/t


def bounds(q: int, n: int, t: int, b_key: float = 1.0) -> NoiseBounds:
    """The reference's formulas."""
    rt = (q % t) / t
    fresh = q / (2.0 * t) - rt / 2.0
    ef = 2.0 * math.sqrt(n)                 # the expansion factor delta
    v = fresh - 1.0                         # the most operand noise admitted
    mul = ((ef * t) / 2.0) * ((2.0 * v * v) / q
                              + (4.0 + ef * b_key) * (v + v)
                              + rt * (ef * b_key + 5.0)) \
        + (1.0 + ef * b_key + ef * ef * b_key * b_key) / 2.0
    return NoiseBounds(fresh_bound=fresh, mul_bound=mul, rt=rt)


def measure_noise(param, sk, ct, m):
    """The infinity norm of v = (c0 + c1·s) - Delta·m mod q, centered: the
    reference's ``infinity_norm`` probe on the decryption relation.
    int64 [...]."""
    q, t = param.ring.q, param.t
    cs = rq.add(ct.c0, ntt.intt(modops.mulmod(ntt.ntt(ct.c1, q), sk.s_evals,
                                              q), q), q)
    dm = rq.scalar_mul_u64(modops.coerce_u64(m, q), q // t, q)
    return rq.infinity_norm(rq.sub(cs, dm, q), q)


def fresh_noise_ok(param, sk, ct, m) -> bool:
    nb = bounds(param.ring.q, param.ring.n, param.t)
    return bool(measure_noise(param, sk, ct, m).max() < nb.fresh_bound)

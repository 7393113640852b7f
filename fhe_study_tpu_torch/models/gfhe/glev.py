"""GLev: the gadget vector of l GLWEs — the counterpart of
fhe_study_tpu/models/gfhe/glev.py.

The level indexing is the reference's:
  * the pk encryption scales by q // beta^i for i = 0..l-1;
  * the sk encryption scales by q // beta^i for i = 1..l;
  * decrypt reads level [1] and rescales by beta/q.
(The two encryptions use different index bases; each agrees with decrypt.)
"""

import torch

from ...arith.ring import ring_for
from ...utils import prng
from . import glwe as glwe_mod
from .glwe import GLWE, GLev, Param


def _scales(param: Param, beta: int, l: int, start: int) -> list:
    q = param.ring.q
    return [q // beta ** i for i in range(start, start + l)]


def _stack(cts) -> GLev:
    cts = list(cts)
    return GLev(a=torch.stack([c.a for c in cts], dim=-3),
                b=torch.stack([c.b for c in cts], dim=-2))


def encrypt(gen: prng.Gen, param: Param, beta: int, l: int, pk, m,
            batch=()) -> GLev:
    ring = ring_for(param.ring)
    return _stack(glwe_mod.encrypt(g, param, pk, ring.scalar_mul_u64(m, sc),
                                   batch=batch)
                  for g, sc in zip(prng.split(gen, l),
                                   _scales(param, beta, l, 0)))


def encrypt_s_with(param: Param, beta: int, l: int, sk, m, a, e) -> GLev:
    """encrypt_s from given draws: masks a [l, ..., k, n], noise
    e [l, ..., n], one of each a level."""
    ring = ring_for(param.ring)
    return _stack(glwe_mod.encrypt_s_with(param, sk,
                                          ring.scalar_mul_u64(m, sc), a[i],
                                          e[i])
                  for i, sc in enumerate(_scales(param, beta, l, 1)))


def encrypt_s(gen: prng.Gen, param: Param, beta: int, l: int, sk, m,
              batch=()) -> GLev:
    ring = ring_for(param.ring)
    return _stack(glwe_mod.encrypt_s(g, param, sk, ring.scalar_mul_u64(m, sc),
                                     batch=batch)
                  for g, sc in zip(prng.split(gen, l),
                                   _scales(param, beta, l, 1)))


def decrypt(param: Param, sk, glev: GLev, beta: int):
    pt = glwe_mod.decrypt(param, sk,
                          GLWE(a=glev.a[..., 1, :, :], b=glev.b[..., 1, :]))
    return ring_for(param.ring).mul_div_round(pt, beta, param.ring.q)


def mul_vec(param: Param, glev: GLev, v) -> GLWE:
    """The gadget dot product sum_i GLWE_i * v_i, v [..., l, n]: one
    contraction per output component."""
    ring = ring_for(param.ring)
    b = ring.contract(glev.b, v)                           # [..., n]
    a = ring.contract(glev.a.movedim(-2, 0), v)            # [k, ..., n]
    return GLWE(a=a.movedim(0, -2), b=b)

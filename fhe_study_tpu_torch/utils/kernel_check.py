"""Each CUDA kernel against its plain PyTorch version, at main-path shapes.

``cases`` builds, on one device and from one seeded generator, the inputs
that the paths of ``models/bfv_rns.py`` (``mul_e`` with either relin key,
``mul``, ``key_switch``) hand each kernel wrapper of ``ops/_cuda.KERNELS``
for a parameter set and a batch, and pairs a call of the wrapper with a call
of its plain version on the same tensors; ``linear_cases`` does the same
for the linear pipeline (``to_evals``, ``pt_to_evals``, ``from_evals``) at
its own parameter set, and ``tfhe_cases`` for the two kernels of the TFHE
bootstrap (the single-prime transform at the shapes of key generation, the
whole-chain blind rotation), ``ckks_cases`` for the variants that RNS-CKKS
and the hybrid rotations (``models/ckks/ckks_rns.py``, ``models/hybrid_ks.py``)
launch, ``ext_sum_cases`` for the contraction-only base extension,
``bench_cases`` for the two measuring loops of ``ops/alu_bench.py`` and
``blind_rotate_sweep`` for the blind rotation across ring degrees, gadget
shapes, chain lengths and batches.
``chip_smoke.py`` and the card-marked tests run them on the card and require
equal outputs.

Each case also carries the least work its function needs on these inputs,
for a lower bound on its time: ``bytes`` moved through device memory (every
input and table read once, every output written once) and ``ops``, 32-bit
integer instructions by pipe (a ``Work``): the fewest transforms and
products the function can do, each counted as the SASS instructions that
the compiler makes of the primitives of ``csrc/modarith.cuh`` (the *_OPS
constants, read from the ``alu_rate`` loops by ``utils/sass_counts.py``).
``bound`` turns them into the least time: the bytes over the memory rate,
all instructions over the SM's dispatch rate (128 thread-instructions a
clock: one warp-instruction in each of its four partitions), and each
integer pipe's issue slots over its 64 lanes a clock, the largest of the
four; no kernel made of these primitives can beat it.
"""

import contextlib
import math
from functools import partial
from typing import Callable, NamedTuple

import torch

from ..models.hybrid_ks import ks_ext_primes
from ..models.tfhe.tggsw import _u32_bits
from ..ops import _cuda, alu_bench
from ..ops import blind_rotate_cuda as brc
from ..ops import ext_cuda as ext
from ..ops import ntt as ntt_mod
from ..ops import ntt_cuda as nc
from ..ops.primes import ntt_primes
from . import prng


class Work:
    """32-bit integer instructions by pipe: ``alu`` on the ALU pipe, ``fma``
    on the FMA pipe, of which ``wide`` are IMAD.HI / IMAD.WIDE (two FMA
    issue slots and one ALU slot each; utils/sass_counts.py).  Adds and
    scales like a number."""

    __slots__ = ("alu", "fma", "wide")

    def __init__(self, alu: float = 0.0, fma: float = 0.0,
                 wide: float = 0.0):
        self.alu, self.fma, self.wide = alu, fma, wide

    def __add__(self, other):
        if isinstance(other, (int, float)) and other == 0:
            return self
        return Work(self.alu + other.alu, self.fma + other.fma,
                    self.wide + other.wide)

    __radd__ = __add__

    def __mul__(self, k):
        return Work(self.alu * k, self.fma * k, self.wide * k)

    __rmul__ = __mul__

    def __eq__(self, other):
        return (isinstance(other, Work) and (self.alu, self.fma, self.wide)
                == (other.alu, other.fma, other.wide))

    def __repr__(self):
        return f"Work(alu={self.alu:g}, fma={self.fma:g}, wide={self.wide:g})"

    @property
    def instructions(self) -> float:
        return self.alu + self.fma

    @property
    def alu_slots(self) -> float:
        return self.alu + self.wide

    @property
    def fma_slots(self) -> float:
        return self.fma + self.wide


# SASS instructions of each primitive by pipe, as ops/alu_bench.OP_PIPES
# records them from the built loops (a test holds the two together) ...
BUTTERFLY_OPS = Work(*alu_bench.OP_PIPES["butterfly"])  # a Shoup product,
                        # the sum's and the difference's compare, select and
                        # add, one add more
MONT_OPS = Work(*alu_bench.OP_PIPES["mont_mul"])  # 3 multiplies (one wide,
                        # one high), 3 adds, compare, select
SHOUP_OPS = Work(*alu_bench.OP_PIPES["shoup_mul"])  # mul.hi, 2 mul.lo (one
                        # with the subtract), compare, select, add
ADD_OPS = Work(*alu_bench.OP_PIPES["addmod"])  # addmod or submod: compare,
                        # select, three-input add
# ... and of the two that no loop measures, counted by hand at their least
WIDE_MAC_OPS = Work(0, 2, 1)  # 32 x 64-bit multiply-add of the fixed-point
                              # alpha: an IMAD.WIDE.U32 and an IMAD
ADD64_OPS = Work(2, 0, 0)     # 64-bit add, subtract or negate: two ALU ops

MEMORY_BYTES_PER_S = 3.35e12  # device memory rate of the H100 SXM data sheet
ISSUE_PER_SM_CLOCK = 128      # thread-instructions dispatched a clock and SM
PIPE_PER_SM_CLOCK = 64        # lanes of each integer pipe a clock and SM


class Bound(NamedTuple):
    """The least time of a case on a card, in ms, and its four terms."""
    bytes_ms: float
    issue_ms: float             # all instructions at 128 a clock and SM
    alu_ms: float               # ALU issue slots at 64
    fma_ms: float               # FMA issue slots at 64

    @property
    def ops_ms(self) -> float:
        return max(self.issue_ms, self.alu_ms, self.fma_ms)

    @property
    def ms(self) -> float:
        return max(self.bytes_ms, self.ops_ms)

    @property
    def term(self) -> str:
        """The largest term: "bytes", "issue", "ALU" or "FMA"."""
        terms = {"bytes": self.bytes_ms, "issue": self.issue_ms,
                 "ALU": self.alu_ms, "FMA": self.fma_ms}
        return max(terms, key=terms.get)

    @property
    def issue_only_ms(self) -> float:
        """The bound before the pipes were counted: bytes, or all
        instructions at 128 a clock and SM."""
        return max(self.bytes_ms, self.issue_ms)


def bound(nbytes: float, work: Work, sms: int, clock_hz: float) -> Bound:
    """The least time of ``work`` and ``nbytes`` on ``sms`` SMs at
    ``clock_hz``: the one definition of the bound that chip_smoke.py and
    kernel_times.py print."""
    per_ms = sms * clock_hz * 1e-3          # SM clocks a millisecond
    return Bound(nbytes / MEMORY_BYTES_PER_S * 1e3,
                 work.instructions / (ISSUE_PER_SM_CLOCK * per_ms),
                 work.alu_slots / (PIPE_PER_SM_CLOCK * per_ms),
                 work.fma_slots / (PIPE_PER_SM_CLOCK * per_ms))


class Case(NamedTuple):
    name: str                   # the kernel, as in ops/_cuda.KERNELS
    label: str                  # the variant and its shapes
    kernel: Callable[[], object]
    plain: Callable[[], object]
    bytes: int                  # least device-memory traffic
    ops: Work                   # least integer instructions by pipe
    kernel_reps: int = 10       # timed repetitions of the kernel ...
    plain_reps: int = 3         # ... and of the plain version
    plain_warmup: int = 1       # untimed calls of the plain version first
    butterflies: int = 0        # those of its stage chains, where it has any
    n: int = 0                  # the ring degree of those chains
    timed: bool = True          # False: kernel against kernel, only compared
    layout: str = ""            # the kernel's layout, where it has several
    args: tuple = ()            # its arguments, where a caller reads them
    extra: int = 0              # device-memory bytes of its own scratch past
                                # one block beyond its top passes (own_bytes)


def _butterflies(n: int, transforms: int) -> int:
    return transforms * (n // 2) * (n.bit_length() - 1)


def _ntt_ops(n: int, transforms: int) -> Work:
    return _butterflies(n, transforms) * BUTTERFLY_OPS


def _with_butterflies(cases: list, n: int, transforms: list) -> list:
    """The cases with the butterflies of their transforms filled in (one
    count of transforms a case, 0 for a kernel without a stage chain)."""
    assert len(cases) == len(transforms)
    return [c._replace(butterflies=_butterflies(n, t), n=n if t else 0)
            for c, t in zip(cases, transforms)]


def _ext_ops(coeffs: int, ls: int, ld: int, epilogue: bool = False) -> Work:
    """HPS conversion of ``coeffs`` coefficients from ls to ld primes."""
    per = (ls * (SHOUP_OPS + WIDE_MAC_OPS)
           + ld * (ls * (SHOUP_OPS + ADD_OPS) + SHOUP_OPS + ADD_OPS)
           + (ld * (ADD_OPS + SHOUP_OPS) if epilogue else 0))
    return coeffs * per


def _ks_ops(n: int, polys: int, R: int, Lp: int, reps: int,
            fused_eval: bool) -> Work:
    """Gadget key switch of ``polys`` ciphertexts from limb residues."""
    rows = polys * Lp
    ops = (_ntt_ops(n, rows * (R + 2))
           + rows * n * (R * reps * Work(2) + 2 * R * (MONT_OPS + ADD_OPS)
                         + 2 * SHOUP_OPS))
    if fused_eval:
        ops += _ntt_ops(n, rows * 2) + rows * n * 2 * (SHOUP_OPS + ADD_OPS)
    return ops


def _flat(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def max_abs_err(a, b) -> int:
    """Largest |a - b| over the (tuples of) int32 outputs, in int64."""
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(_flat(a), _flat(b)))


def equal(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(torch.equal(x, y)
                                      for x, y in zip(fa, fb))


def takes(name: str, n: int) -> bool:
    """Kernel ``name`` (of ops/_cuda.KERNELS) takes ring degree n: it has no
    ring degree, or n lies in its range."""
    k = next(k for k in _cuda.KERNELS if k.name == name)
    return k.logn is None or (n.bit_length() - 1 in k.degrees
                              and n & (n - 1) == 0)


def cases(param, batch: int, device, gen: prng.Gen, K: int = 2,
          res=None) -> list:
    """One Case per kernel variant that the main path launches, with K
    auxiliary primes for the hybrid key; the kernels that hold three
    polynomials (K6, K7, K8) only where they take param's ring degree.
    ``res(primes, shape)`` draws the operands (by default uniform residues
    from gen on the host; ``prng.device_residues`` on the card)."""
    qs, ps, L, n = param.qs, param.ps, param.L, param.n
    ks = ks_ext_primes(param, K)
    both = qs + ks
    three = takes("tensor_mul4", n)

    if res is None:
        def res(primes, shape):
            return prng.uniform_mod_multi(gen, shape, primes, device)

    x2q = res(qs, (batch, 2, n))                 # a CT stacked as in to_evals
    eq = [res(qs, (batch, 2, n)) for _ in range(2)]
    ep = [res(ps, (batch, 2, n)) for _ in range(2)]
    t_q = (param.t,) * len(qs)
    t_p = (param.t,) * len(ps)
    ninv_t = tuple(pow(n, -1, q) * param.t % q for q in qs)
    digits = res(both, (batch, n))
    mont = tuple((1 << 32) % p for p in both)
    edm = res(both, (batch, n))[None]            # [R=1, L+K, batch, n]
    kb, ka = res(both, (n,))[None], res(both, (n,))[None]
    w_q, w_p = res(qs, (batch, 3, n)), res(ps, (batch, 3, n))
    r_p = res(ps, (batch, 3, n))
    c2 = res(qs, (batch, n))
    acc = res(both, (batch, n))
    qinv = tuple(pow(math.prod(qs), -1, p) for p in ps)
    pinv = tuple(pow(math.prod(ks), -1, q) for q in qs)
    if three:
        ct = [res(qs, (batch, n)) for _ in range(4)]  # two CTs' components
        x4 = res(qs, (batch, 4, n))
        out3 = res(qs, (batch, 3, n))                 # _scale_to_q's output
        gb, ga = (torch.stack([res(qs, (n,)) for _ in range(L)])
                  for _ in range(2))                  # gadget key [L, L, n]
    reps = nc.digit_reps(qs, qs)
    shape = f"B={batch} n={n}"
    M, K, LK = len(ps), len(ks), len(both)
    rows = batch * n                      # coefficients of one [B, n] limb
    tw = 2 * n                            # root table + companions, a prime

    def pair(name, label, words, ops, kern, plain, *args, **kw):
        return Case(name, f"{label} {shape}", lambda: kern(*args, **kw),
                    lambda: plain(*args, **kw), 4 * words, ops)

    def tensor_work(ld, ls=None):
        """K6 / tensor_mul: words moved and operations for ld primes."""
        src_rows = ld if ls is None else ls
        words = 4 * src_rows * rows + 3 * ld * rows + 2 * tw * ld
        ops = (_ntt_ops(n, 7 * ld * batch)
               + ld * rows * (4 * MONT_OPS + ADD_OPS + 3 * SHOUP_OPS)
               + (0 if ls is None else _ext_ops(4 * rows, ls, ld)))
        return words, ops

    one = [
        pair("ntt_multi", "forward Q", 2 * 2 * L * rows + tw * L,
             _ntt_ops(n, 2 * L * batch), nc.ntt_multi_kernel,
             nc.ntt_multi_plain, x2q, qs),
        pair("ntt_multi", "inverse Q with fin=t/n",
             2 * 2 * L * rows + tw * L,
             _ntt_ops(n, 2 * L * batch) + 2 * L * rows * SHOUP_OPS,
             nc.ntt_multi_kernel, nc.ntt_multi_plain, x2q, qs, inverse=True,
             fin=ninv_t),
        pair("ntt_multi", "forward QK Montgomery", 2 * LK * rows + tw * LK,
             _ntt_ops(n, LK * batch) + LK * rows * SHOUP_OPS,
             nc.ntt_multi_kernel, nc.ntt_multi_plain, digits, both,
             fin=mont),
        *(pair("tensor_eval4", f"{tag} strided views",
               7 * ld * rows + tw * ld,
               _ntt_ops(n, 3 * ld * batch)
               + ld * rows * (4 * MONT_OPS + ADD_OPS + 3 * SHOUP_OPS),
               nc.tensor_eval4_kernel, nc.tensor_eval4_plain,
               e[0][..., 0, :], e[0][..., 1, :], e[1][..., 0, :],
               e[1][..., 1, :], primes, scale=sc)
          for tag, ld, e, primes, sc in (("Q", L, eq, qs, t_q),
                                         ("P", M, ep, ps, t_p))),
        pair("ks_contract", "R=1 over QK", 3 * LK * rows + 2 * LK * n + tw * LK,
             _ntt_ops(n, 2 * LK * batch)
             + LK * rows * 2 * (MONT_OPS + SHOUP_OPS),
             nc.ks_contract_kernel, nc.ks_contract_plain, edm, kb, ka, both),
        pair("base_extend", "Q->K unsigned", (L + K) * rows,
             _ext_ops(rows, L, K), ext.base_extend_fused_kernel,
             ext.base_extend_fused_plain, c2, qs, ks),
        pair("base_extend", "Q->P (w - ext)*Q^-1", 3 * (L + 2 * M) * rows,
             _ext_ops(3 * rows, L, M, True), ext.base_extend_fused_kernel,
             ext.base_extend_fused_plain, w_q, qs, ps, w=w_p, sub_mul=qinv),
        pair("base_extend", "P->Q centered", 3 * (M + L) * rows,
             _ext_ops(3 * rows, M, L), ext.base_extend_fused_kernel,
             ext.base_extend_fused_plain, r_p, ps, qs, centered=True),
        pair("base_extend", "K->Q centered (w - ext)*P^-1",
             (K + 2 * L) * rows, _ext_ops(rows, K, L, True),
             ext.base_extend_fused_kernel, ext.base_extend_fused_plain,
             acc[L:], ks, qs, centered=True, w=acc[:L], sub_mul=pinv),
        pair("ext_ntt", "Q->P", 2 * (L + M) * rows + tw * M,
             _ext_ops(2 * rows, L, M) + _ntt_ops(n, 2 * M * batch),
             nc.ext_ntt_kernel, nc.ext_ntt_plain, x2q, qs, ps)]
    transforms = [2 * L, 2 * L, LK, 3 * L, 3 * M, 2 * LK, 0, 0, 0, 0, 2 * M]
    if not three:
        return _with_butterflies(one, n, [t * batch for t in transforms])
    return _with_butterflies(one + [
        pair("tensor_mul4", "Q basis", *tensor_work(L),
             nc.tensor_mul4_kernel, nc.tensor_mul4_plain, *ct, qs,
             scale=t_q),
        pair("tensor_mul4", "P basis, Q->P inside", *tensor_work(M, L),
             nc.tensor_mul4_kernel, nc.tensor_mul4_plain, *ct, ps,
             scale=t_p, src=qs),
        pair("tensor_mul", "stacked Q", *tensor_work(L),
             nc.tensor_mul_kernel, nc.tensor_mul_plain, x4, qs, scale=t_q),
        pair("ks_fused", "R=L over Q, strided c2",
             3 * L * rows + 2 * L * L * n + 2 * tw * L,
             _ks_ops(n, batch, L, L, reps, False), nc.ks_fused_kernel,
             nc.ks_fused_plain, out3[..., 2, :], gb, ga, qs, qs),
        pair("ks_fused_eval", "R=L over Q, strided c2 and adds",
             7 * L * rows + 2 * L * L * n + 2 * tw * L,
             _ks_ops(n, batch, L, L, reps, True), nc.ks_fused_eval_kernel,
             nc.ks_fused_eval_plain, out3[..., 2, :], gb, ga, qs, qs,
             (out3[..., 0, :], out3[..., 1, :])),
    ], n, [t * batch for t in transforms + [
        7 * L, 7 * M, 7 * L, (L + 2) * L, (L + 4) * L]])


def linear_cases(param, batch: int, device, gen: prng.Gen) -> list:
    """One Case per kernel variant of the linear pipeline (``to_evals``,
    ``pt_to_evals``, ``from_evals``): it launches only the transform and the
    fused extension, at its own ring degree, basis sizes and batch."""
    qs, ps, n = param.qs, param.ps, param.n
    L, M, rows, tw = len(qs), len(ps), batch * n, 2 * n
    x2q = prng.uniform_mod_multi(gen, (batch, 2, n), qs, device)
    ninv = tuple(pow(n, -1, q) for q in qs)
    shape = f"B={batch} n={n}"

    def pair(name, label, words, ops, kern, plain, *args, **kw):
        return Case(name, f"{label} {shape}", lambda: kern(*args, **kw),
                    lambda: plain(*args, **kw), 4 * words, ops)

    return [
        pair("ntt_multi", "linear: forward Q", 2 * 2 * L * rows + tw * L,
             _ntt_ops(n, 2 * L * batch), nc.ntt_multi_kernel,
             nc.ntt_multi_plain, x2q, qs),
        *(pair("ntt_multi", f"linear: plaintext forward {tag} Montgomery",
               2 * ld * rows + tw * ld,
               _ntt_ops(n, ld * batch) + ld * rows * SHOUP_OPS,
               nc.ntt_multi_kernel, nc.ntt_multi_plain,
               prng.uniform_mod_multi(gen, (batch, n), primes, device),
               primes, fin=tuple((1 << 32) % p for p in primes))
          for tag, ld, primes in (("Q", L, qs), ("P", M, ps))),
        pair("ntt_multi", "linear: inverse Q with fin=1/n",
             2 * 2 * L * rows + tw * L,
             _ntt_ops(n, 2 * L * batch) + 2 * L * rows * SHOUP_OPS,
             nc.ntt_multi_kernel, nc.ntt_multi_plain, x2q, qs, inverse=True,
             fin=ninv),
        pair("ext_ntt", "linear: Q->P", 2 * (L + M) * rows + tw * M,
             _ext_ops(2 * rows, L, M) + _ntt_ops(n, 2 * M * batch),
             nc.ext_ntt_kernel, nc.ext_ntt_plain, x2q, qs, ps),
    ]


def _offset_word(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous tensor whose data starts one word past the
    allocator's alignment (so not on a 16-byte boundary)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


EXT_SWEEP_LS = (1, 2, 3, 4, 5, 15)      # K4's source counts in the sweep
EXT_SWEEP_LD = (1, 4, 5)                # and its destination counts
# the source counts past 15 (the 2^59 fixed-point sum of alpha past 2^63):
# K4 from each, to 5 primes
WIDE_SWEEP_LS = tuple(range(16, ext.MAX_SRC + 1))
# K5 and K6 with a source basis, and the lift alone, from every count (K5's
# direct instances 2 and 4 and K6's 4; every other count staged), K5 and K6
# to 5 primes
CONV_SWEEP_LS = tuple(range(1, ext.MAX_SRC + 1))


KS_SWEEP_R = (1, 2, 4, 9)               # K3's, K7's and K8's digit rows in
KS_SWEEP_LP = (2, 6)                    # the sweep, and their prime counts
KS_BOOT_R, KS_BOOT_LOGN = 39, 11        # K7/K8 at the CKKS-bootstrap rows
KS_PATH_R = 29                          # and at n = 2^15 at phase 19's R = L
# K3, K7 and K8 at the CKKS linear maps' shape (models/ckks/eval.py at
# n = 2^12, L = 43, K = 2): R = L digit rows over the L + K primes of Q u P
KS_MAPS_R, KS_MAPS_LP, KS_MAPS_LOGN = 43, 45, 12
EXT_SUM_SWEEP_LD = 5                    # K11's destination count in the sweep


def radix_cases(logn: int, batch: int, device, gen: prng.Gen) -> list:
    """The redesigned kernels at ring degree 2^logn on a small batch
    (compared only, not timed): K1-K3, K5-K9 and K12 on the
    register-resident chains, whose pass structure differs with log n, and
    K4, whose instance differs with the source count; each kernel only where
    it takes 2^logn (all of them take 2^7 .. 2^15; K6-K8 at 2^15 on
    two-block clusters).

      K1: forward (without fin, and with the Montgomery 2^32) and inverse
          (the default n^-1, and an explicit fin), each on a contiguous
          batch and on a contiguous tensor offset by one word (the
          inverse's word-by-word first pass);
      K9: forward and inverse under a 30-bit prime (the TFHE pair's) and a
          31-bit one (the CRT pair's), on int64 rows that are 16-byte
          aligned and one int64 word off;
      K12: reps 0, 1 and 3;
      K2: contiguous operands, the strided views of a stacked pair, and rows
          that are not 16-byte aligned (its word-by-word load);
      K3: KS_SWEEP_R digit rows over each of KS_SWEEP_LP primes, and the
          word-by-word form (edm one word off the alignment) at R = 2; at
          n = 2^KS_MAPS_LOGN also KS_MAPS_R rows over KS_MAPS_LP primes;
      K5: from each of CONV_SWEEP_LS source primes (2 and 4: its direct
          instances; the others: its staged layout, the lift first) to 5
          destination primes;
      K6: over Q with a scale and without, the stacked operand of
          tensor_mul (row strides), rows that are not 16-byte aligned, and
          from each of CONV_SWEEP_LS source primes (4: its direct instance;
          the others: its staged layout) to 5 destination primes;
      the lift alone (ext_lift, which K5 and K6 launch before their staged
          layout): from each of CONV_SWEEP_LS source primes, unsigned and
          centered on [Ls, batch, n] (its vector form), and on rows of
          n - 1 and on an x one word off the 16-byte alignment (its word
          form);
      K7, K8: KS_SWEEP_R limb rows over 30-bit source primes to each of
          KS_SWEEP_LP 28-bit primes (reps >= 2), plus KS_BOOT_R rows to 2
          primes at n = 2^KS_BOOT_LOGN, KS_PATH_R rows to each at n = 2^15
          (the instance on two-block clusters) and KS_MAPS_R rows of its first
          primes to the KS_MAPS_LP 30-bit primes of Q u P at
          n = 2^KS_MAPS_LOGN; the paths' form (R = L = 4 over the
          same primes, c_limbs and K8's adds strided views of one [L, B, 3,
          n] tensor); and c_limbs, kb and ka one word off the 16-byte
          alignment (the keys' word-by-word reads);
      K4: from each of EXT_SWEEP_LS to each of EXT_SWEEP_LD primes, unsigned
          and centered, with and without the (w - ext) * c epilogue, on
          [Ls, batch, n] (the vector form); per source count also on a row
          length of n - 1 (total % 4 != 0) and on an unaligned x and w (both
          the word form); from each of WIDE_SWEEP_LS to 5 primes, unsigned
          and centered with the epilogue (the vector form) and centered on
          rows of n - 1 (the word form);
      K11: from each source count 1 .. MAX_SRC to EXT_SUM_SWEEP_LD primes
          on the (ys, alpha) of [Ls, batch, n] residues, unsigned and
          centered (the vector form), and on rows of n - 1 and on an
          unaligned ys and alpha (the word form)."""
    n = 1 << logn
    primes = ntt_primes(9 + ext.MAX_SRC, 30, 1 << 16)
    qs, ps = primes[:4], primes[4:9]
    # ls source primes apart from qs and ps: the last ls of the pool
    apart = {ls: primes[len(primes) - ls:]
             for ls in range(1, ext.MAX_SRC + 1)}

    def res(basis, shape):
        return prng.uniform_mod_multi(gen, shape, basis, device)

    def compared(name, label, kern, plain, *args, **kw):
        return _pair(name, f"{label} B={batch} n={n}", 0, 0, kern, plain,
                     *args, **kw)._replace(timed=False)

    out = []
    mont = tuple((1 << 32) % q for q in qs)
    t_n = tuple(pow(n, -1, q) * 256 % q for q in qs)
    for layout, make in (("contiguous", lambda t: t),
                         ("offset by one word", _offset_word)):
        x = make(res(qs, (batch, n)))
        for label, kw in (("forward", {}),
                          ("forward fin=2^32", dict(fin=mont)),
                          ("inverse", dict(inverse=True)),
                          ("inverse fin=t/n", dict(inverse=True, fin=t_n))):
            out.append(compared("ntt_multi", f"{label}, {layout}",
                                nc.ntt_multi_kernel, nc.ntt_multi_plain, x,
                                qs, **kw))
    for p in (ntt_mod.CRT_PRIMES_TFHE[0], ntt_mod.CRT_PRIMES[0]):
        x = prng.uniform_mod(gen, (batch, n), p, device)
        for layout, row in (("aligned", x), ("one word off", _offset_word(x))):
            for inverse in (False, True):
                out.append(compared(
                    "ntt", f"{'inverse' if inverse else 'forward'} q={p} "
                    f"({p.bit_length()} bits), {layout}", nc.ntt_kernel,
                    nc.ntt_plain, row, p, inverse=inverse))
    q = ntt_mod.CRT_PRIMES_TFHE[0]
    x = prng.uniform_mod(gen, (batch, n), q, device).int()
    out += [compared("ntt_smem_ceiling", f"reps={reps}",
                     alu_bench.ntt_smem_ceiling_kernel,
                     alu_bench.ntt_smem_ceiling_plain, x, q, reps)
            for reps in (0, 1, 3)]
    pair = res(qs, (batch, 2, n))
    ragged = res(qs, (batch, n + 1))[..., 1:]        # rows at odd offsets
    operands = {"contiguous": [res(qs, (batch, n)) for _ in range(4)],
                "strided views": [pair[..., 0, :], pair[..., 1, :],
                                  pair[..., 1, :], pair[..., 0, :]],
                "unaligned rows": [ragged, ragged, pair[..., 0, :], ragged]}
    scale = tuple(range(3, 3 + len(qs)))
    out += [compared("tensor_eval4", label, nc.tensor_eval4_kernel,
                     nc.tensor_eval4_plain, *ops, qs, scale=scale)
            for label, ops in operands.items()]
    for ls in CONV_SWEEP_LS:
        src = (qs + primes[9:])[:ls] if ls <= 5 else apart[ls]
        out.append(compared("ext_ntt", f"{ls} -> {len(ps)} primes",
                            nc.ext_ntt_kernel, nc.ext_ntt_plain,
                            res(src, (batch, n)), src, ps))
    for ls in CONV_SWEEP_LS:
        src = apart[ls]
        x = res(src, (batch, n))
        for label, row, centered in (
                ("unsigned", x, False), ("centered", x, True),
                ("rows of n - 1", res(src, (batch, n - 1)), False),
                ("x one word off", _offset_word(x), True)):
            out.append(compared("ext_lift", f"{ls} primes, {label}",
                                ext.lift_kernel, _lift_plain32, row, src,
                                centered))
    for lp in KS_SWEEP_LP:
        basis = primes[:lp]
        for R in KS_SWEEP_R:
            edm = torch.stack([res(basis, (batch, n)) for _ in range(R)])
            kb, ka = (torch.stack([res(basis, (n,)) for _ in range(R)])
                      for _ in range(2))
            out.append(compared("ks_contract", f"R={R} over {lp} primes",
                                nc.ks_contract_kernel, nc.ks_contract_plain,
                                edm, kb, ka, basis))
            if R == 2:
                out.append(compared(
                    "ks_contract", f"R={R} over {lp} primes, edm one word "
                    "off", nc.ks_contract_kernel, nc.ks_contract_plain,
                    _offset_word(edm), kb, ka, basis))
    maps = ntt_primes(KS_MAPS_LP, 30, 1 << 16)       # Q u P of the maps
    if logn == KS_MAPS_LOGN:
        R = KS_MAPS_R
        edm = torch.stack([res(maps, (batch, n)) for _ in range(R)])
        kb, ka = (torch.stack([res(maps, (n,)) for _ in range(R)])
                  for _ in range(2))
        out.append(compared("ks_contract", f"R={R} over {KS_MAPS_LP} primes",
                            nc.ks_contract_kernel, nc.ks_contract_plain,
                            edm, kb, ka, maps))
    if takes("tensor_mul4", n):
        narrow = ntt_primes(6, 28, 1 << 16)
        wide = ntt_primes(KS_BOOT_R, 30, 1 << 16)

        def ks_pair(label, c, kb, ka, dst, src, adds):
            return [compared("ks_fused", label, nc.ks_fused_kernel,
                             nc.ks_fused_plain, c, kb, ka, dst, src),
                    compared("ks_fused_eval", label, nc.ks_fused_eval_kernel,
                             nc.ks_fused_eval_plain, c, kb, ka, dst, src,
                             adds)]

        def ks_keys(R, dst):
            return [torch.stack([res(dst, (n,)) for _ in range(R)])
                    for _ in range(2)]

        for lp in KS_SWEEP_LP:
            dst = narrow[:lp]
            boot = lp == 2 and logn == KS_BOOT_LOGN
            rows = (KS_SWEEP_R + ((KS_BOOT_R,) if boot else ())
                    + ((KS_PATH_R,) if logn == nc.WIDE_LOGN else ()))
            for R in rows:
                src = wide[:R]
                c = torch.stack([res((s,), (batch, n))[0] for s in src])
                adds = tuple(res(dst, (batch, n)) for _ in range(2))
                out += ks_pair(f"R={R} over {lp} primes, reps="
                               f"{nc.digit_reps(dst, src)}", c,
                               *ks_keys(R, dst), dst, src, adds)
        if logn == KS_MAPS_LOGN:
            src = maps[:KS_MAPS_R]
            c = torch.stack([res((s,), (batch, n))[0] for s in src])
            adds = tuple(res(maps, (batch, n)) for _ in range(2))
            out += ks_pair(f"R={KS_MAPS_R} over {KS_MAPS_LP} primes (Q u P), "
                           f"reps={nc.digit_reps(maps, src)}", c,
                           *ks_keys(KS_MAPS_R, maps), maps, src, adds)
        out3 = res(qs, (batch, 3, n))                # _scale_to_q's output
        kb, ka = ks_keys(len(qs), qs)
        out += ks_pair(f"R={len(qs)} over Q, strided c_limbs", out3[..., 2, :],
                       kb, ka, qs, qs, (out3[..., 0, :], out3[..., 1, :]))
        out += ks_pair(f"R={len(qs)} over Q, every operand one word off",
                       _offset_word(res(qs, (batch, n))), _offset_word(kb),
                       _offset_word(ka), qs, qs,
                       tuple(_offset_word(res(qs, (batch, n)))
                             for _ in range(2)))
        quad = res(qs, (batch, 4, n))                # tensor_mul's operand
        for label, ops in operands.items():
            out.append(compared("tensor_mul4", f"{label}, scale",
                                nc.tensor_mul4_kernel, nc.tensor_mul4_plain,
                                *ops, qs, scale=scale))
        out.append(compared("tensor_mul4", "contiguous, no scale",
                            nc.tensor_mul4_kernel, nc.tensor_mul4_plain,
                            *operands["contiguous"], qs))
        out.append(compared("tensor_mul", "stacked, scale",
                            nc.tensor_mul_kernel, nc.tensor_mul_plain, quad,
                            qs, scale=scale))
        scale_p = tuple(range(7, 7 + len(ps)))
        for ls in CONV_SWEEP_LS:
            src = (qs + primes[9:])[:ls] if ls <= 5 else apart[ls]
            out.append(compared("tensor_mul4",
                                f"{ls} -> {len(ps)} primes, scale",
                                nc.tensor_mul4_kernel, nc.tensor_mul4_plain,
                                *(res(src, (batch, n)) for _ in range(4)), ps,
                                scale=scale_p, src=src))
    for ls in EXT_SWEEP_LS:
        src = apart[ls]
        x = res(src, (batch, n))
        for ld in EXT_SWEEP_LD:
            dst = ps[:ld]
            w = res(dst, (batch, n))
            sub_mul = tuple(range(5, 5 + ld))
            for centered in (False, True):
                for epi in ({}, dict(w=w, sub_mul=sub_mul)):
                    out.append(compared(
                        "base_extend",
                        f"{ls} -> {ld} primes, "
                        f"{'centered' if centered else 'unsigned'}"
                        f"{', epilogue' if epi else ''}",
                        ext.base_extend_fused_kernel,
                        ext.base_extend_fused_plain, x, src, dst,
                        centered=centered, **epi))
        dst = ps[:max(EXT_SWEEP_LD)]
        tail = res(src, (batch, n - 1))
        out.append(compared(
            "base_extend", f"{ls} -> {len(dst)} primes, rows of n - 1, "
            "centered, epilogue", ext.base_extend_fused_kernel,
            ext.base_extend_fused_plain, tail, src, dst, centered=True,
            w=res(dst, (batch, n - 1)), sub_mul=tuple(range(5, 5 + len(dst)))))
        out.append(compared(
            "base_extend", f"{ls} -> {len(dst)} primes, unaligned x and w, "
            "epilogue", ext.base_extend_fused_kernel,
            ext.base_extend_fused_plain, _offset_word(x), src, dst,
            w=_offset_word(res(dst, (batch, n))),
            sub_mul=tuple(range(5, 5 + len(dst)))))
    for ls in WIDE_SWEEP_LS:
        src, dst = apart[ls], ps
        x = res(src, (batch, n))
        w = res(dst, (batch, n))
        sub_mul = tuple(range(5, 5 + len(dst)))
        for centered in (False, True):
            out.append(compared(
                "base_extend", f"{ls} -> {len(dst)} primes, "
                f"{'centered' if centered else 'unsigned'}, epilogue",
                ext.base_extend_fused_kernel, ext.base_extend_fused_plain, x,
                src, dst, centered=centered, w=w, sub_mul=sub_mul))
        out.append(compared(
            "base_extend", f"{ls} -> {len(dst)} primes, rows of n - 1, "
            "centered", ext.base_extend_fused_kernel,
            ext.base_extend_fused_plain, res(src, (batch, n - 1)), src, dst,
            centered=True))
    dst = ps[:EXT_SUM_SWEEP_LD]
    for ls in range(1, ext.MAX_SRC + 1):
        src = apart[ls]
        for centered in (False, True):
            ys, alpha = (t.int() for t in ext.lift_plain(
                res(src, (batch, n)), src, centered))
            out.append(compared(
                "base_extend_sum", f"{ls} -> {len(dst)} primes, "
                f"{'centered' if centered else 'unsigned'}",
                ext.base_extend_sum_kernel, ext.base_extend_sum_plain, ys,
                alpha, src, dst))
        out.append(compared(
            "base_extend_sum", f"{ls} -> {len(dst)} primes, rows of n - 1",
            ext.base_extend_sum_kernel, ext.base_extend_sum_plain,
            ys[..., 1:].contiguous(), alpha[..., 1:].contiguous(), src, dst))
        out.append(compared(
            "base_extend_sum", f"{ls} -> {len(dst)} primes, unaligned ys "
            "and alpha", ext.base_extend_sum_kernel,
            ext.base_extend_sum_plain, _offset_word(ys), _offset_word(alpha),
            src, dst))
    return out


def _lift_plain32(x, src: tuple, centered: bool = False) -> tuple:
    """ext_cuda.lift_plain's (ys, alpha) as int32, the lift kernel's
    dtype."""
    return tuple(t.int() for t in ext.lift_plain(x, src, centered))


def lift_cases(param, batch: int, device, gen: prng.Gen, res=None) -> list:
    """The lift alone (ext_cuda.lift_kernel) on the operands that the
    paths' K5 (to_evals and mul_e: the [L, batch, 2, n] pair Q -> P) and K6
    (mul: each [L, batch, n] operand Q -> P) convert in their staged layout
    (ops/ntt_cuda.py::lift_plan), where they take it, against its plain
    version: L words read and L + 1 written a coefficient, L Shoup products
    and fixed-point multiply-adds."""
    qs, n = param.qs, param.n
    if res is None:
        def res(primes, shape):
            return prng.uniform_mod_multi(gen, shape, primes, device)
    L = len(qs)
    shapes = []
    if nc.lift_plan(_cuda.EXT_NTT, L, 2 * batch, n).staged:
        shapes.append(("K5's Q->P", (batch, 2, n)))
    if takes("tensor_mul4", n) and nc.lift_plan(_cuda.TENSOR_MUL4, L, batch,
                                                n).staged:
        shapes.append(("K6's Q->P, one operand", (batch, n)))
    out = []
    for label, shape in shapes:
        x = res(qs, shape)
        rows = math.prod(shape)
        dims = ", ".join(map(str, (L,) + shape))
        out.append(_pair("ext_lift", f"{label} [{dims}]",
                         4 * (2 * L + 1) * rows,
                         rows * L * (SHOUP_OPS + WIDE_MAC_OPS),
                         ext.lift_kernel, _lift_plain32, x, qs))
    return out


def cmux_step_ops(n: int, C: int, l: int) -> dict:
    """32-bit integer instructions (Work) of ONE CMux step of the blind
    rotation on one ciphertext (C = K + 1 polynomials, l digits each), by
    part:

      rotate   C*n words: negate and subtract in 64 bits, then l digits of a
               shift (two words) and a mask;
      forward  2 primes x C*l polynomials x (n/2) log n butterflies;
      contract 2 primes x 2C columns x C*l Shoup products and modular adds
               per coefficient;
      inverse  2 primes x 2C polynomials x (n/2) log n butterflies;
      crt      C*n words x 2 limbs: two n^-1 Shoup products, the reduction
               of r1 mod p2 (2), a modular subtract, the Shoup product by
               p1^-1, the 32 x 32 -> 64 multiply-add, the centering compare
               and subtract (2 x 64-bit), the limb shift and add; then the
               64-bit accumulate.
    """
    return {
        "rotate": C * n * (2 * ADD64_OPS + l * Work(3)),
        "forward": _ntt_ops(n, 2 * C * l),
        "contract": 2 * 2 * C * n * C * l * (SHOUP_OPS + ADD_OPS),
        "inverse": _ntt_ops(n, 2 * 2 * C),
        "crt": C * n * (2 * (3 * SHOUP_OPS + Work(2) + ADD_OPS
                             + WIDE_MAC_OPS + 2 * ADD64_OPS + ADD64_OPS)
                        + ADD64_OPS),
    }


def cmux_step_bytes(n: int, C: int, l: int, batch: int,
                    layout: str = "device") -> dict:
    """Device-memory bytes of ONE CMux step of K10's device-memory layout
    on ``batch`` ciphertexts (the cluster layout keeps all but the key in
    shared memory), by part, each at its least, L2 serving every re-read
    within the step; the split layout (n = 2^16) moves the same but half
    the key (its forward blocks read their accumulator component at i and
    i + n/2, and four blocks form each digit: L2 serves those re-reads),
    and so does the quarter layout (n = 2^17: each forward block forms the
    digits of its own quarter of a component: 2 l blocks read each
    accumulator word):

      scratch  the digit evaluations [B, 2, C*l, n] of 32-bit words,
               written by the forward blocks and read back once by the
               inverse clusters (2C clusters read each row; L2 serves all
               but the first); in the grid layout (n > 2^15) also the
               words between its passes: the digit polynomials' and the
               2C columns', each written and read once a top pass
               (ntt_cuda._chunk_plan);
      acc      the 64-bit accumulator [B, C, n], read once by the forward
               blocks and read and written once by the atomic adds of the
               inverse clusters (the grid layout's last pass: no atomics);
      key      the step's slice, values and Shoup companions under both
               primes, 4 planes of C*l*2C*n words, read once for the whole
               batch (the split, quarter and device-memory layouts'
               Montgomery contraction reads the 2 planes of values alone).
    """
    scratch = 2 * batch * 2 * C * l * n * 4
    if layout == "grid":
        passes = len(nc._chunk_plan(n.bit_length() - 1).top)
        scratch += 2 * passes * batch * 2 * (C * l + 2 * C) * n * 4
    return {"scratch": scratch,
            "acc": 3 * batch * C * n * 8,
            "key": (2 if layout in (_cuda.SPLIT, _cuda.QUARTER, "device")
                    else 4)
            * C * l * 2 * C * n * 4}


def _pair(name, label, nbytes, ops, kern, plain, *args, **kw) -> Case:
    return Case(name, label, lambda: kern(*args, **kw),
                lambda: plain(*args, **kw), nbytes, ops)


def top_pass_bytes(n: int, polys: int) -> int:
    """The device-memory bytes that a transform of ``polys`` polynomials
    past one block moves beyond its inputs and outputs
    (csrc/ntt_chunks.cuh): each top pass writes and reads back its 32-bit
    words once (0 at n <= 2^15).  Not in a case's ``bytes`` (the least any
    kernel must move); the bound of the kernel's own traffic adds it."""
    if n <= 1 << nc.CHUNK_LOGN:
        return 0
    return len(nc._chunk_plan(n.bit_length() - 1).top) * 8 * polys * n


def own_bytes(case) -> int:
    """The device-memory bytes of a transform kernel's own traffic past one
    block (K1-K3, K5-K9, K12): its least bytes, the top passes of its
    transforms (``top_pass_bytes``; none in K12's split, where the
    polynomial stays on the chip) and the round trips of its other scratch
    (the case's ``extra``: K12's chunked transforms after the first read
    and write the polynomial once more each; K6's eval scratch and lift;
    K7's and K8's sums in device memory)."""
    n = case.n
    if case.layout == _cuda.SPLIT:
        return case.bytes + case.extra
    transforms = case.butterflies // ((n // 2) * (n.bit_length() - 1))
    return case.bytes + top_pass_bytes(n, transforms) + case.extra


def ntt_case(label: str, x, q: int, inverse: bool) -> Case:
    """K9 on int64 rows x [..., n] under q: every word read and written once
    (8 bytes each) with the root table and its companions (8 bytes a
    coefficient), the transforms' butterflies and, on the inverse, n^-1."""
    n = x.shape[-1]
    polys = x.numel() // n
    return _pair("ntt", label, 2 * 8 * polys * n + 8 * n,
                 _ntt_ops(n, polys) + (polys * n * SHOUP_OPS
                                       if inverse else 0),
                 nc.ntt_kernel, nc.ntt_plain, x, q,
                 inverse=inverse)._replace(
                     butterflies=_butterflies(n, polys), n=n)


def ntt_multi_case(label: str, x, qs: tuple, inverse: bool,
                   fin=None) -> Case:
    """K1 on int32 rows x [L, ..., n]: every word read and written once (4
    bytes each) with each prime's root table and companions, the
    butterflies and the final multiply (n^-1 on the inverse, ``fin`` where
    given)."""
    n = x.shape[-1]
    polys = x.numel() // n
    return _pair("ntt_multi", label, 2 * 4 * polys * n + 8 * n * len(qs),
                 _ntt_ops(n, polys) + (polys * n * SHOUP_OPS
                                       if inverse or fin else 0),
                 nc.ntt_multi_kernel, nc.ntt_multi_plain, x, qs,
                 inverse=inverse, fin=fin)._replace(
                     butterflies=_butterflies(n, polys), n=n)


# The degrees past one block that the sweep holds K1, K9, K2, K3, K5 and
# K12 against plain at: one top pass at 2^16 and 2^17, two at 2^20 and 2^22,
# three at 2^26 (the top: only 2013265921 = 15 * 2^27 + 1 has 2n-th roots
# there)
WIDE_SWEEP_LOGNS = (16, 17, 20, 22, 26)
WIDE_SWEEP_B = (1, 2, 3)


def _wide_primes(n: int) -> tuple:
    """Up to two primes with 2n-th roots, of the TFHE pair and the CRT
    primes, in that order."""
    pool = ntt_mod.CRT_PRIMES_TFHE + ntt_mod.CRT_PRIMES
    return tuple(p for p in pool if (p - 1) % (2 * n) == 0)[:2]


def _layout_of(n: int) -> str:
    """The layout a chain kernel of two schedules runs at n (the record's
    row): "" up to a block's polynomial, "chunked" past it."""
    return _cuda.CHUNKED if n > 1 << nc.CHUNK_LOGN else ""


def tensor_eval4_case(label: str, ops, dst: tuple, scale=None) -> Case:
    """K2 on the four [Ld, B.., n] operands ``ops`` (possibly strided
    views, one view standing for two of them): each distinct operand's
    words read once, the three products written once, the tables; 3 Ld B
    inverse transforms, 4 Montgomery products, an add and 3 Shoup products
    (the products' and n^-1 t) a coefficient."""
    n, ld = ops[0].shape[-1], len(dst)
    rows = ops[0].numel() // ld
    distinct = len({(o.data_ptr(), o.stride()) for o in ops})
    return _pair("tensor_eval4", label,
                 4 * ((distinct + 3) * ld * rows + 2 * n * ld),
                 _ntt_ops(n, 3 * rows // n * ld)
                 + ld * rows * (4 * MONT_OPS + ADD_OPS + 3 * SHOUP_OPS),
                 nc.tensor_eval4_kernel, nc.tensor_eval4_plain, *ops, dst,
                 scale=scale)._replace(
                     butterflies=_butterflies(n, 3 * rows // n * ld), n=n,
                     layout=_layout_of(n))


def ks_contract_case(label: str, edm, kb, ka, primes: tuple) -> Case:
    """K3 on digit rows edm [R, Lp, B.., n] and key rows [R, Lp, n]: every
    digit and key word read once, both halves written once, the tables; 2
    Lp B inverse transforms, per coefficient and half R Montgomery products,
    R - 1 adds and n^-1."""
    R, lp, n = edm.shape[0], len(primes), edm.shape[-1]
    rows = edm[0].numel() // lp
    return _pair("ks_contract", label,
                 4 * (R * lp * rows + 2 * R * lp * n + 2 * lp * rows
                      + 2 * n * lp),
                 _ntt_ops(n, 2 * lp * rows // n)
                 + lp * rows * 2 * (R * MONT_OPS + (R - 1) * ADD_OPS
                                    + SHOUP_OPS),
                 nc.ks_contract_kernel, nc.ks_contract_plain, edm, kb, ka,
                 primes)._replace(butterflies=_butterflies(n, 2 * lp * rows
                                                           // n),
                                  n=n, layout=_layout_of(n))


# source words past which a case holds K5 against its plain version with
# the extension (per coefficient) taken over slices of this many
# coefficients: the int64 lift of 31 rows at n = 2^26 would not fit the
# card beside the kernel's operands
EXT_PLAIN_WORDS, EXT_PLAIN_SLICE = 1 << 28, 1 << 22


def _ext_ntt_plain_sliced(x, src: tuple, dst: tuple):
    """ntt_cuda.ext_ntt_plain's value, its extension over slices of the
    last axis."""
    n = x.shape[-1]
    return nc.ntt_multi_plain(torch.cat([
        ext.base_extend_fused_plain(x[..., i:i + EXT_PLAIN_SLICE], src, dst)
        for i in range(0, n, EXT_PLAIN_SLICE)], dim=-1), dst)


def ext_ntt_case(label: str, x, src: tuple, dst: tuple) -> Case:
    """K5 on x [Ls, B.., n]: every source word read and every output word
    written once, the tables; the conversion of each coefficient and Ld B
    forward transforms."""
    ls, ld, n = len(src), len(dst), x.shape[-1]
    rows = x.numel() // ls
    plain = (_ext_ntt_plain_sliced if x.numel() > EXT_PLAIN_WORDS
             else nc.ext_ntt_plain)
    return _pair("ext_ntt", label, 4 * ((ls + ld) * rows + 2 * n * ld),
                 _ext_ops(rows, ls, ld) + _ntt_ops(n, ld * rows // n),
                 nc.ext_ntt_kernel, plain, x, src, dst)._replace(
                     butterflies=_butterflies(n, ld * rows // n), n=n,
                     layout=_layout_of(n))


def ceiling_case(label: str, x, q: int, reps: int,
                 layout: str | None = None) -> Case:
    """K12 on x [B, n] over ``reps`` transforms: the polynomial read and
    written once, the tables where a transform runs; B reps transforms, in
    ``layout`` (alu_bench.ceiling_layout; at 2^16 split unless named).  On
    the chunked schedule each transform after the first reads and writes
    the polynomial once more (``extra``)."""
    B, n = x.shape
    layout = alu_bench.ceiling_layout(n.bit_length() - 1, layout)
    return _pair("ntt_smem_ceiling", label,
                 4 * (2 * B * n + (2 * n if reps else 0)),
                 _ntt_ops(n, B * reps),
                 partial(alu_bench.ntt_smem_ceiling_kernel, layout=layout),
                 alu_bench.ntt_smem_ceiling_plain, x, q, reps)._replace(
                     butterflies=_butterflies(n, B * reps), n=n,
                     layout="" if layout == "block" else layout,
                     extra=(8 * max(reps - 1, 0) * x.numel()
                            if layout == _cuda.CHUNKED else 0))


# int64 words of a plain version's largest intermediate past which a case
# forms its value over slices of the batch (the plain K7 and K8 hold
# [R, Lp, B, n]: 56 GiB at R = Lp = 29, B = 128, n = 2^16)
PLAIN_WORDS = 1 << 28


def _by_batch(fn, tensors: tuple, words: int):
    """fn(*tensors), each [rows, B, ..], formed over slices of the batch
    axis (1) of at most PLAIN_WORDS // words polynomials (``words``: those
    of the largest intermediate a polynomial), the outputs joined along
    it."""
    B = tensors[0].shape[1]
    step = max(1, PLAIN_WORDS // words)
    if step >= B:
        return fn(*tensors)
    parts = [_flat(fn(*(t[:, i:i + step] for t in tensors)))
             for i in range(0, B, step)]
    out = tuple(torch.cat(p, dim=1) for p in zip(*parts))
    return out if len(out) > 1 else out[0]


def tensor_mul4_case(label: str, ops, dst: tuple, scale=None,
                     src=None) -> Case:
    """K6 on the four operands ``ops`` ([Ld, B, n] over dst, or [Ls, B, n]
    over ``src``; possibly strided views): every operand word read and the
    three products written once, both directions' tables; 7 Ld B
    transforms, 4 Montgomery products, an add and 3 Shoup products a
    coefficient and, with a source basis, the conversion of each operand
    word.  Past one block its own traffic beyond the top passes
    (``extra``): the eval scratch of the four forwards written and read
    once, and the lift's rows when it is staged.  The plain value is formed
    over slices of the batch (``_by_batch``)."""
    n, ld = ops[0].shape[-1], len(dst)
    ls = ld if src is None else len(src)
    rows = ops[0].numel() // ls                  # B n
    polys = rows // n
    extra = 0
    if n > 1 << nc.CHUNK_LOGN:
        extra = 2 * 4 * 4 * ld * rows
        if src is not None and nc.lift_plan(_cuda.TENSOR_MUL4, ls, polys,
                                            n).staged:
            extra += 2 * 4 * 4 * (ls + 1) * rows
    return Case(
        "tensor_mul4", label,
        lambda: nc.tensor_mul4_kernel(*ops, dst, scale=scale, src=src),
        lambda: _by_batch(lambda *o: nc.tensor_mul4_plain(
            *o, dst, scale=scale, src=src), tuple(ops), 4 * max(ls, ld) * n),
        4 * (4 * ls * rows + 3 * ld * rows + 4 * n * ld),
        _ntt_ops(n, 7 * ld * polys)
        + ld * rows * (4 * MONT_OPS + ADD_OPS + 3 * SHOUP_OPS)
        + (0 if src is None else _ext_ops(4 * rows, ls, ld)),
        butterflies=_butterflies(n, 7 * ld * polys), n=n,
        layout=_layout_of(n), extra=extra)


def tensor_mul_case(label: str, x4, qs: tuple, scale=None) -> Case:
    """tensor_mul on the stacked operand x4 [L, B, 4, n] (K6's kernels on
    its row strides): K6's work and own traffic."""
    k6 = tensor_mul4_case(label, [x4[..., i, :] for i in range(4)], qs,
                          scale)
    return k6._replace(
        name="tensor_mul",
        kernel=lambda: nc.tensor_mul_kernel(x4, qs, scale=scale),
        plain=lambda: _by_batch(lambda x: nc.tensor_mul_plain(
            x, qs, scale=scale), (x4,), 4 * len(qs) * x4.shape[-1]))


def _ks_case(name: str, label: str, c, kb, ka, primes: tuple,
             src_primes: tuple, adds=None) -> Case:
    """K7 (adds None) or K8 on limb rows c [R, B, n], keys [R, Lp, n] and
    K8's adds [Lp, B, n] (possibly strided views): the limbs, keys and adds
    read and the 2 (K8: 4) output rows written once, both directions'
    tables; the key switch's transforms, reductions and products
    (``_ks_ops``).  Past one block its own traffic beyond the top passes
    (``extra``): the two sums written and read back by every digit row and
    the inverse, K8's e_h once more.  The plain value (its [R, Lp, B, n]
    int64 digits) is formed over slices of the batch (``_by_batch``)."""
    R, lp, n = c.shape[0], len(primes), c.shape[-1]
    rows = c[0].numel()                          # B n
    polys = rows // n
    evalf = adds is not None
    extra = 0
    if n > 1 << nc.CHUNK_LOGN:
        extra = ((8 * R + 4) if evalf else (8 * R - 4)) * 2 * lp * rows
    if evalf:
        kern = partial(nc.ks_fused_eval_kernel, c, kb, ka, primes,
                       src_primes, adds)
        plain = partial(_by_batch, lambda c_, a0, a1: nc.ks_fused_eval_plain(
            c_, kb, ka, primes, src_primes, (a0, a1)), (c, *adds),
            R * lp * n)
    else:
        kern = partial(nc.ks_fused_kernel, c, kb, ka, primes, src_primes)
        plain = partial(_by_batch, lambda c_: nc.ks_fused_plain(
            c_, kb, ka, primes, src_primes), (c,), R * lp * n)
    return Case(name, label, kern, plain,
                4 * ((R + (6 if evalf else 2) * lp) * rows + 2 * R * lp * n
                     + 4 * n * lp),
                _ks_ops(n, polys, R, lp, nc.digit_reps(primes, src_primes),
                        evalf),
                butterflies=_butterflies(n, (R + (4 if evalf else 2)) * lp
                                         * polys),
                n=n, layout=_layout_of(n), extra=extra)


def ks_fused_case(label: str, c, kb, ka, primes: tuple,
                  src_primes: tuple) -> Case:
    """K7 (``_ks_case``)."""
    return _ks_case("ks_fused", label, c, kb, ka, primes, src_primes)


def ks_fused_eval_case(label: str, c, kb, ka, primes: tuple,
                       src_primes: tuple, adds) -> Case:
    """K8 (``_ks_case``)."""
    return _ks_case("ks_fused_eval", label, c, kb, ka, primes, src_primes,
                    adds)


# K2, K3, K5-K8 and K12 past one block in the sweep (their chunked
# schedules): K2 with and without a scale and on strided views; K3 at R
# digit rows of WIDE_OPS_R, aligned and one word off; K5 from the source
# counts of WIDE_OPS_LS (2 and 4 direct, 3 and 31 staged); K12 over
# WIDE_OPS_REPS; K6 from the source counts of WIDE_MUL4_LS (None: without
# a source basis; 4 direct, 3 staged) and tensor_mul on its stacked
# operand; K7 and K8 at R digit rows of WIDE_OPS_R, c_limbs and K8's adds
# strided views
WIDE_OPS_R = (1, 3)
WIDE_OPS_LS = (2, 4, 3, ext.MAX_SRC)
WIDE_OPS_REPS = (0, 1, 3)
WIDE_MUL4_LS = (None, 4, 3)


def wide_transform_cases(device, seed: int):
    """K1 and K9 past one block (csrc/ntt_chunks.cuh) against their plain
    versions (compared; chip_smoke.py times each kernel beside its bounds)
    at each log n of WIDE_SWEEP_LOGNS on batches of WIDE_SWEEP_B: K1 over
    up to two primes with 2n-th roots (of the TFHE pair and the CRT primes,
    in that order) forward without and with a final multiplier, inverse
    with n^-1 and with fin; K9 forward and inverse under each of them; at
    the last batch K1's inverse also on rows one word off the 16-byte
    alignment (its word-by-word first pass), K9's on int64 rows one word
    off.  Operands drawn on the card (``prng.device_residues``).  Yields
    one case at a time and leaves the root tables cached for
    ``wide_op_cases``, which runs at the same degrees and forgets them."""
    res = prng.device_residues(seed, device)
    for logn in WIDE_SWEEP_LOGNS:
        n = 1 << logn
        qs = _wide_primes(n)
        fin = tuple(range(3, 3 + len(qs)))
        for B in WIDE_SWEEP_B:
            x = res(qs, (B, n))
            last = B == WIDE_SWEEP_B[-1]
            rows = [("", x)] + ([(", one word off", _offset_word(x))]
                                if last else [])
            for tag, row in rows:
                for label, inverse, f in (("forward", False, None),
                                          ("forward fin", False, fin),
                                          ("inverse", True, None),
                                          ("inverse fin", True, fin)):
                    if tag and not inverse:
                        continue
                    yield ntt_multi_case(
                        f"{label} {list(row.shape)} over {qs}{tag}", row, qs,
                        inverse, f)._replace(timed=False)
            for i, q in enumerate(qs):
                y = x[i].long()
                ys = [("", y)] + ([(", one word off", _offset_word(y))]
                                  if last else [])
                for tag, row in ys:
                    for inverse in (False, True):
                        yield ntt_case(
                            f"{'inverse' if inverse else 'forward'} "
                            f"{list(row.shape)} q={q}{tag}", row, q,
                            inverse)._replace(timed=False)
            del x, rows


def wide_op_cases(device, seed: int):
    """K2, K3, K5-K8 and K12 past one block against their plain versions
    (compared; chip_smoke.py times each kernel beside its bounds) at each
    log n of WIDE_SWEEP_LOGNS over up to two primes with 2n-th roots: each
    variant at one batch of WIDE_SWEEP_B, in turn, so that every kernel
    runs each batch at each n (K5 on at most 2^31 source words: from 31
    sources at 2^26 on one polynomial; K6-K8 on one polynomial at 2^26).
    K5's and K6's source primes, and K7's and K8's limbs' primes, are
    30-bit primes apart from those.  Operands drawn on the card
    (``prng.device_residues``), each case's own, so that only the case in
    hand holds memory.  Yields one case at a time, then forgets the root
    tables."""
    res = prng.device_residues(seed, device)
    for logn in WIDE_SWEEP_LOGNS:
        n = 1 << logn
        qs = _wide_primes(n)
        src_pool = tuple(p for p in ntt_primes(ext.MAX_SRC + 2, 30, 1 << 16)
                         if p not in qs)[:ext.MAX_SRC]
        batch = iter(WIDE_SWEEP_B * 8)
        for tag, scaled, strided in (("scale", True, False),
                                     ("no scale", False, False),
                                     ("scale, strided views", True, True)):
            yield _wide_k2(res, qs, next(batch), n, tag, scaled, strided)
        for R in WIDE_OPS_R:
            for off in (False, True):
                yield _wide_k3(res, qs, next(batch), n, R, off)
        for ls in WIDE_OPS_LS:
            B = min(next(batch), max(1, (1 << 31) // (ls * n)))
            yield _wide_k5(res, src_pool[:ls], qs, B, n)
        # K12 at 2^16 split (its rule there) and chunked
        for layout in ((_cuda.SPLIT, _cuda.CHUNKED)
                       if logn == alu_bench.SPLIT_LOGN else (None,)):
            for reps in WIDE_OPS_REPS:
                yield _wide_k12(res, qs[0], next(batch), n, reps, layout)
        cap = max(1, (1 << 26) // n)             # one polynomial at 2^26
        for ls in WIDE_MUL4_LS:
            src = None if ls is None else src_pool[:ls]
            yield _wide_k6(res, src, qs, min(next(batch), cap), n)
        quad = res(qs, (min(next(batch), cap), 4, n))
        yield tensor_mul_case(f"stacked {list(quad.shape)} over {qs}", quad,
                              qs, tuple(range(3, 3 + len(qs))))._replace(
                                  timed=False)
        del quad
        for R in WIDE_OPS_R:
            yield from _wide_ks(res, src_pool[:R], qs, min(next(batch), cap),
                                n)
    nc.drop_tables()


def _wide_k2(res, qs, B, n, tag, scaled, strided) -> Case:
    if strided:
        pair = res(qs, (B, 2, n))
        ops = [pair[..., 0, :], pair[..., 1, :], pair[..., 1, :],
               pair[..., 0, :]]
    else:
        ops = [res(qs, (B, n)) for _ in range(4)]
    scale = tuple(range(3, 3 + len(qs))) if scaled else None
    return tensor_eval4_case(f"{tag} {[len(qs), B, n]} over {qs}", ops, qs,
                             scale)._replace(timed=False)


def _wide_k3(res, qs, B, n, R, off) -> Case:
    edm = res(qs, (R, B, n)).transpose(0, 1).contiguous()
    if off:
        edm = _offset_word(edm)
    kb, ka = (res(qs, (R, n)).transpose(0, 1).contiguous()
              for _ in range(2))
    return ks_contract_case(
        f"R={R} {list(edm.shape)} over {qs}"
        f"{', edm one word off' if off else ''}", edm, kb, ka,
        qs)._replace(timed=False)


def _wide_k5(res, src, qs, B, n) -> Case:
    form = "direct" if len(src) in nc.EXT_NTT_DIRECT else "staged"
    x = res(src, (B, n))
    return ext_ntt_case(f"{len(src)} -> {len(qs)} primes {list(x.shape)} "
                        f"({form})", x, src, qs)._replace(timed=False)


def _wide_k6(res, src, qs, B, n) -> Case:
    ls = len(qs) if src is None else len(src)
    form = ("no source basis" if src is None else
            f"{ls} -> {len(qs)} primes ("
            f"{'direct' if ls in nc.MUL4_DIRECT else 'staged'})")
    ops = [res(qs if src is None else src, (B, n)) for _ in range(4)]
    return tensor_mul4_case(f"{form} {[ls, B, n]}, scale", ops, qs,
                            tuple(range(3, 3 + len(qs))), src)._replace(
                                timed=False)


def _wide_ks(res, src, qs, B, n):
    """K7 and K8 on the same R = len(src) limb rows, c_limbs and K8's adds
    strided views ([R, B, 3, n] and [Lp, B, 2, n] rows)."""
    R = len(src)
    c = torch.stack([res((s,), (B, 3, n))[0] for s in src])[..., 2, :]
    kb, ka = (res(qs, (R, n)).transpose(0, 1).contiguous() for _ in range(2))
    pair = res(qs, (B, 2, n))
    label = (f"R={R} {[len(qs), B, n]} over {qs}, reps="
             f"{nc.digit_reps(qs, src)}, strided c_limbs")
    yield ks_fused_case(label, c, kb, ka, qs, src)._replace(timed=False)
    yield ks_fused_eval_case(f"{label} and adds", c, kb, ka, qs, src,
                             (pair[..., 0, :], pair[..., 1, :]))._replace(
                                 timed=False)


def _wide_k12(res, q, B, n, reps, layout=None) -> Case:
    x = res((q,), (B, n))[0]
    layout = alu_bench.ceiling_layout(n.bit_length() - 1, layout)
    return ceiling_case(f"reps={reps} [{B}, {n}] q={q} {layout}", x, q,
                        reps, layout)._replace(timed=False)


def ntt_cases(n: int, k: int, l: int, steps: int, device,
              gen: prng.Gen) -> list:
    """The single-prime transform at the shapes that generating and
    pre-transforming ``steps`` TGGSW keys (ring degree n, K = k, l levels)
    gives it: ``precompute_evals`` under the two 30-bit primes, forward;
    ``TorusRing._contract_crt`` under the two 31-bit primes, forward on both
    operands and inverse on the contracted sums; and ``tn.mul_crt`` of one
    ciphertext's polynomials, forward on the four 16-bit limbs.  Each case
    carries its butterflies."""
    C = k + 1

    def case(label, p, shp, inverse):
        x = prng.uniform_mod(gen, shp + (n,), p, device)
        return ntt_case(f"{label} {list(shp)} n={n} p={p}", x, p, inverse)

    p1, p2 = ntt_mod.CRT_PRIMES_TFHE
    c1, c2 = ntt_mod.CRT_PRIMES[:2]
    return [
        case("evals fwd", p1, (steps, C, l, C, 2), False),
        case("evals fwd", p2, (steps, C, l, C, 2), False),
        case("contract fwd x", c1, (steps, C, l, k, 4), False),
        case("contract fwd y", c2, (k, 4), False),
        case("contract inv", c1, (steps, C, l), True),
        case("contract inv", c2, (steps, C, l), True),
        case("mul_crt fwd", c1, (C, 4), False),
    ]


def blind_rotate_inputs(n: int, k: int, beta: int, l: int, steps: int,
                        batch: int, device, gen: prng.Gen) -> tuple:
    """The arguments of the blind rotation of ``batch`` ciphertexts over
    ``steps`` CMux steps, on random keys, shifts and accumulators (any
    eval-domain residues do: the arithmetic is exact)."""
    C, w = k + 1, beta.bit_length() - 1
    p1, p2 = ntt_mod.CRT_PRIMES_TFHE
    key = (steps, C, l, C, 2, n)
    ev1 = prng.uniform_mod(gen, key, p1, device)
    ev2 = prng.uniform_mod(gen, key, p2, device)
    ev1s, ev2s = (_u32_bits(e * (1 << 32) // p)
                  for e, p in ((ev1, p1), (ev2, p2)))
    shifts = prng.uniform_mod(gen, (steps, batch), 2 * n, device).int()
    acc0 = prng.uniform_u64(gen, (batch, C, n), device)
    return shifts, acc0, ev1.int(), ev1s, ev2.int(), ev2s, n, w


def blind_rotate_bytes(shifts, acc0, ev1, ev1s, ev2, ev2s, n: int,
                       w: int) -> int:
    """The least device-memory bytes of a blind rotation: the key planes,
    the accumulator in and out, the shifts and both primes' root tables,
    each once."""
    return (4 * 4 * ev1.numel() + 2 * 8 * acc0.numel() + 4 * shifts.numel()
            + 4 * 4 * 2 * n)


def blind_rotate_case(n: int, k: int, beta: int, l: int, steps: int,
                      batch: int, device, gen: prng.Gen,
                      layout: str | None = None, args=None) -> Case:
    """The whole-chain blind rotation on blind_rotate_inputs (or ``args``),
    in the layout the plan takes, or in ``layout`` where given."""
    if args is None:
        args = blind_rotate_inputs(n, k, beta, l, steps, batch, device, gen)
    shifts, acc0, ev1 = args[:3]
    layout = layout or brc._plan(k + 1, l, n).layout
    # the plain chain takes seconds at full width: timed once, no warm-up
    return _pair(
        "blind_rotate", f"steps={steps} B={batch} n={n} beta={beta} l={l} "
        f"{layout}", blind_rotate_bytes(*args),
        steps * batch * sum(cmux_step_ops(n, k + 1, l).values()),
        partial(brc.blind_rotate_kernel, layout=layout),
        brc.blind_rotate_plain, *args)._replace(
            kernel_reps=3, plain_reps=1, plain_warmup=0, layout=layout,
            args=args)


BR_SWEEP_C = (2, 3)              # K10's component counts in the sweep,
BR_SWEEP_L = (1, 2, 3)           # its gadget levels,
BR_SWEEP_STEPS = (1, 2, 17)      # chain lengths
BR_SWEEP_B = (1, 3, 64, 67, 133)  # and batches of the cluster layout (67 and
                                 # 133: more clusters than the card holds at
                                 # once); of the device-memory layout,
BR_DM_SWEEP_B = (1, 3, 67)       # 67 left out at 2^14 and 2^15
BR_DM_WIDE_LOGN = 14
# shapes over a block's shared memory at small n: (log n, C, l, w)
BR_DM_SMALL = ((11, 2, 7, 9), (9, 4, 32, 2))


def gate_width(n: int, C: int, l: int) -> int:
    """The widest digit the reference's gate takes at (n, C, l): the
    largest w with C l n 2^w < 2^26 and w l <= 64 (at least 1)."""
    w = 1
    while C * l * n << (w + 1) < 1 << 26 and (w + 1) * l <= 64:
        w += 1
    return w


BR_SPLIT_LOGN = 16    # the split layout at every (C, l, w) of the gate,
BR_QUARTER_LOGN = 17  # the quarter layout at every (C, l, w) of the gate,
BR_GRID_RUNS = ((2, 1), (3, 2), (4, 1), (2, 2))   # (steps, B) in turn,
# and one (log n, C, l) at each larger degree, at the gate's widest digit
BR_GRID_WIDER = ((18, 2, 2), (19, 3, 1), (20, 2, 2), (21, 1, 2), (22, 2, 1))


def gate_shapes(n: int) -> list:
    """Every (C, l, w) that the reference's gate admits at ring degree n
    (C = K + 1 <= 4, digits of w >= 1 bits below both CRT primes, w l <= 64,
    C l n 2^w < 2^26)."""
    top = min(ntt_mod.CRT_PRIMES_TFHE).bit_length() - 1
    return [(C, l, w) for C in range(1, 5) for l in range(1, 65)
            for w in range(1, top + 1)
            if w * l <= 64 and C * l * n << w < 1 << 26]


def blind_rotate_wide_sweep(device, seed: int):
    """K10 past 2^15 against its plain version (compared; chip_smoke.py
    times each kernel beside its bounds): its split layout at every (C, l,
    w) of ``gate_shapes`` at 2^BR_SPLIT_LOGN, its quarter layout at every
    one at 2^BR_QUARTER_LOGN (each named), each over (steps, B) of
    BR_GRID_RUNS in turn, and the layout the plan takes (grid) at each
    (log n, C, l) of BR_GRID_WIDER at the gate's widest digit; at the
    first shape of each (n, C) also the key planes
    one word off their 16-byte alignment.  Key planes drawn on the card
    (``prng.device_residues``: a shape's keys run to gigabytes), shifts
    and accumulators on the host.  Yields one case at a time, then forgets
    the root tables."""
    res = prng.device_residues(seed, device)
    gen = prng.Gen(seed)
    p1, p2 = ntt_mod.CRT_PRIMES_TFHE
    named = {BR_SPLIT_LOGN: _cuda.SPLIT, BR_QUARTER_LOGN: _cuda.QUARTER}
    shapes = ([(logn, *s) for logn in named
               for s in gate_shapes(1 << logn)]
              + [(logn, C, l, gate_width(1 << logn, C, l))
                 for logn, C, l in BR_GRID_WIDER])
    firsts = set()
    for i, (logn, C, l, w) in enumerate(shapes):
        n = 1 << logn
        layout = named.get(logn) or brc._plan(C, l, n).layout
        steps, B = BR_GRID_RUNS[i % len(BR_GRID_RUNS)]
        key = (steps, C, l, C, 2, n)
        ev1, ev2 = res((p1,), key)[0], res((p2,), key)[0]
        ev1s, ev2s = (_u32_bits(e.long() * (1 << 32) // p)
                      for e, p in ((ev1, p1), (ev2, p2)))
        shifts = prng.uniform_mod(gen, (steps, B), 2 * n, device).int()
        acc0 = prng.uniform_u64(gen, (B, C, n), device)
        label = f"C={C} l={l} w={w} steps={steps} B={B} n={n} {layout}"
        ops = steps * B * sum(cmux_step_ops(n, C, l).values())
        variants = [("", (ev1, ev1s, ev2, ev2s))]
        if (logn, C) not in firsts:
            firsts.add((logn, C))
            variants.append((", key planes one word off",
                             [_offset_word(e) for e in (ev1, ev1s, ev2,
                                                        ev2s)]))
        for tag, planes in variants:
            args = (shifts, acc0, *planes, n, w)
            yield _pair("blind_rotate", label + tag,
                        blind_rotate_bytes(*args), ops,
                        partial(brc.blind_rotate_kernel, layout=layout),
                        brc.blind_rotate_plain, *args)._replace(
                            timed=False, layout=layout, args=args)
        del ev1, ev2, ev1s, ev2s, variants, planes, args
    nc.drop_tables()


def blind_rotate_sweep(device, gen: prng.Gen):
    """K10 against its plain version (compared only, not timed) in its
    two layouts up to 2^15 (past it ``blind_rotate_wide_sweep``): for each
    C in BR_SWEEP_C and l in BR_SWEEP_L at every ring degree 2^7 .. 2^15,
    over BR_SWEEP_STEPS steps, on BR_SWEEP_B ciphertexts
    where the plan takes the cluster layout (digits of w = 20, 12 or 21
    bits) and on BR_DM_SWEEP_B (without 67 from 2^BR_DM_WIDE_LOGN) where it
    takes the device-memory layout (the widest digit of the reference's
    gate, ``gate_width``); then the device-memory layout at the small-n
    shapes of BR_DM_SMALL, and one C = 1 shape in each layout; on random
    keys, shifts and accumulators; and, at each shape, the key planes one
    word off their 16-byte alignment (read from device memory word by word,
    not staged).  Yields the cases one at a time, so that only one case's
    tensors live at once."""
    full = [(logn, C, l, None) for C in BR_SWEEP_C for l in BR_SWEEP_L
            for logn in range(_cuda.BLIND_ROTATE.logn[0], nc.CHUNK_LOGN + 1)]
    extra = [*BR_DM_SMALL, (10, 1, 2, None), (15, 1, 2, None)]
    for shape in full + extra:
        logn, C, l, w = shape
        n = 1 << logn
        plan = brc._plan(C, l, n)
        if plan.layout == "cluster":
            w = w or {1: 20, 2: 12, 3: 21}[l]
            batches = BR_SWEEP_B
            kind = "staged" if plan.staged else "direct"
        else:
            w = w or gate_width(n, C, l)
            batches = tuple(B for B in BR_DM_SWEEP_B
                            if B != 67 or logn < BR_DM_WIDE_LOGN)
            kind = "device"
        # the extra shapes: two steps on three ciphertexts
        runs = ([(2, 3)] if shape in extra else
                [(steps, B) for steps in BR_SWEEP_STEPS for B in batches])
        for steps, B in runs:
            (shifts, acc0, ev1, ev1s, ev2, ev2s, _,
             _) = blind_rotate_inputs(n, C - 1, 1 << w, l, steps, B, device,
                                      gen)
            yield (_pair(
                "blind_rotate", f"C={C} l={l} w={w} steps={steps} B={B} "
                f"n={n} {kind}", 0, 0, brc.blind_rotate_kernel,
                brc.blind_rotate_plain, shifts, acc0, ev1, ev1s, ev2, ev2s,
                n, w)._replace(timed=False, layout=plan.layout,
                               args=(shifts, acc0, ev1, ev1s, ev2, ev2s, n,
                                     w)))
            if steps == 2 and B == 3:
                off = [_offset_word(e) for e in (ev1, ev1s, ev2, ev2s)]
                yield (_pair(
                    "blind_rotate", f"C={C} l={l} w={w} steps=2 B=3 n={n} "
                    f"{kind}, key planes one word off", 0, 0,
                    brc.blind_rotate_kernel, brc.blind_rotate_plain,
                    shifts[:, :3].contiguous(), acc0[:3].contiguous(), *off,
                    n, w)._replace(timed=False, layout=plan.layout,
                                   args=(shifts[:, :3], acc0[:3], *off, n,
                                         w)))


def tfhe_cases(n: int, k: int, beta: int, l: int, steps: int, batch: int,
               device, gen: prng.Gen) -> list:
    """One Case per variant of the two TFHE kernels at the shapes a
    bootstrap gives them."""
    return [*ntt_cases(n, k, l, steps, device, gen),
            blind_rotate_case(n, k, beta, l, steps, batch, device, gen)]


# the reference tests' configurations at ring degree 2^7: RNS-BFV at n = 128,
# t = 16, L = 3, M = 4 (tests/test_bfv_rns.py) and TFHE at n = 128, K = 1,
# beta = 256, l = 3 with a short key of 64 (tests/test_bootstrap.py)
SMALL_BFV = dict(n=128, t=16, L=3, M=4)
SMALL_TFHE = dict(n=128, k=1, beta=256, l=3, n_lwe=64)


def small_degree_cases(param, batch: int, tfhe_batch: int, device,
                       gen: prng.Gen, res=None) -> list:
    """Every kernel of the radix chain at n = 2^7 at the shapes that the
    reference tests' small configurations give it: ``cases`` and
    ``linear_cases`` at param (RNS-BFV: K1, K2, K3, K4, K5, K6 and its
    stacked form, K7, K8), ``tfhe_cases`` at SMALL_TFHE over n steps and
    over n_lwe (K9 at the shapes of key generation, K10 on tfhe_batch
    ciphertexts), and the ceiling loop K12 on [batch, n]."""
    n = param.n
    tf = SMALL_TFHE
    return [*cases(param, batch, device, gen, res=res),
            *linear_cases(param, batch, device, gen),
            *tfhe_cases(n, tf["k"], tf["beta"], tf["l"], n, tfhe_batch,
                        device, gen),
            blind_rotate_case(n, tf["k"], tf["beta"], tf["l"], tf["n_lwe"],
                              tfhe_batch, device, gen),
            *(c for c in bench_cases(n, batch, device, gen)
              if c.name == "ntt_smem_ceiling")]


def ckks_cases(param, batch: int, K: int, device,
               gen: prng.Gen) -> list:
    """One Case per kernel variant that ``mul_hybrid``, ``hoist_digits``,
    ``rotate_hybrid`` and ``rotate_hoisted`` launch and the BFV paths do not:
    ``param`` is a ckks_rns.Param (L primes), K the number of auxiliary
    primes."""
    qs, L, n = param.qs, param.L, param.n
    ks = ks_ext_primes(param, K)
    both = qs + ks
    LK, rows, tw = L + K, batch * n, 2 * n

    def res(primes, shape):
        return prng.uniform_mod_multi(gen, shape, primes, device)

    shape = f"B={batch} n={n}"
    ct = [res(qs, (batch, n)) for _ in range(4)]
    d3 = res(qs, (batch, 3, n))                  # the tensor's output
    kb, ka = (torch.stack([res(both, (n,)) for _ in range(L)])
              for _ in range(2))                 # hybrid key [L, L+K, n]
    digits = res(both, (L, batch, n))            # hoist_digits' operand
    edm = torch.stack([res(both, (batch, n)) for _ in range(L)])
    acc = res(both, (batch, n))
    pinv = tuple(pow(math.prod(ks), -1, q) for q in qs)
    reps = nc.digit_reps(both, qs)
    return _with_butterflies([
        _pair("tensor_mul4", f"CKKS: Q basis, no scale {shape}",
              4 * (7 * L * rows + 2 * tw * L),
              _ntt_ops(n, 7 * L * batch)
              + L * rows * (4 * MONT_OPS + ADD_OPS + 3 * SHOUP_OPS),
              nc.tensor_mul4_kernel, nc.tensor_mul4_plain, *ct, qs),
        _pair("ks_fused", f"CKKS: R={L} over QK ({LK} primes), strided d2 "
              f"{shape}", 4 * ((L + 2 * LK) * rows + 2 * L * LK * n
                               + 2 * tw * LK),
              _ks_ops(n, batch, L, LK, reps, False), nc.ks_fused_kernel,
              nc.ks_fused_plain, d3[..., 2, :], kb, ka, both, qs),
        _pair("ntt_multi", f"CKKS: hoisted digits forward QK Montgomery, "
              f"{L} rows {shape}", 4 * (2 * LK * L * rows + tw * LK),
              _ntt_ops(n, LK * L * batch) + LK * L * rows * SHOUP_OPS,
              nc.ntt_multi_kernel, nc.ntt_multi_plain, digits, both,
              fin=tuple((1 << 32) % p for p in both)),
        _pair("ks_contract", f"CKKS: R={L} over QK {shape}",
              4 * ((L + 2) * LK * rows + 2 * L * LK * n + tw * LK),
              _ntt_ops(n, 2 * LK * batch)
              + LK * rows * 2 * (L * (MONT_OPS + ADD_OPS) + SHOUP_OPS),
              nc.ks_contract_kernel, nc.ks_contract_plain, edm, kb, ka, both),
        _pair("base_extend", f"CKKS: K->Q centered (w - ext)*P^-1 {shape}",
              4 * (K + 2 * L) * rows, _ext_ops(rows, K, L, True),
              ext.base_extend_fused_kernel, ext.base_extend_fused_plain,
              acc[L:], ks, qs, centered=True, w=acc[:L], sub_mul=pinv),
    ], n, [b * batch for b in (7 * L, (L + 2) * LK, LK * L, 2 * LK, 0)])


def _ext_sum_pair(x, src: tuple, dst: tuple, centered: bool,
                  label: str) -> list:
    """K11 on the (ys, alpha) of x against its plain version, and against
    the whole conversion (K4) of x: two Cases."""
    ys, alpha = ext.lift_plain(x, src, centered)
    ys, alpha = ys.int(), alpha.int()
    coeffs = alpha.numel()
    ls, ld = len(src), len(dst)
    nbytes = 4 * (ls + 1 + ld) * coeffs
    ops = coeffs * ld * (ls * (SHOUP_OPS + ADD_OPS) + SHOUP_OPS + ADD_OPS)
    tag = "centered" if centered else "unsigned"
    return [
        _pair("base_extend_sum", f"{label} {tag}", nbytes, ops,
              ext.base_extend_sum_kernel, ext.base_extend_sum_plain, ys,
              alpha, src, dst),
        Case("base_extend_sum", f"{label} {tag} == the whole conversion",
             lambda: ext.base_extend_sum_kernel(ys, alpha, src, dst),
             lambda: ext.base_extend_fused_kernel(x, src, dst,
                                                  centered=centered),
             nbytes, ops, timed=False),
    ]


def ext_sum_cases(n: int, batch: int, device, gen: prng.Gen,
                  L: int = 4, M: int = 5, K: int = 2) -> list:
    """The contraction-only base extension at the hoisting shapes (src = the
    K auxiliary primes, dst = Q, [K, batch, n]) and at the BFV shapes (Q ->
    P, [L, batch, 3, n]), unsigned and centered."""
    primes = ntt_primes(L + M, 30, 1 << 16)
    qs, ps = primes[:L], primes[L:]
    ks = ntt_primes(K, 30, 1 << 16, skip=L)
    x_k = prng.uniform_mod_multi(gen, (batch, n), ks, device)
    x_q = prng.uniform_mod_multi(gen, (batch, 3, n), qs, device)
    out = []
    for centered in (False, True):
        out += _ext_sum_pair(x_k, ks, qs, centered,
                             f"K->Q [{K}, {batch}, {n}]")
        out += _ext_sum_pair(x_q, qs, ps, centered,
                             f"Q->P [{L}, {batch}, 3, {n}]")
    return out


def bench_cases(n: int, batch: int, device, gen: prng.Gen,
                reps: int = 2, rounds: int = 64, counts: dict | None = None
                ) -> list:
    """The two measuring loops against their plain versions: the ceiling
    loop on [batch, n] over ``reps`` chains, and every ``alu_rate`` operation
    over ``rounds`` rounds on the reference's [256, 1024] words.  ``counts``
    are the (ALU, FMA, wide) instructions a word and round of each
    operation's loop (those of the build in hand, from
    ``utils/sass_counts.py``; by default the recorded
    ``alu_bench.OP_PIPES``)."""
    counts = alu_bench.OP_PIPES if counts is None else counts
    q = alu_bench.ALU_Q
    x = prng.uniform_mod(gen, (batch, n), q, device).int()
    shape = (256, 1024)
    ax = prng.uniform_mod(gen, shape, q, device)
    ay = prng.uniform_mod(gen, shape, q - 1, device) + 1
    ayp = ay * (1 << 32) // q                    # below 2^32: its u32 bits
    ax, ay, ayp = ax.int(), ay.int(), _u32_bits(ayp)
    words = ax.numel()
    out = [_pair("ntt_smem_ceiling", f"reps={reps} B={batch} n={n}",
                 4 * (2 * batch * n + 2 * n), _ntt_ops(n, batch * reps),
                 alu_bench.ntt_smem_ceiling_kernel,
                 alu_bench.ntt_smem_ceiling_plain, x, q, reps)._replace(
                     butterflies=_butterflies(n, batch * reps), n=n)]
    for op in alu_bench.OPS:
        units = words // 2 if op == "butterfly" else words
        out.append(_pair(
            "alu_rate", f"{op} rounds={rounds} on {list(shape)}",
            4 * 4 * words, units * rounds * Work(*counts[op]),
            alu_bench.alu_rate_kernel, alu_bench.alu_rate_plain, ax, ay, ayp,
            op, rounds)._replace(plain_reps=1, plain_warmup=0))
    return out


# the wrappers ``record_calls`` can wrap: (counter name, module, function),
# the module's ``<function>_kernel`` and ``<function>_plain``
WRAPPERS = (("ntt_multi", nc, "ntt_multi"),
            ("tensor_eval4", nc, "tensor_eval4"),
            ("ks_contract", nc, "ks_contract"),
            ("ext_ntt", nc, "ext_ntt"),
            ("base_extend", ext, "base_extend_fused"),
            ("tensor_mul4", nc, "tensor_mul4"),
            ("tensor_mul", nc, "tensor_mul"),
            ("ks_fused", nc, "ks_fused"),
            ("ks_fused_eval", nc, "ks_fused_eval"),
            ("ntt", nc, "ntt"),
            ("blind_rotate", brc, "blind_rotate"),
            ("base_extend_sum", ext, "base_extend_sum"))


def _sig(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.storage_offset() % 4,
                str(x.dtype))
    if isinstance(x, (tuple, list)):
        return tuple(_sig(v) for v in x)
    return x


@contextlib.contextmanager
def record_calls(store: dict, seen: dict, names: tuple):
    """While active, the first call of each distinct argument signature
    (shapes, strides, word offsets, dtypes and the other arguments) of the
    kernels ``names`` is kept in ``store`` as (name, signature) -> (kernel,
    plain, args, kwargs), the arguments by reference, to be held against
    the plain version afterwards (``hold_recorded``); ``seen`` counts the
    launches each kernel's counter took inside those calls, for the caller
    to hold against the path's counts (a launch that did not go through a
    recorded call would leave its shape unchecked)."""
    wrapped = [w for w in WRAPPERS if w[0] in names]

    def recorder(name, kern, plain):
        def call(*args, **kwargs):
            key = (name, _sig(args), _sig(sorted(kwargs.items())))
            store.setdefault(key, (kern, plain, args, kwargs))
            before = _cuda.launches()[name]
            out = kern(*args, **kwargs)
            seen[name] = (seen.get(name, 0) + _cuda.launches()[name]
                          - before)
            return out
        return call

    saved = [(mod, f"{fn}_kernel", getattr(mod, f"{fn}_kernel"))
             for _, mod, fn in wrapped]
    try:
        for name, mod, fn in wrapped:
            setattr(mod, f"{fn}_kernel",
                    recorder(name, getattr(mod, f"{fn}_kernel"),
                             getattr(mod, f"{fn}_plain")))
        yield store
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def hold_recorded(store: dict) -> dict:
    """Each recorded call's kernel against its plain version on the same
    arguments, bit for bit; raises on the first difference.  Returns
    {kernel name: (signatures held, largest |kernel - plain|)}."""
    held = {}
    for (name, *_), (kern, plain, args, kwargs) in store.items():
        got, want = kern(*args, **kwargs), plain(*args, **kwargs)
        diff = max_abs_err(got, want)
        if not equal(got, want):
            raise RuntimeError(f"{name}: kernel != plain at a recorded "
                               f"signature (max |diff| {diff})")
        n, err = held.get(name, (0, 0))
        held[name] = (n + 1, max(err, diff))
    return held

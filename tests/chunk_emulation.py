"""The chunked schedule of csrc/ntt_chunks.cuh written out in torch, shared
by the tests of the kernels that run it (tests/test_torch_degree16.py: K1,
K9 and K10's grid layout; tests/test_torch_chunked_ops.py: K2, K3, K5 and
K12): the top passes (2^K words a virtual thread, stage bits from log n - 1
down to log c, the roots below 2^s read at word root << log c of the chunk
table), each chunk's chain of c words (tests/test_torch_radix_plan.py::
_emulate) on its row of the chunk table, and the whole transform both
ways."""

import torch

from fhe_study_tpu_torch.ops import ntt_cuda as nc
from test_torch_radix_plan import _emulate

CPU = torch.device("cpu")


def _table(q: int, n: int, logc: int, inverse: bool):
    """The chunk table [2^s, c] of q at n (ntt_cuda._chunk_index)."""
    roots = nc._roots_plain((q,), n, inverse, CPU)[0]
    return roots[torch.from_numpy(nc._chunk_index(n, 1 << logc))]


def _top_pass(x, q: int, logn: int, lo: int, K: int, table, logc: int,
              inverse: bool, fin: int = 1, first=None):
    """One top pass over bits [lo, lo + K) of x [n] (ntt_top_kernel): virtual
    thread v holds the words base + (k << lo), base = v's bits below lo
    and, above lo + K, the others (top_base); ``first`` forms them from
    their element addresses instead (K10's digits)."""
    n = 1 << logn
    v = torch.arange(n >> K)
    base = (v & ((1 << lo) - 1)) | ((v >> lo) << (lo + K))
    el = base[:, None] + (torch.arange(1 << K) << lo)[None]
    assert bool((el[1:, 0] - el[:-1, 0] == 1).reshape(-1)[:31].all())
    regs = (x[el] if first is None else first(el)).clone()
    flat = table.reshape(-1)
    for u in (range(K) if inverse else reversed(range(K))):
        j = lo + u
        k = torch.arange(1 << K)
        klo = k[(k >> u) & 1 == 0]
        khi = klo | (1 << u)
        root = (n >> (j + 1)) + (base[:, None] >> (j + 1)) + \
            (klo >> (u + 1))[None]
        assert torch.equal(root, (n >> (j + 1)) + (el[:, klo] >> (j + 1)))
        assert bool((root < n >> logc).all() and (root >= 1).all())
        w = flat[root << logc]                    # word 0 of row `root`
        a, b = regs[:, klo], regs[:, khi]
        if inverse:
            regs[:, klo], regs[:, khi] = (a + b) % q, (a - b) % q * w % q
        else:
            t = b * w % q
            regs[:, klo], regs[:, khi] = (a + t) % q, (a - t) % q
    out = torch.full((n,), -1, dtype=torch.int64) if x is None else x.clone()
    out[el] = regs * fin % q
    return out


def _chunks(x, q: int, logc: int, inverse: bool, table, fin: int = 1,
            first=None):
    """Each chunk's chain of c words on its row of the table (ntt_rows)."""
    c = 1 << logc
    return torch.cat([
        _emulate(None if x is None else x[r * c:(r + 1) * c], q, logc,
                 inverse, fin, roots=table[r],
                 first=None if first is None else
                 (lambda addr, r=r: first(r, addr)))
        for r in range(table.shape[0])])


def _chunked(x, q: int, logn: int, logc: int, inverse: bool, fin: int = 1,
             first=None):
    """ntt_chunked on one polynomial x [n]: forward, the top passes then
    the chunk chains with fin; inverse, the chunk chains then the top
    passes in the other order, the last with fin.  ``first``, where given,
    forms the words of the first pass instead of reading x (None): the
    forward's first top pass from their element addresses (K5's
    extension), the inverse's chunk chains from (chunk, addresses in the
    chunk) (K2's products, K3's contraction)."""
    plan = nc._chunk_plan(logn, logc)
    table = _table(q, 1 << logn, logc, inverse)
    if not inverse:
        for t, (lo, K) in enumerate(plan.top):
            x = _top_pass(x, q, logn, lo, K, table, logc, False,
                          first=first if t == 0 else None)
        return _chunks(x, q, logc, False, table, fin)
    y = _chunks(x, q, logc, True, table, first=first)
    for i, (lo, K) in enumerate(reversed(plan.top)):
        last = i == len(plan.top) - 1
        y = _top_pass(y, q, logn, lo, K, table, logc, True,
                      fin if last else 1)
    return y

"""Multi-rank execution: mesh factoring and the full sharded ct-mul step —
the counterpart of fhe_study_tpu/parallel/pipeline.py.

Parallelism axes, as the reference's:
  dp — ciphertext batch (pure data parallel)
  ep — CRT/RNS prime axis (limb parallel; all_gather)
  sp — polynomial coefficient axis (four-step NTT; all_to_all)
  tp — key-switch gadget axis k_src (partial gadget products; psum)

Pipeline parallelism (pp) is not used, as in the reference: the FHE op
graph is a short chain of large data-parallel ops with no weight-stationary
stages.

Each function takes global tensors (the same on every rank) and returns the
global result; inside, a rank works on its slab of each sharded operand
(``mesh.shard``) and calls the collectives of parallel/comm.py itself.
Where the reference leans on GSPMD to run an unpartitioned op on sharded
operands, the port does explicitly what XLA must do around an op that
needs the whole operand:

  * ``R.mul`` with the limbs on ep (``rns_mul_ep_dp``): the rank's limb
    slab is all_gathered over ep, ``bfv_rns.mul`` runs on the rank's batch
    shard, and the rank keeps its own limbs of the product;
  * the TFHE bootstrapping key's rows on tp (``dryrun_bootstrap``) and the
    CKKS Galois key's rows on tp (``dryrun_ckks``): the rows are
    all_gathered over tp, then the op runs on the rank's batch shard.

There is no limb-parallel multiply: the reference has none either.  The
``dryrun*`` functions are the rank programs of ``entry.dryrun_multichip``
(parallel/launch.py runs them in every rank); each returns a report and
raises on any mismatch.
"""

import functools
import hashlib
import time

import numpy as np
import torch

from ..arith import rn, rq
from ..arith.params import TORUS_Q, RingParam
from ..arith.ring import ring_for
from ..models import bfv
from ..models.gfhe import glwe as G
from ..ops import _cuda, modops, ntt
from ..utils import kernel_check, prng
from . import comm, distributed, mesh as mesh_mod, ntt_sharded

AXES = ("dp", "ep", "sp", "tp")


def factor_sizes(n_devices: int) -> dict:
    """Factor n_devices into {dp, ep, sp, tp}: powers of two feed the ep, sp
    and tp axes first (they need >= 2 to exercise collectives), the rest
    goes to dp."""
    sizes = {"dp": 1, "ep": 1, "sp": 1, "tp": 1}
    rem = n_devices
    for axis in ("ep", "sp", "tp"):
        if rem % 2 == 0 and rem >= 2:
            sizes[axis] = 2
            rem //= 2
    sizes["dp"] = rem
    return sizes


def factor_grid(n_devices: int) -> np.ndarray:
    """The (dp, ep, sp, tp) grid of ranks of ``factor_mesh``."""
    return np.arange(n_devices).reshape(
        tuple(factor_sizes(n_devices)[a] for a in AXES))


def factor_mesh(n_devices: int | None = None):
    """The (dp, ep, sp, tp) DeviceMesh of ``factor_sizes`` over the world."""
    import torch.distributed as dist
    return mesh_mod.from_grid(factor_grid(n_devices or dist.get_world_size()),
                              AXES)


def _regather(x, mesh, axis: str, dim: int):
    """The rank's slab of the global x along ``dim``, all_gathered over
    ``axis``: what XLA inserts before an op that needs the whole operand."""
    return mesh_mod.unshard(mesh_mod.shard(x, mesh, axis, dim), mesh, axis,
                            dim)


# -- ep: CRT prime pair sharded over ranks -----------------------------------

def polymul_i64_crt_ep(a, b, mesh):
    """Exact signed negacyclic product; the two CRT primes run on separate
    ``ep`` ranks (coordinate 0 the first, the others the second), and the
    reconstruction all_gathers the residues."""
    p1, p2 = ntt.CRT_PRIMES[:2]
    if comm.axis_size(mesh, "ep") == 1:
        return ntt.polymul_i64_crt(a, b)
    p = (p1, p2)[min(comm.axis_index(mesh, "ep"), 1)]
    mine = ntt.negacyclic_mul(modops.coerce_i64(a, p),
                              modops.coerce_i64(b, p), p)
    both = comm.all_gather(mine.unsqueeze(0), mesh, "ep", 0)   # [ep, ..., n]
    return ntt.crt_lift_centered(both[0], both[1], p1, p2)


# -- tp: key-switch gadget contraction with psum -----------------------------

def key_switch_tp(param: G.Param, beta: int, l: int, ksk: G.KSK, ct: G.GLWE,
                  mesh) -> G.GLWE:
    """GLWE key switch with the k_src gadget axis sharded over ``tp``: each
    rank contracts its slab of the KSK, the partial GLWEs psum over tp (raw
    u64 sums of partials reduced mod q), then one reduction mod q."""
    ring = ring_for(param.ring)
    k, n = param.k, param.ring.n
    d = ring.decompose(ct.a, beta, l).movedim(0, -2)   # [..., k_src, l, n]
    batch = tuple(ct.b.shape[:-1])
    d_loc = mesh_mod.shard(d, mesh, "tp", -3)
    kb_loc = mesh_mod.shard(ksk.b, mesh, "tp", -3)     # [.., k_src, l, n]
    ka_loc = mesh_mod.shard(ksk.a, mesh, "tp", -4)     # [.., k_src, l, k, n]
    M = d_loc.shape[-3] * l
    d_flat = d_loc.reshape(batch + (M, n))
    rhs_b = ring.contract(kb_loc.reshape(kb_loc.shape[:-3] + (M, n)), d_flat)
    ka = ka_loc.reshape(ka_loc.shape[:-4] + (M, k, n)).movedim(-2, 0)
    extra = d_flat.ndim - (ka.ndim - 1)               # ct dims not in ksk
    if extra > 0:
        ka = ka.reshape(ka.shape[:1] + (1,) * extra + ka.shape[1:])
    rhs_a = ring.contract(ka, d_flat).movedim(0, -2)   # [..., k, n]
    rhs_a = modops.coerce_u64(comm.psum(rhs_a, mesh, "tp"), param.ring.q)
    rhs_b = modops.coerce_u64(comm.psum(rhs_b, mesh, "tp"), param.ring.q)
    zero_a = ring.zeros(batch + (k,), ct.b.device)
    return G.GLWE(a=ring.sub(zero_a, rhs_a), b=ring.sub(ct.b, rhs_b))


# -- the full multi-rank step ------------------------------------------------

def ct_mul_step(mesh, param: bfv.Param, ks_param: G.Param, beta: int, l: int,
                c1, c2, rlk, ksk, glwe_ct):
    """One step across the mesh:
       dp: batched BFV ct x ct multiply + relinearization (fast path), the
           batch (and the batched relin key) cut over dp;
       ep: one CRT-pair product of the first ciphertext row on two ranks;
       sp: one four-step-sharded polynomial product;
       tp: a GLWE key switch with psum'd gadget partials."""
    q = param.ring.q

    def dp(x):
        return mesh_mod.shard(x, mesh, "dp", 0)

    out = bfv.mul(param, bfv.RLK(*map(dp, rlk)), bfv.RLWE(*map(dp, c1)),
                  bfv.RLWE(*map(dp, c2)), fast=True)
    out = bfv.RLWE(*(mesh_mod.unshard(x, mesh, "dp", 0) for x in out))
    ep_prod = polymul_i64_crt_ep(c1[0].long()[0], c2[0].long()[0], mesh)
    sp_prod = ntt_sharded.negacyclic_mul_sharded(c1[0][0], c2[0][0], q, mesh,
                                                 axis="sp")
    ks_out = key_switch_tp(ks_param, beta, l, ksk, glwe_ct, mesh)
    return out, ep_prod, sp_prod, ks_out


def multichip_ct_mul_step(mesh, param: bfv.Param, ks_param: G.Param,
                          beta: int, l: int):
    """The step as a function of (c1, c2, rlk, ksk, glwe_ct), as the
    reference returns its jitted step."""
    return functools.partial(ct_mul_step, mesh, param, ks_param, beta, l)


def rns_mul_ep_dp(param, key, x, y, mesh):
    """``bfv_rns.mul`` of global [L, B, n] ciphertexts held with the limbs
    on ep and the batch on dp: the limb slabs all_gathered over ep, the
    product of the rank's batch shard, the rank's own limbs kept; returns
    the global product."""
    from ..models import bfv_rns as R

    def held(v):
        return mesh_mod.shard(mesh_mod.shard(v, mesh, "ep", 0), mesh, "dp", 1)

    def limbs(v):
        return mesh_mod.unshard(held(v), mesh, "ep", 0)

    out = R.mul(param, key, R.CT(*map(limbs, x)), R.CT(*map(limbs, y)))
    mine = [mesh_mod.shard(o, mesh, "ep", 0) for o in out]
    return R.CT(*(mesh_mod.unshard(mesh_mod.unshard(o, mesh, "ep", 0), mesh,
                                   "dp", 1) for o in mine))


def mul_e_ep_dp(param, key, x, y, mesh):
    """``bfv_rns.mul_e`` of global eval-domain ciphertexts held with the Q
    limbs on ep and the batch on dp, as ``rns_mul_ep_dp``; the P limbs stay
    whole on each ep rank (their count, L + 1 in the repo's
    configurations, does not divide over ep = 2)."""
    from ..models import bfv_rns as R

    def dp(v):
        return mesh_mod.shard(v, mesh, "dp", 1)

    def limbs(v):
        return mesh_mod.unshard(mesh_mod.shard(dp(v), mesh, "ep", 0), mesh,
                                "ep", 0)

    def cte(c):
        return R.CTE(limbs(c.e0q), limbs(c.e1q), dp(c.e0p), dp(c.e1p))

    out = R.mul_e(param, key, cte(x), cte(y))
    q_mine = [mesh_mod.shard(o, mesh, "ep", 0) for o in (out.e0q, out.e1q)]
    q_all = [mesh_mod.unshard(o, mesh, "ep", 0) for o in q_mine]
    return R.CTE(*(mesh_mod.unshard(o, mesh, "dp", 1)
                   for o in (*q_all, out.e0p, out.e1p)))


# -- the rank programs -------------------------------------------------------

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device) -> dict:
    """One call of fn: its ms (CUDA events on the card; the host clock,
    after the work is done, on the CPU) and the bytes it staged through
    the host (parallel/comm.py)."""
    _sync(device)
    comm.reset_staged()
    if torch.device(device).type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize(device)
        ms = e0.elapsed_time(e1)
    else:
        t0 = time.perf_counter()
        fn()
        ms = (time.perf_counter() - t0) * 1e3
    return {"ms": ms, "staged_bytes": comm.staged_bytes()}


def _equal(a, b, what: str) -> None:
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise RuntimeError(f"{what}: the sharded result != the unsharded "
                           "call")


def _mod_t_product(m1, m2, t: int):
    """m1 * m2 mod (X^n + 1, t), exactly by the CRT product."""
    return modops.coerce_i64(ntt.polymul_i64_crt(m1.long(), m2.long()), t)


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (a result compared across
    processes without moving it)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dryrun_rns(mesh, device, n: int = 4096) -> dict:
    """RNS-BFV ct-mul (the gadget relin key) at N=2^12 with the limb axis
    sharded over ``ep`` and the batch over ``dp``, bit-equal to the
    unsharded multiply and decrypt-verified."""
    from ..models import bfv_rns as R
    param = R.RnsParam(n=n, t=16, L=4, M=5)
    B = max(comm.axis_size(mesh, "dp"), 2)
    ks = prng.split(prng.Gen(1), 6)
    sk, pk = R.new_key(ks[0], param, device)
    rlk = R.rlk_key(ks[1], param, sk)
    m1 = prng.uniform_mod(ks[2], (B, n), param.t, device)
    m2 = prng.uniform_mod(ks[3], (B, n), param.t, device)
    c1 = R.encrypt(ks[4], param, pk, m1, batch=(B,))
    c2 = R.encrypt(ks[5], param, pk, m2, batch=(B,))
    out = rns_mul_ep_dp(param, rlk, c1, c2, mesh)
    timed = _timed(lambda: rns_mul_ep_dp(param, rlk, c1, c2, mesh), device)
    _equal(out, R.mul(param, rlk, c1, c2), "RNS ct-mul (ep x dp)")
    if not torch.equal(R.decrypt(param, sk, out),
                       _mod_t_product(m1, m2, param.t)):
        raise RuntimeError("RNS limb-sharded ct-mul decrypts wrong")
    return {f"RNS ct-mul (ep x dp, n={n})": timed}


def dryrun_hybrid(n_devices: int, device) -> dict:
    """The multi-host layout in one host: a 2-level (host x local) mesh
    with the host factor feeding dp, running (a) the RNS ct-mul with
    ep-sharded limbs at N=2^12 and (b) the four-step sp-sharded product at
    N=2^12, both bit-equal to the unsharded calls."""
    from ..ops.primes import ntt_primes
    if n_devices % 4 or n_devices < 4:
        return {}  # hybrid factorizations need a multiple of 4 ranks
    mesh_ep = distributed.hybrid_mesh(ici={"ep": 2}, simulate_hosts=2)
    report = {f"hybrid {mesh_mod.axis_sizes(mesh_ep)} {k}": v
              for k, v in dryrun_rns(mesh_ep, device).items()}
    mesh_sp = distributed.hybrid_mesh(ici={"sp": 2}, simulate_hosts=2)
    q = ntt_primes(1, 30, 1 << 12)[0]
    n = 4096
    a = prng.uniform_mod(prng.Gen(2), (n,), q, device)
    b = prng.uniform_mod(prng.Gen(3), (n,), q, device)
    got = ntt_sharded.negacyclic_mul_sharded(a, b, q, mesh_sp, axis="sp")
    if not torch.equal(got, rq.mul(a, b, q)):
        raise RuntimeError("hybrid-mesh four-step NTT mismatch")
    report[f"hybrid {mesh_mod.axis_sizes(mesh_sp)} four-step n={n}"] = \
        _timed(lambda: ntt_sharded.negacyclic_mul_sharded(a, b, q, mesh_sp,
                                                          axis="sp"), device)
    return report


def dryrun_bootstrap(mesh, device) -> dict:
    """TFHE blind rotation under the mesh at the production ring (N=1024,
    k=1): the ciphertext batch cut over dp, the bootstrapping key's
    TGGSW row axis over tp (all_gathered before the chain); a short chain
    (n_lwe=32), bit-equal to the unsharded chain and decrypt-exact."""
    from ..models.gfhe.glwe import ERR_SIGMA, Param as TParam
    from ..models.tfhe import bootstrap, tglwe, tlwe
    n, t, n_lwe = 1024, 8, 32
    kw = dict(beta=4096, l=2, beta_ks=16, l_ks=8)
    param = TParam(ERR_SIGMA, RingParam(TORUS_Q, n), 1, t)
    B = max(comm.axis_size(mesh, "dp") * 2, 2)
    ks = prng.split(prng.Gen(11), 3)
    table = bootstrap.compute_lookup_table_standard(param, device)
    s, _ = tglwe.new_key(ks[0], param, device)
    s_flat = tglwe.sk_to_tlwe(s)
    sbtk = bootstrap.new_short_bootstrapping_key(ks[1], param, s,
                                                 n_lwe=n_lwe, **kw)
    gev = bootstrap.precompute_short_btk_evals(param, sbtk)
    m = torch.arange(B, device=device) % (t // 2)
    c = tlwe.encrypt_uniform(ks[2], param.lwe(), s_flat,
                             tlwe.encode(param, m), batch=(B,))

    def f(ct, ev):
        return bootstrap.bootstrap_short(param, sbtk, table, ct,
                                         btk_evals=ev, fused=False, **kw)

    want = f(c, gev)
    ev = type(gev)(*(_regather(x, mesh, "tp", 1) for x in gev))
    mine = f(tlwe.TLWE(*(mesh_mod.shard(x, mesh, "dp", 0) for x in c)), ev)
    got = tlwe.TLWE(*(mesh_mod.unshard(x, mesh, "dp", 0) for x in mine))
    _equal(got, want, "dp x tp blind rotation")
    rec = tlwe.decode(param, tlwe.decrypt(param.lwe(), s_flat, got))
    if not torch.equal(rec, m):
        raise RuntimeError("sharded bootstrap decrypts wrong")
    return {f"TFHE bootstrap_short (dp batch x tp BSK rows, N={n}, "
            f"n_lwe={n_lwe})": "bit-equal + decrypt ok"}


def dryrun_ckks(mesh, device, n: int = 4096) -> dict:
    """CKKS Galois rotation (hybrid key switch) + multiply and rescale at
    N=2^12: the batch cut over dp, the hybrid Galois key's row axis over tp
    (all_gathered before the switch); bit-equal to the unsharded call and
    decode-accurate."""
    from ..models import galois, hybrid_ks
    from ..models.ckks import ckks_rns as C
    # L=4: the hybrid key's row axis (= L) must divide over tp
    param = C.Param(n=n, L=4, delta=2.0 ** 28)
    B = max(comm.axis_size(mesh, "dp"), 2)
    ks = prng.split(prng.Gen(12), 4)
    sk, pk = C.new_key(ks[0], param, device)
    g = galois.rotation_element(n, 1)        # rotate slots by one
    hgk = hybrid_ks.galois_key_hybrid(ks[1], param, sk, g)
    hrlk = C.hybrid_rlk(ks[3], param, sk)    # replicated (1-row relin key)
    z = np.random.default_rng(5).uniform(-1, 1, (B, n // 2))
    zt = torch.from_numpy(z).to(device)
    ct = C.encrypt(ks[2], param, pk, C.encode(param, zt, torch.zeros_like(zt)),
                   batch=(B,))

    def f(c, key):
        rot = hybrid_ks.rotate_hybrid(param, key, c, g)
        return C.mul_hybrid(param, hrlk, rot, rot)[0]

    want = f(ct, hgk)
    key = hybrid_ks.HybridKSK(*(_regather(x, mesh, "tp", 0) for x in hgk))
    mine = f(C.CT(*(mesh_mod.shard(x, mesh, "dp", 1) for x in ct)), key)
    got = C.CT(*(mesh_mod.unshard(x, mesh, "dp", 1) for x in mine))
    _equal(got, want, "dp x tp CKKS rotate+mul+rescale")
    # mul_hybrid rescales: L-1 limbs at delta^2 / q_top
    p1 = C.Param(n=n, L=param.L - 1,
                 delta=param.delta ** 2 / param.qs[param.L - 1])
    rr, _ = C.decode(p1, C.decrypt_to_coeffs(p1, sk, got))
    perm, _ = galois.ckks_slot_perm(n, g)
    want_slots = z[:, np.asarray(perm)] ** 2   # real inputs: conj no-op
    err = float(np.abs(rr.cpu().numpy() - want_slots).max())
    if not err <= 1e-2:
        raise RuntimeError(f"sharded CKKS rotate+mul+rescale decodes wrong "
                           f"(max error {err})")
    return {f"CKKS rotate+mul+rescale (dp batch x tp key rows, n={n}) "
            "max slot error": err}


def dryrun_step(n_devices: int, device) -> dict:
    """ONE full multi-rank step on small shapes (q = 65537, n = 64), with
    real dp/ep/sp/tp slabs, on the factor_mesh of n_devices ranks."""
    mesh = factor_mesh(n_devices)
    q, n = 2 ** 16 + 1, 64
    param = bfv.Param(RingParam(q, n), 2, q * q)
    ks_param = G.Param(G.ERR_SIGMA, RingParam(q, n), 4, 2)
    beta, l = 2, 8
    B = max(comm.axis_size(mesh, "dp") * 2, 2)

    ks = prng.split(prng.Gen(0), 8)
    sk, pk = bfv.new_key(ks[0], param, device, batch=(B,))
    rlk = bfv.rlk_key(ks[1], param, sk, batch=(B,))
    m = prng.uniform_mod(ks[2], (B, n), param.t, device)
    c1 = bfv.encrypt(ks[3], param, pk, m, batch=(B,))
    c2 = bfv.encrypt(ks[4], param, pk, m, batch=(B,))
    gsk, _ = G.new_key(ks[5], ks_param, device)
    gsk2, _ = G.new_key(ks[6], ks_param, device)
    ksk = G.new_ksk(ks[7], ks_param, beta, l, gsk, gsk2)
    gct = G.encrypt_s(ks[5], ks_param, gsk,
                      G.encode(ks_param, m[0] % ks_param.t))

    step = multichip_ct_mul_step(mesh, param, ks_param, beta, l)
    out, ep_prod, sp_prod, ks_out = step(tuple(c1), tuple(c2), rlk, ksk, gct)
    report = {f"mesh {mesh_mod.axis_sizes(mesh)} full step (dp+ep+sp+tp)":
              _timed(lambda: step(tuple(c1), tuple(c2), rlk, ksk, gct),
                     device)}
    rec = bfv.decrypt(param, sk, out)
    if not torch.equal(rec, rn.to_rq(rn.naive_poly_mul(m, m), param.t, n)):
        raise RuntimeError("multichip BFV ct-mul decrypts wrong")
    _equal(out, bfv.mul(param, rlk, c1, c2, fast=True), "dp BFV ct-mul")
    if not torch.equal(sp_prod, rq.mul(c1[0][0], c2[0][0], q)):
        raise RuntimeError("sp-sharded NTT mismatch")
    if not torch.equal(ep_prod, ntt.polymul_i64_crt(c1[0].long()[0],
                                                    c2[0].long()[0])):
        raise RuntimeError("ep-sharded CRT mismatch")
    _equal(ks_out, G.key_switch(ks_param, beta, l, ksk, gct),
           "tp GLWE key switch")
    return report, mesh


def dryrun_full_width(n_devices: int, device, n: int, L: int, M: int,
                      t: int, B: int, seed: int) -> dict:
    """The paths at full width: the eval-resident RNS-BFV multiply (mul_e,
    the 1-row hybrid relin key) at (n, L, M, t, B) with the batch on dp and
    the Q limbs on ep (2 when n_devices is even), its keys and ciphertexts
    drawn from ``seed`` in the order a single-rank caller draws them (so
    its ``digest`` equals that caller's); TFHE ``bootstrap`` at N=1024,
    B=64 (the whole chain, K10 on the card) with the batch on dp; and
    ``polymul_i64_crt_ep`` at the graft entry's [4, 1024] operands."""
    from .. import entry
    from ..models import bfv_rns as R
    from ..models.gfhe.glwe import ERR_SIGMA, Param as TParam
    from ..models.tfhe import bootstrap, tglwe, tlwe
    report = {}
    mesh = distributed.hybrid_mesh(ici={"ep": 2 if n_devices % 2 == 0
                                        else 1})
    param = R.RnsParam(n=n, t=t, L=L, M=M)
    gen = prng.Gen(seed)
    sk, pk = R.new_key(gen, param, device)
    hk = R.hybrid_rlk1(gen, param, sk)
    m = [prng.uniform_mod(gen, (B, n), t, device) for _ in range(2)]
    c = [R.encrypt(gen, param, pk, x, batch=(B,)) for x in m]
    e = [R.to_evals(param, x) for x in c]
    ce = mul_e_ep_dp(param, hk, *e, mesh)
    label = (f"mul_e HRLK (dp x ep {mesh_mod.axis_sizes(mesh)}, n={n}, "
             f"L={L}, M={M}, t={t}, B={B})")
    report[label] = _timed(lambda: mul_e_ep_dp(param, hk, *e, mesh), device)
    report[label]["digest"] = digest(ce)
    rows = R.CT(*(mesh_mod.shard(x, mesh, "dp", 1)
                  for x in R.from_evals(param, ce)))
    mine = [mesh_mod.shard(x, mesh, "dp", 0) for x in m]
    if not torch.equal(R.decrypt(param, sk, rows),
                       _mod_t_product(*mine, t)):
        raise RuntimeError("full-width mul_e decrypts wrong in this rank's "
                           "rows")

    # TFHE: the bench's configuration, the batch over every rank
    tparam = TParam(ERR_SIGMA, RingParam(TORUS_Q, 1024), 1, 8)
    kw = dict(beta=4096, l=2, beta_ks=16, l_ks=8)
    tb = 64
    tgen = prng.Gen(seed + 1)
    s, _ = tglwe.new_key(tgen, tparam, device)
    s_flat = tglwe.sk_to_tlwe(s)
    btk, s_out = bootstrap.new_bootstrapping_key(tgen, tparam, s,
                                                 s_lwe_out=s_flat, **kw)
    evals = bootstrap.precompute_btk_evals(tparam, btk)
    table = bootstrap.compute_lookup_table_standard(tparam, device)
    msg = torch.arange(tb, device=device) % (tparam.t // 2)
    ct = tlwe.encrypt_uniform(tgen, tparam.lwe(), s_flat,
                              tlwe.encode(tparam, msg), batch=(tb,))
    dmesh = mesh_mod.make_mesh(dp=n_devices)

    def boot(x):
        return bootstrap.bootstrap(tparam, btk, table, x, btk_evals=evals, **kw)

    def sharded():
        part = boot(tlwe.TLWE(*(mesh_mod.shard(x, dmesh, "dp", 0)
                                for x in ct)))
        return tlwe.TLWE(*(mesh_mod.unshard(x, dmesh, "dp", 0)
                           for x in part))

    got = sharded()
    label = f"TFHE bootstrap (dp {n_devices}, N=1024, B={tb})"
    report[label] = _timed(sharded, device)
    _equal(got, boot(ct), label)
    if not torch.equal(tlwe.decode(tparam, tlwe.decrypt(tparam.lwe(), s_out, got)),
                       msg):
        raise RuntimeError(f"{label} decrypts wrong")

    # ep: the graft entry's CRT products on two ranks
    es = entry.setup(device)
    a = rq.to_centered_i64(es.c1.c0, entry.Q)
    b = rq.to_centered_i64(es.c2.c0, entry.Q)
    fmesh = factor_mesh(n_devices)
    got = polymul_i64_crt_ep(a, b, fmesh)
    label = (f"polymul_i64_crt_ep (ep {comm.axis_size(fmesh, 'ep')}, "
             f"{list(a.shape)})")
    report[label] = _timed(lambda: polymul_i64_crt_ep(a, b, fmesh), device)
    if not torch.equal(got, ntt.polymul_i64_crt(a, b)):
        raise RuntimeError(f"{label}: != the unsharded product")
    return report


def dryrun(n_devices: int, device="cuda", full_width: tuple | None = None
           ) -> dict:
    """The rank program of ``entry.dryrun_multichip``: the step of
    ``dryrun_step``, then the 2-level (host x local) layout at N=2^12, the
    TFHE / CKKS bootstrap-pipeline stages (dp x tp) at N=1024 and N=2^12,
    and, given ``full_width`` = (n, L, M, t, B, seed), the paths of
    ``dryrun_full_width``.  Every sharded result is held bit for bit
    against the unsharded call and decrypt-verified.  On the card every
    kernel launch is recorded, and each distinct argument signature is held
    against the kernel's plain version after the run.  Returns {"programs":
    {what: {"ms", "staged_bytes"} or outcome}, "launches": {kernel: count}
    (this rank's, before the holding), "held": {kernel: (signatures,
    largest |diff|)}}."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    store, seen = {}, {}
    names = tuple(w[0] for w in kernel_check.WRAPPERS) if on_card else ()
    _cuda.reset_launches()
    with kernel_check.record_calls(store, seen, names):
        report, mesh = dryrun_step(n_devices, device)
        report.update(dryrun_hybrid(n_devices, device))
        report.update(dryrun_bootstrap(mesh, device))
        report.update(dryrun_ckks(mesh, device))
        if full_width is not None:
            report.update(dryrun_full_width(n_devices, device, *full_width))
    _sync(device)
    launches = {k: v for k, v in _cuda.launches().items() if v}
    unseen = {k: v - seen.get(k, 0) for k, v in launches.items()
              if v != seen.get(k, 0)}
    if unseen:
        raise RuntimeError(f"launches that went round the recorder: {unseen}")
    return {"programs": report, "launches": launches,
            "held": kernel_check.hold_recorded(store)}

"""A two-process run of the parallel layer, torchrun style — the
counterpart of scripts/distributed_worker.py.

    torchrun --nproc-per-node=2 -m fhe_study_tpu_torch.utils.distributed_worker
    # or by hand, per process i in 0, 1: MASTER_ADDR=127.0.0.1
    # MASTER_PORT=<port> WORLD_SIZE=2 RANK=i LOCAL_RANK=i python3 -m ...

Options: ``--device cpu`` (default ``cuda``: one card a process, NCCL),
``--backend gloo``.  Each process prints ``DIST2PROC OK p<rank>`` and
``DIST2PROC EP OK p<rank>``, and exits non-zero on any mismatch.

What it shows:
  * ``distributed.initialize()`` brings the process group up from the
    environment (two processes);
  * ``hybrid_mesh`` builds the (dp, ep, sp, tp) mesh over ranks owned by
    the two processes, dp spanning them (n = 256, t = 16, L = 3, M = 4,
    B = 8, the 1-row hybrid relin key): each process multiplies its batch
    rows and decrypt-verifies them;
  * one replicated all-reduce crosses the processes (a psum of each
    process's sum of its rows, against the sum of all rows);
  * with ``dcn_axis="ep"`` (two hosts, so the limb axis crosses the
    processes) at L = 4, M = 5, B = 4, the RNS ct-mul's limb all_gather
    crosses the processes; the gathered product decrypts.

Both processes draw the same keys and messages from one seed.
"""

import argparse

import torch

from ..arith import rn
from ..models import bfv_rns as R
from ..parallel import comm, distributed, mesh as mesh_mod, pipeline
from . import prng


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    opts = ap.parse_args(argv)
    if not distributed.initialize(opts.device, opts.backend):
        raise SystemExit("no process group: set MASTER_ADDR, MASTER_PORT, "
                         "WORLD_SIZE, RANK and LOCAL_RANK (torchrun does)")
    import torch.distributed as dist
    try:
        run(distributed.rank_device(opts.device), dist.get_rank(),
            dist.get_world_size())
    finally:
        dist.destroy_process_group()


def run(dev, pid: int, world: int) -> None:
    if world != 2:
        raise SystemExit(f"the worker runs in 2 processes, not {world}")
    mesh = distributed.hybrid_mesh(ici={"ep": 1})
    if mesh_mod.axis_sizes(mesh) != {"dp": 2, "ep": 1, "sp": 1, "tp": 1}:
        raise RuntimeError(f"mesh {mesh_mod.axis_sizes(mesh)}")

    param = R.RnsParam(n=256, t=16, L=3, M=4)
    B = 8
    ks = prng.split(prng.Gen(0), 6)
    sk, pk = R.new_key(ks[0], param, dev)
    hk = R.hybrid_rlk1(ks[1], param, sk)
    m1 = prng.uniform_mod(ks[2], (B, param.n), param.t, dev)
    m2 = prng.uniform_mod(ks[3], (B, param.n), param.t, dev)
    c1 = R.encrypt(ks[4], param, pk, m1, batch=(B,))
    c2 = R.encrypt(ks[5], param, pk, m2, batch=(B,))

    # dp: this process's batch rows, multiplied and decrypted here
    def rows(v):
        return mesh_mod.shard(v, mesh, "dp", 1)              # [L, B/2, n]

    out = R.mul(param, hk, R.CT(*map(rows, c1)), R.CT(*map(rows, c2)))
    want = rn.to_rq(rn.naive_poly_mul(m1, m2), param.t, param.n)
    mine = mesh_mod.shard(want, mesh, "dp", 0)
    if not torch.equal(R.decrypt(param, sk, out), mine):
        raise RuntimeError(f"process {pid}: its rows decrypt wrong")

    # a reduction that crosses the processes: each sums its rows
    tot = comm.psum(rows(c1.c0).long().sum().reshape(1), mesh, "dp")
    if int(tot) != int(c1.c0.long().sum()):
        raise RuntimeError(f"process {pid}: psum {int(tot)} != the sum of "
                           "all rows")
    print(f"DIST2PROC OK p{pid}", flush=True)

    # ep spanning the two processes: the limb all_gather crosses them
    mesh2 = distributed.hybrid_mesh(ici={"ep": 1}, dcn_axis="ep",
                                    simulate_hosts=2)
    if mesh_mod.axis_sizes(mesh2) != {"dp": 1, "ep": 2, "sp": 1, "tp": 1}:
        raise RuntimeError(f"mesh {mesh_mod.axis_sizes(mesh2)}")
    if comm.axis_ranks(mesh2, "ep") != [0, 1]:
        raise RuntimeError("the ep axis does not span the two processes")
    B2 = 4
    param4 = R.RnsParam(n=256, t=16, L=4, M=5)
    sk4, pk4 = R.new_key(ks[0], param4, dev)
    hk4 = R.hybrid_rlk1(ks[1], param4, sk4)
    c1f = R.encrypt(ks[4], param4, pk4, m1[:B2], batch=(B2,))
    c2f = R.encrypt(ks[5], param4, pk4, m2[:B2], batch=(B2,))
    out2 = pipeline.rns_mul_ep_dp(param4, hk4, c1f, c2f, mesh2)
    want2 = rn.to_rq(rn.naive_poly_mul(m1[:B2], m2[:B2]), param4.t, param4.n)
    if not torch.equal(R.decrypt(param4, sk4, out2), want2):
        raise RuntimeError(f"process {pid}: the ep-spanning ct-mul decrypts "
                           "wrong")
    print(f"DIST2PROC EP OK p{pid}", flush=True)


if __name__ == "__main__":
    main()

"""Multi-process execution: the torch.distributed runtime and 2-level
(host x local) meshes — the counterpart of
fhe_study_tpu/parallel/distributed.py.

The design scales in two tiers, as the reference's:

  * local — GPUs within one host: the ep/sp/tp axes; their collectives
    (all_gather / all_to_all / psum) stay on the host's links (NVLink).
  * across hosts — the dp (ciphertext batch) axis ONLY.  FHE batches are
    embarrassingly parallel, so no per-op collective crosses hosts.  (Keys
    are replicated; each host holds its batch shard.)

Launch recipe (G GPUs a host, one process a GPU):

    # on every host:  torchrun --nnodes=H --nproc-per-node=G ... prog.py
    from fhe_study_tpu_torch.parallel import distributed
    distributed.initialize()            # reads MASTER_ADDR, MASTER_PORT,
                                        # WORLD_SIZE, RANK, LOCAL_RANK
    mesh = distributed.hybrid_mesh(ici={"ep": 2, "sp": 1, "tp": 2})
    # -> DeviceMesh (dp=H*G/4, ep=2, sp=1, tp=2), dp spanning the hosts

One host: the same ``hybrid_mesh`` call with ``simulate_hosts=2`` factors
the ranks into an outermost "host" dimension feeding dp, the layout a
multi-host launch gets.  A host is a torchrun node: WORLD_SIZE /
LOCAL_WORLD_SIZE of them.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as mesh_mod

AXES = ("dp", "ep", "sp", "tp")


def initialize(device: str = "cuda", backend: str | None = None,
               timeout_s: float = 600.0) -> bool:
    """Bring up the process group from torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).  Returns True
    if it did, False in a single process (no WORLD_SIZE or MASTER_ADDR:
    nothing to initialize).  ``backend`` None: NCCL on CUDA, gloo on the
    CPU.  On CUDA the rank's device is ``cuda:LOCAL_RANK``."""
    env = os.environ
    if "WORLD_SIZE" not in env or "MASTER_ADDR" not in env:
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method="env://", world_size=int(env["WORLD_SIZE"]),
        rank=int(env["RANK"]), timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_device(device: str = "cuda") -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` on CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def _ici(ici: dict | None) -> dict:
    ici = dict(ici or {})
    for ax in ("ep", "sp", "tp"):
        ici.setdefault(ax, 1)
    return ici


def hybrid_grid(world: int, ici: dict | None = None, dcn_axis: str = "dp",
                hosts: int = 1) -> np.ndarray:
    """The (dp, ep, sp, tp) grid of ranks of ``hybrid_mesh`` over ``hosts``
    hosts of world / hosts ranks each, ranks numbered host by host (as
    torchrun numbers them; the reference's device ids).  dcn_axis="dp":
    the host factor outermost in dp.  dcn_axis="ep": outermost in ep, so
    the RNS limb all_gathers cross hosts."""
    ici = _ici(ici)
    ici_total = ici["ep"] * ici["sp"] * ici["tp"]
    if dcn_axis not in ("dp", "ep"):
        raise ValueError(f"dcn_axis {dcn_axis!r}: take 'dp' or 'ep'")
    if world % (hosts * ici_total):
        raise ValueError(f"{world} ranks don't factor into {hosts} hosts x "
                         f"{ici} local axes")
    ranks = np.arange(world)
    if dcn_axis == "ep":
        dp = world // (hosts * ici_total)
        arr = ranks.reshape(hosts, dp, ici["ep"], ici["sp"], ici["tp"])
        arr = np.moveaxis(arr, 0, 1)        # [dp, hosts, ep_i, sp, tp]
        return arr.reshape(dp, hosts * ici["ep"], ici["sp"], ici["tp"])
    dp = world // ici_total           # host factor folds into dp (outermost)
    return ranks.reshape(dp, ici["ep"], ici["sp"], ici["tp"])


def hybrid_mesh(ici: dict | None = None, dcn_axis: str = "dp",
                simulate_hosts: int | None = None):
    """A (dp, ep, sp, tp) DeviceMesh with dp on the host tier and the given
    local axis sizes within each host.  Several torchrun nodes: the hosts
    are the nodes (``simulate_hosts`` is ignored, as the reference ignores
    it across processes).  One node: ``simulate_hosts`` (default 1)."""
    world = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    nodes = world // local
    hosts = nodes if nodes > 1 else (simulate_hosts or 1)
    return mesh_mod.from_grid(hybrid_grid(world, ici, dcn_axis, hosts), AXES)

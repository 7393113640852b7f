"""Device meshes over torch.distributed ranks and the slab helpers — the
counterpart of fhe_study_tpu/parallel/mesh.py.

FHE's parallelism axes (SURVEY §2.6), as in the reference:
  * dp — ciphertext batch (data parallel; no collectives)
  * ep — RNS/CRT limb axis (limb-parallel; all_gather at reconstruction)
  * sp — polynomial coefficient axis (the four-step NTT exchanges tiles
         all_to_all)
  * tp — GLWE mask / gadget-level axis (tensor parallel; psum reductions)

A mesh is a ``DeviceMesh`` over every rank of the default process group;
its grid of ranks comes from a pure function (``rank_grid`` here,
``distributed.hybrid_grid``, ``pipeline.factor_sizes``) that equals the JAX
mesh's grid of device ids, so a layout can be checked without processes.
The mesh's device type follows the backend: ``cpu`` for gloo (it moves host
memory), ``cuda`` for NCCL.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import comm

AXES = ("dp", "ep", "sp")


def rank_grid(n_devices: int, dp: int | None = None, ep: int = 1,
              sp: int = 1) -> np.ndarray:
    """The (dp, ep, sp) grid of ranks of ``make_mesh``: the first dp*ep*sp
    ranks, row-major."""
    if dp is None:
        dp = n_devices // (ep * sp)
    if dp * ep * sp > n_devices:
        raise ValueError(f"need {dp * ep * sp} devices, have {n_devices}")
    return np.arange(dp * ep * sp).reshape(dp, ep, sp)


def from_grid(grid: np.ndarray, names: tuple) -> DeviceMesh:
    """A DeviceMesh over the default group's ranks laid out as ``grid``;
    the grid must hold every rank once."""
    world = dist.get_world_size()
    if sorted(grid.ravel().tolist()) != list(range(world)):
        raise ValueError(f"the mesh grid {grid.tolist()} does not hold each "
                         f"of the {world} ranks once")
    kind = "cpu" if dist.get_backend() == dist.Backend.GLOO else "cuda"
    return DeviceMesh(kind, torch.from_numpy(np.ascontiguousarray(grid)),
                      mesh_dim_names=tuple(names))


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              ep: int = 1, sp: int = 1) -> DeviceMesh:
    """A (dp, ep, sp) mesh over the world's ranks (all of them: torch has
    no mesh over part of the world that every rank can call)."""
    n = n_devices or dist.get_world_size()
    return from_grid(rank_grid(n, dp, ep, sp), AXES)


def axis_sizes(mesh: DeviceMesh) -> dict:
    """{axis name: size}, the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def shard(x: torch.Tensor, mesh: DeviceMesh, axis: str,
          dim: int) -> torch.Tensor:
    """This rank's slab of the global ``x`` along ``dim``, cut over ``axis``
    (the reference's ``device_put`` with that dim's PartitionSpec), in
    memory of its own, as a rank holds it (and a kernel takes it)."""
    S = comm.axis_size(mesh, axis)
    if x.shape[dim] % S:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axis}={S}")
    return x.chunk(S, dim)[comm.axis_index(mesh, axis)].contiguous()


def unshard(x: torch.Tensor, mesh: DeviceMesh, axis: str,
            dim: int) -> torch.Tensor:
    """The global tensor from every rank's slab along ``dim``."""
    return comm.all_gather(x, mesh, axis, dim)

"""Collectives over one axis of a DeviceMesh — the port's counterpart of the
``jax.lax`` collectives that fhe_study_tpu/parallel calls inside
``shard_map`` (``axis_index``, ``all_gather``, ``all_to_all`` with
``tiled=True``, ``psum``).

Torch has no ``shard_map``: every rank holds its slab of a global tensor and
calls the collective itself, on the process group of the mesh axis.  The
chunks of a collective are ordered by the ranks' coordinates along the axis
(JAX's device order); ``_group`` checks that the group's own rank order is
that order, and raises if it is not.

Transport, fixed by the group's backend and never by a failure: an NCCL
group gets the tensors where they lie; a gloo group moves host memory only,
so a CUDA tensor is copied to the host, the collective runs there, and the
result is copied back.  Every byte so copied, in either direction, is
counted in ``STAGED`` (``staged_bytes`` / ``reset_staged``).  Nothing falls
back from one backend to another.
"""

import torch
import torch.distributed as dist

# bytes copied between a CUDA tensor and the host for a gloo group; module
# state, read and reset by the callers that report it
STAGED = {"bytes": 0}


def staged_bytes() -> int:
    return STAGED["bytes"]


def reset_staged() -> None:
    STAGED["bytes"] = 0


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_ranks(mesh, axis: str) -> list:
    """The global ranks along ``axis`` through this rank, in coordinate
    order."""
    coord = mesh.get_coordinate()
    dim = mesh.mesh_dim_names.index(axis)
    idx = tuple(slice(None) if d == dim else c for d, c in enumerate(coord))
    return mesh.mesh[idx].tolist()


def _group(mesh, axis: str):
    group = mesh.get_group(axis)
    got = dist.get_process_group_ranks(group)
    want = axis_ranks(mesh, axis)
    if got != want:
        raise RuntimeError(f"the process group of mesh axis {axis!r} orders "
                           f"its ranks {got}, the mesh {want}: chunks would "
                           "land out of coordinate order")
    return group


def _to_backend(x: torch.Tensor, group):
    """(the tensor to hand the backend, the device to return results to or
    None): a CUDA tensor on a gloo group goes through host memory."""
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        STAGED["bytes"] += x.numel() * x.element_size()
        return x.cpu(), x.device
    return x, None


def _back(y: torch.Tensor, device):
    if device is None:
        return y
    STAGED["bytes"] += y.numel() * y.element_size()
    return y.to(device)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' slabs along ``axis`` concatenated along ``dim`` in
    coordinate order (``lax.all_gather(..., tiled=True)``); every slab has
    x's shape."""
    group = _group(mesh, axis)
    xs, home = _to_backend(x, group)
    parts = [torch.empty_like(xs) for _ in range(group.size())]
    dist.all_gather(parts, xs, group=group)
    return _back(torch.cat(parts, dim), home)


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``: x is
    cut into S chunks along ``split_dim``, chunk j goes to coordinate j, and
    the chunks received are concatenated along ``concat_dim`` in coordinate
    order.  ``all_to_all_single`` splits dim 0 only, so the split dim is
    moved to the front and made contiguous first."""
    group = _group(mesh, axis)
    S = group.size()
    split_dim %= x.dim()
    if x.shape[split_dim] % S:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split into {S} chunks")
    xs, home = _to_backend(x.movedim(split_dim, 0), group)
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    out = _back(out, home)
    return torch.cat([c.movedim(0, split_dim) for c in out.chunk(S, 0)],
                     concat_dim)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of int64 slabs, wrapping mod 2^64 as JAX's u64
    ``psum`` does; the caller reduces it (``modops.coerce_u64``).  The slabs
    are gathered and summed by torch, whose int64 sum wraps: gloo's
    all_reduce adds int64 in C++, where signed overflow is undefined."""
    if x.dtype != torch.int64:
        raise TypeError(f"psum takes int64 (u64 bits), got {x.dtype}")
    return all_gather(x.unsqueeze(0), mesh, axis, 0).sum(0)

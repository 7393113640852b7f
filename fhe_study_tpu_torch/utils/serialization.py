"""Checkpoint and reload nested containers of tensors — the counterpart of
fhe_study_tpu/utils/serialization.py.

A tree is a nest of dicts, tuples and lists whose leaves are torch tensors,
numpy arrays or plain scalars (int, float, str, bool, None); dict keys are
scalars or tuples of them, as the bootstrap's key sets use.  ``save_pytree``
writes one ``.npz``: each array a member, and a JSON manifest of the
structure (scalars inline, exact: JSON keeps Python ints whole and floats by
their shortest repr).  ``load_pytree`` rebuilds the same tree, its tensors on
a given device.  No pickle is involved either way.  NamedTuples are refused:
their type would not survive the trip.
"""

import json

import numpy as np
import torch

_MANIFEST = "__manifest__"
_SCALARS = (bool, int, float, str, type(None))


def _encode(x, arrays: list):
    if isinstance(x, torch.Tensor):
        arrays.append(x.detach().cpu().numpy())
        return {"tensor": len(arrays) - 1}
    if isinstance(x, np.ndarray):
        arrays.append(x)
        return {"array": len(arrays) - 1}
    if isinstance(x, _SCALARS):
        return {"value": x}
    if isinstance(x, dict):
        return {"dict": [[_encode(k, arrays), _encode(v, arrays)]
                         for k, v in x.items()]}
    if type(x) in (tuple, list):
        return {type(x).__name__: [_encode(v, arrays) for v in x]}
    raise TypeError(f"cannot save a {type(x).__name__}: the tree holds "
                    "dicts, tuples, lists, tensors, numpy arrays and scalars")


def _decode(node, data, device):
    (kind, v), = node.items()
    if kind == "tensor":
        return torch.from_numpy(data[f"leaf_{v}"]).to(device)
    if kind == "array":
        return data[f"leaf_{v}"]
    if kind == "value":
        return v
    if kind == "dict":
        return {_decode(k, data, device): _decode(x, data, device)
                for k, x in v}
    items = [_decode(x, data, device) for x in v]
    return tuple(items) if kind == "tuple" else items


def save_pytree(path: str, tree) -> None:
    arrays = []
    manifest = json.dumps(_encode(tree, arrays))
    members = {f"leaf_{i}": a for i, a in enumerate(arrays)}
    members[_MANIFEST] = np.frombuffer(manifest.encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **members)


def load_pytree(path: str, device):
    """The tree that save_pytree wrote to ``path``, tensors on ``device``."""
    with np.load(path, allow_pickle=False) as npz:
        data = {k: npz[k] for k in npz.files}
    return _decode(json.loads(data.pop(_MANIFEST).tobytes().decode()), data,
                   device)

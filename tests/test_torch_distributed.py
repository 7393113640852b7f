"""The port's multi-process tier (fhe_study_tpu_torch/parallel/distributed)
against the JAX package's: ``hybrid_grid`` against the JAX device ids of
``hybrid_mesh`` over a grid of local axis sizes, DCN axes and simulated
hosts (no processes), ``initialize`` in one process, and the two-process
worker (utils/distributed_worker.py, torchrun style over gloo on the CPU),
which decrypt-verifies each process's rows and the ep-spanning product."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from fhe_study_tpu.parallel import distributed as jdist

from fhe_study_tpu_torch.parallel import distributed

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT_S = 240

ICI = [{}, {"ep": 2}, {"sp": 2}, {"ep": 2, "tp": 2}, {"ep": 2, "sp": 2},
       {"ep": 2, "sp": 2, "tp": 2}, {"tp": 4}, {"ep": 4}]


@pytest.mark.parametrize("hosts", [None, 1, 2, 4])
@pytest.mark.parametrize("dcn_axis", ["dp", "ep"])
@pytest.mark.parametrize("ici", ICI, ids=lambda d: repr(d))
def test_hybrid_grid_is_hybrid_mesh_device_ids(ici, dcn_axis, hosts):
    per_host = 8 // (hosts or 1)
    total = int(np.prod([ici.get(a, 1) for a in ("ep", "sp", "tp")]))
    if per_host % total:
        with pytest.raises((AssertionError, ValueError)):
            jdist.hybrid_mesh(ici=ici, dcn_axis=dcn_axis,
                              simulate_hosts=hosts)
        with pytest.raises(ValueError, match="factor"):
            distributed.hybrid_grid(8, ici, dcn_axis, hosts or 1)
        return
    jm = jdist.hybrid_mesh(ici=ici, dcn_axis=dcn_axis, simulate_hosts=hosts)
    got = distributed.hybrid_grid(8, ici, dcn_axis, hosts or 1)
    np.testing.assert_array_equal(
        got, np.vectorize(lambda d: d.id)(jm.devices))
    assert dict(zip(distributed.AXES, got.shape)) == dict(jm.shape)


def test_hybrid_grid_refuses_other_dcn_axes():
    with pytest.raises(ValueError, match="dcn_axis"):
        distributed.hybrid_grid(8, {"ep": 2}, "sp", 2)


def test_initialize_single_process_noop(monkeypatch):
    # nothing configured -> no process group is brought up
    for var in ("WORLD_SIZE", "MASTER_ADDR", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize("cpu") is False


def test_two_process_worker():
    """Two OS processes, torchrun's environment, gloo: each is a host of
    one rank (LOCAL_WORLD_SIZE=1), dp spans them, then ep does."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": "0",
                    "LOCAL_WORLD_SIZE": "1", "OMP_NUM_THREADS": "2"})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fhe_study_tpu_torch.utils."
             "distributed_worker", "--device", "cpu"], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out)
            assert p.returncode == 0, f"worker {rank} failed:\n{out[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, out in enumerate(outs):
        assert f"DIST2PROC OK p{rank}" in out, out[-3000:]
        assert f"DIST2PROC EP OK p{rank}" in out, out[-3000:]


def test_jax_devices_are_the_conftests_eight():
    assert len(jax.devices()) == 8

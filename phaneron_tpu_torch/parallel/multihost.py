"""The two-process multihost dry run (counterpart of
``__graft_entry__.dryrun_multihost`` and tools/multihost_worker.py).

``dryrun_multihost()`` starts two processes,

    python -m phaneron_tpu_torch.parallel.multihost <rank> <port> <device> [out.npy]

which form a ``torch.distributed`` group over gloo on a free loopback
port.  Rank h serves channel h of the JAX worker's frames and matrices
(seed 7, (2, 4, 64, 96) frames, one axis-aligned DVE matrix a channel):
its frame row-sharded over sp=4 bands of its device, each band warped by
K4's band form from the rows its taps reach.  The ROUTE is rank h
receiving rank h-1's warped frame (the JAX worker's ``jnp.roll`` over
its 'host' axis) through gloo, host tensors both ways (gloo moves host
tensors, and NCCL refuses two ranks on one GPU).  Each rank mixes
``warped * 0.6 + routed * 0.4`` and asserts it equal, max |delta| 0, to
the same step computed unsharded on the rank (the JAX worker allows one
ulp for XLA's FMA formation across its collective; the port forms no
FMA).  Rank 0 prints the OK line and, given a path, saves its mixed
frame there.  The worker runs only under ``__main__``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

__all__ = ["dryrun_multihost", "worker_inputs"]

_ROOT = Path(__file__).resolve().parents[2]
SP = 4  # bands a rank


def worker_inputs():
    """The JAX worker's inputs (tools/multihost_worker.py): seed-7 frames
    (2, 4, 64, 96) float32, one a channel, and their matrices (2, 3, 3)."""
    from ..ops.geometry import transform_matrix

    h, w = 64, 96
    rng = np.random.default_rng(7)
    frames = rng.random((2, 4, h, w), dtype=np.float32)
    mats = np.stack([transform_matrix(w, h, scale_y=1.3, offset_y=0.05),
                     transform_matrix(w, h, scale_x=0.8, offset_x=-0.1)])
    return frames, mats


def dryrun_multihost(timeout: float = 120.0, device: str | None = None, out: str | None = None) -> str:
    """Run the two ranks (on ``device``: default cuda:0 where torch sees a
    card, else the CPU) and return rank 0's OK line; raise if a rank
    fails, or kill both and raise if they outlast ``timeout`` seconds.
    ``out``: a path where rank 0 saves its mixed frame (.npy)."""
    import torch

    if device is None:
        device = "cuda:0" if torch.cuda.is_available() else "cpu"
    with socket.socket() as s:  # a free loopback port for the group's store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(_ROOT), os.environ.get("PYTHONPATH")])))
    args = lambda rank: [sys.executable, "-m", "phaneron_tpu_torch.parallel.multihost", str(rank), str(port),
                         device] + ([out] if out and rank == 0 else [])
    procs = [subprocess.Popen(args(r), cwd=_ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"multihost rank failed ({p.returncode}):\n{o}")
    line = next((ln for o in outs for ln in o.splitlines() if "dryrun multihost ok" in ln), None)
    if line is None:
        raise RuntimeError(f"no rank reported ok:\n{outs}")
    print(line)
    return line


def _main(rank: int, port: int, device: str, out: str | None) -> None:
    import torch
    import torch.distributed as dist

    from ..graph.pipeline import _warp_rows
    from ..ops.kernels import Rows
    from ..ops.warp import warp
    from .mesh import band_bounds, make_sp_mesh, shard_params_sp

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
    dev = torch.device(device)
    frames, mats = worker_inputs()
    _, _, h, w = frames.shape
    mesh = make_sp_mesh([dev] * SP)
    # channel `rank`, its rows over SP bands; each band warps its own output
    # rows from the rows its taps reach
    frame = shard_params_sp({"src": torch.from_numpy(frames[rank]).to(dev)}, mesh)["src"]
    mat = torch.from_numpy(mats[rank]).to(dev)
    bands = []
    for d, (r0, r1) in zip(mesh.flat, band_bounds(h, SP)):
        (lo, hi), = _warp_rows([mats[rank]], [(r0, r1)], w, h)
        bands.append(warp(frame.rows(lo, hi, d), mat.to(d), rows=Rows(r0, r1, h, lo)).to(dev))
    warped = torch.cat(bands, dim=1)
    # the ROUTE: rank h receives rank h-1's warped frame, host tensors over gloo
    sent, got = warped.cpu(), torch.empty((4, h, w), dtype=torch.float32)
    req = dist.isend(sent, (rank + 1) % 2)
    dist.recv(got, (rank - 1) % 2)
    req.wait()
    mixed = warped * 0.6 + got.to(dev) * 0.4
    # reference: the same step unsharded on this rank
    whole = [warp(torch.from_numpy(frames[c]).to(dev), torch.from_numpy(mats[c]).to(dev)) for c in (0, 1)]
    ref = whole[rank] * 0.6 + whole[(rank - 1) % 2] * 0.4
    diff = float((mixed - ref).abs().max())
    if diff != 0.0:
        raise AssertionError(f"rank {rank}: banded step differs from the unsharded one by {diff}")
    dist.barrier()
    if rank == 0:
        if out:
            np.save(out, mixed.cpu().numpy())
        print(f"dryrun multihost ok: 2 processes x sp={SP} bands on {device}, channel-per-rank + "
              f"row bands, cross-process ROUTE over gloo, max |delta| 0 vs unsharded", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4] if len(sys.argv) > 4 else None)

"""The port's two-process multihost dry run (parallel/multihost.py) on
the CPU: two ``torch.distributed`` ranks over gloo on a loopback port,
each a channel row-sharded into 4 bands warped by K4's band form (its
plain version here), the ROUTE a cross-process send of the warped frame.
Each rank asserts its mixed frame equal, max |delta| 0, to the unsharded
step; the test holds rank 0's frame to the JAX worker's step
(tools/multihost_worker.py: vmapped ``warp_axis_aligned``, the roll over
its hosts, ``warped * 0.6 + routed * 0.4``) on the same inputs, within
K4's plain-version tolerance (5e-5, tests/test_torch_kernels_plain.py).
The ranks are killed if they outlast the 120 s limit, so the test cannot
hang the suite."""

import jax
import jax.numpy as jnp
import numpy as np

from phaneron_tpu.ops.geometry import warp_axis_aligned
from phaneron_tpu_torch.parallel.multihost import dryrun_multihost, worker_inputs

TOL_WARP = 5e-5


def test_dryrun_multihost_matches_jax_worker(tmp_path):
    out = tmp_path / "rank0.npy"
    line = dryrun_multihost(timeout=120.0, device="cpu", out=str(out))
    assert "dryrun multihost ok" in line and "cross-process ROUTE" in line
    got = np.load(out)
    frames, mats = worker_inputs()
    warped = jax.vmap(warp_axis_aligned)(jnp.asarray(frames), jnp.asarray(mats))
    want = np.asarray(warped * 0.6 + jnp.roll(warped, 1, axis=0) * 0.4)[0]
    assert got.shape == want.shape == (4, 64, 96)
    assert np.abs(got - want).max() <= TOL_WARP

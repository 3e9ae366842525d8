"""Build the CUDA kernels at first use and bind them with ctypes.

``library()`` compiles every ``phaneron_tpu_torch/csrc/*.cu`` with nvcc,
one process per source, all started together, and links the objects into
one shared library with a plain C interface, under ``build/kernels/`` at
the repository root, and loads it.  The file name carries a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads the existing library.  Nothing but the package's own sources goes
into the build.  A failed build raises with nvcc's output.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false``: nvcc would
otherwise contract ``a*b + c`` into one fused multiply-add, which rounds
differently from the plain PyTorch versions and the JAX reference.
Division and ``powf`` stay IEEE / full precision (no fast-math).
The link adds the CUDA driver library (``-lcuda``, from the toolkit's
stubs; the CUDA driver's own at run time) for csrc/graph_rebind.cu's graph
calls.  ``nvcc_flags()`` adds the -D defines of the constants a kernel shares
with its plain version (``nvcc_defines`` of ops/rotate.py and
ops/packed_warp.py).

Importing this module builds nothing, so the package imports cleanly on
a machine without nvcc.  ``library()`` and ``build_info()`` hold one lock
while they build or load, so threads that ask at once (channels
prewarming from worker threads) wait for one build instead of each
running nvcc.  Each load counts on the port's tracer
(``utils/metrics.py``): ``ops.library_builds.built`` or ``.loaded``, and
its seconds in ``ops.library_builds.seconds``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path

from ..utils.metrics import tracer

__all__ = ["library", "build_dir", "sources", "NVCC_FLAGS", "nvcc_flags", "BuildInfo", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _L, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_size_t
# argtypes of every exported function: pointers and the stream as
# c_void_p (a plain int would be cut to 32 bits), sizes as c_int, plane
# strides as c_longlong, byte counts as c_size_t
_SIGNATURES = {
    "phn_v210_unpack": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "phn_v210_pack": (_P, _P, _I, _I, _I, _P, _P, _P),
    "phn_planar422_unpack": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "phn_planar422_pack": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "phn_planar420_unpack": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "phn_planar420_pack": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "phn_rgb8_unpack": (_P, _P, _I, _I, _I, _P, _P, _P),
    "phn_warp": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "phn_rotate": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    "phn_yadif_ring": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _L, _L, _I, _I, _I, _P),
    "phn_yadif_pair": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "phn_packed_composite": (_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P,
                             _P),
    "phn_fused_v210": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    "phn_fused_v210_corrections": (_P, _P, _P, _P, _P),
    "phn_l2g_corrections": (_P, _P, _P, _P),
    "phn_combine_pack": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P),
    "phn_packed_warp": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "phn_graph_nodes": (_P, _P, _P),
    "phn_graph_node": (_P, _P, _P, _P, _S, _P, _P, _S, _P, _P),
    "phn_graph_rebind": (_P, _P, _P, _P, _P, _I, _P),
}


class BuildInfo:
    """What the last ``library()`` call did: the library path, whether it
    compiled (False: an existing build was loaded), the seconds it took
    and nvcc's output (ptxas register and spill counts)."""

    def __init__(self, path: Path, compiled: bool, seconds: float, log: str):
        self.path, self.compiled, self.seconds, self.log = path, compiled, seconds, log


def build_dir() -> Path:
    """build/kernels/ at the root of the checkout holding the package."""
    return _PKG.parent / "build" / "kernels"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_flags() -> tuple:
    """NVCC_FLAGS and the defines every source is built with."""
    from . import packed_warp, rotate

    return NVCC_FLAGS + rotate.nvcc_defines() + packed_warp.nvcc_defines()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _link_flags(nvcc: str) -> list[str]:
    """The CUDA driver library, linked against the toolkit's stub."""
    return [f"-L{Path(nvcc).resolve().parent.parent / 'lib64' / 'stubs'}", "-lcuda"]


def _digest(srcs: list[Path]) -> str:
    h = hashlib.sha256(" ".join(nvcc_flags() + ("-lcuda",)).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmd: list[str], what: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {what} ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def _compile(out: Path, srcs: list[Path]) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, flags = _nvcc(), nvcc_flags()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
        cus = [p for p in srcs if p.suffix == ".cu"]
        objs = [str(Path(tmp_dir) / f"{p.stem}.o") for p in cus]
        # one nvcc per source, all at once
        with ThreadPoolExecutor(max_workers=len(cus)) as pool:
            logs = list(pool.map(
                lambda po: _run([nvcc, *flags, "-c", "-o", po[1], str(po[0])], po[0].name),
                zip(cus, objs),
            ))
        tmp = str(Path(tmp_dir) / out.name)
        logs.append(_run([nvcc, "-shared", "-o", tmp, *objs, *_link_flags(nvcc)], "link"))
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    log = "".join(logs)
    out.with_suffix(".log").write_text(log)
    return log


_LOAD_LOCK = threading.Lock()


@lru_cache(maxsize=1)
def _load() -> tuple[ctypes.CDLL, BuildInfo]:
    """Build or load the library once a process; call it under _LOAD_LOCK
    (``library``, ``build_info``): lru_cache alone lets two threads that
    miss at once both build."""
    t0 = time.perf_counter()
    srcs = sources()
    out = build_dir() / f"libphaneron_kernels-{_digest(srcs)}.so"
    compiled = not out.exists()
    if compiled:
        log = _compile(out, srcs)
    else:
        log_path = out.with_suffix(".log")
        log = log_path.read_text() if log_path.exists() else ""
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    seconds = time.perf_counter() - t0
    tracer.count("ops.library_builds.built" if compiled else "ops.library_builds.loaded")
    tracer.count("ops.library_builds.seconds", seconds)
    return lib, BuildInfo(out, compiled, seconds, log)


def library() -> ctypes.CDLL:
    """The kernel library, built on the first call of the process."""
    with _LOAD_LOCK:
        return _load()[0]


def build_info() -> BuildInfo:
    with _LOAD_LOCK:
        return _load()[1]

"""The band executor: one channel's frame program row-sharded over a
1-D 'sp' mesh (the port's form of the JAX package's GSPMD program under
``shard_params_sp``).

PyTorch has no GSPMD, so the rows are split by hand.  The frame's H rows
make sp bands (``output_bounds``: equal, except that a 4:2:0 output's
bands end on even rows), band k computed on the mesh's device k:

- it takes **the route** ``make_channel_program`` takes for the spec
  (graph/pipeline.py, routes 1-3): the same program runs each band, given
  a ``Band`` (graph/pipeline.py), so a banded frame equals the unsharded
  one bit for bit;
- for band k, output rows [r0, r1), each source slot's window is the rows
  its stages reach (``band_windows``): a row-local stage its own rows, an
  axis-aligned DVE the rows its matrices' taps reach (worked out on the
  host from the matrices' host copies, ``mesh.host_copy``; under a
  rotation the box its corners' taps span), the yadif ring
  two more each side (``yadif.ring_window``), a 4:2:0 unpack whole row
  pairs, a stretch fit the source rows it reads;
- ``Sharded.rows`` brings those rows onto device k from the bands that
  hold them: a view where they lie on device k (on one card, every row
  of a frame the group's shards were cut from), else device-to-device
  copies, joined;
- the row-local kernels (K1, K3/B10, B12, K2, B5, B11, B13, B3) run on a
  band's rows unchanged; K4, B6, K5, B9 and B14 run as band forms that
  take their windows and work in frame coordinates (ops/kernels.py
  ``Rows``);
- the packed planes (and, under ``emit_rgba``, the frame) are gathered
  onto the mesh's first device, so consumers and ROUTE taps receive whole
  planes on one device.

B13 packs a chroma row from each row pair, so a 4:2:0 output's bands
hold whole pairs: their bounds snap to even rows (1080 rows at sp=8 make
bands of 134 and 136 rows, not 135).  The params stay split into equal
runs (``shard_params_sp``); each band fetches its rows from them.  The
one refusal, in ``check_sp``, is a height that sp does not divide, as in
the JAX package.  There is no fallback to an unsharded frame.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graph.pipeline import (
    Band,
    ChannelSpec,
    _fused_v210_ok,
    band_windows,
    make_channel_program,
    make_pack_program,
)
from ..ops import kernels, packed_warp, rotate as rotate_mod, warp as warp_mod, yadif
from ..ops.composite import transparent
from .mesh import Mesh, Shard, Sharded, band_bounds, host_copy, shard_params_sp

__all__ = ["make_sp_channel_program", "check_sp", "output_bounds", "BAND_KERNELS"]

# the wrappers whose launches a band records, by name
BAND_KERNELS = {
    "v210_unpack": kernels.v210_unpack, "planar422_unpack": kernels.planar422_unpack,
    "planar420_unpack": kernels.planar420_unpack, "warp": warp_mod.warp,
    "v210_pack": kernels.v210_pack, "planar422_pack": kernels.planar422_pack,
    "planar420_pack": kernels.planar420_pack, "yadif_ring": yadif.yadif_ring,
    "packed_composite": packed_warp.packed_composite, "packed_warp": packed_warp.packed_warp,
    "combine_pack": kernels.combine_pack, "fused_v210": kernels.fused_v210,
    "rotate": rotate_mod.rotate, "rgb8_unpack": kernels.rgb8_unpack,
}


def check_sp(height: int, sp: int) -> None:
    """Raise ValueError for a channel of ``height`` rows that cannot be
    split into sp bands: sp must divide the height (JAX
    runtime/channel.py)."""
    if height % sp:
        raise ValueError(f"channel height {height} not divisible by sp={sp}")


def output_bounds(height: int, sp: int, out_format: str) -> list:
    """[(row0, row1)] of the sp bands of a ``height``-row frame into
    ``out_format``: ``band_bounds``' equal runs, or for a 4:2:0 output,
    whose pack makes a chroma row of each row pair, runs of whole pairs
    (every bound even but the frame's last row; equal runs where H / sp
    is even).  A frame of fewer pairs than bands leaves some bands
    empty."""
    if out_format not in kernels.PLANAR420:
        return band_bounds(height, sp)
    return [(min(2 * r0, height), min(2 * r1, height)) for r0, r1 in band_bounds((height + 1) // 2, sp)]


def _local(x, device: torch.device):
    """A band's params: replicated leaves on its device; split leaves stay
    ``Sharded`` for ``Band.fetch``."""
    if isinstance(x, dict):
        return {k: _local(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_local(v, device) for v in x)
    if isinstance(x, Sharded) and x.axis is None:
        return x.on(device)
    return x


def _fetch(device: torch.device):
    def fetch(leaf, lo: int, hi: int) -> torch.Tensor:
        if not isinstance(leaf, Sharded):
            raise TypeError(f"band fetch: expected a Sharded leaf, got {type(leaf).__name__}")
        return leaf.rows(lo, hi, device)

    return fetch


def _gather(parts: list, device: torch.device, dim: int) -> torch.Tensor:
    return torch.cat([p.to(device, non_blocking=True) for p in parts], dim=dim)


def make_sp_channel_program(spec: ChannelSpec, mesh: Mesh, plain: bool = False):
    """The frame program of ``spec`` row-sharded over the 1-D mesh:
    fn(params) -> the packed planes (under ``emit_rgba``: {"packed":
    planes, "rgba": frame}) on the mesh's first device, equal to
    ``make_channel_program(spec, plain)`` of the same params bit for bit.
    ``params`` may be sharded already (``shard_params_sp`` over this mesh;
    a leaf sharded over another mesh is resharded band to band) or hold
    whole tensors, which are sharded here.  ``fn.last_bands`` records the
    last frame's bands: their rows, device and kernel launches.
    ``fn.last_rgba`` holds its frame as the bands left it (``Sharded``), for
    a ROUTE into another mesh.  ``fn.prepare()`` prepares the program on
    every device of the mesh."""
    check_sp(spec.height, len(mesh.flat))
    # the bands that hold rows, each with its device
    placed = [(d, b) for d, b in zip(mesh.flat, output_bounds(spec.height, len(mesh.flat), spec.out_format))
              if b[1] > b[0]]
    devices, bounds = [d for d, _ in placed], [b for _, b in placed]
    program = make_channel_program(spec, plain) if spec.layers else None
    pack = lambda rows: make_pack_program(spec.out_format, spec.width, rows, spec.out_col_spec,
                                          spec.gamma_mode, plain)
    fused = spec.layers and _fused_v210_ok(spec)  # route 1 reads its bands' own rows only
    first = mesh.flat[0]

    def run(params: Optional[dict] = None):
        sharded = shard_params_sp(params, mesh) if spec.layers else None
        mats = [{k: host_copy(lp.get(k)) for k in ("matrix", "matrix_b")} for lp in sharded["layers"]] \
            if spec.layers else []
        windows = band_windows(spec, mats, bounds) if program is not None and not fused else [{}] * len(bounds)
        outs, record = [], []
        for dev, (r0, r1), win in zip(devices, bounds, windows):
            before = {k: w.launches for k, w in BAND_KERNELS.items()}
            if program is None:  # an empty channel: transparent black, packed a band at a time
                out = pack(r1 - r0)(transparent(r1 - r0, spec.width, dev))
            else:
                band = Band(r0, r1, spec.height, dev, win, _fetch(dev))
                out = program(_local(sharded, dev), band)
            outs.append(out)
            record.append({"rows": (r0, r1), "device": dev, "launches": {
                k: w.launches - before[k] for k, w in BAND_KERNELS.items() if w.launches != before[k]}})
        run.last_bands = record
        emit = isinstance(outs[0], dict)
        planes = [o["packed"] if emit else o for o in outs]
        packed = [_gather(list(p), first, 0) for p in zip(*planes)]
        if not (emit or (program is None and spec.emit_rgba)):
            run.last_rgba = None
            return packed
        rgbas = [o["rgba"] for o in outs] if emit else [transparent(r1 - r0, spec.width, d)
                                                           for d, (r0, r1) in zip(devices, bounds)]
        run.last_rgba = Sharded([Shard(d, r0, t) for d, (r0, _), t in zip(devices, bounds, rgbas)],
                                (rgbas[0].shape[0], spec.height, spec.width), 1, mesh)
        return {"packed": packed, "rgba": _gather(rgbas, first, 1)}

    def prepare() -> None:
        if program is not None:
            for dev in dict.fromkeys(devices):
                program.prepare(dev)

    run.prepare = prepare
    run.last_bands = []
    run.last_rgba = None
    return run

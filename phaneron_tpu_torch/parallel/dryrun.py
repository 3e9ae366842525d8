"""Dry runs of the multi-device layouts (counterparts of
``__graft_entry__.dryrun_multichip``, ``_dryrun_sp_sharded_uhd`` and
``_dryrun_ch_sp_route``).

Each takes its devices: CPU devices in the tests (``["cpu"] * n``), the
card's in chip_smoke.py (``[cuda:0] * n`` on one card, every band in
turn), and raises AssertionError on a mismatch.  Each holds the sharded
result to the same program run whole on one device, bit for bit, and
returns its outputs (for the tests' comparison with the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.convert import params_from_numpy
from ..graph.pipeline import ChannelSpec, LayerSpec, make_channel_program
from ..ops.formats import get_format
from ..ops.geometry import transform_matrix
from .bands import make_sp_channel_program
from .mesh import (
    card_devices,
    make_mesh,
    make_multi_channel_program,
    make_sp_mesh,
    shard_channel_params,
    shard_params_sp,
)

__all__ = [
    "example_spec_and_params",
    "dryrun_multichip",
    "dryrun_sp_sharded_uhd",
    "dryrun_ch_sp_route",
    "uhd_spec_and_params",
    "route_specs_and_params",
]


def example_spec_and_params(width: int, height: int):
    """entry()'s structure (a v210 dissolve under an axis-aligned DVE over a
    yuv422p8 layer) and numpy params (``__graft_entry__``
    ``_example_spec_and_params``)."""
    spec = ChannelSpec(
        width, height, "v210",
        layers=(
            LayerSpec("v210", transition="dissolve", has_transform=True, axis_aligned=True,
                      src_b_format="v210"),
            LayerSpec("yuv422p8"),
        ),
    )
    v210, y422 = get_format("v210"), get_format("yuv422p8")
    params = {"layers": [
        {
            "src": [np.asarray(p) for p in v210.fill_buf(width, height)],
            "src_b": [np.zeros_like(np.asarray(p)) for p in v210.fill_buf(width, height)],
            "matrix": transform_matrix(width, height, scale_x=0.9, offset_x=0.05),
            "mix": np.float32(0.5),
        },
        {"src": [np.asarray(p) for p in y422.fill_buf(width, height)]},
    ]}
    return spec, params


def _require(ok: bool, msg: str) -> None:
    """Raise AssertionError on a mismatch (a check ``python -O`` keeps)."""
    if not ok:
        raise AssertionError(msg)


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return _equal(a["packed"], b["packed"]) and torch.equal(a["rgba"].cpu(), b["rgba"].cpu())
    return len(a) == len(b) and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def dryrun_multichip(n_devices: int, devices=None, uhd_size=(3840, 2160)) -> dict:
    """One multi-channel step over an n-device (ch, sp) mesh: entry()'s
    structure at 96x64, its params stacked over the mesh's 'ch' axis,
    sharded with ``shard_channel_params`` and run by
    ``make_multi_channel_program``; each channel's planes must equal the
    program run whole on the first device.  Then, as the JAX dry run does,
    the row-sharded UHD frame over all n devices (``uhd_size``) and, from 4
    devices, the cross-mesh ROUTE.  ``devices``: default the card's."""
    devices = card_devices(n_devices) if devices is None else [torch.device(d) for d in devices]
    mesh = make_mesh(devices)
    n_ch = mesh.shape["ch"]
    width, height = 96, 64  # a height every sp up to 8 divides
    spec, params = example_spec_and_params(width, height)
    stacked = _stack(params, n_ch)
    out = make_multi_channel_program(spec, mesh)(shard_channel_params(stacked, mesh))
    _require(out[0].shape[0] == n_ch, f"{out[0].shape[0]} channels out, mesh has {n_ch}")
    single = make_channel_program(spec)(params_from_numpy(params, devices[0]))
    for c in range(n_ch):
        _require(_equal([p[c] for p in out], single), f"multichip channel {c} differs from one device")
    print(f"dryrun_multichip ok: mesh ch={mesh.shape['ch']} sp={mesh.shape['sp']}, "
          f"out plane {tuple(out[0].shape)}, every channel bit-equal to one device")
    result = {"multichip": out, "single": single}
    result["uhd"] = dryrun_sp_sharded_uhd(devices, *uhd_size)
    if len(devices) >= 4:
        result["route"] = dryrun_ch_sp_route(devices)
    return result


def _stack(x, n: int):
    if isinstance(x, dict):
        return {k: _stack(v, n) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_stack(v, n) for v in x)
    return np.stack([np.asarray(x)] * n)


def uhd_spec_and_params(width: int, height: int, device):
    """The UHD dry run's structure and params on ``device``: an rgba_f32
    layer deinterlaced over a 3-frame ring (column ramps, seed 0) under an
    axis-aligned DVE (scale 1.2 x 1.3, offset_y 0.05), into v210."""
    spec = ChannelSpec(width, height, "v210", layers=(
        LayerSpec("rgba_f32", has_transform=True, axis_aligned=True, deinterlace=True),))
    rng = np.random.default_rng(0)
    col = rng.random((3, 4, height, 1), dtype=np.float32)
    ring = tuple(torch.from_numpy(col[k]).to(device).expand(4, height, width).contiguous() for k in range(3))
    mat = transform_matrix(width, height, scale_x=1.2, scale_y=1.3, offset_y=0.05)
    on_device = torch.from_numpy(mat).to(device)
    on_device.host = mat  # the host copy the bands' windows come from, as Mixer.matrix_on leaves it
    params = {"layers": [{"src_ring": ring, "parity": torch.zeros((), dtype=torch.int32, device=device),
                          "matrix": on_device}]}
    return spec, params


def dryrun_sp_sharded_uhd(devices, width: int = 3840, height: int = 2160) -> dict:
    """One UHD channel frame row-sharded over sp = len(devices): the yadif
    ring (vertical +-1-line and temporal taps) then an axis-aligned DVE
    whose vertical taps cross band edges, then the v210 pack; the banded
    words must equal the frame run whole on the first device."""
    devices = [torch.device(d) for d in devices]
    mesh = make_sp_mesh(devices)
    spec, params = uhd_spec_and_params(width, height, devices[0])
    prog = make_sp_channel_program(spec, mesh)
    sharded = prog(shard_params_sp(params, mesh))
    single = make_channel_program(spec)(params)
    _require(sharded[0].shape == single[0].shape and torch.equal(sharded[0], single[0]),
             "sp-sharded halo mismatch vs single device")
    print(f"dryrun sp-sharded UHD ok: {width}x{height} over sp={len(devices)}, yadif+warp halos "
          f"bit-equal to single-device")
    return {"sharded": sharded, "single": single, "bands": prog.last_bands}


def route_specs_and_params(width: int, height: int):
    """The cross-mesh ROUTE dry run's two channels: A a v210 cut with
    emit_rgba, B an rgba_f32 layer (A's frame) under an axis-aligned DVE
    (scale_y 1.3, offset_y 0.05), both into v210; A's numpy params and
    B's matrix."""
    spec_a = ChannelSpec(width, height, "v210", layers=(LayerSpec("v210"),), emit_rgba=True)
    params_a = {"layers": [{"src": [np.asarray(get_format("v210").fill_buf(width, height)[0])]}]}
    spec_b = ChannelSpec(width, height, "v210",
                         layers=(LayerSpec("rgba_f32", has_transform=True, axis_aligned=True),))
    return spec_a, params_a, spec_b, transform_matrix(width, height, scale_y=1.3, offset_y=0.05)


def dryrun_ch_sp_route(devices, width: int = 96, height: int = 64) -> dict:
    """ch x sp with a cross-mesh ROUTE: channel A row-sharded over the
    first half of ``devices``, its RGBA frame (as A's bands left it)
    resharded band to band onto channel B's mesh, the second half, where
    a DVE warp and the pack follow; B's words must equal the whole chain
    run on the first device."""
    devices = [torch.device(d) for d in devices]
    half = len(devices) // 2
    mesh_a, mesh_b = make_sp_mesh(devices[:half]), make_sp_mesh(devices[half:])
    spec_a, params_a, spec_b, mat = route_specs_and_params(width, height)
    prog_a = make_sp_channel_program(spec_a, mesh_a)
    prog_a(shard_params_sp(params_from_numpy(params_a, devices[0]), mesh_a))
    # the ROUTE hop: A's bands -> B's bands, each B band's rows copied from
    # the A bands that hold them
    routed = shard_params_sp({"src": prog_a.last_rgba}, mesh_b)["src"]
    prog_b = make_sp_channel_program(spec_b, mesh_b)
    out_b = prog_b({"layers": [{"src": routed, "matrix": mat}]})
    single_a = make_channel_program(spec_a)(params_from_numpy(params_a, devices[0]))
    single_b = make_channel_program(spec_b)(
        {"layers": [{"src": single_a["rgba"], "matrix": torch.from_numpy(mat).to(devices[0])}]})
    _require(torch.equal(out_b[0], single_b[0]), "ch x sp ROUTE output differs from single-device")
    print(f"dryrun ch-x-sp ROUTE ok: A(sp={half}) -> reshard -> B(sp={len(devices) - half}), "
          f"warped output bit-equal to single-device")
    return {"sharded": out_b, "single": single_b, "routed": routed}

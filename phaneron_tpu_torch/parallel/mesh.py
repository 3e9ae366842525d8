"""Multi-device layout: channels across devices, scanlines across devices
(counterpart of phaneron_tpu/parallel/mesh.py).

The JAX package lays its devices out as a 2-D mesh: axis 'ch' runs each
channel's frame program on its own device, axis 'sp' shards one
channel's scanlines across devices, and XLA's GSPMD inserts the halo
exchanges for the vertical taps.  PyTorch has no GSPMD, so here the
layout is explicit:

- ``Mesh``: a (ch, sp) grid of torch devices with its axis names.  A
  device may appear more than once: sp=4 over ``[cuda:0] * 4`` runs four
  bands in turn on one card.
- ``shard_params_sp`` / ``shard_channel_params``: a channel's params (or
  a stacked (n_ch, ...) tree of them) as ``Sharded`` leaves, chosen by
  param name as the JAX package's ``_sp_pspec`` / ``_param_pspec`` choose
  them: matrices, mixes, parities and every leaf of at most one dimension
  replicated; plane lists and frames split into equal disjoint runs of
  rows, one a band, each copied to its band's device without a host wait
  (a view where it already lies there: on one card every band's rows,
  halo included, are views of the frame they were cut from).
- the band executor (parallel/bands.py ``make_sp_channel_program``) runs
  the channel program band by band, each band fetching the rows its
  stages reach from the bands that hold them (``Sharded.rows``).
- ``make_multi_channel_program``: channels of a stacked params tree, each
  on its row of the mesh, row-sharded over that row's devices.

A ``Sharded`` leaf whose mesh differs from the one asked for is resharded
band to band (``shard_params_sp`` of a ``Sharded``): the port's form of
the cross-mesh ROUTE (JAX: ``device_put`` with a new sharding).

One difference from the JAX rules, kept on purpose: a packed plane of
three dimensions (rgba8 / bgra8, (H, W, 4)) splits its rows here, where
JAX's rule by dimension count would split its columns; and a stacked
(n_ch, C, H, W) frame splits its rows, where JAX's would split C.  The
band executor reads every plane by rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..graph.convert import to_tensor

__all__ = [
    "Mesh",
    "Shard",
    "Sharded",
    "card_devices",
    "make_mesh",
    "make_sp_mesh",
    "shard_params_sp",
    "shard_channel_params",
    "make_multi_channel_program",
    "band_bounds",
    "host_copy",
]

# replicated by name, whatever their shape (JAX mesh.py _REPLICATED_KEYS)
_REPLICATED_KEYS = frozenset({"matrix", "matrix_b", "mix", "parity", "mask_mix"})
_RING_KEYS = frozenset({"src_ring", "src_b_ring"})


def card_devices(n: Optional[int] = None) -> list:
    """The card's devices for an n-device layout: ``cuda:(i % count)`` for
    i < n (default: one each), so a layout names a device more than once
    where the machine has fewer.  Raises where no CUDA device is seen:
    there is no CPU fallback (pass CPU devices to run on the CPU)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device; pass devices (e.g. ['cpu'] * n) to run on the CPU")
    return [torch.device("cuda", i % count) for i in range(count if n is None else n)]


class Mesh:
    """A grid of torch devices with one name per axis (('ch', 'sp') or
    ('sp',)); ``shape`` maps each name to its size, as a JAX mesh's does."""

    def __init__(self, devices, axis_names: tuple):
        grid = np.empty(np.shape(devices)[:len(axis_names)], dtype=object)
        for idx in np.ndindex(grid.shape):
            d = devices
            for i in idx:
                d = d[i]
            grid[idx] = torch.device(d)
        if grid.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {grid.shape} for axes {axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def flat(self) -> list:
        """The devices in order, each position once (a band each)."""
        return list(self.devices.reshape(-1))

    def row(self, c: int) -> "Mesh":
        """Row c of the 'ch' axis: the 1-D 'sp' mesh of channel row c."""
        if "ch" not in self.axis_names:
            raise ValueError("row: the mesh has no 'ch' axis")
        return Mesh(list(self.devices[c]), ("sp",))

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and all(a == b for a, b in zip(self.flat, other.flat)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.flat]})"


def make_mesh(devices=None, ch: Optional[int] = None, sp: Optional[int] = None) -> Mesh:
    """A (ch, sp) mesh over ``devices`` (default: the card's,
    ``card_devices``): (2, n // 2) for an even n > 1, else (1, n), as the
    JAX package splits them."""
    devices = card_devices() if devices is None else list(devices)
    n = len(devices)
    if ch is None and sp is None:
        ch, sp = (2, n // 2) if n % 2 == 0 and n > 1 else (1, n)
    elif ch is None:
        ch = n // sp
    elif sp is None:
        sp = n // ch
    if ch * sp != n:
        raise ValueError(f"mesh {ch}x{sp} != {n} devices")
    return Mesh([devices[i * sp:(i + 1) * sp] for i in range(ch)], ("ch", "sp"))


def make_sp_mesh(devices) -> Mesh:
    """1-D scanline mesh over a channel's device group: one live channel's
    frame program runs row-sharded across these devices."""
    return Mesh(list(devices), ("sp",))


def band_bounds(rows: int, n: int) -> list:
    """[(first, last + 1)] of n disjoint runs of ``rows`` rows, equal where
    n divides rows (else the later runs one row longer)."""
    return [(rows * k // n, rows * (k + 1) // n) for k in range(n)]


def host_copy(x) -> Optional[np.ndarray]:
    """A host numpy copy of a small leaf (a matrix): numpy as it is, a
    tensor's ``host`` attribute where its maker left one
    (runtime/mixer.py ``Mixer.matrix_on``), a CPU tensor's values, else a
    copy from the device (a host wait)."""
    if x is None:
        return None
    if isinstance(x, Sharded):
        return host_copy(x.shards[0].tensor) if x.host is None else x.host
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        host = getattr(x, "host", None)
        return host if host is not None else x.detach().cpu().numpy()
    return np.asarray(x)


class Shard(NamedTuple):
    """One band's piece of a leaf: its device, its first row along the
    leaf's rows axis (0 for a replicated leaf), the tensor, and for a
    stacked leaf the first channel it holds."""

    device: torch.device
    row0: int
    tensor: torch.Tensor
    ch0: int = 0


class Sharded:
    """A leaf laid out over a mesh: one ``Shard`` a band (mesh position).
    ``axis`` is the rows axis (None: replicated, each shard the whole
    leaf), ``ch_axis`` 0 for a stacked (n_ch, ...) leaf split over the
    mesh's 'ch' axis.  ``host`` holds a replicated leaf's host copy (what
    the band executor works windows out from).  ``whole`` is the tensor
    the shards were cut from where every one of them is a view of it (a
    leaf sharded over a group that names its device for every band)."""

    def __init__(self, shards: Sequence[Shard], shape: tuple, axis: Optional[int], mesh: Mesh,
                 ch_axis: Optional[int] = None, host: Optional[np.ndarray] = None,
                 whole: Optional[torch.Tensor] = None):
        self.whole = whole
        self.shards = tuple(shards)
        self.shape = tuple(shape)
        self.axis = axis
        self.ch_axis = ch_axis
        self.mesh = mesh
        self.host = host

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def index(self, i: int) -> tuple:
        """Shard i's place in the whole leaf, a slice a dimension (JAX's
        ``addressable_shards[i].index``, with every bound explicit)."""
        sh = self.shards[i]
        out = []
        for d, size in enumerate(self.shape):
            if d == self.axis:
                out.append(slice(sh.row0, sh.row0 + sh.tensor.shape[d]))
            elif d == self.ch_axis:
                out.append(slice(sh.ch0, sh.ch0 + sh.tensor.shape[d]))
            else:
                out.append(slice(0, size))
        return tuple(out)

    def on(self, device) -> torch.Tensor:
        """A replicated leaf on ``device`` (its shard there, else copied)."""
        device = torch.device(device)
        for sh in self.shards:
            if sh.device == device:
                return sh.tensor
        return self.shards[0].tensor.to(device, non_blocking=True)

    def rows(self, lo: int, hi: int, device) -> torch.Tensor:
        """Rows [lo, hi) along the rows axis on ``device``: a view of the
        shard that holds them there (of ``whole``, where every shard is a
        view of it on ``device``: one card's bands need no copies), else
        the pieces copied from the shards that hold them (device to
        device, no host wait) and joined.  A replicated leaf gives its
        rows from the shard on ``device``."""
        device = torch.device(device)
        if self.axis is None:
            return self.on(device)
        if self.whole is not None and self.whole.device == device:
            return self.whole.narrow(self.axis, lo, hi - lo)
        pieces, seen = [], set()
        for sh in sorted(self.shards, key=lambda s: (s.row0, s.device != device)):
            n = sh.tensor.shape[self.axis]
            a, b = max(lo, sh.row0), min(hi, sh.row0 + n)
            if a >= b or (sh.row0, sh.ch0) in seen:
                continue
            seen.add((sh.row0, sh.ch0))
            pieces.append(sh.tensor.narrow(self.axis, a - sh.row0, b - a).to(device, non_blocking=True))
        if not pieces or sum(p.shape[self.axis] for p in pieces) != hi - lo:
            raise ValueError(f"rows [{lo}, {hi}) of a leaf of shape {self.shape}: not held")
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=self.axis)

    def gather(self, device) -> torch.Tensor:
        """The whole leaf on ``device``."""
        if self.ch_axis is not None:
            return torch.stack([_channel_view(self, c).gather(device) for c in range(self.shape[0])])
        return self.rows(0, self.shape[self.axis], device) if self.axis is not None else self.on(device)

    def __repr__(self) -> str:
        return f"Sharded(shape={self.shape}, axis={self.axis}, bands={len(self.shards)})"


def _leaf_axis(key: str, ndim: int, in_list: bool, in_ring: bool) -> Optional[int]:
    """The rows axis of one channel's leaf under scanline sharding, by
    param name (JAX ``_sp_pspec``): None (replicated) for the replicated
    keys and leaves of at most one dimension; a ring frame's or a bare
    (C, H, W) frame's axis 1; a packed plane's axis 0."""
    if key in _REPLICATED_KEYS or ndim <= 1:
        return None
    if in_ring or (not in_list and ndim >= 3):
        return 1
    return 0


def _as_tensor(x) -> torch.Tensor:
    """A leaf as a tensor: numpy as the port carries it (graph/convert.py
    to_tensor: v210 words as int32, float64 as float32), on the host."""
    return to_tensor(x, "cpu") if isinstance(x, np.ndarray) else torch.as_tensor(x)


def _replicated(x, devices: list, mesh: Mesh, ch: Optional[int] = None) -> Sharded:
    host = x if isinstance(x, np.ndarray) else None
    t = _as_tensor(x)
    if host is None and isinstance(x, torch.Tensor):
        host = getattr(x, "host", None)
        if host is None and x.device.type == "cpu":
            host = x.numpy()
    copies = {}
    shards = []
    for d in devices:
        if d not in copies:
            copies[d] = t.to(d, non_blocking=True)
        shards.append(Shard(d, 0, copies[d]))
    return Sharded(shards, tuple(t.shape), None, mesh, host=host)


def _split(x, axis: int, devices: list, mesh: Mesh) -> Sharded:
    if isinstance(x, Sharded):  # a reshard: each band's rows from the bands that hold them
        shards = [Shard(d, r0, x.rows(r0, r1, d)) for d, (r0, r1)
                  in zip(devices, band_bounds(x.shape[axis], len(devices)))]
        whole = x.whole if x.whole is not None and all(d == x.whole.device for d in devices) else None
        return Sharded(shards, x.shape, axis, mesh, whole=whole)
    t = _as_tensor(x)
    shards = [Shard(d, r0, t.narrow(axis, r0, r1 - r0).to(d, non_blocking=True))
              for d, (r0, r1) in zip(devices, band_bounds(t.shape[axis], len(devices)))]
    whole = t if all(d == t.device for d in devices) else None
    return Sharded(shards, tuple(t.shape), axis, mesh, whole=whole)


def _map_leaves(x, leaf, key: str = "", in_list: bool = False, in_ring: bool = False):
    """``leaf(value, key, in_list, in_ring)`` over every leaf of a params
    tree, ``key`` the leaf's param name (its nearest dict key), ``in_list``
    for a packed plane of a plane list, ``in_ring`` for a frame of a
    3-frame ring."""
    if isinstance(x, dict):
        return {k: _map_leaves(v, leaf, k) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        ring = key in _RING_KEYS
        return type(x)(_map_leaves(v, leaf, key, isinstance(x, list) and not ring, ring) for v in x)
    return leaf(x, key, in_list, in_ring)


def shard_params_sp(params, mesh: Mesh):
    """One channel's params with scanline (row) sharding over a 1-D 'sp'
    mesh (JAX ``shard_params_sp``): every array leaf becomes a ``Sharded``
    chosen by its param name (``_leaf_axis``), numpy leaves on the host
    uploaded (numpy scalars too).  A leaf already sharded over ``mesh``
    passes through; one sharded over another mesh is resharded band to
    band (the cross-mesh ROUTE); a gathered leaf a non-sp channel needs is
    ``Sharded.gather``.  Python scalars pass through."""
    devices = mesh.flat

    def put(x, key: str, in_list: bool, in_ring: bool):
        if isinstance(x, Sharded):
            if x.mesh == mesh:
                return x
            if x.axis is not None:
                return _split(x, x.axis, devices, mesh)
            out = _replicated(x.shards[0].tensor, devices, mesh)
            out.host = x.host
            return out
        if isinstance(x, np.generic):
            x = np.asarray(x)
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        axis = _leaf_axis(key, x.ndim, in_list, in_ring)
        return _replicated(x, devices, mesh) if axis is None else _split(x, axis, devices, mesh)

    return _map_leaves(params, put)


def shard_channel_params(params, mesh: Mesh):
    """A stacked multi-channel params tree (every leaf (n_ch, ...)) over a
    (ch, sp) mesh (JAX ``shard_channel_params``): the leading axis over
    the 'ch' rows of the mesh, n_ch / ch channels a row, and each
    channel's rows over its row's 'sp' devices (the rows axis one further
    in than ``shard_params_sp``'s); replicated keys and (n_ch,) leaves are
    split over 'ch' only."""
    ch, sp = mesh.devices.shape

    def put(x, key: str, in_list: bool, in_ring: bool):
        if isinstance(x, np.generic):
            x = np.asarray(x)
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        t = _as_tensor(x)
        n_ch = t.shape[0]
        if n_ch % ch:
            raise ValueError(f"{n_ch} stacked channels over a mesh of {ch} channel rows")
        per = n_ch // ch
        axis = _leaf_axis(key, t.ndim - 1, in_list, in_ring)
        axis = None if axis is None else axis + 1
        host = x if isinstance(x, np.ndarray) and axis is None else None
        shards = []
        for r in range(ch):
            rows = t.narrow(0, r * per, per)
            bounds = band_bounds(t.shape[axis], sp) if axis is not None else [(0, None)] * sp
            for d, (r0, r1) in zip(mesh.devices[r], bounds):
                piece = rows if axis is None else rows.narrow(axis, r0, r1 - r0)
                shards.append(Shard(d, r0, piece.to(d, non_blocking=True), r * per))
        return Sharded(shards, tuple(t.shape), axis, mesh, ch_axis=0, host=host)

    return _map_leaves(params, put)


def _channel_view(x, c: int):
    """Channel c of a stacked tree from ``shard_channel_params``: each leaf
    the ``Sharded`` of that channel's shards (on its mesh row), the
    channel axis dropped."""
    if isinstance(x, dict):
        return {k: _channel_view(v, c) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_channel_view(v, c) for v in x)
    if not isinstance(x, Sharded) or x.ch_axis is None:
        return x
    ch, sp = x.mesh.devices.shape
    row = c // (x.shape[0] // ch)  # shards are laid out a mesh row at a time
    shards = [Shard(sh.device, sh.row0, sh.tensor[c - sh.ch0]) for sh in x.shards[row * sp:(row + 1) * sp]]
    host = None if x.host is None else x.host[c]
    return Sharded(shards, x.shape[1:], None if x.axis is None else x.axis - 1, x.mesh.row(row), host=host)


def make_multi_channel_program(spec, mesh: Mesh, plain: bool = False):
    """The port's form of the JAX package's vmapped program: fn(stacked)
    over a ``shard_channel_params`` tree -> the stacked outputs, each
    channel run on its row of the mesh, row-sharded over that row's 'sp'
    devices (parallel/bands.py ``make_sp_channel_program``), its planes
    gathered and stacked on the mesh's first device."""
    from .bands import make_sp_channel_program

    ch = mesh.devices.shape[0]
    programs = [make_sp_channel_program(spec, mesh.row(r), plain) for r in range(ch)]
    first = mesh.flat[0]

    def step(stacked):
        n_ch = _stack_size(stacked)
        per = n_ch // ch
        outs = [programs[c // per](_channel_view(stacked, c)) for c in range(n_ch)]
        stack = lambda ts: torch.stack([t.to(first, non_blocking=True) for t in ts])
        if isinstance(outs[0], dict):
            return {"packed": [stack(p) for p in zip(*(o["packed"] for o in outs))],
                    "rgba": stack([o["rgba"] for o in outs])}
        return [stack(p) for p in zip(*outs)]

    step.programs = programs
    return step


def _stack_size(x) -> int:
    if isinstance(x, dict):
        for v in x.values():
            n = _stack_size(v)
            if n:
                return n
    elif isinstance(x, (list, tuple)):
        for v in x:
            n = _stack_size(v)
            if n:
                return n
    elif isinstance(x, Sharded):
        return x.shape[0]
    return 0

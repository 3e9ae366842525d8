"""One CUDA graph a warm structure: a channel-tick's staged frame program
as one replay, its sources and outputs rebound by address.

A single-device channel on the card captures a structure once, on the
worker thread that runs the structure's first frame
(runtime/channel.py ``Channel._dispatch_cold``: ``graphs.capture`` after
the eager frame), into a ``torch.cuda.CUDAGraph`` with its own memory
pool, keyed by (spec, device, stream): the channels of one structure that
tick on one stream share it, as their replays run one after another
there.  Its warm ticks on the event loop (``Channel._dispatch``:
``graphs.run``) rebind and launch it; the loop never captures and never
waits for a capture.

Rebind, never copy.  The capture runs on copies of the tick's tensors
(the params' leaves: source planes, ``mix``, ``matrix``, ``matrix_b``,
yadif rings and parity), each with its layout and its address mod 512,
laid out in one allocation with ``GUARD`` bytes free around each
(``_copies``).  The runner records the address and extent of each copy
and of each tensor the program hands out (the packed planes; no block is
reused inside a capture, ``KeepAlive``, so an address names one tensor)
and finds each node whose parameters hold one of them (``find_patches``:
every 8-byte word of a kernel's parameter bytes that is an address the
host took from a tensor during the capture, ``data_ptr``, so pointers
inside by-value structs too, at any offset into their tensor; a word
that merely lies in a tensor's range is data, such as a float beside a
struct's uninitialised padding).  A warm tick then allocates fresh output planes on the current
stream, as an eager tick does, writes its own addresses into those words
(csrc/graph_rebind.cu ``phn_graph_rebind``:
cudaGraphExecKernelNodeSetParams on the executable graph) and launches the
graph.  No plane is copied: the card runs the same kernels in the same
order on the same data, and each output is a fresh allocation its
consumers own.  CUDA applies an update to later launches only.

Where rebinding is sound, as the capture shows it:

- only the staged route is captured (``program.staged``, route 3 of
  graph/pipeline.py); the fused v210 program and a whole-stack packed
  composite make the frame in one or two launches and run as they are,
  uncounted, as do row-sharded channels, ``plain=True`` and the CPU,
  which never come here;
- a structure replays only if every node that holds an input or output
  address is one of the port's own kernels (its function among the
  entries of the kernel library's build log, ``own_kernels``), no node
  copies from host memory, every input whose address the host takes
  (``data_ptr``) is held by some node and every output written by one;
- then one replay at the first frame's own addresses, into outputs and
  over copies filled with a pseudo-random pattern (``_poison``), must
  equal the eager first frame byte for byte: an address the rebinding
  misses (one a C entry derives from a taken one, or a stale one) reads
  the pattern, an output byte it misses keeps it, and a word rebound that
  was not an address changes the frame;
- a torch op on a tick's tensor (``mix_frames`` of a dissolve without
  DVE, the combine over an ``rgba_f32`` slot without DVE, an RGB output's
  torch pack, ``emit_rgba``'s frame), a refusal above or a capture that
  fails leaves the structure eager, and each of its ticks counts as eager;
- a tick whose params differ from the captured ones in layout (a shape, a
  type, a stride, a scalar) runs eager, counted as the structure's; one
  whose address differs from the captured one in alignment mod 16 runs
  eager, counted on its own: the unpacks and packs choose their 16-byte
  paths from the addresses they are launched with.

Counters on the tracer (utils/metrics.py): ``program.graph_captures``,
``program.graph_replays``, ``program.graph_eager_ticks.structure`` and
``program.graph_eager_ticks.alignment``; the span ``program.replay`` times a
tick's rebind and launch.  The launches a capture records
(ops/kernels.py ``recording``: nothing runs) are added to the kernel
wrappers' ``launches`` counters at each replay, so each still counts the
launches the card ran.  ``refusals`` keeps why each eager structure stays
eager.

Captures take ``capture_lock``, which a structure's first frame
(``Channel._dispatch_cold``) and a prewarm's ``prepare`` also hold, so no
two captures share the capture stream and no other worker thread's frame
program enqueues during one.  A capture runs on a side stream in CUDA's
relaxed mode: the event loop's warm ticks allocate and launch on their own
stream meanwhile; only a device-wide synchronize is not allowed while any
stream captures, and the port makes none (threads wait for their own
stream).
"""

from __future__ import annotations

import ctypes
import re
import struct
import threading
from bisect import bisect_right
from collections import OrderedDict
from functools import lru_cache
from typing import Callable, NamedTuple

import torch
from torch.overrides import TorchFunctionMode

from ..ops import _build, kernels
from ..utils.metrics import tracer

__all__ = [
    "ALIGN",
    "GUARD",
    "MAX_GRAPHS",
    "Node",
    "Patch",
    "Refused",
    "KeepAlive",
    "find_patches",
    "substitute",
    "tick_leaves",
    "with_tensors",
    "flatten_out",
    "own_kernels",
    "CudaGraphs",
    "GraphRunner",
    "capture_lock",
    "graphs",
]

ALIGN = 16  # the alignment class a rebound address keeps
GUARD = 4096  # bytes free around each input's capture copy: a pointer derived from one lands in no other
MAX_GRAPHS = 16  # captured structures kept, least recently ticked dropped first
PARAM_BYTES = 32768  # a kernel's parameters fit in 32 KB (CUDA 12.1)
MAX_PARAMS = 256

capture_lock = threading.RLock()

_WORD = struct.Struct("<Q")
# CUgraphNodeType -> kind; a node of a kind not listed is "other"
_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 5: "empty", 6: "event", 7: "event"}


class Node(NamedTuple):
    """One node of a captured graph: ``kind`` 'kernel', 'memcpy',
    'memcpy_from_host', 'memset', 'empty', 'event' or 'other'; a kernel's
    function ``name``; ``params`` a kernel's parameter bytes as the kernel
    receives them (a copy's or a fill's addresses as 8-byte words) and
    ``offsets`` where each kernel parameter begins."""

    kind: str
    name: str
    params: bytes
    offsets: tuple = ()


class Patch(NamedTuple):
    """An address to rebind: the 8-byte word at ``offset`` of node
    ``node``'s parameters holds leaf ``leaf``'s address plus ``delta``."""

    node: int
    offset: int
    leaf: int
    delta: int


class Refused(Exception):
    """A structure that cannot replay, and why."""


def find_patches(nodes: list, leaves: list, n_ins: int, own: frozenset, taken=None) -> list:
    """The words of ``nodes`` to rebind for ``leaves``, (address, bytes) of
    each tensor a tick brings in (the first ``n_ins``) and hands out.
    ``taken`` holds the addresses the host took from tensors during the
    capture (``KeepAlive.taken``: every pointer a port wrapper passes to
    its kernel, directly or in a by-value struct its C entry fills), or is
    None (unknown: every word counts).  An 8-byte word of a node's
    parameters holds a leaf when it lies in the leaf's [address, address +
    bytes) and is a taken address or the leaf's own: any other word there
    is data (a float beside a struct's padding can read as an address)
    and stays.  Raises Refused where rebinding is not sound: two leaves
    overlap; a node that holds a leaf is not a kernel in ``own``; a node
    copies from host memory or is of a kind that may hide work; an input
    with bytes is held by no node while the host took an address in it
    (or ``taken`` is None): its address reaches the card another way; an
    output is written by none of the nodes.  An input held by no node
    whose address the host never took is one the structure does not read
    (``matrix_b`` of a pair that shares one matrix).  A pointer a C entry
    derives from a taken one stays the capture's: the runner's check at
    capture finds it (module docstring)."""
    spans = sorted((a, a + n, i) for i, (a, n) in enumerate(leaves) if n > 0)
    for (_, a1, i), (b0, _, j) in zip(spans, spans[1:]):
        if b0 < a1:
            raise Refused(f"tensors {i} and {j} of the tick overlap")
    starts = [s[0] for s in spans]
    known = None if taken is None else set(taken) | set(starts)
    patches, found = [], set()
    for k, node in enumerate(nodes):
        if node.kind in ("memcpy_from_host", "other"):
            raise Refused(f"node {k} is a {node.kind} node")
        usable = len(node.params) - len(node.params) % 8
        for w, (v,) in enumerate(_WORD.iter_unpack(node.params[:usable])):
            s = bisect_right(starts, v) - 1
            if s < 0 or v >= spans[s][1] or (known is not None and v not in known):
                continue
            leaf = spans[s][2]
            if node.kind != "kernel" or node.name not in own:
                what = "input" if leaf < n_ins else "output"
                raise Refused(f"{node.name or node.kind} (node {k}) holds the address of {what} {leaf}")
            patches.append(Patch(k, 8 * w, leaf, v - spans[s][0]))
            found.add(leaf)
    for i, (a, n) in enumerate(leaves):
        if n > 0 and i not in found:
            if i >= n_ins:
                raise Refused(f"output {i - n_ins} is written by none of the port's kernels")
            if taken is None or any(a <= v < a + n for v in taken):
                raise Refused(f"input {i} is held by no node, yet its address was taken: it would reach "
                              "the card another way")
    return patches


def substitute(buf, patches, bases: list) -> None:
    """Write each patch's new address, ``bases[leaf] + delta``, into the
    parameter bytes ``buf`` (a writable buffer) of its node."""
    for p in patches:
        _WORD.pack_into(buf, p.offset, bases[p.leaf] + p.delta)


def _extent(t: torch.Tensor) -> int:
    """The bytes from a tensor's address to just past its last element."""
    if t.numel() == 0:
        return 0
    return (1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))) * t.element_size()


def tick_leaves(params: dict) -> tuple:
    """(tensors, layout) of a tick's params: its tensors in a fixed order
    (layer by layer, keys sorted, lists in order) and everything else a
    capture fixes (keys, shapes, types, strides, lengths, scalars)."""
    tensors, layout = [], []

    def walk(v) -> None:
        if isinstance(v, torch.Tensor):
            tensors.append(v)
            layout.append((v.shape, v.dtype, v.stride()))
        elif isinstance(v, (list, tuple)):
            layout.append(len(v))
            for x in v:
                walk(x)
        else:
            layout.append(v)

    for lp in params["layers"]:
        for key in sorted(lp):
            layout.append(key)
            walk(lp[key])
    return tensors, tuple(layout)


def with_tensors(params: dict, tensors: list) -> dict:
    """``params`` with its tensors replaced by ``tensors``, in
    ``tick_leaves`` order."""
    it = iter(tensors)

    def put(v):
        if isinstance(v, torch.Tensor):
            return next(it)
        if isinstance(v, (list, tuple)):
            return type(v)(put(x) for x in v)
        return v

    return {"layers": [{k: put(lp[k]) for k in sorted(lp)} for lp in params["layers"]]}


def _copies(tensors: list, device: torch.device) -> tuple:
    """(arena, copies): for each tensor with bytes a copy of its shape,
    type, strides and bytes whose address agrees with it mod 512, all
    in the one allocation ``arena``, each ``GUARD`` bytes or more from the
    next and from the arena's ends; an empty tensor is its own copy."""
    sizes = [_extent(t) for t in tensors]
    arena = torch.empty(GUARD + sum(n + 511 + GUARD for n in sizes if n), dtype=torch.uint8, device=device)
    base, at, copies = arena.data_ptr(), GUARD, []
    for t, n in zip(tensors, sizes):
        if not n:
            copies.append(t)
            continue
        at += (t.data_ptr() - base - at) % 512
        copy = arena[at:at + n].view(t.dtype).as_strided(t.shape, t.stride())
        copies.append(copy.copy_(t))
        at += n + GUARD
    return arena, copies


def _poison(t: torch.Tensor) -> None:
    """Fill a contiguous tensor's bytes with a fixed pseudo-random pattern."""
    gen = torch.Generator(device=t.device)
    gen.manual_seed(0x5EED)
    t.reshape(-1).view(torch.uint8).random_(0, 256, generator=gen)


def _bytes_differ(got: list, want: list) -> list:
    """(output, bytes that differ) of each output whose bytes are not
    ``want``'s."""
    differ = []
    for i, (g, w) in enumerate(zip(got, want)):
        a, b = g.reshape(-1).view(torch.uint8), w.contiguous().reshape(-1).view(torch.uint8)
        if a.shape != b.shape:
            differ.append((i, "shape"))
        elif not torch.equal(a, b):
            differ.append((i, int((a != b).sum())))
    return differ


@lru_cache(maxsize=None)
def own_kernels() -> frozenset:
    """The entry functions of the port's kernel library, as its build log
    (ptxas -v) names them."""
    return frozenset(re.findall(r"Compiling entry function '([^']+)'", _build.build_info().log))


class KeepAlive(TorchFunctionMode):
    """Every tensor a torch function returns while this mode is on stays
    alive until the mode is dropped, and each address ``data_ptr()``
    gives is kept in ``taken`` (find_patches).  Around a capture, no buffer the
    program frees is handed out again inside it, so an address a port
    kernel holds names one tensor (the wrappers allocate every buffer their
    kernels write with ``torch.empty``): without it an output plane may
    take the block an earlier intermediate used, and the nodes that used
    the intermediate would seem to hold the output.  A temporary inside one
    torch op is not seen; if an output reuses it, a torch node seems to
    hold the output and the structure stays eager.  (A function mode: the
    first dispatch mode of a process imports torch._dynamo, seconds.)"""

    def __init__(self):
        super().__init__()
        self.kept: list = []
        self.taken: list = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.Tensor.data_ptr:
            self.taken.append(out)
        else:
            self.kept.append(out)
        return out


def flatten_out(out) -> tuple:
    """(tensors, rebuild) of a frame program's result: its packed planes,
    and under ``emit_rgba`` the frame after them."""
    if isinstance(out, dict):
        n = len(out["packed"])
        return list(out["packed"]) + [out["rgba"]], lambda ts: {"packed": ts[:n], "rgba": ts[n]}
    return list(out), list


# ------------------------------------------------------------ the CUDA side


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA driver error {rc}")


class _CudaRebind:
    """The rebind of one captured graph: each patched node's parameter
    bytes, which ``GraphRunner`` writes a tick's addresses into, and
    ``launch``."""

    def __init__(self, graph, items: list):
        n = len(items)
        self.graph = graph  # holds the nodes, the exec and the pool the exec runs in
        self.exec = ctypes.c_void_p(graph.raw_cuda_graph_exec())
        self.buffers = [ctypes.create_string_buffer(params, len(params)) for _, params, _ in items]
        self._offsets = [(ctypes.c_ulonglong * max(len(o), 1))(*o) for _, _, o in items]
        self.nodes = (ctypes.c_void_p * n)(*[h for h, _, _ in items])
        self.params = (ctypes.c_void_p * n)(*[ctypes.addressof(b) for b in self.buffers])
        self.offsets = (ctypes.c_void_p * n)(*[ctypes.addressof(o) for o in self._offsets])
        self.counts = (ctypes.c_ulonglong * n)(*[len(o) for _, _, o in items])
        self.n = n

    def launch(self, stream: int) -> None:
        _check(_build.library().phn_graph_rebind(self.exec, self.nodes, self.params, self.offsets, self.counts,
                                                 self.n, ctypes.c_void_p(stream)), "graph rebind")


class CudaGraphs:
    """Capture with PyTorch (``torch.cuda.CUDAGraph(keep_graph=True)``, a
    relaxed capture on a side stream), list and rebind nodes through the
    kernel library (csrc/graph_rebind.cu)."""

    def __init__(self):
        self._side: dict = {}  # device -> its capture stream

    def stream_id(self, device: torch.device) -> int:
        return torch.cuda.current_stream(device).cuda_stream

    def capture(self, program: Callable, params: dict, device: torch.device) -> tuple:
        """(graph, ``program(params)``) with the program's work captured,
        not run."""
        side = self._side.get(device)
        if side is None:
            side = self._side[device] = torch.cuda.Stream(device)
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.device(device), torch.cuda.stream(side):
            g.capture_begin(capture_error_mode="relaxed")
            try:
                out = program(params)
            except BaseException:
                self._abandon(g, device)
                raise
            g.capture_end()
        g.instantiate()
        return g, out

    @staticmethod
    def _abandon(g, device: torch.device) -> None:
        """End a capture that failed and give back its pool (an invalidated
        capture's end raises before the allocator stops routing to it)."""
        try:
            g.capture_end()
            return
        except Exception:
            pass
        for release in (torch._C._cuda_endAllocateToPool, torch._C._cuda_releasePool):
            try:
                release(device.index, g.pool())
            except Exception:
                pass

    def nodes(self, g) -> list:
        """[(node handle, Node)] of a captured graph."""
        lib = _build.library()
        graph = ctypes.c_void_p(g.raw_cuda_graph())
        count = ctypes.c_size_t(0)
        _check(lib.phn_graph_nodes(graph, None, ctypes.byref(count)), "graph nodes")
        handles = (ctypes.c_void_p * count.value)()
        _check(lib.phn_graph_nodes(graph, handles, ctypes.byref(count)), "graph nodes")
        buf = ctypes.create_string_buffer(PARAM_BYTES)
        offsets = (ctypes.c_ulonglong * MAX_PARAMS)()
        kind, name, size = ctypes.c_int(), ctypes.c_char_p(), ctypes.c_size_t()
        n, from_host = ctypes.c_size_t(), ctypes.c_int()
        out = []
        for h in handles[:count.value]:
            ctypes.memset(buf, 0, PARAM_BYTES)
            _check(lib.phn_graph_node(h, ctypes.byref(kind), ctypes.byref(name), buf, PARAM_BYTES,
                                      ctypes.byref(size), offsets, MAX_PARAMS, ctypes.byref(n),
                                      ctypes.byref(from_host)), "graph node")
            k = _KINDS.get(kind.value, "other")
            if k == "memcpy" and from_host.value:
                k = "memcpy_from_host"
            out.append((h, Node(k, (name.value or b"").decode(), buf.raw[:size.value],
                                tuple(offsets[:n.value]))))
        return out

    def own_kernels(self) -> frozenset:
        return own_kernels()

    def rebinder(self, g, items: list) -> _CudaRebind:
        """The rebind of ``items`` [(node handle, parameter bytes, offsets)]."""
        return _CudaRebind(g, items)


# ------------------------------------------------------------ the runner


class _Graph(NamedTuple):
    """A captured structure ready to replay."""

    handle: object
    layout: tuple
    aligns: tuple  # each input's address mod ALIGN at capture
    outs: tuple  # (shape, stride, dtype) of each output
    rebuild: Callable
    rebind: object  # the backend's rebind: .buffers, .launch()
    patches: tuple  # per rebound node: its patches
    launches: tuple  # (wrapper, launches a replay)


_BYPASS = "bypass"  # not the staged route: runs as it is, uncounted
_EAGER = "eager"  # cannot replay: runs eager, each tick counted


class GraphRunner:
    """Single-device channels on the card: a structure's capture after its
    first frame, then its warm ticks replayed, or run eager and counted
    (module docstring)."""

    def __init__(self, backend=None):
        self.backend = backend if backend is not None else CudaGraphs()
        self._graphs: OrderedDict = OrderedDict()
        self.refusals: dict = {}  # spec -> why it stays eager

    def _key(self, spec, device: torch.device) -> tuple:
        return spec, device, self.backend.stream_id(device)

    def holds(self, spec, device: torch.device) -> bool:
        """True while the structure's capture, on this thread's stream, is
        kept: replayed, eager or bypassed.  (A structure dropped for
        ``MAX_GRAPHS`` is captured again by its next first frame.)"""
        return self._key(spec, device) in self._graphs

    def capture(self, spec, program: Callable, params: dict, device: torch.device, out) -> None:
        """After a structure's eager first frame ``out = program(params)``:
        capture it for its warm ticks, or find why it cannot replay.  Runs
        once a (structure, device, stream), under ``capture_lock``."""
        key = self._key(spec, device)
        with capture_lock:
            if key in self._graphs:
                return
            if not program.staged(params):
                g = _BYPASS
            else:
                try:
                    g = self._capture(program, params, device, out)
                    self.refusals.pop(spec, None)
                except Exception as why:  # Refused, or the CUDA driver could not list or rebind the graph
                    self.refusals[spec] = f"{type(why).__name__}: {why}"
                    g = _EAGER
            self._graphs[key] = g
            while len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)

    def run(self, spec, program: Callable, params: dict, device: torch.device):
        """``program(params)``, replayed where its structure's capture allows."""
        key = self._key(spec, device)
        g = self._graphs.get(key)
        if g is _BYPASS:
            return program(params)
        if g is None or g is _EAGER:
            tracer.count("program.graph_eager_ticks.structure")
            return program(params)
        try:
            self._graphs.move_to_end(key)
        except KeyError:  # dropped meanwhile by a capture on a worker thread
            pass
        tensors, layout = tick_leaves(params)
        if layout != g.layout:
            tracer.count("program.graph_eager_ticks.structure")
            return program(params)
        ptrs = [t.data_ptr() for t in tensors]
        if any(p % ALIGN != a for p, a in zip(ptrs, g.aligns)):
            tracer.count("program.graph_eager_ticks.alignment")
            return program(params)
        with tracer.span("program.replay"):
            outs = self._launch(g, ptrs, device, key[2])
        tracer.count("program.graph_replays")
        return g.rebuild(outs)

    @staticmethod
    def _launch(g: _Graph, ptrs: list, device: torch.device, stream: int, fill: Callable | None = None) -> list:
        """Fresh outputs, the graph rebound to them and to ``ptrs``, one
        launch on ``stream``."""
        outs = [torch.empty_strided(shape, stride, dtype=dtype, device=device) for shape, stride, dtype in g.outs]
        if fill is not None:
            for o in outs:
                fill(o)
        bases = ptrs + [o.data_ptr() for o in outs]
        for buf, patches in zip(g.rebind.buffers, g.patches):
            substitute(buf, patches, bases)
        g.rebind.launch(stream)
        for w, n in g.launches:
            w.launches += n
        return outs

    def _capture(self, program: Callable, params: dict, device: torch.device, out) -> _Graph:
        tensors, layout = tick_leaves(params)
        arena, copies = _copies(tensors, device)
        with kernels.recording() as launched, KeepAlive() as keep:
            try:
                handle, captured = self.backend.capture(program, with_tensors(params, copies), device)
            except Exception as err:
                raise Refused(f"the capture failed ({type(err).__name__}: {err})") from err
        outs, rebuild = flatten_out(captured)
        if any(not o.is_contiguous() for o in outs):
            raise Refused("an output is not contiguous")
        leaves = [(t.data_ptr(), _extent(t)) for t in copies + outs]
        listed = self.backend.nodes(handle)
        patches = find_patches([n for _, n in listed], leaves, len(copies), self.backend.own_kernels(), keep.taken)
        by_node: dict = {}
        for p in patches:
            by_node.setdefault(p.node, []).append(p)
        items = [(listed[k][0], listed[k][1].params, listed[k][1].offsets) for k in by_node]
        g = _Graph(
            handle, layout, tuple(t.data_ptr() % ALIGN for t in tensors),
            tuple((tuple(o.shape), o.stride(), o.dtype) for o in outs), rebuild,
            self.backend.rebinder(handle, items), tuple(tuple(v) for v in by_node.values()),
            tuple(launched.items()),
        )
        # the first frame again, replayed over poisoned copies into poisoned outputs
        _poison(arena)
        got = self._launch(g, [t.data_ptr() for t in tensors], device, self.backend.stream_id(device), _poison)
        differ = _bytes_differ(got, flatten_out(out)[0])
        if differ:
            raise Refused(f"the first frame replayed differs from it eager (output, bytes): {differ}")
        tracer.count("program.graph_captures")
        return g


graphs = GraphRunner()

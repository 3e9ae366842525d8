"""Faults planted in the timed path underneath a run, each of which the
comparison has to find: ``correct`` comes out false.

    with planted("mix_frozen"):
        run, bank, plan = asyncio.run(run_cell(...))

The CPU tests plant each at a tiny geometry; ``calibrate --faults``
reads them on the card at the cell's own size.
"""

from __future__ import annotations

import contextlib

__all__ = ["FAULTS", "planted"]


def _stale(real):
    """A frame program that hands back its previous tick's output."""
    last = {}

    def dispatch(self, spec, contribs):
        out = real(self, spec, contribs)
        prev = last.get(self.chan_id, out)
        last[self.chan_id] = out
        return prev

    return dispatch


def _half(real):
    """Every second layer left out of the composite."""
    def dispatch(self, spec, contribs):
        keep = contribs[::2]
        return real(self, spec._replace(layers=tuple(c.spec for c in keep)), keep)

    return dispatch


def _altered(real):
    """One row of each tick's output set to a wrong code where it is made."""
    def dispatch(self, spec, contribs):
        packed, rgba = real(self, spec, contribs)
        packed = [p.clone() for p in packed]
        packed[0][packed[0].shape[0] // 2] = 0
        return packed, rgba

    return dispatch


def _frozen(real):
    """A dissolve whose weight stays at its first tick's: the transition's
    position never advances."""
    def mix(self, weight):
        return real(self, self.__dict__.setdefault("_bench_frozen_mix", weight))

    return mix


def _reversed(real):
    """A dissolve that runs backwards: the two sources' weights swapped."""
    def mix(self, weight):
        return real(self, 1.0 - weight)

    return mix


def _targets():
    from phaneron_tpu_torch.runtime.channel import Channel
    from phaneron_tpu_torch.runtime.layer import Layer

    return {
        "state_unchanged": (Channel, "_dispatch", _stale),
        "half_left_out": (Channel, "_dispatch", _half),
        "answer_altered": (Channel, "_dispatch", _altered),
        "mix_frozen": (Layer, "_mix", _frozen),
        "mix_reversed": (Layer, "_mix", _reversed),
    }


FAULTS = ("state_unchanged", "half_left_out", "answer_altered", "mix_frozen", "mix_reversed")


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` in place, restored on exit."""
    cls, attr, fault = _targets()[name]
    real = cls.__dict__[attr]
    setattr(cls, attr, fault(real))
    try:
        yield
    finally:
        setattr(cls, attr, real)

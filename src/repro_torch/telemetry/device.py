"""Device intervals on the host clock.

A span that brackets device work records one CUDA event where it begins
and one where it ends; recording never synchronises.  The events are
put on the host clock through anchors: synchronise, read the host
clock, record an anchor event on the idle device.  One anchor is taken
when the clock attaches and a closing one when the events are read
(once, after a synchronise), and an event's host time is interpolated
between the two: ``anchor_host + anchor.elapsed_time(event) * scale``,
``scale`` the host seconds per device millisecond between the anchors.
The device's timer and the host's drift apart by some microseconds a
second, which one anchor would let grow over a run.  An anchor event
runs a launch latency (a few microseconds) after its host reading, so
device times read that much early.

Torch is imported when a clock is built, never at module import: the
telemetry plane runs on hosts with no CUDA device.
"""
from __future__ import annotations

from typing import Callable

__all__ = ["DeviceClock"]


class DeviceClock:
    """CUDA timing events tied to a host clock by two anchors."""

    def __init__(self, clock: Callable[[], float]) -> None:
        import torch
        self._cuda = torch.cuda
        self._clock = clock
        self.anchor_host, self.anchor = self._anchor()
        #: host minus device seconds elapsed between the anchors, at the
        #: last ``resolve``
        self.drift_s = 0.0

    def _anchor(self):
        """(host seconds, an event recorded then on the idle device)."""
        event = self._cuda.Event(enable_timing=True)
        event.record()              # creates the CUDA event, off the clock
        self._cuda.synchronize()
        host = self._clock()
        event.record()
        self._cuda.synchronize()
        return host, event

    def mark(self):
        """Record a timing event on the current stream."""
        event = self._cuda.Event(enable_timing=True)
        event.record()
        return event

    def resolve(self, events: list) -> list[float]:
        """The host-clock seconds of recorded ``events``."""
        if not events:
            return []
        self._cuda.synchronize()
        host, closing = self._anchor()
        device_ms = self.anchor.elapsed_time(closing)
        self.drift_s = (host - self.anchor_host) - device_ms / 1e3
        scale = (host - self.anchor_host) / device_ms if device_ms > 0 \
            else 1e-3
        elapsed = self.anchor.elapsed_time
        return [self.anchor_host + elapsed(e) * scale for e in events]

"""Metrics registry — numpy-backed counters, gauges and histograms.

The recording surface mirrors the repo's control-plane discipline:
series values live in flat numpy arrays keyed by an interned series id
(one id per label tuple, e.g. ``(pool, tier, verdict)``), and the HOT
recording APIs are *batch row-ops* —

* ``Counter.inc_rows(sids, by)``    — one ``np.add.at`` per quantum;
* ``Histogram.observe_rows(values, sids)`` — one ``np.searchsorted``
  over the log-spaced bucket edges + one 2-D ``np.add.at`` into the
  per-series count matrix per quantum.

The scalar ``inc()`` / ``observe()`` twins are retained as the parity
oracles (the reference package's telemetry tests pin batch == scalar state
through random sweeps) and are FORBIDDEN inside ``@hot_path`` functions by the
``telemetry-hot-path`` sanitizer pass — the same arrangement the
request lifecycle uses (row-ops hot, scalars as oracles).

Series creation (``series(labels)``) is a cold-path dict lookup with
pow2 array growth; hot paths pre-resolve their ids into lookup arrays
(see ``Telemetry._pool_sids``) so per-quantum work is pure indexing.

Counterpart of ``repro/telemetry/registry.py`` (numpy only; the port
keeps its own copy).
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.core.markers import hot_path

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


def _grown(arr: np.ndarray, n: int) -> np.ndarray:
    """Pow2-grow ``arr``'s leading axis to hold at least ``n`` rows."""
    cap = arr.shape[0]
    while cap < n:
        cap *= 2
    out = np.zeros((cap,) + arr.shape[1:], arr.dtype)
    out[:arr.shape[0]] = arr
    return out


class _Family:
    """One named metric family: label tuples interned to series ids."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: tuple = ()) -> None:
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._index: dict[tuple, int] = {}
        #: sid → label tuple (same order as the value arrays)
        self.series_labels: list[tuple] = []

    def series(self, labels: tuple = ()) -> int:
        """Intern a label tuple → series id (get-or-create).  Cold
        path: hot recorders pre-resolve ids into lookup arrays."""
        labels = tuple(labels)
        sid = self._index.get(labels)
        if sid is None:
            if len(labels) != len(self.label_names):
                raise ValueError(
                    f"{self.name}: expected labels {self.label_names}, "
                    f"got {labels!r}")
            sid = len(self.series_labels)
            self._index[labels] = sid
            self.series_labels.append(labels)
            self._grow(sid + 1)
        return sid

    def _grow(self, n: int) -> None:  # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Family):
    """Monotone counter family (``_total`` by Prometheus convention)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: tuple = ()) -> None:
        super().__init__(name, help, labels)
        self.values = np.zeros(8, np.float64)

    def _grow(self, n: int) -> None:
        if n > self.values.shape[0]:
            self.values = _grown(self.values, n)

    def inc(self, sid: int, by: float = 1.0) -> None:
        """Scalar oracle — one series, one increment."""
        self.values[sid] += by
        self._check(by)

    @hot_path
    def inc_rows(self, sids: np.ndarray, by) -> None:
        """Batch recorder: ``by`` is a scalar or per-row array.  The
        scatter-add runs as one ``bincount`` over the (small, dense)
        sid space — ~10x ``np.add.at`` on 10k-row quanta."""
        self._check(by)
        sids = np.asarray(sids)
        if sids.size == 0:
            return
        n = self.values.shape[0]
        if np.ndim(by) == 0:
            self.values += float(by) * np.bincount(sids, minlength=n)
        else:
            self.values += np.bincount(
                sids, weights=np.asarray(by, np.float64), minlength=n)

    def _check(self, by) -> None:
        if np.any(np.asarray(by) < 0):
            raise ValueError(f"{self.name}: counters only go up")

    def read(self, sid: int) -> float:
        return float(self.values[sid])


class Gauge(_Family):
    """Point-in-time value family.  A series is either *set* directly
    or *bound* to a zero-arg callable — callback gauges are how the
    legacy ``pool.stats()`` dict stays a thin view over the registry
    (both read the SAME callables; see ``TokenPool.gauges``)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: tuple = ()) -> None:
        super().__init__(name, help, labels)
        self.values = np.zeros(8, np.float64)
        self._callbacks: dict[int, Callable[[], float]] = {}

    def _grow(self, n: int) -> None:
        if n > self.values.shape[0]:
            self.values = _grown(self.values, n)

    def set(self, sid: int, value: float) -> None:
        self.values[sid] = value

    @hot_path
    def set_rows(self, sids: np.ndarray, values: np.ndarray) -> None:
        self.values[sids] = values

    def bind(self, labels: tuple, fn: Callable[[], float]) -> int:
        """Register a callback series: ``read`` evaluates ``fn``."""
        sid = self.series(labels)
        self._callbacks[sid] = fn
        return sid

    def read(self, sid: int) -> float:
        fn = self._callbacks.get(sid)
        return float(fn()) if fn is not None else float(self.values[sid])


class Histogram(_Family):
    """Log-spaced-bucket histogram family.

    ``edges`` are the bucket UPPER bounds (Prometheus ``le``
    semantics): a value lands in the first bucket whose edge is >= it,
    values beyond ``hi`` land in the implicit +Inf overflow bucket
    (index ``buckets``).  Per-series state is one row of the 2-D count
    matrix plus a sum and a total — everything quantiles, attainment
    ratios and the Prometheus exposition need."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: tuple = (),
                 lo: float = 1e-3, hi: float = 1e3,
                 buckets: int = 36) -> None:
        super().__init__(name, help, labels)
        if not (0 < lo < hi):
            raise ValueError(f"{name}: need 0 < lo < hi")
        self.edges = np.geomspace(lo, hi, buckets)
        self.counts = np.zeros((8, buckets + 1), np.int64)
        self.sums = np.zeros(8, np.float64)
        self.totals = np.zeros(8, np.int64)

    def _grow(self, n: int) -> None:
        if n > self.sums.shape[0]:
            self.counts = _grown(self.counts, n)
            self.sums = _grown(self.sums, n)
            self.totals = _grown(self.totals, n)

    def observe(self, sid: int, value: float) -> None:
        """Scalar oracle — the parity twin of ``observe_rows``."""
        b = int(np.searchsorted(self.edges, value, side="left"))
        self.counts[sid, b] += 1
        self.sums[sid] += value
        self.totals[sid] += 1

    @hot_path
    def observe_rows(self, values: np.ndarray,
                     sids: np.ndarray) -> None:
        """Batch recorder: one ``searchsorted`` + one 2-D ``add.at``
        (plus the sum/total scatters) for the whole quantum."""
        values = np.asarray(values, np.float64)
        b = np.searchsorted(self.edges, values, side="left")
        np.add.at(self.counts, (sids, b), 1)
        np.add.at(self.sums, sids, values)
        np.add.at(self.totals, sids, 1)

    def quantile(self, sid: int, q: float) -> float:
        """Bucket-interpolated quantile (P50/P99 live views).  Returns
        0.0 for an empty series; overflow-bucket hits clamp to the top
        edge (the histogram cannot see past ``hi``)."""
        total = int(self.totals[sid])
        if total == 0:
            return 0.0
        target = q * total
        cum = np.cumsum(self.counts[sid])
        b = int(np.searchsorted(cum, target, side="left"))
        if b >= self.edges.shape[0]:
            return float(self.edges[-1])
        hi = float(self.edges[b])
        lo = float(self.edges[b - 1]) if b > 0 else 0.0
        in_bucket = int(self.counts[sid, b])
        prev = float(cum[b - 1]) if b > 0 else 0.0
        if in_bucket == 0:
            return hi
        frac = min(1.0, max(0.0, (target - prev) / in_bucket))
        return lo + frac * (hi - lo)


class MetricsRegistry:
    """Name → family registry (get-or-create, kind-checked)."""

    def __init__(self) -> None:
        self._families: dict[str, _Family] = {}

    def _get(self, cls, name: str, help: str, labels: tuple,
             **kwargs) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = cls(name, help=help, labels=labels, **kwargs)
            self._families[name] = fam
        elif not isinstance(fam, cls):
            raise TypeError(f"{name} is a {fam.kind}, not {cls.kind}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: tuple = ()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: tuple = ()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: tuple = (),
                  lo: float = 1e-3, hi: float = 1e3,
                  buckets: int = 36) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         lo=lo, hi=hi, buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def families(self) -> Iterator[_Family]:
        for name in sorted(self._families):
            yield self._families[name]

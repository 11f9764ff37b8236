"""Runtime cross-check for the ``retrace-hazard`` pass.

The static pass asserts that kernel call sites shape-bucket their
arrays.  In eager torch nothing is traced; what a retrace stands for —
a new compiled variant, state rebuilt from scratch — is counted by the
port itself: ``kernels/build.py``'s ``BUILD_LOG`` (one entry per
``nvcc`` run of this process) and each resident store's
``full_uploads`` (whole-mirror rebuilds of its device ``ControlState``).
This helper turns those counters into an assertion so tests can
sandwich a churn scenario and prove the static claim holds at
runtime::

    with assert_no_rebuild(gateway.pool.store) as start:
        for _ in range(64):
            gateway.handle_quantum(requests(), now)
    assert start.launched()["admit_quantum"]["rounds"] == 64
"""
from __future__ import annotations

import contextlib
import dataclasses


def route_launches() -> dict[str, dict[str, int]]:
    """Launches so far of each kernel wrapper, by route."""
    from repro_torch.kernels.admit_quantum import admit_scan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention

    return {"admit_quantum": dict(admit_scan.route_launches),
            "flash_attention": dict(flash_attention.route_launches),
            "paged_attention": dict(paged_attention.route_launches)}


@dataclasses.dataclass(frozen=True)
class Counts:
    """The counters at the start of a no-rebuild block."""

    builds: tuple[str, ...]           # kernel libraries built so far
    full_uploads: tuple[int, ...]     # per watched store
    launches: dict[str, dict[str, int]]

    def launched(self) -> dict[str, dict[str, int]]:
        """Launches by kernel and route since the block began."""
        now = route_launches()
        return {k: {r: n - self.launches[k].get(r, 0)
                    for r, n in routes.items()}
                for k, routes in now.items()}


@contextlib.contextmanager
def assert_no_rebuild(*stores):
    """Assert that nothing inside the block built a new kernel variant:
    no kernel library is built (``BUILD_LOG`` gains or replaces no
    entry) and no watched resident store rebuilds its whole device
    mirror (``full_uploads`` does not move).  Yields the starting
    :class:`Counts`, whose ``launched()`` gives the launches by route
    made inside the block."""
    from repro_torch.kernels import build

    builds = dict(build.BUILD_LOG)
    start = Counts(builds=tuple(sorted(builds)),
                   full_uploads=tuple(s.full_uploads for s in stores),
                   launches=route_launches())
    yield start
    built = sorted(n for n, entry in build.BUILD_LOG.items()
                   if builds.get(n) is not entry)
    moved = {i: (before, s.full_uploads) for i, (before, s)
             in enumerate(zip(start.full_uploads, stores))
             if s.full_uploads != before}
    if built or moved:
        raise AssertionError(
            f"rebuilt inside no-rebuild block: kernels built {built}; "
            f"whole-mirror uploads (store: before -> after) {moved}")

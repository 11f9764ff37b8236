"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its
plain PyTorch version; built by ``build`` at first use.

Each kernel's entry point counts its launches in attributes of its own:
``launches`` (an int), ``route_launches`` (ints by route) and, for the
paged kernel, ``windowed_launches``.  :data:`ENTRY_POINTS` lists the
entry points, and :func:`launch_counts`, :func:`launches_between`,
:func:`add_launches` and :func:`set_launch_counts` read and move every
counter at once, so a caller never names a kernel's attributes.
"""
from __future__ import annotations

import importlib

#: kernel → (its wrapper module under this package, its entry point)
ENTRY_POINTS = {
    "admit_quantum": ("admit_quantum.admit_quantum", "admit_scan"),
    "flash_attention": ("flash_attention.flash_attention",
                        "flash_attention"),
    "paged_attention": ("paged_attention.paged_attention",
                        "paged_attention"),
}
#: the launch counters an entry point may carry
COUNTERS = ("launches", "route_launches", "windowed_launches")


def entry_point(kernel: str):
    """The entry point of ``kernel`` (imported here, not at this
    package's import: nothing builds until a launch)."""
    module, name = ENTRY_POINTS[kernel]
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def launch_counts() -> dict:
    """Every kernel's launch counters, copied: kernel → counter → an int,
    or a dict of ints by route."""
    out = {}
    for kernel in ENTRY_POINTS:
        fn = entry_point(kernel)
        out[kernel] = {c: (dict(v) if isinstance(v, dict) else v)
                       for c in COUNTERS
                       if (v := getattr(fn, c, None)) is not None}
    return out


def launches_between(before: dict, after: dict) -> dict:
    """What each counter gained from ``before`` to ``after`` (both
    :func:`launch_counts`)."""
    return {kernel: {c: ({r: n - before[kernel][c].get(r, 0)
                          for r, n in v.items()} if isinstance(v, dict)
                         else v - before[kernel][c])
                     for c, v in counters.items()}
            for kernel, counters in after.items()}


def add_launches(delta: dict) -> None:
    """Add ``delta`` (a :func:`launches_between`) to the counters as they
    stand now, in place: a caller that swapped a counter's dict for its
    own still counts."""
    for kernel, counters in delta.items():
        fn = entry_point(kernel)
        for c, d in counters.items():
            if isinstance(d, dict):
                counts = getattr(fn, c)
                for r, n in d.items():
                    if n:
                        counts[r] = counts.get(r, 0) + n
            elif d:
                setattr(fn, c, getattr(fn, c) + d)


def set_launch_counts(counts: dict) -> None:
    """Put the counters back to ``counts`` (a :func:`launch_counts`), each
    dict in place."""
    for kernel, counters in counts.items():
        fn = entry_point(kernel)
        for c, v in counters.items():
            if isinstance(v, dict):
                getattr(fn, c).update(v)
            else:
                setattr(fn, c, v)

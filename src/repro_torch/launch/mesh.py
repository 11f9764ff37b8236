"""Model meshes: named axes over the ranks of a ``torch.distributed``
process group.

Counterpart of ``repro/launch/mesh.py``.  The reference's mesh is a
grid of devices under one controller; here it is a grid of ranks, each
running the same program (SPMD).  A :class:`ModelMesh` holds the axis
names and sizes.  It is *abstract* until :meth:`ModelMesh.bind` lays the
ranks of the initialised group out on it row-major (rank r at the
coordinates of r in a C-order walk, as ``jax.make_mesh`` orders its
devices) and makes one subgroup per axis and per tuple of axes.  An
abstract mesh is what the dry-run uses: its collectives communicate
nothing and only tally (``distributed.collectives``).

Defined as functions, so importing this module touches no process
group.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

import torch.distributed as dist

#: an axis entry of a spec: one axis name, a tuple of names, or None
AxisEntry = Optional[object]


def axes_of(entry: AxisEntry) -> tuple[str, ...]:
    """A spec entry as a tuple of axis names (``None`` → ``()``)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


class ModelMesh:
    """Named axes of ``shape`` (an ordered ``{name: size}``).  Unbound,
    this process is taken to sit at coordinate 0 of every axis.  After
    :meth:`bind`, ``rank`` is this process's rank in the group and
    ``coords`` its coordinates.  ``tally`` accumulates what the
    collectives over this mesh moved: result bytes and counts by kind,
    and host seconds (bound meshes only)."""

    def __init__(self, shape: dict) -> None:
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.rank = 0
        self.coords = {a: 0 for a in self.axis_names}
        self.groups: Optional[dict] = None
        self.reset_tally()

    def __repr__(self) -> str:
        dims = "x".join(f"{a}={n}" for a, n in self.shape.items())
        return f"ModelMesh({dims}, {'bound' if self.bound else 'abstract'})"

    @property
    def bound(self) -> bool:
        return self.groups is not None

    def reset_tally(self) -> None:
        self.tally = {"bytes_by_kind": {}, "counts": {}, "seconds": 0.0}

    def axis_size(self, entry: AxisEntry) -> int:
        return math.prod(self.shape[a] for a in axes_of(entry))

    def axis_index(self, entry: AxisEntry) -> int:
        """This rank's place along ``entry`` (row-major over a tuple)."""
        idx = 0
        for a in axes_of(entry):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, entry: AxisEntry):
        """The subgroup of the ranks that differ from this one only
        along ``entry``."""
        if not self.bound:
            raise RuntimeError(f"{self!r} has no process group")
        return self.groups[tuple(sorted(axes_of(entry),
                                        key=self.axis_names.index))]

    def bind(self) -> "ModelMesh":
        """Lay the initialised group's ranks out on this mesh.  Every
        rank of the group must call it, in the same order as its other
        group-making calls; the group's size must be the mesh's."""
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"{self!r} needs {self.size} ranks; the group "
                             f"has {world}")
        self.rank = dist.get_rank()
        sizes = list(self.shape.values())
        coords_of = list(itertools.product(*(range(n) for n in sizes)))
        self.coords = dict(zip(self.axis_names, coords_of[self.rank]))
        groups = {}
        for k in range(1, len(self.axis_names) + 1):
            for sub in itertools.combinations(self.axis_names, k):
                if len(sub) == len(self.axis_names):
                    groups[sub] = dist.group.WORLD
                    continue
                # ranks that agree on every axis outside ``sub``
                members: dict[tuple, list[int]] = {}
                for r, c in enumerate(coords_of):
                    key = tuple(c[i] for i, a in enumerate(self.axis_names)
                                if a not in sub)
                    members.setdefault(key, []).append(r)
                mine, _ = dist.new_subgroups_by_enumeration(
                    list(members.values()), backend="gloo")
                groups[sub] = mine
        self.groups = groups
        return self


def make_production_mesh(*, multi_pod: bool = False) -> ModelMesh:
    """16×16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return ModelMesh({"pod": 2, "data": 16, "model": 16})
    return ModelMesh({"data": 16, "model": 16})


def make_test_mesh(n_data: int = 2, n_model: int = 4) -> ModelMesh:
    """A small mesh; :meth:`ModelMesh.bind` it on ``n_data · n_model``
    ranks (``core.shard_plane.launch_ranks``)."""
    return ModelMesh({"data": n_data, "model": n_model})

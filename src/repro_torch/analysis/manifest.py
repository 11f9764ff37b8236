"""Column manifest — the machine-readable contract the passes run on.

``repro_torch.core.resident``, ``repro_torch.core.request_table`` and
``repro_torch.telemetry.flight`` each export a ``column_manifest()``
dict (columns → dtype, the device-mirrored set, the f32 kernel-facing
set, sanctioned mutators).  This module merges them into one
:class:`Manifest` and round-trips it through JSON so the analyzer's
view of the contract can be pinned/diffed in CI artifacts.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class Manifest:
    """Merged column contract across every exporting store."""

    stores: tuple[dict, ...]

    @property
    def mirrored(self) -> set[str]:
        """Columns backed by a cached device mirror — host writes must
        invalidate (`mirror-invalidation` pass)."""
        return {c for s in self.stores for c in s.get("mirrored", ())}

    @property
    def kernel_f32(self) -> set[str]:
        return {c for s in self.stores for c in s.get("kernel_f32", ())}

    @property
    def f64_columns(self) -> set[str]:
        """Accumulator columns (float64 contract — `dtype-discipline`)."""
        return {name
                for s in self.stores
                for name, dt in s.get("columns", {}).items()
                if dt == "float64"}

    @property
    def sanctioned_mutators(self) -> set[str]:
        return {q for s in self.stores
                for q in s.get("sanctioned_mutators", ())}

    def to_json(self) -> str:
        return json.dumps({"stores": list(self.stores)}, indent=2,
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Manifest":
        return cls(stores=tuple(json.loads(text)["stores"]))

    @classmethod
    def from_exports(cls, exports: list[dict]) -> "Manifest":
        return cls(stores=tuple(exports))


def default_manifest() -> Manifest:
    """The live contract, imported from the port's stores themselves so
    a new column is covered the moment it is declared."""
    from repro_torch.core import request_table, resident
    from repro_torch.telemetry import flight

    return Manifest.from_exports(
        [resident.column_manifest(), request_table.column_manifest(),
         flight.column_manifest()])

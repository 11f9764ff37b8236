"""StateStore — the control plane's low-latency state backend.

The paper keeps per-entitlement state in Redis (§4.3): in-flight count,
burst intensity b_e, accumulated debt d_e, effective allocation, updated
on every request completion via the gateway callback.  This module
provides an in-memory store with the same operation set (get / set /
compare-and-set / atomic increment / TTL expiry) so the control plane is
written against the Redis contract and a real Redis client can be
swapped in behind the same interface.

Deterministic: expiry is evaluated against an explicit ``now``.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass
class _Entry:
    value: Any
    version: int = 0
    expires_at: Optional[float] = None


class CASConflict(RuntimeError):
    """Optimistic-concurrency conflict (another writer won)."""


class StateStore:
    """In-memory key/value store with versions, CAS, counters and TTL.

    Mirrors the subset of Redis used by the auth service: plain
    GET/SET, WATCH/MULTI-style compare-and-set, INCRBY, EXPIRE.
    """

    def __init__(self) -> None:
        self._data: dict[str, _Entry] = {}

    # -- plain KV ---------------------------------------------------------
    def get(self, key: str, now: float = 0.0) -> Any:
        e = self._data.get(key)
        if e is None:
            return None
        if e.expires_at is not None and now >= e.expires_at:
            del self._data[key]
            return None
        return e.value

    def set(self, key: str, value: Any, now: float = 0.0,
            ttl_s: Optional[float] = None) -> int:
        prev = self._data.get(key)
        version = (prev.version + 1) if prev is not None else 1
        expires_at = (now + ttl_s) if ttl_s is not None else None
        self._data[key] = _Entry(value=value, version=version,
                                 expires_at=expires_at)
        return version

    def get_versioned(self, key: str, now: float = 0.0) -> tuple[Any, int]:
        e = self._data.get(key)
        if e is None:
            return None, 0
        if e.expires_at is not None and now >= e.expires_at:
            del self._data[key]
            return None, 0
        return e.value, e.version

    # -- optimistic concurrency -------------------------------------------
    def compare_and_set(self, key: str, value: Any, expected_version: int,
                        now: float = 0.0) -> int:
        _, version = self.get_versioned(key, now)
        if version != expected_version:
            raise CASConflict(
                f"{key}: expected v{expected_version}, found v{version}")
        return self.set(key, value, now)

    def update(self, key: str, fn: Callable[[Any], Any], now: float = 0.0,
               max_retries: int = 8) -> Any:
        """Read-modify-write with CAS retry (Redis WATCH/MULTI loop)."""
        for _ in range(max_retries):
            value, version = self.get_versioned(key, now)
            new_value = fn(copy.deepcopy(value))
            try:
                if version == 0:
                    self.set(key, new_value, now)
                else:
                    self.compare_and_set(key, new_value, version, now)
                return new_value
            except CASConflict:  # pragma: no cover - single-threaded here
                continue
        raise CASConflict(f"update({key}) exhausted retries")

    # -- counters -----------------------------------------------------------
    def incr(self, key: str, by: float = 1.0, now: float = 0.0) -> float:
        """Atomic increment with Redis INCRBY semantics: the key's TTL
        is PRESERVED (``set`` would rewrite the entry and clear
        ``expires_at``); an absent or expired key starts from 0 with no
        expiry."""
        e = self._data.get(key)
        if e is not None and e.expires_at is not None \
                and now >= e.expires_at:
            del self._data[key]
            e = None
        if e is None:
            new = by + 0.0
            self._data[key] = _Entry(value=new, version=1)
        else:
            new = (e.value or 0.0) + by
            e.value = new
            e.version += 1
        return new

    def incr_many(self, deltas: dict, now: float = 0.0) -> None:
        """Batched increments — the Redis MULTI/pipeline analogue the
        hot paths use so a quantum issues ONE store call instead of one
        ``incr`` per distinct key."""
        for key, by in deltas.items():
            self.incr(key, by, now)

    # -- TTL -----------------------------------------------------------------
    def expire(self, key: str, ttl_s: float, now: float = 0.0) -> bool:
        e = self._data.get(key)
        if e is None:
            return False
        e.expires_at = now + ttl_s
        return True

    def keys(self, prefix: str = "", now: float = 0.0) -> list[str]:
        out = []
        for k in list(self._data):
            if k.startswith(prefix) and self.get(k, now) is not None:
                out.append(k)
        return sorted(out)

    def delete(self, key: str) -> bool:
        return self._data.pop(key, None) is not None

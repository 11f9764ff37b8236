"""Virtual nodes: capacity admission via scheduler semantics (paper §4.1).

For each TokenPool the Virtual Node Provider creates a *virtual node*
advertising extended resources that mirror pool capacity (token
throughput, KV GiB, concurrency).  Entitlement controllers create
*virtual lease pods* requesting specific token resources; the scheduler
binds a lease to the node iff allocatable capacity suffices, otherwise
the lease stays Pending and the entitlement is marked Degraded.

The lease pod consumes no compute — it exists solely to occupy capacity,
so two entitlements can never claim the same reserved tokens.  In the
paper this repurposes the Kubernetes scheduler (inheriting its
consistency and race handling); here we implement the same contract as
a deterministic in-process scheduler with transactional binds:

  * bind is atomic: either the full resource vector fits and is
    committed, or nothing is;
  * unbind returns capacity and triggers a rescheduling pass over the
    pending queue in FIFO order (K8s would re-queue pending pods);
  * capacity changes (autoscaling, replica failure) also trigger
    rescheduling, and may *preempt* bound leases in reverse-priority
    order when capacity shrinks below committed reservations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.types import Resources


@dataclasses.dataclass
class LeasePod:
    """A virtual pod requesting token resources for one entitlement."""

    name: str
    entitlement: str
    request: Resources
    #: larger weight = more protected (evicted last on capacity shrink)
    protection_weight: float = 0.0
    bound: bool = False


@dataclasses.dataclass
class VirtualNode:
    """Synthetic node advertising a pool's capacity as extended resources."""

    name: str
    capacity: Resources
    allocated: Resources = dataclasses.field(default_factory=Resources.zero)

    def allocatable(self) -> Resources:
        return (self.capacity - self.allocated).clamp_nonneg()


class VirtualNodeProvider:
    """One virtual node per pool + the scheduler that binds leases."""

    def __init__(self) -> None:
        self._nodes: dict[str, VirtualNode] = {}
        self._leases: dict[str, LeasePod] = {}       # by lease name
        self._pending: list[str] = []                # FIFO of lease names
        #: bind/unbind event log (name, event) for tests & observability
        self.events: list[tuple[str, str]] = []

    # -- node lifecycle -----------------------------------------------------
    def create_node(self, pool: str, capacity: Resources) -> VirtualNode:
        node = VirtualNode(name=f"vnode-{pool}", capacity=capacity)
        self._nodes[pool] = node
        return node

    def node(self, pool: str) -> VirtualNode:
        return self._nodes[pool]

    def set_capacity(self, pool: str, capacity: Resources) -> list[str]:
        """Update node capacity (autoscale / replica failure).

        Returns the names of leases *preempted* because the new capacity
        cannot hold all bound reservations.  Preemption evicts the least
        protected leases first; then pending leases are rescheduled.
        """
        node = self._nodes[pool]
        node.capacity = capacity
        preempted = []
        # Evict least-protected bound leases until committed fits capacity.
        while not node.allocated.fits_within(node.capacity):
            bound = [l for l in self._leases.values()
                     if l.bound and self._pool_of(l) == pool]
            if not bound:
                break
            victim = min(bound, key=lambda l: (l.protection_weight, l.name))
            self._unbind(pool, victim)
            self._pending.append(victim.name)
            preempted.append(victim.name)
            self.events.append((victim.name, "preempted"))
        self._reschedule(pool)
        return preempted

    # -- lease lifecycle ----------------------------------------------------
    def submit(self, pool: str, lease: LeasePod) -> bool:
        """Create a lease pod; attempt to schedule it immediately.

        Returns True if bound, False if left Pending (⇒ Degraded)."""
        self._leases[lease.name] = lease
        lease._pool = pool  # type: ignore[attr-defined]
        if self._try_bind(pool, lease):
            return True
        self._pending.append(lease.name)
        return False

    def delete(self, lease_name: str) -> None:
        lease = self._leases.pop(lease_name, None)
        if lease is None:
            return
        pool = self._pool_of(lease)
        if lease.bound:
            self._unbind(pool, lease)
            self._reschedule(pool)
        elif lease_name in self._pending:
            self._pending.remove(lease_name)

    def resize(self, lease_name: str, request: Resources) -> bool:
        """Change a lease's resource request atomically (entitlement
        update).  Falls back to the old request if the new one doesn't
        fit; returns bound-status for the *new* request."""
        lease = self._leases[lease_name]
        pool = self._pool_of(lease)
        old = lease.request
        if lease.bound:
            self._unbind(pool, lease)
        lease.request = request
        if self._try_bind(pool, lease):
            self._reschedule(pool)
            return True
        # restore: try to re-bind the old request so a failed grow
        # doesn't lose an existing reservation
        lease.request = old
        if not self._try_bind(pool, lease):
            if lease.name not in self._pending:
                self._pending.append(lease.name)
        lease.request = request  # the *spec* keeps the new ask
        return False

    def is_bound(self, lease_name: str) -> bool:
        lease = self._leases.get(lease_name)
        return bool(lease and lease.bound)

    def pending(self) -> list[str]:
        return list(self._pending)

    # -- internals ------------------------------------------------------------
    def _pool_of(self, lease: LeasePod) -> str:
        return lease._pool  # type: ignore[attr-defined]

    def _try_bind(self, pool: str, lease: LeasePod) -> bool:
        node = self._nodes[pool]
        if not lease.request.fits_within(node.allocatable()):
            return False
        node.allocated = node.allocated + lease.request
        lease.bound = True
        self.events.append((lease.name, "bound"))
        return True

    def _unbind(self, pool: str, lease: LeasePod) -> None:
        node = self._nodes[pool]
        node.allocated = (node.allocated - lease.request).clamp_nonneg()
        lease.bound = False
        self.events.append((lease.name, "unbound"))

    def _reschedule(self, pool: str) -> None:
        """FIFO pass over pending leases (K8s scheduler queue)."""
        still_pending: list[str] = []
        for name in self._pending:
            lease = self._leases.get(name)
            if lease is None or self._pool_of(lease) != pool:
                if lease is not None:
                    still_pending.append(name)
                continue
            if not self._try_bind(pool, lease):
                still_pending.append(name)
        self._pending = still_pending

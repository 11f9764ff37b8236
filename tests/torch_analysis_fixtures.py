"""Fixtures of ``tests/test_torch_analysis.py``: the sources that both
sanitizers scan.

The framework-free fixtures are ``tests/test_analysis.py``'s and
``tests/test_telemetry.py``'s, restated, plus a chaos-harness pair; both
analyzers scan them unchanged.  The kernel-keyed fixtures come in pairs
of the reference's source and its torch twin: ``@kernel`` plus
``jax.jit`` becomes ``@device_kernel`` plus ``torch.no_grad()``, a
``jit`` definition becomes a function that launches a kernel through
``kernels.build.function``, ``shard_map`` becomes a collective,
``Mesh(...)`` a ``RowMesh(...)`` over a new process group, numpy casts
torch casts — each construct on the same line, so both analyzers must
report the same (rule, line) set.
"""
import textwrap
from pathlib import Path

#: synthetic column contract — one mirrored f32 column, one f64
#: accumulator, one sanctioned mutator.
SYNTH = [{
    "store": "Store", "module": "fixture",
    "columns": {"burst": "float32", "window_tokens": "float64"},
    "mirrored": ["burst"],
    "kernel_f32": ["burst"],
    "sanctioned_mutators": ["Pool.adopt_device"],
}]


def line_of(src: str, needle: str) -> int:
    """1-based line of the first line containing ``needle``."""
    for i, ln in enumerate(textwrap.dedent(src).splitlines(), start=1):
        if needle in ln:
            return i
    raise AssertionError(f"{needle!r} not in fixture")


def write(root: Path, name: str, src: str) -> Path:
    p = root / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return p


# -- framework-free rules: one source, both analyzers -------------------------

MIRROR_VIOLATING = """
import numpy as np

class Pool:
    def bump(self, slot, v):
        c = self.store.col
        c["burst"][slot] = v

    def scatter(self, slots):
        c = self.store.col
        np.add.at(c["burst"], slots, 1.0)
"""

MIRROR_CLEAN = """
class Pool:
    def bump(self, slot, v):
        c = self.store.col
        c["burst"][slot] = v
        self.store.mark_dirty()

    def adopt_device(self, state):
        self.store.col["burst"][:] = 0.0

    def unmirrored(self, slot, v):
        self.store.col["window_tokens"][slot] = v
"""

HOT_VIOLATING = """
from repro.core.markers import hot_path

class Pool:
    @hot_path
    def bad(self):
        return [r for r in self.in_flight.values()]
"""

HOT_CLEAN = """
from repro.core.markers import hot_path

class Pool:
    @hot_path
    def ok(self, batch):
        return [b for b in batch]

    def unmarked(self):
        return [r for r in self.in_flight.values()]
"""

TELEMETRY_VIOLATING = """
from repro.core.markers import hot_path

class Gw:
    @hot_path
    def admit(self, batch, now):
        for ent in batch:
            self.store.incr(f"admits:{ent}", 1.0, now)
        self.hist.observe(0, 0.5)

    def cold(self, now):
        self.store.incr("fine-here", 1.0, now)
"""

TELEMETRY_CLEAN = """
from repro.core.markers import hot_path

class Gw:
    @hot_path
    def admit(self, sids, vals, now):
        self.hist.observe_rows(vals, sids)
        self.count.inc_rows(sids, 1.0)
        self.flight.record_batch(sids, now)
        self.store.incr_many({"admits:a": 2.0}, now)

    def oracle(self, now):
        self.hist.observe(0, 0.5)
        self.store.incr("admits:a", 1.0, now)
"""

CHAOS_VIOLATING = """
class Checker:
    def check(self, pool, store):
        level = pool._authorized
        store._free.append(3)
        return level, self._seen, pool.__class__
"""

CHAOS_CLEAN = """
class Checker:
    def check(self, pool):
        snap = pool.audit_snapshot()
        self._seen = snap
        x = pool._authorized  # repro: allow[chaos-public-api] -- audited read
        return snap, x
"""

WAIVER_SAME_LINE = """
class Pool:
    def bump(self, slot, v):
        c = self.store.col
        c["burst"][slot] = v  # repro: allow[mirror-invalidation] -- adopted wholesale below
"""

WAIVER_COMMENT_LINE = """
class Pool:
    def bump(self, slot, v):
        c = self.store.col
        # repro: allow[mirror-invalidation] -- statics; caller invalidates
        c["burst"][slot] = v
"""

WAIVER_REASONLESS = """
class Pool:
    def bump(self, slot, v):
        c = self.store.col
        c["burst"][slot] = v  # repro: allow[mirror-invalidation]
"""

WAIVER_FILE = """
# repro: allow-file[mirror-invalidation] -- generated shim

class Pool:
    def bump(self, slot, v):
        self.store.col["burst"][slot] = v
"""

WAIVER_WRONG_RULE = """
class Pool:
    def bump(self, slot, v):
        c = self.store.col
        c["burst"][slot] = v  # repro: allow[hot-path-scalar-loop] -- wrong rule
"""

MULTI_RULE_WAIVER = """
a = 1  # repro: allow[rule-a, rule-b] -- both
"""

#: (id, source, rules, path under the scan root for the reference, and
#: for the port where it differs)
FRAMEWORK_FREE = [
    ("mirror-violating", MIRROR_VIOLATING, ["mirror-invalidation"], None),
    ("mirror-clean", MIRROR_CLEAN, ["mirror-invalidation"], None),
    ("hot-violating", HOT_VIOLATING, ["hot-path-scalar-loop"], None),
    ("hot-clean", HOT_CLEAN, ["hot-path-scalar-loop"], None),
    ("telemetry-violating", TELEMETRY_VIOLATING, ["telemetry-hot-path"],
     None),
    ("telemetry-clean", TELEMETRY_CLEAN, ["telemetry-hot-path"], None),
    ("chaos-violating", CHAOS_VIOLATING, ["chaos-public-api"],
     ("repro/chaos/mod.py", "repro_torch/chaos/mod.py")),
    ("chaos-clean", CHAOS_CLEAN, ["chaos-public-api"],
     ("repro/chaos/mod.py", "repro_torch/chaos/mod.py")),
    ("chaos-outside-harness", CHAOS_VIOLATING, ["chaos-public-api"],
     ("repro/core/mod.py", "repro_torch/core/mod.py")),
    ("waiver-same-line", WAIVER_SAME_LINE, ["mirror-invalidation"], None),
    ("waiver-comment-line", WAIVER_COMMENT_LINE, ["mirror-invalidation"],
     None),
    ("waiver-reasonless", WAIVER_REASONLESS, ["mirror-invalidation"], None),
    ("waiver-file", WAIVER_FILE, ["mirror-invalidation"], None),
    ("waiver-wrong-rule", WAIVER_WRONG_RULE, ["mirror-invalidation"], None),
    ("all-rules", MIRROR_VIOLATING + HOT_VIOLATING, None, None),
]

# -- kernel-keyed rules: the reference's source and its torch twin ------------

DTYPE_VIOLATING = """
import numpy as np
from repro.core.markers import kernel

@kernel(oracle="fixture.oracle_fn")
@jax.jit
def k(x):
    return x

class Pool:
    def call_uncast(self):
        c = self.store.col
        return k(c["window_tokens"])

    def call_f64(self, arr):
        return k(np.asarray(arr, np.float64))

    def truncate(self, slot, v):
        c = self.store.col
        c["window_tokens"][slot] = np.float32(v)
"""

DTYPE_VIOLATING_TWIN = """
import torch
from repro_torch.core.markers import device_kernel

@device_kernel(oracle="fixture.oracle_fn")
@torch.no_grad()
def k(x):
    return x

class Pool:
    def call_uncast(self):
        c = self.store.col
        return k(torch.from_numpy(c["window_tokens"]))

    def call_f64(self, arr):
        return k(torch.as_tensor(arr, dtype=torch.float64))

    def truncate(self, slot, v):
        c = self.store.col
        c["window_tokens"][slot] = torch.tensor(v).float().item()
"""

DTYPE_CLEAN = """
import numpy as np
from repro.core.markers import kernel

@kernel(oracle="fixture.oracle_fn")
@jax.jit
def k(x):
    return x

class Pool:
    def call_cast(self):
        c = self.store.col
        return k(c["window_tokens"].astype(np.float32))

    def accumulate(self, slot, v):
        c = self.store.col
        c["window_tokens"][slot] += float(v)
"""

DTYPE_CLEAN_TWIN = """
import torch
from repro_torch.core.markers import device_kernel

@device_kernel(oracle="fixture.oracle_fn")
@torch.no_grad()
def k(x):
    return x

class Pool:
    def call_cast(self):
        c = self.store.col
        return k(torch.from_numpy(c["window_tokens"]).to(torch.float32))

    def accumulate(self, slot, v):
        c = self.store.col
        c["window_tokens"][slot] += float(v)
"""

#: torch spellings beyond the twins: flagged lines carry ``# f64`` or
#: ``# truncates``; every other call is sanctioned
DTYPE_TORCH_IDIOMS = """
import torch
from repro_torch.core.markers import device_kernel

@device_kernel(oracle="fixture.oracle_fn")
@torch.no_grad()
def k(x, y=None):
    return x

class Pool:
    def flagged(self, t):
        c = self.store.col
        k(t.double())  # f64
        k(t, y=torch.zeros(4, dtype=torch.float64))  # f64
        k(torch.tensor(c["window_tokens"]))  # f64
        c["window_tokens"][0] = t.float()  # truncates
        c["window_tokens"][:] = t.to(torch.float32).numpy()  # truncates

    def sanctioned(self, t):
        c = self.store.col
        k(torch.from_numpy(c["window_tokens"]).float())
        k(torch.as_tensor(c["window_tokens"], dtype=torch.float32))
        k(torch.tensor(c["window_tokens"], dtype=torch.float32))
        k(torch.from_numpy(c["window_tokens"]).to(t.device, torch.float32))
        c["window_tokens"][0] += t.double().item()
"""

RETRACE_VIOLATING = """
from functools import partial
from repro.core.markers import kernel

COUNTS = {"k": 0}
NAMES = ("coeff",)

@kernel(oracle="fixture.oracle_fn")
@partial(jax.jit, static_argnames=NAMES)
def k(x, coeff=None):
    COUNTS["k"] += 1
    return x

@kernel(oracle="fixture.oracle_fn")
@partial(jax.jit, static_argnames=("coeff",))
def k2(x, coeff=None):
    return x

def unbucketed(arr):
    return k(arr)

def unhashable(arr):
    return k2(pad_rows(arr), coeff=[1, 2])
"""

#: the same constructs under the port's marker: only the unbucketed
#: call is a hazard in eager torch
RETRACE_VIOLATING_TWIN = """
from functools import partial
from repro_torch.core.markers import device_kernel

COUNTS = {"k": 0}
NAMES = ("coeff",)

@device_kernel(oracle="fixture.oracle_fn")
@partial(jax.jit, static_argnames=NAMES)
def k(x, coeff=None):
    COUNTS["k"] += 1
    return x

@device_kernel(oracle="fixture.oracle_fn")
@partial(jax.jit, static_argnames=("coeff",))
def k2(x, coeff=None):
    return x

def unbucketed(arr):
    return k(arr)

def unhashable(arr):
    return k2(pad_rows(arr), coeff=[1, 2])
"""

RETRACE_CLEAN = """
from functools import partial
from repro.core.markers import kernel

@kernel(oracle="fixture.oracle_fn")
@partial(jax.jit, static_argnames=("coeff",))
def k(x, coeff=None):
    return x

def caller(arr, n):
    w = bucket_width(n)
    return k(pad_rows(arr, w), coeff=3)
"""

RETRACE_CLEAN_TWIN = """
import torch
from repro_torch.core.markers import device_kernel

@device_kernel(oracle="fixture.oracle_fn")
@torch.no_grad()
def k(x, coeff=None):
    return x

def caller(arr, n):
    w = bucket_width(n)
    return k(pad_rows(arr, w), coeff=3)
"""

SHARD_VIOLATING = """
from functools import partial
from repro.core.markers import kernel

@kernel(oracle="fixture.oracle_fn")
@partial(jax.jit, static_argnames=("mesh",))
def sharded_k(x, *, mesh):
    return x

def caller(arr, devices):
    w = bucket_width(arr.shape[0])
    return sharded_k(pad_rows(arr, w),
                     mesh=Mesh(devices, ("rows",)))
"""

SHARD_VIOLATING_TWIN = """
import torch.distributed as dist
from repro_torch.core.markers import device_kernel

@device_kernel(oracle="fixture.oracle_fn")
@torch.no_grad()
def sharded_k(x, *, mesh):
    return x

def caller(arr, ranks):
    w = bucket_width(arr.shape[0])
    return sharded_k(pad_rows(arr, w),
                     mesh=RowMesh(dist.new_group(ranks), 2, 0))
"""

SHARD_CLEAN = """
from functools import partial
from repro.core.markers import kernel

@kernel(oracle="fixture.oracle_fn")
@partial(jax.jit, static_argnames=("mesh",))
def sharded_k(x, *, mesh):
    return x

def caller(arr, n):
    mesh = row_mesh(4)
    w = shard_width(n, mesh)
    return sharded_k(pad_rows(arr, w), mesh=mesh)
"""

SHARD_CLEAN_TWIN = """
import torch
from repro_torch.core.markers import device_kernel

@device_kernel(oracle="fixture.oracle_fn")
@torch.no_grad()
def sharded_k(x, *, mesh):
    return x

def caller(arr, n):
    mesh = row_mesh(4)
    w = shard_width(n, mesh)
    return sharded_k(pad_rows(arr, w), mesh=mesh)
"""

PARITY_SRC = """
from repro.core.markers import kernel

@jax.jit
def unregistered(x):
    return x

@kernel(oracle="repro.core.scalar.Oracle.run")
@jax.jit
def fused_step(x):
    return x
"""

PARITY_SRC_TWIN = """
from repro_torch.core.markers import device_kernel
from repro_torch.kernels import build

def unregistered(x):
    return build.function("k", "k_launch", [])(x)

@device_kernel(oracle="repro.core.scalar.Oracle.run")
@torch.no_grad()
def fused_step(x):
    return build.function("k", "k_launch", [])(x)
"""

PARITY_SHARDED = """
from functools import partial
from repro.core.markers import kernel

@partial(jax.jit, static_argnames=("mesh",))
def rogue_sharded(x, *, mesh):
    return shard_map(lambda b: b, mesh=mesh,
                     in_specs=P("rows"), out_specs=P("rows"))(x)

@kernel(oracle="repro.core.scalar.Oracle.run")
@partial(jax.jit, static_argnames=("mesh",))
def fused_step(x, *, mesh):
    return shard_map(lambda b: b, mesh=mesh,
                     in_specs=P("rows"), out_specs=P("rows"))(x)
"""

PARITY_SHARDED_TWIN = """
import torch.distributed as dist
from repro_torch.core.markers import device_kernel

@torch.no_grad()
def rogue_sharded(x, *, mesh):
    dist.all_reduce(x, group=mesh.group)
    return x

@device_kernel(oracle="repro.core.scalar.Oracle.run")
@torch.no_grad()
def fused_step(x, *, mesh):
    dist.all_reduce(x, group=mesh.group)
    return x
"""

PARITY_NONLITERAL = """
from repro.core.markers import kernel

PATH = "a.b"

@kernel(oracle=PATH)
@jax.jit
def fused_step(x):
    return x
"""

PARITY_NONLITERAL_TWIN = """
from repro_torch.core.markers import device_kernel

PATH = "a.b"

@device_kernel(oracle=PATH)
@torch.no_grad()
def fused_step(x):
    return x
"""

#: a parity test module of each package: the reference's by bare name,
#: the port's by qualified name (``{module}`` is the kernel's module)
PARITY_TEST_REF = "from mod import fused_step\nfrom scalar import Oracle\n"
PARITY_TEST_TWIN = ("from {module} import fused_step\n"
                    "from repro.core.scalar import Oracle\n")

#: (id, rule, reference source, torch twin, reference path, port path,
#: whether the case carries a tests dir)
KERNEL_KEYED = [
    ("dtype-violating", "dtype-discipline", DTYPE_VIOLATING,
     DTYPE_VIOLATING_TWIN, "repro/core/mod.py", "repro_torch/core/mod.py",
     False),
    ("dtype-clean", "dtype-discipline", DTYPE_CLEAN, DTYPE_CLEAN_TWIN,
     "repro/core/mod.py", "repro_torch/core/mod.py", False),
    ("retrace-clean", "retrace-hazard", RETRACE_CLEAN, RETRACE_CLEAN_TWIN,
     "repro/core/mod.py", "repro_torch/core/mod.py", False),
    ("shard-violating", "retrace-hazard", SHARD_VIOLATING,
     SHARD_VIOLATING_TWIN, "repro/core/mod.py", "repro_torch/core/mod.py",
     False),
    ("shard-clean", "retrace-hazard", SHARD_CLEAN, SHARD_CLEAN_TWIN,
     "repro/core/mod.py", "repro_torch/core/mod.py", False),
    ("parity-covered", "oracle-parity", PARITY_SRC, PARITY_SRC_TWIN,
     "repro/core/mod.py", "repro_torch/core/mod.py", True),
    ("parity-deleted", "oracle-parity", PARITY_SRC, PARITY_SRC_TWIN,
     "repro/core/mod.py", "repro_torch/core/mod.py", False),
    ("parity-out-of-scope", "oracle-parity", PARITY_SRC, PARITY_SRC_TWIN,
     "repro/kernels/mod.py", "repro_torch/serving/mod.py", True),
    ("parity-sharded", "oracle-parity", PARITY_SHARDED, PARITY_SHARDED_TWIN,
     "repro/distributed/mod.py", "repro_torch/distributed/mod.py", True),
    ("parity-non-literal", "oracle-parity", PARITY_NONLITERAL,
     PARITY_NONLITERAL_TWIN, "repro/core/mod.py", "repro_torch/core/mod.py",
     True),
]

# -- qualified keying (the port only) -----------------------------------------

#: a registered kernel in one module, an unrelated function of the
#: same bare name in another, and callers of each
QUALIFIED_KERNEL = """
import torch
from repro_torch.core.markers import device_kernel

@device_kernel(oracle="repro.core.fleet.step")
@torch.no_grad()
def step(x):
    return x
"""

QUALIFIED_CALLERS = """
from repro_torch.core import kern
from repro_torch.core.kern import step as kernel_step

def step(x):
    return x

def own_name(arr):
    return step(arr)

def through_module(arr):
    return kern.step(arr)

def through_alias(arr):
    fn = kernel_step
    return fn(arr)
"""

#: collectives: the layer itself is no kernel, its users are
COLLECTIVE_LAYER = """
import torch.distributed as dist

def all_reduce(x, mesh, axis):
    dist.all_reduce(x, group=mesh.group(axis))
    return x
"""

COLLECTIVE_USERS = """
from repro_torch.distributed.collectives import all_reduce

def plain(x):
    return x + 1

def tp_sum(x, mesh):
    return all_reduce(x, mesh, "tp")
"""

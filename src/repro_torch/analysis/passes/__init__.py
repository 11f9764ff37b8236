"""The seven control-plane invariant passes.  Importing this package
registers them all with ``repro_torch.analysis.core.PASS_REGISTRY``."""
from repro_torch.analysis.passes import (  # noqa: F401
    chaos_api,
    dtype,
    hotpath,
    mirror,
    parity,
    retrace,
    telemetry,
)

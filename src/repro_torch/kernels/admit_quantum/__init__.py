from repro_torch.kernels.admit_quantum.admit_quantum import (
    admit_scan,
    reference_admit_scan,
)

__all__ = ["admit_scan", "reference_admit_scan"]

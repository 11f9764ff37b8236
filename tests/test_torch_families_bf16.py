"""The bfloat16-cache half of ``test_prefill_then_decode_logits`` (its
float32 half, and what both check, in ``tests/test_torch_families.py``):
each family's reduced config, two prompts of 40 tokens, then 24 decode
steps, the port's logits held to the reference's as the port is (no
further than the reference's own float32-cache drift) and with the
reference's rounding of the attention weights mirrored, at 2e-2."""
import pytest

from torch_families_support import ARCHS, check_logits, \
    no_launches  # noqa: F401 (an autouse fixture)
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("kv_dtype", ["bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_logits(arch, kv_dtype, monkeypatch):
    check_logits(arch, kv_dtype, 1, monkeypatch)

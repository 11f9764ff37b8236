"""``test_bfloat16_cache_over_seeds``, half of its archs: deepseek-7b
and both gemma2 (tinyllama-1.1b and both MoE configs in
``tests/test_torch_families_seeds.py``; what it checks:
``tests/test_torch_families.py``).  Seeds 2-4 repeat the bfloat16-cache
case of ``test_prefill_then_decode_logits``; ``-s`` prints each run's
three distances."""
import pytest

from torch_families_support import check_logits, \
    no_launches  # noqa: F401 (an autouse fixture)
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("seed", [2, 3, 4])
@pytest.mark.parametrize("arch", ("deepseek-7b", "gemma2-2b", "gemma2-9b"))
def test_bfloat16_cache_over_seeds(arch, seed, monkeypatch):
    check_logits(arch, "bfloat16", seed, monkeypatch)

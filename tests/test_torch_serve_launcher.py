"""``repro_torch.launch.serve`` prints what ``repro.launch.serve``
prints, on the CPU: the last check of the serve slice
(``tests/test_torch_engine.py``), for half of the archs the engine
serves (the other half in ``tests/test_torch_serve_launcher_more.py``).
"""
import sys

import pytest
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("arch", [
    pytest.param(None, id="default-qwen3-8b"), "gemma2-2b",
    "qwen3-moe-30b-a3b", "recurrentgemma-2b", "xlstm-350m",
    "internvl2-2b"])
def test_serve_launcher_prints_the_same(monkeypatch, capsys, arch):
    """The default arch (qwen3-8b) and every other arch the engine
    serves (whisper-small it cannot: fault C10): 16 requests on 4 slots
    in full waves, so no lane is idle during a decode (the engines
    differ there for MoE: fault C9)."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve as port_serve
    flags = [] if arch is None else ["--arch", arch]
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    jax_serve.main()
    ref = capsys.readouterr().out
    port_serve.main(["--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert out == ref
    assert "pool tokens served" in out

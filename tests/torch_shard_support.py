"""Shared by the port's model-sharding tests: the reduced configs and
the subprocess that runs the JAX package's sharded programs
(``tests/torch_shard_reference.py``).  Imports no JAX, as the test
modules that spawn ranks must not (each rank imports its module)."""
import os
import pickle
import subprocess
import sys
import tempfile

from repro_torch.configs import get_config

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
#: the three meshes of the model-sharding tests, (data, model)
MESHES = ((1, 2), (2, 2), (2, 4))
ARCHS = ("tinyllama-1.1b", "gemma2-2b", "qwen3-moe-30b-a3b", "internvl2-2b")


def reduced(arch: str, **over):
    """The port's copy of the reduced config of tests/test_distributed.py
    (d 128, 4/2 heads, dh 32, vocab 512, d_ff 256)."""
    base = get_config(arch)
    return base.reduced(d_model=128, num_heads=4, num_kv_heads=2,
                        head_dim=32, vocab_size=512,
                        d_ff=0 if base.d_ff == 0 else 256, **over)


def run_reference(jobs: dict, devices: int = 8, timeout: float = 600.0
                  ) -> dict:
    """Run ``jobs`` through tests/torch_shard_reference.py on ``devices``
    host devices; their results by key."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "jobs.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(jobs, f)
        res = subprocess.run(
            [sys.executable, os.path.join(HERE, "torch_shard_reference.py"),
             src, dst], capture_output=True, text=True, timeout=timeout,
            env=env, cwd=REPO)
        assert res.returncode == 0, f"reference failed:\n{res.stderr[-3000:]}"
        with open(dst, "rb") as f:
            return pickle.load(f)        # written by the reference just now

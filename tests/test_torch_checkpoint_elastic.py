"""Elastic checkpoints across both packages: ``repro_torch.checkpointing``
``save(..., shardings=)`` / ``restore(..., shardings=)`` on CPU gloo
ranks against the JAX package's sharded ``save`` / ``restore`` on host
devices (``tests/test_distributed.py::test_elastic_checkpoint_reshard``
saves on 8 devices and restores on 4).

Two leaves: ``w`` (8, 8) float32 split over ``data`` on its rows, and
``g`` a stacked (2, 8, 4) bfloat16 leaf — a group of two layers in the
port — split on its middle dim.  The reference saves on 8 devices and
the port restores on 4 ranks; the port saves on 8 ranks and the
reference restores on 4 devices; the port saves on 4 ranks and restores
on 8.  Every restored block equals the slice of the saved values.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpointing import latest_step, restore, save
from repro_torch.core.shard_plane import launch_ranks
from repro_torch.distributed.sharding import NamedSharding, block
from repro_torch.launch.mesh import ModelMesh
from torch_shard_support import run_reference

W = np.arange(64, dtype=np.float32).reshape(8, 8)
G = (np.arange(64, dtype=np.float32).reshape(2, 8, 4) / 8.0 - 3.0)
SPECS = {"w": ("data", None), "g": (None, "data", None)}


def whole() -> dict:
    return {"w": torch.from_numpy(W),
            "g": list(torch.from_numpy(G).to(torch.bfloat16).unbind(0))}


def shardings(mesh) -> dict:
    return {k: NamedSharding(mesh, s) for k, s in SPECS.items()}


def save_rank(directory: str, n: int, step: int) -> bool:
    mesh = ModelMesh({"data": n}).bind()
    blocks = {"w": block(mesh, SPECS["w"], whole()["w"]).clone(),
              "g": [block(mesh, SPECS["g"][1:], t).clone()
                    for t in whole()["g"]]}
    save(directory, step, blocks, shardings(mesh))
    return True


def restore_rank(directory: str, n: int) -> dict:
    mesh = ModelMesh({"data": n}).bind()
    target = {"w": torch.empty(8, 8, device="meta"),
              "g": [torch.empty(8, 4, dtype=torch.bfloat16, device="meta")
                    for _ in range(2)]}
    out = restore(directory, latest_step(directory), target,
                  shardings(mesh))
    return {"w": out["w"].numpy(),
            "g": torch.stack(out["g"]).float().numpy(),
            "rank": mesh.rank}


def check_blocks(results, n):
    for r in results:
        k = r["rank"]
        b = 8 // n
        np.testing.assert_array_equal(r["w"], W[k * b:(k + 1) * b])
        np.testing.assert_array_equal(
            r["g"], torch.from_numpy(G[:, k * b:(k + 1) * b])
            .to(torch.bfloat16).float().numpy())


def test_reference_saves_on_8_port_restores_on_4(tmp_path):
    d = str(tmp_path)
    run_reference({"s": ("ckpt_save", (d, 3, 8, {
        "w": (W, "float32", SPECS["w"]),
        "g": (G, "bfloat16", SPECS["g"])}))},
        devices=8)
    assert latest_step(d) == 3
    check_blocks(launch_ranks(restore_rank, 4, d, 4, timeout=120.0), 4)


def test_port_saves_on_8_reference_restores_on_4(tmp_path):
    d = str(tmp_path)
    assert all(launch_ranks(save_rank, 8, d, 8, 5, timeout=120.0))
    out = run_reference({"r": ("ckpt_restore", (d, 5, 4, {
        "w": ((8, 8), "float32", SPECS["w"]),
        "g": ((2, 8, 4), "bfloat16", SPECS["g"])}))}, devices=4)["r"]
    assert out["w"][0] == 4 and out["g"][0] == 4
    np.testing.assert_array_equal(out["w"][1], W)
    np.testing.assert_array_equal(
        out["g"][1], torch.from_numpy(G).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("n_save,n_restore", [(4, 8), (8, 2)])
def test_port_reshards_across_rank_counts(tmp_path, n_save, n_restore):
    d = str(tmp_path)
    assert all(launch_ranks(save_rank, n_save, d, n_save, 7, timeout=120.0))
    check_blocks(launch_ranks(restore_rank, n_restore, d, n_restore,
                              timeout=120.0), n_restore)

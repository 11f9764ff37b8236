"""The 2×4 cases of ``tests/test_torch_model_shard_train.py`` (which
describes them): the sharded train step of the reduced attention
families on 2 data × 4 model ranks against the reference's sharded step
in bfloat16 and against the one-device step in float32.  A file of its
own so that ``--dist loadfile`` runs its launch of 8 ranks and its
reference subprocess on another worker."""
import pytest

from test_torch_model_shard_train import check_against_one_device, \
    check_against_reference, port_for, reference_for
from torch_shard_support import ARCHS
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

HERE = ((2, 4),)


@pytest.fixture(scope="module")
def reference():
    return reference_for(HERE)


@pytest.fixture(scope="module")
def port(reference):
    return port_for(reference, HERE)


@pytest.mark.parametrize("mesh", HERE, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_reference(reference, port, arch, mesh):
    """bfloat16, the reference's own bounds (see the other file)."""
    check_against_reference(reference, port, arch, mesh)


@pytest.mark.parametrize("mesh", HERE, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_one_device(reference, port, arch, mesh):
    """Float32, against the one-device step (the MoE: against the
    reference's float32 sharded step), as the other file holds it."""
    check_against_one_device(reference, port, arch, mesh)

"""Scale-out parity on ``data=2 x fsdp=2`` (4 ranks, one row of each
4-row microbatch per rank): the port's PPO, SFT and ILQL trainers against
the JAX package's on a mesh of the same shape (the checks of
:mod:`tests.test_torch_scale_out`)."""

import pytest

from tests.test_torch_scale_out import KINDS, check_kind, shape_fixture

pytestmark = pytest.mark.torch_port

data2_fsdp2 = shape_fixture(dict(data=2, fsdp=2), 4)


@pytest.mark.parametrize("kind", KINDS)
def test_trainers_match_jax_on_data2_fsdp2(data2_fsdp2, kind):
    check_kind(data2_fsdp2, kind)

"""Scale-out parity on ``fsdp=2`` (ZeRO: parameters and AdamW state
sharded, gathered for each forward phase, gradients reduce-scattered): the
port's PPO, SFT and ILQL trainers on 2 gloo ranks against the JAX
package's on a mesh of the same shape (the checks of
:mod:`tests.test_torch_scale_out`)."""

import pytest

from tests.test_torch_scale_out import KINDS, check_kind, shape_fixture

pytestmark = pytest.mark.torch_port

fsdp2 = shape_fixture(dict(fsdp=2), 2)


@pytest.mark.parametrize("kind", KINDS)
def test_trainers_match_jax_on_fsdp2(fsdp2, kind):
    check_kind(fsdp2, kind)

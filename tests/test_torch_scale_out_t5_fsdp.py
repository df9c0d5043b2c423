"""Scale-out parity for T5 on ``fsdp=2``: the port's seq2seq PPO, ILQL and
SFT trainers on 2 gloo ranks against the JAX package's on a mesh of the
same shape (the checks of :mod:`tests.test_torch_scale_out_t5`)."""

import pytest

from tests.test_torch_scale_out_t5 import KINDS, check_kind, shape_fixture

pytestmark = pytest.mark.torch_port

fsdp2 = shape_fixture("fsdp2")


@pytest.mark.parametrize("kind", KINDS)
def test_t5_trainers_match_jax_on_fsdp2(fsdp2, kind):
    check_kind(fsdp2, kind)

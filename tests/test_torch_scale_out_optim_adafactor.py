"""Adafactor over sharded leaves in the default step on ``fsdp=2`` and
``model=2`` against optax under the JAX trainer (the checks of
:mod:`tests.test_torch_scale_out_optim`)."""

import pytest

from tests.test_torch_scale_out_optim import MESHES, check_shape, optimizer_fixture

pytestmark = pytest.mark.torch_port

adafactor = optimizer_fixture("adafactor")


@pytest.mark.parametrize("shape", list(MESHES))
def test_adafactor_matches_optax_on_a_mesh(adafactor, shape):
    check_shape(adafactor, "adafactor", shape)

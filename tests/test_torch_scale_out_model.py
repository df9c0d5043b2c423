"""Scale-out parity on ``model=2`` (tensor parallelism: column / row
parallel layers, one of the two heads per rank, the even 12-row vocab
split over the ranks): the port's PPO, SFT and ILQL trainers on 2 gloo
ranks against the JAX package's on a mesh of the same shape (the checks
of :mod:`tests.test_torch_scale_out`)."""

import pytest

from tests.test_torch_scale_out import KINDS, check_kind, shape_fixture

pytestmark = pytest.mark.torch_port

model2 = shape_fixture(dict(model=2), 2)


@pytest.mark.parametrize("kind", KINDS)
def test_trainers_match_jax_on_model2(model2, kind):
    check_kind(model2, kind)

"""The port's ROUGE scorers (``trlx_tpu_torch/utils/metrics.py``) against
the JAX package's: ``rouge``, ``rouge_scores`` and ``rouge_per_sample``
equal (``==``) on the cases of ``tests/test_utils.py`` and on
hypothesis-drawn texts. Both compute the same integer counts into the same
float expressions, so anything short of equality is a fault."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from trlx_tpu.utils import metrics as jax_metrics
from trlx_tpu_torch.utils import metrics

pytestmark = pytest.mark.torch_port

PAIRS = [("The cat sat.", "the cat sat"), ("the cat", "the cat sat on the mat"), ("dog", "the cat"),
         ("", "the cat"), ("cat the", "the cat"), ("the cat", ""), ("", "")]


@pytest.mark.parametrize("pred, ref", PAIRS)
def test_rouge_equals_the_jax_function_on_the_reference_cases(pred, ref):
    assert metrics.rouge(pred, ref) == jax_metrics.rouge(pred, ref)


def test_corpus_scores_equal_the_jax_functions():
    preds, refs = ["the cat", "dog"], ["the cat sat on the mat", "the cat"]
    assert metrics.rouge_scores(preds, refs) == jax_metrics.rouge_scores(preds, refs)
    assert metrics.rouge_per_sample(preds, refs) == jax_metrics.rouge_per_sample(preds, refs)
    assert metrics.rouge_scores([], []) == jax_metrics.rouge_scores([], [])
    assert metrics.rouge_scores(preds, refs)["rouge1"] == 0.25
    with pytest.raises(ValueError):
        metrics.rouge_scores(preds, refs[:1])


WORDS = st.sampled_from(["the", "cat", "sat", "on", "mat", "A", "dog", "7", "x-ray", "Cat.", "é", ""])
TEXT = st.lists(WORDS, max_size=14).map(" ".join) | st.text(max_size=40)


@settings(max_examples=150, deadline=None)
@given(st.lists(st.tuples(TEXT, TEXT), min_size=1, max_size=4))
def test_rouge_equals_the_jax_function_on_drawn_texts(pairs):
    preds, refs = [p for p, _ in pairs], [r for _, r in pairs]
    for p, r in pairs:
        assert metrics.rouge(p, r) == jax_metrics.rouge(p, r)
    assert metrics.rouge_scores(preds, refs) == jax_metrics.rouge_scores(preds, refs)
    assert metrics.rouge_per_sample(preds, refs) == jax_metrics.rouge_per_sample(preds, refs)

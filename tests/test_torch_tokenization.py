"""Port parity for the tokenizers the checkpoint path adds: a ``bpe://``
file trained here with ``train_and_save`` encodes and decodes seeded
strings identically in both packages, and a local HF tokenizer directory
loads through the same lazy ``transformers`` branch (pad = eos) in both.
A tokenizer named by hub name raises naming its slice."""

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

WORDS = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran", "über", "naïve", "x"]


def _texts(seed, n):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(1, 12)))) for _ in range(n)]


def test_bpe_matches_jax(tmp_path):
    from trlx_tpu.data.configs import TokenizerConfig as JaxTokConfig
    from trlx_tpu.pipeline.bpe import train_and_save as jax_train
    from trlx_tpu.pipeline.tokenization import load_tokenizer as jax_load

    from trlx_tpu_torch.data.configs import TokenizerConfig
    from trlx_tpu_torch.pipeline.bpe import BPETokenizer, train_and_save
    from trlx_tpu_torch.pipeline.tokenization import load_tokenizer

    corpus = _texts(0, 200)
    ours = train_and_save(corpus, 320, str(tmp_path / "port.json"))
    theirs = jax_train(corpus, 320, str(tmp_path / "jax.json"))
    assert ours.merges == theirs.merges and ours.vocab_size == theirs.vocab_size > 259
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()

    path = "bpe://" + str(tmp_path / "jax.json")
    ptok = load_tokenizer(TokenizerConfig(tokenizer_path=path, truncation_side="left"))
    jtok = jax_load(JaxTokConfig(tokenizer_path=path, truncation_side="left"))
    assert isinstance(ptok, BPETokenizer) and ptok.truncation_side == "left"
    texts = _texts(1, 50) + ["unseen wörds here", ""]
    for t in texts:
        ids = ptok.encode(t)
        assert ids == jtok.encode(t)
        assert ptok(t).input_ids == ids
        assert ptok.decode(ids) == jtok.decode(ids) == t
        with_specials = [1] + ids + [2]
        assert ptok.decode(with_specials, skip_special_tokens=False) == jtok.decode(
            with_specials, skip_special_tokens=False)
    assert ptok([texts[0], texts[1]]).input_ids == [ptok.encode(texts[0]), ptok.encode(texts[1])]


def test_hf_tokenizer_directory_matches_jax(tmp_path):
    tokenizers = pytest.importorskip("tokenizers")
    import transformers

    from trlx_tpu.data.configs import TokenizerConfig as JaxTokConfig
    from trlx_tpu.pipeline.tokenization import load_tokenizer as jax_load

    from trlx_tpu_torch.data.configs import TokenizerConfig
    from trlx_tpu_torch.pipeline.tokenization import load_tokenizer

    vocab = {w: i for i, w in enumerate(["<unk>", "<eos>"] + WORDS)}
    core = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="<unk>"))
    core.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=core, eos_token="<eos>", unk_token="<unk>")
    fast.save_pretrained(tmp_path / "tok")

    kw = dict(tokenizer_path=str(tmp_path / "tok"), padding_side="right", truncation_side="left")
    ptok, jtok = load_tokenizer(TokenizerConfig(**kw)), jax_load(JaxTokConfig(**kw))
    assert ptok.pad_token == ptok.eos_token == jtok.pad_token == "<eos>"
    assert (ptok.padding_side, ptok.truncation_side) == ("right", "left")
    for t in _texts(2, 10):
        assert ptok(t).input_ids == jtok(t).input_ids


def test_hub_tokenizer_name_raises_naming_its_slice():
    from trlx_tpu_torch.data.configs import TokenizerConfig
    from trlx_tpu_torch.pipeline.tokenization import load_tokenizer

    with pytest.raises(NotImplementedError, match="HF-hub slice"):
        load_tokenizer(TokenizerConfig(tokenizer_path="gpt2"))

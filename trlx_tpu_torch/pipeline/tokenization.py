"""Tokenizer layer (counterpart of ``trlx_tpu/pipeline/tokenization.py``):
the builtin offline tokenizers (copied) and HF tokenizer directories.

``tokenizer_path`` resolution:
- ``"char://<alphabet>"``  -> :class:`CharTokenizer` over the given alphabet
- ``"bytes"``              -> :class:`ByteTokenizer` (vocab 256 + specials)
- ``"bpe://<file>"``       -> :class:`trlx_tpu_torch.pipeline.bpe.BPETokenizer`
- a local directory        -> ``transformers.AutoTokenizer`` (imported here,
  lazily: the only place the port uses ``transformers``; a host without it
  raises saying so)
- anything else (a hub name) raises ``NotImplementedError``: the port reads
  no hub cache.
"""

import os
from typing import Iterable, List, Union

from trlx_tpu_torch.data.configs import TokenizerConfig


class CharTokenizer:
    """Character-level tokenizer with pad/bos/eos specials. Interface mirrors the
    subset of the HF tokenizer API the trainers use."""

    def __init__(self, alphabet: str, padding_side="left", truncation_side="right"):
        self.alphabet = alphabet
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self._offset = 3
        self._char_to_id = {ch: i + self._offset for i, ch in enumerate(alphabet)}
        self._id_to_char = {i + self._offset: ch for i, ch in enumerate(alphabet)}
        self.pad_token = "<pad>"
        self.bos_token = "<bos>"
        self.eos_token = "<eos>"
        self.padding_side = padding_side
        self.truncation_side = truncation_side
        self.vocab_size = self._offset + len(alphabet)
        self.name_or_path = f"char://{alphabet}"

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids = []
        rest = text
        # greedy-match specials so decode(encode(x)) roundtrips
        while rest:
            matched = False
            for tok, tid in (
                (self.pad_token, self.pad_token_id),
                (self.bos_token, self.bos_token_id),
                (self.eos_token, self.eos_token_id),
            ):
                if rest.startswith(tok):
                    ids.append(tid)
                    rest = rest[len(tok):]
                    matched = True
                    break
            if matched:
                continue
            ch = rest[0]
            if ch in self._char_to_id:
                ids.append(self._char_to_id[ch])
            rest = rest[1:]
        return ids

    def __call__(self, text: Union[str, List[str]], add_special_tokens: bool = False, **_):
        if isinstance(text, str):
            return _Enc(self.encode(text, add_special_tokens))
        return _BatchEnc([self.encode(t, add_special_tokens) for t in text])

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        out = []
        for i in map(int, ids):
            if i >= self._offset:
                # ids beyond the alphabet (a model with a larger vocab than
                # this tokenizer) are dropped rather than crashing the decode
                ch = self._id_to_char.get(i)
                if ch is not None:
                    out.append(ch)
            elif not skip_special_tokens:
                out.append({0: self.pad_token, 1: self.bos_token, 2: self.eos_token}[i])
        return "".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]


class ByteTokenizer(CharTokenizer):
    """UTF-8 byte-level tokenizer (vocab = 3 specials + 256 bytes)."""

    def __init__(self, padding_side="left", truncation_side="right"):
        super().__init__("", padding_side, truncation_side)
        self.vocab_size = self._offset + 256
        self.name_or_path = "bytes"

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return [b + self._offset for b in text.encode("utf-8")]

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        specials = {0: self.pad_token, 1: self.bos_token, 2: self.eos_token}
        out = []
        byte_run: list = []

        def flush():
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="ignore"))
                byte_run.clear()

        for i in map(int, ids):
            if self._offset <= i < self._offset + 256:
                byte_run.append(i - self._offset)
            elif i < self._offset:
                flush()
                if not skip_special_tokens:
                    out.append(specials[i])
            # ids beyond the byte range (e.g. a model with a larger vocab than
            # this tokenizer) are dropped rather than crashing the decode
        flush()
        return "".join(out)


class _Enc:
    def __init__(self, input_ids):
        self.input_ids = input_ids


class _BatchEnc:
    def __init__(self, input_ids):
        self.input_ids = input_ids


def load_tokenizer(config: TokenizerConfig):
    """Resolve a tokenizer from a :class:`TokenizerConfig`."""
    path = config.tokenizer_path
    if path.startswith("char://"):
        return CharTokenizer(path[len("char://"):], config.padding_side, config.truncation_side)
    if path == "bytes":
        return ByteTokenizer(config.padding_side, config.truncation_side)
    if path.startswith("bpe://"):
        from trlx_tpu_torch.pipeline.bpe import BPETokenizer

        return BPETokenizer.load(path[len("bpe://"):], config.padding_side, config.truncation_side)
    if not os.path.isdir(path):
        raise NotImplementedError(
            f"trlx_tpu_torch does not port tokenizers by hub name ({path!r}) yet: HF-hub slice; "
            "use a local tokenizer directory, 'bpe://<file>', 'char://<alphabet>' or 'bytes'"
        )
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            f"tokenizer_path {path!r} is an HF tokenizer directory, which needs the `transformers` "
            "package, and this host does not have it; use 'bpe://<file>', 'char://<alphabet>' or 'bytes'"
        ) from e
    tok = transformers.AutoTokenizer.from_pretrained(path, **config.tokenizer_extra_kwargs)
    tok.padding_side = config.padding_side
    tok.truncation_side = config.truncation_side
    if tok.pad_token is None:
        tok.pad_token = tok.eos_token
    return tok

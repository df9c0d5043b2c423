"""From-scratch byte-level BPE (a copy of ``trlx_tpu/pipeline/bpe.py``): a
trainable tokenizer for hosts with no HF vocabulary files. It is built the
way GPT-2's own tokenizer was: byte-level BPE
(Sennrich-style merges over UTF-8 bytes, words pre-split on whitespace with
the leading-space convention) TRAINED on the task corpus, saved as JSON, and
loaded via the ``bpe://<path>`` tokenizer scheme
(:func:`trlx_tpu_torch.pipeline.tokenization.load_tokenizer`).

Id layout matches the other local tokenizers: 0/1/2 = pad/bos/eos, 3..258 the
256 byte symbols, 259+ the learned merges — so any saved model keeps decoding
even under a tokenizer with fewer merges.
"""

import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple, Union

_OFFSET = 3  # pad/bos/eos
_NUM_BYTES = 256


def _pre_split(text: str) -> List[str]:
    """GPT-2-style pre-tokenization, simplified: words keep their leading
    space so merges never cross word boundaries."""
    words: List[str] = []
    cur = ""
    for ch in text:
        if ch == " " and cur:
            words.append(cur)
            cur = " "
        else:
            cur += ch
    if cur:
        words.append(cur)
    return words


def train_bpe(texts: Sequence[str], vocab_size: int = 1024) -> List[Tuple[int, int]]:
    """Learn BPE merges over the corpus; returns the ordered merge list.

    Standard word-frequency training: each distinct word is a byte-symbol
    sequence weighted by its corpus count; every round merges the most
    frequent adjacent pair into a new symbol until ``vocab_size`` is reached.
    """
    n_merges = max(0, vocab_size - _OFFSET - _NUM_BYTES)
    word_freq = Counter()
    for t in texts:
        word_freq.update(_pre_split(t))
    # each word as a tuple of symbol ids (bytes offset to final id space)
    words: List[List[int]] = []
    freqs: List[int] = []
    for w, f in word_freq.items():
        words.append([b + _OFFSET for b in w.encode("utf-8")])
        freqs.append(f)

    merges: List[Tuple[int, int]] = []
    next_id = _OFFSET + _NUM_BYTES
    for _ in range(n_merges):
        pair_counts: Counter = Counter()
        for seq, f in zip(words, freqs):
            for a, b in zip(seq, seq[1:]):
                pair_counts[(a, b)] += f
        if not pair_counts:
            break
        (a, b), count = pair_counts.most_common(1)[0]
        if count < 2:
            break
        merges.append((a, b))
        for i, seq in enumerate(words):
            if len(seq) < 2:
                continue
            out = []
            j = 0
            while j < len(seq):
                if j + 1 < len(seq) and seq[j] == a and seq[j + 1] == b:
                    out.append(next_id)
                    j += 2
                else:
                    out.append(seq[j])
                    j += 1
            words[i] = out
        next_id += 1
    return merges


class BPETokenizer:
    """Byte-level BPE with the local-tokenizer interface the trainers use."""

    def __init__(self, merges: Sequence[Tuple[int, int]],
                 padding_side: str = "left", truncation_side: str = "right",
                 name: str = "bpe"):
        self.pad_token_id, self.bos_token_id, self.eos_token_id = 0, 1, 2
        self.pad_token, self.bos_token, self.eos_token = "<pad>", "<bos>", "<eos>"
        self.padding_side = padding_side
        self.truncation_side = truncation_side
        self.merges = [tuple(m) for m in merges]
        self.ranks: Dict[Tuple[int, int], int] = {m: r for r, m in enumerate(self.merges)}
        self.merged_id: Dict[Tuple[int, int], int] = {
            m: _OFFSET + _NUM_BYTES + r for r, m in enumerate(self.merges)
        }
        # token id -> byte string, for decode
        self._bytes: Dict[int, bytes] = {_OFFSET + i: bytes([i]) for i in range(_NUM_BYTES)}
        for (a, b), tid in self.merged_id.items():
            self._bytes[tid] = self._bytes[a] + self._bytes[b]
        self.vocab_size = _OFFSET + _NUM_BYTES + len(self.merges)
        self.name_or_path = name
        self._word_cache: Dict[str, List[int]] = {}

    # ------------------------------------------------------------- encoding
    def _encode_word(self, word: str) -> List[int]:
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        seq = [b + _OFFSET for b in word.encode("utf-8")]
        while len(seq) > 1:
            best_rank, best_i = None, -1
            for i, pair in enumerate(zip(seq, seq[1:])):
                r = self.ranks.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            pair = (seq[best_i], seq[best_i + 1])
            seq = seq[:best_i] + [self.merged_id[pair]] + seq[best_i + 2:]
        if len(self._word_cache) < 65536:
            self._word_cache[word] = seq
        return seq

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        ids: List[int] = []
        for w in _pre_split(text):
            ids.extend(self._encode_word(w))
        return ids

    def __call__(self, text: Union[str, List[str]], add_special_tokens: bool = False, **_):
        from trlx_tpu_torch.pipeline.tokenization import _BatchEnc, _Enc

        if isinstance(text, str):
            return _Enc(self.encode(text, add_special_tokens))
        return _BatchEnc([self.encode(t, add_special_tokens) for t in text])

    # ------------------------------------------------------------- decoding
    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        specials = {0: self.pad_token, 1: self.bos_token, 2: self.eos_token}
        out: List[str] = []
        run = b""
        for i in map(int, ids):
            bs = self._bytes.get(i)
            if bs is not None:
                run += bs
            elif i < _OFFSET:
                if run:
                    out.append(run.decode("utf-8", errors="ignore"))
                    run = b""
                if not skip_special_tokens:
                    out.append(specials[i])
            # unknown ids (model vocab larger than tokenizer) are dropped
        if run:
            out.append(run.decode("utf-8", errors="ignore"))
        return "".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    # ----------------------------------------------------------- persistence
    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"merges": self.merges, "vocab_size": self.vocab_size}, f)
        return path

    @classmethod
    def load(cls, path: str, padding_side: str = "left", truncation_side: str = "right"):
        with open(path) as f:
            data = json.load(f)
        return cls(data["merges"], padding_side, truncation_side, name=f"bpe://{path}")


def train_and_save(texts: Sequence[str], vocab_size: int, path: str) -> BPETokenizer:
    tok = BPETokenizer(train_bpe(texts, vocab_size))
    tok.save(path)
    return BPETokenizer.load(path)

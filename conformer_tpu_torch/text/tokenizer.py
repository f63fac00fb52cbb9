"""Rule-based grapheme tokenizer for Vietnamese/English ASR.

This package's own copy of conformer_tpu/text/tokenizer.py (framework-free;
kept in step with it): the reference's vocab assembly order (vi.json yields
370 ids, pad = blank = 0), greedy longest-match grapheme segmentation,
QU/GI prefix handling, digraph substitutions, text cleaning, and greedy CTC
text assembly in which blank/unk frames do not reset the repeat-collapse
state (the device-side collapse in conformer_tpu_torch.ops.ctc implements
the same rule). Spec files live in ``conformer_tpu_torch/text/specs/``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

_SPEC_DIR = os.path.join(os.path.dirname(__file__), "specs")

_GROUP_KEYS = (
    "single_vowel", "composed_vowel", "single_consonant", "no_split",
    "voiced", "voiceless", "voiced_special", "voiceless_special",
    "exceptions", "short_item", "single_suffix", "composed_suffix",
    "no_split_suffix", "mix",
)

DEFAULT_PUNCS = r"([:./,?!@#$%^&=`~;*\(\)\[\]\"\\])"


class GraphemeTokenizer:
    """Grapheme tokenizer over a generated spec file.

    `spec` may be a language name resolving to a bundled spec ('vi', 'en'),
    a path to a spec JSON, or a loaded spec dict.
    """

    def __init__(self, spec: "str | Dict" = "vi",
                 pad_token: str = "<PAD>", delim_token: str = "|",
                 unk_token: str = "<UNK>", puncs: str = DEFAULT_PUNCS) -> None:
        if isinstance(spec, str):
            path = spec
            if not os.path.exists(path):
                path = os.path.join(_SPEC_DIR, f"{spec}.json")
            with open(path, encoding="utf8") as f:
                spec = json.load(f)
        groups = {k: list(spec.get("groups", {}).get(k, [])) for k in _GROUP_KEYS}
        self.groups = groups
        self.replace_dict: Dict[str, str] = dict(spec.get("replace", {}))

        self.pad_token, self.delim_token, self.unk_token = pad_token, delim_token, unk_token
        self.vocab: List[str] = (
            [pad_token]
            + groups["single_vowel"] + groups["composed_vowel"]
            + groups["single_consonant"] + groups["no_split"]
            + groups["voiced"] + groups["voiceless"]
            + groups["voiced_special"] + groups["voiceless_special"]
            + groups["exceptions"] + groups["short_item"]
            + groups["no_split_suffix"]
            + [delim_token, unk_token]
        )
        self._token_to_id = {tok: i for i, tok in enumerate(self.vocab)}
        self.pad_id = self._token_to_id[pad_token]
        self.unk_id = self._token_to_id[unk_token]
        self.delim_id = self._token_to_id[delim_token]

        self.single_vowels = set(groups["single_vowel"])
        self.single_consonants = set(groups["single_consonant"])
        self.mix = groups["mix"]
        self.slide_patterns = set(
            groups["single_vowel"] + groups["composed_vowel"]
            + groups["single_consonant"] + groups["no_split"]
        )
        self._decode_patterns = [
            (re.compile(re.escape(v) + r"(\S)"), k + r"\1")
            for k, v in self.replace_dict.items()
        ]
        self._puncs = re.compile(puncs)
        self._spaces = re.compile(r"\s\s+")

    # ---- vocab ------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def token_id(self, token: str) -> int:
        return self._token_to_id.get(token, self.unk_id)

    # ---- text -> graphemes ------------------------------------------------
    def clean_text(self, sentence: str) -> str:
        sentence = self._puncs.sub(" ", sentence)
        sentence = self._spaces.sub(" ", sentence)
        return sentence.strip()

    def spec_replace(self, word: str) -> str:
        """First applicable digraph substitution (single occurrence only),
        skipped when the tail is a lone single vowel (processor.py:218-226)."""
        for key, value in self.replace_dict.items():
            parts = word.split(key)
            if len(parts) == 2:
                if parts[1] in self.single_vowels:
                    return word
                return word.replace(key, value)
        return word

    def spec_decode(self, text: str) -> str:
        for pattern, repl in self._decode_patterns:
            text = pattern.sub(repl, text)
        return text

    def slide_graphemes(self, text: str, n_grams: int = 4,
                        reverse: bool = False) -> List[str]:
        """Greedy longest-match segmentation with an n-gram window
        (processor.py:254-294, including its window-shrink rules)."""
        if len(text) == 1:
            return [text] if text in self.slide_patterns else [self.unk_token]
        if reverse:
            text = text[::-1]
        if len(text) - 1 < n_grams:
            n_grams = len(text)
        graphemes: List[str] = []
        start, window = 0, n_grams
        while start < len(text):
            item = text[start: start + window]
            if reverse:
                item = item[::-1]
            if item in self.slide_patterns:
                graphemes.append(item)
            elif window == 1:
                graphemes.append(self.unk_token)
            else:
                window -= 1
                continue
            start += window
            window = min(n_grams, len(text) - start)
        if reverse:
            graphemes.reverse()
        return graphemes

    def word2graphemes(self, word: str, n_grams: int = 3,
                       reverse: bool = False) -> List[str]:
        """Segment one word, with QU/GI prefix disambiguation
        (processor.py:166-185)."""
        first_item: Optional[str] = None
        for item in self.mix:
            if word.startswith(item):
                if len(word) == len(item):
                    return list(item)
                if word[len(item)] in self.single_consonants:
                    # e.g. GIM -> G + IM: keep only the first letter.
                    first_item = item[0]
                    word = word[1:]
                else:
                    first_item = item
                    word = word[len(item):]
                break
        word = self.spec_replace(word)
        graphemes = self.slide_graphemes(word, n_grams=n_grams, reverse=reverse)
        if first_item is not None:
            graphemes = [first_item] + graphemes
        return graphemes

    def sentence2graphemes(self, sentence: str) -> List[str]:
        sentence = self.clean_text(sentence.upper())
        words = sentence.split(" ")
        graphemes: List[str] = []
        for index, word in enumerate(words):
            graphemes.extend(self.word2graphemes(word))
            if index != len(words) - 1:
                graphemes.append(self.delim_token)
        return graphemes

    # ---- graphemes <-> ids ------------------------------------------------
    def graphemes2ids(self, graphemes: Iterable[str]) -> List[int]:
        return [self.token_id(g) for g in graphemes]

    def encode(self, sentence: str) -> List[int]:
        return self.graphemes2ids(self.sentence2graphemes(sentence))

    def decode_ids(self, ids: Sequence[int]) -> str:
        """Stop at pad; delim -> space (processor.py:233-246)."""
        out = []
        for t in ids:
            t = int(t)
            if t == self.pad_id:
                break
            out.append(" " if t == self.delim_id else self.vocab[t])
        return "".join(out)

    # ---- CTC text assembly ------------------------------------------------
    def collapsed_ids_to_text(self, ids: Sequence[int], count: Optional[int] = None) -> str:
        """Assemble text from already-collapsed ids (device greedy_collapse
        output): join, delim -> space, then spec_decode (processor.py:321-322)."""
        if count is not None:
            ids = ids[:int(count)]
        pieces = []
        for t in ids:
            t = int(t)
            if t in (self.pad_id, self.unk_id):
                continue
            pieces.append(self.vocab[t])
        text = "".join(pieces).replace(self.delim_token, " ")
        return self.spec_decode(text)

    def greedy_decode(self, ids_or_logits: np.ndarray) -> str:
        """Host-side reference collapse for tests/small inputs
        (processor.py:301-322)."""
        arr = np.asarray(ids_or_logits)
        if arr.ndim == 2:
            arr = arr.argmax(axis=-1)
        pieces: List[str] = []
        prev_id: Optional[int] = None
        for t in arr:
            t = int(t)
            if t in (self.pad_id, self.unk_id):
                continue
            if prev_id != t:
                prev_id = t
                pieces.append(self.vocab[t])
        text = "".join(pieces).replace(self.delim_token, " ")
        return self.spec_decode(text)

    def batch_greedy_decode(self, logits: np.ndarray) -> List[str]:
        return [self.greedy_decode(item) for item in logits]

    # ---- batching ---------------------------------------------------------
    def encode_batch(self, sentences: Sequence[str], max_len: Optional[int] = None
                     ) -> "tuple[np.ndarray, np.ndarray]":
        """-> (padded ids (B, N), lengths (B,)), padded with pad_id."""
        encoded = [self.encode(s) for s in sentences]
        lengths = np.array([len(e) for e in encoded], dtype=np.int32)
        n = max_len if max_len is not None else max(1, int(lengths.max(initial=1)))
        out = np.full((len(encoded), n), self.pad_id, dtype=np.int32)
        for i, e in enumerate(encoded):
            out[i, : min(len(e), n)] = e[:n]
        return out, np.minimum(lengths, n)


def load_tokenizer(name_or_path: str = "vi", **kwargs) -> GraphemeTokenizer:
    return GraphemeTokenizer(name_or_path, **kwargs)

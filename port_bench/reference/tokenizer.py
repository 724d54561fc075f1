"""Text frontend: a pure-Python BPE tokenizer over the bundled vocab tables.

Counterpart of ``detail_tts_tpu/text/tokenizer.py`` that needs no HF
``tokenizers``: it reads the same four JSON tables (copied under
``vocabs/``) and reproduces what ``Tokenizer.from_file(...).encode`` does for
them.  The tables are model ``BPE`` (255 tokens, ~200 merges, unknown chars
map to ``[UNK]`` one by one, no fusing), a ``Whitespace`` pre-tokenizer and
three added tokens ``[STOP]/[UNK]/[SPACE]`` that are split out of the raw
text before pre-tokenization.  ``decode`` inverts the same tables (HF's
decode of a table with no decoder, then the JAX package's clean-up), and
:func:`train_bpe` makes a new table with ``tokenizers``, imported where it
is called (the training host has it, the card's machine need not).
:class:`CharTokenizer` is the explicit ``"char"`` opt-in, a different text
frontend.
"""
from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

_VOCAB_DIR = os.path.dirname(os.path.abspath(__file__))
BUNDLED_VOCABS = ("zh", "en", "jp", "kr")

_REPLACEMENTS = {
    "{": "(", "}": ")", "[": "(", "]": ")",
    "`": "'", "—": "-", "ʼ": "'",
}
_REPLACE_RE = re.compile("|".join(re.escape(k) for k in sorted(
    _REPLACEMENTS, key=len, reverse=True)), flags=re.DOTALL)
_EXTRANEOUS_RE = re.compile(r"^[@#%_=\$\^&\*\+\\]$")


def resolve_vocab(path: str) -> str:
    """An existing file, a bundled language code, or a path whose basename
    names a bundled table (e.g. ``bpe_tokenizers/zh_tokenizer.json``)."""
    if os.path.isfile(path):
        return path
    if path in BUNDLED_VOCABS:
        return os.path.join(_VOCAB_DIR, f"{path}_tokenizer.json")
    bundled = os.path.join(_VOCAB_DIR, os.path.basename(path))
    if os.path.isfile(bundled):
        return bundled
    raise FileNotFoundError(f"tokenizer vocab {path!r} not found "
                            f"(bundled: {BUNDLED_VOCABS})")


def normalize_punctuation(txt: str) -> str:
    """Reference ``remove_extraneous_punctuation`` (voice_tokenizer.py:15-28)."""
    txt = _REPLACE_RE.sub(lambda m: _REPLACEMENTS[m.group(0)], txt)
    return _EXTRANEOUS_RE.sub("", txt)


def _is_word(ch: str) -> bool:
    """Unicode ``\\w`` as the Rust regex of the Whitespace pre-tokenizer has
    it: letters, marks, decimal/letter numbers, connector punctuation and
    the joiners."""
    cat = unicodedata.category(ch)
    return (cat[0] in "LM" or cat in ("Nd", "Nl", "Pc")
            or ch in "‌‍")


def whitespace_split(text: str) -> List[str]:
    """HF ``Whitespace`` pre-tokenizer: runs of word characters and runs of
    other non-space characters, in order (regex ``\\w+|[^\\w\\s]+``)."""
    out: List[str] = []
    cur: List[str] = []
    kind = None
    for ch in text:
        k = None if ch.isspace() else _is_word(ch)
        if k != kind and cur:
            out.append("".join(cur))
            cur = []
        kind = k
        if k is not None:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


class VoiceBpeTokenizer:
    """BPE encode over a ``tokenizers``-format vocab file."""

    def __init__(self, vocab_file: str):
        with open(vocab_file, encoding="utf-8") as f:
            data = json.load(f)
        model = data["model"]
        if model["type"] != "BPE" or data["pre_tokenizer"]["type"] != "Whitespace":
            raise ValueError(f"{vocab_file}: only BPE + Whitespace tables")
        self.vocab: Dict[str, int] = model["vocab"]
        self.unk_id = self.vocab[model["unk_token"]]
        self.ranks: Dict[Tuple[str, str], int] = {}
        for i, merge in enumerate(model["merges"]):
            a, b = merge.split(" ") if isinstance(merge, str) else merge
            self.ranks[(a, b)] = i
        self.added = {t["content"]: t["id"] for t in data["added_tokens"]}
        self.id_to_token = {i: t for t, i in {**self.vocab, **self.added}.items()}
        self._added_re = re.compile("|".join(
            re.escape(t) for t in sorted(self.added, key=len, reverse=True)))
        self._cache: Dict[str, List[int]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _bpe(self, word: str) -> List[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        syms = list(word)
        while len(syms) > 1:
            best = None
            for i in range(len(syms) - 1):
                r = self.ranks.get((syms[i], syms[i + 1]))
                if r is not None and (best is None or r < best[0]):
                    best = (r, i)
            if best is None:
                break
            i = best[1]
            syms[i:i + 2] = [syms[i] + syms[i + 1]]
        ids = [self.vocab.get(s, self.unk_id) for s in syms]
        self._cache[word] = ids
        return ids

    def _encode_plain(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in whitespace_split(text):
            ids.extend(self._bpe(word))
        return ids

    def encode(self, txt: str) -> List[int]:
        txt = normalize_punctuation(txt).replace(" ", "[SPACE]")
        ids: List[int] = []
        pos = 0
        for m in self._added_re.finditer(txt):
            ids.extend(self._encode_plain(txt[pos:m.start()]))
            ids.append(self.added[m.group(0)])
            pos = m.end()
        ids.extend(self._encode_plain(txt[pos:]))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """Ids -> text as the JAX package decodes (``tokenizer.py:87``): the
        tokens joined (HF joins them with spaces when a table has no
        decoder, and the spaces are then removed), ``[STOP]`` and ``[UNK]``
        dropped, ``[SPACE]`` made a space; ids outside the table are
        skipped, as HF skips them."""
        txt = "".join(self.id_to_token.get(int(i), "") for i in ids)
        for special in ("[STOP]", "[UNK]"):
            txt = txt.replace(special, "")
        return txt.replace("[SPACE]", " ")


class CharTokenizer:
    """Char-level tokenizer with the BPE tables' special-token layout: an
    explicit opt-in (``make_tokenizer("char")``), never a silent substitute.

    IDs: 0=[STOP], 1=[UNK], 2=[SPACE]; then lower-case ASCII letters, digits
    and the punctuation of pinyin text, within the GPT's 256-token text
    embedding (config_24k.json:70)."""

    _ALPHABET = (
        "abcdefghijklmnopqrstuvwxyz0123456789"
        "!:~;.\"/,-()'?。，？：；’‘”“、！"
    )

    def __init__(self):
        self.stoi = {"[STOP]": 0, "[UNK]": 1, "[SPACE]": 2}
        for ch in self._ALPHABET:
            if ch not in self.stoi:
                self.stoi[ch] = len(self.stoi)
        self.itos = {v: k for k, v in self.stoi.items()}

    @property
    def vocab_size(self) -> int:
        return len(self.stoi)

    def encode(self, txt: str) -> List[int]:
        txt = normalize_punctuation(txt.lower())
        return [2 if ch == " " else self.stoi.get(ch, 1) for ch in txt]

    def decode(self, ids) -> str:
        parts = []
        for i in ids:
            tok = self.itos.get(int(i), "")
            if tok == "[SPACE]":
                parts.append(" ")
            elif tok not in ("[STOP]", "[UNK]"):
                parts.append(tok)
        return "".join(parts)


def train_bpe(lines: Sequence[str], save_path: str, vocab_size: int = 255) -> None:
    """Train a BPE table of this format on ``lines`` and save it as JSON at
    ``save_path`` (reference ``train()``, voice_tokenizer.py:57): the three
    added tokens, ``[UNK]`` for unknown characters, a ``Whitespace``
    pre-tokenizer, lines lower-cased and punctuation-normalised first.
    Needs the ``tokenizers`` package, imported here."""
    from tokenizers import Tokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import BpeTrainer

    trainer = BpeTrainer(special_tokens=["[STOP]", "[UNK]", "[SPACE]"],
                         vocab_size=vocab_size)
    tokenizer = Tokenizer(BPE(unk_token="[UNK]"))
    tokenizer.pre_tokenizer = Whitespace()

    def batches(size: int = 1000):
        for i in range(0, len(lines), size):
            yield [normalize_punctuation(t.lower()) for t in lines[i:i + size]]

    tokenizer.train_from_iterator(batches(), trainer, length=len(lines))
    tokenizer.save(save_path)


def make_tokenizer(spec: str):
    """The tokenizer of a config's ``tokenizer_vocab``: ``"char"`` selects
    :class:`CharTokenizer`, anything else must resolve to a BPE table."""
    if spec == "char":
        return CharTokenizer()
    return VoiceBpeTokenizer(resolve_vocab(spec))

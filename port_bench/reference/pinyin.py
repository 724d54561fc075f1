"""Chinese text -> TONE3 pinyin from the bundled table.

Counterpart of ``detail_tts_tpu/text/pinyin.py`` restricted to its bundled
path (``bundled_lazy_pinyin``): the reference calls
``lazy_pinyin(text, style=Style.TONE3, neutral_tone_with_five=True)``, and
the table ``pinyin_data.json`` (copied from the JAX package) reproduces it
without ``pypinyin``: longest-match phrases first, then per-char readings;
runs of non-hanzi characters stay verbatim as single items; hanzi absent
from the table pass through.  :func:`coverage` is the table's diagnostic.
"""
from __future__ import annotations

import json
import os
import re
from functools import lru_cache
from typing import Dict, List, Tuple

_CJK_RE = re.compile(r"[一-鿿㐀-䶿]")
_DATA_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "pinyin_data.json")


def has_cjk(text: str) -> bool:
    return _CJK_RE.search(text) is not None


@lru_cache(maxsize=1)
def _load_table() -> Tuple[Dict[str, str], Dict[str, list], int]:
    with open(_DATA_PATH, encoding="utf-8") as f:
        data = json.load(f)
    phrases = data["phrases"]
    return data["chars"], phrases, max((len(w) for w in phrases), default=1)


def bundled_lazy_pinyin(text: str) -> List[str]:
    """One item per hanzi (or phrase syllable), one per non-hanzi run."""
    chars, phrases, max_len = _load_table()
    out: List[str] = []
    other: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if not _CJK_RE.match(ch):
            other.append(ch)
            i += 1
            continue
        if other:
            out.append("".join(other))
            other = []
        for width in range(min(max_len, n - i), 1, -1):
            word = text[i:i + width]
            if word in phrases:
                out.extend(phrases[word])
                i += width
                break
        else:
            out.append(chars.get(ch, ch))
            i += 1
    if other:
        out.append("".join(other))
    return out


def to_pinyin(text: str) -> str:
    """Romanise ``text`` as the reference does, with surrounding spaces."""
    if has_cjk(text):
        text = " ".join(bundled_lazy_pinyin(text))
    return " " + text + " "


def coverage(text: str) -> Tuple[int, List[str]]:
    """(the number of hanzi in ``text``, those in neither the table's
    characters nor its phrases): the bundled table's diagnostic."""
    chars, phrases, _ = _load_table()
    cjk = [c for c in text if _CJK_RE.match(c)]
    in_phrase = set("".join(phrases))
    return len(cjk), [c for c in cjk if c not in chars and c not in in_phrase]

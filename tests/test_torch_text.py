"""Port text frontend vs the JAX package's: pure-Python BPE ids equal the HF
``tokenizers`` ids on all four bundled vocabs; bundled pinyin is identical."""
import pytest

from detail_tts_tpu.text.pinyin import bundled_lazy_pinyin as jax_pinyin
from detail_tts_tpu.text.tokenizer import make_tokenizer as jax_tokenizer
from detail_tts_tpu_torch.text.pinyin import bundled_lazy_pinyin, to_pinyin
from detail_tts_tpu_torch.text.tokenizer import make_tokenizer

TEXTS = [
    " ni3 hao3 , shi4 jie4 . ",
    "Hello,  world!  It's 3:45pm -- ok?",
    "zhe4 shi4 yi2 ge4 ce4 shi4 [SPACE] [STOP] {x} `q` — done",
    "unknown: é ß ø ☃ 😀 ½ ² _under_score_ a_b",
    "konnichiwa, ohayou gozaimasu. annyeonghaseyo!!",
    "  leading and trailing spaces  ",
    "tabs\tand\nnewlines mixed\r\nin",
    "numbers 12345 67 8.9 and #hash @at %pct",
    "",
]


@pytest.mark.parametrize("lang", ["zh", "en", "jp", "kr"])
def test_bpe_ids_match_hf_tokenizers(lang):
    ours, ref = make_tokenizer(lang), jax_tokenizer(lang)
    assert ours.vocab_size == ref.vocab_size
    for text in TEXTS:
        assert ours.encode(text) == ref.encode(text), text
    # the serving path encodes pinyin of Chinese text
    for text in ("你好，世界。", "今天天气很好，我们去公园吧！", "中文 English 混合 123"):
        py = to_pinyin(text)
        assert ours.encode(py) == ref.encode(py), text


def test_bundled_pinyin_matches():
    for text in ("你好，世界。", "银行行长说长江很长。", "重庆的重量", "abc 中文 def",
                 "㐀䶿 unknown hanzi", "一二三四五六七八九十", ""):
        assert bundled_lazy_pinyin(text) == jax_pinyin(text), text
    assert to_pinyin("ni3 hao3") == " ni3 hao3 "

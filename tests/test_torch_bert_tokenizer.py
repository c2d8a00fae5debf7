"""The port's WordPiece tokenizer gives `transformers.BertTokenizer`'s
tokens and ids on a synthetic vocab.txt laid out as chinese-roberta's
([PAD] 0, [unused*], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103), over zh,
mixed and punctuation text."""

import numpy as np
import pytest

from gpt_sovits_tpu_torch.text.bert_tokenizer import BertTokenizer

transformers = pytest.importorskip("transformers")

VOCAB = (
    ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    + list("，。！？、：；“”（）《》,.!?-'\"%$#@~…—")
    + list("我们你好银行长今天是年月日中国人一二三四五六七八九十零百千万的了在用工作点分钟气温度")
    + ["hello", "world", "##s", "ip", "##hone", "iphone", "cafe", "##ing", "test", "un", "##aff", "##able",
       "a", "b", "c", "##b", "##c", "2024", "20", "##24", "ok", "gpu"]
)

TEXTS = [
    "我们在用iPhone工作，你好！",
    "今天是2024年3月5日。气温25.5度",
    "Hello, WORLD's café testing... unaffable OK?",
    "银行行长：“你好”（测试）《书名》——完！",
    "a\tb　c  ab 　x\x00y�z",
    "Ünïcödé ﬁ naïve — “quoted” ¿qué? GPUs",
    "好[MASK]的[UNK]测试[CLS]",
    "𠀀𪜀 丽 ＡＢＣ１２３",
    "x" * 120 + " 我",
]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    path = tmp_path_factory.mktemp("bert") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return transformers.BertTokenizer(str(path)), BertTokenizer(str(path))


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_tokens_and_ids_equal(tokenizers, i):
    hf, port = tokenizers
    text = TEXTS[i]
    assert port.tokenize(text) == hf.tokenize(text)
    want = hf(text, return_tensors="np")["input_ids"]
    got = port(text, return_tensors="np")["input_ids"]
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 101 and got[0, -1] == 102


def test_token_list_and_ids(tokenizers):
    hf, port = tokenizers
    from_list = BertTokenizer(VOCAB)
    toks = ["[CLS]", "我", "##s", "nope", "[SEP]"]
    assert from_list.convert_tokens_to_ids(toks) == port.convert_tokens_to_ids(toks) == hf.convert_tokens_to_ids(toks)
    assert port.convert_tokens_to_ids("[PAD]") == 0 and len(port) == len(VOCAB)

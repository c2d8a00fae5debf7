"""The port's g2pW (on its torch ONNX executor and WordPiece tokenizer)
against the JAX package's, over the synthetic G2PWModel bundle of
tests/test_g2pw.py written with the port's `encode_model`: the same
predictions, the same `correct` overlay, and `enable` routes the port's
`clean_text_zh` as the JAX one routes its own."""

import json

import numpy as np
import pytest

from gpt_sovits_tpu.text import g2pw as jg2pw
from gpt_sovits_tpu.text.chinese import clean_text_zh as j_clean_zh
from gpt_sovits_tpu_torch.text import g2pw as pg2pw
from gpt_sovits_tpu_torch.text.bert_tokenizer import BertTokenizer
from gpt_sovits_tpu_torch.text.chinese import _g2pw_segment, clean_text_zh
from gpt_sovits_tpu_torch.utils.onnx_lite import Graph, Node, encode_model

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "长", "行", "好", "我", "们", "马", "银", "a", "b"]


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("g2pw")
    d = tmp / "G2PWModel"
    d.mkdir()
    # labels sorted: CH2, H2, X2, ZH3
    (d / "POLYPHONIC_CHARS.txt").write_text("长\tCH2\n长\tZH3\n行\tX2\n行\tH2", encoding="utf-8")
    (d / "MONOPHONIC_CHARS.txt").write_text("好\tHAO3", encoding="utf-8")
    (d / "bopomofo_to_pinyin_wo_tune_dict.json").write_text(
        json.dumps({"CH": "chang", "ZH": "zhang", "X": "xing", "H": "hang", "HAO": "hao"}), encoding="utf-8"
    )
    (d / "char_bopomofo_dict.json").write_text("{}", encoding="utf-8")
    (d / "config.py").write_text("use_mask = True\nuse_char_phoneme = False\n", encoding="utf-8")
    # chars sorted: 行 (0) -> X2, 长 (1) -> ZH3
    table = np.array([[0.0, 0.0, 5.0, 0.0], [0.0, 0.0, 0.0, 5.0]], np.float32)
    g = Graph(
        nodes=[
            Node("Gather", ["table", "char_ids"], ["logits"], {"axis": 0}),
            Node("Mul", ["logits", "phoneme_mask"], ["masked"], {}),
            Node("Softmax", ["masked"], ["probs"], {"axis": -1}),
        ],
        initializers={"table": table},
        inputs=["input_ids", "token_type_ids", "attention_mask", "phoneme_mask", "char_ids", "position_ids"],
        outputs=["probs"],
    )
    (d / "g2pW.onnx").write_bytes(encode_model(g))
    vf = tmp / "vocab.txt"
    vf.write_text("\n".join(VOCAB), encoding="utf-8")
    return str(d), BertTokenizer(str(vf))


SENTENCES = ["我长好行", "银行行长", "马好", "长长行行好"]


def test_predictions_equal(bundle):
    d, tok = bundle
    jm, pm = jg2pw.G2PW(d, tok), pg2pw.G2PW(d, tok, device="cpu")
    got = pm(SENTENCES)
    assert got == jm(SENTENCES)
    assert got[0] == [None, "zhang3", "hao3", "xing2"]


def test_correct_overlay_equal(bundle):
    d, tok = bundle
    jm, pm = jg2pw.G2PW(d, tok), pg2pw.G2PW(d, tok, device="cpu")
    base = ["wo3", "chang2", "hao4", "hang2"]
    assert pm.correct("我长好行", base) == jm.correct("我长好行", base) == ["wo3", "zhang3", "hao3", "xing2"]


def test_enable_routes_clean_text_zh(bundle):
    d, tok = bundle
    text = "银行行长很好。"
    plain = clean_text_zh(text)
    assert _g2pw_segment("长行") is None  # disabled: no overlay
    pg2pw.enable(d, tok, device="cpu")
    jg2pw.enable(d, tok)
    try:
        assert pg2pw.active() is not None
        assert _g2pw_segment("长行") == ["zhang3", "xing2"]
        got = clean_text_zh(text)
        assert got == j_clean_zh(text)
        assert got != plain  # the bundle's readings were taken
    finally:
        pg2pw.disable()
        jg2pw.disable()
    assert pg2pw.active() is None and clean_text_zh(text) == plain

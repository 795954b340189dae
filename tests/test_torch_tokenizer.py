"""The port's tokenizer against the JAX package's on the real fixtures.

tests/fixtures/ holds three HF-produced tokenizer.json files and golden
strings; both the greedy trie and the exact-BPE path (merge ranks) must
give the JAX package's ids and decodes on every case, and the port must
build its tokenizer from a checkpoint the same way.
"""

import json
import os

import pytest

from yalm_tpu.convert import load_merges, load_tokens, pack_tokens
from yalm_tpu.tokenizer import Tokenizer as JaxTokenizer
from yalm_tpu_torch.codec.format import read_yalm, write_yalm
from yalm_tpu_torch.tokenizer import Tokenizer

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
STYLES = ["llama_style", "gpt2_style", "llama3_style"]
EXTRA = ["it's the dog's    toy\n\nnew  lines", "½⅓⅔ numbers", "tab\tsep\tvals ",
         "  ", "\n", "mixed ÿ bytes", "<0x41> literal fallback piece", ""]


def _load(style):
    with open(os.path.join(FIX, "tokenizer_golden.json")) as f:
        golden = json.load(f)[style]
    path = os.path.join(FIX, f"{style}_tokenizer.json")
    return path, load_tokens(path, golden["vocab_size"]), golden


@pytest.mark.parametrize("bpe", [False, True], ids=["greedy", "bpe"])
@pytest.mark.parametrize("style", STYLES)
def test_encode_decode_match_jax(style, bpe):
    path, vocab, golden = _load(style)
    kw = {}
    if bpe:
        merges, added, pretok = load_merges(path, vocab)
        kw = dict(merges=merges, added=added, pretok=pretok)
    mine = Tokenizer(vocab, bos_id=-1000, eos_id=-1000, **kw)
    ref = JaxTokenizer(vocab, bos_id=-1000, eos_id=-1000, **kw)
    for text in [c["text"] for c in golden["cases"]] + EXTRA:
        ids = mine.encode(text)
        assert ids == ref.encode(text), text
        assert mine.decode(ids, prev=0) == ref.decode(ids, prev=0), text
    for case in golden["cases"]:
        assert mine.decode(case["hf_ids"], prev=0) == ref.decode(case["hf_ids"], prev=0)
        if bpe:
            assert mine.encode(case["text"]) == case["hf_ids"], case["text"]


def test_from_checkpoint_with_merges(tmp_path):
    path, vocab, golden = _load("llama_style")
    merges, added, pretok = load_merges(path, vocab)
    out = str(tmp_path / "tok.yalm")
    write_yalm(out, {"tokenizer.tokens": pack_tokens(vocab),
                     "tokenizer.merges": merges, "tokenizer.added": added},
               {"bos_token_id": "1", "eos_token_id": "2", "tokenizer_pretok": pretok})
    yf = read_yalm(out)
    tok = Tokenizer.from_yalm(yf)
    for case in golden["cases"]:
        assert tok.encode(case["text"]) == case["hf_ids"], case["text"]
    assert tok.encode("hello", bos=True)[0] == 1
    yf.close()

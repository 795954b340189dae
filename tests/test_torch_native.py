"""The port's native library (`yalm_tpu_torch/native`) on the CPU: built with
g++ at first use into `build/native-<hash>/`, its mmap reader gives the
pure-Python reader's views, tags and metadata for every weight type (int4
and MoE included), its trie and exact-BPE encoders give the Python paths'
ids and HF's golden ids on the fixtures of tests/fixtures/, and nothing
falls back quietly: `read_yalm(native=True)` and `Tokenizer(native=True)`
raise without the library, a failed build raises with g++'s output, and a
bad or missing file raises IOError."""

import gc
import json
import os
import shutil

import numpy as np
import pytest

from yalm_tpu.convert import load_merges, load_tokens
from yalm_tpu_torch import native
from yalm_tpu_torch.codec.format import read_yalm
from yalm_tpu_torch.tokenizer import Tokenizer
from yalm_tpu_torch.utils.testing import synth_checkpoint, synth_vocab, tiny_config

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
STYLES = ["llama_style", "gpt2_style", "llama3_style"]
EXTRA = ["it's the dog's    toy\n\nnew  lines", "½⅓⅔ numbers", "tab\tsep\tvals ", "  ", "\n",
         "mixed ÿ bytes", "double  space words", "<0x41> literal fallback piece", ""]
KW256 = dict(dim=256, hidden_dim=512, head_dim=128, n_heads=4, n_kv_heads=2, vocab_size=512,
             rotary_dim=128)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return native.build()


def test_build_goes_to_build_dir(lib):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert str(lib).startswith(os.path.join(root, "build", "native-")) and lib.exists()
    assert native.loaded() and native.build() == lib   # built once per source hash
    pkg = os.path.join(root, "yalm_tpu_torch", "native")
    assert not any(f.endswith(".so") for f in os.listdir(pkg))


@pytest.mark.parametrize("dtype,moe", [("fp32", False), ("fp16", False), ("bf16", False),
                                       ("fp8", False), ("int8", False), ("int4", False),
                                       ("fp8", True), ("int4", True)])
def test_native_reader_equals_pure(lib, tmp_path, dtype, moe):
    path = str(tmp_path / "m.yalm")
    synth_checkpoint(path, tiny_config(weight_dtype=dtype, **KW256,
                                       **(dict(n_experts=4, n_experts_active=2) if moe else {})),
                     seed=4)
    py, nat = read_yalm(path, native=False), read_yalm(path, native=True)
    assert py._native is None and nat._native is not None
    assert nat.metadata == py.metadata and nat.dtypes == py.dtypes
    assert list(nat.tensors) == list(py.tensors)
    for k, a in py.tensors.items():
        b = nat.tensors[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
        t1, t2 = py.torch(k), nat.torch(k)
        assert t1.dtype == t2.dtype and t1.shape == t2.shape, k


def test_default_reader_is_native_once_built(lib, tmp_path):
    path = str(tmp_path / "m.yalm")
    synth_checkpoint(path, tiny_config())
    assert read_yalm(path)._native is not None


def test_native_views_keep_the_mapping(lib, tmp_path):
    path = str(tmp_path / "m.yalm")
    synth_checkpoint(path, tiny_config(weight_dtype="fp16"))
    want = read_yalm(path, native=False).tensors["model.embed.weight"].copy()
    yf = read_yalm(path, native=True)
    view = yf.tensors["model.embed.weight"]
    yf.close()
    del yf
    gc.collect()
    np.testing.assert_array_equal(view, want)


def test_bad_or_missing_file_raises_ioerror(lib, tmp_path):
    bad = tmp_path / "bad.yalm"
    bad.write_bytes(b"\xff" * 100)
    with pytest.raises(IOError):
        read_yalm(str(bad), native=True)
    with pytest.raises(IOError):
        native.NativeCheckpoint(str(tmp_path / "missing.yalm"))
    with pytest.raises(IOError):
        read_yalm(str(tmp_path / "missing.yalm"), native=True)


@pytest.fixture
def absent(monkeypatch, tmp_path):
    """The library as if it were not built."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "empty")


def test_native_true_without_library_raises(absent, tmp_path):
    path = str(tmp_path / "m.yalm")
    synth_checkpoint(path, tiny_config())
    assert not native.loaded()
    with pytest.raises(RuntimeError, match="not built"):
        read_yalm(path, native=True)
    with pytest.raises(RuntimeError, match="not built"):
        Tokenizer(synth_vocab(300), 1, 2, native=True)
    # where it is not built, the default is the pure-Python path
    assert read_yalm(path)._native is None
    assert not Tokenizer(synth_vocab(300), 1, 2).native


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-fno-such-flag-exists"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*no-such-flag"):
        native.build()
    assert not native.lib_path().exists()
    assert [p.name for p in tmp_path.iterdir()] == []   # nothing half-built stays


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", "no-such-compiler-on-path")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()


def _load(style, pad=0):
    with open(os.path.join(FIX, "tokenizer_golden.json")) as f:
        golden = json.load(f)[style]
    path = os.path.join(FIX, f"{style}_tokenizer.json")
    return path, load_tokens(path, golden["vocab_size"] + pad), golden


@pytest.mark.parametrize("pad", [0, 1000], ids=["vocab", "padded"])
@pytest.mark.parametrize("bpe", [False, True], ids=["greedy", "bpe"])
@pytest.mark.parametrize("style", STYLES)
def test_native_tokenizer_equals_python_and_hf(lib, style, bpe, pad):
    """The C++ trie (greedy) and exact BPE give the Python paths' ids on
    the golden cases and extra strings, and BPE gives HF's golden ids; a
    vocab padded with empty pieces (as load_tokens pads to a model's
    vocab_size) encodes the same."""
    def make(pad, native):
        path, vocab, golden = _load(style, pad)
        kw = {}
        if bpe:
            merges, added, pretok = load_merges(path, vocab)
            kw = dict(merges=merges, added=added, pretok=pretok)
        return Tokenizer(vocab, bos_id=-1000, eos_id=-1000, native=native, **kw), golden

    (nat, golden), (py, _) = make(pad, True), make(pad, False)
    assert nat.native and not py.native
    ref = make(0, False)[0]   # the unpadded vocab
    for text in [c["text"] for c in golden["cases"]] + EXTRA:
        assert nat.encode(text) == py.encode(text) == ref.encode(text), text
    if bpe:
        for case in golden["cases"]:
            assert nat.encode(case["text"]) == case["hf_ids"], case["text"]


def test_native_bpe_long_text(lib):
    """A 4 KB text on a vocab padded to 32000: native BPE equals the Python BPE."""
    path, vocab, golden = _load("llama_style", 32000 - 528)
    merges, added, pretok = load_merges(path, vocab)
    kw = dict(bos_id=1, eos_id=2, merges=merges, added=added, pretok=pretok)
    text = (" ".join(c["text"] for c in golden["cases"]) + " the quick brown fox. ") * 20
    text = text[:4096]
    nat, py = Tokenizer(vocab, native=True, **kw), Tokenizer(vocab, native=False, **kw)
    ids = nat.encode(text)
    assert ids == py.encode(text) and len(ids) > 500


def test_from_yalm_native_flag(lib, tmp_path):
    path = str(tmp_path / "m.yalm")
    synth_checkpoint(path, tiny_config())
    yf = read_yalm(path)
    assert Tokenizer.from_yalm(yf).native and not Tokenizer.from_yalm(yf, native=False).native
    a, b = Tokenizer.from_yalm(yf), Tokenizer.from_yalm(yf, native=False)
    for text in ("hello world", "the pass key is 12345. Remember it.", "🎉 unicode"):
        assert a.encode(text, bos=True) == b.encode(text, bos=True), text


def test_native_trie_metadata(lib):
    assert native.NativeTrie(b"a\0ab\0<0x00>\0").byte_fallback_start == 2
    assert native.NativeTrie(b"a\0b\0").byte_fallback_start == -1
    assert native.NativeTrie(b"a\0b\0c\0").n_vocab == 3


def test_loaded_library_errors_raise(lib):
    """A loaded library's tokenizer errors raise: BPE encode before the
    merges are installed."""
    trie = native.NativeTrie(b"a\0b\0ab\0")
    with pytest.raises(RuntimeError, match="before set_bpe"):
        trie.encode_bpe(b"ab")
    trie.set_bpe(np.array([[0, 1]], np.int32), None, "")
    assert trie.encode_bpe(b"ab") == [2]

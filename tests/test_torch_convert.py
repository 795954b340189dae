"""The port's converter (`yalm_tpu_torch/convert.py`) against the JAX
package's on the CPU: the same `.yalm` bytes for every dtype (fp32, fp16,
bf16, fp8, int8 on a random HF model of every family of
tests/test_hf_parity.py; int4 on dense and MoE directories with K >= 256),
on BF16 and two-shard inputs and through the CLI; the same exception types
on broken inputs; the bf16 / e5m2 casts' bytes equal ml_dtypes' (NaN,
round-to-nearest-even ties, subnormals, overflow); and the port's oracle on
each converted family within tests/test_hf_parity.py's 2e-3 of
transformers' forward."""

import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from yalm_tpu.convert import convert as jax_convert
from yalm_tpu_torch.codec.format import read_yalm, write_yalm
from yalm_tpu_torch.config import ModelConfig
from yalm_tpu_torch.convert import cast_f32, convert
from yalm_tpu_torch.models.cache import KVCache
from yalm_tpu_torch.models.transformer import prefill
from yalm_tpu_torch.models.weights import load_weights
from yalm_tpu_torch.utils.testing import synth_hf_dir, tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ["fp32", "fp16", "bf16", "fp8", "int8"]
KW256 = dict(dim=256, hidden_dim=512, head_dim=128, n_heads=4, n_kv_heads=2, vocab_size=512,
             rotary_dim=128)
MOE = dict(n_experts=4, n_experts_active=2)

try:   # the families need transformers (tests/test_hf_parity.py skips without it too)
    import test_hf_parity as hf
    HF_CASES = hf.test_converted_logits_match_transformers.pytestmark[0].args[1]
except pytest.skip.Exception:
    hf, HF_CASES = None, []
FAMILY_IDS = [f"{a}-{i}" for i, (a, _) in enumerate(HF_CASES)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny shapes: one intra-op thread each, so the suite's parallel
    workers do not oversubscribe the cores with spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """One random HF model per family: {id: (model, directory)}."""
    d = tmp_path_factory.mktemp("families")
    return {fid: hf._mk_hf(d / fid, arch, **extra)
            for fid, (arch, extra) in zip(FAMILY_IDS, HF_CASES)}


def both(src: str, out_dir, dtype: str) -> tuple[bytes, bytes, str]:
    """(the port's bytes, the JAX converter's bytes, the port's file)."""
    mine, ref = str(out_dir / f"port-{dtype}.yalm"), str(out_dir / f"jax-{dtype}.yalm")
    convert(src, mine, dtype)
    jax_convert(src, ref, dtype)
    with open(mine, "rb") as f, open(ref, "rb") as g:
        return f.read(), g.read(), mine


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fid", FAMILY_IDS)
def test_family_bytes_match_jax(families, tmp_path, fid, dtype):
    got, want, _ = both(families[fid][1], tmp_path, dtype)
    assert got == want


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_int4_bytes_match_jax(tmp_path, moe):
    src = str(tmp_path / "hf")
    synth_hf_dir(src, tiny_config(**KW256, **(MOE if moe else {})), seed=11)
    got, want, path = both(src, tmp_path, "int4")
    assert got == want
    yf = read_yalm(path)
    assert yf.dtypes["model.layers.0.mlp.w1.weight"] == "U8"
    assert "model.layers.0.mlp.w1.weight.gscale" in yf.tensors
    assert yf.dtypes["model.embed.weight"] == "I8"


@pytest.mark.parametrize("dtype", DTYPES + ["int4"])
@pytest.mark.parametrize("shards", [1, 2])
def test_bf16_shard_input(tmp_path, shards, dtype):
    """BF16 shards (as Mistral and Llama ship), one file or two: the port's
    bytes equal JAX's, and the values are the bf16 weights widened as
    floats, not their bit patterns widened as integers."""
    src = str(tmp_path / "hf")
    synth_hf_dir(src, tiny_config(**KW256, **MOE), seed=12, arch="MixtralForCausalLM",
                 dtype="bf16", shards=shards)
    files = sorted(f for f in os.listdir(src) if f.endswith(".safetensors"))
    assert len(files) == shards
    assert read_yalm(os.path.join(src, files[0])).dtypes["model.embed_tokens.weight"] == "BF16"
    got, want, path = both(src, tmp_path, dtype)
    assert got == want
    if dtype == "fp32":
        shard = {}
        for f in files:
            yf = read_yalm(os.path.join(src, f))
            shard.update({k: yf.torch(k) for k in yf.tensors})
        out = read_yalm(path)
        np.testing.assert_array_equal(
            out.tensors["model.layers.0.attn.wv.weight"],
            shard["model.layers.0.self_attn.v_proj.weight"].float().numpy())
        np.testing.assert_array_equal(
            out.tensors["model.layers.0.mlp.w2.weight"][1],
            shard["model.layers.0.block_sparse_moe.experts.1.w2.weight"].float().numpy())


def test_two_shards_equal_one(tmp_path):
    """The shard merge: a directory split over two files converts to the
    same bytes as the same tensors in one file."""
    outs = []
    for shards in (1, 2):
        src = str(tmp_path / f"hf{shards}")
        synth_hf_dir(src, tiny_config(**KW256), seed=13, dtype="bf16", shards=shards)
        outs.append(str(tmp_path / f"{shards}.yalm"))
        convert(src, outs[-1], "fp8")
    with open(outs[0], "rb") as f, open(outs[1], "rb") as g:
        assert f.read() == g.read()


def test_synth_hf_dir_drawn_by_torch(tmp_path):
    """device= draws the weights with torch's generator: the same bytes for
    the same seed, other bytes than numpy's, and the converters agree."""
    cfg = tiny_config(**KW256)
    for name in ("a", "b"):
        synth_hf_dir(str(tmp_path / name), cfg, seed=15, dtype="bf16", device="cpu")
    synth_hf_dir(str(tmp_path / "np"), cfg, seed=15, dtype="bf16")
    blob = lambda d: (tmp_path / d / "model.safetensors").read_bytes()  # noqa: E731
    assert blob("a") == blob("b") != blob("np")
    got, want, _ = both(str(tmp_path / "a"), tmp_path, "fp8")
    assert got == want


def test_synth_hf_dir_matches_jax(tmp_path):
    from yalm_tpu.utils.testing import synth_hf_dir as jax_synth_hf_dir
    from yalm_tpu.utils.testing import tiny_config as jax_tiny
    for kw in ({}, MOE, dict(has_qkv_bias=True), dict(has_qk_norm=True)):
        synth_hf_dir(str(tmp_path / "p"), tiny_config(**kw), seed=3)
        jax_synth_hf_dir(str(tmp_path / "j"), jax_tiny(**kw), seed=3)
        for f in ("config.json", "tokenizer.json", "model.safetensors"):
            with open(tmp_path / "p" / f, "rb") as a, open(tmp_path / "j" / f, "rb") as b:
                assert a.read() == b.read(), (kw, f)


def _broken(tmp_path, case: str) -> str:
    src = str(tmp_path / case)
    cfg = tiny_config(tie_word_embeddings=case != "untied")
    synth_hf_dir(src, cfg, seed=14)
    cpath = os.path.join(src, "config.json")
    with open(cpath) as f:
        config = json.load(f)
    if case == "arch":
        config["architectures"] = ["FalconForCausalLM"]
    elif case in ("config", "tokenizer"):
        os.remove(os.path.join(src, f"{case}.json"))
    elif case == "shards":
        os.remove(os.path.join(src, "model.safetensors"))
    elif case == "untied":
        # the config says untied and the shard lacks lm_head.weight
        yf = read_yalm(os.path.join(src, "model.safetensors"))
        keep = {k: yf.torch(k) for k in yf.tensors if k != "lm_head.weight"}
        yf.close()
        write_yalm(os.path.join(src, "model.safetensors"), keep, {"format": "pt"})
    elif case == "o_bias":
        yf = read_yalm(os.path.join(src, "model.safetensors"))
        keep = {k: yf.torch(k) for k in yf.tensors}
        keep["model.layers.0.self_attn.o_proj.bias"] = torch.zeros(cfg.dim)
        yf.close()
        write_yalm(os.path.join(src, "model.safetensors"), keep, {"format": "pt"})
    if os.path.exists(cpath):
        with open(cpath, "w") as f:
            json.dump(config, f)
    return src


@pytest.mark.parametrize("case", ["arch", "config", "tokenizer", "shards", "untied", "o_bias"])
def test_errors_match_jax(tmp_path, case):
    src = _broken(tmp_path, case)
    with pytest.raises(Exception) as want:
        jax_convert(src, str(tmp_path / "j.yalm"), "fp16")
    with pytest.raises(Exception) as got:
        convert(src, str(tmp_path / "p.yalm"), "fp16")
    assert type(got.value) is type(want.value), (got.value, want.value)
    assert type(got.value) in (ValueError, FileNotFoundError)


def _edge_values() -> np.ndarray:
    """f32 values at the edges of the bf16 and e5m2 casts: NaNs of both
    signs and several payloads, infinities, exact round-to-nearest-even
    ties and their neighbours, subnormals of both targets, values past
    e5m2's 57344 and fp16's 65504, and 2^16 random values of every scale."""
    nan_bits = np.array([0x7FC00000, 0x7F800001, 0x7FA00000, 0x7F812345, 0x7FFFFFFF,
                         0xFFC00000, 0xFF800001, 0xFFFFFFFF], np.uint32)
    special = [np.inf, -np.inf, 0.0, -0.0, 57344.0, 57343.0, 61439.0, 61440.0, 61441.0,
               65504.0, 65519.0, 65520.0, 1e6, -1e6, 3.4e38, 2.0 ** -14, 2.0 ** -16,
               2.0 ** -17, 3 * 2.0 ** -18, 2.0 ** -18, 1e-7, 2.0 ** -126, 2.0 ** -133,
               2.0 ** -149, 1e-40]
    # bf16 ties: the 16 dropped bits exactly 0x8000, with even and odd kept halves
    ties_bf16 = (np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x7F7F8000, 0x00018000],
                          np.uint32)).view(np.float32)
    # e5m2 ties: 1 + 1/8 lies halfway between 1 and 1.25 (even: 1), 1 + 3/8
    # between 1.25 and 1.5 (even: 1.5)
    ties_e5m2 = np.array([1.125, 1.375, -1.125, 1.125 * 2 ** -14, 2.0 ** -16 * 1.5,
                          2.0 ** -16 * 0.5, 2.0 ** -16 * 2.5], np.float32)
    rng = np.random.default_rng(0)
    rand = (rng.standard_normal(1 << 16) * np.exp2(rng.integers(-30, 20, 1 << 16))
            ).astype(np.float32)
    return np.concatenate([nan_bits.view(np.float32), np.array(special, np.float32),
                           -np.array(special, np.float32), ties_bf16, ties_e5m2, rand])


@pytest.mark.parametrize("tag,ml,bits", [("BF16", ml_dtypes.bfloat16, np.uint16),
                                         ("F8_E5M2", ml_dtypes.float8_e5m2, np.uint8),
                                         ("F16", np.float16, np.uint16)])
def test_cast_bytes_match_ml_dtypes(tag, ml, bits):
    f = _edge_values()
    with np.errstate(invalid="ignore", over="ignore"):
        want = f.astype(ml).view(bits)
    got = cast_f32(f, tag)
    got = (got.view(torch.int16 if bits == np.uint16 else torch.uint8).numpy().view(bits)
           if isinstance(got, torch.Tensor) else got.view(bits))
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, [(hex(f[i:i + 1].view(np.uint32)[0]), hex(got[i]), hex(want[i]))
                           for i in bad[:8]]


@pytest.mark.parametrize("fid", FAMILY_IDS)
def test_family_logits_match_transformers(families, tmp_path, fid):
    """The port's oracle on the port's fp32 conversion: prefill logits
    within 2e-3 of transformers' forward, the argmax equal
    (tests/test_hf_parity.py:136)."""
    model, src = families[fid]
    out = str(tmp_path / "m.yalm")
    convert(src, out, "fp32")
    yf = read_yalm(out)
    cfg = ModelConfig.from_metadata(yf.metadata)
    w = load_weights(yf, cfg, "cpu")
    ids = np.array([1, 5, 9, 13, 42, 7, 99, 3, 64, 120, 17, 2])
    with torch.no_grad():
        want = model(torch.tensor(ids[None])).logits[0].float().numpy()
    got, _ = prefill(cfg, w, ids, 0, len(ids), KVCache.init(cfg, torch.float32, "cpu"),
                     logits_mode="all")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    assert (got.numpy().argmax(-1) == want.argmax(-1)).all()


def test_cli_writes_jax_bytes(families, tmp_path):
    src = families[FAMILY_IDS[0]][1]
    out = str(tmp_path / "cli.yalm")
    res = subprocess.run([sys.executable, "-m", "yalm_tpu_torch.convert", "--dtype", "fp8",
                          out, src], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Saving" in res.stdout
    jax_convert(src, str(tmp_path / "jax.yalm"), "fp8")
    with open(out, "rb") as f, open(tmp_path / "jax.yalm", "rb") as g:
        assert f.read() == g.read()

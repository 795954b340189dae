"""The PyTorch port's `.yalm` codec against the JAX package's.

Both packages must read each other's checkpoints bit for bit, for every
weight type the fast path loads, and the port's `synth_checkpoint` must
write the same bytes as the JAX package's for the same seed (so tests can
hand both packages one checkpoint).
"""

import numpy as np
import pytest
import torch

from yalm_tpu.codec.format import read_yalm as jax_read
from yalm_tpu.utils.testing import synth_checkpoint as jax_synth
from yalm_tpu.utils.testing import tiny_config as jax_tiny
from yalm_tpu_torch.codec.format import read_yalm, write_yalm
from yalm_tpu_torch.utils.testing import synth_checkpoint, tiny_config

DTYPES = ["fp32", "fp16", "bf16", "fp8", "int8"]
TORCH_OF = {"float32": torch.float32, "float16": torch.float16,
            "bfloat16": torch.bfloat16, "float8_e5m2": torch.float8_e5m2,
            "int8": torch.int8, "uint8": torch.uint8}


def _raw(arr) -> bytes:
    return np.ascontiguousarray(arr).view(np.uint8).tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_reads_jax_checkpoint_bitwise(tmp_path, dtype):
    path = str(tmp_path / "m.yalm")
    jax_synth(path, jax_tiny(weight_dtype=dtype, has_qkv_bias=True), seed=1)
    want = jax_read(path, native=False)
    got = read_yalm(path)
    assert got.metadata == want.metadata
    assert set(got.tensors) == set(want.tensors)
    for name, arr in want.tensors.items():
        t = got.torch(name)
        # the same element type (ml_dtypes' on the JAX side) and the same bits
        assert t.dtype == TORCH_OF[arr.dtype.name], name
        assert tuple(t.shape) == arr.shape, name
        assert t.reshape(-1).view(torch.uint8).numpy().tobytes() == _raw(arr), name
    got.close()
    want.close()


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_reads_port_checkpoint_and_bytes_match(tmp_path, dtype):
    p_port, p_jax = str(tmp_path / "port.yalm"), str(tmp_path / "jax.yalm")
    synth_checkpoint(p_port, tiny_config(weight_dtype=dtype, has_qkv_bias=True), seed=2)
    jax_synth(p_jax, jax_tiny(weight_dtype=dtype, has_qkv_bias=True), seed=2)
    # the port's fixture writes exactly the JAX fixture's file
    with open(p_port, "rb") as a, open(p_jax, "rb") as b:
        assert a.read() == b.read()
    yf = jax_read(p_port, native=False)
    mine = read_yalm(p_port)
    for name, arr in yf.tensors.items():
        assert _raw(arr) == _raw(mine.tensors[name]), name
    yf.close()
    mine.close()


def test_write_torch_tensors_roundtrip(tmp_path):
    """bf16 and both fp8 types go through torch tensors in the writer and
    come back with their type; the JAX reader sees the same values."""
    rng = np.random.default_rng(0)
    f = torch.from_numpy(rng.standard_normal((3, 16), dtype=np.float32))
    tensors = {"bf": f.to(torch.bfloat16), "e5": f.to(torch.float8_e5m2),
               "e4": f.to(torch.float8_e4m3fn), "f32": f.numpy(),
               "i8": np.arange(-8, 8, dtype=np.int8)}
    path = str(tmp_path / "t.yalm")
    write_yalm(path, tensors, {"k": "v"})
    yf = read_yalm(path)
    for name in ("bf", "e5", "e4"):
        back = yf.torch(name)
        assert back.dtype == tensors[name].dtype
        assert torch.equal(back.float(), tensors[name].float())
    assert np.array_equal(yf.torch("i8").numpy(), tensors["i8"])
    jf = jax_read(path, native=False)
    for name in ("bf", "e5", "e4"):
        np.testing.assert_array_equal(np.asarray(jf.tensors[name], np.float32),
                                      tensors[name].float().numpy())
    yf.close()
    jf.close()

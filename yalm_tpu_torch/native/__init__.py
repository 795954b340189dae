"""ctypes bindings for the native host library (libyalm_native.so): the
mmap checkpoint reader and the trie / exact-BPE tokenizer.

The port's copy of `yalm_tpu/native/__init__.py`. `build()` compiles
`yalm_native.cpp` with g++ (the JAX package's Makefile flags) into
`build/native-<hash of the sources>/libyalm_native.so` at the repo root,
as `ops/cuda/_build.py` builds the kernels with nvcc; nothing is written
inside the package. A failed compile raises with g++'s output.

The library is an accelerator: `loaded()` says whether it is built and
loaded, and the pure-Python reader and tokenizer are used where it is
not. Where it is loaded, its errors raise; nothing falls back quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SOURCES = ("yalm_native.cpp", "unicode_ln.h")
BUILD_ROOT = _HERE.parents[1] / "build"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

_lib: ctypes.CDLL | None = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_HERE / name).read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    """Where this source hash's library is (or will be) built."""
    return BUILD_ROOT / f"native-{_digest()}" / "libyalm_native.so"


def build() -> Path:
    """Compile the library unless this source hash is already built; return
    its path. Raises if g++ is missing or the compile fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native library needs a C++ compiler")
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-native-", dir=BUILD_ROOT))
    try:
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp / out.name), str(_HERE / "yalm_native.cpp")]
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n"
                               f"{res.stdout.decode(errors='replace')}")
        try:
            os.replace(tmp, out.parent)   # atomic publish of the whole directory
        except OSError:
            if not out.exists():          # lost a race only if a peer built it
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    P, I, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int32, ctypes.c_int64
    cp, i32p = ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32)
    sigs = {
        "yn_open": ([cp], P),
        "yn_error": ([P], cp),
        "yn_close": ([P], None),
        "yn_n_tensors": ([P], I),
        "yn_tensor_info": ([P, I, ctypes.POINTER(cp), ctypes.POINTER(cp),
                            ctypes.POINTER(ctypes.POINTER(I64)), ctypes.POINTER(I),
                            ctypes.POINTER(P), ctypes.POINTER(I64)], I),
        "yn_n_metadata": ([P], I),
        "yn_metadata": ([P, I, ctypes.POINTER(cp), ctypes.POINTER(cp)], I),
        "yt_create": ([cp, I64], P),
        "yt_free": ([P], None),
        "yt_byte_fallback_start": ([P], I32),
        "yt_n_vocab": ([P], I32),
        "yt_encode": ([P, cp, I64, i32p, I64], I64),
        "yt_set_bpe": ([P, i32p, I64, i32p, I64, cp], I32),
        "yt_encode_bpe": ([P, cp, I64, i32p, I64], I64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _try_load() -> ctypes.CDLL | None:
    """The loaded library, or None where this source hash is not built."""
    global _lib
    if _lib is None and lib_path().exists():
        lib = ctypes.CDLL(str(lib_path()))
        _bind(lib)
        _lib = lib
    return _lib


def loaded() -> bool:
    return _try_load() is not None


def _require() -> ctypes.CDLL:
    lib = _try_load()
    if lib is None:
        raise RuntimeError(f"the native library is not built ({lib_path()}): "
                           "call yalm_tpu_torch.native.build()")
    return lib


class NativeCheckpoint:
    """A checkpoint mapped by the native reader: zero-copy numpy views into
    the mapping, BF16 and the fp8 types as raw uint16 / uint8 bits, as the
    pure-Python reader returns them."""

    def __init__(self, path: str):
        lib = _require()
        self._lib = lib
        self._h = lib.yn_open(os.fsencode(path))
        err = lib.yn_error(self._h)
        if err:
            msg = err.decode()
            lib.yn_close(self._h)
            self._h = None
            raise IOError(f"{path}: {msg}")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.yn_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def metadata(self) -> dict[str, str]:
        out = {}
        k, v = ctypes.c_char_p(), ctypes.c_char_p()
        for i in range(self._lib.yn_n_metadata(self._h)):
            self._lib.yn_metadata(self._h, i, ctypes.byref(k), ctypes.byref(v))
            out[k.value.decode()] = v.value.decode()
        return out

    def tensors(self) -> tuple[dict[str, np.ndarray], dict[str, str]]:
        """(numpy views by name, safetensors tag by name). Each view keeps
        this checkpoint, and with it the mapping, alive."""
        from ..codec.format import _TAGS
        views, tags = {}, {}
        name, dtype = ctypes.c_char_p(), ctypes.c_char_p()
        shape_p = ctypes.POINTER(ctypes.c_int64)()
        ndim = ctypes.c_int()
        data = ctypes.c_void_p()
        nbytes = ctypes.c_int64()
        for i in range(self._lib.yn_n_tensors(self._h)):
            self._lib.yn_tensor_info(self._h, i, ctypes.byref(name), ctypes.byref(dtype),
                                     ctypes.byref(shape_p), ctypes.byref(ndim),
                                     ctypes.byref(data), ctypes.byref(nbytes))
            key, tag = name.value.decode(), dtype.value.decode()
            if tag not in _TAGS:
                raise ValueError(f"tensor {key}: unsupported dtype {tag}")
            np_dtype = _TAGS[tag][0]
            shape = tuple(shape_p[j] for j in range(ndim.value))
            count = int(np.prod(shape, dtype=np.int64))
            if count * np_dtype.itemsize != nbytes.value:
                raise ValueError(f"tensor {key}: {nbytes.value} bytes for shape {shape}")
            buf = (ctypes.c_char * nbytes.value).from_address(data.value or 0)
            buf._owner = self   # the view's base holds the mapping
            views[key] = np.frombuffer(buf, dtype=np_dtype, count=count).reshape(shape)
            tags[key] = tag
        return views, tags


class NativeTrie:
    """The native trie encoder over a packed NUL-delimited vocab blob, and
    its exact-BPE encoder once set_bpe installed the merge ranks."""

    def __init__(self, blob: bytes):
        self._lib = _require()
        self._h = self._lib.yt_create(blob, len(blob))
        if not self._h:
            raise RuntimeError("yt_create failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.yt_free(self._h)
            self._h = None

    @property
    def byte_fallback_start(self) -> int:
        return self._lib.yt_byte_fallback_start(self._h)

    @property
    def n_vocab(self) -> int:
        return self._lib.yt_n_vocab(self._h)

    def _run(self, fn, data: bytes, what: str) -> list[int]:
        cap = max(len(data) * 2, 16)
        out = (ctypes.c_int32 * cap)()
        n = fn(self._h, data, len(data), out, cap)
        if n == -2:
            raise RuntimeError(f"{what} before set_bpe")
        if n < 0:
            raise RuntimeError(f"{what}: output capacity {cap} overflowed")
        return list(out[:n])

    def encode(self, data: bytes) -> list[int]:
        """Greedy longest-prefix match with byte fallback."""
        return self._run(self._lib.yt_encode, data, "yt_encode")

    def set_bpe(self, merges, added, pretok: str) -> None:
        """Install merge ranks for exact-BPE encode. merges: (M, 2) int32;
        added: (A,) int32; pretok: 'metaspace[:scheme]' | 'bytelevel[:prefix]'
        | 'llama3'. Raises if the library refuses them."""
        m = np.ascontiguousarray(merges, np.int32)
        a = np.ascontiguousarray(added if added is not None else [], np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        rc = self._lib.yt_set_bpe(self._h, m.ctypes.data_as(i32p), len(m),
                                  a.ctypes.data_as(i32p), len(a), pretok.encode())
        if rc != 0:
            raise RuntimeError(f"yt_set_bpe failed ({rc})")

    def encode_bpe(self, data: bytes) -> list[int]:
        return self._run(self._lib.yt_encode_bpe, data, "yt_encode_bpe")

"""Build and load the port's CUDA kernels; count their launches.

At first use the sources under `yalm_tpu_torch/csrc/` are compiled with
`nvcc` for `sm_90a` (one nvcc process per `.cu`, all started together, then
one link) into `build/<hash of the sources>/libyalm_cuda.so` at the repo
root, and the library is loaded with ctypes. The library has a plain C
interface: every entry point returns 0, a cudaError_t, or -1 for arguments
it does not take. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# Kernel launches by the name of the TPU function each wrapper replaces. A
# wrapper adds one where it launches its kernel on the card, never on the
# CPU path; chip_smoke.py zeroes it before the main path and reads it after.
LAUNCHES: collections.Counter = collections.Counter()

# weight type codes of csrc/common.cuh (uint8 weights are packed int4); the
# KV cache takes the bf16 and e5m2 codes
WTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e5m2: 2, torch.int8: 3,
         torch.uint8: 4}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # (layer, E, expert, expert_id) address a matrix of an (L, E, N, K) stack
    "yt_gemv": [_I, _P, _I, _I, _I, _P, _I, _I, _P, _I, _P, _F, _P, _P, _I, _P, _F,
                _P, _P, _I, _I, _P],
    "yt_gemm": [_I, _P, _I, _I, _I, _P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _P],
    "yt_gemm4": [_P, _I, _I, _I, _P, _I, _I, _I, _P, _I, _P, _P, _P, _I, _I, _P],
    "yt_rmsnorm_rows": [_P, _I, _I, _P, _F, _P, _P],
    "yt_attend_step": [_I, _P, _P, _P, _P, _P, _P, _F, _F, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "yt_attend_step_batched": [_I, _P, _P, _P, _P, _P, _P, _F, _F, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "yt_attend_step_paged": [_I, _P, _P, _P, _P, _P, _P, _F, _F, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this source hash is already built; return
    the library's path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libyalm_cuda.so"
    if lib_path.exists():
        return lib_path
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        objs = []
        for cmd, obj, proc in procs:
            log = proc.communicate()[0].decode(errors="replace")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{log}")
            objs.append(str(obj))
        link = [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp / lib_path.name)]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout.decode(errors='replace')}")
        try:
            os.replace(tmp, out_dir)   # atomic publish of the whole directory
        except OSError:
            if not lib_path.exists():  # lost a race only if a peer built it
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.yt_error_string.argtypes = [ctypes.c_int]
        handle.yt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().yt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA kernel launch failed ({code}: {msg})")


def stream_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def device_kind(*tensors: torch.Tensor) -> str:
    """"cpu" (the plain version runs) or "cuda" (the kernel runs), chosen by
    the tensors' device alone; any other device, or a mix, raises."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type in ("cpu", "cuda"):
        return dev.type
    raise ValueError(f"no kernel or plain version for tensors on {dev}")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def aligned16(*tensors: torch.Tensor | None) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)

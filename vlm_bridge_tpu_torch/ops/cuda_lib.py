"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The sources are compiled with nvcc for sm_90a into a library with a plain C
interface, loaded with ctypes (seconds per source, against minutes for an
extension that includes PyTorch's headers). One nvcc runs per source, all
started together, and a last call links the objects. The build runs at
first use, into `build/` at the repository root, keyed by a hash of the
sources, so a changed source rebuilds and an unchanged one is loaded as it
is. `build_log` keeps what `-Xptxas -v` printed (registers, shared memory
and spills per kernel), also when the library was built by an earlier
process: the log is kept beside it. `VBT_NVCC_FLAGS` in the environment adds
compiler flags (for instance a `-D` define, to time a kernel's variants
against each other); they are part of the key.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points and their argument types (pointers and the stream as void*)
SIGNATURES = {
    "vbt_int8_matmul_t_argmax": [_P] * 6 + [_I] * 3 + [_P],
    "vbt_int8_matmul_t": [_P] * 4 + [_I] * 3 + [_P],
    "vbt_int8_matmul": [_P] * 4 + [_I] * 4 + [_P],
    "vbt_int8_mlp": [_P] * 9 + [_I] * 5 + [_P],
    "vbt_int8_ffn": [_P] * 9 + [_I] * 5 + [_P],
    "vbt_int8_clusters": [_I, _P],
    "vbt_int4_clusters": [_I, _I, _P],
    "vbt_int4_matmul_t_argmax": [_P] * 6 + [_I] * 4 + [_P],
    "vbt_int4_matmul_t": [_P] * 4 + [_I] * 4 + [_P],
    "vbt_int4_mlp": [_P] * 9 + [_I] * 7 + [_P],
    "vbt_tiled_matmul": [_P] * 4 + [_I] * 5 + [_P],
    "vbt_layer_norm": [_P] * 4 + [_I] * 3 + [_F] + [_P],
    "vbt_fused_attn_step": [_P] * 21 + [_I] * 9 + [_F] * 3 + [_P],
    "vbt_fused_mlp_step": [_P] * 11 + [_I] * 5 + [_F] + [_P],
    "vbt_i8_gemm": [_P] * 6 + [_I] * 6 + [_P],
    "vbt_i4_gemm": [_P] * 5 + [_I] * 6 + [_P],
    "vbt_fused_stack_step": [_P] * 21 + [_I] * 13 + [_F] * 3 + [_P] * 7 + [_I] * 3 + [_P],
    "vbt_fused_bridge_step": [_P] * 31 + [_I] * 11 + [_F] + [_P],
    "vbt_flash_attention_fwd": [_P] * 6 + [_I] * 8 + [_F] * 2 + [_L] * 9 + [_P],
    "vbt_flash_attention_bwd_dq": [_P] * 9 + [_I] * 8 + [_F] * 2 + [_L] * 15 + [_P],
    "vbt_flash_attention_bwd_dkv": [_P] * 9 + [_I] * 8 + [_F] * 2 + [_L] * 12 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process (None: loaded, not built)
build_log = ""        # the compilers' output of the loaded library's build


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built on "
                       "a machine with the CUDA toolkit")


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256()
        for p in _sources():
            digest.update(p.name.encode())
            digest.update(p.read_bytes())
        flags = NVCC_FLAGS + os.environ.get("VBT_NVCC_FLAGS", "").split()
        digest.update(" ".join(flags).encode())
        out = BUILD_DIR / f"libvbt_kernels-{digest.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
                objs, procs = [], []
                for src in sorted(CSRC.glob("*.cu")):
                    objs.append(str(Path(work) / (src.stem + ".o")))
                    procs.append(subprocess.Popen(
                        [_nvcc(), *flags, "-c", "-o", objs[-1], str(src)],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
                logs = [proc.communicate()[0] for proc in procs]
                build_log = "".join(logs)
                if any(proc.returncode != 0 for proc in procs):
                    raise RuntimeError(f"nvcc failed:\n{build_log}")
                tmp = str(Path(work) / "lib.so")
                res = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
                out.with_suffix(".log").write_text(build_log)
                os.replace(tmp, out)
            build_seconds = time.perf_counter() - t0
        elif out.with_suffix(".log").exists():
            build_log = out.with_suffix(".log").read_text()
        handle = ctypes.CDLL(str(out))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
        return _lib


def call(name: str, *args) -> None:
    """Run one C entry point on the current stream; raise on a CUDA error."""
    fn = getattr(lib(), name)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Refuse what the kernels do not take: device, dtype, shape, layout."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")

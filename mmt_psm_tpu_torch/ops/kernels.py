"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``; nothing here
includes PyTorch's headers, so a build takes seconds. Builds happen at first
use, into ``mmt_psm_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by
a hash of the source and flags so an edited source is rebuilt. Nothing is
built or loaded when this module is imported.

``-fmad=false`` keeps every float multiply and add separately rounded, so
the kernels' box and sampling arithmetic, and FrozenBN's epilogue, match
float32 on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_ptr = ctypes.c_void_p
_int = ctypes.c_int
# each source under csrc/ -> the argtypes of the C functions it exports
SIGNATURES = {
    "nms": {"nms_suppress": (_ptr, _ptr, _ptr, _ptr, _ptr, _int, _int, _ptr)},
    "roi_align": {
        "roi_align_forward": (
            ctypes.POINTER(_ptr), ctypes.POINTER(_int), ctypes.POINTER(_int),
            ctypes.POINTER(ctypes.c_float), _int, _ptr, _ptr, _ptr,
            _int, _int, _int, _int, _int, _int, _ptr,
        ),
        "roi_align_backward": (
            ctypes.POINTER(_int), ctypes.POINTER(_int), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_longlong), _int, _ptr, _ptr, _ptr, _ptr, _ptr,
            _int, _int, _int, _int, _int, _int, _ptr,
        ),
    },
    "mask_targets": {"mask_targets": (_ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int, _int, _int, _ptr)},
    "frozen_bn": {
        "prepare_conv_bn": (_ptr,) * 7 + (_int, ctypes.c_longlong, _ptr),
        "bn_residual_relu": (_ptr,) * 4 + (ctypes.c_longlong, _int, _int, _ptr),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")


def _build_one(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source (one nvcc each, all at once) and load them."""
    with _lock:
        missing = [n for n in SIGNATURES if n not in _libs]
        if missing:
            with ThreadPoolExecutor(len(missing)) as pool:
                paths = list(pool.map(_build_one, missing))
            for name, path in zip(missing, paths):
                lib = ctypes.CDLL(path)
                for fn, argtypes in SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _libs[name] = lib
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]


def require_cuda(what: str, *tensors):
    """The one CUDA device that all ``tensors`` lie on; raises ValueError
    where any lies elsewhere (a kernel's wrapper takes no CPU tensor)."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: every tensor must lie on one CUDA device, got {[str(t.device) for t in tensors]}")
    return dev


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")

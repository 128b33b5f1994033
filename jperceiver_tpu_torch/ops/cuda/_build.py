"""Build the port's CUDA kernels from `csrc/` at first use, and bind them.

All `.cu` sources are compiled for Hopper (`sm_90a`) into one shared library
with `torch.utils.cpp_extension.load`, into `jperceiver_tpu_torch/_build/`.
The sources export plain C functions and include no PyTorch header, so the
build takes seconds; the library is bound with `ctypes`, and the wrappers
pass raw device pointers and the current CUDA stream. A failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
SOURCES = ("conv3x3.cu", "conv3x3_wgrad.cu", "maxpool5x5.cu", "maxpool3x3s2.cu",
           "reproj.cu")
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    # `load` defines these four to keep PyTorch's half/bf16 operators out;
    # the sources include no PyTorch header and use cuda_bf16.h's own.
    "-U__CUDA_NO_HALF_OPERATORS__",
    "-U__CUDA_NO_HALF_CONVERSIONS__",
    "-U__CUDA_NO_BFLOAT16_CONVERSIONS__",
    "-U__CUDA_NO_HALF2_OPERATORS__",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> argument types; every function returns a cudaError_t as int.
_SIGNATURES = {
    "jp_conv3x3_fwd_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L) + (_I,) * 8 + (_P,),
    "jp_conv3x3_fwd_f32": (_P, _P, _P, _P) + (_I,) * 6 + (_P,),
    "jp_conv3x3_wgrad_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _L, _L, _L)
    + (_I,) * 7 + (_P,),
    "jp_conv3x3_wgrad_f32": (_P, _P, _P, _P) + (_I,) * 10 + (_P,),
    "jp_maxpool5x5_fwd": (_P, _P) + (_I,) * 9 + (_P,),
    "jp_maxpool5x5_bwd": (_P, _P, _P, _P) + (_I,) * 9 + (_P,),
    "jp_maxpool3x3s2_bwd": (_P, _P, _P, _P) + (_I,) * 6 + (_P,),
    "jp_reproj_fwd": (_P,) * 6 + (_I,) * 9 + (_P,),
    "jp_reproj_bwd": (_P, _P, _P, _P, _P) + (_I,) * 7 + (_P,),
}


@functools.cache
def library() -> ctypes.CDLL:
    """Compile (once a process) and load the kernels' shared library."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = load(
        name="jperceiver_tpu_torch_kernels",
        sources=[str(_CSRC / s) for s in SOURCES],
        extra_cuda_cflags=list(NVCC_FLAGS),
        build_directory=str(BUILD_DIR),
        is_python_module=False,
        verbose=False,
    )
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def ptxas_report() -> str:
    """What `nvcc -Xptxas -v` says of every kernel (registers, shared
    memory, spills), one `nvcc` a source, all started together; cubins go to
    the build directory. Raises if a source does not compile."""
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-cubin", "-o", str(BUILD_DIR / f"{s}.cubin"),
         str(_CSRC / s)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s in SOURCES]
    outs = [(s, p.communicate()[0], p.returncode) for s, p in zip(SOURCES, procs)]
    for s, out, rc in outs:
        if rc:
            raise RuntimeError(f"nvcc failed on {s}:\n{out}")
    return "".join(f"== {s}\n{out}" for s, out, _ in outs)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        import torch

        raise RuntimeError(
            f"{what}: CUDA error {err} at launch "
            f"({torch.cuda.get_device_name()})")

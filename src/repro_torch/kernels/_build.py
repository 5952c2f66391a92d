"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/*.cu`` is compiled on its own by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/repro_torch/`` at
the root of the checkout (listed in ``.gitignore``). A library's file name
carries a hash of its source, the shared header and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing is built
when a module is imported: ``build()`` runs at a kernel's first launch, or
when a caller asks for it, and then compiles every missing source at once,
one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["SOURCES", "BUILD_DIR", "build", "CudaKernel", "check_aligned", "dtype_code"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("bsr_matmul.cu", "paged_attention.cu", "bsr_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "port's CUDA kernels are built from source at first use"
        )
    return path


def _library(source: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / source, CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: tuple[str, ...] = SOURCES) -> dict[str, Path]:
    """Compile every source of ``sources`` whose library is missing, all
    ``nvcc`` processes started together. Returns source -> library path.
    The compiler's output (``-Xptxas -v``) is kept beside each library as
    ``<name>.log``. Raises with that output when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for source in sources:
        lib = _library(source)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((source, lib, tmp, proc))
    failed = []
    for source, lib, tmp, proc in running:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source}:\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("\n".join(failed))
    return {source: _library(source) for source in sources}


def dtype_code(dtype: torch.dtype) -> int:
    """The dtype code of ``csrc/common.cuh``."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not {dtype}")
    return codes[dtype]


def check_aligned(fn: str, **tensors: torch.Tensor) -> None:
    """Raise ValueError unless every tensor's data is 16-byte aligned, as
    the kernels' 16-byte loads and copies need."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(
                f"{fn} reads {name} in 16-byte chunks; its data must be "
                f"16-byte aligned (offset {t.data_ptr() % 16} bytes)"
            )


class CudaKernel:
    """One C entry point of a ``csrc`` source.

    ``launch`` builds and loads the library at first use, calls the entry
    point on the current stream of the tensors' device, raises if it
    returns a CUDA error, and counts the launch in ``launches``.
    ``argtypes`` lists the entry point's arguments before the trailing
    stream pointer.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._error_string = None

    def _load(self) -> None:
        lib = ctypes.CDLL(str(build((self.source,))[self.source]))
        fn = getattr(lib, self.symbol)
        fn.argtypes = [*self.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = lib.repro_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._error_string = fn, err

    def launch(self, device: torch.device, *args) -> None:
        if self._fn is None:
            self._load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = self._fn(*args, ctypes.c_void_p(stream))
        if rc != 0:
            text = self._error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({text})")
        self.launches += 1

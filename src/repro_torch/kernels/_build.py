"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first
use by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch_kernels/`` at the root of the checkout, then loaded
with ``ctypes``.  The library's file name carries a hash of its source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and a stale library never loads.
``build_all`` starts one ``nvcc`` per source at once and waits for all.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; the Python wrapper raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
KERNELS = ("quant_matmul", "flash_attention", "decode_attention",
           "paged_decode_attention", "dequant_matmul",
           "paged_decode_attention_q", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# the launches of each kernel in this process, by name: its wrapper adds
# one where it launches the kernel, and a CUDA-graph replay adds the
# launches its capture recorded (``core.executor.CapturedProgram``); a
# wrapper module reads its own as ``<module>.launches`` (``count_of``)
launches: Dict[str, int] = dict.fromkeys(
    KERNELS[:5] + ("dequant_matmul_i4",) + KERNELS[5:], 0)

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's report (registers, shared memory, spills) for each kernel built
# by this process
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Iterable[str] = KERNELS) -> None:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes at once; raise with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def count_of(module: str, attr: str) -> int:
    """A wrapper module's ``launches`` (``dequant_matmul``'s
    ``launches_i4`` too): its kernel's entry in ``launches``."""
    key = module.rsplit(".", 1)[-1] + attr[len("launches"):]
    if not attr.startswith("launches") or key not in launches:
        raise AttributeError(f"module {module!r} has no attribute {attr!r}")
    return launches[key]

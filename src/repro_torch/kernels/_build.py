"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into an object
file, all compilers running at once; the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The sources in
``csrc/`` are the only input.  The library is built at first use into
``kernels/build/`` (listed in ``.gitignore``) under a name that hashes the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C signature of every entry point: (argtypes), each returns cudaError_t
SIGNATURES = {
    "hbmc_trisolve_fused_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "hbmc_trisolve_fused_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "sell_spmv_f64": (_P, _P, _P, _P, _I64, _I, _I, _I64, _P),
    "sell_spmv_f32": (_P, _P, _P, _P, _I64, _I, _I, _I64, _P),
    "hbmc_trisolve_fused_batched_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _P),
    "hbmc_trisolve_fused_batched_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _P),
    "sell_spmv_batched_f64": (_P, _P, _P, _P, _I64, _I, _I, _I64, _I, _P),
    "sell_spmv_batched_f32": (_P, _P, _P, _P, _I64, _I, _I, _I64, _I, _P),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an earlier build was loaded
    log: str               # nvcc's output (``-Xptxas -v`` register report)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def _sources() -> tuple[list[Path], list[Path]]:
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest(sources: list[Path], headers: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources: list[Path], out: Path) -> str:
    """Compile every source at once, then link; returns nvcc's output."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                                   str(obj)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs, failed = [], []
        for src, proc in zip(sources, procs):
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o",
                               str(tmp_lib)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)   # atomic: a reader never sees half a file
    return log


@functools.cache
def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library; once per process."""
    sources, headers = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libreprotorch_{_digest(sources, headers)}.so"
    seconds, log = 0.0, ""
    if not path.is_file():
        t0 = time.perf_counter()
        log = _compile(find_nvcc(), sources, path)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds, log=log)


def call(name: str, *args) -> None:
    """Call entry point ``name`` of the library; raise on a CUDA error.

    The C function returns ``cudaGetLastError()`` after its launches, so a
    launch the device refused surfaces here, not at a later synchronize.
    """
    err = getattr(load_library().lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")

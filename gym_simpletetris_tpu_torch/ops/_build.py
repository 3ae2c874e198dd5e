"""Build and load the port's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles every source in ``csrc/`` for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which ``ctypes`` loads. The
library goes into ``_build/`` inside this package (listed in ``.gitignore``),
named by a hash of the sources and the flags, so a changed source builds anew
and an unchanged one is loaded as it is. A missing ``nvcc`` or a failed build
raises; nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels of gym_simpletetris_tpu_torch cannot be "
            "built")
    return found


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ("-shared",)).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtetris_kernels_{h.hexdigest()[:16]}.so"


def _check(cmd, returncode: int, log: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {returncode}:\n"
                           f"{' '.join(cmd)}\n{log}")


def build() -> dict:
    """Compile the kernels unless the library for these sources exists.
    Returns {"path", "seconds", "log"}; ``log`` holds nvcc's output (the
    ``-Xptxas=-v`` register and spill report) when a build ran."""
    path = library_path()
    if path.exists():
        return {"path": path, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    tmp = path.with_name(f"{path.name}.{pid}.tmp")
    objs = [path.with_name(f"{path.stem}.{src.stem}.{pid}.o")
            for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            _check(cmd, proc.returncode, log)
        proc = subprocess.run(link, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append(proc.stdout)
        _check(link, proc.returncode, proc.stdout)
        os.replace(tmp, path)    # atomic: a concurrent build loses nothing
    finally:
        for f in (tmp, *objs):
            f.unlink(missing_ok=True)
    return {"path": path, "seconds": time.perf_counter() - t0,
            "log": "".join(logs)}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built if needed, with its C entry points typed."""
    lib = ctypes.CDLL(str(build()["path"]))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tetris_step_launch.argtypes = [vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.tetris_step_launch.restype = i
    lib.tetris_raster_launch.argtypes = [vp, i, i, i, vp, vp, vp, i, i, i, vp,
                                         i, i, vp]
    lib.tetris_raster_launch.restype = i
    return lib

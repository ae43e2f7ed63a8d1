"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under `repro_torch/csrc/` has a plain C interface and is compiled
on its own into a shared library for sm_90a, at first use, into
`build/repro_torch/` at the root of the checkout. A library is named after its
source's content and the shared headers', so an edited source is rebuilt and
an unchanged one is loaded as it is. `build` starts one nvcc per missing library, all at once, and
waits for every one of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Sequence

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((pathlib.Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and pathlib.Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def library_path(source: pathlib.Path) -> pathlib.Path:
    """The library's path, named after the source, the headers beside it
    (`*.cuh`, which a source may include) and the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:12]}.so"


def build(sources: Sequence[pathlib.Path]) -> dict[pathlib.Path, pathlib.Path]:
    """Compile every source whose library is missing, in parallel.

    Returns {source: library}. The compiler's output (with `-Xptxas -v`:
    registers, shared memory and spills per kernel) is kept beside each
    library as `<library>.log`.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {pathlib.Path(s): library_path(pathlib.Path(s)) for s in sources}
    jobs = []
    for src, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in jobs:       # wait for all before raising
        log, _ = proc.communicate()
        lib.with_name(lib.name + ".log").write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(source: pathlib.Path) -> ctypes.CDLL:
    """Build `source` if needed and load its library."""
    source = pathlib.Path(source)
    return ctypes.CDLL(str(build([source])[source]))

"""Build and load the port's CUDA kernels.

Each source in ``fedml_tpu_torch/csrc/`` is compiled by hand with ``nvcc``
into a shared library with a plain C interface, loaded with ``ctypes``. The
library lands in ``fedml_tpu_torch/_build/`` (git-ignored), named by a hash
of the source and the flags, so an edited source builds anew and an
unchanged one loads the library already there. Nothing is downloaded: the
build reads only the repository's sources and the CUDA toolkit.

``build(names)`` starts one ``nvcc`` per source, all at once, and waits for
all of them; ``load(name)`` builds at first use and returns the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict:
    """Compile every named source that has no library yet, one ``nvcc`` each,
    started together. Returns {name: ptxas report} for what was built;
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".ptxas.txt").write_text(log)
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]

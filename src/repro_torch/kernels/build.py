"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` on its own into ``build/repro_torch/<name>-<hash>.so`` at the
repository root, at first use::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/<name>.cu

No PyTorch header is included, so a source builds in seconds.  The hash
of the source names the library, so an edited source is rebuilt and an
unchanged one is loaded as it is.  :func:`build_all` starts one ``nvcc``
per source, all at once.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["BUILD_DIR", "CSRC", "build_all", "library", "nvcc_command",
           "ptxas_log", "sources"]

CSRC = Path(__file__).resolve().parent / "csrc"
#: ``build/repro_torch`` at the repository root (``build/`` is git-ignored)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> what ``-Xptxas -v`` printed (registers, shared memory, spills)
ptxas_log: Dict[str, str] = {}


def sources() -> List[str]:
    """Names of the CUDA sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "repro_torch: nvcc not found (neither on PATH nor under "
        f"{cuda_home}/bin); the CUDA kernels build from csrc/ with the CUDA "
        "toolkit")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> List[str]:
    """The ``nvcc`` command line that builds ``csrc/<name>.cu`` into ``out``."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(CSRC / f"{name}.cu")]


def _start(name: str) -> Tuple[subprocess.Popen, Path]:
    tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(nvcc_command(name, tmp, _nvcc()),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"repro_torch: nvcc failed on csrc/{name}.cu "
            f"(exit {proc.returncode}):\n{log}")
    ptxas_log[name] = log
    os.replace(tmp, _lib_path(name))


def build_all(names: Optional[List[str]] = None) -> Dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every source not yet loaded."""
    names = sources() if names is None else list(names)
    with _lock:
        todo = [n for n in names if n not in _libs and not _lib_path(n).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = {n: _start(n) for n in todo}
            try:
                for n, (p, tmp) in procs.items():
                    _finish(n, p, tmp)
            finally:
                for p, _ in procs.values():
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        for n in names:
            if n not in _libs:
                _libs[n] = ctypes.CDLL(str(_lib_path(n)))
        return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all([name])[name]

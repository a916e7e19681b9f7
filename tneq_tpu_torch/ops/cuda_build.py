"""Build and load the port's hand-written CUDA kernels (``nvcc`` + ``ctypes``).

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, for Hopper
(``sm_90a``), into its own shared library under ``tneq_tpu_torch/_build/``
(listed in ``.gitignore``).  The library name carries a digest of the source
and the flags, so an edited source rebuilds and a built one is reused.
Nothing is compiled when a module is imported: the first kernel launch, or
an explicit :func:`build`, compiles.  :func:`build` starts one ``nvcc`` per
source, all together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "build", "build_log", "library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("chain_sweep", "transfer_step")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the build log
)
_BUILD_LOCK = threading.Lock()  # threads of one process build one at a time


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"], "bin", "nvcc")))
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the port's CUDA kernels are compiled on the machine with the "
        "card"
    )


def _target(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every listed source that is not built yet, one ``nvcc`` per
    source started together; returns ``{name: path to the .so}``.  Raises
    with the compiler's output if any build fails."""
    names = tuple(names)
    with _BUILD_LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        running = {}
        try:
            for name in names:
                out = _target(name)
                if out.exists():
                    continue
                tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                proc = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                )
                running[name] = (proc, tmp, out)
            failed = []
            for name, (proc, tmp, out) in running.items():
                text, _ = proc.communicate()
                out.with_suffix(".log").write_text(text)
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{text}")
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("\n".join(failed))
        finally:
            for proc, tmp, _ in running.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                tmp.unlink(missing_ok=True)
    return {name: _target(name) for name in names}


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` ('' if none)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(str(build((name,))[name]))

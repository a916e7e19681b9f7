"""Build and load the native contraction-path finder (``g++`` + ``ctypes``).

Counterpart of ``tneq_tpu/native/build.py``.  ``native/pathfinder.cpp`` is
the port's own copy of the reference's source; it compiles with ``g++ -O3
-shared -fPIC -std=c++17`` into ``tneq_tpu_torch/_build/`` (listed in
``.gitignore``), under a name that carries a digest of the source and the
flags, so an edited source rebuilds and a built one is reused.  Nothing is
compiled when a module is imported: the first path search compiles.

Unlike JAX's loader, a failed build raises with the compiler's output: the
port has no ``opt_einsum`` to fall back on (the machine with the card lacks
it), and a silent fallback would change every contraction order.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["CXX", "CXX_FLAGS", "build", "load_library"]

_SRC = Path(__file__).resolve().parent / "pathfinder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_BUILD_LOCK = threading.Lock()  # threads of one process build one at a time


def _target() -> Path:
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libpathfinder-{digest}.so"


def build(cxx: str = CXX) -> Path:
    """Compile ``pathfinder.cpp`` unless it is built already; returns the
    path of the shared library.  Raises ``RuntimeError`` with the compiler's
    output if the build fails."""
    with _BUILD_LOCK:
        out = _target()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            try:
                proc = subprocess.run(
                    [cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                    capture_output=True, text=True, timeout=300,
                )
            except OSError as e:
                raise RuntimeError(
                    f"cannot run the C++ compiler {cxx!r} for {_SRC.name}: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{cxx} failed for {_SRC.name} (rc {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)  # atomic: concurrent processes race harmlessly
        finally:
            tmp.unlink(missing_ok=True)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The path-finder library with its C signatures declared, built if
    needed."""
    lib = ctypes.CDLL(str(build()))
    I, PI = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    PD = ctypes.POINTER(ctypes.c_double)
    common = [I, PI, PI, PD, I, PI, I]
    for fn, last in ((lib.tneq_find_path, PI), (lib.tneq_find_path_dp, PI),
                     (lib.tneq_path_cost, PD)):
        fn.argtypes = common + [last]
        fn.restype = I
    return lib

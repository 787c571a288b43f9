"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of
them at once, for ``sm_90a`` (H100), and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. The build
happens at first use, under ``build/repro_torch/<hash>/`` in the checkout
(listed in ``.gitignore``); the hash covers the sources, the headers and
the flags, so an edited kernel is rebuilt and an unchanged one is not.

Each C entry point launches on the stream it is given and returns the
``cudaGetLastError()`` of its launch; :func:`check` turns a non-zero code
into an exception, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["library", "kernel", "check", "BUILD_ROOT", "CSRC",
           "SMEM_LIMIT"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]
_LIB_NAME = "libreprotorch.so"
# dynamic shared memory one block may have on the H100 (227 KB):
# rt::SMEM_LIMIT in csrc/bsr_tile.cuh, which every kernel checks
SMEM_LIMIT = 232_448
_lib: list[ctypes.CDLL] = []
_fns: dict[str, ctypes._CFuncPtr] = {}
# the first load may come from two threads at once (the service's
# dispatcher and a warm-pool build): one builds, the other waits
_load_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build(out: Path) -> None:
    """Compile every source in parallel, link, and move the library into
    ``out`` in one rename (a reader never sees half a library). nvcc's
    output, ``-Xptxas -v`` register and shared-memory counts included, is
    kept in ``out/build.log``."""
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name} (exit {proc.returncode})\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(tmp / _LIB_NAME),
             *sorted(str(p) for p in tmp.glob("*.o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        (tmp / "build.log").write_text("\n".join(log))
        os.rename(tmp, out)
    except OSError:
        if not (out / _LIB_NAME).exists():   # a concurrent build won: fine
            raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none.
    Thread-safe: concurrent first calls build and load it once."""
    if not _lib:
        with _load_lock:
            if not _lib:
                out = _build_dir()
                if not (out / _LIB_NAME).exists():
                    _build(out)
                lib = ctypes.CDLL(str(out / _LIB_NAME))
                lib.rt_error_string.argtypes = [ctypes.c_int]
                lib.rt_error_string.restype = ctypes.c_char_p
                _lib.append(lib)
    return _lib[0]


def kernel(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry point ``name`` with its argument types declared (every
    pointer and the stream as ``c_void_p``, so none is cut to 32 bits).
    Declared once and kept: the chunked eMA calls its wrappers thousands of
    times a coloring."""
    fn = _fns.get(name)
    if fn is None:
        # indexing makes a new function object (attribute access would
        # share one): declared in full before another thread reads it
        fn = library()[name]
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code:
        msg = library().rt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")

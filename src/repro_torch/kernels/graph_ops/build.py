"""Build and load the hand-written CUDA kernels of this package.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared library
with a plain C interface (``extern "C"`` launch functions) and loaded with
``ctypes``.  The libraries land in ``build/repro_torch/`` at the root of
the checkout, named by a hash of their source and flags, so an edited
source is rebuilt and a stale library is never loaded.  All sources that
need building are compiled at once, one ``nvcc`` process each.

Nothing happens at import: the first call of ``load()`` builds and loads.
A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# (argtypes, restype) of every exported function, keyed by library (source
# stem); pointers and the stream are c_void_p so ctypes never cuts them
SIGNATURES = {
    "graph_ops": {
        "graph_ops_edge_relax": (
            [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P], _I),
        "graph_ops_advance": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
             _P, _P, _P, _P, _P, _P, _P, _P], _I),
        "graph_ops_error_string": ([_I], ctypes.c_char_p),
    },
}

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels of repro_torch cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    returns {stem: library path}.  Raises on the first failed build."""
    global build_seconds
    t0 = time.perf_counter()
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))}
    todo = [(stem, src, lib) for stem, (src, lib) in targets.items()
            if not lib.exists()]
    nvcc = nvcc_path() if todo else None
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for stem, src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((stem, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for stem, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return {stem: lib for stem, (_, lib) in targets.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built at first use."""
    if stem not in _libs:
        paths = build_all()
        lib = ctypes.CDLL(str(paths[stem]))
        for name, (argtypes, restype) in SIGNATURES[stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _libs[stem] = lib
    return _libs[stem]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function reported a CUDA error."""
    if rc != 0:
        msg = lib.graph_ops_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")

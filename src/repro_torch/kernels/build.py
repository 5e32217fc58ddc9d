"""Build and load the hand-written CUDA kernels of this package.

Every ``kernels/*/csrc/*.cu`` file is compiled by ``nvcc`` into its own
shared library with a plain C interface (``extern "C"`` launch functions)
and loaded with ``ctypes``.  The libraries land in ``build/repro_torch/``
at the root of the checkout, named by a hash of their source and flags, so
an edited source is rebuilt and a stale library is never loaded.  All
sources that need building are compiled at once, one ``nvcc`` process
each.

Each library exports ``<stem>_error_string(int)``, which ``check`` uses to
name a CUDA error code returned by one of its launch functions.

``nvcc`` runs with ``-Xptxas -v``; its output is kept beside the library
(``<library>.ptxas.txt``), and ``ptxas_info`` reads each kernel's
registers, spills and shared memory from it.

Nothing happens at import: the first call of ``load()`` builds and loads.
A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

KERNELS = Path(__file__).resolve().parent
BUILD_DIR = KERNELS.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)

# (argtypes, restype) of every exported launch function, keyed by library
# (source stem); pointers and the stream are c_void_p so ctypes never cuts
# them.  ``<stem>_error_string`` is added to each by ``load``.
SIGNATURES = {
    "graph_ops": {
        # src, dst, w, mask, src_val, out_init, out, m, n_pad, dtype, kind,
        # use_weight, case, flag, gate (or null), stream
        "graph_ops_edge_relax": (
            [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P, _P, _P], _I),
        # src, dst, w, valid (or null), active, src_val, seed (or null), out,
        # m, n_pad, lanes, dtype, kind, use_weight, at (or null), n_at,
        # changed (or null), beyond (or null), words, flag, stream
        "graph_ops_edge_relax_lanes": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I,
             _P, _LL, _P, _P, _P, _P, _P], _I),
        "graph_ops_advance": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
             _P, _P, _P, _P, _P, _P, _P, _P], _I),
        # adj, n_rows, dmax, src, dst, row_len, e, chunk, scratch, partial,
        # nch, stream
        "graph_ops_intersect": ([_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P], _I),
        "graph_ops_intersect_scratch": ([_LL, _I], _LL),   # e, dmax
    },
    "device_loop": {
        # body graph, k, limit, go, exec out
        "device_loop_build": ([_P, _P, _P, _P, _PP], _I),
        "device_loop_launch": ([_P, _P], _I),   # exec, stream
        "device_loop_destroy": ([_P], _I),      # exec
    },
    "embedding_bag": {
        # ids, weights, table, out, B, L, V, D, table dtype, vector bytes, stream
        "embedding_bag_forward": ([_P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _P], _I),
    },
    "spmm_bsr": {
        # indices, blocks, x, out, R, K, bm, bk, n_col_blocks, F,
        # blocks dtype, x dtype, stream
        "spmm_bsr_forward": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
                             _I),
    },
    "crc32": {
        # data, nbytes, segment, pad, blocks, combine threads, chunk, powers
        # (host array), init term, scratch, out on the card, out on the host
        # (pinned, or null), stream
        "crc32_device": ([_P, _LL, _I, _LL, _LL, _I, _LL, _P, ctypes.c_uint32, _P, _P, _P,
                          _P], _I),
    },
    "flash_attention": {
        # q, k, v, out, bh, s, d, causal, window (-1 = none), scale, splits
        # (f32 only), stream; f32 in split TF32 and bf16 (``_tc``), both on
        # the tensor cores
        "flash_attention_forward": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P], _I),
        "flash_attention_forward_tc": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P], _I),
        "flash_attention_f32_smem_bytes": ([_I], _I),  # d
        "flash_attention_tc_smem_bytes": ([_I], _I),   # d
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


def sources() -> dict[str, Path]:
    """{stem: source} of every kernel library, one per ``*/csrc/*.cu``."""
    return {src.stem: src for src in sorted(KERNELS.glob("*/csrc/*.cu"))}


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def _log(lib: Path) -> Path:
    return lib.with_name(lib.name + ".ptxas.txt")


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    returns {stem: library path}.  Raises if any build failed."""
    global build_seconds
    t0 = time.perf_counter()
    targets = {stem: (src, _target(src)) for stem, src in sources().items()}
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
            _log(lib).write_text(out)
            os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    if todo:   # the time of the call that built, not of a later one that found all
        build_seconds = time.perf_counter() - t0
    return {stem: lib for stem, (_, lib) in targets.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``<pkg>/csrc/<stem>.cu``, built at first use."""
    if stem not in _libs:
        paths = build_all()
        lib = ctypes.CDLL(str(paths[stem]))
        sigs = dict(SIGNATURES[stem])
        sigs[f"{stem}_error_string"] = ([_I], ctypes.c_char_p)
        for name, (argtypes, restype) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        lib.error_string = getattr(lib, f"{stem}_error_string")
        _libs[stem] = lib
    return _libs[stem]


def ptxas_info(stem: str) -> dict[str, dict[str, int]]:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads",
    "stack", "smem"}} from ``-Xptxas -v``'s lines of ``<stem>``'s build
    (``smem`` is the static shared memory; dynamic comes at launch)."""
    info: dict[str, dict[str, int]] = {}
    name = None
    for line in _log(build_all()[stem]).read_text().splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line):
            name = m.group(1)
            info.setdefault(name, {})
        elif name and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            info[name].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            info[name]["registers"] = int(m[1])
            sm = re.search(r"(\d+) bytes smem", line)
            info[name]["smem"] = int(sm[1]) if sm else 0
    return info


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function of ``lib`` reported a CUDA error."""
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")

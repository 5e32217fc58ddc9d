"""Persistent graph store: the store half of ``repro.checkpoint.manager``.

``save_graph`` / ``open_graph`` persist a graph once as block-granular
edge shards and map them back on every later run (the Metall analogue of
the paper's persistent-memory setting).  One **uncompressed** ``.npz`` per
shard (members ``src``, ``dst``, ``w``), a ``vertices.npz`` with the O(n)
arrays, and ``graph_manifest.json`` written **last** as the commit record:
a crash between shard writes leaves no manifest, and ``open_graph``
refuses cleanly.

The layout, the manifest's keys and the CRC32 of each shard are the
reference's byte for byte, so a store either package wrote opens in the
other.  ``np.load(..., mmap_mode="r")`` ignores ``mmap_mode`` for ``.npz``
archives, so ``open_graph`` finds each stored ``.npy`` member inside the
zip and hands it to ``np.memmap``: pages fault in only when a shard is
actually streamed (through ``TieredGraph``'s pinned staging ring).

Run checkpoints (``RunCheckpointer``, ``save_pytree`` / ``load_pytree``)
are ROADMAP queue 1, item 8, and dynamic stores (``save_dynamic`` /
``open_dynamic``, format v3) item 9.
"""

from __future__ import annotations

import json
import os
import time
import warnings
import zipfile
from typing import Optional

import numpy as np
from numpy.lib import format as npformat

from ..core.faultio import ShardCorruptError
from ..core.tiered import TieredGraph, shard_crc, tier_graph

GRAPH_MANIFEST = "graph_manifest.json"
_GRAPH_FORMAT = "tiered-graph-v2"
_GRAPH_FORMATS = ("tiered-graph-v1", "tiered-graph-v2", "tiered-graph-v3")
_SHARD_DTYPES = ("int32", "int32", "float32")  # src, dst, w


def _mmap_npz_member(path: str, name: str) -> Optional[np.ndarray]:
    """Memory-map one array of an uncompressed ``.npz`` archive: find the
    stored ``.npy`` member's data offset (local zip header + npy header)
    and hand it to ``np.memmap``.  ``None`` when the member cannot be
    mapped (compressed entry, unexpected header): callers load it."""
    try:
        with zipfile.ZipFile(path) as zf:
            info = zf.getinfo(name + ".npy")
            if info.compress_type != zipfile.ZIP_STORED:
                return None
        with open(path, "rb") as f:
            f.seek(info.header_offset)
            hdr = f.read(30)
            if hdr[:4] != b"PK\x03\x04":
                return None
            fnlen = int.from_bytes(hdr[26:28], "little")
            exlen = int.from_bytes(hdr[28:30], "little")
            f.seek(info.header_offset + 30 + fnlen + exlen)
            version = npformat.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = npformat.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = npformat.read_array_header_2_0(f)
            else:
                return None
            if fortran or dtype.hasobject:
                return None
            offset = f.tell()
        return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape)
    except (KeyError, OSError, ValueError):
        return None


def _load_shard_arrays(path: str, names=("src", "dst", "w")):
    """Map (preferred) or load the named arrays of one shard archive."""
    out = []
    eager = None
    for name in names:
        arr = _mmap_npz_member(path, name)
        if arr is None:
            if eager is None:
                eager = np.load(path)
            arr = eager[name]
        out.append(arr)
    return tuple(out)


def _shard_path(directory: str, sid: int, direction: str = "csr") -> str:
    prefix = "cscshard" if direction == "csc" else "shard"
    return os.path.join(directory, f"{prefix}_{sid:06d}.npz")


def _replace_written(final: str, write) -> None:
    """Stage ``final`` as ``final.tmp`` through ``write(file)``, then
    ``os.replace`` it into place."""
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, final)


def save_graph(g, directory: str, nshards: int = 8,
               build_csc: Optional[bool] = None) -> str:
    """Persist a graph as a tiered shard store.

    ``g`` is a port ``Graph`` (cut here with ``tier_graph(g, nshards)``, on
    the host) or a ``TieredGraph`` (its cut is persisted; ``nshards`` is
    ignored).  Stale ``*.tmp`` files of a crashed save are swept first,
    each file is staged to ``*.tmp`` and ``os.replace``d, and the manifest
    goes last.  The manifest records each shard's CRC32 over the padded
    (src, dst, w) bytes, the dtypes and the padded shape.

    ``build_csc``: ``None`` persists a CSC mirror whenever the source has
    one, ``True`` requires it, ``False`` drops it.  CSC shards are
    ``cscshard_NNNNNN.npz`` with a ``"csc"`` manifest block, and ``in_deg``
    rides in ``vertices.npz``.
    """
    if not isinstance(g, TieredGraph):
        want_csc = g.has_csc if build_csc is None else bool(build_csc)
        g = tier_graph(g, nshards, build_csc=want_csc, device="cpu")
    elif build_csc and not g.has_csc:
        raise ValueError(
            "build_csc=True but this TieredGraph was cut without a CSC "
            "mirror; re-cut with tier_graph(..., build_csc=True)")
    save_csc = g.has_csc and build_csc is not False
    os.makedirs(directory, exist_ok=True)
    for f in os.listdir(directory):
        if f.endswith(".tmp"):
            try:
                os.remove(os.path.join(directory, f))
            except OSError:
                pass

    def write_shards(host, direction):
        crcs = []
        for sid in range(g.nshards):
            src, dst, w = host[sid]
            crcs.append(shard_crc(src, dst, w))
            _replace_written(_shard_path(directory, sid, direction), lambda f: np.savez(
                f, src=np.asarray(src), dst=np.asarray(dst), w=np.asarray(w)))
        return crcs

    crcs = write_shards(g._host, "csr")
    vertices = {"out_deg": g.out_deg.cpu().numpy().astype(np.int32)}
    manifest = {
        "format": _GRAPH_FORMAT,
        "n": g.n, "m": g.m, "n_pad": g.n_pad,
        "block_size": g.block_size,
        "nshards": g.nshards, "epd": g.epd,
        "vtx_bounds": [int(x) for x in g.vtx_bounds],
        "shard_sizes": [int(x) for x in g.shard_sizes],
        "shard_crcs": crcs,
        "shard_dtypes": list(_SHARD_DTYPES),
        "shard_shape": [g.epd],
        "time": time.time(),
    }
    if save_csc:
        manifest["csc"] = {
            "shard_sizes": [int(x) for x in g.in_shard_sizes],
            "shard_crcs": write_shards(g._csc_host, "csc"),
        }
        vertices["in_deg"] = g.in_deg.cpu().numpy().astype(np.int32)
    _replace_written(os.path.join(directory, "vertices.npz"),
                     lambda f: np.savez(f, **vertices))
    _replace_written(os.path.join(directory, GRAPH_MANIFEST),
                     lambda f: f.write(json.dumps(manifest).encode()))
    return directory


def open_graph(directory: str, resident_shards: int = 2,
               resident_bytes: Optional[int] = None, verify: str = "fetch",
               *, device=None) -> TieredGraph:
    """Open a persisted graph store as a ``TieredGraph`` whose host shards
    are memory-mapped off disk, its vertex tier on ``device`` (the card by
    default).

    Raises ``FileNotFoundError`` without a manifest (the save never
    committed) and ``ValueError`` when the manifest and the shard files
    disagree (missing or wrong-shape shards, a dynamic store with pending
    deltas); a shard archive that cannot be parsed raises
    ``ShardCorruptError`` naming the shard.

    ``verify``: ``"fetch"`` (default) checks each shard's CRC32 the first
    time it streams, and every time after; ``"open"`` scans every shard now;
    ``"require"`` is ``"open"`` that also refuses a store with no
    checksums (a v1 manifest); ``"off"`` trusts the store.  A v1 store
    under ``"fetch"``/``"open"`` opens with a ``UserWarning`` and
    ``verified=False``.
    """
    if verify not in ("fetch", "open", "require", "off"):
        raise ValueError(f"verify must be fetch|open|require|off, got {verify!r}")
    mpath = os.path.join(directory, GRAPH_MANIFEST)
    if not os.path.exists(mpath):
        raise FileNotFoundError(
            f"{directory} has no {GRAPH_MANIFEST} — either not a graph "
            "store or a save crashed before committing; re-run save_graph")
    with open(mpath) as f:
        man = json.load(f)
    if man.get("format") not in _GRAPH_FORMATS:
        raise ValueError(f"unknown graph store format {man.get('format')!r}")
    logs = man.get("logs")
    if logs is not None and any(int(s) for s in logs.get("sizes", ())):
        raise ValueError(
            f"graph store {directory} is a dynamic (v3) store with pending "
            "edge-log deltas; opening it as a plain TieredGraph would "
            "silently drop them (dynamic stores are ROADMAP queue 1, item 9)")
    nshards, epd = int(man["nshards"]), int(man["epd"])
    crcs = man.get("shard_crcs")  # absent on v1 stores: unverifiable
    if crcs is None:
        if verify == "require":
            raise ValueError(
                f"graph store {directory} has a v1 manifest with no "
                "per-shard checksums; verify='require' refuses to open an "
                "unverifiable store — re-run save_graph to upgrade it, or "
                "open with verify='fetch' to proceed unverified")
        if verify != "off":
            warnings.warn(
                f"graph store {directory} has a v1 manifest with no "
                f"per-shard checksums: opening UNVERIFIED (verify="
                f"{verify!r} has nothing to check); re-run save_graph to "
                "record integrity records", UserWarning, stacklevel=2)
    dtypes = tuple(man.get("shard_dtypes", _SHARD_DTYPES))
    eager_scan = verify in ("open", "require")

    def read_cut(direction, cut_crcs):
        shards = []
        for sid in range(nshards):
            path = _shard_path(directory, sid, direction)
            if not os.path.exists(path):
                raise ValueError(
                    f"graph store {directory} is incomplete: manifest "
                    f"promises {nshards} {direction} shards but "
                    f"{os.path.basename(path)} is missing")
            try:
                src, dst, w = _load_shard_arrays(path)
            except Exception as e:  # zip/npy parse failures → typed, named
                raise ShardCorruptError(
                    f"graph store {directory} {direction} shard {sid} is "
                    f"unreadable ({type(e).__name__}: {e}) — torn or "
                    "truncated write; restore the shard or re-run "
                    "save_graph") from e
            if not (src.shape == dst.shape == w.shape == (epd,)):
                raise ValueError(
                    f"graph store {directory} {direction} shard {sid} has "
                    f"shape {src.shape}/{dst.shape}/{w.shape}, manifest "
                    f"says ({epd},)")
            got_dt = (str(src.dtype), str(dst.dtype), str(w.dtype))
            if got_dt != dtypes:
                raise ValueError(
                    f"graph store {directory} {direction} shard {sid} has "
                    f"dtypes {got_dt}, manifest says {dtypes}")
            if eager_scan and cut_crcs is not None:
                got = shard_crc(src, dst, w)
                if got != int(cut_crcs[sid]):
                    raise ShardCorruptError(
                        f"graph store {directory} {direction} shard {sid}: "
                        f"crc32 {got:#010x} != manifest "
                        f"{int(cut_crcs[sid]):#010x} — bit-rot or torn "
                        "write; restore from a replica or re-run "
                        "save_graph")
            shards.append((src, dst, w))
        return shards

    shards = read_cut("csr", crcs)
    vertices = np.load(os.path.join(directory, "vertices.npz"))
    csc_kw = {}
    csc = man.get("csc")
    if csc is not None:
        in_crcs = csc.get("shard_crcs")
        csc_kw = dict(
            csc_host=read_cut("csc", in_crcs),
            in_shard_sizes=np.asarray(csc["shard_sizes"], np.int64),
            in_shard_crcs=in_crcs,
            in_deg=vertices["in_deg"],
        )
    if resident_bytes is not None:
        resident_shards = max(2, int(resident_bytes) // (epd * 12))
    return TieredGraph(
        n=int(man["n"]), m=int(man["m"]), n_pad=int(man["n_pad"]),
        block_size=int(man["block_size"]), nshards=nshards, epd=epd,
        vtx_bounds=np.asarray(man["vtx_bounds"], np.int64),
        shard_sizes=np.asarray(man["shard_sizes"], np.int64),
        host_shards=shards, out_deg=vertices["out_deg"],
        resident_shards=resident_shards,
        shard_crcs=crcs, verify_checksums=(verify != "off"),
        verified=(verify != "off"), device=device,
        **csc_kw,
    )

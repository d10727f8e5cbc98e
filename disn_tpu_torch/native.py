"""ctypes bindings for the host C++ passes of native/: the mesh assembler
(meshassemble.cpp), for evaluation the OBJ formatter and parser
(objwriter.cpp, objreader.cpp) and the exact surface voxelizer
(voxelsat.cpp), and for preprocess-sdf the signed distance field
(distfield.cpp, multithreaded, built with -pthread).

The record route of ``ops/marching.py`` ships per-cell records to the host;
these C++ passes rebuild the welded mesh from them, in the device
extractor's vertex order and with its triangle tables. Each library is
compiled with the host C++ compiler at first use into ``build/native/``
under the repository root, named by a hash of its sources, the flags and
the CPU's features (the flags include -march=native), and loaded with
ctypes. A build failure raises (``RuntimeError``), and so
does a pass that reports inconsistent input: there is no fallback here.
The numpy versions (``marching.assemble_mesh_np``, ``derive_recs_np``,
``expand_block_ids_np``) exist for tests and for callers that ask for
them by name.

Bound here: ``mesh_expand_ids``, ``derive_recs``, ``mesh_faces_blocks``,
``mesh_verts_blocks`` and ``mesh_assemble`` (libmeshassemble); the
incremental entry points of that source (``*_incr``, ``*_range``) serve
chunked record streams, which the port does not have. ``format_obj``,
``parse_obj`` and ``voxelize_sat`` (libevalio, the three evaluation
sources in one library). ``compute_distance_field`` (libdistfield).
Every call releases the GIL (ctypes), so the evaluator's, the writer's and
preprocess-sdf's pool threads overlap.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

from disn_tpu_torch.kernels import build_lock
from disn_tpu_torch.ops import marching

_NATIVE = Path(__file__).resolve().parents[1] / "native"
_SRC = _NATIVE / "meshassemble.cpp"
_EVAL_SRCS = tuple(_NATIVE / f for f in ("objwriter.cpp", "objreader.cpp",
                                          "voxelsat.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

_I32P = ctypes.POINTER(ctypes.c_int32)
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32, _I64 = ctypes.c_int32, ctypes.c_int64


def _cpu_tag() -> str:
    """What -march=native depends on: the machine type and, where the
    system lists them, the CPU's feature flags. A build directory copied to
    another machine then gets a library of its own there."""
    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return tag + line
    except OSError:
        pass
    return tag


def _build(name: str, srcs: tuple[Path, ...], extra: tuple = ()) -> Path:
    """Compile `srcs` with CXX_FLAGS and `extra` into lib<name>-<hash>.so
    (once per hash of the sources, the flags and the CPU's features) and
    return its path. One thread at a time builds a library."""
    flags = (*CXX_FLAGS, *extra)
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs)
                            + " ".join(flags).encode()
                            + _cpu_tag().encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    with build_lock(lib.name):
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(
                [cxx, *flags, "-o", str(tmp), *map(str, srcs)],
                capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(
                f"cannot run the C++ compiler {cxx!r}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on "
                               f"{', '.join(p.name for p in srcs)}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def build() -> Path:
    """Compile native/meshassemble.cpp and return the library's path."""
    return _build("meshassemble", (_SRC,))


def build_eval() -> Path:
    """Compile the OBJ formatter, the OBJ parser and the voxelizer into one
    library and return its path."""
    return _build("evalio", _EVAL_SRCS)


def build_distfield() -> Path:
    """Compile native/distfield.cpp (std::thread: -pthread) and return the
    library's path."""
    return _build("distfield", (_NATIVE / "distfield.cpp",), ("-pthread",))


@functools.lru_cache(maxsize=None)
def _distfield_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_distfield()))
    lib.compute_distance_field.restype = ctypes.c_int
    lib.compute_distance_field.argtypes = [
        _F32P, _I32, _I32P, _I32, _I32, ctypes.POINTER(ctypes.c_double),
        _F32P, _I32, _I32, ctypes.c_double]
    return lib


@functools.lru_cache(maxsize=None)
def _eval_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_eval()))
    lib.format_obj.restype = _I64
    lib.format_obj.argtypes = [_F32P, _I32, _I32P, _I32,
                               ctypes.POINTER(ctypes.c_char), _I64]
    lib.parse_obj.restype = _I64
    lib.parse_obj.argtypes = [ctypes.c_char_p, _I64, _F32P, _I64, _I32P,
                              _I64, _I64P]
    lib.voxelize_sat.restype = None
    lib.voxelize_sat.argtypes = [_F32P, _I64, _I32P, _I64, _I32,
                                 ctypes.c_float, ctypes.c_float, _U8P]
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    blocks = [_I32P, _U32P, _U32P, _I32]        # bids, mask lo, mask hi, rows
    lib.mesh_expand_ids.restype = _I64
    lib.mesh_expand_ids.argtypes = [*blocks, _I32, _I32, _I32P]
    lib.derive_recs.restype = ctypes.c_int
    lib.derive_recs.argtypes = [*blocks, _U8P, _I64, _I32, _I32, _I32P,
                                _I32P, _U32P]
    lib.mesh_faces_blocks.restype = _I64
    lib.mesh_faces_blocks.argtypes = [*blocks, _U32P, _I32, _I32, _I32,
                                      *[_I32P] * 6]
    lib.mesh_verts_blocks.restype = _I64
    lib.mesh_verts_blocks.argtypes = [*blocks, _U32P, _U16P, _I32, _I32,
                                      _I32, _I32, _I64, _I32P, _I32P, _I32P,
                                      _F32P, _F32P]
    lib.mesh_assemble.restype = ctypes.c_int
    lib.mesh_assemble.argtypes = [_I32P, _U32P, _U16P, _I32, _I32, _I32,
                                  *[_I32P] * 7, _F32P, _F32P, _I32P, _I64P]
    return lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _block_args(blk: np.ndarray) -> tuple[list[np.ndarray], list]:
    """blk [b,3] int32 rows -> (the arrays, kept alive by the caller, and
    the four leading C arguments every blocks-driven pass takes)."""
    blk = _i32(blk)
    if blk.ndim != 2 or blk.shape[1] != 3:
        raise ValueError(f"blk must be [b,3] int32 rows, got {blk.shape}")
    bids = np.ascontiguousarray(blk[:, 0])
    mlo = np.ascontiguousarray(blk[:, 1]).view(np.uint32)
    mhi = np.ascontiguousarray(blk[:, 2]).view(np.uint32)
    return [bids, mlo, mhi], [_ptr(bids, _I32P), _ptr(mlo, _U32P),
                              _ptr(mhi, _U32P), np.int32(len(blk))]


def _face_tables() -> list[np.ndarray]:
    _, _, nb_tbl, dir_tbl = marching._owned_tables()
    return [_i32(marching.CORNERS), _i32(marching.TETS),
            _i32(marching._tables()[1]), _i32(nb_tbl), _i32(dir_tbl)]


def _vert_tables() -> list[np.ndarray]:
    pair_i, pair_j, _, _ = marching._owned_tables()
    return [_i32(pair_i), _i32(pair_j), _i32(marching.CORNERS)]


def _tq_u16(tq: np.ndarray) -> np.ndarray:
    """The assemblers read u16 fixed point; u8 maps onto it exactly
    (255 * 257 == 65535)."""
    tq = np.asarray(tq)
    if tq.dtype == np.uint8:
        tq = tq.astype(np.uint16) * np.uint16(257)
    return np.ascontiguousarray(tq, np.uint16)


def _records(recs: np.ndarray, n_cells: int) -> np.ndarray:
    if len(recs) < n_cells:
        raise RuntimeError(f"{len(recs)} record slots < {n_cells} cells "
                           "(the stream under-covers the scan)")
    return np.ascontiguousarray(recs[:n_cells], np.uint32)


def mesh_expand_ids(blk: np.ndarray, R: int) -> tuple[np.ndarray, int]:
    """The scan's (block id, mask lo, mask hi) rows -> (ids int32 [n], n):
    the flat cell-id list of the device compaction."""
    keep, args = _block_args(blk)
    out = np.empty(len(keep[0]) * marching.BLOCK ** 3, np.int32)
    n = int(_lib().mesh_expand_ids(*args, np.int32(R),
                                   np.int32(marching.BLOCK),
                                   _ptr(out, _I32P)))
    return out[:n].copy(), n


def derive_recs(blk: np.ndarray, imask: np.ndarray, R: int) -> np.ndarray:
    """u8 inside masks of the slots the rows encode -> uint32 records
    (crossing mask << 8 | inside mask); see marching.derive_recs_np."""
    keep, args = _block_args(blk)
    imask = np.ascontiguousarray(imask, np.uint8)
    pair_j = _i32(marching._owned_tables()[1])
    alias = _i32(marching._alias_axes())
    out = np.empty(len(imask), np.uint32)
    rc = _lib().derive_recs(*args, _ptr(imask, _U8P), np.int64(len(imask)),
                            np.int32(R), np.int32(len(pair_j)),
                            _ptr(pair_j, _I32P), _ptr(alias, _I32P),
                            _ptr(out, _U32P))
    if rc:
        raise RuntimeError(f"derive_recs failed (rc={rc})")
    return out


def mesh_faces_blocks(blk: np.ndarray, recs: np.ndarray, n_cells: int,
                      R: int) -> np.ndarray:
    """Faces [ntri,3] int32 from the block rows and the records: a cell's
    neighbours resolve by popcounts on the masks, no id list needed."""
    keep, args = _block_args(blk)
    recs = _records(recs, n_cells)
    tables = _face_tables()
    faces = np.empty((max(n_cells, 1) * 12, 3), np.int32)
    ntri = int(_lib().mesh_faces_blocks(
        *args, _ptr(recs, _U32P), np.int32(n_cells), np.int32(R),
        np.int32(marching.D_OWNED), *[_ptr(t, _I32P) for t in tables],
        _ptr(faces, _I32P)))
    if ntri < 0:
        raise RuntimeError(f"mesh_faces_blocks failed (rc={ntri}): the "
                           "records and the block rows are inconsistent")
    return faces[:ntri].copy()


def mesh_verts_blocks(blk: np.ndarray, recs: np.ndarray, tq: np.ndarray,
                      n_cells: int, R: int, bbox: np.ndarray,
                      compact: bool = False, nv: int | None = None
                      ) -> np.ndarray:
    """Vertices [nv,3] f32 from the block rows, the records and the edge
    parameters. compact=True reads tq as the crossing-only vertex-order
    stream (pass nv); otherwise tq is slot-dense [n_cells, D]."""
    keep, args = _block_args(blk)
    recs = _records(recs, n_cells)
    if not compact and len(tq) < n_cells:
        raise RuntimeError(f"{len(tq)} tq rows < {n_cells} cells")
    tq = _tq_u16(tq if compact else tq[:n_cells])
    tables = _vert_tables()
    bbox = np.ascontiguousarray(bbox, np.float32)
    cap = max(nv, 1) if compact and nv is not None \
        else max(n_cells, 1) * marching.D_OWNED
    if compact and tq.size < cap:
        raise RuntimeError(f"compact tq stream has {tq.size} entries, "
                           f"caller claims {cap} vertices")
    verts = np.empty((cap, 3), np.float32)
    got = int(_lib().mesh_verts_blocks(
        *args, _ptr(recs, _U32P), _ptr(tq, _U16P),
        np.int32(1 if compact else 0), np.int32(n_cells), np.int32(R),
        np.int32(marching.D_OWNED), np.int64(cap),
        *[_ptr(t, _I32P) for t in tables], _ptr(bbox, _F32P),
        _ptr(verts, _F32P)))
    if got < 0 or (compact and nv is not None and got != nv):
        raise RuntimeError(f"mesh_verts_blocks emitted {got} vertices, the "
                           f"caller expects {nv} (inconsistent records)")
    return verts[:got].copy()


def mesh_assemble(ids: np.ndarray, recs: np.ndarray, tq: np.ndarray,
                  n_cells: int, R: int, bbox: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Welded (verts, faces) from the id list, the records and slot-dense
    edge parameters: the C++ twin of marching.assemble_mesh_np."""
    if len(ids) < n_cells or len(tq) < n_cells:
        raise RuntimeError(f"{len(ids)} ids / {len(tq)} tq rows < "
                           f"{n_cells} cells")
    ids = _i32(ids[:n_cells])
    recs = _records(recs, n_cells)
    tq = _tq_u16(tq[:n_cells])
    tables = _vert_tables() + _face_tables()[1:]
    bbox = np.ascontiguousarray(bbox, np.float32)
    verts = np.empty((max(n_cells, 1) * marching.D_OWNED, 3), np.float32)
    faces = np.empty((max(n_cells, 1) * 12, 3), np.int32)
    counts = np.zeros(2, np.int64)
    rc = _lib().mesh_assemble(
        _ptr(ids, _I32P), _ptr(recs, _U32P), _ptr(tq, _U16P),
        np.int32(n_cells), np.int32(R), np.int32(marching.D_OWNED),
        *[_ptr(t, _I32P) for t in tables], _ptr(bbox, _F32P),
        _ptr(verts, _F32P), _ptr(faces, _I32P), _ptr(counts, _I64P))
    if rc:
        raise RuntimeError(f"mesh_assemble failed (rc={rc}): the records "
                           "and the id list are inconsistent")
    return verts[:counts[0]].copy(), faces[:counts[1]].copy()


def format_obj(verts: np.ndarray, faces: np.ndarray | None) -> memoryview:
    """ASCII OBJ text of (verts [V,3] f32, faces [F,3] i32 0-based) from the
    C formatter, as a view of a buffer of its own."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(np.zeros((0, 3), np.int32)
                                 if faces is None else faces, np.int32)
    nv, nf = len(verts), len(faces)
    # the longest lines objwriter.cpp writes: 3 x 27 + 4 and 3 x 12 + 4
    buf = np.empty(nv * (3 * 27 + 4) + nf * (3 * 12 + 4) + 64, np.uint8)
    n = _eval_lib().format_obj(
        _ptr(verts, _F32P), nv, _ptr(faces, _I32P), nf,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_char)), int(buf.nbytes))
    if n < 0:
        raise RuntimeError("format_obj: buffer overflow")
    return memoryview(buf)[:n]


def parse_obj(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """ASCII OBJ bytes -> (verts [V,3] f32, faces [F,3] i32 0-based,
    polygons fan-triangulated) from the C parser. The capacities come from
    counts of line starts; a file with more triangles than two a face line
    is parsed again at the counts the parser reports."""
    vcap = max(1, data.count(b"\nv ") + data.startswith(b"v "))
    fcap = 2 * max(1, data.count(b"\nf ") + data.startswith(b"f "))
    counts = np.zeros(2, np.int64)
    for _ in range(2):
        verts = np.empty((vcap, 3), np.float32)
        faces = np.empty((fcap, 3), np.int32)
        rc = _eval_lib().parse_obj(data, len(data), _ptr(verts, _F32P),
                                   vcap, _ptr(faces, _I32P), fcap,
                                   _ptr(counts, _I64P))
        if rc == 0:
            return verts[:counts[0]].copy(), faces[:counts[1]].copy()
        if rc != -1:
            raise ValueError(f"parse_obj: malformed OBJ (rc={rc})")
        vcap, fcap = int(counts[0]), int(counts[1])
    raise RuntimeError("parse_obj: the parser's counts did not fit")


def voxelize_sat(verts: np.ndarray, faces: np.ndarray, dim: int = 110,
                 offset: float = 1.1, span: float = 2.4) -> np.ndarray:
    """Boolean [dim,dim,dim] occupancy: a cell is marked iff a triangle
    intersects it (the 13-axis separating-axis test of voxelsat.cpp). Cell
    (i,j,k) covers [-offset + i*cell, -offset + (i+1)*cell) per axis with
    cell = span/dim."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    occ = np.zeros(dim ** 3, np.uint8)
    _eval_lib().voxelize_sat(_ptr(verts, _F32P), len(verts),
                             _ptr(faces, _I32P), len(faces), dim,
                             offset, span, _ptr(occ, _U8P))
    return occ.reshape(dim, dim, dim).astype(bool)


def compute_distance_field(verts: np.ndarray, faces: np.ndarray, res: int,
                           bbox: np.ndarray, sign_votes: int = 3,
                           threads: int = 0, band: float = 0.0
                           ) -> np.ndarray:
    """Signed distance field on a (res+1)^3 grid, [z,y,x] indexed (x
    fastest). verts [V,3] float32, faces [F,3] int32, bbox [6] (x0 y0 z0
    x1 y1 z1); sign by parity rays along `sign_votes` axes (majority);
    `threads` 0 = one per core. band > 0: exact within `band` of the
    surface, a coarse interpolation beyond (needs res % 4 == 0, else the
    field is exact everywhere). Raises when the library reports a
    failure (no triangles, res <= 0)."""
    verts = np.ascontiguousarray(verts, dtype=np.float32)
    faces = np.ascontiguousarray(faces, dtype=np.int32)
    bbox = np.ascontiguousarray(bbox, dtype=np.float64)
    out = np.empty(((res + 1) ** 3,), dtype=np.float32)
    rc = _distfield_lib().compute_distance_field(
        _ptr(verts, _F32P), np.int32(len(verts)), _ptr(faces, _I32P),
        np.int32(len(faces)), np.int32(res),
        bbox.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _ptr(out, _F32P), np.int32(sign_votes), np.int32(threads),
        ctypes.c_double(band))
    if rc:
        raise RuntimeError(f"compute_distance_field failed (rc={rc})")
    return out.reshape(res + 1, res + 1, res + 1)

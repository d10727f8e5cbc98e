"""K7, the volume flow's owned-edge extractor: wrapper and build.

Replaces ``disn_tpu/ops/marching.py::_extract_owned`` (XLA code the JAX
package wrote for the TPU; ``_pack8`` is its TPU packing of the corner
values): over the first S slots of a cell list, one vertex a crossing
owned edge in (slot, direction) order and the welded triangles in (slot,
tet, triangle) order, with their counts and the corners whose owner is
not a live slot. The CUDA source is ``csrc/owned_extract.cu``; its header
note gives what it computes, its bound (bytes: the corner values read
once, the padded outputs written once) and the design.

``extract_owned`` (the fixed form: nothing read back) and
``extract_owned_exact`` (S = n, the counts read once) take CUDA tensors
only and launch on the current stream. With the scan's block rows
``blk`` [b,3] (block id, mask lo, mask hi), as every caller on the main
path passes them, a neighbour's slot is looked up through the rows: three
kernels. Without them (a hand-built id list) the owner table is dense
([R^3] int32, set by a memset): a memset and three kernels, counted in
``extract_owned.dense_calls``. The plain versions are ``ops/marching``'s
``_extract_owned_fixed_plain`` and ``_extract_owned_plain``, which take
``blk`` too, and ``ops/marching._extract_owned_fixed`` /
``_extract_owned`` send a CPU tensor there and a CUDA tensor here. There
is no fallback from the kernel to the plain versions.
``extract_owned.launches`` counts the calls of both; when
``extract_owned.inputs`` is a list, each call of either appends its
(args, kwargs) in ``extract_owned``'s form.

The kernels are built with nvcc into ``build/kernels/`` under the
repository root at first use (``build()``) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from disn_tpu_torch import kernels

D_OWNED = 7   # owned edge directions a cell
N_SLOTS = 12  # triangles a cell: 6 tets x up to 2


def build() -> Path:
    """Compile csrc/owned_extract.cu (once per source hash) and return the
    library's path; the compiler's report is ``<lib>.log`` beside it."""
    return kernels.nvcc_build("owned_extract")


def bind(path) -> ctypes.CDLL:
    """The library at `path` with its entries' argument types."""
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.owned_extract.argtypes = [vp, ci, vp, vp, ci, vp, ci, ctypes.c_float,
                                  vp, ci, vp, vp, vp, vp, vp, vp]
    lib.owned_extract.restype = ci
    lib.owned_tables_bytes.argtypes = []
    lib.owned_tables_bytes.restype = ci
    lib.owned_scratch_words.argtypes = [ci, ci, ci, ci]
    lib.owned_scratch_words.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def tables() -> bytes:
    """ops/marching's case tables in the kernel's layout (csrc: Tables):
    corners [8,3] (x, y, z), tets [6,4], triangle counts [6,16], owner
    corner | direction << 3 [6,16,2,3], pair_j [7], alias axes [7]; u8.
    Each call passes them to the kernels in their parameters."""
    from disn_tpu_torch.ops import marching

    _, counts = marching._tables()
    _, pair_j, nb_tbl, dir_tbl = marching._owned_tables()
    parts = (marching.CORNERS, marching.TETS, counts, nb_tbl | dir_tbl << 3,
             pair_j, marching._alias_axes())
    return b"".join(np.asarray(p).astype(np.uint8).tobytes() for p in parts)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = bind(build())
    if lib.owned_tables_bytes() != len(tables()):
        raise RuntimeError("owned_extract.cu's Tables are not the wrapper's")
    return lib


def scratch_bytes(R: int, S: int, b: int | None) -> int:
    """Bytes of scratch a call takes at grid R, S slots and b rows (None:
    the dense route)."""
    return 4 * _lib().owned_scratch_words(R, S, b or 0, b is None)


def _check(volume, sdf_params, cell_ids, n_cells, S, blk) -> None:
    """Raise on what the kernels do not take."""
    idx = volume.get_device()
    if idx < 0:
        raise ValueError(f"the owned extractor's kernel takes CUDA tensors, "
                         f"got {volume.device}")
    R = volume.shape[0]
    if (volume.dtype != torch.float32 or volume.dim() != 3
            or tuple(volume.shape) != (R, R, R) or R < 2):
        raise ValueError(f"volume must be [R,R,R] float32 with R >= 2, got "
                         f"{tuple(volume.shape)} {volume.dtype}")
    if R ** 3 + 4 * S >= 2 ** 31 or S * N_SLOTS * 3 >= 2 ** 31:
        raise ValueError(f"R = {R}, S = {S}: past the int32 range")
    if sdf_params.dtype != torch.float32 or sdf_params.shape != (6,):
        raise ValueError(f"sdf_params must be [6] float32, got "
                         f"{tuple(sdf_params.shape)} {sdf_params.dtype}")
    if cell_ids.dtype != torch.int32 or cell_ids.dim() != 1:
        raise ValueError(f"cell_ids must be [n] int32, got "
                         f"{tuple(cell_ids.shape)} {cell_ids.dtype}")
    if not 0 <= S <= cell_ids.shape[0]:
        raise ValueError(f"{S} slots past the {cell_ids.shape[0]} ids")
    tensors = [volume, sdf_params, cell_ids]
    if torch.is_tensor(n_cells):
        if n_cells.dim() != 0 or n_cells.dtype != torch.int32:
            raise TypeError(f"n_cells must be an int or a 0-d int32 tensor, "
                            f"got {n_cells!r}")
        tensors.append(n_cells)
    if blk is not None:
        if (blk.dtype != torch.int32 or blk.dim() != 2
                or blk.shape[1] != 3 or 4 * blk.shape[0] >= 2 ** 31):
            raise ValueError(f"blk must be [b,3] int32 rows, got "
                             f"{tuple(blk.shape)} {blk.dtype}")
        tensors.append(blk)
    for t in tensors:
        if t.get_device() != idx:
            raise ValueError(f"all inputs must be on {volume.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")


def _launch(volume, sdf_params, cell_ids, n_cells, iso, S, blk):
    """One call of the library -> (verts [S*7,3], faces [S*12,3], out [3]
    (nv, ntri, missing)), views of one allocation."""
    lib = _lib()
    dev = volume.device
    R = volume.shape[0]
    b = None if blk is None else blk.shape[0]
    nvw, nfw = S * D_OWNED * 3, S * N_SLOTS * 3
    buf = torch.empty(nvw + nfw + 4, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.owned_scratch_words(R, S, b or 0, b is None),
                          dtype=torch.int32, device=dev)
    verts = buf[:nvw].view(torch.float32).view(S * D_OWNED, 3)
    faces = buf[nvw:nvw + nfw].view(S * N_SLOTS, 3)
    out = buf[nvw + nfw:nvw + nfw + 3]
    on_card = torch.is_tensor(n_cells)
    tbl = tables()
    stream = torch._C._cuda_getCurrentRawStream(volume.get_device())
    err = lib.owned_extract(
        volume.data_ptr(), R, sdf_params.data_ptr(), cell_ids.data_ptr(), S,
        n_cells.data_ptr() if on_card else None,
        0 if on_card else int(n_cells), float(iso),
        None if blk is None else blk.data_ptr(), b or 0, scratch.data_ptr(),
        verts.data_ptr(), faces.data_ptr(), out.data_ptr(), tbl, stream)
    if err != 0:
        raise RuntimeError(f"owned_extract failed: CUDA error {err}")
    extract_owned.launches += 1
    if blk is None:
        extract_owned.dense_calls += 1
    return verts, faces, out


def extract_owned(volume: torch.Tensor, sdf_params: torch.Tensor,
                  cell_ids: torch.Tensor, n_cells, iso: float, S: int,
                  blk: torch.Tensor | None = None):
    """ops/marching._extract_owned_fixed on the card, bit for bit its plain
    version: the first S slots of cell_ids [>= S] int32 (flat over the
    R^3 extended cells), those at or past n_cells (an int, or a 0-d int32
    on the card) dead, the owners looked up through the scan's rows `blk`
    [b,3] int32 when given -> (verts [S*7,3] f32, nv, faces [S*12,3]
    int32, ntri, missing), the counts 0-d int32 on the card, the rows past
    them zero, views of one allocation; nothing read back. `blk` must be
    the rows of the scan that produced cell_ids, and cell_ids a prefix of
    their cells in the scan's order (ops/marching._compact_block_bits):
    only the dtype and shape are checked, and other rows give wrong slots,
    not missing ones."""
    _check(volume, sdf_params, cell_ids, n_cells, S, blk)
    if extract_owned.inputs is not None:
        extract_owned.inputs.append(
            ((volume, sdf_params, cell_ids, n_cells, iso, S), {"blk": blk}))
    verts, faces, out = _launch(volume, sdf_params, cell_ids, n_cells, iso,
                                S, blk)
    return verts, out[0], faces, out[1], out[2]


extract_owned.launches = 0
extract_owned.dense_calls = 0  # calls of either form without rows
extract_owned.inputs = None


def extract_owned_exact(volume: torch.Tensor, sdf_params: torch.Tensor,
                        cell_ids: torch.Tensor, iso: float,
                        blk: torch.Tensor | None = None):
    """ops/marching._extract_owned on the card: extract_owned at S = n =
    len(cell_ids), (nv, ntri, missing) read once -> (verts [nv,3] f32,
    faces [ntri,3] int32), the leading rows. Raises ValueError where a
    triangle's owner is not in the list, as the plain version does. `blk`
    as in extract_owned: the rows of the scan that produced cell_ids."""
    n = cell_ids.shape[0]
    _check(volume, sdf_params, cell_ids, n, n, blk)
    if extract_owned.inputs is not None:
        extract_owned.inputs.append(
            ((volume, sdf_params, cell_ids, n, iso, n), {"blk": blk}))
    verts, faces, out = _launch(volume, sdf_params, cell_ids, n, iso, n, blk)
    nv, ntri, missing = out.tolist()
    if missing:
        raise ValueError("a triangle's edge belongs to a cell that is not "
                         "in the active-cell list")
    return verts[:nv], faces[:ntri]

"""Iso-surface extraction by marching tetrahedra (port of
disn_tpu/ops/marching.py).

Each cube splits into 6 tetrahedra around its main diagonal c0-c6 (Kuhn);
the split is translation-consistent across cube faces, so the mesh is
watertight. Every tet emits 0-2 triangles whose vertices lie on tet edges
at the interpolated iso crossing. The 6x16 case tables are derived at
import, with windings fixed numerically so normals point from inside
(value < iso) to outside.

Three routes share those tables:

* ``marching_tets`` + ``weld`` (the mesh oracle, ``extract_mesh``): an
  unwelded triangle soup built on the volume's device, keyed by the (min,
  max) global ids of each edge's grid points, welded on the host by a sort.
* the owned-edge route (``extract_mesh_owned``, ``extract_mesh_from_ids``):
  Kuhn tets cut only 7 edge directions per cell, all leaving the cell's
  corner 0, so each cell OWNS those 7 edges and every crossing grid edge is
  emitted exactly once. Pass 1 gives each owned crossing edge its vertex in
  slot-major, direction-minor order; pass 2 names each triangle vertex as
  vstart[owner cell] + rank of the edge's direction in the owner's crossing
  mask. The mesh leaves the device welded; no sort runs. Cells on the high
  faces own edges of no real cell: a ghost layer of cells (corner reads
  clamped to the last plane) owns them and emits vertices, never triangles.
  ``_extract_owned_fixed`` is the same extraction at fixed shapes, with
  its counts on the card (the speculative volume flow's).
* the record route (``extract_mesh_records``): the device emits per active
  cell its inside mask, crossing mask and quantised edge parameters; the
  host rebuilds the same mesh from them (``disn_tpu_torch.native``, C++;
  ``assemble_mesh_np`` and its helpers are the numpy versions the C++
  passes are held against).

The active cells come from a scan of the volume: ``_active_cells_ext``
over the whole extended grid, or ``_active_cells_from_coarse`` over the 4^3
blocks of the sparse pass's active coarse cells. Both emit the same order:
block ascending, then the cell's bit l = (z*4 + y)*4 + x inside its block.
Three of the functions they and the owned route run are hand-written
kernels on the card and plain PyTorch on the CPU, chosen by the tensors'
device: the scan (``_candidate_scan``: ``ops/change_scan``,
``csrc/change_scan.cu``; ``_candidate_scan_plain``), its compaction
(``_compact_block_bits``: ``ops/block_compact``, ``csrc/block_compact.cu``;
``_compact_block_bits_plain``) and the owned extractor
(``_extract_owned_fixed`` and ``_extract_owned``: ``ops/owned_extract``,
``csrc/owned_extract.cu``; ``_extract_owned_fixed_plain``,
``_extract_owned_plain``).
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.ops import block_compact, change_scan, owned_extract

# Cube corner offsets (x, y, z), indexed 0..7.
CORNERS = np.array([
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
], dtype=np.int64)

# Kuhn decomposition: 6 tets around the main diagonal c0-c6.
TETS = np.array([
    (0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
    (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6),
], dtype=np.int64)

_N_SLOTS = 12  # 6 tets x up to 2 triangles
_CELL_BATCH = 65536  # surface cells per step (bounds the [M,12,3,3] soup)
BLOCK = 4  # edge of a scan block, in cells: 64 cells, one 64-bit mask
_FACE_BATCH = 1 << 20  # cells per step of the owned route's triangle pass


@functools.lru_cache(maxsize=1)
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """Derive ([6,16,2,3,2] edge tables, [6,16] tri counts). Edge entries
    are (cube_corner_i, cube_corner_j) pairs, -1 padded."""
    edges = np.full((6, 16, 2, 3, 2), -1, dtype=np.int64)
    counts = np.zeros((6, 16), dtype=np.int64)
    corners_f = CORNERS.astype(np.float64)

    for t, tet in enumerate(TETS):
        pos = corners_f[tet]
        for case in range(1, 15):
            inside = [i for i in range(4) if case & (1 << i)]
            outside = [i for i in range(4) if not case & (1 << i)]
            if len(inside) == 1:
                i = inside[0]
                tris = [[(i, outside[0]), (i, outside[1]), (i, outside[2])]]
            elif len(inside) == 3:
                o = outside[0]
                tris = [[(inside[0], o), (inside[1], o), (inside[2], o)]]
            else:  # 2 inside -> quad -> 2 triangles
                i0, i1 = inside
                o0, o1 = outside
                tris = [[(i0, o0), (i0, o1), (i1, o1)],
                        [(i0, o0), (i1, o1), (i1, o0)]]
            out_dir = pos[outside].mean(axis=0) - pos[inside].mean(axis=0)
            for k, tri in enumerate(tris):
                pts = np.array([(pos[a] + pos[b]) / 2.0 for a, b in tri])
                n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
                if np.dot(n, out_dir) < 0:
                    tri = [tri[0], tri[2], tri[1]]
                for v, (a, b) in enumerate(tri):
                    edges[t, case, k, v] = (tet[a], tet[b])
            counts[t, case] = len(tris)
    return edges, counts


def _cell_triangles(corner_vals: torch.Tensor, corner_pos: torch.Tensor,
                    corner_gid: torch.Tensor, iso: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vectorized over M cells: corner_vals [M,8], corner_pos [M,8,3],
    corner_gid [M,8] -> (tri_pos [M,12,3,3], tri_keys [M,12,3,2] int64,
    valid [M,12])."""
    dev = corner_vals.device
    edges_tbl, counts_tbl = _tables()
    edges_t = torch.from_numpy(edges_tbl).to(dev)
    counts_t = torch.from_numpy(counts_tbl).to(dev)
    tets = torch.from_numpy(TETS).to(dev)
    m = corner_vals.shape[0]

    inside = (corner_vals < iso).long()                    # [M,8]
    bits = torch.tensor([1, 2, 4, 8], device=dev)
    case = (inside[:, tets] * bits).sum(-1)                # [M,6]
    tet_i = torch.arange(6, device=dev)[None, :]
    tri_edges = edges_t[tet_i, case]                       # [M,6,2,3,2]
    n_tris = counts_t[tet_i, case]                         # [M,6]
    slot = torch.arange(2, device=dev)
    valid = slot[None, None, :] < n_tris[..., None]        # [M,6,2]

    ci = tri_edges[..., 0].clamp(min=0).reshape(m, -1)     # [M,36]
    cj = tri_edges[..., 1].clamp(min=0).reshape(m, -1)
    shape = (m, 6, 2, 3)
    vi = torch.gather(corner_vals, 1, ci).reshape(shape)
    vj = torch.gather(corner_vals, 1, cj).reshape(shape)
    pi = torch.gather(corner_pos, 1, ci[..., None].expand(-1, -1, 3)
                      ).reshape(shape + (3,))
    pj = torch.gather(corner_pos, 1, cj[..., None].expand(-1, -1, 3)
                      ).reshape(shape + (3,))
    gi = torch.gather(corner_gid, 1, ci).reshape(shape)
    gj = torch.gather(corner_gid, 1, cj).reshape(shape)

    denom = vj - vi
    t = torch.where(denom.abs() > 1e-12, (iso - vi) / denom,
                    torch.full_like(vi, 0.5))
    t = t.clamp(0.0, 1.0)[..., None]
    pts = pi + t * (pj - pi)

    keys = torch.stack([torch.minimum(gi, gj), torch.maximum(gi, gj)], -1)
    return (pts.reshape(m, _N_SLOTS, 3, 3), keys.reshape(m, _N_SLOTS, 3, 2),
            valid.reshape(m, _N_SLOTS))


def _active_cells(volume: torch.Tensor, iso: float) -> torch.Tensor:
    """Flat ids (ascending) of cells whose 8 corners straddle the iso."""
    c = volume.shape[0] - 1
    inside = volume < iso
    corners = torch.stack([inside[dz:dz + c, dy:dy + c, dx:dx + c]
                           for dz in (0, 1) for dy in (0, 1)
                           for dx in (0, 1)])
    change = corners.any(0) & ~corners.all(0)
    return torch.nonzero(change.reshape(-1))[:, 0]


def _cell_corner_data(volume: torch.Tensor, cell_ids: torch.Tensor,
                      sdf_params: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Corner (values [B,8], positions [B,8,3], gids [B,8]) for flat cell
    ids over the (R-1)^3 cell grid of a [R,R,R] (z,y,x) volume."""
    R = volume.shape[0]
    c = R - 1
    cz = cell_ids // (c * c)
    cy = (cell_ids // c) % c
    cx = cell_ids % c
    offs = torch.from_numpy(CORNERS).to(volume.device)
    gx = cx[:, None] + offs[None, :, 0]
    gy = cy[:, None] + offs[None, :, 1]
    gz = cz[:, None] + offs[None, :, 2]
    gid = (gz * R + gy) * R + gx
    vals = volume.reshape(-1)[gid]
    pos = _world(torch.stack([gx, gy, gz], dim=-1), R, sdf_params)
    return vals, pos, gid


def _world(g: torch.Tensor, R: int, sdf_params: torch.Tensor) -> torch.Tensor:
    """[..., 3] integer grid coordinates (x, y, z) of a [R,R,R] grid -> f32
    world positions lo + g / (R - 1) * (hi - lo). The divide is an IEEE
    divide by a scalar tensor on g's device: on CUDA, dividing by a Python
    float multiplies by its reciprocal instead, an ulp off wherever R - 1
    is not a power of two."""
    sp = sdf_params.float()
    lo, span = sp[0:3], sp[3:6] - sp[0:3]
    denom = torch.full((), float(R - 1), dtype=torch.float32,
                       device=g.device)
    return lo + g.float() / denom * span


def marching_tets(volume: torch.Tensor, sdf_params: torch.Tensor,
                  iso: float = 0.0
                  ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Triangles of the iso-surface of a [R,R,R] (z,y,x) volume, on its
    device: (tri_pos [T,3,3] f32, tri_keys [T,3,2] int64, T), ordered by
    cell id then slot."""
    volume = volume.float()
    sdf_params = torch.as_tensor(sdf_params, dtype=torch.float32,
                                 device=volume.device)
    cell_ids = _active_cells(volume, iso)
    pos_parts, key_parts = [], []
    for i in range(0, cell_ids.shape[0], _CELL_BATCH):
        vals, pos, gid = _cell_corner_data(
            volume, cell_ids[i:i + _CELL_BATCH], sdf_params)
        tri_pos, tri_keys, valid = _cell_triangles(vals, pos, gid, iso)
        pos_parts.append(tri_pos[valid])
        key_parts.append(tri_keys[valid])
    if not pos_parts:
        return (torch.zeros(0, 3, 3, device=volume.device),
                torch.zeros(0, 3, 2, dtype=torch.long, device=volume.device),
                0)
    tri_pos = torch.cat(pos_parts)
    return tri_pos, torch.cat(key_parts), int(tri_pos.shape[0])


def weld(tri_pos: np.ndarray, tri_keys: np.ndarray, count: int
         ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side exact vertex welding via canonical grid-edge keys ->
    (vertices [V,3] f32, faces [F,3] i32). Degenerate triangles (a repeated
    welded vertex: tet faces lying exactly on the iso) are dropped."""
    tri_pos = np.asarray(tri_pos[:count]).reshape(-1, 3)
    keys = np.asarray(tri_keys[:count]).reshape(-1, 2)
    flat = keys[:, 0].astype(np.int64) << 32 | keys[:, 1].astype(np.int64)
    order = np.argsort(flat, kind="stable")
    s = flat[order]
    first = np.empty(len(s), bool)
    if len(s):
        first[0] = True
        np.not_equal(s[1:], s[:-1], out=first[1:])
    uid = np.cumsum(first) - 1
    inv = np.empty(len(s), np.int64)
    inv[order] = uid
    n_unique = int(uid[-1]) + 1 if len(s) else 0
    verts = np.zeros((n_unique, 3), np.float32)
    verts[inv] = tri_pos  # positions per key are identical
    faces = inv.reshape(-1, 3).astype(np.int32)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok]


def extract_mesh(volume: torch.Tensor, sdf_params, iso: float = 0.0
                 ) -> tuple[np.ndarray, np.ndarray]:
    """volume [R,R,R] (z,y,x) -> welded numpy (vertices, faces)."""
    tri_pos, tri_keys, count = marching_tets(volume, sdf_params, iso=iso)
    return weld(tri_pos.cpu().numpy(), tri_keys.cpu().numpy(), count)


def weld_device(tri_pos: torch.Tensor, tri_keys: torch.Tensor, count: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``weld`` on the triangles' device (port of weld_device): (vertices
    [V,3] f32, faces [F,3] int32) there, equal to the host weld's bit for
    bit. The (min, max) edge keys become one int64 key, a stable sort
    orders them, a cumsum over the key changes names the vertices, and a
    scatter sends every corner its name. Where several corners share a key
    the vertex takes the last one's position in triangle order, as the
    host weld's assignment does (the JAX package sorts the two int32 halves
    in two stable passes: TPUs have no int64 by default)."""
    dev = tri_pos.device
    pos = tri_pos[:count].reshape(-1, 3)
    keys = tri_keys[:count].reshape(-1, 2).long()
    flat = keys[:, 0] << 32 | keys[:, 1]
    s, order = torch.sort(flat, stable=True)
    change = s[1:] != s[:-1]
    first = torch.cat([torch.ones(min(1, len(s)), dtype=torch.bool,
                                  device=dev), change])
    last = torch.cat([change, torch.ones(min(1, len(s)), dtype=torch.bool,
                                         device=dev)])
    uid = torch.cumsum(first.long(), 0) - 1
    inv = torch.empty_like(uid)
    inv[order] = uid
    verts = pos[order[last]]
    faces = inv.reshape(-1, 3).int()
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return verts, faces[ok]


def extract_mesh_device_sorted(volume, sdf_params, iso: float = 0.0,
                               device: str | torch.device | None = None
                               ) -> tuple[np.ndarray, np.ndarray]:
    """marching_tets + weld_device on the volume's device (the card unless
    `device` says otherwise), then one copy -> welded numpy (verts,
    faces): the JAX package's independent implementation for equivalence
    tests. Its triangle cap has no counterpart: marching_tets has none."""
    vol, sdfp = _on_device(volume, sdf_params, device)
    tri_pos, tri_keys, count = marching_tets(vol, sdfp, iso=iso)
    verts, faces = weld_device(tri_pos, tri_keys, count)
    return verts.cpu().numpy(), faces.cpu().numpy()


# ---------------------------------------------------------------------------
# Owned-edge tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _owned_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Derive (pair_i [D], pair_j [D], nb_tbl [6,16,2,3], dir_tbl [6,16,2,3]).

    pair_i/pair_j: corner ids of the canonical owned-edge directions
    (min(offset_i, offset_j) == 0 elementwise), sorted; D == 7 for Kuhn
    tets, and every pair_i is corner 0.
    nb_tbl: per table triangle vertex, the corner id of the owner-cell offset
    (elementwise min of the two edge-corner offsets).
    dir_tbl: the canonical direction index of that edge within its owner."""
    edges, _counts = _tables()
    cid = {tuple(c): i for i, c in enumerate(CORNERS.tolist())}

    def owner_and_pair(a, b):
        oa, ob = CORNERS[a], CORNERS[b]
        m = np.minimum(oa, ob)
        pa, pb = cid[tuple(oa - m)], cid[tuple(ob - m)]
        return cid[tuple(m)], (min(pa, pb), max(pa, pb))

    used = [(idx, owner_and_pair(*edges[idx]))
            for idx in np.ndindex(6, 16, 2, 3) if edges[idx][0] >= 0]
    pairs = sorted({pair for _, (_, pair) in used})
    pidx = {p: i for i, p in enumerate(pairs)}
    nb_tbl = np.zeros((6, 16, 2, 3), np.int32)
    dir_tbl = np.zeros((6, 16, 2, 3), np.int32)
    for idx, (owner, pair) in used:
        nb_tbl[idx] = owner
        dir_tbl[idx] = pidx[pair]
    pair_i = np.array([p[0] for p in pairs], np.int32)
    pair_j = np.array([p[1] for p in pairs], np.int32)
    if len(pairs) != 7 or pair_i.any():
        raise AssertionError(f"owned edges must be 7, all from corner 0: "
                             f"{pairs}")
    return pair_i, pair_j, nb_tbl, dir_tbl


D_OWNED = 7  # owned edge directions per cell (checked by _owned_tables)


def _alias_axes() -> np.ndarray:
    """[D] bitmask (x=1, y=2, z=4) of the axes an owned edge extends along.
    In a ghost cell (coordinate R-1 on an axis) such an edge collapses under
    the clamp onto a lower direction's grid edge, and is suppressed."""
    pair_i, pair_j, _, _ = _owned_tables()
    bad = (CORNERS[pair_i] | CORNERS[pair_j]) > 0              # [D,3] (xyz)
    return (bad << np.arange(3)[None, :]).sum(1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_tables(dev: torch.device) -> dict[str, torch.Tensor]:
    """The case tables as int64 tensors on `dev` (made once per device)."""
    _, counts = _tables()
    _, pair_j, nb_tbl, dir_tbl = _owned_tables()
    tbl = dict(corners=CORNERS, tets=TETS, counts=counts, pair_j=pair_j,
               nb=nb_tbl, dir=dir_tbl, alias=_alias_axes(),
               pop7=[bin(i).count("1") for i in range(1 << D_OWNED)],
               pop8=[bin(i).count("1") for i in range(256)])
    return {k: torch.as_tensor(np.asarray(v, np.int64)).to(dev)
            for k, v in tbl.items()}


def _tq_bits(R: int) -> int:
    """Width of a record's quantised edge parameter: u8 once a cell is at
    most 1/128 of the box (a vertex then moves by at most cell/510), u16 on
    smaller grids, where it keeps the record route tight to the exact one."""
    return 8 if R - 1 >= 128 else 16


# ---------------------------------------------------------------------------
# K2: the scans for cells whose corner signs disagree
# ---------------------------------------------------------------------------

def _sign_change_cells(volume: torch.Tensor, iso: float) -> torch.Tensor:
    """[R,R,R] field -> [E,E,E] bool over the extended cell grid (E = R):
    the cell's 8 corner signs disagree. The high ghost layer reads the last
    plane again, so ghost cells change only within the faces they own."""
    inside = volume < iso
    for ax in range(3):
        inside = torch.cat(
            [inside, inside.narrow(ax, inside.shape[ax] - 1, 1)], ax)
    any_, all_ = inside, inside
    for ax in (2, 1, 0):
        n = any_.shape[ax] - 1
        any_ = any_.narrow(ax, 0, n) | any_.narrow(ax, 1, n)
        all_ = all_.narrow(ax, 0, n) & all_.narrow(ax, 1, n)
    return any_ & ~all_


def _block_bits(change: torch.Tensor) -> torch.Tensor:
    """[E,E,E] bool -> [B3^3] int64 (B3 = ceil(E/4)): each 4^3 block's 64
    change bits, bit l = (z*4 + y)*4 + x of the cell inside its block,
    blocks in (z, y, x) order. Packed by shifts along x (a nibble), y (16
    bits) and z (64)."""
    E = change.shape[0]
    B3 = -(-E // BLOCK)
    Ep = B3 * BLOCK
    ch = torch.zeros((Ep, Ep, Ep), dtype=torch.uint8, device=change.device)
    ch[:E, :E, :E] = change
    x = ch.view(Ep, Ep, B3, BLOCK)
    x = x[..., 0] | (x[..., 1] << 1) | (x[..., 2] << 2) | (x[..., 3] << 3)
    y = x.view(Ep, B3, BLOCK, B3).to(torch.int32)               # [z,by,ly,bx]
    y = (y[:, :, 0] | (y[:, :, 1] << 4) | (y[:, :, 2] << 8)
         | (y[:, :, 3] << 12))
    z = y.view(B3, BLOCK, B3, B3).to(torch.int64)               # [bz,lz,by,bx]
    z = z[:, 0] | (z[:, 1] << 16) | (z[:, 2] << 32) | (z[:, 3] << 48)
    return z.reshape(-1)


def _candidate_scan(volume: torch.Tensor, iso: float,
                    coarse_ids: torch.Tensor | None = None,
                    count: torch.Tensor | None = None):
    """The scan both volume-flow scans start with: on a CUDA tensor the
    kernel (change_scan.change_scan), on a CPU tensor
    _candidate_scan_plain, which says what it computes; the two agree bit
    for bit."""
    if volume.device.type == "cpu":
        return _candidate_scan_plain(volume, iso, coarse_ids, count)
    return change_scan.change_scan(volume, iso, coarse_ids, count)


def _candidate_scan_plain(volume: torch.Tensor, iso: float,
                          coarse_ids: torch.Tensor | None = None,
                          count: torch.Tensor | None = None):
    """[R,R,R] field -> (bits [B3^3, 2] int32: each 4^3 block's change
    bits as (lo, hi) (_block_bits of _sign_change_cells; B3 = ceil(R/4)),
    cand [B3^3] bool, counts [3] int32: total (the change cells), inside
    (the change bits in candidate blocks) and outside (the rest)).

    The candidates: with coarse_ids [n] (cells of the (B3 - 1)^3 coarse
    grid, stride 4), those cells, the first `count` of them when a 0-d
    count is given, the ghost blocks taking their low neighbour's flag;
    without, every block (the full scan)."""
    change = _sign_change_cells(volume, iso)
    # an int64 mask read as two int32 words is (lo, hi): little-endian, as
    # every platform of PyTorch is
    bits = _block_bits(change).view(torch.int32).view(-1, 2)
    dev = volume.device
    total = change.sum()
    if coarse_ids is None:
        cand = torch.ones(bits.shape[0], dtype=torch.bool, device=dev)
        inside = total
    else:
        cgrid = (volume.shape[0] - 1) // BLOCK
        fixed = count is not None
        act = torch.zeros(cgrid ** 3 + int(fixed), dtype=torch.bool,
                          device=dev)
        if fixed:  # the padding slots set the extra last flag, dropped
            live = torch.arange(coarse_ids.shape[0], device=dev) < count
            act.scatter_(0, torch.where(live, coarse_ids.long(), cgrid ** 3),
                         True)
            act = act[:cgrid ** 3]
        else:
            act[coarse_ids.long()] = True
        cand = act.view(cgrid, cgrid, cgrid)
        for ax in range(3):  # the ghost blocks take their low neighbour's
            cand = torch.cat([cand, cand.narrow(ax, cgrid - 1, 1)], ax)
        cand = cand.reshape(-1)
        pop8 = _device_tables(dev)["pop8"]  # a block's bits, byte by byte
        inside = (pop8[bits.view(torch.uint8).long()].sum(1) * cand).sum()
    return bits, cand, torch.stack([total, inside, total - inside]).int()


def _active_cells_ext(volume: torch.Tensor, iso: float
                      ) -> tuple[torch.Tensor, int]:
    """Sign-change scan of the whole extended cell grid -> (cell ids [n]
    int32 flat over E^3, n)."""
    return _active_cells_ext_rows(volume, iso)[:2]


def _active_cells_ext_rows(volume: torch.Tensor, iso: float
                           ) -> tuple[torch.Tensor, int, torch.Tensor]:
    """_active_cells_ext with the scan's rows -> (ids, n, blk [b,3] int32:
    block id, mask lo, mask hi), which the owned extractor looks its
    owners up through."""
    bits, every, _ = _candidate_scan(volume.contiguous(), iso)
    return _compact_block_bits(bits, every, volume.shape[0])


def _active_cells_from_coarse(volume: torch.Tensor, coarse_ids: torch.Tensor,
                              iso: float, stride: int = BLOCK,
                              count: torch.Tensor | None = None,
                              bcap: int | None = None):
    """Fine sign-change cells inside the sparse pass's ACTIVE coarse cells
    (and the ghost blocks clamped onto them) -> (ids [n] int32, n, guard,
    blk [b,3] int32 rows (block id, mask lo, mask hi)).

    Sound on a volume the sparse pass assembled: an inactive coarse cell has
    corners of one sign and sign-keeping interpolation inside, so every fine
    change lies in an active coarse cell or a ghost block beside one. The
    guard counts change cells OUTSIDE the candidate blocks; when it is not
    0 the premise failed and the caller must run _active_cells_ext. The id
    sequence equals _active_cells_ext's when the guard is 0: the blocks are
    the same, only blocks without a change are skipped. The masks are held
    as int32 bit patterns; the host reads them as uint32.

    With `count` and `bcap` the shapes are fixed and nothing waits for the
    card (port of disn_tpu/ops/marching.py _active_cells_from_coarse with
    coarse_count and bcap): coarse_ids is phase_a's padded list, `count`
    its 0-d count, and the compaction runs capped at bcap
    (_compact_block_bits). Returns (ids [b2*64] int32, n, guard, gov, blk
    [b2,3]), all on the card: guard as above, gov the JAX function's
    overflow (the blocks past b2, plus the change cells the kept blocks
    leave out), so that gov is 0 exactly when ids[:n] is the exact scan's
    list."""
    if stride != BLOCK:
        raise ValueError(f"the candidate scan's blocks are {BLOCK}^3 cells; "
                         f"got stride {stride}")
    R = volume.shape[0]
    if count is not None and count.dtype != torch.int32:
        count = count.int()
    bits, cand, counts = _candidate_scan(
        volume.contiguous(), iso, coarse_ids.int().contiguous(), count)
    if count is None:
        ids, n_cells, blk = _compact_block_bits(bits, cand, R)
        return ids, n_cells, int(counts[0]) - n_cells, blk
    # the compaction adds the change cells to its g_over: gov = its blocks
    # past b2 + (total - n)
    ids, n_cells, g_total, blk = _compact_block_bits(
        bits, cand, R, bcap=bcap, guard=counts[0])
    return ids, n_cells, counts[2], g_total - n_cells, blk


_b2cap = block_compact.b2cap  # the capped compaction's rows for a cap


def _compact_block_bits(bits: torch.Tensor, cand: torch.Tensor, E: int,
                        srow_tbl: torch.Tensor | None = None,
                        bcap: int | None = None,
                        guard: torch.Tensor | None = None):
    """The compaction both flows end their scan in: on CUDA tensors the
    kernel (block_compact.compact_block_bits), on CPU tensors
    _compact_block_bits_plain, which says what it computes; the two agree
    bit for bit."""
    if bits.device.type == "cpu":
        return _compact_block_bits_plain(bits, cand, E, srow_tbl, bcap,
                                         guard)
    return block_compact.compact_block_bits(bits, cand, E, srow_tbl, bcap,
                                            guard)


def _compact_block_bits_plain(bits: torch.Tensor, cand: torch.Tensor,
                              E: int, srow_tbl: torch.Tensor | None = None,
                              bcap: int | None = None,
                              guard: torch.Tensor | None = None):
    """The tail both flows share (port of disn_tpu/ops/marching.py
    _compact_block_bits): the candidate blocks that hold a change bit, in
    block order, and their cells in bit order -> (ids [n] int32, n, blk
    [b,3] int32 rows (block id, mask lo, mask hi)).

    bits [B3^3, 2] int32: each block's 64 change bits as (lo, hi); cand
    [B3^3] bool. Without `srow_tbl` the ids are flat cell ids over E^3.
    With it (the sparse-words flow: [c^3] coarse cell -> its row slot in
    the words arrays) they are sparse row ids slot*64 + bit, which address
    the words arrays; the blk rows are the same in both flows, and the host
    rebuilds the cell ids from them.

    With `bcap` the shapes are fixed and nothing waits for the card: the
    first b2 = _b2cap(bcap) blocks are kept, and the result is (ids
    [b2*64] int32 padded with 0, n int32 0-d, g_over int32 0-d, blk [b2,3]
    with zero rows (block 0, masks 0) past the block count); g_over is the
    blocks past b2 plus `guard` (a 0-d tensor, or 0). Where g_over holds
    no overflow, ids[:n], n and the rows with a mask equal the uncapped
    call's."""
    bits = bits.contiguous()
    words = bits.view(torch.int64).reshape(-1)
    B3 = -(-E // BLOCK)
    dev = bits.device
    bit = torch.arange(BLOCK ** 3, device=dev)
    sel = cand & (words != 0)
    if bcap is None:
        bids = torch.nonzero(sel)[:, 0]
        rbits = bits[bids]
    else:
        b2 = _b2cap(bcap)
        bcs = torch.cumsum(sel.int(), 0, dtype=torch.int32)
        b_count = bcs[-1]
        slot = torch.where(sel & (bcs <= b2), bcs - 1, b2).long()
        bids = torch.zeros(b2 + 1, dtype=torch.int64, device=dev).scatter_(
            0, slot, torch.arange(B3 ** 3, device=dev))[:b2]
        live = torch.arange(b2, device=dev) < b_count
        rbits = bits[bids] * live[:, None]
    blk = torch.cat([bids.int()[:, None], rbits], dim=1)
    rwords = rbits.contiguous().view(torch.int64).reshape(-1)
    bz, by, bx = bids // (B3 * B3), (bids // B3) % B3, bids % B3
    if srow_tbl is None:
        base = ((bz * BLOCK) * E + by * BLOCK) * E + bx * BLOCK
        loff = ((bit // BLOCK ** 2) * E + (bit // BLOCK) % BLOCK) * E \
            + bit % BLOCK
    else:
        # a ghost block (coordinate c) never holds a bit in this flow: its
        # boundary-touching active cell trips the guard first
        c = B3 - 1
        cid = (bz.clamp(max=c - 1) * c + by.clamp(max=c - 1)) * c \
            + bx.clamp(max=c - 1)
        base = srow_tbl.long()[cid].clamp(min=0) * BLOCK ** 3
        loff = bit
    flags = (rwords[:, None] >> bit[None, :]) & 1
    if bcap is None:
        bi, li = torch.nonzero(flags, as_tuple=True)  # row-major: the order
        ids = (base[bi] + loff[li]).int()
        return ids, int(ids.shape[0]), blk
    flat = flags.reshape(-1)                           # row-major: the order
    cs = torch.cumsum(flat, 0)
    cap = flat.shape[0]
    eid = (base[:, None] + loff[None, :]).reshape(-1)
    ids = torch.zeros(cap + 1, dtype=torch.int64, device=dev).scatter_(
        0, torch.where(flat > 0, cs - 1, cap), eid)[:cap].int()
    g_over = (b_count - b2).clamp(min=0)
    if guard is not None:
        g_over = g_over + guard
    return ids, cs[-1].int(), g_over.int(), blk


# ---------------------------------------------------------------------------
# Per-slot data shared by the device extractor and the record emitter
# ---------------------------------------------------------------------------

def _cell_xyz(ids: torch.Tensor, E: int) -> torch.Tensor:
    """Flat ids over E^3 -> [n,3] int64 cell coordinates (x, y, z)."""
    ids = ids.long()
    return torch.stack([ids % E, (ids // E) % E, ids // (E * E)], dim=-1)


def _slot_data(volume: torch.Tensor, cell_ids: torch.Tensor, iso: float
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """For each active-cell slot: (cell xyz [n,3], corner values [n,8] with
    reads clamped to the last plane, inside [n,8] bool, cross [n,D] bool:
    the owned edges that cross the iso, alias-suppressed in ghost cells)."""
    tb = _device_tables(volume.device)
    R = volume.shape[0]
    c = _cell_xyz(cell_ids, R)
    g = torch.clamp(c[:, None, :] + tb["corners"][None], max=R - 1)
    vals = volume.reshape(-1)[(g[..., 2] * R + g[..., 1]) * R + g[..., 0]]
    inside = vals < iso
    ghost = ((c == R - 1).long() << torch.arange(3, device=c.device)).sum(1)
    aliased = (ghost[:, None] & tb["alias"][None, :]) != 0
    cross = (inside[:, :1] != inside[:, tb["pair_j"]]) & ~aliased
    return c, vals, inside, cross


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 in x, byte by byte."""
    pop8 = _device_tables(x.device)["pop8"]
    return sum(pop8[(x >> (8 * k)) & 0xFF] for k in range(8))


def _dense_owner(cell_ids: torch.Tensor, live: torch.Tensor, R: int):
    """The owner look-up through a dense [R^3] table of the live slots ->
    a function from cell coordinates [..., 3] int64 (x, y, z), each in
    [0, R), to their slots [...] int64, -1 where the cell is not a live
    slot."""
    dev = cell_ids.device
    owner = torch.full((R ** 3 + 1,), -1, dtype=torch.int32, device=dev)
    owner.scatter_(0, torch.where(live, cell_ids.long(), R ** 3),
                   torch.arange(cell_ids.shape[0], dtype=torch.int32,
                                device=dev))
    owner = owner[:R ** 3]
    return lambda xyz: owner[(xyz[..., 2] * R + xyz[..., 1]) * R
                             + xyz[..., 0]].long()


def _block_owner(blk: torch.Tensor, R: int, live):
    """The owner look-up through the scan's rows blk [b,3] int32 (block
    id, mask lo, mask hi; csrc/owned_extract.cu's rows route) -> a function
    from cell coordinates [..., 3] int64 (x, y, z), each in [0, R), to
    their slots [...] int64. A cell in block B (of the B3 = ceil(R/4) 4^3
    blocks an axis) at bit k has the slot first[r] + popcount(mask_r below
    k), r the row of B and first the exclusive prefix of the rows'
    popcounts; -1 where B is not a row with a mask, its bit is not set, or
    the slot is at or past `live` (an int or a 0-d tensor)."""
    dev = blk.device
    B3 = -(-R // BLOCK)
    rows = blk.long()
    mask = (rows[:, 1] & 0xFFFFFFFF) | (rows[:, 2] << 32)
    pop = _popcount64(mask)
    first = torch.cumsum(pop, 0) - pop
    bid = rows[:, 0]
    keep = (mask != 0) & (bid >= 0) & (bid < B3 ** 3)
    table = torch.full((B3 ** 3 + 1,), -1, dtype=torch.int64, device=dev)
    table.scatter_(0, torch.where(keep, bid, B3 ** 3),
                   torch.arange(rows.shape[0], device=dev))
    table = table[:B3 ** 3]
    mask = torch.cat([mask, mask.new_zeros(1)])    # row -1: no bit set
    first = torch.cat([first, first.new_zeros(1)])

    def lookup(xyz: torch.Tensor) -> torch.Tensor:
        b = (((xyz[..., 2] >> 2) * B3 + (xyz[..., 1] >> 2)) * B3
             + (xyz[..., 0] >> 2))
        bit = ((xyz[..., 2] & 3) * 4 + (xyz[..., 1] & 3)) * 4 + (xyz[..., 0]
                                                                 & 3)
        m = mask[table[b]]
        slot = first[table[b]] + _popcount64(m & ((torch.ones_like(bit)
                                                   << bit) - 1))
        hit = (((m >> bit) & 1) != 0) & (slot < live)
        return torch.where(hit, slot, -1)

    return lookup


def _edge_t(v0: torch.Tensor, vj: torch.Tensor, iso: float) -> torch.Tensor:
    """Where the iso cuts the edge from v0 to vj, as a fraction in [0, 1];
    0.5 on an edge whose ends are equal."""
    dv = vj - v0
    t = torch.where(dv.abs() > 1e-12, (iso - v0) / dv,
                    torch.full_like(dv, 0.5))
    return t.clamp(0.0, 1.0)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[n,k] bool -> [n] int64, bit i = column i."""
    w = 1 << torch.arange(bits.shape[1], device=bits.device)
    return (bits.long() * w).sum(1)


# ---------------------------------------------------------------------------
# The device extractor
# ---------------------------------------------------------------------------

def _owned_faces(c: torch.Tensor, imask: torch.Tensor, owner,
                 cmask: torch.Tensor, vstart: torch.Tensor, R: int
                 ) -> torch.Tensor:
    """Triangles of the cells `c` [m,3] with inside masks `imask` [m] ->
    [T,3] int64 welded vertex indices, ordered by slot, tet, triangle.
    `owner` (_dense_owner, _block_owner) maps a cell's coordinates to its
    slot in `cmask`/`vstart`."""
    tb = _device_tables(c.device)
    case = (((imask[:, None, None] >> tb["tets"][None]) & 1)
            << torch.arange(4, device=c.device)).sum(-1)          # [m,6]
    tet = torch.arange(6, device=c.device)
    n_tris = tb["counts"][tet[None, :], case]
    real = (c <= R - 2).all(1)                 # ghost cells emit no triangle
    valid = ((torch.arange(2, device=c.device) < n_tris[..., None])
             & real[:, None, None])                                # [m,6,2]
    sc, st, sk = torch.nonzero(valid, as_tuple=True)
    cs = case[sc, st]
    nb_v, dr_v = tb["nb"][st, cs, sk], tb["dir"][st, cs, sk]       # [T,3]
    slot = owner(c[sc][:, None, :] + tb["corners"][nb_v])           # [T,3]
    if bool((slot < 0).any()):
        raise ValueError("a triangle's edge belongs to a cell that is not "
                         "in the active-cell list")
    rank = tb["pop7"][cmask[slot] & ((1 << dr_v) - 1)]
    return vstart[slot] + rank


def _owned_pass1(volume: torch.Tensor, sdf_params: torch.Tensor,
                 cell_ids: torch.Tensor, iso: float):
    """One vertex per owned crossing edge, slot-major then direction ->
    (verts [nv,3] f32, cell xyz [n,3], inside masks [n], crossing masks
    [n])."""
    tb = _device_tables(volume.device)
    R = volume.shape[0]
    c, vals, inside, cross = _slot_data(volume, cell_ids, iso)
    slot, d = torch.nonzero(cross, as_tuple=True)   # row-major: the order
    pj = tb["pair_j"][d]
    t = _edge_t(vals[slot, 0], vals[slot, pj], iso)[:, None]
    gi = c[slot]
    gj = torch.clamp(gi + tb["corners"][pj], max=R - 1)
    pi_, pj_ = _world(gi, R, sdf_params), _world(gj, R, sdf_params)
    return pi_ + t * (pj_ - pi_), c, _pack_bits(inside), _pack_bits(cross)


def _owned_pass2(c: torch.Tensor, imask: torch.Tensor, cmask: torch.Tensor,
                 cell_ids: torch.Tensor, R: int,
                 blk: torch.Tensor | None = None) -> torch.Tensor:
    """Faces [ntri,3] int32: a triangle's vertex is its owner cell's first
    vertex plus the rank of the edge's direction among the owner's crossing
    directions. The owner's slot comes from the scan's rows `blk` when
    given (_block_owner), else from a dense [E^3] table (_dense_owner)."""
    dev = c.device
    n = c.shape[0]
    counts = _device_tables(dev)["pop7"][cmask]
    vstart = torch.cumsum(counts, 0) - counts
    owner = (_dense_owner(cell_ids, torch.ones(n, dtype=torch.bool,
                                               device=dev), R)
             if blk is None else _block_owner(blk, R, n))
    faces = [_owned_faces(c[i:i + _FACE_BATCH], imask[i:i + _FACE_BATCH],
                          owner, cmask, vstart, R)
             for i in range(0, n, _FACE_BATCH)]
    return torch.cat(faces).int()


def _rows_arg(blk: torch.Tensor | None) -> torch.Tensor | None:
    """The scan's rows as the kernel takes them (contiguous int32)."""
    return None if blk is None else blk.int().contiguous()


def _extract_owned(volume: torch.Tensor, sdf_params: torch.Tensor,
                   cell_ids: torch.Tensor, iso: float,
                   blk: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-pass owned-edge extraction over exactly the cells `cell_ids`
    (scan order) -> (verts [nv,3] f32, faces [ntri,3] int32) on the
    volume's device: welded, outward-wound. `blk`, the rows of the scan
    that listed cell_ids, is what the owners are looked up through (a
    dense table without it). On a CUDA tensor the kernel at S = n
    (owned_extract.extract_owned_exact: the first nv / ntri rows of
    _extract_owned_fixed's result, its counts read once); on a CPU tensor,
    or with no cell, _extract_owned_plain; the two agree bit for bit."""
    if volume.device.type == "cpu" or cell_ids.shape[0] == 0:
        return _extract_owned_plain(volume, sdf_params, cell_ids, iso, blk)
    return owned_extract.extract_owned_exact(
        volume.float().contiguous(), sdf_params.float().contiguous(),
        cell_ids.int().contiguous(), iso, blk=_rows_arg(blk))


def _extract_owned_plain(volume: torch.Tensor, sdf_params: torch.Tensor,
                         cell_ids: torch.Tensor, iso: float,
                         blk: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """_extract_owned in plain PyTorch: _owned_pass1, then _owned_pass2
    with the rows' look-up, or its dense owner table without rows."""
    if cell_ids.shape[0] == 0:
        return (torch.zeros(0, 3, device=volume.device),
                torch.zeros(0, 3, dtype=torch.int32, device=volume.device))
    verts, c, imask, cmask = _owned_pass1(volume, sdf_params, cell_ids, iso)
    return verts, _owned_pass2(c, imask, cmask, cell_ids, volume.shape[0],
                               blk)


def _extract_owned_fixed(volume: torch.Tensor, sdf_params: torch.Tensor,
                         cell_ids: torch.Tensor, n_cells: torch.Tensor,
                         iso: float, n_iter: int, batch: int,
                         blk: torch.Tensor | None = None):
    """The owned extractor at fixed shapes: on CUDA tensors the kernel
    (owned_extract.extract_owned), on CPU tensors
    _extract_owned_fixed_plain, which says what it computes; the two
    agree bit for bit."""
    if volume.device.type == "cpu":
        return _extract_owned_fixed_plain(volume, sdf_params, cell_ids,
                                          n_cells, iso, n_iter, batch, blk)
    if torch.is_tensor(n_cells) and n_cells.dtype != torch.int32:
        n_cells = n_cells.int()
    return owned_extract.extract_owned(
        volume.float().contiguous(), sdf_params.float().contiguous(),
        cell_ids.int().contiguous(), n_cells, iso, n_iter * batch,
        blk=_rows_arg(blk))


def _extract_owned_fixed_plain(volume: torch.Tensor, sdf_params: torch.Tensor,
                               cell_ids: torch.Tensor, n_cells: torch.Tensor,
                               iso: float, n_iter: int, batch: int,
                               blk: torch.Tensor | None = None):
    """_extract_owned at fixed shapes, with nothing waiting for the card
    (port of disn_tpu/ops/marching.py _extract_owned(..., n_cells, n_iter,
    batch)): the first S = n_iter * batch slots of the padded id list
    `cell_ids`, those at or past n_cells (a 0-d tensor) masked out ->
    (verts [S*D,3] f32, nv, faces [S*12,3] int32, ntri, missing), the
    counts 0-d on the card and the rows past them zero.

    Both passes run over every slot: a mask and a cumsum give each crossing
    edge its vertex row and each triangle its face row, in the exact
    function's orders (slot then direction; slot, tet, triangle), and a
    scatter puts the masked rows into an extra last row that is dropped.
    On its first nv / ntri rows the result is _extract_owned's on
    cell_ids[:n_cells], bit for bit, when S >= n_cells. `missing` counts
    the triangle corners whose owner cell is not in the first S slots
    (where _extract_owned raises): 0 on a scan's list that S covers.

    The owner of a triangle's edge is looked up through `blk`, the rows of
    the scan that listed cell_ids (_block_owner; the capped compaction's
    zero rows are no block), when given; else through a dense [R^3] table
    of the live slots (_dense_owner). The two give the same slots on a
    scan's list and its rows."""
    dev = volume.device
    tb = _device_tables(dev)
    R = volume.shape[0]
    S = n_iter * batch
    if S > cell_ids.shape[0]:
        raise ValueError(f"{n_iter} x {batch} slots past the "
                         f"{cell_ids.shape[0]} ids")
    ids = cell_ids[:S].long()
    live = torch.arange(S, device=dev) < n_cells
    c, vals, inside, cross = _slot_data(volume, ids, iso)
    cross = cross & live[:, None]
    # pass 1: every (slot, direction)'s vertex, the crossing ones kept
    pj = tb["pair_j"]
    t = _edge_t(vals[:, :1], vals[:, pj], iso)[..., None]          # [S,D,1]
    gi = c[:, None, :]
    gj = torch.clamp(gi + tb["corners"][pj][None], max=R - 1)
    pi_, pj_ = _world(gi, R, sdf_params), _world(gj, R, sdf_params)
    pos = (pi_ + t * (pj_ - pi_)).reshape(-1, 3)
    flat = cross.reshape(-1)
    vcs = torch.cumsum(flat, 0)
    vcap = S * D_OWNED
    vrow = torch.where(flat, vcs - 1, vcap)
    verts = torch.zeros(vcap + 1, 3, device=dev).scatter_(
        0, vrow[:, None].expand(-1, 3), pos)[:vcap]
    # pass 2: every (slot, tet, triangle)'s corners, the real ones kept
    imask, cmask = _pack_bits(inside), _pack_bits(cross)
    counts = tb["pop7"][cmask]
    vstart = torch.cumsum(counts, 0) - counts
    owner = (_dense_owner(ids, live, R) if blk is None
             else _block_owner(blk, R, live.sum()))
    case = (((imask[:, None, None] >> tb["tets"][None]) & 1)
            << torch.arange(4, device=dev)).sum(-1)                  # [S,6]
    tet = torch.arange(6, device=dev)[None, :]
    n_tris = tb["counts"][tet, case]
    real = (c <= R - 2).all(1) & live           # ghost cells emit no triangle
    valid = ((torch.arange(2, device=dev) < n_tris[..., None])
             & real[:, None, None])                                # [S,6,2]
    nb_v, dr_v = tb["nb"][tet, case], tb["dir"][tet, case]       # [S,6,2,3]
    vvalid = valid[..., None].expand_as(nb_v)
    ncell = c[:, None, None, None, :] + tb["corners"][nb_v]     # [S,6,2,3,3]
    slot = torch.where(vvalid, owner(torch.where(vvalid[..., None], ncell,
                                                 0)), -1)
    missing = (vvalid & (slot < 0)).sum().int()
    slot = slot.clamp(min=0)
    rank = tb["pop7"][cmask[slot] & ((1 << dr_v) - 1)]
    tri = (vstart[slot] + rank).int().reshape(-1, 3)
    tflat = valid.reshape(-1)
    tcs = torch.cumsum(tflat, 0)
    tcap = S * _N_SLOTS
    trow = torch.where(tflat, tcs - 1, tcap)
    faces = torch.zeros(tcap + 1, 3, dtype=torch.int32, device=dev).scatter_(
        0, trow[:, None].expand(-1, 3), tri)[:tcap]
    return verts, vcs[-1].int(), faces, tcs[-1].int(), missing


def _fetch_mesh(verts: torch.Tensor, faces: torch.Tensor
                ) -> tuple[np.ndarray, np.ndarray]:
    """Device (verts f32 [nv,3], faces int32 [ntri,3]) -> numpy. Plain
    copies into pageable memory: one copy into a kept page-locked buffer
    must be copied out of it again, and was no faster on an H100 (0.68 ms
    against 0.58 ms for a 6.3 MB mesh; chip_smoke.py times both)."""
    return verts.cpu().numpy(), faces.cpu().numpy()


def _to_host(tensors, join: bool) -> tuple[list[np.ndarray], Any]:
    """Tensors -> (numpy arrays, event). join=True, or tensors off a card:
    plain copies (a CPU tensor's array shares its memory), event None.
    join=False on a card: non-blocking copies into page-locked buffers
    and one CUDA event recorded after them on the current stream; the
    arrays hold the data once the event has completed. The sources may be
    freed at once: the allocator reuses their memory in stream order."""
    out, event = [], None
    for t in tensors:
        if join or not t.is_cuda:
            out.append(t.cpu().numpy())
            continue
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        out.append(buf.numpy())
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
    return out, event


def _empty_mesh() -> tuple[np.ndarray, np.ndarray]:
    return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)


def _on_device(volume, sdf_params, device) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The f32 volume and sdf_params on the resolved device: the card,
    unless `device` asks for another; a tensor already on a card stays."""
    if device is None and torch.is_tensor(volume) and volume.is_cuda:
        dev = volume.device
    else:
        dev = device_mod.resolve(device)
    vol = torch.as_tensor(volume, dtype=torch.float32).to(dev)
    return vol, torch.as_tensor(sdf_params, dtype=torch.float32).to(dev)


def extract_mesh_from_ids_deferred(volume, sdf_params, ids: torch.Tensor,
                                   iso: float = 0.0,
                                   device: str | torch.device | None = None,
                                   stats: dict | None = None,
                                   blk: torch.Tensor | None = None
                                   ) -> Callable[[], tuple[np.ndarray,
                                                           np.ndarray]]:
    """extract_mesh_from_ids split for the farm: both passes and the copy
    run here, on the calling thread; the returned zero-argument closure
    returns the fetched mesh."""
    vol, sdfp = _on_device(volume, sdf_params, device)
    with device_mod.stage(stats, "extract_ms", vol.device):
        verts, faces = _extract_owned(
            vol, sdfp, ids.to(vol.device), float(iso),
            None if blk is None else blk.to(vol.device))
    with device_mod.stage(stats, "fetch_ms", vol.device):
        mesh = _fetch_mesh(verts, faces)
    return lambda: mesh


def extract_mesh_from_ids(volume, sdf_params, ids: torch.Tensor,
                          iso: float = 0.0,
                          device: str | torch.device | None = None,
                          stats: dict | None = None,
                          blk: torch.Tensor | None = None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Owned-edge extraction given the active-cell list of a scan (ids [n]
    flat over the extended E^3 grid, in scan order) -> exact welded numpy
    (verts [nv,3] f32, faces [ntri,3] i32). `blk`, the scan's rows, is
    what the owners are looked up through; without it a dense table. It
    must be the rows of the scan that produced ids, and ids a prefix of
    their cells in the scan's order: only its dtype and shape are checked,
    and other rows give wrong owners. `stats`, when given, receives ``extract_ms`` (the two passes on the
    device) and ``fetch_ms`` (the copy to the host)."""
    return extract_mesh_from_ids_deferred(volume, sdf_params, ids, iso=iso,
                                          device=device, stats=stats,
                                          blk=blk)()


def extract_mesh_owned_deferred(volume, sdf_params, iso: float = 0.0,
                                device: str | torch.device | None = None,
                                stats: dict | None = None
                                ) -> Callable[[], tuple[np.ndarray,
                                                        np.ndarray]]:
    """extract_mesh_owned split for the farm: the scan, both passes and the
    copy run here; the closure returns the fetched mesh."""
    vol, sdfp = _on_device(volume, sdf_params, device)
    with device_mod.stage(stats, "scan_ms", vol.device):
        ids, _, blk = _active_cells_ext_rows(vol, float(iso))
    return extract_mesh_from_ids_deferred(vol, sdfp, ids, iso=iso,
                                          device=vol.device, stats=stats,
                                          blk=blk)


def extract_mesh_owned(volume, sdf_params, iso: float = 0.0,
                       device: str | torch.device | None = None,
                       stats: dict | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Owned-edge extraction of a [R,R,R] (z,y,x) volume through the
    full-volume scan -> exact welded numpy (verts, faces). `stats` also
    receives ``scan_ms``."""
    return extract_mesh_owned_deferred(volume, sdf_params, iso=iso,
                                       device=device, stats=stats)()


# ---------------------------------------------------------------------------
# K3: the record route
# ---------------------------------------------------------------------------

def _extract_records(volume: torch.Tensor, cell_ids: torch.Tensor, iso: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Owned-edge records of the active-cell slots, computed at those slots
    only -> (rec [n] int16 = crossing mask << 8 | inside mask (at most
    0x7FFF), tq [n,D]: every owned edge's parameter t quantised to
    round(t * 255) uint8 when R - 1 >= 128, else round(t * 65535) held in
    int32). Edges that do not cross carry their t all the same, as in the
    JAX package, so the arrays compare bit for bit."""
    tb = _device_tables(volume.device)
    _, vals, inside, cross = _slot_data(volume, cell_ids, iso)
    rec = (_pack_bits(cross) << 8 | _pack_bits(inside)).to(torch.int16)
    t = _edge_t(vals[:, :1], vals[:, tb["pair_j"]], iso)
    if _tq_bits(volume.shape[0]) == 8:
        return rec, torch.round(t * 255.0).to(torch.uint8)
    return rec, torch.round(t * 65535.0).to(torch.int32)


def _fit_batch(ids_len: int, batch: int) -> int:
    """The largest batch <= `batch` that divides the JAX package's id
    buffer length (its record pass slices the buffer batch by batch)."""
    batch = max(1, min(batch, ids_len))
    while ids_len % batch:
        batch //= 2
    return batch


def _norm_gcap(E: int) -> int:
    """The JAX package's default group cap of its scan over E^3 cells: its
    id buffer holds 64 ids a group."""
    gcap = max(512, (E * E) // 4)
    return min(-(-gcap // 128) * 128, -(-((E + 3) // 4) ** 3 // 128) * 128)


def _qbucket(n: int) -> int:
    """The JAX package's quarter-power-of-two bucket of a batch count."""
    p = 1
    while p < max(n, 4):
        p *= 2
    p //= 2
    for m in (5, 6, 7, 8):
        if n <= p * m // 4:
            return p * m // 4
    return 2 * p


def _ebucket(n: int) -> int:
    """The JAX package's eighth-power-of-two bucket of a block count (the
    fine pass's: every padded block is decoded)."""
    p = 1
    while p < max(n, 4):
        p *= 2
    p //= 2
    for m in range(9, 17):
        if n <= p * m // 8:
            return p * m // 8
    return 2 * p


def records_n_iter(ids_len: int, n_cells: int, batch: int
                   ) -> tuple[int, int]:
    """(n_iter, fitted batch) of a record pass over the first n_cells slots
    of an id buffer of ids_len (the JAX package's rule: n_iter batches,
    quarter-power-of-two bucketed, at most the buffer)."""
    batch = _fit_batch(ids_len, batch)
    n_iter = min(_qbucket(max(1, -(-n_cells // batch))), ids_len // batch)
    return n_iter, batch


def sharded_records(volume: torch.Tensor, cell_ids: torch.Tensor,
                    n_cells: int, mesh, *, iso: float, n_iter: int,
                    batch: int = 8192
                    ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The record pass striped over the points axis of a parallel.Mesh
    (port of make_sharded_records_fn): with S = ceil(n_iter / ranks) x
    batch slots a rank, rank j emits the records of slots [j S, (j+1) S);
    every rank gets them all, gathered in slot order -> (rec [n_cells]
    int16, tq [n_cells, D], the slot count S x ranks). The volume and the
    ids are every rank's. A slot's record depends on the volume alone, so the result is
    _extract_records' on all the ids, bit for bit; slots past n_cells,
    which the JAX pass computes and leaves unread, are not computed."""
    from disn_tpu_torch import parallel

    n = mesh.shape[parallel.POINT_AXIS]
    per_rank = -(-n_iter // n) * batch
    j = mesh.coords[1]
    mine = cell_ids[min(n_cells, j * per_rank):
                    min(n_cells, (j + 1) * per_rank)]
    rec, tq = _extract_records(volume, mine.to(volume.device), float(iso))
    return (parallel.gather(rec, mesh, mesh.points_group),
            parallel.gather(tq, mesh, mesh.points_group), per_rank * n)


def _cross_bits(rec: torch.Tensor) -> torch.Tensor:
    """rec [n] -> [n,D] bool crossing flags."""
    shifts = 8 + torch.arange(D_OWNED, device=rec.device)
    return ((rec.long()[:, None] >> shifts[None, :]) & 1) > 0


def _count_cross(rec: torch.Tensor) -> int:
    """Total crossing edges (== vertex count) across all record slots."""
    return int(_cross_bits(rec).sum())


def records_masked_sparse(words: torch.Tensor, sids: torch.Tensor,
                          n_cells: torch.Tensor, R: int, n_iter: int,
                          batch: int, scalars: tuple = ()
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The record pass over the sparse words at a predicted bucket (port
    of _records_masked_split_sparse), with nothing waiting for the card:
    the first n_iter x batch slots of `sids` gathered, those at or past
    n_cells (a 0-d device tensor) zeroed. Returns (imask [S] uint8, tq [S,
    D] in _extract_records' type, flags int32 [len(scalars) + 1]): the
    scalars (0-d tensors or ints), then nv, the crossing edges (vertices)
    of the live slots. On the live slots imask and tq equal
    _records_from_words_sparse's."""
    S = n_iter * batch
    rec, tq = _records_from_words_sparse(words, sids[:S], R)
    live = torch.arange(S, device=words.device) < n_cells
    rec = rec * live
    tq = tq * live[:, None].to(tq.dtype)
    nv = _cross_bits(rec).sum()
    flags = torch.stack([
        s.reshape(()).int() if torch.is_tensor(s)
        else torch.full((), int(s), dtype=torch.int32, device=words.device)
        for s in (*scalars, nv)])
    return (rec & 0xFF).to(torch.uint8), tq, flags


def _compact_tq(rec: torch.Tensor, tq: torch.Tensor) -> torch.Tensor:
    """Only the CROSSING edges' parameters, in vertex order (slot-major,
    direction-minor): [nv] instead of [n,D]."""
    return tq[_cross_bits(rec)]


def _host_records(rec: np.ndarray, tq: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Fetched records -> the C++ passes' types (rec uint16, or uint8 when
    only the inside masks are shipped; tq uint8 | uint16)."""
    if rec.dtype == np.int16:
        rec = rec.view(np.uint16)
    if tq.dtype != np.uint8:
        tq = tq.astype(np.uint16)
    return rec, tq


def _records_to_host(rec: torch.Tensor, tq: torch.Tensor
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Device records -> numpy in _host_records' types."""
    return _host_records(rec.cpu().numpy(), tq.cpu().numpy())


def extract_mesh_records_deferred(volume, sdf_params, ids: torch.Tensor,
                                  n_cells: int,
                                  blk: torch.Tensor | None = None,
                                  iso: float = 0.0,
                                  device: str | torch.device | None = None,
                                  join: bool = True
                                  ) -> Callable[[], tuple[np.ndarray,
                                                          np.ndarray]]:
    """extract_mesh_records split for the farm (port of the JAX package's
    extract_mesh_records_deferred): this call does all device work, the
    record pass and the copies, on the calling thread; the returned
    zero-argument closure runs the host assembly and nothing else, so a
    writer pool can overlap it with the next image's device work. It holds
    numpy arrays and at most a CUDA event, never a CUDA tensor, and issues
    no device operation.

    join=True: plain copies, the closure holds the arrays. join=False: the
    copies are non-blocking into page-locked buffers (_to_host), and the
    closure waits on their event before it reads them."""
    vol, sdfp = _on_device(volume, sdf_params, device)
    R = int(vol.shape[0])
    if n_cells != ids.shape[0]:
        raise ValueError(f"{ids.shape[0]} ids for {n_cells} cells")
    if n_cells == 0:
        return _empty_mesh
    rec_d, tq_d = _extract_records(vol, ids.to(vol.device), float(iso))
    bbox = sdfp.cpu().numpy()
    if blk is not None:
        return _blocks_deferred(rec_d, tq_d, blk, n_cells, R, bbox, join)
    (rec, tq, ids_np), done = _to_host((rec_d, tq_d, ids), join)

    def assemble() -> tuple[np.ndarray, np.ndarray]:
        from disn_tpu_torch import native

        if done is not None:
            done.synchronize()
        return native.mesh_assemble(ids_np, *_host_records(rec, tq),
                                    n_cells, R, bbox)

    return assemble


def extract_mesh_records(volume, sdf_params, ids: torch.Tensor, n_cells: int,
                         blk: torch.Tensor | None = None, iso: float = 0.0,
                         device: str | torch.device | None = None
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Record route: the device emits per-slot records, one copy takes them
    to the host, and the C++ passes of ``disn_tpu_torch.native`` assemble
    the welded mesh. Faces equal the device extractor's; a vertex is off by
    at most its cell edge over 510 per coordinate (u8 t) or over 131070
    (u16 t, grids under 129).

    With the scan's `blk` rows the host gets the u8 inside masks and the
    block rows (it derives the crossing bits and the cell coordinates from
    them); without, the u16 records and the id list. Raises when the
    library does not build, or a pass finds the streams inconsistent:
    there is no fallback to numpy."""
    return extract_mesh_records_deferred(volume, sdf_params, ids, n_cells,
                                         blk=blk, iso=iso, device=device)()


def _blocks_deferred(rec_d: torch.Tensor, tq_d: torch.Tensor,
                     blk: torch.Tensor, n_cells: int, R: int,
                     bbox: np.ndarray, join: bool,
                     stats: dict | None = None
                     ) -> Callable[[], tuple[np.ndarray, np.ndarray]]:
    """The record route's host half from the block rows: here one copy of
    the u8 inside masks, the edge parameters and the rows (_to_host);
    the closure checks the rows against the cell count and runs the C++
    passes, which derive the crossing bits and the cell coordinates and
    build the mesh. `stats` receives ``fetch_ms`` (the copy) and, from the
    closure, ``assemble_ms`` (host clock: it touches no device)."""
    with device_mod.stage(stats, "fetch_ms", rec_d.device):
        (imask, tq, rows), done = _to_host(
            ((rec_d & 0xFF).to(torch.uint8), tq_d, blk), join)

    def assemble() -> tuple[np.ndarray, np.ndarray]:
        if done is not None:
            done.synchronize()
        return assemble_blocks(imask, tq, rows, n_cells, R, bbox, stats)

    return assemble


def assemble_blocks(imask: np.ndarray, tq: np.ndarray, rows: np.ndarray,
                    n_cells: int, R: int, bbox: np.ndarray,
                    stats: dict | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
    """The record route's host assembly from fetched streams: the u8
    inside masks and edge parameters of the first n_cells slots, and the
    block rows, whose rows with an empty mask (a capped compaction's
    padding) are dropped. Checks the rows against the cell count and runs
    the C++ passes, which derive the crossing bits and the cell coordinates
    and build the mesh. Host work only; `stats` receives ``assemble_ms``."""
    from disn_tpu_torch import native

    with device_mod.stage(stats, "assemble_ms", torch.device("cpu")):
        rows = rows[(rows[:, 1] != 0) | (rows[:, 2] != 0)]
        rec, tq16 = _host_records(imask[:n_cells], tq[:n_cells])
        if _mask_cell_count(rows) != n_cells:
            raise RuntimeError(
                f"block masks encode {_mask_cell_count(rows)} cells, "
                f"the scan counted {n_cells} (inconsistent record "
                f"streams)")
        recs = native.derive_recs(rows, rec, R)
        faces = native.mesh_faces_blocks(rows, recs, n_cells, R)
        verts = native.mesh_verts_blocks(rows, recs, tq16, n_cells, R,
                                         bbox)
    return verts, faces


# ---------------------------------------------------------------------------
# K5: record words and change bits straight from the fine pass's rows
# ---------------------------------------------------------------------------

LANES = BLOCK ** 3  # a cell's fine points, lane l = (z*4 + y)*4 + x
_LANE_XYZ = (np.arange(LANES) % BLOCK, (np.arange(LANES) // BLOCK) % BLOCK,
             np.arange(LANES) // BLOCK ** 2)
# the "-1" directions (dx, dy, dz) whose neighbour covers a cell's low faces
_LOW_DIRS = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
             (0, 1, 1), (1, 1, 1))


def _own_table(cell_ids: torch.Tensor, count, c: int) -> torch.Tensor:
    """[c^3] int32: the row slot of each of the first `count` (an int or a
    0-d tensor) coarse cells of `cell_ids`, -1 for every other cell."""
    dev = cell_ids.device
    nk = cell_ids.shape[0]
    slot = torch.arange(nk, dtype=torch.int32, device=dev)
    own = torch.full((c ** 3 + 1,), -1, dtype=torch.int32, device=dev)
    # the slots past the count all go to the extra last entry, dropped
    own[torch.where(slot < count, cell_ids.long(), c ** 3)] = slot
    return own[:c ** 3]


def _coarse_guard(vol_c: torch.Tensor, own_tbl: torch.Tensor, iso: float
                  ) -> torch.Tensor:
    """Guard term (1), int32 0-d: coarse cells whose corner signs disagree
    but that are not active. Their lerp may cross the iso in a block that
    no candidate covers; the band cull makes every such cell active, so
    this counts violations of its premise."""
    c = vol_c.shape[0] - 1
    chg = _sign_change_cells(vol_c, iso)[:c, :c, :c].reshape(-1)
    return (chg & (own_tbl < 0)).sum().to(torch.int32)


def _pack_words(tq: list, imask: torch.Tensor, R: int) -> torch.Tensor:
    """7 edge parameters and the inside mask per lane -> [2 | 4, n] int32
    words: u8 (tq0..tq3 | tq4..tq6, imask), or u16 pairs (tq6, imask)."""
    if _tq_bits(R) == 8:
        ws = [tq[0] | (tq[1] << 8) | (tq[2] << 16) | (tq[3] << 24),
              tq[4] | (tq[5] << 8) | (tq[6] << 16) | (imask << 24)]
    else:
        ws = [tq[0] | (tq[1] << 16), tq[2] | (tq[3] << 16),
              tq[4] | (tq[5] << 16), tq[6] | (imask << 16)]
    return torch.stack([w.reshape(-1) for w in ws])


def _sparse_cell_words(rows: torch.Tensor, cell_ids: torch.Tensor,
                       count, vol_c: torch.Tensor, R: int, iso: float):
    """K5 in plain PyTorch (port of disn_tpu/ops/marching.py
    _sparse_cell_words, lane form): the record words and change bits of
    every active 4^3 block, from the fine pass's rows, with no [R^3]
    volume.

    rows [NK*64] f32: the fine pass's values, cell after cell, lane l =
    (z*4 + y)*4 + x; cell_ids [NK] int32 coarse cells, the first `count`
    valid (an int, or a 0-d int32 tensor on their device, as the kernel
    takes it; at most NK of them count). A lane's corner value at offset o is the value the dense volume
    holds there: the cell's own row, else the row of its active "+1"
    neighbour, else the coarse trilinear, lo*(1-w) + hi*w along z, y, x,
    each product and sum rounded, as sparse._upsample_aligned computes it.
    Requires no active cell on the + boundary (the caller adds those to the
    guard): ghost blocks and boundary planes stay out of this model.

    Returns (words [2|4, NK*64] int32 (_pack_words), bits [B3^3, 2] int32
    change masks (lo, hi), cand [B3^3] bool, own_tbl [c^3] int32,
    guard int32 0-d: term (1) of _coarse_guard plus term (2), lanes on a
    low face whose own value and coarse lerp differ in sign while a "-1"
    neighbour that reads them is not active)."""
    c = (R - 1) // BLOCK
    if tuple(vol_c.shape) != (c + 1,) * 3:
        raise ValueError(f"vol_c must be [{c + 1}]^3, got "
                         f"{tuple(vol_c.shape)}")
    dev = rows.device
    nk = cell_ids.shape[0]
    B3 = c + 1
    valid = torch.arange(nk, device=dev) < count
    own_tbl = _own_table(cell_ids, count, c)
    gid = torch.where(valid, cell_ids.long(), 0)
    cz, cy, cx = gid // (c * c), (gid // c) % c, gid % c
    # k = dz*4 + dy*2 + dx: the cell's coarse corners, and the row slots of
    # the cell (k = 0) and of its "+1" neighbours (-1: inactive, or past
    # the grid)
    corn, slot = [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                z, y, x = cz + dz, cy + dy, cx + dx
                corn.append(vol_c[z, y, x])
                inside = (z < c) & (y < c) & (x < c)
                s = own_tbl[((z * c + y) * c + x).clamp(max=c ** 3 - 1)]
                slot.append(torch.where(inside, s, -1))
    corn8 = torch.stack(corn, 1)                                # [NK,8]
    slot8 = torch.stack(slot, 1)                                # [NK,8]
    rows2 = rows.reshape(nk, LANES)
    ok8 = (slot8 >= 0) & valid[:, None]
    ok8[:, 0] = valid
    src8 = torch.stack([rows2] + [rows2[slot8[:, k].clamp(min=0)]
                                  for k in range(1, 8)], 1)     # [NK,8,64]
    lx, ly, lz = _LANE_XYZ

    def weight(lane):
        return torch.from_numpy((lane / 4.0).astype(np.float32)).to(dev)

    def lerp1(lo, hi, w):
        return lo * (1 - w) + hi * w

    def lerp_at(ox, oy, oz):
        """The coarse trilinear at every lane's point + (ox, oy, oz)."""
        wx, wy, wz = weight(lx + ox), weight(ly + oy), weight(lz + oz)
        az = [[lerp1(corn8[:, dy * 2 + dx, None],
                     corn8[:, 4 + dy * 2 + dx, None], wz[None])
               for dx in (0, 1)] for dy in (0, 1)]
        ay = [lerp1(az[0][dx], az[1][dx], wy[None]) for dx in (0, 1)]
        return lerp1(ay[0], ay[1], wx[None])                    # [NK,64]

    def value_at(ox, oy, oz):
        tx, ty, tz = lx + ox, ly + oy, lz + oz
        k = torch.from_numpy((tz // 4) * 4 + (ty // 4) * 2 + tx // 4).to(dev)
        sl = torch.from_numpy((tz % 4) * 16 + (ty % 4) * 4 + tx % 4).to(dev)
        return torch.where(ok8[:, k], src8[:, k, sl], lerp_at(ox, oy, oz))

    _, pair_j, _, _ = _owned_tables()
    v0 = rows2
    imask = (v0 < iso).int()
    scale = 255.0 if _tq_bits(R) == 8 else 65535.0
    tq = []
    for j in pair_j.tolist():
        vj = value_at(*CORNERS[j].tolist())
        imask = imask | ((vj < iso).int() << j)
        tq.append(torch.round(_edge_t(v0, vj, iso) * scale).int())
    words = _pack_words(tq, imask, R)

    # a cell changes iff its 8 corner signs disagree
    change = (imask != 0) & (imask != 0xFF) & valid[:, None]
    masks = _pack_bits(change).view(torch.int32).view(-1, 2)
    b3id = ((cz * B3 + cy) * B3 + cx)[valid]
    bits = torch.zeros((B3 ** 3, 2), dtype=torch.int32, device=dev)
    bits[b3id] = masks[valid]
    cand = torch.zeros(B3 ** 3, dtype=torch.bool, device=dev)
    cand[b3id] = True

    mm = (rows2 < iso) != (lerp_at(0, 0, 0) < iso)              # [NK,64]
    cov = []
    for dx, dy, dz in _LOW_DIRS:
        z, y, x = cz - dz, cy - dy, cx - dx
        past = (z < 0) | (y < 0) | (x < 0)
        act = own_tbl[((z * c + y) * c + x).clamp(min=0)] >= 0
        cov.append((past | act)[:, None])
    a_x, a_y, a_z, a_xy, a_xz, a_yz, a_xyz = cov
    ex, ey, ez = (torch.from_numpy(v == 0).to(dev)[None]
                  for v in (lx, ly, lz))
    badx = ex & (~a_x | (ey & ~a_xy) | (ez & ~a_xz) | (ey & ez & ~a_xyz))
    bady = ey & (~a_y | (ex & ~a_xy) | (ez & ~a_yz) | (ex & ez & ~a_xyz))
    badz = ez & (~a_z | (ex & ~a_xz) | (ey & ~a_yz) | (ex & ey & ~a_xyz))
    guard = (_coarse_guard(vol_c, own_tbl, iso)
             + (mm & (badx | bady | badz) & valid[:, None]).sum()
             ).to(torch.int32)
    return words, bits, cand, own_tbl, guard


def _records_from_words_sparse(words: torch.Tensor, sids: torch.Tensor,
                               R: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(rec, tq) of the slots whose ids address the sparse words arrays
    (slot*64 + bit, see _compact_block_bits), in _extract_records' types.
    No ghost aliasing: the sparse flow never gives a ghost cell a slot."""
    rows = words[:, sids.long()]
    if _tq_bits(R) == 8:
        imask = (rows[1] >> 24) & 0xFF
        tq = torch.stack([(rows[w] >> s) & 0xFF for w, s in
                          ((0, 0), (0, 8), (0, 16), (0, 24), (1, 0), (1, 8),
                           (1, 16))], -1).to(torch.uint8)
    else:
        imask = (rows[3] >> 16) & 0xFF
        tq = torch.stack([(rows[w] >> s) & 0xFFFF for w in range(4)
                          for s in (0, 16)][:7], -1)
    pj = _device_tables(words.device)["pair_j"]
    bitj = (imask.long()[:, None] >> pj[None, :]) & 1
    cross = (imask.long()[:, None] & 1) != bitj
    rec = (_pack_bits(cross) << 8 | imask.long()).to(torch.int16)
    return rec, tq


def extract_mesh_records_deferred_sparse(
        words: torch.Tensor, R: int, sdf_params, sids: torch.Tensor,
        n_cells: int, blk: torch.Tensor, join: bool = True,
        stats: dict | None = None
        ) -> Callable[[], tuple[np.ndarray, np.ndarray]]:
    """The record route over the sparse words arrays, split for the farm
    (port of extract_mesh_records_deferred_sparse without its fetch
    streams): the slots' (rec, tq) gathered on the words' device and the
    copies happen here; the closure is _blocks_deferred's (host work
    only; `join` as in extract_mesh_records_deferred). `stats` receives
    ``extract_ms`` (the gather), ``fetch_ms`` and, when the closure runs,
    ``assemble_ms``."""
    if n_cells != sids.shape[0]:
        raise ValueError(f"{sids.shape[0]} ids for {n_cells} cells")
    if n_cells == 0:
        return _empty_mesh
    bbox = torch.as_tensor(sdf_params, dtype=torch.float32).cpu().numpy()
    with device_mod.stage(stats, "extract_ms", words.device):
        rec_d, tq_d = _records_from_words_sparse(words, sids, R)
    return _blocks_deferred(rec_d, tq_d, blk, n_cells, R, bbox, join, stats)


def extract_mesh_records_sparse(words: torch.Tensor, R: int, sdf_params,
                                sids: torch.Tensor, n_cells: int,
                                blk: torch.Tensor,
                                stats: dict | None = None
                                ) -> tuple[np.ndarray, np.ndarray]:
    """The record route over the sparse words arrays: the slots' (rec, tq)
    gathered on the words' device, one copy to the host, and the C++
    passes of extract_mesh_records(blk=...). Faces equal the owned
    extractor's on the volume flow's volume; a vertex is off by at most
    its cell edge over 510 per coordinate (u8 t) or over 131070 (u16 t).
    `stats` receives ``extract_ms`` (the gather), ``fetch_ms`` and
    ``assemble_ms``."""
    return extract_mesh_records_deferred_sparse(
        words, R, sdf_params, sids, n_cells, blk, stats=stats)()


# ---------------------------------------------------------------------------
# Host assembly in numpy: what the C++ passes are held against
# ---------------------------------------------------------------------------

def _masks_u64(blk: np.ndarray) -> np.ndarray:
    """blk [b,3] int32 rows -> [b] uint64 change masks."""
    blk = np.ascontiguousarray(blk, np.int32)
    lo = np.ascontiguousarray(blk[:, 1]).view(np.uint32).astype(np.uint64)
    hi = np.ascontiguousarray(blk[:, 2]).view(np.uint32).astype(np.uint64)
    return lo | (hi << np.uint64(32))


def expand_block_ids_np(blk: np.ndarray, R: int) -> tuple[np.ndarray, int]:
    """The scan's (block id, mask lo, mask hi) rows -> (flat cell ids int32,
    block ascending then bit ascending, their count)."""
    E, S = R, BLOCK
    B3 = (E + S - 1) // S
    rows = ((_masks_u64(blk)[:, None]
             >> np.arange(S ** 3, dtype=np.uint64)[None, :]) & 1).astype(bool)
    bi, li = np.nonzero(rows)  # row-major == (block asc, bit asc)
    bids = np.asarray(blk)[:, 0].astype(np.int64)
    bz, by, bx = bids // (B3 * B3), (bids // B3) % B3, bids % B3
    base = ((bz * S) * E + by * S) * E + bx * S
    lz, ly, lx = li // (S * S), (li // S) % S, li % S
    ids = (base[bi] + (lz * E + ly) * E + lx).astype(np.int32)
    return ids, len(ids)


def _mask_cell_count(blk: np.ndarray) -> int:
    """Total cells encoded by the scan's (block id, 64-bit mask) rows."""
    return int(np.unpackbits(_masks_u64(blk).view(np.uint8)).sum())


def derive_recs_np(blk: np.ndarray, imask: np.ndarray, R: int) -> np.ndarray:
    """u8 inside masks of the slots the rows encode -> uint32 records
    (crossing mask << 8 | inside mask). Every owned edge starts at corner 0,
    so direction d crosses when inside bit 0 differs from inside bit
    pair_j[d], unless the cell is a ghost on an axis the edge extends along.
    Slots past the encoded cells keep a crossing mask of 0."""
    _, pair_j, _, _ = _owned_tables()
    alias = _alias_axes()
    out = np.asarray(imask).astype(np.uint32)
    ids, n = expand_block_ids_np(blk, R)
    n = min(n, len(out))
    ids = ids[:n].astype(np.int64)
    E = R
    ghost = ((ids % E == E - 1).astype(np.int32)
             | (((ids // E) % E == E - 1) << 1)
             | ((ids // (E * E) == E - 1) << 2))
    im = out[:n]
    bitj = (im[:, None] >> pair_j.astype(np.uint32)[None, :]) & 1
    cross = (((im[:, None] & 1) != bitj)
             & ((ghost[:, None] & alias[None, :]) == 0))
    cmask = (cross << np.arange(len(pair_j), dtype=np.uint32)[None, :]
             ).sum(1).astype(np.uint32)
    out[:n] = im | (cmask << np.uint32(8))
    return out


def assemble_mesh_np(ids: np.ndarray, recs: np.ndarray, tqs: np.ndarray,
                     n_cells: int, R: int, sdf_params,
                     tq_compact: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Welded (verts f32, faces i32) from the records of `n_cells` slots, in
    the device extractor's vertex order (slot-major, direction-minor) and
    with its triangle tables, so faces are identical to its.

    tq_compact=True: tqs is the _compact_tq stream, one entry per CROSSING
    edge in vertex order, instead of [slots, D]."""
    pair_i, pair_j, nb_tbl, dir_tbl = _owned_tables()
    D = len(pair_i)
    E = R
    ids = np.asarray(ids[:n_cells], np.int64)
    recs = np.asarray(recs[:n_cells]).astype(np.uint32)
    tqs = np.asarray(tqs if tq_compact else tqs[:n_cells])
    if tqs.dtype == np.uint8:  # exact range map: 255 * 257 == 65535
        tqs = tqs.astype(np.uint16) * np.uint16(257)
    tqs = tqs.astype(np.uint16)
    cross = ((recs[:, None] >> (8 + np.arange(D, dtype=np.uint32))) & 1
             ).astype(bool)                                     # [n, D]
    inside = ((recs[:, None] >> np.arange(8, dtype=np.uint32)) & 1
              ).astype(np.int64)                                # [n, 8]
    counts = cross.sum(1)
    vstart = np.zeros(n_cells, np.int64)
    np.cumsum(counts[:-1], out=vstart[1:])
    nv = int(counts.sum())

    cz, cy, cx = ids // (E * E), (ids // E) % E, ids % E
    lo = np.asarray(sdf_params[:3], np.float32)
    hi = np.asarray(sdf_params[3:6], np.float32)
    sel_cell, sel_dir = np.nonzero(cross)     # row-major == vertex order
    cc = np.stack([cx[sel_cell], cy[sel_cell], cz[sel_cell]], axis=1)
    gi = np.minimum(cc + CORNERS[pair_i[sel_dir]], R - 1)
    gj = np.minimum(cc + CORNERS[pair_j[sel_dir]], R - 1)
    denom = np.float32(R - 1)
    pi = lo + gi.astype(np.float32) / denom * (hi - lo)
    pj = lo + gj.astype(np.float32) / denom * (hi - lo)
    if tq_compact:
        t = tqs[:nv].astype(np.float32) / np.float32(65535.0)
    else:
        t = tqs[sel_cell, sel_dir].astype(np.float32) / np.float32(65535.0)
    verts = pi + t[:, None] * (pj - pi)

    _, counts_tbl = _tables()                                    # [6,16]
    case = (inside[:, TETS] * (1 << np.arange(4))).sum(-1)       # [n, 6]
    n_tris = counts_tbl[np.arange(6)[None, :], case]             # [n, 6]
    real = (cx <= R - 2) & (cy <= R - 2) & (cz <= R - 2)
    valid = ((np.arange(2)[None, None, :] < n_tris[:, :, None])
             & real[:, None, None])                              # [n, 6, 2]
    sc, st, sk = np.nonzero(valid)
    cs = case[sc, st]
    nb_v, dr_v = nb_tbl[st, cs, sk], dir_tbl[st, cs, sk]         # [T, 3]
    off = CORNERS[nb_v.reshape(-1)]                              # [T*3, 3]
    ncell = np.repeat(np.stack([cx[sc], cy[sc], cz[sc]], 1), 3, axis=0) + off
    nid = (ncell[:, 2] * E + ncell[:, 1]) * E + ncell[:, 0]
    # ids ascend within 4^3 blocks, not globally: sort once for the owner
    # look-up; vertex order stays slot order
    order = np.argsort(ids, kind="stable")
    pos = np.searchsorted(ids[order], nid)
    slot = order[np.minimum(pos, max(n_cells - 1, 0))] if n_cells else pos
    if not (ids[slot] == nid).all():
        raise ValueError("a triangle's edge belongs to a cell that is not "
                         "in the id list")
    below = (1 << dr_v.reshape(-1).astype(np.uint32)) - 1
    masked = (recs[slot] >> np.uint32(8)) & np.uint32((1 << D) - 1) & below
    rank = np.zeros(len(slot), np.int64)
    for b in range(D):
        rank += (masked >> np.uint32(b)) & 1
    faces = (vstart[slot] + rank).reshape(-1, 3).astype(np.int32)
    return verts.astype(np.float32), faces

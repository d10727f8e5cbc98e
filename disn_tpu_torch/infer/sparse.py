"""Sparse two-level dense-grid inference: coarse cull -> fine refine (port of
the dense-volume flow of disn_tpu/infer/sparse.py).

The head predicts an approximately signed DISTANCE, so a coarse pass can
prove cells empty: a coarse cell whose corners all have |sdf| above the
cull band (band_factor x the cell diagonal, widened by the observed
Lipschitz slope when cfg.band_autocal) and agree in sign cannot hold the
surface. Only the band is decoded at fine resolution; the far field is the
coarse grid upsampled with corners aligned, which keeps the signs.

* phase_a: encode + fold, decode the coarse (R-1)/4+1 grid
  (fused.dense_grid_via_cells where fused.kernel_enabled allows it, else
  the plain decode), threshold ('band' for regression heads, 'sign' for
  binary ones), compact the active cells (K4: tau and the cull in one
  launch of a hand-written kernel on the card, ops/band_cull and
  csrc/band_cull.cu; the plain versions _band_tau_plain then
  _active_cells_plain on the CPU).
* finish: decode exactly the active cells (through the kernel where
  kernel_enabled allows it, else the plain decode), upsample the coarse
  grid, scatter the fine values, and decode the boundary planes when an
  active cell touches them.
* phase_b_mesh: finish, then the mesh extractor's candidate scan of the
  fine cells inside the active coarse cells.
* phase_b_mesh_sparse (the sparse-words flow, port of
  _phase_b_mesh_sparse_jit): the fine pass's rows go straight to K5
  (ops/sparse_words), which builds the record words and change bits of the
  active blocks, then to the compaction. No volume, no upsample, no
  scatter, no planes. Its guard counts what that model cannot hold
  (active cells on the + boundary, band violations); the caller then runs
  phase_b_mesh from the same phase_a outputs.
* sparse_volume / sparse_dense_sdf: both phases, with the exact dense
  fallback when more cells are active than the cap allows. Every variant
  but THREEDCNN, in both sampling modes; binary heads through the sign
  cull, which the pipeline takes only with cfg.binary_sparse.

Run synchronously, the fine pass decodes exactly `count` cells (the
count read once from the card). The speculative dispatch of
infer/pipeline takes the fixed-shape forms instead (port of the JAX
package's static shapes): phase_a(max_cells=) keeps the count on the card
and the ids padded, and phase_b_mesh_sparse(count=, n_kcells=, bcap=)
(the words flow) and phase_b_mesh(count=, n_kcells=, bcap=, planes=) (the
volume flow) decode a predicted bucket of blocks and compact at a fixed
cap, so that nothing waits for a count; the volume flow's caller also
predicts whether the boundary planes are due. There is no escape re-run
in either: the kernel has no escapes.
"""
from __future__ import annotations

from typing import Any

import torch

from disn_tpu_torch import device as device_mod
from disn_tpu_torch.config import Config, Variant
from disn_tpu_torch.infer import dense as dense_mod
from disn_tpu_torch.infer import fused
from disn_tpu_torch.models import disn
from disn_tpu_torch.ops import band_cull, marching, sparse_words

Params = dict[str, Any]

STRIDE = fused.STRIDE
# the JAX package rounds the cell cap up to its 65,536-point decode blocks
CAP_BLOCK_CELLS = 65536 // STRIDE ** 3


def _upsample_aligned(vol_c: torch.Tensor, stride: int) -> torch.Tensor:
    """Trilinear upsample with coarse points EXACTLY on every stride-th fine
    point (align-corners semantics)."""
    rc = vol_c.shape[0]
    rf = (rc - 1) * stride + 1
    idx = torch.arange(rf, device=vol_c.device)
    i0 = torch.clamp(idx // stride, max=rc - 2)
    w = (idx - i0 * stride).to(vol_c.dtype) / stride

    def lerp(v, axis):
        lo = torch.index_select(v, axis, i0)
        hi = torch.index_select(v, axis, i0 + 1)
        shape = [1, 1, 1]
        shape[axis] = rf
        ww = w.reshape(shape)
        return lo * (1 - ww) + hi * ww

    return lerp(lerp(lerp(vol_c, 0), 1), 2)


def _corners(vol: torch.Tensor) -> torch.Tensor:
    c = vol.shape[0] - 1
    return torch.stack([vol[dz:dz + c, dy:dy + c, dx:dx + c]
                        for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)])


def _active_cells(vol_c: torch.Tensor, tau: torch.Tensor | None,
                  mode: str = "band", max_cells: int | None = None):
    """The band cull's cells: on a CUDA grid the kernel
    (band_cull.active_cells), on a CPU grid _active_cells_plain, which says
    what it computes; the two agree bit for bit."""
    if vol_c.device.type == "cpu":
        return _active_cells_plain(vol_c, tau, mode, max_cells)
    return band_cull.active_cells(vol_c, tau, mode, max_cells)


def _active_cells_plain(vol_c: torch.Tensor, tau: torch.Tensor,
                        mode: str = "band", max_cells: int | None = None):
    """Ids (int32, ascending) of coarse cells that may hold the surface.
    Returns (ids [count], count), or with `max_cells` (port of
    disn_tpu/infer/sparse.py _active_cells, whose shapes are fixed) (ids
    [max_cells] int32 padded with 0, count as an int32 0-d tensor on the
    grid's device): then nothing waits for the card, and ids past
    max_cells are dropped while count still counts them.

    mode 'band' (regression heads): some corner |v| < tau, or the corner
    signs disagree; sound for Lipschitz-1 distance-like fields.
    mode 'sign' (binary heads, whose (softmax - 0.5)/10 saturates the band
    test): the cells whose corner signs disagree, dilated by one cell. A
    heuristic: a feature thinner than ~2 coarse cells that flips no corner
    sign is missed (tau is not read)."""
    corners = _corners(vol_c)
    sign_change = (corners < 0).any(0) & (corners >= 0).any(0)
    if mode == "sign":
        c = sign_change.shape[0]
        p = torch.nn.functional.pad(sign_change, (1, 1, 1, 1, 1, 1))
        active = torch.zeros_like(sign_change)
        for dz in (0, 1, 2):
            for dy in (0, 1, 2):
                for dx in (0, 1, 2):
                    active |= p[dz:dz + c, dy:dy + c, dx:dx + c]
    elif mode == "band":
        active = (corners.abs().amin(0) < tau) | sign_change
    else:
        raise ValueError(f"mode must be 'band' or 'sign', got {mode!r}")
    active = active.reshape(-1)
    cap = active.shape[0] if max_cells is None else max_cells
    csum = torch.cumsum(active.int(), 0, dtype=torch.int32)
    # each active cell to its rank, the others (and ranks past the cap) to
    # the extra last slot, dropped
    slot = torch.where(active & (csum <= cap), csum - 1, cap).long()
    ids = torch.zeros(cap + 1, dtype=torch.int32, device=active.device)
    ids = ids.scatter_(0, slot, torch.arange(active.shape[0],
                                             dtype=torch.int32,
                                             device=active.device))[:cap]
    if max_cells is not None:
        return ids, csum[-1]
    count = int(csum[-1])
    return ids[:count], count


def _band_cull(vol_c: torch.Tensor, sdf_params: torch.Tensor, rc: int,
               band_factor: float, cfg: Config, mode: str = "band",
               max_cells: int | None = None):
    """The cull band's tau and the cull with it -> (tau, ids, count) as
    _band_tau and _active_cells give them: on a CUDA grid one launch of the
    kernel (band_cull.band_cull), on a CPU grid _band_cull_plain; the two
    agree bit for bit."""
    if vol_c.device.type == "cpu":
        return _band_cull_plain(vol_c, sdf_params, rc, band_factor, cfg, mode,
                                max_cells)
    return band_cull.band_cull(vol_c, sdf_params, rc, band_factor,
                               cfg.band_autocal and not cfg.binary, mode,
                               max_cells)


def _band_cull_plain(vol_c: torch.Tensor, sdf_params: torch.Tensor, rc: int,
                     band_factor: float, cfg: Config, mode: str = "band",
                     max_cells: int | None = None):
    """_band_tau_plain, then _active_cells_plain with its tau."""
    tau = _band_tau_plain(vol_c, sdf_params, rc, band_factor, cfg)
    return (tau, *_active_cells_plain(vol_c, tau, mode, max_cells))


def _band_tau(vol_c: torch.Tensor, sdf_params: torch.Tensor, rc: int,
              band_factor: float, cfg: Config) -> torch.Tensor:
    """The cull band's tau: on a CUDA grid the kernel (band_cull.band_tau),
    on a CPU grid _band_tau_plain, which says what it computes; the two
    agree bit for bit."""
    if vol_c.device.type == "cpu":
        return _band_tau_plain(vol_c, sdf_params, rc, band_factor, cfg)
    return band_cull.band_tau(vol_c, sdf_params, rc, band_factor,
                              cfg.band_autocal and not cfg.binary)


def _band_tau_plain(vol_c: torch.Tensor, sdf_params: torch.Tensor, rc: int,
                    band_factor: float, cfg: Config) -> torch.Tensor:
    """Cull-band threshold: band_factor x coarse cell diagonal, widened by
    the OBSERVED near-band slope over 7 directions (3 axes + 4 space
    diagonals) when cfg.band_autocal (see disn_tpu/infer/sparse._band_tau
    for the reasoning). vol_c axes are (z, y, x)."""
    sp = sdf_params.float()
    span = sp[3:6] - sp[0:3]
    cell_diag = torch.sqrt(torch.sum(torch.square(span / (rc - 1))))
    tau = band_factor * cell_diag
    if cfg.band_autocal and not cfg.binary:
        h = span / (rc - 1)
        hx, hy, hz = h[0], h[1], h[2]
        n_ = rc - 1
        vmin = torch.min(torch.abs(vol_c))
        win = 4.0 * tau + 2.0 * vmin

        def dir_lip(sl_a, sl_b, step):
            a = vol_c[sl_a]
            b = vol_c[sl_b]
            near = torch.minimum(a.abs(), b.abs()) < win
            d = torch.where(near, (b - a).abs(), torch.zeros_like(a))
            return torch.max(d) / step

        lo_ = slice(0, n_)
        hi_ = slice(1, rc)
        full = slice(None)
        hd = torch.sqrt(hx * hx + hy * hy + hz * hz)
        dirs = [
            ((lo_, full, full), (hi_, full, full), hz),
            ((full, lo_, full), (full, hi_, full), hy),
            ((full, full, lo_), (full, full, hi_), hx),
            ((lo_, lo_, lo_), (hi_, hi_, hi_), hd),
            ((lo_, lo_, hi_), (hi_, hi_, lo_), hd),
            ((lo_, hi_, lo_), (hi_, lo_, hi_), hd),
            ((lo_, hi_, hi_), (hi_, lo_, lo_), hd),
        ]
        lip = torch.zeros((), device=vol_c.device)
        for sa, sb, st in dirs:
            lip = torch.maximum(lip, dir_lip(sa, sb, st))
        tau = tau * torch.clamp(lip, min=1.0)
    return tau


def _cap_block(cfg: Config) -> tuple[int, int]:
    """(cfg.cell_cap_frac of the coarse cells, at least 256; the JAX
    package's cells per decode block)."""
    cap = max(256, int((cfg.sdf_res // STRIDE) ** 3 * cfg.cell_cap_frac))
    return cap, min(cap, CAP_BLOCK_CELLS)


def cell_cap(cfg: Config) -> int:
    """Most active coarse cells the sparse pass takes before it falls back
    to the dense path: the JAX package's rule, cfg.cell_cap_frac of the
    coarse cells (at least 256), rounded up to its blocks."""
    cap, blk = _cap_block(cfg)
    return -(-cap // blk) * blk


def _folds(cfg: Config) -> tuple[str, bool, bool]:
    """(fold, fine pass through the kernel, coarse pass through the
    kernel). The fine check is strict (fused_kernel='on' raises on an
    ineligible config), the coarse one is not: the coarse grid (65^3 on
    the main path) keeps the kernel where it is eligible and decodes
    plainly otherwise, as the JAX package's strict=False check has it."""
    fold = dense_mod.normalize_fold(None, cfg)
    rc = cfg.sdf_res // STRIDE + 1
    return (fold, fused.kernel_enabled(cfg, fold, STRIDE, cfg.grid_resolution),
            fused.kernel_enabled(cfg, fold, STRIDE, rc, strict=False))


def phase_a(params: Params, img: torch.Tensor, trans_mat: torch.Tensor,
            sdf_params: torch.Tensor, cfg: Config,
            stats: dict | None = None, max_cells: int | None = None):
    """Encode + fold + coarse grid + cull ('sign' for binary heads, else
    'band'). Returns (embedding, endpoints, vol_c [rc,rc,rc] f32, cell_ids
    [count] int32, count); with `max_cells`, cell_ids [max_cells] padded
    with 0 and count a 0-d int32 tensor on the card (_active_cells), so
    that nothing here waits for the card."""
    dev = sdf_params.device
    fold, _, coarse_kernel = _folds(cfg)
    rc = cfg.sdf_res // STRIDE + 1
    with device_mod.stage(stats, "encode_ms", dev):
        embedding, eps = disn.encode(params, img, cfg)
    with device_mod.stage(stats, "prep_ms", dev):
        endpoints = dense_mod.fold_endpoints(params, embedding, eps, cfg,
                                             fold)
    with device_mod.stage(stats, "phase_a_ms", dev):
        if coarse_kernel:
            vol_c = fused.dense_grid_via_cells(params, endpoints, trans_mat,
                                               sdf_params, rc, cfg)
        else:
            vol_c = dense_mod._stream_blocks(
                params, endpoints, embedding, trans_mat, sdf_params,
                cfg.replace(sdf_res=rc - 1), 0, rc ** 3, folded=fold
            ).float().reshape(rc, rc, rc)
        _, cell_ids, count = _band_cull(
            vol_c, sdf_params, rc, cfg.band_factor, cfg,
            mode="sign" if cfg.binary else "band", max_cells=max_cells)
    return embedding, endpoints, vol_c, cell_ids, count


def boundary_cells(cell_ids: torch.Tensor, c: int,
                   count: torch.Tensor | None = None) -> torch.Tensor:
    """0-d count of the coarse cells in `cell_ids` (of a c^3 grid) on the
    + boundary layer, whose fine cells reach the planes no cell owns; with
    `count`, over the first count slots of a padded list."""
    ids = cell_ids.long()
    edge = ((ids % c == c - 1) | ((ids // c) % c == c - 1)
            | (ids // (c * c) == c - 1))
    if count is not None:
        edge = edge & (torch.arange(ids.shape[0], device=ids.device) < count)
    return edge.sum()


def finish(params: Params, endpoints: dict, vol_c: torch.Tensor,
           cell_ids: torch.Tensor, trans_mat: torch.Tensor,
           sdf_params: torch.Tensor, cfg: Config,
           embedding: torch.Tensor | None = None,
           count: torch.Tensor | None = None, n_kcells: int | None = None,
           planes: bool | None = None) -> torch.Tensor:
    """Fine pass over exactly the active cells (the kernel, or the plain
    decode of their points, which reads `embedding` on the arms that need
    it) + far-field fill + boundary planes -> the [R,R,R] f32 volume.

    With `count`, `n_kcells` and `planes` the shapes are fixed and nothing
    waits for the card (port of the n_blocks form of the JAX package's
    _sparse_parts finish): cell_ids is phase_a's padded list and count its
    0-d count; the first n_kcells cells are decoded, the values of the
    slots at or past count go to an extra last element, dropped, and the
    boundary planes are decoded when `planes` says so (the JAX function's
    cond on the boundary cells, which the caller predicts). Where n_kcells
    covers count and `planes` is boundary_cells(..) > 0, the volume is the
    exact form's bit for bit."""
    fold, fine_kernel, _ = _folds(cfg)
    fine_r = cfg.grid_resolution
    c = vol_c.shape[0] - 1
    fixed = count is not None
    kcells = cell_ids[:n_kcells] if fixed else cell_ids
    vol = _upsample_aligned(vol_c, STRIDE).reshape(-1)
    if fixed:
        vol = torch.cat([vol, vol.new_zeros(1)])
    if kcells.shape[0]:
        pts, flats = fused._cell_points(kcells, c, fine_r, sdf_params)
        if fine_kernel:
            vals = fused.decode_cells(params, endpoints, trans_mat,
                                      sdf_params, kcells, cfg,
                                      fine_r=fine_r, coarse_c=c)
        else:
            vals = dense_mod.decode_points(params, endpoints, embedding,
                                           trans_mat, pts, cfg, folded=fold)
        if fixed:
            k = STRIDE ** 3
            slot = torch.arange(flats.shape[0], device=flats.device) // k
            vol.scatter_(0, torch.where(slot < count, flats, fine_r ** 3),
                         vals.float())
        else:
            vol[flats] = vals.float()
    if fixed:
        vol = vol[:fine_r ** 3]
    else:
        # exact plane values only matter inside ACTIVE boundary-layer
        # cells: inactive cells have no crossings and sign-safe
        # interpolation
        planes = bool(boundary_cells(cell_ids, c))
    if planes:
        fused.decode_planes(params, endpoints, trans_mat, sdf_params, fine_r,
                            cfg, vol, embedding=embedding, folded=fold)
    return vol.reshape(fine_r, fine_r, fine_r)


def phase_b_mesh(params: Params, endpoints: dict, vol_c: torch.Tensor,
                 cell_ids: torch.Tensor, trans_mat: torch.Tensor,
                 sdf_params: torch.Tensor, cfg: Config, iso: float,
                 stats: dict | None = None,
                 embedding: torch.Tensor | None = None,
                 count: torch.Tensor | None = None,
                 n_kcells: int | None = None, bcap: int | None = None,
                 planes: bool | None = None):
    """`finish`, then the mesh extractor's candidate scan on the volume it
    built, limited to the blocks of the active coarse cells. Returns (vol,
    ids [n] int32 fine sign-change cells, n, guard, blk); see
    marching._active_cells_from_coarse. `stats` receives ``phase_b_ms`` and
    ``scan_ms``.

    With `count`, `n_kcells`, `bcap` and `planes` the shapes are fixed and
    nothing waits for the card (port of _phase_b_mesh_jit): finish's fixed
    form, then the scan's at bcap. Returns (vol, ids [b2*64], n, guard,
    gov, blk [b2,3], n_boundary), the counts 0-d on the card; n_boundary
    (boundary_cells over the whole padded list, so that a bucket too small
    to cover the active cells cannot hide one) says whether the planes
    were due."""
    dev = sdf_params.device
    fixed = count is not None
    with device_mod.stage(stats, "phase_b_ms", dev):
        vol = finish(params, endpoints, vol_c, cell_ids, trans_mat,
                     sdf_params, cfg, embedding=embedding, count=count,
                     n_kcells=n_kcells, planes=planes)
    with device_mod.stage(stats, "scan_ms", dev):
        if not fixed:
            scan = marching._active_cells_from_coarse(vol, cell_ids, iso,
                                                      stride=STRIDE)
            return (vol, *scan)
        scan = marching._active_cells_from_coarse(
            vol, cell_ids, iso, stride=STRIDE, count=count, bcap=bcap)
        n_boundary = boundary_cells(cell_ids, vol_c.shape[0] - 1, count)
    return (vol, *scan, n_boundary)


def words_eligible(cfg: Config) -> bool:
    """The sparse-words flow's configs: those whose fine pass runs the
    fused kernel (fused.kernel_enabled on the fold='137' path: twostream +
    tf1, stride 4, R - 1 a multiple of it, 137^2 images, fused_kernel not
    'off'; K5 reads the kernel's rows) on a grid of R - 1 >= 48, the
    grids the JAX package's words flow serves."""
    return (cfg.grid_resolution - 1 >= 48
            and fused.kernel_enabled(cfg, dense_mod.normalize_fold(None, cfg),
                                     cfg.sparse_stride, cfg.grid_resolution,
                                     strict=False))


def phase_b_mesh_sparse(params: Params, endpoints: dict, vol_c: torch.Tensor,
                        cell_ids: torch.Tensor, trans_mat: torch.Tensor,
                        sdf_params: torch.Tensor, cfg: Config, iso: float,
                        stats: dict | None = None,
                        count: torch.Tensor | None = None,
                        n_kcells: int | None = None,
                        bcap: int | None = None):
    """The sparse-words flow: K1 over the active cells, K5 on its rows, and
    the compaction, with no volume. Returns (words [2|4, n_cells*64] int32,
    sids [n] int32 sparse row ids, n, guard, blk [b,3] int32); blk and n
    equal phase_b_mesh's when guard is 0. guard adds to K5's guard the
    active cells on the + boundary layer, which the words' patch model
    leaves out; when it is not 0 the caller must take phase_b_mesh.
    `stats` receives ``phase_b_ms`` (K1 + K5) and ``scan_ms`` (the
    compaction).

    With `count`, `n_kcells` and `bcap` the shapes are fixed and nothing
    waits for the card (port of _phase_b_mesh_sparse_jit): cell_ids is
    phase_a's padded list (max_cells) and count its 0-d count; K1 decodes
    the first n_kcells cells (the predicted bucket, padding included), K5
    takes min(count, n_kcells) on the card, the boundary cells are counted
    over the whole list (slot < count), so that a bucket too small to cover
    the active cells cannot hide one, and the compaction runs at bcap
    (marching._compact_block_bits). Returns (words, sids [b2*64], n 0-d,
    gov 0-d, blk [b2,3], guard 0-d), all on the card: gov is guard plus the
    compaction's overflow."""
    dev = sdf_params.device
    fine_r = cfg.grid_resolution
    c = vol_c.shape[0] - 1
    fixed = count is not None
    cells = cell_ids.int().contiguous()
    kcells = cells[:n_kcells] if fixed else cells
    with device_mod.stage(stats, "phase_b_ms", dev):
        vals = fused.decode_cells(params, endpoints, trans_mat, sdf_params,
                                  kcells, cfg, fine_r=fine_r, coarse_c=c)
        words, bits, cand, own_tbl, guard = sparse_words.sparse_cell_words(
            vals.contiguous(), kcells,
            count.clamp(max=n_kcells) if fixed else kcells.shape[0],
            vol_c.contiguous(), R=fine_r, iso=iso)
    with device_mod.stage(stats, "scan_ms", dev):
        guard = (guard + boundary_cells(cells, c, count)).int()
        if fixed:
            sids, n, gov, blk = marching._compact_block_bits(
                bits, cand, fine_r, srow_tbl=own_tbl, bcap=bcap, guard=guard)
            return words, sids, n, gov, blk, guard
        sids, n, blk = marching._compact_block_bits(bits, cand, fine_r,
                                                    srow_tbl=own_tbl)
        guard = int(guard)
    return words, sids, n, guard, blk


def sparse_volume(params: Params, img, trans_mat, sdf_params, cfg: Config,
                  device: str | torch.device | None = None,
                  stats: dict | None = None, scan_iso: float | None = None):
    """Image -> ([R,R,R] f32 volume on `device`, scan) through the two-level
    sparse pass, or the exact dense path when the active cells overflow the
    cap (cell_cap). The band width and the cap come from cfg.band_factor
    and cfg.cell_cap_frac. With `scan_iso` the sparse pass ends in
    phase_b_mesh and scan is its (ids, n, guard, blk); otherwise, and after
    the dense fallback, scan is None. (The sparse-words flow, which makes
    no volume, runs from phase_a in infer/pipeline.)

    Binary heads take the sign cull (_active_cells mode 'sign'), a
    heuristic: a feature thinner than ~2 coarse cells that flips no
    coarse corner's sign is missed. THREEDCNN raises (it decodes a fixed
    volume).

    `stats`, when given, receives per-stage wall times (``*_ms``, each
    stage synchronised), ``active_cells`` and ``dense_fallback``."""
    if cfg.sdf_res % STRIDE:
        raise ValueError(f"stride {STRIDE} must divide sdf_res "
                         f"{cfg.sdf_res}")
    if cfg.variant is Variant.THREEDCNN:
        raise ValueError("THREEDCNN decodes a fixed volume; use "
                         "pipeline.predict_volume")
    fold = _folds(cfg)[0]  # fused_kernel='on' on an ineligible grid raises
    dev = device_mod.resolve(device)
    params = device_mod.tree_to(params, dev)
    img_t, trans, sdfp = dense_mod.as_inputs(img, trans_mat, sdf_params, dev)
    embedding, endpoints, vol_c, cell_ids, count = phase_a(
        params, img_t, trans, sdfp, cfg, stats)
    overflow = count > cell_cap(cfg)
    if stats is not None:
        stats["active_cells"] = count
        stats["dense_fallback"] = overflow
    if overflow:
        with device_mod.stage(stats, "dense_fallback_ms", dev):
            return dense_mod.dense_volume(params, endpoints, embedding,
                                          trans, sdfp, cfg, fold), None
    if scan_iso is not None:
        vol, *scan = phase_b_mesh(params, endpoints, vol_c, cell_ids, trans,
                                  sdfp, cfg, float(scan_iso), stats,
                                  embedding=embedding)
        return vol, tuple(scan)
    with device_mod.stage(stats, "phase_b_ms", dev):
        return finish(params, endpoints, vol_c, cell_ids, trans, sdfp,
                      cfg, embedding=embedding), None


def sparse_volume_sharded(params: Params, img, trans_mat, sdf_params,
                          cfg: Config, mesh,
                          device: str | torch.device | None = None,
                          stats: dict | None = None):
    """The sparse pass striped over a points-only parallel.Mesh (port of
    make_sharded_sparse_fn) -> (vol [R,R,R] f32 on every rank, count, esc,
    cap). vol is None when count > cap: the caller takes the dense path.
    esc is always 0 (the kernel has no escapes); it stands where the JAX
    function returns the kernel's.

    Every rank runs phase_a, then takes the mesh's first rank's coarse
    grid, active cells and count (a broadcast): the stripes must not depend
    on every card rounding alike. The cap is the JAX function's: cell_cap
    rounded up so that its blocks divide over the ranks. Rank j decodes its
    contiguous share of the `count` active cells (fused.decode_cells
    through the kernel where kernel_enabled allows it, the plain decode
    otherwise) and its share of the boundary planes when an active cell
    touches them (as `finish` does; the JAX function decodes the planes
    whatever the cells). The JAX function's stripes are fixed runs of
    blocks of its padded cap buffer, since its shapes are static and every
    device decodes its whole stripe, valid or not; with exact counts those
    runs would leave every rank but the first idle below half the cap
    (17,888 active cells of 65,536 on the main path), so the active cells
    split evenly instead, which changes no value. Every rank gathers the
    stripes and scatters them into the upsampled coarse grid. `stats`
    receives ``active_cells``, ``stripe_cells`` (this rank's),
    ``stripe_ms`` (its fine decode) and ``gather_ms`` besides phase_a's
    stages."""
    from disn_tpu_torch import parallel

    if mesh.shape[parallel.DATA_AXIS] > 1:
        raise ValueError("use a points-only mesh for sparse inference")
    if cfg.sdf_res % STRIDE:
        raise ValueError(f"stride {STRIDE} must divide sdf_res "
                         f"{cfg.sdf_res}")
    if cfg.variant is Variant.THREEDCNN:
        raise ValueError("THREEDCNN decodes a fixed volume; use "
                         "pipeline.predict_volume")
    fold, fine_kernel, _ = _folds(cfg)
    dev = device_mod.resolve(device)
    params = device_mod.tree_to(params, dev)
    img_t, trans, sdfp = dense_mod.as_inputs(img, trans_mat, sdf_params, dev)
    embedding, endpoints, vol_c, cell_ids, _ = phase_a(
        params, img_t, trans, sdfp, cfg, stats)
    vol_c = parallel.broadcast(vol_c, mesh)
    cell_ids = parallel.broadcast(cell_ids, mesh)
    count = int(cell_ids.shape[0])
    n = mesh.shape[parallel.POINT_AXIS]
    j = mesh.coords[1]
    cpb = _cap_block(cfg)[1]
    cap = -(-(cell_cap(cfg) // cpb) // n) * cpb * n
    if stats is not None:
        stats["active_cells"] = count
    if count > cap:
        return None, count, 0, cap
    fine_r = cfg.grid_resolution
    c = vol_c.shape[0] - 1
    mine = cell_ids[slice(*parallel.share(count, n, j))]
    with device_mod.stage(stats, "stripe_ms", dev):
        pts, flats = fused._cell_points(mine, c, fine_r, sdfp)
        if not mine.shape[0]:
            vals = torch.zeros(0, device=dev)
        elif fine_kernel:
            vals = fused.decode_cells(params, endpoints, trans, sdfp, mine,
                                      cfg, fine_r=fine_r, coarse_c=c)
        else:
            vals = dense_mod.decode_points(params, endpoints, embedding,
                                           trans, pts, cfg, folded=fold)
    vals, flats = [vals.float()], [flats.long()]
    ids = cell_ids.long()
    if bool(((ids % c == c - 1) | ((ids // c) % c == c - 1)
             | (ids // (c * c) == c - 1)).any()):
        ppts, pflats = fused.plane_points(fine_r, sdfp)
        lo, hi = parallel.share(ppts.shape[0], n, j)
        vals.append(dense_mod.decode_points(
            params, endpoints, embedding, trans, ppts[lo:hi], cfg,
            folded=fold, block=fused.PLANE_BLOCK).float())
        flats.append(pflats[lo:hi].long())
    with device_mod.stage(stats, "gather_ms", dev):
        vals = parallel.gather(torch.cat(vals), mesh, mesh.points_group)
        flats = parallel.gather(torch.cat(flats), mesh, mesh.points_group)
    vol = _upsample_aligned(vol_c, STRIDE).reshape(-1)
    vol[flats] = vals
    if stats is not None:
        stats["stripe_cells"] = int(mine.shape[0])
    return vol.reshape(fine_r, fine_r, fine_r), count, 0, cap


def sparse_dense_sdf(params: Params, img, trans_mat, sdf_params,
                     cfg: Config,
                     device: str | torch.device | None = None,
                     stats: dict | None = None) -> torch.Tensor:
    """sparse_volume's volume alone."""
    return sparse_volume(params, img, trans_mat, sdf_params, cfg,
                         device=device, stats=stats)[0]

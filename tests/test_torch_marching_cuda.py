"""The extraction family on the card against the same code on the CPU, on
fields that the smoke run's octahedron never gives it: surfaces cut by the
high faces of the box (ghost cells, suppressed edges), noise, and a grid
whose spacing is inexact in f32. Needs an NVIDIA GPU; skips without one.
Imports nothing of JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_marching_cuda.py
"""
import numpy as np
import pytest
import torch

from disn_tpu_torch.infer import sparse
from disn_tpu_torch.ops import marching as m

BOX = np.array([-0.3, -1, -2, 0.9, 1, 2], np.float32)
CASES = [("sphere", 49), ("boundary", 33), ("box_cut", 49), ("plane", 17),
         ("noise", 17), ("sphere", 129)]


def field(name: str, R: int) -> np.ndarray:
    lin = np.linspace(-1, 1, R, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    if name == "sphere":
        v = np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6
    elif name == "boundary":
        v = np.sqrt(x ** 2 + y ** 2 + z ** 2) - 1.3
    elif name == "box_cut":
        v = np.maximum(np.maximum(np.abs(x - 0.5) - 0.6,
                                  np.abs(y - 0.4) - 0.7),
                       np.abs(z - 0.5) - 0.65)
    elif name == "plane":
        v = z - 0.1
    else:
        v = np.random.RandomState(3).randn(R, R, R)
    return np.ascontiguousarray(v, np.float32)


def both(name, R):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    vol = torch.from_numpy(field(name, R))
    return vol, vol.cuda(), torch.from_numpy(BOX), torch.from_numpy(BOX).cuda()


def coarse_ids(vol: torch.Tensor) -> torch.Tensor:
    coarse = vol[::4, ::4, ::4].contiguous()
    tau = 1.5 * float(np.sqrt(3.0)) * 2.0 / (coarse.shape[0] - 1)
    return sparse._active_cells(coarse, torch.tensor(tau, device=vol.device))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name,R", CASES)
def test_scans_extractor_and_records_equal_the_cpu_run(name, R):
    """Every output bit for bit: ids, block rows, guard, records, faces,
    and the vertices too (IEEE f32 on both sides, no fused operations)."""
    vol, vol_d, box, box_d = both(name, R)
    ids, n = m._active_cells_ext(vol, 0.0)
    ids_d, n_d = m._active_cells_ext(vol_d, 0.0)
    assert n_d == n > 0 and torch.equal(ids_d.cpu(), ids)
    cand = m._active_cells_from_coarse(vol, coarse_ids(vol), 0.0)
    cand_d = m._active_cells_from_coarse(vol_d, coarse_ids(vol_d), 0.0)
    assert cand_d[1:3] == cand[1:3]
    assert torch.equal(cand_d[0].cpu(), cand[0])
    assert torch.equal(cand_d[3].cpu(), cand[3])
    v, f = m._extract_owned(vol, box, ids, 0.0)
    v_d, f_d = m._extract_owned(vol_d, box_d, ids_d, 0.0)
    assert torch.equal(f_d.cpu(), f) and torch.equal(v_d.cpu(), v)
    rec, tq = m._extract_records(vol, ids, 0.0)
    rec_d, tq_d = m._extract_records(vol_d, ids_d, 0.0)
    assert torch.equal(rec_d.cpu(), rec) and torch.equal(tq_d.cpu(), tq)
    assert torch.equal(m._compact_tq(rec_d, tq_d).cpu(),
                       m._compact_tq(rec, tq))


@pytest.mark.cuda
@pytest.mark.parametrize("name,R", [c for c in CASES if c[0] != "noise"])
def test_routes_agree_on_the_card(name, R):
    """Entry points with no device named: the record route's faces are the
    owned route's and its vertices within the quantisation step; the owned
    mesh equals marching_tets + weld as vertex and triangle sets."""
    _, vol_d, _, _ = both(name, R)
    ids, n, guard, blk = m._active_cells_from_coarse(vol_d,
                                                     coarse_ids(vol_d), 0.0)
    assert guard == 0
    ov, of_ = m.extract_mesh_owned(vol_d, BOX)
    iv, if_ = m.extract_mesh_from_ids(vol_d, BOX, ids)
    assert np.array_equal(iv, ov) and np.array_equal(if_, of_)
    rv, rf = m.extract_mesh_records(vol_d, BOX, ids, n, blk=blk)
    assert np.array_equal(rf, of_)
    step = 4.0 / (R - 1) / (510 if R >= 129 else 131070)
    assert np.abs(rv - ov).max() <= step + 2e-6
    tv, tf_ = m.extract_mesh(vol_d, BOX)
    assert len(tv) == len(ov) and len(tf_) == len(of_)
    for a, b in zip((np.sort(ov, axis=0), np.sort(np.sort(
            ov[of_].reshape(-1, 9), axis=1), axis=0)),
            (np.sort(tv, axis=0), np.sort(np.sort(
                tv[tf_].reshape(-1, 9), axis=1), axis=0))):
        assert np.abs(a - b).max() <= 2e-6

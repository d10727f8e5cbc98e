"""The volume flow's speculative dispatch on the card: a warm volume-flow
_fused_dispatch issues no synchronising call and hits, and the fixed-shape
owned extractor and candidate scan equal the exact ones bit for bit at
257^3. Needs an NVIDIA GPU and nvcc; skips without them. Imports nothing
of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_volume_spec_cuda.py
"""
import numpy as np
import pytest
import torch

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sdf_res", [64, 32])
def test_warm_volume_dispatch_never_synchronises(card, sdf_res,
                                                 monkeypatch):
    """A full-width bf16 analytic head on the volume flow (sdf_res 64: no
    boundary planes; 32: the planes): after the seed and a warm image,
    _fused_dispatch runs under set_sync_debug_mode("error") (any
    synchronising call raises), the collect is a hit, and its mesh is the
    seed path's bit for bit."""
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline

    monkeypatch.setattr(pipeline, "_SWORDS_SKIP", set())
    monkeypatch.setattr(pipeline, "_SPEC_CACHE", {})
    cfg = Config(sdf_res=sdf_res, compute_dtype="bfloat16",
                 cell_cap_frac=0.9, sparse_words=False)
    params = synthetic.analytic_octahedron_params(cfg, r=0.25)
    img = np.random.RandomState(0).randint(0, 256, (137, 137, 3),
                                           dtype=np.uint8)
    trans = synthetic.demo_trans_mat()
    seed = pipeline.image_to_mesh(params, img, trans, cfg)
    pipeline.image_to_mesh(params, img, trans, cfg)  # warm
    planes = pipeline._SPEC_CACHE[pipeline._vkey(cfg, cfg.iso)][6]
    assert planes == (sdf_res == 32)
    torch.cuda.synchronize()
    before = pipeline.spec_counts["hit"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        ctx = pipeline._fused_dispatch(params, img, trans, BOX, cfg, cfg.iso)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    v, f = pipeline._collect_or_dense(ctx)
    assert pipeline.spec_counts["hit"] == before + 1
    assert len(f) > 500
    np.testing.assert_array_equal(f, seed[1])
    np.testing.assert_array_equal(v, seed[0])


def _octahedron(R, r, device):
    """A [R,R,R] field |x|+|y|+|z| - r (z, y, x) on `device`, its coarse
    band's cell ids (a corner within one coarse cell's diagonal of the
    surface) and their count."""
    lin = torch.linspace(-1, 1, R, device=device)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    vol = (x.abs() + y.abs() + z.abs() - r).contiguous()
    c = (R - 1) // 4
    vc = vol[::4, ::4, ::4]
    corners = torch.stack([vc[dz:dz + c, dy:dy + c, dx:dx + c]
                           for dz in (0, 1) for dy in (0, 1)
                           for dx in (0, 1)])
    near = corners.abs().amin(0) < 2.0 / c * 3 ** 0.5
    ids = torch.nonzero(near.reshape(-1))[:, 0].int()
    return vol, ids


@pytest.mark.cuda
def test_fixed_scan_and_extractor_equal_the_exact_ones_at_257(card):
    """At 257^3 on the card: the candidate scan's fixed form (padded coarse
    ids, the count on the card, bcap for twice the candidates) equals the
    exact scan on the first n ids and the masked rows, with guard and gov
    0; the fixed owned extractor over the slots that cover n equals
    _extract_owned on those ids bit for bit on the first nv / ntri rows,
    zero past them, no owner missing."""
    from disn_tpu_torch.ops import marching as m

    vol, cids = _octahedron(257, 0.6, card)
    box = torch.from_numpy(BOX).to(card)
    count = cids.shape[0]
    padded = torch.zeros(count + 777, dtype=torch.int32, device=card)
    padded[:count] = cids
    ids, n, guard, gov, blk = m._active_cells_from_coarse(
        vol, padded, 0.0, count=torch.tensor(count, dtype=torch.int32,
                                             device=card),
        bcap=2 * count + 1024)
    eids, en, eguard, eblk = m._active_cells_from_coarse(vol, cids, 0.0)
    assert eguard == 0 and int(guard) == 0 and int(gov) == 0
    assert int(n) == en > 50000
    assert torch.equal(ids[:en], eids)
    assert torch.equal(blk[:eblk.shape[0]], eblk)
    assert not blk[eblk.shape[0]:].any()
    batch = 4096
    n_iter = -(-en // batch)
    verts, nv, faces, ntri, missing = m._extract_owned_fixed(
        vol, box, ids, n, 0.0, n_iter, batch)
    ev, ef = m._extract_owned(vol, box, eids, 0.0)
    assert int(missing) == 0
    assert int(nv) == ev.shape[0] and int(ntri) == ef.shape[0] > 100000
    assert torch.equal(verts[:int(nv)], ev)
    assert torch.equal(faces[:int(ntri)], ef)
    assert not verts[int(nv):].any() and not faces[int(ntri):].any()

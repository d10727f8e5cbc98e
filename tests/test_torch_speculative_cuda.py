"""The speculative dispatch on the card: a warm _fused_dispatch issues no
synchronising call, K5 takes its count from the device bit for bit as its
plain version does, and the page-locked uploads land the bytes sent. Needs
an NVIDIA GPU and nvcc; skips without them. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_speculative_cuda.py
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


@pytest.fixture
def words_net(card, monkeypatch):
    """A full-width bf16 analytic head at sdf_res 64 whose images take the
    sparse-words flow, a seeded u8 image, and no prediction yet."""
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline

    monkeypatch.setattr(pipeline, "_SWORDS_SKIP", set())
    monkeypatch.setattr(pipeline, "_SPEC_CACHE", {})
    cfg = Config(sdf_res=64, compute_dtype="bfloat16", cell_cap_frac=0.9)
    params = synthetic.analytic_octahedron_params(cfg, r=0.25)
    img = np.random.RandomState(0).randint(0, 256, (137, 137, 3),
                                           dtype=np.uint8)
    return cfg, params, img


@pytest.mark.cuda
def test_warm_dispatch_never_synchronises(words_net):
    """With a prediction, _fused_dispatch runs under
    set_sync_debug_mode("error") (any synchronising call raises), and the
    collect gives the seed path's mesh bit for bit."""
    from disn_tpu_torch.infer import pipeline

    cfg, params, img = words_net
    seed = pipeline.image_to_mesh(params, img, synthetic_trans(), cfg)
    pipeline.image_to_mesh(params, img, synthetic_trans(), cfg)  # warm
    torch.cuda.synchronize()
    before = pipeline.spec_counts["hit"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        ctx = pipeline._fused_dispatch(params, img, synthetic_trans(), BOX,
                                       cfg, cfg.iso)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    v, f = pipeline._collect_or_dense(ctx)
    assert pipeline.spec_counts["hit"] == before + 1
    assert len(f) > 1000
    np.testing.assert_array_equal(f, seed[1])
    np.testing.assert_array_equal(v, seed[0])


def synthetic_trans():
    from disn_tpu_torch.data import synthetic

    return synthetic.demo_trans_mat()


def _random_words(R, nk, count, seed):
    c = (R - 1) // 4
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.choice(c ** 3, nk, replace=False)).astype(np.int32)
    ids[count:] = 0
    rows = (0.3 * rng.randn(nk * 64)).astype(np.float32)
    rows[rng.rand(nk * 64) < 0.05] = 0.0
    vol_c = (0.3 * rng.randn(c + 1, c + 1, c + 1)).astype(np.float32)
    card = torch.device("cuda")
    return (torch.from_numpy(rows).to(card), torch.from_numpy(ids).to(card),
            torch.from_numpy(vol_c).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["main path", "padded bucket"])
def test_k5_count_on_the_card_equals_its_plain_version(card, words_net,
                                                       source):
    """K5 with a 0-d int32 count on the card against the plain version:
    on the main path's inputs (a hit's fine pass: its padded bucket and
    the count phase_a left on the card) and on random inputs padded past
    the count (and a count past the cells, which both clamp)."""
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.ops import marching as m
    from disn_tpu_torch.ops import sparse_words as sw

    if source == "main path":
        cfg, params, img = words_net
        pipeline.image_to_mesh(params, img, synthetic_trans(), cfg)  # seed
        sw.sparse_cell_words.inputs = []
        try:
            pipeline.image_to_mesh(params, img, synthetic_trans(), cfg)
            (args, kw), = sw.sparse_cell_words.inputs
        finally:
            sw.sparse_cell_words.inputs = None
        assert torch.is_tensor(args[2]) and args[2].is_cuda
        assert int(args[2]) < args[1].numel()  # the bucket is padded
        cases = [(args, kw)]
    else:
        # ids past 1637 are the padding (cell 0); a count past it needs
        # distinct ids, as every valid cell must be distinct
        padded = _random_words(257, 2000, 1637, seed=1)
        full = _random_words(257, 2000, 2000, seed=2)
        cases = [((w[0], w[1], torch.tensor(n, dtype=torch.int32,
                                            device=card), w[2]),
                  dict(R=257, iso=0.0))
                 for w, n in ((padded, 1637), (padded, 0), (full, 2000),
                              (full, 2600))]
    for args, kw in cases:
        got = sw.sparse_cell_words(*args, **kw)
        want = m._sparse_cell_words(*args, kw["R"], kw["iso"])
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_pinned_uploads_land_the_bytes_sent(words_net, monkeypatch):
    """50 speculative dispatches back to back, each with another image,
    camera and box, whose arrays the caller overwrites at once: every
    upload (through a fresh page-locked buffer, nothing waiting for its
    copy) holds on the card exactly the bytes sent, and every dispatch
    collects to a mesh."""
    from disn_tpu_torch.infer import dense, pipeline

    cfg, params, img = words_net
    pipeline.image_to_mesh(params, img, synthetic_trans(), cfg)  # seed
    uploads = []
    real = dense.as_inputs
    monkeypatch.setattr(dense, "as_inputs",
                        lambda *a: uploads.append(real(*a)) or uploads[-1])
    rng = np.random.RandomState(7)
    sent, ctxs = [], []
    for i in range(50):
        im = rng.randint(0, 256, (137, 137, 3), dtype=np.uint8)
        tr = (synthetic_trans() * (1 + i / 100)).astype(np.float32)
        box = (BOX * (1 + i / 1000)).astype(np.float32)
        sent.append((im.copy(), tr.copy(), box.copy()))
        ctxs.append(pipeline._fused_dispatch(params, im, tr, box, cfg,
                                             cfg.iso))
        im[:] = 0
        tr[:] = 0
        box[:] = 0
    torch.cuda.synchronize()
    assert len(uploads) == 50
    for (im, tr, box), (a, b, c) in zip(sent, uploads):
        assert a.is_cuda and a.dtype == torch.uint8
        np.testing.assert_array_equal(a[0].cpu().numpy(), im)
        np.testing.assert_array_equal(b.cpu().numpy(), tr)
        np.testing.assert_array_equal(c.cpu().numpy(), box)
    for ctx in ctxs:
        assert len(pipeline._collect_or_dense(ctx)[1]) > 1000

"""The farm's deferred closures on the card: they hold no CUDA tensor,
issue no device operation, and give image_to_mesh's mesh; the farm runs
the host assembly on its pool, never on the calling thread (the count
chip_smoke.py's [farm pipe] gates). Needs an NVIDIA GPU and nvcc; skips
without them. Imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_farm_cuda.py
"""
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

BOX = np.array([-1, -1, -1, 1, 1, 1], np.float32)
# device work that a closure must not start (it may wait on its event)
DEVICE_CALLS = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemcpy",
                "cudaMemsetAsync", "cudaMalloc", "cudaStreamSynchronize",
                "cudaDeviceSynchronize")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture
def words_net(card, monkeypatch):
    """A full-width bf16 analytic head at sdf_res 64 whose images take the
    sparse-words flow, and a seeded u8 image."""
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline

    monkeypatch.setattr(pipeline, "_SWORDS_SKIP", set())
    cfg = Config(sdf_res=64, compute_dtype="bfloat16", cell_cap_frac=0.9)
    params = synthetic.analytic_octahedron_params(cfg, r=0.25)
    img = np.random.RandomState(0).randint(0, 256, (137, 137, 3),
                                           dtype=np.uint8)
    return cfg, params, img


def chip_smoke():
    """The repository's chip_smoke.py as a module (its PassSpy)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cuda_tensors(obj, seen=None) -> list:
    """Every CUDA tensor reachable from obj through closures, defaults,
    containers, objects' attributes and numpy arrays' bases."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if torch.is_tensor(obj):
        return [obj] if obj.is_cuda else []
    found = []
    if isinstance(obj, types.FunctionType):
        parts = [c.cell_contents for c in (obj.__closure__ or ())]
        parts += list(obj.__defaults__ or ()) + list(
            (obj.__kwdefaults__ or {}).values())
    elif isinstance(obj, dict):
        parts = list(obj.values())
    elif isinstance(obj, (list, tuple, set)):
        parts = list(obj)
    elif isinstance(obj, np.ndarray):
        parts = [obj.base]
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        parts = list(vars(obj).values())
    else:
        parts = []
    for p in parts:
        found += cuda_tensors(p, seen)
    return found


def device_calls(fn):
    """fn() under torch.profiler -> (its result, the runtime calls of
    DEVICE_CALLS made inside fn's own window; the profiler's start and
    stop make calls of their own outside it)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("closure under test"):
            out = fn()
    events = prof.events()
    win = next(e.time_range for e in events
               if e.name == "closure under test")
    bad = [e.name for e in events if e.name in DEVICE_CALLS
           and win.start <= e.time_range.start
           and e.time_range.end <= win.end]
    return out, bad


@pytest.mark.cuda
@pytest.mark.parametrize("join", [True, False])
def test_collect_closure_holds_no_cuda_tensor(words_net, join):
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline

    cfg, params, img = words_net
    trans = synthetic.demo_trans_mat()
    stats = {}
    want = pipeline.image_to_mesh(params, img, trans, cfg, stats=stats)
    assert stats["route"] == "records_sparse"
    ctx = pipeline._fused_dispatch(params, img, trans, BOX, cfg, cfg.iso,
                                   join=join)
    fin = pipeline._fused_collect(ctx, defer=True)
    assert not cuda_tensors(fin) and not cuda_tensors(ctx)
    (v, f), bad = device_calls(fin)
    assert not bad, bad
    np.testing.assert_array_equal(f, want[1])
    np.testing.assert_array_equal(v, want[0])


@pytest.mark.cuda
def test_record_closures_hold_no_cuda_tensor(card):
    from disn_tpu_torch.ops import marching

    lin = torch.linspace(-1, 1, 65, device=card)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    vol = torch.sqrt(x * x + y * y + z * z) - 0.6
    ids_c = torch.arange(16 ** 3, dtype=torch.int32, device=card)
    ids, n, _, blk = marching._active_cells_from_coarse(vol, ids_c, 0.0)
    for kw in ({"blk": blk}, {}):
        want = marching.extract_mesh_records(vol, BOX, ids, n, **kw)
        fin = marching.extract_mesh_records_deferred(vol, BOX, ids, n,
                                                     join=False, **kw)
        assert not cuda_tensors(fin)
        (v, f), bad = device_calls(fin)
        assert not bad, bad
        np.testing.assert_array_equal(f, want[1])
        np.testing.assert_array_equal(v, want[0])


@pytest.mark.cuda
def test_farm_assembles_off_the_calling_thread(words_net, tmp_path):
    """[farm pipe]'s count: the C++ passes run 3 times an image, all on
    the pool, at depth 1 and 2."""
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.data import listing, synthetic
    from disn_tpu_torch.infer import pipeline

    cfg, params, img = words_net
    paths = listing.SplitPaths(str(tmp_path / "sdf"),
                               str(tmp_path / "renders"))
    rec = codecs.ViewRecord(img_arr=img, trans_mat=synthetic.demo_trans_mat(),
                            K=np.eye(3, dtype=np.float32),
                            RT=np.zeros((3, 4), np.float32),
                            obj_rot_mat=np.eye(3, dtype=np.float32),
                            regress_mat=np.zeros((4, 3), np.float32))
    listinfo = [("c", "o", v) for v in range(3)]
    spy = chip_smoke().PassSpy()
    try:
        for depth in (1, 2):
            spy.reset()
            written = pipeline.reconstruct_split(
                params, cfg, paths, listinfo, str(tmp_path / f"d{depth}"),
                depth=depth, read_view=lambda p: rec,
                read_sdf_params=lambda p: BOX)
            assert len(written) == 3
            assert spy.main_calls == 0 and spy.pool_calls == 9
    finally:
        spy.close()

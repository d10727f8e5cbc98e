"""The port's train-time visual dump (`train --dump-every`, utils/output)
against the JAX package's, and the `--set` forms of the other variants,
heads, samplings and decode settings through `train`, `create-sdf` and
`demo`, with device='cpu' at CI width (width_mult 0.125, 32 classes) on a
synthetic dataset tree."""
import os

import numpy as np
import pytest
import torch

import jax

from disn_tpu import cli as jcli
from disn_tpu.config import Config as JConfig
from disn_tpu.config import Variant as JVariant
from disn_tpu.models import disn as jdisn
from disn_tpu.utils import output as joutput
from disn_tpu_torch import cli, convert
from disn_tpu_torch.config import Config, Variant
from disn_tpu_torch.core import camera, codecs
from disn_tpu_torch.data import synthetic
from disn_tpu_torch.infer import pipeline
from disn_tpu_torch.train import checkpoint
from disn_tpu_torch.utils import output
from torch_threads import few_threads  # noqa: F401  (autouse)

SMALL = dict(num_classes=32, width_mult=0.125, batch_size=2,
             num_sample_points=64)
SET = [x for k, v in SMALL.items() for x in ("--set", f"{k}={v}")]


def _batch(seed=0, b=2, n=64):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.8, 0.8, (b, n, 3)).astype(np.float32)
    return {
        "img": rng.rand(b, 137, 137, 3).astype(np.float32),
        "sdf_pt": pts,
        "sdf_pt_rot": (pts @ camera.obj_rot_matrix(30.0, 20.0, 0.0)
                       ).astype(np.float32),
        "sdf_val": (np.linalg.norm(pts, axis=-1, keepdims=True) - 0.5
                    + 0.05 * rng.randn(b, n, 1)).astype(np.float32),
        "trans_mat": np.stack([synthetic.demo_trans_mat()] * b),
    }


def _read_cloud(path):
    rows = [line.split()[1:] for line in open(path) if line.startswith("v ")]
    return np.array(rows, np.float64)


def test_output_writers_match_jax(tmp_path):
    """magma, the point-cloud, bounding-box and PPM writers and
    draw_points_on_image: the same bytes as the JAX package's."""
    rng = np.random.RandomState(0)
    t = rng.rand(100)
    np.testing.assert_array_equal(output.magma(t), joutput.magma(t))
    pts = rng.randn(50, 3).astype(np.float32)
    vals = rng.randn(50).astype(np.float32)
    img = rng.rand(137, 137, 3).astype(np.float32)
    px = rng.uniform(-5, 140, (40, 2)).astype(np.float32)
    drawn = output.draw_points_on_image(img, px)
    np.testing.assert_array_equal(drawn, joutput.draw_points_on_image(img,
                                                                      px))
    colors = rng.rand(50, 3)
    for mod, d in ((output, tmp_path / "t"), (joutput, tmp_path / "j")):
        mod.save_scaled_point_cloud(str(d / "c.obj"), pts, vals)
        mod.save_colored_point_cloud(str(d / "k.obj"), pts, colors)
        mod.save_bounding_box(str(d / "b.obj"), pts.min(0), pts.max(0))
        mod.save_ppm(str(d / "i.ppm"), drawn)
        mod.save_ppm(str(d / "u.ppm"), (img * 255).astype(np.uint8))
    for name in ("c.obj", "k.obj", "b.obj", "i.ppm", "u.ppm"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


@pytest.mark.parametrize("variant,binary", [("twostream", False),
                                            ("onestream", True)])
def test_train_visual_dump_matches_jax(variant, binary, tmp_path):
    """The same files from the same params and batch: the projection PPM
    byte for byte, the point clouds' positions equal and their colours
    (magma of the min-max normalised SDF, written to 4 decimals) within
    2e-3 (the unfolded forward pass agrees to 1e-4 of its scale in f32)."""
    kw = dict(SMALL, binary=binary)
    jcfg = JConfig(**dict(kw, variant=JVariant(variant)))
    cfg = Config(**dict(kw, variant=Variant(variant)))
    jparams = jdisn.init(jcfg, jax.random.PRNGKey(2))
    params = convert.params_from_jax(jax.device_get(jparams))
    batch = _batch(3)
    jcli._train_visual_dump(str(tmp_path / "j"), 40, jcfg, jparams, batch)
    cli.train_visual_dump(str(tmp_path / "t"), 40, cfg, params,
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          torch.device("cpu"))
    names = sorted(os.listdir(tmp_path / "j" / "dumps"))
    assert names == sorted(os.listdir(tmp_path / "t" / "dumps")) == [
        "step000040_gt.obj", "step000040_pred.obj", "step000040_proj.ppm"]
    j, t = tmp_path / "j" / "dumps", tmp_path / "t" / "dumps"
    assert (t / names[2]).read_bytes() == (j / names[2]).read_bytes()
    assert (t / names[0]).read_bytes() == (j / names[0]).read_bytes()
    got, want = _read_cloud(t / names[1]), _read_cloud(j / names[1])
    assert got.shape == want.shape == (64, 6)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    np.testing.assert_allclose(got[:, 3:], want[:, 3:], atol=2e-3)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("variants_cli"))
    synthetic.build_dataset(os.path.join(root, "data"), views=2,
                            num_samples=512, grid_res=16)
    return root


def test_train_cli_dumps_and_takes_the_variant(data):
    """`train --dump-every 1 --set variant=onestream --set sampling=native
    --set tanh=true` on the CPU: every step writes its three non-empty
    files, and the checkpoint holds the onestream tree (sdfimgfeat)."""
    log = os.path.join(data, "run_onestream")
    cli.main(["train", "--device", "cpu", "--data-root",
              os.path.join(data, "data"), "--log-dir", log, *SET,
              "--set", "variant=onestream", "--set", "sampling=native",
              "--set", "tanh=true", "--set", "view_num=2", "--epochs", "1",
              "--workers", "1", "--dump-every", "1", "--log-every", "1"])
    dumps = sorted(os.listdir(os.path.join(log, "dumps")))
    steps = len(dumps) // 3
    assert steps >= 2 and dumps[:3] == [
        "step000000_gt.obj", "step000000_pred.obj", "step000000_proj.ppm"]
    assert all(os.path.getsize(os.path.join(log, "dumps", n)) > 0
               for n in dumps)
    saved = Config.load(os.path.join(log, "config.json"))
    assert (saved.variant, saved.sampling, saved.tanh) == (
        Variant.ONESTREAM, "native", True)
    tree = convert.load_npz(os.path.join(log, "latest.npz"))["params"]
    assert set(tree) == {"vgg_16", "sdfimgfeat"}


def test_set_overrides_match_jax():
    """The decode settings' --set forms give the JAX CLI's Config values."""
    pairs = ["variant=global", "binary=true", "tanh=1", "sampling=native",
             "fused_kernel=off", "binary_sparse=yes"]
    cfg = cli.apply_overrides(Config(), pairs)
    jcfg = jcli.apply_overrides(JConfig(), pairs)
    for key in ("binary", "tanh", "sampling", "fused_kernel",
                "binary_sparse"):
        assert getattr(cfg, key) == getattr(jcfg, key), key
    assert cfg.variant.value == jcfg.variant.value == "global"


@pytest.mark.parametrize("variant,sets", [
    ("onestream", ["sampling=native", "fused_kernel=off"]),
    ("global", ["binary=true", "binary_sparse=true"]),
    ("twostream", ["tanh=true", "fused_kernel=on", "sdf_res=48"])])
def test_create_sdf_and_demo_take_the_sets(data, variant, sets):
    """create-sdf and demo with --set variant=... and the decode settings
    on the CPU, from a checkpoint of that variant: every listed view's OBJ
    (one view an object) and the demo's, the demo's the mesh
    pipeline.image_to_mesh gives on the same config and params."""
    d = os.path.join(data, "data")
    base = [*SET, "--set", f"variant={variant}", "--set", "view_num=1",
            *[x for s in sets for x in ("--set", s)]]
    if not any(s.startswith("sdf_res") for s in sets):
        base += ["--set", "sdf_res=16"]
    cfg = cli.apply_overrides(Config(), base[1::2])
    ckpt = os.path.join(data, f"{variant}.npz")
    params = {k: v.numpy() for k, v in checkpoint.leaves(_params(cfg))}
    checkpoint.save(ckpt, {"params": checkpoint.unflatten(params)})
    log = os.path.join(data, f"create_{variant}")
    cli.main(["create-sdf", "--device", "cpu", "--data-root", d,
              "--restore", ckpt, "--log-dir", log, *base])
    root = pipeline.result_dir(log, cfg)
    objs = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root)
                  for f in fs)
    assert len(objs) == len(synthetic.SHAPES)
    view = os.path.join(d, "renders", synthetic.SYNTH_CAT,
                        sorted(synthetic.SHAPES)[0], "00.h5")
    out = os.path.join(data, f"demo_{variant}.obj")
    cli.main(["demo", "--device", "cpu", "--image", view, "--restore", ckpt,
              "--out", out, *base])
    rec = codecs.read_view_h5(view)
    tree = convert.load_npz(ckpt)["params"]
    v, f = pipeline.image_to_mesh(tree, rec.img_arr[:, :, :3], rec.trans_mat,
                                  cfg, device="cpu")
    lines = open(out).read().splitlines()
    assert sum(line.startswith("f ") for line in lines) == len(f)
    assert sum(line.startswith("v ") for line in lines) == len(v)


def _params(cfg):
    """A seeded net of cfg's variant whose head biases are N(0, 0.1^2)."""
    from disn_tpu_torch.models import disn
    p = disn.init(cfg, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(2)
    for scope, tree in p.items():
        if scope == "vgg_16":
            continue
        for path, leaf in checkpoint.leaves(tree):
            if path.endswith("biases"):
                leaf.copy_(0.1 * torch.randn(leaf.shape, generator=gen))
    return p

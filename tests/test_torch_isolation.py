"""disn_tpu_torch stands alone: importing every module of it loads neither
JAX (nor optax or flax) nor any module of disn_tpu, and its entry points
refuse to run on the CPU unless asked to."""
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import disn_tpu_torch

_CHECK = """
import importlib, pkgutil, sys
import disn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(disn_tpu_torch.__path__,
                                               "disn_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "optax", "flax",
                                    "disn_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_disn_tpu():
    out = subprocess.run([sys.executable, "-c", _CHECK], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20


def test_every_module_is_listed():
    """The walk above must see the kernel wrapper and the pipeline."""
    names = {m.name for m in pkgutil.walk_packages(disn_tpu_torch.__path__,
                                                   "disn_tpu_torch.")}
    assert {"disn_tpu_torch.ops.fused_decode",
            "disn_tpu_torch.infer.pipeline", "disn_tpu_torch.native",
            "disn_tpu_torch.postprocessing",
            "disn_tpu_torch.ops.marching", "disn_tpu_torch.train.trainer",
            "disn_tpu_torch.train.checkpoint",
            "disn_tpu_torch.data.pipeline", "disn_tpu_torch.cli",
            "disn_tpu_torch.eval.metrics", "disn_tpu_torch.eval.runner",
            "disn_tpu_torch.ops.voxelize", "disn_tpu_torch.core.meshes",
            "disn_tpu_torch.kernels", "disn_tpu_torch.models.posenet",
            "disn_tpu_torch.core.camera", "disn_tpu_torch.core.grids",
            "disn_tpu_torch.infer.multiview", "disn_tpu_torch.utils.output",
            "disn_tpu_torch.infer.dense", "disn_tpu_torch.infer.fused",
            "disn_tpu_torch.infer.sparse", "disn_tpu_torch.models.layers",
            "disn_tpu_torch.models.sdfnet", "disn_tpu_torch.models.encoders",
            "disn_tpu_torch.preprocessing.sdf_gen",
            "disn_tpu_torch.preprocessing.img_gen",
            "disn_tpu_torch.convert", "disn_tpu_torch.convert.tf_ckpt",
            "disn_tpu_torch.parallel", "disn_tpu_torch.parallel.mesh",
            "disn_tpu_torch.ops.mv_taps"} <= names


def test_native_bindings_load_neither_jax_nor_disn_tpu():
    """The host libraries' bindings, built and called, stand alone too."""
    code = (
        "import sys, numpy as np\n"
        "from disn_tpu_torch import native\n"
        "blk = np.array([[0, 1, 0]], np.int32)\n"
        "ids, n = native.mesh_expand_ids(blk, 9)\n"
        "assert n == 1 and ids.tolist() == [0]\n"
        "v = np.eye(3, dtype=np.float32); f = np.array([[0, 1, 2]], np.int32)\n"
        "assert native.voxelize_sat(v, f, dim=4).any()\n"
        "assert native.parse_obj(bytes(native.format_obj(v, f)))[1].tolist()"
        " == [[0, 1, 2]]\n"
        "box = np.array([-1, -1, -1, 1, 1, 1], np.float64)\n"
        "assert native.compute_distance_field(v, f, 4, box).shape == "
        "(5, 5, 5)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'disn_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("entry", ["image_to_mesh", "init", "octahedron",
                                   "extract_mesh_owned",
                                   "extract_mesh_from_ids",
                                   "extract_mesh_records", "create_state",
                                   "make_train_step", "make_eval_step",
                                   "cli_train", "reconstruct_split",
                                   "evaluate_tree", "occupancy_device",
                                   "cli_create_sdf", "cli_evaluate",
                                   "cli_evaluate_acc", "posenet_init",
                                   "make_cam_train_step", "cli_demo",
                                   "cli_train_cam", "reconstruct_multiview",
                                   "multiview_to_mesh",
                                   "multiview_sdf_sparse", "multiview_sdf",
                                   "cli_create_sdf_multi_view", "dense_sdf",
                                   "sparse_volume", "threedcnn_volume",
                                   "predict_volume_threedcnn",
                                   "init_onestream", "cli_train_dump",
                                   "cli_demo_global", "init_alexnet",
                                   "init_resnet_alpha", "generate_object",
                                   "write_object", "cli_preprocess_sdf",
                                   "image_to_mesh_sharded",
                                   "init_from_env"])
def test_entry_points_need_a_device_without_cuda(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from disn_tpu_torch import cli
    from disn_tpu_torch.config import Config, EncoderKind, Variant
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.eval import runner
    from disn_tpu_torch.infer import dense, multiview, pipeline, sparse
    from disn_tpu_torch.models import disn, posenet
    from disn_tpu_torch.ops import marching, voxelize
    from disn_tpu_torch.preprocessing import sdf_gen
    from disn_tpu_torch.train import trainer

    vol = np.ones((9, 9, 9), np.float32)
    box = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    ids = torch.zeros(0, dtype=torch.int32)
    cfg = Config(num_classes=32, width_mult=0.125, sdf_res=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "image_to_mesh":
            pipeline.image_to_mesh({}, np.zeros((137, 137, 3), np.uint8),
                                   synthetic.demo_trans_mat(), cfg)
        elif entry == "init":
            disn.init(cfg)
        elif entry == "extract_mesh_owned":
            marching.extract_mesh_owned(vol, box)
        elif entry == "extract_mesh_from_ids":
            marching.extract_mesh_from_ids(torch.from_numpy(vol), box, ids)
        elif entry == "extract_mesh_records":
            marching.extract_mesh_records(vol, box, ids, 0)
        elif entry == "create_state":
            trainer.create_state(cfg)
        elif entry == "make_train_step":
            trainer.make_train_step(cfg)
        elif entry == "make_eval_step":
            trainer.make_eval_step(cfg)
        elif entry == "cli_train":
            cli.main(["train", "--data-root", "unused", "--log-dir",
                      str(tmp_path)])
        elif entry == "reconstruct_split":
            pipeline.reconstruct_split({}, cfg, None, [], str(tmp_path))
        elif entry == "evaluate_tree":
            runner.evaluate_tree(str(tmp_path), str(tmp_path), str(tmp_path))
        elif entry == "occupancy_device":
            voxelize.occupancy_device(np.eye(3, dtype=np.float32),
                                      np.array([[0, 1, 2]], np.int32))
        elif entry == "cli_create_sdf":
            cli.main(["create-sdf", "--data-root", "unused", "--restore",
                      "unused", "--log-dir", str(tmp_path)])
        elif entry == "cli_evaluate":
            cli.main(["evaluate", "--data-root", "unused", "--pred-dir",
                      "unused", "--gt-dir", "unused"])
        elif entry == "cli_evaluate_acc":
            cli.main(["evaluate-acc", "--data-root", "unused", "--restore",
                      "unused", "--log-dir", str(tmp_path)])
        elif entry == "posenet_init":
            posenet.init(cfg)
        elif entry == "make_cam_train_step":
            trainer.make_cam_train_step(cfg)
        elif entry == "cli_demo":
            cli.main(["demo", "--image", "unused.h5", "--restore",
                      "unused", "--out", str(tmp_path / "x.obj")])
        elif entry == "cli_train_cam":
            cli.main(["train-cam", "--data-root", "unused", "--log-dir",
                      str(tmp_path)])
        elif entry == "reconstruct_multiview":
            pipeline.reconstruct_multiview({}, cfg, None, [], str(tmp_path))
        elif entry == "multiview_to_mesh":
            pipeline.multiview_to_mesh({}, np.zeros((2, 137, 137, 3),
                                                    np.uint8),
                                       np.zeros((2, 4, 3), np.float32), box,
                                       cfg)
        elif entry in ("multiview_sdf_sparse", "multiview_sdf"):
            getattr(multiview, entry)({}, np.zeros((2, 137, 137, 3),
                                                   np.uint8),
                                      np.zeros((2, 4, 3), np.float32), box,
                                      cfg)
        elif entry == "dense_sdf":
            dense.dense_sdf({}, np.zeros((137, 137, 3), np.uint8),
                            synthetic.demo_trans_mat(), box,
                            cfg.replace(variant=Variant.ONESTREAM))
        elif entry == "sparse_volume":
            sparse.sparse_volume({}, np.zeros((137, 137, 3), np.uint8),
                                 synthetic.demo_trans_mat(), box,
                                 cfg.replace(variant=Variant.GLOBAL,
                                             binary=True))
        elif entry == "threedcnn_volume":
            pipeline.threedcnn_volume({}, np.zeros((137, 137, 3), np.uint8),
                                      cfg.replace(variant=Variant.THREEDCNN))
        elif entry == "predict_volume_threedcnn":
            pipeline.predict_volume({}, np.zeros((137, 137, 3), np.uint8),
                                    None, box,
                                    cfg.replace(variant=Variant.THREEDCNN))
        elif entry == "init_onestream":
            disn.init(cfg.replace(variant=Variant.ONESTREAM))
        elif entry == "cli_train_dump":
            cli.main(["train", "--data-root", "unused", "--log-dir",
                      str(tmp_path), "--dump-every", "1", "--set",
                      "variant=global"])
        elif entry == "cli_demo_global":
            cli.main(["demo", "--image", "unused.h5", "--restore", "unused",
                      "--out", str(tmp_path / "x.obj"), "--set",
                      "variant=global", "--set", "binary=true"])
        elif entry == "init_alexnet":
            disn.init(cfg.replace(encoder=EncoderKind.ALEXNET))
        elif entry == "init_resnet_alpha":
            disn.init(cfg.replace(encoder=EncoderKind.RESNET, alpha=True))
        elif entry == "generate_object":
            sdf_gen.generate_object(np.eye(3, dtype=np.float32),
                                    np.array([[0, 1, 2]], np.int32),
                                    str(tmp_path / "obj"))
        elif entry == "write_object":
            sdf_gen.write_object(None, str(tmp_path / "obj"))
        elif entry == "cli_preprocess_sdf":
            cli.main(["preprocess-sdf", "--pattern", "unused/*.obj",
                      "--out-dir", str(tmp_path)])
        elif entry == "image_to_mesh_sharded":
            from disn_tpu_torch import parallel
            pipeline.image_to_mesh_sharded(
                {}, np.zeros((137, 137, 3), np.uint8),
                synthetic.demo_trans_mat(), cfg, parallel.make_mesh())
        elif entry == "init_from_env":
            from disn_tpu_torch import parallel
            parallel.init_from_env()
        elif entry == "cli_create_sdf_multi_view":
            cli.main(["create-sdf", "--multi-view", "--data-root", "unused",
                      "--restore", "unused", "--log-dir", str(tmp_path)])
        else:
            synthetic.analytic_octahedron_params(cfg)


def test_single_process_paths_make_no_process_group():
    """Without WORLD_SIZE nothing joins a process group: a plain
    image_to_mesh, a single-process train step, init_from_env and the
    one-process mesh leave torch.distributed uninitialised."""
    import torch.distributed as dist

    from disn_tpu_torch import parallel
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.train import trainer

    assert "WORLD_SIZE" not in __import__("os").environ
    cfg = Config(num_classes=32, width_mult=0.125, sdf_res=16,
                 compute_dtype="float32", cell_cap_frac=0.9, batch_size=2,
                 num_sample_points=16)
    params = synthetic.analytic_octahedron_params(cfg, device="cpu")
    _, faces = pipeline.image_to_mesh(params, np.zeros((137, 137, 3),
                                                       np.uint8),
                                      synthetic.demo_trans_mat(), cfg,
                                      device="cpu")
    assert len(faces) and not dist.is_initialized()
    state = trainer.create_state(cfg, device="cpu", mesh=parallel.make_mesh())
    rng = np.random.RandomState(0)
    batch = {"img": rng.rand(2, 137, 137, 3).astype(np.float32),
             "sdf_pt": rng.uniform(-1, 1, (2, 16, 3)).astype(np.float32),
             "sdf_val": rng.uniform(-.1, .1, (2, 16, 1)).astype(np.float32),
             "trans_mat": np.stack([synthetic.demo_trans_mat()] * 2)}
    trainer.make_train_step(cfg, device="cpu")(state, batch)
    assert parallel.init_from_env("cpu") == torch.device("cpu")
    assert not dist.is_initialized()

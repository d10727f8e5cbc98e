"""Command-line interface of the port (the subcommands of disn_tpu/cli.py):

    python -m disn_tpu_torch train --data-root DIR [--device cpu]

trains the SDF net on the dataset tree under DIR (filelists/, sdf/,
renders/; the bundled ShapeNet split lists when DIR has no filelists/) and
writes config.json, log_train.txt, metrics_train.jsonl and the checkpoints
(latest.npz with the optimizer state, best.npz, epoch_NNN.npz) into
--log-dir, in the JAX package's format: either package resumes the
other's; every --dump-every steps it writes the visual dumps into dumps/.
`--set key=value` overrides a Config field (e.g. variant=onestream,
binary=true, sampling=native, fused_kernel=off).

    python -m disn_tpu_torch create-sdf --data-root DIR --restore CKPT
    python -m disn_tpu_torch evaluate --data-root DIR --pred-dir P --gt-dir G
    python -m disn_tpu_torch evaluate-acc --data-root DIR --restore CKPT

reconstruct every view of a split into
{log-dir}/test_objs/{R}_{iso}/{cat}/{cat}_{obj}_{view:02d}.obj, score such
a tree against {G}/{cat}/{obj}/isosurf.obj (CD, EMD, F-score, IoU; the
result JSON on stdout and in --out), and print the SDF accuracy and losses
over a split.

    python -m disn_tpu_torch train-cam --data-root DIR [--mode train|test|create]
    python -m disn_tpu_torch create-sdf --data-root DIR --restore CKPT --cam-est
    python -m disn_tpu_torch demo --image IMG --restore CKPT [--cam-est]

train the camera net (latest.npz every 1000 steps), report its losses and
point distances over a split, or write DIR/renders_camest/, the view tree
with every trans_mat replaced by the net's prediction, which create-sdf
--cam-est reconstructs into test_objs/camest_{R}_{iso}/. demo turns one
image (a view h5, or a PNG with --trans-mat or an estimated camera) into
an OBJ.

    python -m disn_tpu_torch preprocess-sdf --pattern 'MESHES/*.obj' --out-dir D
    python -m disn_tpu_torch preprocess-img --pattern 'VIEWS/*.png' \
        --metadata rendering_metadata.txt --sdf-h5 D/obj/ori_sample.h5 --out-dir V
    python -m disn_tpu_torch clean --pattern 'RESULTS/*.obj'
    python -m disn_tpu_torch convert-ckpt --tf-prefix model.ckpt --out params.npz
    python -m disn_tpu_torch synth --out-dir DIR

are the offline tools: the SDF ground truth of each mesh (D/<name>/
ori_sample.h5 and isosurf.obj; --jobs N computes N distance fields at a
time on the host), the view h5s of an object's renders, the removal of
small or far-off mesh parts, a TF1 bundle checkpoint as npz, and the
synthetic dataset tree. Every subcommand that uses the device runs on the
GPU unless --device cpu; preprocess-img, clean, convert-ckpt and synth use
none.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Any

from disn_tpu_torch.config import CATS, Config, Variant


def _coerce(field_type: Any, raw: str) -> Any:
    if field_type is bool or field_type == "bool":
        return raw.lower() in ("1", "true", "yes")
    if field_type is Variant:
        return Variant(raw)
    try:
        return field_type(raw)
    except (TypeError, ValueError):
        return raw


def apply_overrides(cfg: Config, pairs: list[str]) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {}
    for pair in pairs or []:
        key, _, val = pair.partition("=")
        if key not in fields:
            raise SystemExit(f"unknown config key: {key}")
        kw[key] = _coerce(type(getattr(cfg, key)), val)
    return cfg.replace(**kw)


def data_handles(cfg: Config, data_root: str, split: str,
                 cam_est: bool = False):
    """(listinfo, cats_limit, SplitPaths) of a dataset tree; with cam_est
    the views are read from renders_camest/ instead of renders/."""
    from disn_tpu_torch.data import listing

    lst_dir = os.path.join(data_root, "filelists")
    if not os.path.isdir(lst_dir):
        lst_dir = listing.BUNDLED_FILELISTS
    cats = dict(CATS)
    # categories of the list directory beyond ShapeNet's (the synthetic one)
    for f in glob.glob(os.path.join(lst_dir, f"*_{split}.lst")):
        cat = os.path.basename(f).rsplit("_", 1)[0]
        if cat not in cats.values():
            cats[cat] = cat
    listinfo, cats_limit = listing.load_split(lst_dir, cats, split,
                                              view_num=cfg.view_num)
    paths = listing.SplitPaths(
        os.path.join(data_root, "sdf"),
        os.path.join(data_root, "renders_camest" if cam_est else "renders"))
    return listinfo, cats_limit, paths


def _data_parallel(args, cfg: Config):
    """(device, mesh, lead) of this process. Under torchrun (WORLD_SIZE >
    1) it joins the process group (parallel.init_from_env: NCCL with one
    card a rank, gloo with --device cpu) and takes its place in the
    fitting mesh of cfg.batch_size; a rank outside that mesh gets mesh
    None and lead False and takes no step. Alone: (device, None, True)."""
    import torch.distributed as dist

    from disn_tpu_torch import parallel

    dev = parallel.init_from_env(args.device)
    if not dist.is_initialized():
        return dev, None, True
    mesh = parallel.fitting_mesh(cfg.batch_size)
    return dev, mesh, mesh is not None and mesh.lead


def _stripe_loader(args, cfg: Config, mesh, dev):
    """The loader of this rank's stripe: data rank i of n loads stripe i
    in batches of cfg.batch_size // n (the global batch stays
    cfg.batch_size)."""
    from disn_tpu_torch.data import pipeline

    n, i = (1, 0) if mesh is None else (mesh.shape["data"], mesh.coords[0])
    listinfo, cats_limit, paths = data_handles(cfg, args.data_root, "train")
    return pipeline.make_loader(cfg, paths, listinfo, cats_limit,
                                epochs=args.epochs, workers=args.workers,
                                seed=args.seed, device=dev, host_id=i,
                                host_count=n,
                                batch_size=cfg.batch_size // n)


def cmd_train(args) -> None:
    from disn_tpu_torch import parallel

    cfg = apply_overrides(Config(), args.set)
    dev, mesh, lead = _data_parallel(args, cfg)
    try:
        if mesh is not None or lead:
            _train(args, cfg, dev, mesh, lead)
    finally:
        parallel.shutdown()


def _train(args, cfg: Config, dev, mesh, lead: bool = True) -> None:
    """The train loop of one rank: the lead rank alone logs and writes
    config.json, the checkpoints and the dumps; every rank reads --resume
    and --restore."""
    import torch

    from disn_tpu_torch.train import checkpoint, trainer
    from disn_tpu_torch.utils.logging import MetricLogger, Timer

    logger = MetricLogger(args.log_dir if lead else None, stdout=lead)
    logger.log(f"config: {cfg.to_json()}")
    if lead:
        cfg.save(os.path.join(args.log_dir, "config.json"))

    loader = _stripe_loader(args, cfg, mesh, dev)
    state = trainer.create_state(cfg, seed=args.seed, device=dev, mesh=mesh)
    if args.resume:
        # full state: params, optimizer moments and step
        path = args.resume if os.path.isfile(args.resume) else \
            os.path.join(args.resume, "latest.npz")
        state.load_state_tree(checkpoint.restore(path, state.state_tree()))
        logger.log(f"resumed from {path} at step {state.step}")
    for donor_path, scopes, skip in ((args.restore, None, ()),
                                     (args.restore_cnn, ("vgg_16",),
                                      ("fc8",))):
        if not donor_path:
            continue
        donor = checkpoint.restore_params(donor_path)
        merged, skipped = checkpoint.merge_scopes(
            state.params_tree(), donor.get("params", donor),
            scopes=scopes, skip_substr=skip)
        state.load_params(merged)
        logger.log(f"restored {donor_path} (scopes {scopes or 'all'}); "
                   f"skipped {len(skipped)} leaves")

    step_fn = trainer.make_train_step(cfg, device=dev, mesh=mesh)
    mgr = checkpoint.CheckpointManager(args.log_dir, period=10) if lead \
        else None
    timer = Timer()
    loader.start()
    bpe = loader.batches_per_epoch
    # accuracy summed on the device: reading it every step would sync
    acc_sum, acc_n = torch.zeros((), device=dev), 0
    try:
        for i, batch in enumerate(loader):
            with timer.phase("step"):
                state, losses = step_fn(state, batch)
            acc_sum += losses["accuracy"]
            acc_n += 1
            if i % args.log_every == 0:
                logger.metrics(i, losses)
                logger.log(timer.summary())
            if lead and args.dump_every and i % args.dump_every == 0:
                train_visual_dump(args.log_dir, i, cfg, state.params, batch,
                                  dev)
            if (i + 1) % bpe == 0:
                epoch = (i + 1) // bpe
                acc = float(acc_sum) / acc_n
                if lead:
                    tree = state.state_tree()
                    mgr.save_epoch({"params": tree["params"]}, epoch,
                                   metric=acc)
                    mgr.save_latest(tree, state.step)
                logger.log(f"epoch {epoch} done; acc {acc:.4f}")
                acc_sum.zero_()
                acc_n = 0
    finally:
        loader.shutdown()
        logger.close()


def train_visual_dump(log_dir: str, step: int, cfg: Config, params,
                      batch: dict, dev) -> None:
    """The train-time visuals of the JAX package's train (reference
    train/train_sdf.py:403-428), into {log_dir}/dumps/: the batch's first
    example's sample points projected onto its image (stepNNNNNN_proj.ppm),
    and its points coloured by the predicted and the ground-truth SDF
    (stepNNNNNN_pred.obj, stepNNNNNN_gt.obj). The prediction is the
    unfolded forward pass (disn.apply(fold=False)) on `dev`, the params'
    device, without gradients."""
    import numpy as np
    import torch

    from disn_tpu_torch.core import camera
    from disn_tpu_torch.infer.dense import scale_pred
    from disn_tpu_torch.models import disn
    from disn_tpu_torch.train.trainer import to_model_batch
    from disn_tpu_torch.utils import output

    host = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                else np.asarray(v)) for k, v in batch.items()}
    d = os.path.join(log_dir, "dumps")
    px = camera.project_points(
        torch.from_numpy(host["sdf_pt"][:1]),
        torch.from_numpy(host["trans_mat"][:1]), img_w=cfg.img_w,
        img_h=cfg.img_h)[0].numpy()
    output.save_ppm(os.path.join(d, f"step{step:06d}_proj.ppm"),
                    output.draw_points_on_image(host["img"][0], px))
    with torch.no_grad():
        eps = disn.apply(params, to_model_batch(
            {k: torch.from_numpy(v[:1]).to(dev) for k, v in host.items()}),
            cfg, fold=False)
        pred = scale_pred(eps["pred_sdf"], cfg)[0].float().cpu().numpy()
    output.save_scaled_point_cloud(
        os.path.join(d, f"step{step:06d}_pred.obj"), host["sdf_pt"][0], pred)
    output.save_scaled_point_cloud(
        os.path.join(d, f"step{step:06d}_gt.obj"), host["sdf_pt"][0],
        host["sdf_val"][0, :, 0])


def cmd_train_cam(args) -> None:
    """--mode train runs data parallel under torchrun, as `train` does;
    --mode create and test run in one process."""
    from disn_tpu_torch import device as device_mod
    from disn_tpu_torch import parallel

    cfg = apply_overrides(Config(), args.set)
    if args.mode != "train":
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise SystemExit(f"train-cam --mode {args.mode} runs in one "
                             "process, not under torchrun")
        _train_cam(args, cfg, device_mod.resolve(args.device), None)
        return
    dev, mesh, lead = _data_parallel(args, cfg)
    try:
        if mesh is not None or lead:
            _train_cam(args, cfg, dev, mesh, lead)
    finally:
        parallel.shutdown()


def _train_cam(args, cfg: Config, dev, mesh, lead: bool = True) -> None:
    from disn_tpu_torch.models import posenet
    from disn_tpu_torch.train import checkpoint, trainer
    from disn_tpu_torch.utils.logging import MetricLogger

    logger = MetricLogger(args.log_dir if lead else None, name="cam",
                          stdout=lead)
    state = trainer.create_state(cfg, seed=args.seed, device=dev,
                                 init_fn=posenet.init, mesh=mesh)
    if args.restore:
        # where the paths and shapes agree
        donor = checkpoint.restore_params(args.restore)
        merged, _ = checkpoint.merge_scopes(state.params_tree(),
                                            donor.get("params", donor))
        state.load_params(merged)
    if args.mode == "create":
        _cam_create_h5(args, cfg, state.params, logger, dev)
        return
    if args.mode == "test":
        _cam_eval(args, cfg, state.params, logger, dev)
        return
    loader = _stripe_loader(args, cfg, mesh, dev)
    step_fn = trainer.make_cam_train_step(cfg, device=dev, mesh=mesh)
    mgr = checkpoint.CheckpointManager(args.log_dir, period=10) if lead \
        else None
    loader.start()
    try:
        for i, batch in enumerate(loader):
            state, losses = step_fn(state, trainer.to_cam_batch(batch))
            if i % args.log_every == 0:
                logger.metrics(i, losses)
            if lead and i % 1000 == 999:
                mgr.save_latest({"params": state.params_tree()},
                                state.step)
    finally:
        loader.shutdown()
        logger.close()


def _cam_eval(args, cfg: Config, params, logger, dev) -> None:
    """--mode test: the camera loss graph over one unshuffled epoch of the
    split's batches; every loss averaged over batches, and the average,
    largest and smallest per-batch 2D and 3D point distances."""
    import numpy as np

    from disn_tpu_torch.data import pipeline
    from disn_tpu_torch.train import trainer

    listinfo, cats_limit, paths = data_handles(cfg, args.data_root,
                                               args.split)
    loader = pipeline.make_loader(cfg, paths, listinfo, cats_limit,
                                  epochs=1, shuffle=False,
                                  workers=args.workers, seed=args.seed,
                                  device=dev)
    ev = trainer.make_eval_step(cfg, device=dev,
                                objective=trainer.cam_loss_fn)
    sums: dict[str, float] = {}
    d2, d3 = [], []
    loader.start()
    try:
        for batch in loader:
            losses = {k: float(v) for k, v in
                      ev(params, trainer.to_cam_batch(batch)).items()}
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + v
            d2.append(losses["rot2d_dist"])
            d3.append(losses["rot3d_dist"])
    finally:
        loader.shutdown()
    if not d2:
        logger.log("cam eval: empty split")
        return
    for k in sorted(sums):
        logger.log(f"cam eval {k}: {sums[k] / len(d2):.6f}")
    for name, d in (("2d", np.asarray(d2)), ("3d", np.asarray(d3))):
        logger.log(f"avg {name} dist {d.mean():.6f}, max {name} dist "
                   f"{d.max():.6f}, min {name} dist {d.min():.6f}")
    logger.close()


def _cam_create_h5(args, cfg: Config, params, logger, dev,
                   batch: int = 64) -> None:
    """--mode create: rewrite the split's view h5s into
    DATA_ROOT/renders_camest/{cat}/{obj}/{view:02d}.h5 with trans_mat
    replaced by the camera net's prediction (everything else copied):
    pipeline.estimate_cameras, BATCH views a forward, fed by a reader pool
    that prefetches the h5s (gzip decompression is the host's cost) up to
    2 x BATCH ahead and drained by a writer pool with at most 4 x BATCH
    writes pending."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.infer import pipeline

    listinfo, _, paths = data_handles(cfg, args.data_root, args.split)
    out_root = os.path.join(args.data_root, "renders_camest")

    def prefetched(readers):
        pending: deque = deque()
        todo = iter(listinfo)
        while True:
            while len(pending) < 2 * batch:
                key = next(todo, None)
                if key is None:
                    break
                pending.append((key, readers.submit(
                    codecs.read_view_h5, paths.img_path(*key))))
            if not pending:
                return
            key, fut = pending.popleft()
            yield key, fut.result()

    with ThreadPoolExecutor(2) as writers, ThreadPoolExecutor(2) as readers:
        writes: deque = deque()
        for (cat_id, obj, view), rec in pipeline.estimate_cameras(
                params, prefetched(readers), cfg, batch=batch, device=dev):
            writes.append(writers.submit(
                codecs.write_view_h5,
                os.path.join(out_root, cat_id, obj, f"{view:02d}.h5"), rec))
            while len(writes) > 4 * batch:
                writes.popleft().result()
        for f in writes:
            f.result()
    logger.log(f"wrote {len(listinfo)} estimated-camera view h5s to "
               f"{out_root}")
    logger.close()


def cmd_create_sdf(args) -> None:
    from disn_tpu_torch import convert
    from disn_tpu_torch import device as device_mod
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.utils.logging import MetricLogger

    dev = device_mod.resolve(args.device)
    cfg = apply_overrides(Config(), args.set)
    logger = MetricLogger(args.log_dir, name="test")
    listinfo, _, paths = data_handles(cfg, args.data_root, args.split,
                                      cam_est=args.cam_est)
    donor = convert.load_npz(args.restore)
    params = donor.get("params", donor)
    if args.multi_view:
        # the JAX command's stripe: a farm worker fuses its share of the
        # listed views of each object
        written = pipeline.reconstruct_multiview(
            params, cfg, paths, listinfo[args.shard::args.shards],
            args.log_dir, logger=logger, device=dev)
    else:
        written = pipeline.reconstruct_split(
            params, cfg, paths, listinfo, args.log_dir, cam_est=args.cam_est,
            sparse=not args.dense, logger=logger, shard_index=args.shard,
            shard_count=args.shards, device=dev)
    logger.log(f"wrote {len(written)} meshes")
    logger.close()


# the bundled camera net (demo/make_assets.py trains it on the synthetic
# dataset), used by `demo` without --cam-restore at its own config only
BUNDLED_POSENET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demo",
    "tiny_posenet.npz")


def cmd_demo(args) -> None:
    import numpy as np

    from disn_tpu_torch import convert
    from disn_tpu_torch import device as device_mod
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.utils.logging import MetricLogger

    dev = device_mod.resolve(args.device)
    cfg = apply_overrides(Config(), args.set)
    logger = MetricLogger(None)
    if args.image.endswith(".h5"):
        rec = codecs.read_view_h5(args.image)
        img = rec.img_arr[:, :, :cfg.img_channels]  # u8, /255 on the device
        trans = rec.trans_mat
    else:
        img = codecs.read_png(args.image, "RGBA" if cfg.alpha else "RGB")
        trans = None
    if args.trans_mat:
        trans = np.loadtxt(args.trans_mat, dtype=np.float32,
                           comments="#").reshape(4, 3)
    cam_params = None
    if args.cam_est or trans is None:
        cam_restore = args.cam_restore
        if (not cam_restore and cfg.width_mult == 0.25
                and cfg.num_classes == 128
                and os.path.exists(BUNDLED_POSENET)):
            # the bundled net only at its own training config: at another
            # width its shapes do not fit, and a toy camera for a real
            # photo would mislead
            cam_restore = BUNDLED_POSENET
            logger.log(f"using bundled posenet checkpoint {cam_restore} "
                       "(synthetically trained; pass --cam-restore for a "
                       "real one)")
        if not cam_restore:
            raise SystemExit(
                "a plain image carries no camera: pass --trans-mat "
                "<4x3 txt> or --cam-restore <posenet ckpt> (or use a view "
                ".h5 with a trans_mat)")
        donor = convert.load_npz(cam_restore)
        cam_params = donor.get("params", donor)
        trans = None
    donor = convert.load_npz(args.restore)
    verts, faces = pipeline.reconstruct_image(
        donor.get("params", donor), img, cfg, trans_mat=trans,
        cam_params=cam_params, sparse=not args.dense, clean=args.clean,
        device=dev)
    if cam_params is not None:
        logger.log("camera estimated by posenet")
    codecs.write_obj(args.out, verts, faces)
    logger.log(f"wrote {args.out}: {len(verts)} verts, {len(faces)} faces")


def cmd_evaluate(args) -> None:
    from disn_tpu_torch.eval import runner

    results = runner.evaluate_tree(
        pred_dir=args.pred_dir, gt_dir=args.gt_dir,
        lst_dir=os.path.join(args.data_root, "filelists"),
        split=args.split, metrics=args.metrics.split(","),
        num_points=args.num_points, view_num=args.view_num, dim=args.dim,
        protocol=args.protocol, device_iou=args.device_iou,
        cache_dir=args.cache_dir, device=args.device)
    print(json.dumps(results, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)


def cmd_evaluate_acc(args) -> None:
    """SDF accuracy and losses on a split's sampled points (the reference's
    test/test_sdf_acc.py): the metric-only eval step over one unshuffled
    epoch, averaged over batches."""
    from disn_tpu_torch import convert
    from disn_tpu_torch import device as device_mod
    from disn_tpu_torch.data import pipeline
    from disn_tpu_torch.train import trainer
    from disn_tpu_torch.utils.logging import MetricLogger

    dev = device_mod.resolve(args.device)
    cfg = apply_overrides(Config(), args.set)
    logger = MetricLogger(args.log_dir, name="acc")
    listinfo, cats_limit, paths = data_handles(cfg, args.data_root,
                                               args.split)
    donor = convert.load_npz(args.restore)
    params = device_mod.tree_to(donor.get("params", donor), dev)
    loader = pipeline.make_loader(cfg, paths, listinfo, cats_limit,
                                  epochs=1, shuffle=False, workers=4,
                                  device=dev)
    ev = trainer.make_eval_step(cfg, device=dev)
    loader.start()
    sums: dict[str, float] = {}
    n = 0
    try:
        for batch in loader:
            for k, v in ev(params, batch).items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
    finally:
        loader.shutdown()
    logger.log(json.dumps({k: v / max(n, 1) for k, v in sums.items()},
                          indent=2))
    logger.close()


def cmd_preprocess_sdf(args) -> None:
    """The SDF ground truth of every mesh matching --pattern, in sorted
    order. The distance fields (host C++, which drops the GIL) run --jobs
    at a time in a thread pool, at most 2 x --jobs ahead; the sampling,
    the extraction on the device and the writes follow on this thread in
    input order, so the output is the same for any --jobs."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from disn_tpu_torch import device as device_mod
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.preprocessing import sdf_gen

    dev = device_mod.resolve(args.device)
    jobs = max(1, args.jobs)
    threads = max(1, (os.cpu_count() or 1) // jobs)
    todo = []
    for obj_path in sorted(glob.glob(args.pattern)):
        rel = os.path.splitext(os.path.basename(obj_path))[0]
        out_dir = os.path.join(args.out_dir, rel)
        os.makedirs(out_dir, exist_ok=True)
        todo.append((obj_path, out_dir))

    def field(job):
        if sdf_gen.is_done(job[1]):
            return None
        verts, faces = codecs.read_obj(job[0])
        return sdf_gen.object_field(verts, faces, sdf_res=args.res,
                                    threads=threads)

    with ThreadPoolExecutor(jobs) as pool:
        rest = iter(todo)
        pending = deque((job, pool.submit(field, job))
                        for _, job in zip(range(2 * jobs), rest))
        while pending:
            (_, out_dir), fut = pending.popleft()
            job = next(rest, None)
            if job is not None:
                pending.append((job, pool.submit(field, job)))
            f = fut.result()
            if f is None:
                print({"h5": os.path.join(out_dir, "ori_sample.h5"),
                       "skipped": True})
                continue
            print(sdf_gen.write_object(f, out_dir, cat_id=args.cat_id,
                                       num_sample=args.num_sample,
                                       device=dev))


def cmd_preprocess_img(args) -> None:
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.preprocessing import img_gen

    meta = img_gen.parse_render_metadata(args.metadata)
    images = [codecs.read_png_u8(p, "RGBA")
              for p in sorted(glob.glob(args.pattern))]
    sdf = codecs.read_sdf_h5(args.sdf_h5)
    paths = img_gen.generate_object_views(images, meta, sdf.norm_params,
                                          args.out_dir)
    print(f"wrote {len(paths)} view h5s")


def cmd_clean(args) -> None:
    from disn_tpu_torch.postprocessing import clean_mesh_file
    for src in sorted(glob.glob(args.pattern)):
        dst = src if args.in_place else src.replace(".obj", "_clean.obj")
        clean_mesh_file(src, dst, vert_ratio=args.vert_ratio,
                        center_dist=args.center_dist)
        print(f"cleaned {src} -> {dst}")


def cmd_convert_ckpt(args) -> None:
    """TF1 bundle checkpoint -> npz (convert/tf_ckpt.py)."""
    from disn_tpu_torch.convert import convert_checkpoint
    from disn_tpu_torch.train import checkpoint
    params = convert_checkpoint(args.tf_prefix, args.out)
    n = sum(1 for _ in checkpoint.leaves(params))
    print(f"converted {n} tensors from {args.tf_prefix} -> {args.out}")


def cmd_synth(args) -> None:
    from disn_tpu_torch.data import synthetic
    info = synthetic.build_dataset(args.out_dir, views=args.views,
                                   num_samples=args.num_samples,
                                   grid_res=args.grid_res)
    print(json.dumps({k: v for k, v in info.items()
                      if isinstance(v, (str, int))}, indent=2))


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="override a Config field")
    p.add_argument("--log-dir", default="runs/default")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default: it fails without a card) or "
                        "'cpu'")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("disn_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser(
        "train", help="SDF training",
        description="SDF training: the folded forward pass for twostream + "
                    "tf1, the unfolded one for every other variant and "
                    "sampling (--set variant=onestream|global, "
                    "sampling=native, binary=true, tanh=true).")
    _common(p)
    p.add_argument("--data-root", required=True)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--dump-every", type=int, default=4000,
                   help="visual dump cadence in steps, step 0 included, "
                        "into LOG_DIR/dumps/ (0 disables)")
    p.add_argument("--restore", default=None,
                   help="params from a checkpoint (shape mismatches skipped)")
    p.add_argument("--restore-cnn", default=None,
                   help="encoder-only init (scope vgg_16, fc8 skipped)")
    p.add_argument("--resume", default=None,
                   help="full-state resume (params + optimizer + step) from "
                        "a checkpoint file or a run dir's latest.npz; "
                        "either package's")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("train-cam", help="camera pose training / eval / h5")
    _common(p)
    p.add_argument("--data-root", required=True)
    p.add_argument("--mode", choices=["train", "test", "create"],
                   default="train",
                   help="train; test: losses and point distances over "
                        "--split; create: write renders_camest/")
    p.add_argument("--split", default="test",
                   help="the split of --mode test and create")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--restore", default=None,
                   help="camera-net params from a checkpoint (shape "
                        "mismatches skipped); either package's")
    p.set_defaults(fn=cmd_train_cam)

    p = sub.add_parser("create-sdf", help="test-split reconstruction")
    _common(p)
    p.add_argument("--data-root", required=True)
    p.add_argument("--restore", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--cam-est", action="store_true",
                   help="read the estimated-camera tree renders_camest/ "
                        "and write test_objs/camest_{R}_{iso}/")
    p.add_argument("--dense", action="store_true",
                   help="exact dense path (default: sparse two-level)")
    p.add_argument("--shard", type=int, default=0,
                   help="this worker's index in a reconstruction farm")
    p.add_argument("--shards", type=int, default=1,
                   help="total farm workers (one process per card)")
    p.add_argument("--multi-view", action="store_true",
                   help="fuse all views of each object (feature averaging) "
                        "into test_objs/{R}_{iso}_mv/")
    p.set_defaults(fn=cmd_create_sdf)

    p = sub.add_parser("demo", help="single image -> mesh")
    _common(p)
    p.add_argument("--image", required=True, help="png or view h5")
    p.add_argument("--restore", required=True)
    p.add_argument("--trans-mat", default=None,
                   help="4x3 world->pixel matrix txt for a plain png "
                        "(e.g. demo/chair_trans_mat.txt)")
    p.add_argument("--cam-est", action="store_true",
                   help="estimate the camera with the camera net")
    p.add_argument("--cam-restore", default=None,
                   help="the camera net's checkpoint (default: the bundled "
                        "demo/tiny_posenet.npz, at width_mult 0.25 and 128 "
                        "classes only)")
    p.add_argument("--dense", action="store_true")
    p.add_argument("--clean", action="store_true")
    p.add_argument("--out", default="result.obj")
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("evaluate", help="cd/emd/f-score/iou over a result tree")
    _common(p)
    p.add_argument("--data-root", required=True)
    p.add_argument("--pred-dir", required=True)
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--metrics", default="cd,emd,fscore,iou")
    p.add_argument("--num-points", type=int, default=2048)
    p.add_argument("--view-num", type=int, default=24)
    p.add_argument("--dim", type=int, default=110)
    p.add_argument("--protocol", choices=["vertices", "surface"],
                   default="vertices",
                   help="point sampling: reference protocol (vertices) or "
                        "uniform surface sampling")
    p.add_argument("--device-iou", action="store_true",
                   help="voxelize on the device by sampling")
    p.add_argument("--cache-dir", default=None,
                   help="per-object metric cache: a killed run resumes, "
                        "skipping finished objects")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("evaluate-acc",
                       help="SDF sign-accuracy/loss on held-out points")
    _common(p)
    p.add_argument("--data-root", required=True)
    p.add_argument("--restore", required=True)
    p.add_argument("--split", default="test")
    p.set_defaults(fn=cmd_evaluate_acc)

    p = sub.add_parser("preprocess-sdf",
                       help="SDF samples and ground-truth mesh per mesh")
    p.add_argument("--pattern", required=True, help="glob of input .obj files")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--cat-id", default="")
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--num-sample", type=int, default=32768)
    p.add_argument("--jobs", type=int, default=1,
                   help="distance fields computed at a time (threads)")
    p.add_argument("--device", default=None,
                   help="where the ground-truth mesh is extracted: 'cuda' "
                        "(the default: it fails without a card) or 'cpu'")
    p.set_defaults(fn=cmd_preprocess_sdf)

    p = sub.add_parser("preprocess-img", help="view h5s of rendered views")
    p.add_argument("--pattern", required=True, help="glob of view pngs")
    p.add_argument("--metadata", required=True)
    p.add_argument("--sdf-h5", required=True)
    p.add_argument("--out-dir", required=True)
    p.set_defaults(fn=cmd_preprocess_img)

    p = sub.add_parser("clean", help="drop small or far-off mesh parts")
    p.add_argument("--pattern", required=True)
    p.add_argument("--in-place", action="store_true")
    p.add_argument("--vert-ratio", type=float, default=0.3)
    p.add_argument("--center-dist", type=float, default=0.5)
    p.set_defaults(fn=cmd_clean)

    p = sub.add_parser("convert-ckpt",
                       help="convert a TF1 bundle checkpoint to npz")
    p.add_argument("--tf-prefix", required=True,
                   help="TF checkpoint prefix (model.ckpt of .index/.data)")
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_convert_ckpt)

    p = sub.add_parser("synth", help="write the synthetic dataset tree")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--views", type=int, default=4)
    p.add_argument("--num-samples", type=int, default=8192)
    p.add_argument("--grid-res", type=int, default=32)
    p.set_defaults(fn=cmd_synth)
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)

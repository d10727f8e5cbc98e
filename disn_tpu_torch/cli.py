"""Command-line interface of the port (the `train`, `create-sdf`,
`evaluate` and `evaluate-acc` subcommands of disn_tpu/cli.py):

    python -m disn_tpu_torch train --data-root DIR [--device cpu]

trains the SDF net on the dataset tree under DIR (filelists/, sdf/,
renders/; the bundled ShapeNet split lists when DIR has no filelists/) and
writes config.json, log_train.txt, metrics_train.jsonl and the checkpoints
(latest.npz with the optimizer state, best.npz, epoch_NNN.npz) into
--log-dir, in the JAX package's format: either package resumes the
other's. `--set key=value` overrides a Config field.

    python -m disn_tpu_torch create-sdf --data-root DIR --restore CKPT
    python -m disn_tpu_torch evaluate --data-root DIR --pred-dir P --gt-dir G
    python -m disn_tpu_torch evaluate-acc --data-root DIR --restore CKPT

reconstruct every view of a split into
{log-dir}/test_objs/{R}_{iso}/{cat}/{cat}_{obj}_{view:02d}.obj, score such
a tree against {G}/{cat}/{obj}/isosurf.obj (CD, EMD, F-score, IoU; the
result JSON on stdout and in --out), and print the SDF accuracy and losses
over a split. Every subcommand runs on the GPU unless --device cpu.
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


def data_handles(cfg: Config, data_root: str, split: str):
    """(listinfo, cats_limit, SplitPaths) of a dataset tree."""
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
    paths = listing.SplitPaths(os.path.join(data_root, "sdf"),
                               os.path.join(data_root, "renders"))
    return listinfo, cats_limit, paths


def cmd_train(args) -> None:
    import torch

    from disn_tpu_torch import device as device_mod
    from disn_tpu_torch.data import pipeline
    from disn_tpu_torch.train import checkpoint, trainer
    from disn_tpu_torch.utils.logging import MetricLogger, Timer

    dev = device_mod.resolve(args.device)
    cfg = apply_overrides(Config(), args.set)
    logger = MetricLogger(args.log_dir)
    logger.log(f"config: {cfg.to_json()}")
    cfg.save(os.path.join(args.log_dir, "config.json"))

    listinfo, cats_limit, paths = data_handles(cfg, args.data_root, "train")
    loader = pipeline.make_loader(cfg, paths, listinfo, cats_limit,
                                  epochs=args.epochs, workers=args.workers,
                                  seed=args.seed, device=dev)
    state = trainer.create_state(cfg, seed=args.seed, device=dev)
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
            state.state_tree()["params"], donor.get("params", donor),
            scopes=scopes, skip_substr=skip)
        state.load_params(merged)
        logger.log(f"restored {donor_path} (scopes {scopes or 'all'}); "
                   f"skipped {len(skipped)} leaves")

    step_fn = trainer.make_train_step(cfg, device=dev)
    mgr = checkpoint.CheckpointManager(args.log_dir, period=10)
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
            if (i + 1) % bpe == 0:
                epoch = (i + 1) // bpe
                acc = float(acc_sum) / acc_n
                tree = state.state_tree()
                mgr.save_epoch({"params": tree["params"]}, epoch, metric=acc)
                mgr.save_latest(tree, state.step)
                logger.log(f"epoch {epoch} done; acc {acc:.4f}")
                acc_sum.zero_()
                acc_n = 0
    finally:
        loader.shutdown()
        logger.close()


def cmd_create_sdf(args) -> None:
    from disn_tpu_torch import convert
    from disn_tpu_torch import device as device_mod
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.utils.logging import MetricLogger

    if args.multi_view:
        raise NotImplementedError("--multi-view: the multiview fusion is "
                                  "not ported yet (ROADMAP item 14)")
    if args.cam_est:
        raise NotImplementedError("--cam-est: the camera net is not ported "
                                  "yet (ROADMAP item 13)")
    dev = device_mod.resolve(args.device)
    cfg = apply_overrides(Config(), args.set)
    logger = MetricLogger(args.log_dir, name="test")
    listinfo, _, paths = data_handles(cfg, args.data_root, args.split)
    donor = convert.load_npz(args.restore)
    written = pipeline.reconstruct_split(
        donor.get("params", donor), cfg, paths, listinfo, args.log_dir,
        sparse=not args.dense, logger=logger, shard_index=args.shard,
        shard_count=args.shards, device=dev)
    logger.log(f"wrote {len(written)} meshes")
    logger.close()


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
        description="SDF training with the folded forward pass. The visual "
                    "dumps of the JAX package's --dump-every need the "
                    "unfolded forward pass, which the port does not have "
                    "yet, so that option is not accepted.")
    _common(p)
    p.add_argument("--data-root", required=True)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--restore", default=None,
                   help="params from a checkpoint (shape mismatches skipped)")
    p.add_argument("--restore-cnn", default=None,
                   help="encoder-only init (scope vgg_16, fc8 skipped)")
    p.add_argument("--resume", default=None,
                   help="full-state resume (params + optimizer + step) from "
                        "a checkpoint file or a run dir's latest.npz; "
                        "either package's")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("create-sdf", help="test-split reconstruction")
    _common(p)
    p.add_argument("--data-root", required=True)
    p.add_argument("--restore", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--cam-est", action="store_true",
                   help="not ported yet: raises")
    p.add_argument("--dense", action="store_true",
                   help="exact dense path (default: sparse two-level)")
    p.add_argument("--shard", type=int, default=0,
                   help="this worker's index in a reconstruction farm")
    p.add_argument("--shards", type=int, default=1,
                   help="total farm workers (one process per card)")
    p.add_argument("--multi-view", action="store_true",
                   help="not ported yet: raises")
    p.set_defaults(fn=cmd_create_sdf)

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
    return ap


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)

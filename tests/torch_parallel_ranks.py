"""The rank side of tests/test_torch_parallel.py: one function that a
spawned process runs as one rank of a gloo process group on the CPU. It
imports torch and the port only (never JAX), so that a spawned child
starts quickly, and writes its results with pickle to
``{out_dir}/rank{r}.pkl``; the test process reads them."""
import os
import pickle

import torch
import torch.distributed as dist


def _np(t):
    return t.detach().cpu().numpy()


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _step(cfg, params, batch, mesh):
    """One train step of the port on this rank's `batch` -> (losses as
    floats, every parameter leaf as numpy, by path)."""
    from disn_tpu_torch.train import checkpoint, trainer

    state = trainer.create_state(cfg, params=params, device="cpu",
                                 mesh=mesh)
    step = trainer.make_train_step(cfg, device="cpu", mesh=mesh)
    state, losses = step(state, batch)
    return ({k: float(v) for k, v in losses.items()},
            {path: _np(p) for path, p in checkpoint.leaves(state.params)})


def run(rank: int, world: int, init_file: str, inputs: dict,
        out_dir: str) -> None:
    """Every multi-rank check of the test module, in one process group."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    from disn_tpu_torch import parallel
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import dense, pipeline, sparse
    from disn_tpu_torch.ops import marching

    out = {}
    cfg = Config(**inputs["cfg"])
    params, batch = _tensors(inputs["params"]), inputs["batch"]

    # data parallel: 2 ranks x 4 rows of the 8-row batch
    mesh = parallel.make_mesh(data=world, points=1)
    out["train"] = _step(cfg, params, parallel.shard_batch(batch, mesh),
                         mesh)
    # the JAX package's 2D dry run: the sample points split over 'points'
    mesh = parallel.make_mesh(data=1, points=world)
    sl = parallel.point_slice(batch["sdf_pt"].shape[1], mesh)
    out["train points"] = _step(cfg, params, {
        k: v[:, sl] if k in ("sdf_pt", "sdf_pt_rot", "sdf_val") else v
        for k, v in batch.items()}, mesh)
    # a batch of 3 on 2 ranks: the fitting mesh is the first rank alone
    cfg3 = cfg.replace(batch_size=3)
    mesh = parallel.fitting_mesh(3)
    out["fitting"] = (None if mesh is None else mesh.grid.tolist())
    if mesh is not None:
        out["train 3"] = _step(cfg3, params, {k: v[:3] for k, v in
                                              batch.items()}, mesh)

    img, trans, box = inputs["img"], inputs["trans"], inputs["box"]
    for shape in ((1, world), (world, 1)):
        mesh = parallel.make_mesh(*shape)
        out[f"dense {shape}"] = _np(dense.dense_sdf(
            params, img, trans, box, cfg, device="cpu", mesh=mesh))
    mesh = parallel.make_mesh(data=1, points=world)
    out["dense plain"] = _np(dense.dense_sdf(
        params, img, trans, box, cfg.replace(fused_kernel="off"),
        device="cpu", mesh=mesh))
    with torch.no_grad():
        try:
            parallel.make_mesh(data=world + 1, points=1)
        except ValueError as e:
            out["bad mesh"] = str(e)
        stats = {}
        vol, count, esc, cap = sparse.sparse_volume_sharded(
            params, img, trans, box, cfg.replace(sdf_res=16), mesh,
            device="cpu", stats=stats)
        out["sparse"] = (_np(vol), count, esc, cap, stats["stripe_cells"])

        vol = torch.from_numpy(inputs["sphere"])
        ids, nc = marching._active_cells_ext(vol, 0.0)
        batch_ = 512
        n_iter = world * max(1, -(-nc // (batch_ * world)))
        rec, tq, slots = marching.sharded_records(
            vol, ids, nc, mesh, iso=0.0, n_iter=n_iter, batch=batch_)
        out["records"] = (_np(ids), nc, _np(rec), _np(tq), slots, n_iter)

        ocfg = Config(**inputs["octa_cfg"])
        octa = synthetic.analytic_octahedron_params(ocfg, r=0.6,
                                                    device="cpu")
        out["mesh"] = pipeline.image_to_mesh_sharded(
            octa, inputs["octa_img"], inputs["octa_trans"], ocfg, mesh,
            sdf_params=box,
            device="cpu")
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()

"""Typed configuration for disn_tpu_torch (a copy of disn_tpu's Config, so
that the port imports nothing of the JAX package).

Replaces the reference's ~40 per-script argparse flags (train/train_sdf.py:25-67,
test/create_sdf.py:24-64) and the mutually-exclusive architecture booleans
(--img_feat_twostream / --img_feat_onestream / --threedcnn / --binary / --tanh,
dispatch tree at models/model_normalization.py:81-215) with one dataclass and an
explicit variant enum.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Any


class Variant(enum.Enum):
    """Model topology (reference dispatch: model_normalization.py:81-215)."""

    TWOSTREAM = "twostream"  # main DISN: global stream + local-feature stream
    ONESTREAM = "onestream"  # conv1-3 local feats concat inside one decoder
    GLOBAL = "global"        # global-feature-only decoder
    THREEDCNN = "threedcnn"  # 3D deconv volume decoder from global embedding


class EncoderKind(enum.Enum):
    """Image encoder (reference ships AlexNet/ResNet as unused alternates,
    models/CNN/alexnet.py, models/CNN/resnet.py; every reference script uses VGG-16)."""
    VGG16 = "vgg16"
    ALEXNET = "alexnet"
    RESNET = "resnet"


# Per-encoder endpoint channel widths, in the order local features are
# concatenated (VGG: model_normalization.py:171-190).
ENCODER_CHANNELS: dict[EncoderKind, tuple[int, ...]] = {
    EncoderKind.VGG16: (64, 128, 256, 512, 512),
    EncoderKind.ALEXNET: (96, 256, 384, 384, 256),
    EncoderKind.RESNET: (64, 128, 256, 512),
}


# ShapeNet 13-category registry (reference: preprocessing/info.json:1-45).
CATS: dict[str, str] = {
    "airplane": "02691156",
    "bench": "02828884",
    "cabinet": "02933112",
    "car": "02958343",
    "chair": "03001627",
    "display": "03211117",
    "lamp": "03636649",
    "speaker": "03691459",
    "rifle": "04090263",
    "sofa": "04256520",
    "table": "04379243",
    "phone": "04401088",
    "watercraft": "04530566",
}

# Categories whose meshes are often inverted; the offline SDF generator checks
# the sign of the SDF at the center voxel for these
# (reference: preprocessing/create_point_sdf_grid.py:115-137).
INSIDEOUT_CATS = ("02958343", "02691156", "04530566")


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- model topology -------------------------------------------------
    variant: Variant = Variant.TWOSTREAM
    encoder: EncoderKind = EncoderKind.VGG16
    binary: bool = False          # 2-class sign logits instead of regression
    tanh: bool = False            # squash pred_sdf through tanh
    alpha: bool = False           # RGBA (4-channel) input images
    multi_view: bool = False      # decode from precomputed fused features
    rot: bool = False             # rotate sample points into view frame
    num_classes: int = 1024       # VGG global-embedding width (fc8 out)
    width_mult: float = 1.0       # scales encoder channel widths (tests/CI)
    img_h: int = 137
    img_w: int = 137
    vgg_size: int = 224           # encoder input resolution after resize

    # ---- training --------------------------------------------------------
    batch_size: int = 20
    num_sample_points: int = 2048  # SDF query points per example at train time
    num_points: int = 1            # surface points carried through the batch
    learning_rate: float = 1e-4
    lr_decay_step: int = 200_000   # in *samples* (batch index * batch_size)
    lr_decay_rate: float = 0.9
    lr_floor: float = 1e-6
    beta1: float = 0.5             # Adam beta1 (reference train_sdf.py:55)
    optimizer: str = "adam"        # "adam" | "momentum"
    momentum: float = 0.9
    weight_decay: float = 1e-5     # L2 on conv/fc kernels (wd in reference)
    sdf_weight: float = 10.0       # gt scaling inside the L1 loss
    mask_weight: float = 4.0       # near-surface loss up-weighting
    mask_margin: float = 0.01      # |gt| threshold for the near-surface mask
    iso_offset: float = 0.003      # subtracted from gt sdf when feeding
    max_epoch: int = 200
    cat_limit: int = 36_000        # per-category example quota per epoch
    regularization: bool = True

    # ---- data ------------------------------------------------------------
    sdf_res: int = 64              # inference grid resolution (cells per axis)
    num_sample_grid: int = 32_768  # offline stratified samples per object
    bandwidth: float = 0.1         # stratified-sampling SDF band
    expand_rate: float = 1.2       # distance-field bbox expansion
    iso_val: float = 0.003         # offline marching-cubes iso for GT meshes
    augcolorfore: bool = False
    augcolorback: bool = False
    backcolorwhite: bool = False
    shuffle: bool = True
    prefetch: int = 4              # host->device prefetch depth

    # ---- cam-pose estimation ----------------------------------------------
    cam_shift: bool = False        # predict a 2-DoF pixel shift head
    cam_loss_mode: str = "3DM"     # "3D" | "2D" | "3DM" | "all"
    shift_weight: float = 1.0

    # ---- numerics / hardware ----------------------------------------------
    compute_dtype: str = "float32"   # "bfloat16" for encoder conv compute
    sampling: str = "tf1"            # local-feature sampling: "tf1" is the
    # bit-exact 16-tap resize∘resample composition; "native" is the 4-tap
    # direct sample of the original maps (fast path, equivalent off-edge)
    data_axis: str = "data"          # mesh axis for batch sharding
    point_axis: str = "points"       # mesh axis for query-point sharding
    fused_kernel: str = "auto"       # fused sample+MLP decode kernel
    # ("auto" | "on" | "off"); serves twostream+tf1 inference on grids
    # whose R - 1 is a multiple of 4 (infer/fused.kernel_enabled): "off"
    # takes the plain decode, "on" raises on an ineligible config
    sparse_stride: int = 4           # fine cells per coarse cell per axis
    binary_sparse: bool = False      # opt-in: sparse culling for BINARY
    # heads uses sign-change dilation — heuristic, can miss features
    # thinner than ~2 coarse cells; default routes binary through the
    # exact dense path (the reference has no sparse binary either,
    # test/create_sdf.py:279-285)
    band_factor: float = 1.5         # cull margin x coarse cell diagonal
    # (sound for Lipschitz-1 SDFs at >=1.0; raise for fields with steeper
    # gradients, e.g. sqrt(3) for L1-ball-like nets)
    band_autocal: bool = True        # widen the cull band by the OBSERVED
    # coarse-grid Lipschitz constant max(1, max|dv|/h): a trained head that
    # over-reports |sdf| (slope > 1) would otherwise silently cull cells
    # the surface crosses — see infer/sparse.py and
    # tests/test_infer.py::test_steep_field_autocal (round-2 verdict #2)
    cell_cap_frac: float = 0.25      # active-cell cap / total coarse cells
    sparse_words: bool = True        # build the record words + change-bit
    # scan DIRECTLY from the fine kernel's per-cell output (5^3 halo
    # patches, ops/marching._sparse_cell_words): the dense [R^3] volume —
    # and its ~7 ms per-point value scatter, ~2 ms full-volume change
    # sweep, ~1 ms upsample at 257^3 — never materializes on the fused
    # latency path. Boundary-touching actives and band violations fall
    # back to the dense flow via the gov guard; False forces the dense
    # flow everywhere (A/B + exact-twin testing)
    compact_tq: bool = True          # once the speculation cache has
    # learned a vertex-count prediction, ship only the CROSSING edges' t
    # parameters (vertex order, ~nv bytes) instead of the full [slots, D]
    # stream — trades a device-side compaction scatter against ~45% fewer
    # record bytes. Default ON from the round-4 TPU A/B
    # (scripts/probe_tail_ab.py): compact+opt 131.2 ms vs masked+opt
    # 140.6 ms e2e at 257^3 — the ~30 ns/row scatter estimate was wrong
    # (the fetch-stream byte savings dominate on the ~52 MB/s link)

    # ---- inference ---------------------------------------------------------
    iso: float = 0.0               # marching-cubes iso surface at inference
    view_num: int = 24
    max_triangles: int = 1 << 21   # cap for on-device marching-cubes output

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def img_channels(self) -> int:
        return 4 if self.alpha else 3

    @property
    def local_feat_dim(self) -> int:
        """Per-point local feature width sampled from encoder endpoint maps.

        VGG twostream: conv1_2..conv5_3 -> 64+128+256+512+512 = 1472
        VGG onestream: conv1_2..conv3_3 -> 64+128+256 = 448
        (reference: model_normalization.py:171-190, 153-168); alternate
        encoders use their own endpoint widths (ENCODER_CHANNELS).
        """
        from disn_tpu_torch.models.vgg import scaled_width
        chans = [scaled_width(c, self.width_mult)
                 for c in ENCODER_CHANNELS[self.encoder]]
        if self.variant is Variant.TWOSTREAM:
            return sum(chans)
        if self.variant is Variant.ONESTREAM:
            return sum(chans[:3])
        return 0

    @property
    def grid_resolution(self) -> int:
        """Grid points per axis: sdf_res + 1 (reference create_sdf.py:69)."""
        return self.sdf_res + 1

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["variant"] = self.variant.value
        d["encoder"] = self.encoder.value
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        d["variant"] = Variant(d["variant"])
        d["encoder"] = EncoderKind(d["encoder"])
        return Config(**d)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "Config":
        with open(path) as f:
            return Config.from_json(f.read())


@dataclasses.dataclass(frozen=True)
class DataPaths:
    """Dataset path registry (reference: preprocessing/info.json +
    create_file_lst.get_all_info, preprocessing/create_file_lst.py:5-9)."""

    root: str = "data"

    @property
    def lst_dir(self) -> str:
        return os.path.join(self.root, "filelists")

    @property
    def sdf_dir(self) -> str:
        return os.path.join(self.root, "sdf")

    @property
    def rendered_dir(self) -> str:
        return os.path.join(self.root, "renders")

    @property
    def rendered_est_dir(self) -> str:
        """Image h5 tree with trans_mat replaced by posenet predictions."""
        return os.path.join(self.root, "renders_camest")

    @property
    def norm_mesh_dir(self) -> str:
        return os.path.join(self.root, "norm_meshes")

    @property
    def march_cube_dir(self) -> str:
        return os.path.join(self.root, "march_cube_objs")

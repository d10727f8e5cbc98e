"""Smoke run of disn_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Run from the repository root on a machine with one CUDA card, nvcc and a
host C++ compiler. It imports nothing of JAX or disn_tpu. Phases, each fatal
on failure:

1. build every kernel of the port from csrc/ (nvcc, sm_90a: fused_decode.cu,
   metrics.cu, sparse_words.cu, band_cull.cu, block_compact.cu,
   change_scan.cu, owned_extract.cu and mv_taps.cu) and,
   beside them, the host mesh assembler from native/meshassemble.cpp and
   the OBJ formatter, OBJ parser and voxelizer of evaluation (g++), all
   started together, and report the build seconds and the compiler's
   register/shared-memory/wgmma report; a wgmma the compiler serialised,
   or a spill in K1's f32 kernel, fails the run;
2. drive the main path, pipeline.image_to_mesh with the default Config at
   sdf_res=256 on the full-width VGG-16 two-stream net (analytic octahedron
   head, r=0.6, the demo camera): a warm-up image and 3 fresh seeded u8
   images in bf16, then one image in f32 with TF32 off, with the K1, K5,
   K4 (band_cull, band_tau, active_cells) and compaction counts set to 0
   just before and read just after (K4's fused entry, tau and the cull in
   one launch, once an image; the compaction at least once).
   Every image must take
   the sparse-words flow (route records_sparse, guard 0: K1 in the coarse
   and the fine pass, K5 once on the fine rows, the record route's host
   assembly), with > 1000 faces and every vertex on |x|+|y|+|z| = 0.6
   within SURFACE_TOL + 3 x span/(R-1)/510 (the records' u8 edge
   parameter), no K2s or K7 call. Then the volume flow (sparse_words=False)
   on the same 4 bf16 images, its counts set to 0 just before and read
   just after (8 K1 launches, no K5, 4 fused K4 calls, 4 compactions, 4
   candidate scans (K2s) and 4 owned extractions (K7); the seed's and
   the first hit's scan and extraction inputs kept): route
   owned_ids, guard 0, within SURFACE_TOL; the two
   flows' meshes have equal faces, in order, and vertices within
   span/(R-1)/510 + 1e-6. The inputs of K1's two launches and K5's one for
   one bf16 image and the f32 image are kept; [swords hold]: on that bf16
   image the words flow and the volume flow from one phase_a give equal
   block rows, cell counts and (rec, tq) on every slot; K5 (the whole step:
   own-slot table, guard, zeroing and words in one library call) equals its
   plain version bit for bit on the kept inputs (timed: the step's events
   and the wrapper back to back) and on seeded random inputs at 257^3 (u8)
   and 65^3 (u16) with absent neighbours, rows at the iso, ragged counts,
   no cells, and lattices with every or no neighbour active and padded
   ids, and with the count as a 0-d int32 on the card (the speculative
   dispatch's: padded, none, past the cells); [k5 profile]: torch.profiler
   over 8 steps sees the library's memset and two kernels, each at most
   once a step, and no other device work; [spec]: the speculative dispatch (phase_spec) on 48 seeded
   images whose analytic head's radius varies, each against the seed path
   (_SPEC_CACHE cleared) bit for bit, the single-image walls of the hits
   and of the seed path in turns, each re-run kind forced once (short
   block and record buckets, compaction overflow, guard trip, cap
   overflow) and held the same way, and a warm _fused_dispatch under
   torch.cuda.set_sync_debug_mode("error"); [vspec]: the volume flow's
   speculative dispatch (phase_vspec, sparse_words=False) the same way on
   48 images, its hits' kernel launches counted (K1 twice, K4 once, the
   capped compaction once an image), the calling thread's waits and
   launch calls an image under torch.profiler through the seed path and
   as hits, every kind of its re-runs forced (blocks, planes, guard,
   overflow, extract, cap), the sync-free dispatch, and a surface the box
   cuts: the words guard pins (cfg, iso), then a volume-flow hit with the
   boundary planes; [scan owned]: K2s (csrc/change_scan.cu, the candidate
   scan) and K7 (csrc/owned_extract.cu, the owned extractor) against
   their plain versions bit for bit over their whole outputs, on the
   volume flow's kept seed (exact forms) and hit (fixed forms), on 49^3,
   65^3, 129^3 and 100^3 (full scan) grids, on a surface the box cuts
   (ghost cells), on no cell, every cell, +-0.0, NaN and values at the
   iso, and with slots past the cells, count 0 and a list the slots do
   not cover (missing > 0, the exact route raising where the plain one
   raises), the capped compaction's lists and zero rows; K7 through the
   scan's rows (the main path's route; no K7 call over the main path and
   [vspec] takes the dense owner table) and held to its dense route
   too; each wrapper on CUDA events (median of 20) beside the plain
   version and its bound, its kernels by torch.profiler, its launch
   calls (at most 3 a scan, 3 an extraction with no memset, no copy),
   K7's scratch a call (at most 2 MB at 257^3), the whole scan and
   extractor in turns with --parent DIR's (its own K7 build; else the
   plain versions'), and a volume-flow hit's launch calls an image with
   the plain versions (PlainScanOwned), --parent's K7 and the kernels
   (at least 150 fewer);
3. hold K1 against its plain PyTorch version on the card, timing both with
   CUDA events: (a) on those kept main-path inputs; (b) at the same two
   shapes (the coarse pass: all 4,096 cells of the 65^3 grid; the fine
   pass: the main path's active cells of the 257^3 grid) with seeded random
   full-width head weights and a random map, which exercise the feature
   sampling and the local stream that the analytic head zeroes, in float32
   and bfloat16, with the demo camera and one whose w=0 plane cuts the box;
   (c) at ragged cell counts (1, 3, 5 and the fine pass's count minus one,
   which the bf16 wrapper pads to whole clusters), the same way; (d) on 200
   random cells of a 49^3 grid, whose spacing 2/48 is inexact in f32 (the
   main path's 2/64 and 2/256 are exact), the same way; then [k1 turns]:
   K1 on the kept main-path inputs of both passes in f32 and bf16 through
   each checkout's own wrapper launch, in turns with --parent DIR's K1
   (parent, change, change, parent), per pass and per image beside the
   bound;
4. hold the extraction routes against each other on the card, on the volume
   flow's volume and scan of one bf16 main-path image (257^3) and of an f32
   image at sdf_res=48 (49^3): the candidate scan's ids equal the full
   scan's; the full-scan owned route equals the owned_ids route exactly
   (and the volume flow's mesh); owned against marching_tets + weld as
   vertex and triangle sets, with the Euler characteristic; the record
   route through the C++ passes (faces identical, vertices within the
   quantisation bound); the C++ passes against assemble_mesh_np on the same
   records. At 49^3 also: grid-point coordinates (plane_points, _world) and
   extracted vertices against an IEEE f32 evaluation on the host (equal)
   and a float64 one (1 ulp);
5. time every part of both routes and of marching_tets + weld at 257^3
   (median of 5 after a warm-up; CUDA events around device parts, the host
   clock around host parts and copies) beside a bound from the run's sizes;
   [flows ab]: the two flows' wall time on 10 more images, in turns (not
   gated); [phase_a profile]: torch.profiler over one phase_a of that image
   (idle share, top ops and kernels), and [k4]: K4 (csrc/band_cull.cu:
   tau and the cull in one launch of one 16-CTA cluster) against its
   plain versions through each entry (fused, tau, cull) on the main
   path's 65^3 grid (tau's bits, ids and count in the exact and the fixed
   form, both modes, past the cap), on edge grids (no active cell, every
   cell, corners at +-0.0, NaN and +-inf) and on 129^3 and a ragged
   100^3 grid; one launch a call; the fused call and the plain pair timed
   on CUDA events beside the bound, its kernel's device time by the
   profiler (that kernel and no other device work), host us a call,
   clusters of 16 and 8 CTAs in turns, and with --parent DIR that
   checkout's K4 in turns (parent, change, change, parent: wrapper ms,
   device us, host us); phase_a's launches and stage with the plain
   versions (PlainCulls) and with the kernel, in turns; [compact]: the
   compaction (csrc/block_compact.cu, one cluster launch capped, two
   exact) against its plain version on the main path's words-flow launch
   (capped, sparse row ids) and volume-flow launch (exact, flat ids),
   past b2, at b2's edge, with no change bit, every block and a 513^3
   grid; one launch capped, at most two exact, no copy call; timed beside
   its bound and torch.nonzero on the same block mask (the selection
   alone), 16 and 8 CTAs and --parent DIR's in turns; and the main path's
   launches an image (every runtime launch call, one image_to_mesh under
   torch.profiler each) and
   its single-image wall in turns with the plain versions and with the
   kernels; then [dist] (disn_tpu_torch/parallel):
   pipeline.image_to_mesh_sharded on the kept bf16 image at 257^3 over a
   1-rank NCCL group in this process (a warm-up, then one timed call: K1
   twice, no dense fallback, the main path's faces, every vertex on the
   surface within SURFACE_TOL + the records' u8 step), then over 2 gloo
   ranks that share card 0 (spawned processes: the same gates on each
   rank, each rank's K1 stripe by CUDA events, its share of the active
   cells and the gather's time) with one data-parallel step of the default
   Config (2 x B/2 rows) whose loss must be within DIST_LOSS_RTOL of the
   single step's on the same batch; 2 NCCL ranks on card 0 (NCCL refuses
   them; the first line of its error is printed); and, with 2 cards, the
   image over NCCL with a card a rank (else a line says it did not run);
6. evaluate. [eval hold]: K6a-K6d (metrics.cu: nn_distance, approx_match,
   match_cost and its gradient) against their plain PyTorch versions on
   the card in the protocol's argument order, at B = 24, N = M = 2048 on
   vertices drawn from the main path's bf16 257^3 mesh (predictions) and
   an f32 mesh of the same head at sdf_res 128 (GT), and on seeded randn
   clouds (both timed with CUDA events after a warm-up, the kernels'
   wrappers median of 20, the plain versions of 5, beside a bound and, for
   K6a, torch.cdist), and at B = 3 with (N, M) =
   (2048, 1000), (1000, 2048), (2047, 1537) and at B = N = M = 1; the
   tolerances and their reasons are the constants NN_ULPS ... NN_BWD_REL_TOL;
   on every shape: K6a bit for bit the lowest-index minimum both ways of
   its own gram_d tile (approx_match_d_tile) on the first 128 x 512 points,
   as drawn and with duplicated points and exact ties; the kernels' norms
   (sq3) equal to _sq's bits; K6b and its f32 plain version against the
   float64 referee (eval/referee.py: the marginals per xyz1 and per xyz2
   point and the EMD), K6b within 2x the plain version's distance + 1e-7,
   and with --parent DIR that checkout's K6b measured beside them; K6c
   within 2x the f32 plain version's distance from match_cost_plain in
   float64 + 1e-6 relative; K6d (one launch a backward) within
   GRAD_REL_TOL of the plain backward and within 2x the f32 plain
   version's distance from match_cost_grad_plain in float64 + 1 ulp of
   max g x max marginal (eval/referee.py), --parent DIR's K6d measured
   beside it; at the protocol's shapes K6b's split by pass
   (torch.profiler) beside its bound and the three-pass floor, K6a's,
   K6c's and K6d's kernel alone (CUDA events around the library call) and
   wrapper's work, in turns with --parent DIR's (parent, change, change,
   parent), beside the bound and the floor (and K6d's distances from the
   float64 referee), and a torch.profiler split of one call of each (the
   library's device work and nothing else); nn_distance's backward on the
   card against the CPU. [eval farm]:
   reconstruct_split writes 2 objects x 24 views from in-memory records
   (seeded u8 images, the demo camera; full-width net, analytic head,
   sdf_res 256, bf16), evaluate_tree scores them on the card against GT
   meshes written with the port's write_obj (K6a-K6c launched, every value
   finite, F1 at 20% = 1.0), the images per second and each object's host
   and device halves are printed, K6b and K6d are held to their float64
   referees on each object's clouds as on [eval hold]'s, and 1 object x 4
   views is
   scored again
   on the CPU (CD and EMD within 1e-3 relative, precision and recall
   within 1/2048, IoU equal) and with the device IoU on both, which
   samples the surface: its occupancy is held to that design's bounds and
   its IoU on the card to the CPU's over 8 seeds (hold_device_iou).
   [farm pipe]: reconstruct_split's depth-deep pipeline on the same 2
   objects x 24 views: the tree of image_to_mesh + write_obj on the
   calling thread, then the parent's loop (image_to_mesh on the calling
   thread, writes on a pool) and the farm at depth 1, 2 and 3 in turns,
   twice, each tree byte for byte that one, K1 x2 and K5 x1 an image (counts set to 0
   just before each run and read just after) and every image a hit of the
   speculative dispatch, the C++ assembly passes
   called 0 times on the calling thread (PassSpy); images/s, the pool's
   time in the passes, and, from one depth-2 run under torch.profiler,
   the calling thread's time in the runtime's waits an image; with
   --parent DIR, DIR's farm and this tree's at depth 1-3, each in a fresh
   worker process, in turns (parent, change, change, parent), their trees
   the same reference's byte for byte, and their waits. All of it also on
   the volume flow (sparse_words=False; tagged [vspec farm]: K1 x2 and no
   K5 an image, no C++ pass).
   [closed loop]: tools.closed_loop's gt-cam row (sdf_res 256, bf16, full
   width: the ground truth's face count, IoU >= CL_IOU, F1 = 1 at 20%,
   CD and EMD within CL_FLOOR_RATIO of their noise floor) and cam-est row
   (the bundled camera net: its camera within CL_CAM_REL of the CPU's,
   > 1000 faces, finite metrics). [rehearsal]: tools.eval_rehearsal at 4
   objects x 24 views: finite metrics, 4 objects, the cached re-run equal
   to the run that filled the cache; objects/min, the 1,311-object
   extrapolation, and the host half split into parse, sample and voxelize;
7. train (the port's SDF training path; no kernel of its own): in-memory
   records of the synthetic dataset (3 shapes x 8192 stratified samples, 4
   views at 137^2) served through the port's SdfImageDataset, sampler and
   PrefetchLoader onto the card. [train hold]: the port's step on the card
   and on the CPU at width 0.25, B = 2, N = 256, TF32 off: the f32 loss,
   every gradient leaf in float64 (in f32 a ReLU input or L1 residual
   within rounding of 0 takes the other side on the other device, so the
   f32 gradients are only printed), one fused Adam update from the same
   gradients. [train f32] / [train bf16]: the default full-width Config
   (B = 20, N = 2048): 2 warm-up and 10 timed steps (CUDA events), samples
   per second, peak memory, the share of the wall time blocked on the
   loader; in f32 also 20 steps on one batch from a fresh seed-0 state,
   whose sdf_loss must fall (the median of the last 5 steps below that of
   the first 5).
   [train profile]: torch.profiler over 3 steps of each: idle share, top
   ops and kernels, the sampler's gather and scatter-add. [train ckpt]:
   latest.npz after step 3 holds exactly the JAX package's names, and
   restored into a fresh state it gives the same state and step-4 loss. [conv]:
   tools.train_convergence at its defaults (full width, bf16, B = 20,
   1500 steps, one training view reconstructed at sdf_res 256 and scored
   by K6a on 30,000 samples): sign accuracy >= 0.9, > 500 faces, a finite
   CD x 1000, printed beside the JAX package's TRAIN_CONV_r05.json;
8. the estimated-camera path (models/posenet, pipeline.reconstruct_image,
   pipeline.estimate_cameras, the camera train step; no kernel of its own:
   it runs K1 and K5 through image_to_mesh). [cam full]: a full-width
   camera net whose heads' last kernels are zeroed and whose biases
   predict the demo camera whatever the image, then reconstruct_image
   (the `demo` subcommand's body) on the main path's image 1 at sdf_res
   256, bf16, analytic head, its K1 and K5 counts set to 0 just before and
   read just after: the predicted camera within CAM_REL_TOL of the demo
   camera, route records_sparse, guard 0, K1 x2, K5 x1, and the mesh equal
   (faces in order, vertices) to the main path's mesh of that image; the
   net's forward at B = 1 and 64 (bf16 and f32, CUDA events, median of
   5), [cam profile]: its heads alone and one forward under
   torch.profiler, and the demo's wall time (median of 3). [cam farm]: estimate_cameras
   over 64 in-memory views in one forward (every camera the demo camera),
   then 4 of them through reconstruct_split(cam_est=True) and its keyword
   readers into the camest_ tree, every mesh over 1000 faces. [cam hold]:
   the bundled float16 nets (demo/tiny_posenet.npz, demo/tiny_synth.npz)
   through reconstruct_image on a torus view rendered in memory at sdf_res
   64, on the card and on the CPU: the cameras within CAM_HOLD_REL, the
   same route, face counts within CAM_HOLD_FACES, the symmetric max
   nearest-vertex distance within a cell. [cam train]: the camera step on
   the card and the CPU at width 0.25, B = 2, shift head on, every loss
   term: the f32 loss within CAM_LOSS_REL, every float64 gradient leaf
   within HOLD_GRAD_REL; then 20 full-width steps (B = 20) from a fresh
   seed-0 state on one batch, whose loss must fall (the median of the last
   5 below that of the first 5), with ms/step;
9. multi-view fusion (infer/multiview, pipeline.multiview_to_mesh and
   reconstruct_multiview; the folded arm's tap mean is K8, csrc/mv_taps.cu,
   where the reference has XLA's fusion; the MLPs are PyTorch ops, and
   neither K1 nor K5 runs). [mv taps]: K8 against mv_tap_mean_plain on
   the card at V = 24, 512 channels, on the maps the full-width net folds
   from 24 seeded u8 views, bf16 and f32, in the main path's decode steps:
   the coarse 65^3 grid, the fine points of the object's active cells,
   the boundary planes, points on the last row and column and off the
   image (clamped), a NaN projection; bit for bit (NaN where the plain
   version has NaN); K8, the plain version and grid_sample + mean (the
   yardstick) timed on a coarse step beside K8's bound. [mv full]:
   multiview_to_mesh on 24 seeded u8 views of one object under 24 cameras
   around the demo camera, full-width net with the analytic octahedron
   head, sdf_res 256: bf16 the median of 3 after a warm-up, the default
   Config (f32, TF32 off) once, the K1, K5 and K8 counts set to 0 just
   before each object and read just after (K1 and K5 0, K8 one launch a
   decode step): the sparse flow with no cap overflow, > 1000 faces,
   every vertex on the surface (f32 within SURFACE_TOL, bf16 within
   MV_BF16_SURFACE_TOL: the MLP rounds the head's output layer to bf16),
   the faces those of phase 2's volume-flow mesh; stage times, peak
   memory, active cells, decode steps, K8's time an object, the decode
   beside its bound (mv_bound); with --parent, bf16 objects in turns with
   that checkout's decode (its _mv_decode and decode_step); and [mv
   profile]: one bf16 object under torch.profiler, with no gather of the
   bf16 maps or nan_to_num kernel (the plain resampler's) on the card,
   and K8 held bit for bit against the plain version on that object's
   own launches (their inputs kept through mv_tap_mean.inputs). [mv hold]: the
   flow on the card against the CPU at width 0.25, V = 3, sdf_res 64,
   f32, random seeded params: the dense stream on the folded (tf1, K8 on
   the card) and the general (native) arm, the sparse flow's two phases
   on both arms and with a binary head (the sign cull), the dense
   fallback forced by a tiny cap, all within MV_HOLD_REL; the analytic
   head's sparse mesh against its dense mesh on the card; and _mv_decode
   on the coarse grid of a random full-width bf16 net at V = 24 with K8
   against the same with the plain version, both on the card, bit for
   bit. [mv cli]: `create-sdf --multi-view` through the port's CLI on the
   card on a temporary split of 2 objects x 3 views (in-memory readers),
   one fused mesh an object;
10. the other heads (binary and tanh, onestream, global, 3D-CNN, the
   unfolded forward pass, the fold modes, the train-time dump; no kernel
   of their own: K1 serves the binary twostream head). [var binary]: the
   analytic octahedron's binary head (logits (0, 10(s - r))), full width,
   257^3, a warm-up and 3 bf16 images and one f32 image through the exact
   dense route (K1 with out_dim 2 over all 262,144 cells, the planes by
   the plain decode) and the binary_sparse route (the sign cull), the K1
   and K5 counts set to 0 just before each route and read just after (1
   and 2 K1 launches an image): the routes' faces equal, vertices on the
   surface within SURFACE_TOL + binary_edge_tol (the field's curvature
   along a tet edge); stages, wall and K1 share; K1 on the dense launch's
   own inputs against its plain version (every 16th cell) and the whole
   launch timed beside its bound (k1_macs(2)). [var onestream] / [var
   global]: image_to_mesh at full width, 257^3, with the analytic head
   copied into the variant's MLP (var_analytic_params), a warm-up and 3
   bf16 images and one f32 image, counts set to 0 before each: no K1 or
   K5 launch, the sparse volume flow by the plain decode, the main path's
   faces, vertices on the surface (f32 SURFACE_TOL, bf16
   MV_BF16_SURFACE_TOL), the decode beside var_bound. [var 3dcnn]: the
   full-width forward to 65^3 (f32 and bf16, median of 5, peak memory),
   meshed at its median. [var train]: the onestream step at the default
   Config's width (B = 20, N = 2048, f32), ms/step and peak memory, the
   falling-loss gate from a fresh seed-0 state; `train --dump-every 1`
   through the CLI on the card at width 0.125 (in-memory h5 readers):
   every step's three dump files. [var hold]: card against CPU at width
   0.25, sdf_res 64, f32: twostream by fold 'none', 'local' and '137'
   under fused_kernel 'off' and 'auto' (K1 once only for '137' + 'auto'),
   native sampling, onestream, global, a binary + tanh twostream head
   (K1), a binary onestream head through the sign cull, the 3D-CNN
   volume, each within VAR_HOLD_REL. Phase 3 also holds K1 with out_dim 2
   (random binary heads) at the main path's shapes, ragged counts and
   49^3, in both types;
11. the alternate encoders and RGBA input (models/encoders; no kernel of
   their own: cuDNN convolutions, as VGG-16's, and K1 in both passes).
   [enc full]: image_to_mesh at sdf_res 256 on the full-width twostream
   net with AlexNet, ResNet-18 and VGG-16 on RGBA u8 images (alpha=True),
   analytic octahedron head, bf16 and f32 (TF32 off): a warm-up and 3
   fresh seeded images a run, K1's count set to 0 before each run and read
   after (2 an image), run_main_path's gates (words flow, vertices on the
   surface), the faces of phase 2's VGG-16 RGB mesh of the same type;
   encode_ms, prep_ms, wall_ms and K1's ms (medians) beside K1's bound.
   [enc k1]: K1 against its plain version on each encoder's fold-137 map
   and g_contrib of an RGBA image (full width, random head), f32 and bf16,
   at the main path's coarse and fine shapes. [enc hold]: card against CPU
   at width 0.25, f32, for each encoder with and without alpha: the
   embedding, every endpoint and the fold-137 map within ENC_HOLD_REL; one
   train step's loss for AlexNet and ResNet on RGBA within HOLD_LOSS_REL;
12. the offline tools (preprocessing, postprocessing, the CLI's
   preprocess-sdf and synth; no kernel: the extraction is ops/marching's
   PyTorch marching_tets). [prep sdf]: sdf_gen's two halves on an
   icosphere at sdf_res 256 with in-memory writers: the host distance
   field's seconds, marching_tets on the card and the weld's ms; every
   sample within the bandwidth, every ground-truth vertex on the iso
   surface within PREP_SURFACE_CELLS of a cell, the CPU's mesh of the same
   volume equal; [prep weld]: the same soup welded on the card
   (marching.weld_device) equal bit for bit to the host weld, both timed;
   preprocess-sdf through the CLI on the card with --jobs 2
   equal to --jobs 1. [prep tools]: generate_object_views, clean_mesh_file
   on a mesh with a stray part, synth through the CLI (h5 in memory) and
   read_dist of the .dist files it wrote;
13. print per-stage times of both flows, each main-path K1 launch's share
   of its bound (bf16 and f32, per pass and per image) and the weight bytes
   it moves from L2, the card, and the kernel table as JSON (K1's bf16 and
   f32 kernels, K5's, K4's and the compaction's launches from the main
   path's run of phase 2, K2s's and K7's from its volume-flow run, K6's
   from the farm's evaluate_tree, where K6d is not called: it serves
   autograd).

A torch.profiler window that a check reads is taken again, up to
PROFILE_TRIES windows, when it misses a device event the traced work
always launches (the profiler drops events now and then); every window
taken is printed and the check reads the last one.

The last line is {"ok": true, "device": {...}}; any failure exits non-zero
before printing it.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12     # FMA units, no tensor cores
H100_BYTES_PER_S = 3.35e12
# K1 against its plain version: f32 differs only in summation order; bf16
# bounds are tests/test_fused.py's (both sides round to bf16 per layer,
# and f32 accumulation order decides ties)
F32_REL_TOL = 1e-4
BF16_MAX_REL, BF16_MEAN_REL = 0.02, 0.003
# K1's weight stream per fetch (one fetch serves a cluster of cells): w2,
# w3, wp, w4 of both streams in the compute type (2 or 4 bytes) plus
# small_params' f32 biases, w1 and w5
K1_GEMM_WEIGHTS = 2 * (64 * 256 + 256 * 512 + 512 * 512 + 512 * 256)
K1_WEIGHT_BYTES = {"bf16": 2 * K1_GEMM_WEIGHTS + 2 * 2308 * 4,
                   "f32": 4 * K1_GEMM_WEIGHTS + 2 * 2308 * 4}
RAGGED_CELLS = (1, 3, 5)
# vertex distance from the octahedron surface |x|+|y|+|z| = 0.6. Grid
# coordinates k/128 - 1 are exact in bf16, and near the surface their sum
# (in [0.5, 1), a multiple of 1/128) is too, so the analytic head's field
# is exact at grid points up to f32 rounding in both types, and a vertex
# (interpolated in f32 along a tet edge on which the field is linear) is
# off the surface by f32 rounding alone: a few ulp(0.6) = 6e-8. 1e-5 is
# ~100x that and still catches a 0.1% error in the head's output.
SURFACE_TOL = 1e-5
TRANS_W0_IN_BOX = np.vstack([np.eye(3) * 60, [68.0, 68.0, 2.0]]
                            ).astype(np.float32)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def k1_macs(out_dim: int) -> int:
    """Multiply-adds per point, both streams."""
    return 2 * (3 * 64 + 64 * 256 + 256 * 512 + 512 * 512 + 512 * 256
                + 256 * out_dim)


def k1_bound(args, kw) -> tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes") for one K1
    call: each input read once, the output written once, the MACs at the
    tensor-core (bf16) or FMA (f32) peak."""
    import torch
    fmap, weights, trans, geom, cells = args
    out_dim = weights[10].shape[1]
    n_pts = cells.numel() * 64
    flops = 2.0 * n_pts * k1_macs(out_dim)
    nbytes = (sum(t.numel() * t.element_size()
                  for t in (fmap, *weights, trans, geom, cells))
              + n_pts * out_dim * 4)
    peak = H100_BF16_FLOPS if fmap.dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> None:
    """nvcc on the eight kernel sources and the host compiler on the mesh
    assembler and the evaluation library, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from disn_tpu_torch import native
    from disn_tpu_torch.eval import metrics
    from disn_tpu_torch.ops import (band_cull, block_compact, change_scan,
                                    fused_decode, mv_taps, owned_extract,
                                    sparse_words)

    def timed(build):
        t0 = time.perf_counter()
        build()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(10) as pool:
        (k1_s, k6_s, k5_s, k4_s, kc_s, ks_s, k7_s, k8_s, asm_s,
         eio_s) = pool.map(
            timed, (fused_decode.build, metrics.build, sparse_words.build,
                    band_cull.build, block_compact.build, change_scan.build,
                    owned_extract.build, mv_taps.build, native.build,
                    native.build_eval))
    secs = fused_decode.build_seconds()
    native._lib()
    native._eval_lib()
    metrics._lib()
    sparse_words._lib()
    band_cull._lib()
    block_compact._lib()
    change_scan._lib()
    owned_extract._lib()
    mv_taps._lib()
    print(f"[build] fused_decode.cu built in {k1_s:.2f} s (loaded in "
          f"{secs:.2f} s); meshassemble.cpp built in {asm_s:.2f} s -> "
          f"{native.build().parent.name}/{native.build().name}")
    print(f"[eval build] metrics.cu built in {k6_s:.2f} s -> "
          f"{metrics.build().name}; objwriter/objreader/voxelsat.cpp built "
          f"in {eio_s:.2f} s -> {native.build_eval().name}")
    print(f"[swords build] sparse_words.cu built in {k5_s:.2f} s -> "
          f"{sparse_words.build().name}")
    print(f"[cull build] band_cull.cu built in {k4_s:.2f} s -> "
          f"{band_cull.build().name}; block_compact.cu in {kc_s:.2f} s -> "
          f"{block_compact.build().name}")
    print(f"[scan owned build] change_scan.cu built in {ks_s:.2f} s -> "
          f"{change_scan.build().name}; owned_extract.cu in {k7_s:.2f} s -> "
          f"{owned_extract.build().name}")
    print(f"[mv taps build] mv_taps.cu built in {k8_s:.2f} s -> "
          f"{mv_taps.build().name}")
    keys = ("registers", "spill", "smem", "wgmma", "Performance",
            "setmaxnreg", "entry function")
    for tag, lib in (("[build]", fused_decode.build()),
                     ("[eval build]", metrics.build()),
                     ("[swords build]", sparse_words.build()),
                     ("[cull build]", band_cull.build()),
                     ("[cull build]", block_compact.build()),
                     ("[scan owned build]", change_scan.build()),
                     ("[scan owned build]", owned_extract.build()),
                     ("[mv taps build]", mv_taps.build())):
        log = lib.with_suffix(".log").read_text()
        for line in log.splitlines():
            if any(k in line for k in keys):
                print(f"{tag} {line.strip()}")
        check("serialized" not in log,
              f"the compiler serialised wgmma instructions (see {lib.name}"
              ".log)")
    f32 = [r for name, r in ptxas_report(
        fused_decode.build().with_suffix(".log").read_text()).items()
        if "3f32" in name and "decode_kernel" in name]
    print(f"[build] f32 K1 kernel: {f32}")
    check(len(f32) == 1 and f32[0]["spill_stores"] == 0
          and f32[0]["spill_loads"] == 0,
          f"ptxas reports spills in the f32 K1 kernel (or no f32 kernel): "
          f"{f32}")


def ptxas_report(log: str) -> dict:
    """The ptxas -v report per entry function: stack frame, spill stores
    and loads (bytes) and registers."""
    import re
    out = {}
    for m in re.finditer(r"Function properties for (\S+)\n\s*(\d+) bytes "
                         r"stack frame, (\d+) bytes spill stores, (\d+) "
                         r"bytes spill loads\n.*?Used (\d+) registers", log):
        out[m.group(1)] = dict(stack=int(m.group(2)),
                               spill_stores=int(m.group(3)),
                               spill_loads=int(m.group(4)),
                               registers=int(m.group(5)))
    return out


def hold_k1(label: str, args, kw, timed: bool = True) -> dict:
    """One K1 call against fused_decode_plain on the same inputs: check the
    tolerance, and time both unless `timed` is false. These launches are
    made after the main path's counts were read."""
    import torch
    from disn_tpu_torch.ops import fused_decode

    k1, plain = fused_decode.fused_cell_decode, fused_decode.fused_decode_plain
    got = k1(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"K1 {label}: non-finite output")
    err = (got - want).abs()
    scale = max(want.abs().max().item(), 1e-3)
    max_err, mean_err = err.max().item(), err.mean().item()
    if args[0].dtype == torch.float32:
        ok = max_err <= F32_REL_TOL * scale
    else:
        ok = (max_err <= BF16_MAX_REL * scale
              and mean_err <= BF16_MEAN_REL * scale)
    ms = cuda_ms(lambda: k1(*args, **kw), 5) if timed else float("nan")
    plain_ms = (cuda_ms(lambda: plain(*args, **kw), 2) if timed
                else float("nan"))
    bound_ms, bound_by = k1_bound(args, kw)
    print(f"[k1] {label} cells={args[4].numel()} fine_r={kw['fine_r']} "
          f"max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e} "
          f"max|want|={scale:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) ok={ok}")
    check(ok, f"K1 {label} disagrees with its plain version: max "
              f"{max_err:.3e} mean {mean_err:.3e} scale {scale:.3e}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def random_k1_args(dtype, cam, main_args, seed: int = 0,
                   out_dim: int = 1):
    """Seeded random full-width head weights (non-zero biases; out_dim 2:
    the binary head's two logits) and folded map in `dtype`, with the cell
    ids and geometry of a main-path launch."""
    import torch
    from disn_tpu_torch.models import sdfnet
    from disn_tpu_torch.ops import fused_decode

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    binary = out_dim == 2
    params = {"sdfprediction": sdfnet.init_global_head(gen, dev, 1024,
                                                       binary),
              "sdfprediction_imgfeat": sdfnet.init_local_head(gen, dev,
                                                              1472, binary)}
    for scope in params.values():
        for layer in scope.values():
            for p in layer.values():
                p["biases"] = 0.1 * torch.randn(
                    p["biases"].shape, generator=gen, device=dev)
    g_contrib = torch.randn(1, 512, generator=gen, device=dev).to(dtype)
    fmap = (0.5 * torch.randn(137, 137, 512, generator=gen, device=dev)
            ).to(dtype)
    weights = fused_decode.pack_weights(params, g_contrib, dtype)
    trans = torch.from_numpy(np.ascontiguousarray(cam)).to(dev)
    _, _, _, geom, cells = main_args
    return fmap, weights, trans, geom, cells


def phase_k1_check(kept: dict) -> dict:
    """Hold K1 against its plain version on the main path's own inputs, and
    with random weights (a one-logit head, timed, and the binary head's
    two logits) at its shapes, at ragged counts and on a 49^3 grid.
    Returns the results by label."""
    import torch
    from disn_tpu_torch.data import synthetic

    res = {}
    for dt in ("bf16", "f32"):
        for (args, kw), pass_ in zip(kept[dt], ("coarse", "fine")):
            res[(dt, "main", pass_)] = hold_k1(f"{dt} main-path {pass_}",
                                               args, kw)
    args_by_pass = dict(zip(("coarse", "fine"), kept["bf16"]))
    fine_args, fine_kw = args_by_pass["fine"]
    n_fine = fine_args[4].numel()
    for dtype, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for cam_name, cam in (("demo", synthetic.demo_trans_mat()),
                              ("w0_plane_in_box", TRANS_W0_IN_BOX)):
            # out_dim 2 (the binary head's logits, its own epilogue) beside
            # the one-logit head, on every run; timed for out_dim 1 only
            for out_dim in (1, 2):
                head = "" if out_dim == 1 else " out_dim=2"
                for pass_, (margs, kw) in args_by_pass.items():
                    args = random_k1_args(dtype, cam, margs,
                                          out_dim=out_dim)
                    label = f"{dt} random camera={cam_name}{head} {pass_}"
                    held = hold_k1(label, args, kw, timed=out_dim == 1)
                    res[(dt, cam_name + head, pass_)] = held
                    if pass_ != "fine":
                        continue
                    for n in (*RAGGED_CELLS, n_fine - 1):
                        ragged = (*args[:4], args[4][:n].contiguous())
                        hold_k1(f"{dt} random camera={cam_name}{head} "
                                f"ragged n={n}", ragged, kw, timed=False)
                args = random_k1_args(dtype, cam,
                                      (*fine_args[:3], *grid49()),
                                      out_dim=out_dim)
                hold_k1(f"{dt} random camera={cam_name}{head} grid 49^3",
                        args, dict(fine_r=49, coarse_c=12, img_w=137,
                                   img_h=137), timed=False)
    return res


def grid49() -> tuple:
    """(geom, cell ids): the box [-1, 1]^3 and 200 seeded random cells of
    the 12^3 coarse grid of a 49^3 fine grid."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cells = torch.randperm(12 ** 3, generator=gen, device=dev)[:200]
    return (torch.tensor([-1, -1, -1, 1, 1, 1.0], device=dev),
            cells.sort().values.int())


def print_k1_shares(kept: dict, res: dict) -> None:
    """Each main-path launch's share of its bound, per pass and per image,
    in both types, and the weight bytes the design moves from L2 for it:
    one fetch per cluster of cells."""
    from disn_tpu_torch.ops import fused_decode

    cluster = fused_decode._lib().fused_decode_cluster()
    for dt in ("bf16", "f32"):
        ref = [res[(dt, "main", p)] for p in ("coarse", "fine")]
        l2_total = 0
        for (args, kw), r, pass_ in zip(kept[dt], ref, ("coarse", "fine")):
            l2 = -(-args[4].numel() // cluster) * K1_WEIGHT_BYTES[dt]
            l2_total += l2
            print(f"[k1] {dt} main-path {pass_}: ms {r['ms']:.4f} bound "
                  f"{r['bound_ms']:.4f} share of bound "
                  f"{r['bound_ms'] / r['ms']:.4f}, l2_weight_bytes={l2} "
                  f"(cluster of {cluster})")
        ms, bound = sum(r["ms"] for r in ref), sum(r["bound_ms"] for r in ref)
        print(f"[k1] {dt} main-path per image: ms {ms:.4f} bound {bound:.4f}"
              f" share of bound {bound / ms:.4f}, l2_weight_bytes={l2_total}")


PARENT_K1: dict = {}  # another checkout's K1 (--parent): its wrapper, build


def k1_parent(root: str) -> dict:
    """Another checkout's K1: its wrapper module (ops/fused_decode.py, loaded
    under another name; it imports this checkout's helpers) and its
    csrc/fused_decode.cu built and bound. Builds whose C entry still takes
    the 24 weight pointers (before the f32 ring kernel) have no bind()."""
    import importlib.util

    from disn_tpu_torch import kernels

    spec = importlib.util.spec_from_file_location(
        "parent_fused_decode",
        os.path.join(root, "disn_tpu_torch", "ops", "fused_decode.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path = kernels.nvcc_build("fused_decode", src=os.path.join(
        root, "disn_tpu_torch", "csrc", "fused_decode.cu"))
    if hasattr(mod, "bind"):
        lib = mod.bind(path)
    else:
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_decode_launch.argtypes = [ci, vp, ctypes.POINTER(vp), vp,
                                            vp, vp, vp, vp, ci, ci, ci, ci,
                                            ci, ci, vp, vp]
        lib.fused_decode_launch.restype = ci
        lib.fused_decode_cluster.argtypes = []
        lib.fused_decode_cluster.restype = ci
    return {"module": mod, "lib": lib}


def time_k1_turns(kept: dict, res: dict) -> None:
    """K1 on the main path's kept launch inputs, both passes of an image in
    f32 and bf16: this checkout's kernel and, with --parent, that
    checkout's, each through its own wrapper's launch (tiles, padding,
    output allocation), in turns (parent, change, change, parent; CUDA
    events, mean of `reps` after a warm-up); else this checkout's twice.
    Prints each turn per pass and per image beside the bound, and how far
    the two builds' outputs are apart."""
    import torch
    from disn_tpu_torch.ops import fused_decode

    runs = {"change": (fused_decode, fused_decode._lib())}
    if PARENT_K1:
        runs["parent"] = (PARENT_K1["module"], PARENT_K1["lib"])
    order = (["parent", "change", "change", "parent"] if PARENT_K1
             else ["change", "change"])
    for dt, reps in (("f32", 3), ("bf16", 10)):
        turns = {p: [] for p in ("coarse", "fine")}
        for (args, kw), pass_ in zip(kept[dt], ("coarse", "fine")):
            fns = {k: (lambda m=m, lib=lib: m._launch(lib, *args, **kw))
                   for k, (m, lib) in runs.items()}
            turns[pass_] = [(k, cuda_ms(fns[k], reps)) for k in order]
            bound = res[(dt, "main", pass_)]["bound_ms"]
            print(f"[k1 turns] {dt} main-path {pass_} cells="
                  f"{args[4].numel()}: ms "
                  f"{[(k, round(t, 4)) for k, t in turns[pass_]]}, shares of "
                  f"the bound {bound:.4f} ms "
                  f"{[(k, round(bound / t, 4)) for k, t in turns[pass_]]}")
            if "parent" in fns:
                a, c = fns["parent"](), fns["change"]()
                rel = float((a - c).abs().max() / c.abs().max().clamp_min(
                    1e-30))
                print(f"[k1 turns] {dt} {pass_}: parent vs change max|diff|/"
                      f"max|change| {rel:.3e}")
        bound = sum(res[(dt, "main", p)]["bound_ms"] for p in turns)
        image = [(k, c + f) for (k, c), (_, f)
                 in zip(turns["coarse"], turns["fine"])]
        print(f"[k1 turns] {dt} main-path per image: ms "
              f"{[(k, round(t, 4)) for k, t in image]}, shares of the bound "
              f"{bound:.4f} ms {[(k, round(bound / t, 4)) for k, t in image]}")
    torch.cuda.synchronize()


def run_main_path(cfg, params, imgs, trans, label: str, keep: int,
                  kept: dict | None, meshes: dict) -> list[dict]:
    """image_to_mesh on each image; returns per-image stats. With
    cfg.sparse_words (the default) every image must take the sparse-words
    flow (route records_sparse: K1 twice, K5 once), otherwise the volume
    flow (owned_ids: K1 twice, no K5); either flow runs K4 (tau and the
    cull in one launch) once and the block compaction at least once an
    image. The inputs
    of image `keep`'s K1, K5 and compaction launches go into kept[label],
    kept[label + " k5"] and kept[label + " compact"] when `kept` is given;
    every image's mesh goes into meshes[label]."""
    import torch
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.ops import (band_cull, block_compact, fused_decode,
                                    sparse_words)

    k1 = fused_decode.fused_cell_decode
    k5 = sparse_words.sparse_cell_words
    culls = (band_cull.band_cull, band_cull.band_tau, band_cull.active_cells,
             block_compact.compact_block_bits)
    compact = culls[3]
    words = cfg.sparse_words
    route = "records_sparse" if words else "owned_ids"
    R = cfg.grid_resolution
    # the records' u8 edge parameter moves a coordinate by at most
    # cell/510, so |x|+|y|+|z| by at most 3 of that
    tol = SURFACE_TOL + (3 * 2.0 / (R - 1) / 510 if words else 0.0)
    out = []
    meshes[label] = []
    for i, img in enumerate(imgs):
        stats: dict = {}
        before = (k1.launches, k5.launches)
        before_cull = [f.launches for f in culls]
        k1.events, k5.events = [], []
        k1.inputs = [] if i == keep else None
        k5.inputs = [] if i == keep else None
        compact.inputs = [] if i == keep else None
        t0 = time.perf_counter()
        verts, faces = pipeline.image_to_mesh(params, img, trans, cfg,
                                              stats=stats)
        wall_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        k1_ms = sum(s.elapsed_time(e) for s, e in k1.events)
        k5_ms = sum(s.elapsed_time(e) for s, e in k5.events)
        if i == keep and kept is not None:
            kept[label], kept[label + " k5"] = k1.inputs, k5.inputs
            kept[label + " compact"] = compact.inputs
        k1.events = k1.inputs = k5.events = k5.inputs = None
        compact.inputs = None
        launches = k1.launches - before[0]
        k5_launches = k5.launches - before[1]
        cull_launches = [f.launches - b for f, b in zip(culls, before_cull)]
        dist = np.abs(np.abs(verts).sum(1) - 0.6)
        stats.update(label=label, image=i, wall_ms=wall_ms, k1_ms=k1_ms,
                     k5_ms=k5_ms,
                     k1_launches=launches, k5_launches=k5_launches,
                     cull_launches=cull_launches,
                     faces=len(faces), verts=len(verts),
                     max_surface_dist=float(dist.max()) if len(verts)
                     else float("nan"))
        print(f"[main {label}] " + json.dumps(stats))
        check(len(faces) > 1000, f"{label} image {i}: {len(faces)} faces")
        check(np.isfinite(verts).all(), f"{label} image {i}: bad vertices")
        check(float(dist.max()) <= tol,
              f"{label} image {i}: a vertex is {dist.max():.3e} off the "
              f"surface (tolerance {tol:.3e})")
        check(not stats["dense_fallback"] and launches == 2,
              f"{label} image {i}: expected K1 in the coarse and the fine "
              f"pass (2 launches, no dense fallback), got {launches} "
              f"launches, fallback={stats['dense_fallback']}")
        check(k5_launches == int(words),
              f"{label} image {i}: {k5_launches} K5 launches, expected "
              f"{int(words)}")
        check(cull_launches[:3] == [1, 0, 0] and cull_launches[3] >= 1,
              f"{label} image {i}: K4 (fused, tau, cull) and compaction "
              f"calls {cull_launches}, expected 1, 0, 0 and at least 1")
        check(stats["route"] == route and stats["guard"] == 0
              and stats.get("swords_guard", 0) == 0,
              f"{label} image {i}: expected route {route} with guard 0, got "
              f"route {stats['route']} with guard {stats.get('guard')} and "
              f"words guard {stats.get('swords_guard')}")
        meshes[label].append((verts, faces))
        out.append(stats)
    return out


def hold_flows(words_meshes: list, volume_meshes: list, R: int) -> None:
    """The sparse-words flow's meshes against the volume flow's on the same
    images: faces equal, in order; vertices within the records' u8
    quantisation, span/(R-1)/510 + 1e-6 (hold (c)'s bound)."""
    bound = 2.0 / (R - 1) / 510 + 1e-6
    for i, ((wv, wf), (vv, vf)) in enumerate(zip(words_meshes,
                                                 volume_meshes)):
        same = np.array_equal(wf, vf) and wv.shape == vv.shape
        dv = float(np.abs(wv - vv).max()) if same else float("inf")
        print(f"[flows] image {i}: records_sparse vs owned_ids faces equal="
              f"{same} ({len(wf)} faces), vertices max diff {dv:.6e} "
              f"(bound {bound:.6e})")
        check(same and dv <= bound, f"[flows] image {i}: the words flow's "
                                    f"mesh is not the volume flow's")


def phase_main_path() -> tuple[dict, list[dict], list[dict], dict, dict]:
    """The main path (the default Config: the sparse-words flow), then the
    volume flow (sparse_words=False) on the same bf16 images, each with the
    kernels' launch counts set to 0 just before it and read just after.
    Returns (launch counts of the main path, its per-image stats, the
    volume flow's, kept K1 and K5 inputs, and for the holds the meshes and
    the volume flow's volume and scan of the kept bf16 image and of an f32
    image on a 49^3 grid)."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.ops import (band_cull, block_compact, change_scan,
                                    fused_decode, owned_extract,
                                    sparse_words)

    k1 = fused_decode.fused_cell_decode
    k5 = sparse_words.sparse_cell_words
    culls = {"band_cull": band_cull.band_cull,
             "band_tau": band_cull.band_tau,
             "active_cells": band_cull.active_cells,
             "compact": block_compact.compact_block_bits}
    scan_owned = {"change_scan": change_scan.change_scan,
                  "extract_owned": owned_extract.extract_owned}

    def zero_counts():
        k1.launches = k5.launches = 0
        for f in (*culls.values(), *scan_owned.values()):
            f.launches = 0
        owned_extract.extract_owned.dense_calls = 0

    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (137, 137, 3), dtype=np.uint8)
            for _ in range(5)]
    trans = synthetic.demo_trans_mat()
    cfg = Config(sdf_res=256, compute_dtype="bfloat16")
    check(cfg.sparse_words, "the default Config must take the words flow")
    params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6)
    kept: dict = {}
    held: dict = {}
    torch.cuda.synchronize()
    zero_counts()
    runs = run_main_path(cfg, params, imgs[:4], trans, "bf16", 1, kept,
                         held)
    cfg32 = cfg.replace(compute_dtype="float32")
    runs += run_main_path(cfg32, params, imgs[4:], trans, "f32", 0, kept,
                          held)
    launches = {"k1": k1.launches, "k5": k5.launches,
                **{k: f.launches for k, f in culls.items()}}
    words_so = {k: f.launches for k, f in scan_owned.items()}
    check(words_so == {"change_scan": 0, "extract_owned": 0},
          f"the words flow launched K2s or K7: {words_so}")
    check(launches["band_cull"] == len(runs)
          and launches["band_tau"] == launches["active_cells"] == 0
          and launches["compact"] >= len(runs),
          f"the main path's K4 and compaction launches {launches}, expected "
          f"one K4 (tau and the cull in one launch) an image and at least "
          f"one compaction")
    for dt in ("bf16", "f32"):
        launches[f"k1 {dt}"] = sum(r["k1_launches"] for r in runs
                                   if r["label"] == dt)
    check(launches["k1 bf16"] + launches["k1 f32"] == launches["k1"],
          f"K1 launches by type do not add up: {launches}")
    cfgv = cfg.replace(sparse_words=False)
    torch.cuda.synchronize()
    # the volume flow's first image is a seed (exact scan, exact
    # extraction), the next ones hits (the fixed forms): their inputs are
    # kept for [scan owned]
    for f in scan_owned.values():
        f.inputs = []
    zero_counts()
    vruns = run_main_path(cfgv, params, imgs[:4], trans, "bf16 volume", 1,
                          None, held)
    vcounts = [f.launches for f in culls.values()]
    so_counts = {k: f.launches for k, f in scan_owned.items()}
    kept["volume scan"] = scan_owned["change_scan"].inputs[:2]
    kept["volume extract"] = scan_owned["extract_owned"].inputs[:2]
    for f in scan_owned.values():
        f.inputs = None
    check(k1.launches == 8 and k5.launches == 0
          and vcounts == [4, 0, 0, 4],
          f"volume flow: {k1.launches} K1, {k5.launches} K5 and {vcounts} "
          f"K4 (fused, tau, cull) and compaction calls, expected 8, 0 and "
          f"[4, 0, 0, 4]")
    check(so_counts == {"change_scan": 4, "extract_owned": 4},
          f"volume flow: K2s and K7 calls {so_counts}, expected one scan "
          f"and one extraction an image")
    dense = owned_extract.extract_owned.dense_calls
    check(dense == 0 and all(kw["blk"] is not None
                             for _, kw in kept["volume extract"]),
          f"volume flow: {dense} K7 calls without the scan's rows (the "
          f"dense owner table), expected 0")
    launches.update(so_counts)
    hold_flows(held["bf16"], held["bf16 volume"], cfg.grid_resolution)
    # made after the counts were read
    held.update(cfg=cfg, params=params, img=imgs[1], trans=trans)
    culls["compact"].inputs = []
    held["257"] = volume_and_scan(cfgv, params, imgs[1], trans)
    kept["bf16 volume compact"] = culls["compact"].inputs
    culls["compact"].inputs = None
    held["49"] = volume_and_scan(cfgv.replace(compute_dtype="float32",
                                              sdf_res=48), params, imgs[1],
                                 trans)
    return launches, runs, vruns, kept, held


def compare_flows(cfg, params, trans, pairs: int = 10) -> None:
    """[flows ab]: image_to_mesh's wall time through the sparse-words flow
    and the volume flow on the same fresh seeded images, in turns (pair k
    runs the words flow first when k is even), host clock with the device
    synchronised; the medians and the pairs each flow won. Only the route
    is checked (K5 launched once by the words flow, never by the other).
    """
    import torch
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.ops import sparse_words

    k5 = sparse_words.sparse_cell_words
    rng = np.random.RandomState(7)
    flows = {True: cfg.replace(sparse_words=True),
             False: cfg.replace(sparse_words=False)}
    ms: dict = {True: [], False: []}
    for k in range(pairs):
        img = rng.randint(0, 256, (137, 137, 3), dtype=np.uint8)
        for words in ((True, False) if k % 2 == 0 else (False, True)):
            before = k5.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipeline.image_to_mesh(params, img, trans, flows[words])
            torch.cuda.synchronize()
            ms[words].append((time.perf_counter() - t0) * 1e3)
            check(k5.launches - before == int(words),
                  f"[flows ab] pair {k}: the {'words' if words else 'volume'}"
                  f" flow launched K5 {k5.launches - before} times")
    w, v = np.array(ms[True]), np.array(ms[False])
    print(f"[flows ab] {pairs} pairs in turns: words flow median "
          f"{np.median(w):.3f} ms (quartiles {np.percentile(w, 25):.3f}-"
          f"{np.percentile(w, 75):.3f}), volume flow median "
          f"{np.median(v):.3f} ms ({np.percentile(v, 25):.3f}-"
          f"{np.percentile(v, 75):.3f}); the words flow won "
          f"{int((w < v).sum())} of {pairs} pairs; words "
          f"{[round(float(x), 3) for x in w]}, volume "
          f"{[round(float(x), 3) for x in v]}")


def k5_bound(args, kw) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations") for one K5
    step on these inputs: the rows, ids and coarse grid read once; the
    words, the own-slot table, the change bits and cand of the whole block
    grid and the guard written once; 56 f32 operations a lane (7 edges x
    (2 subtractions, a divide, a scale, a compare) and the 7 lerps of the
    guard's own point)."""
    rows, cells, _, vol_c = args
    nk = cells.numel()
    c = vol_c.shape[0] - 1
    nw = 2 if kw["R"] - 1 >= 128 else 4
    nbytes = (rows.numel() * 4 + nk * 4 + vol_c.numel() * 4
              + nw * nk * 64 * 4 + c ** 3 * 4 + (c + 1) ** 3 * 9 + 4)
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 56.0 * nk * 64 / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def hold_k5(label: str, args, kw, timed: bool = False) -> dict:
    """One K5 step against marching._sparse_cell_words on the same inputs:
    every output equal bit for bit (max_abs_err is the count of differing
    words); timed, the wrapper back to back (allocation, the one library
    call), the step on the device (its CUDA events) and the plain version.
    These launches are made after the main path's counts were read."""
    import torch
    from disn_tpu_torch.ops import marching as m
    from disn_tpu_torch.ops import sparse_words

    k5 = sparse_words.sparse_cell_words
    got = k5(*args, **kw)
    want = m._sparse_cell_words(*args, kw["R"], kw["iso"])
    torch.cuda.synchronize()
    names = ("words", "bits", "cand", "own_tbl", "guard")
    bad = [n for n, a, b in zip(names, got, want)
           if a.dtype != b.dtype or not torch.equal(a, b)]
    diff = int((got[0] != want[0]).sum()) if got[0].shape == want[0].shape \
        else got[0].numel()
    res = dict(max_abs_err=diff, ms=float("nan"), step_ms=float("nan"),
               plain_ms=float("nan"))
    if timed:
        res["ms"] = cuda_ms(lambda: k5(*args, **kw), 20)
        k5.events = []
        for _ in range(20):
            k5(*args, **kw)
        torch.cuda.synchronize()
        res["step_ms"] = float(np.median([s.elapsed_time(e)
                                          for s, e in k5.events]))
        k5.events = None
        res["plain_ms"] = cuda_ms(
            lambda: m._sparse_cell_words(*args, kw["R"], kw["iso"]), 3)
    res["bound_ms"], res["bound_by"] = k5_bound(args, kw)
    print(f"[k5] {label} cells={args[1].numel()} count={int(args[2])}"
          f"{' (on the card)' if hasattr(args[2], 'is_cuda') else ''} "
          f"R={kw['R']} differing words={diff} outputs off={bad} guard="
          f"{int(got[4])} ms={res['ms']:.5f} step_ms="
          f"{res['step_ms']:.5f} plain_ms={res['plain_ms']:.4f} bound_ms="
          f"{res['bound_ms']:.5f} ({res['bound_by']})")
    check(not bad, f"K5 {label}: {bad} differ from the plain version")
    return res


# torch.profiler windows taken before a check reads one: now and then the
# H100's profiler returns a window without some device events of the work
# it traced, or without any (seen on kernels' memsets and on a whole K6a
# window); the work itself does not change, so a window that misses an
# event the work always launches is taken again (late in a long process
# the first windows after a stretch without the profiler have lost up to
# every event they traced, and a window taken at once after one has kept
# them; a host pause inside the window did not help)
PROFILE_TRIES = 5


def profiled(fn, want: tuple = (), tdir: str | None = None):
    """torch.profiler (CPU and the card) over fn() and a device sync,
    taken again, up to PROFILE_TRIES windows, while the window holds no
    device event, or no device event whose name contains one of `want`.
    With tdir the window's Chrome trace is written to tdir/trace.json.
    Returns (the profiler of the last window taken, fn's last result); the
    caller's checks read that window as they would any other."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from disn_tpu_torch.utils.logging import trace

    for i in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with (trace(tdir) if tdir else profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA])) as prof:
            out = fn()
            torch.cuda.synchronize()
        keys = [e.key for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        missing = [w for w in want if not any(w in k for k in keys)]
        if keys and not missing:
            break
        print(f"[profiler] window {i + 1} of {PROFILE_TRIES} held "
              f"{len(keys)} device events"
              + (f", none named {missing}" if keys else ""))
    return prof, out


def profile_k5(args, kw) -> None:
    """[k5 profile]: torch.profiler over LIBRARY_CALLS steps on these
    inputs; the device must run the library's work alone (the own-slot
    memset and its two kernels, once a step), no PyTorch op's kernel."""
    from torch.autograd import DeviceType

    from disn_tpu_torch.ops import sparse_words

    ours = ("Memset", "own_scatter", "sparse_words_grid")
    prof, _ = profiled(lambda: [sparse_words.sparse_cell_words(*args, **kw)
                                for _ in range(LIBRARY_CALLS)], want=ours)
    avg = prof.key_averages()
    dev = [(e.key, e.count, _device_time(e, True)) for e in avg
           if e.device_type == DeviceType.CUDA]
    ops = sorted(e.key for e in avg if e.device_type == DeviceType.CPU
                 and e.key.startswith("aten::"))
    for key, count, us in dev:
        print(f"[k5 profile] device: {key[:90]} x{count} {us / count:.2f} "
              "us each")
    print(f"[k5 profile] {len(dev)} kinds of device event in "
          f"{LIBRARY_CALLS} steps; PyTorch ops on the host (allocation and "
          f"views, no device work): {ops}")
    check(len(dev) == 3 and all(any(o in k for o in ours) for k, _, _ in dev)
          and all(count <= LIBRARY_CALLS for _, count, _ in dev),
          f"[k5 profile] the step ran other device work: {dev}")


def random_k5_args(R: int, nk: int, count: int, seed: int):
    """Seeded K5 inputs on the card: nk distinct random coarse cells (most
    "+1" neighbours absent), rows and coarse grid around the iso with 5% of
    the rows exactly at it, ids past `count` set to 0."""
    import torch

    c = (R - 1) // 4
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.choice(c ** 3, nk, replace=False)).astype(np.int32)
    ids[count:] = 0
    rows = (0.3 * rng.randn(nk * 64)).astype(np.float32)
    rows[rng.rand(nk * 64) < 0.05] = 0.0
    vol_c = (0.3 * rng.randn(c + 1, c + 1, c + 1)).astype(np.float32)
    dev = torch.device("cuda")
    return ((torch.from_numpy(rows).to(dev), torch.from_numpy(ids).to(dev),
             count, torch.from_numpy(vol_c).to(dev)), dict(R=R, iso=0.0))


def lattice_k5_args(R: int, stride: int, pad: int, seed: int):
    """Seeded K5 inputs on the card: every `stride`-th coarse cell along
    each axis active (1: every neighbour active; 2: none), then `pad` ids
    past the count that repeat active cells."""
    import torch

    c = (R - 1) // 4
    rng = np.random.RandomState(seed)
    ax = np.arange(0, c, stride)
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    ids = ((z * c + y) * c + x).reshape(-1).astype(np.int32)
    count = len(ids)
    ids = np.concatenate([ids, rng.choice(ids, pad)]).astype(np.int32)
    rows = (0.3 * rng.randn(len(ids) * 64)).astype(np.float32)
    rows[rng.rand(len(ids) * 64) < 0.05] = 0.0
    vol_c = (0.3 * rng.randn(c + 1, c + 1, c + 1)).astype(np.float32)
    dev = torch.device("cuda")
    return ((torch.from_numpy(rows).to(dev), torch.from_numpy(ids).to(dev),
             count, torch.from_numpy(vol_c).to(dev)), dict(R=R, iso=0.0))


def hold_swords(cfg, params, img, trans, kept: dict) -> dict:
    """[swords hold]: on one 257^3 bf16 image, the words flow against the
    volume flow from the same phase_a outputs (blk and the cell count
    equal, (rec, tq) from the words equal _extract_records on the volume on
    every slot), then K5 against its plain version on the main path's kept
    inputs (timed) and on random inputs at u8 and u16 grids with absent
    neighbours, values at the iso and ragged counts. Returns the timed
    main-path hold."""
    import torch
    from disn_tpu_torch import device as device_mod
    from disn_tpu_torch.infer import dense, pipeline, sparse
    from disn_tpu_torch.ops import marching as m

    dev = torch.device("cuda")
    params = device_mod.tree_to(params, dev)
    img_t, trans_t, sdfp = dense.as_inputs(img, trans, pipeline.UNIT_BOX, dev)
    _, eps, vol_c, cells, _ = sparse.phase_a(params, img_t, trans_t, sdfp,
                                             cfg)
    R = cfg.grid_resolution
    words, sids, n, guard, blk = sparse.phase_b_mesh_sparse(
        params, eps, vol_c, cells, trans_t, sdfp, cfg, cfg.iso)
    vol, ids, n_d, guard_d, blk_d = sparse.phase_b_mesh(
        params, eps, vol_c, cells, trans_t, sdfp, cfg, cfg.iso)
    rec, tq = m._records_from_words_sparse(words, sids, R)
    rec_d, tq_d = m._extract_records(vol, ids, cfg.iso)
    same_rec = (rec.dtype == rec_d.dtype and torch.equal(rec, rec_d)
                and tq.dtype == tq_d.dtype and torch.equal(tq, tq_d))
    print(f"[swords hold] {R}^3: words flow guard {guard}, volume flow "
          f"guard {guard_d}; cells {n} vs {n_d}, blk equal="
          f"{torch.equal(blk, blk_d)} ({len(blk)} blocks); (rec, tq) equal "
          f"on all {n} slots={same_rec}")
    check(guard == 0 and guard_d == 0 and n == n_d
          and torch.equal(blk, blk_d) and same_rec,
          "[swords hold] the words flow is not the volume flow's twin")
    (args, kw), = kept["bf16 k5"]
    main = hold_k5("bf16 main-path", args, kw, timed=True)
    profile_k5(args, kw)
    (args32, kw32), = kept["f32 k5"]
    hold_k5("f32 main-path", args32, kw32)
    nk = args[1].numel()
    for R_, cases in ((257, ((nk, nk), (nk - 1, nk - 1), (nk, nk - 777),
                             (1, 1), (3, 2), (61, 61), (0, 0))),
                      (65, ((2001, 2001), (2001, 1500), (1, 1), (0, 0)))):
        for k, (n_, count) in enumerate(cases):
            a, kw_ = random_k5_args(R_, n_, count, seed=k)
            hold_k5(f"random R={R_}", a, kw_, timed=(R_, k) == (257, 0))
    for stride in (1, 2):  # every neighbour active, then none
        a, kw_ = lattice_k5_args(65, stride, pad=37, seed=stride)
        hold_k5(f"lattice stride {stride} + 37 padded ids R=65", a, kw_)
    # the count on the card, as the speculative dispatch passes it: padded,
    # none, and past the cells (clamped)
    for R_, n_, count in ((257, nk, nk - 777), (257, nk, 0), (65, 2001, 1500),
                          (65, 2001, 2001)):
        a, kw_ = random_k5_args(R_, n_, count, seed=count)
        over = count + 5 if count == n_ else count
        a = (a[0], a[1], torch.tensor(over, dtype=torch.int32,
                                      device=a[0].device), a[3])
        hold_k5(f"count {over} on the card R={R_}", a, kw_)
    return main


SPEC_IMAGES = 48
SPEC_R = (0.5, 0.7)   # the analytic head's radius, drawn an image
SPEC_GUARD_R = 0.95   # the band reaches the box's + faces: the guard trips
SPEC_CAP_FRAC = 0.05  # a cell cap under the main path's 17,888 active cells


def spec_run(fn, *args, **kw):
    """(verts, faces, the speculation's kind, host ms) of one
    image_to_mesh-like call, the card synchronised before and after;
    kind is the one kind pipeline.spec_counts gained, or "none"."""
    import torch
    from disn_tpu_torch.infer import pipeline

    before = dict(pipeline.spec_counts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    verts, faces = fn(*args, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    gained = [k for k, v in pipeline.spec_counts.items()
              if v != before.get(k, 0)]
    check(len(gained) <= 1, f"[spec] one call ended as {gained}")
    return verts, faces, gained[0] if gained else "none", ms


def seed_path(params, img, trans, cfg, **kw):
    """image_to_mesh with _SPEC_CACHE cleared (the synchronous flow, which
    seeds it), the cache restored after, and (cfg, iso) unpinned from the
    volume flow as it was."""
    from disn_tpu_torch.infer import pipeline

    saved = dict(pipeline._SPEC_CACHE)
    pinned = set(pipeline._SWORDS_SKIP)
    pipeline._SPEC_CACHE.clear()
    try:
        return spec_run(pipeline.image_to_mesh, params, img, trans, cfg,
                        **kw)
    finally:
        pipeline._SPEC_CACHE.clear()
        pipeline._SPEC_CACHE.update(saved)
        pipeline._SWORDS_SKIP.clear()
        pipeline._SWORDS_SKIP.update(pinned)


def same_mesh(a, b) -> bool:
    return (a[0].shape == b[0].shape and np.array_equal(a[0], b[0])
            and np.array_equal(a[1], b[1]))


def sync_free_dispatch(params, img, trans, cfg):
    """_fused_dispatch under torch.cuda.set_sync_debug_mode("error") (any
    synchronising call raises), then _fused_collect: (verts, faces,
    kind)."""
    import torch
    from disn_tpu_torch.infer import pipeline

    torch.cuda.synchronize()
    before = dict(pipeline.spec_counts)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ctx = pipeline._fused_dispatch(params, img, trans, pipeline.UNIT_BOX,
                                       cfg, cfg.iso)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    verts, faces = pipeline._collect_or_dense(ctx)
    kind = [k for k, v in pipeline.spec_counts.items()
            if v != before.get(k, 0)]
    return verts, faces, kind


def phase_spec(smi: str) -> None:
    """[spec]: the speculative dispatch on the main path's configuration
    (full width, analytic head, 257^3 bf16, demo camera). SPEC_IMAGES
    seeded u8 images, each with the head's radius drawn in SPEC_R (so the
    active cells and the buckets change from image to image): each image
    through image_to_mesh with the prediction the earlier images left
    (hit, or the re-run its bucket called for) and through the seed path
    (_SPEC_CACHE cleared), in turns (even images speculative first), the
    meshes equal bit for bit; then each re-run kind forced once and held
    to the seed path: a block bucket of 1, a record bucket of 1 batch, a
    compaction cap of 256 blocks (overflow; its guard is 0), the surface
    cut by the box (r = SPEC_GUARD_R: the guard trips, the volume flow),
    a cell cap under the active cells (cell_cap_frac SPEC_CAP_FRAC: the
    dense route); then, on a warm prediction, _fused_dispatch under
    torch.cuda.set_sync_debug_mode("error"). Prints the walls of the hits
    and of the seed path (host clock, the card synchronised before and
    after; medians) and the kinds, and leaves _SPEC_CACHE as it found
    it."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline

    cfg = Config(sdf_res=256, compute_dtype="bfloat16")
    params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6)
    bias = params["sdfprediction"]["fold2"]["conv5"]["biases"]
    trans = synthetic.demo_trans_mat()
    rng = np.random.RandomState(18)
    imgs = [rng.randint(0, 256, (137, 137, 3), dtype=np.uint8)
            for _ in range(SPEC_IMAGES)]
    radii = rng.uniform(*SPEC_R, SPEC_IMAGES)
    key = (cfg, float(cfg.iso))
    saved = dict(pipeline._SPEC_CACHE)  # the later phases' prediction

    def radius(r: float) -> None:  # the head's field 10 (|x|+|y|+|z| - r)
        with torch.no_grad():
            bias.fill_(-10.0 * r)

    kinds: dict = {}
    walls: dict = {"spec": [], "seed": [], "kind": []}
    for i, (img, r) in enumerate(zip(imgs, radii)):
        radius(r)
        runs = {}
        for which in (("spec", "seed") if i % 2 == 0 else ("seed", "spec")):
            if which == "seed":
                runs["seed"] = seed_path(params, img, trans, cfg)
            else:
                runs["spec"] = spec_run(pipeline.image_to_mesh, params, img,
                                        trans, cfg)
        kind = runs["spec"][2]
        kinds[kind] = kinds.get(kind, 0) + 1
        walls["spec"].append(runs["spec"][3])
        walls["kind"].append(kind)
        walls["seed"].append(runs["seed"][3])
        check(runs["seed"][2] == "seed" and len(runs["seed"][1]) > 1000,
              f"[spec] image {i}: the seed path ended as {runs['seed'][2]}")
        check(same_mesh(runs["spec"], runs["seed"]),
              f"[spec] image {i} (r {r:.4f}, {kind}): the speculative mesh "
              f"is not the seed path's")
    print(f"[spec] {SPEC_IMAGES} images, r in {SPEC_R}: the speculative "
          f"route ended as {kinds}, every mesh the seed path's bit for bit; "
          f"prediction now {pipeline._SPEC_CACHE.get(key)}")
    check(kinds.get("hit", 0) >= SPEC_IMAGES // 2,
          f"[spec] only {kinds.get('hit', 0)} hits in {SPEC_IMAGES} images")
    hits = np.array([k == "hit" for k in walls["kind"]])
    s, d = np.array(walls["spec"])[hits], np.array(walls["seed"])[hits]
    missed = [round(w, 3) for w, k in zip(walls["spec"], walls["kind"])
              if k != "hit"]
    print(f"[spec] single-image wall on the {hits.sum()} hits, in turns with "
          f"the seed path on the same image (host clock, card synchronised "
          f"before and after): hit median {np.median(s):.3f} ms (quartiles "
          f"{np.percentile(s, 25):.3f}-{np.percentile(s, 75):.3f}), seed path "
          f"median {np.median(d):.3f} ms ({np.percentile(d, 25):.3f}-"
          f"{np.percentile(d, 75):.3f}); the hit won {int((s < d).sum())} of "
          f"{hits.sum()}; the misses {missed} ms; {smi}")

    # each re-run kind once, against the seed path on the same image
    radius(0.6)
    img = imgs[0]
    spec_run(pipeline.image_to_mesh, params, img, trans, cfg)  # warm, exact
    nb, ni = pipeline._SPEC_CACHE[key][:2]
    sizes = pipeline._spec_sizes(cfg)

    def forced(kind: str, c=cfg, r: float = 0.6, pred=None, bcap=None):
        radius(r)
        saved = dict(pipeline._SPEC_CACHE)
        real_bcap = pipeline._fused_bcap
        if pred is not None:
            pipeline._SPEC_CACHE[(c, float(c.iso))] = pred
        if bcap is not None:
            pipeline._fused_bcap = lambda n, s: bcap
        try:
            got = spec_run(pipeline.image_to_mesh, params, img, trans, c)
        finally:
            pipeline._fused_bcap = real_bcap
            pipeline._SPEC_CACHE.clear()
            pipeline._SPEC_CACHE.update(saved)
            pipeline._SWORDS_SKIP.discard((c, float(c.iso)))
        want = seed_path(params, img, trans, c)
        pipeline._SWORDS_SKIP.discard((c, float(c.iso)))
        print(f"[spec] forced {kind}: ended as {got[2]}, {len(got[1])} "
              f"faces, equal to the seed path's ({want[2]}) bit for bit: "
              f"{same_mesh(got, want)}; {got[3]:.3f} ms against "
              f"{want[3]:.3f}")
        check(got[2] == kind and same_mesh(got, want),
              f"[spec] forced {kind}: ended as {got[2]}, or its mesh is not "
              f"the seed path's")

    forced("blocks", pred=(1, ni, None, 0, None))
    forced("records", pred=(nb, 1, None, 0, None))
    forced("overflow", bcap=256)
    forced("guard", r=SPEC_GUARD_R)
    ccap = cfg.replace(cell_cap_frac=SPEC_CAP_FRAC)
    forced("cap", c=ccap,
           pred=(pipeline._spec_sizes(ccap)["max_blocks"], ni, None, 0,
                 None))
    radius(0.6)

    # no synchronisation on a warm prediction
    spec_run(pipeline.image_to_mesh, params, img, trans, cfg)
    want = seed_path(params, img, trans, cfg)
    verts, faces, kind = sync_free_dispatch(params, img, trans, cfg)
    print(f"[spec] _fused_dispatch under set_sync_debug_mode('error'): no "
          f"synchronising call; collect ended as {kind}, the seed path's "
          f"mesh: {same_mesh((verts, faces), want)}")
    check(kind == ["hit"] and same_mesh((verts, faces), want),
          "[spec] the sync-free dispatch did not hit, or its mesh is not the "
          "seed path's")
    check(sizes["cells_per_block"] == 512,
          f"[spec] {sizes['cells_per_block']} cells a block, expected 512")
    pipeline._SPEC_CACHE.clear()
    pipeline._SPEC_CACHE.update(saved)


VSPEC_IMAGES = 48
VSPEC_R = (0.5, 0.7)        # the analytic head's radius, drawn an image
VSPEC_CUT = (0.5, 0.5, 0.5)  # the centre that puts r 0.6's tips past the box
VSPEC_PROFILED = 8          # images of a profiled run of waits and launches


def volume_counters() -> dict:
    """The wrappers of the kernels the volume flow can launch, by name:
    K1, K5 (never on this flow), K4's fused entry, the compaction, the
    candidate scan (K2s) and the owned extractor (K7)."""
    from disn_tpu_torch.ops import (band_cull, block_compact, change_scan,
                                    fused_decode, owned_extract,
                                    sparse_words)
    return {"k1": fused_decode.fused_cell_decode,
            "k5": sparse_words.sparse_cell_words,
            "band_cull": band_cull.band_cull,
            "compact": block_compact.compact_block_bits,
            "change_scan": change_scan.change_scan,
            "extract_owned": owned_extract.extract_owned}


def image_waits(fn, images: list) -> tuple[float, int, int]:
    """fn(img) on each image under torch.profiler: (ms the calling thread
    spent in SYNC_CALLS, its runtime launch calls of every kind, cluster
    launches included; its cudaLaunchKernel calls), per image."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for img in images:
            fn(img)
        torch.cuda.synchronize()
    main_ms, _, n_launch, _, all_launch = sync_waits(prof)
    k = len(images)
    return main_ms / k, all_launch / k, n_launch / k


def phase_vspec(smi: str) -> None:
    """[vspec]: the volume flow's speculative dispatch on the main path's
    configuration with sparse_words=False (full width, analytic head,
    257^3 bf16, demo camera). VSPEC_IMAGES seeded u8 images, each with the
    head's radius drawn in VSPEC_R (the buckets move): each image through
    image_to_mesh with the prediction the earlier images left and through
    the seed path (_SPEC_CACHE cleared), in turns, the meshes equal bit
    for bit, at least half of them hits. Then 4 hits with the kernels'
    counts set to 0 just before and read just after (K1 twice, no K5, K4
    once, the capped compaction, the scan and the fixed extractor once an
    image); the fixed owned extractor
    against the exact one on one image's volume and ids (bit for bit;
    CUDA events over 20 calls, in turns; launch calls); the calling
    thread's waits and runtime launch calls an image under torch.profiler,
    on
    VSPEC_PROFILED images through the seed path (the synchronous flow, the
    parent's) and as hits, in turns; each kind of the volume arm forced
    once and held to the seed path (blocks: a bucket of 1; planes: the bit
    flipped; guard: a scan told of no active coarse cell; overflow: a
    compaction cap of 256 blocks; extract: a vertex prediction of 1; cap:
    a cell cap under the active cells); _fused_dispatch on a warm
    prediction under torch.cuda.set_sync_debug_mode("error"); and the head
    moved to VSPEC_CUT, so that the box cuts the surface, on the words
    flow's config: the words guard trips and pins (cfg, iso), the next
    image is a volume-flow hit with the boundary planes, the seed path's
    mesh bit for bit."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.ops import marching

    t_phase = time.perf_counter()
    cfg = Config(sdf_res=256, compute_dtype="bfloat16", sparse_words=False)
    params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6)
    bias = params["sdfprediction"]["fold2"]["conv5"]["biases"]
    shift = params["sdfprediction"]["fold1"]["conv1"]["biases"]
    trans = synthetic.demo_trans_mat()
    rng = np.random.RandomState(21)
    imgs = [rng.randint(0, 256, (137, 137, 3), dtype=np.uint8)
            for _ in range(VSPEC_IMAGES)]
    radii = rng.uniform(*VSPEC_R, VSPEC_IMAGES)
    key = pipeline._vkey(cfg, cfg.iso)
    saved = dict(pipeline._SPEC_CACHE)
    counters = volume_counters()
    counters["extract_owned"].dense_calls = 0

    def radius(r: float) -> None:  # the head's field 10 (|x|+|y|+|z| - r)
        with torch.no_grad():
            bias.fill_(-10.0 * r)

    def image(c=cfg):
        return lambda img: pipeline.image_to_mesh(params, img, trans, c)

    kinds: dict = {}
    walls: dict = {"spec": [], "seed": [], "kind": []}
    for i, (img, r) in enumerate(zip(imgs, radii)):
        radius(r)
        runs = {}
        for which in (("spec", "seed") if i % 2 == 0 else ("seed", "spec")):
            runs[which] = (seed_path(params, img, trans, cfg)
                           if which == "seed" else
                           spec_run(pipeline.image_to_mesh, params, img,
                                    trans, cfg))
        kind = runs["spec"][2]
        kinds[kind] = kinds.get(kind, 0) + 1
        walls["spec"].append(runs["spec"][3])
        walls["seed"].append(runs["seed"][3])
        walls["kind"].append(kind)
        check(runs["seed"][2] == "seed" and len(runs["seed"][1]) > 1000,
              f"[vspec] image {i}: the seed path ended as {runs['seed'][2]}")
        check(same_mesh(runs["spec"], runs["seed"]),
              f"[vspec] image {i} (r {r:.4f}, {kind}): the speculative mesh "
              f"is not the seed path's")
    print(f"[vspec] {VSPEC_IMAGES} images, r in {VSPEC_R}: the speculative "
          f"route ended as {kinds}, every mesh the seed path's bit for bit; "
          f"prediction now {pipeline._SPEC_CACHE.get(key)}")
    check(kinds.get("hit", 0) >= VSPEC_IMAGES // 2,
          f"[vspec] only {kinds.get('hit', 0)} hits in {VSPEC_IMAGES} images")
    hits = np.array([k == "hit" for k in walls["kind"]])
    s, d = np.array(walls["spec"])[hits], np.array(walls["seed"])[hits]
    print(f"[vspec] single-image wall on the {hits.sum()} hits, in turns with "
          f"the seed path on the same image (host clock, card synchronised "
          f"before and after): hit median {np.median(s):.3f} ms (quartiles "
          f"{np.percentile(s, 25):.3f}-{np.percentile(s, 75):.3f}), seed path "
          f"median {np.median(d):.3f} ms ({np.percentile(d, 25):.3f}-"
          f"{np.percentile(d, 75):.3f}); the hit won {int((s < d).sum())} of "
          f"{hits.sum()}; {smi}")

    # the kernels a hit launches, counted over 4 hits
    radius(0.6)
    spec_run(pipeline.image_to_mesh, params, imgs[0], trans, cfg)  # warm
    before = dict(pipeline.spec_counts)
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    for img in imgs[:4]:
        pipeline.image_to_mesh(params, img, trans, cfg)
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in counters.items()}
    n_hits = pipeline.spec_counts["hit"] - before.get("hit", 0)
    print(f"[vspec] 4 hits at r 0.6: launches {counts}")
    check(n_hits == 4 and counts == {"k1": 8, "k5": 0, "band_cull": 4,
                                     "compact": 4, "change_scan": 4,
                                     "extract_owned": 4},
          f"[vspec] {n_hits} hits in 4, kernel launches {counts}; expected "
          f"8 K1, 0 K5, 4 K4, 4 capped compactions, 4 scans and 4 fixed "
          f"extractions")

    # the fixed extractor against the exact one on a hit's volume and ids
    from disn_tpu_torch.infer import sparse

    vol, (ids, n, _, blk) = sparse.sparse_volume(
        params, imgs[0], trans, pipeline.UNIT_BOX, cfg, scan_iso=cfg.iso)
    sizes = pipeline._spec_sizes(cfg)
    slots = pipeline._ids_len(pipeline._SPEC_CACHE[key][0], sizes)
    padded = torch.zeros(slots, dtype=torch.int32, device=vol.device)
    padded[:n] = ids
    n_iter, batch = marching.records_n_iter(slots, n, pipeline.SPEC_BATCH)
    box = torch.as_tensor(pipeline.UNIT_BOX, device=vol.device)
    n_t = torch.tensor(n, dtype=torch.int32, device=vol.device)

    def fixed():
        return marching._extract_owned_fixed(vol, box, padded, n_t, 0.0,
                                             n_iter, batch, blk=blk)

    def exact():
        return marching._extract_owned(vol, box, ids, 0.0, blk)

    ext = {"fixed": [], "exact": []}
    for who in ("fixed", "exact", "exact", "fixed"):
        ext[who].append(cuda_ms(fixed if who == "fixed" else exact, 20))
    calls = {who: count_launches(f) for who, f in (("fixed", fixed),
                                                   ("exact", exact))}
    got, want = fixed(), exact()
    nv, ntri = int(got[1]), int(got[3])
    check(torch.equal(got[0][:nv], want[0])
          and torch.equal(got[2][:ntri], want[1]),
          "[vspec] the fixed extractor is not the exact one on the volume")
    print(f"[vspec] the owned extractor on one image's volume ({n} cells, "
          f"{n_iter} x {batch} slots, {nv} vertices, {ntri} faces; CUDA "
          f"events over 20 calls, in turns): fixed form "
          f"{[round(t, 4) for t in ext['fixed']]} ms in {calls['fixed']} "
          f"launch calls, exact {[round(t, 4) for t in ext['exact']]} ms "
          f"in {calls['exact']} (with its waits); equal bit for bit; {smi}")
    del vol, ids, padded, got, want, blk

    # the calling thread's waits and launch calls an image, in turns
    prof_imgs = imgs[:VSPEC_PROFILED]
    waits: dict = {"seed path": [], "hit": []}

    def seeded(img):
        pipeline._SPEC_CACHE.pop(key, None)
        return image()(img)

    for turn in range(2):
        for who in (("seed path", "hit") if turn == 0
                    else ("hit", "seed path")):
            image()(imgs[0])  # a prediction to start from
            waits[who].append(image_waits(
                seeded if who == "seed path" else image(), prof_imgs))
    for who, runs in waits.items():
        print(f"[vspec] {who}, {VSPEC_PROFILED} images under torch.profiler "
              f"(2 turns): the calling thread waited "
              f"{[round(w[0], 3) for w in runs]} ms an image in "
              f"{'/'.join(SYNC_CALLS)}, with "
              f"{[round(w[1], 1) for w in runs]} runtime launch calls an "
              f"image (cluster launches included; cudaLaunchKernel alone "
              f"{[round(w[2], 1) for w in runs]}); {smi}")

    # each kind of the volume arm once, against the seed path
    img = imgs[0]
    spec_run(pipeline.image_to_mesh, params, img, trans, cfg)  # warm
    nb, ni, nv, _, nvc, ntri, planes = pipeline._SPEC_CACHE[key]

    def forced(kind: str, c=cfg, pred=None, bcap=None, scan=None):
        saved_pred = dict(pipeline._SPEC_CACHE)
        real_bcap = pipeline._fused_bcap
        real_scan = marching._active_cells_from_coarse
        if pred is not None:
            pipeline._SPEC_CACHE[pipeline._vkey(c, c.iso)] = pred
        if bcap is not None:
            pipeline._fused_bcap = lambda n, s: bcap
        if scan is not None:
            marching._active_cells_from_coarse = scan
        try:
            got = spec_run(pipeline.image_to_mesh, params, img, trans, c)
        finally:
            pipeline._fused_bcap = real_bcap
            marching._active_cells_from_coarse = real_scan
            pipeline._SPEC_CACHE.clear()
            pipeline._SPEC_CACHE.update(saved_pred)
        want = seed_path(params, img, trans, c)
        print(f"[vspec] forced {kind}: ended as {got[2]}, {len(got[1])} "
              f"faces, equal to the seed path's ({want[2]}) bit for bit: "
              f"{same_mesh(got, want)}; {got[3]:.3f} ms against "
              f"{want[3]:.3f}")
        check(got[2] == kind and same_mesh(got, want),
              f"[vspec] forced {kind}: ended as {got[2]}, or its mesh is not "
              f"the seed path's")

    def blind(vol, coarse_ids, iso, stride, count=None, bcap=None):
        """The candidate scan told of no active coarse cell."""
        real = blind.real
        if count is None:
            return real(vol, coarse_ids[:0], iso, stride=stride)
        return real(vol, coarse_ids, iso, stride=stride, count=count * 0,
                    bcap=bcap)

    blind.real = marching._active_cells_from_coarse
    forced("blocks", pred=(1, ni, nv, 0, nvc, ntri, planes))
    forced("planes", pred=(nb, ni, nv, 0, nvc, ntri, not planes))
    forced("guard", scan=blind)
    forced("overflow", bcap=256)
    forced("extract", pred=(nb, ni, 1, 0, nvc, ntri, planes))
    ccap = cfg.replace(cell_cap_frac=SPEC_CAP_FRAC)
    forced("cap", c=ccap,
           pred=(pipeline._spec_sizes(ccap)["max_blocks"], ni, nv, 0, nvc,
                 ntri, planes))

    # no synchronisation on a warm prediction
    spec_run(pipeline.image_to_mesh, params, img, trans, cfg)
    want = seed_path(params, img, trans, cfg)
    verts, faces, kind = sync_free_dispatch(params, img, trans, cfg)
    print(f"[vspec] _fused_dispatch under set_sync_debug_mode('error'): no "
          f"synchronising call; collect ended as {kind}, the seed path's "
          f"mesh: {same_mesh((verts, faces), want)}")
    check(kind == ["hit"] and same_mesh((verts, faces), want),
          "[vspec] the sync-free dispatch did not hit, or its mesh is not "
          "the seed path's")

    # the box cuts the surface: the words flow pins, the volume flow hits
    words = cfg.replace(sparse_words=True)
    wkey = (words, float(words.iso))
    with torch.no_grad():
        shift[:6] = torch.tensor([-VSPEC_CUT[i // 2] * (1 - 2 * (i % 2))
                                  for i in range(6)], device=shift.device)
    try:
        pinned = wkey in pipeline._SWORDS_SKIP
        got = [spec_run(pipeline.image_to_mesh, params, im, trans, words)
               for im in imgs[:2]]
        vpred = pipeline._SPEC_CACHE.get(pipeline._vkey(words, words.iso))
        want = seed_path(params, imgs[1], trans, words)
        print(f"[vspec] the surface cut by the box (centre {VSPEC_CUT}, r "
              f"0.6) on the words flow's config: pinned before {pinned}, "
              f"after {wkey in pipeline._SWORDS_SKIP}; the images ended as "
              f"{[g[2] for g in got]}, the volume prediction {vpred}; the "
              f"hit's {len(got[1][1])} faces are the seed path's bit for "
              f"bit: {same_mesh(got[1], want)}")
        check(not pinned and got[0][2] in ("guard", "seed")
              and wkey in pipeline._SWORDS_SKIP and vpred is not None
              and vpred[6] is True and got[1][2] == "hit"
              and same_mesh(got[1], want),
              f"[vspec] the cut surface: pinned before {pinned}, after "
              f"{wkey in pipeline._SWORDS_SKIP}, volume prediction {vpred}, "
              f"the images {[g[2] for g in got]} (expected a words guard "
              f"or seed, then a hit), or the hit's mesh is not the seed "
              f"path's")
    finally:
        with torch.no_grad():
            shift[:6] = 0.0
        pipeline._SWORDS_SKIP.discard(wkey)
    radius(0.6)
    pipeline._SPEC_CACHE.clear()
    pipeline._SPEC_CACHE.update(saved)
    dense = counters["extract_owned"].dense_calls
    print(f"[vspec] K7 calls without the scan's rows over the phase: "
          f"{dense}")
    check(dense == 0, f"[vspec] {dense} K7 calls took the dense owner "
                      f"table, expected 0: every caller passes its rows")
    print(f"[vspec] phase seconds {time.perf_counter() - t_phase:.1f}")


SO_GRIDS = (49, 65, 129, 100)   # 100: R - 1 not a multiple of 4 (full scan)
SO_EDGES = ("none", "every", "zeros", "nan", "at_iso")
SO_AT_ISO = 0.25                # the iso of the "at_iso" field
SO_NAMES = {"full scan": ("Memset", "scan_kernel"),
            "coarse scan": ("Memset", "mark_kernel", "scan_kernel"),
            "extract": ("owned_count", "owned_prefix", "owned_write"),
            "dense extract": ("Memset", "owned_count", "owned_prefix",
                              "owned_write")}
SO_SCRATCH_MAX = 2 << 20  # K7's scratch a call at the hit's 257^3 inputs
PARENT_SO: dict = {}  # another checkout's ops/marching and K7 (--parent)


def so_parent(root: str):
    """Another checkout's ops/marching.py, loaded under another name (it
    imports this checkout's helpers): its scans and owned extractor, as
    that checkout runs them."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "parent_marching",
        os.path.join(root, "disn_tpu_torch", "ops", "marching.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def so_parent_k7(root: str):
    """Another checkout's ops/owned_extract.py, loaded under another name
    and built from that checkout's csrc/owned_extract.cu: its K7, with its
    own entry points (another checkout's ops/marching would call this
    checkout's wrapper)."""
    import importlib.util
    from disn_tpu_torch import kernels
    spec = importlib.util.spec_from_file_location(
        "parent_owned_extract",
        os.path.join(root, "disn_tpu_torch", "ops", "owned_extract.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = os.path.join(root, "disn_tpu_torch", "csrc", "owned_extract.cu")
    mod.build = lambda: kernels.nvcc_build("owned_extract", src=src)
    return mod


def so_field(kind: str, R: int, device):
    """A seeded [R]^3 f32 field on the card: a sphere inside the box, one
    the box cuts (ghost cells), no change cell, every cell changing (a
    checkerboard), corners at +-0.0, NaN, values exactly at SO_AT_ISO."""
    import torch
    rng = np.random.RandomState(22)
    lin = np.linspace(-1, 1, R)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = np.sqrt(x * x + y * y + z * z) - 0.6
    if kind == "sphere":
        v = sphere
    elif kind == "cut":
        v = np.sqrt((x - 0.5) ** 2 + (y - 0.45) ** 2 + (z - 0.55) ** 2) - 0.9
    elif kind == "none":
        v = np.ones((R, R, R))
    elif kind == "every":
        v = np.where(np.indices((R, R, R)).sum(0) % 2 == 0, 1.0, -1.0)
    elif kind == "zeros":
        v = sphere + 0.02 * rng.randn(R, R, R)
        v[rng.rand(R, R, R) < 0.1] = 0.0
        v[rng.rand(R, R, R) < 0.1] = -0.0
    elif kind == "nan":
        v = sphere + 0.05 * rng.randn(R, R, R)
        v[rng.rand(R, R, R) < 0.02] = np.nan
    elif kind == "at_iso":
        v = np.round(sphere * 8) / 8 + SO_AT_ISO
    else:
        raise ValueError(kind)
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)


def so_coarse(vol, iso: float):
    """The coarse cells (stride 4) with a corner within 0.3 of the iso or
    corners of both signs: a band like the sparse pass's active cells."""
    import torch
    c = (vol.shape[0] - 1) // 4
    vc = vol[::4, ::4, ::4][:c + 1, :c + 1, :c + 1] - iso
    corners = torch.stack([vc[dz:dz + c, dy:dy + c, dx:dx + c]
                           for dz in (0, 1) for dy in (0, 1)
                           for dx in (0, 1)])
    act = ((corners.abs().amin(0) < 0.3)
           | ((corners < 0).any(0) & (corners >= 0).any(0)))
    return torch.nonzero(act.reshape(-1))[:, 0].int()


def same_bits(a, b) -> bool:
    """Equal type, shape and bits (floats as their bit patterns)."""
    import torch
    if not torch.is_tensor(a):
        return a == b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def hold_scan(label: str, vol, iso: float, ids=None, count=None):
    """K2s against _candidate_scan_plain on one input: bits, flags and
    counts bit for bit -> the counts."""
    from disn_tpu_torch.ops import marching
    got = marching._candidate_scan(vol, iso, ids, count)
    want = marching._candidate_scan_plain(vol, iso, ids, count)
    ok = [same_bits(g, w) for g, w in zip(got, want)]
    check(all(ok), f"[scan owned] {label}: the scan differs from its plain "
                   f"version (bits, cand, counts equal: {ok}; counts "
                   f"{got[2].tolist()} against {want[2].tolist()})")
    return got[2].tolist()


def hold_fixed(label: str, args, blk=None) -> tuple:
    """K7's fixed form against _extract_owned_fixed_plain on (volume,
    sdf_params, ids, n, iso, n_iter, batch), through the scan's rows `blk`
    when given: every output bit for bit; with rows, also against the
    dense route's kernel (the same owners through the [R^3] table) ->
    (nv, ntri, missing)."""
    from disn_tpu_torch.ops import marching
    got = marching._extract_owned_fixed(*args, blk=blk)
    want = marching._extract_owned_fixed_plain(*args, blk=blk)
    ok = [same_bits(g, w) for g, w in zip(got, want)]
    check(all(ok), f"[scan owned] {label}: the fixed extractor differs from "
                   f"its plain version (verts, nv, faces, ntri, missing "
                   f"equal: {ok})")
    if blk is not None:
        dense = marching._extract_owned_fixed(*args)
        ok = [same_bits(g, w) for g, w in zip(got, dense)]
        check(all(ok), f"[scan owned] {label}: the rows' look-up differs "
                       f"from the dense table's ({ok})")
    return int(got[1]), int(got[3]), int(got[4])


def hold_exact(label: str, vol, sp, ids, iso: float, blk=None) -> tuple:
    """K7's exact route against _extract_owned_plain, through the rows
    `blk` when given (and then against the dense route's kernel too): the
    rows bit for bit, or the same ValueError -> (nv, ntri), or the error's
    text."""
    from disn_tpu_torch.ops import marching
    outs = []
    fns = [(marching._extract_owned, blk), (marching._extract_owned_plain,
                                            blk)]
    if blk is not None:
        fns.append((marching._extract_owned, None))
    for fn, rows in fns:
        try:
            outs.append(fn(vol, sp, ids, iso, rows))
        except ValueError as e:
            outs.append(str(e))
    got, want = outs[:2]
    for other, what in zip(outs[1:], ("plain", "dense route's")):
        if isinstance(other, str) or isinstance(got, str):
            check(got == other, f"[scan owned] {label}: the {what} route "
                                f"gave {other!r}, the kernel's {got!r}")
        else:
            check(same_bits(got[0], other[0]) and same_bits(got[1], other[1]),
                  f"[scan owned] {label}: the exact route differs from the "
                  f"{what} one")
    if isinstance(want, str):
        return want
    return got[0].shape[0], got[1].shape[0]


def device_us_all(tag: str, fn) -> float:
    """torch.profiler over LIBRARY_CALLS calls of fn(): the device time a
    call of every device event (a chain of PyTorch ops), us."""
    from torch.autograd import DeviceType
    prof, _ = profiled(lambda: [fn() for _ in range(LIBRARY_CALLS)])
    dev = [(e.key, e.count, _device_time(e, True))
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(us for _, _, us in dev) / LIBRARY_CALLS
    print(f"{tag} device: {len(dev)} kinds of device event, {total:.2f} us "
          f"a call")
    return total


class PlainScanOwned:
    """A context in which ops/marching's _candidate_scan, _extract_owned
    and _extract_owned_fixed take their plain versions on the card: the
    code path before K2s and K7 were kernels."""

    def __enter__(self):
        from disn_tpu_torch.ops import marching as m
        self.saved = (m._candidate_scan, m._extract_owned,
                      m._extract_owned_fixed)
        m._candidate_scan = m._candidate_scan_plain
        m._extract_owned = m._extract_owned_plain
        m._extract_owned_fixed = m._extract_owned_fixed_plain
        return self

    def __exit__(self, *exc):
        from disn_tpu_torch.ops import marching as m
        (m._candidate_scan, m._extract_owned,
         m._extract_owned_fixed) = self.saved


def so_turns(tag: str, change, plain) -> dict:
    """This tree's function (change) and its yardstick (plain: --parent's
    function, else the plain version) in turns (plain, change, change,
    plain): ms on CUDA events (median of 20) and device us by the
    profiler (every device event of a call)."""
    out: dict = {"plain": {"ms": [], "device_us": []},
                 "change": {"ms": [], "device_us": []}}
    for arm in ("plain", "change", "change", "plain"):
        fn = change if arm == "change" else plain
        out[arm]["ms"].append(median_ms(fn, True, 20))
        out[arm]["device_us"].append(device_us_all(f"{tag} {arm}", fn))
    for arm, r in out.items():
        print(f"{tag} {arm} in turns: {[round(v, 4) for v in r['ms']]} ms "
              f"(CUDA events, median of 20), device "
              f"{[round(v, 2) for v in r['device_us']]} us (profiler); "
              f"{card_name()}")
    return out


def phase_scan_owned(kept: dict, cfg, params, img, trans) -> dict:
    """[scan owned]: K2s (csrc/change_scan.cu) and K7
    (csrc/owned_extract.cu) against their plain versions on the card, bit
    for bit over their whole outputs: on the main path's kept inputs of a
    volume-flow seed (the exact scan, the exact extraction) and a hit (the
    fixed forms, the capped compaction's rows with their zero rows), the
    hit's list cut at half its slots; on grids of SO_GRIDS (100^3 through
    _active_cells_ext_rows); on SO_EDGES at 65^3; with ghost cells, slots
    past the cells, count 0, a list the slots do not cover (missing > 0,
    the exact route raising where the plain one raises) and the capped
    compaction's lists and rows (a cap that keeps every block, the least
    cap). K7 takes the scan's rows, as the main path calls it, and is held
    to the dense table's route of the same kernels too. Then each
    kernel's wrapper on CUDA events (median of 20) beside the plain
    version and its bound, its kernels' device time by the profiler (no
    memset on K7's rows route), launch calls a call, K7's scratch bytes a
    call (at most SO_SCRATCH_MAX); both kernels in turns with --parent
    DIR's functions (its own K7 build: the dense-table design; else the
    plain versions), K7's kernels by name in the same turns; and a
    volume-flow hit's launch calls an image with the plain versions
    (PlainScanOwned), with --parent's K7 and with this tree's kernels
    (cfg: the main path's, with sparse_words=False). Returns the kernel
    table's entries."""
    import torch
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.ops import change_scan, marching, owned_extract

    t_phase = time.perf_counter()
    smi = card_name()
    dev = torch.device("cuda")
    (sargs_s, skw_s), (sargs_h, skw_h) = kept["volume scan"]
    (eargs_s, ekw_s), (eargs_h, ekw_h) = kept["volume extract"]
    blk_s, blk_h = ekw_s["blk"], ekw_h["blk"]
    check(skw_s["count"] is None and skw_h["count"] is not None
          and not torch.is_tensor(eargs_s[3]) and torch.is_tensor(eargs_h[3])
          and blk_s is not None and blk_h is not None,
          "[scan owned] the kept volume-flow launches are not a seed's "
          "(exact forms) then a hit's (fixed forms), each with its rows")

    # the main path's inputs
    for label, (args, kw) in (("seed's scan (exact form)", (sargs_s, skw_s)),
                              ("hit's scan (fixed form)", (sargs_h, skw_h))):
        counts = hold_scan(label, *args, kw["coarse_ids"], kw["count"])
        print(f"[scan owned] main path, {label}: bit for bit; total, inside, "
              f"outside {counts}")
    vol_h, sp_h, ids_h, n_h, iso_h, S_h = eargs_h
    res = hold_fixed("hit's extraction", (vol_h, sp_h, ids_h, n_h, iso_h,
                                          S_h, 1), blk_h)
    zero_rows = int((blk_h[:, 1:] == 0).all(1).sum())
    print(f"[scan owned] main path, hit's extraction (S = {S_h}, n = "
          f"{int(n_h)}, {blk_h.shape[0]} rows of which {zero_rows} zero "
          f"rows): bit for bit its plain version and the dense table's "
          f"route; nv, ntri, missing {res}")
    cut = hold_fixed("hit's list at S = n/2", (vol_h, sp_h, ids_h, n_h,
                                                iso_h, int(n_h) // 2, 1),
                     blk_h)
    check(cut[2] > 0, f"[scan owned] the hit's list cut at n/2: missing "
                      f"{cut[2]}, expected > 0")
    vol_s, sp_s, ids_s, n_s, iso_s, _ = eargs_s
    res = hold_exact("seed's extraction", vol_s, sp_s, ids_s, iso_s, blk_s)
    fres = hold_fixed("seed's list, fixed at S = n",
                      (vol_s, sp_s, ids_s, n_s, iso_s, n_s, 1), blk_s)
    print(f"[scan owned] main path, seed's extraction (exact, n = {n_s}, "
          f"{blk_s.shape[0]} rows): bit for bit, (nv, ntri) {res}; the "
          f"fixed form at S = n {fres}; the hit's list at S = n/2 {cut}")

    # grids, edge cases, slot cases
    boxes = {"unit": torch.tensor([-1, -1, -1, 1, 1, 1], dtype=torch.float32,
                                  device=dev),
             "skewed": torch.tensor([-0.7, -1.1, -0.4, 0.9, 1.3, 0.8],
                                    dtype=torch.float32, device=dev)}
    cases = [("sphere", R) for R in SO_GRIDS] + [("cut", 65)] + [
        (kind, 65) for kind in SO_EDGES]
    for kind, R in cases:
        iso = SO_AT_ISO if kind == "at_iso" else 0.0
        vol = so_field(kind, R, dev)
        full = hold_scan(f"{kind} {R}^3 full", vol, iso)
        line = f"full {full}"
        if R != 100:
            cids = so_coarse(vol, iso)
            pad = torch.full((cids.shape[0] + 333,), 7, dtype=torch.int32,
                             device=dev)
            pad[:cids.shape[0]] = cids
            line += f", coarse {hold_scan(f'{kind} {R}^3 coarse', vol, iso, cids)}"
            for cnt in (cids.shape[0], 0, pad.shape[0] + 5):
                hold_scan(f"{kind} {R}^3 fixed count {cnt}", vol, iso, pad,
                          torch.tensor(cnt, dtype=torch.int32, device=dev))
            line += " (fixed: the count, 0, past the list)"
            cnt = torch.tensor(cids.shape[0], dtype=torch.int32, device=dev)
            capped = []
            for bcap in (4 * cids.shape[0] + 4096, 64):
                cap_ids, cap_n, _, gov, cap_blk = \
                    marching._active_cells_from_coarse(vol, cids, iso,
                                                       count=cnt, bcap=bcap)
                nn = int(cap_n)
                if nn:
                    for S in (nn, max(1, nn // 2)):
                        capped.append(hold_fixed(
                            f"{kind} {R}^3 capped at {bcap} S {S}",
                            (vol, boxes["skewed"], cap_ids, cap_n, iso, S, 1),
                            cap_blk) + (int(gov),))
            line += f"; capped lists (nv, ntri, missing, gov) {capped}"
        ids, n, blk = marching._active_cells_ext_rows(vol, iso)
        if 0 < n < 100000:
            padded = torch.zeros(n + 700, dtype=torch.int32, device=dev)
            padded[:n] = ids
            for box, sp in boxes.items():
                got = [hold_fixed(f"{kind} {R}^3 {box} S {S} live {live}",
                                  (vol, sp, padded,
                                   torch.tensor(live, dtype=torch.int32,
                                                device=dev), iso, S, 1), blk)
                       for S, live in ((n + 500, n), (n, n), (n + 500, 0),
                                       (n // 2, n))]
                check(got[0][2] == 0 and got[3][2] > 0,
                      f"[scan owned] {kind} {R}^3: missing {got}, expected "
                      f"0 where the slots cover the cells and > 0 where "
                      f"they do not")
                ex = hold_exact(f"{kind} {R}^3 {box} exact", vol, sp, ids,
                                iso, blk)
                cut = hold_exact(f"{kind} {R}^3 {box} a third of the list",
                                 vol, sp, ids[:n // 3], iso, blk)
                check(isinstance(cut, str),
                      f"[scan owned] {kind} {R}^3: the cut list did not "
                      f"raise")
            line += (f"; {n} cells extracted ({box}: S past n, S = n, count "
                     f"0, S = n/2 with missing {got[3][2]}; exact {ex}; a "
                     f"third of the list raises on every route)")
        print(f"[scan owned] {kind} {R}^3 iso {iso}: bit for bit, rows and "
              f"dense routes; {line}")
    vol = so_field("cut", 65, dev)
    ids, n = marching._active_cells_ext(vol, 0.0)
    ghosts = ids[(marching._cell_xyz(ids, 65) == 64).any(1)].contiguous()
    g = hold_fixed("cut 65^3 ghost cells alone",
                   (vol, boxes["skewed"], ghosts, ghosts.shape[0], 0.0,
                    ghosts.shape[0], 1))
    check(ghosts.shape[0] > 0 and g[0] > 0 and g[1] == 0,
          f"[scan owned] ghost cells: {ghosts.shape[0]} cells, (nv, ntri, "
          f"missing) {g}; expected vertices and no triangle")
    print(f"[scan owned] cut 65^3: {ghosts.shape[0]} ghost cells alone (a "
          f"hand-built list: the dense route), bit for bit, (nv, ntri, "
          f"missing) {g}")

    # times, launches, bounds on the main path's inputs
    key = pipeline._vkey(cfg, cfg.iso)
    sizes = pipeline._spec_sizes(cfg)
    nb_p = min(pipeline._SPEC_CACHE[key][0], sizes["max_blocks"])
    bcap = pipeline._fused_bcap(nb_p, sizes)
    pm, pk7 = PARENT_SO.get("marching"), PARENT_SO.get("k7")
    vol, iso = sargs_h
    cids, cnt = skw_h["coarse_ids"], skw_h["count"]
    R = vol.shape[0]
    nb = (-(-R // 4)) ** 3
    fixed_args = (vol_h, sp_h, ids_h, n_h, iso_h, S_h, 1)
    fns = {
        "scan": (lambda: change_scan.change_scan(vol, iso, cids, cnt),
                 lambda: marching._candidate_scan_plain(vol, iso, cids, cnt),
                 SO_NAMES["coarse scan"]),
        "extract": (lambda: owned_extract.extract_owned(*eargs_h, **ekw_h),
                    lambda: marching._extract_owned_fixed_plain(
                        *fixed_args, blk=blk_h),
                    SO_NAMES["extract"]),
        "dense extract": (lambda: owned_extract.extract_owned(*eargs_h),
                          lambda: marching._extract_owned_fixed_plain(
                              *fixed_args),
                          SO_NAMES["dense extract"]),
        "full scan": (lambda: change_scan.change_scan(vol, iso),
                      lambda: marching._candidate_scan_plain(vol, iso),
                      SO_NAMES["full scan"])}
    live = min(int(n_h), S_h)
    outputs = S_h * 7 * 12 + S_h * 12 * 12 + 12
    nbytes = {"scan": 4 * R ** 3 + 4 * int(cnt) + 9 * nb + 12,
              "extract": 4 * S_h + 32 * live + 24 + 4 + 12 * blk_h.shape[0]
              + outputs,
              "dense extract": 4 * S_h + 32 * live + 24 + 4 + outputs,
              "full scan": 4 * R ** 3 + 9 * nb + 12}
    most = {"scan": 3, "extract": 3, "dense extract": 4, "full scan": 2}
    out = {}
    for name, (fn, plain, names) in fns.items():
        ms = median_ms(fn, True, 20)
        plain_ms = median_ms(plain, True, 20)
        dev_us = library_device_us(f"[scan owned profile] {name}", fn, names)
        bound, by = k_bound(nbytes[name], 0.0)
        calls = launch_calls(fn)
        n_calls = sum(v for k, v in calls.items()
                      if k.startswith("cuda") and "Memcpy" not in k)
        print(f"[scan owned] {name} on the main path's hit inputs: wrapper "
              f"{ms:.4f} ms (CUDA events, median of 20), its kernels "
              f"{dev_us:.2f} us by the profiler, plain {plain_ms:.4f} ms; "
              f"bound {bound:.5f} ms ({by}, {nbytes[name]} B); runtime "
              f"calls a call {calls}; {smi}")
        check(n_calls <= most[name] and not any("Memcpy" in k for k in calls),
              f"[scan owned] {name}: {calls}; expected at most {most[name]} "
              f"launch calls (memsets included) and no copy")
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, library_ms=None, max_abs_err=0.0,
                         device_us=dev_us, calls=n_calls)
    check(out["extract"]["calls"] == 3,
          f"[scan owned] K7 on the rows route made {out['extract']['calls']} "
          f"launch calls, expected 3 and no memset")
    scratch = {"rows": owned_extract.scratch_bytes(R, S_h, blk_h.shape[0]),
               "dense": owned_extract.scratch_bytes(R, S_h, None)}
    if pk7:  # its dense route; a K7 before the rows takes (R, S)
        words = pk7._lib().owned_scratch_words
        scratch["--parent's"] = (pk7.scratch_bytes(R, S_h, None)
                                 if len(words.argtypes) == 4
                                 else 4 * words(R, S_h))
    print(f"[scan owned] K7's scratch a call at R = {R}, S = {S_h}, "
          f"{blk_h.shape[0]} rows: {scratch} bytes")
    check(scratch["rows"] <= SO_SCRATCH_MAX,
          f"[scan owned] K7's scratch {scratch['rows']} B a call, more than "
          f"{SO_SCRATCH_MAX}")
    out["extract"]["scratch"] = scratch["rows"]

    exact_ms = median_ms(lambda: marching._extract_owned(
        vol_s, sp_s, ids_s, iso_s, blk_s), True, 20)
    exact_plain = median_ms(lambda: marching._extract_owned_plain(
        vol_s, sp_s, ids_s, iso_s, blk_s), True, 20)
    calls = launch_calls(lambda: marching._extract_owned(
        vol_s, sp_s, ids_s, iso_s, blk_s))
    print(f"[scan owned] exact extraction on the seed's list ({n_s} cells, "
          f"its rows): {exact_ms:.4f} ms (its wait included), plain "
          f"{exact_plain:.4f} ms; runtime calls {calls}; {smi}")

    # in turns with --parent's functions (else the plain versions)
    arm = "--parent's" if pm else "the plain version's"
    src = pm if pm else None
    whole = {
        "candidate scan, fixed (scan + compaction + gov)": (
            lambda: marching._active_cells_from_coarse(
                vol, cids, iso, count=cnt, bcap=bcap),
            lambda: (src._active_cells_from_coarse(vol, cids, iso, count=cnt,
                                                   bcap=bcap) if src else
                     _plain_call(marching._active_cells_from_coarse, vol,
                                 cids, iso, count=cnt, bcap=bcap))),
        "owned extractor, fixed": (
            lambda: marching._extract_owned_fixed(*fixed_args, blk=blk_h),
            lambda: (pk7.extract_owned(*eargs_h) if pk7 else
                     marching._extract_owned_fixed_plain(*fixed_args)))}
    for name, (fn, yard) in whole.items():
        if pm:
            want = yard()
            got = fn()
            check(all(same_bits(a, b) for a, b in zip(got, want)),
                  f"[scan owned] {name}: this tree's result is not "
                  f"--parent's")
        calls = (launch_calls(fn), launch_calls(yard))
        print(f"[scan owned turns] {name}, in turns with {arm}: runtime "
              f"calls a call {calls[0]} against {calls[1]}")
        so_turns(f"[scan owned turns] {name}", fn, yard)
    if pk7:  # K7's kernels by name, in turns with --parent's
        for who in ("--parent's", "this tree's", "this tree's",
                    "--parent's"):
            if who == "--parent's":
                library_device_us(f"[scan owned turns] K7 kernels, {who}",
                                  lambda: pk7.extract_owned(*eargs_h),
                                  SO_NAMES["dense extract"])
            else:
                library_device_us(
                    f"[scan owned turns] K7 kernels, {who}",
                    lambda: owned_extract.extract_owned(*eargs_h, **ekw_h),
                    SO_NAMES["extract"])
    for name, (fn, yard) in {
            "candidate scan, exact (the seed's)": (
                lambda: marching._active_cells_from_coarse(
                    vol_s, skw_s["coarse_ids"], iso_s),
                lambda: (src._active_cells_from_coarse(
                    vol_s, skw_s["coarse_ids"], iso_s) if src else
                    _plain_call(marching._active_cells_from_coarse, vol_s,
                                skw_s["coarse_ids"], iso_s))),
            "owned extractor, exact (the seed's)": (
                lambda: marching._extract_owned(vol_s, sp_s, ids_s, iso_s,
                                                blk_s),
                lambda: (pk7.extract_owned_exact(vol_s, sp_s, ids_s, iso_s)
                         if pk7 else marching._extract_owned_plain(
                             vol_s, sp_s, ids_s, iso_s)))}.items():
        res = {"plain": [], "change": []}
        for a in ("plain", "change", "change", "plain"):
            res[a].append(round(median_ms(fn if a == "change" else yard,
                                          True, 20), 4))
        print(f"[scan owned turns] {name}, in turns with {arm} (CUDA events, "
              f"median of 20, waits included): {arm} {res['plain']} ms, "
              f"this tree {res['change']} ms; {smi}")

    # a volume-flow hit's launch calls an image
    def run():
        pipeline.image_to_mesh(params, img, trans, cfg)

    run()
    hits = pipeline.spec_counts["hit"]
    with PlainScanOwned():
        run()
        before = launch_calls(run)
    counted = [before]
    if pk7:  # --parent's K7 (no rows) in this tree's flow
        this_k7 = owned_extract.extract_owned
        owned_extract.extract_owned = (
            lambda *args, blk=None: pk7.extract_owned(*args))
        try:
            run()
            counted.append(launch_calls(run))
        finally:
            owned_extract.extract_owned = this_k7
    run()
    after = launch_calls(run)
    counted.append(after)
    check(pipeline.spec_counts["hit"] - hits == 2 * len(counted),
          "[scan owned] the counted volume-flow images were not all hits")
    launches = [sum(v for k, v in c.items() if "LaunchKernel" in k)
                for c in counted]
    memsets = [c.get("cudaMemsetAsync", 0) for c in counted]
    print(f"[scan owned] one volume-flow image_to_mesh (a hit): "
          f"{launches[0]} launch calls with the plain scan and extractor, "
          + (f"{launches[1]} with --parent's K7, " if pk7 else "")
          + f"{launches[-1]} with K2s and this K7 (every launch call, "
          f"cluster launches included), and {memsets} memset calls; runtime "
          f"calls {counted}; {smi}")
    check(launches[0] - launches[-1] >= 150,
          f"[scan owned] the kernels cut a hit's launch calls by "
          f"{launches[0] - launches[-1]}, fewer than 150")
    if pk7:
        check(launches[1] == launches[-1] and memsets[1] - memsets[-1] == 1,
              f"[scan owned] a hit with --parent's K7: {launches[1]} launch "
              f"calls and {memsets[1]} memsets, with this one "
              f"{launches[-1]} and {memsets[-1]}: expected one memset fewer "
              f"(the owner table's)")
    out["image_launches"] = launches
    out["image_memsets"] = memsets
    print(f"[scan owned] phase seconds {time.perf_counter() - t_phase:.1f}")
    return out


def _plain_call(fn, *args, **kw):
    """fn(*args, **kw) with the plain scan and extractor (PlainScanOwned)."""
    with PlainScanOwned():
        return fn(*args, **kw)


def trace_busy(tdir: str) -> tuple[float, float, int, int]:
    """(device busy us, span of device activity us, device events, host
    synchronisations) of the Chrome trace in tdir."""
    with open(os.path.join(tdir, "trace.json")) as f:
        events = json.load(f)
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    check(len(spans) > 0, f"no device activity in {tdir}/trace.json")
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    syncs = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                and "Synchronize" in e.get("name", ""))
    return busy, spans[-1][1] - spans[0][0], len(spans), syncs


def profile_phase_a(cfg, params, img, trans) -> None:
    """[phase_a profile]: one phase_a (encode, fold, the coarse 65^3 pass,
    the band cull) timed on the host clock, then under torch.profiler
    (twice; the second is read): the device's idle share of the span of
    its activity and of the unprofiled wall, the 10 PyTorch ops and the 5
    kernels with the most self time on the device (K1 is a kernel of no
    PyTorch op). Then [k4] (phase_k4) on the coarse grid it made."""
    import torch
    from torch.autograd import DeviceType

    from disn_tpu_torch import device as device_mod
    from disn_tpu_torch.infer import dense, pipeline, sparse

    dev = torch.device("cuda")
    params = device_mod.tree_to(params, dev)
    img_t, trans_t, sdfp = dense.as_inputs(img, trans, pipeline.UNIT_BOX, dev)

    def run():
        return sparse.phase_a(params, img_t, trans_t, sdfp, cfg)

    wall = median_ms(run, False)
    tdir = os.path.join(TRACE_DIR, "phase_a")
    profiled(run, tdir=tdir)  # the first profiled call starts the tracer
    prof, (_, _, vol_c, _, count) = profiled(run, tdir=tdir)
    busy, window, n_ev, syncs = trace_busy(tdir)
    tag = "[phase_a profile]"
    print(f"{tag} one phase_a: wall {wall:.3f} ms without the profiler "
          f"(host clock, median of 5); under it (the second profiled call) "
          f"device busy {busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms span "
          f"of device activity, idle share {1 - busy / window:.4f} (of the "
          f"unprofiled wall {1 - busy / 1e3 / wall:.4f}); {n_ev} device "
          f"events, {syncs} host synchronisations; trace in "
          f"{os.path.relpath(tdir, ROOT)}/trace.json")
    avg = prof.key_averages()
    for kind, dt, n in (("op", DeviceType.CPU, 10),
                        ("kernel", DeviceType.CUDA, 5)):
        rows = [e for e in avg if e.device_type == dt]
        for e in sorted(rows, key=lambda e: -_device_time(e, True))[:n]:
            t = _device_time(e, True)
            print(f"{tag} top {kind}: {e.key[:100]} self {t / 1e3:.3f} ms "
                  f"in {e.count} calls ({t / busy:.4f} of busy)")
    return phase_k4(cfg, params, img_t, trans_t, sdfp, vol_c)


class PlainCulls:
    """A context in which infer/sparse's _band_cull, _band_tau and
    _active_cells and ops/marching's _compact_block_bits take their plain
    versions on the card: the code path before K4 and the compaction were
    kernels (the plain versions are its functions, unchanged)."""

    def __enter__(self):
        from disn_tpu_torch.infer import sparse
        from disn_tpu_torch.ops import marching
        self.saved = (sparse._band_cull, sparse._band_tau,
                      sparse._active_cells, marching._compact_block_bits)
        sparse._band_cull = sparse._band_cull_plain
        sparse._band_tau = sparse._band_tau_plain
        sparse._active_cells = sparse._active_cells_plain
        marching._compact_block_bits = marching._compact_block_bits_plain
        return self

    def __exit__(self, *exc):
        from disn_tpu_torch.infer import sparse
        from disn_tpu_torch.ops import marching
        (sparse._band_cull, sparse._band_tau, sparse._active_cells,
         marching._compact_block_bits) = self.saved


def launch_calls(fn) -> dict:
    """The runtime's kernel launch calls (cudaLaunchKernel, the cluster
    launches' cudaLaunchKernelExC, ...), memset and copy calls in one fn()
    under torch.profiler, by name (with the device's memset and copy
    events, whose names do not start with "cuda")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if any(k in e.name for k in ("LaunchKernel", "Memset", "Memcpy")):
            out[e.name] = out.get(e.name, 0) + 1
    return out


def count_launches(fn) -> int:
    """Kernel launches in one fn() under torch.profiler: the runtime's
    launch calls of every kind (cudaLaunchKernel alone leaves out the
    cluster launches, cudaLaunchKernelExC)."""
    return sum(n for k, n in launch_calls(fn).items() if "LaunchKernel" in k)


def k_bound(nbytes: int, flops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for nbytes moved once and flops
    f32 operations on the FMA units."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def same_tau(a, b) -> bool:
    import torch
    if bool(torch.isnan(a)) and bool(torch.isnan(b)):
        return True
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def hold_k4(label: str, vol_c, sdfp, cfg, mode: str, max_cells: int) -> int:
    """K4 against its plain versions on one grid, through each entry: the
    fused call (tau and the cull in one launch) in the exact form and the
    fixed form at max_cells (padding and count), tau alone, and the cull
    alone on the plain tau; tau's bits, ids and counts equal. Returns the
    active cells."""
    from disn_tpu_torch.infer import sparse
    from disn_tpu_torch.ops import band_cull

    rc = vol_c.shape[0]
    bf = cfg.band_factor
    tau_p, ids_p, n_p = sparse._band_cull_plain(vol_c, sdfp, rc, bf, cfg,
                                                mode)
    _, fix_p, cnt_p = sparse._band_cull_plain(vol_c, sdfp, rc, bf, cfg,
                                              mode, max_cells)
    tau, ids, n = sparse._band_cull(vol_c, sdfp, rc, bf, cfg, mode)
    tau_f, fix, cnt = sparse._band_cull(vol_c, sdfp, rc, bf, cfg, mode,
                                        max_cells)
    tau_e = sparse._band_tau(vol_c, sdfp, rc, bf, cfg)
    ids_e, n_e = band_cull.active_cells(vol_c, tau_p, mode)
    fix_e, cnt_e = band_cull.active_cells(vol_c, tau_p, mode, max_cells)
    ok = (same_tau(tau, tau_p) and same_tau(tau_f, tau_p)
          and same_tau(tau_e, tau_p) and n == n_p == n_e
          and torch_equal(ids, ids_p) and torch_equal(ids_e, ids_p)
          and torch_equal(fix, fix_p) and torch_equal(cnt, cnt_p)
          and torch_equal(fix_e, fix_p) and torch_equal(cnt_e, cnt_p))
    print(f"[k4] {label} ({mode}, {rc}^3): tau {float(tau)!r} (plain "
          f"{float(tau_p)!r}), {n} active cells (plain {n_p}), the fixed "
          f"form at {max_cells}: count {int(cnt)}; fused, tau and cull "
          f"entries equal={ok}")
    check(ok, f"[k4] {label} ({mode}): the kernel differs from its plain "
              f"versions")
    return n


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call of fn over `calls` calls queued with no
    sync (time.perf_counter_ns), after a warm-up; the card is synchronised
    after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


PARENT_CULL: dict = {}  # another checkout's K4 and compaction (--parent)


def cull_parent(root: str) -> dict:
    """Another checkout's K4 and compaction wrappers (ops/band_cull.py and
    ops/block_compact.py, loaded under other names; they import this
    checkout's helpers), each bound to a build of that checkout's source."""
    import importlib.util

    from disn_tpu_torch import kernels

    out = {}
    for name in ("band_cull", "block_compact"):
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}",
            os.path.join(root, "disn_tpu_torch", "ops", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        src = os.path.join(root, "disn_tpu_torch", "csrc", f"{name}.cu")
        mod.build = (lambda name=name, src=src:
                     kernels.nvcc_build(name, src=src))
        mod._lib.cache_clear()
        out[name] = mod
    return out


def k4_call(mod, vol_c, sdfp, rc, cfg, mode, max_cells):
    """phase_a's tau and cull through a checkout's K4 wrappers: its fused
    entry where it has one, else tau then the cull (two calls)."""
    autocal = cfg.band_autocal and not cfg.binary
    if hasattr(mod, "band_cull"):
        return lambda: mod.band_cull(vol_c, sdfp, rc, cfg.band_factor,
                                     autocal, mode, max_cells)

    def pair():
        tau = mod.band_tau(vol_c, sdfp, rc, cfg.band_factor, autocal)
        return (tau, *mod.active_cells(vol_c, tau, mode, max_cells))
    return pair


# the kernels of each checkout's K4 and compaction, for the profiler: a
# parent from before the cluster kernels has these, a later one the
# change's (parent_kernels)
K4_KERNELS = {"change": ("band_cull_kernel",),
              "parent": ("tau_vmin", "tau_lip", "tau_final", "cull_count",
                         "cull_write")}
KC_KERNELS = {"change": ("compact_kernel",),
              "parent": ("bc_count", "bc_write", "bc_finish")}


def parent_kernels(table: dict, name: str) -> dict:
    """`table` with the parent's kernel names for PARENT_CULL[name]: the
    change's when that checkout launches a cluster kernel (its wrapper
    module plans the cluster: CTAS)."""
    if hasattr(PARENT_CULL.get(name), "CTAS"):
        return {"change": table["change"], "parent": table["change"]}
    return table


def turns(tag: str, fns: dict, names: dict) -> dict:
    """The change's and, with --parent, the parent's calls in turns
    (parent, change, change, parent): the wrapper's ms on CUDA events
    (median of 20), its kernels' device us by the profiler (their kernels
    and no other device work) and its host us a call; returns the lists by
    arm."""
    order = (["parent", "change", "change", "parent"] if "parent" in fns
             else ["change", "change"])
    out: dict = {k: {"ms": [], "device_us": [], "host_us": []} for k in fns}
    for arm in order:
        out[arm]["ms"].append(median_ms(fns[arm], True, 20))
        out[arm]["device_us"].append(library_device_us(
            f"{tag} {arm}", fns[arm], names[arm]))
        out[arm]["host_us"].append(host_us(fns[arm]))
    for arm, r in out.items():
        print(f"{tag} {arm} in turns: wrapper "
              f"{[round(v, 4) for v in r['ms']]} ms (CUDA events, median of "
              f"20), kernels {[round(v, 2) for v in r['device_us']]} us "
              f"(profiler), host {[round(v, 2) for v in r['host_us']]} us a "
              f"call; {card_name()}")
    return out


# calls of a library in one profiler window: late in a long run the
# profiler drops the first device events of a window, one or two and, in
# a long enough process, a dozen, so each kernel is timed over the calls
# it kept
LIBRARY_CALLS = 8


def library_device_us(tag: str, fn, names: tuple) -> float:
    """torch.profiler over LIBRARY_CALLS calls of fn(): the device must run
    the library's kernels `names` and nothing else (no PyTorch op's kernel,
    no copy); returns their device time a call (each kernel's mean over
    its events), us."""
    from torch.autograd import DeviceType

    prof, _ = profiled(lambda: [fn() for _ in range(LIBRARY_CALLS)],
                       want=names)
    dev = [(e.key, e.count, _device_time(e, True))
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    for key, count, us in dev:
        print(f"{tag} device: {key[:90]} x{count} {us / count:.2f} us each")
    check(len(dev) == len(names)
          and all(any(n in k for n in names) for k, _, _ in dev)
          and all(count <= LIBRARY_CALLS for _, count, _ in dev),
          f"{tag}: the calls ran other device work: {dev}")
    return sum(us / count for _, count, us in dev)


def torch_equal(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and torch.equal(a, b)


def octahedron_grid(rc: int, device):
    """The analytic head's field |x|+|y|+|z| - 0.6 on an rc^3 lattice over
    the unit box (the main path's coarse grid at rc 65)."""
    import torch
    lin = torch.linspace(-1.0, 1.0, rc, device=device)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    return (x.abs() + y.abs() + z.abs() - 0.6).contiguous()


def phase_k4(cfg, params, img_t, trans_t, sdfp, vol_c) -> dict:
    """[k4]: K4 (one cluster launch: tau and the cull) against its plain
    versions on the main path's coarse grid and sizes (both forms, both
    modes, the fixed form past its cap, every entry), on edge grids (no
    active cell, every cell, corners at +-0.0, NaN and +-inf) and on grids
    past the main path's (129^3, a ragged 100^3); one launch a call of each
    entry; the fused call and the plain pair timed on CUDA events beside
    the bound, the kernel's device time by the profiler, host us a call;
    clusters of 16 and 8 CTAs in turns; with --parent, that checkout's K4
    in turns with this one's; phase_a's launches and its host-clock stage
    with the plain versions (PlainCulls) and with the kernel, in turns.
    Returns the kernel table's entry's numbers."""
    import torch
    from disn_tpu_torch.infer import pipeline, sparse
    from disn_tpu_torch.ops import band_cull

    rc = vol_c.shape[0]
    dev = vol_c.device
    max_cells = (pipeline._spec_sizes(cfg)["max_blocks"]
                 * pipeline._spec_sizes(cfg)["cells_per_block"])
    n = hold_k4("main grid", vol_c, sdfp, cfg, "band", max_cells)
    hold_k4("main grid", vol_c, sdfp, cfg, "sign", max_cells)
    hold_k4("main grid past the cap", vol_c, sdfp, cfg, "band", n // 2)
    rng = np.random.RandomState(19)
    i = torch.arange(rc, device=dev)
    parity = (i[:, None, None] + i[None, :, None] + i[None, None, :]) % 2
    zeros = vol_c.clone().reshape(-1)
    pick = torch.from_numpy(rng.rand(zeros.numel())).to(dev)
    zeros[pick < 0.05] = 0.0
    zeros[(pick >= 0.05) & (pick < 0.1)] = -0.0
    bad = vol_c.clone().reshape(-1)
    bad[pick < 0.01] = float("nan")
    bad[(pick >= 0.01) & (pick < 0.015)] = float("inf")
    bad[(pick >= 0.015) & (pick < 0.02)] = -float("inf")
    for label, grid, want in (
            ("no active cell", vol_c.abs() + 1.0, 0),
            ("every cell", (1 - 2 * parity.float()) * 0.01, (rc - 1) ** 3),
            ("corners at +-0.0", zeros.reshape(vol_c.shape), None),
            ("NaN and +-inf", bad.reshape(vol_c.shape), None),
            ("past the main grid", octahedron_grid(129, dev), None),
            ("a ragged grid", (0.3 * torch.from_numpy(rng.randn(
                100, 100, 100)).float()).to(dev), None)):
        for mode in ("band", "sign"):
            got = hold_k4(label, grid.contiguous(), sdfp, cfg, mode,
                          max_cells)
            check(want is None or got == want,
                  f"[k4] {label} ({mode}): {got} active cells, expected "
                  f"{want}")
    fused = k4_call(band_cull, vol_c, sdfp, rc, cfg, "band", max_cells)
    tau = fused()[0]
    counts = {"band_cull": count_launches(fused),
              "band_tau": count_launches(lambda: band_cull.band_tau(
                  vol_c, sdfp, rc, cfg.band_factor, True)),
              "active_cells": count_launches(lambda: band_cull.active_cells(
                  vol_c, tau, "band", max_cells))}
    print(f"[k4] kernel launches a call (torch.profiler): {counts}")
    check(all(v == 1 for v in counts.values()),
          f"[k4] an entry took other than one launch: {counts}")

    def plain():
        return sparse._band_cull_plain(vol_c, sdfp, rc, cfg.band_factor, cfg,
                                       "band", max_cells)

    ms = {"band_cull": median_ms(fused, True, 20),
          "plain": median_ms(plain, True, 20),
          "band_tau": median_ms(lambda: band_cull.band_tau(
              vol_c, sdfp, rc, cfg.band_factor, True), True, 20)}
    dev_us = library_device_us("[k4 profile] band_cull", fused,
                               K4_KERNELS["change"])
    host = host_us(fused)
    sizes: dict = {16: [], 8: []}
    for ctas in (16, 8, 8, 16):
        band_cull.CTAS = ctas
        sizes[ctas].append((median_ms(fused, True, 20), library_device_us(
            f"[k4 profile] {ctas} CTAs", fused, K4_KERNELS["change"])))
    band_cull.CTAS = 16
    print(f"[k4] clusters in turns (16, 8, 8, 16), (wrapper ms, kernel us): "
          f"16 CTAs {[(round(a, 4), round(b, 2)) for a, b in sizes[16]]}, "
          f"8 CTAs {[(round(a, 4), round(b, 2)) for a, b in sizes[8]]}; "
          f"{card_name()}")
    fns = {"change": fused}
    if PARENT_CULL:
        fns["parent"] = k4_call(PARENT_CULL["band_cull"], vol_c, sdfp, rc,
                                cfg, "band", max_cells)
        want = plain()
        got = fns["parent"]()
        check(same_tau(got[0], want[0]) and torch_equal(got[1], want[1])
              and torch_equal(got[2], want[2]),
              "[k4] the parent's K4 differs from the plain versions")
    k4_turns = turns("[k4 turns]", fns,
                     parent_kernels(K4_KERNELS, "band_cull"))
    grid_b = vol_c.numel() * 4
    bound, by = k_bound(grid_b + 24 + 4 + 4 * max_cells + 4,
                        7 * 7 * vol_c.numel() + 8 * 4 * (rc - 1) ** 3)
    out = {"band_cull": dict(bound_ms=bound, bound_by=by, ms=ms["band_cull"],
                             plain_ms=ms["plain"], max_abs_err=0.0,
                             library_ms=None, device_us=dev_us,
                             host_us=host, turns=k4_turns)}
    print(f"[k4] the main path's tau and cull on the {rc}^3 grid ({n} "
          f"active cells, the fixed form at {max_cells}): the fused call "
          f"{ms['band_cull']:.4f} ms (CUDA events, median of 20; its kernel "
          f"alone {dev_us:.2f} us by the profiler; host {host:.2f} us a "
          f"call), tau alone {ms['band_tau']:.4f}, the plain pair "
          f"{ms['plain']:.4f}; bound {bound:.5f} ({by}); {card_name()}")
    sign = k4_call(band_cull, vol_c, sdfp, rc, cfg, "sign", max_cells)
    print(f"[k4] sign mode on the main grid: {median_ms(sign, True, 20):.4f}"
          f" ms, kernel {library_device_us('[k4 profile] sign', sign, K4_KERNELS['change']):.2f}"
          f" us; {card_name()}")

    def run():
        return sparse.phase_a(params, img_t, trans_t, sdfp, cfg,
                              max_cells=max_cells)

    def stage_ms():
        st: dict = {}
        sparse.phase_a(params, img_t, trans_t, sdfp, cfg, stats=st,
                       max_cells=max_cells)
        return st["phase_a_ms"]

    with PlainCulls():
        plain_calls = launch_calls(run)
    kern_calls = launch_calls(run)
    plain_n, kern_n = (sum(v for k, v in c.items() if "LaunchKernel" in k)
                       for c in (plain_calls, kern_calls))
    walls: dict = {"plain": [], "kernels": []}
    stage: dict = {"plain": [], "kernels": []}
    for arm in ("plain", "kernels", "kernels", "plain"):
        with PlainCulls() if arm == "plain" else contextlib.nullcontext():
            walls[arm].append(median_ms(run, False))
            stage[arm].append(float(np.median([stage_ms()
                                               for _ in range(5)])))
    print(f"[k4] phase_a (encode, fold, the coarse pass, the cull; the "
          f"speculative dispatch's fixed form): {plain_n} kernel launches "
          f"with the plain versions, {kern_n} with the kernel (runtime "
          f"calls: {plain_calls} / {kern_calls}); in turns (plain, kernel, "
          f"kernel, plain; host clock, medians of 5) wall "
          f"{[round(w, 3) for w in walls['plain']]} / "
          f"{[round(w, 3) for w in walls['kernels']]} ms, its phase_a_ms "
          f"stage {[round(w, 3) for w in stage['plain']]} / "
          f"{[round(w, 3) for w in stage['kernels']]} ms; {card_name()}")
    check(kern_n < plain_n, f"[k4] phase_a launched {kern_n} kernels with "
                            f"the kernel, {plain_n} without")
    out["phase_a"] = dict(launches=(plain_n, kern_n), walls=walls,
                          stage=stage)
    return out


def hold_compact(label: str, args, kw, timed: bool = True) -> dict:
    """The compaction's kernel against its plain version on one input, in
    the form given and in the exact form; its launches a call (one capped,
    at most two exact, with no copy call: the exact form's (b, n) come
    through mapped host memory). Timed (CUDA events, median of 20) beside
    the bound and torch.nonzero on the same block mask; the capped form's
    kernel by the profiler, host us a call, and with --parent that
    checkout's compaction in turns with this one's."""
    import torch
    from disn_tpu_torch.ops import marching

    bits, cand, E = args
    srow = kw.get("srow_tbl")
    got = marching._compact_block_bits(*args, **kw)
    want = marching._compact_block_bits_plain(*args, **kw)
    capped = kw.get("bcap") is not None
    same = all(torch_equal(a, b) if torch.is_tensor(a) else a == b
               for a, b in zip(got, want))
    exact = marching._compact_block_bits(bits, cand, E, srow_tbl=srow)
    exact_p = marching._compact_block_bits_plain(bits, cand, E,
                                                 srow_tbl=srow)
    same_exact = (exact[1] == exact_p[1] and torch_equal(exact[0], exact_p[0])
                  and torch_equal(exact[2], exact_p[2]))
    n, b = exact[1], exact[2].shape[0]
    form = f"capped at bcap {kw['bcap']}" if capped else "exact"
    print(f"[compact] {label}: {form}, "
          f"{'sparse row ids' if srow is not None else 'flat ids'}; "
          f"{b} blocks, {n} cells; kernel = plain {same}, exact form "
          f"{same_exact}")
    check(same and same_exact, f"[compact] {label}: the kernel differs "
                               f"from its plain version")
    calls = {"capped": launch_calls(lambda: marching._compact_block_bits(
                 bits, cand, E, srow_tbl=srow, bcap=kw.get("bcap") or 1024,
                 guard=kw.get("guard"))),
             "exact": launch_calls(lambda: marching._compact_block_bits(
                 bits, cand, E, srow_tbl=srow))}
    launches = {k: sum(v for name, v in c.items() if "LaunchKernel" in name)
                for k, c in calls.items()}
    copies = {k: sum(v for name, v in c.items() if "Memcpy" in name)
              for k, c in calls.items()}
    print(f"[compact] {label}: runtime calls a call {calls}")
    check(launches["capped"] == 1 and 1 <= launches["exact"] <= 2
          and copies["capped"] == copies["exact"] == 0,
          f"[compact] {label}: launches {launches}, copies {copies}; "
          f"expected one capped, at most two exact, no copy")
    if not timed:
        return {}
    fn = lambda: marching._compact_block_bits(*args, **kw)  # noqa: E731
    dev_us = library_device_us("[compact profile]", fn,
                               KC_KERNELS["change"]) if capped else None
    sel = cand & ((bits[:, 0] | bits[:, 1]) != 0)
    ms = median_ms(fn, True, 20)
    plain_ms = median_ms(lambda: marching._compact_block_bits_plain(
        *args, **kw), True, 20)
    lib_ms = median_ms(lambda: torch.nonzero(sel), True, 20)
    host = host_us(fn, 1000 if capped else 100)
    ids_len, rows = (got[0].numel(), got[3].shape[0]) if capped else (n, b)
    nbytes = (bits.numel() * 4 + cand.numel()
              + (0 if srow is None else srow.numel() * 4)
              + 4 * ids_len + 12 * rows + (8 if capped else 0))
    bound, by = k_bound(nbytes, 3.0 * bits.shape[0] + n)
    print(f"[compact] {label}: kernel {ms:.4f} ms (the wrapper on CUDA "
          f"events; its kernel alone "
          f"{'%.2f us' % dev_us if capped else 'not profiled'} by the "
          f"profiler; host {host:.2f} us a call), plain {plain_ms:.4f}, "
          f"torch.nonzero of the block mask (the selection alone) "
          f"{lib_ms:.4f}; bound {bound:.5f} ({by}, {nbytes} B); "
          f"{card_name()}")
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               library_ms=lib_ms, max_abs_err=0.0, device_us=dev_us,
               host_us=host)
    if capped:
        from disn_tpu_torch.ops import block_compact
        sizes: dict = {16: [], 8: []}
        for ctas in (16, 8, 8, 16):
            block_compact.CTAS = ctas
            sizes[ctas].append((median_ms(fn, True, 20), library_device_us(
                f"[compact profile] {ctas} CTAs", fn, KC_KERNELS["change"])))
        block_compact.CTAS = 16
        print(f"[compact] {label}: clusters in turns (16, 8, 8, 16), "
              f"(wrapper ms, kernel us): 16 CTAs "
              f"{[(round(a, 4), round(b, 2)) for a, b in sizes[16]]}, 8 CTAs "
              f"{[(round(a, 4), round(b, 2)) for a, b in sizes[8]]}; "
              f"{card_name()}")
        fns = {"change": fn}
        if PARENT_CULL:
            pmod = PARENT_CULL["block_compact"]
            fns["parent"] = lambda: pmod.compact_block_bits(*args, **kw)
            check(all(torch_equal(a, b) for a, b in zip(fns["parent"](),
                                                        want)),
                  "[compact] the parent's compaction differs from the plain "
                  "version")
        out["turns"] = turns(f"[compact turns] {label}", fns,
                             parent_kernels(KC_KERNELS, "block_compact"))
    else:
        exact_fns = {"change": fn}
        if PARENT_CULL:
            pmod = PARENT_CULL["block_compact"]
            exact_fns["parent"] = lambda: pmod.compact_block_bits(*args, **kw)
        order = (["parent", "change", "change", "parent"]
                 if "parent" in exact_fns else ["change", "change"])
        res = [(arm, round(median_ms(exact_fns[arm], True, 20), 4),
                round(host_us(exact_fns[arm], 100), 2)) for arm in order]
        print(f"[compact turns] {label}: (arm, wrapper ms, host us a call) "
              f"{res}; {card_name()}")
    return out


def phase_compact(kept: dict, img_fn) -> dict:
    """[compact]: the compaction's kernel against its plain version on the
    words flow's main-path inputs (the kept bf16 image, a hit: capped,
    sparse row ids, the guard on the card) and the volume flow's (exact,
    flat ids), then at a cap that overflows, with no change bit, with
    every block selected, past b2 by one block and on a 513^3 grid; the
    main path's launches an image and its single-image wall with the
    plain versions and with the kernels (img_fn: image_turns). Returns the
    words flow's entry for the kernel table."""
    import torch

    args, kw = kept["bf16 compact"][0]
    vargs, vkw = kept["bf16 volume compact"][0]
    check(kw.get("bcap") is not None and kw.get("srow_tbl") is not None,
          f"[compact] the kept words-flow launch is not the capped one: "
          f"{sorted(k for k, v in kw.items() if v is not None)}")
    entry = hold_compact("words flow, the main path's launch", args, kw)
    hold_compact("volume flow, the main path's launch", vargs, vkw)
    hold_compact("words flow past b2", args, dict(kw, bcap=256), False)
    bits, cand, E = args
    hold_compact("no change bit", (torch.zeros_like(bits), cand, E), kw,
                 False)
    every = torch.ones_like(cand)
    full = torch.full_like(bits, -1)
    hold_compact("every block selected", (full, every, E),
                 dict(kw, bcap=2 * cand.numel()), False)
    sel = int((cand & ((bits[:, 0] | bits[:, 1]) != 0)).sum())
    for b2 in (max(512, (sel - 1) // 256 * 256), -(-sel // 256) * 256):
        hold_compact(f"b2 {b2} against {sel} selected blocks", args,
                     dict(kw, bcap=2 * b2), False)
    rng = np.random.RandomState(20)
    E2 = 513
    nb2 = (-(-E2 // 4)) ** 3
    words = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1, (nb2, 2),
                                         dtype=np.int64).astype(np.int32))
    keep = torch.from_numpy(rng.rand(nb2) < 0.02)
    hold_compact("a 513^3 grid", ((words * keep[:, None]).cuda(),
                                  torch.from_numpy(rng.rand(nb2) < 0.8)
                                  .cuda(), E2), dict(bcap=65536), False)
    turns_ = img_fn()
    before, after = turns_["launches"]
    print(f"[compact] one main-path image_to_mesh (a hit): {before} kernel "
          f"launches with the plain K4 and compaction, {after} with the "
          f"kernels (every launch call; runtime calls "
          f"{turns_['calls'][0]} / {turns_['calls'][1]}); its wall in turns "
          f"(plain, "
          f"kernels, kernels, plain; host clock, medians of 5) "
          f"{[round(w, 3) for w in turns_['plain']]} / "
          f"{[round(w, 3) for w in turns_['kernels']]} ms; {card_name()}")
    check(after < before, "[compact] the kernels did not cut the main "
                          "path's launches")
    entry["image_launches"] = (before, after)
    return entry


def image_turns(cfg, params, img, trans) -> dict:
    """One image_to_mesh of the main path (a hit of the speculative
    dispatch) with the plain K4 and compaction and with the kernels: the
    runtime's launch calls in one image, and the single-image wall in
    turns (plain, kernels, kernels, plain; host clock with the card
    synchronised, median of 5 each)."""
    from disn_tpu_torch.infer import pipeline

    def run():
        pipeline.image_to_mesh(params, img, trans, cfg)

    with PlainCulls():
        run()
        before = launch_calls(run)
    run()
    after = launch_calls(run)
    out = {"calls": (before, after),
           "launches": tuple(sum(v for k, v in c.items()
                                 if "LaunchKernel" in k)
                             for c in (before, after)),
           "plain": [], "kernels": []}
    for arm in ("plain", "kernels", "kernels", "plain"):
        with PlainCulls() if arm == "plain" else contextlib.nullcontext():
            out[arm].append(median_ms(run, False))
    return out


def volume_and_scan(cfg, params, img, trans) -> dict:
    """phase_a and phase_b_mesh of one image, as image_to_mesh runs them:
    the volume, the active coarse cells and the candidate scan."""
    import torch
    from disn_tpu_torch import device as device_mod
    from disn_tpu_torch.infer import dense, pipeline, sparse

    dev = torch.device("cuda")
    params = device_mod.tree_to(params, dev)
    img_t, trans_t, sdfp = dense.as_inputs(img, trans, pipeline.UNIT_BOX, dev)
    _, endpoints, vol_c, coarse_ids, _ = sparse.phase_a(
        params, img_t, trans_t, sdfp, cfg)
    vol, ids, n, guard, blk = sparse.phase_b_mesh(
        params, endpoints, vol_c, coarse_ids, trans_t, sdfp, cfg, cfg.iso)
    return dict(vol=vol, coarse_ids=coarse_ids, ids=ids, n=n, guard=guard,
                blk=blk, sdfp=sdfp, iso=float(cfg.iso))


def median_ms(fn, device_clock: bool, reps: int = 5) -> float:
    """Median over `reps` calls after one warm-up: CUDA events around each
    call (the device's timeline, idle gaps at host syncs included), or the
    host clock with the device synchronised on both sides."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        if device_clock:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def mesh_sets(v: np.ndarray, f: np.ndarray):
    """Order-free form of a mesh: sorted vertices, sorted triangle rows."""
    tris = np.sort(np.sort(v[f].reshape(len(f), 9), axis=1), axis=0)
    return np.sort(v, axis=0), tris


def euler(v: np.ndarray, f: np.ndarray) -> int:
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]],
                                    f[:, [2, 0]]]), axis=1)
    return len(v) - len(np.unique(edges, axis=0)) + len(f)


def drop_degenerate(f: np.ndarray) -> np.ndarray:
    """weld's rule: a triangle with a repeated welded vertex goes."""
    return f[(f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2])
             & (f[:, 0] != f[:, 2])]


def hold_routes(label: str, k: dict, main_mesh=None) -> None:
    """The extraction routes against each other on one volume and scan."""
    import torch
    from disn_tpu_torch.ops import marching as m

    vol, sdfp, iso, ids, n, blk = (k[x] for x in
                                   ("vol", "sdfp", "iso", "ids", "n", "blk"))
    R = int(vol.shape[0])
    box = sdfp.cpu().numpy()
    tag = f"[routes {label}]"
    check(k["guard"] == 0, f"{tag} candidate scan guard {k['guard']}")
    # (e) the candidate scan's ids are the full scan's
    full_ids, n_full = m._active_cells_ext(vol, iso)
    check(n_full == n and torch.equal(full_ids, ids),
          f"{tag} candidate scan ids differ from the full scan's "
          f"({n} vs {n_full} cells)")
    # (a) the full-scan owned route equals the owned_ids route
    ov, of_ = m.extract_mesh_from_ids(vol, sdfp, ids, iso=iso, blk=blk)
    sv, sf = m.extract_mesh_owned(vol, sdfp, iso=iso)
    check(np.array_equal(sv, ov) and np.array_equal(sf, of_),
          f"{tag} extract_mesh_owned differs from the owned_ids route")
    if main_mesh is not None:
        check(np.array_equal(main_mesh[0], ov)
              and np.array_equal(main_mesh[1], of_),
              f"{tag} the main path's mesh is not the owned_ids route's")
    print(f"{tag} (e) scan ids equal, {n} cells in {len(blk)} blocks; "
          f"(a) full-scan route equal: {len(ov)} verts, {len(of_)} faces")
    # (b) owned against marching_tets + weld
    tv, tf_ = m.extract_mesh(vol, sdfp, iso=iso)
    check(len(tv) == len(ov), f"{tag} {len(ov)} owned vs {len(tv)} welded "
                              "vertices")
    check(len(drop_degenerate(of_)) == len(tf_),
          f"{tag} {len(drop_degenerate(of_))} owned vs {len(tf_)} welded "
          "faces")
    (ovs, ots), (tvs, tts) = mesh_sets(ov, of_), mesh_sets(tv, tf_)
    dv = float(np.abs(ovs - tvs).max())
    dt = (float(np.abs(ots - tts).max()) if len(ots) == len(tts)
          else float("inf"))
    chi_o, chi_t = euler(ov, of_), euler(tv, tf_)
    print(f"{tag} (b) owned vs tets+weld: vertex sets max diff {dv:.3e}, "
          f"triangle sets max diff {dt:.3e} (limit 1e-6), Euler "
          f"{chi_o} vs {chi_t}")
    check(dv <= 1e-6 and dt <= 1e-6 and chi_o == chi_t,
          f"{tag} owned and tets+weld meshes differ")
    # (c) the record route through the C++ passes
    rv, rf = m.extract_mesh_records(vol, sdfp, ids, n, blk=blk, iso=iso)
    span = float((box[3:] - box[:3]).max())
    quant = 510 if m._tq_bits(R) == 8 else 131070
    bound = span / (R - 1) / quant + 1e-6
    dr = float(np.abs(rv - ov).max())
    print(f"{tag} (c) record route: faces equal="
          f"{np.array_equal(rf, of_)}, vertices max diff {dr:.6e} (bound "
          f"{bound:.6e} = span/(R-1)/{quant} + 1e-6)")
    check(np.array_equal(rf, of_) and dr <= bound,
          f"{tag} the record route's mesh is outside its bound")
    # (d) the C++ passes against assemble_mesh_np on the same records.
    # Faces must be equal bit for bit. Vertices cannot be: the C++ passes
    # interpolate in double and round once, numpy in f32 step by step, so
    # they may differ in the last place of the coordinate scale.
    rec, tq = m._records_to_host(*m._extract_records(vol, ids, iso))
    nv_, nf_ = m.assemble_mesh_np(ids.cpu().numpy(), rec, tq, n, R, box)
    dn = float(np.abs(nv_ - rv).max())
    lim = 2e-7 * float(np.abs(box).max())
    print(f"{tag} (d) C++ vs assemble_mesh_np: faces equal="
          f"{np.array_equal(nf_, rf)}, vertices differ in "
          f"{int((nv_ != rv).any(1).sum())} of {len(rv)} rows, max "
          f"{dn:.3e} (limit {lim:.1e}: double vs f32 interpolation)")
    check(np.array_equal(nf_, rf) and dn <= lim,
          f"{tag} the C++ passes and assemble_mesh_np disagree")


def hold_divisions(k: dict) -> None:
    """Grid index -> world coordinate on the card, at a spacing that is
    inexact in f32: plane_points, _world and the extracted vertices equal
    the IEEE f32 evaluation on the host and lie within 1 ulp of the
    coordinate scale of the float64 one. On CUDA a tensor divided by a
    Python float is multiplied by the reciprocal instead; the count of grid
    points that form would move is printed beside the holds."""
    import torch
    from disn_tpu_torch.infer import fused
    from disn_tpu_torch.ops import marching as m

    vol, ids, iso = k["vol"], k["ids"], k["iso"]
    R = int(vol.shape[0])
    dev = vol.device
    axes = torch.arange(R, device=dev)
    grid = torch.stack(torch.meshgrid(axes, axes, axes, indexing="ij"),
                       -1).reshape(-1, 3)
    g_np = grid.cpu().numpy()
    for box in (np.array([-1, -1, -1, 1, 1, 1], np.float32),
                np.array([-0.3, -1, -2, 0.9, 1, 2], np.float32)):
        sp = torch.from_numpy(box).to(dev)
        lo, span = box[:3], box[3:] - box[:3]
        ulp = float(np.spacing(np.abs(box).max()))
        want32 = lo + g_np.astype(np.float32) / np.float32(R - 1) * span
        want64 = (lo.astype(np.float64) + g_np.astype(np.float64) / (R - 1)
                  * span.astype(np.float64))
        got = m._world(grid, R, sp).cpu().numpy()
        pts, flat = fused.plane_points(R, sp)
        idx = flat.cpu().numpy()
        gp = np.stack([idx % R, (idx // R) % R, idx // (R * R)], -1)
        p32 = lo + gp.astype(np.float32) / np.float32(R - 1) * span
        p64 = (lo.astype(np.float64) + gp.astype(np.float64) / (R - 1)
               * span.astype(np.float64))
        pts = pts.cpu().numpy()
        faulty = (sp[0:3] + grid.float() / float(R - 1) * (sp[3:6] - sp[0:3])
                  ).cpu().numpy()
        e_w, e_p = np.abs(got - want64).max(), np.abs(pts - p64).max()
        print(f"[division 49^3] box {box.tolist()}: _world equal to IEEE "
              f"f32 = {np.array_equal(got, want32)}, max |err| vs float64 "
              f"{e_w:.3e}; plane_points equal = {np.array_equal(pts, p32)}, "
              f"vs float64 {e_p:.3e} (1 ulp = {ulp:.3e}); dividing by a "
              f"Python float would move {int((faulty != want32).sum())} of "
              f"{want32.size} coordinates, max |err| vs float64 "
              f"{np.abs(faulty - want64).max():.3e}")
        check(np.array_equal(got, want32) and e_w <= ulp,
              "_world is off the IEEE f32 / float64 evaluation")
        check(np.array_equal(pts, p32) and e_p <= ulp,
              "plane_points is off the IEEE f32 / float64 evaluation")
    # the extracted vertices (K7 on the card): the plain version on the
    # CPU (IEEE f32), and the interpolation redone in float64 from the same
    # f32 volume
    sdfp = k["sdfp"]
    blk = k["blk"]
    verts = m._extract_owned(vol, sdfp, ids, iso, blk)[0].cpu().numpy()
    cpu = m._extract_owned(vol.cpu(), sdfp.cpu(), ids.cpu(), iso,
                           blk.cpu())[0].numpy()
    tb = m._device_tables(torch.device("cpu"))
    c, vals, _, cross = m._slot_data(vol.cpu().double(), ids.cpu(), iso)
    slot, d = torch.nonzero(cross, as_tuple=True)
    pj = tb["pair_j"][d]
    t = m._edge_t(vals[slot, 0], vals[slot, pj], iso)[:, None]
    box64 = sdfp.cpu().double()

    def world64(g):
        return box64[:3] + g.double() / (R - 1) * (box64[3:] - box64[:3])

    gi = c[slot]
    gj = torch.clamp(gi + tb["corners"][pj], max=R - 1)
    v64 = (world64(gi) + t * (world64(gj) - world64(gi))).numpy()
    ulp = float(np.spacing(np.float32(box64.abs().max().item())))
    e_v = float(np.abs(verts - v64).max())
    print(f"[division 49^3] {len(verts)} extracted vertices: equal to the "
          f"CPU run = {np.array_equal(verts, cpu)}, max |err| vs float64 "
          f"{e_v:.3e} (1 ulp = {ulp:.3e})")
    check(np.array_equal(verts, cpu) and e_v <= ulp,
          "extracted vertices are off the IEEE f32 / float64 evaluation")


def time_extraction(k: dict) -> dict:
    """Every part of the owned route, the record route and marching_tets +
    weld on one volume, with the bytes each device part must move."""
    import torch
    from disn_tpu_torch import native
    from disn_tpu_torch.ops import marching as m

    vol, sdfp, iso, coarse = k["vol"], k["sdfp"], k["iso"], k["coarse_ids"]
    R = int(vol.shape[0])
    box = sdfp.cpu().numpy()
    ids, n, _, blk = m._active_cells_from_coarse(vol, coarse, iso)
    t = {}
    t["scan"] = median_ms(
        lambda: m._active_cells_from_coarse(vol, coarse, iso), True)
    t["full_scan"] = median_ms(lambda: m._active_cells_ext(vol, iso), True)
    # the owned extractor as the route runs it on the card (K7 at S = n,
    # its counts read once), and its plain version's two passes
    t["owned_extract"] = median_ms(
        lambda: m._extract_owned(vol, sdfp, ids, iso, blk), True)
    t["owned_passes_plain"] = median_ms(
        lambda: m._extract_owned_plain(vol, sdfp, ids, iso, blk), True)
    verts, faces = m._extract_owned(vol, sdfp, ids, iso, blk)
    t["mesh_copy"] = median_ms(lambda: m._fetch_mesh(verts, faces), False)
    # the alternative the port does not take: one copy into a page-locked
    # buffer kept across calls, and a copy out of it into a fresh array
    pinned = torch.empty(verts.numel() + faces.numel(), dtype=torch.int32,
                         pin_memory=True)

    def copy_pinned():
        pinned.copy_(torch.cat([verts.reshape(-1).view(torch.int32),
                                faces.reshape(-1)]))
        return pinned.numpy().copy()

    t["mesh_copy_pinned"] = median_ms(copy_pinned, False)
    # the same copy when the allocator has just given its free memory back
    # to the system (glibc's malloc_trim, called outside the timed region),
    # so that the destination's pages are new to the process: what a caller
    # meets that drops one mesh before it asks for the next
    trim = getattr(ctypes.CDLL(None), "malloc_trim", None)
    if trim is not None:
        cold = []
        for _ in range(5):
            trim(0)
            t0 = time.perf_counter()
            m._fetch_mesh(verts, faces)
            cold.append((time.perf_counter() - t0) * 1e3)
        t["mesh_copy_after_trim"] = float(np.median(cold))
    t["record_emit"] = median_ms(lambda: m._extract_records(vol, ids, iso),
                                 True)
    rec_d, tq_d = m._extract_records(vol, ids, iso)
    imask_d = (rec_d & 0xFF).to(torch.uint8)
    t["record_copy"] = median_ms(
        lambda: (m._records_to_host(imask_d, tq_d), blk.cpu().numpy()),
        False)
    (imask8, tq), blk_np = m._records_to_host(imask_d, tq_d), blk.cpu().numpy()
    t["derive_recs"] = median_ms(
        lambda: native.derive_recs(blk_np, imask8, R), False)
    recs = native.derive_recs(blk_np, imask8, R)
    t["mesh_faces_blocks"] = median_ms(
        lambda: native.mesh_faces_blocks(blk_np, recs, n, R), False)
    t["mesh_verts_blocks"] = median_ms(
        lambda: native.mesh_verts_blocks(blk_np, recs, tq, n, R, box), False)
    t["marching_tets"] = median_ms(lambda: m.marching_tets(vol, sdfp, iso),
                                   True)
    tri_pos, tri_keys, count = m.marching_tets(vol, sdfp, iso)
    t["soup_copy"] = median_ms(
        lambda: (tri_pos.cpu().numpy(), tri_keys.cpu().numpy()), False)
    pos_np, keys_np = tri_pos.cpu().numpy(), tri_keys.cpu().numpy()
    t["weld"] = median_ms(lambda: m.weld(pos_np, keys_np, count), False)
    # owner look-up of pass 2: the dense [E^3] table against a sort of the
    # ids and a binary search, at pass 2's count of look-ups
    look = ids.long()[torch.randint(n, (3 * len(faces),), device=ids.device)]

    def dense_table():
        owner = torch.full((R ** 3,), -1, dtype=torch.int32,
                           device=ids.device)
        owner[ids.long()] = torch.arange(n, dtype=torch.int32,
                                         device=ids.device)
        return owner[look]

    def sorted_search():
        srt, order = torch.sort(ids.long())
        return order[torch.searchsorted(srt, look)]

    check(torch.equal(dense_table().long(), sorted_search()),
          "the two owner look-ups disagree")
    t["owner_dense_table"] = median_ms(dense_table, True)
    t["owner_sorted_search"] = median_ms(sorted_search, True)
    # the link's rate, from one large copy into pinned memory
    big = torch.empty(256 << 20, dtype=torch.uint8, device=vol.device)
    pin = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
    link = (256 << 20) / (median_ms(lambda: pin.copy_(big), False) * 1e-3)
    del big, pin
    mesh_b = verts.numel() * 4 + faces.numel() * 4
    rec_b = imask8.nbytes + tq.nbytes + blk_np.nbytes
    soup_b = pos_np.nbytes + keys_np.nbytes
    touched = min(4 * R ** 3, 32 * n)   # the active cells' corner values
    dev_bytes = {
        "scan": 4 * R ** 3 + 4 * coarse.numel() + 4 * n + blk_np.nbytes,
        "full_scan": 4 * R ** 3 + 4 * n,
        "owned_extract": 4 * n + touched + mesh_b,
        "owned_passes_plain": 4 * n + touched + mesh_b,
        "record_emit": 4 * n + touched + 2 * n + tq_d.numel()
        * tq_d.element_size(),
        "marching_tets": 4 * R ** 3 + soup_b,
    }
    link_bytes = {"mesh_copy": mesh_b, "mesh_copy_pinned": mesh_b,
                  "mesh_copy_after_trim": mesh_b,
                  "record_copy": rec_b, "soup_copy": soup_b}
    tag = f"[extract {R}^3]"
    print(f"{tag} {n} cells, {len(verts)} verts, {len(faces)} faces; mesh "
          f"{mesh_b} B, records {rec_b} B, soup {soup_b} B; link "
          f"{link / 1e9:.2f} GB/s (256 MiB into pinned memory); medians of "
          f"5 after a warm-up")
    for name, ms in t.items():
        if name in dev_bytes:
            extra = (f" device clock; bound_ms="
                     f"{dev_bytes[name] / H100_BYTES_PER_S * 1e3:.5f} "
                     f"({dev_bytes[name]} B at 3.35 TB/s)")
        elif name in link_bytes:
            extra = (f" host clock; bound_ms="
                     f"{link_bytes[name] / link * 1e3:.5f} "
                     f"({link_bytes[name]} B at the link's rate)")
        elif name.startswith("owner_"):
            extra = " device clock"
        else:
            extra = " host clock, host code"
        print(f"{tag} {name} ms={ms:.4f}{extra}")
    owned = t["scan"] + t["owned_extract"] + t["mesh_copy"]
    record = (t["scan"] + t["record_emit"] + t["record_copy"]
              + t["derive_recs"] + t["mesh_faces_blocks"]
              + t["mesh_verts_blocks"])
    tets = t["marching_tets"] + t["soup_copy"] + t["weld"]
    bound = ((4 * R ** 3 + mesh_b) / H100_BYTES_PER_S + mesh_b / link) * 1e3
    print(f"{tag} sums: owned route (scan + extractor + copy) {owned:.4f} ms "
          f"against a bound of {bound:.5f} ms (volume read once and the "
          f"mesh written at 3.35 TB/s, the mesh over the link); record "
          f"route {record:.4f} ms; marching_tets + copy + weld "
          f"{tets:.4f} ms")
    return t


# -- training ---------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")  # removed after
TRACE_DIR = os.path.join(ROOT, "build", "chip_smoke_trace")  # Chrome traces
# card against CPU at width_mult 0.25 (the [train hold] lines): the loss is
# a sum of many rounded terms, continuous across every ReLU and L1 kink, so
# it agrees to summation order; the gradient is not continuous there, so it
# is held in float64, where both devices round alike to 1e-16 and no unit
# sits on the other side of a kink; the Adam update from identical
# gradients differs by the fused kernel's rounding only
CARD = "cuda"
HOLD_LOSS_REL = 1e-5
HOLD_GRAD_REL = 1e-4
HOLD_ADAM_ABS = 1e-6


def train_loader(cfg, records, batches: int):
    """At least `batches` batches of the memory dataset through the port's
    sampler and PrefetchLoader onto the card (at B = 20 the 12 pairs make
    one batch an epoch)."""
    from disn_tpu_torch.data import pipeline, synthetic

    ds = synthetic.memory_dataset(cfg, records)
    sampler = pipeline.EpochSampler(ds.listinfo, {synthetic.SYNTH_CAT: 12},
                                    cfg.cat_limit, seed=0)
    loader = pipeline.PrefetchLoader(ds, sampler, cfg.batch_size,
                                     epochs=batches, workers=4, seed=0,
                                     device=CARD)
    check(loader.total_batches >= batches, "loader batch count")
    return loader


def host_batch(cfg, records, seed: int) -> dict:
    from disn_tpu_torch.data import synthetic

    ds = synthetic.memory_dataset(cfg, records)
    idx = np.random.RandomState(seed).randint(len(ds.listinfo),
                                              size=cfg.batch_size)
    return ds.get_batch(idx, np.random.RandomState(seed))[0]


def on(batch: dict, device: str) -> dict:
    import torch
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def phase_train_hold(records) -> None:
    """The port's step on the card and with device='cpu', from the same
    params and batch: loss (f32), every gradient leaf (f64), and the
    parameters after one Adam update from the same gradients (f32)."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.models import disn
    from disn_tpu_torch.train import checkpoint, trainer

    cfg = Config(width_mult=0.25, num_classes=64, batch_size=2,
                 num_sample_points=256)
    params = disn.init(cfg, seed=0, device="cpu")
    batch = host_batch(cfg, records, seed=1)
    grads = {}
    for dtype in ("float32", "float64"):
        c = cfg.replace(compute_dtype=dtype)
        devs = (("card", CARD), ("cpu", "cpu"))
        st = {k: trainer.create_state(c, params=params, device=d)
              for k, d in devs}
        loss = {k: trainer.compute_gradients(st[k], on(batch, d))
                ["overall_loss"].item() for k, d in devs}
        rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
        ratios = []
        for (path, pg), (_, pc) in zip(checkpoint.leaves(st["card"].params),
                                       checkpoint.leaves(st["cpu"].params)):
            scale = max(pc.grad.abs().max().item(), 1e-30)
            ratios.append(((pg.grad.cpu() - pc.grad).abs().max().item()
                           / scale, path))
        worst = max(ratios)
        over = sum(r > HOLD_GRAD_REL for r, _ in ratios)
        print(f"[train hold] {dtype}: loss card {loss['card']!r} cpu "
              f"{loss['cpu']!r} rel {rel:.3e} (limit {HOLD_LOSS_REL}); "
              f"gradients: worst leaf {worst[1]} max|diff|/max|grad| "
              f"{worst[0]:.3e}, {over} of {len(ratios)} leaves over "
              f"{HOLD_GRAD_REL}")
        check(rel <= HOLD_LOSS_REL, f"train hold {dtype}: loss differs")
        if dtype == "float64":
            check(over == 0, "train hold: a float64 gradient leaf differs "
                             "between the card and the CPU")
        grads[dtype] = st
    # one Adam update on each device from the CPU's f32 gradients
    st = grads["float32"]
    for (_, pg), (_, pc) in zip(checkpoint.leaves(st["card"].params),
                                checkpoint.leaves(st["cpu"].params)):
        pg.grad = pc.grad.to(CARD)
    for s in st.values():
        s.apply_gradients()
    diff = max((pg.detach().cpu() - pc.detach()).abs().max().item()
               for (_, pg), (_, pc) in zip(checkpoint.leaves(st["card"].params),
                                           checkpoint.leaves(st["cpu"].params)))
    print(f"[train hold] adam (fused on the card): params after one update "
          f"from the same gradients, max|diff| {diff:.3e} (limit "
          f"{HOLD_ADAM_ABS})")
    check(diff <= HOLD_ADAM_ABS, "train hold: Adam updates differ")


def train_step_bound(cfg, n_params: int) -> tuple[float, dict]:
    """(least ms the card could take for one step, MACs by part) from the
    step's shapes: the forward's multiply-adds (VGG-16's convolutions and
    fc layers, the fold in the order fold_137 takes, the two point MLPs;
    for the unfolded arm of the other variants their MLPs on the
    concatenated features and the samples' taps, in f32),
    three times over for the forward and the backward, at the peak of the
    type each runs in (the fold's resizes in f32 whatever the compute type;
    the rest in bf16 for a bf16 step); against the bytes of the batch, and
    the parameters, gradients and Adam moments read and written once."""
    from disn_tpu_torch.config import Variant
    from disn_tpu_torch.infer import dense
    from disn_tpu_torch.models import vgg

    b, n = cfg.batch_size, cfg.num_sample_points
    w = [vgg.scaled_width(c, cfg.width_mult) for c in (64, 128, 256, 512, 512)]
    macs = {"encoder": 0, "fold matmuls": 0, "fold resizes": 0, "heads": 0,
            "samples": 0}
    cin, side = cfg.img_channels, cfg.vgg_size
    for (_, names, _), cout in zip(vgg._CFG, w):
        for _ in names:
            macs["encoder"] += side * side * 9 * cin * cout
            cin = cout
        side //= 2
    fc = vgg.scaled_width(4096, cfg.width_mult)
    macs["encoder"] += 7 * 7 * cin * fc + fc * fc + fc * cfg.num_classes
    oh, ow = cfg.img_h, cfg.img_w
    out = 2 if cfg.binary else 1

    def mlp(extra):
        return (3 * 64 + 64 * 256 + 256 * 512 + (512 + extra) * 512
                + 512 * 256 + 256 * out)

    if cfg.variant is Variant.TWOSTREAM and cfg.sampling == "tf1":
        side = cfg.vgg_size
        for c in w:
            if dense._resize_first(side, side, c, 512, cfg):
                macs["fold resizes"] += (oh * side * side * c
                                         + oh * ow * side * c)
                macs["fold matmuls"] += oh * ow * c * 512
            else:
                macs["fold matmuls"] += side * side * c * 512
                macs["fold resizes"] += (oh * side * side * 512
                                         + oh * ow * side * 512)
            side //= 2
        macs["fold matmuls"] += cfg.num_classes * 512
        macs["heads"] = n * 2 * mlp(0)
    else:
        # the unfolded arm (the other variants): one MLP per stream on the
        # concatenated features, and per point and channel of the sampled
        # maps tf1's 16 taps (12 multiply-adds: 16 products, lerps' 8)
        loc = cfg.local_feat_dim
        if cfg.variant is Variant.TWOSTREAM:
            macs["heads"] = n * (mlp(cfg.num_classes) + mlp(loc))
        else:
            macs["heads"] = n * mlp(cfg.num_classes + loc)
        macs["samples"] = n * 12 * loc
    macs = {k: v * b for k, v in macs.items()}
    fast = H100_BF16_FLOPS if cfg.compute_dtype == "bfloat16" else \
        H100_F32_FLOPS
    t_ops = sum(2 * 3 * v / (H100_F32_FLOPS if k in ("fold resizes",
                                                     "samples") else fast)
                for k, v in macs.items())
    nbytes = (b * (oh * ow * cfg.img_channels + n * 7 + 12) * 4
              + n_params * 4 * 7)
    return max(t_ops, nbytes / H100_BYTES_PER_S) * 1e3, macs


def time_steps(cfg, state, loader, label: str) -> dict:
    """2 warm-up steps, then 10 timed ones (CUDA events between steps) from
    the loader; the host time blocked in next(loader) over the wall time of
    the timed steps is the loader-wait share."""
    import torch
    from disn_tpu_torch.train import checkpoint, trainer

    step = trainer.make_train_step(cfg)
    it = iter(loader)
    for _ in range(2):
        step(state, next(it))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(11)]
    waited, losses = 0.0, []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(10):
        tw = time.perf_counter()
        batch = next(it)
        waited += time.perf_counter() - tw
        _, out = step(state, batch)
        losses.append(out["sdf_loss"])
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = [events[i].elapsed_time(events[i + 1]) for i in range(10)]
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    med = float(np.median(ms))
    bound, macs = train_step_bound(cfg, sum(p.numel() for _, p in
                                            checkpoint.leaves(state.params)))
    print(f"[train {label}] forward MACs by part "
          f"{ {k: f'{v / 1e9:.1f} G' for k, v in macs.items()} }; "
          f"bound {bound:.3f} ms (operations x 3 for the backward, at "
          f"{cfg.compute_dtype}'s peak, resizes at f32's), share "
          f"{bound / med:.4f}")
    print(f"[train {label}] ms/step median={med:.3f} all="
          f"{[round(x, 3) for x in ms]}; samples/s="
          f"{cfg.batch_size * 1000 / med:.1f} (B={cfg.batch_size}, "
          f"N={cfg.num_sample_points}); peak memory {peak} B "
          f"({peak / 2**30:.2f} GiB); loader wait {waited * 1e3:.2f} ms of "
          f"{wall * 1e3:.1f} ms wall = {waited / wall:.4f} (workers' queue "
          f"{loader.wait_s * 1e3:.2f} ms since start)")
    check(all(np.isfinite(losses)), f"train {label}: non-finite loss")
    return dict(ms=ms, median=med, peak=peak, wait_share=waited / wall)


def phase_train_steps(records) -> None:
    """Full width, the default Config: f32 timing and a falling loss on one
    repeated batch, its profile, then bf16 timing and profile."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.train import trainer

    cfg = Config()
    state = trainer.create_state(cfg, seed=0)
    loader = train_loader(cfg, records, 12).start()
    try:
        time_steps(cfg, state, loader, "f32")
    finally:
        loader.shutdown()
    step = trainer.make_train_step(cfg)
    batch = on(host_batch(cfg, records, seed=2), CARD)
    # from a fresh seed-0 state, so that the run repeats: after the timed
    # steps the state depends on the order in which the loader's workers
    # delivered their batches, and one run in seven on an H100 spiked late
    # (4338.7 at step 15) and ended above its start; from the fresh state
    # four runs gave the same losses up to cuDNN's summation order
    # (medians 3353.85 -> 2950.6-2951.4). Adam at lr 1e-4 and beta1 0.5
    # moves each of the 119M randomly initialised fc6/fc7 weights by ~lr a
    # step: single steps spike (9397.4 at step 4 from the fresh state), so
    # the medians of the first and the last five steps are compared
    del state
    torch.cuda.empty_cache()
    state = trainer.create_state(cfg, seed=0)
    losses = [step(state, batch)[1]["sdf_loss"] for _ in range(20)]
    losses = [x.item() for x in losses]
    first, last = np.median(losses[:5]), np.median(losses[-5:])
    print(f"[train f32] 20 steps on one batch: sdf_loss "
          f"{[round(x, 2) for x in losses]}; median of the first 5 "
          f"{first:.2f}, of the last 5 {last:.2f}")
    check(all(np.isfinite(losses)) and last < first,
          "train f32: sdf_loss did not fall over 20 steps on one batch")
    profile_steps(cfg, state, batch, "f32")
    del state
    torch.cuda.empty_cache()
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    state = trainer.create_state(cfg16, seed=0)
    loader = train_loader(cfg16, records, 12).start()
    try:
        time_steps(cfg16, state, loader, "bf16")
    finally:
        loader.shutdown()
    profile_steps(cfg16, state, batch, "bf16")


def _device_time(evt, own: bool) -> float:
    """An event's time on the device in us, its own or with its children's
    (the attributes' names differ between torch versions)."""
    names = (("self_device_time_total", "self_cuda_time_total") if own
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_steps(cfg, state, batch, label: str) -> None:
    """torch.profiler over 3 steps: the device's idle share of the span of
    its activity (from the Chrome trace), the 10 PyTorch ops and the 5
    kernels with the most self time on the device, with their share of the
    busy time, and the sampler's gather (forward) and scatter-add (its
    backward)."""
    from torch.autograd import DeviceType

    from disn_tpu_torch.train import trainer

    step = trainer.make_train_step(cfg)
    tdir = os.path.join(TRACE_DIR, label)

    def steps():
        for _ in range(3):
            step(state, batch)

    prof, _ = profiled(steps, tdir=tdir)
    busy, window, n_ev, syncs = trace_busy(tdir)
    tag = f"[train profile {label}]"
    print(f"{tag} 3 steps: device busy {busy / 1e3:.3f} ms of a "
          f"{window / 1e3:.3f} ms span of device activity, idle share "
          f"{1 - busy / window:.4f}; {n_ev} device events, {syncs} "
          f"stream/device synchronisations; trace in "
          f"{os.path.relpath(tdir, ROOT)}/trace.json")
    avg = prof.key_averages()
    for kind, dt, n in (("op", DeviceType.CPU, 10),
                        ("kernel", DeviceType.CUDA, 5)):
        rows = [e for e in avg if e.device_type == dt]
        for e in sorted(rows, key=lambda e: -_device_time(e, True))[:n]:
            t = _device_time(e, True)
            print(f"{tag} top {kind}: {e.key[:100]} self {t / 1e3:.3f} ms "
                  f"in {e.count} calls ({t / busy:.4f} of busy)")
    for name in ("aten::gather", "aten::scatter_add_"):
        for e in avg:
            if e.key == name:
                t = _device_time(e, False)
                print(f"{tag} sampler {name}: {t / 1e3:.3f} ms on the "
                      f"device in {e.count} calls over 3 steps "
                      f"({t / busy:.4f} of busy)")


def phase_train_ckpt(records) -> None:
    """Save latest.npz after step 3 of a full-width run, check its names
    against the JAX package's, restore it into a fresh state and hold step
    4's loss and the optimizer state against the run that went on."""
    import shutil

    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.train import checkpoint, trainer

    cfg = Config()
    step = trainer.make_train_step(cfg)
    batches = [on(host_batch(cfg, records, seed=10 + i), CARD)
               for i in range(4)]
    state = trainer.create_state(cfg, seed=1)
    for b in batches[:3]:
        step(state, b)
    mgr = checkpoint.CheckpointManager(TRAIN_DIR)
    t0 = time.perf_counter()
    mgr.save_latest(state.state_tree(), state.step)
    save_s = time.perf_counter() - t0
    paths = [p for p, _ in checkpoint.leaves(state.params)]
    want = ({"step", "opt_state$0$count", "opt_state$1$count"}
            | {f"{k}${p}" for p in paths
               for k in ("params", "opt_state$0$mu", "opt_state$0$nu")})
    with np.load(mgr.latest_path()) as z:
        names = set(z.files) - {"__metadata__"}
    check(names == want, f"train ckpt: names differ from the reference's: "
          f"{sorted(names ^ want)[:5]}")
    fresh = trainer.create_state(cfg, seed=2)
    t0 = time.perf_counter()
    fresh.load_state_tree(checkpoint.restore(mgr.latest_path(),
                                             fresh.state_tree()))
    load_s = time.perf_counter() - t0
    shutil.rmtree(TRAIN_DIR)
    same = all(torch.equal(state.opt.state[a][k], fresh.opt.state[b][k])
               for (_, a), (_, b) in zip(checkpoint.leaves(state.params),
                                         checkpoint.leaves(fresh.params))
               for k in ("exp_avg", "exp_avg_sq", "step"))
    same = same and all(torch.equal(a, b) for (_, a), (_, b) in zip(
        checkpoint.leaves(state.params), checkpoint.leaves(fresh.params)))
    l4 = step(state, batches[3])[1]["overall_loss"].item()
    r4 = step(fresh, batches[3])[1]["overall_loss"].item()
    rel = abs(r4 - l4) / abs(l4)
    print(f"[train ckpt] latest.npz after step 3: {len(names)} names, the "
          f"reference's; saved in {save_s:.2f} s, restored in {load_s:.2f} "
          f"s; params and Adam state equal after restore: {same}; step 4 "
          f"loss {l4!r} uninterrupted, {r4!r} resumed, rel {rel:.3e} "
          f"(limit 1e-5)")
    check(same, "train ckpt: the restored state differs")
    check(rel <= 1e-5, "train ckpt: step 4's loss differs after resume")


def phase_train() -> tuple[dict, dict]:
    """The [train ...] phases; returns their in-memory records."""
    import torch
    from disn_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    records = synthetic.memory_records()
    print(f"[train] records: 3 objects x 8192 samples, 12 views at 137^2, "
          f"made in {time.perf_counter() - t0:.2f} s")
    phase_train_hold(records)
    torch.cuda.empty_cache()
    phase_train_steps(records)
    torch.cuda.empty_cache()
    phase_train_ckpt(records)
    torch.cuda.empty_cache()
    print(f"[train] phase took {time.perf_counter() - t0:.1f} s")
    return records


# -- evaluation ---------------------------------------------------------------

# the special-function units: 16 results a clock per SM against the FMA
# units' 128 lanes x 2 flops, so 1/16 of the f32 FMA peak in results a second
H100_SFU_PER_S = H100_F32_FLOPS / 16
EPS32 = 2.0 ** -23
# K6a: the kernel's a.b and cuBLAS's round three products and two sums in
# their own order, and (|a|^2 - 2a.b) + |b|^2 adds two roundings at the
# scale |a|^2 + |b|^2: 8 ulps of that scale covers all five
NN_ULPS = 8
# K6b: exp(level * d) at level -16384 turns a difference of delta in d into
# a relative 16384 * delta in e; with the K6a bound on delta at the mesh
# clouds' scale (|x|^2 <= 0.36) that is ~5e-3 on the pairs the first level
# moves. The protocol reads the cost (the EMD) and match's marginals,
# which sum many pairs: they are held to 1e-3 (relative for the cost,
# absolute for each marginal, whose scale is the starting mass 1 or 2)
EMD_REL_TOL = 1e-3
MARGINAL_TOL = 1e-3
# K6c / K6d: sums of match-weighted terms over up to 4M pairs (K6c) or
# 2048 (K6d) in another order than the plain version's: n * eps of the sum
# of |terms| bounds them; 1e-4 of that scale is n * eps for n = 2048
COST_REL_TOL = 1e-4
GRAD_REL_TOL = 1e-4
# K6c against match_cost_plain run in float64 on the same match: no further
# from it than this many times the f32 plain version's distance + this
# relative share of the cost (the kernel sums in f64 and takes d with FMAs,
# the plain version sums in f32 after a cuBLAS a.b)
COST_F64_RATIO = 2.0
COST_F64_REL = 1e-6
# K6a's floor in issue slots a pair: d once (FMUL, 2 FFMA, 2 FADD, FMNMX for
# the clamp), then a compare and two selects for the row and the same for
# the column; 128 lanes a clock per SM issue them at half the f32 flop peak
NN_SLOTS_PER_PAIR = 12
# K6d's floor in issue slots a pair: 3 FSUB, 5 for |d|^2 in the plain
# version's order, the clamp, one rsqrtf, w, 2 x 3 FFMA, a quarter of a
# global and of a shared load (17.5), the rows' warp sums, 18 SHFL, 18 FADD
# and 18 selects a thread for 4 rows of 4 pairs (3.4), the chunk sums (0.2)
MG_SLOTS_PER_PAIR = 21
# K6a against the gram_d tile (approx_match_d_tile, at most 128 x 512): the
# first points of batch 0 of each shape, as they are and with duplicated
# points (d clamped to 0) and exact ties
NN_TILE_ROWS, NN_TILE_COLS = 128, 512
# nn_distance's backward on the card against the CPU: index_add_ adds with
# atomics in any order; an entry sums the few points whose neighbour it is
NN_BWD_REL_TOL = 1e-5
# --device-iou draws with a torch.Generator, whose streams differ on the
# card and on the CPU: the card's mean IoU over these seeds is held within
# this many standard errors of the CPU's
DEV_IOU_SEEDS = 8
DEV_IOU_SIGMAS = 4.0
EVAL_SHAPES = (("protocol mesh", 24, 2048, 2048),
               ("protocol randn", 24, 2048, 2048),
               ("ragged", 3, 2048, 1000), ("ragged", 3, 1000, 2048),
               ("ragged", 3, 2047, 1537), ("single", 1, 1, 1))


def octahedron_mesh(sdf_res: int, dtype: str):
    """The main path's mesh (the analytic octahedron head on the
    full-width net, the demo camera, seeded image 1) at `sdf_res`."""
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline

    cfg = Config(sdf_res=sdf_res, compute_dtype=dtype)
    params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6)
    img = np.random.RandomState(0).randint(0, 256, (2, 137, 137, 3),
                                           dtype=np.uint8)[1]
    return pipeline.image_to_mesh(params, img, synthetic.demo_trans_mat(),
                                  cfg)


def eval_clouds(kind: str, b: int, n: int, m: int, pred_mesh, gt_mesh):
    """(pred [b,n,3], gt [b,m,3]) on the card: each view's vertices drawn
    from the prediction mesh and one GT draw broadcast over the views, as
    the runner samples them; or seeded randn clouds (scaled 0.5 for the
    ragged shapes)."""
    import torch
    from disn_tpu_torch.eval import metrics

    rng = np.random.RandomState(b * 7919 + n * 31 + m)
    if kind == "protocol mesh":
        gt = metrics.sample_mesh_vertices(gt_mesh[0], m, rng)
        pred = np.stack([metrics.sample_mesh_vertices(pred_mesh[0], n, rng)
                         for _ in range(b)])
        gt = np.broadcast_to(gt, (b, m, 3))
    else:
        scale = 1.0 if kind == "protocol randn" else 0.5
        pred = scale * rng.randn(b, n, 3)
        gt = scale * rng.randn(b, m, 3)
    return (torch.from_numpy(np.ascontiguousarray(pred, np.float32)).cuda(),
            torch.from_numpy(np.ascontiguousarray(gt, np.float32)).cuda())


def k6_bounds(b: int, n: int, m: int) -> dict:
    """(least ms, "bytes" or "operations") of each K6 kernel at [b,n]x[b,m]:
    inputs read once and outputs written once at 3.35 TB/s; flops at the
    f32 FMA peak and exp / sqrt / divides at the special-function rate, the
    larger of the two (they run on separate units)."""
    pairs = b * n * m
    cloud_b = 12 * b * (n + m)

    def bound(nbytes, flops, sfu):
        t_b = nbytes / H100_BYTES_PER_S
        t_o = max(flops / H100_F32_FLOPS, sfu / H100_SFU_PER_S)
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    return {
        # d is symmetric, so once a pair serves both directions: a.b (3
        # products, 5 flops) and the Gram sum (3), then one compare a
        # direction (2)
        "nn_distance": bound(cloud_b + 8 * b * (n + m), 10 * pairs, 0),
        # d once (8), then per level the row sum, column sum, w (2), its
        # row sum and the match sum (8), and level * d (1) on the 9 levels
        # below 0; one exp a pair on those 9 (level 0 has exp(0) = 1)
        "approx_match": bound(cloud_b + 4 * pairs, (8 + 10 * 8 + 9) * pairs,
                              9 * pairs),
        # d (8) and the weighted sum (2); one sqrt a pair
        "match_cost": bound(cloud_b + 4 * pairs + 4 * b, 10 * pairs, pairs),
        # the difference and its square (8), w = match / dist (1), its
        # products with the difference (3), both sums (6); one reciprocal
        # square root a pair gives 1 / max(dist, 1e-12)
        "match_cost_grad": bound(cloud_b * 2 + 4 * pairs + 4 * b,
                                 18 * pairs, pairs),
    }


def hold_k6(kind: str, b: int, n: int, m: int, pred_mesh, gt_mesh,
            timed: bool) -> dict:
    """K6a-K6d against their plain versions on one shape, in the protocol's
    argument order: nn_distance(pred, gt), approx_match(gt, pred),
    match_cost(gt, pred, match) and its gradient."""
    import torch
    from disn_tpu_torch.eval import metrics as mt

    pred, gt = eval_clouds(kind, b, n, m, pred_mesh, gt_mesh)
    tag = f"[eval hold] {kind} B={b} N={n} M={m}"
    out = {}
    # K6a
    got, want = mt.nn_distance(pred, gt), mt.nn_distance_plain(pred, gt)
    scale = float((pred * pred).sum(-1).max() + (gt * gt).sum(-1).max())
    tol = NN_ULPS * EPS32 * scale
    err = max(float((got[0] - want[0]).abs().max()),
              float((got[2] - want[2]).abs().max()))
    ties = 0
    worst_tie = 0.0
    for gi, wi, a, c in ((got[1], want[1], pred, gt),
                         (got[3], want[3], gt, pred)):
        rows = torch.nonzero(gi != wi, as_tuple=True)
        ties += len(rows[0])
        if len(rows[0]):
            a64 = a[rows].double()
            dk = ((a64 - c[rows[0], gi[rows].long()].double()) ** 2).sum(-1)
            dp = ((a64 - c[rows[0], wi[rows].long()].double()) ** 2).sum(-1)
            worst_tie = max(worst_tie, float((dk - dp).abs().max()))
    print(f"{tag} K6a nn_distance: max|dist diff| {err:.3e} (tol {tol:.3e} "
          f"= {NN_ULPS} ulp of {scale:.3f}); {ties} indices differ, their "
          f"candidates' float64 distances within {worst_tie:.3e}")
    check(err <= tol and worst_tie <= tol,
          f"{tag}: nn_distance disagrees with its plain version")
    out["nn_distance"] = {"max_abs_err": err}
    hold_nn_tile(tag, pred, gt)
    hold_norms(tag, pred, gt)
    # K6b
    mk, mp = mt.approx_match(gt, pred), mt.approx_match_plain(gt, pred)
    ck = mt.match_cost_plain(gt, pred, mk)
    cp = mt.match_cost_plain(gt, pred, mp)
    rel = float(((ck - cp).abs() / cp.abs().clamp_min(1e-30)).max())
    row = float((mk.sum(1) - mp.sum(1)).abs().max())
    col = float((mk.sum(2) - mp.sum(2)).abs().max())
    elem = float((mk - mp).abs().max())
    mass = float(mp.sum((1, 2)).min()) / min(n, m)
    print(f"{tag} K6b approx_match: EMD rel diff {rel:.3e} (tol "
          f"{EMD_REL_TOL}), marginals max|diff| over N {row:.3e} and over M "
          f"{col:.3e} (tol {MARGINAL_TOL}); elementwise max|diff| {elem:.3e} "
          f"(not gated); plain mass moved {mass:.4f} of min(N,M)")
    check(rel <= EMD_REL_TOL and row <= MARGINAL_TOL and col <= MARGINAL_TOL,
          f"{tag}: approx_match disagrees with its plain version")
    out["approx_match"] = {"max_abs_err": elem}
    hold_referee(tag, gt, pred, mk, mp)
    del mp
    # K6c on the kernel's match
    got_c = mt.match_cost(gt, pred, mk)
    want_c = mt.match_cost_plain(gt, pred, mk)
    err_c = float((got_c - want_c).abs().max())
    lim_c = COST_REL_TOL * float(want_c.abs().max())
    print(f"{tag} K6c match_cost: max|diff| {err_c:.3e} (tol {lim_c:.3e} = "
          f"{COST_REL_TOL} x max cost)")
    check(err_c <= lim_c, f"{tag}: match_cost disagrees with its plain "
                          "version")
    out["match_cost"] = {"max_abs_err": err_c}
    ref_c = mt.match_cost_plain(gt.double(), pred.double(), mk.double())
    dk_c = (got_c.double() - ref_c).abs()
    dp_c = (want_c.double() - ref_c).abs()
    ok_c = bool((dk_c <= COST_F64_RATIO * dp_c
                 + COST_F64_REL * ref_c.abs()).all())
    print(f"{tag} K6c float64 match_cost on the same match: kernel max "
          f"rel |diff| {float((dk_c / ref_c.abs()).max()):.3e}, f32 plain "
          f"{float((dp_c / ref_c.abs()).max()):.3e}; kernel within "
          f"{COST_F64_RATIO} x plain + {COST_F64_REL} relative on every "
          f"batch entry: {ok_c}")
    check(ok_c, f"{tag}: match_cost is further from float64 than "
                f"{COST_F64_RATIO} x its plain version")
    del ref_c
    # K6d through autograd against the plain backward and float64
    g = torch.from_numpy(np.random.RandomState(5).rand(b).astype(
        np.float32) + 0.5).cuda()
    out["match_cost_grad"] = {"max_abs_err": hold_k6d(tag, gt, pred, mk, g)}
    # nn_distance's backward (PyTorch ops) on the card against the CPU,
    # from the card's indices
    rng = np.random.RandomState(6)
    g1 = torch.from_numpy(rng.rand(b, n).astype(np.float32)).cuda()
    g2 = torch.from_numpy(rng.rand(b, m).astype(np.float32)).cuda()
    card = mt.nn_distance_backward(pred, gt, got[1], got[3], g1, g2)
    cpu = mt.nn_distance_backward(pred.cpu(), gt.cpu(), got[1].cpu(),
                                  got[3].cpu(), g1.cpu(), g2.cpu())
    err_b = max(float((x.cpu() - y).abs().max()) for x, y in zip(card, cpu))
    lim_b = NN_BWD_REL_TOL * max(float(y.abs().max()) for y in cpu)
    print(f"{tag} nn_distance backward card vs CPU: max|diff| {err_b:.3e} "
          f"(tol {lim_b:.3e})")
    check(err_b <= lim_b, f"{tag}: nn_distance's backward differs from "
                          "the CPU's")
    if timed:
        bounds = k6_bounds(b, n, m)
        calls = {
            "nn_distance": (lambda: mt.nn_distance(pred, gt),
                            lambda: mt.nn_distance_plain(pred, gt)),
            "approx_match": (lambda: mt.approx_match(gt, pred),
                             lambda: mt.approx_match_plain(gt, pred)),
            "match_cost": (lambda: mt.match_cost(gt, pred, mk),
                           lambda: mt.match_cost_plain(gt, pred, mk)),
            "match_cost_grad": (
                lambda: mt.match_cost_grad(gt, pred, mk, g),
                lambda: mt.match_cost_grad_plain(gt, pred, mk, g)),
        }

        def library():
            d = torch.cdist(pred, gt) ** 2
            return d.min(-1).values, d.argmin(-1), d.min(-2).values, \
                d.argmin(-2)

        for name, (kern, plain) in calls.items():
            r = out[name]
            r["ms"] = median_ms(kern, True, reps=20)
            r["plain_ms"] = median_ms(plain, True)
            r["bound_ms"], r["bound_by"] = bounds[name]
            r["library_ms"] = (median_ms(library, True)
                               if name == "nn_distance" else None)
            lib = (f" library (cdist**2, min/argmin both ways) "
                   f"{r['library_ms']:.4f} ms" if r["library_ms"] else "")
            print(f"{tag} {name} ms={r['ms']:.4f} plain_ms="
                  f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
                  f"({r['bound_by']}) share {r['bound_ms'] / r['ms']:.4f}"
                  f"{lib}")
        am_split(tag, gt, pred, out["approx_match"])
        time_k6_turns(tag, pred, gt, mk, g, out)
        profile_k6(tag, pred, gt, mk, g)
    return out


def hold_k6d(tag: str, xyz1, xyz2, match, g) -> float:
    """K6d through autograd, match_cost(xyz1, xyz2, match) weighted by g:
    one match_cost_grad launch a backward; its gradients within
    GRAD_REL_TOL x max g x max marginal of the f32 plain backward, and
    within referee.RATIO x the plain version's distance from the float64
    referee + referee.GRAD_ULPS ulps of the scale (eval/referee.py). With
    --parent, that checkout's K6d is measured too (not gated). Returns the
    largest difference from the plain version."""
    from disn_tpu_torch.eval import metrics as mt
    from disn_tpu_torch.eval import referee

    x1r = xyz1.clone().requires_grad_(True)
    x2r = xyz2.clone().requires_grad_(True)
    before = mt.match_cost_grad.launches
    (mt.match_cost(x1r, x2r, match) * g).sum().backward()
    check(mt.match_cost_grad.launches == before + 1,
          f"{tag}: a backward made {mt.match_cost_grad.launches - before} "
          "match_cost_grad launches, not 1")
    w1, w2 = mt.match_cost_grad_plain(xyz1, xyz2, match, g)
    scale_g = float(g.max()) * max(float(match.sum(1).max()),
                                   float(match.sum(2).max()))
    err_d = max(float((x1r.grad - w1).abs().max()),
                float((x2r.grad - w2).abs().max()))
    print(f"{tag} K6d match_cost_grad (autograd): max|diff| {err_d:.3e} "
          f"(tol {GRAD_REL_TOL * scale_g:.3e} = {GRAD_REL_TOL} x max g x "
          f"max marginal)")
    check(err_d <= GRAD_REL_TOL * scale_g,
          f"{tag}: match_cost's gradient disagrees with its plain version")
    ref = referee.grad_referee(xyz1, xyz2, match, g)
    dk = referee.grad_distance((x1r.grad, x2r.grad), ref)
    dp = referee.grad_distance((w1, w2), ref)
    ok = referee.grad_within(dk, dp, ref)

    def fmt(d):
        return " ".join(f"{k} {float(d[k].max()):.3e}"
                        for k in referee.GRAD_KEYS)

    ratio = max(float((dk[k] / dp[k].clamp_min(1e-300)).max())
                for k in referee.GRAD_KEYS)
    parent = ""
    if PARENT_K6:
        dq = referee.grad_distance(PARENT_K6["match_cost_grad"]["call"](
            xyz1, xyz2, match, g), ref)
        parent = f"; parent kernel {fmt(dq)}"
    print(f"{tag} K6d float64 referee (largest |diff| of g1 and g2 over the "
          f"batch entries): kernel {fmt(dk)}; f32 plain {fmt(dp)}{parent}; "
          f"worst kernel / plain ratio of an entry {ratio:.3f}; kernel "
          f"within {referee.RATIO} x plain + {referee.GRAD_ULPS} ulp of "
          f"max|g| x max marginal on every batch entry: {ok}")
    check(ok, f"{tag}: match_cost's gradient is further from the float64 "
              f"referee than {referee.RATIO} x its plain version")
    return err_d


def hold_nn_tile(tag: str, pred, gt) -> None:
    """K6a's dist and idx both ways equal, bit for bit, the lowest-index
    minimum of the kernel's own gram_d tile (approx_match_d_tile(...)[2]) on
    the first points of batch 0: as drawn, and with points of xyz1 copied
    into xyz2 (d clamped to 0, two candidates at 0 for a row) and points of
    xyz2 repeated (exact ties)."""
    import torch
    from disn_tpu_torch.eval import metrics as mt

    x = pred[0, :NN_TILE_ROWS].contiguous()
    y = gt[0, :NN_TILE_COLS].contiguous()
    cases = [("as drawn", y)]
    if len(x) > 3 and len(y) > 40:
        yd = y.clone()
        yd[7], yd[30], yd[31] = x[2], x[2], x[3]
        yd[40] = yd[7]
        cases.append(("duplicates and ties", yd))
    for label, yy in cases:
        tile = mt.approx_match_d_tile(x, yy)[2]
        got = mt.nn_distance(x[None], yy[None])
        want = (tile.min(1).values, tile.argmin(1).int(),
                tile.min(0).values, tile.argmin(0).int())
        same = [torch.equal(got[k][0].view(torch.int32),
                            want[k].view(torch.int32)) for k in range(4)]
        print(f"{tag} K6a vs its gram_d tile "
              f"{tuple(tile.shape)} {label}: dist1, idx1, dist2, idx2 equal "
              f"bit for bit {same}")
        check(all(same), f"{tag}: nn_distance is not the lowest-index "
                         f"minimum of its gram_d tile ({label})")


def hold_norms(tag: str, pred, gt) -> None:
    """K6a and K6c compute |p|^2 themselves (sq3): its bits must be _sq's,
    the plain versions' torch.sum(p * p, -1) on the card."""
    import torch
    from disn_tpu_torch.eval import metrics as mt

    bad = sum(int((mt.kernel_norms(c).view(torch.int32)
                   != mt._sq(c).view(torch.int32)).sum()) for c in (pred, gt))
    print(f"{tag} kernel norms (sq3) against _sq: {bad} of "
          f"{pred.shape[0] * (pred.shape[1] + gt.shape[1])} differ")
    check(bad == 0, f"{tag}: the kernels' norms differ from _sq")


PARENT_K6: dict = {}  # another checkout's K6 (--parent), run beside


def k6_runners(path) -> dict:
    """Launchers of a build of some checkout's csrc/metrics.cu with its own
    entry points' signatures: for K6a, K6c and K6d, "prep"(clouds[, match[,
    g]]) allocates every buffer once and returns a function that only
    launches (the kernel alone), "call" does what that checkout's wrapper
    does on the card (allocation, norms where that build takes them, the
    launch); for K6b, referee.load's auction. Builds from before the
    one-pass K6a take the norms from the caller and sum K6c's shares in f32
    scratch; builds from before the one-pass K6d (no match_cost_grad_parts)
    take no scratch for it."""
    import torch
    from disn_tpu_torch.eval import metrics as mt
    from disn_tpu_torch.eval import referee

    lib = ctypes.CDLL(str(path))
    out = {"approx_match": referee.load(path)[1]}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    new = hasattr(lib, "cloud_norms")
    if new:
        lib = mt.bind(path)
    else:
        lib.nn_distance_launch.argtypes = [vp, vp, ci, vp, vp, ci, ci, vp, vp,
                                           vp, vp, vp]
        lib.match_cost_parts.argtypes = [ci]
        lib.match_cost_launch.argtypes = [vp, vp, ci, vp, vp, ci, ci, vp, vp,
                                          vp, vp]
        for f in ("nn_distance_launch", "match_cost_parts",
                  "match_cost_launch"):
            getattr(lib, f).restype = ci
    grad_new = hasattr(lib, "match_cost_grad_parts")
    if not grad_new:
        lib.match_cost_grad_launch.argtypes = [vp, ci, vp, ci, ci] + [vp] * 5
        lib.match_cost_grad_launch.restype = ci

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def nn_prep(x, y):
        b, n, m = x.shape[0], x.shape[1], y.shape[1]
        o = [torch.empty((b, k), dtype=t, device=x.device)
             for k, t in ((n, torch.float32), (n, torch.int32),
                          (m, torch.float32), (m, torch.int32))]
        p = [t.data_ptr() for t in o]
        if new:
            keys = torch.empty((b * (n + m),), dtype=torch.int64,
                               device=x.device)
            args = (x.data_ptr(), n, y.data_ptr(), m, b, keys.data_ptr(), *p)
            hold = (keys,)
        else:
            s1, s2 = mt._sq(x), mt._sq(y)
            args = (x.data_ptr(), s1.data_ptr(), n, y.data_ptr(),
                    s2.data_ptr(), m, b, *p)
            hold = (s1, s2)

        def launch():
            mt._raise_on(lib.nn_distance_launch(*args, stream()),
                         "nn_distance")
            return o
        launch.hold = hold
        return launch

    def mc_prep(x, y, match):
        b, n, m = x.shape[0], x.shape[1], y.shape[1]
        cost = torch.empty((b,), device=x.device)
        if new:
            part = torch.empty((b, lib.match_cost_parts(n, m)),
                               dtype=torch.float64, device=x.device)
            args = (x.data_ptr(), n, y.data_ptr(), m, b, match.data_ptr(),
                    part.data_ptr(), cost.data_ptr())
            hold = (part,)
        else:
            s1, s2 = mt._sq(x), mt._sq(y)
            part = torch.empty((b, lib.match_cost_parts(m)), device=x.device)
            args = (x.data_ptr(), s1.data_ptr(), n, y.data_ptr(),
                    s2.data_ptr(), m, b, match.data_ptr(), part.data_ptr(),
                    cost.data_ptr())
            hold = (s1, s2, part)

        def launch():
            mt._raise_on(lib.match_cost_launch(*args, stream()),
                         "match_cost")
            return cost
        launch.hold = hold
        return launch

    def mg_prep(x, y, match, g):
        b, n, m = x.shape[0], x.shape[1], y.shape[1]
        o = [torch.empty((b, k, 3), device=x.device) for k in (n, m)]
        scratch = ()
        if grad_new:
            scratch = (torch.empty((b, lib.match_cost_grad_parts(n, m)),
                                   device=x.device),)
        args = (x.data_ptr(), n, y.data_ptr(), m, b, match.data_ptr(),
                g.data_ptr(), *(t.data_ptr() for t in scratch),
                o[0].data_ptr(), o[1].data_ptr())

        def launch():
            mt._raise_on(lib.match_cost_grad_launch(*args, stream()),
                         "match_cost_grad")
            return o
        launch.hold = scratch
        return launch

    out["nn_distance"] = {
        "prep": nn_prep,
        "call": ((lambda x, y: mt._nn_run(lib, x, y)) if new
                 else (lambda x, y: nn_prep(x, y)()))}
    out["match_cost"] = {
        "prep": mc_prep,
        "call": ((lambda x, y, w: mt._match_cost_run(lib, x, y, w)) if new
                 else (lambda x, y, w: mc_prep(x, y, w)()))}
    out["match_cost_grad"] = {
        "prep": mg_prep,
        "call": ((lambda x, y, w, g: list(mt._match_cost_grad_run(
            lib, x, y, w, g))) if grad_new
            else (lambda x, y, w, g: mg_prep(x, y, w, g)()))}
    return out


def time_k6_turns(tag: str, pred, gt, mk, g, out: dict) -> None:
    """K6a, K6c and K6d: the kernel alone (CUDA events around the library
    call, buffers allocated before) and the wrapper's work without its
    checks (allocation, norms where the build takes them, the call), median
    of 20 after a warm-up; with --parent both in turns (parent, change,
    change, parent), else this checkout's twice; the public wrapper beside
    each run of this checkout's. Beside them the bound and the floor (K6a:
    NN_SLOTS_PER_PAIR issue slots a pair; K6c: its bound, bytes; K6d:
    MG_SLOTS_PER_PAIR issue slots a pair), whether the two builds give the
    same bits and whether this checkout's kernel alone was faster in every
    turn. Both builds' K6d distances from the float64 referee on these
    inputs are hold_k6d's line, printed before."""
    import torch
    from disn_tpu_torch.eval import metrics as mt

    b, n, m = pred.shape[0], pred.shape[1], gt.shape[1]
    builds = {"change": k6_runners(mt.build())}
    if PARENT_K6:
        builds["parent"] = PARENT_K6
    order = (["parent", "change", "change", "parent"] if PARENT_K6
             else ["change", "change"])
    slots = H100_F32_FLOPS / 2 / (b * n * m) / 1e3  # ms a slot a pair
    floors = {"nn_distance": NN_SLOTS_PER_PAIR / slots,
              "match_cost": out["match_cost"]["bound_ms"],
              "match_cost_grad": MG_SLOTS_PER_PAIR / slots}
    for name, args, public in (
            ("nn_distance", (pred, gt), lambda: mt.nn_distance(pred, gt)),
            ("match_cost", (gt, pred, mk),
             lambda: mt.match_cost(gt, pred, mk)),
            ("match_cost_grad", (gt, pred, mk, g),
             lambda: mt.match_cost_grad(gt, pred, mk, g))):
        kern = {k: v[name]["prep"](*args) for k, v in builds.items()}
        alone, wrap, pub = [], [], []
        for k in order:
            alone.append((k, median_ms(kern[k], True, reps=20)))
            wrap.append((k, median_ms(lambda k=k: builds[k][name]["call"](
                *args), True, reps=20)))
            if k == "change":
                pub.append(median_ms(public, True, reps=20))
        r = out[name]
        kernel_ms = float(np.median([t for k, t in alone if k == "change"]))
        bound, floor = r["bound_ms"], floors[name]
        print(f"{tag} {name} in turns (CUDA events, median of 20): kernel "
              f"alone {[(k, round(t, 5)) for k, t in alone]}, wrapper's work "
              f"{[(k, round(t, 5)) for k, t in wrap]}, the public wrapper "
              f"{[round(t, 5) for t in pub]} ({r['ms']:.5f} before); bound "
              f"{bound:.5f} ms (share of the kernel alone "
              f"{bound / kernel_ms:.4f}, of the wrapper "
              f"{bound / r['ms']:.4f}), floor {floor:.5f} ms (share "
              f"{floor / kernel_ms:.4f} / {floor / r['ms']:.4f})")
        if "parent" in kern:
            a, c = kern["parent"](), kern["change"]()
            a = a if isinstance(a, list) else [a]
            c = c if isinstance(c, list) else [c]
            same = all(torch.equal(u, v) for u, v in zip(a, c))
            diff = max(float((u.double() - v.double()).abs().max())
                       for u, v in zip(a, c))
            faster = max(t for k, t in alone if k == "change") < min(
                t for k, t in alone if k == "parent")
            print(f"{tag} {name} parent and change give the same bits: "
                  f"{same} (max|diff| {diff:.3e}; not gated: K6c's and "
                  f"K6d's sums run in another order); the change's kernel "
                  f"alone faster in every turn: {faster}")


def profile_k6(tag: str, pred, gt, mk, g) -> None:
    """torch.profiler over LIBRARY_CALLS calls each of K6a, K6c and K6d
    through the public wrappers: the device runs the library's work alone
    (K6a: the keys' memset, nn_pass, nn_unpack; K6c: mc_pass, mc_total;
    K6d: mc_grad_pass, mc_grad_total, one read of match), and each
    kernel's time a call. The profiler does not record every event of a
    window (the first ones go missing late in a long run), so a kernel
    need only be seen (and a window that misses one is taken again:
    profiled)."""
    from torch.autograd import DeviceType

    from disn_tpu_torch.eval import metrics as mt

    for name, fn, kerns in (
            ("nn_distance", lambda: mt.nn_distance(pred, gt),
             ("nn_pass", "nn_unpack")),
            ("match_cost", lambda: mt.match_cost(gt, pred, mk),
             ("mc_pass", "mc_total")),
            ("match_cost_grad", lambda: mt.match_cost_grad(gt, pred, mk, g),
             ("mc_grad_pass", "mc_grad_total"))):
        fn()
        prof, _ = profiled(lambda: [fn() for _ in range(LIBRARY_CALLS)],
                           want=kerns)
        dev = [(e.key, e.count, _device_time(e, True) / e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        print(f"{tag} {name} profile ({LIBRARY_CALLS} calls; event, count, "
              f"us a call): "
              f"{[(k[:40], c, round(us, 2)) for k, c, us in dev]}")
        check(all(any(o in k for o in ("Memset", *kerns)) for k, _, _ in dev)
              and all(any(o in k for k, _, _ in dev) for o in kerns),
              f"{tag}: {name} ran other device work than its library's: "
              f"{dev}")


def am_split(tag: str, xyz1, xyz2, res: dict) -> None:
    """K6b's device time by pass (row, column, match) from torch.profiler
    over 3 calls, beside its bound and the three-pass floor: 36 exps a pair
    (2 a row pass, 1 a column pass and match write, none at the last level,
    0) at the special-function rate, the rate the bound counts 9 exps a
    pair at."""
    from torch.autograd import DeviceType

    from disn_tpu_torch.eval import metrics as mt

    split = {"row": 0.0, "col": 0.0, "match": 0.0}
    prof, _ = profiled(lambda: [mt.approx_match(xyz1, xyz2)
                                for _ in range(3)],
                       want=tuple(f"am_{k}" for k in split))
    other = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = next((k for k in split if f"am_{k}" in e.key), None)
        if key is None:
            other.append(e.key)
        else:
            split[key] += _device_time(e, True) / 3e3
    floor = 36 / 9 * res["bound_ms"]
    print(f"{tag} approx_match split (torch.profiler, 3 calls): row passes "
          f"{split['row']:.4f} ms, column passes {split['col']:.4f} ms, "
          f"match write {split['match']:.4f} ms, sum "
          f"{sum(split.values()):.4f}; events ms {res['ms']:.4f}; bound "
          f"{res['bound_ms']:.5f} ms ({res['bound_ms'] / res['ms']:.4f}), "
          f"three-pass floor {floor:.5f} ms ({floor / res['ms']:.4f}); "
          f"other device work (the norms): {[k[:40] for k in other]}")


def hold_referee(tag: str, xyz1, xyz2, mk=None, mp=None) -> None:
    """K6b and its f32 plain version against the float64 referee
    (eval/referee.py) on approx_match(xyz1, xyz2): each one's largest
    difference of the marginal per xyz1 point and per xyz2 point and
    relative of the EMD; K6b within referee.RATIO x the plain version's +
    referee.ABS. With --parent, that checkout's K6b is measured too (not
    gated)."""
    from disn_tpu_torch.eval import metrics as mt
    from disn_tpu_torch.eval import referee

    mk = mt.approx_match(xyz1, xyz2) if mk is None else mk
    mp = mt.approx_match_plain(xyz1, xyz2) if mp is None else mp
    ref = referee.referee(xyz1, xyz2)
    dk, dp = referee.distance(mk, ref), referee.distance(mp, ref)
    ok = referee.within(dk, dp)

    def fmt(d):
        return " ".join(f"{k} {d[k]:.3e}" for k in referee.KEYS)

    parent = ""
    if PARENT_K6:
        dq = referee.distance(PARENT_K6["approx_match"](xyz1, xyz2), ref)
        parent = f"; parent kernel {fmt(dq)}"
    print(f"{tag} K6b float64 referee (largest |diff| of the marginal per "
          f"xyz1 point n, per xyz2 point m, relative of the EMD): kernel "
          f"{fmt(dk)}; f32 plain {fmt(dp)}{parent}; kernel within "
          f"{referee.RATIO} x plain + {referee.ABS}: {ok}")
    check(ok, f"{tag}: approx_match is further from the float64 referee "
              f"than {referee.RATIO} x its plain version")


def phase_eval_hold(pred_mesh, gt_mesh) -> dict:
    """Every shape of EVAL_SHAPES; returns the protocol mesh shape's
    results with each kernel's worst error over all shapes."""
    import torch

    res = {}
    worst: dict = {}
    for kind, b, n, m in EVAL_SHAPES:
        r = hold_k6(kind, b, n, m, pred_mesh, gt_mesh,
                    timed=kind.startswith("protocol"))
        if kind == "protocol mesh":
            res = r
        for k, v in r.items():
            worst[k] = max(worst.get(k, 0.0), v["max_abs_err"])
        torch.cuda.empty_cache()
    for k in res:
        res[k]["max_abs_err"] = worst[k]
    return res


FARM_CAT = "99999999"
FARM_OBJS = ("obj0", "obj1")
FARM_VIEWS = 24


def farm_records(paths):
    """In-memory view records (seeded u8 RGBA images, the demo camera) and
    sdf_params (the unit box) of the farm's objects, keyed by path."""
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline

    rng = np.random.RandomState(3)
    views, sdf = {}, {}
    for obj in FARM_OBJS:
        sdf[paths.sdf_path(FARM_CAT, obj)] = pipeline.UNIT_BOX
        for v in range(FARM_VIEWS):
            views[paths.img_path(FARM_CAT, obj, v)] = codecs.ViewRecord(
                img_arr=rng.randint(0, 256, (137, 137, 4), dtype=np.uint8),
                trans_mat=synthetic.demo_trans_mat(),
                K=np.eye(3, dtype=np.float32),
                RT=np.zeros((3, 4), np.float32),
                obj_rot_mat=np.eye(3, dtype=np.float32),
                regress_mat=np.zeros((4, 3), np.float32))
    return views, sdf


def phase_eval_farm(gt_mesh) -> dict:
    """The slice end to end: reconstruct_split writes 2 objects x 24 views
    (full-width net, analytic octahedron head, sdf_res 256, bf16) from
    in-memory records, then evaluate_tree scores them against GT meshes
    written with the port's write_obj, on the card. The K6 counts are set
    to 0 just before and read just after. Then 1 object x 4 views on the
    card and with device='cpu', and the device IoU. Returns the counts."""
    import shutil

    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.data import listing, synthetic
    from disn_tpu_torch.eval import metrics as mt
    from disn_tpu_torch.eval import runner
    from disn_tpu_torch.infer import pipeline

    root = os.path.join(ROOT, "build", "chip_smoke_eval")
    shutil.rmtree(root, ignore_errors=True)
    cfg = Config(sdf_res=256, compute_dtype="bfloat16")
    params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6)
    paths = listing.SplitPaths(os.path.join(root, "sdf"),
                               os.path.join(root, "renders"))
    views, sdf = farm_records(paths)
    listinfo = [(FARM_CAT, o, v) for o in FARM_OBJS
                for v in range(FARM_VIEWS)]
    gt_dir = os.path.join(root, "gt")
    lst_all, lst_one = (os.path.join(root, d) for d in ("lst_all", "lst_one"))
    for d, objs in ((lst_all, FARM_OBJS), (lst_one, FARM_OBJS[:1])):
        os.makedirs(d)
        with open(os.path.join(d, f"{FARM_CAT}_test.lst"), "w") as f:
            f.write("\n".join(objs) + "\n")
    for obj in FARM_OBJS:
        codecs.write_obj(os.path.join(gt_dir, FARM_CAT, obj, "isosurf.obj"),
                         *gt_mesh)
    wrappers = (mt.nn_distance, mt.approx_match, mt.match_cost,
                mt.match_cost_grad)
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    t0 = time.perf_counter()
    written = pipeline.reconstruct_split(
        params, cfg, paths, listinfo, root, read_view=views.__getitem__,
        read_sdf_params=sdf.__getitem__)
    rec_s = time.perf_counter() - t0
    pred_dir = pipeline.result_dir(root, cfg)
    check(len(written) == 48 and all(os.path.getsize(p) > 0
                                     for p in written),
          f"eval farm: {len(written)} meshes written, 48 expected")
    t0 = time.perf_counter()
    res = runner.evaluate_tree(pred_dir, gt_dir, lst_all,
                               view_num=FARM_VIEWS)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = {w.__name__: w.launches for w in wrappers}
    overall = res["overall"]
    print(f"[eval farm] reconstruct_split: {len(written)} images in "
          f"{rec_s:.3f} s = {len(written) / rec_s:.2f} images/s (reading "
          f"from memory, writing {sum(os.path.getsize(p) for p in written)}"
          f" B of OBJ); evaluate_tree: {len(FARM_OBJS)} objects x "
          f"{FARM_VIEWS} views in {eval_s:.3f} s; K6 launches {counts}")
    print(f"[eval farm] overall {json.dumps(overall)}")
    check(all(counts[k] > 0 for k in ("nn_distance", "approx_match",
                                      "match_cost")),
          f"eval farm: a K6 kernel was not launched: {counts}")
    flat = [v for v in overall.values() if isinstance(v, float)]
    flat += [x for v in overall.values() if isinstance(v, list) for x in v]
    check(res["total_objects"] == 2 and all(np.isfinite(flat)),
          "eval farm: missing objects or non-finite metrics")
    check(overall["f1"][-1] == 1.0, f"eval farm: F1 at 20% is "
                                    f"{overall['f1'][-1]}, not 1.0")
    # the per-object split, on the farm's objects
    which = {"cd", "emd", "fscore", "iou"}
    for obj in FARM_OBJS:
        preds = [os.path.join(pred_dir, FARM_CAT,
                              f"{FARM_CAT}_{obj}_{v:02d}.obj")
                 for v in range(FARM_VIEWS)]
        gt_path = os.path.join(gt_dir, FARM_CAT, obj, "isosurf.obj")
        t0 = time.perf_counter()
        host = runner._object_host(gt_path, preds, 2048, which, 110)
        host_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        runner._object_device(host, which, 110)
        torch.cuda.synchronize()
        dev_ms = (time.perf_counter() - t0) * 1e3
        print(f"[eval farm] {obj}: host half (parse {FARM_VIEWS + 1} meshes, "
              f"sample, voxelize them at 110^3, one thread) {host_ms:.1f} ms;"
              f" device half (chamfer_emd + f_score on [{FARM_VIEWS},2048,3])"
              f" {dev_ms:.2f} ms")
        # the auction as _object_device runs it: GT first, broadcast
        pred = torch.from_numpy(host[0].astype(np.float32)).cuda()
        gt = torch.from_numpy(host[1].astype(np.float32)).cuda()
        gt = gt.expand(len(pred), -1, -1).contiguous()
        mk = mt.approx_match(gt, pred)
        hold_referee(f"[eval farm] {obj}", gt, pred, mk)
        g = torch.from_numpy(np.random.RandomState(5).rand(len(pred)).astype(
            np.float32) + 0.5).cuda()
        hold_k6d(f"[eval farm] {obj}", gt, pred, mk, g)
        del mk
        torch.cuda.empty_cache()
    # 1 object x 4 views: the card against the CPU, and the device IoU
    card = runner.evaluate_tree(pred_dir, gt_dir, lst_one, view_num=4)
    cpu = runner.evaluate_tree(pred_dir, gt_dir, lst_one, view_num=4,
                               device="cpu")
    dev_iou = [runner.evaluate_tree(pred_dir, gt_dir, lst_one, view_num=4,
                                    metrics=["iou"], device_iou=True,
                                    device=d)["overall"]["iou_avg"]
               for d in ("cuda", "cpu")]
    a, c = card["overall"], cpu["overall"]
    rel = {k: abs(a[k] - c[k]) / max(abs(c[k]), 1e-30)
           for k in ("cd_avg", "cd_min", "emd_avg", "emd_min")}
    pr = max(abs(x - y) for k in ("f_precision", "f_recall")
             for x, y in zip(a[k], c[k]))
    print(f"[eval farm] 1 object x 4 views, card vs CPU: relative "
          f"{ {k: f'{v:.3e}' for k, v in rel.items()} } (tol 1e-3); "
          f"precision/recall max|diff| {pr:.3e} (tol 1/2048); IoU "
          f"{a['iou_avg']!r} vs {c['iou_avg']!r} (equal)")
    check(max(rel.values()) <= 1e-3, "eval farm: CD/EMD differ between the "
                                     "card and the CPU")
    check(pr <= 1 / 2048, "eval farm: precision/recall differ between the "
                          "card and the CPU")
    check(a["iou_avg"] == c["iou_avg"] and a["iou_best"] == c["iou_best"],
          "eval farm: host IoU differs between the card's and the CPU's run")
    hold_device_iou(*dev_iou, gt_mesh, codecs.read_obj(written[0]))
    shutil.rmtree(root)
    return counts


def device_iou_spread(name: str, mesh1, mesh2, dim: int) -> float:
    """iou_meshes_device of two meshes on the card and on the CPU at seeds
    0..DEV_IOU_SEEDS-1. The two devices draw different streams from one
    seed, so the card is held to the CPU's distribution: the difference of
    the two means within DEV_IOU_SIGMAS of its standard error. Prints the
    gap of each to the host IoU; returns the larger per-seed spread."""
    from disn_tpu_torch.ops import voxelize

    host = voxelize.iou_meshes(mesh1, mesh2, dim=dim)
    runs = {d: np.array([voxelize.iou_meshes_device(
        mesh1, mesh2, dim=dim, seed=s, device=d)
        for s in range(DEV_IOU_SEEDS)]) for d in ("cuda", "cpu")}
    card, cpu = runs["cuda"], runs["cpu"]
    var = card.var(ddof=1), cpu.var(ddof=1)
    lim = DEV_IOU_SIGMAS * float(np.sqrt(sum(var) / DEV_IOU_SEEDS))
    diff = abs(float(card.mean() - cpu.mean()))
    for dev, r in runs.items():
        print(f"[eval farm] device IoU of the {name} at {dim}^3 on {dev}, "
              f"{DEV_IOU_SEEDS} seeds: mean {float(r.mean())!r} sd "
              f"{r.std(ddof=1):.5f} (min {r.min():.5f} max {r.max():.5f}); "
              f"gap to the host's {host!r}: mean {host - r.mean():.5f}, "
              f"max {float(np.abs(host - r).max()):.5f}")
    print(f"[eval farm] device IoU of the {name}: card mean - CPU mean "
          f"{diff:.5f} (limit {lim:.5f})")
    check(diff <= lim, f"eval farm: the card's device IoU of the {name} "
                       "is off the CPU's distribution")
    return float(np.sqrt(max(var)))


def hold_device_iou(tree_card: float, tree_cpu: float, gt_mesh,
                    pred_mesh) -> None:
    """--device-iou samples the surface (the JAX package's occupancy_device
    design): on the farm's meshes at dim 110 its occupancy is held to the
    bounds of tests/test_metrics.py:216-222 (its cells lie inside the exact
    (SAT) cells up to rounding at cell faces, 1 in 1000, and it misses at
    most 25% of them), a mesh against itself gives IoU 1, and its IoU on
    the farm's pair and on tests/test_metrics.py:237's spheres (radius 0.6
    and 0.55 by marching tetrahedra on a 33^3 grid, dim 48) follows the
    CPU's distribution. The evaluate_tree --device-iou values of the card
    and the CPU (one draw each) then agree within DEV_IOU_SIGMAS of their
    difference's spread. Sampling misses the cells a triangle only
    grazes, so the sampled IoU sits below the host's; the gaps are
    printed."""
    import torch
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.ops import marching, voxelize

    for name, mesh in (("GT", gt_mesh), ("view 0", pred_mesh)):
        exact = voxelize.voxelize_surface(*mesh, dim=110)
        samp = voxelize.occupancy_device(*mesh, dim=110)
        extra, miss = int((samp & ~exact).sum()), int((exact & ~samp).sum())
        n = int(exact.sum())
        print(f"[eval farm] device occupancy of the {name} mesh at 110^3: "
              f"{int(samp.sum())} cells, {extra} outside the {n} exact ones "
              f"(limit {max(1, n // 1000)}), {miss} of those missed ("
              f"{miss / n:.4f}, limit 0.25)")
        check(extra <= max(1, n // 1000) and miss <= 0.25 * n,
              f"eval farm: the device occupancy of the {name} mesh is off "
              "the exact one")
    self_iou = voxelize.iou_meshes_device(gt_mesh, gt_mesh, dim=110)
    print(f"[eval farm] device self-IoU of the GT mesh {self_iou!r}")
    check(self_iou == 1.0, "eval farm: a mesh's device IoU with itself is "
                           "not 1")
    sd = device_iou_spread("farm's GT and view 0", gt_mesh, pred_mesh, 110)
    lin = np.linspace(-1, 1, 33, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    p = np.stack([x, y, z], -1)
    box = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    m1, m2 = (marching.extract_mesh(torch.from_numpy(synthetic.sdf_sphere(
        p, r=r).astype(np.float32)), box) for r in (0.6, 0.55))
    device_iou_spread("spheres 0.6 and 0.55", m1, m2, 48)
    lim = DEV_IOU_SIGMAS * np.sqrt(2.0) * sd
    print(f"[eval farm] evaluate_tree --device-iou, 1 object x 4 views: "
          f"card {tree_card!r}, CPU {tree_cpu!r} (|diff| "
          f"{abs(tree_card - tree_cpu):.5f}, limit {lim:.5f})")
    check(abs(tree_card - tree_cpu) <= lim,
          "eval farm: --device-iou differs between the card and the CPU")


# -- the estimated-camera path -----------------------------------------------

# [cam full]: the camera net's predicted camera against the demo camera it
# is built to predict, relative to max|demo_trans_mat| (164.2): the heads'
# last kernels are zero, so their outputs are their biases exactly; what is
# left is Gram-Schmidt on an orthonormal pair and f32 products, a few ulp
# (~1e-7 on the host)
CAM_REL_TOL = 1e-5
# [cam hold]: the bundled tiny nets (float16 leaves) on the card and the CPU,
# TF32 off: f32 convolutions and matmuls summed in other orders move the
# camera by ~1e-6 of its scale
CAM_HOLD_REL = 1e-4
# their meshes at sdf_res 64: a grid value within rounding of the iso can
# take the other sign on the other device, which moves or adds the vertices
# on its edges within their cells: face counts within 2%, every vertex
# within one cell edge (2/64) of the other mesh's nearest vertex
CAM_HOLD_FACES = 0.02
CAM_HOLD_RES = 64
# [cam train]: the camera loss on the card and the CPU: a sum of squared
# differences of the predicted matrices (scale ~150) from the GT ones,
# where the encoder's summation order moves the prediction by ~1e-6
CAM_LOSS_REL = 1e-4
CAM_FARM_VIEWS = 64  # one forward of the create path
CAM_DIR = os.path.join(ROOT, "build", "chip_smoke_cam")  # removed after


def card_name() -> str:
    """nvidia-smi's name and power limit of the card, as the records keep
    them beside every time."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def cam_demo_params(cfg):
    """A full-width camera net (posenet.init, seed 0, on the card) whose
    heads predict the demo camera whatever the image: each head's last
    kernel zeroed and its bias set to scale 1, the first two columns of the
    demo view's regress_mat[:3] (orthonormal, det +1) and its translation
    minus POSENET_T_BIAS; the demo view's K is K_137. Scaffolding for the
    smoke run, like the analytic octahedron head."""
    import torch
    from disn_tpu_torch.core import camera
    from disn_tpu_torch.models import posenet

    params = posenet.init(cfg, seed=0)
    _, regress, K, _ = camera.view_params_to_trans_mat(
        45.0, 20.0, 1.1, np.zeros(3), 1.0)
    r = regress[:3].astype(np.float64)
    check(np.array_equal(K, camera.K_137)
          and np.abs(r @ r.T - np.eye(3)).max() < 1e-6
          and np.linalg.det(r) > 0,
          "the demo view's K is not K_137 or its regress_mat[:3] is not a "
          "rotation")
    heads = params["cameraprediction"]
    for name, bias in (("scale", [1.0]),
                       ("ortho6d", np.r_[regress[:3, 0], regress[:3, 1]]),
                       ("translation", regress[3] - camera.POSENET_T_BIAS)):
        fc3 = heads[name]["fc3"]
        fc3["weights"] = torch.zeros_like(fc3["weights"])
        fc3["biases"] = torch.tensor(np.asarray(bias, np.float32),
                                     device=fc3["biases"].device)
    return params


def cam_rel_err(trans: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(trans - want).max() / np.abs(want).max())


def time_posenet(params, cfg, b: int) -> float:
    """The camera net's forward (posenet.predict_trans_mat) on B seeded u8
    images on the card: CUDA events, median of 5 after a warm-up."""
    import torch
    from disn_tpu_torch.models import posenet

    img = torch.from_numpy(np.random.RandomState(b).randint(
        0, 256, (b, 137, 137, 3), dtype=np.uint8)).to(CARD)
    return median_ms(lambda: posenet.predict_trans_mat(params, img, cfg),
                     True)


def profile_posenet(params, cfg, smi: str) -> None:
    """[cam profile]: the four heads alone (posenet.apply_heads on a
    seeded embedding, CUDA events, median of 5) at B = 1 and 64, and one
    bf16 forward at B = 1 under torch.profiler (the second of two
    profiled calls): the device's busy time and idle share of the span of
    its activity, and the 5 kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType

    from disn_tpu_torch.models import posenet

    heads = params["cameraprediction"]
    for b in (1, 64):
        emb = torch.from_numpy(np.random.RandomState(b).randn(
            b, cfg.num_classes).astype(np.float32)).to(CARD)

        def run():
            with torch.no_grad():
                return posenet.apply_heads(heads, emb)["pred_RT"]

        print(f"[cam profile] the four heads alone at B={b}: "
              f"{median_ms(run, True):.4f} ms (CUDA events, median of 5); "
              f"{smi}")
    img = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (1, 137, 137, 3), dtype=np.uint8)).to(CARD)
    tdir = os.path.join(TRACE_DIR, "posenet")

    def forward():
        return posenet.predict_trans_mat(params, img, cfg)

    profiled(forward, tdir=tdir)  # the first profiled call starts the tracer
    prof, _ = profiled(forward, tdir=tdir)
    busy, window, n_ev, _ = trace_busy(tdir)
    print(f"[cam profile] one bf16 forward at B=1: device busy "
          f"{busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms span, idle share "
          f"{1 - busy / window:.4f}, {n_ev} device events; {smi}")
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    for e in sorted(rows, key=lambda e: -_device_time(e, True))[:5]:
        t = _device_time(e, True)
        print(f"[cam profile] top kernel: {e.key[:100]} {t / 1e3:.4f} ms in "
              f"{e.count} calls ({t / busy:.4f} of busy)")


def phase_cam_full(img, main_mesh, encode_ms: float, smi: str):
    """[cam full]: pipeline.reconstruct_image (the demo subcommand's body)
    on the main path's image 1 with the demo-camera net at full width and
    the analytic octahedron head, sdf_res 256, bf16, its K1 and K5 counts
    set to 0 just before and read just after; then the net's forward and
    the demo's wall time. Returns the net."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.ops import fused_decode, sparse_words

    k1 = fused_decode.fused_cell_decode
    k5 = sparse_words.sparse_cell_words
    cfg = Config(sdf_res=256, compute_dtype="bfloat16")
    sdf_params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6)
    cam = cam_demo_params(cfg)
    demo = synthetic.demo_trans_mat()
    stats: dict = {}
    torch.cuda.synchronize()
    k1.launches = k5.launches = 0
    verts, faces = pipeline.reconstruct_image(sdf_params, img, cfg,
                                              cam_params=cam, stats=stats)
    launches = (k1.launches, k5.launches)
    err = cam_rel_err(stats["trans_mat"], demo)
    print(f"[cam full] predicted camera vs the demo camera: max|diff| / "
          f"max|demo| {err:.3e} (limit {CAM_REL_TOL}); route "
          f"{stats['route']}, guard {stats.get('guard')}, words guard "
          f"{stats.get('swords_guard')}, K1 {launches[0]} and K5 "
          f"{launches[1]} launches; {len(faces)} faces, {len(verts)} verts")
    check(err <= CAM_REL_TOL, "cam full: the predicted camera is not the "
                              "demo camera")
    check(stats["route"] == "records_sparse" and stats.get("guard") == 0
          and stats.get("swords_guard", 0) == 0 and launches == (2, 1),
          "cam full: expected route records_sparse, guard 0, K1 x2, K5 x1")
    mv, mf = main_mesh
    same = (np.array_equal(faces, mf) and verts.shape == mv.shape
            and np.array_equal(verts, mv))
    print(f"[cam full] mesh equal to the main path's mesh of the image under "
          f"the demo camera (faces in order, vertices): {same}")
    check(same, "cam full: the estimated-camera mesh is not the main "
                "path's (the analytic head's field does not depend on the "
                "camera)")
    for dt, c in (("bf16", cfg), ("f32", cfg.replace(compute_dtype=
                                                     "float32"))):
        ms = {b: time_posenet(cam, c, b) for b in (1, 64)}
        print(f"[cam full] posenet forward {dt} (full width, CUDA events, "
              f"median of 5): B=1 {ms[1]:.3f} ms, B=64 {ms[64]:.3f} ms = "
              f"{ms[64] / 64:.3f} ms an image; the main path's encode_ms "
              f"(bf16, B=1) {encode_ms:.3f}; {smi}")
    profile_posenet(cam, cfg, smi)
    wall = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.reconstruct_image(sdf_params, img, cfg, cam_params=cam)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    print(f"[cam full] demo wall (posenet + image_to_mesh, bf16 257^3, host "
          f"clock, median of 3 after the gated run) {np.median(wall):.3f} "
          f"ms, all {[round(w, 3) for w in wall]}; {smi}")
    return cam, sdf_params, cfg


def phase_cam_hold(smi: str) -> None:
    """[cam hold]: the bundled tiny nets (demo/tiny_posenet.npz and
    demo/tiny_synth.npz, float16 leaves; width 0.25, 128 classes) through
    reconstruct_image on a torus view rendered in memory, sdf_res 64, TF32
    off, on the card and with device='cpu'."""
    import torch
    from disn_tpu_torch import convert
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import pipeline

    cfg = Config(width_mult=0.25, num_classes=128, sdf_res=CAM_HOLD_RES)
    cam = convert.load_npz(os.path.join(ROOT, "demo", "tiny_posenet.npz"))
    sdf = convert.load_npz(os.path.join(ROOT, "demo", "tiny_synth.npz"))
    img = np.ascontiguousarray(synthetic.render_view(
        synthetic.sdf_torus, 40.0, 25.0, 0.85)[0][:, :, :3])
    out = {}
    for dev in (CARD, "cpu"):
        stats: dict = {}
        t0 = time.perf_counter()
        mesh = pipeline.reconstruct_image(sdf["params"], img, cfg,
                                          cam_params=cam["params"],
                                          device=dev, stats=stats)
        out[dev] = (mesh, stats, (time.perf_counter() - t0) * 1e3)
    (cv, cf), cst, cms = out[CARD]
    (pv, pf), pst, pms = out["cpu"]
    rel = cam_rel_err(cst["trans_mat"], pst["trans_mat"])
    share = abs(len(cf) - len(pf)) / max(len(pf), 1)
    a, b = torch.from_numpy(cv).to(CARD), torch.from_numpy(pv).to(CARD)
    d = torch.cat([torch.cdist(a[i:i + 4096], b).min(1).values
                   for i in range(0, len(a), 4096)]).max().item()
    d = max(d, torch.cat([torch.cdist(b[i:i + 4096], a).min(1).values
                          for i in range(0, len(b), 4096)]).max().item())
    cell = 2.0 / CAM_HOLD_RES
    print(f"[cam hold] bundled nets, torus view, sdf_res {CAM_HOLD_RES}: "
          f"camera card vs cpu max|diff|/max|cpu| {rel:.3e} (limit "
          f"{CAM_HOLD_REL}); faces card {len(cf)} cpu {len(pf)} (share "
          f"{share:.4f}, limit {CAM_HOLD_FACES}); symmetric max "
          f"nearest-vertex distance {d:.3e} (limit one cell, {cell:.4f}); "
          f"routes {cst['route']} / {pst['route']}; wall card {cms:.1f} ms "
          f"(first call) cpu {pms:.1f} ms; {smi}")
    check(len(pf) > 1000 and cst["route"] == pst["route"],
          "cam hold: the CPU mesh has too few faces, or the routes differ")
    check(rel <= CAM_HOLD_REL, "cam hold: the cameras differ")
    check(share <= CAM_HOLD_FACES and d <= cell,
          "cam hold: the card's mesh is not the CPU's")


def phase_cam_train(records, smi: str) -> None:
    """[cam train]: the camera step on the card and with device='cpu' at
    width 0.25, B = 2 (shift head on, every loss term), from the same
    params and batch: the f32 losses, every gradient leaf in float64; then
    20 steps of the full-width default Config (B = 20) from a fresh seed-0
    state on one batch of the in-memory records, whose loss must fall."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.models import posenet
    from disn_tpu_torch.train import checkpoint, trainer

    cfg = Config(width_mult=0.25, num_classes=64, batch_size=2,
                 num_sample_points=256, cam_shift=True, cam_loss_mode="all")
    params = posenet.init(cfg, seed=0, device="cpu")
    batch = trainer.to_cam_batch(host_batch(cfg, records, seed=1))
    check("shifts" in batch, "cam train: the batch has no shifts")
    for dtype in ("float32", "float64"):
        c = cfg.replace(compute_dtype=dtype)
        devs = (("card", CARD), ("cpu", "cpu"))
        st = {k: trainer.create_state(c, params=params, device=d)
              for k, d in devs}
        loss = {k: trainer.compute_gradients(st[k], on(batch, d),
                                             trainer.cam_loss_fn)
                ["overall_loss"].item() for k, d in devs}
        rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
        ratios = []
        for (path, pg), (_, pc) in zip(checkpoint.leaves(st["card"].params),
                                       checkpoint.leaves(st["cpu"].params)):
            scale = max(pc.grad.abs().max().item(), 1e-30)
            ratios.append(((pg.grad.cpu() - pc.grad).abs().max().item()
                           / scale, path))
        worst = max(ratios)
        over = sum(r > HOLD_GRAD_REL for r, _ in ratios)
        print(f"[cam train] hold {dtype}: loss card {loss['card']!r} cpu "
              f"{loss['cpu']!r} rel {rel:.3e} (limit {CAM_LOSS_REL}); "
              f"gradients: worst leaf {worst[1]} max|diff|/max|grad| "
              f"{worst[0]:.3e}, {over} of {len(ratios)} leaves over "
              f"{HOLD_GRAD_REL}")
        check(rel <= CAM_LOSS_REL, f"cam train {dtype}: the loss differs")
        if dtype == "float64":
            check(over == 0, "cam train: a float64 gradient leaf differs "
                             "between the card and the CPU")
    cfg = Config()
    state = trainer.create_state(cfg, seed=0, init_fn=posenet.init)
    step = trainer.make_cam_train_step(cfg)
    batch = on(trainer.to_cam_batch(host_batch(cfg, records, seed=2)), CARD)
    losses, ms = [], []
    for _ in range(20):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        losses.append(step(state, batch)[1]["overall_loss"])
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    losses = [x.item() for x in losses]
    first, last = np.median(losses[:5]), np.median(losses[-5:])
    print(f"[cam train] full width, B = {cfg.batch_size}, f32, 20 steps on "
          f"one batch: overall_loss {[round(x, 2) for x in losses]}; median "
          f"of the first 5 {first:.2f}, of the last 5 {last:.2f}; ms/step "
          f"median of steps 3-20 {np.median(ms[2:]):.3f} (CUDA events), "
          f"all {[round(x, 2) for x in ms]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    check(all(np.isfinite(losses)) and last < first,
          "cam train: the loss did not fall over 20 steps on one batch")


def phase_cam_farm(cam, sdf_params, cfg, smi: str) -> None:
    """[cam farm]: the create path (pipeline.estimate_cameras, one forward
    of 64 in-memory views, seeded u8 RGBA images) with the demo-camera
    net, every camera within CAM_REL_TOL of the demo camera; then the first
    4 views' estimated records through reconstruct_split(cam_est=True) and
    its keyword readers (sdf_res 256, bf16, analytic head) into the
    camest_ tree: every mesh over 1000 faces."""
    import shutil

    import torch
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.data import listing, synthetic
    from disn_tpu_torch.infer import pipeline

    shutil.rmtree(CAM_DIR, ignore_errors=True)
    paths = listing.SplitPaths(os.path.join(CAM_DIR, "sdf"),
                               os.path.join(CAM_DIR, "renders_camest"))
    rng = np.random.RandomState(5)
    items = [((FARM_CAT, "cam0", v), codecs.ViewRecord(
        img_arr=rng.randint(0, 256, (137, 137, 4), dtype=np.uint8),
        trans_mat=np.zeros((4, 3), np.float32),
        K=np.eye(3, dtype=np.float32), RT=np.zeros((3, 4), np.float32),
        obj_rot_mat=np.eye(3, dtype=np.float32),
        regress_mat=np.zeros((4, 3), np.float32)))
        for v in range(CAM_FARM_VIEWS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = list(pipeline.estimate_cameras(cam, iter(items), cfg,
                                         batch=CAM_FARM_VIEWS))
    est_ms = (time.perf_counter() - t0) * 1e3
    demo = synthetic.demo_trans_mat()
    err = max(cam_rel_err(r.trans_mat, demo) for _, r in est)
    check([k for k, _ in est] == [k for k, _ in items],
          "cam farm: estimate_cameras changed the order")
    check(err <= CAM_REL_TOL, "cam farm: an estimated camera is not the "
                              "demo camera")
    views = {paths.img_path(*k): r for k, r in est[:4]}
    sdf = {paths.sdf_path(FARM_CAT, "cam0"): pipeline.UNIT_BOX}
    t0 = time.perf_counter()
    written = pipeline.reconstruct_split(
        sdf_params, cfg, paths, [k for k, _ in est[:4]], CAM_DIR,
        cam_est=True, read_view=views.__getitem__,
        read_sdf_params=sdf.__getitem__)
    rec_s = time.perf_counter() - t0
    faces = [len(codecs.read_obj(p)[1]) for p in written]
    root = pipeline.result_dir(CAM_DIR, cfg, cam_est=True)
    print(f"[cam farm] estimate_cameras: {CAM_FARM_VIEWS} views in one "
          f"forward, {est_ms:.3f} ms host clock (images from memory), worst "
          f"camera vs demo {err:.3e}; reconstruct_split(cam_est=True): "
          f"{len(written)} meshes in {rec_s:.3f} s under "
          f"{os.path.relpath(root, CAM_DIR)}, faces {faces}; {smi}")
    check(len(written) == 4 and all(p.startswith(root + os.sep)
                                    for p in written)
          and os.path.basename(root).startswith("camest_"),
          "cam farm: the meshes are not in the camest_ tree")
    check(all(f > 1000 for f in faces), "cam farm: a mesh has too few faces")
    shutil.rmtree(CAM_DIR, ignore_errors=True)


def phase_cam(records, img, main_mesh, encode_ms: float) -> None:
    import torch

    t0 = time.perf_counter()
    smi = card_name()
    cam, sdf_params, cfg = phase_cam_full(img, main_mesh, encode_ms, smi)
    phase_cam_farm(cam, sdf_params, cfg, smi)
    del cam, sdf_params
    torch.cuda.empty_cache()
    phase_cam_hold(smi)
    phase_cam_train(records, smi)
    torch.cuda.empty_cache()
    print(f"[cam] phase took {time.perf_counter() - t0:.1f} s")


# -- multi-view fusion -------------------------------------------------------

MV_VIEWS = 24  # the renders an object has in the reference's split
# [mv full], bf16: the plain decode rounds the head's output layer, 10 s
# (s = |x|+|y|+|z|, a multiple of 1/128 at grid points), to bf16, whose
# ulp near 6 is 1/32: a grid value is off the field by up to 1/64 / 10 =
# 1/640, and a vertex, interpolated along a tet edge on which the field is
# linear, by at most that. K1 computes that layer in f32 and the reference
# decodes multi-view as the port does; f32 is held to SURFACE_TOL
MV_BF16_SURFACE_TOL = SURFACE_TOL + 1.0 / 640
# [mv hold]: card against CPU, f32, TF32 off: summation order alone (the
# encoder's convolutions, the fold's matmuls and the heads), relative to
# the volume's largest value, as K1's f32 hold
MV_HOLD_REL = F32_REL_TOL
MV_HOLD = dict(width_mult=0.25, sdf_res=64, compute_dtype="float32")
MV_HOLD_VIEWS = 3
MV_CLI_DIR = os.path.join(ROOT, "build", "chip_smoke_mv")  # removed after


def mv_cameras(v: int) -> np.ndarray:
    """V cameras around the demo camera (az 45 + 360 i / V, el 20, distance
    ratio 1.1): [V,4,3]."""
    from disn_tpu_torch.core import camera
    return np.stack([camera.view_params_to_trans_mat(
        45.0 + 360.0 * i / v, 20.0, 1.1, np.zeros(3), 1.0)[0]
        for i in range(v)]).astype(np.float32)


def mv_bound(n_pts: int, views: int, dtype: str, map_bytes: int,
             weight_bytes: int) -> dict:
    """The least time the card could take for the multi-view decode of
    n_pts points: the two MLP streams (K1's work a point: k1_macs), the V x
    4 taps and the view mean (per view and channel 4 multiply-adds: the
    tap weights formed once a point and view, the view sum chained into
    the accumulator; in f32 on the FMA units, as the reference lerps a
    bf16 map in f32), and the bytes: the V maps and the weights read once,
    the values written once. bf16: the MLP on the tensor cores, the taps
    on the FMA units (either may hide the other); f32: both on the FMA
    units."""
    mlp = 2.0 * n_pts * k1_macs(1)
    taps = 8.0 * n_pts * views * 512
    if dtype == "bf16":
        parts = {"mlp": mlp / H100_BF16_FLOPS, "taps": taps / H100_F32_FLOPS}
        ops = max(parts.values())
    else:
        parts = {"mlp": mlp / H100_F32_FLOPS, "taps": taps / H100_F32_FLOPS}
        ops = sum(parts.values())
    nbytes = map_bytes + weight_bytes + 4 * n_pts
    parts["bytes"] = nbytes / H100_BYTES_PER_S
    bound = max(ops, parts["bytes"])
    by = ("bytes" if parts["bytes"] >= ops else
          "operations (" + max(("mlp", "taps"), key=parts.get) + ")")
    return {"bound_ms": bound * 1e3, "bound_by": by,
            **{f"{k}_ms": t * 1e3 for k, t in parts.items()}}


# [mv taps]: K8 timed over this many launches (CUDA events, the median);
# the plain version and the library yardstick over MV_TAPS_SLOW
MV_TAPS_REPS, MV_TAPS_SLOW = 20, 5
# under mv_edge_cameras: the last column, the last row, both, the corner
# pixel, off the image on each side (clamped), w = 0 with u, v != 0 (an
# infinite projection, clamped); MV_NAN_PT: u = v = w = 0 in view 0, a NaN
# projection (tests/mv_edge.py's EDGE_PTS)
MV_EDGE_PTS = np.array([[1, 0.25, 0], [0.25, 1, 0], [1, 1, 0],
                        [-1.125, -1.125, 0], [2, 0.5, 0], [-3, 0.5, 0],
                        [0.5, 2, 0], [0.5, -3, 0], [5, 5, 0],
                        [0.5, 0.5, -1]], np.float32)
MV_NAN_PT = np.array([[-1.125, -1.125, -1]], np.float32)
PARENT_MV: dict = {}  # another checkout's infer/multiview (--parent)


def mv_edge_cameras(v: int) -> np.ndarray:
    """w = z + 1; view i maps x = 1 to u = (64 + 8i) + (72 - 8i) = 136
    exactly, the last column (y likewise: the last row): [V,4,3]."""
    t = np.zeros((v, 4, 3), np.float32)
    for i in range(v):
        t[i, 0, 0] = t[i, 1, 1] = 64 + 8 * i
        t[i, 2, 2] = 1.0
        t[i, 3] = [72 - 8 * i, 72 - 8 * i, 1.0]
    return t


def mv_parent(root: str):
    """Another checkout's infer/multiview.py, loaded under another name (it
    imports this checkout's helpers): its _mv_decode and decode_step."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "parent_multiview",
        os.path.join(root, "disn_tpu_torch", "infer", "multiview.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def mv_route(mod=None):
    """A context in which infer/multiview decodes with `mod`'s _mv_decode
    and decode_step (another checkout's decode, its steps), or, with mod
    None, with this checkout's code; yields the list of decode steps
    taken (the points of each _mv_decode call)."""
    from disn_tpu_torch.infer import multiview
    saved = (multiview._mv_decode, multiview.decode_step)
    decode = saved[0] if mod is None else mod._mv_decode
    steps: list = []

    def counted(params, state, trans_mats, pts, cfg):
        steps.append(pts.shape[0])
        return decode(params, state, trans_mats, pts, cfg)

    multiview._mv_decode = counted
    if mod is not None:
        multiview.decode_step = mod.decode_step
    try:
        yield steps
    finally:
        multiview._mv_decode, multiview.decode_step = saved


@contextlib.contextmanager
def plain_k8():
    """A context in which the folded arm takes mv_tap_mean_plain on the
    card (the code path before K8)."""
    from disn_tpu_torch.ops import mv_taps
    saved = mv_taps.mv_tap_mean
    mv_taps.mv_tap_mean = mv_taps.mv_tap_mean_plain
    try:
        yield
    finally:
        mv_taps.mv_tap_mean = saved


def k8_differing(got, want) -> tuple[int, float]:
    """(elements whose bits differ, NaN against NaN counted equal; the
    largest |got - want| over the rest, inf where one side alone is NaN)."""
    import torch
    g, w = got.float(), want.float()
    both = torch.isnan(g) & torch.isnan(w)
    n = int(((g.view(torch.int32) != w.view(torch.int32)) & ~both).sum())
    d = torch.where(both, torch.zeros_like(g), (g - w).abs())
    err = float(d.max()) if d.numel() else 0.0
    return n, float("inf") if err != err else err


def k8_bound(merged, n_pts: int) -> tuple[float, str]:
    """K8's least time for n_pts points: 8 FLOP a view-channel on the FMA
    units (mv_bound's taps: 4 multiply-adds); the maps, the points and the
    cameras read once, the [P,512] output written once."""
    v, elt = merged.shape[0], merged.element_size()
    nbytes = merged.numel() * elt + 12 * n_pts + 48 * v + 512 * elt * n_pts
    return k_bound(nbytes, 8.0 * n_pts * v * 512)


def mv_library(merged, trans, pts):
    """torch.nn.functional.grid_sample (zeros padding, align_corners=True)
    over the V maps at the projections, then mean(0): two PyTorch calls,
    K8's yardstick (the port never calls it). grid_sample takes its grid
    in the maps' type, so a bf16 grid rounds the pixel coordinates, and an
    NCHW copy of the maps, made here and not timed. cuDNN is off for the
    call: its f32 sampler refuses this size (3.2e9 output elements), and
    PyTorch's own kernel, which bf16 takes anyway, serves both types."""
    import torch
    from disn_tpu_torch.core import camera
    v, h, w, _ = merged.shape
    px = camera.project_points(pts[None].expand(v, -1, -1), trans,
                               img_w=w, img_h=h)
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], device=px.device)
    grid = (px * scale - 1.0).to(merged.dtype)[:, None]       # [V,1,P,2]
    nchw = merged.permute(0, 3, 1, 2).contiguous()

    def call():
        with torch.backends.cudnn.flags(enabled=False):
            return torch.nn.functional.grid_sample(
                nchw, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True).mean(0)                    # [C,1,P]
    return call


def phase_mv_taps(params, smi: str) -> dict:
    """[mv taps]: K8 against mv_tap_mean_plain on the card at V = 24, 512
    channels, on the maps the full-width net folds from 24 seeded u8 views,
    in bf16 and f32, cut into the main path's decode steps: the coarse 65^3
    grid, the fine points of the object's active cells (phase_a's band cull
    of its coarse grid, cell_points), the three boundary planes, the
    hand-made edge points under mv_edge_cameras and the NaN point. Bit for
    bit, NaN where the plain version has NaN. Then, on the first coarse
    step, K8 (median of MV_TAPS_REPS on CUDA events), the plain version and
    grid_sample + mean (median of MV_TAPS_SLOW) beside K8's bound. Returns
    the kernels line's fields by type."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.core import grids
    from disn_tpu_torch.infer import fused, multiview, pipeline
    from disn_tpu_torch.ops import fused_decode, mv_taps

    t0 = time.perf_counter()
    k8 = mv_taps.mv_tap_mean
    rng = np.random.RandomState(23)
    imgs = rng.randint(0, 256, (MV_VIEWS, 137, 137, 3), dtype=np.uint8)
    dev = torch.device("cuda")
    im, tr, sp = multiview._inputs(imgs, mv_cameras(MV_VIEWS),
                                   pipeline.UNIT_BOX, dev)
    edge = torch.from_numpy(mv_edge_cameras(MV_VIEWS)).to(dev)
    out: dict = {}
    sets = None
    for label, cd in (("bf16", "bfloat16"), ("f32", "float32")):
        cfg = Config(sdf_res=256, compute_dtype=cd)
        rc = cfg.sdf_res // 4 + 1
        if sets is None:
            state, _, ids, count = multiview.phase_a(params, im, tr, sp, cfg,
                                                     4)
            fine, _ = fused_decode.cell_points(ids, rc - 1,
                                               cfg.grid_resolution, sp, 4)
            planes, _ = fused.plane_points(cfg.grid_resolution, sp)
            sets = {"coarse 65^3": (tr, grids.grid_block(sp, rc, 0, rc ** 3)),
                    f"fine ({count} active cells)": (tr, fine),
                    "boundary planes": (tr, planes),
                    "edge points": (edge, torch.from_numpy(MV_EDGE_PTS)
                                    .to(dev)),
                    "NaN point": (edge, torch.from_numpy(MV_NAN_PT).to(dev))}
        else:
            state = multiview._mv_prep(params, im, cfg)
        merged = state[1]
        step = multiview.decode_step(state, cfg)
        err, n_all = 0.0, 0
        for name, (trans, pts) in sets.items():
            n_diff, e, n_el, nan_rows = 0, 0.0, 0, 0
            for i in range(0, pts.shape[0], step):
                p = pts[i:i + step]
                got = k8(merged, trans, p)
                want = mv_taps.mv_tap_mean_plain(merged, trans, p)
                d, ei = k8_differing(got, want)
                n_diff, e, n_el = n_diff + d, max(e, ei), n_el + got.numel()
                nan_rows += int(torch.isnan(got.float()).all(1).sum())
            print(f"[mv taps] {label} {name}: {pts.shape[0]} points in "
                  f"steps of {step}, {n_diff} of {n_el} elements differ "
                  f"(bit for bit, NaN = NaN), max_abs_err {e}, rows all "
                  f"NaN {nan_rows}")
            check(n_diff == 0, f"[mv taps] {label} {name}: K8 is not its "
                               f"plain version ({n_diff} elements)")
            if name == "NaN point":
                check(nan_rows == 1, f"[mv taps] {label}: the NaN point "
                                     f"gave {nan_rows} NaN rows")
            elif name == "edge points":
                check(nan_rows == 0, f"[mv taps] {label}: NaN in the edge "
                                     f"points")
            err, n_all = max(err, e), n_all + n_diff
        trans, pts = sets["coarse 65^3"]
        p = pts[:step]
        ms = median_ms(lambda: k8(merged, trans, p), True, MV_TAPS_REPS)
        plain_ms = median_ms(
            lambda: mv_taps.mv_tap_mean_plain(merged, trans, p), True,
            MV_TAPS_SLOW)
        lib = mv_library(merged, trans, p)
        lib_ms = median_ms(lib, True, MV_TAPS_SLOW)
        lib_err = float((lib()[:, 0].t().float() - k8(merged, trans, p)
                         .float()).abs().max())
        bound_ms, bound_by = k8_bound(merged, p.shape[0])
        print(f"[mv taps] {label} timed on {p.shape[0]} coarse points (one "
              f"decode step), V = {MV_VIEWS}: K8 {ms:.4f} ms (CUDA events, "
              f"median of {MV_TAPS_REPS}), bound {bound_ms:.4f} ms "
              f"({bound_by}: 8 FLOP a view-channel at 67 TFLOP/s; maps, "
              f"points and output once), {bound_ms / ms:.4f} of it; plain "
              f"{plain_ms:.4f} ms; grid_sample + mean(0) (two PyTorch "
              f"calls, the yardstick) {lib_ms:.4f} ms, max |diff| to K8 "
              f"{lib_err:.3e}; {smi}")
        out[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": lib_ms}
        del state, merged, lib
        torch.cuda.empty_cache()
    print(f"[mv taps] phase took {time.perf_counter() - t0:.1f} s")
    return out


def mv_object(params, imgs, trans, cfg, label: str, parent=None) -> tuple:
    """pipeline.multiview_to_mesh on one object on the card, the K1, K5
    and K8 counts set to 0 just before and read just after: neither K1 nor
    K5 may run; K8 once a decode step (none with `parent`, another
    checkout's multiview module whose decode runs instead). Gates: the
    sparse flow (no cap overflow), > 1000 faces, finite vertices. Returns
    (stats, verts, faces)."""
    import torch
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.ops import fused_decode, mv_taps, sparse_words

    k1 = fused_decode.fused_cell_decode
    k5 = sparse_words.sparse_cell_words
    k8 = mv_taps.mv_tap_mean
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k5.launches = k8.launches = 0
    k8.events = []
    stats: dict = {}
    t0 = time.perf_counter()
    try:
        with mv_route(parent) as steps:
            verts, faces = pipeline.multiview_to_mesh(
                params, imgs, trans, pipeline.UNIT_BOX, cfg, stats=stats)
        stats["wall_ms"] = (time.perf_counter() - t0) * 1e3
        stats["k8_ms"] = sum(a.elapsed_time(b) for a, b in k8.events)
    finally:
        k8.events = None
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    stats.update(k1_launches=k1.launches, k5_launches=k5.launches,
                 k8_launches=k8.launches, decode_steps=len(steps),
                 faces=len(faces), verts=len(verts))
    print(f"[mv full] {label}: " + json.dumps(stats))
    check(k1.launches == 0 and k5.launches == 0,
          f"[mv full] {label}: the multi-view path launched K1 "
          f"{k1.launches} and K5 {k5.launches} times")
    want = 0 if parent is not None else len(steps)
    check(len(steps) > 0 and k8.launches == want,
          f"[mv full] {label}: K8 launched {k8.launches} times in "
          f"{len(steps)} decode steps (want {want})")
    check(not stats["dense_fallback"],
          f"[mv full] {label}: the active cells ({stats['active_cells']}) "
          f"overflowed the cap ({stats['cell_cap']}): dense fallback")
    check(len(faces) > 1000 and np.isfinite(verts).all(),
          f"[mv full] {label}: {len(faces)} faces or bad vertices")
    return stats, verts, faces


def phase_mv_full(params, main_mesh, smi: str) -> dict:
    """[mv full]: multiview_to_mesh (the body of create-sdf --multi-view)
    on V = 24 seeded u8 views of one object under 24 cameras, full-width
    VGG-16 two-stream net with the analytic octahedron head, 257^3: bf16
    the median of 3 after a warm-up, then the default Config (f32, TF32
    off) once. Every vertex on |x|+|y|+|z| = 0.6 (f32 within SURFACE_TOL,
    bf16 within MV_BF16_SURFACE_TOL), the faces those of the main path's
    volume-flow mesh of the same field. Stage times, peak memory, active
    cells, decode steps, K8's time; the decode beside its bound; with
    --parent, bf16 objects in turns with that checkout's decode (parent,
    change, change, parent); one bf16 object under torch.profiler (device
    kernels, launches, the idle share; no nan_to_num kernel and no gather
    of the bf16 maps: the plain resampler's), its K8 launches' inputs kept
    through mv_tap_mean.inputs and K8 held bit for bit against the plain
    version on each of them afterwards.
    Returns (K8's launches an object by type, that hold's max_abs_err)."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.models import layers
    from disn_tpu_torch.ops import mv_taps

    cfg = Config(sdf_res=256, compute_dtype="bfloat16")
    trans = mv_cameras(MV_VIEWS)
    rng = np.random.RandomState(13)
    n_weights = sum(layers.param_count(params[k]) for k in
                    ("sdfprediction", "sdfprediction_imgfeat"))
    weight_bytes = {"bf16": 2 * n_weights, "f32": 4 * n_weights}
    runs = {"bf16": [], "f32": []}
    for label, c, reps in (("bf16", cfg, 4), ("f32", Config(sdf_res=256),
                                              1)):
        for rep in range(reps):
            imgs = rng.randint(0, 256, (MV_VIEWS, 137, 137, 3),
                               dtype=np.uint8)
            stats, verts, faces = mv_object(params, imgs, trans, c,
                                            f"{label} object {rep}")
            dist = np.abs(np.abs(verts).sum(1) - 0.6)
            tol = MV_BF16_SURFACE_TOL if label == "bf16" else SURFACE_TOL
            same = np.array_equal(faces, main_mesh[1])
            print(f"[mv full] {label} object {rep}: vertices off the "
                  f"surface by {dist.max():.3e} (tolerance {tol:.3e}); faces "
                  f"equal to the main path's volume-flow mesh: {same} "
                  f"({len(faces)} against {len(main_mesh[1])})")
            check(float(dist.max()) <= tol,
                  f"[mv full] {label}: a vertex is {dist.max():.3e} off the "
                  f"surface")
            check(same, f"[mv full] {label}: the faces are not the main "
                        f"path's")
            if label == "f32" or rep > 0:
                runs[label].append(stats)
    n_pts = (cfg.sdf_res // 4 + 1) ** 3 + 64 * runs["bf16"][0]["active_cells"]
    for label, timed in runs.items():
        keys = ("encode_ms", "prep_ms", "phase_a_ms", "finish_ms", "k8_ms",
                "extraction_ms", "wall_ms", "peak_gib")
        for key in keys:
            vals = [r[key] for r in timed]
            print(f"[mv full] {label} {key} median={np.median(vals):.3f} "
                  f"all={[round(v, 3) for v in vals]}")
        decode = [r["phase_a_ms"] + r["finish_ms"] for r in timed]
        map_bytes = MV_VIEWS * 137 * 137 * 512 * (2 if label == "bf16" else 4)
        b = mv_bound(n_pts, MV_VIEWS, label, map_bytes, weight_bytes[label])
        print(f"[mv full] {label} decode (phase_a + finish) per object: "
              f"median {np.median(decode):.3f} ms, all "
              f"{[round(v, 3) for v in decode]}; {n_pts} points "
              f"({timed[0]['active_cells']} active cells) in "
              f"{timed[0]['decode_steps']} decode steps, K8 launches "
              f"{timed[0]['k8_launches']}; bound "
              f"{json.dumps({k: round(v, 5) if isinstance(v, float) else v for k, v in b.items()})}; "
              f"share of the bound {b['bound_ms'] / np.median(decode):.5f}; "
              f"wall {np.median([r['wall_ms'] for r in timed]):.3f} ms, the "
              f"decode's share {np.median(decode) / np.median([r['wall_ms'] for r in timed]):.4f}; "
              f"peak {np.median([r['peak_gib'] for r in timed]):.3f} GiB; {smi}")
    if PARENT_MV:
        turns_mv: dict = {"parent": [], "change": []}
        for arm in ("parent", "change", "change", "parent"):
            imgs = rng.randint(0, 256, (MV_VIEWS, 137, 137, 3),
                               dtype=np.uint8)
            stats, _, faces = mv_object(
                params, imgs, trans, cfg, f"bf16 {arm} turn",
                parent=PARENT_MV["mod"] if arm == "parent" else None)
            check(np.array_equal(faces, main_mesh[1]),
                  f"[mv full] {arm} turn: the faces are not the main path's")
            turns_mv[arm].append(stats)
        for arm, rs in turns_mv.items():
            print(f"[mv full] bf16 in turns, {arm}: decode "
                  f"{[round(r['phase_a_ms'] + r['finish_ms'], 3) for r in rs]}"
                  f" ms, wall {[round(r['wall_ms'], 3) for r in rs]} ms, "
                  f"peak {[round(r['peak_gib'], 3) for r in rs]} GiB, decode "
                  f"steps {[r['decode_steps'] for r in rs]}, K8 launches "
                  f"{[r['k8_launches'] for r in rs]}; {smi}")
        peak = {arm: max(r["peak_gib"] for r in rs)
                for arm, rs in turns_mv.items()}
        check(peak["change"] <= peak["parent"],
              f"[mv full] the peak memory rose: {peak['change']:.3f} GiB "
              f"against the parent's {peak['parent']:.3f}")
    imgs = rng.randint(0, 256, (MV_VIEWS, 137, 137, 3), dtype=np.uint8)
    tdir = os.path.join(TRACE_DIR, "mv")
    k8 = mv_taps.mv_tap_mean
    held: list = []   # the profiled object's K8 launches: (args, kwargs)

    def one():
        held.clear()
        return pipeline.multiview_to_mesh(params, imgs, trans,
                                          pipeline.UNIT_BOX, cfg)

    k8.inputs = held
    try:
        prof, _ = profiled(one, want=("mv_taps_kernel",), tdir=tdir)
    finally:
        k8.inputs = None
    busy, window, n_ev, syncs = trace_busy(tdir)
    launches = sum(1 for e in prof.events() if "LaunchKernel" in e.name)
    print(f"[mv profile] one bf16 object under torch.profiler: {n_ev} device "
          f"events (kernels, copies, memsets), {launches} kernel launch "
          f"calls, busy {busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms span, "
          f"idle share {1 - busy / window:.4f}, {syncs} host "
          f"synchronisations")
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    for e in sorted(rows, key=lambda e: -_device_time(e, True))[:6]:
        t = _device_time(e, True)
        print(f"[mv profile] top kernel: {e.key[:100]} {t / 1e3:.3f} ms in "
              f"{e.count} launches ({t / busy:.4f} of busy)")
    # the plain resampler's hallmarks: nan_to_num, and gathers of the bf16
    # maps' 2-byte elements (the 4-byte gathers are finish's upsample,
    # index_select on the f32 coarse grid)
    gathers = [(e.key[:120], e.count) for e in rows
               if "scatter_gather" in e.key]
    print(f"[mv profile] gather kernels on the card: {gathers}")
    plain = [e.key for e in rows if "nan_to_num" in e.key
             or ("scatter_gather" in e.key and "OpaqueType<2>" in e.key)]
    check(not plain, f"[mv profile] the plain resampler's kernels ran on the "
                     f"card: {plain}")
    n_diff, err, n_el = 0, 0.0, 0
    for args, kw in held:
        d, e = k8_differing(k8(*args, **kw),
                            mv_taps.mv_tap_mean_plain(*args, **kw))
        n_diff, err, n_el = n_diff + d, max(err, e), n_el + args[2].numel()
    print(f"[mv full] K8 on the profiled object's own {len(held)} decode "
          f"steps ({n_el // 3} points, kept through mv_tap_mean.inputs) "
          f"against mv_tap_mean_plain: {n_diff} elements differ (bit for "
          f"bit, NaN = NaN), max_abs_err {err}")
    check(len(held) > 0 and n_diff == 0,
          f"[mv full] K8 is not its plain version on the main path's "
          f"inputs ({n_diff} elements in {len(held)} steps)")
    held.clear()
    return ({label: timed[0]["k8_launches"] for label, timed in runs.items()},
            err)


def mv_rel(got, want) -> float:
    """max|got - want| / max|want| of two tensors (on any devices)."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def mv_explained(vol_c, tau: float, ids_a, ids_b, mode: str,
                 tol: float) -> bool:
    """Whether two active-cell sets of (nearly) one coarse grid differ only
    in cells that a value within `tol` of a threshold decides: a corner
    with |v| or ||v| - tau| within tol ('band'), or such a corner in the
    cell's 3^3 neighbourhood ('sign')."""
    import torch
    from disn_tpu_torch.infer import sparse
    corners = sparse._corners(vol_c.double().cpu())
    near = ((corners.abs() <= tol)
            | ((corners.abs() - float(tau)).abs() <= tol)).any(0)
    if mode == "sign":
        c = near.shape[0]
        p = torch.nn.functional.pad(near, (1, 1, 1, 1, 1, 1))
        near = torch.zeros_like(near)
        for dz in range(3):
            for dy in range(3):
                for dx in range(3):
                    near |= p[dz:dz + c, dy:dy + c, dx:dx + c]
    diff = set(ids_a.cpu().tolist()) ^ set(ids_b.cpu().tolist())
    flat = near.reshape(-1)
    return all(bool(flat[i]) for i in diff)


def mv_hold_sparse(tag: str, params, imgs, trans, cfg) -> None:
    """The sparse flow's two phases on the card against the CPU: phase_a's
    coarse grid within MV_HOLD_REL, its active cells equal (or differing
    only where a value within MV_HOLD_REL of the scale decides them); then
    finish on the card from the CPU's coarse grid and cells against the
    CPU's finish, within MV_HOLD_REL."""
    import torch
    from disn_tpu_torch import device as device_mod
    from disn_tpu_torch.infer import multiview, pipeline
    from disn_tpu_torch.infer import sparse

    out = {}
    for name in ("cuda", "cpu"):
        dev = torch.device(name)
        p = device_mod.tree_to(params, dev)
        im, tr, sp = multiview._inputs(imgs, trans, pipeline.UNIT_BOX, dev)
        out[name] = (p, tr, sp, *multiview.phase_a(p, im, tr, sp, cfg, 4))
    (pg, trg, spg, state_g, vol_g, ids_g, n_g) = out["cuda"]
    (pc, trc, spc, state_c, vol_cc, ids_c, n_c) = out["cpu"]
    rel_c = mv_rel(vol_g, vol_cc)
    rc = vol_cc.shape[0]
    tau = float(sparse._band_tau(vol_cc, spc, rc, multiview.BAND_FACTOR,
                                 cfg))
    mode = "sign" if cfg.binary else "band"
    tol = MV_HOLD_REL * float(vol_cc.abs().max())
    same = torch.equal(ids_g.cpu(), ids_c)
    explained = same or mv_explained(vol_cc, tau, ids_g, ids_c, mode, tol)
    fine_g = multiview.finish(pg, state_g, vol_cc.cuda(), ids_c.cuda(), trg,
                              spg, cfg, 4)
    fine_c = multiview.finish(pc, state_c, vol_cc, ids_c, trc, spc, cfg, 4)
    rel_f = mv_rel(fine_g, fine_c)
    print(f"[mv hold] {tag} ({mode} cull): phase_a coarse grid card vs CPU "
          f"{rel_c:.3e} of max|v| (tolerance {MV_HOLD_REL:.0e}); active cells "
          f"card {n_g} CPU {n_c}, equal {same}, differences explained "
          f"{explained}; finish from the CPU's cells {rel_f:.3e}")
    check(rel_c <= MV_HOLD_REL and explained and rel_f <= MV_HOLD_REL,
          f"[mv hold] {tag}: the card's sparse flow is not the CPU's")


def phase_mv_hold(smi: str) -> None:
    """[mv hold]: the multi-view flow on the card against the same code on
    the CPU, width 0.25, V = 3, sdf_res 64, f32, TF32 off, random seeded
    params (the local stream live): the dense stream on the folded arm
    (tf1) and the general arm (native); the sparse flow's phases (band cull)
    on both arms and with a binary head (the dilated sign cull); the dense
    fallback forced by a tiny cell cap (None on both devices); and on the
    card, the analytic head's sparse mesh against its dense mesh."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import multiview, pipeline
    from disn_tpu_torch.models import disn

    t0 = time.perf_counter()
    rng = np.random.RandomState(17)
    imgs = rng.randint(0, 256, (MV_HOLD_VIEWS, 137, 137, 3), dtype=np.uint8)
    trans = mv_cameras(MV_HOLD_VIEWS)
    box = pipeline.UNIT_BOX
    for sampling in ("tf1", "native"):
        cfg = Config(**MV_HOLD, sampling=sampling)
        params = disn.init(cfg, seed=3, device="cpu")
        vols = {d: multiview.multiview_sdf(params, imgs, trans, box, cfg,
                                           device=d) for d in ("cuda", "cpu")}
        rel = mv_rel(vols["cuda"], vols["cpu"])
        print(f"[mv hold] {sampling} arm, dense stream at sdf_res "
              f"{cfg.sdf_res}: card vs CPU {rel:.3e} of max|v| "
              f"{float(vols['cpu'].abs().max()):.4f} (tolerance "
              f"{MV_HOLD_REL:.0e})")
        check(rel <= MV_HOLD_REL, f"[mv hold] {sampling}: the card's dense "
                                  f"volume is not the CPU's")
        mv_hold_sparse(f"{sampling} arm", params, imgs, trans, cfg)
        for d in ("cuda", "cpu"):
            st: dict = {}
            tiny = multiview.multiview_sdf_sparse(
                params, imgs, trans, box, cfg, block=64, cell_cap_frac=0.0,
                device=d, stats=st)
            print(f"[mv hold] {sampling} arm on {d}, cell cap "
                  f"{st['cell_cap']} against {st['active_cells']} active "
                  f"cells: the sparse flow gives None ({tiny is None}), so "
                  f"the dense fallback (held above) is taken")
            check(tiny is None, f"[mv hold] {sampling}: a tiny cap did not "
                                f"force the dense fallback on {d}")
    cfg = Config(**MV_HOLD, binary=True)
    mv_hold_sparse("binary head", disn.init(cfg, seed=4, device="cpu"), imgs,
                   trans, cfg)
    # a random net's band holds every coarse cell; the analytic head with
    # a live local stream (its output layer seeded random, small) is an
    # octahedron moved by the images, whose band holds part of them
    cfg = Config(**MV_HOLD)
    params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6,
                                                  device="cpu")
    last = params["sdfprediction_imgfeat"]["fold2"]["conv5"]
    last["weights"] = torch.from_numpy(0.02 * np.random.RandomState(5).randn(
        *last["weights"].shape).astype(np.float32))
    mv_hold_sparse("analytic head, live local stream", params, imgs, trans,
                   cfg)
    params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6)
    dense = multiview.multiview_sdf(params, imgs, trans, box, cfg)
    # at sdf_res 64 the band holds ~40% of the coarse cells: a roomy cap
    sparse = multiview.multiview_sdf_sparse(params, imgs, trans, box, cfg,
                                            cell_cap_frac=0.9)
    check(sparse is not None, "[mv hold] the analytic head overflowed the "
                              "cap")
    dv, df = pipeline.volume_to_mesh(dense, box)
    sv, sf = pipeline.volume_to_mesh(sparse, box)
    same = np.array_equal(sf, df) and sv.shape == dv.shape
    dvert = float(np.abs(sv - dv).max()) if same else float("inf")
    print(f"[mv hold] analytic head on the card, sdf_res {cfg.sdf_res}: "
          f"sparse vs dense mesh faces equal {same} ({len(sf)} faces), "
          f"vertices max diff {dvert:.3e} (tolerance 1e-6); phase took "
          f"{time.perf_counter() - t0:.1f} s; {smi}")
    check(same and dvert <= 1e-6 and len(sf) > 1000,
          "[mv hold] the sparse mesh is not the dense one")
    torch.cuda.empty_cache()
    mv_hold_k8_decode(smi)


def mv_hold_k8_decode(smi: str) -> None:
    """[mv hold] bf16 at V = 24, full width: _mv_decode on the coarse 65^3
    grid of a random seeded net (the local stream live) in the decode's
    steps with K8, against the same steps with mv_tap_mean_plain, both on
    the card. Held in bf16 bit for bit (a tolerance of 0 ulps): K8 is its
    plain version bit for bit, and the MLP runs the same ops on the same
    shapes."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.core import grids
    from disn_tpu_torch.infer import multiview, pipeline
    from disn_tpu_torch.models import disn

    cfg = Config(sdf_res=256, compute_dtype="bfloat16")
    params = disn.init(cfg, seed=6)
    rng = np.random.RandomState(29)
    imgs = rng.randint(0, 256, (MV_VIEWS, 137, 137, 3), dtype=np.uint8)
    im, tr, sp = multiview._inputs(imgs, mv_cameras(MV_VIEWS),
                                   pipeline.UNIT_BOX, torch.device("cuda"))
    state = multiview._mv_prep(params, im, cfg)
    rc = cfg.sdf_res // 4 + 1
    pts = grids.grid_block(sp, rc, 0, rc ** 3)
    step = multiview.decode_step(state, cfg)
    got, want = [], []
    for i in range(0, pts.shape[0], step):
        got.append(multiview._mv_decode(params, state, tr, pts[i:i + step],
                                        cfg))
        with plain_k8():
            want.append(multiview._mv_decode(params, state, tr,
                                             pts[i:i + step], cfg))
    got, want = torch.cat(got), torch.cat(want)
    n_diff, err = k8_differing(got, want)
    print(f"[mv hold] bf16 V = {MV_VIEWS} full width, random net: _mv_decode "
          f"on the coarse {rc}^3 grid in steps of {step}, K8 against the "
          f"plain version on the card: {n_diff} of {got.numel()} values "
          f"differ, max |diff| {err:.3e} (max|v| "
          f"{float(want.float().abs().max()):.4f}; tolerance 0: bit for "
          f"bit); {smi}")
    check(got.dtype == torch.bfloat16 and n_diff == 0
          and bool(torch.isfinite(got.float()).all()),
          "[mv hold] the bf16 decode with K8 is not the plain version's")
    del params, state
    torch.cuda.empty_cache()


def phase_mv_cli(smi: str) -> None:
    """[mv cli]: `create-sdf --multi-view` through the port's CLI on the
    card, on a temporary split (2 objects x 3 views of seeded u8 images
    under mv_cameras, filelists on disk) and a width-0.25 checkpoint of the
    analytic head written with the port's checkpoint module; the card's
    machine has no h5py, so the command reads the views and sdf_params
    through core/codecs' readers, replaced for the call by in-memory ones.
    Each object's {cat}_{obj}_fused.obj must be written under
    test_objs/{R}_{iso}_mv/ with > 1000 faces."""
    import shutil

    from disn_tpu_torch import cli
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.data import listing, synthetic
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.train import checkpoint

    shutil.rmtree(MV_CLI_DIR, ignore_errors=True)
    cat, objs, views = "synthcat", ("obj_a", "obj_b"), 3
    kw = dict(width_mult=0.25, sdf_res=64, view_num=views)
    data = os.path.join(MV_CLI_DIR, "data")
    os.makedirs(os.path.join(data, "filelists"))
    with open(os.path.join(data, "filelists", f"{cat}_test.lst"), "w") as f:
        f.write("\n".join(objs) + "\n")
    ckpt = os.path.join(MV_CLI_DIR, "analytic.npz")
    checkpoint.save(ckpt, synthetic.analytic_octahedron_params(
        Config(**kw), seed=0, r=0.6, device="cpu"))
    paths = listing.SplitPaths(os.path.join(data, "sdf"),
                               os.path.join(data, "renders"))
    rng = np.random.RandomState(19)
    trans = mv_cameras(views)
    records = {paths.img_path(cat, o, v): codecs.ViewRecord(
        img_arr=rng.randint(0, 256, (137, 137, 4), dtype=np.uint8),
        trans_mat=trans[v], K=np.eye(3, dtype=np.float32),
        RT=np.zeros((3, 4), np.float32),
        obj_rot_mat=np.eye(3, dtype=np.float32),
        regress_mat=np.zeros((4, 3), np.float32))
        for o in objs for v in range(views)}
    readers = {"read_view_h5": records.__getitem__,
               "read_sdf_params": lambda path: pipeline.UNIT_BOX}
    saved = {k: getattr(codecs, k) for k in readers}
    t0 = time.perf_counter()
    try:
        for k, fn in readers.items():
            setattr(codecs, k, fn)
        cli.main(["create-sdf", "--multi-view", "--data-root", data,
                  "--restore", ckpt, "--log-dir", MV_CLI_DIR]
                 + [x for k, v in kw.items() for x in ("--set", f"{k}={v}")])
    finally:
        for k, fn in saved.items():
            setattr(codecs, k, fn)
    secs = time.perf_counter() - t0
    root = os.path.join(MV_CLI_DIR, "test_objs", "65_0.0_mv", cat)
    faces = []
    for o in objs:
        path = os.path.join(root, f"{cat}_{o}_fused.obj")
        check(os.path.exists(path), f"[mv cli] {path} was not written")
        faces.append(len(codecs.read_obj(path)[1]))
    print(f"[mv cli] create-sdf --multi-view on the card: {len(objs)} "
          f"objects x {views} views fused in {secs:.3f} s into "
          f"{os.path.relpath(root, MV_CLI_DIR)}/, faces {faces}; {smi}")
    check(all(f > 1000 for f in faces), "[mv cli] a mesh has too few faces")
    shutil.rmtree(MV_CLI_DIR, ignore_errors=True)


def phase_mv(main_mesh) -> dict:
    """[mv taps], [mv full], [mv hold], [mv cli]; returns K8's fields of
    the kernels line by type, with its launches an object."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    smi = card_name()
    params = synthetic.analytic_octahedron_params(
        Config(sdf_res=256, compute_dtype="bfloat16"), seed=0, r=0.6)
    k8 = phase_mv_taps(params, smi)
    launches, held_err = phase_mv_full(params, main_mesh, smi)
    for label, n in launches.items():
        k8[label]["launches"] = n
    k8["bf16"]["max_abs_err"] = max(k8["bf16"]["max_abs_err"], held_err)
    del params
    torch.cuda.empty_cache()
    phase_mv_hold(smi)
    phase_mv_cli(smi)
    print(f"[mv] phase took {time.perf_counter() - t0:.1f} s")
    return k8


def mv_entries(k8: dict) -> list[dict]:
    """K8 in the kernels line: bf16's launch at the main path's largest
    step ([mv taps]) and launches an object ([mv full]); f32's beside."""
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    return [{"name": "mv_tap_mean", "route": "cuda",
             "source": "disn_tpu_torch/csrc/mv_taps.cu",
             "replaces": "disn_tpu/infer/multiview.py:111-119",
             **{k: k8["bf16"][k] for k in keys},
             "max_abs_err": max(r["max_abs_err"] for r in k8.values()),
             "f32": {k: k8["f32"][k] for k in keys}}]


# ---- the other heads: binary and tanh, onestream, global, 3D-CNN, the
# unfolded forward pass and fold modes, the train-time dump ----
VAR_DIR = os.path.join(ROOT, "build", "chip_smoke_var")  # removed after
# [var ...] card against CPU (f32, TF32 off): summation order alone,
# relative to the volume's largest value, as K1's f32 hold
VAR_HOLD_REL = F32_REL_TOL
VAR_HOLD = dict(width_mult=0.25, sdf_res=64, compute_dtype="float32")
# [var binary]: the K1 launch of the exact dense route is held against the
# plain version on every VAR_K1_SUBSET-th of its 262,144 cells (the plain
# version of all of them would take ~2 s in bf16)
VAR_K1_SUBSET = 16


def binary_edge_tol(step: float) -> float:
    """How far off the surface |x|+|y|+|z| = r a vertex of the binary
    head's mesh may lie, from the field's shape alone. The field (sigmoid(
    10(s - r)) - 0.5) / 10 = tanh(5(s - r)) / 20 is monotone in s =
    |x|+|y|+|z| (its zero set is the surface) but not linear: the extractor
    interpolates it linearly along a tet edge, on which s is linear (grid
    points lie on the coordinate planes, so no edge crosses one) and spans
    at most 3 grid steps (the space diagonal). With the crossing a in s
    below one end and b above the other (a + b = D <= 3 step), the vertex
    sits at s = r - a + D g(a) / (g(a) + g(b)), g = tanh(5 x); the bound is
    the largest |D g(a) / (g(a) + g(b)) - a| over a in [0, D], for every D
    up to 3 steps (the error grows with D)."""
    d = 3.0 * step
    a = np.linspace(0.0, d, 100_001)
    g = np.tanh(5.0 * a), np.tanh(5.0 * (d - a))
    return float(np.abs(d * g[0] / (g[0] + g[1]) - a).max())


def var_image(cfg, params, img, trans, label: str, keep: bool = False
              ) -> tuple[dict, np.ndarray, np.ndarray, list]:
    """image_to_mesh on the card, K1's launches timed by its events; the
    launch inputs when `keep`. Returns (stats, verts, faces, inputs)."""
    import torch
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.ops import fused_decode, sparse_words

    k1 = fused_decode.fused_cell_decode
    k5 = sparse_words.sparse_cell_words
    stats: dict = {}
    torch.cuda.synchronize()
    before = (k1.launches, k5.launches)
    k1.events, k1.inputs = [], ([] if keep else None)
    t0 = time.perf_counter()
    verts, faces = pipeline.image_to_mesh(params, img, trans, cfg,
                                          stats=stats)
    stats["wall_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    stats["k1_ms"] = sum(a.elapsed_time(b) for a, b in k1.events)
    inputs = k1.inputs or []
    k1.events = k1.inputs = None
    stats.update(k1_launches=k1.launches - before[0],
                 k5_launches=k5.launches - before[1], faces=len(faces),
                 verts=len(verts))
    print(f"[var {label}] " + json.dumps(stats))
    check(len(faces) > 1000 and np.isfinite(verts).all(),
          f"[var {label}]: {len(faces)} faces or bad vertices")
    return stats, verts, faces, inputs


def print_stages(tag: str, runs: list[dict], keys: tuple) -> None:
    """The median (and all values) of each stage over `runs`."""
    for key in keys:
        vals = [r.get(key, float("nan")) for r in runs]
        print(f"{tag} {key} median={np.median(vals):.3f} "
              f"all={[round(v, 3) for v in vals]}")


def phase_var_binary(smi: str) -> dict:
    """[var binary]: the analytic octahedron's binary head (logits (0,
    10(s - r))), full width, 257^3: the default exact dense route (K1 with
    out_dim 2 over all 262,144 cells, the planes by the plain decode, the
    whole volume to the extractor) and the binary_sparse route (the sign
    cull), each on a warm-up and 3 bf16 images and one f32 image, the K1
    and K5 counts set to 0 just before each route and read just after.
    Gates: the launches (1 an image dense, 2 sparse), the routes' faces
    equal image by image, vertices on the surface within SURFACE_TOL +
    binary_edge_tol (+ the records' u8 step on records_sparse); then K1
    on the dense launch's own inputs against its plain version (a subset
    of the cells) and the whole launch timed beside its bound. Returns
    the K1 hold results by type."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.ops import fused_decode, sparse_words

    k1 = fused_decode.fused_cell_decode
    k5 = sparse_words.sparse_cell_words
    cfg = Config(sdf_res=256, compute_dtype="bfloat16", binary=True)
    R = cfg.grid_resolution
    params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6)
    rng = np.random.RandomState(23)
    imgs = [rng.randint(0, 256, (137, 137, 3), dtype=np.uint8)
            for _ in range(5)]
    trans = synthetic.demo_trans_mat()
    edge = binary_edge_tol(2.0 / (R - 1))
    quant = 3 * 2.0 / (R - 1) / 510
    print(f"[var binary] vertex tolerance: SURFACE_TOL {SURFACE_TOL:.1e} + "
          f"the field's curvature along an edge {edge:.4e} (+ {quant:.4e} "
          f"on records_sparse)")
    meshes, kept, runs = {}, {}, {}
    for route, rcfg in (("dense", cfg),
                        ("sparse", cfg.replace(binary_sparse=True))):
        torch.cuda.synchronize()
        k1.launches = k5.launches = 0
        runs[route] = []
        for i, img in enumerate(imgs):
            c = rcfg if i < 4 else rcfg.replace(compute_dtype="float32")
            dt = "bf16" if i < 4 else "f32"
            keep = route == "dense" and i in (1, 4)
            stats, verts, faces, inputs = var_image(
                c, params, img, trans, f"binary {route} {dt} image {i}",
                keep)
            if keep:
                kept[dt] = inputs[0]
            want_route = ("tets",) if route == "dense" else (
                "records_sparse", "owned_ids")
            want_k1 = 1 if route == "dense" else 2
            check(stats["route"] in want_route
                  and stats["k1_launches"] == want_k1
                  and stats["k5_launches"] == int(
                      stats["route"] == "records_sparse"),
                  f"[var binary] {route} image {i}: route {stats['route']} "
                  f"with {stats['k1_launches']} K1 and "
                  f"{stats['k5_launches']} K5 launches")
            if route == "sparse":
                check(not stats["dense_fallback"], "[var binary] the sign "
                      "cull's cells overflowed the cap")
            tol = SURFACE_TOL + edge + (
                quant if stats["route"] == "records_sparse" else 0.0)
            dist = float(np.abs(np.abs(verts).sum(1) - 0.6).max())
            stats["max_surface_dist"] = dist
            check(dist <= tol, f"[var binary] {route} image {i}: a vertex is "
                               f"{dist:.3e} off the surface ({tol:.3e})")
            meshes[(route, i)] = (verts, faces, stats["route"])
            runs[route].append(stats)
        print(f"[var binary] {route} route: {k1.launches} K1 and "
              f"{k5.launches} K5 launches (counts set to 0 before it); "
              f"{smi}")
        check(k1.launches == want_k1 * len(imgs),
              f"[var binary] {route}: {k1.launches} K1 launches")
    for i in range(len(imgs)):
        dv, df, _ = meshes[("dense", i)]
        sv, sf, sroute = meshes[("sparse", i)]
        same = np.array_equal(sf, df) and sv.shape == dv.shape
        bound = (2.0 / (R - 1) / 510 if sroute == "records_sparse"
                 else 0.0) + 1e-6
        diff = float(np.abs(sv - dv).max()) if same else float("inf")
        print(f"[var binary] image {i}: dense vs binary_sparse ({sroute}) "
              f"faces equal {same} ({len(df)} faces), vertices max diff "
              f"{diff:.3e} (bound {bound:.3e})")
        check(same and diff <= bound,
              f"[var binary] image {i}: the routes' meshes differ")
    print_stages("[var binary dense bf16]", runs["dense"][1:4],
                 ("wall_ms", "k1_ms", "extraction_ms"))
    print_stages("[var binary sparse bf16]", runs["sparse"][1:4],
                 ("wall_ms", "encode_ms", "prep_ms", "phase_a_ms",
                  "phase_b_ms", "scan_ms", "extraction_ms", "k1_ms",
                  "active_cells", "fine_cells"))
    for route in ("dense", "sparse"):
        for dt, rs in (("bf16", runs[route][1:4]), ("f32", runs[route][4:])):
            share = np.median([r["k1_ms"] / r["wall_ms"] for r in rs])
            print(f"[var binary {route} {dt}] wall "
                  f"{np.median([r['wall_ms'] for r in rs]):.3f} ms, K1 "
                  f"{np.median([r['k1_ms'] for r in rs]):.3f} ms, K1 share "
                  f"of the wall {share:.4f}")
    res = {}
    for dt in ("bf16", "f32"):
        args, kw = kept[dt]
        sub = (*args[:4], args[4][::VAR_K1_SUBSET].contiguous())
        res[dt] = hold_k1(f"{dt} binary dense launch, every "
                          f"{VAR_K1_SUBSET}th cell", sub, kw)
        full_ms = cuda_ms(lambda: k1(*args, **kw), 3)
        bound_ms, bound_by = k1_bound(args, kw)
        res[dt].update(full_ms=full_ms, full_bound_ms=bound_ms)
        print(f"[var binary k1] {dt} out_dim 2, the dense launch of "
              f"{args[4].numel()} cells: {full_ms:.4f} ms against its bound "
              f"{bound_ms:.4f} ms ({bound_by}, k1_macs(2) = {k1_macs(2)} a "
              f"point) = {bound_ms / full_ms:.4f}; {smi}")
    return res


def var_analytic_params(cfg):
    """The analytic octahedron head (10 (|x|+|y|+|z| - 0.6)) in cfg's
    variant, so that the band cull engages as on the main path: the
    twostream fixture's global stream, copied into `sdfprediction`
    (global) or into `sdfimgfeat` (onestream: the rows of fold2/conv1 past
    the point part are zero, so the embedding and the local features add
    nothing). Smoke-run scaffolding, not a package feature."""
    import torch
    from disn_tpu_torch.config import Variant
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.models import disn

    src = synthetic.analytic_octahedron_params(
        cfg.replace(variant=Variant.TWOSTREAM), seed=0, r=0.6)
    params = disn.init(cfg, seed=0)
    if cfg.variant is Variant.GLOBAL:
        params["sdfprediction"] = src["sdfprediction"]
        return params
    head = params["sdfimgfeat"]
    for fold, layers in src["sdfprediction"].items():
        for name, leaf in layers.items():
            w = leaf["weights"]
            if (fold, name) == ("fold2", "conv1"):
                w = torch.zeros_like(head[fold][name]["weights"])
                w[:512] = leaf["weights"][:512]
            head[fold][name] = {"weights": w, "biases": leaf["biases"]}
    return params


def var_bound(n_pts: int, cfg, dtype: str) -> dict:
    """The least time the card could take for the plain decode of n_pts
    points by cfg's point MLP (global: 3 -> 64 -> 256 -> 512, ++ the 1024
    embedding -> 512 -> 256 -> 1; onestream: ++ 1024 + 448), its tf1
    samples (onestream: per point and channel of the three maps, 16 taps:
    16 multiply-adds and the lerps' 8, in f32 on the FMA units, as
    resize_then_sample gathers) and the bytes (the endpoint maps and the
    weights read once, the values written once). bf16: the MLP on the
    tensor cores, the taps on the FMA units; f32: both on the FMA units."""
    from disn_tpu_torch.config import Variant

    extra = cfg.num_classes + (cfg.local_feat_dim
                               if cfg.variant is Variant.ONESTREAM else 0)
    macs = (3 * 64 + 64 * 256 + 256 * 512 + (512 + extra) * 512
            + 512 * 256 + 256)
    mlp = 2.0 * n_pts * macs
    taps = (24.0 * n_pts * cfg.local_feat_dim
            if cfg.variant is Variant.ONESTREAM else 0.0)
    fast = H100_BF16_FLOPS if dtype == "bf16" else H100_F32_FLOPS
    parts = {"mlp": mlp / fast, "taps": taps / H100_F32_FLOPS}
    ops = max(parts.values()) if dtype == "bf16" else sum(parts.values())
    esize = 2 if dtype == "bf16" else 4
    maps = sum(s * s * c for s, c in ((224, 64), (112, 128), (56, 256))) \
        if cfg.variant is Variant.ONESTREAM else 0
    nbytes = esize * (maps + macs) + 4 * n_pts
    parts["bytes"] = nbytes / H100_BYTES_PER_S
    bound = max(ops, parts["bytes"])
    by = ("bytes" if parts["bytes"] >= ops else
          "operations (" + max(("mlp", "taps"), key=parts.get) + ")")
    return {"bound_ms": bound * 1e3, "bound_by": by, "macs": macs,
            **{f"{k}_ms": t * 1e3 for k, t in parts.items()}}


def phase_var_stream(variant: str, main_mesh, smi: str) -> None:
    """[var onestream] / [var global]: image_to_mesh of the variant at full
    width, 257^3, with var_analytic_params: the sparse volume flow by the
    plain decode (coarse 65^3 and the active cells' fine points; K1 does
    not serve these heads), a warm-up and 3 bf16 images and one f32 image
    (TF32 off), the K1 and K5 counts set to 0 just before each image and
    read just after (0 both). Gates: no cap overflow, the main path's
    volume-flow faces (the field is the same), vertices on the surface
    (f32 within SURFACE_TOL, bf16 within MV_BF16_SURFACE_TOL: the plain
    decode rounds the output layer to bf16). Prints the stages, peak
    memory and the decode (phase_a + phase_b) beside var_bound."""
    import torch
    from disn_tpu_torch.config import Config, Variant
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.ops import fused_decode, sparse_words

    k1 = fused_decode.fused_cell_decode
    k5 = sparse_words.sparse_cell_words
    tag = f"[var {variant}]"
    cfg = Config(sdf_res=256, compute_dtype="bfloat16",
                 variant=Variant(variant))
    params = var_analytic_params(cfg)
    rng = np.random.RandomState(29)
    trans = synthetic.demo_trans_mat()
    runs = []
    _, mf = main_mesh
    for i in range(5):
        c = cfg if i < 4 else cfg.replace(compute_dtype="float32")
        img = rng.randint(0, 256, (137, 137, 3), dtype=np.uint8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.launches = k5.launches = 0
        stats, verts, faces, _ = var_image(c, params, img, trans,
                                           f"{variant} image {i}")
        stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        check(k1.launches == 0 and k5.launches == 0,
              f"{tag} image {i}: K1 {k1.launches} and K5 {k5.launches} "
              f"launches, expected none")
        check(not stats["dense_fallback"] and stats["route"] == "owned_ids",
              f"{tag} image {i}: route {stats['route']}, dense fallback "
              f"{stats['dense_fallback']}")
        tol = MV_BF16_SURFACE_TOL if i < 4 else SURFACE_TOL
        dist = float(np.abs(np.abs(verts).sum(1) - 0.6).max())
        same = np.array_equal(faces, mf)
        stats.update(max_surface_dist=dist, main_faces_equal=same,
                     decode_ms=stats["phase_a_ms"] + stats["phase_b_ms"])
        n_pts = (c.sdf_res // 4 + 1) ** 3 + 64 * stats["active_cells"]
        b = var_bound(n_pts, c, "bf16" if i < 4 else "f32")
        print(f"{tag} image {i}: {len(faces)} faces (the main path's: "
              f"{same}), vertices off the surface by {dist:.3e} "
              f"(tolerance {tol:.3e}); decode {stats['decode_ms']:.3f} ms "
              f"for {n_pts} points against its bound {b['bound_ms']:.4f} "
              f"ms ({b['bound_by']}; mlp {b['mlp_ms']:.4f}, taps "
              f"{b['taps_ms']:.4f}, bytes {b['bytes_ms']:.4f}; "
              f"{b['macs']} MACs a point) = "
              f"{b['bound_ms'] / stats['decode_ms']:.5f}; peak "
              f"{stats['peak_gib']:.3f} GiB; {smi}")
        check(dist <= tol and same, f"{tag} image {i}: the mesh is not the "
                                    f"main path's octahedron")
        runs.append(stats)
    keys = ("wall_ms", "encode_ms", "prep_ms", "phase_a_ms", "phase_b_ms",
            "scan_ms", "extraction_ms", "decode_ms", "active_cells",
            "fine_cells", "peak_gib")
    print_stages(f"{tag} bf16", runs[1:4], keys)
    print_stages(f"{tag} f32", runs[4:], keys)


def phase_var_3dcnn(smi: str) -> None:
    """[var 3dcnn]: the 3D-CNN variant's full-width forward (VGG-16, the
    transpose-conv stack to 65^3, the f32 1x1x1 head) through
    pipeline.threedcnn_volume, f32 (TF32 off) and bf16: a warm-up, then
    the median of 5 (host clock, synchronised) and peak memory; no K1
    launch. The f32 volume is meshed at its median as the iso, so that the
    extractor has work: > 0 faces, finite."""
    import torch
    from disn_tpu_torch.config import Config, Variant
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.models import disn
    from disn_tpu_torch.ops import fused_decode

    k1 = fused_decode.fused_cell_decode
    cfg = Config(variant=Variant.THREEDCNN)
    params = disn.init(cfg, seed=0)
    img = np.random.RandomState(31).randint(0, 256, (137, 137, 3),
                                            dtype=np.uint8)
    vol = None
    for dt in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dt)
        pipeline.threedcnn_volume(params, img, c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.launches = 0
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            v = pipeline.threedcnn_volume(params, img, c)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(k1.launches == 0 and tuple(v.shape) == (65, 65, 65)
              and bool(torch.isfinite(v).all()),
              f"[var 3dcnn] {dt}: shape {tuple(v.shape)}, K1 {k1.launches}")
        print(f"[var 3dcnn] {dt} forward to the 65^3 volume: median "
              f"{np.median(ms):.3f} ms all={[round(x, 3) for x in ms]}; "
              f"peak {peak:.3f} GiB; {smi}")
        vol = v if vol is None else vol
    iso = float(vol.median())
    t0 = time.perf_counter()
    verts, faces = pipeline.volume_to_mesh(vol, pipeline.UNIT_BOX, iso=iso)
    print(f"[var 3dcnn] f32 volume meshed at its median {iso:.6e}: "
          f"{len(faces)} faces, {len(verts)} verts in "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    check(len(faces) > 0 and np.isfinite(verts).all(),
          "[var 3dcnn] the median iso gave no mesh")


def phase_var_train(records, smi: str) -> None:
    """[var train]: the onestream variant's step (the trainer's fold=True
    falls through to the unfolded forward pass) at the default Config's
    full width, B = 20, N = 2048, f32: 2 warm-ups and 10 timed steps from
    the memory loader (time_steps), then 20 steps on one batch from a
    fresh seed-0 state, whose sdf_loss must fall (the median of the last 5
    below that of the first 5). Then `train --dump-every 1` through the
    CLI on the card at width 0.125 on the memory records (the card's
    machine has no h5py: core/codecs' h5 readers are replaced for the
    call): every step's three dump files exist and are not empty."""
    import shutil

    import torch
    from disn_tpu_torch import cli
    from disn_tpu_torch.config import Config, Variant
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.data import listing, synthetic
    from disn_tpu_torch.train import trainer

    cfg = Config(variant=Variant.ONESTREAM)
    state = trainer.create_state(cfg, seed=0)
    loader = train_loader(cfg, records, 12).start()
    try:
        time_steps(cfg, state, loader, "var onestream f32")
    finally:
        loader.shutdown()
    del state
    torch.cuda.empty_cache()
    state = trainer.create_state(cfg, seed=0)
    step = trainer.make_train_step(cfg)
    batch = on(host_batch(cfg, records, seed=2), CARD)
    losses = [step(state, batch)[1]["sdf_loss"] for _ in range(20)]
    losses = [x.item() for x in losses]
    first, last = np.median(losses[:5]), np.median(losses[-5:])
    print(f"[var train] onestream, 20 steps on one batch: sdf_loss "
          f"{[round(x, 2) for x in losses]}; median of the first 5 "
          f"{first:.2f}, of the last 5 {last:.2f}; {smi}")
    check(all(np.isfinite(losses)) and last < first,
          "[var train] onestream: sdf_loss did not fall over 20 steps")
    del state
    torch.cuda.empty_cache()

    shutil.rmtree(VAR_DIR, ignore_errors=True)
    data = os.path.join(VAR_DIR, "data")
    os.makedirs(os.path.join(data, "filelists"))
    cat = synthetic.SYNTH_CAT
    with open(os.path.join(data, "filelists", f"{cat}_train.lst"), "w") as f:
        f.write("\n".join(synthetic.SHAPES) + "\n")
    paths = listing.SplitPaths(os.path.join(data, "sdf"),
                               os.path.join(data, "renders"))
    sdf = {paths.sdf_path(cat, o): r for o, r in records[0].items()}
    views = {paths.img_path(cat, o, v): r for (o, v), r in records[1].items()}
    readers = {"read_sdf_h5": sdf.__getitem__,
               "read_view_h5": views.__getitem__}
    saved = {k: getattr(codecs, k) for k in readers}
    log = os.path.join(VAR_DIR, "run")
    sets = dict(width_mult=0.125, num_classes=32, batch_size=4,
                num_sample_points=256, view_num=4, variant="onestream")
    t0 = time.perf_counter()
    try:
        for k, fn in readers.items():
            setattr(codecs, k, fn)
        cli.main(["train", "--data-root", data, "--log-dir", log,
                  "--epochs", "1", "--workers", "2", "--dump-every", "1"]
                 + [x for k, v in sets.items() for x in ("--set", f"{k}={v}")])
    finally:
        for k, fn in saved.items():
            setattr(codecs, k, fn)
    secs = time.perf_counter() - t0
    dumps = sorted(os.listdir(os.path.join(log, "dumps")))
    steps = len(dumps) // 3
    sizes = [os.path.getsize(os.path.join(log, "dumps", n)) for n in dumps]
    print(f"[var train] train --dump-every 1 on the card ({sets}): "
          f"{steps} steps in {secs:.2f} s, {len(dumps)} dump files "
          f"{dumps[:3]}..., smallest {min(sizes)} B; {smi}")
    want = [f"step{i:06d}_{k}" for i in range(steps)
            for k in ("gt.obj", "pred.obj", "proj.ppm")]
    check(steps >= 3 and dumps == want and min(sizes) > 0,
          f"[var train] the dumps are not every step's three files: {dumps}")
    shutil.rmtree(VAR_DIR, ignore_errors=True)


def phase_var_hold(smi: str) -> None:
    """[var hold]: the volume on the card against the same code on the CPU
    (VAR_HOLD: width 0.25, sdf_res 64, f32, TF32 off; seeded random params
    with the heads' biases drawn too) for every arm: twostream tf1 by
    dense_sdf with fold 'none', 'local' and '137' under fused_kernel 'off'
    and 'auto' ('137' + 'auto' launches K1, once; the rest none); native
    sampling; onestream and global; a binary + tanh twostream head (K1,
    out_dim 2) and a binary onestream head through the sign cull; the 3D-CNN
    volume. Each within VAR_HOLD_REL of the CPU's largest |value|."""
    import torch
    from disn_tpu_torch.config import Config, Variant
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import dense, pipeline
    from disn_tpu_torch.models import disn
    from disn_tpu_torch.ops import fused_decode

    k1 = fused_decode.fused_cell_decode
    t0 = time.perf_counter()
    img = np.random.RandomState(37).randint(0, 256, (137, 137, 3),
                                            dtype=np.uint8)
    trans = synthetic.demo_trans_mat()
    box = pipeline.UNIT_BOX

    def net(cfg, seed):
        params = disn.init(cfg, seed=seed, device="cpu")
        gen = torch.Generator().manual_seed(seed)
        for scope, tree in params.items():
            stack = [tree] if scope != "vgg_16" else []
            while stack:
                node = stack.pop()
                for k, v in node.items():
                    if isinstance(v, dict):
                        stack.append(v)
                    elif k == "biases":
                        node[k] = 0.1 * torch.randn(v.shape, generator=gen)
        return params

    arms = [(f"twostream tf1 fold={fold} fused_kernel={fk}",
             dict(), fold, fk) for fold in ("none", "local", "137")
            for fk in ("off", "auto")]
    arms += [("twostream native", dict(sampling="native"), None, "auto"),
             ("onestream tf1", dict(variant=Variant.ONESTREAM), None,
              "auto"),
             ("global", dict(variant=Variant.GLOBAL), None, "auto"),
             ("twostream binary + tanh", dict(binary=True, tanh=True), None,
              "auto"),
             ("onestream native binary, sign cull",
              dict(variant=Variant.ONESTREAM, sampling="native",
                   binary=True, binary_sparse=True), "sparse", "auto"),
             ("3dcnn", dict(variant=Variant.THREEDCNN), None, "auto")]
    # fold 'none' and 'local' take the plain decode under either setting:
    # the CPU's volume of the first serves the second
    cpu_vols = {}
    for i, (name, kw, fold, fk) in enumerate(arms):
        cfg = Config(**VAR_HOLD, fused_kernel=fk, **kw)
        params = net(cfg, 40 + (i if fold not in ("none", "local")
                                else ("none", "local").index(fold)))
        vols, launches = {}, {}
        for d in ("cuda", "cpu"):
            torch.cuda.synchronize()
            before = k1.launches
            if d == "cpu" and fold in cpu_vols:
                vols[d] = cpu_vols[fold]
            elif fold == "sparse" or cfg.variant is Variant.THREEDCNN:
                vols[d] = pipeline.predict_volume(params, img, trans, box,
                                                  cfg, device=d)
            else:
                vols[d] = dense.dense_sdf(params, img, trans, box, cfg,
                                          device=d, fold_local=fold)
            torch.cuda.synchronize()
            launches[d] = k1.launches - before
        if fold in ("none", "local"):
            cpu_vols[fold] = vols["cpu"]
        want_k1 = int(cfg.variant is Variant.TWOSTREAM and fold in
                      (None, "137") and cfg.sampling == "tf1"
                      and fk == "auto")
        rel = mv_rel(vols["cuda"], vols["cpu"])
        print(f"[var hold] {name}: card vs CPU {rel:.3e} of max|v| "
              f"{float(vols['cpu'].abs().max()):.4e} (tolerance "
              f"{VAR_HOLD_REL:.0e}); K1 launches on the card "
              f"{launches['cuda']} (expected {want_k1})")
        check(rel <= VAR_HOLD_REL and launches["cuda"] == want_k1
              and launches["cpu"] == 0,
              f"[var hold] {name}: the card's volume is not the CPU's, or "
              f"K1 ran {launches['cuda']} times")
    print(f"[var hold] {len(arms)} arms in {time.perf_counter() - t0:.1f} "
          f"s; {smi}")


def phase_var(records, main_mesh) -> dict:
    import torch

    t0 = time.perf_counter()
    smi = card_name()
    res = phase_var_binary(smi)
    torch.cuda.empty_cache()
    for variant in ("onestream", "global"):
        phase_var_stream(variant, main_mesh, smi)
        torch.cuda.empty_cache()
    phase_var_3dcnn(smi)
    torch.cuda.empty_cache()
    phase_var_train(records, smi)
    torch.cuda.empty_cache()
    phase_var_hold(smi)
    print(f"[var] phase took {time.perf_counter() - t0:.1f} s")
    return res


# ---------------------------------------------------------------------------
# 11. the alternate encoders and RGBA input; 12. the offline tools
# ---------------------------------------------------------------------------

ENC_SEED = 60
ENC_HOLD = dict(width_mult=0.25, num_classes=64, compute_dtype="float32",
                batch_size=2, num_sample_points=256)
# card against CPU at width 0.25, f32 with TF32 off: cuDNN's convolutions
# sum in other orders than the CPU's, as K1's f32 hold allows
ENC_HOLD_REL = F32_REL_TOL
PREP_DIR = os.path.join(ROOT, "build", "chip_smoke_prep")  # removed after
PREP_RES = 256   # preprocess-sdf's default resolution
# A ground-truth vertex lies at the iso value 0.003 outside the mesh. The
# offset surface rounds the input polyhedron's edges with radius 0.003, a
# third of a cell at 256^3 (cell 2.4/256 = 0.0094), and marching tets
# interpolates the field linearly along tet edges across that curvature;
# the icosphere's faces lie up to 1.3e-4 inside its sphere. On an NVIDIA
# H100 80GB HBM3 the worst vertex was 0.116 of a cell off; a quarter of a
# cell is the bound.
PREP_SURFACE_CELLS = 0.25


def enc_configs():
    """(label, encoder) for the three encoders, VGG-16 last."""
    from disn_tpu_torch.config import EncoderKind
    return [(e.value, e) for e in (EncoderKind.ALEXNET, EncoderKind.RESNET,
                                   EncoderKind.VGG16)]


def phase_enc_full(main_faces: dict, smi: str) -> None:
    """[enc full]: image_to_mesh at sdf_res 256 on the full-width twostream
    net with each encoder on RGBA (4-channel u8) images, analytic
    octahedron head, bf16 and f32 (TF32 off): a warm-up and 3 fresh seeded
    images a run, K1's count set to 0 before each run and read after (2 an
    image), every image through run_main_path's gates (the words flow,
    vertices on the surface) and with the faces of the VGG-16 RGB main
    path's mesh of the same type. Medians of the 3 timed images."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.ops import fused_decode

    k1 = fused_decode.fused_cell_decode
    trans = synthetic.demo_trans_mat()
    for name, enc in enc_configs():
        for dt, cd in (("bf16", "bfloat16"), ("f32", "float32")):
            cfg = Config(sdf_res=256, compute_dtype=cd, encoder=enc,
                         alpha=True)
            params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6)
            rng = np.random.RandomState(ENC_SEED)
            imgs = [rng.randint(0, 256, (137, 137, 4), dtype=np.uint8)
                    for _ in range(4)]
            label = f"enc {name} rgba {dt}"
            kept, meshes = {}, {}
            torch.cuda.synchronize()
            k1.launches = 0
            runs = run_main_path(cfg, params, imgs, trans, label, 1, kept,
                                 meshes)
            torch.cuda.synchronize()
            launches = k1.launches
            check(launches == 2 * len(imgs),
                  f"[enc full] {label}: {launches} K1 launches for "
                  f"{len(imgs)} images, expected {2 * len(imgs)}")
            same = [np.array_equal(f, main_faces[dt])
                    for _, f in meshes[label]]
            check(all(same), f"[enc full] {label}: faces differ from the "
                             f"VGG-16 RGB main path's ({same})")
            bound = sum(k1_bound(a, kw)[0] for a, kw in kept[label])

            def med(key):
                return float(np.median([r[key] for r in runs[1:]]))

            print(f"[enc full] {label}: K1 launches {launches} (2 an image),"
                  f" faces equal to the main path's ({len(main_faces[dt])}),"
                  f" encode_ms median={med('encode_ms'):.3f} prep_ms median="
                  f"{med('prep_ms'):.3f} wall_ms median={med('wall_ms'):.3f}"
                  f" k1_ms median={med('k1_ms'):.4f} beside its bound "
                  f"{bound:.4f} ms; {smi}")
            del params, kept, meshes
            torch.cuda.empty_cache()


def enc_net(cfg, seed: int, device: str):
    """disn.init(cfg) with the heads' biases drawn N(0, 0.1^2), so that a
    head is random, not analytic."""
    import torch
    from disn_tpu_torch.models import disn

    params = disn.init(cfg, seed=seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for scope in ("sdfprediction", "sdfprediction_imgfeat"):
        for layer in params[scope].values():
            for p in layer.values():
                p["biases"] = 0.1 * torch.randn(
                    p["biases"].shape, generator=gen, device=device)
    return params


def phase_enc_k1(main_kept: dict) -> None:
    """[enc k1]: K1 against its plain version on each encoder's fold-137
    map and g_contrib of a seeded RGBA image (full width, random head), in
    f32 and bf16, with the cell ids and geometry of the main path's coarse
    and fine launches and the existing tolerances."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.infer import dense
    from disn_tpu_torch.models import disn
    from disn_tpu_torch.ops import fused_decode

    trans = torch.from_numpy(synthetic.demo_trans_mat()).to(CARD)
    img = torch.from_numpy(np.random.RandomState(ENC_SEED + 1).randint(
        0, 256, (1, 137, 137, 4), dtype=np.uint8)).to(CARD)
    for name, enc in enc_configs():
        for dtype, dt, cd in ((torch.float32, "f32", "float32"),
                              (torch.bfloat16, "bf16", "bfloat16")):
            cfg = Config(encoder=enc, alpha=True, compute_dtype=cd)
            params = enc_net(cfg, ENC_SEED + 2, CARD)
            with torch.no_grad():
                emb, eps = disn.encode(params, img, cfg)
                folded = dense.fold_137(params, emb, eps, cfg)
            check(tuple(folded["fold137"].shape) == (1, 137, 137, 512),
                  f"[enc k1] {name}: fold-137 map "
                  f"{tuple(folded['fold137'].shape)}")
            fmap = folded["fold137"][0].contiguous()
            weights = fused_decode.pack_weights(params, folded["g_contrib"],
                                                dtype)
            for pass_, (margs, kw) in zip(("coarse", "fine"),
                                          main_kept["bf16"]):
                hold_k1(f"[enc k1] {name} rgba {dt} {pass_}",
                        (fmap, weights, trans, margs[3], margs[4]), kw,
                        timed=False)
            del params, folded, fmap, weights
            torch.cuda.empty_cache()


def enc_rel(got, want) -> float:
    """max |card - CPU| over the CPU's max |value|."""
    want = want.detach().float()
    return float((got.detach().float().cpu() - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


def phase_enc_hold(records, smi: str) -> None:
    """[enc hold]: the card against the CPU (ENC_HOLD: width 0.25, f32, TF32
    off) for each encoder with and without alpha: the embedding, every
    endpoint map and the fold-137 map of two seeded u8 images, each within
    ENC_HOLD_REL of the CPU's largest |value|; for AlexNet and ResNet on
    RGBA one train step's loss on a batch of the in-memory records, within
    HOLD_LOSS_REL."""
    import torch
    from disn_tpu_torch import device as device_mod
    from disn_tpu_torch.config import Config, EncoderKind
    from disn_tpu_torch.infer import dense
    from disn_tpu_torch.models import disn
    from disn_tpu_torch.train import trainer

    t0 = time.perf_counter()
    for name, enc in enc_configs():
        for alpha in (False, True):
            cfg = Config(encoder=enc, alpha=alpha, **ENC_HOLD)
            params = enc_net(cfg, ENC_SEED + 3, "cpu")
            img = np.random.RandomState(ENC_SEED + 4).randint(
                0, 256, (2, 137, 137, cfg.img_channels), dtype=np.uint8)
            out = {}
            for d in (CARD, "cpu"):
                p = device_mod.tree_to(params, torch.device(d))
                with torch.no_grad():
                    emb, eps = disn.encode(p, torch.from_numpy(img).to(d),
                                           cfg)
                    folded = dense.fold_137(p, emb, eps, cfg)
                out[d] = {"embedding": emb, **eps,
                          "fold137": folded["fold137"],
                          "g_contrib": folded["g_contrib"]}
            rels = {k: enc_rel(out[CARD][k], out["cpu"][k])
                    for k in out["cpu"]}
            worst = max(rels, key=rels.get)
            line = (f"[enc hold] {name} alpha={alpha}: {len(rels)} outputs,"
                    f" worst {worst} {rels[worst]:.3e} of max|v| (tolerance "
                    f"{ENC_HOLD_REL:.0e})")
            check(rels[worst] <= ENC_HOLD_REL,
                  f"{line}: the card's encoder is not the CPU's")
            if alpha and enc is not EncoderKind.VGG16:
                batch = host_batch(cfg, records, seed=1)
                loss = {d: trainer.compute_gradients(
                    trainer.create_state(cfg, params=params, device=d),
                    on(batch, d))["overall_loss"].item()
                    for d in (CARD, "cpu")}
                lrel = abs(loss[CARD] - loss["cpu"]) / abs(loss["cpu"])
                line += (f"; train step loss card {loss[CARD]!r} cpu "
                         f"{loss['cpu']!r} rel {lrel:.3e} (limit "
                         f"{HOLD_LOSS_REL})")
                check(lrel <= HOLD_LOSS_REL,
                      f"{line}: the train step's loss differs")
            print(line)
    print(f"[enc hold] took {time.perf_counter() - t0:.1f} s; {smi}")


def phase_enc(records, main_faces: dict, main_kept: dict) -> None:
    import torch

    t0 = time.perf_counter()
    smi = card_name()
    phase_enc_full(main_faces, smi)
    phase_enc_k1(main_kept)
    torch.cuda.empty_cache()
    phase_enc_hold(records, smi)
    print(f"[enc] phase took {time.perf_counter() - t0:.1f} s")


def icosphere(level: int, r: float) -> tuple[np.ndarray, np.ndarray]:
    """A sphere of radius r: the icosahedron split `level` times, every
    vertex on the sphere (20 x 4^level faces)."""
    t = (1 + 5 ** 0.5) / 2
    pts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
           (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
           (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.array(p, np.float64) / np.linalg.norm(p) for p in pts]
    for _ in range(level):
        mid: dict = {}

        def middle(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                p = verts[a] + verts[b]
                verts.append(p / np.linalg.norm(p))
                mid[key] = len(verts) - 1
            return mid[key]

        split = []
        for a, b, c in faces:
            ab, bc, ca = middle(a, b), middle(b, c), middle(c, a)
            split += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = split
    return ((np.array(verts) * r).astype(np.float32),
            np.array(faces, np.int32))


class MemoryWriters:
    """codecs' h5 writers (and write_obj) replaced by in-memory stand-ins
    for a block: the card's machine has no h5py. `written[path]` holds
    each call's arrays."""

    NAMES = ("write_sdf_h5", "write_view_h5", "write_obj")

    def __init__(self, names=NAMES):
        self.names, self.written, self.saved = names, {}, {}

    def __enter__(self):
        from disn_tpu_torch.core import codecs

        def stub(name):
            def write(path, *args, **kw):
                self.written[path] = (name, args, kw)
            return write

        for n in self.names:
            self.saved[n] = getattr(codecs, n)
            setattr(codecs, n, stub(n))
        return self

    def __exit__(self, *exc):
        from disn_tpu_torch.core import codecs
        for n, fn in self.saved.items():
            setattr(codecs, n, fn)


def phase_prep_sdf(smi: str) -> None:
    """[prep sdf]: sdf_gen.generate_object's two halves on an icosphere
    (r 0.5, 20480 faces) at sdf_res 256, the h5 and OBJ writers in memory:
    the host distance field's seconds, marching_tets on the card and the
    weld on the host; every sample within the bandwidth of the iso value,
    every ground-truth vertex at the iso value off the (normalised)
    sphere within PREP_SURFACE_CELLS of a cell, and marching_tets + weld
    on the CPU from the same volume: the same faces, vertices within 1e-6.
    Then `preprocess-sdf` through the CLI on the card, --jobs 2 and --jobs
    1 over the icosphere and a smaller one off the centre at res 64
    (in-memory writers): the same samples and meshes."""
    import torch
    from disn_tpu_torch import cli
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.ops import marching
    from disn_tpu_torch.preprocessing import sdf_gen

    verts, faces = icosphere(5, 0.5)
    stats: dict = {}
    field = sdf_gen.object_field(verts, faces, sdf_res=PREP_RES)
    with MemoryWriters() as mem:
        out = sdf_gen.write_object(field, os.path.join(PREP_DIR, "obj"),
                                   device=CARD, stats=stats)
    samples = mem.written[out["h5"]][1][0]
    _, (gv, gf), _ = mem.written[os.path.join(PREP_DIR, "obj",
                                              "isosurf.obj")]
    band = float(np.abs(samples[:, 3] - 0.003).max())
    check(len(samples) == 32768 and band < 0.1,
          f"[prep sdf] {len(samples)} samples, the farthest {band} from "
          f"the iso value (bandwidth 0.1)")
    cell = float(field.bbox[3] - field.bbox[0]) / PREP_RES
    center = -field.centroid.astype(np.float64) / field.m
    dist = np.linalg.norm(gv - center, axis=1) - 0.5 / field.m
    off = float(np.abs(dist - 0.003).max())
    check(len(gf) > 100000 and off <= PREP_SURFACE_CELLS * cell,
          f"[prep sdf] {len(gf)} faces; a vertex is {off:.3e} off the "
          f"iso surface (bound {PREP_SURFACE_CELLS * cell:.3e})")
    t0 = time.perf_counter()
    cv, cf = marching.extract_mesh(torch.from_numpy(field.vol),
                                   field.bbox.astype(np.float32), iso=0.003)
    cpu_s = time.perf_counter() - t0
    dv = float(np.abs(cv - gv).max()) if cv.shape == gv.shape else np.inf
    check(np.array_equal(cf, gf) and dv <= 1e-6,
          f"[prep sdf] the CPU's mesh of the same volume differs (faces "
          f"equal: {np.array_equal(cf, gf)}, vertices {dv:.3e})")
    print(f"[prep sdf] icosphere {len(faces)} faces at {PREP_RES}^3: "
          f"distfield_s={stats['distfield_s']:.3f} (host, "
          f"{os.cpu_count()} cores) marching_tets_ms="
          f"{stats['marching_tets_ms']:.3f} (card) weld_ms="
          f"{stats['weld_ms']:.3f} (host); {len(samples)} samples within "
          f"{band:.4f} of the iso value; {len(gv)} vertices, {len(gf)} "
          f"faces, worst vertex {off:.3e} off the iso surface ({off / cell:.3f}"
          f" cell); the CPU's mesh of the volume equal (vertices {dv:.1e}, "
          f"{cpu_s:.1f} s); {smi}")
    prep_weld(field, gv, gf, smi)
    obj_dir = os.path.join(PREP_DIR, "meshes")
    os.makedirs(obj_dir, exist_ok=True)
    codecs.write_obj(os.path.join(obj_dir, "ico.obj"), verts, faces)
    small, small_f = icosphere(3, 0.3)
    codecs.write_obj(os.path.join(obj_dir, "off.obj"),
                     small + np.float32([0.2, 0, 0]), small_f)
    trees = {}
    for jobs in ("2", "1"):
        with MemoryWriters() as mem:
            cli.main(["preprocess-sdf", "--pattern",
                      os.path.join(obj_dir, "*.obj"), "--out-dir",
                      os.path.join(PREP_DIR, "jobs"), "--res", "64",
                      "--num-sample", "4096", "--jobs", jobs])
        trees[jobs] = mem.written
    same = trees["1"].keys() == trees["2"].keys() and all(
        all(np.array_equal(a, b) for a, b in zip(
            (*one[1], *one[2].values()), (*two[1], *two[2].values())))
        for one, two in ((trees["1"][k], trees["2"][k]) for k in trees["1"]))
    check(same and len(trees["1"]) == 4,
          f"[prep sdf] preprocess-sdf --jobs 2 wrote other files or arrays "
          f"than --jobs 1 ({sorted(trees['1'])}, {sorted(trees['2'])})")
    print(f"[prep sdf] preprocess-sdf on the card, 2 meshes at 64^3: "
          f"--jobs 2 = --jobs 1 ({len(trees['1'])} files)")


def prep_weld(field, gv, gf, smi: str) -> None:
    """[prep weld]: marching_tets' soup of the ground-truth volume welded
    on the card (marching.weld_device: a stable sort of the edge keys, a
    cumsum, a scatter) against the host weld of the same soup: equal bit
    for bit (and whether it equals write_object's mesh); both timed (CUDA
    events, median of 3 after a warm-up; the host clock) beside a byte
    bound (the soup read once, the mesh written once)."""
    import torch
    from disn_tpu_torch.ops import marching

    vol = torch.from_numpy(field.vol).to(CARD)
    box = torch.from_numpy(field.bbox.astype(np.float32)).to(CARD)
    tri_pos, tri_keys, count = marching.marching_tets(vol, box, iso=0.003)
    times = []
    for _ in range(4):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        dv, df = marching.weld_device(tri_pos, tri_keys, count)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    pos, keys = tri_pos.cpu().numpy(), tri_keys.cpu().numpy()
    t0 = time.perf_counter()
    hv, hf = marching.weld(pos, keys, count)
    host_ms = (time.perf_counter() - t0) * 1e3
    dv, df = dv.cpu().numpy(), df.cpu().numpy()
    same = np.array_equal(dv, hv) and np.array_equal(df, hf)
    same_obj = np.array_equal(df, gf) and np.array_equal(dv, gv)
    moved = pos.nbytes + keys.nbytes + dv.nbytes + df.nbytes
    print(f"[prep weld] {count} triangles -> {len(dv)} vertices, {len(df)} "
          f"faces: weld_device {np.median(times[1:]):.3f} ms (all "
          f"{[round(t, 3) for t in times[1:]]}; bound "
          f"{moved / H100_BYTES_PER_S * 1e3:.4f} ms, {moved} bytes), host "
          f"weld {host_ms:.1f} ms; equal to the host weld: {same}, to "
          f"write_object's mesh: {same_obj}; {smi}")
    check(same, "[prep weld] weld_device differs from the host weld")


def phase_prep_tools(smi: str) -> None:
    """[prep tools]: img_gen.generate_object_views on a rendered view (the
    view h5 writer in memory: the record's camera is view_params_to_trans_mat
    of the metadata); clean_mesh_file on a mesh with a stray part; `synth`
    through the CLI (h5 writers in memory; the .dist files on disk) and
    read_dist of each .dist it wrote against the analytic field."""
    from disn_tpu_torch import cli, postprocessing
    from disn_tpu_torch.core import camera, codecs
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.preprocessing import img_gen

    img8, _ = synthetic.render_view(synthetic.sdf_sphere, 30.0, 20.0, 0.85)
    norm = np.array([0.1, -0.2, 0.05, 1.3], np.float32)
    with MemoryWriters() as mem:
        paths = img_gen.generate_object_views(
            [img8], [(30.0, 20.0, 0.0, 0.85)], norm,
            os.path.join(PREP_DIR, "views"), skip_existing=False)
    rec = mem.written[paths[0]][1][0]
    want = camera.view_params_to_trans_mat(30.0, 20.0, 0.85, norm[:3],
                                           float(norm[3]))[0]
    check(rec.img_arr.shape == (137, 137, 4)
          and np.allclose(rec.trans_mat, want, rtol=0, atol=1e-6),
          "[prep tools] generate_object_views wrote another record")
    big = icosphere(3, 0.5)
    small = icosphere(1, 0.1)
    verts = np.concatenate([big[0], small[0] + np.float32([1.5, 0, 0])])
    faces = np.concatenate([big[1], small[1] + len(big[0])])
    src, dst = (os.path.join(PREP_DIR, n) for n in ("two.obj", "clean.obj"))
    codecs.write_obj(src, verts, faces)
    postprocessing.clean_mesh_file(src, dst)
    cv, cf = codecs.read_obj(dst)
    check(len(cv) == len(big[0]) and len(cf) == len(big[1]),
          f"[prep tools] clean_mesh_file kept {len(cv)} vertices, expected "
          f"{len(big[0])}")
    root = os.path.join(PREP_DIR, "synth")
    with MemoryWriters(("write_sdf_h5", "write_view_h5")) as mem:
        cli.main(["synth", "--out-dir", root, "--views", "2",
                  "--num-samples", "1024", "--grid-res", "16"])
    n_h5 = len(mem.written)
    lin = np.linspace(-1, 1, 17, dtype=np.float32)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    pts = np.stack([xx, yy, zz], -1).reshape(-1, 3)
    worst = 0.0
    for obj, fn in synthetic.SHAPES.items():
        dist = codecs.read_dist(os.path.join(root, "sdf_grids",
                                             synthetic.SYNTH_CAT, obj,
                                             "grid.dist"), expect_res=16)
        worst = max(worst, float(np.abs(
            dist.values.reshape(-1) - fn(pts)).max()))
    check(n_h5 == 3 * len(synthetic.SHAPES) and worst == 0.0,
          f"[prep tools] synth wrote {n_h5} h5 files; read_dist differs "
          f"from the field by {worst}")
    print(f"[prep tools] generate_object_views: one record, camera within "
          f"1e-6; clean_mesh_file: {len(verts)} -> {len(cv)} vertices; "
          f"synth: {n_h5} h5 records in memory and {len(synthetic.SHAPES)} "
          f".dist files read back by read_dist exactly; {smi}")


def phase_prep() -> None:
    import shutil

    t0 = time.perf_counter()
    smi = card_name()
    try:
        phase_prep_sdf(smi)
        phase_prep_tools(smi)
    finally:
        shutil.rmtree(PREP_DIR, ignore_errors=True)
    print(f"[prep] phase took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# [dist]: the parallel path (disn_tpu_torch/parallel)
# ---------------------------------------------------------------------------

DIST_DIR = os.path.join(ROOT, "build", "chip_smoke_dist")  # removed after
DIST_TIMEOUT_S = 300   # a spawned group: start, build loads, its work
NCCL_DUP_TIMEOUT_S = 60
DIST_LOSS_RTOL = 2e-5  # tests/test_train.py:68's sharded-vs-single bound


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_batch(cfg) -> dict:
    """A seeded full-size batch of the default Config (B rows, N points)."""
    from disn_tpu_torch.data import synthetic

    rng = np.random.RandomState(7)
    b, n = cfg.batch_size, cfg.num_sample_points
    pts = rng.uniform(-0.8, 0.8, (b, n, 3)).astype(np.float32)
    return {"img": rng.rand(b, 137, 137, 3).astype(np.float32),
            "sdf_pt": pts, "sdf_pt_rot": pts[..., ::-1].copy(),
            "sdf_val": (np.linalg.norm(pts, axis=-1, keepdims=True) - 0.5
                        + 0.05 * rng.randn(b, n, 1)).astype(np.float32),
            "trans_mat": np.stack([synthetic.demo_trans_mat()] * b)}


def sharded_image(mesh, cfg, params, img, trans) -> dict:
    """image_to_mesh_sharded once as a warm-up, then timed once (host
    clock, synchronised; K1's launches counted and timed with CUDA events
    around each) -> its mesh and numbers."""
    import torch
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.ops import fused_decode

    k1 = fused_decode.fused_cell_decode
    pipeline.image_to_mesh_sharded(params, img, trans, cfg, mesh)
    torch.cuda.synchronize()
    stats: dict = {}
    k1.events, before = [], k1.launches
    t0 = time.perf_counter()
    verts, faces = pipeline.image_to_mesh_sharded(params, img, trans, cfg,
                                                  mesh, stats=stats)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    k1_ms = [s.elapsed_time(e) for s, e in k1.events]
    k1.events = None
    return dict(verts=verts, faces=faces, wall_ms=wall,
                k1_launches=k1.launches - before, k1_ms=k1_ms, **stats)


def dist_rank(rank: int, world: int, port: int, backend: str,
              inputs: dict) -> None:
    """One rank of a [dist] group, spawned by phase_dist: card `rank` under
    NCCL, card 0 under gloo. Writes its results to DIST_DIR."""
    import pickle

    import torch
    import torch.distributed as dist

    from disn_tpu_torch import parallel
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.train import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        cfg = Config(sdf_res=256, compute_dtype="bfloat16")
        params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6)
        out = sharded_image(parallel.make_mesh(data=1, points=world), cfg,
                            params, inputs["img"], inputs["trans"])
        if inputs.get("batch") is not None:
            tcfg = Config()
            mesh = parallel.make_mesh(data=world, points=1)
            state = trainer.create_state(tcfg, seed=0, mesh=mesh)
            step = trainer.make_train_step(tcfg, mesh=mesh)
            t0 = time.perf_counter()
            _, losses = step(state, parallel.shard_batch(inputs["batch"],
                                                         mesh))
            out["loss"] = float(losses["overall_loss"])
            out["step_ms"] = (time.perf_counter() - t0) * 1e3
        with open(os.path.join(DIST_DIR, f"{backend}{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def nccl_dup_rank(rank: int, port: int, q) -> None:
    """Two NCCL ranks on card 0: one all_reduce; the first line of what
    NCCL says goes to q."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        dist.init_process_group("nccl",
                                init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=2)
        t = torch.ones(4, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        q.put((rank, f"accepted: all_reduce gave {t.tolist()}"))
    except Exception as e:  # the refusal is what this run records
        q.put((rank, f"refused: {type(e).__name__}: "
                     f"{str(e).strip().splitlines()[0]}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_group(target, args_of, world: int, timeout_s: float) -> list:
    """Start `world` spawned processes of target(*args_of(rank)); wait up to
    timeout_s for all, kill whatever is left; returns their exit codes."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    return [p.exitcode for p in procs]


def hold_sharded_mesh(tag: str, res: dict, main_faces, R: int) -> None:
    """Faces equal to the main path's, in order; vertices on the surface
    within SURFACE_TOL + the records' u8 edge step."""
    tol = SURFACE_TOL + 3 * 2.0 / (R - 1) / 510
    dist = np.abs(np.abs(res["verts"]).sum(1) - 0.6)
    same = np.array_equal(res["faces"], main_faces)
    print(f"{tag} faces equal to the main path's={same} "
          f"({len(res['faces'])} faces), max surface distance "
          f"{dist.max():.3e} (tolerance {tol:.3e})")
    check(same, f"{tag}: the faces differ from the main path's")
    check(float(dist.max()) <= tol, f"{tag}: a vertex is {dist.max():.3e} "
                                    "off the surface")


def phase_dist(img, trans, main_faces, main_wall_ms: float) -> None:
    """[dist]: image_to_mesh_sharded at 257^3 bf16 over a 1-rank NCCL group
    in this process, then over 2 gloo ranks sharing card 0 (spawned), with
    a data-parallel train step; NCCL with 2 ranks on one card; NCCL with a
    card a rank when there are 2 cards."""
    import pickle
    import shutil

    import torch
    import torch.distributed as dist

    from disn_tpu_torch import parallel
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import synthetic
    from disn_tpu_torch.train import trainer

    smi = card_name()
    cfg = Config(sdf_res=256, compute_dtype="bfloat16")
    R = cfg.grid_resolution
    params = synthetic.analytic_octahedron_params(cfg, seed=0, r=0.6)
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        res = sharded_image(parallel.make_mesh(1, 1), cfg, params, img, trans)
    finally:
        dist.destroy_process_group()
    print(f"[dist nccl 1 rank] {smi}: image_to_mesh_sharded wall "
          f"{res['wall_ms']:.3f} ms (main path median {main_wall_ms:.3f}), "
          f"K1 launches {res['k1_launches']}, K1 ms {res['k1_ms']}, active "
          f"cells {res['active_cells']}, stripe {res['stripe_cells']}, "
          f"gather {res['gather_ms']:.3f} ms")
    check(res["k1_launches"] == 2 and not res["dense_fallback"],
          f"[dist nccl 1 rank]: {res['k1_launches']} K1 launches, "
          f"fallback {res['dense_fallback']}: expected 2 and none")
    hold_sharded_mesh("[dist nccl 1 rank]", res, main_faces, R)

    os.makedirs(DIST_DIR, exist_ok=True)
    try:
        tcfg = Config()
        batch = dist_batch(tcfg)
        port = free_port()
        codes = spawn_group(dist_rank, lambda r: (r, 2, port, "gloo", {
            "img": img, "trans": trans, "batch": batch}), 2, DIST_TIMEOUT_S)
        check(codes == [0, 0], f"[dist gloo] the ranks exited {codes}")
        ranks = []
        for r in range(2):
            with open(os.path.join(DIST_DIR, f"gloo{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        for r, res in enumerate(ranks):
            print(f"[dist gloo 2 ranks on one card] rank {r} {smi}: wall "
                  f"{res['wall_ms']:.3f} ms, K1 stripe "
                  f"{res['k1_ms'][-1]:.4f} ms (CUDA events; coarse pass "
                  f"{res['k1_ms'][0]:.4f}), share {res['stripe_cells']} of "
                  f"{res['active_cells']} cells, gather "
                  f"{res['gather_ms']:.3f} ms, step {res['step_ms']:.1f} ms "
                  "(both ranks share card 0 and gloo copies through the "
                  "host: the cost of the collective path, not a speed-up)")
            hold_sharded_mesh(f"[dist gloo rank {r}]", res, main_faces, R)
        check(sum(r["stripe_cells"] for r in ranks)
              == ranks[0]["active_cells"], "[dist gloo] stripes do not add up")
        state = trainer.create_state(tcfg, seed=0)
        _, losses = trainer.make_train_step(tcfg)(state, batch)
        single = float(losses["overall_loss"])
        rel = abs(ranks[0]["loss"] - single) / abs(single)
        print(f"[dist gloo train] Config() f32, 2 x {tcfg.batch_size // 2} "
              f"rows: loss {ranks[0]['loss']:.7f} (rank 1 "
              f"{ranks[1]['loss']:.7f}) against one rank's "
              f"{single:.7f}: rel {rel:.2e} (bound {DIST_LOSS_RTOL})")
        check(rel <= DIST_LOSS_RTOL and ranks[0]["loss"] == ranks[1]["loss"],
              "[dist gloo train] the data-parallel loss is not the "
              "single step's")
        del state
        torch.cuda.empty_cache()

        import multiprocessing as mp
        q = mp.get_context("spawn").Queue()
        port = free_port()
        codes = spawn_group(nccl_dup_rank, lambda r: (r, port, q), 2,
                            NCCL_DUP_TIMEOUT_S)
        said = []
        while not q.empty():
            said.append(q.get())
        print(f"[dist nccl 2 ranks on one card] exit codes {codes}: "
              f"{sorted(said) or 'no answer before the time limit'}")
        if torch.cuda.device_count() >= 2:
            port = free_port()
            codes = spawn_group(dist_rank, lambda r: (r, 2, port, "nccl", {
                "img": img, "trans": trans}), 2, DIST_TIMEOUT_S)
            check(codes == [0, 0], f"[dist nccl] the ranks exited {codes}")
            for r in range(2):
                with open(os.path.join(DIST_DIR, f"nccl{r}.pkl"), "rb") as f:
                    res = pickle.load(f)
                print(f"[dist nccl multi-card] rank {r}: wall "
                      f"{res['wall_ms']:.3f} ms, K1 stripe "
                      f"{res['k1_ms'][-1]:.4f} ms, share "
                      f"{res['stripe_cells']} of {res['active_cells']}")
                hold_sharded_mesh(f"[dist nccl rank {r}]", res, main_faces,
                                  R)
        else:
            print("[dist] nccl multi-card: not run (1 card)")
    finally:
        shutil.rmtree(DIST_DIR, ignore_errors=True)


# -- the farm's pipeline and the closed-loop tools ---------------------------

PIPE_DIR = os.path.join(ROOT, "build", "chip_smoke_pipe")  # removed after
PIPE_DEPTHS = (1, 2, 3)
PIPE_TURNS = 2
# the C++ passes of the record route's host assembly
PIPE_PASSES = ("derive_recs", "mesh_faces_blocks", "mesh_verts_blocks",
               "mesh_assemble")
# CUDA runtime calls in which the calling host thread waits for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")
CONV_JAX = os.path.join(ROOT, "TRAIN_CONV_r05.json")  # the JAX package's
REHEARSAL_DIR = os.path.join(ROOT, "build", "chip_smoke_rehearsal")
REHEARSAL_OBJS, REHEARSAL_VIEWS = 4, 24
CL_FLOOR_RATIO = 1.25   # gt-cam: CD and EMD within this of the noise floor
CL_IOU = 0.999
CL_CAM_REL = 1e-3       # cam-est: the card's camera against the CPU's


def tree_digests(root: str) -> dict:
    """{relative path: sha256} of every file under root."""
    import hashlib

    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


class PassSpy:
    """native's assembly passes wrapped: the calls made on the thread that
    made the spy (the farm's calling thread) are counted; the seconds of
    the calls on any other thread are summed. close() unwraps them."""

    def __init__(self):
        import threading

        from disn_tpu_torch import native
        self.native, self.threading = native, threading
        self.main = threading.get_ident()
        self.lock = threading.Lock()
        self.saved = {n: getattr(native, n) for n in PIPE_PASSES}
        self.reset()
        for n, fn in self.saved.items():
            setattr(native, n, self._wrap(fn))

    def reset(self) -> None:
        self.main_calls, self.pool_calls, self.pool_s = 0, 0, 0.0

    def _wrap(self, fn):
        def spy(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                with self.lock:
                    if self.threading.get_ident() == self.main:
                        self.main_calls += 1
                    else:
                        self.pool_calls += 1
                        self.pool_s += dt
        return spy

    def close(self) -> None:
        for n, fn in self.saved.items():
            setattr(self.native, n, fn)


def sync_waits(prof) -> tuple[float, float, int, dict, int]:
    """From a torch.profiler run: (ms the calling thread spent in the CUDA
    runtime calls that wait for the card, SYNC_CALLS, ms of those calls on
    every other thread, the calling thread's kernel launches, the calling
    thread's ms and calls by name, its runtime launch calls of every kind,
    cluster launches (cudaLaunchKernelExC) included). The calling thread
    is the one that launched the kernels (the farm's pool launches none).
    A non-blocking cudaMemcpyAsync counts too: it returns at once, so it
    adds its few microseconds."""
    launches: dict = {}
    every: dict = {}
    waits: dict = {}
    named: dict = {}
    for evt in prof.events():
        if "LaunchKernel" in evt.name:
            every[evt.thread] = every.get(evt.thread, 0) + 1
        if evt.name == "cudaLaunchKernel":
            launches[evt.thread] = launches.get(evt.thread, 0) + 1
        elif evt.name in SYNC_CALLS:
            ms = evt.time_range.elapsed_us() / 1e3
            waits[evt.thread] = waits.get(evt.thread, 0.0) + ms
            named.setdefault(evt.thread, {}).setdefault(evt.name, [0.0, 0])
            named[evt.thread][evt.name][0] += ms
            named[evt.thread][evt.name][1] += 1
    if not launches:
        return float("nan"), float("nan"), 0, {}, 0
    main = max(launches, key=launches.get)
    return (waits.get(main, 0.0),
            sum(v for t, v in waits.items() if t != main), launches[main],
            named.get(main, {}), every.get(main, 0))


def farm_setup(flow: str = "words", base: dict | None = None) -> dict:
    """[farm pipe]'s split: [eval farm]'s 2 objects x 24 views (full-width
    net, analytic head, sdf_res 256, bf16, in-memory records) under
    PIPE_DIR, with whichever disn_tpu_torch is imported; flow "volume"
    takes sparse_words=False. With `base` (another flow's), its net and
    records."""
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.data import listing, synthetic

    cfg = Config(sdf_res=256, compute_dtype="bfloat16",
                 sparse_words=flow == "words")
    if base is not None:
        return dict(base, cfg=cfg)
    paths = listing.SplitPaths(os.path.join(PIPE_DIR, "sdf"),
                               os.path.join(PIPE_DIR, "renders"))
    views, sdf = farm_records(paths)
    return dict(cfg=cfg, paths=paths, views=views, sdf=sdf,
                params=synthetic.analytic_octahedron_params(cfg, seed=0,
                                                            r=0.6),
                listinfo=[(FARM_CAT, o, v) for o in FARM_OBJS
                          for v in range(FARM_VIEWS)],
                readers=dict(read_view=views.__getitem__,
                             read_sdf_params=sdf.__getitem__))


def farm_run(farm: dict, depth: int, tag: str) -> tuple[float, dict]:
    """One reconstruct_split of the split at `depth` into PIPE_DIR/tag:
    (images/s, {relative path: sha256} of the tree), the tree removed."""
    import shutil

    import torch
    from disn_tpu_torch.infer import pipeline

    root = os.path.join(PIPE_DIR, tag)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = pipeline.reconstruct_split(
        farm["params"], farm["cfg"], farm["paths"], farm["listinfo"], root,
        depth=depth, **farm["readers"])
    dt = time.perf_counter() - t0
    got = tree_digests(pipeline.result_dir(root, farm["cfg"]))
    shutil.rmtree(root)
    check(len(written) == len(farm["listinfo"]),
          f"farm pipe: {tag} wrote {len(written)} meshes")
    return len(farm["listinfo"]) / dt, got


def single_walls(farm: dict) -> list[float]:
    """The split's images one at a time through image_to_mesh, the card
    synchronised before and after each: their walls in ms (host clock)."""
    import torch
    from disn_tpu_torch.infer import pipeline

    cfg, paths, ms = farm["cfg"], farm["paths"], []
    for c, o, v in farm["listinfo"]:
        rec = farm["views"][paths.img_path(c, o, v)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.image_to_mesh(
            farm["params"], rec.img_arr[:, :, :cfg.img_channels],
            rec.trans_mat, cfg, sdf_params=farm["sdf"][paths.sdf_path(c, o)],
            iso=cfg.iso)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def farm_worker(checkout: str) -> int:
    """`chip_smoke.py --farm-worker DIR`: [farm pipe]'s runs with DIR's
    disn_tpu_torch (this checkout's, or another's unpacked with git
    archive). After one untimed run of each flow's split (the builds, the
    warm-up) it answers "FARM {"ready": true}", then each line of stdin:
    "depth N FLOW" runs FLOW's split ("words" or "volume", farm_setup) at
    depth N, "single FLOW" its images one at a time through image_to_mesh
    (single_walls), "profile FLOW" one depth-2 run under torch.profiler,
    "quit" ends; each answers one line "FARM <json>" on stdout (images/s
    and the tree's digests, the walls, or the calling thread's waits). Its
    trees go under PIPE_DIR/worker<pid>."""
    sys.path.insert(0, os.path.abspath(checkout))
    import torch
    from disn_tpu_torch.infer import pipeline

    tag = f"worker{os.getpid()}"
    farms = {"words": farm_setup("words")}
    farms["volume"] = farm_setup("volume", base=farms["words"])
    for farm in farms.values():
        farm_run(farm, 2, tag)
    print("FARM " + json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        cmd = line.split()
        if cmd[0] == "quit":
            break
        farm = farms[cmd[-1]]
        if cmd[0] == "depth":
            rate, got = farm_run(farm, int(cmd[1]), tag)
            out = {"rate": rate, "digests": got}
        elif cmd[0] == "single":
            out = {"ms": single_walls(farm)}
        else:
            root = os.path.join(PIPE_DIR, tag)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                pipeline.reconstruct_split(
                    farm["params"], farm["cfg"], farm["paths"],
                    farm["listinfo"], root, depth=2, **farm["readers"])
            import shutil
            shutil.rmtree(root)
            main_ms, other_ms, n_launch, named, every = sync_waits(prof)
            out = {"main_ms": main_ms, "other_ms": other_ms,
                   "launches": n_launch, "named": named, "every": every}
        print("FARM " + json.dumps(out), flush=True)
    return 0


class FarmWorker:
    """A farm_worker process on a checkout (this one, or another), made
    ready (built and warm) before this returns, then asked for one run at
    a time; close() ends it."""

    def __init__(self, checkout: str):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--farm-worker",
             checkout], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, cwd=ROOT)
        try:
            self.answer()
        except BaseException:
            self.close()
            raise

    def ask(self, cmd: str) -> dict:
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return self.answer()

    def answer(self) -> dict:
        for line in self.proc.stdout:
            if line.startswith("FARM "):
                return json.loads(line[5:])
            sys.stdout.write(line)
        raise SmokeFailure(f"farm pipe: a farm worker ended "
                           f"(exit {self.proc.wait()})")

    def close(self) -> None:
        try:
            if self.proc.poll() is None:
                self.proc.stdin.write("quit\n")
                self.proc.stdin.close()
                self.proc.wait(timeout=60)
        except Exception:  # a worker that does not end is killed
            pass
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


PIPE_FLOWS = ("words", "volume")


def phase_farm_pipe(smi: str, parent: str | None = None) -> None:
    """[farm pipe]: reconstruct_split's depth-deep pipeline on [eval
    farm]'s 2 objects x 24 views (farm_setup), on the words flow and, as
    [vspec farm], on the volume flow (sparse_words=False): first
    image_to_mesh + write_obj on this thread, image by image (each flow's
    reference tree; it leaves the speculative dispatch's prediction warm);
    then, in turns, PIPE_TURNS times, the parent's loop (image_to_mesh on
    this thread, writes on a pool; the words flow) and each flow's farm at
    depth 1, 2 and 3 (its K1/K5 counts set to 0 just before each run and
    read just after: 2 and 1 an image on the words flow, 2 and 0 on the
    volume flow; every image a hit of the speculative dispatch), each tree
    byte for byte its reference, the words farm's C++ passes called 0
    times on this thread (PassSpy), the volume farm's not at all;
    images/s, the pool's seconds in the passes; then one depth-2 run of
    each flow under torch.profiler for the calling thread's time blocked
    in the runtime's waits (sync_waits) and its launch calls, per image.
    With `parent` (another checkout, e.g. the parent commit's, unpacked
    with git archive), two farm_worker processes, one on that checkout and
    one on this, run both flows' farms at depth 1, 2 and 3 in turns
    (parent, change, change, parent): fresh processes alike, where this
    process carries every earlier phase's state. Their trees are held to
    the same references byte for byte, each times the volume flow's
    images one at a time in the same turns (single_walls), and each gives
    its calling thread's waits from one profiled depth-2 run of each
    flow."""
    import shutil

    import torch
    from disn_tpu_torch.core import codecs
    from disn_tpu_torch.infer import pipeline
    from disn_tpu_torch.ops import fused_decode, sparse_words

    k1 = fused_decode.fused_cell_decode
    k5 = sparse_words.sparse_cell_words
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    farms = {"words": farm_setup("words")}
    farms["volume"] = farm_setup("volume", base=farms["words"])
    farm = farms["words"]
    params, paths = farm["params"], farm["paths"]
    views, sdf, listinfo = farm["views"], farm["sdf"], farm["listinfo"]
    n = len(listinfo)
    tags = {"words": "[farm pipe]", "volume": "[vspec farm]"}
    refs: dict = {}
    seq_s: dict = {}
    for flow, f in farms.items():
        cfg = f["cfg"]
        ref_root = os.path.join(PIPE_DIR, "ref")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c, o, v in listinfo:
            rec = views[paths.img_path(c, o, v)]
            mesh = pipeline.image_to_mesh(
                params, rec.img_arr[:, :, :cfg.img_channels], rec.trans_mat,
                cfg, sdf_params=sdf[paths.sdf_path(c, o)], iso=cfg.iso)
            codecs.write_obj(os.path.join(pipeline.result_dir(ref_root, cfg),
                                          c, f"{c}_{o}_{v:02d}.obj"), *mesh)
        seq_s[flow] = time.perf_counter() - t0
        refs[flow] = tree_digests(pipeline.result_dir(ref_root, cfg))
        shutil.rmtree(ref_root)
        check(len(refs[flow]) == n,
              f"farm pipe: {len(refs[flow])} {flow} reference meshes")
        print(f"{tags[flow]} reference: image_to_mesh + write_obj on the "
              f"calling thread, {n} images in {seq_s[flow]:.3f} s = "
              f"{n / seq_s[flow]:.2f} images/s; {smi}")
    cfg = farm["cfg"]

    def parent_loop(root: str) -> None:
        """The parent's farm loop: image_to_mesh (its host assembly too)
        on the calling thread, the OBJ writes on a pool of 4 threads."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(4) as pool:
            futures = []
            for c, o, v in listinfo:
                rec = views[paths.img_path(c, o, v)]
                mesh = pipeline.image_to_mesh(
                    params, rec.img_arr[:, :, :cfg.img_channels],
                    rec.trans_mat, cfg, sdf_params=sdf[paths.sdf_path(c, o)],
                    iso=cfg.iso)
                futures.append(pool.submit(codecs.write_obj, os.path.join(
                    pipeline.result_dir(root, cfg), c,
                    f"{c}_{o}_{v:02d}.obj"), *mesh))
            for f in futures:
                f.result()

    def hits() -> int:
        return pipeline.spec_counts["hit"]

    # the order of a worker turn: parent, change; then change, parent
    who_dirs = ({os.path.basename(os.path.normpath(parent)): parent,
                 "this tree (worker)": ROOT} if parent else {})
    workers: dict = {}
    spy = PassSpy()
    rates: dict = {"parent loop": []}
    rates.update({f"{flow} {d}": [] for flow in PIPE_FLOWS
                  for d in PIPE_DEPTHS})
    rates.update({f"{w} {flow} {d}": [] for w in who_dirs
                  for flow in PIPE_FLOWS for d in PIPE_DEPTHS})
    walls: dict = {w: [] for w in who_dirs}

    def worker_turn(turn: int) -> None:
        for who in (list(workers) if turn % 2 == 0 else list(workers)[::-1]):
            ms = np.array(workers[who].ask("single volume")["ms"])
            walls[who].append(float(np.median(ms)))
            print(f"[vspec farm] {who}: the volume flow's {n} images one at "
                  f"a time through image_to_mesh (turn {turn + 1}; host "
                  f"clock, the card synchronised before and after each): "
                  f"median {np.median(ms):.3f} ms (quartiles "
                  f"{np.percentile(ms, 25):.3f}-{np.percentile(ms, 75):.3f}"
                  f"); {smi}")
            for flow in PIPE_FLOWS:
                for depth in PIPE_DEPTHS:
                    out = workers[who].ask(f"depth {depth} {flow}")
                    rates[f"{who} {flow} {depth}"].append(out["rate"])
                    print(f"{tags[flow]} {who}: the farm at depth {depth} "
                          f"(turn {turn + 1}): {n} images, "
                          f"{out['rate']:.2f} images/s; {smi}")
                    check(out["digests"] == refs[flow],
                          f"farm pipe: {who}'s {flow} tree at depth {depth} "
                          f"is not the reference's byte for byte")

    try:
        for who, checkout in who_dirs.items():  # one at a time, warm
            workers[who] = FarmWorker(checkout)
        for turn in range(PIPE_TURNS):
            if workers and turn % 2 == 0:
                worker_turn(turn)
            root = os.path.join(PIPE_DIR, "parent")
            before = hits()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parent_loop(root)
            dt = time.perf_counter() - t0
            got = tree_digests(pipeline.result_dir(root, cfg))
            shutil.rmtree(root)
            rates["parent loop"].append(n / dt)
            print(f"[farm pipe] the parent's loop (turn {turn + 1}): {n} "
                  f"images in {dt:.3f} s = {n / dt:.2f} images/s, "
                  f"{hits() - before} hits; {smi}")
            check(got == refs["words"], "farm pipe: the parent loop's tree "
                                        "is not the reference's byte for "
                                        "byte")
            for flow in PIPE_FLOWS:
                words = flow == "words"
                for depth in PIPE_DEPTHS:
                    spy.reset()
                    before = hits()
                    torch.cuda.synchronize()
                    k1.launches = k5.launches = 0
                    rate, got = farm_run(farms[flow], depth, f"d{depth}")
                    counts = (k1.launches, k5.launches)
                    rates[f"{flow} {depth}"].append(rate)
                    print(f"{tags[flow]} depth {depth} (turn {turn + 1}): "
                          f"{n} images, {rate:.2f} images/s, "
                          f"{hits() - before} hits; K1 {counts[0]}, K5 "
                          f"{counts[1]} launches; C++ passes: "
                          f"{spy.main_calls} calls on the calling thread, "
                          f"{spy.pool_calls} on the pool, "
                          f"{spy.pool_s * 1e3:.1f} ms there "
                          f"({spy.pool_s * 1e3 / n:.2f} ms an image); {smi}")
                    check(got == refs[flow], f"farm pipe: the {flow} flow's "
                                             f"tree at depth {depth} is not "
                                             f"the reference's byte for "
                                             f"byte")
                    check(counts == (2 * n, n * words)
                          and hits() - before == n,
                          f"farm pipe: {flow} depth {depth}: K1 {counts[0]} "
                          f"and K5 {counts[1]} launches, {hits() - before} "
                          f"hits; expected {2 * n}, {n * words} and {n}")
                    check(spy.main_calls == 0
                          and spy.pool_calls == 3 * n * words,
                          f"farm pipe: {flow} depth {depth}: "
                          f"{spy.main_calls} C++ pass calls on the calling "
                          f"thread and {spy.pool_calls} on the pool (0 and "
                          f"{3 * n * words} expected)")
            if workers and turn % 2 == 1:
                worker_turn(turn)
        waits: dict = {}
        for flow in PIPE_FLOWS:
            root = os.path.join(PIPE_DIR, "profiled")
            f = farms[flow]
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                pipeline.reconstruct_split(params, f["cfg"], paths, listinfo,
                                           root, depth=2, **f["readers"])
            shutil.rmtree(root)
            waits[("this tree", flow)] = sync_waits(prof)
            for who, worker in workers.items():
                out = worker.ask(f"profile {flow}")
                waits[(who, flow)] = (out["main_ms"], out["other_ms"],
                                      out["launches"], out["named"],
                                      out["every"])
        for (who, flow), (main_ms, other_ms, n_launch, named,
                          every) in waits.items():
            print(f"{tags[flow]} {who} under torch.profiler, depth 2: the "
                  f"calling thread waited {main_ms:.1f} ms in "
                  f"{'/'.join(SYNC_CALLS)} = {main_ms / n:.2f} ms an image "
                  f"({n_launch} cudaLaunchKernel calls from it, "
                  f"{n_launch / n:.1f} an image; every launch call, cluster "
                  f"launches included, {every / n:.1f} an image; by call, "
                  f"ms and calls: "
                  f"{ {k: [round(v[0], 2), v[1]] for k, v in named.items()} }"
                  f"); the other threads {other_ms:.1f} ms (the closures' "
                  f"event waits); {smi}")
    finally:
        spy.close()
        for worker in workers.values():
            worker.close()
        shutil.rmtree(PIPE_DIR, ignore_errors=True)
    if walls:
        print(f"[vspec farm] the volume flow's single-image medians by "
              f"tree, in turns: "
              f"{ {w: [round(m, 3) for m in v] for w, v in walls.items()} }"
              f"; {smi}")
    for flow in PIPE_FLOWS:
        mine = {d: [round(r, 2) for r in v] for d, v in rates.items()
                if flow in d.split() or (d, flow) == ("parent loop",
                                                      "words")}
        print(f"{tags[flow]} images/s by depth: {mine} against "
              f"{n / seq_s[flow]:.2f} with every write on the calling "
              f"thread too; {smi}")


def phase_conv(smi: str) -> None:
    """[conv]: tools.train_convergence at its defaults (full width, bf16,
    B = 20, 1500 steps through PrefetchLoader, image_to_mesh at sdf_res
    256, CD x 1000 on 30,000 samples by K6a): sign accuracy >= 0.9, more
    than 500 faces, a finite CD; beside the JAX package's reading."""
    import torch
    from disn_tpu_torch.tools import train_convergence

    t0 = time.perf_counter()
    out = train_convergence.run(
        log=lambda m: print(f"[conv] {m}", flush=True))
    wall = time.perf_counter() - t0
    with open(CONV_JAX) as f:
        ref = json.load(f)
    losses = out["losses"]
    print(f"[conv] overall_loss every 200 steps "
          f"{[round(x, 1) for x in losses[::200]]}, last {losses[-1]:.1f}; "
          f"{out['steps']} steps at {out['steps_per_s']:.3f} steps/s "
          f"(loader wait {out['loader_wait_s']:.2f} s); sign acc "
          f"{out['sign_acc']:.4f}; {out['tris']} faces (route "
          f"{out['route']}); CD*1000 {out['cd_x1000']:.4f}; phase "
          f"{wall:.1f} s; {smi}")
    print(f"[conv] the JAX package's reading (TRAIN_CONV_r05.json, its own "
          f"run, not on this card): sign acc {ref['sign_acc']:.4f}, "
          f"CD*1000 {ref['cd_x1000']:.4f}, {ref['tris']} faces at sdf_res "
          f"{ref['sdf_res']}, {ref['steps']} steps")
    check(out["sign_acc"] >= 0.9, f"conv: sign accuracy "
                                  f"{out['sign_acc']:.4f} < 0.9")
    check(out["tris"] > 500 and np.isfinite(out["cd_x1000"]),
          f"conv: {out['tris']} faces, CD {out['cd_x1000']}")
    torch.cuda.empty_cache()


def phase_closed_loop(smi: str) -> None:
    """[closed loop]: both rows of tools.closed_loop on the card (sdf_res
    256, bf16). gt-cam: the mesh has the ground truth's face count, IoU
    >= CL_IOU, F1 = 1 at 20% x 2.5, CD and EMD within CL_FLOOR_RATIO of
    their noise floor. cam-est: the card's camera within CL_CAM_REL of
    the port's CPU run on the same image, > 1000 faces, every metric
    finite."""
    import torch
    from disn_tpu_torch.config import Config
    from disn_tpu_torch.tools import closed_loop

    t0 = time.perf_counter()
    gt = closed_loop.gt_cam_row()
    print(closed_loop.report(gt))
    print(f"[gt-cam] {smi}")
    check(gt["faces"] == gt["gt_faces"],
          f"closed loop: {gt['faces']} faces, the ground truth has "
          f"{gt['gt_faces']}")
    check(gt["iou"] >= CL_IOU and gt["f1"][-1] == 1.0,
          f"closed loop: IoU {gt['iou']}, F1 at 20% {gt['f1'][-1]}")
    check(gt["cd"] <= CL_FLOOR_RATIO * gt["cd_floor"]
          and gt["emd"] <= CL_FLOOR_RATIO * gt["emd_floor"],
          f"closed loop: CD {gt['cd']} / EMD {gt['emd']} against floors "
          f"{gt['cd_floor']} / {gt['emd_floor']}")
    torch.cuda.empty_cache()
    cfg = Config(sdf_res=256, compute_dtype="bfloat16", width_mult=0.25,
                 num_classes=128)
    est = closed_loop.cam_est_row(cfg)
    cpu = closed_loop.cam_est_camera(cfg, device="cpu")
    card = np.asarray(est["pred_trans_mat"], np.float32)
    rel = float(np.abs(card - cpu["pred_trans_mat"]).max()
                / np.abs(cpu["pred_trans_mat"]).max())
    print(closed_loop.report(est))
    print(f"[cam-est] pred_trans_mat card vs CPU max|diff|/max|cpu| "
          f"{rel:.3e} (limit {CL_CAM_REL}); rot3d {est['rot3d']:.4f} / CPU "
          f"{cpu['rot3d']:.4f}, rot2d {est['rot2d']:.2f} / "
          f"{cpu['rot2d']:.2f} px; phase {time.perf_counter() - t0:.1f} s; "
          f"{smi}")
    vals = [est[k] for k in ("cd", "emd", "cd_floor", "emd_floor", "iou",
                             "rot3d", "rot2d")] + est["f1"]
    check(rel <= CL_CAM_REL, "closed loop: the card's estimated camera is "
                             "not the CPU's")
    check(est["faces"] > 1000 and all(np.isfinite(vals)),
          f"closed loop: cam-est mesh {est['faces']} faces, metrics {vals}")
    torch.cuda.empty_cache()


def phase_rehearsal(smi: str) -> None:
    """[rehearsal]: tools.eval_rehearsal at REHEARSAL_OBJS x
    REHEARSAL_VIEWS on the card: finite overall metrics, every object
    scored, the cached re-run's overall equal to the run that filled the
    cache; objects/min, the 1,311-object extrapolation, the host split."""
    import shutil

    from disn_tpu_torch.tools import eval_rehearsal

    try:
        out = eval_rehearsal.run(
            REHEARSAL_OBJS, REHEARSAL_VIEWS, root=REHEARSAL_DIR,
            log=lambda m: print(f"[rehearsal] {m}", flush=True))
    finally:
        shutil.rmtree(REHEARSAL_DIR, ignore_errors=True)
    ov = out["overall"]
    flat = [v for v in ov.values() if isinstance(v, float)]
    flat += [x for v in ov.values() if isinstance(v, list) for x in v]
    split = out["host_split"]
    per = max(split["objects"], 1)
    print(f"[rehearsal] overall {json.dumps(ov)}; faces an object "
          f"{out['faces']}; the cached overall equals the full protocol's: "
          f"{out['cached_overall'] == ov}; {smi}")
    print(f"[rehearsal] host half per object, one thread: parse "
          f"{split['parse_s'] / per * 1e3:.1f} ms, sample "
          f"{split['sample_s'] / per * 1e3:.1f} ms, voxelize "
          f"{split['voxelize_s'] / per * 1e3:.1f} ms "
          f"({REHEARSAL_VIEWS + 1} meshes); {smi}")
    check(out["total_objects"] == REHEARSAL_OBJS and all(np.isfinite(flat)),
          f"rehearsal: {out['total_objects']} objects, overall {ov}")
    check(out["cached_overall"] == out["cache_fill_overall"]
          and out["cached_objects"] == REHEARSAL_OBJS,
          "rehearsal: the cached re-run's overall differs")


def k1_entries(res: dict, launches: dict) -> list[dict]:
    """K1's two kernels, each per image: its coarse + fine launch on the
    main path's own inputs (the error: the worst of every timed hold of the
    type, random weights included); no single PyTorch call computes K1."""
    out = []
    for dt in ("bf16", "f32"):
        ref = [res[(dt, "main", p)] for p in ("coarse", "fine")]
        out.append({
            "name": f"fused_cell_decode[{dt}]", "route": "cuda",
            "source": "disn_tpu_torch/csrc/fused_decode.cu",
            "replaces": "disn_tpu/ops/pallas_fused.py:46",
            "launches": launches[f"k1 {dt}"],
            "max_abs_err": max(r["max_abs_err"] for k, r in res.items()
                               if k[0] == dt),
            "ms": sum(r["ms"] for r in ref),
            "plain_ms": sum(r["plain_ms"] for r in ref),
            "bound_ms": sum(r["bound_ms"] for r in ref),
            "bound_by": ref[1]["bound_by"], "library_ms": None})
    return out


def k6_entries(hold: dict, counts: dict) -> list[dict]:
    lines = {"nn_distance": 38, "approx_match": 75, "match_cost": 116,
             "match_cost_grad": 129}
    return [{"name": name, "route": "cuda",
             "source": "disn_tpu_torch/csrc/metrics.cu",
             "replaces": f"disn_tpu/eval/metrics.py:{line}",
             "launches": counts[name], **hold[name]}
            for name, line in lines.items()]


def cull_entries(k4: dict, kc: dict, launches: dict) -> list[dict]:
    """K4 ([k4]: the fused call of tau and the cull, the main path's fixed
    form on its coarse grid; it replaces both functions, :113 and :67) and
    the compaction ([compact]: the words flow's capped launch of the main
    path); launches from the main path's run of phase 2."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rows = (("band_cull", "band_cull", "disn_tpu/infer/sparse.py:113",
             k4["band_cull"], launches["band_cull"],
             {"also_replaces": "disn_tpu/infer/sparse.py:67"}),
            ("compact_block_bits", "block_compact",
             "disn_tpu/ops/marching.py:694", kc, launches["compact"], {}))
    return [{"name": name, "route": "cuda",
             "source": f"disn_tpu_torch/csrc/{src}.cu", "replaces": where,
             "launches": n, **{k: res[k] for k in keys}, **extra}
            for name, src, where, res, n, extra in rows]


def scan_owned_entries(so: dict, launches: dict) -> list[dict]:
    """K2s ([scan owned]: the coarse scan's fixed form on a volume-flow
    hit's inputs; it replaces :540 with :608's packing and flags) and K7
    (the fixed extractor on the same hit's inputs); launches from the
    volume flow's run in phase 2 (a seed and 3 hits)."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rows = (("change_scan", "change_scan", "disn_tpu/ops/marching.py:540",
             so["scan"], {"also_replaces": "disn_tpu/ops/marching.py:608"}),
            ("extract_owned", "owned_extract",
             "disn_tpu/ops/marching.py:780", so["extract"], {}))
    return [{"name": name, "route": "cuda",
             "source": f"disn_tpu_torch/csrc/{src}.cu", "replaces": where,
             "launches": launches[name], **{k: res[k] for k in keys},
             **extra}
            for name, src, where, res, extra in rows]


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of disn_tpu_torch "
                                             "on one NVIDIA GPU.")
    ap.add_argument("--parent", default=None,
                    help="root of another checkout (for example the parent "
                         "commit's, unpacked with git archive) whose K1 and "
                         "K6 also run: its K1 timed in turns with this "
                         "checkout's on the main path's kept inputs, its "
                         "K6b on [eval hold]'s and [eval farm]'s clouds, "
                         "measured against the float64 referee, its K6d "
                         "likewise, its K6a, K6c and K6d timed in turns "
                         "with this checkout's at the protocol's shape; its "
                         "K4 and compaction in turns with this checkout's "
                         "in [k4] and [compact]; its candidate scan and "
                         "owned extractor in turns with this checkout's in "
                         "[scan owned]; its farm in turns with this "
                         "checkout's in [farm pipe]; its multi-view decode "
                         "in turns with this checkout's in [mv full]")
    ap.add_argument("--farm-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.farm_worker:  # [farm pipe]'s runs of a checkout
        return farm_worker(args.farm_worker)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    try:
        import disn_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (disn_tpu_torch "
              "not found)", file=sys.stderr)
        return 2
    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        phase_build()
        if args.parent:
            from disn_tpu_torch import kernels
            PARENT_K6.update(k6_runners(kernels.nvcc_build(
                "metrics", src=os.path.join(args.parent, "disn_tpu_torch",
                                            "csrc", "metrics.cu"))))
            PARENT_K1.update(k1_parent(args.parent))
            PARENT_CULL.update(cull_parent(args.parent))
            PARENT_SO["marching"] = so_parent(args.parent)
            PARENT_SO["k7"] = so_parent_k7(args.parent)
            PARENT_MV["mod"] = mv_parent(args.parent)
        launches, runs, vruns, kept, held = phase_main_path()
        main_inputs = (held["cfg"], held["params"], held["img"],
                       held["trans"])
        k5 = hold_swords(*main_inputs, kept)
        phase_spec(card_name())
        phase_vspec(card_name())
        so = phase_scan_owned(
            kept, held["cfg"].replace(sparse_words=False), held["params"],
            held["img"], held["trans"])
        k1 = phase_k1_check(kept)
        time_k1_turns(kept, k1)
        hold_routes("257^3 bf16", held["257"],
                    main_mesh=held["bf16 volume"][1])
        hold_routes("49^3 f32", held["49"])
        hold_divisions(held["49"])
        time_extraction(held["257"])
        compare_flows(held["cfg"], held["params"], held["trans"])
        k4 = profile_phase_a(*main_inputs)
        kc = phase_compact(kept, lambda: image_turns(*main_inputs))
        phase_dist(held["img"], held["trans"], held["bf16"][1][1],
                   float(np.median([r["wall_ms"] for r in runs[1:4]])))
        pred_mesh = held["bf16"][1]
        mv_mesh = held["bf16 volume"][1]
        main_faces = {"bf16": pred_mesh[1], "f32": held["f32"][0][1]}
        cam_inputs = (held["img"], pred_mesh,
                      float(np.median([r["encode_ms"] for r in runs[1:4]])))
        del held, main_inputs
        torch.cuda.empty_cache()
        gt_mesh = octahedron_mesh(128, "float32")
        k6 = phase_eval_hold(pred_mesh, gt_mesh)
        torch.cuda.empty_cache()
        k6_counts = phase_eval_farm(gt_mesh)
        torch.cuda.empty_cache()
        smi = card_name()
        phase_farm_pipe(smi, args.parent)
        phase_closed_loop(smi)
        phase_rehearsal(smi)
        torch.cuda.empty_cache()
        records = phase_train()
        phase_conv(smi)
        phase_cam(records, *cam_inputs)
        del cam_inputs, pred_mesh
        torch.cuda.empty_cache()
        k8 = phase_mv(mv_mesh)
        torch.cuda.empty_cache()
        # the binary dense route's K1 holds count in K1's max_abs_err
        for dt, held_k1 in phase_var(records, mv_mesh).items():
            k1[(dt, "binary dense launch", "subset")] = held_k1
        torch.cuda.empty_cache()
        phase_enc(records, main_faces, kept)
        del records
        torch.cuda.empty_cache()
        phase_prep()
        for flow, timed, keys in (
                ("words", runs[1:4], ("encode_ms", "prep_ms", "phase_a_ms",
                                      "phase_b_ms", "scan_ms",
                                      "extraction_ms", "extract_ms",
                                      "fetch_ms", "assemble_ms", "wall_ms",
                                      "k1_ms", "k5_ms")),
                ("volume", vruns[1:4], ("encode_ms", "prep_ms", "phase_a_ms",
                                        "phase_b_ms", "scan_ms",
                                        "extraction_ms", "extract_ms",
                                        "fetch_ms", "wall_ms", "k1_ms"))):
            tag = f"[stages bf16 257^3 {flow}]"
            for key in keys:
                vals = [r[key] for r in timed]
                print(f"{tag} {key} median={np.median(vals):.3f} "
                      f"all={[round(v, 3) for v in vals]}")
            print(f"{tag} active_cells={[r['active_cells'] for r in timed]} "
                  f"fine_cells={[r['fine_cells'] for r in timed]} faces="
                  f"{[r['faces'] for r in timed]} verts="
                  f"{[r['verts'] for r in timed]} route="
                  f"{[r['route'] for r in timed]}")
        print(f"[card] {card_name()}")
        print(f"[total] {time.perf_counter() - t0:.1f} s")
        print_k1_shares(kept, k1)
        print(json.dumps({"kernels": [
            *k1_entries(k1, launches), *k6_entries(k6, k6_counts), {
            "name": "sparse_cell_words", "route": "cuda",
            "source": "disn_tpu_torch/csrc/sparse_words.cu",
            "replaces": "disn_tpu/ops/marching.py:1102",
            "launches": launches["k5"],
            "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
            "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
            "bound_by": k5["bound_by"], "library_ms": None},
            *cull_entries(k4, kc, launches),
            *scan_owned_entries(so, launches), *mv_entries(k8)]}))
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

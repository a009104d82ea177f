#!/usr/bin/env python3
"""Drive the PyTorch port (gator_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each:
  1. card: name and power limit (nvidia-smi), CUDA version; TF32 off;
  2. build: compile K1 (csrc/gat_trunk.cu) and K2 (csrc/lbf_stack.cu);
  3. K1 against its plain version, full width, at B=1, 300 (a few
     tiles), 1001 (a ragged last tile) and 2048, J=17 and 19 (f32 within
     1e-4, bf16 reported);
  4. K2 against its plain version, B=16 and the serving batch B=2048, 431
     vertices, J=17 and 19 (f32 within 1e-4, bf16 within 5e-2; the
     kernels line reports bf16's, the dtype phase 7 times);
  5. end to end: full-width synthetic 6890-vertex model, kernel path
     against the plain path (f32 within 1e-4 m; bf16 within 5e-2 m of f32);
  6. the serve CLI on 300 seeded COCO poses: this is the main path the
     launch counts are read from (reset just before, read just after);
  7. times at B=2048, bf16: K1, K2 and the whole serving call, each kernel
     path beside its plain version (CUDA events, median of 5); K2's two
     launches (rows_kernel, lbf_selfattn_kernel) in device ms per serving
     call and K1's launch from torch.profiler, each beside its bound, with
     K1's registers, CTAs per SM and shared bytes and the plan of K2's bf16
     rows kernel (csrc/lbf_rows_wg.cuh), whose launches the trace must show
     under gator::lbf_wg and none of lbf_layer.cuh's; K1 and the serving call
     at B=1, 64 and 256, each beside its plain version.
The training path (K4 csrc/lbf_stack_train.cu, K5 csrc/gat_trunk_train.cu):
  8. (a) K4 and K5 are built with the others in phase 2;
  9. (b) K5 at full width (depth 6, B=64 and 512) and K4 (3 layers,
     Nv=431, B=16 and 512), J=17 and 19, default rates, mask export on;
     B=512 is the main path's batch, at which each of K4's row-launch CTAs
     walks ~52 row tiles of 16 across samples: every exported mask equals
     the plain hash bit for
     bit; output, dx, dbias or djoints and every parameter gradient
     against the plain version fed those masks (f32 within 1e-4, gradients
     scaled by their max; bf16 reported); keep fractions;
 10. (c) determinism at B=512: two runs with one seed are bit-identical,
     another seed differs;
 11. (d) a stage-2 step on the kernels against the plain step, zero rates,
     f32, B=16 (loss rtol 1e-5, gradients scaled within 1e-4);
 12. (e) the main training path: 20 stage-2 steps, full width, bf16,
     default rates, B=512, one fixed batch of bench.py's shapes, human36
     (alpha False) and coco (alpha True): losses finite and falling, every
     K4/K5 forward and backward counter above 0 (reset just before, read
     just after);
 13. (f) 10 stage-1 steps at B=256 (configs/gat_synthetic_e2e.yml), the same
     checks;
 14. (g) times at B=512, bf16: the stage-2 and stage-1 steps, and K4/K5
     forward and backward, each beside the plain version; K4's eight
     launches (the row-local lbf_rows_fwd, lbf_rows_bwd + lbf_wgrad; the
     rest: lbf_sa_fwd, lbf_sa_bwd_dq, lbf_sa_bwd_dkv, lbf_joints_bwd,
     lbf_reduce) and K5's four (gat_block_fwd, gat_block_bwd,
     gat_block_wgrad, the reductions) in device ms per step from
     torch.profiler, each beside its bound (the rest's from the bytes the
     function needs, with the interface's beside them where they differ);
     the registers and CTAs per SM of K5's launches and of K4's rest.
The evaluation path (K3 csrc/fused_attention.cu, the MDR vertex
self-attention of the module form):
 15. (h) K3 is built with the others in phase 2;
 16. (i) K3 against its plain version: B=16, the real-dataset test
     configs' batch B=64 and the eval batch B=512 at Nq=Nk=431, 2 heads of
     32, no bias; with a bias at 431x431, at the
     GAT shape 17x17, 8 heads of 16, and at 1000x1000, 2 heads of 64 (K/V
     staged in chunks); f32 (3xTF32) within 1e-4, bf16 reported; the
     autograd Function's dq, dk, dv, dbias against autograd through the
     plain version (f32, scaled by their max, within 1e-4);
 17. (j) the main eval path, every kernel counter reset just before and
     read just after: `gator_tpu_torch.cli.test.main` on
     configs/gator_synthetic_e2e.yml --synthetic at full width (human36),
     the same session with coco input and alpha True, the GAT config
     configs/gat_synthetic_e2e.yml (no kernel), and a Session/run_eval run
     over 2048 samples at B=512 (four batches): K3 launched 3 times per
     GATOR batch, K1/K2/K4/K5 never; then the 2048-sample run with plain
     attention: every predicted mesh within 1e-4 m, MPJPE and MPVPE within
     1e-3 mm, all finite;
 18. (k) times at B=512 (CUDA events, median of 5): K3 beside its plain
     version and scaled_dot_product_attention (f32 and bf16), the eval
     step; the eval loop in poses/s on the host clock and the share of it
     that GT synthesis alone takes.
The tool paths (K2-layer csrc/lbf_layer.cu, T1 csrc/lbf_ablate.cu, both
built in phase 2):
 19. (l) K2-layer against its plain version at B=16 and the tool's B=2048,
     431 vertices, J=17 and 19 (f32 within 1e-4, bf16 reported), and in f32
     against K2 run on the same one-layer weights (within 1e-4);
 20. (m) every T1 mode against its plain version, B=16 and the tool's
     B=2048, 431 vertices, 3 layers, J=17 and 19 (f32 within 1e-4, bf16
     reported); at B=16 `group` 1 and 8 give bit-equal outputs;
 21. (n) the two tool paths, each with the counters reset just before and
     read just after: `python -m gator_tpu_torch.tools.profile_serving`
     (K1, K2 and K2-layer launched) and `... exp_mdr_ablate` with its
     default modes (T1 launched), then every T1 mode's time; then times at
     B=2048 bf16: K2-layer per layer and T1 `full` over 3 layers, each
     beside its plain version; their two launches apart (`rows_kernel`,
     `attn_kernel`) in device ms from torch.profiler, each beside its
     bound; the attention kernel's registers, CTAs per SM, shared bytes
     and K/V chunk keys for K2-layer and each T1 variant; and, for scale
     only, scaled_dot_product_attention on the same q2/k2/v2 (the
     attention alone, without the probability rounding, L3 or the
     residual; the port never calls it).
The real-dataset path (no new kernel; K1-K5 through the entry points), on
fabricated annotation trees in the readers' real schemas
(`write_fixtures`), each phase with every counter reset just before and
read just after:
 22. (o) the trees: Human36M train (subjects 1/5/6/7/8, 1280 rows) and
     test (9/11, 2048 frames at camera 4, two without an SMPL fit, with
     absnet_output_on_testset.json), 3DPW test (512 rows, both genders),
     COCO and MuCo train (1024 each), read through GATOR_DATA_DIR;
 23. (p) `cli.test.run_test` at full width with a saved seeded checkpoint
     on configs/gator_human36J_test_human36_det.yml (detector input, the
     H36M protocol-2 suite per action) and
     configs/gator_cocoJ_test_human36_coco_muco_gt.yml (the 3DPW suite): K3
     3 times per batch and nothing else, the suite's four metrics finite,
     the card's suite within rel 1e-5 of the same suite on the CPU, the GT
     mesh as prediction reading MPVPE 0;
 24. (q) 5 stage-2 steps of configs/gator_synthetic_flagship.yml's mix
     (Human36M + COCO + MuCo readers, COCO joints, detector noise,
     augmentation on) at B=512 bf16 on the kernels, batches from
     `data.BatchPipeline` (the host path): losses finite, K4 and K5 launched
     and nothing else; then the host ms per batch of the pipeline alone
     with `synthesize_pose_batch` split out, the step's ms on batches
     already made, and the ms per step fed by the pipeline, each on its own
     line, with the card's name and power limit;
 25. (r) the serve CLI with --obj_dir, --obj_every 100 and --f32 on 300
     poses: K1 and K2 launched, three .obj files, the meshes within 1e-4 m
     of make_serving_fn in f32.
The in-step input paths (TRAIN.gt_in_step; no new kernel, K4 and K5 on
every step):
 26. (s) detector noise on the card (data/device_noise.py): fed uniforms
     drawn on the CPU, `synthesize_pose_device` at B=512 gives the CPU
     form's output within 1e-3 px on every (row, joint) but at most 0.2 %
     boundary cases, each shown (`noise_same_draws`), and
     `h36m_syn_error_device` within 1e-6; with the card's own generator,
     4096 poses over the recipe's three OKS areas against the host
     `synthesize_pose_batch`: every state frequency within 0.01, the KS
     distance of the error radii within max(0.01, 3 sqrt(2 / (17 N)))
     (tools/check_noise_distribution.py's gate); the sampler's device ms
     and launches at B=512 (torch.profiler);
 27. (t) `Session(cfg, is_train=True)`, each run with every counter reset
     just before and read just after: configs/gator_synthetic_flagship.yml
     on the phase-22 trees, where "auto" resolves to "device": 5 stage-2
     steps at B=512 bf16 from index batches, losses finite, K4 and K5
     launched and nothing else, no device-to-host sync in the step's input
     assembly (`torch.cuda.set_sync_debug_mode("error")`); then, each on
     its own line with the card, the host ms per index batch, the ms per
     step fed by the pipeline with the mesh cache on and off, and phase
     24's host-path figures; then configs/gator_synthetic_e2e.yml and
     configs/gat_synthetic_e2e.yml ("full", stages 2 and 1) and one "on"
     run, augmentation on: the wrapped step's batch against the host
     path's at the same rows, flips and rotations (pose2d 1e-5, mesh 2e-6
     m, joints 2e-3 mm, masks equal), 3 steps each, losses finite.
The train CLI (cli/train.py through the port's convergence tool,
gator_tpu_torch/tools/run_convergence_cli.py; no new kernel), each run
with every counter reset just before and read just after:
 28. (u) (a) configs/gator_synthetic_convergence.yml at the tool's
     defaults (12 epochs, n=2048, B=256 bf16, gt_in_step full, plateau,
     edge gate at epoch 4): every epoch evaluated, finite, the best below
     the first, best.pth.tar written; the tool's `passed` and failures,
     the per-epoch eval MPJPE, samples/s and train/eval/save seconds, and
     K5, K4 and K3 launched the same number of times every epoch; (b) the
     flagship-shaped two-stage recipe (stage 1
     configs/gat_cocoJ_synthetic_convergence.yml, 8 epochs; stage 2
     configs/gator_synthetic_flagship.yml, 12 epochs, B=512) against the
     port's own scratch run of the same stage-2 config: passed,
     beats_scratch and the curves are printed, not checked; (c)
     configs/gator_synthetic_smoke.yml at full width, a SIGTERM in epoch 2,
     then --resume_training: the epoch-2 loss and eval errors within rel
     1e-4 of an uninterrupted run's; the artifacts go to
     build/convergence/, and the phase's wall time is printed.
The demo and the rest of the JAX package's surface (no new kernel; K3 at a
batch of one), at full width, f32, TF32 off:
 29. (v) `gator_tpu_torch.cli.demo.main` with seeded weights (--weights)
     on the fabricated COCO pose of tests/test_coverage_extras.py: coco
     closed-form, coco --adam_fit and human36, every counter reset just
     before and read just after each run, cv2 hidden: K3 launched 3 times
     and nothing else, demo_mesh.obj with 6890 finite vertices, the two
     PNGs skipped and named in the printed line; each mesh within 1e-4 m of
     the same model's plain path on the same input, the closed-form
     cameras within rel 1e-4 of the fit on the CPU, the fitted (s, tx, ty)
     and L1 of both fits printed; the software renderer's time on the coco
     mesh (at least one pixel covered) and each run's wall time (host
     clock); K3 at B=1, 431x431, 2 heads of 32 against its plain version
     (f32 within 1e-4, bf16 reported), with its time, the plain version's
     and scaled_dot_product_attention's beside its bound; the native
     library built with the host's C++ compiler and held equal to the
     numpy forms (the human36 and coco graph tables, build_coarse_graphs on
     the 6890-vertex mesh); MeshResampler down and up, GraphResBlock,
     mano_forward on synthetic_mano(0), rot6d_to_rotmat and
     one_euro_smooth_torch on the card within 1e-5 of the CPU;
     profiling.trace around one demo forward and device_memory_stats; the
     phase's wall time. The demo's K3 launches join the eval path's in the
     kernels line.
Data parallelism (gator_tpu_torch.parallel; K4 and K5 with their sample
base, K1-K3 unchanged), at full width, human36, the BatchNorm head with
seeded running stats:
 30. (w) (a) world 1 over NCCL on cuda:0 in this process, every counter
     reset just before and read just after: the stage-2 step at B=512 bf16
     with the default rates, `run_eval` over 377 samples (300 and a ragged
     77) and the sharded serving call at B=256 bf16 bit-equal to the
     one-device path (loss, every gradient, every parameter and running
     stat after the step, the eval means, count and collected rows, the
     served meshes), K1-K5 launched; then the step with the SIGTERM flag
     after it, as the train CLI runs it, timed on the host clock on both
     paths, alternating (median of 10), and the flag alone; K4's and K5's
     masks exported at
     sample0 = 64 equal rows [64, 128) of a 128 batch's and their plain
     versions', bit for bit; (b) world 2 over gloo, both ranks on cuda:0
     (`parallel.spawn`, its own time limit), against one process on the
     global batch: the step's loss rtol 1e-4, every gradient scaled by its
     max within 1e-3 (in bf16 those outside K4/K5 within 2^-7), the
     running stats within 1e-4, K4/K5 launched on every rank, the eval
     means rel 1e-6 with the count, the collected rows in order and, as
     the served f32 meshes, bit-equal to the one-device path on each
     rank's rows (their distance from the whole batch's printed; serving
     within 1e-6 m of it); each step's host ms (median of 5) for one
     process and world 2; a planted fault in the bf16 step (masks keyed
     from sample 0 on both ranks; the BatchNorm statistics not
     all-reduced) must break a bar, and its readings are printed; (c) the
     same over NCCL with one rank per card where the host has two or more
     cards, with the step's rate and card count at B=512 and at 512 a
     card, else a line that says it did not run. Its world-1 launches
     join the kernels line.
The GAT kernels' second width and the root-level tools (no new kernel):
 31. (x) (a) the full-width human36 model at embed 64 (8 heads of 8): K1
     against its plain version at B=1, 1001 and 2048 (f32 within 1e-4,
     bf16 reported, each run repeatable bit for bit), the serving call in
     f32 (mesh within 1e-4 m of the plain path) and bf16 (5e-2 m) with the
     counters reset just before and read just after; K5 at B=512 with its
     exported masks (equal to the hash) against its plain version (output,
     dx, dbias and every parameter gradient scaled by their max, f32
     within 1e-4, bf16 reported); a kernel step against a plain step (f32,
     zero rates, B=16: loss rel 1e-5, gradients 1e-4); three stage-2
     steps at B=512 bf16 with the counters reset just before and read
     just after (losses finite, K5 and K4 launched); the C=64 errors, K1's
     and K5's times beside their plain versions and bounds on a line of
     their own; (b) the five tools through their `main(argv)` at a reduced
     size, each JSON read back: the noise gate at n=30,000 (started after
     the build in a process of its own, so that its host forms overlap
     the card's phases) passed, every noise-ablation variant and
     component timed, `gumbel_pick`'s band diff (the shipped law drawn
     again) below 0.02 and the bf16 variants' printed (the JAX tool finds
     them suspect), the train ablation's seven variants with the
     sweep, the derived block and `not_ported`, the split's seven parts
     and the GT-synthesis profile's three steps and four parts, each with
     device time; the phase's wall time. Its main-path K1 and K5 launches
     join the kernels line.
MotionBERT's serving call (models/motionbert.py; K3's serving path):
 32. (y) (a) K3's two modes at 128 clips x 16 frames x 17 joints, 8 heads
     of 64, on views of one qkv product: spatial [2048, 17, 8, 64] and
     temporal [128, 17, 16, 8, 64] written through a permuted view,
     against its plain version (f32 within 1e-4, bf16 within 5e-2, the
     bf16 ulps reported), each mode's ms a launch (CUDA events) beside
     its bound; (b) the full-width model
     (`build_motionbert_mesh`, the head at xavier gain 1 and a drawn
     stream gate, so the input moves the mesh) served at B=128, T=16 bf16
     through `make_serving_fn`, against the same call with
     `use_kernels=False` (mesh and kp3d RMS gaps, and the worst clip's,
     as shares of the f32 plain call's RMS spread over the clips: bf16
     bars 0.2, 0.3, 0.2; the same in f32, bars 1e-3, 2e-3, 1e-3), a
     planted fault (each clip's temporal output written into the next
     clip's) outside every bf16 bar, 20 K3 launches and no other kernel
     from the counters zeroed just before the bf16 call; (c) the call's
     time beside the plain call's. Its 20 launches join the kernels line,
     its f32 K3 error K3's.
Then a JSON line with each kernel's numbers, and as the last line
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and no result line is printed. Without a CUDA device the
script fails at once; there is no CPU fallback.
"""
import concurrent.futures
import contextlib
import copy
import importlib
import json
import os
import signal
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# the JAX package's own bf16-vs-f32 mesh difference on a TPU v5e
# (BENCH_r05.json kernel_max_abs_diff_bf16): a TPU figure, shown for scale
TPU_BF16_MESH_ERR = 0.012410640716552734
KERNELS = {
    "gat_trunk": ("gator_tpu_torch/csrc/gat_trunk.cu",
                  "gator_tpu/nn/pallas_gat.py:266"),
    "lbf_stack": ("gator_tpu_torch/csrc/lbf_stack.cu",
                  "gator_tpu/nn/pallas_mdr.py:352"),
    "gat_trunk_train": ("gator_tpu_torch/csrc/gat_trunk_train.cu",
                        "gator_tpu/nn/pallas_gat_train.py:530"),
    "lbf_stack_train": ("gator_tpu_torch/csrc/lbf_stack_train.cu",
                        "gator_tpu/nn/pallas_mdr_train.py:592"),
    "fused_attention": ("gator_tpu_torch/csrc/fused_attention.cu",
                        "gator_tpu/nn/pallas_attention.py:142"),
    "lbf_layer": ("gator_tpu_torch/csrc/lbf_layer.cu",
                  "gator_tpu/nn/pallas_mdr.py:153"),
    "lbf_ablate": ("gator_tpu_torch/csrc/lbf_ablate.cu",
                   "tools/exp_mdr_ablate.py:199"),
}
# one H100 SXM (NVIDIA's data sheet): HBM rate, dense bf16 and TF32 tensor
# rates
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


# parameters of one GAT block (C=128) and one LBF layer (C=64)
GAT_BLOCK_WEIGHTS = 266_000
LBF_LAYER_WEIGHTS = 61_000


def fma_gat_block(j, c=128, hid=512, c2=16):
    """FMA of one GAT block's forward for one sample: qkv, scores and
    probabilities times v, projection, MGCN (two products and the
    adjacency), XFeat (two projections, ring sums, back projection), MLP."""
    return (j * c * 3 * c + 2 * j * j * c + j * c * c + 2 * j * c * c
            + j * j * c + j * c * c + j * c * c2 + j * j * (c + c2)
            + j * (c + c2) * c + 2 * j * c * hid)


def dense_gat_block(j, c=128, hid=512, c2=16):
    """FMA of one GAT block's dense products for one sample: qkv, proj,
    MGCN W0 and W1, XFeat x0, x1, back, fc1, fc2. The backward's input
    gradients and its weight gradients each take as many."""
    return j * (3 * c * c + 4 * c * c + c * c2 + c * c + c2 * c
                + 2 * c * hid)


def fma_gat_block_dgrad(j, c=128, c2=16):
    """FMA of K5's row backward (gat_block_bwd) for one sample and block:
    the dense products transposed, the attention backward (dp, dq, dk,
    dv), MGCN's adjacency and its gradient, XFeat's ring transposes."""
    return dense_gat_block(j) + 6 * j * j * c + j * j * (c + c2)


def fma_lbf_layer(nv, j, c=64, hid=256):
    """FMA of one LBF layer's forward for one sample: q, k, v, cross
    attention, projection, MLP, q2/k2/v2, the Nv x Nv self-attention, L3."""
    return (nv * c * c + 2 * j * c * c + 2 * nv * j * c + nv * c * c
            + 2 * nv * c * hid + 3 * nv * c * c + 2 * nv * nv * c
            + nv * c * c)


def fma_lbf_rows_fwd(nv, j, c=64, hid=256):
    """FMA of K4's row-local forward launch (lbf_rows_fwd), and of K2's row
    launch (rows_kernel), for one sample and layer: q, the cross-attention
    over j joints (scores and PV, both heads), proj, fc1, fc2, q2/k2/v2,
    and the joints' k and v once."""
    return nv * (5 * c * c + 2 * j * c + 2 * c * hid) + 2 * j * c * c


def fma_lbf_rows_bwd(nv, j, c=64, hid=256):
    """FMA of K4's row-local backward (lbf_rows_bwd and lbf_wgrad) for one
    sample and layer, as the code does it: the forward again up to y3, the
    transposed products (dy3 from dq2/dk2/dv2, dh1, dy2, da1, dyv), the
    cross-attention's four (dp, dq, the joints' dk and dv), the weight
    gradients (L0-L3, fc2, fc1, proj, wq)."""
    return (fma_lbf_rows_fwd(nv, j, c, hid) - 3 * nv * c * c
            + nv * (5 * c * c + 2 * c * hid + 4 * j * c)
            + nv * (6 * c * c + 2 * c * hid))


# K4's launches, by the names torch.profiler shows
K4_ROWS = ("lbf_rows_fwd", "lbf_rows_bwd", "lbf_wgrad")
K4_REST = ("lbf_sa_fwd", "lbf_sa_bwd_dq", "lbf_sa_bwd_dkv", "lbf_joints_bwd",
           "lbf_reduce")


def lbf_rest_bounds(b, nv, j, plan, c=64, layers=3):
    """{launch: (bound with the bytes the function needs, bound with the
    bytes its interface moves)} for K4's rest at one stage-2 step (bf16
    rows, f32 where the kernels keep f32), each input read once and each
    output written once. Operations: the self-attention's products once
    each (the forward's two passes compute S twice), L3 in the forward and
    its da2 in the dq launch (L3's weight gradient is lbf_wgrad's), the
    joints' four [J, 64] x [64, 64] products. Bytes per vertex row:
    lbf_sa_fwd reads q2/k2/v2 (bf16) and y3, writes out (bf16), a2 and the
    log-sum-exp; lbf_sa_bwd_dq reads gout, q2/k2/v2, a2 and the log-sum-
    exp, writes da2 (bf16), D, dq2 and L3's two weight-gradient operands
    (bf16, to ops); lbf_sa_bwd_dkv reads q2/k2/v2, da2, the log-sum-exp
    and D, writes dk2/dv2. lbf_joints_bwd needs the joints in, djoints out
    and the summed dk/dv of each sample; its interface reads each row
    tile's share of them (and L3's bias shares). lbf_reduce reads the
    compact partial rows and writes the gradients."""
    sa_fma = layers * b * nv * nv * c  # one [Nv, Nv] product, width 64
    rows = layers * b * nv
    bf, f4 = 2, 4
    per_layer_partials = (plan["nc_w"] * 14 * c * c + plan["nc_rows"]
                          * (11 * c + 256) + plan["nc_j"]
                          * (2 * c * c + 3 * c)) * f4
    joints_need = layers * b * j * c * (bf + bf + 2 * f4)
    joints_io = joints_need + layers * b * (
        2 * plan["nrt"] * j * c * f4 + plan["nqt"] * c * f4)
    out = {
        "lbf_sa_fwd": (bound(2 * sa_fma + rows * c * c,
                             rows * (c * (3 * bf + f4 + bf + f4) + 2 * f4)),),
        "lbf_sa_bwd_dq": (bound(3 * sa_fma + rows * c * c, rows * (
            c * (bf + 3 * bf + f4 + bf + f4 + 2 * bf) + 4 * f4)),),
        "lbf_sa_bwd_dkv": (bound(4 * sa_fma,
                                 rows * (c * (4 * bf + 2 * f4) + 4 * f4)),),
        "lbf_joints_bwd": (bound(layers * b * 4 * j * c * c, joints_need),
                           bound(layers * b * 4 * j * c * c, joints_io)),
        "lbf_reduce": (bound(0, layers * (per_layer_partials
                                         + LBF_LAYER_WEIGHTS * f4)),),
    }
    return {k: v if len(v) == 2 else v * 2 for k, v in out.items()}


def bound(fma, nbytes, flop_per_s=BF16_FLOP_PER_S):
    """(least ms on one H100 for `fma` FMA at `flop_per_s` (bf16 by
    default) moving `nbytes`, what bounds it)."""
    t_ops = 2.0 * fma / flop_per_s
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def scaled_err(got, want):
    scale = max(want.float().abs().max().item(), 1e-6)
    return (got.float() - want.float()).abs().max().item() / scale


def bf16_ulps(got, ref):
    """How far a bf16 attention output is from its plain version: the share
    of elements that differ and the largest difference in units of the
    last bf16 place of the largest plain value of its head row, 2^(e - 7)
    (a value near zero, where many terms cancel, moves by more than its
    own last place when one probability rounds the other way)."""
    import torch
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    top = r.abs().amax(-1, keepdim=True).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return (f"{(diff > 0).float().mean().item():.2e} of the outputs "
            f"differ, by at most {(diff / ulp).max().item():.3g} ulp of "
            f"their row's largest")


def grads_of(module):
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()
            if p.grad is not None}


def compare_grads(tag, got, want, bar, zero_bias):
    """(max scaled error over every parameter gradient, the largest abs
    value of a zero-true-gradient slice, the worst gradient's name);
    `zero_bias(name)`
    gives the slice of a gradient that is zero in exact arithmetic (an
    attention key bias), which is reported as an absolute value instead."""
    check(set(got) == set(want) and got, f"{tag}: the same gradients")
    worst, noise, which = 0.0, 0.0, None
    for name, w in want.items():
        g = got[name]
        zero = zero_bias(name, g)
        if zero is not None:
            noise = max(noise, g[zero].abs().max().item(),
                        w[zero].abs().max().item())
            keep = g.new_ones(g.shape).bool()
            keep[zero] = False
            g, w = g[keep], w[keep]
            if g.numel() == 0:
                continue
        e = scaled_err(g, w)
        check(np.isfinite(e), f"{tag}: grad {name} finite")
        if bar is not None:
            check(e <= bar, f"{tag}: grad {name} scaled err {e} <= {bar}")
        if e >= worst:
            worst, which = e, name
    return worst, noise, which


def zero_bias(name, g):
    """The key slice of the GAT qkv bias, the MDR self-attention key bias."""
    if name.endswith("attn.qkv.bias"):
        c = g.shape[0] // 3
        return slice(c, 2 * c)
    if "selfatt" in name and name.endswith("linears.1.bias"):
        return slice(0, g.shape[0])
    return None


def masks_equal(got, want):
    """An exported mask against the plain hash's (None = rate 0 = keep
    all); -> (bitwise equal, keep fraction)."""
    if want is None:
        return bool((got == 1).all()), 1.0
    return (bool(got.shape == want.shape and (got == want).all()),
            (want > 0).float().mean().item())


# -- fabricated dataset trees in the real annotation schemas ---------------

H36M_SUBJECTS = {"train": (1, 5, 6, 7, 8), "test": (9, 11)}


def _h36m_name(s, act, cam, frame):
    stem = f"s_{s:02d}_act_{act:02d}_subact_01_ca_{cam:02d}"
    return f"{stem}/{stem}_{frame:06d}.jpg"


def _rot_y(yaw):
    cs, sn = np.cos(yaw), np.sin(yaw)
    return np.array([[cs, 0, sn], [0, 1, 0], [-sn, 0, cs]])


def _smpl_param(rng, trans=None):
    """An SMPL fit: pose, shape and, where the schema has one, trans."""
    param = {"pose": (0.2 * rng.standard_normal(72)).round(5).tolist(),
             "shape": rng.uniform(-1, 1, 10).round(5).tolist()}
    if trans is not None:
        param["trans"] = list(trans)
    return param


def write_fixtures(root, h36m_test=2048, h36m_train=1280, pw3d=512,
                   coco=1024, muco=1024, seed=0):
    """Write Human36M (train subjects 1/5/6/7/8 at every 5th frame, cameras
    1-4; test subjects 9/11 at every 50th frame, camera 4, with
    absnet_output_on_testset.json), 3DPW test (both genders, DarkPose
    detections), COCO and MuCo train trees under `root`, in the schemas the
    readers parse (gator_tpu_torch/data/{h36m,pw3d,coco_ds,muco}.py). Rows
    are random, from `seed`: plausible SMPL fits, cameras ~5 m away, joints
    and keypoints of body scale. The last frame of each test subject has no
    SMPL fit (the readers skip it, and its detection)."""
    rng = np.random.default_rng(seed)

    def dump(obj, *parts):
        path = os.path.join(root, *parts)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f)

    dets, next_id = {}, 0
    for split, n_total in (("train", h36m_train), ("test", h36m_test)):
        subjects = H36M_SUBJECTS[split]
        step, cams = (5, (1, 2, 3, 4)) if split == "train" else (50, (4,))
        per = -(-n_total // (len(subjects) * len(cams)))
        for s in subjects:
            cameras = {str(c): {
                "R": _rot_y(0.5 * c - 1.2).round(6).tolist(),
                "t": [0.0, 0.0, 5000.0], "f": [1145.0, 1144.0],
                "c": [512.0, 515.0]} for c in cams}
            images, anns, joints, smpls = [], [], {}, {}
            for k in range(per):
                act = 2 + k % 15
                frame = step * (k // 15)
                joints.setdefault(str(act), {"1": {}})
                smpls.setdefault(str(act), {"1": {}})
                world = rng.normal(0, 250, (17, 3))
                joints[str(act)]["1"][str(frame)] = world.round(3).tolist()
                if not (split == "test" and k == per - 1):
                    smpls[str(act)]["1"][str(frame)] = _smpl_param(
                        rng, [0.0, 0.0, 0.0])
                for c in cams:
                    img_id, next_id = next_id, next_id + 1
                    name = _h36m_name(s, act, c, frame)
                    images.append({
                        "id": img_id, "file_name": name, "frame_idx": frame,
                        "subject": s, "action_idx": act, "subaction_idx": 1,
                        "cam_idx": c, "height": 1002, "width": 1000})
                    anns.append({"id": img_id, "image_id": img_id,
                                 "bbox": [300.0, 150.0, 420.0, 700.0]})
                    if split == "test":
                        cam = np.array(cameras[str(c)]["R"])
                        jc = world @ cam.T + [0, 0, 5000.0]
                        xy = jc[:, :2] / jc[:, 2:] * 1145.0 + 512.0
                        xy = xy + rng.normal(0, 4.0, xy.shape)
                        dets[name.split("/")[-1]] = np.concatenate(
                            [xy, np.ones((17, 1))], 1).round(3).tolist()
            base = ("Human36M", "annotations", f"Human36M_subject{s}")
            dump({"images": images, "annotations": anns},
                 *base[:-1], base[-1] + "_data.json")
            dump(cameras, *base[:-1], base[-1] + "_camera.json")
            dump(joints, *base[:-1], base[-1] + "_joint_3d.json")
            dump(smpls, *base[:-1], base[-1] + "_smpl_param.json")
    dump(dets, "Human36M", "absnet_output_on_testset.json")

    images, anns, dark = [], [], []
    for i in range(pw3d):
        images.append({"id": i, "width": 1080, "height": 1920,
                       "sequence": f"courtyard_{i // 64:02d}",
                       "file_name": f"image_{i % 64:05d}.jpg",
                       "cam_param": {"focal": [1961.0, 1969.0],
                                     "princpt": [540.0, 960.0]}})
        param = _smpl_param(rng, [0.0, 0.2, 4.0])
        param["gender"] = "female" if i % 2 else "male"
        anns.append({"id": i, "image_id": i, "person_id": i % 2,
                     "bbox": [300.0, 500.0, 420.0, 900.0],
                     "smpl_param": param})
        kp = np.concatenate([rng.uniform(350, 700, (17, 1)),
                             rng.uniform(550, 1350, (17, 1)),
                             rng.uniform(0.3, 1.0, (17, 1))], 1)
        dark.append({"annotation_id": i, "keypoints": kp.round(3).tolist()})
    dump({"images": images, "annotations": anns},
         "PW3D", "data", "3DPW_latest_test.json")
    dump(dark, "PW3D", "data", "darkpose_3dpw_testset_output.json")

    anns, fits = [], {}
    for i in range(coco):
        kp = np.concatenate([rng.uniform(100, 400, (17, 2)),
                             np.full((17, 1), 2.0)], 1)
        anns.append({"id": i, "iscrowd": 0, "num_keypoints": 17,
                     "keypoints": kp.round(3).flatten().tolist(),
                     "bbox": [90.0, 80.0, 320.0, 380.0]})
        fits[str(i)] = {"smpl_param": _smpl_param(rng),
                        "cam_param": {"s": [float(rng.uniform(150, 250))],
                                      "t": rng.uniform(150, 250,
                                                       2).tolist()}}
    dump({"annotations": anns},
         "COCO", "annotations", "person_keypoints_train2017.json")
    dump(fits, "COCO", "annotations", "coco_smplify_train.json")

    images, anns, params = [], [], {}
    for i in range(muco):
        images.append({"id": i, "f": [1500.0, 1500.0], "c": [1000.0, 1000.0]})
        for p in range(1 + i % 2):          # every other image: two people
            aid = 2 * i + p
            kc = rng.uniform(-400, 400, (21, 3))
            kc[:, 2] += 3000.0 + 1000.0 * p
            anns.append({"id": aid, "image_id": i,
                         "bbox": [60.0 + 40 * p, 60.0, 300.0, 400.0],
                         "keypoints_cam": kc.round(3).tolist()})
            params[str(aid)] = _smpl_param(rng, [0.0, 0.0, 3.0 + p])
    dump({"images": images, "annotations": anns},
         "MuCo", "data", "MuCo-3DHP.json")
    dump(params, "MuCo", "data", "smpl_param.json")


def train_phases(torch, dev, card, randn):
    """Phases 8-14 (a-g): K4 and K5 against their plain versions, the
    training steps on the card, and their times."""
    from gator_tpu_torch import losses
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.models import GatorSpec, build_gator
    from gator_tpu_torch.nn.gat_trunk_train import (extract_block_params,
                                                    gat_trunk_train,
                                                    gat_trunk_train_ref)
    from gator_tpu_torch.nn.lbf_stack_train import (DEFAULT_RATES,
                                                    ZERO_RATES,
                                                    extract_layer_params,
                                                    lbf_stack_train,
                                                    lbf_stack_train_ref)
    from gator_tpu_torch.tools.timing import time_ms
    from gator_tpu_torch.train import (Adam, TrainState, make_gat_train_step,
                                       make_gator_train_step)

    f32, bf16 = torch.float32, torch.bfloat16
    out = {"errs": {}, "launches": {}, "ms": {}, "bounds": {}}
    assets = {js: build_assets(js, data_dirs=[], synthetic_vertex_num=6890,
                               seed=0) for js in ("human36", "coco")}
    alphas = {"human36": False, "coco": True}
    models = {js: build_gator(GatorSpec.from_assets(assets[js],
                                                    alpha=alphas[js]),
                              seed=11, device=dev) for js in assets}

    def run_k5(model, x0, cot, seed, kernel=True):
        gat = model.pose_lifter
        x = x0.clone().requires_grad_(True)
        bias = gat.get_hop_path_encoding().detach().float().requires_grad_(
            True)
        gat.zero_grad(set_to_none=True)
        export = []
        fn = gat_trunk_train if kernel else gat_trunk_train_ref
        y = fn(x, bias, [extract_block_params(b) for b in gat.blocks],
               gat.spec.masks_xfeat, 8, seed, export=export)
        y.backward(cot)
        torch.cuda.synchronize()
        return {"out": y.detach(), "dx": x.grad, "dbias": bias.grad,
                "grads": grads_of(gat.blocks), "masks": export}

    def run_k4(model, x0, j0, cot, seed, kernel=True, rates=DEFAULT_RATES):
        mdr = model.pose2mesh
        x = x0.clone().requires_grad_(True)
        jt = j0.clone().requires_grad_(True)
        mdr.zero_grad(set_to_none=True)
        export = []
        fn = lbf_stack_train if kernel else lbf_stack_train_ref
        y = fn(x, jt, [extract_layer_params(mdr, i) for i in range(3)], 2,
               seed, rates=rates, export=export)
        y.backward(cot)
        torch.cuda.synchronize()
        grads = {n: g for n, g in grads_of(mdr).items()
                 if n.startswith(("encoder", "norm", "selfatt"))}
        return {"out": y.detach(), "dx": x.grad, "djt": jt.grad,
                "grads": grads, "masks": export}

    def hold(tag, k, p, dt, extra):
        """kernel run k against plain run p: masks bit for bit, output and
        gradients (f32 bars, bf16 reported) -> output's max abs err."""
        for li, (km, pm) in enumerate(zip(k["masks"], p["masks"])):
            for name in km:
                same, _ = masks_equal(km[name], pm[name])
                check(same, f"{tag}: unit {li} mask {name} equals the hash")
        keep = {name: round(masks_equal(k["masks"][-1][name],
                                        p["masks"][-1][name])[1], 4)
                for name in k["masks"][-1]}
        bar = 1e-4 if dt == f32 else None
        e_out = max_err(k["out"], p["out"])
        errs = {name: scaled_err(k[name], p[name]) for name in extra}
        errs["out"] = scaled_err(k["out"], p["out"])
        for name, e in errs.items():
            check(np.isfinite(e), f"{tag}: {name} finite")
            if bar is not None:
                check(e <= bar, f"{tag}: {name} scaled err {e} <= {bar}")
        worst, noise, which = compare_grads(tag, k["grads"], p["grads"],
                                            bar, zero_bias)
        say(9, f"{tag} {str(dt)[6:]}: masks equal the hash in all "
               f"{len(k['masks'])} units; out max abs err {e_out:.3e}; "
               f"scaled errs " + ", ".join(f"{n} {e:.2e}"
                                            for n, e in errs.items())
               + f"; {len(k['grads'])} param grads worst {worst:.2e} "
               + f"({which})"
               + f" (zero-true-grad key biases {noise:.1e} abs)"
               + (" (bars 1e-4)" if bar else " (reported)")
               + f"; keep fractions (last unit) {keep}")
        return e_out

    # 9 (b) and 10 (c): K5 and K4 against their plain versions, at a small
    # batch and at the main path's (B=512: K4's grid-stride CTAs then loop
    # over ~27 row tiles each and its joints CTAs over ~2 samples)
    err5 = err4 = 0.0
    for js, model in models.items():
        j = model.spec.gat.num_joint
        for b5, dt in ((64, f32), (64, bf16), (512, f32), (512, bf16)):
            x0, cot = randn(b5, j, 128).to(dt), randn(b5, j, 128).to(dt)
            k = run_k5(model, x0, cot, 1234)
            p = run_k5(model, x0, cot, 1234, kernel=False)
            e = hold(f"K5 {js} J={j} B={b5} depth 6", k, p, dt,
                     ("dx", "dbias"))
            del p
            if dt == f32:
                err5 = max(err5, e)
            if dt == f32 and b5 == 512:
                k2 = run_k5(model, x0, cot, 1234)
                same = all(torch.equal(k[n], k2[n])
                           for n in ("out", "dx", "dbias")) and all(
                    torch.equal(k["grads"][n], k2["grads"][n])
                    for n in k["grads"])
                other = run_k5(model, x0, cot, 1235)
                check(same, "K5 repeat run bit-identical")
                check(not torch.equal(k["out"], other["out"]),
                      "K5 another seed differs")
                say(10, f"K5 {js} B={b5}: two runs with one seed "
                        f"bit-identical (out, dx, dbias, "
                        f"{len(k['grads'])} grads); another seed differs")
                del k2, other
            del k
        nv = model.spec.mdr.coarse_num
        for b4, dt in ((16, f32), (16, bf16), (512, f32), (512, bf16)):
            x0, j0 = randn(b4, nv, 64).to(dt), randn(b4, j, 64).to(dt)
            cot = randn(b4, nv, 64).to(dt)
            k = run_k4(model, x0, j0, cot, 4321)
            p = run_k4(model, x0, j0, cot, 4321, kernel=False)
            e = hold(f"K4 {js} J={j} B={b4} Nv={nv} 3 layers", k, p, dt,
                     ("dx", "djt"))
            del p
            if dt == f32:
                err4 = max(err4, e)
            if dt == f32 and b4 == 512:
                k2 = run_k4(model, x0, j0, cot, 4321)
                same = all(torch.equal(k[n], k2[n])
                           for n in ("out", "dx", "djt")) and all(
                    torch.equal(k["grads"][n], k2["grads"][n])
                    for n in k["grads"])
                other = run_k4(model, x0, j0, cot, 4322)
                check(same, "K4 repeat run bit-identical")
                check(not torch.equal(k["out"], other["out"]),
                      "K4 another seed differs")
                say(10, f"K4 {js} B={b4}: two runs with one seed "
                        f"bit-identical (out, dx, djt, {len(k['grads'])} "
                        f"grads); another seed differs")
                del k2, other
            del k
    out["errs"] = {"gat_trunk_train": err5, "lbf_stack_train": err4}

    def batch_of(js, b, seed):
        v = models[js].spec.mdr.full_num
        j = models[js].spec.gat.num_joint
        rng = np.random.default_rng(seed)
        arrays = {
            "pose2d": rng.normal(size=(b, j, 2)),
            "mesh": rng.normal(size=(b, v, 3)) * 0.1,
            "lift_pose3d": rng.normal(size=(b, j, 3)) * 100,
            "reg_pose3d": rng.normal(size=(b, 17, 3)) * 100,
            "mesh_valid": np.ones((b, v, 1)),
            "lift_valid": np.ones((b, j, 1)),
            "reg_valid": np.ones((b, 17, 1)),
        }
        return {k: torch.from_numpy(a.astype(np.float32)).to(dev)
                for k, a in arrays.items()}

    def stage2(js, model, dt, lr, use_kernels=True, **kw):
        st = TrainState(model, Adam(model.parameters(), lr=lr))
        step = make_gator_train_step(
            model.spec, assets[js].faces, assets[js].j_regressor_h36m,
            losses.LossWeights(), dtype=dt, use_kernels=use_kernels, **kw)
        return st, step

    # 11 (d): a kernel step against a plain step, zero rates, f32, B=16
    zero = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)
    for js in ("human36", "coco"):
        mk = build_gator(GatorSpec.from_assets(assets[js], alpha=alphas[js],
                                               **zero), seed=5, device=dev)
        mp = copy.deepcopy(mk)
        batch = batch_of(js, 16, 2)
        res = {}
        for name, m, use in (("kernel", mk, True), ("plain", mp, False)):
            st, step = stage2(js, m, f32, 0.0, use, rates=ZERO_RATES,
                              gat_mlp_rate=0.0)
            res[name] = float(step(st, batch, 0, 1.0)["loss"])
        torch.cuda.synchronize()
        rel = abs(res["kernel"] - res["plain"]) / abs(res["plain"])
        check(rel <= 1e-5, f"step loss kernel {res['kernel']} vs plain "
                           f"{res['plain']}: rel {rel} <= 1e-5")
        worst, noise, _ = compare_grads("stage-2 step", grads_of(mk),
                                        grads_of(mp), 1e-4, zero_bias)
        say(11, f"stage-2 step {js} f32 B=16 zero rates: loss kernel "
                f"{res['kernel']:.7f} plain {res['plain']:.7f} (rel "
                f"{rel:.1e}, bar 1e-5); {len(grads_of(mk))} param grads "
                f"worst scaled err {worst:.2e} (bar 1e-4; key biases "
                f"{noise:.1e} abs)")

    # 12 (e): the main training path, 20 stage-2 steps at B=512, bf16
    from gator_tpu_torch.nn import gat_trunk_train as k5mod
    from gator_tpu_torch.nn import lbf_stack_train as k4mod
    k5 = k5mod.gat_trunk_train
    k4 = k4mod.lbf_stack_train
    batches = {js: batch_of(js, 512, 1) for js in models}
    k5.launches_fwd = k5.launches_bwd = 0
    k4.launches_fwd = k4.launches_bwd = 0
    for js, model in models.items():
        st, step = stage2(js, model, bf16, 1e-3)
        t0 = time.perf_counter()
        curve = [float(step(st, batches[js], 7, 1.0)["loss"])
                 for _ in range(20)]
        torch.cuda.synchronize()
        check(all(np.isfinite(curve)), f"stage-2 {js} losses finite")
        check(curve[-1] < curve[0], f"stage-2 {js} loss falls: {curve}")
        say(12, f"stage-2 {js} alpha={alphas[js]} B=512 bf16 default rates:"
                f" 20 steps in {time.perf_counter() - t0:.1f} s, loss "
                f"{curve[0]:.4f} -> {curve[-1]:.4f} "
                f"({' '.join(f'{c:.4f}' for c in curve)})")
    torch.cuda.synchronize()
    counts = {"K5 fwd": k5.launches_fwd, "K5 bwd": k5.launches_bwd,
              "K4 fwd": k4.launches_fwd, "K4 bwd": k4.launches_bwd}
    check(all(n > 0 for n in counts.values()),
          f"every K4/K5 counter above 0 on the stage-2 path: {counts}")
    say(12, f"launches on the stage-2 path (40 steps): {counts}")
    out["launches"] = {
        "gat_trunk_train": k5.launches_fwd + k5.launches_bwd,
        "lbf_stack_train": k4.launches_fwd + k4.launches_bwd}

    # 13 (f): 10 stage-1 steps at B=256
    k5.launches_fwd = k5.launches_bwd = 0
    gat = build_gator(GatorSpec.from_assets(assets["human36"]), seed=12,
                      device=dev).pose_lifter
    rng = np.random.default_rng(3)
    b1 = {"pose2d": rng.normal(size=(256, 17, 2)),
          "joint_cam": rng.normal(0, 100, size=(256, 17, 3)),
          "joint_valid": np.ones((256, 17, 1))}
    b1 = {k: torch.from_numpy(a.astype(np.float32)).to(dev)
          for k, a in b1.items()}
    st1 = TrainState(gat, Adam(gat.parameters(), lr=8e-4))
    step1 = make_gat_train_step(gat.spec, dtype=bf16)
    curve = [float(step1(st1, b1, 3)["loss"]) for _ in range(10)]
    torch.cuda.synchronize()
    check(all(np.isfinite(curve)) and curve[-1] < curve[0],
          f"stage-1 losses finite and falling: {curve}")
    check(k5.launches_fwd > 0 and k5.launches_bwd > 0,
          "K5 launched on the stage-1 path")
    say(13, f"stage-1 human36 B=256 bf16: loss {curve[0]:.3f} -> "
            f"{curve[-1]:.3f} over 10 steps; K5 launches fwd "
            f"{k5.launches_fwd} bwd {k5.launches_bwd}")

    # 14 (g): times at B=512, bf16
    js, model = "human36", models["human36"]
    b = 512
    st_k, step_k = stage2(js, model, bf16, 1e-4)
    mp = copy.deepcopy(model)
    st_p, step_p = stage2(js, mp, bf16, 1e-4, use_kernels=False)
    gp = copy.deepcopy(gat)
    s1k = TrainState(gat, Adam(gat.parameters(), lr=1e-4))
    s1p = TrainState(gp, Adam(gp.parameters(), lr=1e-4))
    step1p = make_gat_train_step(gat.spec, dtype=bf16, use_kernels=False)
    rng = np.random.default_rng(4)
    b512 = {"pose2d": rng.normal(size=(b, 17, 2)),
            "joint_cam": rng.normal(0, 100, size=(b, 17, 3)),
            "joint_valid": np.ones((b, 17, 1))}
    b512 = {k: torch.from_numpy(a.astype(np.float32)).to(dev)
            for k, a in b512.items()}
    t = {
        "stage2": time_ms(lambda: step_k(st_k, batches[js], 7, 1.0),
                          calls=1),
        "stage2_plain": time_ms(
            lambda: step_p(st_p, batches[js], 7, 1.0), calls=1),
        "stage1": time_ms(lambda: step1(s1k, b512, 3), calls=1),
        "stage1_plain": time_ms(lambda: step1p(s1p, b512, 3),
                                calls=1),
    }
    gatm = model.pose_lifter
    x5 = randn(b, 17, 128).to(bf16).requires_grad_(True)
    g5 = randn(b, 17, 128).to(bf16)
    bias5 = gatm.get_hop_path_encoding().detach().float().requires_grad_(True)
    bp5 = [extract_block_params(blk) for blk in gatm.blocks]
    mdr = model.pose2mesh
    nv = mdr.spec.coarse_num
    x4 = randn(b, nv, 64).to(bf16).requires_grad_(True)
    j4 = randn(b, 17, 64).to(bf16).requires_grad_(True)
    g4 = randn(b, nv, 64).to(bf16)
    lp4 = [extract_layer_params(mdr, i) for i in range(3)]
    for name, fns in (("k5", (gat_trunk_train, gat_trunk_train_ref)),
                      ("k4", (lbf_stack_train, lbf_stack_train_ref))):
        for fn, sfx in zip(fns, ("", "_plain")):
            if name == "k5":
                def fwd(fn=fn):
                    return fn(x5, bias5, bp5, gatm.spec.masks_xfeat, 8, 9)
                g = g5
            else:
                def fwd(fn=fn):
                    return fn(x4, j4, lp4, 2, 9)
                g = g4
            t[f"{name}_fwd{sfx}"] = time_ms(fwd, calls=1)
            y = fwd()
            t[f"{name}_bwd{sfx}"] = time_ms(
                lambda y=y, g=g: y.backward(g, retain_graph=True),
                calls=1)
            del y
    for name, what in (("stage2", "stage-2 step (K4 + K5 + the rest)"),
                       ("stage1", "stage-1 step (K5 + the rest)"),
                       ("k5_fwd", "K5 forward, 6 blocks"),
                       ("k5_bwd", "K5 backward, 6 blocks"),
                       ("k4_fwd", "K4 forward, 3 layers"),
                       ("k4_bwd", "K4 backward, 3 layers")):
        k, p = t[name], t[name + "_plain"]
        say(14, f"{what} B={b} bf16 on {card}: kernel path {k:.3f} ms, "
                f"plain {p:.3f} ms" + (
                    f" ({b / k * 1e3:,.0f} vs {b / p * 1e3:,.0f} poses/s)"
                    if name.startswith("stage") else ""))
    # K4's launches alone: device ms per call of the 3-layer stack (one
    # stage-2 step's worth), from torch.profiler
    from gator_tpu_torch.nn.lbf_stack_train import card_plan
    from gator_tpu_torch.nn.lbf_stack_train import kernel_info as k4_info
    from gator_tpu_torch.tools.profile_train import _device_us, _is_kernel
    y = lbf_stack_train(x4, j4, lp4, 2, 9)
    y.backward(g4, retain_graph=True)
    torch.cuda.synchronize()
    k4l = dict.fromkeys(K4_ROWS + K4_REST, 0.0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            y.backward(g4, retain_graph=True)
            lbf_stack_train(x4, j4, lp4, 2, 9)
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        for key in k4l:
            if _is_kernel(evt) and key in evt.key:
                k4l[key] += _device_us(evt) / 1e3 / 3
    del y
    check(all(v > 0 for v in k4l.values()),
          f"the profiler saw K4's launches: {k4l}")
    # bytes each must move: x in, y3 (f32, the residual) and q2/k2/v2
    # (bf16: every reader rounds them) out; x, gout and dq2/dk2/dv2 (f32:
    # their bias gradients sum them unrounded) in, dx out.
    row_bounds = {
        "lbf_rows_fwd": bound(3 * b * fma_lbf_rows_fwd(nv, 17),
                              3 * b * nv * 64 * (2 + 4 + 6)),
        "lbf_rows_bwd": bound(3 * b * fma_lbf_rows_bwd(nv, 17),
                              3 * b * nv * 64 * (2 + 2 + 12 + 2)),
    }
    say(14, f"K4 row launches per stage-2 step (3 layers, B={b} bf16) on "
            f"{card}: lbf_rows_fwd {k4l['lbf_rows_fwd']:.3f} ms (bound "
            f"{row_bounds['lbf_rows_fwd'][0]:.3f}, "
            f"{row_bounds['lbf_rows_fwd'][1]}); lbf_rows_bwd "
            f"{k4l['lbf_rows_bwd']:.3f} + lbf_wgrad "
            f"{k4l['lbf_wgrad']:.3f} ms (bound together "
            f"{row_bounds['lbf_rows_bwd'][0]:.3f}, "
            f"{row_bounds['lbf_rows_bwd'][1]})")
    # K4's rest, each launch beside its own bound (lbf_rest_bounds); where
    # the interface moves more than the function needs, both
    plan4 = card_plan(b, nv, bf16)
    rest = lbf_rest_bounds(b, nv, 17, plan4)
    say(14, f"K4's rest per stage-2 step (3 layers, B={b} bf16) on {card}: "
            + "; ".join(
                f"{key} {k4l[key]:.3f} ms (bound {rest[key][0][0]:.3f}, "
                f"{rest[key][0][1]}" + (
                    f"; {rest[key][1][0]:.3f} with the interface's bytes"
                    if rest[key][1] != rest[key][0] else "") + ")"
                for key in K4_REST)
            + f"; together {sum(k4l[k] for k in K4_REST):.3f} ms against "
            f"{sum(v[0][0] for v in rest.values()):.3f} ms (the interfaces' "
            f"{sum(v[1][0] for v in rest.values()):.3f}); registers / CTAs "
            f"per SM / shared bytes: " + ", ".join(
                f"{k} {v['registers']}/{v['ctas_per_sm']}/{v['smem_bytes']}"
                for k, v in k4_info(bf16, nv).items()))
    # K5's launches alone, the same way: device ms per step (six blocks)
    from gator_tpu_torch.nn.gat_trunk_train import (kernel_info,
                                                    launch_plan,
                                                    partial_strides)
    y = gat_trunk_train(x5, bias5, bp5, gatm.spec.masks_xfeat, 8, 9)
    y.backward(g5, retain_graph=True)
    torch.cuda.synchronize()
    k5l = dict.fromkeys(("gat_block_fwd", "gat_block_bwd",
                         "gat_block_wgrad", "reduce_partials"), 0.0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            y.backward(g5, retain_graph=True)
            gat_trunk_train(x5, bias5, bp5, gatm.spec.masks_xfeat, 8, 9)
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        for key in k5l:
            if _is_kernel(evt) and key in evt.key:
                k5l[key] += _device_us(evt) / 1e3 / 3
    del y
    check(all(v > 0 for v in k5l.values()),
          f"the profiler saw K5's launches: {k5l}")
    # bytes each launch moves (bf16 rows of 128, f32 x1): the forward reads
    # x and writes out, the saved operands (2,320 a row) and x1; the
    # row backward reads x, gout, q/k/v, g0, g1, the pre-activation (1,152
    # a row) and x1, writes dx and the cotangent operands (1,680 a row);
    # gat_block_wgrad reads the 2,848 operand columns of the weight
    # gradients and writes its chunks' partial rows (f32); the reductions
    # read those and the tiles' rows. Weights: bf16 in, f32 gradients out.
    plan = launch_plan(b, 17)
    strides = partial_strides(17, 128)
    rows6 = 6 * b * 17
    wbytes = 6 * GAT_BLOCK_WEIGHTS * 2
    k5_bounds = {
        "gat_block_fwd": bound(6 * b * fma_gat_block(17),
                               rows6 * (2 * 128 * 2 + 2320 * 2
                                        + 128 * 4) + wbytes),
        "gat_block_bwd": bound(6 * b * fma_gat_block_dgrad(17),
                               rows6 * (3 * 128 * 2 + 1152 * 2 + 128 * 4
                                        + 1680 * 2) + wbytes),
        "gat_block_wgrad": bound(6 * b * dense_gat_block(17),
                                 rows6 * 2848 * 2 + 6 * plan["nc_w"]
                                 * GAT_BLOCK_WEIGHTS * 4),
        "reduce_partials": bound(0, 6 * 4 * (
            (plan["nc_w"] + 1) * strides["weights"]
            + (plan["ntiles"] + 1) * strides["small"])),
    }
    info = kernel_info(bf16, 128)
    say(14, f"K5 launches per stage-2 step (6 blocks, B={b} bf16, "
            f"{plan['ntiles']} tiles) on {card}: " + "; ".join(
                f"{k} {k5l[k]:.3f} ms (bound {k5_bounds[k][0]:.3f}, "
                f"{k5_bounds[k][1]})" for k in k5l)
            + "; registers / CTAs per SM / shared bytes: " + ", ".join(
                f"{k} {v['registers']}/{v['ctas_per_sm']}/{v['smem_bytes']}"
                for k, v in info.items()))
    out["ms"] = {
        "gat_trunk_train": t["k5_fwd"] + t["k5_bwd"],
        "gat_trunk_train_plain": t["k5_fwd_plain"] + t["k5_bwd_plain"],
        "lbf_stack_train": t["k4_fwd"] + t["k4_bwd"],
        "lbf_stack_train_plain": t["k4_fwd_plain"] + t["k4_bwd_plain"],
    }
    # a train step's work: the forward and a backward of twice its FMA
    out["bounds"] = {
        "gat_trunk_train": bound(
            3 * b * 6 * fma_gat_block(17),
            6 * 4 * b * 17 * 128 * 2 + 6 * GAT_BLOCK_WEIGHTS * (2 + 4)),
        "lbf_stack_train": bound(
            3 * b * 3 * fma_lbf_layer(nv, 17),
            (4 * b * nv * 64 + 2 * b * 17 * 64) * 2
            + 3 * LBF_LAYER_WEIGHTS * (2 + 4)),
        **row_bounds,
    }
    return out


def launch_counters(torch):
    """-> (reset, read) over the launch counts of the main paths' kernels
    (K1, K2, K5, K4, K3): `reset()` sets every count to 0, `read()`
    synchronizes and returns {kernel: launches since the reset}."""
    from gator_tpu_torch.nn import gat_trunk, lbf_stack
    from gator_tpu_torch.nn.fused_attention import fused_attention
    from gator_tpu_torch.nn.gat_trunk_train import gat_trunk_train as k5
    from gator_tpu_torch.nn.lbf_stack_train import lbf_stack_train as k4

    counters = {"gat_trunk": (gat_trunk, ("launches",)),
                "lbf_stack": (lbf_stack, ("launches",)),
                "gat_trunk_train": (k5, ("launches_fwd", "launches_bwd")),
                "lbf_stack_train": (k4, ("launches_fwd", "launches_bwd")),
                "fused_attention": (fused_attention, ("launches",))}

    def reset():
        for fn, attrs in counters.values():
            for a in attrs:
                setattr(fn, a, 0)

    def read():
        torch.cuda.synchronize()
        return {n: sum(getattr(fn, a) for a in attrs)
                for n, (fn, attrs) in counters.items()}

    return reset, read


def eval_phases(torch, dev, card, randn):
    """Phases 16-18 (i-k): K3 against its plain version, the eval path on
    the card, and its times."""
    import torch.nn.functional as F

    from gator_tpu_torch.cli import test as test_cli
    from gator_tpu_torch.cli.common import Session
    from gator_tpu_torch.config import load_config
    from gator_tpu_torch.nn.fused_attention import (fused_attention,
                                                    fused_attention_ref)
    from gator_tpu_torch.tools.timing import time_ms
    from gator_tpu_torch.train import run_eval

    f32, bf16 = torch.float32, torch.bfloat16
    out = {}

    # 16 (i): K3 against its plain version
    def qkv(b, nq, nk, h, d, dt, with_bias):
        q, k, v = (randn(b, n, h, d).to(dt) for n in (nq, nk, nk))
        return q, k, v, (randn(h, nq, nk) if with_bias else None)

    err3 = 0.0
    for b, nq, h, d, with_bias in ((16, 431, 2, 32, False),
                                   (64, 431, 2, 32, False),
                                   (512, 431, 2, 32, False),
                                   (16, 431, 2, 32, True),
                                   (64, 17, 8, 16, True),
                                   (16, 1000, 2, 64, True)):
        for dt in (f32, bf16):
            q, k, v, bias = qkv(b, nq, nq, h, d, dt, with_bias)
            got = fused_attention(q, k, v, bias, d ** -0.5)
            ref = fused_attention_ref(q, k, v, bias, d ** -0.5)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            check(np.isfinite(err), f"K3 {dt} finite")
            if dt == f32:
                check(err <= 1e-4, f"K3 f32 B={b} {nq}x{nq} err {err} "
                                   f"<= 1e-4")
                err3 = max(err3, err)
            say(16, f"K3 fused_attention B={b} {nq}x{nq} H={h} D={d} "
                    f"{'bias' if with_bias else 'no bias'} {str(dt)[6:]}: "
                    f"max abs err {err:.3e} vs plain"
                    + (" (bar 1e-4)" if dt == f32 else
                       f" (reported; {bf16_ulps(got, ref)})"))
    out["errs"] = {"fused_attention": err3}
    with torch.enable_grad():
        q, k, v, bias = qkv(16, 431, 431, 2, 32, f32, True)
        cot = randn(16, 431, 2, 32)
        grads = []
        for fn in (fused_attention, fused_attention_ref):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
            fn(*leaves, 32 ** -0.5).backward(cot)
            grads.append([t.grad for t in leaves])
        torch.cuda.synchronize()
    errs = {name: scaled_err(g, w) for name, g, w in
            zip(("dq", "dk", "dv", "dbias"), *grads)}
    check(all(e <= 1e-4 for e in errs.values()),
          f"K3 Function gradients scaled within 1e-4: {errs}")
    say(16, "K3 Function backward (plain recompute) vs autograd through the "
            "plain version, f32 B=16 431x431 with bias: scaled errs "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + " (bar 1e-4)")

    # 17 (j): the main eval path; every counter reset just before
    e2e = os.path.join(ROOT, "configs", "gator_synthetic_e2e.yml")
    gat_cfg = os.path.join(ROOT, "configs", "gat_synthetic_e2e.yml")
    reset_counts, read_counts = launch_counters(torch)
    reset_counts()
    gator_batches = 0
    with tempfile.TemporaryDirectory() as tmp:
        res = test_cli.main(["--cfg", e2e, "--synthetic",
                             "--vis_dir", tmp])
        check(np.isfinite(res["mpjpe"]), "CLI human36 MPJPE finite")
        gator_batches += 1
        coco_cfg = load_config(e2e, overrides={
            "DATASET": {"input_joint_set": "coco"}, "MODEL": {"alpha": True}})
        res_c, full_c = test_cli.run_test(coco_cfg, synthetic=True,
                                          vis_dir=tmp)
        check(np.isfinite(res_c["mpjpe"]) and np.isfinite(
            full_c["surface_err"]), "CLI coco MPJPE/MPVPE finite")
        gator_batches += 1
        res_g = test_cli.main(["--cfg", gat_cfg, "--synthetic",
                               "--vis_dir", tmp])
        check(np.isfinite(res_g["mpjpe"]), "GAT eval MPJPE finite")
    gat_counts = read_counts()
    check(gat_counts["fused_attention"] == 3 * gator_batches,
          f"the GAT eval launched no kernel: {gat_counts}")
    cfg = load_config(e2e)
    sess = Session(cfg, synthetic=True, synthetic_n=2048)
    model = sess.build_model()
    step_k = sess.make_eval_step()
    kern = run_eval(step_k, model, sess.pipeline,
                    collect_out=("pred_mesh_mm",))
    torch.cuda.synchronize()
    gator_batches += len(sess.pipeline)
    counts = read_counts()
    check(len(sess.pipeline) == 4 and kern["count"] == 2048,
          "2048 samples in four batches of 512")
    check(counts["fused_attention"] == 3 * gator_batches,
          f"K3 launched 3 times per eval batch ({gator_batches}): {counts}")
    check(all(n == 0 for name, n in counts.items()
              if name != "fused_attention"),
          f"no serving or training kernel on the eval path: {counts}")
    say(17, f"eval CLI human36 MPJPE {res['mpjpe']:.3f} mm; coco alpha=True "
            f"MPJPE {res_c['mpjpe']:.3f} MPVPE {full_c['surface_err']:.3f} "
            f"mm; GAT MPJPE {res_g['mpjpe']:.3f} mm; Session/run_eval "
            f"2048 at B=512: MPJPE {kern['joint_err']:.4f} MPVPE "
            f"{kern['surface_err']:.4f} mm; launches {counts} "
            f"({gator_batches} GATOR batches)")
    step_p = sess.make_eval_step(use_kernels=False)
    plain = run_eval(step_p, model, sess.pipeline,
                     collect_out=("pred_mesh_mm",))
    e_mesh = float(np.abs(kern["pred_mesh_mm"]
                          - plain["pred_mesh_mm"]).max()) / 1000.0
    e_j = abs(kern["joint_err"] - plain["joint_err"])
    e_s = abs(kern["surface_err"] - plain["surface_err"])
    check(np.isfinite(kern["pred_mesh_mm"]).all() and np.isfinite(e_mesh),
          "kernel-path meshes finite")
    check(e_mesh <= 1e-4, f"eval meshes kernel vs plain {e_mesh} <= 1e-4 m")
    check(e_j <= 1e-3 and e_s <= 1e-3,
          f"MPJPE/MPVPE kernel vs plain {e_j}, {e_s} <= 1e-3 mm")
    say(17, f"kernel path vs plain attention, 2048 samples: meshes within "
            f"{e_mesh:.3e} m (bar 1e-4), MPJPE {e_j:.2e} mm, MPVPE "
            f"{e_s:.2e} mm (bars 1e-3)")
    out["launches"] = {"fused_attention": counts["fused_attention"]}

    # 18 (k): times at B=512
    ms = {}
    for dt, tag in ((f32, ""), (bf16, "_bf16")):
        q, k, v, _ = qkv(512, 431, 431, 2, 32, dt, False)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms["fused_attention" + tag] = time_ms(
            lambda: fused_attention(q, k, v, None, 32 ** -0.5))
        ms["fused_attention_plain" + tag] = time_ms(
            lambda: fused_attention_ref(q, k, v, None, 32 ** -0.5))
        ms["fused_attention_sdpa" + tag] = time_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=32 ** -0.5))
        say(18, f"K3 B=512 431x431 H=2 D=32 {str(dt)[6:]} on {card}: "
                f"kernel {ms['fused_attention' + tag]:.3f} ms, plain "
                f"{ms['fused_attention_plain' + tag]:.3f} ms, "
                f"scaled_dot_product_attention "
                f"{ms['fused_attention_sdpa' + tag]:.3f} ms")
    batch = next(iter(sess.pipeline))
    ms["eval_step"] = time_ms(lambda: step_k(model, batch), calls=1)
    ms["eval_step_plain"] = time_ms(lambda: step_p(model, batch),
                                    calls=1)
    t0 = time.perf_counter()
    run_eval(step_k, model, sess.pipeline)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in sess.pipeline:
        pass
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    say(18, f"eval step B=512 f32 on {card}: {ms['eval_step']:.3f} ms on "
            f"K3, {ms['eval_step_plain']:.3f} ms plain attention; eval loop "
            f"(run_eval, 2048 samples, host clock): {loop_s * 1e3:.1f} ms = "
            f"{2048 / loop_s:,.0f} poses/s; the pipeline alone (GT "
            f"synthesis + batch assembly): {synth_s * 1e3:.1f} ms = "
            f"{100 * synth_s / loop_s:.1f} % of the loop")
    out["ms"] = {"fused_attention": ms["fused_attention"],
                 "fused_attention_plain": ms["fused_attention_plain"]}
    out["library_ms"] = {"fused_attention": ms["fused_attention_sdpa"]}
    # f32 at f32 accuracy on the tensor cores: three TF32 products (3xTF32)
    # for each of the scores' and PV's FMA; q, k, v read and out written
    b, n, h, d = 512, 431, 2, 32
    out["bounds"] = {"fused_attention": bound(
        3 * 2 * b * h * n * n * d, 4 * b * n * h * d * 4, TF32_FLOP_PER_S)}
    return out


def layer_phases(torch, dev, card, randn, models):
    """Phases 19-21 (l-n): K2-layer and T1 against their plain versions, the
    two tool paths on the card, and their times."""
    from gator_tpu_torch.nn import (MODES, extract_layer_params, gat_trunk,
                                    lbf_layer, lbf_layer_ref, lbf_stack,
                                    run_layers, run_layers_ref)
    from gator_tpu_torch.nn.lbf_ablate import ATTN_KERNELS, ROW_MODES
    from gator_tpu_torch.tools import exp_mdr_ablate, profile_serving
    from gator_tpu_torch.tools.timing import time_ms

    # the modules (the package exports functions of the same names)
    k2_layer_mod = importlib.import_module("gator_tpu_torch.nn.lbf_layer")
    t1_mod = importlib.import_module("gator_tpu_torch.nn.lbf_ablate")

    f32, bf16 = torch.float32, torch.bfloat16
    out = {"errs": {"lbf_layer": 0.0, "lbf_ablate": 0.0}}

    def hold(phase, tag, got, ref, dt, name):
        err = max_err(got, ref)
        check(np.isfinite(err), f"{tag} finite")
        if dt == f32:
            check(err <= 1e-4, f"{tag} f32 err {err} <= 1e-4")
            out["errs"][name] = max(out["errs"][name], err)
        return err

    # 19 (l): K2-layer against its plain version, and against K2 in f32
    for js, model in models.items():
        mdr = model.pose2mesh
        j, nv = mdr.spec.num_joint, mdr.spec.coarse_num
        for b in (16, 2048):
            verts, joints = randn(b, nv, 64), randn(b, j, 64)
            for dt in (f32, bf16):
                w = extract_layer_params(mdr, 0, dt, dev)
                v, jt = verts.to(dt), joints.to(dt)
                got = lbf_layer(v, jt, w, 2)
                tag = f"K2-layer {js} J={j} B={b} Nv={nv} {str(dt)[6:]}"
                err = hold(19, tag, got, lbf_layer_ref(v, jt, w, 2), dt,
                           "lbf_layer")
                msg = f"{tag}: max abs err {err:.3e} vs plain" + (
                    " (bar 1e-4)" if dt == f32 else " (reported)")
                if dt == f32:
                    e_k2 = max_err(got, lbf_stack(v, jt, w, 2))
                    check(e_k2 <= 1e-4, f"{tag} vs K2 {e_k2} <= 1e-4")
                    msg += f"; vs K2 on the same layer {e_k2:.3e} (bar 1e-4)"
                say(19, msg)
                del got

    # 20 (m): every T1 mode against its plain version at B=16 (with group
    # independence) and at the tool's B=2048
    for js, model in models.items():
        mdr = model.pose2mesh
        j, nv = mdr.spec.num_joint, mdr.spec.coarse_num
        layers = {dt: [extract_layer_params(mdr, i, dt, dev)
                       for i in range(3)] for dt in (f32, bf16)}
        for b in (16, 2048):
            verts, joints = randn(b, nv, 64), randn(b, j, 64)
            for mode in MODES:
                errs, same = {}, True
                for dt in (f32, bf16):
                    v, jt = verts.to(dt), joints.to(dt)
                    got = run_layers(v, jt, layers[dt], 2, 8, mode)
                    ref = run_layers_ref(v, jt, layers[dt], 2, 8, mode)
                    errs[dt] = hold(20, f"T1 {mode} {js} B={b}", got, ref,
                                    dt, "lbf_ablate")
                    if b == 16:
                        same &= torch.equal(
                            got, run_layers(v, jt, layers[dt], 2, 1, mode))
                    del got, ref
                check(same, f"T1 {mode} {js}: group 1 and 8 bit-equal")
                say(20, f"T1 {mode} {js} J={j} B={b} Nv={nv} 3 layers: max "
                        f"abs err vs plain f32 {errs[f32]:.3e} (bar 1e-4), "
                        f"bf16 {errs[bf16]:.3e} (reported)"
                        + ("; group 1 and 8 bit-equal" if b == 16 else ""))
            del verts, joints

    # 21 (n): the tool paths; the counters reset just before, read after
    gat_trunk.launches = lbf_stack.launches = lbf_layer.launches = 0
    prof = profile_serving.main([])
    torch.cuda.synchronize()
    counts = {"gat_trunk": gat_trunk.launches,
              "lbf_stack": lbf_stack.launches,
              "lbf_layer": lbf_layer.launches}
    check(all(n > 0 for n in counts.values()),
          f"K1, K2 and K2-layer launched by profile_serving: {counts}")
    check(all(np.isfinite(t) and t > 0 for k, t in prof["ms"].items()
              if k != "head+embeds"), f"stage times {prof['ms']}")
    say(21, f"profile_serving B={prof['batch']} bf16 on {prof['card']}: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in prof["ms"].items())
            + f"; launches {counts}")
    run_layers.launches = 0
    abl = exp_mdr_ablate.main([])
    torch.cuda.synchronize()
    check(run_layers.launches > 0 and len(abl["ms"]) == 3,
          f"T1 launched by exp_mdr_ablate: {run_layers.launches}")
    say(21, f"exp_mdr_ablate (default modes) B=2048 bf16 on {abl['card']}: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in abl["ms"].items())
            + f"; T1 launches {run_layers.launches}")
    out["launches"] = {"lbf_layer": counts["lbf_layer"],
                       "lbf_ablate": run_layers.launches}
    every = exp_mdr_ablate.main(list(MODES))["ms"]
    say(21, "T1 per mode, 3 layers, B=2048 bf16: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in every.items()))

    mdr = models["human36"].pose2mesh
    b, nv = 2048, mdr.spec.coarse_num
    v, jt = randn(b, nv, 64).to(bf16), randn(b, 17, 64).to(bf16)
    layers = [extract_layer_params(mdr, i, bf16, dev) for i in range(3)]
    ms = {
        "lbf_layer": time_ms(lambda: lbf_layer(v, jt, layers[0], 2)),
        "lbf_layer_plain": time_ms(
            lambda: lbf_layer_ref(v, jt, layers[0], 2)),
        "lbf_ablate": time_ms(
            lambda: run_layers(v, jt, layers, 2, 8, "full")),
        "lbf_ablate_plain": time_ms(
            lambda: run_layers_ref(v, jt, layers, 2, 8, "full")),
    }
    say(21, f"K2-layer B={b} bf16 on {card}: {ms['lbf_layer']:.3f} ms per "
            f"layer, plain {ms['lbf_layer_plain']:.3f} ms; T1 full, 3 layers:"
            f" {ms['lbf_ablate']:.3f} ms, plain {ms['lbf_ablate_plain']:.3f}"
            f" ms; row-local modes {', '.join(ROW_MODES)} run no attention")
    out["ms"] = ms

    # the two launches of K2-layer (one layer) and of T1 `full` (3 layers)
    # apart: device ms per call from torch.profiler (each kernel's mean per
    # launch times its launches per call: the profiler can miss a window's
    # first launches), each beside its bound.
    # Per row and layer the row launch reads x (bf16) and writes y3 (f32)
    # and q2/k2/v2 (bf16); the attention reads those four and writes out
    # (bf16): 768 bytes each. Operations: the row launch's products, and
    # QK, PV and L3 once each (pass 1's scores again are not the function's
    # work).
    from gator_tpu_torch.tools.profile_train import _device_us, _is_kernel
    calls = {"K2-layer": (1, lambda: lbf_layer(v, jt, layers[0], 2)),
             "T1 full": (3, lambda: run_layers(v, jt, layers, 2, 8, "full"))}
    rows_io = b * nv * 64 * (2 + 4 + 6) + b * 17 * 64 * 2
    attn_io = b * nv * 64 * (6 + 4 + 2)
    for name, (n_layers, fn) in calls.items():
        dev_ms = dict.fromkeys(("rows_kernel", "attn_kernel"), 0.0)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            for key in dev_ms:
                if _is_kernel(evt) and key in evt.key:
                    dev_ms[key] = _device_us(evt) / evt.count / 1e3 * n_layers
        check(all(t > 0 for t in dev_ms.values()),
              f"the profiler saw {name}'s two launches: {dev_ms}")
        lb = {"rows_kernel": bound(n_layers * b * fma_lbf_rows_fwd(nv, 17),
                                   n_layers * rows_io),
              "attn_kernel": bound(n_layers * b * (2 * nv * nv * 64
                                                   + nv * 64 * 64),
                                   n_layers * attn_io)}
        say(21, f"{name} launches per call ({n_layers} layer"
                f"{'s' if n_layers > 1 else ''}, B={b} bf16) on {card}: "
                + "; ".join(
                    f"{k} {dev_ms[k]:.3f} ms device (bound {lb[k][0]:.3f} "
                    f"ms, {lb[k][1]}; {dev_ms[k] / lb[k][0]:.1f}x)"
                    for k in dev_ms))
    infos = {"K2-layer": k2_layer_mod.attn_info(bf16, nv)}
    infos.update({f"T1 {m}": t1_mod.attn_info(bf16, m, nv)
                  for m in ATTN_KERNELS})
    say(21, f"attn_kernel bf16 Nv={nv} on {card}: " + "; ".join(
        f"{k} registers {i['registers']}, CTAs per SM {i['ctas_per_sm']}, "
        f"shared bytes {i['smem_bytes']}, K/V chunk keys {i['chunk_keys']}"
        for k, i in infos.items()))
    # for scale only: the library's attention on the same q2/k2/v2
    _, q2, k2, v2 = k2_layer_mod.lbf_layer_rows(v, jt, layers[0])
    qkv = [t.view(b, nv, 2, 32).transpose(1, 2) for t in (q2, k2, v2)]
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        *qkv))
    say(21, f"scaled_dot_product_attention on K2-layer's q2/k2/v2 "
            f"[{b}, 2, {nv}, 32] bf16 on {card}: {sdpa:.3f} ms; for scale "
            f"only: the attention alone, without the probability rounding, "
            f"L3 or the residual, used nowhere in the port")
    del q2, k2, v2, qkv
    # one layer reads verts and joints and writes verts, in bf16
    nbytes = (2 * b * nv * 64 + b * 17 * 64) * 2 + LBF_LAYER_WEIGHTS * 2
    out["bounds"] = {
        "lbf_layer": bound(b * fma_lbf_layer(nv, 17), nbytes),
        "lbf_ablate": bound(b * 3 * fma_lbf_layer(nv, 17),
                            nbytes + 2 * LBF_LAYER_WEIGHTS * 2),
    }
    return out


def dataset_phases(torch, dev, card, tmp):
    """Phases 22-25 (o-r): the real-dataset path on fabricated trees in the
    real schemas: the eval CLI with the Human36M and 3DPW metric suites,
    stage-2 steps on the flagship mix of the readers with detector noise,
    and the serve CLI's .obj and f32 flags. -> {phase: launch counts} and
    the flagship mix's host and step times."""
    from gator_tpu_torch import losses
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.cli import serve as serve_cli
    from gator_tpu_torch.cli import test as test_cli
    from gator_tpu_torch.cli.common import build_datasets
    from gator_tpu_torch.config import load_config
    from gator_tpu_torch.data import BatchPipeline, GtSynthesizer, noise
    from gator_tpu_torch.data import processing
    from gator_tpu_torch.models import GatorSpec, build_gator
    from gator_tpu_torch.serving import make_serving_fn
    from gator_tpu_torch.train import (Adam, TrainState,
                                       make_gator_train_step,
                                       save_checkpoint)

    reset, read = launch_counters(torch)
    out = {"launches": {}}

    # 22 (o): the fabricated trees, read through GATOR_DATA_DIR
    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    write_fixtures(data)
    os.environ["GATOR_DATA_DIR"] = data
    say(22, f"fixtures (Human36M train 1280 / test 2048 rows with "
            f"detections, 3DPW 512, COCO 1024, MuCo 1024) written in "
            f"{time.perf_counter() - t0:.1f} s")

    # 23 (p): the eval CLI with the datasets' metric suites, on the card
    assets = {js: build_assets(js, data_dirs=[], synthetic_vertex_num=6890,
                               seed=0) for js in ("human36", "coco")}
    for name in ("gator_human36J_test_human36_det.yml",
                 "gator_cocoJ_test_human36_coco_muco_gt.yml"):
        cfg = load_config(os.path.join(ROOT, "configs", name))
        js = cfg.DATASET.input_joint_set
        model = build_gator(GatorSpec.from_assets(
            assets[js], embed_dim=cfg.MODEL.embed_dim, depth=cfg.MODEL.depth,
            alpha=cfg.MODEL.alpha), seed=21, device="cpu")
        weights = save_checkpoint(os.path.join(tmp, "w_" + js), model, 1)
        reset()
        t0 = time.perf_counter()
        suite, res = test_cli.run_test(cfg, weights,
                                       vis_dir=os.path.join(tmp, "vis"),
                                       assets=assets[js])
        eval_s = time.perf_counter() - t0
        counts = read()
        (ds,) = build_datasets(cfg, assets[js], cfg.DATASET.test_list, False)
        n = len(ds)
        batches = -(-n // cfg.TEST.batch_size)
        check(res["count"] == n, f"{name}: every row evaluated")
        check(counts["fused_attention"] == 3 * batches and all(
            v == 0 for k, v in counts.items() if k != "fused_attention"),
            f"{name}: K3 3 times per batch ({batches}), nothing else: "
            f"{counts}")
        keys = {"mpjpe", "pa_mpjpe", "smpl_mpjpe", "mpvpe"}
        check(set(suite) == keys and all(np.isfinite(list(suite.values()))),
              f"{name}: the metric suite's keys, finite: {suite}")
        pred = torch.as_tensor(res["pred_mesh_mm"][:n], device=dev)
        gt = torch.as_tensor(res["mesh"][:n], device=dev) * 1000.0
        host = ds.evaluate(pred.cpu(), gt.cpu(), verbose=False)
        worst = max(abs(host[k] - suite[k]) / abs(host[k]) for k in keys)
        check(worst <= 1e-5, f"{name}: the card's suite against the same "
                             f"suite on the CPU, rel {worst} <= 1e-5")
        zero = ds.evaluate(gt, gt, verbose=False)
        check(zero["mpvpe"] == 0.0 and zero["smpl_mpjpe"] == 0.0,
              f"{name}: the GT mesh as prediction reads 0: {zero}")
        out["launches"][f"eval {ds.name}"] = counts
        say(23, f"{name}: {type(ds).__name__} {n} rows, {batches} batches "
                f"of {cfg.TEST.batch_size} in {eval_s:.1f} s (host clock, "
                f"set-up included); "
                + ", ".join(f"{k} {suite[k]:.3f}" for k in sorted(keys))
                + f" mm; the CPU's suite within rel {worst:.1e} (bar 1e-5);"
                f" GT as prediction: MPVPE {zero['mpvpe']}; launches "
                f"{counts}")

    # 24 (q): stage-2 steps on the flagship mix (Human36M + COCO + MuCo
    # readers, COCO joints, detector noise, augmentation on), batches from
    # the host pipeline
    cfg = load_config(os.path.join(ROOT, "configs",
                                   "gator_synthetic_flagship.yml"))
    coco = assets["coco"]
    synth = GtSynthesizer(coco, dev)
    datasets = build_datasets(cfg, coco, cfg.DATASET.train_list, True,
                              synthesizer=synth)
    check([type(d).__name__ for d in datasets]
          == ["Human36M", "CocoDataset", "MucoDataset"]
          and not datasets[0].opts.use_gt_input,
          "the flagship mix reads its three readers, detector input")
    b = cfg.TRAIN.batch_size
    pipe = BatchPipeline(datasets, synth, b, shuffle=cfg.TRAIN.shuffle,
                         seed=cfg.seed)
    synth_s = [0.0]
    plain_synth = noise.synthesize_pose_batch

    def timed_synth(*args, **kw):
        t = time.perf_counter()
        try:
            return plain_synth(*args, **kw)
        finally:
            synth_s[0] += time.perf_counter() - t

    noise.synthesize_pose_batch = timed_synth
    try:
        it = iter(pipe)
        kept = [next(it)]                  # the first batch warms up
        torch.cuda.synchronize()
        synth_s[0] = 0.0
        t0 = time.perf_counter()
        for _ in range(5):
            kept.append(next(it))
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / 5
        synth_ms = synth_s[0] * 1e3 / 5
        del it
    finally:
        noise.synthesize_pose_batch = plain_synth
    spec_v = coco.mean_vertices.shape[0]
    check(all(np.isfinite(k["pose2d"]).all() for k in kept)
          and kept[1]["pose2d"].shape == (b, 19, 2)
          and kept[1]["mesh"].shape == (b, spec_v, 3),
          "flagship batches of the configured shape, finite inputs")

    spec = GatorSpec.from_assets(coco, embed_dim=cfg.MODEL.embed_dim,
                                 depth=cfg.MODEL.depth,
                                 alpha=cfg.MODEL.alpha)
    model = build_gator(spec, seed=23, device=dev)
    state = TrainState(model, Adam(model.parameters(), lr=cfg.TRAIN.lr))
    step = make_gator_train_step(
        spec, coco.faces, coco.j_regressor_h36m,
        losses.LossWeights(normal=cfg.MODEL.normal_loss_weight,
                           edge=cfg.MODEL.edge_loss_weight,
                           joint=cfg.MODEL.joint_loss_weight),
        dtype=torch.bfloat16)
    edge = 1.0 if cfg.TRAIN.begin_epoch >= cfg.TRAIN.edge_loss_start \
        else 0.0
    # the main path: 5 steps fed by the pipeline (its prefetch thread
    # overlapping the steps), every counter reset just before
    pipe.set_epoch(1)
    reset()
    curve, e2e = [], []
    it = iter(pipe)
    with torch.enable_grad():
        for _ in range(5):
            t0 = time.perf_counter()
            batch = next(it)
            curve.append(float(step(state, batch, cfg.seed, edge)["loss"]))
            e2e.append((time.perf_counter() - t0) * 1e3)
    del it
    counts = read()
    check(all(np.isfinite(curve)), f"flagship losses finite: {curve}")
    check(counts["gat_trunk_train"] > 0 and counts["lbf_stack_train"] > 0
          and counts["fused_attention"] == counts["gat_trunk"]
          == counts["lbf_stack"] == 0,
          f"K4 and K5 (only) launched on the flagship steps: {counts}")
    out["launches"]["flagship stage 2"] = counts
    # the step alone, on batches already made
    step_ms = []
    with torch.enable_grad():
        for batch in kept[1:]:
            t0 = time.perf_counter()
            float(step(state, batch, cfg.seed, edge)["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
    out["flagship"] = {"host_ms": host_ms, "synth_ms": synth_ms,
                       "step_ms": float(np.median(step_ms)),
                       "e2e_ms": float(np.median(e2e[1:]))}
    say(24, f"flagship stage 2, B={b} bf16, kernels on: losses "
            + " ".join(f"{c:.4f}" for c in curve)
            + f"; launches {counts}")
    print(f"flagship host pipeline: {host_ms:.1f} ms per batch of {b} "
          f"(synthesize_pose_batch {synth_ms:.1f} ms of it), host clock, "
          f"mean of 5 after one warm-up", flush=True)
    print(f"flagship stage-2 step: {out['flagship']['step_ms']:.1f} ms "
          f"(median of 5, host clock, synchronised); fed by the pipeline "
          f"{out['flagship']['e2e_ms']:.1f} ms per step (median of steps "
          f"2-5)", flush=True)
    print(f"flagship times on {card}", flush=True)

    # 25 (r): the serve CLI's .obj dump and --f32, on the card
    rng = np.random.default_rng(25)
    poses = np.concatenate([rng.uniform(50, 450, size=(300, 17, 2)),
                            rng.uniform(0.3, 1.0, size=(300, 17, 1))],
                           axis=2).astype(np.float32)
    src, dst = os.path.join(tmp, "poses.npy"), os.path.join(tmp, "m.npy")
    objs = os.path.join(tmp, "objs")
    np.save(src, poses)
    reset()
    served = serve_cli.main(["--input_poses", src, "--joint_set", "coco",
                             "--output", dst, "--obj_dir", objs,
                             "--obj_every", "100", "--f32"])
    counts = read()
    check(counts["gat_trunk"] > 0 and counts["lbf_stack"] > 0,
          f"K1 and K2 launched by the serve CLI: {counts}")
    names = sorted(os.listdir(objs))
    check(names == [f"mesh_{i:06d}.obj" for i in (0, 100, 200)],
          f"one .obj per 100 poses: {names}")
    cli_assets = build_assets("coco")
    cli_model = build_gator(GatorSpec.from_assets(cli_assets), seed=0,
                            device=dev)
    pose2d = processing.batch_crop_and_normalize(
        processing.add_pelvis_neck_scores(
            poses, list(cli_assets.joint_set.joints_name))[..., :2],
        cli_assets.joint_set,
        processing.ProcessOptions(is_train=False, input_joint_name="coco"),
        np.zeros(300, np.int64), np.zeros(300, np.float32))
    fn = make_serving_fn(cli_model, torch.float32)
    ref = np.concatenate([
        fn(torch.from_numpy(pose2d[lo:lo + 256]).to(dev))[0].cpu().numpy()
        for lo in (0, 256)])
    e_f32 = float(np.abs(served["meshes"] - ref).max())
    check(e_f32 <= 1e-4, f"--f32 meshes against make_serving_fn in f32: "
                         f"{e_f32} <= 1e-4 m")
    out["launches"]["serve --f32"] = counts
    say(25, f"serve CLI --f32 --obj_dir --obj_every 100: 300 poses, "
            f"{len(names)} .obj files, meshes within {e_f32:.2e} m of "
            f"make_serving_fn in f32 (bar 1e-4); launches {counts}")
    return out


# -- detector noise on the device: the checks phase 26 and the CPU tests
#    share (host numpy in, no card needed) ------------------------------

# the h36m joints in the readers' order (data/base.py)
H36M_JOINTS = ("Pelvis", "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee",
               "L_Ankle", "Torso", "Neck", "Nose", "Head", "L_Shoulder",
               "L_Elbow", "L_Wrist", "R_Shoulder", "R_Elbow", "R_Wrist")


def noise_boundary_cases(joints, areas, draws, out):
    """[B, 17] True where a (row, joint) of `synthesize_pose_device` on
    all-visible joints, fed the draws `draws` ({path: array}), is a
    boundary case of the run that gave `out`: a candidate of one of its
    five annuli within 1e-3 px of its acceptance radius, or its state
    uniform within 1e-6 of a cumulative-probability edge (a float64
    recomputation from the same draws). An ulp of cos, sin or a sum moves
    such a case across its edge."""
    from gator_tpu_torch.data import device_noise as dn
    from gator_tpu_torch.data import noise

    b = len(joints)
    var = (noise.KPS_SIGMAS * 2) ** 2
    a = areas.astype(np.float64)[:, None]
    ks10, ks50, ks85 = (np.sqrt(-2.0 * a * var * np.log(q))
                        for q in (0.10, 0.50, 0.85))
    near = np.zeros((b, 17), bool)
    for w, wave in enumerate((dn._WAVE1, dn._WAVE2)):
        pair = noise._PAIR[wave]
        gt = joints[:, wave].astype(np.float64)
        # wave 2's pairs were synthesised in wave 1
        src = out if w == 1 else joints
        pp = np.where((pair >= 0)[None, :, None],
                      src[:, np.maximum(pair, 0)], 0.0).astype(np.float64)
        has = np.broadcast_to(pair >= 0, (b, len(wave)))
        every = np.ones_like(has)
        k85, k50, k10 = ks85[:, wave], ks50[:, wave], ks10[:, wave]
        zero = np.zeros_like(k85)
        ann = {1: (gt, k85, k50, pp, has, None),
               3: (gt, zero, k85, pp, has, None),
               5: (pp, zero, k50, gt, every, None),
               6: (gt, k50, k10, pp, has, k50),
               7: (pp, k50, k10, gt, every, k50)}
        ok = {}
        for i, (c, lo, hi, other, ovalid, rr) in ann.items():
            ang = np.asarray(draws[(w, i, 0)], np.float64) \
                * float(np.float32(2 * np.pi))
            r = (np.asarray(draws[(w, i, 1)], np.float64)
                 * (hi - lo)[..., None] + lo[..., None])
            d = np.hypot(c[..., 0, None] + r * np.cos(ang)
                         - other[..., 0, None],
                         c[..., 1, None] + r * np.sin(ang)
                         - other[..., 1, None])
            radius = r if rr is None else rr[..., None]
            near[:, wave] |= ((np.abs(d - radius) < 1e-3)
                              & ovalid[..., None]).any(-1)
            ok[i] = np.where(ovalid[..., None], d > radius, True)
        w_p = np.floor((ok[7] & has[..., None]).sum(-1) / 4.0)
        jit, miss, inv = (noise._JIT_HIGH[wave], noise._MISS_HIGH[wave],
                          noise._INV_P[wave])
        probs = np.stack([jit * ok[1].any(-1),
                          miss * (ok[6].sum(-1) + w_p > 0),
                          inv * (ok[5].any(-1) & has),
                          (1 - jit - miss - inv) * ok[3].any(-1)], -1)
        u = np.asarray(draws[(w, 11)], np.float64) \
            * np.maximum(probs.sum(-1), 1e-12)
        near[:, wave] |= (np.abs(u[..., None] - np.cumsum(probs, -1))
                          < 1e-6).any(-1)
    return near


def noise_same_draws(joints, areas, draws, got, want):
    """The shared-draws rule: `got` and `want` ([B, 17, 2], one
    simulator's output each from the same draws) agree within 1e-3 px on
    every (row, joint) but at most 0.2 % boundary cases, each one a
    boundary case of its own (`noise_boundary_cases`) or downstream of its
    wave-1 pair's. -> (cases beyond 1e-3 px, of them explained, max error
    of the rest); raises if the rule fails."""
    from gator_tpu_torch.data import device_noise as dn
    from gator_tpu_torch.data import noise

    err = np.abs(got - want).max(-1)
    off = err > 1e-3
    near = noise_boundary_cases(joints, areas, draws, want)
    upstream = np.zeros_like(off)
    for j in dn._WAVE2:
        p = noise._PAIR[j]
        upstream[:, j] = off[:, p] & near[:, p]
    explained = off & (near | upstream)
    rest = float(err[~off].max()) if (~off).any() else 0.0
    check(off.mean() <= 0.002 and not (off & ~explained).any(),
          f"shared draws: {int(off.sum())} of {off.size} beyond 1e-3 px "
          f"(bar 0.2 %), unexplained at {np.argwhere(off & ~explained)}")
    return int(off.sum()), int(explained.sum()), rest


def input_phases(torch, dev, card, host_path):
    """Phases 26-27 (s-t): detector noise on the card, and the in-step
    input paths through `Session(cfg, is_train=True)`: the flagship mix on
    the phase-22 trees in "device" mode, the e2e configs in "full" mode
    (both stages) and one "on" run. -> {phase: launch counts} and the
    flagship's times. `host_path`: phase 24's times."""
    from gator_tpu_torch.cli.common import Session
    from gator_tpu_torch.config import load_config
    from gator_tpu_torch.data import device_noise as dn
    from gator_tpu_torch.data import noise
    from gator_tpu_torch.data.packed import with_packed_input_pipeline
    from gator_tpu_torch.tools.check_noise_distribution import (
        RECIPE_AREAS, gate_poses, noise_gate)
    from gator_tpu_torch.tools.profile_packed_step import profile
    from gator_tpu_torch.train import Adam

    reset, read = launch_counters(torch)
    out = {"launches": {}}

    # 26 (s): the sampler on the card against its CPU form, on CPU draws
    class Recorded(dn.Draws):
        def __init__(self, gen):
            self.gen, self.table = gen, {}

        def uniform(self, path, shape):
            self.table[path] = torch.rand(tuple(shape), generator=self.gen)
            return self.table[path]

        def normal(self, path, shape):
            self.table[path] = torch.randn(tuple(shape), generator=self.gen)
            return self.table[path]

    class Replay(dn.Draws):
        def __init__(self, table):
            self.table = {k: v.to(dev) for k, v in table.items()}

        def uniform(self, path, shape):
            return self.table[path]

        normal = uniform

    b = 512
    poses, areas = gate_poses(b, seed=26)
    rec = Recorded(torch.Generator().manual_seed(26))
    want = dn.synthesize_pose_device(rec, torch.from_numpy(poses),
                                     torch.from_numpy(areas)).numpy()
    got = dn.synthesize_pose_device(
        Replay(rec.table), torch.from_numpy(poses).to(dev),
        torch.from_numpy(areas).to(dev)).cpu().numpy()
    off, explained, rest = noise_same_draws(
        poses, areas, {k: v.numpy() for k, v in rec.table.items()}, got,
        want)
    stats = torch.from_numpy(noise.h36m_error_stats(H36M_JOINTS))
    rec = Recorded(torch.Generator().manual_seed(27))
    h_want = dn.h36m_syn_error_device(rec, stats, b, (384, 288)).numpy()
    h_got = dn.h36m_syn_error_device(Replay(rec.table), stats.to(dev), b,
                                     (384, 288)).cpu().numpy()
    h_err = float(np.abs(h_got - h_want).max())
    check(h_err <= 1e-6, f"h36m noise, same draws: {h_err} <= 1e-6")
    say(26, f"synthesize_pose_device B={b} on the card, fed the CPU's "
            f"draws: {off} of {b * 17} (row, joint) beyond 1e-3 px "
            f"({explained} boundary cases), the rest within {rest:.2e} px;"
            f" h36m_syn_error_device within {h_err:.1e}")

    n = 4096
    poses, areas = gate_poses(n, seed=0)
    host = noise.synthesize_pose_batch(
        np.concatenate([poses, np.ones((n, 17, 1), np.float32)], -1),
        areas, np.random.default_rng((0, 2)))
    host_xy = np.where(host[..., 2:] > 0, host[..., :2], 0.0)
    card_xy = dn.synthesize_pose_device(
        torch.Generator(device=dev).manual_seed(0),
        torch.from_numpy(poses).to(dev),
        torch.from_numpy(areas).to(dev)).cpu().numpy()
    diff, ks, ks_bar = noise_gate(card_xy, host_xy, poses, areas)
    check(diff <= 0.01 and ks <= ks_bar,
          f"the card's sampler against the host's: state frequencies "
          f"{diff} <= 0.01, KS {ks} <= {ks_bar}")
    joints = torch.from_numpy(poses[:b]).to(dev)
    area_t = torch.from_numpy(areas[:b]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    sampler = profile(lambda: dn.synthesize_pose_device(gen, joints, area_t))
    out["sampler"] = sampler
    say(26, f"its own generator, N={n} poses over the areas "
            f"{RECIPE_AREAS}, against the host synthesize_pose_batch: "
            f"state frequencies within {diff:.4f} (bar 0.01), KS {ks:.4f} "
            f"(bar {ks_bar:.4f})")
    print(f"synthesize_pose_device B={b}: {sampler['device_ms']:.3f} ms "
          f"device, {sampler['launches']:.0f} launches, "
          f"{sampler['host_ms']:.3f} ms host (device ms and launches per "
          f"call from torch.profiler over 5 calls, host ms the median of 5 "
          f"synchronised calls) on {card}", flush=True)

    # 27 (t) 1: the flagship mix on the phase-22 trees, "device" mode
    cfg = load_config(os.path.join(ROOT, "configs",
                                   "gator_synthetic_flagship.yml"))
    sess = Session(cfg, device=dev, is_train=True)
    check(sess.gt_in_step == "device"
          and [type(d).__name__ for d in sess.datasets]
          == ["Human36M", "CocoDataset", "MucoDataset"],
          f"the flagship's readers resolve auto to device: "
          f"{sess.gt_in_step}")
    state, step = sess.make_train_step(lambda p: Adam(p, lr=cfg.TRAIN.lr))
    edge = 1.0 if cfg.TRAIN.begin_epoch >= cfg.TRAIN.edge_loss_start \
        else 0.0
    seed, b = cfg.seed, cfg.TRAIN.batch_size
    table = sess.packed_table()
    uncached = with_packed_input_pipeline(
        step.inner, table, sess.synth, sess.assets.joint_set,
        opts=sess.datasets[0].opts, device_input=True, mesh_cache=False)

    def fed(step_fn, epoch):
        """5 steps fed by the pipeline -> (losses, host ms per step)."""
        sess.pipeline.set_epoch(epoch)
        curve, ms = [], []
        it = iter(sess.pipeline)
        with torch.enable_grad():
            for _ in range(5):
                t0 = time.perf_counter()
                curve.append(float(step_fn(state, next(it), seed,
                                           edge)["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
        it.close()
        return curve, ms

    it = iter(sess.pipeline)
    first = next(it)
    it.close()
    check(set(first) == {"row", "flips", "rots"}
          and all(v.device.type == "cuda" for v in first.values()),
          "index batches on the card")
    with torch.enable_grad():
        step(state, first, seed, edge)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        inner = step.assemble(state, first, seed, edge)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(inner["pose2d"].shape == (b, 19, 2)
          and bool(torch.isfinite(inner["pose2d"]).all()),
          "the in-step input: shape, finite")
    reset()
    curve, _ = fed(step, 1)
    counts = read()
    check(all(np.isfinite(curve)), f"flagship device-mode losses finite: "
                                   f"{curve}")
    check(counts["gat_trunk_train"] > 0 and counts["lbf_stack_train"] > 0
          and counts["fused_attention"] == counts["gat_trunk"]
          == counts["lbf_stack"] == 0,
          f"K4 and K5 (only) launched on the device-mode steps: {counts}")
    out["launches"]["flagship device mode"] = counts
    it = iter(sess.pipeline)
    next(it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        next(it)
    host_ms = (time.perf_counter() - t0) * 1e3 / 5
    it.close()
    # the mesh cache on and off in turns (on, off, off, on), steps 2-5 of
    # each round
    fed_ms = {"on": [], "off": []}
    for epoch, cache in enumerate(("on", "off", "off", "on"), start=2):
        fed_ms[cache] += fed(step if cache == "on" else uncached, epoch)[1][1:]
    out["flagship"] = {"host_ms": host_ms,
                       "fed_cache_on_ms": float(np.median(fed_ms["on"])),
                       "fed_cache_off_ms": float(np.median(fed_ms["off"]))}
    say(27, f"flagship on the phase-22 trees, gt_in_step auto -> device, "
            f"B={b} bf16, kernels on: losses "
            + " ".join(f"{c:.4f}" for c in curve)
            + f"; no host sync in the input assembly; launches {counts}")
    print(f"flagship device mode: {host_ms:.2f} ms per index batch on the "
          f"host (mean of 5 after one); {card}", flush=True)
    print(f"flagship device mode: {out['flagship']['fed_cache_on_ms']:.1f} "
          f"ms per step fed by the pipeline, mesh cache on "
          f"({len(table)} rows; host clock, median of steps 2-5 of two "
          f"rounds taken in turns with the cache off); {card}", flush=True)
    print(f"flagship device mode: {out['flagship']['fed_cache_off_ms']:.1f}"
          f" ms per step fed by the pipeline, mesh cache off; {card}",
          flush=True)
    print(f"flagship host path (phase 24): {host_path['host_ms']:.1f} ms "
          f"per batch, {host_path['e2e_ms']:.1f} ms per step fed; {card}",
          flush=True)
    del sess, state, step, uncached, table, inner, first

    # 27 (t) 2: the e2e configs in "full" mode (both stages) and one "on"
    # run; the wrapped step's batch against the host path's at the same
    # rows, flips and rotations
    bars = {"pose2d": 1e-5, "mesh": 2e-6, "lift_pose3d": 2e-3,
            "reg_pose3d": 2e-3, "joint_cam": 2e-3}
    aug = {"AUG": {"flip": True, "rotate_factor": 30}}
    runs = (("gator_synthetic_e2e.yml", "full", aug),
            ("gat_synthetic_e2e.yml", "full", aug),
            ("gator_synthetic_e2e.yml", "on",
             {**aug, "TRAIN": {"gt_in_step": "on"}}))
    for name, mode, over in runs:
        cfg = load_config(os.path.join(ROOT, "configs", name), over)
        sess = Session(cfg, synthetic=True,
                       synthetic_n=4 * cfg.TRAIN.batch_size, device=dev,
                       is_train=True)
        check(sess.gt_in_step == mode, f"{name}: {sess.gt_in_step}")
        state, step = sess.make_train_step(
            lambda p: Adam(p, lr=cfg.TRAIN.lr))
        extra = (cfg.seed, 1.0) if sess.is_gator else (cfg.seed,)
        stage = "gator" if sess.is_gator else "gat"
        ds = sess.datasets[0]
        idx = np.arange(cfg.TRAIN.batch_size)[::-1].copy()
        form = ds.make_raw_batch if mode == "on" else ds.make_index_batch
        batch = form(idx, np.random.default_rng(27), stage=stage)
        if mode != "on":
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in batch.items()}
        got = step.assemble(state, batch, *extra)
        host = ds.make_batch(idx, sess.synth, np.random.default_rng(27),
                             stage=stage)
        check(set(got) == set(host), f"{name} {mode}: the host's keys")
        worst = {}
        for k, v in host.items():
            g = got[k].float().cpu().numpy()
            h = torch.as_tensor(v).float().cpu().numpy()
            worst[k] = float(np.abs(g - h).max())
            check(g.shape == h.shape and (
                worst[k] == 0 if k.endswith("valid")
                else worst[k] <= bars[k]),
                f"{name} {mode} {k}: {worst[k]} (bar "
                f"{0 if k.endswith('valid') else bars[k]})")
        reset()
        curve = []
        it = iter(sess.pipeline)
        with torch.enable_grad():
            for _ in range(3):
                curve.append(float(step(state, next(it), *extra)["loss"]))
        it.close()
        counts = read()
        check(all(np.isfinite(curve)), f"{name} {mode}: losses {curve}")
        launched = {"gat_trunk_train"} | (
            {"lbf_stack_train"} if sess.is_gator else set())
        check(all((counts[k] > 0) == (k in launched) for k in counts),
              f"{name} {mode}: launched {sorted(launched)} only: {counts}")
        out["launches"][f"{name} {mode}"] = counts
        say(27, f"{name} gt_in_step={mode}, B={cfg.TRAIN.batch_size} "
                f"{cfg.TRAIN.precision}: the wrapped step's batch against "
                f"the host path's: "
                + ", ".join(f"{k} {v:.1e}" for k, v in sorted(worst.items()))
                + "; losses " + " ".join(f"{c:.4f}" for c in curve)
                + f"; launches {counts}")
        del sess, state, step
    return out


CONVERGENCE_DIR = os.path.join("build", "convergence")


def _per_epoch(counts, epochs):
    return {k: v / epochs for k, v in counts.items() if v}


def train_cli_phases(torch, card):
    """Phase 28 (u): the train CLI on the card through the port's
    convergence tool, each run with every counter reset just before and
    read just after: (a) configs/gator_synthetic_convergence.yml at the
    tool's defaults; (b) the flagship-shaped two-stage recipe against the
    port's own scratch run of the same stage-2 config (the tool's passed
    and beats_scratch are findings, not checks, in both); (c) a SIGTERM in
    epoch 2 of a full-width smoke run and --resume_training, against an
    uninterrupted run. Runs from the repo root with relative paths (the
    artifacts name what ran); the artifacts go to build/convergence/.
    -> {"launches": {run: launch counts}}."""
    import shutil
    import signal

    from gator_tpu_torch.cli.train import run_train
    from gator_tpu_torch.config import load_config
    from gator_tpu_torch.data.pipeline import BatchPipeline
    from gator_tpu_torch.tools import run_convergence_cli as conv
    from gator_tpu_torch.train import load_checkpoint

    reset, read = launch_counters(torch)
    out = {"launches": {}}
    t_phase = time.perf_counter()
    prev_cwd = os.getcwd()
    os.chdir(ROOT)
    os.makedirs(CONVERGENCE_DIR, exist_ok=True)

    def tool(name, argv):
        """The convergence tool -> (artifact, launch counts); its
        checkpoints are removed after it."""
        exp = os.path.join(CONVERGENCE_DIR, name)
        art = os.path.join(CONVERGENCE_DIR, f"{name}.json")
        reset()
        with torch.enable_grad():
            conv.main(argv + ["--exp_dir", exp, "--out", art])
        counts = read()
        shutil.rmtree(exp, ignore_errors=True)
        with open(art) as f:
            return json.load(f), counts

    def curves(res):
        return ("eval MPJPE " + " ".join(
            f"{x:.1f}" for x in res["eval_mpjpe_per_epoch"])
            + "; samples/s " + " ".join(
                f"{x:,.0f}" for x in res["samples_per_s_per_epoch"])
            + "; epoch s (train/eval/save) " + " ".join(
                f"{e['train_s']:.2f}/{e['eval_s']:.2f}/{e['save_s']:.2f}"
                for e in res["epoch_seconds"]))

    try:
        # (a) the GT-input recipe at the tool's defaults
        t0 = time.perf_counter()
        res, counts = tool("convergence_torch",
                           ["--cfg", "configs/gator_synthetic_convergence.yml",
                            "--epochs", "12", "--n", "2048"])
        out["launches"]["gator_synthetic_convergence.yml"] = counts
        per = _per_epoch(counts, 12)
        check(set(per) == {"gat_trunk_train", "lbf_stack_train",
                           "fused_attention"}
              and all(v == int(v) for v in per.values()),
              f"K5, K4 and K3 launched the same every epoch: {counts}")
        say(28, f"(a) gator_synthetic_convergence.yml, 12 epochs, n=2048, "
                f"B=256 bf16, gt_in_step full, on {card}: {curves(res)}; "
                f"launches per epoch {per}; best "
                f"{res['best_joint_err_mm']:.2f} mm; passed "
                f"{res['passed']} {res['failures']} "
                f"({time.perf_counter() - t0:.1f} s)")
        j = res["eval_mpjpe_per_epoch"]
        check(len(j) == 12 and all(np.isfinite(j)) and min(j) < j[0]
              and res["best_dir_exists"],
              f"(a) 12 finite evals that improve, best.pth.tar: {j}")

        # (b) the flagship-shaped two-stage run against the port's own
        # scratch run of the same stage-2 config, same n and seed
        t0 = time.perf_counter()
        flagship = ["--cfg", "configs/gator_synthetic_flagship.yml",
                    "--epochs", "12", "--n", "2048"]
        scratch, counts = tool("convergence_scratch_torch", flagship)
        out["launches"]["flagship scratch"] = counts
        say(28, f"(b) scratch gator_synthetic_flagship.yml, 12 epochs, "
                f"n=2048, B=512 bf16, gt_in_step auto -> device, on "
                f"{card}: {curves(scratch)}; launches per epoch "
                f"{_per_epoch(counts, 12)}; best "
                f"{scratch['best_joint_err_mm']:.2f} mm; passed "
                f"{scratch['passed']} {scratch['failures']}")
        two, counts = tool("convergence_two_stage_torch", [
            "--two_stage", "--stage1_cfg",
            "configs/gat_cocoJ_synthetic_convergence.yml",
            "--stage1_epochs", "8", "--baseline",
            os.path.join(CONVERGENCE_DIR,
                         "convergence_scratch_torch.json")] + flagship)
        out["launches"]["flagship two-stage"] = counts
        check(all(np.isfinite(two["eval_mpjpe_per_epoch"]))
              and len(two["eval_mpjpe_per_epoch"]) == 12
              and len(two["stage1"]["eval_mpjpe_per_epoch"]) == 8,
              "(b) both stages ran every epoch, finite")
        say(28, f"(b) stage 1 gat_cocoJ_synthetic_convergence.yml, 8 "
                f"epochs, B=256 bf16, on {card}: {curves(two['stage1'])}")
        say(28, f"(b) stage 2 from the stage-1 best, on {card}: "
                f"{curves(two)}; launches of both stages {counts}; best "
                f"{two['best_joint_err_mm']:.2f} mm against scratch "
                f"{two['scratch_best_joint_err_mm']:.2f}: passed "
                f"{two['passed']}, beats_scratch {two['beats_scratch']} "
                f"{two['failures']} ({time.perf_counter() - t0:.1f} s)")

        # (c) SIGTERM in epoch 2 and --resume_training against an
        # uninterrupted run: the smoke config at full width
        t0 = time.perf_counter()
        cfg = load_config("configs/gator_synthetic_smoke.yml")
        dirs = {k: os.path.join(CONVERGENCE_DIR, f"resume_{k}")
                for k in ("straight", "run")}
        set_epoch = BatchPipeline.set_epoch

        def term_in_epoch_2(self, epoch):
            set_epoch(self, epoch)
            if epoch == 2 and self.drop_last:
                signal.raise_signal(signal.SIGTERM)

        with torch.enable_grad():
            run_train(cfg, exp_dir=dirs["straight"], synthetic=True)
            BatchPipeline.set_epoch = term_in_epoch_2
            try:
                run_train(cfg, exp_dir=dirs["run"], synthetic=True)
            finally:
                BatchPipeline.set_epoch = set_epoch
            ckpts = sorted(os.listdir(os.path.join(dirs["run"],
                                                   "checkpoint")))
            check(ckpts == ["best.pth.tar", "checkpoint1.pth.tar"],
                  f"(c) SIGTERM wrote checkpoint1 only: {ckpts}")
            run_train(cfg, exp_dir=dirs["run"], synthetic=True, resume=True)
        got, want = (load_checkpoint(os.path.join(
            dirs[k], "checkpoint", "final.pth.tar")) for k in ("run",
                                                                 "straight"))
        pairs = [(got["train_log"][1], want["train_log"][1])] + [
            (got["test_log"][k][1], want["test_log"][k][1])
            for k in ("joint", "surface")]
        rel = max(abs(a - b) / abs(b) for a, b in pairs)
        w_err = max(float((got["model_state_dict"][k].float()
                           - v.float()).abs().max())
                    for k, v in want["model_state_dict"].items())
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)
        say(28, f"(c) gator_synthetic_smoke.yml at full width, B=16 f32, "
                f"SIGTERM in epoch 2 then --resume_training, on {card}: "
                f"epoch-2 loss, MPJPE, MPVPE against an uninterrupted run: "
                f"max relative difference {rel:.3e} (bar 1e-4); final "
                f"weights "
                + ("bit-equal" if w_err == 0 else
                   f"differ by up to {w_err:.3e} (K4's or K5's sums are "
                   f"not bit-deterministic here)")
                + f" ({time.perf_counter() - t0:.1f} s)")
        check(rel <= 1e-4, f"(c) resume against uninterrupted {rel} <= 1e-4")
    finally:
        os.chdir(prev_cwd)
    say(28, f"phase 28 wall time {time.perf_counter() - t_phase:.1f} s; "
            f"artifacts in {CONVERGENCE_DIR}/")
    return out


# the fabricated COCO pose of tests/test_coverage_extras.py:61-66, pixels
DEMO_POSE = np.array(
    [[500, 180], [520, 160], [480, 160], [545, 170], [455, 170],
     [580, 260], [420, 260], [610, 380], [390, 380], [630, 490],
     [370, 490], [560, 520], [440, 520], [565, 700], [435, 700],
     [570, 880], [430, 880]], np.float32)


def demo_phases(torch, dev, card):
    """Phase 29 (v): the demo CLI and the rest of the JAX package's
    surface on the card, at full width (synthetic 6890-vertex assets,
    embed 128, depth 6, f32, TF32 off). -> {"launches": {"fused_attention":
    the demo's K3 launches}}."""
    import contextlib
    import io
    from unittest import mock

    import scipy.sparse as sp

    from gator_tpu_torch import ops, profiling
    from gator_tpu_torch.assets import (build_assets, coarsening, graphs,
                                        native, skeletons)
    from gator_tpu_torch.bodymodel import mano, rotations6d
    from gator_tpu_torch.cli import demo
    from gator_tpu_torch.data import coords
    from gator_tpu_torch.models import GatorSpec, build_gator
    from gator_tpu_torch.models.camera import crop_cam_to_orig_img
    from gator_tpu_torch.nn.fused_attention import (fused_attention,
                                                    fused_attention_ref)
    from gator_tpu_torch.smoothing import one_euro_smooth_torch
    from gator_tpu_torch.tools.timing import time_ms
    from gator_tpu_torch.vis import render_mesh_overlay

    import torch.nn.functional as F

    t_phase = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    reset, read = launch_counters(torch)
    gen = torch.Generator().manual_seed(29)
    assets = {js: build_assets(js) for js in ("coco", "human36")}
    out = {"launches": {"fused_attention": 0}}

    # (a) the demo whole, through `main` and its flags: coco and human36,
    # the closed-form fit, then --adam_fit; seeded weights, the same file
    # for every run. cv2 is hidden, as on a machine without it: the demo
    # then skips its two PNGs and says so, and (c) times the renderer once.
    # (Only that key is swapped: restoring a copy of sys.modules would drop
    # the modules the runs imported, and torch's would register twice.)
    cv2_module = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    with tempfile.TemporaryDirectory() as tmp:
        pose_path = os.path.join(tmp, "pose.npy")
        np.save(pose_path, np.concatenate(
            [DEMO_POSE + np.random.default_rng(1234).normal(
                0, 5, (17, 2)).astype(np.float32),
             np.ones((17, 1), np.float32)], 1))
        runs = {}
        for joint_set, flags in (("coco", []), ("coco", ["--adam_fit"]),
                                 ("human36", [])):
            tag = f"{joint_set}{' --adam_fit' if flags else ''}"
            weights = os.path.join(tmp, f"{joint_set}.pth.tar")
            if not os.path.exists(weights):
                torch.save({"epoch": 0, "model_state_dict": build_gator(
                    GatorSpec.from_assets(assets[joint_set]), seed=1,
                    device="cpu").state_dict()}, weights)
            out_dir = os.path.join(tmp, tag.replace(" ", ""))
            kept = {}
            real_build = demo.build_gator
            real_fit = demo.fit_camera_closed_form

            def keep_input(module, args):
                kept.setdefault("pose2d", args[0])

            def keep_model(*a, **k):
                kept["model"] = real_build(*a, **k)
                kept["model"].register_forward_pre_hook(keep_input)
                return kept["model"]

            def keep_fit(pose3d, target, crop):
                kept["fit_args"] = (pose3d, target, crop)
                return real_fit(pose3d, target, crop)

            printed = io.StringIO()
            torch.cuda.synchronize()
            reset()
            t0 = time.perf_counter()
            with mock.patch.object(demo, "build_gator", keep_model), \
                    mock.patch.object(demo, "fit_camera_closed_form",
                                      keep_fit), \
                    contextlib.redirect_stdout(printed):
                res = demo.main(["--input_pose", pose_path, "--joint_set",
                                 joint_set, "--weights", weights,
                                 "--output_dir", out_dir] + flags)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read()
            lines = printed.getvalue().splitlines()
            for line in lines:
                say(29, f"demo {tag} printed: {line}")
            check(counts["fused_attention"] == 3 and all(
                n == 0 for k, n in counts.items() if k != "fused_attention"),
                f"demo {tag}: K3 launched 3 times and nothing else: "
                f"{counts}")
            out["launches"]["fused_attention"] += counts["fused_attention"]
            with open(res["obj_path"]) as f:
                obj_v = np.array([ln.split()[1:] for ln in f
                                  if ln.startswith("v ")], np.float64)
            check(obj_v.shape == (6890, 3) and np.isfinite(obj_v).all(),
                  f"demo {tag}: demo_mesh.obj has 6890 finite vertices")
            check(res["mesh"].shape == (6890, 3)
                  and np.isfinite(res["mesh"]).all(),
                  f"demo {tag}: mesh finite, 6890 vertices")
            check(not any(os.path.exists(os.path.join(out_dir, name))
                          for name in demo.IMAGES) and any(
                line.startswith("skipped demo_mesh.png and "
                                "demo_pose2d.png: cv2 is not installed")
                for line in lines),
                f"demo {tag}: the skipped PNGs named: {lines}")
            l1 = float(lines[0].split("L1=")[1][:-2])
            cam = np.concatenate([res["cam"].s.cpu().numpy()[0],
                                  res["cam"].t.cpu().numpy()[0]])
            check(np.isfinite(cam).all() and np.isfinite(l1),
                  f"demo {tag}: camera and L1 finite")
            runs[tag] = dict(res=res, kept=kept, wall=wall, cam=cam, l1=l1)
            say(29, f"demo {tag} on {card}: wall {wall:.3f} s (host clock, "
                    f"model build and weights included); K3 launches "
                    f"{counts['fused_attention']}; fitted (s, tx, ty) "
                    f"{cam.tolist()}, L1 {l1:.2f} px; .obj 6890 vertices, "
                    f"finite; PNGs skipped (cv2 hidden)")
    if cv2_module is None:
        del sys.modules["cv2"]
    else:
        sys.modules["cv2"] = cv2_module

    # (b) each run's mesh against the plain path (the same model and input,
    # use_kernels=False), and each closed-form camera against the same fit
    # on the CPU
    for tag, run in runs.items():
        model, pose2d = run["kept"]["model"], run["kept"]["pose2d"]
        with torch.no_grad():
            plain, _ = model(pose2d, use_kernels=False)
        e_mesh = float(np.abs(run["res"]["mesh"]
                              - plain[0].cpu().numpy()).max())
        check(e_mesh <= 1e-4, f"demo {tag} mesh vs plain {e_mesh} <= 1e-4 m")
        msg = f"demo {tag}: mesh vs plain path {e_mesh:.3e} m (bar 1e-4)"
        if "--adam_fit" not in tag:
            pose3d, target, crop = run["kept"]["fit_args"]
            cpu = demo.fit_camera_closed_form(pose3d.cpu(), target.cpu(),
                                              crop)
            cpu_cam = np.concatenate([cpu.s.numpy()[0], cpu.t.numpy()[0]])
            rel = float(np.abs(run["cam"] - cpu_cam).max()
                        / np.abs(cpu_cam).max())
            check(rel <= 1e-4, f"demo {tag} closed form card vs CPU {rel}")
            msg += f"; closed-form camera vs the CPU's rel {rel:.2e} " \
                   f"(bar 1e-4)"
        say(29, msg)

    # (c) the software renderer on the coco demo's mesh and camera, on the
    # image the demo would draw (host numpy)
    run = runs["coco"]
    joints = demo.add_pelvis_neck_3(
        np.concatenate([DEMO_POSE + np.random.default_rng(1234).normal(
            0, 5, (17, 2)).astype(np.float32), np.ones((17, 1), np.float32)],
            1), list(assets["coco"].joint_set.joints_name))[:, :2]
    bbox1 = coords.process_bbox(coords.get_bbox(joints), 1.0, scale=1.25)
    ow, oh = int(joints[:, 0].max() * 1.5), int(joints[:, 1].max() * 1.5)
    orig_cam = crop_cam_to_orig_img(
        run["res"]["cam"], torch.from_numpy(bbox1[None]).to(dev), ow,
        oh)[0].cpu().numpy()
    faces = assets["coco"].faces
    img = np.zeros((oh, ow, 3), np.uint8)
    t0 = time.perf_counter()
    drawn = render_mesh_overlay(img, run["res"]["mesh"], faces, orig_cam,
                                backend="software")
    render_s = time.perf_counter() - t0
    covered = int((drawn != 0).any(-1).sum())
    check(covered >= 1, "the software render covers a pixel")
    say(29, f"software render (numpy z-buffer) of the coco demo mesh, "
            f"{len(faces)} faces, {ow}x{oh} image: {render_s:.3f} s on the "
            f"host of {card}, {covered} pixels covered; demo wall times "
            f"without the renders "
            + ", ".join(f"{t} {r['wall']:.3f} s" for t, r in runs.items()))

    # (d) K3 at the demo's batch of one, against its plain version
    b, n, h, d = 1, 431, 2, 32
    errs = {}
    for dt in (f32, bf16):
        q, k, v = (torch.randn(b, n, h, d, generator=gen).to(dev, dt)
                   for _ in range(3))
        got = fused_attention(q, k, v, None, d ** -0.5)
        ref = fused_attention_ref(q, k, v, None, d ** -0.5)
        torch.cuda.synchronize()
        errs[dt] = max_err(got, ref)
        check(np.isfinite(errs[dt]), f"K3 B=1 {dt} finite")
    check(errs[f32] <= 1e-4, f"K3 B=1 f32 err {errs[f32]} <= 1e-4")
    q, k, v = (torch.randn(b, n, h, d, generator=gen).to(dev)
               for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    k3_ms = time_ms(lambda: fused_attention(q, k, v, None, d ** -0.5))
    plain_ms = time_ms(lambda: fused_attention_ref(q, k, v, None,
                                                   d ** -0.5))
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, scale=d ** -0.5))
    k3_bound = bound(3 * 2 * b * h * n * n * d, 4 * b * n * h * d * 4,
                     TF32_FLOP_PER_S)
    say(29, f"K3 B=1 {n}x{n} H={h} D={d} on {card}: f32 max abs err "
            f"{errs[f32]:.3e} vs plain (bar 1e-4), bf16 {errs[bf16]:.3e} "
            f"(reported); f32 kernel {k3_ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, scaled_dot_product_attention {sdpa_ms:.4f} ms (CUDA "
            f"events, median of 5); bound {k3_bound[0]:.5f} ms "
            f"({k3_bound[1]})")
    out["k3_b1"] = dict(ms=k3_ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                        bound_ms=k3_bound[0], err=errs[f32])

    # (e) the native library, built with the host's C++ compiler, against
    # the numpy forms: the joint graphs' tables and the full mesh's
    # coarsening
    t0 = time.perf_counter()
    lib = native.build()
    say(29, f"native library {os.path.relpath(lib, ROOT)} built in "
            f"{time.perf_counter() - t0:.2f} s")
    for name, jset in (("human36", skeletons.H36M), ("coco", skeletons.COCO)):
        adj = skeletons.gat_adjacency(jset)
        tj = assets[name].template_joints
        a = graphs.build_graph_tables(adj, tj, use_native=True)
        b_ = graphs.build_graph_tables(adj, tj, use_native=False)
        for field in b_.__dataclass_fields__:
            x, y = getattr(a, field), getattr(b_, field)
            check(x.dtype == y.dtype and np.array_equal(x, y),
                  f"{name} graph table {field}: native equals numpy")
    mesh_faces = assets["human36"].faces
    t_np = time.perf_counter()
    want = coarsening.build_coarse_graphs(
        mesh_faces, skeletons.gat_adjacency(skeletons.H36M),
        use_native=False)
    t_np = time.perf_counter() - t_np
    t_nat = time.perf_counter()
    got = coarsening.build_coarse_graphs(
        mesh_faces, skeletons.gat_adjacency(skeletons.H36M),
        use_native=True)
    t_nat = time.perf_counter() - t_nat
    for x, y in zip(got[0] + got[1], want[0] + want[1]):
        check(x.shape == y.shape and x.dtype == y.dtype
              and (sp.csr_matrix(x) != sp.csr_matrix(y)).nnz == 0,
              "coarse graphs and Laplacians: native equals numpy")
    check(all(np.array_equal(x, y) for x, y in zip(got[2:], want[2:])),
          "coarsening permutations: native equals numpy")
    say(29, f"native graph tables (human36, coco) equal to numpy; "
            f"build_coarse_graphs on the {mesh_faces.max() + 1}-vertex mesh "
            f"(9 levels, {[g.shape[0] for g in got[0]]} vertices) equal: "
            f"{t_nat:.3f} s native, {t_np:.3f} s numpy (host)")

    # (f) the device-side surface on the card against the CPU, TF32 off
    def both(fn, *args):
        """fn on the card and on the CPU -> max abs difference."""
        on_card = fn(*(a.to(dev) if torch.is_tensor(a) else a
                       for a in args))
        on_cpu = fn(*args)
        on_card = on_card if isinstance(on_card, tuple) else (on_card,)
        on_cpu = on_cpu if isinstance(on_cpu, tuple) else (on_cpu,)
        return max(max_err(x.cpu(), y) for x, y in zip(on_card, on_cpu))

    sampling = assets["human36"].sampling
    res_cpu = ops.MeshResampler(sampling)
    res_card = ops.MeshResampler(sampling).to(dev)
    xv = torch.randn(8, sampling.down1.shape[1], 3, generator=gen)
    xc = torch.randn(8, sampling.down2.shape[0], 3, generator=gen)
    surface = {
        "MeshResampler down": max_err(
            res_card.downsample(xv.to(dev), 0, 2).cpu(),
            res_cpu.downsample(xv, 0, 2)),
        "MeshResampler up": max_err(
            res_card.upsample(xc.to(dev), 2, 0).cpu(),
            res_cpu.upsample(xc, 2, 0)),
    }
    adj = ops.row_normalized_adjacency(skeletons.gat_adjacency(
        skeletons.COCO), 2)
    for cin, cout in ((64, 128), (128, 128)):
        block = ops.GraphResBlock(cin, cout, adj)
        xb = torch.randn(64, 19, cin, generator=gen)
        with torch.no_grad():
            surface[f"GraphResBlock {cin}->{cout}"] = max_err(
                block.to(dev)(xb.to(dev)).cpu(), block.cpu()(xb))
    hand = mano.synthetic_mano(0)
    params = {str(p): mano.ManoParams.from_model(hand, device=p)
              for p in ("cpu", dev)}
    pose = torch.randn(64, 48, generator=gen) * 0.5
    betas = torch.randn(64, 10, generator=gen)
    surface["mano_forward"] = max(
        max_err(a.cpu(), c) for a, c in zip(
            mano.mano_forward(params[str(dev)], pose.to(dev), betas.to(dev)),
            mano.mano_forward(params["cpu"], pose, betas)))
    surface["rot6d_to_rotmat"] = both(rotations6d.rot6d_to_rotmat,
                                      torch.randn(4096, 6, generator=gen))
    surface["one_euro_smooth_torch"] = both(
        one_euro_smooth_torch,
        torch.randn(64, 17, 3, generator=gen).cumsum(0))
    bad = {k: e for k, e in surface.items() if not e <= 1e-5}
    check(not bad, f"the surface on the card within 1e-5 of the CPU: {bad}")
    say(29, "on the card vs the CPU, f32, TF32 off (bar 1e-5): "
            + ", ".join(f"{k} {e:.2e}" for k, e in surface.items()))

    # (g) profiling: a trace around one demo forward, the cards' memory
    model, pose2d = runs["coco"]["kept"]["model"], runs["coco"]["kept"][
        "pose2d"]
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp), torch.no_grad():
            model(pose2d)
        trace_file = os.path.join(tmp, "trace.json")
        size = os.path.getsize(trace_file)
        with open(trace_file) as f:
            saw_k3 = "attention_kernel" in f.read()
    check(size > 0, "profiling.trace wrote a trace")
    stats = profiling.device_memory_stats()
    check(len(stats) == 1 and torch.cuda.get_device_name(0)
          in next(iter(stats)), f"device_memory_stats names the card: "
                                f"{list(stats)}")
    say(29, f"profiling.trace around one demo forward: {size} bytes, K3 "
            f"{'in' if saw_k3 else 'not in'} the trace; "
            f"device_memory_stats: {list(stats)}, peak allocated "
            f"{next(iter(stats.values()))['allocated_bytes.all.peak']} "
            f"bytes")
    say(29, f"phase 29 wall time {time.perf_counter() - t_phase:.1f} s on "
            f"{card}")
    return out


def planted_cases(world, cases):
    """`run_cases` for phase 30's negative control: a case with a "fault"
    runs with that fault planted in this process. "sample0": every rank
    keys its dropout masks from sample 0, as if the step gave K4 and K5 no
    sample base; "bn": the BatchNorm statistics over this rank's rows
    alone, as if they were not all-reduced."""
    from unittest import mock

    from gator_tpu_torch.parallel.checks import run_cases
    from gator_tpu_torch.train import fused_forward, loop

    stats = fused_forward.batch_stats
    faults = {
        "sample0": lambda: mock.patch.object(loop, "_sample0",
                                             lambda batch, world: 0),
        "bn": lambda: mock.patch.object(fused_forward, "batch_stats",
                                        lambda m32, world=None: stats(m32)),
    }
    out = []
    for case in cases:
        fault = case.get("fault")
        with (faults[fault]() if fault else contextlib.nullcontext()):
            out += run_cases(world, [case])
    return out


def parallel_phases(torch, card):
    """Phase 30 (w): data parallelism, one process per rank, at full width
    (human36, BatchNorm head with seeded running stats): (a) world 1 over
    NCCL on cuda:0 in this process, bit-equal to the one-device path; (b)
    world 2 over gloo with both ranks on cuda:0 against one process on the
    global batch, and K4's and K5's sample base; (c) NCCL across cards
    where the host has two or more. -> {"launches": part (a)'s}."""
    from gator_tpu_torch import losses
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.models import GatorSpec, build_gator
    from gator_tpu_torch.nn.gat_trunk_train import (extract_block_params,
                                                    gat_trunk_train,
                                                    gat_trunk_train_ref)
    from gator_tpu_torch.nn.lbf_stack_train import (extract_layer_params,
                                                    lbf_stack_train,
                                                    lbf_stack_train_ref)
    from gator_tpu_torch.parallel import (any_rank, close_world, join_world,
                                          pad_to_multiple, spawn)
    from gator_tpu_torch.parallel.checks import run_cases
    from gator_tpu_torch.serving import (make_serving_fn,
                                         make_sharded_serving_fn)
    from gator_tpu_torch.train import (Adam, TrainState,
                                       make_gator_eval_step,
                                       make_gator_train_step, run_eval)

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32
    assets = build_assets("human36", data_dirs=[], synthetic_vertex_num=6890,
                          seed=0)
    spec = GatorSpec.from_assets(assets)
    model = build_gator(spec, seed=21, device=dev)
    gen = torch.Generator().manual_seed(30)
    bn = model.pose2mesh.bias_norm
    bn.running_mean.copy_(torch.randn(bn.running_mean.shape,
                                      generator=gen).to(dev) * 0.5)
    bn.running_var.copy_(torch.rand(bn.running_var.shape,
                                    generator=gen).to(dev) * 1.5 + 0.5)
    sd = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    v = spec.mdr.full_num
    b = 512
    rng = np.random.default_rng(30)
    batch = {
        "pose2d": rng.normal(size=(b, 17, 2)),
        "mesh": rng.normal(size=(b, v, 3)) * 0.1,
        "lift_pose3d": rng.normal(size=(b, 17, 3)) * 100,
        "reg_pose3d": rng.normal(size=(b, 17, 3)) * 100,
        "mesh_valid": (rng.uniform(size=(b, 1, 1)) < 0.8),
        "lift_valid": np.ones((b, 17, 1)),
        "reg_valid": np.ones((b, 17, 1)),
    }
    batch = {k: a.astype(np.float32) for k, a in batch.items()}
    evals = [{"pose2d": rng.normal(size=(n, 17, 2)).astype(np.float32),
              "mesh": (rng.normal(size=(n, v, 3)) * 0.1).astype(np.float32),
              "reg_pose3d": (rng.normal(size=(n, 17, 3)) * 100).astype(
                  np.float32)} for n in (300, 77)]
    poses = rng.normal(size=(256, 17, 2)).astype(np.float32)

    # (a) world 1 over NCCL, in this process: the step at the training
    # shapes (B=512 bf16, default rates), run_eval and the serving call
    # bit-equal to the one-device path
    reset, read = launch_counters(torch)
    tb = {k: torch.from_numpy(a).to(dev) for k, a in batch.items()}
    tp = torch.from_numpy(poses).to(dev)
    estep = make_gator_eval_step(assets.j_regressor_h36m,
                                 assets.joint_set.eval_joints)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        world = join_world(0, 1, dev, "nccl", f"file://{tmp}/rendezvous",
                           timeout_s=120)
        try:
            for name, w in (("one device", None), ("world 1", world)):
                if w is not None:
                    reset()
                m = copy.deepcopy(model)
                st = TrainState(m, Adam(m.parameters(), lr=1e-4))
                step = make_gator_train_step(
                    spec, assets.faces, assets.j_regressor_h36m,
                    losses.LossWeights(), dtype=bf16, world=w)
                with torch.enable_grad():
                    met = step(st, tb, 7, 1.0)
                ev = run_eval(estep, model, evals,
                              collect_out=("pred_mesh_mm",),
                              collect_batch=("mesh",), world=w)
                fn = (make_serving_fn(model, bf16) if w is None
                      else make_sharded_serving_fn(model, w, bf16))
                runs[name] = {"loss": float(met["loss"]),
                              "grads": grads_of(m),
                              "state": {k: t.clone() for k, t in
                                        m.state_dict().items()},
                              "eval": ev, "serve": fn(tp),
                              "train": (step, st, w)}
                if w is not None:
                    launches = read()
            # after the checked runs and the launch count: the step as the
            # train CLI runs it (then the SIGTERM flag, `any_rank`, on the
            # host group) on the one-device path and on world 1 over NCCL,
            # alternating, on the host clock to a synchronize
            step_ms = {name: [] for name in runs}
            for i in range(11):
                for name, r in runs.items():
                    step, st, w = r["train"]
                    t0 = time.perf_counter()
                    with torch.enable_grad():
                        step(st, tb, 7, 1.0)
                    any_rank(False, w)
                    torch.cuda.synchronize()
                    if i:       # the first is a warm-up
                        step_ms[name].append(
                            (time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            for _ in range(50):
                any_rank(False, world)
            flag_ms = (time.perf_counter() - t0) * 1e3 / 50
        finally:
            close_world(world)
    one, w1 = runs["one device"], runs["world 1"]
    check(one["loss"] == w1["loss"], f"(a) loss {w1['loss']} == "
                                     f"{one['loss']}")
    check(all(torch.equal(one["grads"][n], g)
              for n, g in w1["grads"].items())
          and set(one["grads"]) == set(w1["grads"]),
          "(a) every gradient bit-equal")
    check(all(torch.equal(one["state"][k], t)
              for k, t in w1["state"].items()),
          "(a) every parameter and running stat after the step bit-equal")
    check(all(one["eval"][k] == w1["eval"][k] for k in
              ("count", "joint_err", "surface_err"))
          and all(np.array_equal(one["eval"][k], w1["eval"][k])
                  for k in ("pred_mesh_mm", "mesh")),
          "(a) run_eval bit-equal")
    check(all(torch.equal(x, y) for x, y in zip(one["serve"], w1["serve"])),
          "(a) serving bit-equal")
    check(all(n > 0 for n in launches.values()),
          f"(a) K1-K5 launched on the world-1 paths: {launches}")
    say(30, f"(a) world 1 over NCCL on cuda:0: the stage-2 step (B=512 "
            f"bf16, default rates; loss {w1['loss']:.6f}, "
            f"{len(w1['grads'])} gradients, {len(w1['state'])} state "
            f"tensors), run_eval ({w1['eval']['count']} samples) and the "
            f"serving call (B=256 bf16) bit-equal to the one-device path; "
            f"launches {launches}")
    one_ms, nccl_ms = (statistics.median(step_ms[k])
                       for k in ("one device", "world 1"))
    say(30, f"(a) step + SIGTERM flag, host ms (median of 10, alternating, "
            f"to a synchronize) on {card}: one device {one_ms:.2f} "
            f"({b / one_ms * 1e3:,.0f} poses/s), world 1 over NCCL "
            f"{nccl_ms:.2f} ({b / nccl_ms * 1e3:,.0f} poses/s); the flag "
            f"alone {flag_ms:.3f} ms; all: " + "; ".join(
                f"{k} " + ", ".join(f"{t:.2f}" for t in v)
                for k, v in step_ms.items()))

    # K4's and K5's sample base: masks exported at sample0 = 64 are rows
    # [64, 128) of a 128 batch's, bit for bit, beside the plain versions
    gat, mdr = model.pose_lifter, model.pose2mesh
    half = 64
    gbias = gat.get_hop_path_encoding().float()
    bp = [extract_block_params(blk) for blk in gat.blocks]
    lp = [extract_layer_params(mdr, i) for i in range(3)]
    x5 = torch.randn(2 * half, 17, spec.gat.embed_dim,
                     generator=gen).to(dev).to(bf16)
    x4 = torch.randn(2 * half, spec.mdr.coarse_num, 64,
                     generator=gen).to(dev).to(bf16)
    j4 = torch.randn(2 * half, 17, 64, generator=gen).to(dev).to(bf16)
    def same_mask(a, b):
        """Bit-equal masks, None (rate 0, no draw) being all ones."""
        if a is None or b is None:
            other = b if a is None else a
            return other is None or bool((other == 1).all())
        return bool(a.shape == b.shape and (a == b).all())

    def k5(fn, rows, **kw):
        return fn(x5[rows], gbias, bp, gat.spec.masks_xfeat,
                  spec.gat.num_heads, 99, **kw)

    def k4(fn, rows, **kw):
        return fn(x4[rows], j4[rows], lp, 2, 99, **kw)

    base = {}
    for name, fn, ref, call in (
            ("K5", gat_trunk_train, gat_trunk_train_ref, k5),
            ("K4", lbf_stack_train, lbf_stack_train_ref, k4)):
        whole, part, plain = [], [], []
        y_whole = call(fn, slice(None), export=whole)
        y_part = call(fn, slice(half, None), export=part, sample0=half)
        call(ref, slice(half, None), export=plain, sample0=half)
        torch.cuda.synchronize()
        n_masks = 0
        for wu, pu, qu in zip(whole, part, plain):
            for k, got in pu.items():
                rows = None if wu[k] is None else wu[k][half:]
                check(same_mask(got, rows),
                      f"{name} sample base: mask {k} equals rows "
                      f"[{half}, {2 * half}) of the {2 * half} batch")
                check(same_mask(got, qu[k]),
                      f"{name} sample base: mask {k} equals the plain "
                      "version's")
                n_masks += 1
        base[name] = (n_masks, max_err(y_part, y_whole[half:]))
    say(30, "(b) sample base, sample0 = 64 of a 128 batch, bf16, default "
            "rates: " + "; ".join(
                f"{n}: {c} exported masks equal rows [64, 128) of the "
                f"128 batch's and the plain version's, bit for bit; "
                f"outputs {e:.1e} apart" for n, (c, e) in base.items()))

    # (b) world 2 over gloo, both ranks on cuda:0, against one process on
    # the global batch; (c) one rank per card over NCCL. The step in bf16
    # (the training shapes) and in f32. In bf16 the parameters outside K4
    # and K5 get their gradient from a bf16 product in plain torch, which
    # each rank rounds to bf16 before the all-reduce (as each device's
    # partial in the JAX package's GSPMD step): one bf16 ulp, 2^-7 of the
    # largest element; K4's and K5's parameter gradients are f32.
    step_case = {"kind": "step", "assets": assets, "spec": {},
                 "state_dict": sd, "batch": batch, "seed": 7, "lr": 1e-4}
    cases = [dict(step_case, dtype="bfloat16", time_steps=5),
             dict(step_case, dtype="float32"),
             {"kind": "eval", "assets": assets, "spec": {},
              "state_dict": sd, "batches": evals,
              "collect_out": ("pred_mesh_mm",), "collect_batch": ("mesh",)},
             {"kind": "serve", "assets": assets, "spec": {},
              "state_dict": sd, "poses": poses, "dtype": "float32"}]
    want = run_cases(None, [dict(c, device="cuda:0") for c in cases])
    w_ms = statistics.median(want[0]["step_ms"])
    ms = {"(a) one device": one_ms, "(a) world 1 nccl": nccl_ms,
          "(b) one process": w_ms}
    kernel_params = ("pose_lifter.blocks.", "pose2mesh.encoder",
                     "pose2mesh.norm", "pose2mesh.selfatt")

    def grads(st, kernel):
        return {n: torch.from_numpy(g) for n, g in st["grads"].items()
                if n.startswith(kernel_params) == kernel}

    def bars(dt):
        return {"loss rel": 1e-4, "K4/K5 parameter gradients": 1e-3,
                "the others": 1e-3 if dt == "f32" else 2**-7,
                "running stats": 1e-4}

    def readings(tag, st, ref):
        """Each bar's reading, the worst gradients' names and the key
        biases' abs value; the gradients scaled by their largest element,
        the running stats by the largest stat."""
        rel = abs(st["metrics"]["loss"] - ref["metrics"]["loss"]) \
            / abs(ref["metrics"]["loss"])
        worst = {kernel: compare_grads(tag, grads(st, kernel),
                                       grads(ref, kernel), None, zero_bias)
                 for kernel in (True, False)}
        e_bn = max(scaled_err(torch.from_numpy(st["buffers"][k]),
                              torch.from_numpy(ref["buffers"][k]))
                   for k in ("pose2mesh.bias_norm.running_mean",
                             "pose2mesh.bias_norm.running_var"))
        return ({"loss rel": rel,
                 "K4/K5 parameter gradients": worst[True][0],
                 "the others": worst[False][0], "running stats": e_bn},
                {"K4/K5 parameter gradients": worst[True][2],
                 "the others": worst[False][2]}, worst[True][1])

    def against(got, bar):
        return ", ".join(f"{k} {v:.1e} (bar {bar[k]:.1e})"
                         for k, v in got.items())

    def per_rank(n):
        """The one-device path on the rows each of n ranks takes: the eval
        batches padded as `run_eval` pads them and cut into n (the collected
        rows without the pad), and the served poses cut into n."""
        chunks, keep, at = [], [], 0
        for e in evals:
            padded, real = pad_to_multiple(e, n)
            size = len(padded["pose2d"]) // n
            chunks += [{k: a[i * size:(i + 1) * size]
                        for k, a in padded.items()} for i in range(n)]
            keep.append(at + np.arange(real))
            at += n * size
        ev = run_eval(estep, model, chunks, collect_out=("pred_mesh_mm",))
        serve = make_serving_fn(model, f32)
        mesh = torch.cat([serve(p)[0] for p in tp.split(len(tp) // n)])
        return (ev["pred_mesh_mm"][np.concatenate(keep)],
                mesh.float().cpu().numpy())

    def hold(tag, ranks):
        """Every rank's step, eval and serving against one process's; the
        eval rows and served meshes also bit for bit against the one-device
        path on each rank's rows (f32 rounding moves with the batch's
        partition, so the whole batch's are a reading)."""
        rows, meshes = per_rank(len(ranks))
        for r, (s16, s32, ev, sv) in enumerate(ranks):
            msg, checks = [], []
            for st, ref, dt in ((s16, want[0], "bf16"),
                                (s32, want[1], "f32")):
                got, names, key_bias = readings(f"{tag} rank {r} {dt}",
                                                st, ref)
                bar = bars(dt)
                checks += [(v <= bar[k], f"{dt}: {k} {v} <= {bar[k]} "
                                         f"({names.get(k, '')})")
                           for k, v in got.items()]
                checks.append((all(n > 0 for n in st["launches"].values()),
                               f"K4/K5 launched {st['launches']}"))
                msg.append(f"{dt}: {against(got, bar)}; worst "
                           f"{names}; key biases {key_bias:.1e} abs; "
                           f"launches {st['launches']}")
            e_ev = max(abs(ev[k] - want[2][k]) / abs(want[2][k])
                       for k in ("joint_err", "surface_err"))
            e_rows = float(np.abs(ev["pred_mesh_mm"]
                                  - want[2]["pred_mesh_mm"]).max())
            e_sv = float(np.abs(sv["mesh"] - want[3]["mesh"]).max())
            same_rows = np.array_equal(ev["pred_mesh_mm"], rows)
            same_mesh = np.array_equal(sv["mesh"], meshes)
            say(30, f"{tag} rank {r}: stage-2 step B=512 global, default "
                    f"rates, " + "; ".join(msg) + f"; eval of "
                    f"{ev['count']} samples means rel {e_ev:.1e} (bar "
                    f"1e-6), rows bit-equal to the one-device path on each "
                    f"rank's rows {same_rows}, {e_rows:.1e} mm from the "
                    f"whole batch's; serving f32 B=256 bit-equal on each "
                    f"rank's rows {same_mesh}, {e_sv:.1e} m from the whole "
                    f"batch's (bar 1e-6)")
            checks += [
                (ev["count"] == want[2]["count"] == 377,
                 f"eval count {ev['count']}"),
                (e_ev <= 1e-6, f"eval means rel {e_ev} <= 1e-6"),
                (same_rows and np.array_equal(ev["mesh"], want[2]["mesh"]),
                 "collected rows in order"),
                (same_mesh, "served meshes equal the one-device path's on "
                            "each rank's rows"),
                (e_sv <= 1e-6, f"serving {e_sv} <= 1e-6 m")]
            for ok, what in checks:
                check(ok, f"{tag} rank {r}: {what}")
        return statistics.median(ranks[0][0]["step_ms"])

    # and a negative control: the bf16 step with a planted fault, which one
    # of the bars above must catch
    planted = [dict(step_case, dtype="bfloat16", fault=f)
               for f in ("sample0", "bn")]
    t0 = time.perf_counter()
    ranks = spawn(planted_cases, 2, backend="gloo", devices="cuda:0",
                  args=(cases + planted,), timeout=300)
    ms["world 2 gloo, one card"] = hold("(b) world 2 over gloo on cuda:0",
                                        [r[:4] for r in ranks])
    for r, rank in enumerate(ranks):
        for case, st in zip(planted, rank[4:]):
            got, _, _ = readings(f"(b) planted {case['fault']}", st, want[0])
            bar = bars("bf16")
            caught = [k for k, v in got.items() if v > bar[k]]
            check(caught, f"(b) rank {r}: the planted fault "
                          f"{case['fault']} passes every bar: {got}")
            say(30, f"(b) rank {r}, planted fault {case['fault']} (bf16): "
                    f"{against(got, bar)}; caught by {caught}")
    say(30, f"(b) world 2 over gloo on cuda:0 in "
            f"{time.perf_counter() - t0:.1f} s; step host ms (median of 5, "
            f"to a synchronize) on {card}: one process, one device "
            f"{w_ms:.2f} "
            f"({b / w_ms * 1e3:,.0f} poses/s), world 2 on one card "
            f"{ms['world 2 gloo, one card']:.2f}")
    cards = torch.cuda.device_count()
    if cards >= 2:
        n = max(k for k in (2, 4, 8) if k <= cards)
        # and a global batch of 512 a rank (the four-card cell's 2048),
        # timed only
        rows = np.arange(n * b) % b
        big = dict(step_case, dtype="bfloat16", time_steps=5,
                   batch={k: a[rows] for k, a in batch.items()})
        t0 = time.perf_counter()
        ranks = spawn(run_cases, n, backend="nccl",
                      devices=[f"cuda:{r}" for r in range(n)],
                      args=(cases + [big],), timeout=300)
        ms[f"world {n} nccl"] = hold(f"(c) world {n} over NCCL",
                                     [r[:4] for r in ranks])
        ms[f"world {n} nccl, B={n * b}"] = big_ms = statistics.median(
            ranks[0][4]["step_ms"])
        say(30, f"(c) world {n} over NCCL, one rank per card, in "
                f"{time.perf_counter() - t0:.1f} s: step at B={b} "
                f"{ms[f'world {n} nccl']:.2f} ms host "
                f"({b / ms[f'world {n} nccl'] * 1e3:,.0f} poses/s on {n} "
                f"cards), at B={n * b} ({b} a card) {big_ms:.2f} ms "
                f"({n * b / big_ms * 1e3:,.0f} poses/s on {n} cards), "
                f"against one process's {w_ms:.2f} ms at B={b} on one "
                f"({card})")
    else:
        say(30, f"(c) not run: NCCL across cards needs 2 or more, this host "
                f"has {cards}")
    say(30, f"phase wall time {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "ms": ms}


NOISE_GATE_N = 30000


def _gate_main(argv):
    """The noise gate's process: a process group of its own (its workers
    join it), then `check_noise_distribution.main(argv)`."""
    os.setpgid(0, 0)
    sys.path.insert(0, ROOT)
    from gator_tpu_torch.tools import check_noise_distribution as cnd
    cnd.main(argv)


def start_noise_gate(out):
    """Phase 31's noise gate at n = NOISE_GATE_N (its host forms take
    minutes on the host's cores): `check_noise_distribution.main` in a
    process of its own, started after the build so that it overlaps the
    card's phases. -> the process (31 joins it; main stops its group on
    any failure)."""
    import multiprocessing
    proc = multiprocessing.get_context("spawn").Process(
        target=_gate_main, args=(["--n", str(NOISE_GATE_N), "--out", out],))
    proc.start()
    return proc


def width_tool_phases(torch, dev, card, randn, gate, gate_json):
    """Phase 31 (x): (a) K1 and K5 at embed width 64 against their plain
    versions, and their main paths at that width; (b) the five tools
    through their `main(argv)` at a reduced size. -> {"launches": K1's
    and K5's counts from (a)'s main-path runs}."""
    from gator_tpu_torch import losses
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.models import GatorSpec, build_gator
    from gator_tpu_torch.nn import fold_trunk_weights, gat_trunk, \
        gat_trunk_ref
    from gator_tpu_torch.nn.gat_trunk import kernel_info as k1_info
    from gator_tpu_torch.nn.gat_trunk_train import (extract_block_params,
                                                    gat_trunk_train,
                                                    gat_trunk_train_ref)
    from gator_tpu_torch.nn.gat_trunk_train import kernel_info as k5_info
    from gator_tpu_torch.nn.lbf_stack_train import ZERO_RATES
    from gator_tpu_torch.serving import make_serving_fn
    from gator_tpu_torch.tools import (check_noise_distribution,
                                       exp_noise_ablate, exp_train_ablate,
                                       profile_gt_synth, profile_train)
    from gator_tpu_torch.tools.timing import time_ms
    from gator_tpu_torch.train import (Adam, TrainState,
                                       make_gator_train_step)

    t_phase = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    reset, read = launch_counters(torch)
    out = {"launches": {"gat_trunk": 0, "gat_trunk_train": 0}}
    assets = build_assets("human36", data_dirs=[], synthetic_vertex_num=6890,
                          seed=0)
    zero = dict(drop_rate=0.0, attn_drop_rate=0.0, drop_path_rate=0.0)
    model = build_gator(GatorSpec.from_assets(assets, embed_dim=64),
                        seed=21, device=dev)
    gat = model.pose_lifter
    check((gat.spec.embed_dim, gat.spec.num_heads, len(gat.blocks))
          == (64, 8, 6), "the width-64 model: embed 64, 8 heads, 6 blocks")
    j, c = gat.spec.num_joint, 64
    bias = gat.get_hop_path_encoding().float()
    masks = gat.blocks[0].x_feat.masks
    errs = {}

    # (a) K1 at its tile edges, then the serving call (the main path)
    ws = {dt: fold_trunk_weights(gat.blocks, dt, dev) for dt in (f32, bf16)}
    for nb in (1, 1001, 2048):
        x = randn(nb, j, c)
        for dt in (f32, bf16):
            got = gat_trunk(x.to(dt), bias, masks, ws[dt], 8)
            again = gat_trunk(x.to(dt), bias, masks, ws[dt], 8)
            ref = gat_trunk_ref(x.to(dt), bias, masks, ws[dt], 8)
            err = max_err(got, ref)
            check(np.isfinite(err) and torch.equal(got, again),
                  f"K1 C=64 {dt} B={nb} finite and repeatable")
            if dt == f32:
                check(err <= 1e-4, f"K1 C=64 f32 B={nb} err {err} <= 1e-4")
            errs[f"K1 {str(dt)[6:]} B={nb}"] = err
    pose = randn(256, j, 2)
    ref_mesh, _ = make_serving_fn(model, f32, use_kernels=False)(pose)
    serve32, serve16 = make_serving_fn(model, f32), make_serving_fn(model,
                                                                   bf16)
    reset()
    mesh32, _ = serve32(pose)
    mesh16, _ = serve16(pose)
    counts = read()
    e32, e16 = max_err(mesh32, ref_mesh), max_err(mesh16, ref_mesh)
    check(e32 <= 1e-4, f"C=64 serving f32 mesh err {e32} <= 1e-4 m")
    check(np.isfinite(e16) and e16 <= 5e-2,
          f"C=64 serving bf16 mesh err {e16} <= 5e-2 m")
    check(counts["gat_trunk"] == 2, f"K1 launched by the C=64 serving "
                                    f"calls: {counts}")
    out["launches"]["gat_trunk"] += counts["gat_trunk"]

    # (a) K5 against its plain version with the exported masks, then a
    # kernel step against a plain step, then the main path's steps
    def run_k5(x0, cot, kernel):
        x = x0.clone().requires_grad_(True)
        b_ = gat.get_hop_path_encoding().detach().float().requires_grad_(
            True)
        gat.zero_grad(set_to_none=True)
        export = []
        fn = gat_trunk_train if kernel else gat_trunk_train_ref
        with torch.enable_grad():
            y = fn(x, b_, [extract_block_params(blk) for blk in gat.blocks],
                   gat.spec.masks_xfeat, 8, 77, export=export)
            y.backward(cot)
        torch.cuda.synchronize()
        return {"out": y.detach(), "dx": x.grad, "dbias": b_.grad,
                "grads": grads_of(gat.blocks), "masks": export}

    for dt in (f32, bf16):
        x0, cot = randn(512, j, c).to(dt), randn(512, j, c).to(dt)
        k = run_k5(x0, cot, True)
        p = run_k5(x0, cot, False)
        for km, pm in zip(k["masks"], p["masks"]):
            for name in km:
                check(masks_equal(km[name], pm[name])[0],
                      f"K5 C=64 mask {name} equals the hash")
        bar = 1e-4 if dt == f32 else None
        for name in ("out", "dx", "dbias"):
            e = scaled_err(k[name], p[name])
            check(np.isfinite(e) and (bar is None or e <= bar),
                  f"K5 C=64 {dt} {name} scaled err {e}")
            errs[f"K5 {str(dt)[6:]} {name}"] = e
        worst, _, which = compare_grads("K5 C=64", k["grads"], p["grads"],
                                        bar, zero_bias)
        errs[f"K5 {str(dt)[6:]} grads ({which})"] = worst
        del k, p

    def stage2(m, dt, use_kernels=True, **kw):
        st = TrainState(m, Adam(m.parameters(), lr=1e-4))
        step = make_gator_train_step(
            m.spec, assets.faces, assets.j_regressor_h36m,
            losses.LossWeights(), dtype=dt, use_kernels=use_kernels, **kw)
        return st, step

    rng = np.random.default_rng(31)
    v = model.spec.mdr.full_num

    def batch_of(b):
        arrays = {"pose2d": rng.normal(size=(b, j, 2)),
                  "mesh": rng.normal(size=(b, v, 3)) * 0.1,
                  "lift_pose3d": rng.normal(size=(b, j, 3)) * 100,
                  "reg_pose3d": rng.normal(size=(b, 17, 3)) * 100,
                  "mesh_valid": np.ones((b, v, 1)),
                  "lift_valid": np.ones((b, j, 1)),
                  "reg_valid": np.ones((b, 17, 1))}
        return {k_: torch.from_numpy(a.astype(np.float32)).to(dev)
                for k_, a in arrays.items()}

    mk = build_gator(GatorSpec.from_assets(assets, embed_dim=64, **zero),
                     seed=22, device=dev)
    mp = copy.deepcopy(mk)
    small = batch_of(16)
    loss = {}
    with torch.enable_grad():
        for name, m, use in (("kernel", mk, True), ("plain", mp, False)):
            st, step = stage2(m, f32, use, rates=ZERO_RATES,
                              gat_mlp_rate=0.0)
            loss[name] = float(step(st, small, 0, 1.0)["loss"])
    rel = abs(loss["kernel"] - loss["plain"]) / abs(loss["plain"])
    check(rel <= 1e-5, f"C=64 step loss rel {rel} <= 1e-5")
    worst, _, _ = compare_grads("C=64 step", grads_of(mk), grads_of(mp),
                                1e-4, zero_bias)
    errs["step f32 loss rel"] = rel
    errs["step f32 grads"] = worst
    del mk, mp
    st, step = stage2(model, bf16)
    big = batch_of(512)
    reset()
    with torch.enable_grad():
        curve = [float(step(st, big, 7, 1.0)["loss"]) for _ in range(3)]
    counts = read()
    check(all(np.isfinite(curve)), f"C=64 stage-2 losses finite: {curve}")
    check(counts["gat_trunk_train"] > 0 and counts["lbf_stack_train"] > 0,
          f"K5 and K4 launched by the C=64 steps: {counts}")
    out["launches"]["gat_trunk_train"] += counts["gat_trunk_train"]

    # (a) times at the main paths' batches, bf16, beside the bounds
    x = randn(2048, j, c).to(bf16)
    wts = sum(p_.numel() for p_ in gat.blocks[0].parameters())
    t1 = [time_ms(lambda: gat_trunk(x, bias, masks, ws[bf16], 8)),
          time_ms(lambda: gat_trunk_ref(x, bias, masks, ws[bf16], 8))]
    b1 = bound(2048 * 6 * fma_gat_block(j, c, 4 * c, c // 8),
               2 * 2048 * j * c * 2 + 6 * wts * 2)
    x5, g5 = randn(512, j, c).to(bf16), randn(512, j, c).to(bf16)
    bps = [{k_: t_.detach() for k_, t_ in extract_block_params(blk).items()}
           for blk in gat.blocks]
    bias5 = gat.get_hop_path_encoding().detach().float()

    def k5_step(fn):
        def run():
            xx = x5.detach().requires_grad_(True)
            with torch.enable_grad():
                fn(xx, bias5, bps, gat.spec.masks_xfeat, 8, 9).backward(g5)
        return run

    t5 = [time_ms(k5_step(gat_trunk_train)),
          time_ms(k5_step(gat_trunk_train_ref))]
    # device ms of K1's launch and of K5's five kinds of launch
    from gator_tpu_torch.tools.profile_train import _device_us, _is_kernel
    dev_ms = dict.fromkeys(("gat_trunk_kernel", "gat_block_fwd",
                            "gat_block_bwd", "gat_block_wgrad",
                            "reduce_partials"), 0.0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(3):
            gat_trunk(x, bias, masks, ws[bf16], 8)
            k5_step(gat_trunk_train)()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        for key in dev_ms:
            if _is_kernel(evt) and key in evt.key:
                dev_ms[key] += _device_us(evt) / 1e3 / 3
    check(all(v_ > 0 for v_ in dev_ms.values()),
          f"the profiler saw K1's and K5's launches at C=64: {dev_ms}")
    k5_dev = sum(v_ for k_, v_ in dev_ms.items() if k_ != "gat_trunk_kernel")
    b5 = bound(3 * 512 * 6 * dense_gat_block(j, c, 4 * c, c // 8),
               4 * 512 * j * c * 2 + 6 * wts * (2 + 4))
    info1, info5 = k1_info(bf16, c), k5_info(bf16, c)
    print(f"C=64 (8 heads, head width 8): errors "
          + ", ".join(f"{k_} {e:.3e}" for k_, e in errs.items())
          + f" (f32 bars 1e-4, bf16 reported); serving mesh f32 {e32:.3e} m"
          f", bf16 {e16:.4f} m; K1 B=2048 bf16 {t1[0]:.3f} ms (device "
          f"{dev_ms['gat_trunk_kernel']:.3f}; plain {t1[1]:.3f}; bound "
          f"{b1[0]:.4f} {b1[1]}; registers {info1['registers']}, shared "
          f"bytes {info1['smem_bytes']}); K5 forward and backward (six "
          f"blocks) B=512 bf16 {t5[0]:.3f} ms (device {k5_dev:.3f}: "
          + ", ".join(f"{k_} {v_:.3f}" for k_, v_ in dev_ms.items()
                      if k_ != "gat_trunk_kernel")
          + f"; plain {t5[1]:.3f}; bound {b5[0]:.4f} {b5[1]}; registers "
          + "/".join(str(v_["registers"]) for v_ in info5.values())
          + f"); on {card}", flush=True)
    say(31, f"(a) K1 and K5 at embed 64: K1 serving call and K5 stage-2 "
            f"steps (losses {', '.join(f'{l_:.4f}' for l_ in curve)}) "
            f"launched {out['launches']}")

    # (b) the five tools at a reduced size
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name + ".json")

        noise = exp_noise_ablate.main(["--batches", "512", "--out",
                                       path("noise_ablation")])
        check(all(t_ > 0 for t_ in noise["times_ms"].values())
              and len(noise["times_ms"]) == 6,
              f"noise ablation times: {noise['times_ms']}")
        # the argmax pick draws the shipped law: held to the tool's bar;
        # the bf16 variants' diffs are the lever's finding (the JAX tool
        # calls them suspect), printed
        diffs = noise["dist_max_band_diff"]
        check(set(diffs) == {"bf16", "gumbel_pick", "bf16_gumbel"}
              and all(np.isfinite(d) for d in diffs.values())
              and diffs["gumbel_pick"] < 0.02,
              f"noise ablation band diffs (gumbel_pick < 0.02): {diffs}")
        check(noise["not_ported"], "noise ablation lists not_ported")
        train = exp_train_ablate.main(["--batches", "64", "128", "--batch",
                                       "128", "--reps", "2", "--out",
                                       path("train_ablation")])
        check(len(train["variants"]) == 7 and all(
            r["host_ms"] > 0 and r["device_ms"] > 0 and np.isfinite(
                r["loss"]) for r in train["variants"].values()),
              f"train ablation variants: {list(train['variants'])}")
        check(train["not_ported"] and "sweep" in train and "derived" in
              train, "train ablation: not_ported, sweep, derived")
        split = profile_train.main(["--split", "main", "losses", "gat",
                                    "--batch", "128", "--out",
                                    path("split")])
        check(len(split["parts"]) == 7 and all(
            p_["device_ms"] > 0 for p_ in split["parts"].values()),
              f"split parts: {list(split['parts'])}")
        gts = profile_gt_synth.main(["--batch", "128", "--out",
                                     path("gt_synth")])
        check(len(gts["steps"]) == 3 and len(gts["parts"]) == 4 and all(
            p_["device_ms"] > 0 for g_ in ("steps", "parts")
            for p_ in gts[g_].values()), "GT-synthesis steps and parts")
        for name in ("noise_ablation", "train_ablation", "split",
                     "gt_synth"):
            with open(path(name)) as f:
                check(json.load(f), f"{name} JSON written")
    gate.join(timeout=900)
    check(gate.exitcode == 0, f"the noise gate at n={NOISE_GATE_N} "
                              f"passed (exit code {gate.exitcode})")
    with open(gate_json) as f:
        nd = json.load(f)
    check(nd["passed"] and nd["n_total"] >= 30000,
          f"noise gate JSON: passed {nd['passed']}, n {nd['n_total']}")
    worst = {k_: (r["state_freq_max_abs_diff_device"],
                  r["radius_ks_distance_device"])
             for k_, r in nd["areas"].items()}
    say(31, f"(b) the tools at a reduced size: noise gate n={nd['n_total']}"
            f" passed (KS bound {nd['ks_bound']}; device form freq/KS "
            f"{worst}); noise ablation B=512 {len(noise['times_ms'])} "
            f"timings, band diffs {noise['dist_max_band_diff']}; train "
            f"ablation {len(train['variants'])} variants, host ms against "
            f"B {train['sweep']['host_fit']}; split "
            f"{len(split['parts'])} parts; GT synthesis "
            f"{len(gts['steps'])} steps and {len(gts['parts'])} parts; "
            f"not ported "
            f"{list(noise['not_ported']) + list(train['not_ported'])}")
    say(31, f"phase wall time {time.perf_counter() - t_phase:.1f} s "
            f"(the noise gate overlapped the earlier phases)")
    return out


def motionbert_phases(torch, dev, card, randn):
    """Phase 32 (y): MotionBERT's serving call (models/motionbert.py), 128
    clips of 16 frames of 17 H36M joints, 8 heads of 64, bf16: (a) K3's two
    modes against its plain version on views of one qkv product, the
    spatial one [2048 frames, 17, 8, 64], the temporal one [128 clips, 17
    joints, 16, 8, 64] written through a permuted view, each mode's ms a
    launch beside its bound; (b) the serving call on K3 against the same call
    on plain attention, with a planted fault in the temporal launch's
    addressing that the bar has to see, and its launches from the counter
    zeroed just before it; (c) its times. -> {"errs", "launches"}."""
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.models import build_motionbert_mesh, motionbert
    from gator_tpu_torch.nn.fused_attention import (fused_attention_into,
                                                    fused_attention_ref)
    from gator_tpu_torch.serving import make_serving_fn
    from gator_tpu_torch.tools.timing import time_ms

    f32, bf16 = torch.float32, torch.bfloat16
    n, t, j, h, d = 128, 16, 17, 8, 64
    scale = d ** -0.5

    # 32 (a): each mode reads the qkv product's views in place
    def modes(dt):
        q, k, v = randn(n, t, j, 3, h, d).to(dt).unbind(3)
        spatial = [z.view(n * t, j, h, d) for z in (q, k, v)]
        temporal = [z.permute(0, 2, 1, 3, 4) for z in (q, k, v)]
        buf = torch.empty(n, t, j, h, d, dtype=dt, device=dev)
        return spatial, temporal, buf, buf.permute(0, 2, 1, 3, 4)

    err_f32 = 0.0
    for dt, bar in ((f32, 1e-4), (bf16, 5e-2)):
        spatial, temporal, buf, buf_t = modes(dt)
        got = {"spatial": fused_attention_into(*spatial, scale)}
        fused_attention_into(*temporal, scale, buf_t)
        got["temporal"] = buf_t
        torch.cuda.synchronize()
        want = {"spatial": fused_attention_ref(*spatial, None, scale),
                "temporal": fused_attention_ref(
                    *(z.reshape(n * j, t, h, d) for z in temporal), None,
                    scale).view(n, j, t, h, d)}
        for mode in got:
            err = max_err(got[mode], want[mode])
            check(np.isfinite(err) and err <= bar,
                  f"K3 MotionBERT {mode} {dt} err {err} <= {bar}")
            if dt == f32:
                err_f32 = max(err_f32, err)
            say(32, f"K3 MotionBERT {mode} {str(dt)[6:]}: max abs err "
                    f"{err:.3e} vs plain (bar {bar:g})"
                    + ("" if dt == f32 else
                       f"; {bf16_ulps(got[mode], want[mode])}"))
        del spatial, temporal, buf, buf_t, got, want

    # each mode's time a launch on CUDA events (the launches queue, so the
    # device's time), beside the bound: q, k, v read and out written once,
    # at 3.35 TB/s. (Here, after phase 31, torch.profiler records none of
    # these launches; the benchmark's traced run names each mode's kernel)
    spatial, temporal, _, buf_t = modes(bf16)
    k3_bound = bound(n * t * h * 2 * j * j * d, 4 * n * t * j * h * d * 2)
    k3_ms = {"spatial": time_ms(
                 lambda: fused_attention_into(*spatial, scale)),
             "temporal": time_ms(
                 lambda: fused_attention_into(*temporal, scale, buf_t))}
    say(32, f"K3 MotionBERT launches bf16 on {card}: " + "; ".join(
        f"{mode} {ms_:.4f} ms" for mode, ms_ in k3_ms.items())
        + " a launch (CUDA events)"
        + f" (bound {k3_bound[0]:.4f} ms each, {k3_bound[1]}: "
        f"{4 * n * t * j * h * d * 2 / 1e6:.1f} MB at 3.35 TB/s)")
    del spatial, temporal, buf_t

    # 32 (b): the served clips on K3 against the same call on plain
    # attention. MotionBERT's head starts at xavier gain 0.01, where the
    # mesh hardly depends on the input: gain 1 and a drawn stream gate
    # make a fault in an attention move the mesh
    assets = build_assets("human36", data_dirs=[],
                          synthetic_vertex_num=6890, seed=0)
    model = build_motionbert_mesh(assets, seed=1, device=dev)
    model.head.head_pose.weight.mul_(100.0)
    model.head.head_shape.weight.mul_(100.0)
    for lin in model.backbone.ts_attn:
        lin.weight.copy_(randn(*lin.weight.shape) * 0.02)
    gen = torch.Generator().manual_seed(32)
    u = torch.rand(n, t, j, 3, generator=gen)
    clips = torch.cat([u[..., :2] * 2 - 1, u[..., 2:]], -1).to(dev)
    serve_k = make_serving_fn(model, bf16)
    serve_p = make_serving_fn(model, bf16, use_kernels=False)
    reset_counts, read_counts = launch_counters(torch)
    reset_counts()
    verts, kp3d = serve_k(clips)
    counts = read_counts()
    check(counts["fused_attention"] == 20 and all(
        c == 0 for name, c in counts.items() if name != "fused_attention"),
        f"20 K3 launches and no other kernel in a MotionBERT call: {counts}")
    check(verts.shape == (n, t, 6890, 3) and kp3d.shape == (n, t, j, 3)
          and verts.dtype == f32, f"served {verts.shape} {kp3d.shape}")
    got = {bf16: (verts, kp3d), f32: make_serving_fn(model, f32)(clips)}
    ref = {bf16: serve_p(clips),
           f32: make_serving_fn(model, f32, use_kernels=False)(clips)}

    def rms(z):
        return float(z.double().pow(2).mean().sqrt())

    # gaps as a share of what the clips decide: the f32 plain call's RMS
    # distance from its mean over the clips. In bf16 a probability that
    # rounds the other way (1 ulp in ~1e-4 of K3's outputs) moves the
    # tokens by bf16 roundings, ~0.5 % of the 6D rotations, which is
    # several % of their part that the clips decide; f32 holds the call
    # to K3's own error
    ref_v, ref_k = ref[f32]
    spread_v = rms(ref_v - ref_v.mean(0, keepdim=True))
    spread_k = rms(ref_k - ref_k.mean(0, keepdim=True))
    check(spread_v > 1e-3, f"the clips move the mesh: {spread_v} m")

    def gaps(dt, v_, k_):
        rv, rk = ref[dt]
        return {"mesh_rel_rms": rms(v_ - rv) / spread_v,
                "mesh_clip_rel_rms_max": float(
                    (v_ - rv).double().pow(2).mean((1, 2, 3)).sqrt()
                    .max()) / spread_v,
                "kp3d_rel_rms": rms(k_ - rk) / spread_k}

    bars = {f32: {"mesh_rel_rms": 1e-3, "mesh_clip_rel_rms_max": 2e-3,
                  "kp3d_rel_rms": 1e-3},
            bf16: {"mesh_rel_rms": 0.2, "mesh_clip_rel_rms_max": 0.3,
                   "kp3d_rel_rms": 0.2}}

    # the planted fault: the temporal launches write each clip's output
    # into the clip after it (a wrong second batch stride)
    def shifted(q, k, v, sc, out=None, use_kernel=True):
        got_ = fused_attention_into(q, k, v, sc, out, use_kernel)
        if q.dim() == 5:
            got_.copy_(got_.roll(1, dims=0))
        return got_

    motionbert.fused_attention_into = shifted
    try:
        bad = gaps(bf16, *make_serving_fn(model, bf16)(clips))
    finally:
        motionbert.fused_attention_into = fused_attention_into
    for dt in (f32, bf16):
        good = gaps(dt, *got[dt])
        check(all(good[k_] <= bars[dt][k_] for k_ in good),
              f"{dt} kernel vs plain {good} within {bars[dt]}")
        say(32, f"MotionBERT serving B={n} clips x T={t} {str(dt)[6:]} "
                f"({n * t:,} frames): K3 vs plain attention " + ", ".join(
                    f"{k_} {good[k_]:.2e} (bar {bars[dt][k_]:g})"
                    for k_ in good)
                + f", as shares of the clips' RMS spread, mesh "
                f"{spread_v:.4f} m, kp3d {spread_k:.4f} m")
    check(all(bad[k_] > bars[bf16][k_] for k_ in bad),
          f"the planted fault {bad} outside {bars[bf16]}")
    say(32, "the planted fault (each clip's temporal output written into "
            "the next clip's), bf16: " + ", ".join(
                f"{k_} {v_:.3f}" for k_, v_ in bad.items())
            + f"; launches of the bf16 call {counts} (counters zeroed just "
            f"before it)")

    # 32 (c): times
    ms_k, ms_p = time_ms(lambda: serve_k(clips)), time_ms(
        lambda: serve_p(clips))
    say(32, f"MotionBERT serving call B={n}x{t} bf16 on {card}: K3 "
            f"{ms_k:.3f} ms ({n * t / ms_k * 1e3:,.0f} frames/s), plain "
            f"attention {ms_p:.3f} ms ({n * t / ms_p * 1e3:,.0f} frames/s)")
    return {"errs": {"fused_attention": err_f32},
            "launches": {"fused_attention": counts["fused_attention"]}}


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    torch.set_grad_enabled(False)
    sys.path.insert(0, ROOT)
    from gator_tpu_torch.nn import cuda_lib
    from gator_tpu_torch.tools.timing import card_name

    dev = torch.device("cuda")

    # 1. card
    card = card_name()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(1, f"card {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}; TF32 off")

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = dict(zip(KERNELS, pool.map(cuda_lib.build, KERNELS)))
    for name, (path, nvcc_s) in built.items():
        say(2, f"{name}: {os.path.relpath(path, ROOT)} (nvcc {nvcc_s:.1f} s)")
    say(2, f"all built in {time.perf_counter() - t0:.1f} s")
    gate_dir = tempfile.TemporaryDirectory()
    gate_json = os.path.join(gate_dir.name, "noise_distribution.json")
    gate = start_noise_gate(gate_json)
    try:
        run_phases(torch, dev, card, gate, gate_json)
    finally:
        if gate.is_alive():
            try:
                os.killpg(gate.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        gate.join()
        gate_dir.cleanup()


def run_phases(torch, dev, card, gate, gate_json):
    """Phases 3-32 and the result lines."""
    from gator_tpu_torch.assets import build_assets
    from gator_tpu_torch.cli import serve as serve_cli
    from gator_tpu_torch.data import processing
    from gator_tpu_torch.models import GatorSpec, build_gator
    from gator_tpu_torch.nn import (fold_stack_weights, fold_trunk_weights,
                                    gat_trunk, gat_trunk_ref, lbf_stack,
                                    lbf_stack_ref)
    from gator_tpu_torch.nn.gat_trunk import kernel_info as trunk_info
    from gator_tpu_torch.nn.gat_trunk import launch_plan as trunk_plan
    from gator_tpu_torch.serving import make_serving_fn
    from gator_tpu_torch.tools.timing import time_ms

    f32, bf16 = torch.float32, torch.bfloat16

    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    models = {}
    for joint_set, alpha in (("human36", False), ("coco", True)):
        assets = build_assets(joint_set, data_dirs=[],
                              synthetic_vertex_num=6890, seed=0)
        model = build_gator(GatorSpec.from_assets(assets, alpha=alpha),
                            seed=1, device=dev)
        if not alpha:
            bn = model.pose2mesh.bias_norm
            bn.running_mean.copy_(randn(*bn.running_mean.shape) * 0.5)
            bn.running_var.copy_(torch.rand(*bn.running_var.shape,
                                            generator=gen).to(dev) * 1.5
                                 + 0.5)
        models[joint_set] = model
    full_v = models["human36"].spec.mdr.full_num
    coarse_v = models["human36"].spec.mdr.coarse_num
    check((full_v, coarse_v) == (6890, 431), "full-width assets")

    errs = {name: 0.0 for name in KERNELS}

    # 3. K1 against its plain version at its tile edges: one sample, a few
    # tiles, a ragged last tile, the serving batch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for joint_set, model in models.items():
        gat = model.pose_lifter
        j = gat.spec.num_joint
        bias = gat.get_hop_path_encoding().float()
        masks = gat.blocks[0].x_feat.masks
        ws = {dt: fold_trunk_weights(gat.blocks, dt, dev)
              for dt in (f32, bf16)}
        for nb in (1, 300, 1001, 2048):
            x = randn(nb, j, 128)
            for dt in (f32, bf16):
                plan = trunk_plan(nb, j, dt, sms)
                got = gat_trunk(x.to(dt), bias, masks, ws[dt], 8)
                ref = gat_trunk_ref(x.to(dt), bias, masks, ws[dt], 8)
                torch.cuda.synchronize()
                err = max_err(got, ref)
                check(got.shape == x.shape and np.isfinite(err),
                      f"K1 {dt} B={nb} shape and finite")
                if dt == f32:
                    check(err <= 1e-4,
                          f"K1 f32 J={j} B={nb} err {err} <= 1e-4")
                    errs["gat_trunk"] = max(errs["gat_trunk"], err)
                ragged = nb % plan["g"] != 0
                check(ragged or nb != 1001, "B=1001 leaves a ragged tile")
                say(3, f"K1 gat_trunk J={j} B={nb} {str(dt)[6:]} "
                       f"({plan['ctas']} CTAs of {plan['g']} samples"
                       + (", the last ragged" if ragged else "")
                       + f"): max abs err {err:.3e} vs plain"
                       + (" (bar 1e-4)" if dt == f32 else " (reported)"))
            del x, got, ref

    # 4. K2 against its plain version, at B=16 and at the serving batch.
    # bf16 takes its own rows kernel (csrc/lbf_rows_wg.cuh): its bar is the
    # card tests' (sums in another order can flip a bf16 rounding), and its
    # error is the kernels line's, since phase 7 times bf16
    for joint_set, model in models.items():
        mdr = model.pose2mesh
        j = mdr.spec.num_joint
        for nb in (16, 2048):
            verts, joints = randn(nb, coarse_v, 64), randn(nb, j, 64)
            for dt, bar in ((f32, 1e-4), (bf16, 5e-2)):
                w = fold_stack_weights(mdr, dt, dev)
                got = lbf_stack(verts.to(dt), joints.to(dt), w, 2)
                ref = lbf_stack_ref(verts.to(dt), joints.to(dt), w, 2)
                torch.cuda.synchronize()
                err = max_err(got, ref)
                check(err <= bar,
                      f"K2 {str(dt)[6:]} J={j} B={nb} err {err} <= {bar}")
                if dt == bf16:
                    errs["lbf_stack"] = max(errs["lbf_stack"], err)
                say(4, f"K2 lbf_stack J={j} B={nb} Nv={coarse_v} "
                       f"{str(dt)[6:]}: max abs err {err:.3e} vs plain "
                       f"(bar {bar:g})")
            del verts, joints, got, ref

    # 5. end to end, kernel path against plain path
    for joint_set, model in models.items():
        j = model.spec.gat.num_joint
        pose = randn(256, j, 2)
        plain = make_serving_fn(model, f32, use_kernels=False)
        ref_mesh, ref_pose = plain(pose)
        gat_trunk.launches = lbf_stack.launches = 0
        mesh32, pose32 = make_serving_fn(model, f32)(pose)
        mesh16, _ = make_serving_fn(model, bf16)(pose)
        torch.cuda.synchronize()
        check(gat_trunk.launches > 0 and lbf_stack.launches > 0,
              "both kernels launched in the end-to-end run")
        check(mesh32.shape == (256, full_v, 3), "mesh shape")
        e32, p32 = max_err(mesh32, ref_mesh), max_err(pose32, ref_pose)
        e16 = max_err(mesh16, ref_mesh)
        check(e32 <= 1e-4, f"e2e f32 mesh err {e32} <= 1e-4 m")
        check(np.isfinite(e16) and e16 <= 5e-2,
              f"e2e bf16 mesh err {e16} <= 5e-2 m")
        say(5, f"{joint_set} alpha={model.spec.mdr.alpha} B=256: kernel "
               f"f32 vs plain f32 mesh {e32:.3e} m, pose3d {p32:.3e} mm; "
               f"kernel bf16 vs plain f32 mesh {e16:.4f} m (bar 5e-2; the "
               f"JAX package's bf16 figure on a TPU v5e: "
               f"{TPU_BF16_MESH_ERR:.4f} m)")

    # 6. the serve CLI, the main path whose launches are counted
    rng = np.random.default_rng(0)
    poses = np.concatenate([rng.uniform(50, 450, size=(300, 17, 2)),
                            rng.uniform(0.3, 1.0, size=(300, 17, 1))],
                           axis=2).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "poses.npy"), os.path.join(tmp, "m.npy")
        np.save(src, poses)
        gat_trunk.launches = lbf_stack.launches = 0
        served = serve_cli.main(["--input_poses", src, "--joint_set", "coco",
                                 "--output", out,
                                 "--batch_size", "256"])
        torch.cuda.synchronize()
        launches = {"gat_trunk": gat_trunk.launches,
                    "lbf_stack": lbf_stack.launches}
        meshes = np.load(out)
    check(meshes.shape == (300, full_v, 3), f"CLI meshes {meshes.shape}")
    check(np.isfinite(meshes).all(), "CLI meshes finite")
    check(all(n > 0 for n in launches.values()),
          f"each kernel launched on the main path: {launches}")
    coco = build_assets("coco")
    cli_model = build_gator(GatorSpec.from_assets(coco), seed=0, device=dev)
    pose2d = processing.batch_crop_and_normalize(
        processing.add_pelvis_neck_scores(
            poses, list(coco.joint_set.joints_name))[..., :2],
        coco.joint_set,
        processing.ProcessOptions(is_train=False, input_joint_name="coco"),
        np.zeros(len(poses), np.int64), np.zeros(len(poses), np.float32))
    ref, _ = make_serving_fn(cli_model, f32, use_kernels=False)(
        torch.from_numpy(pose2d).to(dev))
    e_cli = float(np.abs(meshes - ref.float().cpu().numpy()).max())
    check(e_cli <= 5e-2, f"CLI bf16 meshes vs plain f32 {e_cli} <= 5e-2 m")
    check(served["meshes"].shape == meshes.shape, "CLI return value")
    say(6, f"serve CLI: 300 coco poses -> meshes {list(meshes.shape)}, "
           f"finite, max {e_cli:.4f} m from the plain f32 path; launches "
           f"{launches}")

    # 7. times at the main path's shapes, B=2048, bf16
    model = models["human36"]
    gat, mdr = model.pose_lifter, model.pose2mesh
    b = 2048
    tw = fold_trunk_weights(gat.blocks, bf16, dev)
    sw = fold_stack_weights(mdr, bf16, dev)
    bias = gat.get_hop_path_encoding().float()
    masks = gat.blocks[0].x_feat.masks
    x = randn(b, 17, 128).to(bf16)
    verts, joints = randn(b, coarse_v, 64).to(bf16), randn(b, 17, 64).to(
        bf16)
    pose = randn(b, 17, 2)
    serve_k = make_serving_fn(model, bf16)
    serve_p = make_serving_fn(model, bf16, use_kernels=False)
    ms = {
        "gat_trunk": time_ms(lambda: gat_trunk(x, bias, masks, tw,
                                                      8)),
        "gat_trunk_plain": time_ms(lambda: gat_trunk_ref(
            x, bias, masks, tw, 8)),
        "lbf_stack": time_ms(lambda: lbf_stack(verts, joints, sw, 2)),
        "lbf_stack_plain": time_ms(lambda: lbf_stack_ref(
            verts, joints, sw, 2)),
        "serve": time_ms(lambda: serve_k(pose)),
        "serve_plain": time_ms(lambda: serve_p(pose)),
    }
    for name in ("gat_trunk", "lbf_stack", "serve"):
        k, p = ms[name], ms[name + "_plain"]
        say(7, f"{name} B={b} bf16 on {card}: kernel path {k:.3f} ms "
               f"({b / k * 1e3:,.0f} poses/s), plain {p:.3f} ms "
               f"({b / p * 1e3:,.0f} poses/s)")

    # K2's two launches alone: device ms per serving call (3 layers) from
    # torch.profiler, each beside its bound. Per row and layer the rows
    # launch reads x (f32) and writes y3 (f32) and q2/k2/v2 (bf16); the
    # self-attention reads those four and writes x' (f32): 896 bytes each.
    from gator_tpu_torch.tools.profile_train import _device_us, _is_kernel
    k2_ms = dict.fromkeys(("rows_kernel", "lbf_selfattn_kernel"), 0.0)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lbf_stack(verts, joints, sw, 2)
        torch.cuda.synchronize()
    rows_names = set()
    for evt in prof.key_averages():
        for key in k2_ms:
            if _is_kernel(evt) and key in evt.key:
                k2_ms[key] += _device_us(evt) / 1e3 / 3
                if key == "rows_kernel":
                    rows_names.add(evt.key)
    check(all(v > 0 for v in k2_ms.values()),
          f"the profiler saw K2's two launches: {k2_ms}")
    # bf16's rows launches run csrc/lbf_rows_wg.cuh's kernel, and none
    # lbf_layer.cuh's (which f32, K2-layer and T1 keep)
    check(any("lbf_wg::rows_kernel" in n for n in rows_names)
          and not any("lbf_layer::rows_kernel" in n for n in rows_names),
          f"bf16 K2's rows launches in the trace: {sorted(rows_names)}")
    k2_io = 3 * b * coarse_v * 64 * (4 + 4 + 6)
    k2_bounds = {
        "rows_kernel": bound(3 * b * fma_lbf_rows_fwd(coarse_v, 17), k2_io),
        "lbf_selfattn_kernel": bound(
            3 * b * (2 * coarse_v * coarse_v * 64 + coarse_v * 64 * 64),
            k2_io),
    }
    from gator_tpu_torch.nn.lbf_stack import stack_plan
    rp = stack_plan(bf16, coarse_v)
    say(7, f"K2 launches per serving call (3 layers, B={b} bf16) on {card}: "
           + "; ".join(
               f"{key} {k2_ms[key]:.3f} ms device (bound "
               f"{k2_bounds[key][0]:.3f} ms, {k2_bounds[key][1]}: "
               f"{k2_io / 1e9:.2f} GB at 3.35 TB/s)" for key in k2_ms)
           + f"; the rows launch on {rp['rows_kernel']} (traced as "
           f"{', '.join(sorted(rows_names))}): "
           f"{rp['rows_ctas_per_sm']} CTA an SM of {rp['rows_warpgroups']} "
           f"warpgroups, {rp['rows_tile']}-row tiles, "
           f"{rp['rows_smem_bytes']} shared bytes, "
           f"{rp['rows_registers']} registers")

    # K1 alone: device ms per launch (six blocks) from torch.profiler
    # beside its bound (x in and out, the weights once), and its registers,
    # CTAs per SM and shared bytes
    def k1_bound(nb, j=17):
        return bound(nb * 6 * fma_gat_block(j),
                     2 * nb * j * 128 * 2 + 6 * GAT_BLOCK_WEIGHTS * 2)

    k1_dev = 0.0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            gat_trunk(x, bias, masks, tw, 8)
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        if _is_kernel(evt) and "gat_trunk_kernel" in evt.key:
            k1_dev += _device_us(evt) / 1e3 / 3
    check(k1_dev > 0, f"the profiler saw K1's launch: {k1_dev}")
    info = trunk_info(bf16, 128)
    plan = trunk_plan(b, 17, bf16, sms)
    say(7, f"K1 gat_trunk_kernel B={b} bf16 on {card}: {k1_dev:.3f} ms "
           f"device (bound {k1_bound(b)[0]:.3f} ms, {k1_bound(b)[1]}); "
           f"{plan['ctas']} CTAs of {plan['g']} samples; registers "
           f"{info['registers']}, CTAs per SM {info['ctas_per_sm']}, "
           f"shared bytes {info['smem_bytes']}")

    # K1 and the whole serving call at the serve CLI's chunk and below
    for nb in (1, 64, 256):
        xs, ps = randn(nb, 17, 128).to(bf16), randn(nb, 17, 2)
        t = [time_ms(lambda: gat_trunk(xs, bias, masks, tw, 8)),
             time_ms(lambda: gat_trunk_ref(xs, bias, masks, tw, 8)),
             time_ms(lambda: serve_k(ps)), time_ms(lambda: serve_p(ps))]
        say(7, f"B={nb} bf16 on {card}: K1 {t[0]:.3f} ms (plain "
               f"{t[1]:.3f}; bound {k1_bound(nb)[0]:.4f}), serving call "
               f"{t[2]:.3f} ms (plain {t[3]:.3f})")

    j_full = 17
    bounds = {
        "gat_trunk": k1_bound(b, j_full),
        "lbf_stack": bound(
            b * 3 * fma_lbf_layer(coarse_v, j_full),
            (2 * b * coarse_v * 64 + b * j_full * 64) * 2
            + 3 * LBF_LAYER_WEIGHTS * 2),
    }

    # 8-14: the training path
    with torch.enable_grad():
        train = train_phases(torch, dev, card, randn)
    errs.update(train["errs"])
    launches.update(train["launches"])
    ms.update(train["ms"])
    bounds.update(train["bounds"])

    # 15-18: the evaluation path
    ev = eval_phases(torch, dev, card, randn)
    errs.update(ev["errs"])
    launches.update(ev["launches"])
    ms.update(ev["ms"])
    bounds.update(ev["bounds"])

    # 19-21: the tool paths
    lay = layer_phases(torch, dev, card, randn, models)
    errs.update(lay["errs"])
    launches.update(lay["launches"])
    ms.update(lay["ms"])
    bounds.update(lay["bounds"])
    library_ms = {name: None for name in KERNELS}
    library_ms.update(ev["library_ms"])

    # 22-25: the real-dataset path; 26-27: the in-step input paths (27
    # reads phase 22's trees)
    with tempfile.TemporaryDirectory() as tmp:
        real = dataset_phases(torch, dev, card, tmp)
        say(25, "launches by phase: " + "; ".join(
            f"{phase} {counts}" for phase, counts in real["launches"].items()))
        in_step = input_phases(torch, dev, card, real["flagship"])
    say(27, "launches by phase: " + "; ".join(
        f"{phase} {counts}" for phase, counts
        in in_step["launches"].items()))

    # 28: the train CLI
    cli_runs = train_cli_phases(torch, card)
    say(28, "launches by run: " + "; ".join(
        f"{run} {counts}" for run, counts in cli_runs["launches"].items()))

    # 29: the demo CLI and the rest of the surface; its K3 launches join
    # the eval path's in the kernels line
    demo_run = demo_phases(torch, dev, card)
    launches["fused_attention"] += demo_run["launches"]["fused_attention"]

    # 30: data parallelism; its world-1 launches join the kernels line
    par = parallel_phases(torch, card)
    for name, n in par["launches"].items():
        launches[name] += n

    # 31: K1 and K5 at embed 64, and the five tools; its main-path
    # launches join the kernels line
    wide = width_tool_phases(torch, dev, card, randn, gate, gate_json)
    for name, n in wide["launches"].items():
        launches[name] += n

    # 32: MotionBERT's serving call, K3's serving path; its one counted
    # call's launches join the kernels line, its f32 error K3's
    mb = motionbert_phases(torch, dev, card, randn)
    launches["fused_attention"] += mb["launches"]["fused_attention"]
    errs["fused_attention"] = max(errs["fused_attention"],
                                  mb["errs"]["fused_attention"])

    check("jax" not in sys.modules and "gator_tpu" not in sys.modules,
          "no JAX imported")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src_path,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errs[name], "ms": ms[name],
         "plain_ms": ms[name + "_plain"], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library_ms[name]}
        for name, (src_path, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

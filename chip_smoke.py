#!/usr/bin/env python3
"""Smoke run of hotformerloc_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each printed as a JSON line; any failed check raises and the
script exits non-zero without the final line:

1. device: the card's name and, as nvidia-smi reports them, name and
   power limit. No CUDA device -> exit 1.
2. build: nvcc builds every kernel source of the package (seconds).
   Then the per-tap lists of every kernel level of the batch's plan are
   built once with torch.cuda.set_sync_debug_mode("error") (any
   device-to-host sync raises), and timed.
3. kernels: each CUDA kernel of the serving path (K1 window attention,
   K3 depthwise octree conv, K5 full octree conv) at every shape the
   oxford_config forward gives it, batch 32, on real neighbour tables and
   window coordinates from the package's own octree build: kernel vs its
   plain PyTorch version on the card at fp32 and bf16 (tolerances in
   TOL), and CUDA-event times (median of REPS launches after warm-up) of
   the kernel, the plain version and, for K1, scaled_dot_product_attention
   given a materialised bias (a yardstick the package never calls). K1
   and K5 run the body attn_body / conv_body picks (bf16: the tensor-core
   body, but for K5's C = 3 stem conv); where that is the tensor-core
   body, the CUDA-core body is checked and timed on the same inputs too
   (cc_ms). K3 and K5 also give their device time under torch.profiler
   (device_ms, cc_device_ms: a call's CUDA-event time includes the
   wrapper's host work), and are checked and timed (CUDA events) again
   on a surface-like batch (surf_*: 4096 points on 3-4 random planes per
   cloud, no octree overflow), with valid taps per node for both. K3 runs
   every CPE, the depth-4 one included (the JAX package's dense-grid
   depth); there its library time is cuDNN's grouped conv3d on the dense
   16^3 grid of the same inputs (the call the port made before).
3b. F1: the CUDA-core conv body (the stem's C = 3 -> 32 conv) on 1040
   clouds of 4096 rows, past the old 65535-tile grid cap, held against
   the plain version on a fixed sample of rows at fp32 and bf16.
4. slice: oxford_config with seeded random weights embeds 32 synthetic
   clouds (16 uniform clouds of 4096 points, each twice with sigma 0.01
   noise) through make_embed_fn in bf16 and fp32. The launch counters,
   zeroed just before the bf16 run and read just after, must show K1=34,
   K3=34, K5=3, all 34 K1 launches and K5's 2 with C, O multiples of 16
   on the tensor-core bodies (none at fp32), one layer_norm launch per
   LayerNorm module called (none on the plain path), and the run no call
   of F.conv3d; descriptors must be finite and unit-norm with no octree
   overflow; the fp32 kernel descriptors must match the plain path on
   the same card (cos >= 0.9999, max abs <= 1e-4). These runs are eager
   (``graphs=False``); the serving default, a CUDA graph from a shape's
   second call, then runs the bf16 batch three times: a forward's
   launches, a forward's (the capture), none (the replay), the replay
   bit-equal to the eager descriptors. Retrieval recall@1 of
   the noisy copies against the originals is printed for information
   (the weights are random), with bf16 ms/batch and submaps/s.
4b. weights: reference weights in (``weights_phase``): a state dict
   with the reference's names and shapes for configs/oxford_model.txt
   (the converter's synthesize_reference_state_dict) saved as a .pth,
   converted by tools/convert_reference_weights' CLI, loaded through
   pnv_evaluate's load_model_embed_fn on the card and the 32 clouds
   embedded in bf16: K1, K3 and K5 launched, the bf16 descriptors
   within cos >= 0.999 of the plain path's fp32 ones; the same file's
   weights' fp32 kernel descriptors against the plain path at the
   slice's bar; bf16 ms per batch.
5. backward kernels: K2 window attention, K4 depthwise and K6 full
   octree conv backward at every shape of the train path (microbatch 8
   of the same clouds, the package's own octree build): kernel vs its
   plain PyTorch version at fp32 and bf16 (tolerances in TOL_BWD),
   CUDA-event times of both and, for K2, scaled_dot_product_attention
   forward + backward with a materialised bias that requires grad (a
   yardstick that stops at dbias and does not fold it into the table).
   K2 is also timed without the table gradient (nodtab_ms) and, where it
   runs the tensor-core body, as the CUDA-core body (cc_ms). K4 and K6
   take the plan's tap lists, as the train step gives them; K6 is timed
   on both bodies as K5 is, and K4 (one body) and K6 give device_ms and
   the surface-like microbatch's surf_* rows as K5 does.
5b. attn_ab: tools/pallas_ab.py's three cases (the Oxford microbatch-8
   attention shapes: H-OSA 704 x 49 x 256, 16 heads, one relay slot;
   OctFormer 704 x 48 x 128, 8 heads, dilation 1 and 4), the port's
   WindowAttention module (qkv and proj included) in bf16 on the kernel
   route against the einsum route (the one attention dropout takes):
   forward and forward+backward CUDA-event ms over 30 calls, the launch
   counters zeroed before each route and read after it (the kernel route
   launches K1 and K2, all on the tensor-core bodies; the einsum route
   neither), and, under the loss over valid query rows, the output and the gradient of
   x and of every parameter (the RPE table's included) within the bf16
   bar relative to the einsum route's own largest value.
6. train: the Oxford multistage step (make_train_step, batch 32 as 4
   microbatches of 8, truncatedsmoothap, Adam with L2 weight decay 1e-4
   on bench.py's schedule, DropPath 0.5). At fp32 with TF32 off, one
   step's gradients on the kernel path must equal the plain path's
   (set_use_kernels(False), but for the LayerNorms, which run their
   kernel on both paths), per parameter |dg| <= 1e-4 |g_plain| + 1e-7,
   and the stage-3 embeddings stage 1's (max abs <= 1e-6). In bf16 on
   fp32 parameters, the launch counters of one step (zeroed just before,
   read just after) must equal the counts the shape table gives (K1 272,
   K2 136, K3 272, K4 136, K5 24, K6 12; every K1 and K2 launch on the
   tensor-core bodies, and K5's 16 and K6's 8 that conv_body gives them),
   with no call of F.conv3d; loss, stats and gradients must be finite;
   then 3 warm-up and 10 timed steps give step ms, submaps/s, octree +
   plan ms per step and peak memory. This phase runs without activation
   checkpointing (grad_checkpoint False), as every earlier PR measured it.
6a. lamb: one bf16 step of 16 clouds as 2 microbatches of 8 at Oxford
   width with make_optimizer's 'lamb' on the named parameters (one trust
   ratio per JAX leaf): finite loss, every parameter tensor moved and
   finite.
6b. entry: the port's own CLIs on the card. A synthetic PNV-format
   dataset under .chip_tmp/entry (160 places x 2 passes of surface-like
   4096-point clouds with sigma 0.01 noise, and the four Oxford
   evaluation splits of 2 runs x 32 places inside each split's test
   squares), laid out with the PNV locations CSVs; its training-queries
   pickle and evaluation sets come from tools/pnv_tuples.py
   (construct_query_dict, construct_query_and_database_sets) and must
   equal the ground truth the clouds were written with;
   hotformerloc_torch.training.train's main on configs/oxford.txt's
   settings with that dataset, batch_size 256 as microbatches of 128
   (the shipped batch_split_size), 2 epochs, eval_freq and save_freq 1,
   no validation, and configs/oxford_model.txt unchanged (full width and
   depth, grad_checkpoint on): finite losses, a checkpoint and a
   .meta.json per epoch, and every model kernel (K1-K6) launched in that
   run (counters zeroed just before, read just after). A Trainer resumed
   from latest must hold the same epoch, parameters, optimizer moments,
   update count and sampler batch size. pnv_evaluate's main on the final
   checkpoint must give the in-training evaluation's AR@1 / AR@1% / MRR
   of epoch 2 exactly, and a brute-force float64 numpy recall of the
   same embeddings the same stats per split. The run's trainer then
   takes one step of 256 (2 x 128) under the run's remat_policy
   'save_hot' (the default) and under None, in turns (a b a b), on one
   batch of its loader: step ms, peak memory and K1 / K3 launches
   (remat_launches) for each. Then one embed of the 256 evaluation
   clouds in one chunk (val_batch_size) is timed, and one fp32 step at
   microbatch 8 (batch 16) without checkpointing and with
   grad_checkpoint under each remat_policy (None, 'save_attn',
   'save_hot') must give the same loss (|diff| <= 1e-6) and gradients
   within GRAD_TOL, with the K1 / K3 forward launches the shape table
   gives: the no-checkpoint step's plus, per microbatch, one per
   checkpointed site whose output the policy does not keep (None: K1
   and K3; 'save_attn': K3; 'save_hot': none). The line carries the
   card, step ms (median after the first), loader wait per batch, epoch
   seconds, embed ms per 256 clouds and the peak memory of the training
   run, of each microbatch-8 step and of the evaluation.
6e. convergence: tools/convergence_run.py at --exact shapes (Oxford at
   full width and depth, batch 32 as 2 microbatches of 16, grad_checkpoint
   with 'save_hot') on its synthetic benchmark (16 places per location x
   4 variants), cut to CONV_EPOCHS epochs, evaluated at the last: finite
   losses, the last epoch's below the first's, every model kernel
   launched; prints the trajectory and epoch seconds.
6c. dp: data parallelism (parallel/dist.py) at Oxford width, fp32
   parameters, no activation checkpointing, DropPath 0, through
   tools/multihost_smoke on a synthetic PNV dataset of 64 clouds, batch
   32 as 4 global microbatches of 8, for three models (DP_VARIANTS):
   layernorm (the configs'), conv_norm batchnorm with the
   PyramidOctGeMgc head's BatchNorm in flax's form (the shipped one),
   and powernorm. (a) The DP step at world 1 over NCCL against the step
   without a process group on the same batch and weights, in bf16 and at
   fp32: loss within rtol 1e-5, gradients within GRAD_TOL (at bf16 but
   for the parameters that only shift a MaskedBatchNorm's input, whose
   gradient, 0 in exact arithmetic, is bf16 rounding; at fp32 those
   within ZERO_GRAD_TOL of the gradient's norm), running statistics
   within 1e-6 (absolute and relative) and PowerNorm's count equal; the
   bf16 step run again without a group gives the card's run-to-run
   spread (printed). (b) Two ranks as two processes on this card over
   gloo (NCCL refuses two ranks on one device; the CUDA tensors go
   through the host), 16 rows each (4 of each global microbatch, the
   JAX step's layout). layernorm's run in bf16, on the tensor-core
   bodies (their launches checked), against one process of 8
   microbatches of 4 rows, the ranks' own GEMM shapes, at GRAD_TOL; its
   distance from one process of 4 microbatches of 8 rows is printed
   (other shapes: a bf16 GEMM of 8 rows rounds otherwise than one of 4).
   The models with statistics run fp32 against one process with the
   same accum_steps, at GRAD_TOL times max(1, 2 x the model's own
   rounding spread: its one-process step with the rows of each
   microbatch reversed, and rolled by half, which is equal in exact
   arithmetic), statistics as (a). Every run: both ranks' parameters
   bitwise equal after the step, loss within rtol 1e-5, every model
   kernel launched (counters zeroed just before each step, read just
   after). (c) retrieval_topk of 1000 queries over a 20000 x 256
   database sharded over two such ranks against one card: indices exact
   (random normal rows have no distance ties), distances within 1e-5 of
   one card's and of the distances recomputed on the host from the
   returned indices, the ranks' results equal. The lines give each
   part's seconds, step seconds and peak memory per rank.
6d. configs: the patch-64 and no-ADaPE configurations at full width.
   (a) cs_wild_places_config (depth-7 octree, patch 64: OctFormer windows
   of T = 64, H-OSA windows of 64 nodes + a relay slot, T = 65): K1 at
   every shape of its forward (batch 32) and K2 at every shape of its
   train step (microbatch 8), held and timed as in phases 3 and 5, with
   the tensor-core backward's heads per round; then the slice's checks
   (serve_check: K1 34 all on the tensor-core body, K3 34, K5 3; fp32
   kernel vs plain descriptors cos >= 0.9999, max abs <= 1e-4) and bf16
   embed time on the uniform batch and on the surface-like one. (b) its
   train step as phase 6 (fp32 gradients within GRAD_TOL, stage 3 equal
   to stage 1, bf16 launches K1 272, K2 136 on the tensor-core bodies),
   5 timed steps. (c) configs/wild-places_model.txt (no ADaPE: the
   relay-token CPE adds a K3 launch per pyramid level, 37 per forward;
   cylindrical coordinates): the uniform clouds through the port's
   cylindrical conversion, serve_check, then its train step as (b)
   (fp32 gradients through the relay-token CPE's K4 within GRAD_TOL; bf16
   launches K3 296 and K4 148), 5 timed steps. (d) the train CLI on
   configs/cs-wild-places.txt and configs/cs-wild-places_model.txt
   unchanged but for batch 256 (2 microbatches of the shipped 128), 1
   epoch, eval_freq and save_freq 1, on a synthetic .pcd dataset under the
   CSWildPlaces names (training and validation pickles, four locations'
   evaluation pickles): validation and MESA run, every model kernel
   launches, and pnv_evaluate on the final checkpoint reports the four
   locations with the in-training average. The line gives each part's
   numbers and seconds with the card.
6f. ablations: the model's off-path branches, three variants of
   oxford_config at full width and depth (ablation_variants): A
   batchnorm, xCPE, rt_size 2, relay-token propagation, AttnPoolMixer; B
   relay tokens in the OctFormer stage, powernorm, PyramidOctGeMgc, the
   'NDLP' features (on the surface-like clouds with their exact plane
   normals), dropout 0.1; C disable_rt, no stem downsampling,
   PyramidOctGeM, capacities for depths 6-9. Per variant: the kernels at
   its new shapes against their plain versions and timed (ABLATION_ROWS:
   K1/K2 at T = 50 and 49, K5/K6 at the xCPE's 128 x 128 and 256 x 256,
   K3/K4 and the stem's 128 -> 128 K5/K6 at depth 9), serve_check
   (launches per bf16 forward as the variant's table), train_phase with
   5 timed steps: fp32 gradients within GRAD_TOL at dropout 0 (a
   parameter that only shifts a MaskedBatchNorm's input has gradient 0:
   both paths within ZERO_GRAD_TOL of the gradient's norm; a head's
   BatchNorm takes its variance in two passes there), stage 3 equal to
   stage 1, the running statistics equal between the paths, equal to
   stage 1's last microbatch applied once, and (A) under checkpointing;
   B's bf16 step, with attention dropout, launches no K1/K2 (the einsum
   route, as JAX's). For A (xCPE) also ``xcpe_remat_check``: one fp32
   step of 2 x 8 without checkpointing and under 'save_hot' and None:
   'save_hot' keeps the xCPE conv's output, so the backward runs K5 no
   extra time; None runs it once more per xCPE site and microbatch; loss
   and gradients as without checkpointing.
7. probes: the probe tools end to end on the card, the slice's main
   path: gather_bench (T1 take_rows and T2 dwconv_resident at (8, 4224,
   256) on real tables, on both cluster sizes, with K3 on the same
   inputs) and mosaic_probe constructs (T3's ten kernels), gather (T4's
   six row gathers through take_rows), attn and band, each with
   PROBE_REPS repetitions. First the built probe libraries' SASS
   (cuobjdump) must show the redesigned bodies: HMMA (tensor-core mma) in
   the products' window_product_kernel, no global atomic in
   dtab_cluster_kernel, bulk copies and cluster barriers in
   dwconv_resident_kernel, and in take_rows_kernel the index broadcast
   by shuffle, streaming stores and row loads through L1; softmax_kernel
   streaming stores and butterfly shuffles; 16-byte streaming stores in
   onehot4d, pad, reshape, selloop and slicestore, 16-byte loads in
   reshape and slicestore, and the table shuffled to the indices in
   selloop. Then ``redesign_checks``
   holds the kernels redesigned in PR 15 against their plain versions
   beyond the tools' shapes: take_rows exactly at B > 1 on strided
   indices with -1 and Nx among them (fp32 and bf16 rows of 256), on
   rows of 9 vectors (bf16 C = 72, fp32 C = 36; flat and B > 1) and of
   one vector; the softmax at L = 1, 31, 32, 33, 49, 64, 65 and 1024 with
   -1e9 entries and one large entry, within 1e-5 max |plain|; onehot4d,
   pad, reshape, selloop and slicestore bit for bit at edge indices and
   values, tails and misaligned views (T1 and T4's shapes are the tools'
   own, held exactly there). The
   tools hold every kernel against its plain version (take_rows and the
   copy-like constructs bit for bit, dwconv_resident within one bf16 ulp
   / 1e-5 at fp32, the products, softmax and dtab to a relative 1e-5),
   and time it, its plain version and, where one PyTorch call computes
   the same function, that call: device time under torch.profiler (*ms
   in the kernels line) and CUDA events around one call (*call_ms, the
   host's launch included, which is most of a call of a few
   microseconds). The launch counters, zeroed before each tool and read
   after it, must equal the launches its checked and timed calls make,
   plus PROBE_REPS per profiled window that device_ms had to take again
   because torch.profiler returned it without device events (counted,
   and printed as retaken_profiler_windows).
8. device times: K3, K4, K5 and K6 (K5/K6 on both bodies) under
   torch.profiler at the main path's shapes, taken after every other
   phase (profiled windows before the train phase were followed by
   probe-tool windows without device events). Then the train phase's
   bf16 step once more under torch.profiler (scatter_phase): the device
   ms of the gather/scatter/index kernel class, its kernels, and the op
   calls of scatter_add, index_add and gather's backward; the down-convs
   differentiate no gather (their backward reads the inverse tables), so
   the step may hold one gather_backward (the loss's top-k) and no more.
8d. spans (spans_phase; after the probes for the same reason): the
   slice's bf16 embed under torch.profiler with the program's spans on
   and off: no device event is a range kineto draws for a span (a user
   annotation), both launch the same kernels, and the hfl.* spans take
   >= 99% of the kernel time.
6h. prep (host only): the dataset-preparation CLIs, each in a process
   of its own, on synthetic raw trees under .chip_tmp/prep, each checked
   against the ground truth its tree was built with, and timed:
   fix_broken_timestamps, postprocess_submaps (CSF ground removal and
   voxel downsampling on 2 workers), wildplaces_tuples train and
   test-sets, cswildplaces_tuples, cscampus3d_convert,
   ground_aerial_overlap, and loader_bench at 0, 2 and 4 workers on 256
   clouds (submaps/s); the native library loaded must be the port's own
   build (hotformerloc_torch/build/libpointops.so).
8c. tools, in a process of their own (``chip_smoke.py --tools-worker``:
   torch.profiler returns windows without device events after this
   process's many earlier ones): bisect_step's six stages at Oxford
   shapes (wall, CUDA-event and profiler device time per stage, so the
   host's share of each),
   plan_probe's table kinds and component_profile's band, cpe, rtsa and
   pool experiments (band holds K3/K4/K5 against the plain path); every
   stage must show device time, and K1-K6 must launch in the run.
9. the kernels line {"kernels": [...]} (the six model kernels, forward
   rows per forward of batch 32 and backward rows per train step of
   batch 32, K1/K2 and K5/K6 with their tensor-core launches and the
   CUDA-core bodies' time on the same inputs, K2's time without the table
   gradient, K4/K5/K6's device time, valid taps per node and surface-like
   rows, each kernel's launches in the entry phase's train run as
   launches_entry, and in the dp phase's steps per model as launches_dp
   ((a)'s bf16 step) and launches_dp_two_ranks ((b)'s ranks) and
   in the tools phase as launches_tools, K1's and K2's in the attn_ab
   phase's kernel routes as launches_attn_ab; then the twelve probe
   kernels, per call at the tools' shapes, launches per run of the
   tools; T2's row adds its cluster plan (blocks per cluster, channel
   slice, rows per block, clusters per sample = neighbour-table reads
   per call, at most 2), cudaOccupancyMaxActiveClusters and the times of
   both cluster sizes, T3's rows the body each construct ran). K1's and K2's rows add the same numbers at
   cs_wild_places_config's shapes (cs_wild_places), and every model
   kernel's row its launches in the configs phase's runs (per bf16
   forward and train step of CS-Wild-Places and of Wild-Places, and in
   the CS-Wild-Places CLI run), and in the ablations phase's runs
   (launches_ablations: per bf16 forward, or per step for the backward
   kernels, of each variant; launches_ablations_train_step) with the
   rows at the variants' new shapes (ablations). Then {"ok": true,
   "device": ...}.
Every phase prints its seconds.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# fp32: kernel and plain version sum the same products in fp32; K5 sums
# up to 27*128 of them. bf16: both accumulate in fp32 and round the
# output once, so they differ by about one bf16 ulp of the output.
TOL = {"fp32": {"window_attn": 1e-5, "octree_dwconv": 1e-5,
                "octree_conv": 1e-4},
       "bf16_rel": 1e-2}
# Backward, relative to max(1, max |plain|) of each output. fp32: the
# kernel sums the same fp32 products in another order (dw and the table
# gradient sum up to ~1.7M terms; the table gradient adds per-window
# partials with atomics). bf16: dq/dk/dv/dx are rounded to bf16 once on
# both sides (<= 1 ulp); dw and dtable are fp32 sums of the same
# products.
TOL_BWD = {"fp32": {"act": 1e-5, "weight": 1e-4}, "bf16": {"act": 1e-2,
                                                          "weight": 1e-4}}
GRAD_TOL = (1e-4, 1e-7)      # train phase: |dg| <= a |g_plain| + b
# train phase, parameters whose gradient is 0 in exact arithmetic (a
# shift of a MaskedBatchNorm's input, ``bn_shift_params``): |g| on each
# path <= this times the norm of the whole gradient
ZERO_GRAD_TOL = 1e-6
REPS = 20
DEV_ITERS = 5                # profiled calls per device time
BATCH = 32
MICRO = 8                    # microbatch of the train step
ACCUM = BATCH // MICRO
# kernel -> the pl.pallas_call line(s) it replaces (kernel body line)
_PA = "hotformerloc_tpu/ops/pallas/"
_TL = "hotformerloc_tpu/tools/"
REPLACES = {
    "window_attn": _PA + "window_attn.py:298 (_fwd_kernel :147)",
    "octree_dwconv": _PA + "band_conv.py:326 (_dw_fwd_kernel :193)",
    "octree_conv": _PA + "band_conv.py:367 (_conv_fwd_kernel :242)",
    "window_attn_bwd": _PA + "window_attn.py:333 (_bwd_kernel :181)",
    "octree_dwconv_bwd": _PA + "band_conv.py:344 (_dw_bwd_kernel :210)",
    "octree_conv_bwd": _PA + "band_conv.py:394 (_conv_bwd_kernel :262)",
    "take_rows": (_TL + "gather_bench.py:180 (k_take :157); "
                  + _TL + "mosaic_probe.py:256 (k_take :251), :272 (k_jtake "
                  ":268), :287 (k_rowloop :279), :305 (k_tiled :300)"),
    "dwconv_resident": _TL + "gather_bench.py:189 (k_dw :164)",
}
SOURCES = {k: "hotformerloc_torch/csrc/" + (
    "window_attn.cu" if k.startswith("window") else "octree_conv.cu")
    for k in REPLACES}
SOURCES.update(take_rows="hotformerloc_torch/csrc/gather.cu",
               dwconv_resident="hotformerloc_torch/csrc/gather.cu")
CONSTRUCT_SOURCE = "hotformerloc_torch/csrc/constructs.cu"
PROBE_REPS = 3               # repetitions of each timed call in the tools


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        f"nvidia-smi failed: {r.stderr.strip()}"


def time_ms(fn, reps=REPS):
    """Median CUDA-event time of one call, after two warm-up calls."""
    from hotformerloc_torch.utils.profiling import time_fn
    return time_fn(fn, iters=reps, warmup=2)["median_ms"]


def clouds(seed=0):
    """bench.py's synthetic batch: 16 uniform(-0.9, 0.9) clouds of 4096
    points, each twice with N(0, 0.01) noise (pairs 2i, 2i+1)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.9, 0.9, (BATCH // 2, 4096, 3)).astype(np.float32)
    pts = np.repeat(base, 2, axis=0)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
    return pts


def surface_clouds(seed=2, normals=False):
    """A surface-like batch of BATCH clouds, for information beside the
    uniform one; with ``normals`` (points, normals)."""
    from hotformerloc_torch.tools.graph_check import surface_cloud

    rng = np.random.default_rng(seed)
    clouds_ = [surface_cloud(rng, normals=normals) for _ in range(BATCH)]
    if normals:
        return tuple(np.stack(a) for a in zip(*clouds_))
    return np.stack(clouds_)


def taps_per_node(plan, d):
    """(valid taps, valid taps per valid node) of depth d's table."""
    neigh = plan.neighs[plan.octree.level(d)]
    taps = int((neigh >= 0).sum())
    return taps, taps / max(1, int(plan.octree.node_valid(d).sum()))


def dense_library(plan, d, x, w, out, dt):
    """K3's library yardstick at a depth the JAX package runs on a dense
    voxel grid: cuDNN's grouped conv3d (ops/conv.octree_dwconv_dense's
    one call) on the dense (B, C, D, D, D) grid of the same inputs, timed
    alone (CUDA events; the gathers in and out of the grid not counted);
    and the whole dense-grid function's distance from K3's output ``out``
    (recorded, not asserted: cuDNN is no kernel of the port)."""
    import torch
    import torch.nn.functional as F

    from hotformerloc_torch.ops import conv as plain
    oc = plan.octree
    B, N, C = x.shape
    D = 2 ** d
    vox = plain.dense_voxel_index(oc.key(d), oc.count(d), d)
    grid = plain._gather_rows(x, vox).reshape(B, D, D, D, C).permute(
        0, 4, 1, 2, 3)
    wk = w.t().reshape(C, 1, 3, 3, 3).to(x.dtype)
    ms = time_ms(lambda: F.conv3d(grid, wk, padding=1, groups=C))
    full = plain.octree_dwconv_dense(x, oc.xyz(d), oc.node_valid(d), w, d,
                                     vox)
    err = float((full.float() - out.float()).abs().max())
    del grid, full
    torch.cuda.empty_cache()
    return {f"library_ms_{dt}": ms, f"library_err_{dt}": err,
            "library": f"F.conv3d(groups=C) on the dense {D}^3 grid"}


def f1_phase(torch, dev):
    """The stem's C = 3 -> 32 conv on the CUDA-core body (K5's body for
    every C = 3 and fp32 call) with more than 65535 x 64 rows: 1040
    clouds at depth-9 capacity 4096, on a synthetic neighbour table (a
    third of the taps missing). Held against the plain version on a fixed
    sample of rows, the last tiles included, at fp32 and bf16."""
    from hotformerloc_torch.ops import conv as plain
    from hotformerloc_torch.ops.kernels import octree_conv as kconv
    B, N, C, O = 1040, 4096, 3, 32
    R = B * N
    if (R + 63) // 64 <= 65535:
        raise AssertionError("F1 case is below the old grid cap")
    g = torch.Generator(device=dev).manual_seed(5)
    neigh = torch.randint(-N // 2, N, (B, N, 27), generator=g, device=dev,
                          dtype=torch.int32).clamp_(min=-1)
    x32 = torch.randn(B, N, C, generator=g, device=dev)
    w32 = torch.randn(27, C, O, generator=g, device=dev) * (27 * C) ** -0.5
    b32 = torch.randn(O, generator=g, device=dev) * 0.1
    rows = torch.cat([torch.randint(0, R, (4032,), generator=g, device=dev),
                      torch.arange(R - 64, R, device=dev)])
    nb = neigh.reshape(R, 27)[rows]
    base = (rows // N * N).to(torch.int32)[:, None]
    nb_g = torch.where(nb >= 0, nb + base, nb)[None]      # (1, S, 27)
    out = {"rows": R, "node_tiles": (R + 63) // 64, "sample_rows":
           int(rows.numel())}
    for dt, tdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        x, w, b = x32.to(tdt), w32.to(tdt), b32.to(tdt)
        y = kconv.launch_conv(x, neigh, w, b, body="cc")
        torch.cuda.synchronize()
        got = y.reshape(R, O)[rows]
        ref = plain.octree_conv(x.reshape(1, R, C), nb_g, w, b)[0]
        err = float((got.float() - ref.float()).abs().max())
        scale = max(1.0, float(ref.float().abs().max()))
        lim = (TOL["fp32"]["octree_conv"] if dt == "fp32"
               else TOL["bf16_rel"] * scale)
        if not (err <= lim and torch.isfinite(got.float()).all()):
            raise AssertionError(f"F1 conv {dt}: max |kernel - plain| = "
                                 f"{err} > {lim}")
        out[f"err_{dt}"] = err
        out[f"ms_{dt}"] = time_ms(
            lambda: kconv.launch_conv(x, neigh, w, b, body="cc"), reps=3)
        del y
    del neigh
    torch.cuda.empty_cache()
    return out


def compare(out, ref, kernel, dt):
    """Max |kernel - plain| of a forward output, checked against TOL."""
    import torch
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    lim = (TOL["fp32"][kernel] if dt == "fp32"
           else TOL["bf16_rel"] * max(1.0, scale))
    if not (err <= lim and torch.isfinite(out.float()).all()):
        raise AssertionError(f"{kernel} {dt}: max |kernel - plain| = "
                             f"{err} > {lim}")
    return err


def check_bwd(outs, refs, kinds, kernel, dt):
    """Largest max |kernel - plain| over a backward's outputs (None refs
    skipped), each checked against TOL_BWD relative to max(1, max
    |plain|)."""
    import torch
    errs = []
    for o, r, kind in zip(outs, refs, kinds):
        if r is None:
            continue
        err = float((o.float() - r.float()).abs().max())
        lim = TOL_BWD[dt][kind] * max(1.0, float(r.float().abs().max()))
        if not (err <= lim and torch.isfinite(o.float()).all()):
            raise AssertionError(f"{kernel} {dt}: max |kernel - plain| "
                                 f"= {err} > {lim}")
        errs.append(err)
    return max(errs)


def attn_windows(cfg, plan, d, D, G):
    """The K1/K2 inputs of one attention site from the plan: window node
    coords (BW, 3, K) int32, the key mask (BW, T) int32 (G relay slots
    ahead of the nodes, slot g valid when the window's g-th chunk of K / G
    nodes holds one) and pos_bnd."""
    import torch

    from hotformerloc_torch.models.layers import rpe_pos_bnd
    from hotformerloc_torch.ops import window as ow
    ctx = plan.level_ctx(d)
    K = cfg.patch_size
    xyz_w = ow.data_to_windows(ctx.xyz, K, D)             # (B, W, K, 3)
    BW = xyz_w.shape[0] * xyz_w.shape[1]
    xyz = xyz_w.permute(0, 1, 3, 2).reshape(BW, 3, K).to(
        torch.int32).contiguous()
    nmask = ow.window_key_mask(ctx.node_valid, K, D)
    # relay slot g is valid when its chunk of K / G window nodes holds one
    kmask = torch.cat([nmask.reshape(*nmask.shape[:2], G, K // G).any(-1),
                       nmask], -1) if G else nmask
    mask = kmask.reshape(BW, K + G).to(torch.int32).contiguous()
    return xyz, mask, rpe_pos_bnd(K, D)


def attn_fwd_rows(dev, name, cfg, plan, cases, rnd, bound):
    """K1 at every window_attn case of ``cases`` on the plan's windows:
    kernel vs plain version at fp32 and bf16, the CUDA-core body on the
    same inputs where attn_body picks the tensor-core one, and CUDA-event
    times of both bodies, the plain version and SDPA with the bias and key
    mask materialised (a yardstick the package never calls)."""
    import torch
    import torch.nn.functional as F

    from hotformerloc_torch.ops.kernels import window_attn as kattn
    from hotformerloc_torch.ops.rpe import rpe_bias_reference
    rows = []
    for label, d, C, H, D, G, per_fwd in cases:
        xyz, mask, bnd = attn_windows(cfg, plan, d, D, G)
        BW, T = mask.shape
        table = rnd(3 * (2 * bnd + 1), H, scale=0.5).float()
        qkv32 = [rnd(BW, T, C) for _ in range(3)]
        row = {"case": label, "shape": [BW, T, C], "heads": H, "bnd": bnd,
               "per_forward": per_fwd}
        for dt, tdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v = (t.to(tdt) for t in qkv32)
            args = (q, k, v, xyz, mask, table, H, bnd)
            row[f"body_{dt}"] = kattn.attn_body(tdt, T, C, H, bnd)
            out = kattn.window_attention(*args)
            ref = kattn.window_attention_reference(*args)
            row[f"err_{dt}"] = compare(out, ref, "window_attn", dt)
            row[f"ms_{dt}"] = time_ms(lambda: kattn.window_attention(*args))
            if row[f"body_{dt}"] == "tc":
                # the CUDA-core body on the same inputs: before / after
                cc = kattn.launch_fwd(*args, body="cc")
                row[f"cc_err_{dt}"] = compare(cc, ref, "window_attn", dt)
                row[f"cc_ms_{dt}"] = time_ms(
                    lambda: kattn.launch_fwd(*args, body="cc"))
            row[f"plain_ms_{dt}"] = time_ms(
                lambda: kattn.window_attention_reference(*args))
            # yardstick: SDPA with the bias and key mask materialised
            hd = C // H
            qh, kh, vh = (t.reshape(BW, T, H, hd).transpose(1, 2)
                          for t in (q, k, v))
            bias = torch.zeros(BW, H, T, T, device=dev)
            xyz_f = xyz.transpose(1, 2)[None]
            bias[:, :, G:, G:] = rpe_bias_reference(table.t(), xyz_f,
                                                    bnd)[0]
            bias = bias + torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
            bias = bias.to(tdt)
            row[f"library_ms_{dt}"] = time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       attn_mask=bias))
            esz = q.element_size()
            nbytes = (4 * BW * T * C * esz + xyz.numel() * 4
                      + mask.numel() * 4 + table.numel() * 4)
            flops = 4 * BW * T * T * C
            row[f"bound_ms_{dt}"], row[f"bound_by_{dt}"] = bound(
                nbytes, flops, dt)
            del bias
        rows.append(row)
        emit({"phase": "kernel", "kernel": "window_attn", "config": name,
              **row})
    return rows


def attn_bwd_rows(dev, name, cfg, plan, cases, rnd, bound):
    """K2 at every window_attn case of ``cases`` (microbatch plan):
    kernel vs plain at fp32 and bf16, CUDA-event times of the kernel,
    without the table gradient (nodtab_ms), of the CUDA-core body where
    the tensor-core one runs, of the plain version and of SDPA forward +
    backward with a materialised bias that requires grad (a yardstick
    that stops at dbias and does not fold it into the table)."""
    import torch
    import torch.nn.functional as F

    from hotformerloc_torch.ops.kernels import window_attn as kattn
    from hotformerloc_torch.ops.rpe import rpe_bias_reference
    rows = []
    for label, d, C, H, D, G, per_fwd in cases:
        xyz, mask, bnd = attn_windows(cfg, plan, d, D, G)
        BW, T = mask.shape
        table = rnd(3 * (2 * bnd + 1), H, scale=0.5).float()
        t32 = [rnd(BW, T, C) for _ in range(4)]          # q, k, v, g
        row = {"case": label, "shape": [BW, T, C], "heads": H, "bnd": bnd,
               "per_step": per_fwd * ACCUM}
        # the tensor-core plan as the launchers make it, which attn_body's
        # shared-memory figure must equal
        plan_tc = kattn.tc_plan(T, C, H, bnd, T - G)
        if kattn.launcher_tc_plan(T, C, H, bnd, T - G) != plan_tc:
            raise AssertionError(f"{label}: tc_plan {plan_tc} != the "
                                 "launchers' plan")
        row.update(zip(("heads_per_round", "tc_smem_fwd", "tc_smem_bwd"),
                       plan_tc))
        hd = C // H
        for dt, tdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            q, k, v, g = (t.to(tdt) for t in t32)
            args = (q, k, v, xyz, mask, table, g, H, bnd)
            row[f"body_{dt}"] = kattn.attn_body(tdt, T, C, H, bnd)
            out = kattn.window_attention_bwd(*args)
            ref = kattn.window_attention_bwd_reference(*args)
            kinds = ("act",) * 3 + ("weight",)
            row[f"err_{dt}"] = check_bwd(out, ref, kinds, "window_attn_bwd",
                                         dt)
            row[f"ms_{dt}"] = time_ms(
                lambda: kattn.window_attention_bwd(*args))
            # without the table gradient: the histogram's share
            row[f"nodtab_ms_{dt}"] = time_ms(
                lambda: kattn.window_attention_bwd(*args, need_dtable=False))
            if row[f"body_{dt}"] == "tc":
                # the CUDA-core body on the same inputs: before / after
                cc = kattn.window_attention_bwd(*args, body="cc")
                row[f"cc_err_{dt}"] = check_bwd(cc, ref, kinds,
                                                "window_attn_bwd (cc)", dt)
                row[f"cc_ms_{dt}"] = time_ms(
                    lambda: kattn.window_attention_bwd(*args, body="cc"))
                del cc
            row[f"plain_ms_{dt}"] = time_ms(
                lambda: kattn.window_attention_bwd_reference(*args))
            qh, kh, vh = (t.reshape(BW, T, H, hd).transpose(1, 2).detach()
                          .requires_grad_() for t in (q, k, v))
            gh = g.reshape(BW, T, H, hd).transpose(1, 2)
            bias = torch.zeros(BW, H, T, T, device=dev)
            bias[:, :, G:, G:] = rpe_bias_reference(
                table.t(), xyz.transpose(1, 2)[None], bnd)[0]
            bias = bias + torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
            bias = bias.to(tdt).requires_grad_()

            def lib():
                o = F.scaled_dot_product_attention(qh, kh, vh,
                                                   attn_mask=bias)
                return torch.autograd.grad(o, (qh, kh, vh, bias), gh)
            row[f"library_ms_{dt}"] = time_ms(lib)
            esz = q.element_size()
            nbytes = (7 * BW * T * C * esz + xyz.numel() * 4
                      + mask.numel() * 4 + 2 * table.numel() * 4)
            row[f"bound_ms_{dt}"], row[f"bound_by_{dt}"] = bound(
                nbytes, 10 * BW * T * T * C, dt)
            del bias, qh, kh, vh, out, ref
        rows.append(row)
        emit({"phase": "kernel_bwd", "kernel": "window_attn_bwd",
              "config": name, **row})
    return rows


def serve_check(torch, cfg, pts, pmask, cases, per_forward, spts=None,
                normals=None):
    """The serving slice of ``cfg`` with seeded random weights: embed the
    batch through make_embed_fn in bf16 and fp32 and on the plain path at
    fp32. The launch counters, zeroed just before the bf16 run and read
    just after, must show the shape table's launches per forward (which
    must equal ``per_forward``), every K1 launch and every K5 launch that
    conv_body assigns to it on the tensor-core bodies (none at fp32), and
    no call of F.conv3d; descriptors must be finite and unit-norm; the
    fp32 kernel descriptors
    must match the plain path (cos >= 0.9999, max abs <= 1e-4). Retrieval
    recall@1 of the noisy copies against the originals is printed for
    information (the weights are random), with bf16 ms per batch (median
    of 5) and submaps/s. The batch must not overflow the octree. With
    ``spts`` the same checks and timing on that batch too (surf_*; its
    overflow, the same on every path, is printed). The serving default,
    graphed, on the first batch: its three calls must launch a forward's
    kernels (eager), a forward's (the capture) and none (the replay), and
    the replay must give the eager bf16 descriptors bit for bit. ``normals``: the
    batch's per-point normals, for the 'N' input feature. Returns
    (launches per bf16 forward, numbers)."""
    from hotformerloc_torch.evaluation.embed import make_embed_fn
    from hotformerloc_torch.evaluation.evaluate import retrieval_topk
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.models.layers import rpe_pos_bnd
    from hotformerloc_torch.octree.build import build_batched_octree
    from hotformerloc_torch.ops import kernels
    from hotformerloc_torch.ops.kernels import octree_conv as kconv
    from hotformerloc_torch.ops.kernels import window_attn as kattn
    from hotformerloc_torch.ops.plan import build_plan

    want = {k: sum(c[-1] for c in cs) for k, cs in cases.items()}
    if want != per_forward:
        raise AssertionError(f"main-path shape table is off: {want}")
    not_tc = [c[0] for c in cases["window_attn"] if kattn.attn_body(
        torch.bfloat16, cfg.patch_size + c[5], c[2], c[3],
        rpe_pos_bnd(cfg.patch_size, c[4])) != "tc"]
    if not_tc:
        raise AssertionError(f"bf16 K1 would leave the tensor-core body at "
                             f"{not_tc}")
    want = {k: want.get(k, 0) for k in kernels.LAUNCHES}   # no backward
    want_fp32 = dict(want)
    want["window_attn_tc"] = want["window_attn"]
    want["octree_conv_tc"] = sum(
        c[-1] for c in cases["octree_conv"]
        if kconv.conv_body(torch.bfloat16, c[2], c[3]) == "tc")

    model = HOTFormerLoc(cfg, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    # eager: each call launches its kernels, which the counters count
    embed_bf16 = make_embed_fn(model, torch.bfloat16, graphs=False)
    embed_fp32 = make_embed_fn(model, torch.float32, graphs=False)
    plain_model = HOTFormerLoc(cfg, device="cuda",
                               generator=torch.Generator().manual_seed(0))
    plain_model.set_use_kernels(False)
    embed_plain = make_embed_fn(plain_model, torch.float32, graphs=False)
    out = {"batch": len(pts)}
    for tag, p, nrm in (("", pts, normals), ("surf_", spts, None)):
        if p is None:
            continue
        kernels.reset_launches()
        with CountConv3d() as c3, CountLayerNorms() as lns:
            out_bf16 = embed_bf16(p, pmask, nrm)
            torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        if c3.calls:
            raise AssertionError(f"the bf16 embed called F.conv3d "
                                 f"{c3.calls} times: a CPE left K3")
        if launches != dict(want, layer_norm=lns.calls) or not lns.calls:
            raise AssertionError(f"launches {launches} != expected {want} "
                                 f"and {lns.calls} LayerNorms")
        if not tag:
            # the serving default, as the serve cells run it: an eager
            # call, the capture (its launches recorded), then a replay
            # that launches nothing from the host
            embed_graph = make_embed_fn(model, torch.bfloat16)
            steps = []
            for _ in range(3):
                kernels.reset_launches()
                out_graph = embed_graph(p, pmask, nrm)
                steps.append(dict(kernels.LAUNCHES))
            torch.cuda.synchronize()
            none = dict.fromkeys(launches, 0)
            if steps != [launches, launches, none]:
                raise AssertionError(f"graphed calls launched {steps}, not "
                                     "a forward's, a forward's, none")
            if not torch.equal(out_graph["global"], out_bf16["global"]):
                raise AssertionError("the replayed bf16 descriptors differ "
                                     "from the eager ones")
            out["graph_launches_per_call"] = [sum(x.values()) for x in steps]
            del embed_graph
        kernels.reset_launches()
        with CountLayerNorms() as lns:
            out_fp32 = embed_fp32(p, pmask, nrm)
        if dict(kernels.LAUNCHES) != dict(want_fp32, layer_norm=lns.calls):
            raise AssertionError(f"fp32 launches {kernels.LAUNCHES}")
        kernels.reset_launches()
        out_plain = embed_plain(p, pmask, nrm)
        if any(kernels.LAUNCHES.values()):
            raise AssertionError(f"plain path launched {kernels.LAUNCHES}")
        overflow = {int(o["octree_overflow"]) for o in
                    (out_bf16, out_fp32, out_plain)}
        if len(overflow) != 1 or (not tag and overflow != {0}):
            raise AssertionError(f"{tag}octree overflow {overflow} (the "
                                 "batch must fit, the surface-like one "
                                 "alike on every path)")
        for dt, o in (("bf16", out_bf16), ("fp32", out_fp32),
                      ("plain_fp32", out_plain)):
            gdesc = o["global"]
            if gdesc.shape != (len(p), cfg.output_dim):
                raise AssertionError(f"{tag}{dt}: descriptor shape "
                                     f"{gdesc.shape}")
            if not torch.isfinite(gdesc).all():
                raise AssertionError(f"{tag}{dt}: non-finite descriptors")
            norm_err = float((gdesc.norm(dim=1) - 1).abs().max())
            if norm_err > 1e-4:
                raise AssertionError(f"{tag}{dt}: descriptors not unit norm "
                                     f"({norm_err})")
            if set(o) != {"global", "octree_overflow"}:
                raise AssertionError(f"{tag}{dt}: outputs {sorted(o)}")
        gk, gp = out_fp32["global"], out_plain["global"]
        cos = float((gk * gp).sum(1).min())
        maxabs = float((gk - gp).abs().max())
        if not (cos >= 0.9999 and maxabs <= 1e-4):
            raise AssertionError(f"{tag}fp32 kernel vs plain descriptors: "
                                 f"cos {cos}, max abs {maxabs}")
        desc = out_bf16["global"].cpu().numpy()
        _, idx = retrieval_topk(desc[1::2], desc[0::2], k=1)

        def run():
            embed_bf16(p, pmask, nrm)
            torch.cuda.synchronize()

        run()
        host_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(host_ms)
        out.update({
            f"{tag}octree_overflow": overflow.pop(),
            f"{tag}fp32_kernel_vs_plain_min_cos": cos,
            f"{tag}fp32_kernel_vs_plain_max_abs": maxabs,
            f"{tag}bf16_vs_fp32_plain_min_cos": float(
                (out_bf16["global"] * gp).sum(1).min()),
            f"{tag}recall_at_1_random_weights": float(
                np.mean(idx[:, 0] == np.arange(len(p) // 2))),
            f"{tag}embed_bf16_ms_per_batch": ms,
            f"{tag}embed_bf16_ms_all": host_ms,
            f"{tag}submaps_per_s_bf16": len(p) / (ms / 1e3)})
        if not tag:
            out["launches_per_forward"] = launches

    def octree_and_plan():           # as the serving forward builds it
        with torch.inference_mode():
            oc = build_batched_octree(pts, pmask, cfg.octree_depth,
                                      cfg.min_depth, cfg.resolve_capacities(),
                                      normals=normals)
            build_plan(oc, tap_lists=False)
        torch.cuda.synchronize()

    octree_and_plan()
    plan_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        octree_and_plan()
        plan_ms.append((time.perf_counter() - t0) * 1e3)
    out.update(octree_plan_ms=statistics.median(plan_ms),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del model, plain_model, embed_bf16, embed_fp32, embed_plain
    torch.cuda.empty_cache()
    return out["launches_per_forward"], out


def spans_phase(torch, cfg, pts, pmask):
    """The slice's bf16 embed (seeded random weights) under torch.profiler
    once with the program's spans on and once with them off (``annotate``
    shown a profiler flag that reads off). With them on, no device event
    may be a user annotation (the range kineto draws on a stream for a
    ``record_function``, which a trace reader would count as device
    work); both must launch the same number of kernels; the ``hfl.*``
    spans must take >= 99% of the kernel time; no LayerNorm may run
    aten's kernel (vectorized_layer_norm). Returns the numbers."""
    import types

    from torch.profiler import ProfilerActivity, profile

    from hotformerloc_torch.evaluation.embed import make_embed_fn
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.utils import profiling

    model = HOTFormerLoc(cfg, device="cuda",
                         generator=torch.Generator().manual_seed(0))
    embed = make_embed_fn(model, torch.bfloat16, graphs=False)   # spans

    def records(spans_on):
        real = profiling._autograd_profiler
        if not spans_on:
            profiling._autograd_profiler = types.SimpleNamespace(
                _is_profiler_enabled=False)
        try:
            for _ in range(3):     # a window may come back without events
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    embed(pts, pmask)
                    torch.cuda.synchronize()
                rec = profiling.trace_records(prof)
                if rec[0]:
                    return rec
        finally:
            profiling._autograd_profiler = real
        raise AssertionError("torch.profiler recorded no device event")

    embed(pts, pmask)
    on, off = records(True), records(False)
    del model, embed
    torch.cuda.empty_cache()
    annotations = sorted({d[3] for d in on[0]
                          if d[4] == "gpu_user_annotation"})
    if annotations:
        raise AssertionError(f"spans drew device ranges: {annotations}")
    aten_ln = sorted({d[3] for d in on[0]
                      if "vectorized_layer_norm" in d[3]})
    if aten_ln:
        raise AssertionError(f"aten's LayerNorm ran: {aten_ln}")
    if off[2]:
        raise AssertionError(f"{len(off[2])} spans with the spans off")
    kernels = [sum(d[4] == "kernel" for d in r[0]) for r in (on, off)]
    if kernels[0] != kernels[1]:
        raise AssertionError(f"kernels with spans {kernels[0]}, "
                             f"without {kernels[1]}")
    by_span = profiling.attribute(
        [d for d in on[0] if d[4] == "kernel"], on[1], on[2])
    share = 1.0 - by_span["span_s"].get("unattributed", 0.0) / \
        by_span["device_s"]
    if share < 0.99:
        raise AssertionError(f"spans hold {100 * share:.2f}% of the kernel "
                             f"time: {by_span['span_s']}")
    return {"batch": len(pts), "traced_kernels": kernels[0],
            "span_kernel_share": share,
            "kernel_s_by_span": by_span["span_s"]}


class CountLayerNorms:
    """Counts the LayerNorm module calls inside the block that take the
    kernel (``use_kernels`` on, a CUDA input): each launches
    layer_norm_rows_kernel once."""

    def __enter__(self):
        from hotformerloc_torch.models.layers import LayerNorm
        self.cls, self.real, self.calls = LayerNorm, LayerNorm.forward, 0

        def counting(mod, x, valid=None):
            self.calls += bool(mod.use_kernels and x.is_cuda)
            return self.real(mod, x, valid)
        LayerNorm.forward = counting
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.real


class CountConv3d:
    """Counts calls of torch.nn.functional.conv3d inside the block (the
    dense-grid CPE's only cuDNN call): the main path must make none."""

    def __enter__(self):
        import torch.nn.functional as F
        self.F, self.real, self.calls = F, F.conv3d, 0

        def counting(*a, **k):
            self.calls += 1
            return self.real(*a, **k)
        F.conv3d = counting
        return self

    def __exit__(self, *exc):
        self.F.conv3d = self.real


def path_cases(cfg):
    """Every kernel shape of one forward of ``cfg``, with its launches
    per forward: window_attn (label, depth, C, H, dilation, G, n),
    octree_dwconv (label, depth, C, n), octree_conv (label, depth, C, O,
    n). The stem's first conv (C = the input features) needs no dx. With
    ``octf_use_rt`` the OctFormer blocks are H-OSA blocks (G = rt_size,
    dilation 1); with ``disable_rt`` the pyramid levels run dilated
    OctFormer blocks; with ``xcpe`` every CPE is a full conv (K5);
    without ``downsample_input_embeddings`` the stem is num_down convs at
    the octree depth."""
    from hotformerloc_torch.models.hotformerloc import feature_channels
    nb_octf, nb_hotf = cfg.num_blocks[0], cfg.num_blocks[-1]
    octf_c, octf_h = cfg.channels[0], cfg.num_heads[0]
    _, pyr_c = cfg.stage_channels()
    _, pyr_h = cfg.stage_heads()
    td, G, D = cfg.transformer_depth, cfg.rt_size, cfg.dilation
    if cfg.octf_use_rt:
        attn = [(f"octf_rt{G}", td, octf_c, octf_h, 1, G, nb_octf)]
    else:
        attn = [("octf_dil1", td, octf_c, octf_h, 1, 0, (nb_octf + 1) // 2),
                ("octf_dil%d" % D, td, octf_c, octf_h, D, 0, nb_octf // 2)]
    for j, d in enumerate(cfg.pyramid_depths):
        if cfg.disable_rt:
            attn += [(f"octf_l{j}_d{d}_dil1", d, pyr_c[j], pyr_h[j], 1, 0,
                      (nb_hotf + 1) // 2),
                     (f"octf_l{j}_d{d}_dil{D}", d, pyr_c[j], pyr_h[j], D, 0,
                      nb_hotf // 2)]
        else:
            attn.append((f"hosa_d{d}" + (f"_rt{G}" if G > 1 else ""), d,
                         pyr_c[j], pyr_h[j], 1, G, nb_hotf))
    cpe = [(f"cpe_d{td}", td, octf_c, nb_octf)]
    cpe += [(f"cpe_d{d}", d, pyr_c[j], nb_hotf)
            for j, d in enumerate(cfg.pyramid_depths)]
    if cfg.adape_mode is None and not cfg.disable_rt:
        cpe += [(f"rt_init_cpe_d{d}", d, pyr_c[j], 1)       # the relay-token
                for j, d in enumerate(cfg.pyramid_depths)]  # init's CPE
    dw, conv = [], []
    if cfg.xcpe:
        conv += [(f"x{lab}", d, C, C, n) for lab, d, C, n in cpe]
    else:
        dw = cpe
    cin, od = feature_channels(cfg.input_features), cfg.octree_depth
    if not cfg.downsample_input_embeddings:
        stem = [(f"stem_conv{i}_d{od}", od, cin if i == 0 else octf_c,
                 octf_c, 1) for i in range(cfg.stem_down)]
    else:
        chans = [int(octf_c * 2**i) for i in range(-cfg.stem_down, 1)]
        stem = [(f"stem_conv{i}_d{od - i}", od - i,
                 cin if i == 0 else chans[i], chans[i], 1)
                for i in range(cfg.stem_down)]
        stem.append((f"stem_proj_d{td}", td, chans[-1], chans[-1], 1))
    return {"window_attn": attn, "octree_dwconv": dw,
            "octree_conv": stem + conv}


def bwd_kernel_phase(torch, dev, cfg, pts, spts, pmask, cases, bound, rnd,
                     device_jobs):
    """K2, K4, K6 against their plain versions and timed, at every shape
    of the train path (microbatch ``pts``; K4 and K6 also on the
    surface-like microbatch ``spts``); rows per kernel name. K4's and K6's
    device-time calls are appended to ``device_jobs``."""
    from hotformerloc_torch.models.hotformerloc import build_model_plan
    from hotformerloc_torch.ops import conv as plain
    from hotformerloc_torch.ops.kernels import octree_conv as kconv

    plan = build_model_plan(cfg, pts, pmask)
    splan = build_model_plan(cfg, spts, pmask)
    octree = plan.octree
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    rows = {"window_attn_bwd": attn_bwd_rows(dev, "oxford_config", cfg, plan,
                                             cases["window_attn"], rnd,
                                             bound),
            "octree_dwconv_bwd": [], "octree_conv_bwd": []}

    plans = (("", plan), ("surf_", splan))
    for label, d, C, per_fwd in cases["octree_dwconv"]:
        N = plan.neighs[octree.level(d)].shape[1]
        x32, dy32 = rnd(MICRO, N, C), rnd(MICRO, N, C)
        w32 = rnd(27, C, scale=(27 * C) ** -0.5)
        row = {"case": label, "per_step": per_fwd * ACCUM}
        # the uniform microbatch (the main path's), then the surface-like
        for tag, pl in plans:
            lev = pl.octree.level(d)
            neigh, tl = pl.neighs[lev], pl.taps[lev]
            B, N, _ = neigh.shape
            taps, per_node = taps_per_node(pl, d)
            row.update({f"{tag}shape": [B, N, C], f"{tag}valid_taps": taps,
                        f"{tag}valid_taps_per_node": per_node})
            for dt, tdt in dtypes.items():
                x, w, dy = x32.to(tdt), w32.to(tdt), dy32.to(tdt)

                def k4(x=x, neigh=neigh, w=w, dy=dy, tl=tl):
                    return kconv.octree_dwconv_bwd(x, neigh, w, dy, taps=tl)
                ref = plain.octree_dwconv_bwd(x, neigh, w, dy)
                row[f"{tag}err_{dt}"] = check_bwd(k4(), ref, ("act", "weight"),
                                                  "octree_dwconv_bwd", dt)
                row[f"{tag}ms_{dt}"] = time_ms(k4)
                if dt == "bf16" and not tag:       # device time, taken last
                    device_jobs.append((row, "device_ms_bf16", k4))
                esz = x.element_size()
                nbytes = (3 * B * N * C * esz + neigh.numel() * 4
                          + 27 * C * (esz + 4))
                row[f"{tag}bound_ms_{dt}"], row[f"{tag}bound_by_{dt}"] = \
                    bound(nbytes, 4 * taps * C, dt)
                if not tag:
                    row[f"plain_ms_{dt}"] = time_ms(
                        lambda: plain.octree_dwconv_bwd(x, neigh, w, dy))
                    row[f"library_ms_{dt}"] = None
        rows["octree_dwconv_bwd"].append(row)
        emit({"phase": "kernel_bwd", "kernel": "octree_dwconv_bwd", **row})

    for label, d, C, O, per_fwd in cases["octree_conv"]:
        N = plan.neighs[octree.level(d)].shape[1]
        need_dx = d != cfg.octree_depth      # input features need no dx
        x32, dy32 = rnd(MICRO, N, C), rnd(MICRO, N, O)
        w32 = rnd(27, C, O, scale=(27 * C) ** -0.5)
        row = {"case": label, "dx": need_dx, "per_step": per_fwd * ACCUM}
        for tag, pl in plans:
            lev = pl.octree.level(d)
            neigh, tl = pl.neighs[lev], pl.taps[lev]
            B, N, _ = neigh.shape
            taps, per_node = taps_per_node(pl, d)
            row.update({f"{tag}shape": [B, N, C, O], f"{tag}valid_taps": taps,
                        f"{tag}valid_taps_per_node": per_node})
            for dt, tdt in dtypes.items():
                x, w, dy = x32.to(tdt), w32.to(tdt), dy32.to(tdt)
                args = (x, neigh, w, dy, need_dx)
                body = kconv.conv_body(tdt, C, O)
                row[f"{tag}body_{dt}"] = body

                def k6(body=None, args=args, tl=tl):
                    return kconv.octree_conv_bwd(*args, taps=tl, body=body)
                ref = plain.octree_conv_bwd(*args)
                kinds = ("act", "weight", "weight")
                row[f"{tag}err_{dt}"] = check_bwd(k6(), ref, kinds,
                                                  "octree_conv_bwd", dt)
                row[f"{tag}ms_{dt}"] = time_ms(k6)
                row[f"{tag}cc_ms_{dt}"] = row[f"{tag}ms_{dt}"]
                if body == "tc":
                    # the CUDA-core bodies on the same inputs: before / after
                    row[f"{tag}cc_err_{dt}"] = check_bwd(
                        k6("cc"), ref, kinds, "octree_conv_bwd (cc)", dt)
                    row[f"{tag}cc_ms_{dt}"] = time_ms(lambda: k6("cc"))
                if dt == "bf16" and not tag:       # device times, taken last
                    device_jobs.append((row, "device_ms_bf16", k6))
                    device_jobs.append((row, "cc_device_ms_bf16", (
                        lambda k6=k6: k6("cc")) if body == "tc" else None))
                esz = x.element_size()
                nbytes = (B * N * (C * (2 if need_dx else 1) + O) * esz
                          + neigh.numel() * 4 + 27 * C * O * (esz + 4)
                          + O * 4)
                row[f"{tag}bound_ms_{dt}"], row[f"{tag}bound_by_{dt}"] = \
                    bound(nbytes, (4 if need_dx else 2) * taps * C * O, dt)
                if not tag:
                    row[f"plain_ms_{dt}"] = time_ms(
                        lambda: plain.octree_conv_bwd(*args))
                    row[f"library_ms_{dt}"] = None
        rows["octree_conv_bwd"].append(row)
        emit({"phase": "kernel_bwd", "kernel": "octree_conv_bwd", **row})
    torch.cuda.synchronize()
    return rows


# launches of one bf16 train step of batch 32 (4 microbatches of 8) at
# Oxford and CS-Wild-Places: K1/K3 34 and K5 3 per forward, twice per
# microbatch (stages 1 and 3), their backward once
STEP_LAUNCHES = {"window_attn": 272, "octree_dwconv": 272, "octree_conv": 24,
                 "window_attn_bwd": 136, "octree_dwconv_bwd": 136,
                 "octree_conv_bwd": 12}


def pair_batch(torch, dev, pts, pmask, B):
    """The first B clouds as a train batch of positive pairs (clouds 2i
    and 2i + 1, noisy copies of one cloud)."""
    groups = np.repeat(np.arange(B // 2), 2)
    same = groups[:, None] == groups[None]
    return {"points": pts[:B], "pmask": pmask[:B],
            "positives_mask": torch.from_numpy(
                same & ~np.eye(B, dtype=bool)).to(dev),
            "negatives_mask": torch.from_numpy(~same).to(dev)}


def scatter_phase(torch, dev, cfg, pts, pmask):
    """The train phase's bf16 step (batch 32 as 4 microbatches of 8,
    Adam, no checkpointing), after two warm-up steps, once under
    torch.profiler: the device ms of the gather/scatter/index kernel
    class (tools/profile_step.py ``classify``), its kernels, and the op
    calls of scatter_add, index_add and gather's backward. Before the
    down-convs' scatter-free backward each differentiated gather of a
    down-conv was a gather_backward and a scatter_add (5 per microbatch
    at Oxford); one differentiated gather is left, the loss's top-k
    (once per step), so more than one gather_backward raises. Run after
    every other profiled window: a window this long, taken before the
    probe tools, left their later windows without device events. A
    window without device events is taken again, up to three in all."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from hotformerloc_torch.losses.losses import make_loss
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.tools.profile_step import classify
    from hotformerloc_torch.training.optim import (lr_schedule,
                                                   make_optimizer)
    from hotformerloc_torch.training.step import StepConfig, make_train_step
    from hotformerloc_torch.utils.profiling import device_us, device_work

    m = HOTFormerLoc(cfg, device=dev, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(m.parameters(), "adam", lr_schedule(
        5e-4, steps_per_epoch=100, epochs=150, warmup_epochs=5,
        milestones=[100]), weight_decay=1e-4)
    step = make_train_step(m, opt, make_loss(
        "truncatedsmoothap", positives_per_query=4),
        StepConfig(accum_steps=ACCUM))
    batch = pair_batch(torch, dev, pts, pmask, BATCH)
    for i in range(2):
        step(batch, i)
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(batch, 2 + attempt)
            torch.cuda.synchronize()
        dev_events = [e for e in prof.key_averages() if device_work(e)]
        if sum(device_us(e) for e in dev_events) > 0:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device time")
    ops = collections.Counter(
        e.name for e in prof.events()
        if e.name in ("aten::scatter_add_", "aten::scatter_add",
                      "aten::index_add_", "aten::index_add",
                      "aten::gather_backward"))
    cls = [e for e in dev_events
           if classify(e.key) == "gather/scatter/index"]
    out = {"windows": attempt + 1,
           "gather_scatter_class_device_ms": sum(device_us(e) for e in cls)
           / 1e3,
           "gather_scatter_class_kernels": {e.key[:90]: e.count for e in cls},
           "op_calls": dict(ops)}
    del m, opt, step
    torch.cuda.empty_cache()
    if ops["aten::gather_backward"] > 1:
        raise AssertionError(f"the step differentiates "
                             f"{ops['aten::gather_backward']} gathers: a "
                             "down-conv left its scatter-free backward")
    return out


def bn_shift_params(model):
    """Names of the parameters that only shift a MaskedBatchNorm's input
    by a constant per channel (the bias of its conv, and of an xCPE's
    conv and Linear): the batch mean removes the shift, so in train mode
    their gradient is 0."""
    from hotformerloc_torch.models.layers import CPE, MaskedBatchNorm
    names = set()
    for name, mod in model.named_modules():
        if not isinstance(getattr(mod, "norm", None), MaskedBatchNorm):
            continue
        if isinstance(mod, CPE) and mod.xcpe:
            names.add(f"{name}.linear.bias")
        if hasattr(mod, "bias"):             # not a depthwise CPE's
            names.add(f"{name}.bias")
    return names


def _worst(got, want, floor=1.0):
    """max over tensors of max |got - want| / max(floor, max |want|)."""
    return max(float((got[k].float() - w.float()).abs().max())
               / max(floor, float(w.float().abs().max()))
               for k, w in want.items())


def running_stats_checks(torch, dev, cfg, batch, bufs, make, remat_check):
    """The running statistics after train_phase's fp32 step (``bufs``:
    buffers by path): kernel vs plain; against stage 1's last microbatch
    applied once to the initial state; under checkpointing."""
    from hotformerloc_torch.models.hotformerloc import build_model_plan
    from hotformerloc_torch.training.step import drop_generator
    out = {"running_stat_buffers": len(bufs["kernel"])}
    err = _worst(bufs["kernel"], bufs["plain"])
    if not err <= 1e-5:
        raise AssertionError(f"running stats, kernel vs plain path: {err}")
    out["running_stats_kernel_vs_plain"] = err
    m, _ = make(torch.float32, True, cfg, True)
    sl = slice((ACCUM - 1) * MICRO, ACCUM * MICRO)
    nrm = batch.get("normals")
    g = drop_generator(0, ACCUM - 1)         # the step's draws (seed 0)
    masks = m.draw_drop_masks(MICRO, g)
    dseed = int(torch.randint(2 ** 62, (), generator=g))
    m.train()
    with torch.no_grad():
        plan = build_model_plan(cfg, batch["points"][sl], batch["pmask"][sl],
                                normals=None if nrm is None else nrm[sl])
        m(batch["points"][sl], batch["pmask"][sl], plan=plan,
          drop_masks=masks, dropout_seed=dseed)
    m.commit_stats()
    err = _worst(dict(m.named_buffers()), bufs["kernel"])
    if not err <= 1e-6:
        raise AssertionError(f"running stats != stage 1's last microbatch "
                             f"applied once: {err}")
    out["running_stats_vs_last_microbatch"] = err
    del m
    if remat_check:
        m, step = make(torch.float32, True, dataclasses.replace(
            cfg, grad_checkpoint=True, remat_policy="save_hot"), True)
        step(batch, 0)
        err = _worst(dict(m.named_buffers()), bufs["kernel"])
        if not err <= 1e-6:
            raise AssertionError(f"running stats under checkpointing: {err}")
        out["running_stats_checkpointed_vs_not"] = err
        del m, step
    torch.cuda.empty_cache()
    return out


def train_phase(torch, dev, name, cfg, pts, pmask, cases, expect=None,
                timed=10, normals=None, fp32_cfg=None, remat_check=False):
    """The multistage train step (batch 32 as 4 microbatches of 8): fp32
    kernel vs plain gradients (of ``fp32_cfg``, ``cfg`` when None), then
    bf16 launch counts (the shape table's, which must equal ``expect``,
    STEP_LAUNCHES by default) and ``timed`` timed steps. With attention
    dropout the bf16 step's forwards take the einsum route: no K1/K2.
    A model with running statistics also has them checked after the fp32
    step: kernel path against plain path (within 1e-5 of max(1, |plain|))
    and against one train-mode forward of stage 1's last microbatch from
    the initial state, with the step's masks (within 1e-6); with
    ``remat_check`` also the step under grad_checkpoint ('save_hot')
    against the step without (within 1e-6: the recompute must not update
    them again). ``normals``: the batch's point normals. Returns
    (launches of one bf16 step, the phase's numbers)."""
    from hotformerloc_torch.losses.losses import make_loss
    from hotformerloc_torch.models.hotformerloc import (HOTFormerLoc,
                                                        build_model_plan)
    from hotformerloc_torch.models.layers import BatchNorm, LayerNorm
    from hotformerloc_torch.ops import kernels
    from hotformerloc_torch.ops.kernels import octree_conv as kconv
    from hotformerloc_torch.training.optim import (lr_schedule,
                                                   make_optimizer)
    from hotformerloc_torch.training.step import StepConfig, make_train_step

    groups = np.repeat(np.arange(BATCH // 2), 2)
    same = groups[:, None] == groups[None]
    batch = {"points": pts, "pmask": pmask,
             "positives_mask": torch.from_numpy(
                 same & ~np.eye(BATCH, dtype=bool)).to(dev),
             "negatives_mask": torch.from_numpy(~same).to(dev)}
    if normals is not None:
        batch["normals"] = normals
    fp32_cfg = fp32_cfg or cfg
    loss_fn = make_loss("truncatedsmoothap", positives_per_query=4)
    sched = lr_schedule(5e-4, steps_per_epoch=100, epochs=150,
                        warmup_epochs=5, milestones=[100])

    def make(dtype, use_kernels, cfg=cfg, two_pass=False):
        m = HOTFormerLoc(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0),
                         dtype=dtype)
        m.set_use_kernels(use_kernels)
        for mod in m.modules():       # the heads' BatchNorms, see below
            if isinstance(mod, BatchNorm):
                mod.two_pass = two_pass
            if isinstance(mod, LayerNorm):      # one LayerNorm, see below
                mod.use_kernels = True
        opt = make_optimizer(m.parameters(), "adam", sched, weight_decay=1e-4)
        return m, make_train_step(m, opt, loss_fn, StepConfig(
            accum_steps=ACCUM, check_recompute=True))

    out = {"config": name, "batch": BATCH, "accum_steps": ACCUM,
           "drop_path": cfg.drop_path, "grad_checkpoint": False}
    # fp32, TF32 off (set in main): kernel path against plain path. A
    # head's BatchNorm over the microbatch's pooled descriptors
    # (PyramidOctGeM, -gc) takes its variance in two passes here
    # (layers.py BatchNorm.two_pass, the same function): flax's
    # E[x^2] - E[x]^2 there amplifies the two paths' fp32 rounding
    # differences into the whole gradient (variant B's differed by 2.4x
    # GRAD_TOL with it, 0.08-0.24x without; H100 80GB HBM3, 700 W). Both
    # paths run the LayerNorm kernel: any LayerNorm whose fp32 rounding
    # differs from aten's moves the stem's gradients past GRAD_TOL (its
    # low-variance rows scale rounding by up to 1 / sqrt(eps)): 1.48x
    # with the kernel, 3.93x with a plain two-pass formula, against 0.10x
    # for K1-K6 with aten's LayerNorm on both paths (Oxford, same card).
    # So the bar holds K1-K6, as it did before the kernel; the kernel's
    # training path (the op's y, mean and rstd, and aten's backward on
    # them) is held against aten by tools/norm_bench.py.
    grads, bufs = {}, {}
    for tag, use_kernels in (("kernel", True), ("plain", False)):
        m, step = make(torch.float32, use_kernels, fp32_cfg, True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        stats = step(batch, 0)
        torch.cuda.synchronize()
        out[f"fp32_{tag}_step_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"fp32_{tag}_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[f"fp32_{tag}_loss"] = float(stats["loss"])
        out[f"fp32_{tag}_recompute_max_abs"] = float(
            stats["recompute_max_abs"])
        grads[tag] = {n: p.grad.detach().clone()
                      for n, p in m.named_parameters()}
        bufs[tag] = {n: b.detach().clone() for n, b in m.named_buffers()}
        zero = bn_shift_params(m)
        del m, step, stats
        torch.cuda.empty_cache()
    if bufs["kernel"]:
        out.update(running_stats_checks(torch, dev, fp32_cfg, batch, bufs,
                                        make, remat_check))
    worst, worst_name, bad = 0.0, None, []
    total = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in grads["plain"].values())))
    for n, gp in grads["plain"].items():
        gk = grads["kernel"][n]
        if n in zero:
            # 0 in exact arithmetic: both paths' values are fp32 rounding
            # of 0, which the relative bar cannot compare; each must be
            # within ZERO_GRAD_TOL of the whole gradient's norm
            lim = ZERO_GRAD_TOL * total
            d = max(float(gk.norm()), float(gp.norm()))
        else:
            d = float((gk - gp).norm())
            lim = GRAD_TOL[0] * float(gp.norm()) + GRAD_TOL[1]
        if d / lim > worst:
            worst, worst_name = d / lim, n
        if not (d <= lim and torch.isfinite(gk).all()):
            bad.append((n, d, lim))
    out["fp32_zero_grad_tensors"] = len(zero)
    if bad:
        raise AssertionError(f"fp32 kernel vs plain gradients: {len(bad)} "
                             f"tensors off, e.g. {bad[:3]}")
    if out["fp32_kernel_recompute_max_abs"] > 1e-6:
        raise AssertionError("stage-3 embeddings differ from stage 1: "
                             f"{out['fp32_kernel_recompute_max_abs']}")
    out.update(fp32_grad_tensors=len(grads["plain"]),
               fp32_grad_worst_ratio_to_limit=worst,
               fp32_grad_worst_tensor=worst_name)
    del grads
    torch.cuda.empty_cache()

    # bf16 compute on fp32 parameters, kernel path
    m, step = make(torch.bfloat16, True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with CountConv3d() as c3, CountLayerNorms() as lns:
        stats = step(batch, 0)
        torch.cuda.synchronize()
    warm = [(time.perf_counter() - t0) * 1e3]
    launches = dict(kernels.LAUNCHES)
    if c3.calls:
        raise AssertionError(f"the bf16 step called F.conv3d {c3.calls} "
                             "times: a CPE left K3/K4")
    want = {}
    for k, cs in cases.items():
        per_fwd = sum(c[-1] for c in cs)
        want[k] = per_fwd * ACCUM * 2            # stage 1 + stage 3
        want[k + "_bwd"] = per_fwd * ACCUM
    if want != (expect or STEP_LAUNCHES):
        raise AssertionError(f"train-path shape table is off: {want}")
    if cfg.attn_drop > 0:     # training takes the einsum route, as JAX's
        want.update(window_attn=0, window_attn_bwd=0)
    # every bf16 K1 / K2 launch of the step takes the tensor-core bodies,
    # and every K5 / K6 launch that conv_body assigns to them
    conv_tc = sum(c[-1] for c in cases["octree_conv"]
                  if kconv.conv_body(torch.bfloat16, c[2], c[3]) == "tc")
    want.update(window_attn_tc=want["window_attn"],
                window_attn_bwd_tc=want["window_attn_bwd"],
                octree_conv_tc=conv_tc * ACCUM * 2,
                octree_conv_bwd_tc=conv_tc * ACCUM)
    want = {k: want.get(k, 0) for k in launches}   # no probe kernels
    want["layer_norm"] = lns.calls                # forwards and recomputes
    if launches != want or not lns.calls:
        raise AssertionError(f"train launches {launches} != {want}")
    finite = all(bool(torch.isfinite(v.float()).all()) for v in stats.values())
    finite &= all(bool(torch.isfinite(p.grad).all()) for p in m.parameters())
    if not finite:
        raise AssertionError("non-finite loss, stats or gradients in the "
                             "bf16 step")
    out.update(bf16_launches_per_step=launches,
               bf16_stats_step0={k: float(v) for k, v in stats.items()})
    for i in (1, 2):
        t0 = time.perf_counter()
        step(batch, i)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for i in range(timed):
        t0 = time.perf_counter()
        stats = step(batch, 3 + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(stats["loss"]))
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite losses {losses}")
    ms = statistics.median(times)

    def plans():
        with torch.no_grad():
            for i in range(ACCUM):
                sl = slice(i * MICRO, (i + 1) * MICRO)
                build_model_plan(cfg, pts[sl], pmask[sl], normals=(
                    None if normals is None else normals[sl]))
        torch.cuda.synchronize()

    plans()
    plan_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        plans()
        plan_ms.append((time.perf_counter() - t0) * 1e3)
    out.update(bf16_warmup_ms=warm, bf16_step_ms=ms,
               bf16_step_ms_all=times, bf16_submaps_per_s=BATCH / (ms / 1e3),
               bf16_losses=losses,
               octree_plan_ms_per_step=statistics.median(plan_ms),
               bf16_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del m, step
    torch.cuda.empty_cache()
    return launches, out


def lamb_check(torch, dev, cfg, pts, pmask):
    """One bf16 multistage step (16 clouds as 2 microbatches of 8) with
    LAMB (make_optimizer's 'lamb', named parameters: one trust ratio per
    JAX leaf), constant lr 1e-3: finite loss and gradients, and every
    parameter tensor moved and finite."""
    from hotformerloc_torch.losses.losses import make_loss
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.training.optim import (lr_schedule,
                                                   make_optimizer)
    from hotformerloc_torch.training.step import StepConfig, make_train_step

    batch = pair_batch(torch, dev, pts, pmask, 2 * MICRO)
    m = HOTFormerLoc(cfg, device=dev, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(m.named_parameters(), "lamb",
                         lr_schedule(1e-3, 1, 10, scheduler="constant"),
                         1e-4)
    step = make_train_step(m, opt, make_loss(
        "truncatedsmoothap", positives_per_query=4),
        StepConfig(accum_steps=2))
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = step(batch, 0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    still = [n for n, p in m.named_parameters()
             if torch.equal(p.detach(), before[n])
             or not bool(torch.isfinite(p).all())]
    if not np.isfinite(float(st["loss"])) or still:
        raise AssertionError(f"LAMB step: loss {float(st['loss'])}, "
                             f"{len(still)} tensors unmoved or non-finite, "
                             f"e.g. {still[:3]}")
    out = {"loss": float(st["loss"]), "first_step_ms": ms,
           "tensors": len(before), "trust_ratio_leaves": len(opt.leaves),
           "max_abs_change": max(
               float((p.detach() - before[n]).abs().max())
               for n, p in m.named_parameters())}
    del m, opt, step, before
    torch.cuda.empty_cache()
    return out


# convergence phase: the flagship run's benchmark (16 places per
# location, 256 training clouds, 8 steps per epoch) and microbatch, cut
# to CONV_EPOCHS epochs. The loss starts to fall some 40 steps after the
# 5 warm-up epochs; at 4 places per location (2 steps per epoch) it had
# not fallen after 20 epochs.
CONV_PLACES = 16
CONV_MICRO = 16
CONV_EPOCHS = 15


def convergence_phase(torch, smi):
    """tools/convergence_run.py at --exact shapes (Oxford at full width
    and depth, octree depth 9, 4096 points, the production capacities,
    batch 32 as microbatches of CONV_MICRO, grad_checkpoint with the
    default 'save_hot' policy) on a synthetic benchmark of CONV_PLACES
    places per location x 4 variants, CONV_EPOCHS epochs, evaluated at
    the last: finite losses, the last epoch's below the first's, every
    model kernel launched (counters zeroed just before, read just
    after)."""
    import shutil

    from hotformerloc_torch.config.params import parse_model_config
    from hotformerloc_torch.ops import kernels
    from hotformerloc_torch.tools import convergence_run

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, ".chip_tmp", "convergence")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    mpath = os.path.join(work, "model.txt")
    with open(mpath, "w") as f:
        f.write(convergence_run.model_cfg(True))
    mcfg = parse_model_config(mpath).config
    if not (mcfg.grad_checkpoint and mcfg.remat_policy == "save_hot"):
        raise AssertionError(f"convergence model config off: {mcfg}")
    kernels.reset_launches()
    t0 = time.time()
    summary = convergence_run.run([
        "--exact", "--places_per_loc", str(CONV_PLACES),
        "--batch_split_size", str(CONV_MICRO),
        "--epochs", str(CONV_EPOCHS), "--eval_freq", str(CONV_EPOCHS),
        "--out", os.path.join(work, "data"),
        "--weights_dir", os.path.join(work, "weights"),
        "--json_out", os.path.join(work, "summary.json")])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    losses = [r["loss"] for r in summary["train_trajectory"]]
    missing = [k for k in MODEL_KERNELS if launches[k] == 0]
    if (len(losses) != CONV_EPOCHS or not np.isfinite(losses).all()
            or not losses[-1] < losses[0] or missing
            or [r["epoch"] for r in summary["eval_trajectory"]]
            != [CONV_EPOCHS]):
        raise AssertionError(f"convergence run off: losses {losses}, "
                             f"evaluations {summary['eval_trajectory']}, "
                             f"no launches of {missing}")
    shutil.rmtree(work, ignore_errors=True)
    return {"card": smi, "seconds_run": time.time() - t0,
            "losses": losses, "epoch_time_s": summary["epoch_time_s"],
            "eval_trajectory": summary["eval_trajectory"],
            "launches": launches}


ENTRY_LOCS = 160             # entry phase: training places, 2 passes each
ENTRY_EVAL = 32              # clouds per evaluation run (4 splits x 2 runs)
ENTRY_SPLITS = ("oxford", "university", "residential", "business")
MODEL_KERNELS = ("window_attn", "window_attn_bwd", "octree_dwconv",
                 "octree_dwconv_bwd", "octree_conv", "octree_conv_bwd")


# entry phase, evaluation splits: (runs folder, cloud folder, locations
# CSV) as the PNV test sets lay them out (pnv_tuples.generate_test_sets)
ENTRY_EVAL_LAYOUT = {
    "oxford": ("oxford/", "/pointcloud_20m/", "pointcloud_locations_20m.csv"),
    **{s: ("inhouse_datasets/", "/pointcloud_25m_25/",
           "pointcloud_centroids_25.csv")
       for s in ("university", "residential", "business")}}
ENTRY_GRID = (-100.0, -60.0, -20.0, 20.0, 60.0, 100.0)   # m about a square
ENTRY_BUSINESS_CENTRE = (5735000.0, 620000.0)


def write_locations(path, rows):
    """A PNV locations CSV: (timestamp, northing, easting) rows."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("timestamp,northing,easting\n")
        for ts, n, e in rows:
            f.write(f"{ts},{n!r},{e!r}\n")


def entry_eval_place(split, j):
    """Place j of an evaluation split: on a 40 m grid inside the split's
    first test square (P_DICT, +-150 m), so that only the same place in
    the other run lies within the 25 m threshold; business, which has no
    squares, about a fixed centre."""
    from hotformerloc_torch.tools import pnv_tuples
    c = (pnv_tuples.P_DICT[split] or [ENTRY_BUSINESS_CENTRE])[0]
    g = len(ENTRY_GRID)
    return c[0] + ENTRY_GRID[j % g], c[1] + ENTRY_GRID[j // g]


def write_entry_dataset(root, n_locs=ENTRY_LOCS, n_eval=ENTRY_EVAL,
                        seed=7):
    """A PNV-format dataset under ``root``, laid out as the PNV tools
    read it, and its tuples from the port's ``tools/pnv_tuples.py``:
    n_locs places x 2 passes of 4096-point surface-like clouds (each pass
    the place's cloud plus N(0, 0.01) noise, float64 .bin; pass k in
    oxford/run{k}, places 100 m apart), the training-queries pickle from
    ``construct_query_dict`` (a cloud's positive is its place's other
    pass), and the four evaluation splits from
    ``construct_query_and_database_sets``, each 2 runs of the same n_eval
    places (a query's true neighbour is its place in the other run, 40 m
    from the next place). Asserts that the tool's tuples equal this
    ground truth, built here by hand."""
    import pickle

    from hotformerloc_torch.data.tuples import load_pickle_compat
    from hotformerloc_torch.tools import pnv_tuples as pnv
    from hotformerloc_torch.tools.graph_check import surface_cloud
    assert n_eval <= len(ENTRY_GRID) ** 2
    rng = np.random.default_rng(seed)

    def write(rel, base):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        (base + rng.normal(0, 0.01, base.shape)).astype(np.float64) \
            .tofile(path)

    runs = ("run0", "run1")
    rows = {r: [] for r in runs}
    want = {}                   # rel path -> (place, positive's rel path)
    for loc in range(n_locs):
        base = surface_cloud(rng)
        for k, run in enumerate(runs):
            ts = str(2 * loc + k)
            rel = pnv.RUNS_FOLDER + run + pnv.POINTCLOUD_FOLS + ts + ".bin"
            write(rel, base)
            rows[run].append((ts, 100.0 * loc, 0.0))
            sib = str(2 * loc + 1 - k)
            want[rel] = (loc, pnv.RUNS_FOLDER + runs[1 - k]
                         + pnv.POINTCLOUD_FOLS + sib + ".bin")
    entries = []
    for run in runs:
        csv = os.path.join(root, pnv.RUNS_FOLDER, run, pnv.FILENAME)
        write_locations(csv, rows[run])
        entries += [(pnv.RUNS_FOLDER + run + pnv.POINTCLOUD_FOLS + ts
                     + ".bin", n, e) for ts, n, e in pnv._read_locations(csv)]
    pnv.construct_query_dict(entries, root, "training_queries.pickle",
                             ind_nn_r=10.0)
    got = load_pickle_compat(os.path.join(root, "training_queries.pickle"))
    ids = {t.rel_scan_filepath: i for i, t in got.items()}
    for i, t in got.items():
        loc, sib = want[t.rel_scan_filepath]
        pos = np.array([ids[sib]])
        if not (t.id == i and list(t.positives) == list(pos)
                and list(t.non_negatives) == sorted([i, ids[sib]])
                and list(t.position) == [100.0 * loc, 0.0]
                and t.timestamp == int(os.path.basename(
                    t.rel_scan_filepath)[:-4])):
            raise AssertionError(f"pnv_tuples training tuple {i}: "
                                 f"{vars(t)}")
    if len(got) != 2 * n_locs:
        raise AssertionError(f"{len(got)} training tuples")

    for split in ENTRY_SPLITS:
        runs_folder, fols, fname = ENTRY_EVAL_LAYOUT[split]
        folders = [f"{split}_run{r}" for r in range(2)]
        bases = [surface_cloud(rng) for _ in range(n_eval)]
        sets = {"database": [], "query": []}
        for run, folder in enumerate(folders):
            db, q, locs = {}, {}, []
            for j, base in enumerate(bases):
                ts = str(1000 * run + j)
                rel = runs_folder + folder + fols + ts + ".bin"
                write(rel, base)
                n, e = entry_eval_place(split, j)
                locs.append((ts, n, e))
                db[j] = {"query": rel, "northing": n, "easting": e}
                q[j] = {**db[j], 1 - run: [j]}
            write_locations(os.path.join(root, runs_folder, folder, fname),
                            locs)
            sets["database"].append(db)
            sets["query"].append(q)
        pnv.construct_query_and_database_sets(
            root, runs_folder, folders, fols, fname, pnv.P_DICT[split],
            split)
        for kind, s in sets.items():
            with open(os.path.join(
                    root, f"{split}_evaluation_{kind}.pickle"), "rb") as f:
                if pickle.load(f) != s:
                    raise AssertionError(f"pnv_tuples {split} {kind} sets "
                                         "differ from the ground truth")


# ---- prep phase: the dataset-preparation tools on synthetic raw trees --
# Each tree's ground truth is known by construction: places lie >= 75 m
# apart (every tool's radius is <= 60 m), so a radius query around a row
# finds exactly the rows of its own place.
WILD_FORESTS = ("Venman", "Karawatha")
# Wild-Places places (easting, northing) by the split the tools must give
# them: inside a test polygon, at an exclusion circle's centre, or train
# (wildplaces_tuples.POLY_* / EXCLUDE_*)
WILD_RAW_PLACES = {
    "Venman": (("test", 0.0, 0.0), ("test", 60.0, -80.0),
               ("buffer", -63.0, 40.0), ("train", 300.0, 300.0),
               ("train", 400.0, 300.0), ("train", 500.0, 300.0)),
    "Karawatha": (("test", 0.0, -100.0), ("test", -150.0, 500.0),
                  ("buffer", -216.0, 606.0), ("train", 600.0, 600.0),
                  ("train", 700.0, 600.0), ("train", 800.0, 600.0))}
WILD_RAW_RUNS = 3
WILD_BROKEN = (1, 4)         # rows whose pose timestamp is truncated
# CS-Wild-Places places in UTM: (split, easting, northing, has an aerial
# submap); test places inside the splits' first test polygons
# (cswildplaces_tuples.POLY_DICT)
CSWILD_RAW_PLACES = {
    "Karawatha": (("test", 507100.0, 6942550.0, True),
                  ("test", 507350.0, 6942550.0, True),
                  ("train", 507100.0, 6942800.0, True),
                  ("train", 507250.0, 6942800.0, True),
                  ("train", 507400.0, 6942800.0, True),
                  ("train", 507600.0, 6942800.0, False)),
    "Venman": (("test", 519800.0, 6943700.0, True),
               ("test", 519400.0, 6943700.0, True),
               ("train", 519400.0, 6944000.0, True),
               ("train", 519550.0, 6944000.0, True),
               ("train", 519700.0, 6944000.0, True),
               ("train", 519850.0, 6944000.0, False))}
CSWILD_FOLDERS = ("aerial", "ground_run1", "ground_run2")
CSWILD_ARGS = {"pos_thresh": 15.0, "neg_thresh": 60.0, "buffer_thresh": 30.0,
               "eval_thresh": 15.0}
PREP_VOXEL = 0.8
PREP_MIN_POINTS = 100
PREP_CELLS = 150             # occupied voxels of a kept submap's objects
PREP_LOADER_CLOUDS = 256
PREP_LOADER_WORKERS = "0,2,4"


def same(a, b):
    """Equal nested dicts / lists of numbers, strings, numpy arrays (values
    and dtype kind) and tuple records (their attributes)."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.shape == b.shape and np.array_equal(a, b)
                and (a.size == 0 or a.dtype.kind == b.dtype.kind))
    if hasattr(a, "__dict__") and hasattr(b, "__dict__"):
        return type(a).__name__ == type(b).__name__ and same(vars(a),
                                                             vars(b))
    return type(a) is type(b) and a == b


def _write_pcd(path, points):
    from hotformerloc_torch.data.loaders import write_pcd
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_pcd(path, points)


def _write_csv(path, fields, rows):
    import csv
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(fields)
        w.writerows(rows)


def write_wild_raw(root, runs=WILD_RAW_RUNS, points=64, seed=3):
    """A raw Wild-Places tree: per forest ``runs`` runs visiting the places
    of WILD_RAW_PLACES in order, each with Clouds_downsampled/<ts>.pcd and
    a poses_aligned.csv whose WILD_BROKEN rows carry truncated
    timestamps. Returns the rows [(forest, run, place, split, ts, x, y)]
    and {csv path: the CSV's bytes with every timestamp right}."""
    import csv
    import io

    rng = np.random.default_rng(seed)
    fields = ("timestamp", "x", "y", "z", "qx", "qy", "qz", "qw")
    rows, fixed = [], {}
    for f, forest in enumerate(WILD_FORESTS):
        for r in range(runs):
            run = f"{forest[0]}-{r + 1:02d}"
            base = os.path.join(root, forest, run)
            good, bad = [], []
            for p, (split, x, y) in enumerate(WILD_RAW_PLACES[forest]):
                ts = f"{1624000000 + 100000 * f + 1000 * r + 10 * p}." \
                     f"{100000 + 7 * p:06d}"
                _write_pcd(os.path.join(base, "Clouds_downsampled",
                                       ts + ".pcd"),
                          rng.uniform(-5, 5, (points, 3)))
                rows.append((forest, run, p, split, ts, x, y))
                pose = [repr(x), repr(y), "0.0", "0.0", "0.0", "0.0", "1.0"]
                good.append([ts] + pose)
                bad.append([ts[:-3] if p in WILD_BROKEN else ts] + pose)
            _write_csv(os.path.join(base, "poses_aligned.csv"), fields, bad)
            buf = io.StringIO(newline="")
            w = csv.writer(buf)
            w.writerow(fields)
            w.writerows(good)
            fixed[os.path.join(base, "poses_aligned_fixed.csv")] = \
                buf.getvalue().encode()
    return rows, fixed


def wild_training_truth(rows, n_train_runs=2):
    """wildplaces_tuples' training and testing tuples for ``rows``, as
    {pickle name: [(rel path, timestamp, positives, non-negatives,
    (easting, northing))]}: Venman's first n_train_runs runs then
    Karawatha's (easting + 1e7), each row's positives its place's other
    rows in the same pickle."""
    out = {}
    for name, split in (("training_wild-places.pickle", "train"),
                        ("testing_wild-places.pickle", "test")):
        sel = [(fo, run, p, ts, x + (1e7 if fo == "Karawatha" else 0.0), y)
               for fo in WILD_FORESTS
               for (fo2, run, p, sp, ts, x, y) in rows
               if fo2 == fo and sp == split
               and run in sorted({r[1] for r in rows if r[0] == fo})[
                   :n_train_runs]]
        tuples = []
        for i, (fo, run, p, ts, x, y) in enumerate(sel):
            same_place = [j for j, s in enumerate(sel) if s[:1] == (fo,)
                          and s[2] == p]
            tuples.append((f"{fo}/{run}/Clouds_downsampled/{ts}.pcd",
                           float(ts), [j for j in same_place if j != i],
                           same_place, (x, y)))
        out[name] = tuples
    return out


def wild_test_sets_truth(rows):
    """wildplaces_tuples' evaluation sets for ``rows``: per forest,
    (database sets, query sets) over its runs in order."""
    out = {}
    for fo in WILD_FORESTS:
        runs = sorted({r[1] for r in rows if r[0] == fo})
        dbs, qs = [], []
        for ri, run in enumerate(runs):
            mine = [r for r in rows if r[0] == fo and r[1] == run]
            db = {k: {"query": f"{fo}/{run}/Clouds_downsampled/{ts}.pcd",
                      "northing": y, "easting": x,
                      "pose": np.array([x, y, 0, 0, 0, 0, 1.0]),
                      "timestamp": float(ts)}
                  for k, (_, _, _, _, ts, x, y) in enumerate(mine)}
            tests = [k for k, r in enumerate(mine) if r[3] == "test"]
            qs.append({n: {**db[k], **{i: [k] for i in range(len(runs))
                                       if i != ri}}
                       for n, k in enumerate(tests)})
            dbs.append(db)
        out[fo] = (dbs, qs)
    return out


def check_wild(root, rows, fixed):
    """fix_broken_timestamps' CSVs and wildplaces_tuples' pickles under
    ``root`` against the ground truth of ``write_wild_raw``."""
    from hotformerloc_torch.data.tuples import load_pickle_compat
    for path, want in fixed.items():
        with open(path, "rb") as f:
            if f.read() != want:
                raise AssertionError(f"fix_broken_timestamps: {path}")
    for name, want in wild_training_truth(rows).items():
        got = load_pickle_compat(os.path.join(root, name))
        ok = sorted(got) == list(range(len(want))) and all(
            t.id == i and t.rel_scan_filepath == w[0]
            and t.timestamp == w[1] and list(t.positives) == w[2]
            and list(t.non_negatives) == w[3]
            and list(t.position) == list(w[4])
            for i, t, w in ((i, got[i], want[i]) for i in range(len(want))))
        if not ok:
            raise AssertionError(f"wildplaces_tuples {name} differs from "
                                 "the ground truth")
    for fo, (dbs, qs) in wild_test_sets_truth(rows).items():
        for kind, want in (("database", dbs), ("query", qs)):
            got = load_pickle_compat(os.path.join(
                root, f"{fo}_evaluation_{kind}.pickle"))
            if not same(got, want):
                raise AssertionError(f"wildplaces_tuples {fo} {kind} sets "
                                     "differ from the ground truth")


def write_postprocess_raw(root, n_clouds=6, seed=4):
    """Raw .pcd submaps for postprocess_submaps under
    root/QCAT/ground_run1/clouds (a poses.csv beside them): a flat ground
    (z ~ N(0, 0.02), >= 4 points per CSF cell) under object points in
    PREP_CELLS voxels of PREP_VOXEL (4 points each, >= 0.25 voxel from a
    voxel face, plus the objects' lowest corner point); the last submap
    has 10 voxels, fewer points than PREP_MIN_POINTS. Returns {rel path:
    the voxel centroids of its object points, or None (rejected)}."""
    rng = np.random.default_rng(seed)
    v, corner, grid = PREP_VOXEL, np.array([-12.0, -12.0, 1.0]), (30, 30, 4)
    run = os.path.join(root, "QCAT", "ground_run1")
    want, poses = {}, []
    for c in range(n_clouds):
        n_cells = PREP_CELLS if c < n_clouds - 1 else 10
        cells = np.concatenate([[0], rng.choice(
            np.arange(1, int(np.prod(grid))), n_cells - 1, replace=False)])
        idx = np.stack(np.unravel_index(cells, grid), 1)
        obj = (corner + (np.repeat(idx, 4, 0) + 0.5
                         + rng.uniform(-0.25, 0.25, (4 * n_cells, 3))) * v)
        obj = np.concatenate([corner[None], obj]).astype(np.float32)
        label = np.concatenate([[0], np.repeat(np.arange(n_cells), 4)])
        ground = np.concatenate([rng.uniform(-14, 14, (12544, 2)),
                                 rng.normal(0, 0.02, (12544, 1))], 1)
        ts = str(1700000000 + c)
        rel = os.path.join("QCAT", "ground_run1", "clouds", ts + ".pcd")
        pts = np.concatenate([ground.astype(np.float32), obj])
        _write_pcd(os.path.join(root, rel), pts[rng.permutation(len(pts))])
        poses.append([ts, "0.0", "0.0", "0.0"])
        o64 = obj.astype(np.float64)
        want[rel] = (np.stack([o64[label == k].mean(0)
                               for k in range(n_cells)])
                     if n_cells >= PREP_MIN_POINTS else None)
    _write_csv(os.path.join(run, "poses.csv"), ("timestamp", "x", "y", "z"),
               poses)
    return want


def check_postprocess(out_dir, want):
    """postprocess_submaps' output against ``write_postprocess_raw``: each
    kept submap's points are its object points' voxel centroids (ground
    removed), the rejected one is listed, poses.csv is copied."""
    from hotformerloc_torch.data.loaders import read_pcd

    def rows(a):
        return a[np.lexsort(a.T[::-1])]
    for rel, cen in want.items():
        path = os.path.join(out_dir, rel)
        if cen is None:
            if os.path.exists(path):
                raise AssertionError(f"postprocess_submaps kept {rel}")
            continue
        got = read_pcd(path)
        if not (got.shape == cen.shape and np.allclose(
                rows(got.astype(np.float64)), rows(cen), atol=1e-4)):
            raise AssertionError(f"postprocess_submaps {rel}: {got.shape} "
                                 f"points, want {cen.shape} centroids")
    rejected = [os.path.basename(r)[:-4] for r, c in want.items()
                if c is None]
    with open(os.path.join(out_dir, "rejected_timestamps.txt")) as f:
        if f.read().split() != rejected:
            raise AssertionError("postprocess_submaps rejected list off")
    if not os.path.exists(os.path.join(out_dir, "QCAT", "ground_run1",
                                       "poses.csv")):
        raise AssertionError("postprocess_submaps did not copy poses.csv")


def _rot(q):
    from hotformerloc_torch.tools.preprocess import quaternion_to_rot
    return quaternion_to_rot(q)


def write_cswild_raw(root, points=256, seed=5):
    """A CS-Wild-Places tree: per split of CSWILD_RAW_PLACES the folders
    CSWILD_FOLDERS, each a poses.csv (timestamp, x, y, z, qx, qy, qz, qw)
    and clouds/<ts>.pcd. An aerial submap is a cloud in its own frame (z
    60 m, a random rotation); each ground submap of the same place holds
    the same points in its frame (z 1.5 m, another rotation), so that
    the relative pose maps one onto the other. Returns the rows
    [(split, folder, place, kind, ts, x, y)]."""
    rng = np.random.default_rng(seed)
    rows = []
    for s, split in enumerate(CSWILD_RAW_PLACES):
        world = {}                  # place -> its aerial points in UTM
        for fi, folder in enumerate(CSWILD_FOLDERS):
            base = os.path.join(root, split, folder)
            poses = []
            for p, (kind, x, y, has_aerial) in enumerate(
                    CSWILD_RAW_PLACES[split]):
                if folder == "aerial" and not has_aerial:
                    continue
                ts = str(1650000000 + 100000 * s + 1000 * fi + p)
                q = rng.normal(size=4)
                q /= np.linalg.norm(q)
                t = np.array([x, y, 60.0 if folder == "aerial" else 1.5])
                if folder == "aerial":
                    pc = rng.uniform(-15, 15, (points, 3))
                    world[p] = pc @ _rot(q).T + t
                elif p in world:
                    pc = (world[p] - t) @ _rot(q)
                else:
                    pc = rng.uniform(-15, 15, (points, 3))
                _write_pcd(os.path.join(base, "clouds", ts + ".pcd"), pc)
                poses.append([ts] + [repr(float(v)) for v in (*t, *q)])
                rows.append((split, folder, p, kind, ts, x, y))
            _write_csv(os.path.join(base, "poses.csv"),
                       ("timestamp", "x", "y", "z", "qx", "qy", "qz", "qw"),
                       poses)
    return rows


def cswild_truth(rows):
    """cswildplaces_tuples' ground truth for ``rows``: the baseline
    training entries and the test entries in the tool's order, each
    (rel path, easting, northing, split, place), and per split the
    evaluation (database sets, query sets). Ground submaps inside a test
    polygon are test queries; aerial ones at a test place lie within
    the buffer of those queries; every aerial submap is in the database
    and among the test entries."""
    train, test, evals = [], [], {}
    for split in sorted(CSWILD_RAW_PLACES):
        dbs, qs = [], []
        for folder in CSWILD_FOLDERS:
            db, q = {}, {}
            aerial = folder == "aerial"
            for (sp, fo, p, kind, ts, x, y) in rows:
                if (sp, fo) != (split, folder):
                    continue
                rel = f"{split}/{folder}/clouds/{ts}.pcd"
                entry = (rel, x, y, split, p)
                rec = {"query": rel, "easting": x, "northing": y}
                if kind == "test" and not aerial:
                    test.append(entry)
                    q[len(q)] = dict(rec)
                elif kind == "train":
                    train.append(entry)
                if aerial:
                    test.append(entry)
                    db[len(db)] = dict(rec)
            dbs.append(db)
            qs.append(q)
        for j, q in enumerate(qs):
            for rec in q.values():
                for i, db in enumerate(dbs):
                    if i != j:
                        rec[i] = [d for d, r in db.items()
                                  if (r["easting"], r["northing"])
                                  == (rec["easting"], rec["northing"])]
        evals[split] = (dbs, qs)
    return train, test, evals


def cswild_tuples_truth(entries, test_set):
    """Per entry (positives, non-negatives, negatives) as
    cswildplaces_tuples builds them: a row's radius sets are its place's
    rows; in the test set an aerial row is skipped (all empty) and a
    ground row's positives are its place's aerial rows, its
    non-negatives take in every ground row."""
    every = set(range(len(entries)))
    ground = {i for i, e in enumerate(entries) if "ground" in e[0]}
    out = []
    for i, e in enumerate(entries):
        place = {j for j, o in enumerate(entries) if o[3:] == e[3:]}
        pos, nonneg, neg = place - {i}, set(place), every - place
        if test_set and "aerial" in e[0]:
            pos, nonneg, neg = set(), set(), set()
        elif test_set:
            pos, neg, nonneg = pos - ground, neg - ground, nonneg | ground
        out.append((sorted(pos), sorted(nonneg), sorted(neg)))
    return out


def check_cswild(save_dir, rows):
    """cswildplaces_tuples' v1 / v2 pickles and evaluation sets under
    ``save_dir`` against ``cswild_truth``."""
    from hotformerloc_torch.data.tuples import load_pickle_compat
    train, test, evals = cswild_truth(rows)
    for base, entries, test_set in (
            ("training_queries_CSWildPlaces_baseline_", train, False),
            ("test_queries_CSWildPlaces_", test, True)):
        v1 = load_pickle_compat(os.path.join(save_dir, base + "v1.pickle"))
        v2 = load_pickle_compat(os.path.join(save_dir, base + "v2.pickle"))
        want = cswild_tuples_truth(entries, test_set)
        ok = sorted(v1) == sorted(v2) == list(range(len(entries)))
        for i, (e, (pos, nonneg, neg)) in enumerate(zip(entries, want)):
            t, d = v2.get(i), v1.get(i)
            ok = ok and (
                t.id == i and t.rel_scan_filepath == e[0]
                and t.timestamp == os.path.basename(e[0])[:-4]
                and list(t.positives) == pos
                and list(t.non_negatives) == nonneg
                and list(t.position) == [e[1], e[2]]
                and d["query"] == e[0] and d["positives"] == pos
                and sorted(d["negatives"]) == neg)
        if not ok:
            raise AssertionError(f"cswildplaces_tuples {base}: tuples "
                                 "differ from the ground truth")
    for split, (dbs, qs) in evals.items():
        base = os.path.join(save_dir, f"CSWildPlaces_{split}_evaluation")
        for kind, want in (("database", dbs), ("query", qs)):
            if not same(load_pickle_compat(f"{base}_{kind}.pickle"), want):
                raise AssertionError(f"cswildplaces_tuples {split} {kind} "
                                     "sets differ from the ground truth")


def overlap_truth(rows):
    """ground_aerial_overlap's counts per split of ``rows``: ground
    submaps of a place with an aerial submap pair up (the same points, so
    chamfer 0 and overlap 1), the others are skipped (no aerial submap
    within 10 m)."""
    out = {}
    for split, places in CSWILD_RAW_PLACES.items():
        n = sum(1 for r in rows if r[0] == split and "ground" in r[1])
        pairs = sum(1 for r in rows if r[0] == split and "ground" in r[1]
                    and places[r[2]][3])
        out[split] = {"pairs": pairs, "skipped": n - pairs}
    return out


def write_campus_raw(root, n=12, m=6):
    """Upstream-format CS-Campus3D pickles: n training queries (i's
    positive i ^ 1, its non-negatives i, i ^ 1 and (i + 2) % n) and 2
    evaluation runs of m queries (query j's true match j in the other
    run). Returns (train pickle, query pickle, train dict, query runs)."""
    import pickle
    os.makedirs(root, exist_ok=True)
    train = {i: {"query": f"umd/umd_all_4096/{1000 + i}.bin",
                 "northing": 100.0 * i, "easting": 5.0,
                 "positives": [i ^ 1],
                 "negatives": [j for j in range(n)
                               if j not in (i, i ^ 1, (i + 2) % n)]}
             for i in range(n)}
    query = [[{"query": f"umd/run{r}/{2000 + j}.bin", "northing": 50.0 * j,
               "easting": 0.0, 1 - r: [j]} for j in range(m)]
             for r in range(2)]
    paths = []
    for name, obj in (("training_queries_umd_4096.pickle", train),
                      ("umd_evaluation_query.pickle", query)):
        paths.append(os.path.join(root, name))
        with open(paths[-1], "wb") as f:
            pickle.dump(obj, f)
    return paths[0], paths[1], train, query


def check_campus(train_path, query_path, train, query):
    """cscampus3d_convert's _v2 pickles against ``write_campus_raw``."""
    from hotformerloc_torch.data.tuples import load_pickle_compat
    got = load_pickle_compat(train_path.replace(".pickle", "_v2.pickle"))
    n = len(train)
    ok = sorted(got) == list(range(n)) and all(
        t.id == i and t.rel_scan_filepath == train[i]["query"]
        and t.timestamp == 1000 + i and list(t.positives) == [i ^ 1]
        and list(t.non_negatives) == sorted({i, i ^ 1, (i + 2) % n})
        and list(t.position) == [100.0 * i, 5.0]
        for i, t in got.items())
    runs = load_pickle_compat(query_path.replace(".pickle", "_v2.pickle"))
    if not (ok and runs == [dict(enumerate(run)) for run in query]):
        raise AssertionError("cscampus3d_convert differs from the ground "
                             "truth")


def prep_phase(smi, loader_clouds=PREP_LOADER_CLOUDS,
               workers=PREP_LOADER_WORKERS):
    """The dataset-preparation tools through their CLIs, each in a
    process of its own (host only), on synthetic raw trees under
    .chip_tmp/prep, each checked against the ground truth its tree was
    built with and timed: fix_broken_timestamps, postprocess_submaps
    (ground removal and voxel downsampling on 2 workers),
    wildplaces_tuples train and test-sets, cswildplaces_tuples,
    cscampus3d_convert, ground_aerial_overlap, and loader_bench at
    ``workers`` on a corpus of ``loader_clouds``. Returns the native
    library loaded, seconds per tool (``tool_seconds``: the CLI's
    process, start-up included) and the loader's submaps/s per worker
    count."""
    import re
    import shutil

    from hotformerloc_torch.data import native
    from hotformerloc_torch.tools import loader_bench

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, ".chip_tmp", "prep")
    shutil.rmtree(work, ignore_errors=True)
    lib = native.load_library()
    if lib is None or os.path.realpath(lib._name) != os.path.realpath(
            native.library_path()):
        raise AssertionError(f"native library {lib} is not the port's "
                             f"{native.library_path()}")
    seconds = {}

    def tool(name, *argv, label=None):
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", f"hotformerloc_torch.tools.{name}",
             *map(str, argv)], cwd=here, capture_output=True, text=True,
            timeout=900, env=dict(os.environ, PYTHONPATH=here))
        seconds[label or name] = time.time() - t0
        if r.returncode != 0:
            raise AssertionError(f"{name} {argv}: rc {r.returncode}\n"
                                 f"{r.stderr[-3000:]}")
        return r.stdout

    wild = os.path.join(work, "wild")
    rows, fixed = write_wild_raw(wild)
    tool("fix_broken_timestamps", "--root", wild)
    raw, pp = os.path.join(work, "raw"), os.path.join(work, "postprocessed")
    want = write_postprocess_raw(raw)
    tool("postprocess_submaps", "--root", raw, "--save_dir", pp,
         "--remove_ground", "--downsample", "--downsample_type", "voxel",
         "--voxel_size", PREP_VOXEL, "--min_num_points", PREP_MIN_POINTS,
         "--num_workers", 2)
    check_postprocess(pp, want)
    for cmd in ("train", "test-sets"):
        tool("wildplaces_tuples", cmd, "--root", wild,
             label=f"wildplaces_tuples {cmd}")
    check_wild(wild, rows, fixed)
    cs, cs_out = os.path.join(work, "cswild"), os.path.join(work, "cs_out")
    crows = write_cswild_raw(cs)
    tool("cswildplaces_tuples", "--root", cs, "--save_dir", cs_out,
         *[a for k, v in CSWILD_ARGS.items() for a in (f"--{k}", v)])
    check_cswild(cs_out, crows)
    campus = write_campus_raw(os.path.join(work, "campus"))
    tool("cscampus3d_convert", "--train_pickle", campus[0],
         "--query_pickle", campus[1])
    check_campus(*campus)
    got = {m[0]: {"pairs": int(m[1]), "skipped": int(m[2]),
                  "chamfer": float(m[3]), "overlap": float(m[4])}
           for m in re.findall(r"^(\w+): pairs=(\d+) skipped=(\d+) "
                               r"mean_chamfer=([\d.]+)m mean_overlap="
                               r"([\d.]+)$",
                               tool("ground_aerial_overlap",
                                    "--postproc_path", cs), re.M)}
    want = {s: {**c, "chamfer": 0.0, "overlap": 1.0}
            for s, c in overlap_truth(crows).items()}
    if got != want:
        raise AssertionError(f"ground_aerial_overlap {got} != {want}")
    lroot = os.path.join(work, "loader")
    t0 = time.time()
    loader_bench.make_corpus(lroot, n=loader_clouds)
    corpus_s = time.time() - t0
    lout = os.path.join(work, "LOADER_BENCH_torch.json")
    tool("loader_bench", "--root", lroot, "--workers", workers, "--out",
         lout)
    with open(lout) as f:
        bench = json.load(f)
    rates = {w: bench[f"workers_{w}"]["submaps_s"]
             for w in workers.split(",")}
    if bench["corpus"] != loader_clouds or not all(
            np.isfinite(r) and r > 0 for r in rates.values()):
        raise AssertionError(f"loader_bench: {bench}")
    shutil.rmtree(work, ignore_errors=True)
    return {"card": smi, "native_library": lib._name,
            "tool_seconds": seconds,
            "loader_corpus_seconds": corpus_s,
            "loader_submaps_s": rates,
            "loader": {k: bench[k] for k in ("batch", "num_points", "mode",
                                            "corpus", "host_cpus")},
            "ground_aerial_overlap": got}


def attn_ab_phase(torch, smi):
    """tools/pallas_ab.py's three cases on the card: the port's
    WindowAttention in bf16 on the kernel route (K1 / K2 on their
    tensor-core bodies) against the einsum route (no kernel launched),
    forward and forward+backward ms. Under the loss over valid query
    rows, the kernel route's output and the gradient of x and of each
    parameter, the RPE table's included, lie within the bf16 bar of the
    einsum route's own largest |value|: TOL["bf16_rel"] for the output,
    TOL_BWD["bf16"]["act"] for each gradient. Every gradient here is a
    bf16 result rounded once on both routes (x, qkv, proj) or an fp32
    sum of terms that the einsum route rounds to bf16 first (its dattn,
    for the table); K2's table gradient on the same inputs is held to
    the fp32-sum bar in phase 5. Returns the kernel routes' K1 / K2
    launches and the phase's numbers."""
    from hotformerloc_torch.tools import pallas_ab
    cases, launches = [], {"window_attn": 0, "window_attn_bwd": 0}
    for case in pallas_ab.CASES:
        # no torch.profiler window here: windows profiled before the
        # train phase leave the probe tools' later windows without
        # device events (phase 8)
        r = pallas_ab.bench_case(*case, profile=False)
        k, e = r["kernel"]["launches"], r["einsum"]["launches"]
        peak = r["einsum_grad_max_abs"]
        far = [leaf for leaf, d in r["grad_maxdiff_vs_einsum"].items()
               if not d <= TOL_BWD["bf16"]["act"] * peak[leaf]]
        if not (k["window_attn"] > 0 and k["window_attn"]
                == k["window_attn_tc"] and k["window_attn_bwd"] > 0
                and k["window_attn_bwd"] == k["window_attn_bwd_tc"]
                and not any(e.values()) and r["finite"] and not far
                and r["maxdiff_vs_einsum"]
                <= TOL["bf16_rel"] * r["einsum_max_abs"]):
            raise AssertionError(f"attn_ab {case[0]} (gradients beyond "
                                 f"the bar: {far}): {r}")
        for name in launches:
            launches[name] += k[name]
        cases.append(r)
    torch.cuda.empty_cache()
    return launches, {"card": smi, "cases": cases}


WILD_LOCATIONS = {"CSWildPlaces": ("Karawatha", "Venman", "QCAT", "Samford"),
                  "WildPlaces": ("Karawatha", "Venman")}


def write_wild_dataset(root, dataset, train_file, val_file=None,
                       n_locs=ENTRY_LOCS, n_eval=ENTRY_EVAL, seed=7,
                       points=4096):
    """A (CS-)Wild-Places-format dataset under ``root``, ``dataset``
    "CSWildPlaces" or "WildPlaces": binary .pcd submaps (float32) of
    surface-like clouds; ``train_file``, a training-queries pickle of
    n_locs places x 2 passes (each pass the place's cloud plus N(0, 0.01)
    noise; a cloud's positive is its place's other pass); ``val_file``
    (when given), the same of n_eval other places; and per location of
    the dataset the evaluation database and query pickles under the
    names evaluation/evaluate.py's get_query_database_splits gives, each
    2 runs of the same n_eval places (a query's true neighbour is its
    place in the other run). Returns the location names."""
    import pickle

    from hotformerloc_torch.data.loaders import write_pcd
    from hotformerloc_torch.data.tuples import TrainingTuple
    from hotformerloc_torch.evaluation.evaluate import \
        get_query_database_splits
    from hotformerloc_torch.tools.graph_check import surface_cloud
    rng = np.random.default_rng(seed)

    def write(rel, base):
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_pcd(path, base + rng.normal(0, 0.01, base.shape))

    def tuples(name, n):
        queries = {}
        folder = name.rsplit(".", 1)[0]
        for loc in range(n):
            base = surface_cloud(rng, points)
            for k in range(2):
                i, sib = 2 * loc + k, 2 * loc + 1 - k
                write(f"{folder}/{i:04d}.pcd", base)
                queries[i] = TrainingTuple(
                    i, i, f"{folder}/{i:04d}.pcd", np.array([sib]),
                    np.array(sorted([i, sib])), np.array([100.0 * loc, 0.0]))
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(queries, f)

    tuples(train_file, n_locs)
    if val_file:
        tuples(val_file, n_eval)
    dbs, qs = get_query_database_splits(dataset)
    for loc, dbf, qf in zip(WILD_LOCATIONS[dataset], dbs, qs):
        bases = [surface_cloud(rng, points) for _ in range(n_eval)]
        sets = {dbf: [], qf: []}
        for run in range(2):
            db, q = {}, {}
            for j, base in enumerate(bases):
                rel = f"{loc}/run{run}_{j:03d}.pcd"
                write(rel, base)
                db[j] = {"query": rel, "northing": 100.0 * j,
                         "easting": 0.0}
                q[j] = {**db[j], 1 - run: [j]}
            sets[dbf].append(db)
            sets[qf].append(q)
        for name, s in sets.items():
            with open(os.path.join(root, name), "wb") as f:
                pickle.dump(s, f)
    return WILD_LOCATIONS[dataset]


def numpy_recall(db, qv, query_sets, m, n, k=25):
    """AR@1..k, AR@1% and MRR of query run n against database run m by
    brute force in float64 numpy: the PointNetVLAD protocol, written
    apart from retrieval_topk / get_recall."""
    d = np.sqrt(((qv[:, None, :].astype(np.float64)
                  - db[None, :, :].astype(np.float64)) ** 2).sum(-1))
    order = np.argsort(d, axis=1, kind="stable")[:, :min(k, len(db))]
    thr = max(int(round(len(db) / 100.0)), 1)
    hits, ranks, one_pct, n_eval = np.zeros(k), [], 0, 0
    for i in range(len(qv)):
        tn = set(query_sets[n][i].get(m, []))
        if not tn:
            continue
        n_eval += 1
        first = next((j for j, idx in enumerate(order[i]) if idx in tn),
                     None)
        if first is not None:
            hits[first] += 1
            ranks.append(first + 1)
        one_pct += bool(tn & set(order[i, :thr].tolist()))
    return (np.cumsum(hits) / n_eval * 100, one_pct / n_eval * 100,
            float(np.mean(1.0 / np.asarray(ranks)) * 100) if ranks else 0.0)


REMAT_POLICIES = ("off", None, "save_attn", "save_hot")   # "off": no
# checkpointing


def remat_sites(cfg):
    """(K1, K3) launches per forward at the checkpointed blocks (every
    window attention; every CPE but the relay-token init's), from the
    shape table."""
    cases = path_cases(cfg)
    return (sum(c[-1] for c in cases["window_attn"]),
            sum(c[-1] for c in cases["octree_dwconv"]
                if c[0].startswith("cpe_")))


def remat_launches(cfg, policy, micro):
    """K1 and K3 forward launches of one multistage step of ``micro``
    microbatches under ``policy``: stages 1 and 3 run each forward once;
    the backward runs again, per microbatch, the kernels of the
    checkpointed blocks whose outputs the policy does not keep."""
    cases = path_cases(cfg)
    k1, k3 = remat_sites(cfg)
    base = {k: 2 * micro * sum(c[-1] for c in cases[k])
            for k in ("window_attn", "octree_dwconv")}
    if policy == "off":
        return base
    return {"window_attn": base["window_attn"]
            + (0 if policy in ("save_attn", "save_hot") else micro * k1),
            "octree_dwconv": base["octree_dwconv"]
            + (0 if policy == "save_hot" else micro * k3)}


def set_remat(model, policy):
    """Point every module's model config at ``policy`` (the stages read
    ``cfg.remat_policy`` at each forward)."""
    from hotformerloc_torch.models.config import ModelConfig
    for m in model.modules():
        if isinstance(getattr(m, "cfg", None), ModelConfig):
            m.cfg = dataclasses.replace(m.cfg, remat_policy=policy)


def remat_check(torch, dev, mcfg, pts, pmask):
    """One fp32 step of 16 clouds as 2 microbatches of 8 without
    checkpointing and with grad_checkpoint under each remat policy (None,
    'save_attn', 'save_hot'), same weights and batch: the same loss
    (|diff| <= 1e-6) and gradients within GRAD_TOL of the step without
    checkpointing, and the K1 / K3 forward launches ``remat_launches``
    gives (counters zeroed just before each step, read just after)."""
    from hotformerloc_torch.losses.losses import make_loss
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.ops import kernels
    from hotformerloc_torch.training.optim import (lr_schedule,
                                                   make_optimizer)
    from hotformerloc_torch.training.step import StepConfig, make_train_step

    batch = pair_batch(torch, dev, pts, pmask, 2 * MICRO)
    res, out = {}, {"sites_k1_k3": remat_sites(mcfg)}
    for policy in REMAT_POLICIES:
        m = HOTFormerLoc(dataclasses.replace(
            mcfg, grad_checkpoint=policy != "off",
            remat_policy=None if policy == "off" else policy), device=dev,
            generator=torch.Generator().manual_seed(0), dtype=torch.float32)
        opt = make_optimizer(m.named_parameters(), "adam",
                             lr_schedule(5e-4, 100, 150), 1e-4)
        step = make_train_step(m, opt, make_loss(
            "truncatedsmoothap", positives_per_query=4),
            StepConfig(accum_steps=2))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        st = step(batch, 0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: kernels.LAUNCHES[k] for k in ("window_attn",
                                                 "octree_dwconv")}
        want = remat_launches(mcfg, policy, 2)
        if got != want:
            raise AssertionError(f"remat {policy}: K1 / K3 launches {got} "
                                 f"!= {want}")
        res[policy] = (float(st["loss"]), {n: p.grad.detach().clone()
                                           for n, p in m.named_parameters()})
        out[str(policy)] = {"launches": got,
                            "peak_mem_gb": torch.cuda.max_memory_allocated()
                            / 1e9, "first_step_ms": ms}
        del m, opt, step, st
        torch.cuda.empty_cache()
    loss0, g0 = res["off"]
    for policy in REMAT_POLICIES[1:]:
        loss, g = res[policy]
        worst = max(float((g[n] - g0[n]).norm())
                    / (GRAD_TOL[0] * float(g0[n].norm()) + GRAD_TOL[1])
                    for n in g0)
        dloss = abs(loss - loss0)
        if worst > 1.0 or dloss > 1e-6:
            raise AssertionError(f"remat {policy} changes the step: loss "
                                 f"diff {dloss}, worst gradient {worst} of "
                                 "the bar")
        out[str(policy)].update(loss_diff=dloss,
                                grad_worst_ratio_to_limit=worst)
    out["loss"] = loss0
    return out


def entry_phase(torch, dev, smi, pts, pmask):
    """The port's train and evaluate CLIs on the card (the entry path):
    train configs/oxford.txt's settings at batch 256 as 2 microbatches of
    128 with configs/oxford_model.txt unchanged (full width and depth,
    grad_checkpoint on) for 2 epochs on a synthetic dataset, resume, run
    pnv_evaluate on the final checkpoint and hold its recalls against
    the in-training evaluation and a numpy recomputation. The run's
    trainer then takes one step of 256 under 'save_hot' and under None in
    turns (a b a b) on one batch of its loader. Last, ``remat_check``.
    Returns the launches of the train run and the phase's numbers."""
    import configparser
    import pickle
    import shutil

    from hotformerloc_torch.config.params import (parse_model_config,
                                                  parse_train_config)
    from hotformerloc_torch.evaluation import pnv_evaluate
    from hotformerloc_torch.evaluation.evaluate import get_latent_vectors
    from hotformerloc_torch.ops import kernels
    from hotformerloc_torch.training import train as train_cli
    from hotformerloc_torch.training.trainer import Trainer, to_device

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, ".chip_tmp", "entry")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "data")
    t0 = time.time()
    write_entry_dataset(data)
    out = {"card": smi, "dataset_seconds": time.time() - t0,
           "train_clouds": 2 * ENTRY_LOCS,
           "eval_clouds": len(ENTRY_SPLITS) * 2 * ENTRY_EVAL}
    cp = configparser.ConfigParser()
    cp.read(os.path.join(here, "configs", "oxford.txt"))
    cp["DEFAULT"]["dataset_folder"] = data
    cp["TRAIN"].update(batch_size="256", batch_split_size="128",
                       epochs="2", eval_freq="1", save_freq="1",
                       validation="False",
                       train_file="training_queries.pickle")
    cfg_path = os.path.join(work, "oxford_entry.txt")
    with open(cfg_path, "w") as f:
        cp.write(f)
    model_cfg = os.path.join(here, "configs", "oxford_model.txt")
    wdir = os.path.join(work, "weights")

    # -- train through the CLI (the launch counts of this run) ---------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    tr = train_cli.main(["--config", cfg_path, "--model_config", model_cfg,
                         "--weights_dir", wdir, "--model_name", "entry"])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    out["train_cli_seconds"] = time.time() - t0
    out["train_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    missing = [k for k in MODEL_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the entry run launched no {missing}")
    cfg = tr.cfg
    if not (cfg.grad_checkpoint and cfg.channels == (128, 256)
            and cfg.num_blocks == (4, 10)
            and tr.model.dtype == torch.bfloat16
            and tr.train_step.cfg.accum_steps == 2):
        raise AssertionError(f"entry run config off: {cfg}")
    with open(os.path.join(tr.weights_dir, "entry_log.jsonl")) as f:
        log = [json.loads(ln) for ln in f]
    train_log = [r for r in log if r["phase"] == "train"]
    eval_log = {r["epoch"]: r for r in log if r["phase"] == "eval"}
    if [r["epoch"] for r in train_log] != [1, 2] or sorted(eval_log) != \
            [1, 2] or not all(np.isfinite(r["loss"]) for r in train_log):
        raise AssertionError(f"entry train log off: {log}")
    for tag in ("e1", "e2", "latest", "final"):
        p = tr.ckpt_path(tag)
        if not (os.path.exists(p) and os.path.exists(p + ".meta.json")):
            raise AssertionError(f"no checkpoint {p} or its .meta.json")
    steps = tr.step_log
    if [s["size"] for s in steps] != [256, 64, 256, 64]:
        raise AssertionError(f"entry batches {steps}")
    out.update(
        launches=launches, losses=[r["loss"] for r in train_log],
        epoch_seconds=[r["time"] for r in train_log],
        steps=[{k: s[k] for k in ("epoch", "size", "step_s", "wait_s")}
               for s in steps],
        step_ms_b256_after_first=statistics.median(
            s["step_s"] * 1e3 for s in steps[1:] if s["size"] == 256),
        step_ms_after_first=statistics.median(s["step_s"] * 1e3
                                              for s in steps[1:]),
        loader_wait_ms_per_batch=statistics.mean(s["wait_s"] * 1e3
                                                 for s in steps),
        eval_in_training={e: {k: r[k] for k in ("avg_AR1", "avg_AR1p",
                                                 "avg_MRR")}
                          for e, r in eval_log.items()})

    # -- resume from latest --------------------------------------------
    params = parse_train_config(cfg_path, model_cfg)
    back = Trainer(params, weights_dir=os.path.join(work, "resume"),
                   model_name="entry", device=dev)
    back.close()
    back.resume(tr.ckpt_path("latest"))
    sa, sb = tr.optimizer.state_dict(), back.optimizer.state_dict()
    same = (back.start_epoch == 3
            and back.train_step.state.step == tr.train_step.state.step == 4
            and back.train_sampler.batch_size == tr.train_sampler.batch_size
            and all(torch.equal(x, y) for x, y in zip(
                tr.model.state_dict().values(),
                back.model.state_dict().values()))
            and sa["param_groups"] == sb["param_groups"]
            and sorted(sa["state"]) == sorted(sb["state"])
            and len(sa["state"]) == len(list(tr.model.parameters()))
            and all(torch.equal(sa["state"][k][n], sb["state"][k][n])
                    for k in sa["state"]
                    for n in ("step", "exp_avg", "exp_avg_sq")))
    if not same:
        raise AssertionError("resumed state differs from the trained one")
    out["resume"] = {"epoch": back.start_epoch - 1,
                     "step": back.train_step.state.step,
                     "sampler_batch_size": back.train_sampler.batch_size,
                     "tensors": len(tr.model.state_dict())}
    final = tr.ckpt_path("final")
    del back, sa, sb

    # -- one step of 256 as 2 x 128 under 'save_hot' (the run's policy)
    # and under None, on one batch of the run's loader, in turns ---------
    if cfg.remat_policy != "save_hot":
        raise AssertionError(f"the shipped run's remat_policy is "
                             f"{cfg.remat_policy!r}, not 'save_hot'")
    batch = to_device(next(iter(tr.train_loader)), dev)
    if len(batch["points"]) != 256:
        raise AssertionError(f"first batch of {len(batch['points'])}")
    b256 = {"save_hot": [], "None": []}
    for i, policy in enumerate(("save_hot", None, "save_hot", None)):
        set_remat(tr.model, policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        st = tr.train_step(batch, 1000 + i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: kernels.LAUNCHES[k] for k in ("window_attn",
                                                 "octree_dwconv")}
        want = remat_launches(cfg, policy, 2)
        if got != want or not np.isfinite(float(st["loss"])):
            raise AssertionError(f"2 x 128 step under {policy}: launches "
                                 f"{got} != {want} or loss {st['loss']}")
        b256[str(policy)].append({
            "step_ms": ms, "launches": got,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    set_remat(tr.model, "save_hot")
    out["step_b256_by_remat_policy"] = b256
    del tr, batch, st
    torch.cuda.empty_cache()

    # -- pnv_evaluate on the final checkpoint ----------------------------
    torch.cuda.reset_peak_memory_stats()
    cwd = os.getcwd()
    os.chdir(work)                  # it appends pnv_Oxford_results.txt
    try:
        kernels.reset_launches()
        t0 = time.time()
        stats = pnv_evaluate.main(["--config", cfg_path, "--model_config",
                                   model_cfg, "--weights", final])
        torch.cuda.synchronize()
        eval_launches = dict(kernels.LAUNCHES)
    finally:
        os.chdir(cwd)
    out["pnv_evaluate_seconds"] = time.time() - t0
    out["eval_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for k in ("window_attn", "octree_dwconv", "octree_conv"):
        if eval_launches[k] == 0:
            raise AssertionError(f"pnv_evaluate launched no {k}")
    avg = stats["average"]
    got = {"avg_AR1": float(avg["ave_recall"][0]),
           "avg_AR1p": avg["ave_one_percent_recall"],
           "avg_MRR": avg["ave_mrr"]}
    if got != out["eval_in_training"][2]:
        raise AssertionError(f"pnv_evaluate {got} != the in-training "
                             f"evaluation {out['eval_in_training'][2]}")
    out["pnv_evaluate"] = {loc: {"AR1": float(s["ave_recall"][0]),
                                 "AR1p": s["ave_one_percent_recall"],
                                 "MRR": s["ave_mrr"]}
                           for loc, s in stats.items()}

    # -- the same recalls in numpy from the same embeddings ---------------
    embed_fn, _ = pnv_evaluate.load_model_embed_fn(params, final, dev)
    every = {}
    for split in ENTRY_SPLITS:
        sets = {}
        for kind in ("database", "query"):
            with open(os.path.join(
                    data, f"{split}_evaluation_{kind}.pickle"), "rb") as f:
                sets[kind] = pickle.load(f)
        dv = [get_latent_vectors(embed_fn, s, params)
              for s in sets["database"]]
        qv = [get_latent_vectors(embed_fn, s, params)
              for s in sets["query"]]
        r = [numpy_recall(dv[m], qv[n], sets["query"], m, n)
             for m in range(2) for n in range(2) if m != n]
        want = stats[split]
        ok = (np.array_equal(np.mean([x[0] for x in r], axis=0),
                             want["ave_recall"])
              and float(np.mean([x[1] for x in r]))
              == want["ave_one_percent_recall"]
              and float(np.mean([x[2] for x in r])) == want["ave_mrr"])
        if not ok:
            raise AssertionError(f"{split}: numpy recall {r} != "
                                 f"pnv_evaluate {want}")
        every.update({len(every) + i: e for i, e in enumerate(
            [s[j] for s in sets["database"] for j in sorted(s)])})
    out["numpy_recall_equal"] = True

    # -- one embed of all evaluation clouds at val_batch_size -------------
    bs = params.val_batch_size

    def timed(p, m):
        torch.cuda.synchronize()
        t = time.perf_counter()
        e = embed_fn(p, m)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        return e

    times = []
    get_latent_vectors(timed, every, params)          # warm-up
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        emb = get_latent_vectors(timed, every, params)
    if len(every) != bs or len(times) != 3 or not np.isfinite(emb).all():
        raise AssertionError(f"embed of {len(every)} clouds in chunks of "
                             f"{bs}: {len(times)} calls")
    out.update(embed_ms_per_256=statistics.median(times),
               embed_ms_all=times,
               embed_256_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del embed_fn
    torch.cuda.empty_cache()

    # -- grad_checkpoint at microbatch 8, fp32, under each remat policy ---
    out["grad_checkpoint_mb8_fp32"] = remat_check(
        torch, dev, parse_model_config(model_cfg).config, pts, pmask)
    shutil.rmtree(work, ignore_errors=True)
    return launches, out


DP_BATCH = 32                # dp phase: global batch as DP_ACCUM microbatches
DP_ACCUM = 4
DP_DB = 20_000               # (c): database rows, not a multiple of 2
DP_QUERIES = 1000
# the dp phase's models (multihost_smoke overrides), each with the data
# type of its two-rank run and the accum_steps of the one process that
# run is held against. All run at DropPath 0, so that each pair compared
# is the same step in exact arithmetic. Without batch statistics a row's
# gradient does not depend on the rows beside it: the layernorm ranks
# run bf16 against one process of 2 x DP_ACCUM microbatches of 4 rows,
# the ranks' own GEMM shapes (at bf16 a GEMM of 8 rows rounds otherwise
# than one of 4). With statistics a rank's rows are normalised together
# with the other rank's, so only one process with the same accum_steps,
# of other shapes, runs their step: those ranks run fp32.
DP_VARIANTS = {
    "layernorm": (["--drop_path", "0"], "bfloat16", 2 * DP_ACCUM),
    "batchnorm": (["--conv_norm", "batchnorm", "--pooling",
                   "PyramidOctGeMgc", "--drop_path", "0"], "float32",
                  DP_ACCUM),
    "powernorm": (["--conv_norm", "powernorm", "--drop_path", "0"],
                  "float32", DP_ACCUM),
}
# the row orders (multihost_smoke --reorder) whose fp32 steps give a
# model's own rounding spread; an fp32 two-rank run is held at GRAD_TOL
# times max(1, SPREAD_FACTOR x the larger spread): the ranks' step is one
# more rounding of the same sums, and two roundings each within s of the
# exact step lie within 2 s of each other. PowerNorm's stem breaks
# GRAD_TOL under a row order alone: 1.94 (reversed) and 4.17 (rolled)
# times it, the two ranks 4.17 on the same three tensors (H100 80GB
# HBM3, 700 W)
DP_REORDERS = ("reverse", "roll")
SPREAD_FACTOR = 2.0
TC_KERNELS = ("window_attn_tc", "window_attn_bwd_tc", "octree_conv_tc",
              "octree_conv_bwd_tc")


def _missing(launches, kernels=MODEL_KERNELS):
    """The kernels a run's launch counts show no launch of."""
    return [k for k in kernels if launches[k] == 0]


def _grad_ratios(got, want, zero=()):
    """Per tensor, |got - want| / (a |want| + b) with GRAD_TOL's a and b;
    for the parameters ``zero`` (``bn_shift_params``: gradient 0 in
    exact arithmetic) max(|got|, |want|) / (ZERO_GRAD_TOL times the whole
    gradient's norm) instead."""
    import torch
    total = float(torch.sqrt(sum((w.double() ** 2).sum()
                                 for w in want.values())))
    return {n: (max(float(got[n].norm()), float(w.norm()))
                / (ZERO_GRAD_TOL * total) if n in zero
                else float((got[n] - w).norm())
                / (GRAD_TOL[0] * float(w.norm()) + GRAD_TOL[1]))
            for n, w in want.items()}


def _grad_worst(got, want, zero=()):
    """(largest ``_grad_ratios``, whether every tensor of ``got`` is
    finite, the 3 tensors of largest ratio with their |want|)."""
    import torch
    r = _grad_ratios(got, want, zero)
    top = sorted(r, key=r.get, reverse=True)[:3]
    return (max(r.values()),
            all(bool(torch.isfinite(g).all()) for g in got.values()),
            [(n, r[n], float(want[n].norm())) for n in top])


def _stats_worst(got, want):
    """Largest |got - want| / (1e-6 + 1e-6 |want|) over the float buffers
    (the running statistics: "within 1e-6" as tests/test_torch_norms.py
    holds them), and whether the integer ones (PowerNorm's iters) are
    equal."""
    import torch
    worst, ints = 0.0, True
    for k, w in want.items():
        if w.is_floating_point():
            worst = max(worst, float(((got[k] - w).abs()
                                      / (1e-6 + 1e-6 * w.abs())).max()))
        else:
            ints = ints and torch.equal(got[k], w)
    return worst, ints


def _world1_run(torch, mh, args):
    """multihost_smoke's step in a process group of one rank over NCCL
    (RANK etc. set for the call only). Returns (result, tensors)."""
    from hotformerloc_torch.parallel import dist
    world1 = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                  MASTER_ADDR="localhost", MASTER_PORT=str(dist.free_port()))
    os.environ.update(world1)
    try:
        group, dev = dist.init_from_env("cuda")
        try:
            if torch.distributed.get_backend(group) != "nccl":
                raise AssertionError("world-1 group is not NCCL")
            return mh.run(args, group, dev)
        finally:
            dist.close(group)
    finally:
        for k in world1:
            os.environ.pop(k)
        torch.cuda.empty_cache()


def dp_variant(torch, name, common, work, env):
    """One DP_VARIANTS model at Oxford width through the dp phase's (a)
    and (b) (``dp_phase``). Returns its numbers, (a)'s bf16 launches and
    (b)'s ranks' launches."""
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.parallel import dist
    from hotformerloc_torch.tools import multihost_smoke as mh

    over, rank_dtype, ref_accum = DP_VARIANTS[name]
    dev = torch.device("cuda", 0)
    t0 = time.time()

    def argv(dtype, accum=DP_ACCUM, *extra):
        return [*common, *over, "--dtype", dtype, "--accum", str(accum),
                *extra]

    def one(a, group=False):
        """(result, tensors) of the step without a group, or (group)
        at world 1 over NCCL."""
        args = mh.parse_args(a + ["--out", work])
        if group:
            return _world1_run(torch, mh, args)
        res = mh.run(args, None, dev)
        torch.cuda.empty_cache()
        return res

    cfg = mh.config_of(mh.parse_args(argv("float32") + ["--out", work]))
    m = HOTFormerLoc(cfg, device="cuda")
    zero = bn_shift_params(m)
    del m
    line = {"conv_norm": cfg.conv_norm, "pooling": cfg.pooling,
            "attn_drop": cfg.attn_drop, "drop_path": cfg.drop_path,
            "zero_grad_params": len(zero)}

    # (a) world 1 over NCCL against the step without a group; bf16 (the
    # launches; the repeat gives the card's run-to-run spread), then fp32
    res16, ten16 = one(argv("bfloat16"), group=True)
    one16, t_one16 = one(argv("bfloat16"))
    rep16, t_rep16 = one(argv("bfloat16"))

    # at bf16 a gradient 0 in exact arithmetic is bf16 rounding, far
    # above ZERO_GRAD_TOL: the BN-shift parameters are left out here
    def keep(t):
        return {n: g for n, g in t["grads"].items() if n not in zero}
    w16, fin16, top16 = _grad_worst(keep(ten16), keep(t_one16))
    a16 = {"loss": res16["loss"], "loss_no_group": one16["loss"],
           "loss_repeat": rep16["loss"], "grad_worst_ratio_to_limit": w16,
           "worst_tensors": top16,
           "repeat_grad_worst_ratio_to_limit": _grad_worst(
               keep(t_rep16), keep(t_one16))[0],
           "step_s": res16["step_s"], "step_s_no_group": one16["step_s"],
           "peak_mem_gb": res16["peak_mem_gb"],
           "peak_mem_gb_no_group": one16["peak_mem_gb"],
           "octree_overflow": res16["octree_overflow"],
           "launches": res16["launches"]}
    del ten16, t_rep16
    res32, ten32 = one(argv("float32"), group=True)
    one32, t_one32 = one(argv("float32"))
    w32, fin32, top32 = _grad_worst(ten32["grads"], t_one32["grads"], zero)
    s32, ints32 = _stats_worst(ten32["buffers"], t_one32["buffers"])
    a32 = {"loss": res32["loss"], "loss_no_group": one32["loss"],
           "grad_worst_ratio_to_limit": w32, "worst_tensors": top32,
           "stats_worst_ratio_to_limit": s32, "launches": res32["launches"]}
    del ten32
    line.update(a_nccl_world1_bf16=a16, a_nccl_world1=a32)

    # (b) two gloo ranks on this card, against one process with the same
    # rows per GEMM (layernorm) or the same accum_steps
    same = {"bfloat16": (one16, t_one16), "float32": (one32, t_one32)}
    ref, t_ref = (same[rank_dtype] if ref_accum == DP_ACCUM
                  else one(argv(rank_dtype, ref_accum)))
    bar, spreads = 1.0, {}
    if ref_accum == DP_ACCUM:
        # the model's own rounding spread: its step with the rows of each
        # microbatch in another order, equal in exact arithmetic
        for how in DP_REORDERS:
            t = one(argv(rank_dtype, DP_ACCUM, "--reorder", how))[1]
            s, _, s_top = _grad_worst(t["grads"], t_ref["grads"], zero)
            spreads[how] = {"grad_worst_ratio_to_limit": s,
                            "worst_tensors": s_top}
            del t
        bar = max(1.0, SPREAD_FACTOR * max(
            s["grad_worst_ratio_to_limit"] for s in spreads.values()))
    bdir = os.path.join(work, f"b_{name}")
    dist.torchrun(["-m", mh.TOOL, *argv(rank_dtype), "--backend", "gloo",
                   "--out", bdir, "--tensors"], 2, bdir, timeout=600,
                  env=env)
    ranks, b_worst, b_stats, b_ok, b_top, shape = [], 0.0, 0.0, True, [], None
    for r in range(2):
        with open(os.path.join(bdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        ten = torch.load(os.path.join(bdir, f"rank{r}.pt"),
                         weights_only=True)
        w, fin, top = _grad_worst(ten["grads"], t_ref["grads"], zero)
        st, ints = _stats_worst(ten["buffers"], t_ref["buffers"])
        b_worst, b_stats = max(b_worst, w), max(b_stats, st)
        b_ok, b_top = b_ok and fin and ints, b_top or top
        if r == 0 and ref_accum != DP_ACCUM:
            # the same step at the same accum_steps, of other GEMM shapes
            # (printed, not checked)
            sw, _, s_top = _grad_worst(ten["grads"],
                                       same[rank_dtype][1]["grads"], zero)
            shape = {"accum_steps": DP_ACCUM,
                     "grad_worst_ratio_to_limit": sw, "worst_tensors": s_top}
        del ten
    b = {"dtype": rank_dtype, "reference_accum_steps": ref_accum,
         "reference_loss": ref["loss"], "reorder_spread": spreads,
         "grad_bar_ratio_to_limit": bar,
         "grad_worst_ratio_to_limit": b_worst, "worst_tensors": b_top,
         "stats_worst_ratio_to_limit": b_stats,
         "against_other_shapes": shape,
         "rows_per_rank": [x["rows"] for x in ranks],
         "losses": [x["loss"] for x in ranks],
         "params_bitwise_equal": ranks[0]["param_checksum"]
         == ranks[1]["param_checksum"],
         "step_s": [x["step_s"] for x in ranks],
         "peak_mem_gb": [x["peak_mem_gb"] for x in ranks],
         "launches": [x["launches"] for x in ranks]}
    line.update(b_gloo_two_ranks=b, seconds=time.time() - t0)
    del t_one16, t_one32, t_ref
    torch.cuda.empty_cache()
    emit({"phase": "dp_variant", "variant": name, **line})

    missing = [_missing(res16["launches"]), _missing(res32["launches"])] + [
        _missing(x["launches"], MODEL_KERNELS
                 + (TC_KERNELS if rank_dtype == "bfloat16" else ()))
        for x in ranks]
    if any(missing):
        raise AssertionError(f"dp {name}: kernels not launched {missing}")
    losses = [a16["loss"], a16["loss_no_group"], a32["loss"],
              a32["loss_no_group"], *b["losses"], ref["loss"]]
    if not (fin16 and w16 <= 1.0 and fin32 and ints32 and w32 <= 1.0
            and s32 <= 1.0 and all(np.isfinite(losses))
            and abs(a16["loss"] - a16["loss_no_group"])
            <= 1e-5 * abs(a16["loss_no_group"])
            and abs(a32["loss"] - a32["loss_no_group"])
            <= 1e-5 * abs(a32["loss_no_group"])):
        raise AssertionError(f"dp {name}: (a) the DP step at world 1 "
                             f"differs from the step without a group: "
                             f"{line}")
    if not (b_ok and b_worst <= bar and b_stats <= 1.0
            and b["params_bitwise_equal"]
            and b["rows_per_rank"] == [DP_BATCH // 2] * 2
            and all(abs(x - ref["loss"]) <= 1e-5 * abs(ref["loss"])
                    for x in b["losses"])):
        raise AssertionError(f"dp {name}: (b) two ranks differ from one "
                             f"process: {line}")
    return line, res16["launches"], [x["launches"] for x in ranks]


def dp_phase(torch, smi):
    """Data parallelism at Oxford width (fp32 parameters, no activation
    checkpointing), through tools/multihost_smoke on a synthetic PNV
    dataset of 2 x DP_BATCH clouds, batch DP_BATCH as DP_ACCUM global
    microbatches of 8. For each model of DP_VARIANTS (``dp_variant``):
    (a) the DP step at world 1 over NCCL against the step without a
    process group, in bf16 (the latter twice: the card's run-to-run
    spread) and at fp32; (b) two ranks as two processes on this card
    over gloo, each holding 4 rows of every global microbatch, against
    one process (DP_VARIANTS says which). Then (c) retrieval_topk sharded
    over two such ranks against one card. Returns ((a)'s bf16 launches
    and (b)'s ranks' launches per variant, the phase's numbers)."""
    import shutil

    from hotformerloc_torch.evaluation.evaluate import retrieval_topk
    from hotformerloc_torch.parallel import dist
    from hotformerloc_torch.tools import multihost_smoke as mh

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, ".chip_tmp", "dp")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "data")
    mh.make_synthetic_dataset(data, n=2 * DP_BATCH, points=4096)
    common = ["--data", data, "--config", "oxford", "--batch",
              str(DP_BATCH), "--device", "cuda"]
    out = {"card": smi, "config": "oxford_config", "grad_checkpoint": False,
           "global_batch": DP_BATCH, "microbatch": DP_BATCH // DP_ACCUM,
           "grad_tol": GRAD_TOL, "spread_factor": SPREAD_FACTOR}
    # the ranks run as separate processes that import the package from here
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [here, os.environ.get("PYTHONPATH")]))}
    launches, rank_launches = {}, {}
    for name in DP_VARIANTS:
        out[name], launches[name], rank_launches[name] = dp_variant(
            torch, name, common, work, env)
    # -- (c) retrieval sharded over two ranks --------------------------------
    t0 = time.time()
    rng = np.random.default_rng(11)
    q = rng.standard_normal((DP_QUERIES, 256)).astype(np.float32)
    db = rng.standard_normal((DP_DB, 256)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    cdir = os.path.join(work, "c")
    os.makedirs(cdir)
    np.savez(os.path.join(cdir, "in.npz"), q=q, db=db)
    dist.torchrun([os.path.abspath(__file__), "--dp-retrieval", cdir], 2,
                  cdir, timeout=600, env=env)
    got = np.load(os.path.join(cdir, "rank0.npz"))
    with open(os.path.join(cdir, "rank0.json")) as f:
        c = json.load(f)
    retrieval_topk(q, db, 25, device="cuda")           # warm-up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want_d, want_i = retrieval_topk(q, db, 25, device="cuda")
    c["single_card_s"] = time.perf_counter() - t1
    # the distances of the returned indices, recomputed here in fp64
    recomputed = np.linalg.norm(q[:, None].astype(np.float64)
                                - db[got["idx"]], axis=-1)
    c.update(seconds=time.time() - t0, database=list(db.shape),
             queries=DP_QUERIES, k=25,
             max_abs_dist_err=float(np.abs(got["dist"] - want_d).max()),
             max_abs_recomputed_err=float(np.abs(got["dist"]
                                                 - recomputed).max()),
             index_mismatches=int((got["idx"] != want_i).sum()))
    out["c_retrieval_two_ranks"] = c
    # random normal rows have no distance ties: the indices must be exact,
    # and the distances (returned and recomputed from the indices) to 1e-5
    if not (c["index_mismatches"] == 0 and c["max_abs_dist_err"] <= 1e-5
            and c["max_abs_recomputed_err"] <= 1e-5 and c["ranks_agree"]):
        raise AssertionError(f"(c) sharded retrieval off: {c}")

    shutil.rmtree(work, ignore_errors=True)
    return launches, rank_launches, out


def cylindrical_batch(torch, dev, pts):
    """The port's data path for a cylindrical model (data/pipeline.py):
    each cloud clipped to the unit box and xy-radius, converted to scaled
    (rho, phi, z) by CylindricalCoordinates and packed into (B, 4096, 3)
    points with a (B, 4096) mask."""
    from hotformerloc_torch.data.augmentation import CylindricalCoordinates
    from hotformerloc_torch.data.pipeline import clip_to_unit_box, pack_clouds
    conv = CylindricalCoordinates()
    p, m = pack_clouds([conv(clip_to_unit_box(c, True)) for c in pts],
                       pts.shape[1])
    return torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev)


CSWP_TRAIN = "training_queries_CSWildPlaces_baseline_v2.pickle"
CSWP_VAL = "test_queries_CSWildPlaces_v2.pickle"


def cswp_entry(torch, dev, smi):
    """The train CLI on configs/cs-wild-places.txt with
    configs/cs-wild-places_model.txt unchanged (full width and depth,
    grad_checkpoint on, MESA from the first epoch), cut to batch 256 as 2
    microbatches of the shipped 128, 1 epoch, eval_freq and save_freq 1,
    on a synthetic dataset under the CSWildPlaces names (write_wild_dataset:
    ENTRY_LOCS places x 2 passes, a val_file of ENTRY_EVAL places, four
    locations of 2 runs x ENTRY_EVAL places); then pnv_evaluate on the
    final checkpoint, whose average must equal the in-training
    evaluation's. Returns (the train run's launches, the numbers)."""
    import configparser
    import shutil

    from hotformerloc_torch.evaluation import pnv_evaluate
    from hotformerloc_torch.ops import kernels
    from hotformerloc_torch.training import train as train_cli

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, ".chip_tmp", "cswp_entry")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "data")
    t0 = time.time()
    locs = write_wild_dataset(data, "CSWildPlaces", CSWP_TRAIN, CSWP_VAL)
    out = {"card": smi, "dataset_seconds": time.time() - t0,
           "cuts": "batch_size 2048 -> 256 (2 x batch_split_size 128), "
                   "epochs 100 -> 1, eval_freq 5 -> 1, save_freq 10 -> 1, "
                   "synthetic data"}
    cp = configparser.ConfigParser()
    cp.read(os.path.join(here, "configs", "cs-wild-places.txt"))
    cp["DEFAULT"]["dataset_folder"] = data
    cp["TRAIN"].update(batch_size="256", batch_split_size="128", epochs="1",
                       eval_freq="1", save_freq="1")
    if (cp["TRAIN"]["train_file"], cp["TRAIN"]["val_file"]) != (CSWP_TRAIN,
                                                               CSWP_VAL):
        raise AssertionError("configs/cs-wild-places.txt names other files")
    cfg_path = os.path.join(work, "cs-wild-places_entry.txt")
    with open(cfg_path, "w") as f:
        cp.write(f)
    model_cfg = os.path.join(here, "configs", "cs-wild-places_model.txt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    tr = train_cli.main(["--config", cfg_path, "--model_config", model_cfg,
                         "--weights_dir", os.path.join(work, "weights"),
                         "--model_name", "cswp"])
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    out["train_cli_seconds"] = time.time() - t0
    out["train_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if _missing(launches):
        raise AssertionError(f"the CS-Wild-Places run launched no "
                             f"{_missing(launches)}")
    cfg, p = tr.cfg, tr.params
    if not (cfg.patch_size == 64 and cfg.octree_depth == 7
            and cfg.grad_checkpoint and cfg.adape_mode == "cov"
            and tr.model.dtype == torch.bfloat16
            and tr.train_step.cfg.accum_steps == 2 and tr.use_ema
            and p.normalize_points and p.skip_same_run
            and p.dataset_name == "CSWildPlaces"
            and tr.val_loader is not None):
        raise AssertionError(f"CS-Wild-Places run config off: {cfg}, {p}")
    with open(os.path.join(tr.weights_dir, "cswp_log.jsonl")) as f:
        log = [json.loads(ln) for ln in f]
    by = {ph: [r for r in log if r["phase"] == ph]
          for ph in ("train", "val", "eval")}
    if [len(v) for v in by.values()] != [1, 1, 1] or not np.isfinite(
            [by["train"][0]["loss"], by["val"][0]["val_loss"]]).all():
        raise AssertionError(f"CS-Wild-Places train log off: {log}")
    steps = tr.step_log
    if [st["size"] for st in steps] != [256, 64]:
        raise AssertionError(f"CS-Wild-Places batches {steps}")
    for tag in ("e1", "latest", "final"):
        if not os.path.exists(tr.ckpt_path(tag)):
            raise AssertionError(f"no checkpoint {tr.ckpt_path(tag)}")
    final = tr.ckpt_path("final")
    out.update(launches=launches, loss=by["train"][0]["loss"],
               val_loss=by["val"][0]["val_loss"],
               epoch_seconds=by["train"][0]["time"],
               steps=[{k: st[k] for k in ("size", "step_s", "wait_s")}
                      for st in steps],
               eval_in_training={k: by["eval"][0][k]
                                 for k in ("avg_AR1", "avg_AR1p", "avg_MRR")})
    tr.close()
    del tr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.time()
        stats = pnv_evaluate.main(["--config", cfg_path, "--model_config",
                                   model_cfg, "--weights", final])
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    out["pnv_evaluate_seconds"] = time.time() - t0
    out["eval_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if set(stats) != set(locs) | {"average"}:
        raise AssertionError(f"pnv_evaluate locations {sorted(stats)}")
    avg = stats["average"]
    got = {"avg_AR1": float(avg["ave_recall"][0]),
           "avg_AR1p": avg["ave_one_percent_recall"],
           "avg_MRR": avg["ave_mrr"]}
    if got != out["eval_in_training"]:
        raise AssertionError(f"pnv_evaluate {got} != the in-training "
                             f"evaluation {out['eval_in_training']}")
    out["pnv_evaluate"] = {loc: {"AR1": float(st["ave_recall"][0]),
                                 "AR1p": st["ave_one_percent_recall"],
                                 "MRR": st["ave_mrr"]}
                           for loc, st in stats.items()}
    shutil.rmtree(work, ignore_errors=True)
    return launches, out


def configs_phase(torch, dev, smi, rnd):
    """The patch-64 and no-ADaPE configurations at full width:
    (a) cs_wild_places_config serving (serve_check on the uniform batch
    and the surface-like one), with K1 at its forward's shapes (batch 32)
    and K2 at its train step's (microbatch 8) held against their plain
    versions and timed (attn_fwd_rows, attn_bwd_rows); (b) its train step
    (train_phase, 5 timed steps); (c) configs/wild-places_model.txt
    (no ADaPE: the relay-token CPE runs K3 at each pyramid level, 37 per
    forward) on the uniform batch through the cylindrical conversion:
    serve_check and train_phase (K3 296 and K4 148 per bf16 step, 5
    timed steps); (d) cswp_entry. Returns (K1 rows, K2 rows, launches per run, the
    phase's numbers)."""
    from hotformerloc_torch.config.params import parse_model_config
    from hotformerloc_torch.models.config import cs_wild_places_config
    from hotformerloc_torch.models.hotformerloc import build_model_plan
    from hotformerloc_torch.utils.profiling import bound_ms

    here = os.path.dirname(os.path.abspath(__file__))
    out, launches = {"card": smi}, {}
    pts = torch.from_numpy(clouds()).to(dev)
    pmask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    spts = torch.from_numpy(surface_clouds()).to(dev)

    # -- (a) CS-Wild-Places serving, K1 / K2 at its shapes ---------------
    t0 = time.time()
    cfg = cs_wild_places_config()
    cases = path_cases(cfg)
    name = "cs_wild_places_config"
    plan = build_model_plan(cfg, pts, pmask)
    k1 = attn_fwd_rows(dev, name, cfg, plan, cases["window_attn"], rnd,
                       bound_ms)
    del plan
    mplan = build_model_plan(cfg, pts[:MICRO], pmask[:MICRO])
    k2 = attn_bwd_rows(dev, name, cfg, mplan, cases["window_attn"], rnd,
                       bound_ms)
    del mplan
    torch.cuda.empty_cache()
    launches["cs_wild_places_forward"], out["a_cs_wild_places_serving"] = \
        serve_check(torch, cfg, pts, pmask, cases,
                    {"window_attn": 34, "octree_dwconv": 34,
                     "octree_conv": 3}, spts)
    out["a_cs_wild_places_serving"]["seconds"] = time.time() - t0

    # -- (b) CS-Wild-Places train step -----------------------------------
    t0 = time.time()
    launches["cs_wild_places_step"], out["b_cs_wild_places_train"] = \
        train_phase(torch, dev, name,
                    dataclasses.replace(cfg, grad_checkpoint=False), pts,
                    pmask, cases, timed=5)
    out["b_cs_wild_places_train"]["seconds"] = time.time() - t0

    # -- (c) Wild-Places: no ADaPE, cylindrical coordinates ----------------
    t0 = time.time()
    wfile = os.path.join(here, "configs", "wild-places_model.txt")
    wparams = parse_model_config(wfile, octree_depth=7)
    wcfg = dataclasses.replace(wparams.config, grad_checkpoint=False)
    if wcfg.adape_mode is not None or wparams.coordinates != "cylindrical":
        raise AssertionError(f"{wfile}: {wparams}")
    wpts, wmask = cylindrical_batch(torch, dev, clouds())
    wcases = path_cases(wcfg)
    launches["wild_places_forward"], serve = serve_check(
        torch, wcfg, wpts, wmask, wcases,
        {"window_attn": 34, "octree_dwconv": 37, "octree_conv": 3})
    launches["wild_places_step"], train = train_phase(
        torch, dev, "wild-places_model.txt", wcfg, wpts, wmask, wcases,
        dict(STEP_LAUNCHES, octree_dwconv=296, octree_dwconv_bwd=148),
        timed=5)
    out["c_wild_places"] = {
        "config": "configs/wild-places_model.txt (octree_depth 7)",
        "coordinates": wparams.coordinates,
        "valid_points_per_cloud": [int(wmask.sum(1).min()),
                                   int(wmask.sum(1).max())],
        **serve, "train": train, "seconds": time.time() - t0}
    torch.cuda.empty_cache()

    # -- (d) the train and evaluate CLIs on CS-Wild-Places ----------------
    t0 = time.time()
    launches["cs_wild_places_entry"], out["d_cs_wild_places_entry"] = \
        cswp_entry(torch, dev, smi)
    out["d_cs_wild_places_entry"]["seconds"] = time.time() - t0
    return k1, k2, launches, out


# ablations phase: three variants of oxford_config at full width and
# depth, each with the launches per bf16 forward its shape table gives
# (path_cases), and the kernel shapes the main path never gives the
# kernels, held against their plain versions and timed
def ablation_variants(base):
    """name -> (overrides of oxford_config, launches per bf16 forward,
    the normals of the batch are needed). C's capacities are
    oxford_config's last four entries (depths 6-9: without the stem's
    downsampling the transformer starts at depth 9)."""
    return {
        "A": (dict(conv_norm="batchnorm", xcpe=True, rt_size=2,
                   rt_propagation=True, rt_propagation_scale=0.5,
                   pooling="AttnPoolMixer"),
              {"window_attn": 34, "octree_dwconv": 0, "octree_conv": 37},
              False),
        "B": (dict(octf_use_rt=True, conv_norm="powernorm",
                   pooling="PyramidOctGeMgc", input_features="NDLP",
                   proj_drop=0.1, attn_drop=0.1),
              {"window_attn": 34, "octree_dwconv": 34, "octree_conv": 3},
              True),
        "C": (dict(disable_rt=True, downsample_input_embeddings=False,
                   pooling="PyramidOctGeM", capacities=base.capacities[-4:]),
              {"window_attn": 34, "octree_dwconv": 34, "octree_conv": 2},
              False),
    }


# the new kernel shapes held per variant: (kernel, case label)
ABLATION_ROWS = {
    "A": [("window_attn", "hosa_d6_rt2"), ("window_attn", "hosa_d5_rt2"),
          ("window_attn", "hosa_d4_rt2"), ("octree_conv", "xcpe_d7"),
          ("octree_conv", "xcpe_d6"), ("octree_conv", "xcpe_d5"),
          ("octree_conv", "xcpe_d4")],
    "B": [("window_attn", "octf_rt1")],
    "C": [("window_attn", "octf_dil1"), ("window_attn", "octf_dil4"),
          ("octree_dwconv", "cpe_d9"), ("octree_conv", "stem_conv1_d9")],
}


def conv_rows(torch, name, plan, mplan, cases, rnd, bound, need_dx):
    """K5 (batch ``plan``) and K6 (microbatch ``mplan``) at each octree_conv
    case against their plain versions at fp32 and bf16, CUDA-event times
    of the kernel, its CUDA-core body where the tensor-core one runs, and
    the plain version, with the bound. Returns (K5 rows, K6 rows)."""
    from hotformerloc_torch.ops import conv as plain
    from hotformerloc_torch.ops.kernels import octree_conv as kconv
    fwd, bwd = [], []
    for label, d, C, O, per_fwd in cases:
        for pl, rows, back in ((plan, fwd, False), (mplan, bwd, True)):
            lev = pl.octree.level(d)
            neigh, tl = pl.neighs[lev], pl.taps[lev]
            B, N, _ = neigh.shape
            taps, per_node = taps_per_node(pl, d)
            x32, dy32 = rnd(B, N, C), rnd(B, N, O)
            w32, b32 = rnd(27, C, O, scale=(27 * C) ** -0.5), rnd(O)
            row = {"case": label, "config": name, "shape": [B, N, C, O],
                   "valid_taps_per_node": per_node,
                   ("per_step" if back else "per_forward"):
                   per_fwd * (ACCUM if back else 1)}
            for dt, tdt in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
                x, w, b, dy = (t.to(tdt) for t in (x32, w32, b32, dy32))
                body = kconv.conv_body(tdt, C, O)
                if back:
                    def k(body=None, x=x, w=w, dy=dy):
                        return kconv.octree_conv_bwd(x, neigh, w, dy, need_dx,
                                                     taps=tl, body=body)

                    def ref(x=x, w=w, dy=dy):
                        return plain.octree_conv_bwd(x, neigh, w, dy, need_dx)
                    kinds = ("act", "weight", "weight")
                    err = check_bwd(k(), ref(), kinds, "octree_conv_bwd", dt)
                    nbytes = (B * N * (C * (2 if need_dx else 1) + O)
                              * x.element_size() + neigh.numel() * 4
                              + 27 * C * O * (x.element_size() + 4) + O * 4)
                    flops = (4 if need_dx else 2) * taps * C * O
                else:
                    def k(body=None, x=x, w=w, b=b):
                        return kconv.launch_conv(x, neigh, w, b, body=body)

                    def ref(x=x, w=w, b=b):
                        return plain.octree_conv(x, neigh, w, b)
                    err = compare(k(), ref(), "octree_conv", dt)
                    nbytes = (B * N * (C + O) * x.element_size()
                              + neigh.numel() * 4
                              + (w.numel() + O) * x.element_size())
                    flops = 2 * taps * C * O
                row.update({f"body_{dt}": body, f"err_{dt}": err,
                            f"ms_{dt}": time_ms(k),
                            f"plain_ms_{dt}": time_ms(ref),
                            f"library_ms_{dt}": None})
                row[f"cc_ms_{dt}"] = (time_ms(lambda: k("cc"))
                                      if body == "tc" else row[f"ms_{dt}"])
                row[f"bound_ms_{dt}"], row[f"bound_by_{dt}"] = bound(
                    nbytes, flops, dt)
            rows.append(row)
            emit({"phase": "ablation_kernel",
                  "kernel": "octree_conv_bwd" if back else "octree_conv",
                  **row})
    return fwd, bwd


def dw_rows(torch, name, plan, mplan, cases, rnd, bound):
    """K3 (batch ``plan``) and K4 (microbatch ``mplan``) at each
    octree_dwconv case against their plain versions, timed, with the
    bound. Returns (K3 rows, K4 rows)."""
    from hotformerloc_torch.ops import conv as plain
    from hotformerloc_torch.ops.kernels import octree_conv as kconv
    fwd, bwd = [], []
    for label, d, C, per_fwd in cases:
        for pl, rows, back in ((plan, fwd, False), (mplan, bwd, True)):
            lev = pl.octree.level(d)
            neigh, tl = pl.neighs[lev], pl.taps[lev]
            B, N, _ = neigh.shape
            taps, per_node = taps_per_node(pl, d)
            x32, dy32 = rnd(B, N, C), rnd(B, N, C)
            w32 = rnd(27, C, scale=(27 * C) ** -0.5)
            row = {"case": label, "config": name, "shape": [B, N, C],
                   "valid_taps_per_node": per_node,
                   ("per_step" if back else "per_forward"):
                   per_fwd * (ACCUM if back else 1)}
            for dt, tdt in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
                x, w, dy = (t.to(tdt) for t in (x32, w32, dy32))
                esz = x.element_size()
                if back:
                    def k(x=x, w=w, dy=dy):
                        return kconv.octree_dwconv_bwd(x, neigh, w, dy,
                                                       taps=tl)

                    def ref(x=x, w=w, dy=dy):
                        return plain.octree_dwconv_bwd(x, neigh, w, dy)
                    err = check_bwd(k(), ref(), ("act", "weight"),
                                    "octree_dwconv_bwd", dt)
                    nbytes = (3 * B * N * C * esz + neigh.numel() * 4
                              + 27 * C * (esz + 4))
                    flops = 4 * taps * C
                else:
                    def k(x=x, w=w):
                        return kconv.octree_dwconv(x, neigh, w)

                    def ref(x=x, w=w):
                        return plain.octree_dwconv(x, neigh, w)
                    err = compare(k(), ref(), "octree_dwconv", dt)
                    nbytes = (2 * B * N * C * esz + neigh.numel() * 4
                              + w.numel() * esz)
                    flops = 2 * taps * C
                row.update({f"err_{dt}": err, f"ms_{dt}": time_ms(k),
                            f"plain_ms_{dt}": time_ms(ref),
                            f"library_ms_{dt}": None})
                row[f"bound_ms_{dt}"], row[f"bound_by_{dt}"] = bound(
                    nbytes, flops, dt)
            rows.append(row)
            emit({"phase": "ablation_kernel",
                  "kernel": "octree_dwconv_bwd" if back else "octree_dwconv",
                  **row})
    return fwd, bwd


def ablations_phase(torch, dev, smi, rnd):
    """Variants A, B and C of oxford_config (``ablation_variants``) at full
    width and depth on the 32 uniform clouds (B, which needs normals, on
    the 32 surface-like clouds with their exact plane normals): the
    kernel rows of ABLATION_ROWS (K1/K2 at T = 50 and 49, K5/K6 at the
    xCPE's 128 x 128 and 256 x 256, K3/K4 and the stem's K5/K6 at depth
    9); serve_check (launches per bf16 forward as the variant's table);
    train_phase with 5 timed steps (the fp32 gradient comparison at
    dropout 0, the running statistics checked, A's also under
    checkpointing; B's bf16 step, with its dropout, runs no K1/K2).
    Returns (kernel rows by kernel name, launches by run, the phase's
    numbers)."""
    from hotformerloc_torch.models.config import oxford_config
    from hotformerloc_torch.models.hotformerloc import build_model_plan
    from hotformerloc_torch.utils.profiling import bound_ms

    base = oxford_config()
    pts = torch.from_numpy(clouds()).to(dev)
    pmask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    spts, snrm = (torch.from_numpy(a).to(dev)
                  for a in surface_clouds(normals=True))
    rows = {k: [] for k in MODEL_KERNELS}
    launches, out = {}, {"card": smi, "variants": {}}
    for name, (over, per_forward, normals) in ablation_variants(
            base).items():
        t0 = time.time()
        cfg = oxford_config(grad_checkpoint=False, **over)
        label = f"ablation_{name}"
        p, nrm = (spts, snrm) if normals else (pts, None)
        cases = path_cases(cfg)
        want = ABLATION_ROWS[name]
        sub = {k: [c for c in cs if (k, c[0]) in want]
               for k, cs in cases.items()}
        if sum(map(len, sub.values())) != len(want):
            raise AssertionError(f"{label}: rows {want} not in {cases}")
        plan = build_model_plan(cfg, p, pmask, normals=nrm)
        mplan = build_model_plan(cfg, p[:MICRO], pmask[:MICRO],
                                 normals=None if nrm is None else nrm[:MICRO])
        k1 = attn_fwd_rows(dev, label, cfg, plan, sub["window_attn"], rnd,
                           bound_ms)
        k2 = attn_bwd_rows(dev, label, cfg, mplan, sub["window_attn"], rnd,
                           bound_ms)
        for r in k1 + k2:
            r["config"] = label
        rows["window_attn"] += k1
        rows["window_attn_bwd"] += k2
        for k, (f, b) in (("octree_conv", conv_rows(
                torch, label, plan, mplan, sub["octree_conv"], rnd,
                bound_ms, need_dx=True)), ("octree_dwconv", dw_rows(
                torch, label, plan, mplan, sub["octree_dwconv"], rnd,
                bound_ms))):
            rows[k] += f
            rows[k + "_bwd"] += b
        del plan, mplan
        torch.cuda.empty_cache()
        launches[f"{name}_forward"], serve = serve_check(
            torch, cfg, p, pmask, cases, per_forward, normals=nrm)
        expect = {}
        for k, n in per_forward.items():         # stages 1 and 3; backward
            expect.update({k: n * ACCUM * 2, k + "_bwd": n * ACCUM})
        launches[f"{name}_step"], train = train_phase(
            torch, dev, label, cfg, p, pmask, cases, expect, timed=5,
            normals=nrm, fp32_cfg=dataclasses.replace(
                cfg, attn_drop=0.0, proj_drop=0.0), remat_check=name == "A")
        out["variants"][name] = {
            "overrides": dict(over), "batch": "surface-like, plane normals"
            if normals else "uniform", "serve": serve, "train": train}
        if cfg.xcpe:
            t1 = time.time()
            out["variants"][name]["xcpe_remat"] = dict(
                xcpe_remat_check(torch, dev, cfg, p, pmask),
                seconds=time.time() - t1)
        out["variants"][name]["seconds"] = time.time() - t0
        emit({"phase": "ablation", "variant": name,
              **out["variants"][name]})
    return rows, launches, out


def dp_retrieval_worker(cdir):
    """One rank of the dp phase's (c), over gloo on card 0: the sharded
    retrieval_topk of cdir/in.npz, timed after a warm-up; rank 0 writes
    the result and its numbers, and both ranks' results must agree."""
    import torch

    from hotformerloc_torch.evaluation.evaluate import retrieval_topk
    from hotformerloc_torch.parallel import dist
    group, dev = dist.init_from_env("cuda", "gloo")
    try:
        x = np.load(os.path.join(cdir, "in.npz"))
        retrieval_topk(x["q"], x["db"], 25, device=dev, group=group)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier(group)
        t0 = time.perf_counter()
        d, i = retrieval_topk(x["q"], x["db"], 25, device=dev, group=group)
        sec = time.perf_counter() - t0
        mine = torch.from_numpy(np.concatenate([d, i.astype(np.float32)]))
        every = dist.all_gather_rows(mine[None], group)
        agree = bool((every == every[0]).all())
        if dist.rank(group) == 0:
            np.savez(os.path.join(cdir, "rank0.npz"), dist=d, idx=i)
            with open(os.path.join(cdir, "rank0.json"), "w") as f:
                json.dump({"sharded_s": sec, "ranks_agree": agree,
                           "backend": "gloo (CUDA tensors staged through "
                                      "the host)",
                           "peak_mem_gb_rank0":
                           torch.cuda.max_memory_allocated() / 1e9}, f)
        dist.barrier(group)
    finally:
        dist.close(group)
    return 0


# kernel (a substring of its mangled name) -> SASS it must (True) or
# must not (False) hold: the redesigned probe bodies
SASS_WANT = {
    "constructs": {
        "window_product_kernel": {"HMMA": True},
        "dtab_cluster_kernel": {"RED.": False, "ATOMG": False,
                                "ATOM.E": False, "UCGABAR": True}},
    "gather": {"dwconv_resident_kernel": {"UBLKCP": True, "UCGABAR": True},
               "take_rows_kernel": {"SHFL.IDX": True, "STG.E.EF.128": True,
                                    "LDG.E.128.CONSTANT": True,
                                    "LDG.E.NA.128": False}},
}
SASS_WANT["constructs"]["softmax_kernel"] = {"STG.E.EF": True,
                                             "SHFL.BFLY": True}
SASS_WANT["constructs"]["onehot4d_kernel"] = {
    "STG.E.EF.128": True, "SHFL.IDX": True, "LDG.E.128.CONSTANT": True}
SASS_WANT["constructs"]["pad_kernel"] = {"STG.E.EF.128": True}
SASS_WANT["constructs"]["reshape_kernel"] = {"STG.E.EF.128": True,
                                             "LDG.E.NA.128": True}
SASS_WANT["constructs"]["slicestore_kernel"] = {"STG.E.EF.128": True,
                                                "LDG.E.NA.128": True}
SASS_WANT["constructs"]["selloop_kernel"] = {"STG.E.EF.128": True,
                                             "SHFL.IDX": True}
# redesign_checks' softmax row lengths
SOFTMAX_CHECK_L = (1, 31, 32, 33, 49, 64, 65, 1024)
# redesign_checks' onehot4d (rows, H) and pad (WT, K, G) cases
ONEHOT_CHECK = ((18432, 16), (1000, 6), (777, 1), (333, 8), (50, 12))
PAD_CHECK = ((8, 48, 1), (8, 48, 0), (8, 48, 2), (3, 7, 1), (1, 5, 2),
             (1, 48, 1), (5, 1, 1))
# redesign_checks' reshape and selloop lengths, selloop's nsel, and
# slicestore's (rows, C, width)
FLAT_CHECK_N = (18432, 1, 5, 4099)
SELLOOP_CHECK_NSEL = (1, 4, 32, 33, 77)
SLICESTORE_CHECK = ((392, 256, 32), (392, 256, 5), (7, 256, 24),
                    (9, 36, 24), (13, 8, 8), (3, 40, 16))


def redesign_checks(torch):
    """The redesigned probe kernels against their plain versions on the
    card beyond the probe tools' shapes: take_rows bit for bit, the
    softmax within 1e-5 max |plain|, onehot4d (indices -1, R, 2^31 - 1
    among valid ones; H 16, 6, 1, 8, 12) and pad (G 0, 1, 2; odd K; one
    window; a tail of fewer than 4 floats) bit for bit, then
    ``flat_redesign_checks``.
    Returns {case: max |kernel - plain|}; raises on a miss. Its launches
    precede the tools' counted runs."""
    from hotformerloc_torch.ops.kernels import constructs as kcon
    from hotformerloc_torch.ops.kernels import gather as kgather

    dev = torch.device("cuda")
    rng = np.random.default_rng(15)
    errs = {}
    for C, dt in ((256, torch.float32), (256, torch.bfloat16),
                  (72, torch.bfloat16), (36, torch.float32),
                  (8, torch.bfloat16)):
        B, Nx, TN = 3, 300, 257
        x = torch.from_numpy(rng.normal(0, 1, (B, Nx, C)).astype(
            np.float32)).to(dev, dt)
        tab = rng.integers(-1, Nx + 1, (B, TN, 27)).astype(np.int32)
        tab[:, :4, 0] = [-1, Nx, 0, Nx - 1]
        tab = torch.from_numpy(tab).to(dev)
        for name, xx, ii in ((f"B3_strided_C{C}", x, tab[..., 0]),
                             (f"flat_C{C}", x[1], tab[1, :, 5])):
            name += "_" + str(dt).split(".")[1]
            out = kgather.take_rows(xx, ii)
            ref = kgather.take_rows_reference(xx, ii)
            torch.cuda.synchronize()
            if out.shape != ref.shape or not torch.equal(out, ref):
                raise AssertionError(f"take_rows {name}: differs from its "
                                     f"plain version")
            errs[f"take_rows_{name}"] = 0.0
    for L in SOFTMAX_CHECK_L:
        a = rng.normal(0, 3, (37, L)).astype(np.float32)
        a[::3, ::2] = -1e9
        a[1, L // 2] = 80.0
        t = torch.from_numpy(a).to(dev)
        out, ref = kcon.softmax(t), kcon.softmax_reference(t)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        lim = 1e-5 * float(ref.abs().max())
        if not (err <= lim and torch.isfinite(out).all()):
            raise AssertionError(f"softmax L={L}: max |kernel - plain| = "
                                 f"{err} > {lim}")
        errs[f"softmax_L{L}"] = err
    R = 231
    tab_all = rng.normal(0, 1, (R, 16)).astype(np.float32)
    for rows, H in ONEHOT_CHECK:
        idx = rng.integers(-2, R + 2, (rows,)).astype(np.int32)
        idx[:4] = [-1, R, 2 ** 31 - 1, R - 1]
        tab = torch.from_numpy(np.ascontiguousarray(
            np.tile(tab_all, (1, 1 + H // 16))[:, :H])).to(dev)
        it = torch.from_numpy(idx).to(dev)
        out, ref = kcon.onehot4d(it, tab), kcon.onehot4d_reference(it, tab)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.equal(out, ref):
            raise AssertionError(f"onehot4d rows={rows} H={H}: differs "
                                 f"from its plain version")
        errs[f"onehot4d_rows{rows}_H{H}"] = 0.0
    for WT, K, G in PAD_CHECK:
        b = torch.from_numpy(rng.normal(0, 1, (WT, K, K)).astype(
            np.float32)).to(dev)
        out, ref = kcon.pad(b, G), kcon.pad_reference(b, G)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.equal(out, ref):
            raise AssertionError(f"pad WT={WT} K={K} G={G}: differs from "
                                 f"its plain version")
        errs[f"pad_WT{WT}_K{K}_G{G}"] = 0.0
    errs.update(flat_redesign_checks(torch, rng))
    return errs


def flat_redesign_checks(torch, rng):
    """reshape, selloop and slicestore against their plain versions on the
    card, bit for bit, beyond the probe's shapes: tails, one value, a view
    one element off 16-byte alignment (vec = 1); reshape at +-(2^24 + 1),
    -2^31, 2^31 - 1; selloop at nsel 1 to 77 with indices -1, nsel and
    2^31 - 1 and -0.0 and NaN table entries; slicestore at widths and C
    off a multiple of 8 and a value that doubles to inf."""
    from hotformerloc_torch.ops.kernels import constructs as kcon

    dev = torch.device("cuda")
    errs = {}

    def same(name, out, ref):
        torch.cuda.synchronize()
        bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        if out.shape != ref.shape or out.dtype != ref.dtype or not \
                torch.equal(out.view(bits[out.dtype]),
                            ref.view(bits[ref.dtype])):
            raise AssertionError(f"{name}: differs from its plain version")
        errs[name] = 0.0

    for n in FLAT_CHECK_N:
        a = rng.integers(-2 ** 31, 2 ** 31, (n + 1,), dtype=np.int64)
        a[:4] = [2 ** 24 + 1, -(2 ** 24 + 1), -2 ** 31, 2 ** 31 - 1][:n + 1]
        whole = torch.from_numpy(a.astype(np.int32)).to(dev)
        for tag, t in (("", whole[:n]), ("_off", whole[1:])):
            same(f"reshape_n{n}{tag}", kcon.reshape(t),
                 kcon.reshape_reference(t))
        for nsel in SELLOOP_CHECK_NSEL:
            tab = rng.normal(0, 1, (nsel + 2, 3)).astype(np.float32)
            tab[0, 0] = -0.0
            tab[nsel // 2, 0] = np.nan
            tab = torch.from_numpy(tab).to(dev)
            i = rng.integers(-2, nsel + 2, (n + 1,)).astype(np.int32)
            i[:4] = [-1, nsel, 2 ** 31 - 1, 0][:n + 1]
            i[-1] = nsel // 2
            it = torch.from_numpy(i).to(dev)
            for tag, t in (("", it[:n]), ("_off", it[1:])):
                same(f"selloop_n{n}_nsel{nsel}{tag}",
                     kcon.selloop(t, tab, nsel),
                     kcon.selloop_reference(t, tab, nsel))
    for rows, C, width in SLICESTORE_CHECK:
        a = rng.normal(0, 1, (rows * C + 1,)).astype(np.float32)
        a[1] = 3.3e38                    # near bf16's max: doubles to inf
        a[2] = -0.0
        whole = torch.from_numpy(a).to(dev, torch.bfloat16)
        for tag, t in (("", whole[:-1]), ("_off", whole[1:])):
            q = t.view(rows, C)
            same(f"slicestore_{rows}x{C}_w{width}{tag}",
                 kcon.slicestore(q, width),
                 kcon.slicestore_reference(q, width))
    return errs


def sass_census():
    """Counts of SASS_WANT's patterns per kernel of the built probe
    libraries (cuobjdump --dump-sass); raises where one is missing or
    present against SASS_WANT."""
    import shutil
    from hotformerloc_torch.ops.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    census = {}
    for lib, kernels_ in SASS_WANT.items():
        sass = subprocess.run([tool, "--dump-sass", str(build._target(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        fn = None
        for ln in sass.splitlines():
            if "Function :" in ln:
                fn = next((k for k in kernels_ if k in ln), None)
                if fn:
                    census.setdefault(fn, {p: 0 for p in kernels_[fn]})
            elif fn:
                for pat in kernels_[fn]:
                    census[fn][pat] += pat in ln
        for k, pats in kernels_.items():
            got = census.get(k)
            if got is None or any((got[p] > 0) != want
                                  for p, want in pats.items()):
                raise AssertionError(f"{lib}: SASS of {k} is {got}, want "
                                     f"{pats}")
    return census


def probes_phase(torch):
    """The probe tools end to end on the card (this slice's main path):
    gather_bench, then mosaic_probe constructs, gather, attn and band,
    each holding its kernels against their plain versions. The launch
    counters are zeroed before each tool's run and must show exactly the
    launches its checked and timed calls make. Returns (kernels-line
    entries built from the tools' own lines, phase numbers)."""
    from hotformerloc_torch.ops import kernels
    from hotformerloc_torch.ops.kernels import window_attn as kattn
    from hotformerloc_torch.ops.kernels import gather as kgather
    from hotformerloc_torch.ops.kernels.constructs import (
        CONSTRUCTS, onehot_plan, pad_plan, reshape_plan, selloop_plan,
        slicestore_plan, softmax_plan)
    from hotformerloc_torch.tools import gather_bench, mosaic_probe
    from hotformerloc_torch.utils import profiling

    # a kernel a tool checks and times: one checked call, then time_fn's
    # warm-up and timed calls, then device_ms's warm-up and profiled ones
    per = 1 + (2 + PROBE_REPS) + (1 + PROBE_REPS)
    cons = [f"construct_{n}" for n in mosaic_probe.CONSTRUCT_PROBES]
    n_attn, n_take = len(mosaic_probe.ATTN_FUNCTIONS), len(
        mosaic_probe.gather_inputs())
    # attn: per function K1 is checked twice (forward; forward +
    # backward) and timed twice, K2 once each; band likewise K3 and K4.
    # the attn functions' bf16 launches take the tensor-core bodies
    n_tc = sum(kattn.attn_body(torch.bfloat16, mosaic_probe.K_ATTN + G_, C_,
                               H_, mosaic_probe.BND_ATTN) == "tc"
               for H_, C_, G_, _ in mosaic_probe.ATTN_FUNCTIONS)
    want = {"gather_bench": {"take_rows": per, "dwconv_resident": 3 * per,
                             "octree_dwconv": 2 * per},
            # and the floor line: per kernel a checked call, then
            # device_ms's warm-up and profiled calls (two runs each of
            # floor_copy and floor_chain)
            "constructs": {**{k: per for k in cons},
                           "construct_floor_empty": 2 + PROBE_REPS,
                           "construct_floor_copy": 2 * (2 + PROBE_REPS),
                           "construct_floor_chain": 2 * (2 + PROBE_REPS)},
            "gather": {"take_rows": n_take * per},
            "attn": {"window_attn": n_attn * 2 * per,
                     "window_attn_bwd": n_attn * per,
                     "window_attn_tc": n_tc * 2 * per,
                     "window_attn_bwd_tc": n_tc * per},
            "band": {"octree_dwconv": 2 * per, "octree_dwconv_bwd": per}}
    want["attn"] = {k: v for k, v in want["attn"].items() if v}
    sass = sass_census()
    checks = redesign_checks(torch)
    reps = ["--reps", str(PROBE_REPS)]
    runs = {"gather_bench": lambda: gather_bench.run(["--batch", "8", *reps])}
    for cmd in ("constructs", "gather", "attn", "band"):
        runs[cmd] = lambda cmd=cmd: mosaic_probe.run([cmd, *reps])
    out, launches, retaken = {}, {}, {}
    t0 = time.time()
    for tool, fn in runs.items():
        kernels.reset_launches()
        before = profiling.RETAKEN_WINDOWS
        out[tool] = fn()
        torch.cuda.synchronize()
        retaken[tool] = profiling.RETAKEN_WINDOWS - before
        got = {k: v for k, v in kernels.LAUNCHES.items() if v}
        # a window device_ms profiled again (torch.profiler returned it
        # without device events) made PROBE_REPS more calls of one timed
        # function: every launch beyond the exact counts must be so
        # explained
        extra = {k: got.get(k, 0) - want[tool].get(k, 0)
                 for k in set(got) | set(want[tool])}
        if not all(0 <= e <= retaken[tool] * PROBE_REPS
                   and e % PROBE_REPS == 0 for e in extra.values()):
            raise AssertionError(f"{tool} launched {got}, want {want[tool]}"
                                 f" ({retaken[tool]} windows retaken)")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    tools = {"sass": sass, "redesign_checks": checks,
             "launches_per_tool_run": launches,
             "retaken_profiler_windows": retaken,
             "tools_seconds": round(time.time() - t0, 1)}

    units = ("device ms per call (torch.profiler) at the shape in "
             "'shape'; *call_ms: CUDA events around one call, host "
             "launch included")

    def entry(name, ln, source, replaces):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": ln["maxdiff"], "ms": ln["device_ms"],
                "plain_ms": ln["plain_device_ms"],
                "bound_ms": ln["bound_ms"], "bound_by": ln["bound_by"],
                "library_ms": ln.get("library_device_ms"),
                "call_ms": ln["ms"], "plain_call_ms": ln["plain_ms"],
                "library_call_ms": ln.get("library_ms")}

    res = out["gather_bench"]["results"]
    take = entry("take_rows", res["pl_take"], SOURCES["take_rows"],
                 REPLACES["take_rows"])
    take.update(
        max_abs_err=max([0.0] + [ln["maxdiff"] for ln in out["gather"]]),
        shape="T1: x (8, 4224, 256) bf16, idx = neigh[..., 0]",
        t4_ms={ln["probe"]: ln["device_ms"] for ln in out["gather"]},
        t4_library_ms={ln["probe"]: ln["library_device_ms"]
                       for ln in out["gather"]},
        t4_bound_ms={ln["probe"]: ln["bound_ms"] for ln in out["gather"]},
        plan=kgather.take_plan(8 * 4224, 32),
        units=units + " (library: torch.index_select; t4_*: T4's six "
        "cases; plan: take_plan's at T1)")
    dw = entry("dwconv_resident", res["pl_dw"], SOURCES["dwconv_resident"],
               REPLACES["dwconv_resident"])
    alt, d32 = res["pl_dw_alt_cluster"], res["pl_dw_fp32"]
    plan = {k: res["pl_dw"][k] for k in (
        "cluster", "slice", "rows", "clusters_per_sample", "smem",
        "active_clusters")}
    # each cluster reads the neighbour-table rows of its channel slice
    if plan["clusters_per_sample"] > 2:
        raise AssertionError(f"dwconv_resident reads the table "
                             f"{plan['clusters_per_sample']} times")
    dw.update(
        max_abs_err_fp32=d32["maxdiff"],
        max_abs_err_alt_cluster=alt["maxdiff"],
        k3_ms=res["dw_current"]["device_ms"], **plan,
        table_reads_per_call=plan["clusters_per_sample"],
        **{f"ms_cluster{ln['cluster']}": ln["device_ms"]
           for ln in (res["pl_dw"], alt)},
        **{f"active_clusters_cluster{ln['cluster']}": ln["active_clusters"]
           for ln in (res["pl_dw"], alt)},
        ms_fp32=d32["device_ms"],
        k3_ms_fp32=res["dw_current_fp32"]["device_ms"],
        bound_ms_fp32=d32["bound_ms"],
        plan_fp32={k: d32[k] for k in plan},
        shape="T2: x (8, 4224, 256) bf16, neigh (8, 4224, 27)",
        units=units + " (k3_ms: K3 on the same inputs, both warm in L2; "
        "ms_cluster<n>: the same call on clusters of n blocks; plan: "
        "blocks per cluster, channels per cluster, rows per block; "
        "active_clusters: cudaOccupancyMaxActiveClusters)")
    line = [take, dw]
    floor = [ln for ln in out["constructs"] if ln["construct"] == "floor"]
    if len(floor) != 1:
        raise AssertionError("mosaic_probe constructs gave no floor line")
    tools["floor"] = {k: v for k, v in floor[0].items()
                      if k.endswith("device_ms") or k == "grid"}
    for ln in out["constructs"]:
        name = ln["construct"]
        if name == "floor":
            continue
        e = entry(f"construct_{name}", ln, CONSTRUCT_SOURCE,
                  f"{_TL}mosaic_probe.py:41 (_run of k_{name} "
                  f":{CONSTRUCTS[name][2]})")
        e.update(body=ln["body"], shape=f"T3: out {ln['out']} {ln['dtype']}",
                 units=units)
        if name == "softmax":
            e["plan"] = softmax_plan(math.prod(ln["out"][:-1]),
                                     ln["out"][-1])
        elif name == "onehot4d":
            e["plan"] = onehot_plan(math.prod(ln["out"][:-1]),
                                    ln["out"][-1])
        elif name == "pad":
            e["plan"] = pad_plan(ln["out"][0], ln["out"][1] - 1, 1)
        elif name == "reshape":
            e["plan"] = reshape_plan(math.prod(ln["out"]))
        elif name == "selloop":
            e["plan"] = selloop_plan(math.prod(ln["out"]), mosaic_probe.SEL,
                                     mosaic_probe.H)
        elif name == "slicestore":
            e["plan"] = slicestore_plan(math.prod(ln["out"][:-1]),
                                        mosaic_probe.C, ln["out"][-1])
        e.update(floor=ln["floor"],
                 floor_empty_ms=tools["floor"]["empty_device_ms"],
                 floor_copy_ms=tools["floor"]["grid_copy_device_ms"],
                 floor_chain_ms=tools["floor"]["grid_chain_device_ms"])
        line.append(e)
    return line, tools


def weights_phase(torch, smi, pts, pmask):
    """Reference weights in, at Oxford width and depth
    (configs/oxford_model.txt, octree depth 9, 4096 points): a state dict
    with the reference's names and shapes (the converter's
    ``synthesize_reference_state_dict``, seed 0) saved as a .pth,
    converted by the converter's CLI to a file, loaded through
    pnv_evaluate's ``load_model_embed_fn(device="cuda")``, and the 32
    clouds embedded in bf16: K1, K3 and K5 launched (counters zeroed just
    before, read just after), the bf16 descriptors within cos >= 0.999
    of the plain path's fp32 ones; a model loaded from the same file: its
    fp32 descriptors on the kernel path against the plain path at the
    slice phase's bar (cos >= 0.9999, max abs <= 1e-4); bf16 ms per batch
    (median of 5)."""
    import shutil
    import types

    from hotformerloc_torch.config.params import parse_model_config
    from hotformerloc_torch.evaluation.embed import make_embed_fn
    from hotformerloc_torch.evaluation.pnv_evaluate import load_model_embed_fn
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.ops import kernels
    from hotformerloc_torch.tools import convert_reference_weights as crw

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, ".chip_tmp", "weights")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    mpath = os.path.join(here, "configs", "oxford_model.txt")
    mp = parse_model_config(mpath, octree_depth=9, num_points=4096)
    cfg = mp.config
    ref = os.path.join(work, "reference.pth")
    torch.save({k: torch.from_numpy(v) for k, v in
                crw.synthesize_reference_state_dict(cfg, seed=0).items()},
               ref)
    conv = os.path.join(work, "converted.pt")
    t0 = time.time()
    state = crw.main(["--weights", ref, "--model_config", mpath,
                      "--octree_depth", "9", "--num_points", "4096",
                      "--out", conv])
    convert_s = time.time() - t0
    embed, name = load_model_embed_fn(types.SimpleNamespace(model_params=mp),
                                      conv, device="cuda")
    kernels.reset_launches()
    d16 = embed(pts, pmask)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] for k in ("window_attn",
                                                 "octree_dwconv",
                                                 "octree_conv")}
    host_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        embed(pts, pmask)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t1) * 1e3)
    # the fp32 model from the same --out file, beside the one loaded
    model = HOTFormerLoc(cfg, device="cuda")
    model.load_state_dict(torch.load(conv, weights_only=True))
    k32 = make_embed_fn(model, torch.float32)(pts, pmask)["global"]
    model.set_use_kernels(False)
    p32 = make_embed_fn(model, torch.float32)(pts, pmask)["global"]
    cos = float((k32 * p32).sum(1).min())
    maxabs = float((k32 - p32).abs().max())
    cos16 = float((d16.float() * p32).sum(1).min())
    out = {"card": smi, "model_config": "configs/oxford_model.txt",
           "parameters": sum(v.numel() for v in state.values()),
           "convert_s": convert_s, "weights_name": name,
           "batch": len(pts), "launches": launches,
           "fp32_kernel_vs_plain_min_cos": cos,
           "fp32_kernel_vs_plain_max_abs": maxabs,
           "bf16_vs_fp32_plain_min_cos": cos16,
           "embed_bf16_ms_per_batch": statistics.median(host_ms),
           "embed_bf16_ms_all": host_ms}
    del model, embed
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    if not (all(launches.values()) and torch.isfinite(d16).all()
            and d16.shape == (len(pts), cfg.output_dim)
            and cos >= 0.9999 and maxabs <= 1e-4 and cos16 >= 0.999):
        raise AssertionError(f"weights phase off: {out}")
    return out


def tools_worker(path):
    """The tools phase's process: bisect_step's six stages, plan_probe and
    component_profile's band, cpe, rtsa and pool experiments at Oxford
    shapes, each tool's lines printed; writes their lines, seconds and
    the model kernels' launches over the run (counters zeroed just
    before, read just after) to ``path``."""
    import torch

    from hotformerloc_torch.ops import kernels
    from hotformerloc_torch.tools import (bisect_step, component_profile,
                                          plan_probe)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    kernels.reset_launches()
    t0 = time.time()
    out["bisect"] = bisect_step.run(["--iters", "2", "--device_iters", "1"])
    out["bisect_s"] = time.time() - t0
    t0 = time.time()
    out["plan_probe"] = plan_probe.run(["--iters", "3"])
    out["plan_probe_s"] = time.time() - t0
    t0 = time.time()
    out["component_profile"], _ = component_profile.run(
        ["--exp", "band,cpe,rtsa,pool", "--iters", "10",
         "--out", os.path.join(os.path.dirname(path),
                               "COMPONENT_PROFILE_torch.json")])
    out["component_profile_s"] = time.time() - t0
    torch.cuda.synchronize()
    out["launches"] = {k: kernels.LAUNCHES[k] for k in MODEL_KERNELS}
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def tools_phase(torch, smi):
    """The step-bisection and profile tools at Oxford shapes on the card,
    in a process of their own (``tools_worker``: torch.profiler, after
    the many profiled windows of this process's earlier phases, returned
    windows without device events): bisect_step's six stages (2 timed
    calls each: wall, CUDA events; one more under torch.profiler for the
    device time, so the host's share of each stage), plan_probe's table
    kinds and component_profile's band, cpe, rtsa and pool experiments
    (band holds K3, K4 and K5 against the plain path and raises on a
    disagreement). Every stage must have device time, at most its wall
    time; the model kernels' launches over the tools' run must cover
    K1-K6."""
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, ".chip_tmp", "tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "tools.json")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [here, os.environ.get("PYTHONPATH")]))}
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--tools-worker", path], env=env, check=True,
                   timeout=900)
    with open(path) as f:
        out = {"card": smi, **json.load(f)}
    shutil.rmtree(work, ignore_errors=True)
    stages, plan = out["bisect"], out["plan_probe"]
    bad = [ln["stage"] for ln in stages + plan
           if not (ln["device_ms"] and 0 < ln["device_ms"]
                   <= ln["wall_ms"] * 1.05)]
    if [ln["stage"] for ln in stages] != [
            "null", "octree", "octree+plan", "forward", "loss_fwd", "grad",
            "multistage"] or bad or _missing(out["launches"]):
        raise AssertionError(f"tools phase off: stages without device time "
                             f"{bad}, no launches of "
                             f"{_missing(out['launches'])}")
    return out


def xcpe_remat_check(torch, dev, cfg, pts, pmask):
    """The xCPE's conv under activation checkpointing (ablation variant
    A): one fp32 step of 16 clouds as 2 microbatches of 8 without
    checkpointing, and with grad_checkpoint under 'save_hot' and under
    None. K5's launches (counters zeroed just before, read just after):
    'save_hot' keeps every xCPE conv's output (op
    ``hotformerloc::octree_conv``), so the backward runs K5 no more times
    than without checkpointing; None runs it once more per xCPE site of
    the checkpointed blocks and microbatch. Loss within 1e-6 and
    gradients within GRAD_TOL of the step without checkpointing."""
    from hotformerloc_torch.losses.losses import make_loss
    from hotformerloc_torch.models.hotformerloc import HOTFormerLoc
    from hotformerloc_torch.ops import kernels
    from hotformerloc_torch.training.optim import (lr_schedule,
                                                   make_optimizer)
    from hotformerloc_torch.training.step import StepConfig, make_train_step

    sites = sum(c[-1] for c in path_cases(cfg)["octree_conv"]
                if c[0].startswith("xcpe_"))
    batch = pair_batch(torch, dev, pts, pmask, 2 * MICRO)
    res, out = {}, {"xcpe_sites": sites}
    for policy in ("off", "save_hot", None):
        m = HOTFormerLoc(dataclasses.replace(
            cfg, grad_checkpoint=policy != "off",
            remat_policy="save_hot" if policy == "off" else policy),
            device=dev, generator=torch.Generator().manual_seed(0),
            dtype=torch.float32)
        opt = make_optimizer(m.named_parameters(), "adam",
                             lr_schedule(5e-4, 100, 150), 1e-4)
        step = make_train_step(m, opt, make_loss(
            "truncatedsmoothap", positives_per_query=4),
            StepConfig(accum_steps=2))
        kernels.reset_launches()
        st = step(batch, 0)
        torch.cuda.synchronize()
        res[policy] = (float(st["loss"]), {n: p.grad.detach().clone()
                                           for n, p in m.named_parameters()})
        zero = bn_shift_params(m)
        out[str(policy)] = {"k5_launches": kernels.LAUNCHES["octree_conv"],
                            "k6_launches": kernels.LAUNCHES[
                                "octree_conv_bwd"]}
        del m, opt, step, st
        torch.cuda.empty_cache()
    base = out["off"]["k5_launches"]
    out["k5_recomputed_save_hot"] = out["save_hot"]["k5_launches"] - base
    out["k5_recomputed_none"] = out["None"]["k5_launches"] - base
    loss0, g0 = res["off"]
    for policy in ("save_hot", None):
        loss, g = res[policy]
        worst, fin, _ = _grad_worst(g, g0, zero)
        out[str(policy)].update(loss_diff=abs(loss - loss0),
                                grad_worst_ratio_to_limit=worst,
                                finite=fin)
    if not (out["k5_recomputed_save_hot"] == 0
            and out["k5_recomputed_none"] == 2 * sites and sites > 0
            and all(out[p]["loss_diff"] <= 1e-6 and out[p]["finite"]
                    and out[p]["grad_worst_ratio_to_limit"] <= 1.0
                    for p in ("save_hot", "None"))):
        raise AssertionError(f"xCPE under checkpointing off: {out}")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from hotformerloc_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: hotformerloc_torch not found ({e})",
              file=sys.stderr)
        return 1

    from hotformerloc_torch.models.config import oxford_config
    from hotformerloc_torch.octree.build import build_batched_octree
    from hotformerloc_torch.ops import conv as plain
    from hotformerloc_torch.ops.kernels import build
    from hotformerloc_torch.ops.kernels import octree_conv as kconv
    from hotformerloc_torch.ops.plan import build_plan, build_tap_lists
    from hotformerloc_torch.utils.profiling import bound_ms, device_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()

    # ---- 1. device -----------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build ------------------------------------------------------
    t0 = time.time()
    build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "Used" in ln
                 or "spill" in ln] for k, v in build.PTXAS_LOG.items()}
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "ptxas": ptxas})

    # ---- 3. kernels at the main path's shapes ----------------------------
    t_phase = time.time()
    cfg = oxford_config()
    pts = torch.from_numpy(clouds()).to(dev)
    pmask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    octree = build_batched_octree(pts, pmask, cfg.octree_depth,
                                  cfg.min_depth, cfg.resolve_capacities())
    plan = build_plan(octree)
    spts = torch.from_numpy(surface_clouds()).to(dev)
    soctree = build_batched_octree(spts, pmask, cfg.octree_depth,
                                   cfg.min_depth, cfg.resolve_capacities())
    if int(soctree.overflow.sum()) != 0:
        raise AssertionError("surface-like batch overflows the octree: "
                             f"{int(soctree.overflow.sum())}")
    splan = build_plan(soctree)
    # the tap lists of every level, built with any device-to-host sync
    # raising, then timed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    tap_levels = [nb for nb, t in zip(plan.neighs, plan.taps) if t is not None]
    try:
        for nb in tap_levels:
            build_tap_lists(nb)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit({"phase": "tap_lists", "sync_free": True,
          "levels": [list(nb.shape) for nb in tap_levels],
          "ms_all_levels": time_ms(lambda: [build_tap_lists(nb).dst
                                            for nb in tap_levels])})
    g = torch.Generator().manual_seed(1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    cases = path_cases(cfg)
    attn_cases, dw_cases, conv_cases = (cases["window_attn"],
                                        cases["octree_dwconv"],
                                        cases["octree_conv"])

    bound = bound_ms
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    # (row, key, call) of the K4/K5/K6 device times under torch.profiler,
    # taken after every other phase (call None: the key's body is the one
    # device_ms_bf16 already times)
    device_jobs = []
    results = {"window_attn": attn_fwd_rows(dev, "oxford_config", cfg, plan,
                                            attn_cases, rnd, bound),
               "octree_dwconv": [], "octree_conv": []}

    for label, d, C, per_fwd in dw_cases:
        x32 = rnd(BATCH, plan.neighs[octree.level(d)].shape[1], C)
        w32 = rnd(27, C, scale=(27 * C) ** -0.5)
        row = {"case": label, "per_forward": per_fwd}
        # the uniform batch (the main path's), then the surface-like one
        for tag, pl in (("", plan), ("surf_", splan)):
            neigh = pl.neighs[pl.octree.level(d)]
            B, N, _ = neigh.shape
            taps, per_node = taps_per_node(pl, d)
            row.update({f"{tag}shape": [B, N, C], f"{tag}valid_taps": taps,
                        f"{tag}valid_taps_per_node": per_node})
            for dt, tdt in dtypes.items():
                x, w = x32.to(tdt), w32.to(tdt)
                args = (x, neigh, w)
                out = kconv.octree_dwconv(*args)
                ref = plain.octree_dwconv(*args)
                row[f"{tag}err_{dt}"] = compare(out, ref, "octree_dwconv",
                                                dt)
                row[f"{tag}ms_{dt}"] = time_ms(
                    lambda: kconv.octree_dwconv(*args))
                if dt == "bf16" and not tag:       # device time, taken last
                    device_jobs.append((row, "device_ms_bf16", (
                        lambda a=args: kconv.octree_dwconv(*a))))
                nbytes = (2 * B * N * C * x.element_size()
                          + neigh.numel() * 4 + w.numel() * w.element_size())
                row[f"{tag}bound_ms_{dt}"], row[f"{tag}bound_by_{dt}"] = \
                    bound(nbytes, 2 * taps * C, dt)
                if not tag:
                    row[f"plain_ms_{dt}"] = time_ms(
                        lambda: plain.octree_dwconv(*args))
                    row[f"library_ms_{dt}"] = None
                    if d <= cfg.dense_cpe_max_depth:
                        row.update(dense_library(pl, d, x, w, out, dt))
                del out, ref
        results["octree_dwconv"].append(row)
        emit({"phase": "kernel", "kernel": "octree_dwconv", **row})

    for label, d, C, O, per_fwd in conv_cases:
        x32 = rnd(BATCH, plan.neighs[octree.level(d)].shape[1], C)
        w32, b32 = rnd(27, C, O, scale=(27 * C) ** -0.5), rnd(O, scale=0.1)
        row = {"case": label, "per_forward": per_fwd}
        # the uniform batch (the main path's), then the surface-like one
        for tag, pl in (("", plan), ("surf_", splan)):
            neigh = pl.neighs[pl.octree.level(d)]
            B, N, _ = neigh.shape
            taps, per_node = taps_per_node(pl, d)
            row.update({f"{tag}shape": [B, N, C, O], f"{tag}valid_taps": taps,
                        f"{tag}valid_taps_per_node": per_node})
            for dt, tdt in dtypes.items():
                x, w, b = x32.to(tdt), w32.to(tdt), b32.to(tdt)
                args = (x, neigh, w, b)
                body = kconv.conv_body(tdt, C, O)
                row[f"{tag}body_{dt}"] = body
                out = kconv.octree_conv(*args)
                ref = plain.octree_conv(*args)
                row[f"{tag}err_{dt}"] = compare(out, ref, "octree_conv", dt)
                row[f"{tag}ms_{dt}"] = time_ms(lambda: kconv.octree_conv(*args))
                row[f"{tag}cc_ms_{dt}"] = row[f"{tag}ms_{dt}"]
                if body == "tc":
                    # the CUDA-core body on the same inputs: before / after
                    cc = kconv.launch_conv(*args, body="cc")
                    row[f"{tag}cc_err_{dt}"] = compare(cc, ref, "octree_conv",
                                                       dt)
                    row[f"{tag}cc_ms_{dt}"] = time_ms(
                        lambda: kconv.launch_conv(*args, body="cc"))
                    del cc
                if dt == "bf16" and not tag:       # device times, taken last
                    device_jobs.append((row, "device_ms_bf16",
                                        lambda a=args: kconv.octree_conv(*a)))
                    device_jobs.append((row, "cc_device_ms_bf16", (
                        lambda a=args: kconv.launch_conv(*a, body="cc"))
                        if body == "tc" else None))
                esz = x.element_size()
                nbytes = (B * N * (C + O) * esz + neigh.numel() * 4
                          + (w.numel() + O) * esz)
                row[f"{tag}bound_ms_{dt}"], row[f"{tag}bound_by_{dt}"] = bound(
                    nbytes, 2 * taps * C * O, dt)
                if not tag:
                    row[f"plain_ms_{dt}"] = time_ms(
                        lambda: plain.octree_conv(*args))
                    row[f"library_ms_{dt}"] = None
                del out, ref
        results["octree_conv"].append(row)
        emit({"phase": "kernel", "kernel": "octree_conv", **row})
    torch.cuda.synchronize()
    del octree, plan
    emit({"phase": "kernels_seconds",
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 3b. F1: the CUDA-core conv body past the old grid cap ----------
    t_phase = time.time()
    emit({"phase": "f1_large_conv", **f1_phase(torch, dev),
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 4. the slice: embed 32 clouds ---------------------------------
    t_phase = time.time()
    launches, slice_line = serve_check(
        torch, cfg, pts, pmask, cases,
        {"window_attn": 34, "octree_dwconv": 34, "octree_conv": 3})
    emit({"phase": "slice", "config": "oxford_config", **slice_line})
    emit({"phase": "slice_seconds",
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 4b. reference weights in ----------------------------------------
    t_phase = time.time()
    emit({"phase": "weights", **weights_phase(torch, smi, pts, pmask),
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 5. backward kernels at the train path's shapes ------------------
    t_phase = time.time()
    bwd = bwd_kernel_phase(torch, dev, cfg, pts[:MICRO], spts[:MICRO],
                           pmask[:MICRO], cases, bound, rnd, device_jobs)
    emit({"phase": "bwd_kernels_seconds",
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 5b. window attention at module level: kernel vs einsum route ----
    t_phase = time.time()
    attn_ab_launches, attn_ab = attn_ab_phase(torch, smi)
    emit({"phase": "attn_ab", **attn_ab,
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 6. the train step -----------------------------------------------
    t_phase = time.time()
    train_launches, train = train_phase(
        torch, dev, "oxford_config",
        dataclasses.replace(cfg, grad_checkpoint=False), pts, pmask, cases)
    emit({"phase": "train", **train,
          "seconds": round(time.time() - t_phase, 1)})
    t_phase = time.time()
    emit({"phase": "lamb", **lamb_check(
        torch, dev, dataclasses.replace(cfg, grad_checkpoint=False), pts,
        pmask), "seconds": round(time.time() - t_phase, 1)})

    # ---- 6b. the train and evaluate entry points -------------------------
    t_phase = time.time()
    entry_launches, entry = entry_phase(torch, dev, smi, pts, pmask)
    emit({"phase": "entry", **entry,
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 6h. the dataset-preparation tools (host only) --------------------
    t_phase = time.time()
    emit({"phase": "prep", **prep_phase(smi),
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 6e. a short convergence run through the tool ----------------------
    t_phase = time.time()
    emit({"phase": "convergence", **convergence_phase(torch, smi),
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 6c. data parallelism -------------------------------------------
    t_phase = time.time()
    dp_launches, dp_rank_launches, dp = dp_phase(torch, smi)
    emit({"phase": "dp", **dp, "seconds": round(time.time() - t_phase, 1)})

    # ---- 6d. the patch-64 and no-ADaPE configurations ---------------------
    t_phase = time.time()
    cfg_k1, cfg_k2, cfg_launches, configs = configs_phase(torch, dev, smi,
                                                          rnd)
    emit({"phase": "configs", **configs,
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 6f. the off-path branches: variants A, B, C --------------------
    t_phase = time.time()
    abl_rows, abl_launches, ablations = ablations_phase(torch, dev, smi, rnd)
    abl_names = sorted(ablations["variants"])
    emit({"phase": "ablations", "variants": abl_names,
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 7. the probe tools ---------------------------------------------
    t_phase = time.time()
    probe_line, tools = probes_phase(torch)
    emit({"phase": "probes", **tools,
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 8. device times of K4/K5/K6 ---------------------------------------
    # Last: in runs that profiled these calls before the train phase,
    # several later profiled windows of the probe tools held no device
    # event at all.
    t_phase = time.time()
    for row, key, fn in device_jobs:
        row[key] = (device_ms(fn, iters=DEV_ITERS) if fn is not None
                    else row["device_ms_bf16"])
    emit({"phase": "device_times", "units": "ms per call, bf16",
          **{k: {r["case"]: {n: r.get(n) for n in ("device_ms_bf16",
                                                   "cc_device_ms_bf16")}
                 for r in rows}
             for k, rows in (("octree_dwconv", results["octree_dwconv"]),
                             ("octree_conv", results["octree_conv"]),
                             ("octree_dwconv_bwd", bwd["octree_dwconv_bwd"]),
                             ("octree_conv_bwd", bwd["octree_conv_bwd"]))},
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 8b. the train step's gathers and scatters under the profiler ----
    t_phase = time.time()
    emit({"phase": "scatter_profile", "config": "oxford_config",
          **scatter_phase(torch, dev,
                          dataclasses.replace(cfg, grad_checkpoint=False),
                          pts, pmask),
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 8d. the program's spans in a traced embed ------------------------
    # After the probes, as phase 8: a profiled window before the train
    # phase can leave the probe tools' later windows without device events.
    t_phase = time.time()
    emit({"phase": "spans", "config": "oxford_config",
          **spans_phase(torch, cfg, pts, pmask),
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 8c. the step-bisection and profile tools ------------------------
    t_phase = time.time()
    tools_line = tools_phase(torch, smi)
    emit({"phase": "tools", **tools_line,
          "seconds": round(time.time() - t_phase, 1)})

    # ---- 9. kernels line + result ----------------------------------------
    line = []
    for kname, rows in {**results, **bwd}.items():
        is_bwd = kname.endswith("_bwd")
        mult = "per_step" if is_bwd else "per_forward"

        def total(key):
            vals = [r.get(key) for r in rows]
            if any(v is None for v in vals):
                return None
            return sum(v * r[mult] for v, r in zip(vals, rows))
        by = {r["bound_by_bf16"] for r in rows}
        if kname.startswith("window_attn"):
            # the tensor-core bodies' launches; the CUDA-core body on the
            # same inputs (the bodies fp32 still runs); K2 without dtable
            tc = kname + "_tc"
            extra = {"launches_tc": (train_launches if is_bwd
                                     else launches)[tc],
                     "launches_tc_train_step": train_launches[tc],
                     "launches_attn_ab": attn_ab_launches[kname],
                     "cc_ms": total("cc_ms_bf16")}
            if is_bwd:
                extra["nodtab_ms"] = total("nodtab_ms_bf16")
            # the same at cs_wild_places_config's shapes (T = 64 / 65)
            crow = cfg_k2 if is_bwd else cfg_k1
            src = cfg_launches["cs_wild_places_step" if is_bwd
                               else "cs_wild_places_forward"]
            extra["cs_wild_places"] = {
                "launches": src[kname], "launches_tc": src[tc],
                "max_abs_err": max(r["err_fp32"] for r in crow),
                "max_abs_err_bf16": max(r["err_bf16"] for r in crow),
                **{k: sum(r[f"{k}_bf16"] * r[mult] for r in crow)
                   for k in ("ms", "cc_ms", "plain_ms", "bound_ms",
                             "library_ms")},
                "bound_by": "bytes" if {r["bound_by_bf16"] for r in crow}
                == {"bytes"} else "operations",
                "cases": {r["case"]: {
                    k: r.get(k) for k in (
                        "shape", "heads", "bnd", mult, "heads_per_round",
                        "ms_bf16", "cc_ms_bf16", "nodtab_ms_bf16",
                        "plain_ms_bf16", "bound_ms_bf16", "library_ms_bf16",
                        "ms_fp32")} for r in crow}}
        elif kname in ("octree_dwconv", "octree_conv", "octree_dwconv_bwd",
                       "octree_conv_bwd"):
            # K5 / K6: the tensor-core bodies' launches and the CUDA-core
            # bodies on the same inputs (K3 and K4 have one body); device
            # time under the profiler; the same on the surface-like batch
            tc = kname + "_tc"
            src = train_launches if is_bwd else launches
            extra = {"launches_tc": src.get(tc),
                     "launches_tc_train_step": train_launches.get(tc),
                     "cc_ms": total("cc_ms_bf16"),
                     "device_ms": total("device_ms_bf16"),
                     "cc_device_ms": total("cc_device_ms_bf16"),
                     "valid_taps_per_node": {
                         r["case"]: r["valid_taps_per_node"] for r in rows},
                     "surf_ms": total("surf_ms_bf16"),
                     "surf_cc_ms": total("surf_cc_ms_bf16"),
                     "surf_bound_ms": total("surf_bound_ms_bf16"),
                     "surf_valid_taps_per_node": {
                         r["case"]: r["surf_valid_taps_per_node"]
                         for r in rows},
                     "surf_max_abs_err": max(r["surf_err_fp32"]
                                             for r in rows),
                     "surf_max_abs_err_bf16": max(r["surf_err_bf16"]
                                                  for r in rows)}
        else:
            extra = {}
        if kname == "octree_dwconv":
            # the library call exists at the dense depth only (cuDNN's
            # grouped conv3d on the 16^3 grid): its time per forward beside
            # K3's on the same launches
            lib = [r for r in rows if r.get("library_ms_bf16") is not None]
            extra.update(
                library_ms=sum(r["library_ms_bf16"] * r[mult] for r in lib),
                library_ms_fp32=sum(r["library_ms_fp32"] * r[mult]
                                    for r in lib),
                library_cases=[r["case"] for r in lib],
                library_cases_ms=sum(r["ms_bf16"] * r[mult] for r in lib),
                library_cases_device_ms=sum(r["device_ms_bf16"] * r[mult]
                                            for r in lib),
                library_err_vs_kernel=max(r["library_err_bf16"]
                                          for r in lib),
                library_call=lib[0]["library"])
        line.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname],
            "launches": (train_launches if is_bwd else launches)[kname],
            "launches_train_step": train_launches[kname],
            "launches_entry": entry_launches[kname],
            "launches_dp": {v: la[kname] for v, la in dp_launches.items()},
            "launches_dp_two_ranks": {v: [la[kname] for la in ranks]
                                      for v, ranks in
                                      dp_rank_launches.items()},
            "launches_tools": tools_line["launches"][kname],
            "launches_cs_wild_places": cfg_launches[
                "cs_wild_places_step" if is_bwd
                else "cs_wild_places_forward"][kname],
            "launches_cs_wild_places_entry": cfg_launches[
                "cs_wild_places_entry"][kname],
            "launches_wild_places": cfg_launches[
                "wild_places_step" if is_bwd
                else "wild_places_forward"][kname],
            "launches_ablations": {
                v: abl_launches[f"{v}_{'step' if is_bwd else 'forward'}"][
                    kname] for v in abl_names},
            "launches_ablations_train_step": {
                v: abl_launches[f"{v}_step"][kname]
                for v in abl_names},
            "ablations": {f"{r['config']}:{r['case']}": {k: r.get(k) for k in (
                "shape", "heads", mult, "body_bf16", "err_fp32", "err_bf16",
                "ms_bf16", "cc_ms_bf16", "plain_ms_bf16", "bound_ms_bf16",
                "bound_by_bf16", "library_ms_bf16", "ms_fp32")}
                for r in abl_rows[kname]},
            "max_abs_err": max(r["err_fp32"] for r in rows),
            "max_abs_err_bf16": max(r["err_bf16"] for r in rows),
            "ms": total("ms_bf16"), "plain_ms": total("plain_ms_bf16"),
            "bound_ms": total("bound_ms_bf16"),
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": total("library_ms_bf16"),
            "ms_fp32": total("ms_fp32"),
            "plain_ms_fp32": total("plain_ms_fp32"),
            "bound_ms_fp32": total("bound_ms_fp32"), **extra,
            "units": ("ms per train step of batch 32 (4 microbatches of 8)"
                      if is_bwd else "ms per forward of batch 32")
            + " (bf16 unless _fp32), summed over the path's launches"})
    line += probe_line
    emit({"phase": "done", "seconds": round(time.time() - t_start, 1)})
    print(smi, flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-retrieval"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(dp_retrieval_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--tools-worker"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(tools_worker(sys.argv[2]))
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ESRGAN and SRGAN serving, training and
evaluation paths and its two bench tools' paths on one CUDA card, every
kernel included.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py [--seed N] [--only PHASE,...]

The script sets the RDB knobs of ``ops/rdb.py`` (``EXT_KERNEL``,
``ILV_KERNEL``, ``BWD_XLA``) itself: off on the default paths, on for
the drives that name them.  Each path's launch counters
(``ops.rdb.RDB_*_LAUNCHES``, ``ops.preprocess.PAIR_SYNTH_LAUNCHES``,
``ops.pair_conv.PAIR_FWD_LAUNCHES``, ``PAIR_BWD_LAUNCHES``, and the
f32 kernels' own ``RDB_FWD_F32_LAUNCHES``, ``RDB_FWD_EXT_F32_LAUNCHES``,
``RDB_FWD_ILV_F32_LAUNCHES``, ``RDB_BWD_F32_LAUNCHES``,
``RDB_BWD_EXT_F32_LAUNCHES``,
``PAIR_FWD_F32_LAUNCHES``, ``PAIR_BWD_F32_LAUNCHES``) are set
to 0 just before it and must read exactly what its steps, evals,
renders, tile batches or tool calls imply, every other counter (the
``TORCHSR_RDB_BWD=xla`` one included) at 0.  Phases, one line each:

1. probe: requires a CUDA device; prints its name and power limit.
2. build: compiles every ``torchsr_tpu_torch/ops/csrc/*.cu`` (rdb_fwd,
   rdb_bwd, rdb_ext, rdb_ilv, pair_synth, pair_conv), one nvcc each,
   started together.
3. rdb_fwd (B1): the RDB forward at the serving shape (16 tiles of
   64x64, 64 channels), at a ragged shape, at a width (140) whose runs
   lie inside a row, at the training shape (64, 32, 32, 64), whose
   runs are whole rows, and at ``eval``'s whole image (1, 44, 44, 64),
   in f32 and bf16.  Each of its five convs is
   held against its own convolution of the feature buffer the kernel
   filled, and the block against its plain PyTorch version; each check
   also prints what a wrong kernel reads under its limit, among them the
   faults proper to the bf16 kernels' kx-packed product
   (``WRONG_KXPACK``: row-end masks dropped, y0 and y2 exchanged, and at
   the wide shape a run's extension pixels left at zero), which must
   fail.  In bf16 a call with f32 permuted views of the weights (the
   trainer's) must equal the call with bf16 contiguous ones bit for bit,
   and a call's profile must hold only its own kernels (at most six);
   at each shape the schedule the launches run (runs, grids, halo box,
   ring) must be the one ``ops.rdb.fwd_schedule`` mirrors.  In f32 (the
   3xTF32 kernels, ``ops/csrc/rdb_fwd_tf32_sm90.cuh``) the same, with
   ``fwd_tf32_schedule``, the f32 views bit-equal too, a call's profile
   exactly six kernels, and two more wrong kernels that must fail, launch
   by launch and for the block: plain TF32 and 3xTF32 without lo.hi
   (``WRONG_PAIR_TF32``'s products); the 3xTF32 bound printed beside
   the FMA one.  In bf16
   also the LR batch ``train --scale 8`` gives the blocks at crop 128
   (16, 16, 16, 64) (``--scale 2``'s (16, 64, 64, 64) is the serving
   shape).  Median times over 30 calls (CUDA events) and the device
   time beside the bound.
4. rdb_fwd_ext (B7): the row-extended forward, checked as rdb_fwd on the
   data rows of its padded buffer, at the serving shape, a row-ragged
   eligible one, a wide eligible one (W = 144) and the training shape;
   its pad rows must be zero, what a kernel that writes them reads is
   printed, and the block and its buffer must equal B1's on the same
   inputs bit for bit (f32 too: one 3xTF32 code path).  Routing: with the knob set, an ineligible width (45) goes to
   B1.
5. rdb_fwd_ilv (B6): the interleaved forward, checked as rdb_fwd on the
   mid copies of its buffer (the up and dn copies must equal the rows
   above and below, zeros at the image edges), at the serving shape, the
   ragged one, the wide (2, 6, 140), (4, 1, 9), where every row is an
   image's first and last, and ``eval``'s (1, 44, 44), in f32 and bf16,
   against B1, beside three wrong kernels (``WRONG_ILV``: one chunk's up
   and dn copies swapped, the image-edge zeroing skipped, a run's end
   halo pixel dropped), each where it can show.  A call's profile must
   hold six kernels, all its own, and the schedule the launches run the
   one ``ops.rdb.ilv_schedule`` mirrors (f32: ``ilv_tf32_schedule``).
   In bf16 a call with f32 views of the weights must equal the bf16 one
   bit for bit.  In f32 (the 3xTF32 kernels, ``ops/csrc/
   rdb_ilv_tf32_sm90.cuh``) plain TF32 and 3xTF32 without lo.hi
   (``WRONG_PAIR_TF32``) must each fail at some shape, launch and block,
   and no launch may read more than ``ILV_DRIFT`` times the emulated
   3xTF32 forward (``rdb_ilv_3xtf32_reference``: the kernel's chains
   summed in f32) at that shape, the ratio printed.  Routing: a forward that a backward follows goes to B1.
6. rdb_bwd (B2): the RDB backward at the training shape (64, 32, 32, 64),
   a ragged one and the ``--scale 2`` and ``--scale 8`` LR batches (16,
   64, 64, 64) and (16, 16, 16, 64), f32 and bf16; every stage (each
   cotangent dy_j of the kernel's DY buffer, dx, each dW and db) held
   against a plain computation of the kernel's own inputs to it, the
   whole against ``rdb_bwd_reference``, beside five wrong kernels; dW
   and db bit-equal over two backwards; a call's profile holding only
   its own kernels (at most eight in bf16), with its device time by
   kernel.  In f32 (the 3xTF32 kernels, ``ops/csrc/
   rdb_bwd_tf32_sm90.cuh``) also plain TF32 and 3xTF32 without lo.hi
   (``WRONG_BWD_TF32``), which must fail, what the emulated 3xTF32
   backward reads (beside the launch's: drift on the tensor core shows
   as a launch reading more), a call's profile exactly eight kernels,
   the schedule the launches run the one ``ops.rdb.bwd_tf32_schedule``
   mirrors, and the 3xTF32 bound printed beside the FMA one.
7. rdb_bwd_ext (B8): the row-extended backward, checked as rdb_bwd on
   the data rows (in f32 also at the two ``--scale`` batches), DY's pad
   rows zero, the whole against B2 on the same feature buffer (in f32
   bit for bit: one 3xTF32 code path), beside two wrong kernels proper
   to the padded layout (and in f32 rdb_bwd's).
8. pair_synth (B3): the fused pair synthesis at the bench tool's shape
   (64, 96, 96, 3), the training crops' (64, 128, 128, 3), an odd size
   (3, 148, 148, 3) with each flip and (5, 100, 100, 3), whose 25 LR rows
   the four bands cut unevenly: HR bit for bit and LR within one uint8
   level at <= 0.1% of values against the plain version, beside five
   wrong kernels (the last: each band's window one HR row short); timed
   beside the plain version.
9. pair_conv (B4, B5): the 3x3 64 -> 64 conv forward and backward at
   the bench tool's shape (128, 24, 24, 64), a ragged multi-image one,
   the gate's largest image, an all-edge (4, 3, 2, 64) and a ragged
   persistent schedule (7, 33, 46, 64), f32 and bf16: y, dx, dW and db
   per element against the plain versions, beside five wrong kernels
   (six where a persistent CTA walks several runs: ``stale_stage``; in
   f32 also the 3xTF32 products short of a term, ``WRONG_PAIR_TF32``,
   forward and backward); two backwards' dW and db bit-equal; timed
   beside the plain versions and the library call (cuDNN's convolution
   and its ``convolution_backward``, TF32 off), each call's profile
   holding only its own kernels (one for B4, three for B5).
10. bench_preprocess, bench_pair_conv: the two bench tools
    (``torchsr_tpu_torch/tools/``) at their default shapes (and
    bench_pair_conv again with ``--dtype f32``), in this process,
    printing their own lines; the pair counters must read what their
    calls imply.
10a. bn_act: the SRGAN generator's BatchNorm with its PReLU or skip add
    (``ops/bn_act.py``, two launches each way) at the tower's shape
    (128, 24, 24, 64): each variant in bf16 and f32, training and eval,
    forward and backward, against its plain version (the module
    composition on cuDNN) within ``BN_ACT_LIMITS``, beside a float64
    restatement of the formulas and an emulated fault (dx without its
    mean(dz * xhat) term) that must read over them; the calls timed
    beside their bytes bound, the plain version and cuDNN's
    ``F.batch_norm``, per kernel; the pretrain
    at batch 128: a captured step stands for 33 forward and 33 backward
    calls, a call of 8 replays counts 8 times that, and the kernels'
    device time a step.
11. train_grad, train_grad_ext, train_grad_xla: one L1 backward of the
    23-RRDB generator, every parameter gradient of the kernel path
    against the plain path, f32 and bf16 (each dtype on its own
    counters): on B1/B2, with ``EXT_KERNEL`` on B7/B8, and with
    ``BWD_XLA`` on B1 and the plain backward (its own counter).
12. generator: the 23-RRDB ESRGAN (seeded random weights) on one tile
    batch, kernel path against plain path in f32 and bf16 (generators
    with wrong blocks must read over the f32 limit; one whose blocks
    multiply in plain TF32 at the blocks' default init), timed in bf16,
    and a ``profile`` line (``torch.profiler`` device time per
    kernel class over three tile batches).
13. serve, the main path: the weights saved as a .pth,
    ``CheckpointUpscaleService`` on ``cuda`` behind ``make_server``,
    three PNG requests over HTTP, on B1; the answers held against the
    same tiling of the generator.
14. serve_ilv: the same three requests with ``ILV_KERNEL`` set, on B6.
15. serve_graph, serve_graph_ilv: a 200x300 frame tiled (64 px, overlap
    8, batch 16) through the graphed tile forward (``infer/tiled.py``
    ``tile_forward``: each tile batch one replay of a captured CUDA
    graph) against the eager one, bf16 on B1 and with ``ILV_KERNEL`` on
    B6: equal bytes, two graphed frames the same bytes, equal launch
    counts (the capture's warm-up forward and first replay counted
    apart); a tile batch's wall and device ms and busy share, graphed
    and eager.
16. export: ``export`` (the CLI) of the 23-RRDB checkpoint at (16, 64,
    64, 3), native (bf16, the RDB operator) and portable (f32, aten):
    the native artifact launches B1 (345 a batch) and equals the live
    graphed generator within ``TOL_SERVE_LEVELS``; the portable one
    launches nothing and is held against the f32 plain generator;
    ``serve ARTIFACT`` answers a request; ``eval --artifact`` scores the
    eval images.
17. batching: eight concurrent tile-sized requests through
    ``CheckpointUpscaleService(batch_requests=True)`` against the same
    frames unbatched: within ``TOL_SERVE_LEVELS``, more than one tile a
    forward, B1 at 345 launches a batcher forward.
18. test: ``python -m torchsr_tpu_torch test`` (called in this process)
    on one image, whole-image and tiled.
19. train: ``python -m torchsr_tpu_torch train`` (in this process) on
    seeded PNGs at full width, one pretrain and one GAN epoch (their
    steps replays of captured CUDA graphs after each phase's first),
    then ``test`` on its gan-best; B1 and B2.
20. train_ext: the same drive with ``EXT_KERNEL`` set (B7 and B8: the
    32x32 crops and the 48x64 sample are eligible), then ``test`` on
    its gan-best whole-image (W = 140 is not: B1) and tiled (64x64
    tiles: B7).
20a. train_f32, train_f32_ext: the train drive with ``--disable-amp``
    (TF32 off): every step's forward and backward, every eval and render
    on the f32 (3xTF32) B1 and B2 (``rdb_fwd_f32``, ``rdb_bwd_f32``; with
    ``EXT_KERNEL`` B7 and B8), no bf16 launch; then ``test`` on its
    gan-best (bf16: B1, and with ``EXT_KERNEL`` tiled on B7).
21. eval: ``python -m torchsr_tpu_torch eval`` (in this process) on
    the train phase's gan-best over seeded PNGs of mixed sizes (one
    width not a multiple of 4, one image below the SSIM window, which
    must be skipped), whole-image and tiled, f32 and bf16: B1 5 x 69
    launches a generator forward; every value finite; each report's
    per-image PSNR/SSIM recomputed in float64 numpy from the float SR it
    scored, equal to the report's rounding; one f32 SR against
    ``plain_generator`` on the card (a generator whose blocks lost conv5
    must read over that limit; what one whose blocks multiply in plain
    TF32 reads is printed); the f32 report
    again with TF32 allowed, and the difference printed.
21a. eval_ilv: eval's four runs with ``ILV_KERNEL`` set: B6 5 x 69
    launches a generator forward (f32 on ``rdb_fwd_ilv_f32``, bf16 on
    ``rdb_fwd_ilv``), B1's counters 0; each report recomputed in float64;
    every SR within the generator's tolerance of B1's (the same runs
    first, on B1) and each per-image PSNR within what that can move it.
    Under ``--only`` without the train phase it scores the seeded 23-RRDB
    generator.
22. interp: ``interp`` of the train phase's psnr-best and gan-best at
    alpha 0.2 (alpha 0 and 1 must return the inputs bit for bit), then
    ``eval`` of the blend (B1).
23. srgan_train: ``train --model srgan`` at full width (16 blocks, crop
    96, the full VGG19), one epoch per phase at batch 16, then ``test``
    (whole-image and tiled), ``serve`` (two requests at the SRGAN
    serving tile 256, held against the generator's own tiling) and
    ``eval`` on its gan-best, bn_act's counters at SRGAN_BN calls a
    generator pass (bf16 steps, ``test`` and ``serve``, f32 evals,
    renders and ``eval``), every other counter 0 on each; the two steps'
    times at batch 16.
24. multistep: the trainer's K-step programs, whose calls replay one
    captured CUDA graph a step: K = 2 ESRGAN GAN steps and K = 8 SRGAN
    pretrain steps (full width, batch 16) from one saved state against
    the same eager steps, held on each category of the state
    (parameters, BatchNorm buffers, Adam moments and steps) within the
    noise floor of two eager runs; two faulted runs that must fail that
    limit (replays without the new batch; a graph that baked its
    learning rate at capture, after the call set a new one); the real
    graph at the new rate; a resume from a checkpoint (the trainer drops
    its graphs) and replays against eager steps again; a captured step's
    launch counts (B1 345, B2 69; SRGAN's bn_act 33 and 33) and the
    counters at replays x that; eager and replayed step times, kernels
    and busy shares.
25. bench: ``torchsr_tpu_torch/tools/bench.py``'s five metrics in its
    order at its configurations (ESRGAN GAN batch 64, SRGAN GAN and
    pretrain batch 128, tiled 1080p -> 4K for both, through the graphed
    tile forward) with fewer measured steps and frames: names, finite values, the card, and the launch
    counters at what the calls imply.
26. train_speed: pretrain and GAN step times at batch 16 and 64 (eager
    steps), and a ``train_profile`` line for one GAN step at 64.
27. external (after test, on its checkpoint): the 23-RRDB weights under
    xinntao's old-arch names, and exported by
    ``tools/export_torch_checkpoint.py`` under xinntao's new-arch and
    BasicSR's: ``test`` and one ``serve`` request on each give the
    reference-named checkpoint's bytes, B1 at 345 launches a forward;
    the BasicSR file loads back to the same weights.
28. pack_train (after interp; 28-31 on seeded PNGs, 40 training images
    and 4 eval images of 160 x 160, full width, crop 128, batch 16):
    ``pack`` of both, the first epoch's crops from the pack under
    ``--shuffle-window 4`` byte-equal to the directory's, ``train``
    from the packs with ``--shuffle-window 4 --data-workers 2
    --sample-image``, one epoch each phase, async saves, B1 and B2 at
    what the steps, evals and renders imply; ``eval`` on the eval pack
    equal to ``eval`` on its directory.
29. scale: ``train --scale 2`` and ``--scale 8`` (B1/B2 at LR 64 x 64
    and 16 x 16), ``test`` on each gan-best (2x / 8x the input) and one
    ``serve`` request on the 8x one, the launches exact.
30. preempt: ``train`` in a subprocess receives SIGTERM after a capture
    and two replays of the pretrain: it exits 0 with
    ``esrgan-psnr-latest.pth`` at that step; the resume re-runs the
    epoch; an async and a sync save of one state are byte-equal (each
    one's stall of the loop printed).
31. fast_compile: ``train`` and ``train --fast-compile`` from one seed
    (7 steps an epoch): the flag logs its one line, both runs capture
    the same graphs and their gan-latest is equal bit for bit, equal
    launches; the replayed step time and the time to the first step
    both ways.
32. shard_tiles (after external, on its generator and checkpoint): a
    1080p frame through ``tiled_upscale_sharded`` over the card listed
    twice (a replica and a graph each) equal to ``tiled_upscale`` bit
    for bit; ``test --shard-tiles`` and a ``--shard-tiles`` service
    answer; ``pair_conv`` split over the list (B4/B5 once a part).
33. halo: a 2 x 2 grid on the card listed four times: a 1-RRDB
    generator exact against its monolithic forward in f32, the full
    ESRGAN in bf16 no further from its monolithic forward than the
    tiled path at the same overlap; ``test --spatial-shard``.
34. subpixel_head: SRGAN's 9x9 head (partially folded at 4x) and
    ESRGAN's 3x3 tail in subpixel space against the direct conv, per
    element in f32 and bf16, both times at the serving tile batches and
    the headline batch (forward and backward); both generators both
    ways (B1 on ESRGAN's); BatchNorm's one-pass form against
    ``nn.BatchNorm2d`` at the SRGAN tower's shape.
35. ddp_train (after fast_compile): ESRGAN's ``train`` three times in
    one process under ``torchrun --standalone --nproc-per-node 1``,
    twice without the launcher's variables, then with them (NCCL, world
    1, the gradients' all-reduce captured with each step, the
    preemption vote after each call): its gan-latest within the noise
    floor of the other two; B1/B2's launches exact in each; the epoch
    loop's replayed step timed in each.
36. prefetch (after ddp_train): the prefetcher's host-to-device copies
    on a stream of their own under ``torch.profiler``, every batch
    bit-equal to its host arrays although the consumer's stream holds
    back its read; replayed ESRGAN GAN steps fed by the prefetcher
    bit-equal to the same steps fed by synchronous copies, the launches
    exact; the headline's replayed SRGAN pretrain steps fed from a pack
    through the loader, their time and the device's busy share.

Then a ``seconds`` line (each phase's wall time), the card's name and
power limit again, a ``kernels`` JSON line (all eight kernels, f32
paths of B1, B2, B4, B5, B6, B7 and B8 in rows of their own, and
bn_act's forward and backward in bf16 and f32), and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero and prints no last line.
``--only`` runs the named phases after probe and build (for kernel
work): rdb_fwd, rdb_fwd_ext, rdb_fwd_ilv, rdb_bwd, rdb_bwd_ext,
pair_synth, pair_conv, bench_preprocess, bench_pair_conv, bn_act,
train_grad,
train_grad_ext, train_grad_xla, train, train_ext, train_f32,
train_f32_ext, train_speed, eval and interp (each after train),
eval_ilv, srgan_train, multistep, bench, serve_graph, export, batching,
external, shard_tiles, halo (these six on a seeded
23-RRDB generator), pack_train, scale, preempt, fast_compile,
subpixel_head, ddp_train, prefetch; and multi_card, on a machine with several
cards only (``torchrun --nproc-per-node N`` training for both models,
every rank's state the same; a frame over the N cards equal to one
card's; the halo grid over them).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from torchsr_tpu_torch import cli  # noqa: E402
from torchsr_tpu_torch.infer.server import (  # noqa: E402
    CheckpointUpscaleService,
    make_server,
)
from torchsr_tpu_torch.infer.tiled import _positions, tiled_upscale  # noqa: E402
from torchsr_tpu_torch.models.esrgan import (  # noqa: E402
    ESRGANGenerator,
    ResidualDenseBlock,
)
from torchsr_tpu_torch.models.layers import leaky_relu  # noqa: E402
from torchsr_tpu_torch.data.preprocess import (  # noqa: E402
    _apply_flips,
    synthesize_pair,
)
from torchsr_tpu_torch import ops as ops_pkg  # noqa: E402
from torchsr_tpu_torch.ops import _build  # noqa: E402
from torchsr_tpu_torch.ops import bn_act as bn_ops  # noqa: E402
from torchsr_tpu_torch.ops import pair_conv as pc_ops  # noqa: E402
from torchsr_tpu_torch.ops import preprocess as ps_ops  # noqa: E402
from torchsr_tpu_torch.ops import rdb as rdb_ops  # noqa: E402
from torchsr_tpu_torch.ops.resize import (  # noqa: E402
    INV_255,
    _quantize_pixels,
    nearest_upsample,
    resample_matrix,
)
from torchsr_tpu_torch.tools import (  # noqa: E402
    bench_pair_conv,
    bench_preprocess,
)
from torchsr_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)

# H100 SXM published peaks (dense): the bound of a kernel is the larger
# of its bytes over HBM bandwidth and its operations over the peak rate
# of their type.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# The dense TF32 peak: an f32 product taken as three TF32 ones (3xTF32)
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
RDB_FLOP_PER_PX = 2 * 9 * sum(
    ci * co for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)
)  # 479,232
SERVE_RDB_SHAPE = (16, 64, 64, 64)  # tile_batch 16 of 64 px LR tiles
RAGGED = (3, 37, 45)  # partial CTA tiles, as the whole-image `test` gives
# ``eval``'s whole 176 x 176 HR image (EVAL_SIZES' first) in LR: one image
# a call, as the f32 eval, validation and renders run the blocks; the
# generator-level limits cannot tell plain TF32 there (``phase_eval``),
# so this hold is what guards that path's precision.
EVAL_RDB_SHAPE = (1, 44, 44, 64)
# Wider than 64: the bf16 forward's runs lie inside a row, two a row,
# each with an extension pixel at each end (``run_edge_lost`` shows);
# the second is also eligible for the row-extended kernels.
WIDE = (2, 6, 140)
EXT_WIDE = (2, 6, 144)
# The row-extended kernels (B7, B8) take the shapes the JAX package's
# gate admits (H * W <= 4096, W % 16 == 0); the serving and training
# shapes do.  This one also does, with 16-row tiles that straddle the
# images' pad rows.  A width of 45 does not: with the knob set, such a
# block must still go to B1.
EXT_RAGGED = (3, 37, 48)
EXT_INELIGIBLE = (2, 16, 45)
SCALE = 0.2  # the blocks' residual scale
NUM_RRDB = 23
# The LR batches ``train --scale 2`` and ``--scale 8`` give the blocks at
# crop 128 and batch 16 (scale 2's forward shape is the serving one).
SCALE_RDB_SHAPES = {"scale2": (16, 64, 64, 64), "scale8": (16, 16, 16, 64)}
# The launch counters, by kernel: (module, attribute), the model kernels'
# (``ops.MODEL_KERNELS``: RDB, bn_act) named after their attributes.
# "rdb_bwd_xla" counts the TORCHSR_RDB_BWD=xla backward (no kernel), 0 on
# every path here; the pair kernels run on the two bench tools' paths only.
COUNTERS = {
    **{attr.removesuffix("_LAUNCHES").lower(): (module, attr)
       for module in ops_pkg.MODEL_KERNELS
       for attr in module.LAUNCH_COUNTERS},
    "pair_synth": (ps_ops, "PAIR_SYNTH_LAUNCHES"),
    "pair_fwd": (pc_ops, "PAIR_FWD_LAUNCHES"),
    "pair_bwd": (pc_ops, "PAIR_BWD_LAUNCHES"),
    "pair_fwd_f32": (pc_ops, "PAIR_FWD_F32_LAUNCHES"),
    "pair_bwd_f32": (pc_ops, "PAIR_BWD_F32_LAUNCHES"),
}
# Per-element limits.  A result passes when at every element
#     |got - ref| <= rel * |ref| + frac * max|ref - base|,
# where max|ref - base| is the largest value the checked computation
# adds: a launch's output (base 0), or the block's residual
# scale * conv5 (base x).  "excess" is the largest ratio of the left
# side to the right, and at most 1 passes.  Beside each, the excess of
# a wrong result is printed (a grown slice left at zero, conv5 skipped):
# it must exceed 1, or the limit could not see that fault.
#
# A launch against the same convolution (f32, TF32 off) of the feature
# buffer the kernel itself filled.  f32 differs in summation order only
# (~1e-7 of the values); bf16 also rounds once to bf16, at most 2^-8 of
# the value, and rel 2^-7 allows a tie rounded the other way.
STAGE_LIMITS = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2**-7, 1e-3)}
# The block against its plain version in f32 on the same inputs.  In
# bf16 the four rounded intermediates (2^-9 of their values on average)
# also feed conv5, so frac is 2^-5 of the largest residual.
BLOCK_LIMITS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2**-7, 2**-5)}
# The whole generator in f32, kernel path against plain path on the
# same weights: 351 convs summed in other orders.  Limits on the
# generator are fractions of the largest output value of its f32 plain
# path.
TOL_GEN_F32 = 1e-5
# The generator in bf16 against that f32 plain path.  At the model's
# own init (RDB kernels kaiming-normal x 0.1) what the blocks add to the
# output is of the order of the bf16 rounding of the input and of the
# other convs, so this limit bounds gross errors only.  With the
# blocks' convs at torch's default init they add more, and there the
# bf16 kernel path is also held against the bf16 plain path (the same
# rounding of the input and of the other convs) to a fraction of what
# a generator with wrong blocks reads against the f32 plain path.
TOL_GEN_BF16 = 0.05
GEN_BF16_FRAC = 0.25
# The RDB kernels at the training shape: batch 64 of 128 px HR crops,
# so 32 x 32 LR pixels through the generator's blocks.
TRAIN_RDB_SHAPE = (64, 32, 32, 64)
# One backward is a dgrad and a wgrad per conv: twice the forward's
# operations.
RDB_BWD_FLOP_PER_PX = 2 * RDB_FLOP_PER_PX
# Each stage of the backward against the same computation (f32, TF32
# off) of the kernel's own inputs to that stage: dW_i from feat and the
# kernel's dy_i, db_i from the da_i that the kernel's later cotangents
# give.  The products of working-dtype operands are exact in f32 in
# both, so f32 and bf16 differ in summation order only: sums of 65,536
# pixels.
BWD_STAGE_LIMITS = {torch.float32: (1e-4, 1e-4),
                    torch.bfloat16: (1e-4, 1e-4)}
# Each cotangent dy_j, and dx, against the same sum of dgrads of the
# kernel's own later cotangents (288-1,728 products), times LeakyReLU'
# (plus g for dx), rounded once to the working dtype.  The sums differ
# in order only; in bf16 a sum at a rounding tie rounds one step either
# way, at most 2^-7 of the value.  f32 as BWD_STAGE_LIMITS.
DY_LIMITS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2**-7, 1e-4)}
# The whole backward against rdb_bwd_reference on the same inputs.  In
# bf16 a dense-gradient value that lands on the other side of a rounding
# step rounds the next conv's dy one step (2^-8) apart.
BWD_BLOCK_LIMITS = {torch.float32: (1e-4, 1e-4),
                    torch.bfloat16: (2**-7, 2**-6)}
# The wrong backward kernels each limit must see (emulated in plain
# PyTorch): conv 3's dW left at zero, LeakyReLU' taken as 1, the dgrad
# taps not flipped, conv5's cotangent dy_4 left out of every dense
# gradient (dx's included), and each slot conv's K stopping short of
# the farthest cotangent (dy_4), dx's conv reading all of DY.
WRONG_BWD = ("dw3_zero", "lrelu_one", "taps_unflipped", "conv5_dropped",
             "dy_suffix_short")
# The f32 backward's products short of a term (plain TF32, and 3xTF32
# without lo.hi), emulated by ``rdb_bwd_3xtf32_reference``: each must
# read over the f32 limits.
WRONG_BWD_TF32 = {"tf32_once": (("hi", "hi"),),
                  "cross_term_dropped": (("hi", "hi"), ("hi", "lo"))}
# At most this many kernels in one bf16 backward call's profile, and
# exactly this many in an f32 one: prep, four slot convs, dx, wgrad,
# reduce (no flip or cast beside them).
BWD_BF16_KERNELS = 8
BWD_F32_KERNELS = 8
# train_grad: one L1 backward of the 23-RRDB generator, every parameter
# gradient of the kernel path against the plain path (autograd through
# rdb_reference), as max|kernel - plain| / max|plain| per tensor.
TRAIN_GRAD_BATCH = 4
TOL_GRAD = {torch.float32: 1e-3, torch.bfloat16: 0.1}
# A served frame against the same tiling of the generator, both rounded
# to uint8: the same computation, so at most a rounding tie apart.
TOL_SERVE_LEVELS = 1
REQUEST_SIZES = ((64, 64), (128, 160), (120, 200))
# train, the main path: seeded random PNGs, split 90/10 by the CLI
# (36 train, 4 eval), one pretrain and one GAN epoch at batch 16, the
# full-width generator (23 RRDBs) and the full VGG19 trunk, bf16.
TRAIN_IMAGES = 40
TRAIN_IMAGE_HW = (160, 160)
TRAIN_BATCH = 16
SAMPLE_HW = (48, 64)  # the per-epoch progress sample's LR size
# Step times are also taken at the JAX package's default batch.
SPEED_BATCHES = (16, 64)
SPEED_STEPS = 5
TEST_IMAGE = (100, 140)
DEVICE = "cuda"


def say(phase: str, **fields) -> None:
    print(f"{phase}: {json.dumps(fields)}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def reset_counters() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_counters() -> dict:
    return {name: getattr(module, attr)
            for name, (module, attr) in COUNTERS.items()}


def fwd_counter(kernel: str, dtype: torch.dtype) -> str:
    """The counter of RDB ``kernel`` ("rdb_fwd", "rdb_fwd_ext",
    "rdb_fwd_ilv", "rdb_bwd" or "rdb_bwd_ext") in ``dtype``: f32 runs the
    3xTF32 kernels, counted apart."""
    return f"{kernel}_f32" if dtype == torch.float32 else kernel


def check_counts(path: str, got: dict, **want) -> None:
    """Every counter equals ``want`` (0 where not named)."""
    want = {name: want.get(name, 0) for name in COUNTERS}
    check(got == want, f"{path}: kernel launches {got} == {want}")


@contextlib.contextmanager
def knob(name: str, value: bool = True):
    """Set one of ops/rdb.py's knobs for the block; restore it after."""
    old = getattr(rdb_ops, name)
    setattr(rdb_ops, name, value)
    try:
        yield
    finally:
        setattr(rdb_ops, name, old)


def median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def rdb_bound_ms(shape, dtype) -> tuple[float, str]:
    """The forward reads x, the kernels and the biases once and writes
    out; f32's least time takes its products as three TF32 ones (3xTF32)
    at the TF32 peak: ``rdb_ffma_ms`` gives one f32 product at the FMA
    peak."""
    b, h, w, c = shape
    px = b * h * w
    item = torch.finfo(dtype).bits // 8
    weights = sum(9 * ci * co for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT))
    nbytes = 2 * px * c * item + weights * item + 4 * sum(rdb_ops.COUT)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (3 * px * RDB_FLOP_PER_PX / TF32_FLOPS if dtype == torch.float32
             else px * RDB_FLOP_PER_PX / PEAK_FLOPS[dtype])
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes > t_ops else "operations")


def rdb_ffma_ms(shape) -> float:
    """The f32 forward's operations at the 67 TFLOP/s FMA peak (the bound
    of the FFMA kernels the 3xTF32 ones replaced)."""
    return 1e3 * math.prod(shape[:3]) * RDB_FLOP_PER_PX / PEAK_FLOPS[
        torch.float32]


def excess(got, ref, limits, base=None) -> float:
    """The largest ratio |got - ref| / (rel |ref| + frac max|ref - base|)
    over the elements (0 where both sides agree exactly); at most 1
    passes."""
    rel, frac = limits
    got, ref = got.float(), ref.float()
    if base is not None:
        base = base.float()
    scale = (ref if base is None else ref - base).abs().max()
    diff = (got - ref).abs()
    ratio = diff / (rel * ref.abs() + frac * scale)
    return float(torch.where(diff == 0, 0.0, ratio).max())


def conv3x3(f: torch.Tensor, k: torch.Tensor, b: torch.Tensor):
    """SAME 3x3 conv of NHWC ``f`` by HWIO ``k``, in ``f.dtype``."""
    return F.conv2d(f.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(f.dtype),
                    b.to(f.dtype), padding=1).permute(0, 2, 3, 1)


def conv5_skipped(y, kernels, biases, *, scale_ratio):
    """A wrong block that lost its residual: it returns its input."""
    return y


def grown_zero(y, kernels, biases, *, scale_ratio):
    """A wrong block whose launches 1-4 wrote zeros: conv5 sees x only."""
    grown = rdb_ops.FEAT - rdb_ops.CHANNELS
    return y + scale_ratio * conv3x3(F.pad(y, (0, grown)), kernels[4],
                                     biases[4])


WRONG_BLOCKS = {"conv5_skipped": conv5_skipped, "grown_zero": grown_zero}


def tf32_block(y, kernels, biases, *, scale_ratio):
    """A wrong f32 block that multiplies in plain TF32 (hi.hi only)."""
    return rdb_ops.rdb_fwd_3xtf32_reference(
        y, kernels, biases, scale_ratio,
        terms=WRONG_PAIR_TF32["tf32_once"])[0]
# The wrong bf16 forward kernels proper to the kx-packed product
# (csrc/rdb_fwd_sm90.cuh), emulated by ``kxpack_emulated_fwd``: the
# column masks dropped, so a row end takes the neighbour row's y; y left
# at zero at a run's two extension pixels (runs inside a row, W > 64:
# ``edge_runs``); y0 and y2 exchanged.
WRONG_KXPACK = ("col_mask_dropped", "run_edge_lost", "kx_swapped")
# The kernels of one forward call's profile: prep and five convs (no
# cast or copy beside them), at most in bf16, exactly in f32 (where
# ``bwd_profile`` runs a window that lost some again).
FWD_BF16_KERNELS = 6
FWD_F32_KERNELS = 6


def kxpack_emulated_fwd(x, ks, bs, fault=None):
    """The data flow of the bf16 forward kernels in plain PyTorch (f32
    sums, each conv rounded once to ``x.dtype``): per conv, y = the sum
    over ky of the ky-shifted pixels times W[ky] as (C_in, 3 C_out); out
    = y0 one pixel left + y1 + y2 one pixel right (in image order,
    masked at the row ends) + b.  ``fault``, one of ``WRONG_KXPACK``,
    puts in a wrong kernel's fault.  Returns (out, feat) as
    ``rdb_fwd_cuda`` does."""
    dt = x.dtype
    b, h, w, _ = x.shape
    feat = x.new_zeros((b, h, w, rdb_ops.FEAT))
    feat[..., :rdb_ops.CHANNELS] = x
    col = torch.arange(h * w, device=x.device) % w
    keep_l, keep_r = (col > 0)[:, None], (col < w - 1)[:, None]
    runs = [r for r in rdb_ops.fwd_runs(b, h, w) if r[3]] or [(0, 0, 1)]
    first = torch.tensor([(i, p0) for i, p0, *_ in runs], device=x.device)
    last = first + torch.tensor([(0, n - 1) for _, _, n, *_ in runs],
                                device=x.device)
    for i, (cin, cout) in enumerate(zip(rdb_ops.CIN, rdb_ops.COUT)):
        k = ks[i].float()
        if fault == "kx_swapped":
            k = k.flip(1)
        wp = rdb_ops.pack_kernel(k)
        rows = F.pad(feat[..., :cin].float(), (0, 0, 0, 0, 1, 1))
        y = sum(rows[:, s:s + h] @ wp[s * cin:(s + 1) * cin]
                for s in range(3)).reshape(b, h * w, 3 * cout)
        left = F.pad(y[:, :-1, :cout], (0, 0, 1, 0))
        right = F.pad(y[:, 1:, 2 * cout:], (0, 0, 0, 1))
        if fault != "col_mask_dropped":
            left, right = left * keep_l, right * keep_r
        if fault == "run_edge_lost":
            left[first[:, 0], first[:, 1]] = 0
            right[last[:, 0], last[:, 1]] = 0
        acc = (left + y[..., cout:2 * cout] + right + bs[i].float()).reshape(
            b, h, w, cout)
        if i < 4:
            feat[..., cin:cin + cout] = F.leaky_relu(acc, 0.2).to(dt)
    return (x.float() + SCALE * acc).to(dt), feat


def edge_runs(shape) -> bool:
    """Whether a run of the bf16 forward at ``shape`` (B, H, W, C) has an
    extension pixel inside its row, where ``run_edge_lost`` shows."""
    b, h, w, _ = shape
    return any(e and (p0 % w or p0 % w + n < w)
               for _, p0, n, e, *_ in rdb_ops.fwd_runs(b, h, w))


def kxpack_wrong_excess(x, ks, bs) -> dict:
    """The largest launch excess of each ``WRONG_KXPACK`` kernel that can
    show at x's shape."""
    return {fault: max(rdb_scores(x, ks, bs, *kxpack_emulated_fwd(
        x, ks, bs, fault))["stage_excess"]) for fault in WRONG_KXPACK
        if fault != "run_edge_lost" or edge_runs(x.shape)}


def f32_views(ks):
    """HWIO views of f32 OIHW tensors holding ``ks``: the layout and type
    in which the trainer hands its parameters to the forward."""
    return [k.float().permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
            for k in ks]


def check_fwd_profile(prof: dict, name: str,
                      dtype=torch.bfloat16) -> None:
    """A bf16 forward call launches at most ``FWD_BF16_KERNELS`` kernels,
    all its own (no cast or copy beside them); an f32 one exactly
    ``FWD_F32_KERNELS``, all the 3xTF32 forward's."""
    names = [n for n, _ in prof["by_launch"]]
    if dtype == torch.float32:
        check(prof["kernels_per_call"] == FWD_F32_KERNELS
              and all("rdb_fwd_tf32" in n for n in names),
              f"{name}: one f32 call launches only its own kernels, "
              f"{FWD_F32_KERNELS}: {names}")
        return
    check(prof["kernels_per_call"] <= FWD_BF16_KERNELS
          and all("rdb_fwd_" in n for n in names),
          f"{name}: one bf16 call launches only its own kernels, at most "
          f"{FWD_BF16_KERNELS}: {names}")


def tf32_wrong_excess(x, ks, bs, padded: bool = False) -> dict:
    """What the f32 forward with each ``WRONG_PAIR_TF32`` product (plain
    TF32, and 3xTF32 without lo.hi; emulated by
    ``rdb_fwd_3xtf32_reference``) reads under the f32 limits: its largest
    launch excess and its block excess, each of which must exceed 1."""
    rows = {}
    for fault, terms in WRONG_PAIR_TF32.items():
        out, feat = rdb_ops.rdb_fwd_3xtf32_reference(
            x, ks, bs, SCALE, terms=terms, padded=padded)
        row = rdb_scores(x, ks, bs, out, feat[:, 1:-1] if padded else feat)
        rows[fault] = {"stage": max(row["stage_excess"]),
                       "block": row["block_excess"]}
    return rows


def _dgrad_sum(f, ks, dy, convs, lo, hi, flip=(2, 3)):
    """sum over ``convs`` k of the dgrad of conv k's cotangent (DY's
    channels of dy_k, NCHW f32) onto feat channels lo .. hi: the
    transposed conv by the kernel rounded to the working dtype (``ks``,
    HWIO f32), its taps flipped along ``flip`` (both: the right dgrad)."""
    out = 0
    for k in convs:
        cin, cout = rdb_ops.CIN[k], rdb_ops.COUT[k]
        w = ks[k].permute(3, 2, 0, 1)
        if flip != (2, 3):  # conv2d_input flips both; undo the ones kept
            keep = tuple(d for d in (2, 3) if d not in flip)
            w = w.flip(keep)
        out = out + torch.nn.grad.conv2d_input(
            f[:, :cin].shape, w, dy[:, 32 * k:32 * k + cout],
            padding=1)[:, lo:hi]
    return out


def emulated_bwd(g, feat, kernels, scale_ratio, fault=None, sign=None):
    """The data flow of the bf16 backward kernels (``rdb_bwd_sm90.cuh``)
    in plain PyTorch, optionally with one of the ``WRONG_BWD`` faults (or
    ``WRONG_BWD_EXT``'s ``row_offsets_swapped``): dy_4 = round(scale g);
    for j = 3..0 slot j's dense gradient as the sum of the later convs'
    dgrads, times LeakyReLU' (from ``sign``'s slot, feat's by default),
    rounded into DY; dx from all of DY.  Returns (dx, dws, dbs, DY) as
    ``rdb_bwd_cuda`` does."""
    dt = feat.dtype
    f = feat.permute(0, 3, 1, 2).float()
    s_f = f if sign is None else sign.permute(0, 3, 1, 2).float()
    ks = [k.to(dt).float() for k in kernels]
    flip = {"taps_unflipped": (), "row_offsets_swapped": (3,)}.get(fault,
                                                                   (2, 3))
    dy = torch.zeros_like(f)
    das = [None] * 5
    das[4] = g.permute(0, 3, 1, 2).float() * scale_ratio
    dy[:, 128:] = das[4].to(dt).float()
    late = () if fault == "conv5_dropped" else (4,)
    for j in reversed(range(4)):
        s = rdb_ops._slot(j)
        convs = [*range(j + 1, 4)]
        if fault != "dy_suffix_short":
            convs += late
        deriv = (1.0 if fault == "lrelu_one"
                 else 0.2 + 0.8 * (s_f[:, s] > 0).float())
        das[j] = _dgrad_sum(f, ks, dy, convs, s.start, s.stop, flip) * deriv
        dy[:, 32 * j:32 * j + 32] = das[j].to(dt).float()
    dx = _dgrad_sum(f, ks, dy, [*range(4), *late], 0, rdb_ops.CHANNELS, flip)
    dx = (dx + g.permute(0, 3, 1, 2).float()).to(dt)
    dws, dbs = [], []
    for i, (cin, cout) in enumerate(zip(rdb_ops.CIN, rdb_ops.COUT)):
        dw = torch.nn.grad.conv2d_weight(
            f[:, :cin], (cout, cin, 3, 3), dy[:, 32 * i:32 * i + cout],
            padding=1).permute(2, 3, 1, 0)
        dws.append(torch.zeros_like(dw) if fault == "dw3_zero" and i == 2
                   else dw)
        dbs.append(das[i].sum(dim=(0, 2, 3)))
    return (dx.permute(0, 2, 3, 1), tuple(dws), tuple(dbs),
            dy.to(dt).permute(0, 2, 3, 1))


def _dy_slices():
    """(name, DY channels) of each conv's cotangent: dy1..dy5."""
    return [(f"dy{i + 1}", slice(32 * i, 32 * i + co))
            for i, co in enumerate(rdb_ops.COUT)]


def bwd_scores(g, feat, kernels, got, scale_ratio=SCALE) -> dict:
    """Excess of each stage of a backward ``got`` = (dx, dws, dbs, DY)
    against the same computation of its own inputs, and of the whole
    against ``rdb_bwd_reference`` (see the limits above)."""
    dt = feat.dtype
    dx, dws, dbs, dy = got
    f = feat.permute(0, 3, 1, 2).float()
    dyk = dy.permute(0, 3, 1, 2).float()
    ks = [k.to(dt).float() for k in kernels]
    limits, dy_lim = BWD_STAGE_LIMITS[dt], DY_LIMITS[dt]
    das = [None] * 5
    das[4] = g.permute(0, 3, 1, 2).float() * scale_ratio
    for j in range(4):  # da_j from the kernel's own later cotangents
        s = rdb_ops._slot(j)
        das[j] = _dgrad_sum(f, ks, dyk, range(j + 1, 5), s.start, s.stop) * (
            0.2 + 0.8 * (f[:, s] > 0).float())
    dy_ex, dw_ex, db_ex = {}, [None] * 5, [None] * 5
    for i, (name, sl) in enumerate(_dy_slices()):
        ref = das[i].to(dt).float().permute(0, 2, 3, 1)
        dy_ex[name] = excess(dy[..., sl], ref, dy_lim)
        cin, cout = rdb_ops.CIN[i], rdb_ops.COUT[i]
        ref_dw = torch.nn.grad.conv2d_weight(
            f[:, :cin], (cout, cin, 3, 3), dyk[:, sl],
            padding=1).permute(2, 3, 1, 0)
        dw_ex[i] = excess(dws[i], ref_dw, limits)
        db_ex[i] = excess(dbs[i], das[i].sum(dim=(0, 2, 3)), limits)
    dx_ref = (_dgrad_sum(f, ks, dyk, range(5), 0, rdb_ops.CHANNELS)
              + g.permute(0, 3, 1, 2).float()).to(dt).permute(0, 2, 3, 1)
    ref = rdb_ops.rdb_bwd_reference(g, feat, kernels, scale_ratio,
                                     return_dfeat=True)
    blim = BWD_BLOCK_LIMITS[dt]
    block = {f"dw{i + 1}": excess(dws[i], ref[1][i], blim) for i in range(5)}
    block.update({f"db{i + 1}": excess(dbs[i], ref[2][i], blim)
                  for i in range(5)})
    # the reference's cotangents: its dense gradient's slots times
    # LeakyReLU', and scale * g, rounded as the kernel rounds them
    ref_dy = [ref[3][..., rdb_ops._slot(j)] * (
        0.2 + 0.8 * (feat[..., rdb_ops._slot(j)].float() > 0).float())
        for j in range(4)] + [g.float() * scale_ratio]
    block.update({name: excess(dy[..., sl], r.to(dt), blim)
                  for (name, sl), r in zip(_dy_slices(), ref_dy)})
    block["dx"] = excess(dx, ref[0], blim)
    return {
        "max_abs_err": float((dx.float() - ref[0].float()).abs().max()),
        "stage_dw": dw_ex, "stage_db": db_ex, "stage_dy": dy_ex,
        "dx": excess(dx.float(), dx_ref, dy_lim),
        "block": block,
    }


def _worst(row: dict) -> float:
    """The largest excess of a ``bwd_scores`` row."""
    return max(*row["stage_dw"], *row["stage_db"],
               *row["stage_dy"].values(), row["dx"],
               *row["block"].values())


def plain_generator(gen: ESRGANGenerator, x: torch.Tensor,
                    block=rdb_ops.rdb_reference) -> torch.Tensor:
    """The generator's forward with every residual dense block on
    ``block`` (by default the plain version, five cuDNN convolutions)
    instead of the kernel."""
    x = x.to(gen.compute_dtype or torch.float32)
    conv1 = gen.conv1(x).contiguous()
    out = conv1
    for rrdb in gen.blocks:
        y = out
        for rdb in (rrdb.RDB1, rrdb.RDB2, rrdb.RDB3):
            convs = rdb.convs()
            y = block(y, [c.weight.permute(2, 3, 1, 0) for c in convs],
                      [c.bias for c in convs], scale_ratio=rdb.scale_ratio)
        out = y * rrdb.scale_ratio + out
    out = conv1 + gen.conv2(out)
    for up in gen.upsamplers():
        out = leaky_relu(up(nearest_upsample(out, 2)), 0.2)
    out = leaky_relu(gen.conv3[0](out), 0.2)
    return gen.conv4(out).float()


def phase_probe() -> str:
    """Requires a CUDA device; prints and returns the card's name and
    power limit as nvidia-smi gives them."""
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
            "is False"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("probe", device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return smi


def phase_build() -> None:
    """Every kernel source, one nvcc each, started together."""
    t0 = time.perf_counter()
    built = _build.build_all()
    report = {}
    for lib, info in built.items():
        regs, name = [], None
        for line in info["ptxas"]:
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                t = re.search(r"(\w+?)_(bf16|f32)ILi(\d+)ELi(\d+)E", name)
                if t:
                    name = (f"{t.group(1)[-6:]}_{t.group(2)}/{t.group(3)}"
                            f"->{t.group(4)}")
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(f"{name}:{m.group(1)}r")
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and m.group(1) != "0":
                regs.append(f"{name}:SPILL{m.group(1)}")
            m = re.search(r"\((C75\d\d)\)", line)
            if m:  # ptxas serialized a function's wgmmas
                f = re.search(r"function '([^']+)'", line)
                regs.append(f"{f.group(1) if f else name}:SERIALIZED_"
                            f"{m.group(1)}")
        report[lib] = {"nvcc_seconds": round(info["seconds"], 3),
                       "ptxas": regs}
    for lib in _build.SIGNATURES:
        _build.load_library(lib)
    say("build", seconds=round(time.perf_counter() - t0, 3), **report)


def _rdb_weights(gen: torch.Generator, device):
    convs = ResidualDenseBlock().convs()
    for conv in convs:
        conv.reset_parameters(gen)
    ks = [c.weight.detach().permute(2, 3, 1, 0).contiguous().to(device)
          for c in convs]
    bs = [c.bias.detach().to(device) for c in convs]
    return ks, bs


def hold_rdb(x: torch.Tensor, ks, bs, ks32=None) -> dict:
    """One ``fused_rdb`` on the card, each launch and the whole block
    held against plain convolutions in f32 (see the limits above),
    beside the wrong kernels; in bf16 also the call with f32 views of
    ``ks32`` (the f32 weights ``ks`` were rounded from) bit-equal."""
    counter = fwd_counter("rdb_fwd", x.dtype)
    before = read_counters()[counter]
    out, feat = rdb_ops.rdb_fwd_cuda(x, ks, bs, scale_ratio=SCALE)
    check(read_counters()[counter] == before + 5,
          f"fused_rdb launched its kernel five times ({counter})")
    check(bool(torch.isfinite(out).all()), "rdb_fwd output finite")
    row = rdb_scores(x, ks, bs, out, feat)
    name = f"rdb_fwd {x.dtype} {tuple(x.shape)}"
    check(max(row["stage_excess"]) <= 1 and row["block_excess"] <= 1,
          f"{name} within its limits: {row}")
    row["kxpack_wrong_excess"] = kxpack_wrong_excess(x, ks, bs)
    check(min(row["stage_wrong_excess"]) > 1
          and min(row["block_wrong_excess"].values()) > 1
          and min(row["kxpack_wrong_excess"].values()) > 1,
          f"{name}: the limits see a wrong kernel: {row}")
    if x.dtype == torch.float32:
        row["tf32_wrong_excess"] = tf32_wrong_excess(x, ks, bs)
        check(min(min(r.values()) for r in row["tf32_wrong_excess"].values())
              > 1, f"{name}: the limits see plain TF32 and 3xTF32 short "
                   f"of a term, launch by launch and for the block: "
                   f"{row['tf32_wrong_excess']}")
    if ks32 is not None:
        out32, feat32 = rdb_ops.rdb_fwd_cuda(x, f32_views(ks32), bs,
                                             scale_ratio=SCALE)
        row["f32_views_bit_equal"] = bool(torch.equal(out32, out)
                                          and torch.equal(feat32, feat))
        check(row["f32_views_bit_equal"],
              f"{name}: f32 weight views give the contiguous weights' "
              f"block")
    b, h, w, _ = x.shape
    if x.dtype == torch.bfloat16:
        sched, mirror = (rdb_ops.fwd_kernel_schedule(b, h, w),
                         rdb_ops.fwd_schedule(b, h, w))
    else:
        sched, mirror = (rdb_ops.fwd_tf32_kernel_schedule(b, h, w),
                         rdb_ops.fwd_tf32_schedule(b, h, w))
    row["schedule"] = sched
    check(sched == mirror, f"{name}: the kernel runs the schedule its "
                           f"mirror gives: {sched} vs {mirror}")
    return row


def rdb_scores(x: torch.Tensor, ks, bs, out: torch.Tensor,
               feat: torch.Tensor) -> dict:
    """The excess of each launch of a block (``feat``: the feature
    buffer it filled, ``out``: its output) and of the whole block, and
    of the wrong results beside them."""
    limits = STAGE_LIMITS[x.dtype]
    xf, f, out = x.float(), feat.float(), out.float()
    stages, stages_wrong = [], []
    for i, (cin, cout) in enumerate(zip(rdb_ops.CIN, rdb_ops.COUT)):
        ref = conv3x3(f[..., :cin], ks[i].float(), bs[i])
        if i < 4:  # launch i appended channels [cin, cin + 32)
            ref = F.leaky_relu(ref, 0.2)
            got, wrong, base = f[..., cin:cin + cout], 0 * ref, None
        else:  # launch 5 wrote x + scale * conv5
            ref = xf + SCALE * ref
            got, wrong, base = out, xf, xf
        stages.append(excess(got, ref, limits, base))
        stages_wrong.append(excess(wrong, ref, limits, base))
    limits = BLOCK_LIMITS[x.dtype]
    kf = [k.float() for k in ks]
    ref = rdb_ops.rdb_reference(xf, kf, bs, scale_ratio=SCALE)
    block_wrong = {name: excess(fn(xf, kf, bs, scale_ratio=SCALE), ref,
                                limits, xf)
                   for name, fn in WRONG_BLOCKS.items()}
    return {
        "max_abs_err": float((out - ref).abs().max()),
        "block_excess": excess(out, ref, limits, xf),
        "block_wrong_excess": block_wrong,
        "stage_excess": stages,
        "stage_wrong_excess": stages_wrong,
    }


def phase_rdb(seed: int) -> dict:
    dev = torch.device(DEVICE)
    g = torch.Generator().manual_seed(seed)
    ks, bs = _rdb_weights(g, dev)
    x = (torch.randn(SERVE_RDB_SHAPE, generator=g) * 0.5).to(dev)
    xw = (torch.randn((*WIDE, 64), generator=g) * 0.5).to(dev)
    xt = (torch.randn(TRAIN_RDB_SHAPE, generator=g) * 0.5).to(dev)
    xs8 = (torch.randn(SCALE_RDB_SHAPES["scale8"], generator=g) * 0.5).to(dev)
    xe = (torch.randn(EVAL_RDB_SHAPE, generator=g) * 0.5).to(dev)
    b, h, w = RAGGED
    rows = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            kd = [k.to(dtype) for k in ks]
            f32 = dtype == torch.float32
            xtd = xt.to(dtype)
            row = hold_rdb(xd, kd, bs, ks)
            row["ragged"] = hold_rdb(xd[:b, :h, :w], kd, bs, ks)
            row["wide"] = hold_rdb(xw.to(dtype), kd, bs, ks)
            row["train"] = hold_rdb(xtd, kd, bs, ks)
            row["eval"] = hold_rdb(xe.to(dtype), kd, bs, ks)
            check("run_edge_lost" in row["wide"]["kxpack_wrong_excess"],
                  "rdb_fwd: the wide shape holds run_edge_lost")
            if dtype == torch.bfloat16:
                xs8d = xs8.to(dtype)
                row["scale8"] = hold_rdb(xs8d, kd, bs, ks)
                row["scale8"]["ms"] = median_ms(
                    lambda: rdb_ops.fused_rdb(xs8d, kd, bs))
                row["scale8"]["bound_ms"] = rdb_bound_ms(
                    SCALE_RDB_SHAPES["scale8"], dtype)[0]
            row["ms"] = median_ms(lambda: rdb_ops.fused_rdb(xd, kd, bs))
            row["profile"] = bwd_profile(
                lambda: rdb_ops.rdb_fwd_cuda(xd, kd, bs, scale_ratio=SCALE),
                kernels=FWD_F32_KERNELS if f32 else None)
            check_fwd_profile(row["profile"], f"rdb_fwd {dtype}", dtype)
            row["plain_ms"] = median_ms(
                lambda: rdb_ops.rdb_reference(xd, kd, bs))
            row["bound_ms"], row["bound_by"] = rdb_bound_ms(SERVE_RDB_SHAPE,
                                                            dtype)
            if f32:
                row["ffma_bound_ms"] = rdb_ffma_ms(SERVE_RDB_SHAPE)
                row["train"]["ms"] = median_ms(
                    lambda: rdb_ops.fused_rdb(xtd, kd, bs))
                row["train"]["plain_ms"] = median_ms(
                    lambda: rdb_ops.rdb_reference(xtd, kd, bs))
                row["train"]["bound_ms"] = rdb_bound_ms(TRAIN_RDB_SHAPE,
                                                        dtype)[0]
            row["tflops"] = (SERVE_RDB_SHAPE[0] * 64 * 64 * RDB_FLOP_PER_PX
                             / row["ms"] / 1e9)
            name = str(dtype).removeprefix("torch.")
            rows[name] = row
            say(f"rdb_fwd[{name}]", shape=list(SERVE_RDB_SHAPE),
                ragged_shape=[*RAGGED, 64], stage_limits=STAGE_LIMITS[dtype],
                block_limits=BLOCK_LIMITS[dtype], **row)
    return rows


def ext_emulated_fwd(x, ks, bs, fault=None):
    """The data flow of ``rdb_ext.cu``'s forward in plain PyTorch (f32
    sums, each launch rounded once to ``x.dtype``): a (B, H + 2, W, 192)
    buffer, each conv computed over all H + 2 rows of each image and
    stored on its data rows.  With ``fault="pad_rows_written"`` the pad
    rows are stored too: a kernel that lost its row predicate."""
    dt = x.dtype
    b, h, w, _ = x.shape
    buf = x.new_zeros((b, h + 2, w, rdb_ops.FEAT))
    buf[:, 1:h + 1, :, :rdb_ops.CHANNELS] = x
    rows = slice(None) if fault == "pad_rows_written" else slice(1, h + 1)
    for i, (cin, cout) in enumerate(zip(rdb_ops.CIN, rdb_ops.COUT)):
        acc = conv3x3(buf[..., :cin].float(), ks[i].float(), bs[i])
        if i < 4:
            buf[:, rows, :, cin:cin + cout] = F.leaky_relu(
                acc[:, rows], 0.2).to(dt)
    out = (x.float() + SCALE * acc[:, 1:h + 1]).to(dt)
    return out, buf


def hold_rdb_ext(x: torch.Tensor, ks, bs, ks32=None) -> dict:
    """One row-extended forward (B7): each launch and the block held as
    ``hold_rdb`` holds B1, on the data rows of the padded buffer, beside
    the same wrong kernels; the pad rows must read zero; the block equal
    to B1's on the same inputs bit for bit; in bf16 the call with f32
    views of ``ks32`` bit-equal."""
    dt = x.dtype
    counter = fwd_counter("rdb_fwd_ext", dt)
    before = read_counters()[counter]
    out, feat = rdb_ops.rdb_fwd_ext_cuda(x, ks, bs, scale_ratio=SCALE)
    check(read_counters()[counter] == before + 5,
          f"rdb_fwd_ext_cuda launched its kernel five times ({counter})")
    check(bool(torch.isfinite(out).all()), "rdb_fwd_ext output finite")
    row = rdb_scores(x, ks, bs, out, feat[:, 1:-1])
    row["pad_rows_max_abs"] = float(feat[:, [0, -1]].float().abs().max())
    w_out, w_feat = ext_emulated_fwd(x, ks, bs, "pad_rows_written")
    wrong = rdb_scores(x, ks, bs, w_out, w_feat[:, 1:-1])
    row["pad_rows_written_excess"] = {
        "stage": max(wrong["stage_excess"]), "block": wrong["block_excess"]}
    out1, feat1 = rdb_ops.rdb_fwd_cuda(x, ks, bs, scale_ratio=SCALE)
    row["vs_b1_block_excess"] = excess(out, out1, BLOCK_LIMITS[dt], x)
    row["vs_b1_max_abs"] = float((out.float() - out1.float()).abs().max())
    row["b1_bit_equal"] = bool(torch.equal(out, out1)
                               and torch.equal(feat[:, 1:-1], feat1))
    row["kxpack_wrong_excess"] = kxpack_wrong_excess(x, ks, bs)
    name = f"rdb_fwd_ext {dt} {tuple(x.shape)}"
    check(max(row["stage_excess"]) <= 1 and row["block_excess"] <= 1,
          f"{name} within its limits: {row}")
    check(row["pad_rows_max_abs"] == 0, f"{name}: pad rows zero")
    check(row["vs_b1_block_excess"] <= 1 and row["vs_b1_max_abs"] == 0
          and row["b1_bit_equal"],
          f"{name}: equals B1 bit for bit (output and feature buffer)")
    check(min(row["stage_wrong_excess"]) > 1
          and min(row["block_wrong_excess"].values()) > 1
          and row["pad_rows_written_excess"]["stage"] > 1
          and min(row["kxpack_wrong_excess"].values()) > 1,
          f"{name}: the limits see a wrong kernel: {row}")
    if dt == torch.float32:
        row["tf32_wrong_excess"] = tf32_wrong_excess(x, ks, bs, padded=True)
        check(min(min(r.values()) for r in row["tf32_wrong_excess"].values())
              > 1, f"{name}: the limits see plain TF32 and 3xTF32 short "
                   f"of a term, launch by launch and for the block: "
                   f"{row['tf32_wrong_excess']}")
    if ks32 is not None:
        out32, feat32 = rdb_ops.rdb_fwd_ext_cuda(x, f32_views(ks32), bs,
                                                 scale_ratio=SCALE)
        row["f32_views_bit_equal"] = bool(torch.equal(out32, out)
                                          and torch.equal(feat32, feat))
        check(row["f32_views_bit_equal"],
              f"{name}: f32 weight views give the contiguous weights' "
              f"block")
    return row


# The wrong interleaved bf16 kernels (csrc/rdb_ilv.cu), emulated by
# ``ilv_emulated_fwd``: chunk 0's up and dn copies swapped; the image-edge
# zeroing of the up and dn tiles skipped, so that an up slot of an
# image's first row holds the previous image's last row (and a dn slot of
# its last row the next image's first row); a run's end halo pixel
# dropped, so that its last output loses y2 of the pixel after it.
WRONG_ILV = ("up_dn_swapped", "edge_zero_skipped", "halo_dropped")
# The interleaved forward at the serving shape, the ragged and wide ones,
# ``eval``'s block and one where every row is an image's first and last:
# (4, 1, 9).
ILV_EDGE = (4, 1, 9)
# Exactly this many kernels in one call of the interleaved forward, all
# its own: prep and five convs (f32: the 3xTF32 kernels,
# ``rdb_fwd_ilv_tf32``).
ILV_BF16_KERNELS = 6
ILV_F32_KERNELS = 6
# A launch of the interleaved f32 forward beside the emulated 3xTF32
# forward (``rdb_ilv_3xtf32_reference``: the kernel's products and
# chains, each chain summed in f32): its worst excess may be at most
# ILV_DRIFT times the emulation's at the same shape.  The two differ only
# in how a chain's products are summed (the tensor core's accumulation
# against f32 FMA); on an NVIDIA H100 80GB HBM3 at 700 W a launch read
# 0.82-1.29x the emulation at this phase's shapes and three weight
# seeds, and chains of a K stage or of a group of two k steps 0.82-1.10x
# (in 11-27% more time), so no chain length puts every launch under it.
# A tensor-core chain over all of C_in, the drift this limit is for, read
# 6-9x the emulation in the f32 slot forward's first design.
ILV_DRIFT = 2.0


def ilv_emulated_fwd(x, ks, bs, fault=None):
    """The data flow of ``rdb_ilv.cu`` in plain PyTorch (f32 sums, each
    launch rounded once to ``x.dtype``): the (B, H, W, 576) buffer of
    [up | mid | dn] chunks, each conv one product of its 3 C_in prefix
    with the ``repack_ilv`` weight and the taps reduced.  ``fault``, one
    of ``WRONG_ILV``, puts in a wrong kernel's fault."""
    dt, g = x.dtype, rdb_ops.GROWTH
    b, h, w, _ = x.shape
    m = b * h * w
    buf = x.new_zeros((b, h, w, 3 * rdb_ops.FEAT))
    end = torch.tensor([m0 + n - 1 for m0, n in rdb_ops.ilv_runs(b, h, w)
                        if n == rdb_ops._ILV_OUTS and m0 + n < m],
                       dtype=torch.long, device=x.device)

    def grow(v, chunk0):
        if fault == "edge_zero_skipped" and chunk0 >= 2:
            flat = v.reshape(m, -1)
            up = F.pad(flat[:-w], (0, 0, w, 0)).reshape(v.shape)
            dn = F.pad(flat[w:], (0, 0, 0, w)).reshape(v.shape)
        else:
            up = F.pad(v[:, :-1], (0, 0, 0, 0, 1, 0))
            dn = F.pad(v[:, 1:], (0, 0, 0, 0, 0, 1))
        for j in range(v.shape[-1] // g):
            swap = fault == "up_dn_swapped" and chunk0 + j == 0
            parts = (dn, v, up) if swap else (up, v, dn)
            for p, src in enumerate(parts):
                buf[..., rdb_ops.ilv_columns(chunk0 + j, p)] = \
                    src[..., j * g:(j + 1) * g]

    grow(x, 0)
    col = torch.arange(m, device=x.device) % w
    for i, (cin, cout) in enumerate(zip(rdb_ops.CIN, rdb_ops.COUT)):
        wi = rdb_ops.repack_ilv(rdb_ops.pack_kernel(ks[i].float()), cin)
        y = buf[..., :3 * cin].float().reshape(m, -1) @ wi
        left = F.pad(y[:-1, :cout], (0, 0, 1, 0)) * (col > 0)[:, None]
        right = F.pad(y[1:, 2 * cout:], (0, 0, 0, 1)) * (col < w - 1)[:, None]
        if fault == "halo_dropped":
            right[end] = 0
        acc = (left + y[:, cout:2 * cout] + right + bs[i].float()).reshape(
            b, h, w, cout)
        if i < 4:
            grow(F.leaky_relu(acc, 0.2).to(dt), cin // g)
    return (x.float() + SCALE * acc).to(dt), buf


def ilv_fault_shows(fault: str, shape) -> bool:
    """Whether ``fault`` can show at ``shape`` (B, H, W): swapped copies
    where an image has two rows, the skipped edge zeroing where there are
    two images, the dropped halo pixel where a run's end halo pixel lies
    in the buffer beside a pixel that is not on the last column."""
    b, h, w = shape[:3]
    if fault == "up_dn_swapped":
        return h > 1
    if fault == "edge_zero_skipped":
        return b > 1
    if fault == "halo_dropped":
        return any(n == rdb_ops._ILV_OUTS and m0 + n < b * h * w
                   and (m0 + n - 1) % w < w - 1
                   for m0, n in rdb_ops.ilv_runs(b, h, w))
    return True


def ilv_wrong_excess(x, ks, bs) -> dict:
    """The largest launch excess of each ``WRONG_ILV`` kernel that can
    show at x's shape, on the mid copies, and whether its up and dn
    copies are exact."""
    out = {}
    for fault in WRONG_ILV:
        if ilv_fault_shows(fault, x.shape):
            w_out, w_buf = ilv_emulated_fwd(x, ks, bs, fault)
            row = rdb_scores(x, ks, bs, w_out, ilv_mid(w_buf))
            out[fault] = {"stage": max(row["stage_excess"]),
                          "block": row["block_excess"],
                          "copies_exact": ilv_copies_exact(w_buf)}
    return out


def ilv_mid(buf: torch.Tensor) -> torch.Tensor:
    """The slot feature buffer (B, H, W, 192) of an interleaved buffer:
    the mid copy of each chunk."""
    return torch.cat([buf[..., rdb_ops.ilv_columns(j, 1)]
                      for j in range(rdb_ops.FEAT // rdb_ops.GROWTH)], -1)


def ilv_copies_exact(buf: torch.Tensor) -> bool:
    """Each chunk's up copy is the row above's mid (zero on an image's
    first row), its dn copy the row below's (zero on the last)."""
    ok = True
    for j in range(rdb_ops.FEAT // rdb_ops.GROWTH):
        up, mid, dn = (buf[..., rdb_ops.ilv_columns(j, p)] for p in range(3))
        ok &= bool(torch.equal(up[:, 1:], mid[:, :-1])
                   and torch.equal(dn[:, :-1], mid[:, 1:])
                   and not up[:, 0].any() and not dn[:, -1].any())
    return ok


def ilv_tf32_excess(x, ks, bs) -> dict:
    """What the interleaved f32 forward reads under the f32 limits (its
    largest launch excess and its block excess) with each
    ``WRONG_PAIR_TF32`` product (plain TF32, 3xTF32 without lo.hi), and,
    as ``emulated``, with the kernel's own: all emulated by
    ``rdb_ilv_3xtf32_reference``, the kernel's chains summed in f32 (a
    launch that reads more than ``emulated`` drifts on the tensor
    core)."""
    rows = {}
    for fault, terms in (*WRONG_PAIR_TF32.items(), ("emulated", None)):
        out, buf = rdb_ops.rdb_ilv_3xtf32_reference(x, ks, bs, SCALE,
                                                    terms=terms)
        row = rdb_scores(x, ks, bs, out, ilv_mid(buf))
        rows[fault] = {"stage": max(row["stage_excess"]),
                       "block": row["block_excess"]}
    return rows


def hold_rdb_ilv(x: torch.Tensor, ks, bs, ks32=None) -> dict:
    """One interleaved forward (B6): each launch and the block held as
    ``hold_rdb`` holds B1, on the buffer's mid copies; the up and dn
    copies exact; the block against B1 on the same inputs; beside what
    the ``WRONG_ILV`` kernels read; the schedule the launches run the one
    ``ops.rdb`` mirrors (``ilv_schedule``, f32 ``ilv_tf32_schedule``).
    In bf16 also the call with f32 views of ``ks32`` bit-equal; in f32
    what the 3xTF32 forward short of a term reads (``tf32``, held across
    shapes by the phase) and no launch over ``ILV_DRIFT`` times the
    emulated 3xTF32 forward's worst excess."""
    dt = x.dtype
    counter = fwd_counter("rdb_fwd_ilv", dt)
    before = read_counters()[counter]
    out, buf = rdb_ops.rdb_fwd_ilv_cuda(x, ks, bs, scale_ratio=SCALE)
    check(read_counters()[counter] == before + 5,
          f"rdb_fwd_ilv_cuda launched its conv kernel five times ({counter})")
    check(bool(torch.isfinite(out).all()), "rdb_fwd_ilv output finite")
    row = rdb_scores(x, ks, bs, out, ilv_mid(buf))
    row["copies_exact"] = ilv_copies_exact(buf)
    row["ilv_wrong"] = ilv_wrong_excess(x, ks, bs)
    out1, _ = rdb_ops.rdb_fwd_cuda(x, ks, bs, scale_ratio=SCALE)
    row["vs_b1_block_excess"] = excess(out, out1, BLOCK_LIMITS[dt], x)
    row["vs_b1_max_abs"] = float((out.float() - out1.float()).abs().max())
    name = f"rdb_fwd_ilv {dt} {tuple(x.shape)}"
    check(max(row["stage_excess"]) <= 1 and row["block_excess"] <= 1,
          f"{name} within its limits: {row}")
    check(row["copies_exact"], f"{name}: up/dn copies are the rows "
                               f"above/below")
    check(row["vs_b1_block_excess"] <= 1, f"{name}: agrees with B1")
    check(min(row["stage_wrong_excess"]) > 1
          and min(row["block_wrong_excess"].values()) > 1
          and all(v["stage"] > 1 for v in row["ilv_wrong"].values()),
          f"{name}: the limits see a wrong kernel: {row}")
    b, h, w, _ = x.shape
    if dt == torch.float32:
        row["tf32"] = ilv_tf32_excess(x, ks, bs)
        row["vs_emulated"] = (max(row["stage_excess"])
                              / row["tf32"]["emulated"]["stage"])
        check(row["vs_emulated"] <= ILV_DRIFT,
              f"{name}: no launch reads more than {ILV_DRIFT}x the emulated "
              f"3xTF32 forward (its chains summed in f32): "
              f"{row['stage_excess']} vs {row['tf32']['emulated']}")
        sched, mirror = (rdb_ops.ilv_tf32_kernel_schedule(b, h, w),
                         rdb_ops.ilv_tf32_schedule(b, h, w))
    else:
        if ks32 is not None:
            out32, buf32 = rdb_ops.rdb_fwd_ilv_cuda(x, f32_views(ks32), bs,
                                                    scale_ratio=SCALE)
            row["f32_views_bit_equal"] = bool(torch.equal(out32, out)
                                              and torch.equal(buf32, buf))
            check(row["f32_views_bit_equal"],
                  f"{name}: f32 weight views give the bf16 weights' block")
        sched, mirror = (rdb_ops.ilv_kernel_schedule(b, h, w),
                         rdb_ops.ilv_schedule(b, h, w))
    row["schedule"] = sched
    check(sched == mirror, f"{name}: the kernel runs the schedule its "
                           f"mirror gives: {sched} vs {mirror}")
    return row


def check_ilv_profile(prof: dict, dtype) -> None:
    """One call of the interleaved forward launches exactly its six
    kernels, all its own (f32: all the 3xTF32 forward's)."""
    names = [n for n, _ in prof["by_launch"]]
    own = "rdb_fwd_ilv_tf32" if dtype == torch.float32 else "rdb_fwd_ilv_"
    want = ILV_F32_KERNELS if dtype == torch.float32 else ILV_BF16_KERNELS
    check(prof["kernels_per_call"] == want
          and all(own in n for n in names),
          f"rdb_fwd_ilv {dtype}: one call launches only its own kernels, "
          f"{want}: {names}")


def ilv_traffic_ms(shape, dtype) -> float:
    """The interleaved buffer's own traffic at the memory rate: x read
    and its three copies stored, each conv's 3 C_in prefix read and its
    three 32-channel copies stored, conv5's output stored."""
    b, h, w, c = shape
    px = b * h * w
    item = torch.finfo(dtype).bits // 8
    cols = 4 * c + sum(3 * ci for ci in rdb_ops.CIN) + 4 * 3 * 32 + c
    return 1e3 * px * cols * item / HBM_BYTES_PER_S


def routing_check(path: str, x: torch.Tensor, ks, bs, **want) -> None:
    """One ``fused_rdb`` call goes to the kernel ``want`` names."""
    reset_counters()
    rdb_ops.fused_rdb(x, ks, bs, scale_ratio=SCALE)
    torch.cuda.synchronize()
    check_counts(path, read_counters(), **want)


def phase_rdb_variant(seed: int, variant: str) -> dict:
    """B7 (``variant="ext"``) or B6 (``"ilv"``) at the serving shape, a
    ragged and a wide one (B7: and the training shape; B6: and
    ``ILV_EDGE`` and ``eval``'s block), in f32 and bf16, on the weights
    of ``phase_rdb``."""
    dev = torch.device(DEVICE)
    g = torch.Generator().manual_seed(seed)
    ks, bs = _rdb_weights(g, dev)
    x = (torch.randn(SERVE_RDB_SHAPE, generator=g) * 0.5).to(dev)
    ext = variant == "ext"
    xw = (torch.randn((*(EXT_WIDE if ext else WIDE), 64), generator=g)
          * 0.5).to(dev)
    xt = ((torch.randn(TRAIN_RDB_SHAPE if ext else (*ILV_EDGE, 64),
                       generator=g) * 0.5).to(dev))
    xe = (torch.randn(EVAL_RDB_SHAPE, generator=g) * 0.5).to(dev)
    hold, cuda_fn, plain_fn = (
        (hold_rdb_ext, rdb_ops.rdb_fwd_ext_cuda, rdb_ops.rdb_ext_reference)
        if ext else
        (hold_rdb_ilv, rdb_ops.rdb_fwd_ilv_cuda, rdb_ops.rdb_ilv_reference))
    b, h, w = EXT_RAGGED if ext else RAGGED
    rows = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            kd = [k.to(dtype) for k in ks]
            row = hold(xd, kd, bs, ks)
            row["ragged"] = hold(xd[:b, :h, :w], kd, bs, ks)
            row["wide"] = hold(xw.to(dtype), kd, bs, ks)
            row["train" if ext else "edge"] = hold(xt.to(dtype), kd, bs, ks)
            if ext:
                check("run_edge_lost" in row["wide"]["kxpack_wrong_excess"],
                      "rdb_fwd_ext: the wide shape holds run_edge_lost")
            else:
                row["eval"] = hold(xe.to(dtype), kd, bs, ks)
                check(set(row["ilv_wrong"]) == set(WRONG_ILV)
                      and "edge_zero_skipped" in row["edge"]["ilv_wrong"],
                      "rdb_fwd_ilv: every wrong kernel shows at some shape")
                if dtype == torch.float32:
                    held = [row, *(row[k] for k in ("ragged", "wide", "edge",
                                                    "eval"))]
                    check(all(any(min(r["tf32"][fault].values()) > 1
                                  for r in held)
                              for fault in WRONG_PAIR_TF32),
                          "rdb_fwd_ilv float32: plain TF32 and 3xTF32 "
                          "without lo.hi each read over the limits, launch "
                          "and block, at some shape: "
                          f"{[r['tf32'] for r in held]}")
            f32 = dtype == torch.float32
            row["ms"] = median_ms(
                lambda: cuda_fn(xd, kd, bs, scale_ratio=SCALE))
            row["profile"] = bwd_profile(
                lambda: cuda_fn(xd, kd, bs, scale_ratio=SCALE),
                kernels=(FWD_F32_KERNELS if ext and f32 else ILV_F32_KERNELS
                         if f32 else None))
            if ext:
                check_fwd_profile(row["profile"], f"rdb_fwd_{variant} "
                                  f"{dtype}", dtype)
            else:
                check_ilv_profile(row["profile"], dtype)
                if f32:  # eval's whole 44 x 44 image, a block a call
                    xed = xe.to(dtype)
                    row["eval"]["ms"] = median_ms(
                        lambda: cuda_fn(xed, kd, bs, scale_ratio=SCALE))
                    row["eval"]["bound_ms"] = rdb_bound_ms(EVAL_RDB_SHAPE,
                                                           dtype)[0]
            row["b1_ms"] = median_ms(
                lambda: rdb_ops.rdb_fwd_cuda(xd, kd, bs, scale_ratio=SCALE))
            row["plain_ms"] = median_ms(
                lambda: plain_fn(xd, kd, bs, scale_ratio=SCALE))
            row["bound_ms"], row["bound_by"] = rdb_bound_ms(SERVE_RDB_SHAPE,
                                                            dtype)
            if not ext:
                row["buffer_traffic_ms"] = ilv_traffic_ms(SERVE_RDB_SHAPE,
                                                          dtype)
            if f32:
                row["ffma_bound_ms"] = rdb_ffma_ms(SERVE_RDB_SHAPE)
            row["tflops"] = (SERVE_RDB_SHAPE[0] * 64 * 64 * RDB_FLOP_PER_PX
                             / row["ms"] / 1e9)
            name = str(dtype).removeprefix("torch.")
            rows[name] = row
            say(f"rdb_fwd_{variant}[{name}]", shape=list(SERVE_RDB_SHAPE),
                ragged_shape=[b, h, w, 64], stage_limits=STAGE_LIMITS[dtype],
                block_limits=BLOCK_LIMITS[dtype], **row)
    # routing through fused_rdb, bf16, outside inference mode (a
    # backward may follow)
    xd = x.to(torch.bfloat16)
    kd = [k.to(torch.bfloat16) for k in ks]
    x45 = torch.randn((*EXT_INELIGIBLE, 64), generator=g).to(dev, xd.dtype)
    with knob("EXT_KERNEL" if ext else "ILV_KERNEL"), torch.no_grad():
        routing_check(f"{variant}: eligible, no backward", xd, kd, bs,
                      **{f"rdb_fwd_{variant}": 5})
        if ext:
            routing_check("ext: W = 45", x45, kd, bs, rdb_fwd=5)
    if not ext:
        with knob("ILV_KERNEL"):
            routing_check("ilv: a backward follows",
                          xd.clone().requires_grad_(), kd, bs, rdb_fwd=5)
    return rows


def rdb_bwd_bound_ms(shape, dtype) -> tuple[float, str]:
    """The backward's bound: reads feat, g and the kernels once, writes
    dx, dW and db once; dgrad + wgrad operations, in f32 as three TF32
    products at the TF32 peak (``rdb_bwd_ffma_ms``: one f32 product at
    the FMA peak)."""
    b, h, w, c = shape
    px = b * h * w
    item = torch.finfo(dtype).bits // 8
    weights = sum(9 * ci * co for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT))
    nbytes = (px * (rdb_ops.FEAT + 2 * c) * item + weights * (item + 4)
              + 4 * sum(rdb_ops.COUT))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (3 * px * RDB_BWD_FLOP_PER_PX / TF32_FLOPS
             if dtype == torch.float32
             else px * RDB_BWD_FLOP_PER_PX / PEAK_FLOPS[dtype])
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes > t_ops else "operations")


def rdb_bwd_ffma_ms(shape) -> float:
    """The f32 backward's operations at the 67 TFLOP/s FMA peak (the
    bound of the FFMA kernels the 3xTF32 ones replaced)."""
    return 1e3 * math.prod(shape[:3]) * RDB_BWD_FLOP_PER_PX / PEAK_FLOPS[
        torch.float32]


# Profiler windows a profile may take: torch.profiler now and then
# returns a window without a single device event, or without some of
# them, although its kernels ran; such a window is run again.
PROFILE_WINDOWS = 5


def device_spans(fn, calls: int) -> list:
    """(start, end, name) of every device kernel of ``calls`` calls of
    ``fn`` under ``torch.profiler``, in order of start, after one call
    outside the window (its allocations and caches).  A window with no
    device event is run again, ``PROFILE_WINDOWS`` windows at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            break
    check(bool(spans), "the profiler recorded device events")
    return spans


def bwd_profile(fn, calls: int = 10, kernels: int | None = None) -> dict:
    """``fn`` (one kernel call) under ``torch.profiler``: device ms per
    call, kernels per call, and each launch of a call by its position
    (name and device ms, averaged over the calls).  A window that lost
    some of its kernels (the profiler drops some now and then) is run
    again, ``PROFILE_WINDOWS`` windows at most: one whose count is not a
    whole number of calls, or, where a call's ``kernels`` are known, one
    that holds other than ``kernels`` a call (a window that lost a
    multiple of ``calls`` events would otherwise read as fewer kernels a
    call)."""
    def whole(n: int) -> bool:
        return n % calls == 0 if kernels is None else n == kernels * calls

    for _ in range(PROFILE_WINDOWS):
        spans = device_spans(fn, calls)
        if whole(len(spans)):
            break
    check(whole(len(spans)),
          f"the profiler recorded whole calls ({len(spans)} kernels"
          f"{'' if kernels is None else f', {kernels} a call wanted'})")
    per = len(spans) // calls
    by_launch = [[_kernel_name(spans[i][2]), sum(
        spans[c * per + i][1] - spans[c * per + i][0]
        for c in range(calls)) / calls / 1e3] for i in range(per)]
    return {"device_ms": sum(ms for _, ms in by_launch),
            "kernels_per_call": per, "by_launch": by_launch}


def hold_rdb_bwd(x: torch.Tensor, ks, bs, g: torch.Tensor) -> dict:
    """One backward kernel run on the feature buffer the forward kernel
    filled from ``x``; every stage and the whole held against plain
    computations, beside what the ``WRONG_BWD`` kernels read; a second
    run's dW and db bit-equal to the first's."""
    _, feat = rdb_ops.rdb_fwd_cuda(x, ks, bs, scale_ratio=SCALE)
    module, attr = COUNTERS[fwd_counter("rdb_bwd", x.dtype)]
    before = getattr(module, attr)
    got = rdb_ops.rdb_bwd_cuda(g, feat, ks, scale_ratio=SCALE)
    again = rdb_ops.rdb_bwd_cuda(g, feat, ks, scale_ratio=SCALE)
    torch.cuda.synchronize()
    check(getattr(module, attr) == before + 2,
          f"rdb_bwd_cuda counted one backward a call in {attr}")
    check(all(bool(torch.isfinite(t).all())
              for t in (got[0], *got[1], *got[2], got[3])),
          "rdb_bwd outputs finite")
    row = bwd_scores(g, feat, ks, got)
    row["dw_db_bit_equal"] = all(torch.equal(a, b) for a, b in zip(
        (*got[1], *got[2]), (*again[1], *again[2])))
    row["worst"] = _worst(row)
    row.update(bwd_wrong(g, feat, ks))
    return row


def bwd_wrong(g, feat, ks) -> dict:
    """What the ``WRONG_BWD`` kernels (and in f32 the ``WRONG_BWD_TF32``
    products) read under the limits, and in f32 what the emulated
    3xTF32 backward itself reads (``emulated``: the same products summed
    in f32; a launch reading more than it drifts on the tensor core)."""
    wrong = {fault: _worst(bwd_scores(
        g, feat, ks, emulated_bwd(g, feat, ks, SCALE, fault)))
        for fault in WRONG_BWD}
    out = {"wrong": wrong}
    if feat.dtype == torch.float32:
        for fault, terms in WRONG_BWD_TF32.items():
            wrong[fault] = _worst(bwd_scores(
                g, feat, ks, rdb_ops.rdb_bwd_3xtf32_reference(
                    g, feat, ks, SCALE, terms=terms)))
        out["emulated"] = _worst(bwd_scores(
            g, feat, ks, rdb_ops.rdb_bwd_3xtf32_reference(g, feat, ks,
                                                          SCALE)))
    return out


def check_bwd_row(row: dict, name: str) -> None:
    """A backward row (``hold_rdb_bwd``, ``hold_rdb_bwd_ext``) within its
    limits, its wrong kernels over them, dW and db bit-equal."""
    check(row["worst"] <= 1, f"{name} within its limits")
    check(min(row["wrong"].values()) > 1,
          f"{name}: the limits see every wrong kernel: {row['wrong']}")
    check(row["dw_db_bit_equal"], f"{name}: dW and db bit-equal over two "
                                  f"backwards")


def check_bwd_profile(prof: dict, dtype, name: str) -> None:
    """A bf16 backward call launches at most ``BWD_BF16_KERNELS`` kernels,
    all its own (no flip or cast beside them); an f32 one exactly
    ``BWD_F32_KERNELS``, all the 3xTF32 backward's."""
    names = [n for n, _ in prof["by_launch"]]
    if dtype == torch.float32:
        check(prof["kernels_per_call"] == BWD_F32_KERNELS
              and all("rdb_bwd_tf32" in n for n in names),
              f"{name}: one f32 call launches only its own kernels, "
              f"{BWD_F32_KERNELS}: {names}")
        return
    check(prof["kernels_per_call"] <= BWD_BF16_KERNELS
          and all("rdb_bwd_" in n for n in names),
          f"{name}: one bf16 call launches only its own kernels, at most "
          f"{BWD_BF16_KERNELS}: {names}")


def phase_rdb_bwd(seed: int) -> dict:
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 3)
    ks, bs = _rdb_weights(gen, dev)
    x = (torch.randn(TRAIN_RDB_SHAPE, generator=gen) * 0.5).to(dev)
    g = (torch.randn(TRAIN_RDB_SHAPE, generator=gen) * 0.1).to(dev)
    scaled = {name: ((torch.randn(shape, generator=gen) * 0.5).to(dev),
                     (torch.randn(shape, generator=gen) * 0.1).to(dev))
              for name, shape in SCALE_RDB_SHAPES.items()}
    b, h, w = RAGGED
    rows = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            xd, gd = x.to(dtype), g.to(dtype)
            kd = [k.to(dtype) for k in ks]
            row = hold_rdb_bwd(xd, kd, bs, gd)
            row["ragged"] = hold_rdb_bwd(xd[:b, :h, :w], kd, bs,
                                         gd[:b, :h, :w])
            for name, (xs, gs) in scaled.items():
                xs, gs = xs.to(dtype), gs.to(dtype)
                row[name] = hold_rdb_bwd(xs, kd, bs, gs)
                _, fs = rdb_ops.rdb_fwd_cuda(xs, kd, bs, scale_ratio=SCALE)
                row[name]["ms"] = median_ms(
                    lambda: rdb_ops.rdb_bwd_cuda(gs, fs, kd,
                                                 scale_ratio=SCALE))
                row[name]["bound_ms"] = rdb_bwd_bound_ms(
                    SCALE_RDB_SHAPES[name], dtype)[0]
            if f32:  # the launches' schedule is the one the wrapper sizes
                row["schedules_mirrored"] = all(
                    {k: v for k, v in rdb_ops.bwd_tf32_schedule(*sh).items()
                     if k != "prep_blocks"}
                    == rdb_ops.bwd_tf32_kernel_schedule(*sh)
                    for sh in (TRAIN_RDB_SHAPE[:3], RAGGED, WIDE,
                               *(v[:3] for v in SCALE_RDB_SHAPES.values())))
            _, feat = rdb_ops.rdb_fwd_cuda(xd, kd, bs, scale_ratio=SCALE)

            def call():
                return rdb_ops.rdb_bwd_cuda(gd, feat, kd, scale_ratio=SCALE)

            row["ms"] = median_ms(call)
            row["profile"] = bwd_profile(
                call, kernels=BWD_F32_KERNELS if f32 else None)
            row["plain_ms"] = median_ms(
                lambda: rdb_ops.rdb_bwd_reference(gd, feat, kd, SCALE))
            row["bound_ms"], row["bound_by"] = rdb_bwd_bound_ms(
                TRAIN_RDB_SHAPE, dtype)
            if f32:
                row["ffma_bound_ms"] = rdb_bwd_ffma_ms(TRAIN_RDB_SHAPE)
            px = TRAIN_RDB_SHAPE[0] * TRAIN_RDB_SHAPE[1] * TRAIN_RDB_SHAPE[2]
            row["tflops"] = px * RDB_BWD_FLOP_PER_PX / row["ms"] / 1e9
            name = str(dtype).removeprefix("torch.")
            rows[name] = row
            say(f"rdb_bwd[{name}]", shape=list(TRAIN_RDB_SHAPE),
                ragged_shape=[*RAGGED, 64],
                stage_limits=BWD_STAGE_LIMITS[dtype],
                dy_limits=DY_LIMITS[dtype],
                block_limits=BWD_BLOCK_LIMITS[dtype], **row)
            for where in ("ragged", *SCALE_RDB_SHAPES):
                if where in row:
                    check_bwd_row(row[where], f"rdb_bwd {name} {where}")
            check_bwd_row(row, f"rdb_bwd {name} training")
            check_bwd_profile(row["profile"], dtype, f"rdb_bwd {name}")
            if f32:
                check(row["schedules_mirrored"],
                      "rdb_bwd float32: the launches run the schedule "
                      "bwd_tf32_schedule mirrors")
    return rows


# The wrong row-extended backward kernels the limits must see (emulated
# in plain PyTorch): the slot convs' halo rows taken at offsets 2, 1, 0
# instead of 0, 1, 2 (the vertical taps unflipped); LeakyReLU' read one
# buffer row up, from the pad row on.
WRONG_BWD_EXT = ("row_offsets_swapped", "da_from_pad_rows")


def emulated_bwd_ext(g, feat_padded, kernels, scale_ratio, fault=None):
    """``emulated_bwd`` on the row-extended layout, optionally with one
    of the ``WRONG_BWD_EXT`` faults: (dx, dws, dbs, DY) with DY in the
    (B, H + 2, W, 192) layout, its pad rows zero."""
    sign = feat_padded[:, :-2] if fault == "da_from_pad_rows" else None
    dx, dws, dbs, dy = emulated_bwd(
        g, feat_padded[:, 1:-1], kernels, scale_ratio,
        "row_offsets_swapped" if fault == "row_offsets_swapped" else None,
        sign)
    return dx, dws, dbs, F.pad(dy, (0, 0, 0, 0, 1, 1))


def hold_rdb_bwd_ext(x: torch.Tensor, ks, bs, g: torch.Tensor) -> dict:
    """One row-extended backward (B8) on the padded buffer B7 filled
    from ``x``: every stage and the whole held as ``hold_rdb_bwd`` holds
    B2, on the data rows; DY's pad rows zero; everything against B2 on
    the same feature buffer; beside the ``WRONG_BWD_EXT`` kernels."""
    dt = x.dtype
    _, featp = rdb_ops.rdb_fwd_ext_cuda(x, ks, bs, scale_ratio=SCALE)
    module, attr = COUNTERS[fwd_counter("rdb_bwd_ext", dt)]
    before = getattr(module, attr)
    got = rdb_ops.rdb_bwd_ext_cuda(g, featp, ks, scale_ratio=SCALE)
    again = rdb_ops.rdb_bwd_ext_cuda(g, featp, ks, scale_ratio=SCALE)
    torch.cuda.synchronize()
    check(getattr(module, attr) == before + 2,
          f"rdb_bwd_ext_cuda counted one backward a call in {attr}")
    dx, dws, dbs, dyp = got
    check(all(bool(torch.isfinite(t).all()) for t in (dx, *dws, *dbs, dyp)),
          "rdb_bwd_ext outputs finite")
    feat = featp[:, 1:-1]
    row = bwd_scores(g, feat, ks, (dx, dws, dbs, dyp[:, 1:-1]))
    row["dw_db_bit_equal"] = all(torch.equal(a, b) for a, b in zip(
        (*dws, *dbs), (*again[1], *again[2])))
    row["dy_pad_rows_max_abs"] = float(dyp[:, [0, -1]].float().abs().max())
    limits = BWD_BLOCK_LIMITS[dt]
    b2 = rdb_ops.rdb_bwd_cuda(g, feat.contiguous(), ks, scale_ratio=SCALE)
    if dt == torch.float32:  # one 3xTF32 code path: the same bits
        row["b2_bit_equal"] = all(torch.equal(a, r) for a, r in zip(
            (dx, *dws, *dbs, dyp[:, 1:-1]), (b2[0], *b2[1], *b2[2], b2[3])))
    row["vs_b2"] = max(
        excess(dx, b2[0], limits), excess(dyp[:, 1:-1], b2[3], limits),
        *(excess(a, r, limits) for a, r in zip((*dws, *dbs),
                                               (*b2[1], *b2[2]))))
    row["vs_b2_dx_max_abs"] = float((dx.float() - b2[0].float()).abs().max())
    row["worst"] = max(_worst(row), row["vs_b2"])
    row["wrong"] = bwd_wrong(g, feat, ks)["wrong"] if dt == torch.float32 \
        else {}
    for fault in WRONG_BWD_EXT:
        *grads, wrong_dyp = emulated_bwd_ext(g, featp, ks, SCALE, fault)
        row["wrong"][fault] = _worst(bwd_scores(
            g, feat, ks, (*grads, wrong_dyp[:, 1:-1])))
    check(row["dy_pad_rows_max_abs"] == 0,
          f"rdb_bwd_ext {dt} {tuple(x.shape)}: DY's pad rows zero")
    check(row.get("b2_bit_equal", True),
          f"rdb_bwd_ext {dt} {tuple(x.shape)}: B8 equals B2 bit for bit")
    return row


def phase_rdb_bwd_ext(seed: int) -> dict:
    """B8 at the training shape and a row-ragged eligible one, f32 and
    bf16, and in f32 at the ``--scale 2`` and ``--scale 8`` LR batches,
    on the inputs of ``phase_rdb_bwd``."""
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 3)
    ks, bs = _rdb_weights(gen, dev)
    x = (torch.randn(TRAIN_RDB_SHAPE, generator=gen) * 0.5).to(dev)
    g = (torch.randn(TRAIN_RDB_SHAPE, generator=gen) * 0.1).to(dev)
    scaled = {name: ((torch.randn(shape, generator=gen) * 0.5).to(dev),
                     (torch.randn(shape, generator=gen) * 0.1).to(dev))
              for name, shape in SCALE_RDB_SHAPES.items()}
    b, h, w = EXT_RAGGED
    rows = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            xd, gd = x.to(dtype), g.to(dtype)
            kd = [k.to(dtype) for k in ks]
            row = hold_rdb_bwd_ext(xd, kd, bs, gd)
            row["ragged"] = hold_rdb_bwd_ext(xd[:b, :h, :w], kd, bs,
                                             gd[:b, :h, :w])
            if f32:
                for name, (xs, gs) in scaled.items():
                    row[name] = hold_rdb_bwd_ext(xs, kd, bs, gs)
            _, featp = rdb_ops.rdb_fwd_ext_cuda(xd, kd, bs, scale_ratio=SCALE)
            _, feat = rdb_ops.rdb_fwd_cuda(xd, kd, bs, scale_ratio=SCALE)

            def call():
                return rdb_ops.rdb_bwd_ext_cuda(gd, featp, kd,
                                                scale_ratio=SCALE)

            row["ms"] = median_ms(call)
            row["profile"] = bwd_profile(
                call, kernels=BWD_F32_KERNELS if f32 else None)
            row["b2_ms"] = median_ms(lambda: rdb_ops.rdb_bwd_cuda(
                gd, feat, kd, scale_ratio=SCALE))
            row["plain_ms"] = median_ms(lambda: rdb_ops.rdb_bwd_ext_reference(
                gd, featp, kd, SCALE))
            row["bound_ms"], row["bound_by"] = rdb_bwd_bound_ms(
                TRAIN_RDB_SHAPE, dtype)
            px = TRAIN_RDB_SHAPE[0] * TRAIN_RDB_SHAPE[1] * TRAIN_RDB_SHAPE[2]
            row["tflops"] = px * RDB_BWD_FLOP_PER_PX / row["ms"] / 1e9
            name = str(dtype).removeprefix("torch.")
            rows[name] = row
            say(f"rdb_bwd_ext[{name}]", shape=list(TRAIN_RDB_SHAPE),
                ragged_shape=[b, h, w, 64],
                stage_limits=BWD_STAGE_LIMITS[dtype],
                dy_limits=DY_LIMITS[dtype],
                block_limits=BWD_BLOCK_LIMITS[dtype], **row)
            for where in ("training", "ragged", *SCALE_RDB_SHAPES):
                if where == "training" or where in row:
                    check_bwd_row(row if where == "training" else row[where],
                                  f"rdb_bwd_ext {name} {where}")
            check_bwd_profile(row["profile"], dtype, f"rdb_bwd_ext {name}")
    return rows


# The pair synthesis (B3) at the bench tool's shape (64 crops of 96 px),
# at the training crops' (64 of 128 px) and at an odd size (37 * 4),
# whose three samples take one flip, the other, and both.
# The bench tool's shape, the training crops', an odd size with each
# flip, and a size whose LR side (25) the four bands do not divide.
PAIR_SYNTH_SHAPES = ((64, 96), (64, 128), (3, 148), (5, 100))
ODD_FLIPS = ((1, 0), (0, 1), (1, 1))
# HR holds bit for bit: one f32 product per value in both.  LR: the same
# f32 sums, taken in another order, round a value that sits at a tie of
# the uint8 quantization one level the other way; so every LR value
# within 1/255 (+1e-6), and at most 0.1% of them differing.  A kernel
# that runs the H pass first, or skips the quantization between the
# passes, is also within one level: the fraction is what sees it.
SYNTH_LR_ATOL = 1 / 255 + 1e-6
SYNTH_LR_FRACTION = 1e-3
# A kernel whose band windows (``ops.preprocess.pair_plan``) end one HR
# row short reads that row as zero in its W pass: its band's last LR row
# loses a tap.
WRONG_SYNTH = ("h_first", "no_mid_quant", "flips_swapped", "true_div",
               "window_short")


def emulated_synth(crops, flips, factor=4, fault=None):
    """The plain pair synthesis, optionally with one of the
    ``WRONG_SYNTH`` faults: ``(lr, hr)``."""
    if fault == "window_short":
        lr, hr = synthesize_pair(crops, flips, factor)
        size = hr.shape[1]
        m = torch.from_numpy(resample_matrix(size, size // factor)).to(
            hr.device)
        s = size // factor
        bands = ps_ops.pair_plan(size, s, ps_ops.pair_bands(len(crops), s))
        for o0, o1, _, w1, *_ in bands["bands"]:
            short = hr.clone()
            short[:, w1 - 1:] = 0
            mid = _quantize_pixels(torch.einsum("ow,bhwc->bhoc", m, short))
            lr[:, o0:o1] = _quantize_pixels(
                torch.einsum("oh,bhwc->bowc", m[o0:o1], mid))
        return lr, hr
    if fault == "flips_swapped":
        flips = flips[:, [1, 0]]
    x = crops.float()
    # a tensor divisor: PyTorch's CUDA division by a scalar multiplies by
    # its reciprocal, which is the right product
    hr = _apply_flips(x / torch.full_like(x, 255.0) if fault == "true_div"
                      else x * INV_255, flips)
    size = hr.shape[1]
    m = torch.from_numpy(resample_matrix(size, size // factor)).to(hr.device)
    passes = ("ow,bhwc->bhoc", "oh,bhwc->bowc")
    if fault == "h_first":
        passes = passes[::-1]
    lr = torch.einsum(passes[0], m, hr)
    if fault != "no_mid_quant":
        lr = _quantize_pixels(lr)
    return _quantize_pixels(torch.einsum(passes[1], m, lr)), hr


def synth_scores(got, ref) -> dict:
    (lr, hr), (ref_lr, ref_hr) = got, ref
    diff = (lr - ref_lr).abs()
    return {"hr_equal": bool(torch.equal(hr, ref_hr)),
            "hr_max_abs": float((hr - ref_hr).abs().max()),
            "lr_max_abs": float(diff.max()),
            "lr_frac_differing": float((diff > 0).float().mean())}


def synth_ok(row: dict) -> bool:
    return (row["hr_equal"] and row["lr_max_abs"] <= SYNTH_LR_ATOL
            and row["lr_frac_differing"] <= SYNTH_LR_FRACTION)


def synth_bound_ms(b: int, size: int, factor: int = 4) -> tuple:
    """Crops and flips in, HR and LR out; the band's f32 FMAs (the
    nonzero taps of the resampling matrix) over the f32 peak."""
    s = size // factor
    nbytes = b * size * size * 3 * (1 + 4) + 2 * b + b * s * s * 3 * 4
    taps = int(np.count_nonzero(resample_matrix(size, s)))
    flops = 2 * 3 * b * (size * taps + s * taps)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes > t_ops else "operations")


def phase_pair_synth(seed: int) -> dict:
    """B3 at ``PAIR_SYNTH_SHAPES``: HR bit for bit and LR within its
    limits against the plain version, beside the ``WRONG_SYNTH``
    kernels; each shape timed beside its plain version and bound."""
    rng = np.random.default_rng(seed + 7)
    rows = {}
    for b, size in PAIR_SYNTH_SHAPES:
        crops = torch.from_numpy(rng.integers(
            0, 256, (b, size, size, 3), dtype=np.uint8)).to(DEVICE)
        flips = (torch.tensor(ODD_FLIPS, dtype=torch.bool) if b == 3 else
                 torch.from_numpy(rng.random((b, 2)) < 0.5)).to(DEVICE)
        check(all(w1 - w0 < size for _, _, w0, w1, *_ in
                  ps_ops.pair_plan(size, size // 4, ps_ops.pair_bands(
                      b, size // 4))["bands"]),
              f"pair_synth {size}: each band stages part of the crop")
        before = ps_ops.PAIR_SYNTH_LAUNCHES
        got = ps_ops.synthesize_pair_cuda(crops, flips)
        torch.cuda.synchronize()
        check(ps_ops.PAIR_SYNTH_LAUNCHES == before + 1,
              "synthesize_pair_cuda launched its kernel once")
        lr, hr = got
        s = size // 4
        check(lr.shape == (b, s, s, 3) and hr.shape == crops.shape
              and lr.dtype == hr.dtype == torch.float32,
              "pair_synth returns (lr, hr) in f32")
        ref = synthesize_pair(crops, flips)
        row = synth_scores(got, ref)
        row["wrong"] = {f: synth_scores(emulated_synth(crops, flips,
                                                       fault=f), ref)
                        for f in WRONG_SYNTH}
        name = f"pair_synth {(b, size, size, 3)}"
        check(synth_ok(row), f"{name} within its limits: {row}")
        check(not any(synth_ok(w) for w in row["wrong"].values()),
              f"{name}: the limits see every wrong kernel: {row['wrong']}")
        row["max_abs_err"] = row["lr_max_abs"]
        row["ms"] = median_ms(lambda: ps_ops.synthesize_pair_cuda(crops,
                                                                  flips))
        row["plain_ms"] = median_ms(lambda: synthesize_pair(crops, flips))
        row["profile"] = profile_device_time(
            lambda: ps_ops.synthesize_pair_cuda(crops, flips), 10,
            _kernel_name)
        row["bound_ms"], row["bound_by"] = synth_bound_ms(b, size)
        row["library_ms"] = None  # no single PyTorch call computes it
        rows[f"{b}x{size}"] = row
        say(f"pair_synth[{b}x{size}]", shape=[b, size, size, 3],
            lr_atol=SYNTH_LR_ATOL, lr_fraction=SYNTH_LR_FRACTION, **row)
    b, size = PAIR_SYNTH_SHAPES[0]
    return {"uint8": rows[f"{b}x{size}"]}


# The 3x3 64 -> 64 conv (B4, B5) at the bench tool's shape (128 images
# of 24 x 24), at a ragged multi-image one, at the JAX gate's largest
# image (128 x 256: 16384 pixel pairs), at one where every pixel lies on
# an edge, and at one where the persistent schedule's runs are ragged at
# widths no run divides.
PAIR_CONV_SHAPES = ((128, 24, 24), (3, 5, 10), (1, 128, 256), (4, 3, 2),
                    (7, 33, 46))
# The forward and dx against pair_conv_reference / pair_conv_bwd_reference
# (f32 convs, TF32 off, of the same operands) take STAGE_LIMITS: f32
# differs in summation order only, bf16 also rounds once at the end,
# where a tie may go the other way.  dW and db, sums over up to 73,728
# pixels in another order, take BWD_STAGE_LIMITS.
WRONG_PAIR_FWD = ("k_transposed", "no_column_mask", "bias_dropped")
WRONG_PAIR_BWD = ("dx_unflipped", "dw_partial_dropped")
# The f32 kernels' wrong products (3xTF32 short of a term, emulated by
# pc_ops.pair_conv_3xtf32_reference and, for the RDB forward,
# rdb_ops.rdb_fwd_3xtf32_reference): hi.hi only (plain TF32) and hi.hi
# + hi.lo (lo.hi dropped); each forward, and each backward (the worst of
# dx and dW), must read over its limit.
WRONG_PAIR_TF32 = {"tf32_once": (("hi", "hi"),),
                   "cross_term_dropped": (("hi", "hi"), ("hi", "lo"))}
# Held where some persistent CTA walks more than one run (elsewhere the
# fault changes nothing): the bench tool's shape and the gate's largest.
WRONG_PAIR_STALE = "stale_stage"


def conv_no_column_mask(x, k, bias):
    """A forward that masks rows but not columns: a tap left of column 0
    reads the row above's last pixel, right of the last column the row
    below's first, as in the flat NHWC buffer."""
    b, h, w, c = x.shape
    xp = F.pad(x.float().reshape(b, h * w, c), (0, 0, w + 1, w + 1))
    kk = k.to(x.dtype).float()
    rows = torch.arange(h, device=x.device)
    y = bias.float().expand(b, h, w, c)
    for ky in range(3):
        valid = ((rows + ky - 1 >= 0) & (rows + ky - 1 < h)).float()
        for kx in range(3):
            start = (w + 1) + (ky - 1) * w + (kx - 1)
            win = xp[:, start:start + h * w].reshape(b, h, w, c)
            y = y + (win * valid.view(1, h, 1, 1)) @ kk[ky, kx]
    return y.to(x.dtype)


def dw_partial_dropped(x, k, g):
    """The backward whose reduce skips the wgrad's partial 0 (the pixels
    ``pc_ops.wgrad_partition`` gives it): ``(dW, db)``."""
    keep = pc_ops.wgrad_partition(*x.shape[:3]) != 0
    _, dw, db = pc_ops.pair_conv_bwd_reference(
        x, k, g * keep[..., None].to(g.device, g.dtype))
    return dw, db


def multi_run(shape) -> bool:
    """Some persistent CTA of the bf16 conv walks more than one run."""
    return max(map(len, pc_ops.conv_schedule(*shape))) > 1


def stale_stage(x, k, bias):
    """A forward whose CTAs compute each run after their first from the
    stage of the run before: each such run takes the output of the
    CTA's previous run (as many pixels as both hold)."""
    b, h, w, c = x.shape
    ref = pc_ops.pair_conv_reference(x, k, bias).reshape(b, h * w, c)
    out = ref.clone()
    runs = pc_ops.conv_runs(b, h, w)
    for walk in pc_ops.conv_schedule(b, h, w):
        for prev, cur in zip(walk, walk[1:]):
            (pi, pp, pn), (ci, cp, cn) = runs[prev], runs[cur]
            n = min(pn, cn)
            out[ci, cp:cp + n] = ref[pi, pp:pp + n]
    return out.view(b, h, w, c)


def pair_scores(x, k, bias, g, y, grads) -> dict:
    """Excess of the forward ``y`` and of the backward ``grads`` = (dx,
    dW, db) against the plain versions on the same inputs, and the
    largest absolute errors of y and dx."""
    dt = x.dtype
    ref_y = pc_ops.pair_conv_reference(x, k, bias)
    ref = pc_ops.pair_conv_bwd_reference(x, k, g)
    return {"fwd": excess(y, ref_y, STAGE_LIMITS[dt]),
            "dx": excess(grads[0], ref[0], STAGE_LIMITS[dt]),
            "dw": excess(grads[1], ref[1], BWD_STAGE_LIMITS[dt]),
            "db": excess(grads[2], ref[2], BWD_STAGE_LIMITS[dt]),
            "max_abs_err": float((y.float() - ref_y.float()).abs().max()),
            "dx_max_abs_err": float((grads[0].float()
                                     - ref[0].float()).abs().max())}


def pair_wrong_scores(x, k, bias, g) -> dict:
    """What the ``WRONG_PAIR_FWD`` and ``WRONG_PAIR_BWD`` kernels read
    under the same limits (the worst of dW and db for the dropped
    partial), ``WRONG_PAIR_STALE`` where ``multi_run``, and in f32 the
    ``WRONG_PAIR_TF32`` products, forward and backward (``bwd_`` before
    the name)."""
    dt = x.dtype
    zeros = torch.zeros_like(bias)
    ref_y = pc_ops.pair_conv_reference(x, k, bias)
    ref_dx, ref_dw, ref_db = pc_ops.pair_conv_bwd_reference(x, k, g)
    fwd = {"k_transposed": pc_ops.pair_conv_reference(x, k.transpose(2, 3),
                                                      bias),
           "no_column_mask": conv_no_column_mask(x, k, bias),
           "bias_dropped": pc_ops.pair_conv_reference(x, k, zeros)}
    if multi_run(x.shape[:3]):
        fwd[WRONG_PAIR_STALE] = stale_stage(x, k, bias)
    rows = {name: excess(y, ref_y, STAGE_LIMITS[dt])
            for name, y in fwd.items()}
    unflipped = pc_ops.pair_conv_reference(g.to(dt), k.transpose(2, 3),
                                           zeros)
    rows["dx_unflipped"] = excess(unflipped, ref_dx, STAGE_LIMITS[dt])
    dw, db = dw_partial_dropped(x, k, g)
    rows["dw_partial_dropped"] = max(
        excess(dw, ref_dw, BWD_STAGE_LIMITS[dt]),
        excess(db, ref_db, BWD_STAGE_LIMITS[dt]))
    if dt == torch.float32:
        for name, terms in WRONG_PAIR_TF32.items():
            rows[name] = excess(pc_ops.pair_conv_3xtf32_reference(
                x, k, bias, terms), ref_y, STAGE_LIMITS[dt])
            dx, dw, _ = pc_ops.pair_conv_bwd_3xtf32_reference(x, k, g,
                                                              terms)
            rows[f"bwd_{name}"] = max(
                excess(dx, ref_dx, STAGE_LIMITS[dt]),
                excess(dw, ref_dw, BWD_STAGE_LIMITS[dt]))
    return rows


def hold_pair_conv(x, k, bias, g) -> dict:
    """One forward and two backward kernel calls, each output held
    against the plain versions, beside the wrong kernels; the two
    backwards' dW and db must be bit-equal."""
    f32 = "_f32" if x.dtype == torch.float32 else ""
    before = read_counters()
    y = pc_ops.pair_conv_fwd_cuda(x, k, bias)
    grads = pc_ops.pair_conv_bwd_cuda(x, k, g)
    again = pc_ops.pair_conv_bwd_cuda(x, k, g)
    torch.cuda.synchronize()
    moved = {name: n - before[name] for name, n in read_counters().items()
             if n != before[name]}
    check(moved == {f"pair_fwd{f32}": 1, f"pair_bwd{f32}": 2},
          f"one forward and two backwards counted, as {x.dtype}: {moved}")
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"pair_conv {x.dtype} {tuple(x.shape)}: two backwards bit-equal")
    check(all(bool(torch.isfinite(t).all()) for t in (y, *grads)),
          "pair_conv outputs finite")
    row = pair_scores(x, k, bias, g, y, grads)
    row["wrong"] = pair_wrong_scores(x, k, bias, g)
    name = f"pair_conv {x.dtype} {tuple(x.shape)}"
    check(max(row[key] for key in ("fwd", "dx", "dw", "db")) <= 1,
          f"{name} within its limits: {row}")
    check(min(row["wrong"].values()) > 1,
          f"{name}: the limits see every wrong kernel: {row['wrong']}")
    return row


def pair_conv_bound_ms(shape, dtype, backward: bool = False) -> tuple:
    """The forward reads x, the kernel and the bias once and writes y;
    the backward reads x, g and the kernel and writes dx, dW and db,
    with twice the forward's operations.  f32's least time takes its
    products as three TF32 ones (3xTF32) at the TF32 peak:
    ``pair_conv_ffma_ms`` gives one f32 product at the FMA peak."""
    b, h, w = shape
    px = b * h * w
    item = torch.finfo(dtype).bits // 8
    kbytes = 9 * pc_ops.C * pc_ops.C
    if backward:
        nbytes = 3 * px * pc_ops.C * item + kbytes * (item + 4) + 4 * pc_ops.C
    else:
        nbytes = 2 * px * pc_ops.C * item + kbytes * item + 4 * pc_ops.C
    flops = 2 * kbytes * px * (2 if backward else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (3 * flops / TF32_FLOPS if dtype == torch.float32
             else flops / PEAK_FLOPS[dtype])
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes > t_ops else "operations")


def pair_conv_ffma_ms(shape, backward: bool = False) -> float:
    """The f32 conv's operations at the 67 TFLOP/s FMA peak (the bound
    of the FFMA kernels the 3xTF32 ones replaced)."""
    flops = 2 * 9 * pc_ops.C * pc_ops.C * math.prod(shape) * (1 + backward)
    return 1e3 * flops / PEAK_FLOPS[torch.float32]


def conv_backward(g, x, k):
    """One PyTorch call for dx, dW and db of a SAME 3x3 conv of NCHW
    views (cuDNN's backward): B5's library yardstick."""
    return torch.ops.aten.convolution_backward(
        g, x, k, [k.shape[0]], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
        [True, True, True])


# The kernels one call of B4 (one) and of B5 (three) may launch: no copy
# or cast kernel beside them.
PAIR_KERNELS = {False: ("conv_",), True: ("conv_", "wgrad_", "reduce_partials")}


def pair_profile(kernel, backward: bool, calls: int = 10) -> dict:
    """``kernel`` profiled over ``calls`` calls by kernel name.  A window
    that lost some of its kernels (fewer than ``PAIR_KERNELS`` a call)
    is run again, ``PROFILE_WINDOWS`` windows at most; one with more
    kernels is kept, for ``check_pair_profile`` to refuse."""
    for window in range(1, PROFILE_WINDOWS + 1):
        prof = profile_device_time(kernel, calls, _kernel_name)
        if prof["kernels_per_batch"] >= len(PAIR_KERNELS[backward]):
            break
    prof["windows"] = window
    return prof


def check_pair_profile(prof: dict, dtype, backward: bool) -> None:
    names = PAIR_KERNELS[backward]
    kinds = prof["device_ms_per_batch"]
    check(prof["kernels_per_batch"] == len(names)
          and len(kinds) == len(names)
          and all(any(n in k for n in names) for k in kinds),
          f"one pair_conv {'backward' if backward else 'forward'} "
          f"({dtype}) launches only {names}, "
          f"{prof['kernels_per_batch']} kernels a call: {kinds}")


def phase_pair_conv(seed: int) -> dict:
    """B4 and B5 at ``PAIR_CONV_SHAPES`` in f32 and bf16, every output
    held against the plain versions; at the tool's shape each timed
    beside its plain version, the library call (cuDNN's channels-last
    convolution and its ``convolution_backward``, TF32 off) and its
    bound, and each call's profile held to its own kernels."""
    gen = torch.Generator().manual_seed(seed + 8)
    k = (torch.randn((3, 3, 64, 64), generator=gen) * 0.05).to(DEVICE)
    bias = (torch.randn((64,), generator=gen) * 0.1).to(DEVICE)
    inputs = {shape: [(torch.randn((*shape, 64), generator=gen) * s).to(
        DEVICE) for s in (0.5, 0.1)] for shape in PAIR_CONV_SHAPES}
    timed = {"pair_fwd": {}, "pair_bwd": {}}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            rows = {}
            for shape in PAIR_CONV_SHAPES:
                x, g = (t.to(dtype) for t in inputs[shape])
                rows["x".join(map(str, shape))] = hold_pair_conv(x, k, bias,
                                                                 g)
            shape = PAIR_CONV_SHAPES[0]
            x, g = (t.to(dtype) for t in inputs[shape])
            xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            kn = k.to(dtype).permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            bn = bias.to(dtype)
            tool = rows["x".join(map(str, shape))]
            name = str(dtype).removeprefix("torch.")
            calls = {  # kernel, plain version, library call
                "fwd": (lambda: pc_ops.pair_conv_fwd_cuda(x, k, bias),
                        lambda: pc_ops.pair_conv_reference(x, k, bias),
                        lambda: F.conv2d(xn, kn, bn, padding=1)),
                "bwd": (lambda: pc_ops.pair_conv_bwd_cuda(x, k, g),
                        lambda: pc_ops.pair_conv_bwd_reference(x, k, g),
                        lambda: conv_backward(gn, xn, kn)),
            }
            for part, (kernel, plain, library) in calls.items():
                backward = part == "bwd"
                row = {"max_abs_err": tool["dx_max_abs_err" if backward
                                           else "max_abs_err"],
                       "ms": median_ms(kernel), "plain_ms": median_ms(plain),
                       "library_ms": median_ms(library),
                       "profile": pair_profile(kernel, backward),
                       "library_profile": profile_device_time(
                           library, 10, _kernel_name)}
                check_pair_profile(row["profile"], dtype, backward)
                row["bound_ms"], row["bound_by"] = pair_conv_bound_ms(
                    shape, dtype, backward)
                if dtype == torch.float32:
                    row["ffma_bound_ms"] = pair_conv_ffma_ms(shape,
                                                             backward)
                flops = 2 * 9 * 64 * 64 * math.prod(shape) * (1 + backward)
                row["tflops"] = flops / row["ms"] / 1e9
                timed[f"pair_{part}"][name] = row
            say(f"pair_conv[{name}]", shapes=[[*s, 64] for s in
                                              PAIR_CONV_SHAPES],
                fwd_limits=STAGE_LIMITS[dtype],
                dw_limits=BWD_STAGE_LIMITS[dtype], checks=rows,
                fwd=timed["pair_fwd"][name], bwd=timed["pair_bwd"][name])
    return timed


# Calls of bench_preprocess's kernel path: one warm-up, then --steps.
BENCH_PREPROCESS_STEPS = 20


def phase_bench_preprocess(seed: int) -> dict:
    """``tools/bench_preprocess.py``'s port at its default shape, in
    this process; B3 launched once per call of its kernel path."""
    reset_counters()
    bench_preprocess.main(["--steps", str(BENCH_PREPROCESS_STEPS)])
    torch.cuda.synchronize()
    counts = read_counters()
    say("bench_preprocess", launches=counts)
    check_counts("bench_preprocess", counts,
                 pair_synth=BENCH_PREPROCESS_STEPS + 1)
    return counts


def phase_bench_pair_conv(seed: int) -> dict:
    """``tools/bench_pair_conv.py``'s port at its defaults (bf16, both
    modes), then with ``--dtype f32``, in this process.  Each
    measurement of the kernel path runs each chain length three times
    (warm-up, two phases), one conv per link: forward chains call B4
    once a link, forward-backward chains B4 and B5 once a link.  Returns
    each run's counts, the runs' paths."""
    calls = 3 * (bench_pair_conv.REPS_LO + bench_pair_conv.REPS_HI)
    paths = {}
    for path, argv, f32 in (("bench_pair_conv", [], ""),
                            ("bench_pair_conv --dtype f32",
                             ["--dtype", "f32"], "_f32")):
        reset_counters()
        bench_pair_conv.main(argv)
        torch.cuda.synchronize()
        paths[path] = counts = read_counters()
        say(path, launches=counts)
        check_counts(path, counts, **{f"pair_fwd{f32}": 2 * calls,
                                      f"pair_bwd{f32}": calls})
    return paths


# bn_act: the SRGAN generator's BatchNorm with its PReLU or skip add
# (ops/bn_act.py, csrc/bn_act.cu) at the pretrain cell's tower shape
# against its plain version (the module composition: cuDNN's BatchNorm
# in f32 between casts, then the epilogue), each variant forward and
# backward, training and eval, bf16 and f32.  x has per-channel means and
# scales, and dy leans on x so that both mean terms of dx matter: with dy
# independent of x, mean(dz * xhat) is ~1 / sqrt(rows) of dz, below
# bf16's rounding, and a kernel that dropped it would pass.
BN_ACT_EPIS = ("prelu", "add", "none")
# Limits, |got - ref| <= rel |ref| + atol at every element.  The sides
# sum in other orders (cuDNN's kernels against per-CTA partials), so they
# differ by f32 rounding; in bf16 a value rounded to bf16 can then fall
# on the other side of a tie (one bf16 ulp, at most 2^-7 of it), which a
# skip add carries into the sum (2^-7 of the largest output).  y, dx and
# the running statistics: (rel, frac) with atol = frac * max|ref|.
# dweight, dbias, dslope: atol = BN_SUM_ROUNDING * the sum of the terms'
# magnitudes (an f32 sum of n terms errs by about log2(n) * 6e-8 of it,
# ~1e-6 here), rel 2^-7 for the bf16-rounded dslope.
BN_ACT_LIMITS = {
    torch.bfloat16: {"y": (2**-7, 2**-7), "dx": (2**-7, 2**-7),
                     "running": (1e-5, 1e-5)},
    torch.float32: {"y": (1e-5, 1e-5), "dx": (1e-4, 1e-4),
                    "running": (1e-5, 1e-5)},
}
BN_SUM_ROUNDING = 1e-5


def bn_act_excess(got, ref, rel: float, atol) -> float:
    """The largest |got - ref| / (rel |ref| + atol) (0 where equal)."""
    got, ref = got.double(), ref.double()
    diff = (got - ref).abs()
    ratio = diff / (rel * ref.abs() + atol)
    return float(torch.where(diff == 0, 0.0, ratio).max())


def bn_act_scores(got: dict, ref: dict, mags: dict, dtype) -> dict:
    """Each quantity's excess over its ``BN_ACT_LIMITS``; ``mags`` holds
    the sums' magnitudes (``bn_act_formulas``' ``*_abs``)."""
    lim, out = BN_ACT_LIMITS[dtype], {}
    for key in ("y", "dx", "running_mean", "running_var"):
        if key in ref:
            rel, frac = lim["running" if key.startswith("running") else key]
            out[key] = bn_act_excess(got[key], ref[key], rel,
                                     frac * ref[key].double().abs().max())
    for key in ("dweight", "dbias", "dslope"):
        if key in ref:
            rel = (2**-7 if key == "dslope" and dtype == torch.bfloat16
                   else 0.0)
            out[key] = bn_act_excess(
                got[key], ref[key], rel,
                BN_SUM_ROUNDING * mags[f"{key}_abs"].to(ref[key].device))
    return out


def bn_act_inputs(shape, dtype, seed: int):
    """x, skip, dy, a BatchNorm in training mode and a PReLU, seeded."""
    from torchsr_tpu_torch.models.layers import BatchNorm, PReLU

    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    mean = torch.rand(c, generator=g) * 2 - 1
    scale = torch.rand(c, generator=g) * 1.5 + 0.5
    xn = torch.randn(shape, generator=g)
    skip = torch.rand(shape, generator=g) * 2 - 1
    dy = (0.5 * torch.randn(shape, generator=g) + 0.5 * xn
          + 0.1 * (torch.rand(c, generator=g) - 0.5))
    bn, prelu = BatchNorm(c), PReLU()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=g) + 0.5)
        bn.bias.copy_(torch.rand(c, generator=g) - 0.5)
        bn.running_mean.copy_(mean + 0.1 * torch.randn(c, generator=g))
        bn.running_var.copy_(scale ** 2
                             * (0.8 + 0.4 * torch.rand(c, generator=g)))
        prelu.weight.fill_(0.2 + 0.1 * float(torch.rand(1, generator=g)))
    device = DEVICE
    return ((xn * scale + mean).to(device, dtype), skip.to(device, dtype),
            dy.to(device, dtype), bn.to(device), prelu.to(device))


def bn_act_run(fn, x, skip, dy, bn, prelu, epi: str, train: bool) -> dict:
    """``fn`` (``bn_act`` or ``bn_act_reference``) on copies of the
    module state, forward and backward: y, the gradients, the running
    statistics (training)."""
    import copy

    bn, prelu = copy.deepcopy(bn).train(train), copy.deepcopy(prelu)
    xr = x.clone().requires_grad_(True)
    res = skip.clone().requires_grad_(True) if epi == "add" else None
    y = fn(xr, bn, prelu=prelu if epi == "prelu" else None, residual=res)
    leaves = [xr, bn.weight, bn.bias] + (
        [prelu.weight] if epi == "prelu" else []) + (
        [res] if epi == "add" else [])
    grads = torch.autograd.grad(y, leaves, dy)
    out = {"y": y.detach(), "dx": grads[0], "dweight": grads[1],
           "dbias": grads[2]}
    if epi == "prelu":
        out["dslope"] = grads[3]
    if epi == "add":
        out["dskip"] = grads[3]
    if train:
        out.update(running_mean=bn.running_mean.clone(),
                   running_var=bn.running_var.clone(),
                   num_batches=int(bn.num_batches_tracked))
    return out


def bn_act_bound_ms(shape, dtype, epi: str, backward: bool) -> float:
    """Bytes over HBM bandwidth: forward x in and out out (and the skip
    in), backward x and dy in and dx out."""
    tensors = 3 if backward or epi == "add" else 2
    return (1e3 * tensors * math.prod(shape)
            * (torch.finfo(dtype).bits // 8) / HBM_BYTES_PER_S)


def _bn_act_timing(x, skip, dy, bn, prelu, epi: str) -> dict:
    """The training-mode forward and backward calls (CUDA events),
    profiled per kernel, beside their bytes bound, the plain version's
    times and cuDNN's ``F.batch_norm`` on the NHWC tensor (the library
    yardstick, which the port never calls): ``{"fwd": ..., "bwd": ...}``,
    each side timed alone (a backward replays one graph built once, with
    every gradient the kernels compute)."""
    import copy

    bn = copy.deepcopy(bn).train()
    sl = prelu.weight if epi == "prelu" else None
    res = skip if epi == "add" else None
    code = {"prelu": bn_ops._EPI_PRELU, "add": bn_ops._EPI_ADD,
            "none": bn_ops._EPI_NONE}[epi]
    _, stats = bn_ops.bn_act_fwd_cuda(x, bn, slope=sl, residual=res,
                                      epi=code)

    def fwd():
        return bn_ops.bn_act_fwd_cuda(x, bn, slope=sl, residual=res,
                                      epi=code)

    def bwd():
        return bn_ops.bn_act_bwd_cuda(x, dy, bn.weight, bn.bias, stats,
                                      slope=sl, epi=code, train=True)

    plain = copy.deepcopy(bn)
    pre = copy.deepcopy(prelu) if epi == "prelu" else None
    xg = x.clone().requires_grad_(True)
    y_plain = bn_ops.bn_act_reference(xg, plain, prelu=pre, residual=res)
    plain_leaves = [xg, plain.weight, plain.bias] + (
        [pre.weight] if pre is not None else [])

    def plain_fwd():
        return bn_ops.bn_act_reference(x, plain, prelu=pre, residual=res)

    def plain_bwd():
        return torch.autograd.grad(y_plain, plain_leaves, dy,
                                   retain_graph=True)

    lib_bn = copy.deepcopy(bn)
    nchw = x.permute(0, 3, 1, 2)
    xl = nchw.detach().clone().requires_grad_(True)
    dyl = dy.permute(0, 3, 1, 2)

    def lib(t):
        return F.batch_norm(t, lib_bn.running_mean, lib_bn.running_var,
                            lib_bn.weight, lib_bn.bias, True, 0.1, 1e-5)

    y_lib = lib(xl)

    def lib_bwd():
        return torch.autograd.grad(y_lib, [xl, lib_bn.weight, lib_bn.bias],
                                   dyl, retain_graph=True)

    return {
        "fwd": {"ms": median_ms(fwd),
                "profile": profile_device_time(fwd, 10, _kernel_name),
                "plain_ms": median_ms(plain_fwd),
                "library_ms": median_ms(lambda: lib(nchw)),
                "library_profile": profile_device_time(
                    lambda: lib(nchw), 10, _kernel_name),
                "bound_ms": bn_act_bound_ms(x.shape, x.dtype, epi, False),
                "bound_by": "bytes"},
        "bwd": {"ms": median_ms(bwd),
                "profile": profile_device_time(bwd, 10, _kernel_name),
                "plain_ms": median_ms(plain_bwd),
                "library_ms": median_ms(lib_bwd),
                "library_profile": profile_device_time(lib_bwd, 10,
                                                       _kernel_name),
                "bound_ms": bn_act_bound_ms(x.shape, x.dtype, epi, True),
                "bound_by": "bytes"}}


def _bn_act_pretrain(seed: int) -> dict:
    """The SRGAN pretrain at the cell's batch (128 crops of 96, K = 8): a
    captured step stands for SRGAN_BN forward and SRGAN_BN backward calls,
    and a call's counters read K times that through the replay
    accounting; the bn_act kernels' device time a step."""
    from argparse import Namespace

    from torchsr_tpu_torch.train import graphs
    from torchsr_tpu_torch.train.trainer import SRGANTrainer
    from torchsr_tpu_torch.utils.logging import Logger

    os.environ["WANDB_MODE"] = "disabled"  # never a network sink
    args = Namespace(batch_size=HEADLINE_BATCH, epochs=1, pretrain_epochs=1,
                     seed=seed, skip_image_save=True, disable_amp=False,
                     metrics_file=None)
    tr = SRGANTrainer(args, Namespace(crop_size=HEADLINE_CROP), None, 1, 1,
                      device=torch.device(DEVICE), logger=Logger())
    k = tr.steps_per_call
    crops, flips = _stacks(HEADLINE_BATCH, HEADLINE_CROP, k, seed + 5)
    tr.pretrain_step_multi(crops, flips)  # captures
    (graph,) = tr._graphs.values()
    reset_counters()
    tr.pretrain_step_multi(crops, flips)
    torch.cuda.synchronize()
    counts = read_counters()
    prof = profile_device_time(lambda: tr.pretrain_step_multi(crops, flips),
                               1, _kernel_name)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {n: 0 for n in graphs.launch_counts()}
    per_step.update(BN_ACT_FWD_LAUNCHES=SRGAN_BN,
                    BN_ACT_BWD_LAUNCHES=SRGAN_BN)
    check(graph.launches == per_step,
          f"a captured pretrain step stands for {per_step}: "
          f"{graph.launches}")
    check_counts("bn_act: srgan pretrain call", counts,
                 bn_act_fwd=k * SRGAN_BN, bn_act_bwd=k * SRGAN_BN)
    bn_ms = {n: ms / k for n, ms in prof["device_ms_per_batch"].items()
             if n.startswith("bn_")}
    return {"steps_per_call": k, "graph_launches": graph.launches,
            "call_launches": counts,
            "bn_act_device_ms_per_step": sum(bn_ms.values()),
            "bn_act_kernels_ms_per_step": bn_ms,
            "device_ms_per_step": sum(prof["device_ms_per_batch"].values())
            / k, "busy_share": prof["busy_share_of_span"],
            "top_kernels_ms_per_step": {
                n: ms / k for n, ms in list(
                    prof["device_ms_per_batch"].items())[:12]}}


def phase_bn_act(seed: int) -> dict:
    """bn_act at the SRGAN tower's shape: each variant (PReLU, skip add,
    none) in bf16 and f32, training and eval, forward and backward,
    within ``BN_ACT_LIMITS`` of its plain version; the emulated fault
    (dx without its xhat * mean(dz * xhat) term) over them; the training
    calls timed beside their bounds, the plain version and cuDNN; the
    pretrain path's counts through the replay accounting."""
    rows, timed = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).removeprefix("torch.")
        f32 = "_f32" if dtype == torch.float32 else ""
        x, skip, dy, bn, prelu = bn_act_inputs(SRGAN_TOWER, dtype, seed + 40)
        for epi in BN_ACT_EPIS:
            sl = prelu.weight if epi == "prelu" else None
            res = skip if epi == "add" else None
            for train in (True, False):
                name = f"{dt} {epi} {'train' if train else 'eval'}"
                reset_counters()
                got = bn_act_run(bn_ops.bn_act, x, skip, dy, bn, prelu, epi,
                                 train)
                torch.cuda.synchronize()
                counts = read_counters()
                ref = bn_act_run(bn_ops.bn_act_reference, x, skip, dy, bn,
                                 prelu, epi, train)
                bn.train(train)
                f64 = bn_ops.bn_act_formulas(x, bn, slope=sl, residual=res,
                                             dy=dy)
                row = {"max_abs_err": float((got["y"].float()
                                             - ref["y"].float()).abs().max()),
                       "max_abs_err_dx": float(
                           (got["dx"].float() - ref["dx"].float()).abs().max()),
                       "excess": bn_act_scores(got, ref, f64, dtype),
                       "excess_vs_float64": bn_act_scores(got, f64, f64,
                                                          dtype),
                       "plain_vs_float64": bn_act_scores(ref, f64, f64,
                                                         dtype)}
                if train:
                    row["wrong_dzx"] = bn_act_scores(
                        bn_ops.bn_act_formulas(x, bn, slope=sl,
                                               residual=res, dy=dy,
                                               drop="dzx"), ref, f64, dtype)
                bn.train()
                rows[name] = row
                say(f"bn_act[{name}]", shape=list(SRGAN_TOWER), **row)
                check_counts(f"bn_act {name}", counts,
                             **{f"bn_act_fwd{f32}": 1, f"bn_act_bwd{f32}": 1})
                check(max(row["excess"].values()) <= 1,
                      f"bn_act {name} within its limits: {row['excess']}")
                if train:
                    check(got["num_batches"] == ref["num_batches"] == 1,
                          f"bn_act {name}: num_batches_tracked moved once")
                    check(row["wrong_dzx"]["dx"] > 1,
                          f"bn_act {name}: the limits see a dropped "
                          f"mean(dz * xhat) term: {row['wrong_dzx']}")
                if epi == "add":
                    check(torch.equal(got["dskip"], dy),
                          f"bn_act {name}: the skip's gradient is dy")
        for epi in BN_ACT_EPIS:
            t = _bn_act_timing(x, skip, dy, bn, prelu, epi)
            row = rows[f"{dt} {epi} train"]
            t["fwd"]["max_abs_err"] = row["max_abs_err"]
            t["bwd"]["max_abs_err"] = row["max_abs_err_dx"]
            timed[(dt, epi)] = t
            say(f"bn_act_time[{dt} {epi}]", **t)
        del x, skip, dy
    say("bn_act_pretrain", **_bn_act_pretrain(seed))
    out = {}
    for dt in ("bfloat16", "float32"):
        out[dt] = timed[(dt, "prelu")]["fwd"]
        out[f"{dt}_bwd"] = timed[(dt, "prelu")]["bwd"]
    return out


class _WrongBwdBlock(torch.autograd.Function):
    """The plain block forward with the emulated backward carrying one
    of the ``WRONG_BWD`` faults."""

    @staticmethod
    def forward(ctx, x, fault, *params):
        ks, bs = params[:5], params[5:]
        out, feat = rdb_ops._rdb_plain(x, ks, bs, SCALE)
        ctx.fault = fault
        ctx.save_for_backward(feat, *ks)
        return out

    @staticmethod
    def backward(ctx, g):
        feat, *ks = ctx.saved_tensors
        dx, dws, dbs, _ = emulated_bwd(g, feat, ks, SCALE, ctx.fault)
        return (dx, None, *[d.to(k.dtype) for d, k in zip(dws, ks)], *dbs)


def _rel_grads(got, ref) -> list:
    return [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(got, ref)]


# train_grad's variants: the knob it sets and the forward and backward
# counters the generator's blocks must move.
TRAIN_GRAD_VARIANTS = {
    "": (None, ("rdb_fwd", "rdb_bwd")),
    "ext": ("EXT_KERNEL", ("rdb_fwd_ext", "rdb_bwd_ext")),
    "xla": ("BWD_XLA", ("rdb_fwd", "rdb_bwd_xla")),
}


def phase_train_grad(seed: int, variant: str = "") -> dict:
    """One L1 backward of the full generator: the kernel path's gradient
    of every parameter against the plain path's, in f32 and bf16; on B1
    and B2, with ``variant="ext"`` on B7 and B8 (the 32x32 input is
    eligible), with ``"xla"`` on B1 and the plain backward
    (``TORCHSR_RDB_BWD=xla``)."""
    name, kernels = TRAIN_GRAD_VARIANTS[variant]
    phase = f"train_grad_{variant}" if variant else "train_grad"
    with knob(name) if name else contextlib.nullcontext():
        return _train_grad(seed, phase, kernels)


def _train_grad(seed: int, phase: str, kernels: tuple,
                scale: int = 4) -> dict:
    """``phase_train_grad`` with the generator at ``scale``, on the LR
    crop a 128 HR crop gives it."""
    dev = torch.device(DEVICE)
    gen = ESRGANGenerator(
        num_rrdb_blocks=NUM_RRDB, scale_factor=scale,
        generator=torch.Generator().manual_seed(seed + 5)).to(dev)
    g = torch.Generator().manual_seed(seed + 6)
    lr = 128 // scale
    x = torch.rand((TRAIN_GRAD_BATCH, lr, lr, 3), generator=g).to(dev)
    hr = torch.rand((TRAIN_GRAD_BATCH, 128, 128, 3), generator=g).to(dev)
    names, params = zip(*gen.named_parameters())

    def grads(fn):
        loss = (fn(x) - hr).abs().mean()
        return torch.autograd.grad(loss, params)

    def wrong(y, kernels, biases, *, scale_ratio):
        return _WrongBwdBlock.apply(y, "lrelu_one", *kernels, *biases)

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen.compute_dtype = None if dtype == torch.float32 else dtype
        reset_counters()
        got = grads(gen)
        torch.cuda.synchronize()
        counts = read_counters()
        fwd = fwd_counter(kernels[0], dtype)
        bwd = kernels[1] if kernels[1] == "rdb_bwd_xla" else fwd_counter(
            kernels[1], dtype)
        launches = (counts[fwd], counts[bwd])
        ref = grads(lambda t: plain_generator(gen, t))
        bad = grads(lambda t: plain_generator(gen, t, wrong))
        rel, rel_wrong = _rel_grads(got, ref), _rel_grads(bad, ref)
        worst = max(range(len(rel)), key=rel.__getitem__)
        name = str(dtype).removeprefix("torch.")
        rows[name] = row = {
            "launches_fwd_bwd": list(launches),
            "max_rel": rel[worst], "worst_param": names[worst],
            "wrong_lrelu_one_max_rel": max(rel_wrong),
            "limit": TOL_GRAD[dtype],
            "rdb_params_max_rel": max(r for n, r in zip(names, rel)
                                      if ".RDB" in n),
            "other_params_max_rel": max(r for n, r in zip(names, rel)
                                        if ".RDB" not in n),
        }
        say(f"{phase}[{name}]", batch=TRAIN_GRAD_BATCH, rrdb=NUM_RRDB,
            lr_hw=lr, kernels=list(kernels), **row)
        check_counts(f"{phase} {name}: one kernel forward and backward "
                     f"per block", counts, **{fwd: 5 * 3 * NUM_RRDB,
                                              bwd: 3 * NUM_RRDB})
        check(row["max_rel"] <= TOL_GRAD[dtype],
              f"{phase} {name}: gradients within {TOL_GRAD[dtype]}")
        check(row["wrong_lrelu_one_max_rel"] > TOL_GRAD[dtype],
              f"{phase} {name}: the limit sees a wrong backward")
    gen.compute_dtype = None
    return rows


# The RDB backward's kernels: bf16 (csrc/rdb_bwd_sm90.cuh) and f32
# (csrc/rdb_bwd_tf32_sm90.cuh), every name holding "rdb_bwd_".
_RDB_BWD_KERNELS = ("rdb_bwd_",)


def _kernel_class(name: str) -> str:
    if any(k in name for k in ("bn_stats", "bn_apply", "bn_bwd_")):
        return "bn_act"
    if "conv3x3_" in name or "rdb_fwd_" in name:
        return "rdb_fwd"
    if any(k in name for k in _RDB_BWD_KERNELS):
        return "rdb_bwd"
    low = name.lower()
    if "multi_tensor_apply" in low or "adam" in low:
        return "optimizer"
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "gemm",
                              "sm90_", "cutlass", "wgrad", "dgrad")):
        return "other_conv"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copy"
    if "elementwise" in low or "vectorized" in low or "reduce" in low:
        return "elementwise"
    return "other"


def profile_device_time(fn, batches: int = 3, key=_kernel_class) -> dict:
    """Device time per kernel class (or per ``key`` of the kernel's
    name) over ``batches`` calls of ``fn``, and the device's busy share
    of the span from the first kernel to the last."""
    spans = device_spans(fn, batches)
    by_class: dict = {}
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, name in spans:
        cls = key(name)
        by_class[cls] = by_class.get(cls, 0.0) + (end - start) / 1e3
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    total = sum(by_class.values())
    return {
        "batches": batches,
        "device_ms_per_batch": {k: v / batches for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        "share": {k: v / total for k, v in by_class.items()},
        "kernels_per_batch": len(spans) / batches,
        "busy_share_of_span": busy / (spans[-1][1] - spans[0][0]),
    }


def _kernel_name(name: str) -> str:
    """A kernel's name without return type, namespaces' noise and
    arguments."""
    return name.removeprefix("void ").replace(
        "(anonymous namespace)::", "").split("(")[0][:60]


def _dist(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a - b).abs()
    return {"max": float(d.max()), "mean": float(d.mean())}


def hold_generator(gen: ESRGANGenerator, x: torch.Tensor) -> dict:
    """The generator's kernel path in f32 and bf16 against its plain
    path in f32, and what generators with wrong blocks read there (max
    and mean absolute differences)."""
    with torch.inference_mode():
        gen.compute_dtype = None
        out = gen(x)
        check(tuple(out.shape) == (x.shape[0], 256, 256, 3),
              "generator 4x shape")
        check(bool(torch.isfinite(out).all()), "generator output finite")
        ref = plain_generator(gen, x)
        row = {"f32_vs_f32_plain": _dist(out, ref)}
        gen.compute_dtype = torch.bfloat16
        out = gen(x)
        row["bf16_vs_f32_plain"] = _dist(out, ref)
        row["bf16_vs_bf16_plain"] = _dist(out, plain_generator(gen, x))
        gen.compute_dtype = None
        row["wrong_block_vs_f32_plain"] = {
            name: _dist(plain_generator(gen, x, fn), ref)
            for name, fn in WRONG_BLOCKS.items()}
        row["tf32_block_vs_f32_plain"] = _dist(
            plain_generator(gen, x, tf32_block), ref)
    scale = float(ref.abs().max())
    row["f32_limit"] = TOL_GEN_F32 * scale
    row["tf32_block_excess"] = (row["tf32_block_vs_f32_plain"]["max"]
                                / row["f32_limit"])
    row["bf16_limit"] = TOL_GEN_BF16 * scale
    row["out_range"] = [float(ref.min()), float(ref.max())]
    check(row["f32_vs_f32_plain"]["max"] <= row["f32_limit"],
          f"generator f32: {row}")
    check(min(d["max"] for d in row["wrong_block_vs_f32_plain"].values())
          > row["f32_limit"],
          f"the f32 limit sees a generator with wrong blocks: {row}")
    check(row["bf16_vs_f32_plain"]["max"] <= row["bf16_limit"],
          f"generator bf16: {row}")
    return row


def phase_generator(seed: int, rdb_bf16_ms: float) -> ESRGANGenerator:
    dev = torch.device(DEVICE)
    gen = ESRGANGenerator(
        num_rrdb_blocks=NUM_RRDB, generator=torch.Generator().manual_seed(seed)
    ).to(dev).requires_grad_(False)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.rand((16, 64, 64, 3), generator=g).to(dev)
    rows = {"model_init": hold_generator(gen, x)}
    # the same generator with the blocks' convs at torch's default init
    visible = ESRGANGenerator(num_rrdb_blocks=NUM_RRDB, device="meta")
    visible.load_state_dict({k: v.clone() for k, v in
                             gen.state_dict().items()}, assign=True)
    for m in visible.blocks.modules():
        if isinstance(m, ResidualDenseBlock):
            for conv in m.convs():
                conv.kernel_std = None
                conv.reset_parameters(g)
    rows["rdb_default_init"] = row = hold_generator(
        visible.requires_grad_(False), x)
    del visible
    row["bf16_vs_bf16_plain_mean_limit"] = limit = GEN_BF16_FRAC * min(
        d["mean"] for d in row["wrong_block_vs_f32_plain"].values())
    check(row["bf16_vs_bf16_plain"]["mean"] <= limit,
          f"generator bf16 within {GEN_BF16_FRAC} of a wrong block: {row}")
    # plain TF32 in the blocks moves the output by the TF32 rounding of
    # what the blocks add: at the model's own init that is the limit's
    # order (read 1.05 on the card), at the default init five times it
    check(row["tf32_block_excess"] > 1,
          f"the f32 limit sees a generator whose blocks multiply in plain "
          f"TF32: {row}")
    with torch.inference_mode():
        gen.compute_dtype = torch.bfloat16
        ms = median_ms(lambda: gen(x), reps=5, warmup=1)
        plain_ms = median_ms(lambda: plain_generator(gen, x), reps=5,
                             warmup=1)
        prof = profile_device_time(lambda: gen(x))
    say("generator", rrdb=NUM_RRDB, params=sum(p.numel()
                                               for p in gen.parameters()),
        tile_batch=list(x.shape), **rows, bf16_ms=ms,
        bf16_plain_ms=plain_ms,
        bf16_output_mp_per_s=x.shape[0] * 256 * 256 / 1e6 / (ms / 1e3),
        # the 3 * 23 residual dense blocks at the rdb_fwd phase's time
        rdb_share_of_bf16_ms=3 * NUM_RRDB * rdb_bf16_ms / ms)
    say("profile", tile_batch=list(x.shape), dtype="bfloat16", **prof)
    return gen


def _png(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _unpng(body: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)))


def _levels(a: np.ndarray, b: np.ndarray) -> dict:
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"mean": float(diff.mean()), "max": int(diff.max())}


def save_serving_checkpoint(gen: ESRGANGenerator) -> str:
    """``gen``'s weights as the serving phases' .pth; returns its path."""
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    ckpt = os.path.join(workdir, "esrgan-gan-best.pth")
    save_checkpoint(ckpt, 1, "gan", gen.state_dict())
    return ckpt


def serving_generator(seed: int) -> tuple:
    """The generator phase's seeded 23-RRDB ESRGAN on the card, without
    its checks, and its checkpoint (for ``--only`` serving phases)."""
    gen = ESRGANGenerator(
        num_rrdb_blocks=NUM_RRDB, generator=torch.Generator().manual_seed(seed)
    ).to(DEVICE).requires_grad_(False)
    return gen, save_serving_checkpoint(gen)


def phase_serve(gen: ESRGANGenerator, ckpt: str, seed: int,
                ilv: bool = False, prior=None) -> tuple[dict, list]:
    """Three PNG requests to the checkpoint-backed daemon; on B1, or with
    ``ilv`` (``ILV_KERNEL`` set) on B6.  Returns the path's launch counts
    and the answers; ``prior`` (the B1 answers) is compared with these."""
    phase = "serve_ilv" if ilv else "serve"
    with knob("ILV_KERNEL", ilv):
        return _serve(gen, ckpt, seed, phase, prior)


def _serve(gen, ckpt, seed, phase, prior):
    service = CheckpointUpscaleService(model="esrgan", checkpoint=ckpt,
                                       device=DEVICE)
    t0 = time.perf_counter()
    server = make_server(service, port=0)
    warmup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in REQUEST_SIZES]
    bodies = [_png(f) for f in frames]
    tile, batch = service.tile, service.tile_batch
    overlap = service._resolve_overlap(None)
    batches = 0
    latencies = []
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            check(resp.status == 200, "/healthz 200 after warmup")
        reset_counters()  # the main path starts here
        answers = []
        for frame, body in zip(frames, bodies):
            h, w = frame.shape[:2]
            n_tiles = (len(_positions(max(h, tile), tile, tile - overlap))
                       * len(_positions(max(w, tile), tile, tile - overlap)))
            batches += -(-n_tiles // batch)
            req = urllib.request.Request(base + "/upscale", data=body,
                                         method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as resp:
                check(resp.status == 200, "/upscale 200")
                answers.append(_unpng(resp.read()))
            latencies.append((time.perf_counter() - t0) * 1e3)
        counts = read_counters()
        with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
            metrics = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    for frame, sr in zip(frames, answers):
        h, w = frame.shape[:2]
        check(sr.shape == (4 * h, 4 * w, 3) and sr.dtype == np.uint8,
              f"answer for {h}x{w} is a {4 * h}x{4 * w} RGB uint8 image")
        check(int(sr.max()) > int(sr.min()), "answer is not constant")
    kernel = "rdb_fwd_ilv" if phase == "serve_ilv" else "rdb_fwd"
    check_counts(f"{phase}: the main path", counts,
                 **{kernel: 5 * 3 * NUM_RRDB * batches})
    check(metrics["requests"] == len(frames) and metrics["errors"] == 0,
          "/metrics counts the requests")

    def tiling(fn, frame):
        x = torch.from_numpy(frame).to(DEVICE).float() / 255.0
        out = tiled_upscale(fn, x, scale=4, tile=tile, overlap=overlap,
                            tile_batch=batch)
        return (out.clamp(0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()

    # each answer against the same tiling of the generator (bf16, the
    # kernel path the knobs select); the first frame also against the
    # f32 plain generator and against a generator whose blocks lost conv5
    with torch.inference_mode():
        gen.compute_dtype = torch.bfloat16
        vs_direct = [_levels(sr, tiling(gen, f))
                     for f, sr in zip(frames, answers)]
        gen.compute_dtype = None
        ref = tiling(lambda b: plain_generator(gen, b), frames[0])
        wrong = tiling(lambda b: plain_generator(gen, b, conv5_skipped),
                       frames[0])
    extra = {}
    if prior is not None:
        extra["vs_b1_answers_levels"] = [_levels(a, b)
                                         for a, b in zip(answers, prior)]
    say(phase, sizes=[list(s) for s in REQUEST_SIZES],
        warmup_s=warmup_s, request_ms=latencies, tile_batches=batches,
        launches=counts, vs_same_tiling_levels=vs_direct,
        first_vs_f32_plain_levels=_levels(answers[0], ref),
        conv5_skipped_vs_f32_plain_levels=_levels(wrong, ref),
        **extra, metrics=metrics, meta=service.meta)
    check(max(d["max"] for d in vs_direct) <= TOL_SERVE_LEVELS,
          f"served frames within {TOL_SERVE_LEVELS} level of the "
          f"generator's own tiling: {vs_direct}")
    return counts, answers


# serve_graph: a frame whose 24 tiles (64 px, overlap 8) fill one batch
# of 16 and pad the second; export: the serving shape; batching: eight
# one-tile requests of a 64 px tile, batch 16, against the same frames
# unbatched.  A tile forward's first call runs one eager forward on a
# side stream before it captures the graph (infer/tiled.py TileForward),
# which adds CAPTURE_FORWARDS forwards to the path that makes it.
SERVE_GRAPH_FRAME = (200, 300)
CAPTURE_FORWARDS = 1
BATCHING_REQUESTS = ((64, 64), (40, 56), (64, 48), (33, 64), (60, 60),
                     (17, 23), (64, 64), (50, 37))
BATCHING_WAIT_MS = 100.0


def busy_row(fn, calls: int = 3) -> dict:
    """``fn`` (one call) by the host clock (median of 10 synchronized
    calls) and under the profiler: device ms and kernels a call, and the
    device's busy share of the span from the window's first kernel to
    its last (host gaps between the calls show there)."""
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    spans = device_spans(fn, calls)
    busy, cur = 0.0, None
    for start, end, _name in spans:
        if cur is None or start > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy += cur[1] - cur[0]
    return {"wall_ms": statistics.median(walls),
            "device_ms": sum(e - s for s, e, _ in spans) / 1e3 / calls,
            "kernels": len(spans) / calls,
            "busy_share": busy / (spans[-1][1] - spans[0][0])}


def phase_serve_graph(gen: ESRGANGenerator, seed: int,
                      ilv: bool = False) -> dict:
    """The tiled frame through the graphed tile forward against the
    eager one, bf16 on B1 (or with ``ilv`` on B6): equal bytes, two
    graphed calls equal, launch counts equal; a tile batch's wall and
    device ms and busy share, graphed and eager."""
    from torchsr_tpu_torch.infer.tiled import tile_forward

    phase = "serve_graph_ilv" if ilv else "serve_graph"
    kernel = "rdb_fwd_ilv" if ilv else "rdb_fwd"
    h, w = SERVE_GRAPH_FRAME
    tile, overlap, batch = 64, 8, 16
    batches = bench_tile_batches(SERVE_GRAPH_FRAME, tile, overlap, batch)
    x = torch.from_numpy(np.random.default_rng(seed + 5).random(
        (h, w, 3)).astype(np.float32)).to(DEVICE)
    tiles = torch.from_numpy(np.random.default_rng(seed + 6).random(
        (batch, tile, tile, 3)).astype(np.float32)).to(DEVICE)
    gen.compute_dtype = torch.bfloat16
    with knob("ILV_KERNEL", ilv):
        forward = tile_forward(gen, DEVICE)
        reset_counters()
        forward(tiles)  # captures the graph
        capture = read_counters()

        def frame(fn):
            reset_counters()
            out = tiled_upscale(fn, x, scale=4, tile=tile, overlap=overlap,
                                tile_batch=batch)
            torch.cuda.synchronize()
            return out, read_counters()

        graphed, graphed_counts = frame(forward)
        again, _ = frame(forward)
        eager, eager_counts = frame(gen)

        def eager_batch():
            with torch.inference_mode():
                gen(tiles)

        rows = {"graphed": busy_row(lambda: forward(tiles)),
                "eager": busy_row(eager_batch)}
    gen.compute_dtype = None
    diff = float((graphed - eager).abs().max())
    say(phase, frame=[h, w], tile=tile, overlap=overlap, tile_batch=batch,
        tile_batches=batches, capture_launches=capture,
        launches=graphed_counts, eager_launches=eager_counts,
        graphed_equals_eager=torch.equal(graphed, eager),
        graphed_max_abs_diff=diff, two_calls_equal=torch.equal(graphed,
                                                               again),
        tile_batch_rows=rows)
    check(tuple(graphed.shape) == (4 * h, 4 * w, 3)
          and bool(torch.isfinite(graphed).all()),
          f"{phase}: a finite 4x frame")
    check(torch.equal(graphed, eager),
          f"{phase}: the graphed frame equals the eager one ({diff})")
    check(torch.equal(graphed, again),
          f"{phase}: two graphed frames are the same bytes")
    check_counts(f"{phase}: capture and first replay", capture,
                 **{kernel: 5 * 3 * NUM_RRDB * (CAPTURE_FORWARDS + 1)})
    check_counts(f"{phase}: graphed frame", graphed_counts,
                 **{kernel: 5 * 3 * NUM_RRDB * batches})
    check(graphed_counts == eager_counts,
          f"{phase}: graphed launches {graphed_counts} equal eager "
          f"{eager_counts}")
    return {phase: graphed_counts}


def phase_export(gen: ESRGANGenerator, ckpt: str, seed: int) -> dict:
    """A native (bf16, RDB operator) and a portable (f32, aten) artifact
    of the full-width ESRGAN at (16, 64, 64, 3), exported by the CLI:
    the native one launches B1 and equals the live graphed generator
    within ``TOL_SERVE_LEVELS``; the portable one launches nothing and
    is held against the f32 plain generator; ``serve ARTIFACT`` answers
    a request; ``eval --artifact`` scores the eval images."""
    from torchsr_tpu_torch.infer.server import UpscaleService
    from torchsr_tpu_torch.infer.serving import ServedGenerator, rdb_op_calls
    from torchsr_tpu_torch.infer.tiled import tile_forward

    workdir = os.path.join(ROOT, "build", "chip_smoke", "export")
    os.makedirs(workdir, exist_ok=True)
    native = os.path.join(workdir, "esrgan-native.pt2")
    portable = os.path.join(workdir, "esrgan-portable.pt2")
    common = ["--checkpoint", ckpt, "--tile", "64", "--tile-batch", "16"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["export", native, *common, "--bf16", "--native-kernels"])
        cli.main(["export", portable, *common])
    export_s = time.perf_counter() - t0
    x = torch.from_numpy(np.random.default_rng(seed + 7).random(
        (16, 64, 64, 3)).astype(np.float32)).to(DEVICE)
    paths, row = {}, {"export_s": export_s}
    served = ServedGenerator(native, device=DEVICE)
    row["native_meta"] = served.meta
    row["native_op_calls"] = rdb_op_calls(torch.export.load(native))
    served(x)  # captures the graph
    reset_counters()
    got = served(x)
    torch.cuda.synchronize()
    paths["export: native artifact"] = counts = read_counters()
    gen.compute_dtype = torch.bfloat16
    live = tile_forward(gen, DEVICE)(x).clone()
    gen.compute_dtype = None

    def u8(t):
        return (t.clamp(0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()

    row["native_vs_live_graph"] = {**_dist(got, live),
                                   "levels": _levels(u8(got), u8(live))}
    row["native_ms"] = median_ms(lambda: served._forward(x), reps=10)
    check_counts("export: native artifact", counts,
                 rdb_fwd=5 * 3 * NUM_RRDB)
    check(row["native_op_calls"] == 3 * NUM_RRDB,
          f"the native program calls the RDB operator per block: "
          f"{row['native_op_calls']}")
    check(row["native_vs_live_graph"]["levels"]["max"] <= TOL_SERVE_LEVELS,
          f"native artifact within {TOL_SERVE_LEVELS} level of the live "
          f"graphed generator: {row['native_vs_live_graph']}")
    del served
    served = ServedGenerator(portable, device=DEVICE)
    reset_counters()
    got = served(x)
    torch.cuda.synchronize()
    paths["export: portable artifact"] = counts = read_counters()
    with torch.inference_mode():
        ref = plain_generator(gen, x)
    limit = TOL_GEN_F32 * float(ref.abs().max())
    row["portable_vs_f32_plain"] = _dist(got, ref)
    row["portable_limit"] = limit
    row["portable_ms"] = median_ms(lambda: served._forward(x), reps=10)
    check_counts("export: portable artifact", counts)
    check(row["portable_vs_f32_plain"]["max"] <= limit,
          f"portable artifact within {TOL_GEN_F32} of the f32 plain "
          f"generator's largest output: {row['portable_vs_f32_plain']}")
    del served
    # serve ARTIFACT: one request to the daemon around the native artifact
    service = UpscaleService(native, device=DEVICE)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    frame = np.random.default_rng(seed + 8).integers(
        0, 256, (*REQUEST_SIZES[1], 3), dtype=np.uint8)
    tiles = (len(_positions(frame.shape[0], 64, 48))
             * len(_positions(frame.shape[1], 64, 48)))
    try:
        reset_counters()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/upscale",
            data=_png(frame), method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, sr = resp.status, _unpng(resp.read())
        paths["export: serve ARTIFACT"] = counts = read_counters()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    row["serve_artifact"] = {"status": status, "shape": list(sr.shape),
                             "launches": counts, "meta": service.meta}
    check(status == 200 and sr.shape == (4 * frame.shape[0],
                                         4 * frame.shape[1], 3)
          and sr.max() > sr.min(), "serve ARTIFACT answers a 4x image")
    check_counts("export: serve ARTIFACT", counts,
                 rdb_fwd=5 * 3 * NUM_RRDB * -(-tiles // 16))
    del service
    # eval --artifact on the eval images (each below the tile: one
    # forward of the artifact's batch each), after its capture
    folder = _eval_images(seed)
    reset_counters()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["eval", folder, "--artifact", native, "--report",
                  os.path.join(workdir, "eval_artifact.json")])
    paths["export: eval --artifact"] = counts = read_counters()
    with open(os.path.join(workdir, "eval_artifact.json")) as fh:
        report = json.load(fh)
    row["eval_artifact"] = {**_headline(report), "launches": counts}
    _check_report(report, "eval --artifact")
    check_counts("export: eval --artifact", counts, rdb_fwd=5 * 3 * NUM_RRDB
                 * (report["images"] + CAPTURE_FORWARDS))
    say("export", shape=list(x.shape), **row)
    return paths


def phase_batching(ckpt: str, seed: int) -> dict:
    """Eight concurrent tile-sized requests through the batcher (bf16,
    B1, batch 16) against the same frames unbatched: equal within
    ``TOL_SERVE_LEVELS``, more than one tile a forward, and B1's
    launches at the batcher's forwards."""
    rng = np.random.default_rng(seed + 9)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in BATCHING_REQUESTS]
    off = CheckpointUpscaleService(model="esrgan", checkpoint=ckpt,
                                   device=DEVICE)
    off.warmup()
    want = [off._guarded_upscale(f, None) for f in frames]
    off_ms = busy_row(lambda: off._guarded_upscale(frames[0], None),
                      calls=1)["wall_ms"]
    del off
    on = CheckpointUpscaleService(model="esrgan", checkpoint=ckpt,
                                  device=DEVICE, batch_requests=True,
                                  batch_wait_ms=BATCHING_WAIT_MS)
    on.warmup()
    before = on.metrics()
    got = [None] * len(frames)
    barrier = threading.Barrier(len(frames))

    def client(i):
        barrier.wait()
        got[i] = on._guarded_upscale(frames[i], None)

    reset_counters()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(frames))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counters()
    after = on.metrics()
    on.close()
    calls = after["batched_calls"] - before["batched_calls"]
    tiles = after["batched_tiles"] - before["batched_tiles"]
    levels = [_levels(a, b) for a, b in zip(got, want)]
    say("batching", requests=[list(s) for s in BATCHING_REQUESTS],
        wait_ms=BATCHING_WAIT_MS, forwards=calls, tiles=tiles,
        tiles_per_forward=tiles / max(calls, 1), launches=counts,
        batched_wall_ms=wall_ms, one_unbatched_request_ms=off_ms,
        vs_unbatched_levels=levels, meta=on.meta, metrics=after)
    check(all(g is not None and g.shape == (4 * f.shape[0], 4 * f.shape[1],
                                            3) for g, f in zip(got, frames)),
          "batching: every request answered with a 4x frame")
    check(max(d["max"] for d in levels) <= TOL_SERVE_LEVELS,
          f"batched frames within {TOL_SERVE_LEVELS} level of the "
          f"unbatched ones: {levels}")
    check(tiles == len(frames) and calls >= 1 and tiles / calls > 1,
          f"batching: {tiles} tiles in {calls} forwards (> 1 a forward)")
    check_counts("batching", counts, rdb_fwd=5 * 3 * NUM_RRDB * calls)
    return {"batching": counts}


def phase_test(ckpt: str, seed: int) -> None:
    """The ``test`` subcommand through the CLI's own ``main``."""
    from PIL import Image

    workdir = os.path.dirname(ckpt)
    frame = np.random.default_rng(seed + 2).integers(
        0, 256, (*TEST_IMAGE, 3), dtype=np.uint8)
    Image.fromarray(frame).save(os.path.join(workdir, "photo.png"))
    h, w = TEST_IMAGE
    overlap = 16  # the test subcommand's default --tile-overlap
    tiles = (len(_positions(h, 64, 64 - overlap))
             * len(_positions(w, 64, 64 - overlap)))
    rows = []
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for extra, batches in (([], 1),
                               (["--tile", "64", "--tile-batch", "16"],
                                -(-tiles // 16) + CAPTURE_FORWARDS)):
            reset_counters()
            t0 = time.perf_counter()
            cli.main(["test", "photo.png", "--checkpoint", ckpt, *extra])
            wall_ms = (time.perf_counter() - t0) * 1e3
            counts = read_counters()
            with Image.open("upres-photo.png") as img:
                sr = np.asarray(img)
            check(sr.shape == (4 * h, 4 * w, 3) and sr.max() > sr.min(),
                  f"test {extra} wrote a non-constant {4 * h}x{4 * w} image")
            check_counts(f"test {extra}", counts,
                         rdb_fwd=5 * 3 * NUM_RRDB * batches)
            rows.append({"args": extra, "wall_ms": wall_ms,
                         "rdb_fwd_launches": counts["rdb_fwd"]})
    finally:
        os.chdir(cwd)
    say("test", image=list(TEST_IMAGE), runs=rows)


def _write_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


def _finite_metrics(path: str) -> dict:
    """Every loss and quality value the run logged, each required
    finite; returns the last value of each key."""
    last = {}
    with open(path) as fh:
        for line in fh:
            row = json.loads(line)
            for k, v in row.items():
                if k.endswith(("loss", "PSNR", "SSIM")):
                    check(np.isfinite(v), f"{k} = {v} is finite")
                    last[k] = v
    return last


def phase_train(seed: int, ext: bool = False, f32: bool = False) -> dict:
    """``python -m torchsr_tpu_torch train`` (in this process) on seeded
    random PNGs, then ``test`` on the GAN phase's best checkpoint: on
    B1/B2, or with ``ext`` (``EXT_KERNEL`` set) on B7/B8, with ``test``
    run whole-image (W = 140 is not eligible: B1) and tiled (B7); with
    ``f32``, ``train --disable-amp`` (TF32 off, as ``main`` sets it):
    every step, eval and render on the f32 (3xTF32) B1 and B2 (with
    ``ext`` B7 and B8)."""
    phase = "train" + ("_f32" if f32 else "") + ("_ext" if ext else "")
    with knob("EXT_KERNEL", ext):
        return _train(seed, phase, ext, f32)


def _train(seed: int, phase: str, ext: bool, f32: bool = False) -> dict:
    import shutil

    workdir = os.path.join(ROOT, "build", "chip_smoke", phase)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(os.path.join(workdir, "ds"))
    os.makedirs(os.path.join(workdir, "media"))
    rng = np.random.default_rng(seed)
    for i in range(TRAIN_IMAGES):
        _write_png(os.path.join(workdir, "ds", f"img{i:03d}.png"),
                   rng.integers(0, 256, (*TRAIN_IMAGE_HW, 3), np.uint8))
    _write_png(os.path.join(workdir, "media", "waterfalls-low-res.png"),
               rng.integers(0, 256, (*SAMPLE_HW, 3), np.uint8))
    n_eval = -(-TRAIN_IMAGES // 10)
    steps = (TRAIN_IMAGES - n_eval) // TRAIN_BATCH  # per epoch
    evals = -(-n_eval // TRAIN_BATCH)
    # two epochs (pretrain, GAN): steps run the kernels forward and
    # backward in bf16 (f32 with ``f32``); evals and sample renders
    # forward only, in f32
    fwd, bwd = ("rdb_fwd_ext", "rdb_bwd_ext") if ext else ("rdb_fwd",
                                                            "rdb_bwd")
    step_dt = torch.float32 if f32 else torch.bfloat16
    want = {fwd_counter(fwd, torch.float32): 5 * 3 * NUM_RRDB * 2
            * (evals + 1)}
    want[fwd_counter(fwd, step_dt)] = want.get(
        fwd_counter(fwd, step_dt), 0) + 5 * 3 * NUM_RRDB * 2 * steps
    want[fwd_counter(bwd, step_dt)] = 3 * NUM_RRDB * 2 * steps
    h, w = TEST_IMAGE
    tiles = (len(_positions(h, 64, 48)) * len(_positions(w, 64, 48)))
    # test: whole-image (B1 either way), and under ext tiled at 64 (B7)
    tests = [([], {"rdb_fwd": 5 * 3 * NUM_RRDB})]
    if ext:
        tests.append((["--tile", "64", "--tile-batch", "16"],
                      {"rdb_fwd_ext": 5 * 3 * NUM_RRDB
                       * (-(-tiles // 16) + CAPTURE_FORWARDS)}))
    os.environ["WANDB_MODE"] = "disabled"  # never a network sink
    cwd = os.getcwd()
    os.chdir(workdir)
    log = io.StringIO()
    test_rows = []
    try:
        reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            cli.main(["train", "--train-dir", "ds", "--pretrain-epochs", "1",
                      "--epochs", "1", "--batch-size", str(TRAIN_BATCH),
                      "--seed", str(seed), "--metrics-file", "metrics.jsonl",
                      *(["--disable-amp"] if f32 else [])])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counters()
        text = log.getvalue()
        ckpts = {f"{p}-{k}": os.path.exists(f"esrgan-{p}-{k}.pth")
                 for p in ("psnr", "gan") for k in ("best", "latest")}
        best = load_checkpoint("esrgan-gan-best.pth")
        metrics = _finite_metrics("metrics.jsonl")
        _write_png("photo.png", rng.integers(0, 256, (*TEST_IMAGE, 3),
                                             np.uint8))
        for extra, want_test in tests:
            reset_counters()
            with contextlib.redirect_stdout(log):
                cli.main(["test", "photo.png", "--checkpoint",
                          "esrgan-gan-best.pth", *extra])
            with open("upres-photo.png", "rb") as fh:
                sr = _unpng(fh.read())
            test_rows.append((extra, read_counters(), want_test, sr))
    finally:
        os.chdir(cwd)
    row = {
        "images": TRAIN_IMAGES, "image_hw": list(TRAIN_IMAGE_HW),
        "batch": TRAIN_BATCH, "steps_per_epoch": steps,
        "eval_batches": evals, "wall_s": wall_s, "launches": counts,
        "expected": want, "checkpoints": ckpts,
        "gan_best": {"epoch": best["epoch"], "phase": best["phase"],
                     "step": best["extra"]["step"]},
        "metrics": metrics,
        "test": [{"args": a, "launches": c} for a, c, _, _ in test_rows],
    }
    say(phase, **row)
    lines = text.splitlines()
    check(any("RANDOM VGG features" in ln for ln in lines),
          "the random-VGG warning was printed")
    check("Initialized GAN phase from PSNR weights" in lines,
          "the GAN phase started from psnr-latest")
    check(all(ckpts.values()), f"the four checkpoints exist: {ckpts}")
    check(best["phase"] == "esrgan-gan" and best["extra"]["step"]
          == 2 * steps, "gan-best holds the GAN phase's training state")
    check_counts(phase, counts, **want)
    for extra, got, want_test, sr in test_rows:
        check_counts(f"{phase}: test {extra}", got, **want_test)
        check(sr.shape == (4 * h, 4 * w, 3) and sr.max() > sr.min(),
              f"{phase}: test {extra} on the trained checkpoint wrote a "
              f"4x non-constant image")
    return row


def step_times(trainer, crops: torch.Tensor, flips: torch.Tensor) -> dict:
    """The pretrain and GAN steps' median host-clock time over
    ``SPEED_STEPS`` synchronized steps after one, and their crops/s."""
    row = {}
    for name, step in (
        ("pretrain", lambda: trainer.pretrain_step(crops, flips)),
        ("gan", lambda: trainer.gan_step(crops, flips, 1e-4, 1e-4)),
    ):
        step()
        torch.cuda.synchronize()
        times = []
        for _ in range(SPEED_STEPS):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        row[name] = {"step_ms": ms, "crops_per_s": len(crops) / ms * 1e3,
                     "step_ms_all": times}
    return row


def phase_train_speed(seed: int) -> dict:
    """Pretrain and GAN step times (host clock around synchronized
    steps) at batch 16 and 64, and a profile of one GAN step at 64."""
    from argparse import Namespace

    from torchsr_tpu_torch.data.loader import initialize_datasets
    from torchsr_tpu_torch.train.trainer import ESRGANTrainer
    from torchsr_tpu_torch.utils.logging import Logger

    ds = os.path.join(ROOT, "build", "chip_smoke", "train", "ds")
    rows = {}
    prof = None
    for batch in SPEED_BATCHES:
        args = Namespace(batch_size=batch, epochs=1, pretrain_epochs=1,
                         seed=seed, skip_image_save=True, disable_amp=False,
                         metrics_file=None)
        trainer = ESRGANTrainer(
            args, *initialize_datasets(ds, batch, 128, seed=seed),
            device=torch.device(DEVICE), logger=Logger())
        g = torch.Generator().manual_seed(seed + batch)
        crops = torch.randint(0, 256, (batch, 128, 128, 3), generator=g,
                              dtype=torch.uint8).to(DEVICE)
        flips = torch.randint(0, 2, (batch, 2), generator=g).bool().to(DEVICE)
        row = step_times(trainer, crops, flips)
        torch.cuda.reset_peak_memory_stats()
        trainer.gan_step(crops, flips, 1e-4, 1e-4)
        row["gan_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if batch == SPEED_BATCHES[-1]:
            prof = profile_device_time(
                lambda: trainer.gan_step(crops, flips, 1e-4, 1e-4), 1)
        rows[batch] = row
        del trainer
    say("train_speed", dtype="bfloat16", rrdb=NUM_RRDB, crop=128,
        **{f"batch{b}": r for b, r in rows.items()})
    say("train_profile", batch=SPEED_BATCHES[-1], step="gan", **prof)
    return rows


# eval, the main path of the ``eval`` subcommand: the train phase's
# ESRGAN gan-best on seeded PNGs of mixed sizes, one whose width is not
# a multiple of 4 (cropped to 200) and one below the 11 x 11 SSIM
# window (skipped), whole-image and tiled, f32 and bf16.
EVAL_SIZES = ((176, 176), (150, 203), (96, 132), (9, 30))
EVAL_SKIPPED = "img3.png"
EVAL_TILE = ("--tile", "32", "--tile-overlap", "8", "--tile-batch", "4")
EVAL_RUNS = (("f32", ()), ("f32_tiled", EVAL_TILE), ("bf16", ("--bf16",)),
             ("bf16_tiled", (*EVAL_TILE, "--bf16")))
# A report's per-image PSNR (dB) and SSIM recomputed in float64 numpy
# from the float SR the report scored: half the report's last digit
# (4 and 5 decimals) plus what the report's f32 reductions may carry
# (on the CPU, f32 against float64 at 176 x 176 and 148 x 200, noisy
# and smooth images: <= 3.4e-7 dB and 6.5e-7; the slack is 30x and 3x).
REPORT_SLACK = {"psnr": 5e-5 + 1e-5, "ssim": 5e-6 + 2e-6}
# srgan_train: SRGAN at full width (16 blocks, crop 96, the full VGG19)
# on seeded PNGs, batch 16, one epoch per phase; then test, serve (two
# requests, one tiled at the SRGAN serving tile 256) and eval.
SRGAN_BLOCKS = 16
# bn_act calls in one pass of the generator: two a residual block and the
# long skip's
SRGAN_BN = 2 * SRGAN_BLOCKS + 1
SRGAN_CROP = 96
SRGAN_REQUESTS = ((64, 64), (120, 300))
INTERP_ALPHA = 0.2


def eval_forwards(sizes, tile_args=(), capture: int = CAPTURE_FORWARDS
                  ) -> int:
    """Generator forwards of one ``eval`` over images of ``sizes`` (HR):
    one per scored image whole-image; with ``--tile T --tile-overlap O
    --tile-batch N``, ceil(tiles / N) per image that exceeds T in LR,
    and ``capture`` for the tile forward's capture (on CUDA; on the CPU
    the tile forward is the module itself: 0)."""
    opts = dict(zip(tile_args[::2], tile_args[1::2]))
    tile = int(opts.get("--tile", 0))
    overlap = int(opts.get("--tile-overlap", 16))
    batch = int(opts.get("--tile-batch", 8))
    total = captured = 0
    for h, w in sizes:
        lh, lw = h // 4, w // 4
        if lh * 4 < 11 or lw * 4 < 11:
            continue
        if tile and (lh > tile or lw > tile):
            tiles = (len(_positions(max(lh, tile), tile, tile - overlap))
                     * len(_positions(max(lw, tile), tile, tile - overlap)))
            total += -(-tiles // batch)
            captured = capture
        else:
            total += 1
    return total + captured


def _blur64(n: int) -> np.ndarray:
    """Float64 banded matrix of the VALID 11-tap Gaussian (sigma 1.5)."""
    g = np.exp(-((np.arange(11) - 5.0) ** 2) / (2 * 1.5 ** 2))
    g /= g.sum()
    mat = np.zeros((n - 10, n))
    for i in range(n - 10):
        mat[i, i:i + 11] = g
    return mat


def numpy_scores(sr: np.ndarray, hr: np.ndarray, window=None) -> tuple:
    """(PSNR dB, SSIM) of one HWC image pair in float64 numpy: the
    reference's formulas, independent of the port's torch metrics.
    ``window`` replaces the Gaussian blur (a fault for the tests)."""
    sr, hr = sr.astype(np.float64), hr.astype(np.float64)
    mse = float(np.mean((sr - hr) ** 2))
    gh, gw = (window or _blur64)(sr.shape[0]), (window or _blur64)(
        sr.shape[1])

    def blur(x):
        return np.einsum("oh,hwc->owc", gh, np.einsum("ow,hwc->hoc", gw, x))

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_p, mu_t = blur(sr), blur(hr)
    var_p = blur(sr * sr) - mu_p ** 2
    var_t = blur(hr * hr) - mu_t ** 2
    cov = blur(sr * hr) - mu_p * mu_t
    ssim = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p ** 2 + mu_t ** 2 + c1) * (var_p + var_t + c2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12)), float(ssim.mean())


def report_excess(row: dict, sr: np.ndarray, hr_u8: np.ndarray,
                  window=None) -> dict:
    """A report row's PSNR and SSIM against ``numpy_scores`` of the
    float SR it scored and its HR (cropped as eval crops), each as
    |report - float64| over ``REPORT_SLACK``: at most 1 passes."""
    h, w = row["hw"]
    p, s = numpy_scores(sr, hr_u8[:h, :w] / 255.0, window)
    return {"psnr": abs(row["psnr"] - p) / REPORT_SLACK["psnr"],
            "ssim": abs(row["ssim"] - s) / REPORT_SLACK["ssim"],
            "psnr64": p, "ssim64": s}


@contextlib.contextmanager
def saved_sr(into: dict):
    """Record every float image ``eval --save-sr`` saves (by file name)
    and save it as usual."""
    from torchsr_tpu_torch.utils import image_io

    save = image_io.save_image

    def record(image, path):
        into[os.path.basename(path)] = np.array(image, dtype=np.float32)
        save(image, path)

    image_io.save_image = record
    try:
        yield into
    finally:
        image_io.save_image = save


def _headline(report: dict) -> dict:
    return {k: report[k] for k in ("images", "mean_psnr", "mean_ssim",
                                   "batch_psnr", "mean_bicubic_psnr",
                                   "mean_bicubic_ssim", "psnr_margin_db",
                                   "ssim_margin")}


def _eval_images(seed: int) -> str:
    """The eval phase's seeded PNGs (made once); returns their folder."""
    folder = os.path.join(ROOT, "build", "chip_smoke", "eval", "val")
    if not os.path.isdir(folder):
        os.makedirs(folder)
        rng = np.random.default_rng(seed + 5)
        for i, hw in enumerate(EVAL_SIZES):
            _write_png(os.path.join(folder, f"img{i}.png"),
                       rng.integers(0, 256, (*hw, 3), np.uint8))
    return folder


def _check_report(report: dict, what: str, model: str = "esrgan") -> None:
    names = [r["image"] for r in report["per_image"]]
    check(report["model"] == model and report["images"] == len(EVAL_SIZES)
          - 1 and EVAL_SKIPPED not in names,
          f"{what}: {len(EVAL_SIZES) - 1} images scored, {EVAL_SKIPPED} "
          f"(below the SSIM window) skipped: {names}")
    check(all(np.isfinite(v) for r in report["per_image"]
              for v in r.values() if isinstance(v, float))
          and all(np.isfinite(v) for v in _headline(report).values()),
          f"{what}: every value is finite")
    check([r["hw"] for r in report["per_image"]]
          == [[h // 4 * 4, w // 4 * 4] for h, w in EVAL_SIZES[:-1]],
          f"{what}: sides cropped to multiples of 4")


def _eval_hr(folder: str) -> dict:
    from torchsr_tpu_torch.utils import image_io

    return {f"img{i}.png": image_io.load_image(os.path.join(folder,
                                                            f"img{i}.png"))
            for i in range(len(EVAL_SIZES))}


def _eval_runs(ckpt: str, hr: dict, path: str, kernel: str) -> tuple:
    """``EVAL_RUNS``' four ``eval`` calls (the CLI's ``main``, in this
    process, in the eval workdir) on ``ckpt``, the counters set to 0
    before each: RDB ``kernel`` ("rdb_fwd" B1, "rdb_fwd_ilv" B6) in the
    run's dtype 5 x 69 launches a generator forward, every other counter
    0; each report recomputed in float64.  Returns the rows, the
    launches by path (``path`` and the run's name), the reports and the
    saved SRs, by run."""
    rows, paths, reports, srs = {}, {}, {}, {}
    for name, extra in EVAL_RUNS:
        reset_counters()
        t0 = time.perf_counter()
        with saved_sr({}) as got, contextlib.redirect_stdout(io.StringIO()):
            cli.main(["eval", "val", "--checkpoint", ckpt, "--save-sr",
                      "--report", f"{path}_{name}.json", *extra])
        wall_s = time.perf_counter() - t0
        paths[f"{path} {name}"] = counts = read_counters()
        with open(f"{path}_{name}.json") as fh:
            reports[name] = report = json.load(fh)
        srs[name] = got
        excess = [report_excess(r, got[f"upres-{r['image']}"],
                                hr[r["image"]])
                  for r in report["per_image"]]
        rows[name] = {"wall_s": wall_s, "launches": counts,
                      **_headline(report),
                      "recompute_excess": max(
                          max(e["psnr"], e["ssim"]) for e in excess)}
        _check_report(report, f"{path} {name}")
        fwd = fwd_counter(kernel, torch.bfloat16 if "--bf16" in extra
                          else torch.float32)
        check_counts(f"{path} {name}", counts, **{fwd: 5 * 3 * NUM_RRDB
                     * eval_forwards(EVAL_SIZES, extra)})
        check(rows[name]["recompute_excess"] <= 1,
              f"{path} {name}: the report's PSNR/SSIM equal float64 "
              f"numpy's of the saved SR to the report's rounding: "
              f"{excess}")
    return rows, paths, reports, srs


def phase_eval(seed: int) -> dict:
    """``eval`` (the CLI's ``main``, in this process) on the train
    phase's gan-best: whole-image and tiled, f32 and bf16; B1 5 x 69
    launches a generator forward, every other counter 0; each report
    recomputed in float64; one f32 SR against ``plain_generator``; the
    f32 report again with TF32 allowed."""
    from argparse import Namespace

    from torchsr_tpu_torch.infer.evaluate import run_eval, tf32_allowed
    from torchsr_tpu_torch.infer.runner import load_trained_generator
    from torchsr_tpu_torch.ops.resize import bicubic_resize

    ckpt = os.path.join(ROOT, "build", "chip_smoke", "train",
                        "esrgan-gan-best.pth")
    folder = _eval_images(seed)
    workdir = os.path.dirname(folder)
    hr = _eval_hr(folder)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        rows, paths, reports, srs = _eval_runs(ckpt, hr, "eval", "rdb_fwd")
        args = Namespace(image_dir="val", model="esrgan", checkpoint=ckpt,
                         crop=None, tile=0, tile_overlap=16, tile_batch=8,
                         bf16=False, save_sr=False, report=None,
                         device=DEVICE)
        with contextlib.redirect_stdout(io.StringIO()):
            tf32 = run_eval(args, ESRGANGenerator, allow_tf32=True)
        with tf32_allowed(False):
            gen = load_trained_generator(args, ESRGANGenerator,
                                         device=torch.device(DEVICE),
                                         compute_dtype=torch.float32)
    finally:
        os.chdir(cwd)
    # one f32 SR against the plain generator on the card (TF32 off)
    first = reports["f32"]["per_image"][0]
    h, w = first["hw"]
    hr_t = torch.from_numpy(
        hr[first["image"]][:h, :w].astype(np.float32) / 255.0).to(DEVICE)
    with torch.inference_mode(), tf32_allowed(False):
        lr = bicubic_resize(hr_t[None], (h // 4, w // 4), quantize=True)
        ref = plain_generator(gen, lr)[0].clamp(0, 1)
        wrong = plain_generator(gen, lr, conv5_skipped)[0].clamp(0, 1)
        tf32_sr = plain_generator(gen, lr, tf32_block)[0].clamp(0, 1)
    sr = torch.from_numpy(srs["f32"][f"upres-{first['image']}"]).to(DEVICE)
    limit = TOL_GEN_F32 * float(ref.abs().max())
    vs_plain = _dist(sr, ref)
    base = reports["f32"]["per_image"]
    tf32_diff = {
        "mean_psnr": tf32["mean_psnr"] - reports["f32"]["mean_psnr"],
        "mean_ssim": tf32["mean_ssim"] - reports["f32"]["mean_ssim"],
        "max_abs_per_image_psnr": max(abs(a["psnr"] - b["psnr"])
                                      for a, b in zip(tf32["per_image"],
                                                      base)),
        "max_abs_per_image_ssim": max(abs(a["ssim"] - b["ssim"])
                                      for a, b in zip(tf32["per_image"],
                                                      base))}
    say("eval", checkpoint="train phase gan-best", sizes=EVAL_SIZES,
        tile=EVAL_TILE, runs=rows, f32_vs_plain=vs_plain, f32_limit=limit,
        conv5_skipped_vs_plain=_dist(wrong, ref),
        # printed, not held: after one epoch a phase the blocks add too
        # little to the SR for this limit to see plain TF32 in them (0.95
        # of it on the card); rdb_fwd holds it at this path's own block
        # shape (EVAL_RDB_SHAPE), launch by launch and for the block
        tf32_blocks_vs_plain=_dist(tf32_sr, ref),
        tf32_blocks_excess=_dist(tf32_sr, ref)["max"] / limit,
        tf32_on_minus_off=tf32_diff, tf32_on=_headline(tf32))
    check(vs_plain["max"] <= limit,
          f"eval f32 SR within {TOL_GEN_F32} of the plain generator's "
          f"largest output: {vs_plain} > {limit}")
    check(_dist(wrong, ref)["max"] > limit,
          "the eval limit sees a generator whose blocks lost conv5")
    _check_report(tf32, "eval f32 with TF32 allowed")
    return paths


# eval_ilv: eval's four runs on B6 (``TORCHSR_RDB_ILV``'s variant), each
# SR held against B1's element by element, within the generator's
# tolerance of the largest B1 output (f32 TOL_GEN_F32; bf16, whose blocks
# round at other places, TOL_GEN_BF16), and each per-image PSNR within
# what an SR that close can move it by: 20 log10(1 + tol / rmse) dB (the
# RMSE moves by at most tol), plus each report's REPORT_SLACK.
def _psnr_room(tol: float, psnr: float) -> float:
    """The most a PSNR of ``psnr`` dB moves when every SR value moves by
    at most ``tol``, with two reports' slack."""
    rmse = 10.0 ** (-psnr / 20.0)
    return 20.0 * math.log10(1.0 + tol / rmse) + 2 * REPORT_SLACK["psnr"]


def phase_eval_ilv(seed: int) -> dict:
    """``eval`` as ``phase_eval`` runs it on the train phase's gan-best
    (under ``--only`` without it, on the seeded serving checkpoint), on
    B1 and then with ``ILV_KERNEL`` set: B6 takes every block (f32 on
    the 3xTF32 kernels, ``rdb_fwd_ilv_f32``; bf16 ``rdb_fwd_ilv``), 5 x
    69 launches a generator forward, B1 and every other counter 0; each
    report recomputed in float64; each SR and per-image PSNR held against
    B1's."""
    ckpt = os.path.join(ROOT, "build", "chip_smoke", "train",
                        "esrgan-gan-best.pth")
    if not os.path.exists(ckpt):
        ckpt = serving_generator(seed)[1]
    folder = _eval_images(seed)
    hr = _eval_hr(folder)
    cwd = os.getcwd()
    os.chdir(os.path.dirname(folder))
    try:
        _, _, b1_reports, b1_srs = _eval_runs(ckpt, hr, "eval_b1",
                                              "rdb_fwd")
        with knob("ILV_KERNEL"):
            rows, paths, reports, srs = _eval_runs(ckpt, hr, "eval_ilv",
                                                   "rdb_fwd_ilv")
    finally:
        os.chdir(cwd)
    for name, _ in EVAL_RUNS:
        gen_tol = TOL_GEN_BF16 if name.startswith("bf16") else TOL_GEN_F32
        worst = {"sr": 0.0, "psnr": 0.0, "ssim_abs": 0.0}
        for got, ref in zip(reports[name]["per_image"],
                            b1_reports[name]["per_image"]):
            key = f"upres-{ref['image']}"
            sr_ref = torch.from_numpy(b1_srs[name][key])
            tol = gen_tol * float(sr_ref.abs().max())
            diff = float((torch.from_numpy(srs[name][key]) - sr_ref).abs()
                         .max())
            worst["sr"] = max(worst["sr"], diff / tol)
            worst["psnr"] = max(worst["psnr"], abs(got["psnr"] - ref["psnr"])
                                / _psnr_room(tol, ref["psnr"]))
            worst["ssim_abs"] = max(worst["ssim_abs"],
                                    abs(got["ssim"] - ref["ssim"]))
        rows[name]["vs_b1"] = worst
        check(worst["sr"] <= 1 and worst["psnr"] <= 1,
              f"eval_ilv {name}: the SRs within {gen_tol} of B1's largest "
              f"value and the per-image PSNRs within what that moves: "
              f"{worst}")
    say("eval_ilv", checkpoint=os.path.relpath(ckpt, ROOT), runs=rows)
    return paths


def phase_interp(seed: int) -> dict:
    """``interp`` of the train phase's psnr-best and gan-best at alpha
    0.2 (alpha 0 and 1 must give the inputs bit for bit), then ``eval``
    of the blend on B1."""
    workdir = os.path.join(ROOT, "build", "chip_smoke", "train")
    folder = _eval_images(seed)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            for alpha in (0.0, 1.0, INTERP_ALPHA):
                cli.main(["interp", "esrgan-psnr-best.pth",
                          "esrgan-gan-best.pth", "--alpha", str(alpha),
                          "-o", f"interp-{alpha:g}.pth"])
        states = {name: load_checkpoint(path)["state"] for name, path in (
            ("psnr", "esrgan-psnr-best.pth"), ("gan", "esrgan-gan-best.pth"),
            ("a0", "interp-0.pth"), ("a1", "interp-1.pth"),
            ("blend", f"interp-{INTERP_ALPHA:g}.pth"))}
        ends = {name: all(torch.equal(states[name][k], v)
                          for k, v in states[end].items())
                and list(states[name]) == list(states[end])
                for name, end in (("a0", "psnr"), ("a1", "gan"))}
        moved = sum(not torch.equal(states["blend"][k], v)
                    for k, v in states["psnr"].items())
        reset_counters()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["eval", folder, "--checkpoint",
                      f"interp-{INTERP_ALPHA:g}.pth", "--report",
                      "interp.json"])
        counts = read_counters()
        with open("interp.json") as fh:
            report = json.load(fh)
    finally:
        os.chdir(cwd)
    say("interp", alpha=INTERP_ALPHA, ends_bit_equal=ends,
        tensors_moved=moved, tensors=len(states["psnr"]), launches=counts,
        eval=_headline(report))
    check(all(ends.values()), f"interp at alpha 0 and 1 returns the "
          f"inputs bit for bit: {ends}")
    check(moved > 0, "the alpha 0.2 blend differs from psnr-best")
    _check_report(report, "eval of the interp checkpoint")
    check_counts("interp: eval", counts,
                 rdb_fwd_f32=5 * 3 * NUM_RRDB * eval_forwards(EVAL_SIZES))
    return {"interp: eval": counts}


def _srgan_serve(ckpt: str, seed: int) -> tuple[dict, dict]:
    """Two PNG requests to the SRGAN daemon (default tile 256); the
    answers against the same tiling of the served generator."""
    service = CheckpointUpscaleService(model="srgan", checkpoint=ckpt,
                                       device=DEVICE)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(seed + 4)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in SRGAN_REQUESTS]
    latencies, answers = [], []
    tile, overlap = service.tile, service._resolve_overlap(None)
    batches = sum(
        -(-len(_positions(max(h, tile), tile, tile - overlap))
          * len(_positions(max(w, tile), tile, tile - overlap))
          // service.tile_batch) for h, w in SRGAN_REQUESTS)
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            check(resp.status == 200, "srgan /healthz 200 after warmup")
        reset_counters()
        for frame in frames:
            req = urllib.request.Request(base + "/upscale",
                                         data=_png(frame), method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as resp:
                check(resp.status == 200, "srgan /upscale 200")
                answers.append(_unpng(resp.read()))
            latencies.append((time.perf_counter() - t0) * 1e3)
        counts = read_counters()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    gen, overlap = service._generator, service._resolve_overlap(None)
    levels = []
    with torch.inference_mode():
        for frame, sr in zip(frames, answers):
            h, w = frame.shape[:2]
            check(sr.shape == (4 * h, 4 * w, 3) and sr.max() > sr.min(),
                  f"srgan answer for {h}x{w} is a 4x non-constant image")
            x = torch.from_numpy(frame).to(DEVICE).float() / 255.0
            out = tiled_upscale(gen, x, scale=4, tile=service.tile,
                                overlap=overlap,
                                tile_batch=service.tile_batch)
            direct = (out.clamp(0, 1) * 255 + 0.5).to(torch.uint8)
            levels.append(_levels(sr, direct.cpu().numpy()))
    check(max(d["max"] for d in levels) <= TOL_SERVE_LEVELS,
          f"srgan served frames within {TOL_SERVE_LEVELS} level of the "
          f"generator's own tiling: {levels}")
    return counts, {"request_ms": latencies, "vs_same_tiling_levels": levels,
                    "meta": service.meta, "tile_batches": batches}


def phase_srgan_train(seed: int) -> dict:
    """``train --model srgan`` at full width on seeded PNGs (one epoch
    per phase, batch 16), then ``test`` whole-image and tiled, ``serve``
    and ``eval`` on its gan-best, and the two steps' times at batch 16.
    SRGAN reaches one kernel pair of the port, bn_act (SRGAN_BN calls a
    generator pass: bf16 in the steps, ``test`` and ``serve``, f32 in the
    evals, renders and ``eval``); every other counter reads 0."""
    import shutil
    from argparse import Namespace

    from torchsr_tpu_torch.train.trainer import SRGANTrainer
    from torchsr_tpu_torch.utils.logging import Logger

    workdir = os.path.join(ROOT, "build", "chip_smoke", "srgan_train")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(os.path.join(workdir, "ds"))
    os.makedirs(os.path.join(workdir, "media"))
    rng = np.random.default_rng(seed + 3)
    for i in range(TRAIN_IMAGES):
        _write_png(os.path.join(workdir, "ds", f"img{i:03d}.png"),
                   rng.integers(0, 256, (*TRAIN_IMAGE_HW, 3), np.uint8))
    _write_png(os.path.join(workdir, "media", "waterfalls-low-res.png"),
               rng.integers(0, 256, (*SAMPLE_HW, 3), np.uint8))
    _write_png(os.path.join(workdir, "photo.png"),
               rng.integers(0, 256, (*TEST_IMAGE, 3), np.uint8))
    folder = _eval_images(seed)
    n_eval = -(-TRAIN_IMAGES // 10)
    steps = (TRAIN_IMAGES - n_eval) // TRAIN_BATCH
    evals = -(-n_eval // TRAIN_BATCH)
    h, w = TEST_IMAGE
    tiles = len(_positions(h, 64, 48)) * len(_positions(w, 64, 48))
    # two epochs (pretrain, GAN): each step a generator pass forward and
    # backward in bf16, each eval batch and sample render one forward in
    # f32; ``test`` in bf16, whole-image and tiled (the tile forward's
    # capture adds CAPTURE_FORWARDS)
    want = {"srgan_train": {"bn_act_fwd": SRGAN_BN * 2 * steps,
                            "bn_act_bwd": SRGAN_BN * 2 * steps,
                            "bn_act_fwd_f32": SRGAN_BN * 2 * (evals + 1)},
            "srgan_train: test whole": {"bn_act_fwd": SRGAN_BN},
            "srgan_train: test tiled": {
                "bn_act_fwd": SRGAN_BN * (-(-tiles // 16)
                                          + CAPTURE_FORWARDS)},
            "srgan_train: eval": {
                "bn_act_fwd_f32": SRGAN_BN * eval_forwards(EVAL_SIZES)}}
    paths = {}
    log = io.StringIO()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            cli.main(["train", "--model", "srgan", "--train-dir", "ds",
                      "--pretrain-epochs", "1", "--epochs", "1",
                      "--batch-size", str(TRAIN_BATCH), "--seed", str(seed),
                      "--metrics-file", "metrics.jsonl"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        paths["srgan_train"] = read_counters()
        ckpts = {f"{p}-{k}": os.path.exists(f"srgan-{p}-{k}.pth")
                 for p in ("psnr", "gan") for k in ("best", "latest")}
        best = load_checkpoint("srgan-gan-best.pth")
        metrics = _finite_metrics("metrics.jsonl")
        tests = {}
        for name, extra in (("whole", []),
                            ("tiled", ["--tile", "64", "--tile-batch",
                                       "16"])):
            reset_counters()
            with contextlib.redirect_stdout(log):
                cli.main(["test", "photo.png", "--model", "srgan",
                          "--checkpoint", "srgan-gan-best.pth", *extra])
            paths[f"srgan_train: test {name}"] = read_counters()
            with open("upres-photo.png", "rb") as fh:
                tests[name] = _unpng(fh.read()).shape
        paths["srgan_train: serve"], served = _srgan_serve(
            os.path.abspath("srgan-gan-best.pth"), seed)
        want["srgan_train: serve"] = {
            "bn_act_fwd": SRGAN_BN * served["tile_batches"]}
        reset_counters()
        with contextlib.redirect_stdout(log):
            cli.main(["eval", folder, "--model", "srgan", "--checkpoint",
                      "srgan-gan-best.pth", "--report", "eval.json"])
        paths["srgan_train: eval"] = read_counters()
        with open("eval.json") as fh:
            report = json.load(fh)
    finally:
        os.chdir(cwd)
    # the two steps at batch 16, as train_speed times ESRGAN's
    args = Namespace(batch_size=TRAIN_BATCH, epochs=1, pretrain_epochs=1,
                     seed=seed, skip_image_save=True, disable_amp=False,
                     metrics_file=None)
    trainer = SRGANTrainer(args, Namespace(crop_size=SRGAN_CROP), None, 1,
                           1, device=torch.device(DEVICE), logger=Logger())
    g = torch.Generator().manual_seed(seed + TRAIN_BATCH)
    crops = torch.randint(0, 256, (TRAIN_BATCH, SRGAN_CROP, SRGAN_CROP, 3),
                          generator=g, dtype=torch.uint8).to(DEVICE)
    flips = torch.randint(0, 2, (TRAIN_BATCH, 2), generator=g).bool().to(
        DEVICE)
    speed = step_times(trainer, crops, flips)
    del trainer
    params = sum(v.numel() for k, v in best["state"].items()
                 if not k.endswith(("running_mean", "running_var",
                                    "num_batches_tracked")))
    say("srgan_train", blocks=SRGAN_BLOCKS, params=params, crop=SRGAN_CROP,
        batch=TRAIN_BATCH, steps_per_epoch=steps, wall_s=wall_s,
        checkpoints=ckpts, metrics=metrics, test_shapes=tests,
        serve=served, eval=_headline(report), launches=paths,
        step_times_batch16=speed)
    lines = log.getvalue().splitlines()
    check(any("RANDOM VGG features" in ln for ln in lines),
          "srgan: the random-VGG warning was printed")
    check("Initialized GAN phase from PSNR weights" in lines,
          "srgan: the GAN phase started from psnr-latest")
    check(all(ckpts.values()), f"srgan: the four checkpoints exist: {ckpts}")
    check(params == 1_547_350 and best["phase"] == "srgan-gan"
          and best["extra"]["step"] == 2 * steps,
          "srgan gan-best: the full-width generator and the GAN phase's "
          "training state")
    check(int(best["state"]["blocks.0.bn1.num_batches_tracked"])
          == 2 * steps, "srgan: the BatchNorms counted every train step "
          "(eval and the sample render use the running statistics)")
    for shape in tests.values():
        check(shape == (4 * TEST_IMAGE[0], 4 * TEST_IMAGE[1], 3),
              "srgan test wrote a 4x image")
    _check_report(report, "srgan eval", model="srgan")
    for path, counts in paths.items():
        check_counts(path, counts, **want[path])
    return paths


# multistep: the trainer's K-step programs, replays of one captured
# CUDA graph a step, held against the same eager steps from one state.
MULTI_BATCH = 16
MULTI_LR = 1e-4
MULTI_LR_NEW = 4e-5  # the rate a later epoch sets between calls
# A category of the state passes when its mean |graph - eager| is at
# most MULTI_FLOOR_FACTOR times the mean |eager - eager| of the same
# steps run twice from the same state (the noise floor: atomics in
# cuDNN's backward kernels sum in another order each run; Adam moves an
# element whose gradient is near zero by a full step either way, so
# the largest difference says little and the mean is held), and, where
# the two eager runs agree exactly, when the graph agrees exactly too.
MULTI_FLOOR_FACTOR = 2.0


def _state_tensors(trainer) -> dict:
    """Every tensor a training step updates, live, by category: the
    parameters, the BatchNorm buffers, the Adam moments and steps."""
    cats: dict = {"gen": [], "disc": [], "bn": [], "adam": [],
                  "adam_steps": []}
    for net, module in (("gen", trainer.gen), ("disc", trainer.disc)):
        cats[net] += [p for p in module.parameters()]
        cats["bn"] += [b for b in module.buffers()]
    for opt in trainer.opt.all():
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p, {})
                cats["adam"] += [st[k] for k in ("exp_avg", "exp_avg_sq")
                                 if k in st]
                if "step" in st:
                    cats["adam_steps"].append(st["step"])
    return cats


def _snapshot(trainer) -> dict:
    return {c: [t.detach().clone() for t in ts]
            for c, ts in _state_tensors(trainer).items()}


@torch.no_grad()
def _restore_in_place(trainer, snap: dict) -> None:
    """Copy ``snap`` into the live tensors (a graph keeps reading them)."""
    for c, ts in _state_tensors(trainer).items():
        check(len(ts) == len(snap[c]), f"the {c} state kept its tensors")
        for t, s in zip(ts, snap[c]):
            t.copy_(s)


def _state_diff(a: dict, b: dict) -> dict:
    """Per category, the mean and largest |a - b| over its elements."""
    out = {}
    for c in a:
        total = count = 0.0
        largest = 0.0
        for x, y in zip(a[c], b[c]):
            d = (x.double() - y.double()).abs()
            total += float(d.sum())
            count += d.numel()
            largest = max(largest, float(d.max()) if d.numel() else 0.0)
        out[c] = {"mean": total / max(count, 1), "max": largest}
    return out


def _within_floor(diff: dict, floor: dict) -> bool:
    return all(
        diff[c]["mean"] <= MULTI_FLOOR_FACTOR * floor[c]["mean"]
        if floor[c]["mean"] > 0 else diff[c]["max"] == 0
        for c in floor)


def _stacks(batch: int, crop: int, k: int, seed: int):
    """k distinct seeded uint8 batches on the card, stacked."""
    g = torch.Generator().manual_seed(seed)
    crops = torch.randint(0, 256, (k, batch, crop, crop, 3), generator=g,
                          dtype=torch.uint8).to(DEVICE)
    flips = torch.randint(0, 2, (k, batch, 2), generator=g).bool().to(
        DEVICE)
    return crops, flips


def _eager_vs_graph(trainer, snap, crops_k, flips_k, eager, multi) -> dict:
    """From ``snap``: the eager steps twice (the floor), then the
    replayed call.  Returns the floor, the graph's difference from the
    first eager run, its losses' largest difference, the graph run's
    launch counts and the first eager run's state."""
    runs = {}
    for name, fn in (("eager_a", eager), ("eager_b", eager),
                     ("graph", multi)):
        _restore_in_place(trainer, snap)
        reset_counters()
        losses = fn(crops_k, flips_k)
        torch.cuda.synchronize()
        runs[name] = (_snapshot(trainer), losses, read_counters())
    (a, a_loss, _), (b, _, _), (g, g_loss, launches) = runs.values()
    return {"floor": _state_diff(a, b), "graph": _state_diff(g, a),
            "loss_max_diff": float((g_loss.double()
                                    - a_loss.double()).abs().max()),
            "launches": launches, "eager_state": a}


def _step_timing(eager, replayed) -> dict:
    """One eager step and one replayed step (a K = 1 call): CUDA-event
    ms a step over chained steps, the device's busy share and kernels a
    step under the profiler."""
    from torchsr_tpu_torch.tools.profile_gan_step import chained_ms

    out = {}
    for name, fn in (("eager", eager), ("replayed", replayed)):
        prof = profile_device_time(fn, 2)
        out[name] = {"ms": chained_ms(fn, 5),
                     "device_ms": sum(prof["device_ms_per_batch"].values()),
                     "kernels": prof["kernels_per_batch"],
                     "busy_share": prof["busy_share_of_span"]}
    return out


def phase_multistep(seed: int) -> dict:
    """The trainer's multi-step programs on the card: K = 2 replayed
    ESRGAN GAN steps and K = 8 SRGAN pretrain steps (full width, batch
    16) against the same eager steps from one state, within the noise
    floor of two eager runs; a replay without the new batch and a graph
    that baked its learning rate at capture, both of which must fail
    that limit; a resume from a checkpoint, then replays against eager
    steps again; the launch counters at replays x a step's launches;
    eager and replayed step times and busy shares."""
    from argparse import Namespace

    from torchsr_tpu_torch.train import graphs
    from torchsr_tpu_torch.train.graphs import StepGraph
    from torchsr_tpu_torch.train.trainer import ESRGANTrainer, SRGANTrainer
    from torchsr_tpu_torch.utils.logging import Logger

    args = Namespace(batch_size=MULTI_BATCH, epochs=1, pretrain_epochs=1,
                     seed=seed, skip_image_save=True, disable_amp=False,
                     metrics_file=None)
    per_step = {"RDB_FWD_LAUNCHES": 5 * 3 * NUM_RRDB,
                "RDB_BWD_LAUNCHES": 3 * NUM_RRDB}
    per_step = {k: per_step.get(k, 0) for k in graphs.launch_counts()}
    row: dict = {"batch": MULTI_BATCH}

    # ESRGAN GAN, K = 2
    tr = ESRGANTrainer(args, Namespace(crop_size=128), None, 1, 1,
                       device=torch.device(DEVICE), logger=Logger())
    k = tr.gan_steps_per_call
    check(k == 2, f"ESRGAN's GAN phase runs 2 steps a call, not {k}")
    crops_k, flips_k = _stacks(MULTI_BATCH, 128, k, seed)
    reset_counters()
    tr.gan_step_multi(crops_k, flips_k, MULTI_LR, MULTI_LR)  # captures
    torch.cuda.synchronize()
    capture_call = read_counters()
    graph = tr._graphs[("gan", tuple(crops_k.shape[1:]), torch.bfloat16)]
    snap = _snapshot(tr)

    def eager(ck, fk, lr=MULTI_LR):
        return torch.stack([tr.gan_step(c, f, lr, lr)["gen_loss"]
                            for c, f in zip(ck, fk)])

    def multi(ck, fk, lr=MULTI_LR):
        return tr.gan_step_multi(ck, fk, lr, lr)["gen_loss"]

    gan = _eager_vs_graph(tr, snap, crops_k, flips_k, eager, multi)
    a_state = gan.pop("eager_state")

    # fault 1: the replays see the graph's last batch, not the new ones
    _restore_in_place(tr, snap)
    tr._set_gan_lrs(MULTI_LR, MULTI_LR)
    for _ in range(k):
        graph.graph.replay()
    torch.cuda.synchronize()
    stale_input = _state_diff(_snapshot(tr), a_state)

    # fault 2: a graph whose learning rate was a value at capture; the
    # call sets a new rate, the replays train at the old one
    def baked_lr_body(c, f):
        tr._set_gan_lrs(MULTI_LR, MULTI_LR)
        return tr._gan_body(c, f)

    for opt in tr.opt.all():
        opt.zero_grad(set_to_none=True)
    baked = StepGraph("esrgan gan (lr baked)", baked_lr_body, crops_k[0],
                      flips_k[0])
    _restore_in_place(tr, snap)
    eager(crops_k, flips_k, MULTI_LR_NEW)
    torch.cuda.synchronize()
    new_lr_eager = _snapshot(tr)
    _restore_in_place(tr, snap)
    tr._set_gan_lrs(MULTI_LR_NEW, MULTI_LR_NEW)
    for c, f in zip(crops_k, flips_k):
        baked.replay(c, f)
    torch.cuda.synchronize()
    stale_lr = _state_diff(_snapshot(tr), new_lr_eager)
    del baked
    # the real graph at the new rate: it reads the rate at each replay
    _restore_in_place(tr, snap)
    multi(crops_k, flips_k, MULTI_LR_NEW)
    torch.cuda.synchronize()
    new_lr_graph = _state_diff(_snapshot(tr), new_lr_eager)

    # resume: a checkpoint of this state, restored (new optimizer
    # tensors: the trainer drops its graphs), then replays against eager
    workdir = os.path.join(ROOT, "build", "chip_smoke", "multistep")
    os.makedirs(workdir, exist_ok=True)
    ckpt = os.path.join(workdir, "esrgan-gan-latest.pth")
    save_checkpoint(ckpt, 1, "esrgan-gan", tr.gen.state_dict(),
                    extra=tr._full_state())
    tr._restore(load_checkpoint(ckpt), "gan")
    resumed_graphs = len(tr._graphs)
    multi(crops_k, flips_k)  # captures anew
    resumed = _eager_vs_graph(tr, _snapshot(tr), crops_k, flips_k, eager,
                              multi)
    gan_timing = _step_timing(
        lambda: tr.gan_step(crops_k[0], flips_k[0], MULTI_LR, MULTI_LR),
        lambda: multi(crops_k[:1], flips_k[:1]))
    launches = graph.launches
    del tr, graph, snap, a_state, new_lr_eager
    gc.collect()
    torch.cuda.empty_cache()

    # SRGAN pretrain, K = 8
    tr = SRGANTrainer(args, Namespace(crop_size=SRGAN_CROP), None, 1, 1,
                      device=torch.device(DEVICE), logger=Logger())
    k8 = tr.steps_per_call
    check(k8 == 8, f"the pretrain runs 8 steps a call, not {k8}")
    crops8, flips8 = _stacks(MULTI_BATCH, SRGAN_CROP, k8, seed + 1)
    tr.pretrain_step_multi(crops8, flips8)  # captures
    srgan = _eager_vs_graph(
        tr, _snapshot(tr), crops8, flips8,
        lambda ck, fk: torch.stack([tr.pretrain_step(c, f)
                                    for c, f in zip(ck, fk)]),
        tr.pretrain_step_multi)
    pre_timing = _step_timing(
        lambda: tr.pretrain_step(crops8[0], flips8[0]),
        lambda: tr.pretrain_step_multi(crops8[:1], flips8[:1]))
    del tr

    for res in (resumed, srgan):
        del res["eager_state"]
    row.update(
        esrgan_gan=gan, srgan_pretrain=srgan, esrgan_gan_resumed=resumed,
        graph_launches=launches,
        capture_call_launches=capture_call,
        faults={"stale_input": stale_input, "stale_lr": stale_lr},
        new_lr_graph=new_lr_graph, graphs_after_resume=resumed_graphs,
        esrgan_gan_step=gan_timing, srgan_pretrain_step=pre_timing)
    say("multistep", **row)
    for name, res in (("ESRGAN GAN", gan), ("SRGAN pretrain", srgan),
                      ("ESRGAN GAN after resume", resumed)):
        check(_within_floor(res["graph"], res["floor"]),
              f"{name}: replayed steps equal eager ones within the noise "
              f"floor: {res['graph']} against {res['floor']}")
    check(_within_floor(new_lr_graph, gan["floor"]),
          "replays read the learning rate set between calls")
    for name, diff in (("stale input", stale_input),
                       ("stale lr", stale_lr)):
        check(not _within_floor(diff, gan["floor"]),
              f"the limit sees a {name}: {diff} against {gan['floor']}")
    check(resumed_graphs == 0, "restoring a checkpoint dropped the graphs")
    check(launches == per_step,
          f"a captured ESRGAN GAN step stands for {per_step}: {launches}")
    want = {"rdb_fwd": k * per_step["RDB_FWD_LAUNCHES"],
            "rdb_bwd": k * per_step["RDB_BWD_LAUNCHES"]}
    check_counts("multistep: the capturing call", capture_call, **want)
    for name, res in (("multistep: esrgan gan", gan),
                      ("multistep: esrgan gan resumed", resumed)):
        check_counts(name, res["launches"], **want)
    check_counts("multistep: srgan pretrain", srgan["launches"],
                 bn_act_fwd=k8 * SRGAN_BN, bn_act_bwd=k8 * SRGAN_BN)
    return {"multistep: esrgan gan": gan["launches"],
            "multistep: esrgan gan resumed": resumed["launches"],
            "multistep: srgan pretrain": srgan["launches"]}


# bench: tools/bench.py's five metrics at their full configurations,
# with fewer measured steps and frames than the tool's defaults.
BENCH_SMOKE = (
    ("esrgan_gan_step_crops_per_sec_per_chip", "bench_esrgan_gan",
     {"steps": 4}),
    ("srgan_gan_step_crops_per_sec_per_chip", "bench_srgan_gan",
     {"steps": 8}),
    ("esrgan_tiled_infer_output_mp_per_sec",
     "bench_esrgan_tiled_inference", {"frames": 1}),
    ("srgan_tiled_infer_output_mp_per_sec", "bench_tiled_inference",
     {"frames": 1}),
    ("srgan_train_crops_per_sec_per_chip", "bench_srgan_train",
     {"warmup_steps": 8, "measure_steps": 8}),
)


def bench_tile_batches(hw, tile: int, overlap: int, batch: int) -> int:
    """Generator forwards ``tiled_upscale`` makes for one frame."""
    n = (len(_positions(hw[0], tile, tile - overlap))
         * len(_positions(hw[1], tile, tile - overlap)))
    return -(-n // batch)


def phase_bench(seed: int) -> dict:
    """``torchsr_tpu_torch/tools/bench.py``'s five metrics, in its order,
    at its configurations with fewer measured steps: each line's metric
    name, a finite positive value and the card; the launch counters at
    what the calls imply (ESRGAN GAN: one warm-up call and two phases of
    calls, K = 2 steps each; ESRGAN tiled: one warm-up frame, which
    captures the tile forward's graph, and two of one frame)."""
    from torchsr_tpu_torch.tools import bench

    del seed  # the bench's own seeds
    card = bench.card(DEVICE)
    frame_batches = bench_tile_batches(bench.FRAME_HW, 64, 8, 16)
    gan_steps = 2 * (1 + 2 * max(4 // 2, 1))
    want = {
        "bench_esrgan_gan": {"rdb_fwd": gan_steps * 5 * 3 * NUM_RRDB,
                             "rdb_bwd": gan_steps * 3 * NUM_RRDB},
        "bench_esrgan_tiled_inference": {
            "rdb_fwd": (3 * frame_batches + CAPTURE_FORWARDS)
            * 5 * 3 * NUM_RRDB},
        # SRGAN: K = 8, one warm-up call and two phases of one call
        "bench_srgan_gan": {"bn_act_fwd": 24 * SRGAN_BN,
                            "bn_act_bwd": 24 * SRGAN_BN},
        "bench_tiled_inference": {
            "bn_act_fwd": (3 * bench_tile_batches(bench.FRAME_HW, 256, 16, 8)
                           + CAPTURE_FORWARDS) * SRGAN_BN},
        "bench_srgan_train": {"bn_act_fwd": 24 * SRGAN_BN,
                              "bn_act_bwd": 24 * SRGAN_BN},
    }
    rows, paths = [], {}
    for metric, fn_name, kw in BENCH_SMOKE:
        reset_counters()
        with contextlib.redirect_stdout(io.StringIO()):
            out = getattr(bench, fn_name)(device=DEVICE, **kw)
        torch.cuda.synchronize()
        counts = paths[f"bench: {metric}"] = read_counters()
        rows.append(out)
        check(out["metric"] == metric and math.isfinite(out["value"])
              and out["value"] > 0 and out["device"] == card["device"],
              f"bench line {out}")
        check_counts(f"bench: {metric}", counts, **want.get(fn_name, {}))
        gc.collect()
        torch.cuda.empty_cache()
    say("bench", frame_tile_batches=frame_batches, lines=rows)
    return paths


# The run phases (pack_train, scale, preempt, fast_compile): full width,
# crop 128, batch 16, on seeded PNGs made once a process: 40 training
# images of 160 x 160 (two steps an epoch) and an eval set of 4
# (``--eval-dir``: one eval batch), beside a 48 x 64 sample image given
# by ``--sample-image``.  The images are smooth (an 8 x 8 random grid
# resized bicubically), so that a run learns something: on pure noise
# one GAN epoch at 2x drove the eval PSNR to -1.65 dB, below the best-
# PSNR sentinel (-1), and wrote no gan-best.
RUN_IMAGES = 40
RUN_EVAL_IMAGES = 4
RUN_STEPS = RUN_IMAGES // TRAIN_BATCH
RUN_EVALS = -(-RUN_EVAL_IMAGES // TRAIN_BATCH)
RUN_WINDOW = 4  # pack_train's --shuffle-window
PREEMPT_MULTIPLIER = 3  # preempt: 120 samples, 7 steps of 16
PREEMPT_AFTER_CALLS = 3  # the signal comes after a capture and 2 replays
SCALE_REQUEST = (64, 64)  # one serving tile
SCALE_MULTIPLIER = 3  # scale: 120 samples, 7 steps of 16 an epoch
SCALE_STEPS = SCALE_MULTIPLIER * RUN_IMAGES // TRAIN_BATCH
_RUN_DATA: dict = {}


def _smooth_image(rng, hw) -> np.ndarray:
    from PIL import Image

    grid = rng.integers(0, 256, (8, 8, 3), np.uint8)
    return np.asarray(Image.fromarray(grid).resize(hw[::-1],
                                                   Image.BICUBIC))


def _run_data(seed: int) -> dict:
    """The run phases' seeded images: {"ds", "val", "sample"} paths."""
    if _RUN_DATA.get("seed") != seed:
        import shutil

        root = os.path.join(ROOT, "build", "chip_smoke", "run_data")
        shutil.rmtree(root, ignore_errors=True)
        rng = np.random.default_rng(seed + 20)
        for sub, n in (("ds", RUN_IMAGES), ("val", RUN_EVAL_IMAGES)):
            os.makedirs(os.path.join(root, sub))
            for i in range(n):
                _write_png(os.path.join(root, sub, f"img{i:03d}.png"),
                           _smooth_image(rng, TRAIN_IMAGE_HW))
        _write_png(os.path.join(root, "sample.png"),
                   _smooth_image(rng, SAMPLE_HW))
        _RUN_DATA.clear()
        _RUN_DATA.update(seed=seed, ds=os.path.join(root, "ds"),
                         val=os.path.join(root, "val"),
                         sample=os.path.join(root, "sample.png"))
    return _RUN_DATA


@contextlib.contextmanager
def _workdir(name: str):
    """A fresh ``build/chip_smoke/<name>`` as the working directory for
    the block, removed after it (a full-width training checkpoint holds
    ~400 MB)."""
    import shutil

    path = os.path.join(ROOT, "build", "chip_smoke", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield path
    finally:
        os.chdir(cwd)
        shutil.rmtree(path, ignore_errors=True)


def _quiet(argv: list) -> str:
    """``cli.main(argv)`` in this process; returns what it printed."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        cli.main([str(a) for a in argv])
    return log.getvalue()


def _train_argv(data: dict, seed: int, *extra) -> list:
    os.environ["WANDB_MODE"] = "disabled"  # never a network sink
    return ["train", "--train-dir", data["ds"], "--eval-dir", data["val"],
            "--pretrain-epochs", 1, "--epochs", 1, "--batch-size",
            TRAIN_BATCH, "--seed", seed, "--sample-image", data["sample"],
            *extra]


# A generator pass's kernel calls, by model: (forward counter, calls a
# forward, backward counter, calls a backward); the forward counter's
# ``_f32`` twin counts the f32 passes.
GEN_CALLS = {
    "esrgan": ("rdb_fwd", 5 * 3 * NUM_RRDB, "rdb_bwd", 3 * NUM_RRDB),
    "srgan": ("bn_act_fwd", SRGAN_BN, "bn_act_bwd", SRGAN_BN),
}


def _run_launches(phases: int = 2, steps: int = RUN_STEPS,
                  renders: int = 1, model: str = "esrgan") -> dict:
    """The model kernels' launches of a run (B1 and B2 for ESRGAN,
    bn_act for SRGAN): each phase's steps forward (bf16) and backward;
    its eval batches and its sample render forward only (f32)."""
    fwd, per_fwd, bwd, per_bwd = GEN_CALLS[model]
    return {fwd: per_fwd * phases * steps,
            f"{fwd}_f32": per_fwd * phases * (RUN_EVALS + renders),
            bwd: per_bwd * phases * steps}


def _same_batches(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
        for x, y in zip(a, b))


def phase_pack_train(seed: int) -> dict:
    """``pack`` of the run's images, the first epoch's crops from the
    pack (``--shuffle-window``) byte-equal to the directory's, then
    ``train`` from the packs (train and eval) with ``--shuffle-window
    --data-workers 2 --sample-image``, async saves: one epoch each phase
    on B1/B2, the launches exact; ``eval`` on the eval pack equal to
    ``eval`` on its directory."""
    from PIL import Image

    from torchsr_tpu_torch.data.loader import initialize_datasets

    data = _run_data(seed)
    paths: dict = {}
    with _workdir("pack_train"):
        t0 = time.perf_counter()
        for src, out in ((data["ds"], "ds.tsrpack"),
                         (data["val"], "val.tsrpack")):
            _quiet(["pack", src, out])
        pack_s = time.perf_counter() - t0
        epoch0, host_s = {}, {}
        for src, ev in ((data["ds"], data["val"]),
                        ("ds.tsrpack", "val.tsrpack")):
            loaders = initialize_datasets(
                src, TRAIN_BATCH, 128, seed=seed, eval_directory=ev,
                shuffle_window=RUN_WINDOW, workers=2)
            # nothing decoded yet, but the files were written moments
            # ago: the page cache is warm (a cold epoch of a DIV2K-sized
            # set: tools/bench_loader.py)
            t0 = time.perf_counter()
            epoch0[src] = list(loaders[0].epoch(0))
            host_s[src] = time.perf_counter() - t0
        check(_same_batches(*epoch0.values()),
              "pack_train: the first epoch's crops from the pack equal the "
              "directory's")
        data_packs = {**data, "ds": "ds.tsrpack", "val": "val.tsrpack"}
        reset_counters()
        t0 = time.perf_counter()
        log = _quiet(_train_argv(data_packs, seed, "--shuffle-window",
                                 RUN_WINDOW, "--data-workers", 2))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        paths["pack_train"] = read_counters()
        with Image.open(os.path.join("output", "SR_epoch1.png")) as img:
            sample = img.size
        best = load_checkpoint("esrgan-gan-best.pth")
        reports = {}
        for src in (data["val"], "val.tsrpack"):
            reset_counters()
            _quiet(["eval", src, "--checkpoint", "esrgan-gan-best.pth",
                    "--report", "report.json"])
            paths[f"pack_train: eval {os.path.basename(src)}"] = \
                read_counters()
            with open("report.json") as fh:
                reports[src] = json.load(fh)
    say("pack_train", images=RUN_IMAGES, eval_images=RUN_EVAL_IMAGES,
        shuffle_window=RUN_WINDOW, pack_s=pack_s,
        first_epoch_host_s=host_s, train_wall_s=wall_s, launches=paths,
        sample_png=list(sample),
        eval_mean_psnr=[r["mean_psnr"] for r in reports.values()])
    check("Preemption" not in log and best["extra"]["step"]
          == 2 * RUN_STEPS, "pack_train: gan-best holds both phases' steps")
    check(sample == (4 * SAMPLE_HW[1], 4 * SAMPLE_HW[0]),
          f"pack_train: --sample-image rendered at 4x: {sample}")
    check_counts("pack_train", paths["pack_train"], **_run_launches())
    want_eval = 5 * 3 * NUM_RRDB * eval_forwards(
        [TRAIN_IMAGE_HW] * RUN_EVAL_IMAGES)
    for name, counts in paths.items():
        if "eval" in name:
            check_counts(name, counts, rdb_fwd_f32=want_eval)
    a, b = reports.values()
    check(a == b, "pack_train: eval on the pack equals eval on the "
                  "directory")
    return paths


def _serve_one(ckpt: str, frame: np.ndarray) -> tuple[np.ndarray, dict]:
    """One PNG request to the checkpoint daemon; (answer, launches of
    the request)."""
    service = CheckpointUpscaleService(model="esrgan", checkpoint=ckpt,
                                       device=DEVICE)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reset_counters()
        req = urllib.request.Request(base + "/upscale", data=_png(frame),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            check(resp.status == 200, "/upscale 200")
            body = resp.read()
        counts = read_counters()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    return _unpng(body), counts


def phase_scale(seed: int) -> dict:
    """The 2x and 8x generators' parameter gradients, kernel path
    against plain path at LR 64 x 64 and 16 x 16 (``_train_grad``);
    ``train --scale 2`` and ``--scale 8`` (one epoch each phase, three
    times the run's images: B1 and B2 at LR batches (16, 64, 64) and
    (16, 16, 16)), ``test`` on each gan-latest (2x / 8x the input, B1
    345 launches), and one ``serve`` request on the 8x checkpoint."""
    data = _run_data(seed)
    paths: dict = {}
    rows = {}
    for scale in (2, 8):
        _train_grad(seed, f"train_grad_scale{scale}", ("rdb_fwd", "rdb_bwd"),
                    scale)
    frame = np.random.default_rng(seed + 21).integers(
        0, 256, (*SCALE_REQUEST, 3), dtype=np.uint8)
    for scale in (2, 8):
        with _workdir(f"scale{scale}"):
            reset_counters()
            t0 = time.perf_counter()
            log = _quiet(_train_argv(data, seed, "--scale", scale,
                                     "--metrics-file", "metrics.jsonl",
                                     "--dataset-multiplier", SCALE_MULTIPLIER))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            paths[f"scale{scale}"] = read_counters()
            metrics = _finite_metrics("metrics.jsonl")
            # gan-latest is written whatever the GAN epoch's eval PSNR
            # (gan-best only above the -1 sentinel), so what follows
            # does not hang on how well one epoch trained
            latest = "esrgan-gan-latest.pth"
            check(os.path.exists(latest) and load_checkpoint(latest)[
                "extra"]["step"] == 2 * SCALE_STEPS,
                  f"scale {scale}: gan-latest holds both phases' steps: "
                  f"{log[-1500:]}")
            _write_png("photo.png", np.random.default_rng(seed).integers(
                0, 256, (*TEST_IMAGE, 3), np.uint8))
            reset_counters()
            _quiet(["test", "photo.png", "--checkpoint", latest])
            paths[f"scale{scale}: test"] = read_counters()
            with open("upres-photo.png", "rb") as fh:
                sr = _unpng(fh.read())
            rows[scale] = {"train_wall_s": wall_s, "test_shape":
                           list(sr.shape), "metrics": metrics}
            if scale == 8:
                answer, paths["scale8: serve"] = _serve_one(latest, frame)
                rows[scale]["serve_shape"] = list(answer.shape)
        h, w = TEST_IMAGE
        check(sr.shape == (scale * h, scale * w, 3) and sr.max() > sr.min(),
              f"scale {scale}: test wrote a {scale}x non-constant image")
        check_counts(f"scale{scale}", paths[f"scale{scale}"],
                     **_run_launches(steps=SCALE_STEPS))
        check_counts(f"scale{scale}: test", paths[f"scale{scale}: test"],
                     rdb_fwd=5 * 3 * NUM_RRDB)
    fh_, fw_ = SCALE_REQUEST
    check(tuple(rows[8]["serve_shape"]) == (8 * fh_, 8 * fw_, 3),
          "scale 8: serve answered 8x the request")
    check_counts("scale8: serve", paths["scale8: serve"],
                 rdb_fwd=5 * 3 * NUM_RRDB)
    say("scale", rdb_shapes={k: list(v) for k, v in SCALE_RDB_SHAPES.items()},
        runs=rows, launches=paths)
    return paths


# ``train`` in a process of its own whose third host call waits, after
# it returns, for the SIGTERM the parent sends once it sees the marker
# file: the signal arrives between replays (a capture and two replays
# before it), whatever the timing of the machine.
_PREEMPT_DRIVER = """
import os, sys, time
sys.path.insert(0, sys.argv[1])
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.train.trainer import GANTrainer
real, calls = GANTrainer._multi, []
def multi(self, *a, **kw):
    out = real(self, *a, **kw)
    calls.append(1)
    if len(calls) == int(sys.argv[2]):
        open("replayed", "w").close()
        deadline = time.time() + 120
        while not self._preemption.requested and time.time() < deadline:
            time.sleep(0.01)
    return out
GANTrainer._multi = multi
cli.main(sys.argv[3:])
"""


def phase_preempt(seed: int) -> dict:
    """``train`` in a subprocess gets SIGTERM between replays of the
    pretrain: it exits 0, leaving ``esrgan-psnr-latest.pth`` at that
    step boundary; the resume (in this process) re-runs the epoch; one
    async save and one ``--sync-saves`` save of the trained state give
    byte-equal files, and the loop's stall of each is printed."""
    import signal

    from torchsr_tpu_torch.train.trainer import run_train
    from torchsr_tpu_torch.utils.checkpoint import save_checkpoint as save

    data = _run_data(seed)
    argv = _train_argv(data, seed, "--epochs", 0, "--steps-per-call", 1,
                       "--dataset-multiplier", PREEMPT_MULTIPLIER,
                       "--skip-image-save")
    steps = PREEMPT_MULTIPLIER * RUN_IMAGES // TRAIN_BATCH
    paths: dict = {}
    with _workdir("preempt"):
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", _PREEMPT_DRIVER, ROOT,
             str(PREEMPT_AFTER_CALLS), *map(str, argv)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": ROOT})
        try:
            deadline = time.time() + 600
            while not os.path.exists("replayed"):
                check(proc.poll() is None and time.time() < deadline,
                      "preempt: the run reached its third call")
                time.sleep(0.05)
            signalled_s = time.perf_counter() - t0
            proc.send_signal(signal.SIGTERM)
            out = proc.communicate(timeout=600)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        exit_s = time.perf_counter() - t0 - signalled_s
        saved = load_checkpoint("esrgan-psnr-latest.pth")
        reset_counters()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            trainer = run_train(cli.parse_args([str(a) for a in argv]))
        torch.cuda.synchronize()
        paths["preempt: resume"] = read_counters()
        resumed = load_checkpoint("esrgan-psnr-latest.pth")
        t0 = time.perf_counter()
        trainer._save(1, "esrgan-psnr", "async")
        async_stall_ms = (time.perf_counter() - t0) * 1e3
        trainer.ckpt_writer.close()
        t0 = time.perf_counter()
        save("esrgan-psnr-sync.pth", 1, "esrgan-psnr",
             trainer.gen.state_dict(), extra=trainer._full_state())
        sync_stall_ms = (time.perf_counter() - t0) * 1e3
        with open("esrgan-psnr-async.pth", "rb") as fa, \
                open("esrgan-psnr-sync.pth", "rb") as fs:
            byte_equal = fa.read() == fs.read()
        size_mb = os.path.getsize("esrgan-psnr-sync.pth") / 1e6
        gan_written = os.path.exists("esrgan-gan-latest.pth")
    say("preempt", steps_per_epoch=steps, signal_after_calls=
        PREEMPT_AFTER_CALLS, signalled_after_s=signalled_s,
        exit_after_signal_s=exit_s, rc=proc.returncode,
        saved={"epoch": saved["epoch"], "step": saved["extra"]["step"]},
        resumed_step=resumed["extra"]["step"], launches=paths,
        checkpoint_mb=size_mb, async_save_stall_ms=async_stall_ms,
        sync_save_stall_ms=sync_stall_ms, async_sync_byte_equal=byte_equal)
    check(proc.returncode == 0 and "Preemption signal received: saved "
          "esrgan-psnr-latest.pth at epoch 1" in out,
          f"preempt: SIGTERM'd run exits 0 after its save: {out[-2000:]}")
    check(saved["epoch"] == 1 and saved["extra"]["step"]
          == PREEMPT_AFTER_CALLS and not gan_written,
          "preempt: psnr-latest holds the state at the step boundary")
    check("Resuming pre-training from epoch 1" in log.getvalue()
          and resumed["extra"]["step"] == PREEMPT_AFTER_CALLS + steps,
          "preempt: the resume re-ran the interrupted epoch")
    check_counts("preempt: resume", paths["preempt: resume"],
                 **_run_launches(phases=1, steps=steps, renders=0))
    check(byte_equal, "preempt: an async and a sync save of one state are "
                      "byte-equal")
    return paths


def _checkpoint_categories(path: str) -> dict:
    """A training checkpoint's tensors by ``_state_diff`` category."""
    ck = load_checkpoint(path)
    extra = ck["extra"]
    cats = {"gen": list(ck["state"].values()),
            "disc": list(extra["disc_state"].values()), "adam": [],
            "adam_steps": []}
    for key in ("psnr_opt_state", "gen_opt_state", "disc_opt_state"):
        for st in extra[key]["state"].values():
            cats["adam"] += [st["exp_avg"], st["exp_avg_sq"]]
            cats["adam_steps"].append(st["step"])
    return {c: [t.float() for t in ts] for c, ts in cats.items()}


FAST_COMPILE_MULTIPLIER = 3  # 120 samples, 7 steps of 16 an epoch
# the flag's replayed step against the plain run's: eager steps took
# 3.8-4.8x the replayed time at batch 16 on an H100
FAST_COMPILE_STEP_FACTOR = 1.5


def phase_fast_compile(seed: int) -> dict:
    """``train`` and ``train --fast-compile`` from one seed, 7 steps an
    epoch: the flag logs its one line and changes nothing, so both runs
    capture the same graphs and their gan-latest is equal bit for bit,
    the launches equal; each run's median replayed call time a step
    (the calls after each phase's capturing one), the flag's within
    ``FAST_COMPILE_STEP_FACTOR`` of the plain run's; the time from the
    call to the first step's end both ways."""
    from torchsr_tpu_torch.train import trainer as trainer_mod

    data = _run_data(seed)
    runs, paths = {}, {}
    for name, extra in (("plain", ()), ("fast", ("--fast-compile",))):
        captures, calls = [], []
        real_multi, real_graph = (trainer_mod.GANTrainer._multi,
                                  trainer_mod.StepGraph)

        def multi(self, phase, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_multi(self, phase, *a, **kw)
            torch.cuda.synchronize()
            calls.append((phase, len(a[1]), t0, time.perf_counter()))
            return out

        def graph(*a, **kw):
            captures.append(a[0])
            return real_graph(*a, **kw)

        with _workdir(f"fast_compile_{name}"):
            trainer_mod.GANTrainer._multi = multi
            trainer_mod.StepGraph = graph
            try:
                reset_counters()
                t0 = time.perf_counter()
                log = _quiet(_train_argv(
                    data, seed, "--skip-image-save", "--dataset-multiplier",
                    FAST_COMPILE_MULTIPLIER, *extra))
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
            finally:
                trainer_mod.GANTrainer._multi = real_multi
                trainer_mod.StepGraph = real_graph
            paths[f"fast_compile: {name}"] = read_counters()
            replayed = [(end - start) / k * 1e3
                        for i, (ph, k, start, end) in enumerate(calls)
                        if any(c[0] == ph for c in calls[:i])]
            runs[name] = {
                "first_step_s": calls[0][3] - t0, "wall_s": wall_s,
                "captures": captures,
                "said": log.count("--fast-compile: the port has no long "
                                  "compile to shorten"),
                "replayed_step_ms": statistics.median(replayed),
                "replayed_calls": len(replayed),
                "state": _checkpoint_categories("esrgan-gan-latest.pth")}
    diff = _state_diff(runs["plain"]["state"], runs["fast"]["state"])
    say("fast_compile", **{key: {k: r[key] for k, r in runs.items()}
                           for key in ("first_step_s", "wall_s", "captures",
                                       "said", "replayed_step_ms",
                                       "replayed_calls")},
        plain_vs_fast=diff, launches=paths)
    check(runs["plain"]["captures"] == runs["fast"]["captures"]
          == ["esrgan psnr", "esrgan gan"],
          "fast_compile: both runs capture each phase's step")
    check((runs["plain"]["said"], runs["fast"]["said"]) == (0, 1),
          "fast_compile: the flag logs its line once, and only under it")
    check(all(d["max"] == 0 for d in diff.values()),
          f"fast_compile: the flag's checkpoint equals the plain run's bit "
          f"for bit: {diff}")
    check(runs["fast"]["replayed_step_ms"] <= FAST_COMPILE_STEP_FACTOR
          * runs["plain"]["replayed_step_ms"],
          "fast_compile: the flag's steps run at the replayed speed")
    for name, counts in paths.items():
        check_counts(name, counts, **_run_launches(
            steps=FAST_COMPILE_MULTIPLIER * RUN_IMAGES // TRAIN_BATCH,
            renders=0))
    return paths


# prefetch: the host-to-device copies on the prefetcher's own stream.
PREFETCH_BATCHES = 6  # headline-shaped host batches through a prefetcher
PREFETCH_SLEEP_CYCLES = 20_000_000  # ~10 ms of the consumer stream a batch
# profiler windows at most for the copies' streams (~0.2 s each with
# the pause after an empty one): late in a full run up to 31 windows in
# a row came back with no device event at all, so a window that shows
# some copies and some consumer kernels ends the search
PREFETCH_WINDOWS = 100
PREFETCH_GAN_BATCHES = 5  # two 2-step calls and the ragged tail
HEADLINE_BATCH, HEADLINE_CROP = 128, 96
HEADLINE_EPOCH_STEPS = 16  # two 8-step calls an epoch


def _prefetch_streams(seed: int) -> dict:
    """Headline-shaped uint8 batches through ``prefetch_to_device``
    under the profiler.  Before it reads a batch, the consumer's stream
    sleeps (``torch.cuda._sleep``), so that the batch is read long after
    the prefetcher has moved on: a copy on the consumer's stream, a read
    not ordered after the copy, or memory handed to a later copy before
    the read (no ``record_stream``) shows as a batch unequal to its host
    array (checked in every window).  After one pass outside the
    profiler, a window whose profile lost the copies is run again,
    ``PREFETCH_WINDOWS`` windows at most (as ``device_spans`` does); no
    copy seen in any window may share a stream with a consumer kernel.
    Returns the copies' and the consumer's streams."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torchsr_tpu_torch.data.prefetch import prefetch_to_device

    rng = np.random.default_rng(seed + 40)
    host = [(rng.integers(0, 256, (HEADLINE_BATCH, HEADLINE_CROP,
                                   HEADLINE_CROP, 3), dtype=np.uint8),
             rng.integers(0, 2, (HEADLINE_BATCH, 2)).astype(bool))
            for _ in range(PREFETCH_BATCHES)]
    for _ in prefetch_to_device(iter(host), DEVICE):  # outside a window
        pass
    copies, consumer, seen = set(), set(), []
    for _ in range(PREFETCH_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            read = []
            for crops, flips in prefetch_to_device(iter(host), DEVICE):
                torch.cuda._sleep(PREFETCH_SLEEP_CYCLES)
                read.append((crops.clone(), flips.clone()))
                del crops, flips
            torch.cuda.synchronize()
        equal = [np.array_equal(c.cpu().numpy(), h[0])
                 and np.array_equal(f.cpu().numpy(), h[1])
                 for (c, f), h in zip(read, host)]
        check(all(equal), f"prefetch: every batch equals its host arrays "
                          f"bit for bit: {equal}")
        n_copies = n_consumer = 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            stream = getattr(e, "device_resource_id", None)
            if "HtoD" in e.name:
                copies.add(stream)
                n_copies += 1
            else:
                consumer.add(stream)
                n_consumer += 1
        seen.append([n_copies, n_consumer])
        if n_copies and n_consumer:
            break
        if not n_copies + n_consumer:
            time.sleep(0.1)  # an empty profile: give the tracer time
    check(bool(copies) and bool(consumer),
          f"prefetch: the profiler saw copies and the consumer's kernels "
          f"(copies, kernels a window: {seen})")
    check(None not in copies and not copies & consumer,
          f"prefetch: the copies run on a stream of their own: copies on "
          f"{sorted(map(str, copies))}, the consumer's kernels on "
          f"{sorted(map(str, consumer))}")
    return {"batches": len(equal), "copies_kernels_a_window": seen,
            "copy_streams": sorted(copies),
            "consumer_streams": sorted(consumer)}


def _prefetch_gan(seed: int) -> tuple[dict, dict]:
    """Replayed ESRGAN GAN steps (full width, batch 16, K = 2) fed by
    ``prefetch_to_device_stacked``, then the same batches as host tensors
    copied synchronously, from the same state: the states after each
    equal bit for bit.  Returns the row and the prefetched run's
    launches."""
    from argparse import Namespace

    from torchsr_tpu_torch.data.prefetch import prefetch_to_device_stacked
    from torchsr_tpu_torch.train.trainer import ESRGANTrainer
    from torchsr_tpu_torch.utils.logging import Logger

    args = Namespace(batch_size=MULTI_BATCH, epochs=1, pretrain_epochs=1,
                     seed=seed, skip_image_save=True, disable_amp=False,
                     metrics_file=None)
    tr = ESRGANTrainer(args, Namespace(crop_size=128), None, 1, 1,
                       device=torch.device(DEVICE), logger=Logger())
    k = tr.gan_steps_per_call
    warm = _stacks(MULTI_BATCH, 128, k, seed + 41)
    tr.gan_step_multi(*warm, MULTI_LR, MULTI_LR)  # captures
    torch.cuda.synchronize()
    snap = _snapshot(tr)
    rng = np.random.default_rng(seed + 42)
    host = [(rng.integers(0, 256, (MULTI_BATCH, 128, 128, 3),
                          dtype=np.uint8),
             rng.integers(0, 2, (MULTI_BATCH, 2)).astype(bool))
            for _ in range(PREFETCH_GAN_BATCHES)]

    def call(crops_k, flips_k):
        tr.gan_step_multi(crops_k, flips_k, MULTI_LR, MULTI_LR)

    reset_counters()
    kinds = []
    for kind, (crops, flips) in prefetch_to_device_stacked(
            iter(host), DEVICE, k):
        kinds.append(kind)
        if kind == "single":
            crops, flips = crops[None], flips[None]
        call(crops, flips)
    torch.cuda.synchronize()
    launches = read_counters()
    fed = _snapshot(tr)
    _restore_in_place(tr, snap)
    groups = [host[i:i + k] for i in range(0, len(host) - len(host) % k, k)]
    groups += [[b] for b in host[len(host) - len(host) % k:]]
    for group in groups:
        call(*(torch.from_numpy(np.stack([b[j] for b in group])).to(DEVICE)
               for j in range(2)))
    torch.cuda.synchronize()
    diff = _state_diff(fed, _snapshot(tr))
    del tr, snap, fed
    gc.collect()
    torch.cuda.empty_cache()
    check(kinds == ["multi"] * (len(host) // k) + ["single"] * (len(host) % k),
          f"prefetch: the stacked prefetcher grouped {kinds}")
    check(all(d["max"] == 0 for d in diff.values()),
          f"prefetch: steps fed by the prefetcher equal the same steps fed "
          f"by synchronous copies bit for bit: {diff}")
    per_step = {"rdb_fwd": 5 * 3 * NUM_RRDB, "rdb_bwd": 3 * NUM_RRDB}
    check_counts("prefetch: esrgan gan", launches,
                 **{c: n * len(host) for c, n in per_step.items()})
    return {"kinds": kinds, "prefetched_vs_sync": diff}, launches


def _prefetch_headline(seed: int) -> dict:
    """The headline's replayed SRGAN pretrain (batch 128, crop 96, K = 8)
    fed from a pack of the run images through the training loader and
    ``prefetch_to_device_stacked``: one epoch to capture, then one
    epoch timed by the host clock and one under the profiler: ms a
    step, device ms a step and the device's busy share."""
    from argparse import Namespace

    from torchsr_tpu_torch.data.loader import TrainLoader, dataset_source
    from torchsr_tpu_torch.data.prefetch import prefetch_to_device_stacked
    from torchsr_tpu_torch.train.trainer import SRGANTrainer
    from torchsr_tpu_torch.utils.logging import Logger

    data = _run_data(seed)
    with _workdir("prefetch_pack"):
        _quiet(["pack", data["ds"], "ds.tsrpack"])
        names, reader = dataset_source("ds.tsrpack")
        loader = TrainLoader(
            names, HEADLINE_BATCH, HEADLINE_CROP,
            dataset_multiplier=-(-HEADLINE_EPOCH_STEPS * HEADLINE_BATCH
                                 // len(names)),
            workers=8, seed=seed, reader=reader)
        check(len(loader) == HEADLINE_EPOCH_STEPS,
              f"prefetch: the headline epoch holds {len(loader)} steps")
        args = Namespace(batch_size=HEADLINE_BATCH, epochs=1,
                         pretrain_epochs=1, seed=seed, skip_image_save=True,
                         disable_amp=False, metrics_file=None)
        tr = SRGANTrainer(args, Namespace(crop_size=HEADLINE_CROP), None,
                          1, 1, device=torch.device(DEVICE), logger=Logger())
        k = tr.steps_per_call

        def epoch(i):
            for kind, (crops, flips) in prefetch_to_device_stacked(
                    loader.epoch(i), DEVICE, k):
                if kind == "single":
                    crops, flips = crops[None], flips[None]
                tr.pretrain_step_multi(crops, flips)

        epoch(0)  # captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch(1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / HEADLINE_EPOCH_STEPS * 1e3
        prof = profile_device_time(lambda: epoch(2), 1)
        del tr
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": HEADLINE_BATCH, "crop": HEADLINE_CROP,
            "steps_per_call": k, "step_ms": step_ms,
            "crops_per_s": HEADLINE_BATCH / step_ms * 1e3,
            "device_ms_per_step": sum(prof["device_ms_per_batch"].values())
            / HEADLINE_EPOCH_STEPS,
            "busy_share": prof["busy_share_of_span"]}


def phase_prefetch(seed: int) -> dict:
    """The prefetch's copies on a stream of their own (the consumer's
    stream waits on each batch's event): every batch bit-equal to its
    host arrays although its read is held back; replayed ESRGAN GAN
    steps fed by the prefetcher bit-equal to the same steps fed by
    synchronous copies; the headline's replayed steps fed from a pack,
    their time and busy share."""
    streams = _prefetch_streams(seed)
    gan, launches = _prefetch_gan(seed)
    headline = _prefetch_headline(seed)
    say("prefetch", streams=streams, esrgan_gan=gan, headline=headline,
        launches=launches)
    return {"prefetch: esrgan gan": launches}


def _old_arch(sd: dict) -> dict:
    """The reference's keys -> xinntao's old-arch (``RRDB_ESRGAN_x4.pth``,
    4x) ones, the inverse of the loader's rules, written out here."""
    n = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    heads = (("conv1.", "model.0."), ("conv2.", f"model.1.sub.{n}."),
             ("upsample1.", "model.3."), ("upsample2.", "model.6."),
             ("conv3.0.", "model.8."), ("conv4.", "model.10."))
    out = {}
    for key, value in sd.items():
        new = re.sub(r"^blocks\.(\d+)\.(RDB\d)\.(conv[1-4])\.0\.",
                     r"model.1.sub.\1.\2.\3.0.", key)
        new = re.sub(r"^blocks\.(\d+)\.(RDB\d)\.conv5\.",
                     r"model.1.sub.\1.\2.conv5.0.", new)
        for ref, ext in heads:
            if new.startswith(ref):
                new = ext + new[len(ref):]
                break
        out[new] = value
    return out


def phase_external(gen: ESRGANGenerator, ckpt: str, seed: int) -> dict:
    """The 23-RRDB weights under the reference's names, xinntao's
    old-arch (written here) and new-arch and BasicSR's (both by
    ``tools/export_torch_checkpoint.py``): ``test`` and one ``serve``
    request on each give the reference-named checkpoint's bytes, B1 at
    345 launches a forward; the BasicSR file loads back to the same
    weights."""
    from torchsr_tpu_torch.tools import export_torch_checkpoint

    paths: dict = {}
    answers: dict = {}
    rng = np.random.default_rng(seed + 22)
    frame = rng.integers(0, 256, (*SCALE_REQUEST, 3), dtype=np.uint8)
    sd = {k: v.detach().cpu() for k, v in gen.state_dict().items()}
    with _workdir("external"):
        files = {"reference": ckpt}
        torch.save(_old_arch(sd), "old_arch.pth")
        files["old_arch"] = "old_arch.pth"
        for scheme in ("rrdbnet", "basicsr"):
            files[scheme] = export_torch_checkpoint.export(
                ckpt, scheme, out=f"{scheme}.pth")
        _write_png("photo.png", rng.integers(0, 256, (*TEST_IMAGE, 3),
                                             np.uint8))
        for scheme, path in files.items():
            reset_counters()
            _quiet(["test", "photo.png", "--checkpoint", path])
            paths[f"external: test {scheme}"] = read_counters()
            with open("upres-photo.png", "rb") as fh:
                test_bytes = fh.read()
            served, paths[f"external: serve {scheme}"] = _serve_one(
                path, frame)
            answers[scheme] = (test_bytes, served.tobytes())
        back = load_checkpoint(files["basicsr"])["state"]
        raw_keys = sorted(torch.load(files["basicsr"],
                                     weights_only=True)["params"])[:2]
    say("external", schemes=list(files), basicsr_keys=raw_keys,
        launches=paths)
    for scheme, got in answers.items():
        check(got == answers["reference"], f"external: {scheme} answers "
              f"test and serve with the reference checkpoint's bytes")
    for name, counts in paths.items():
        check_counts(name, counts, rdb_fwd=5 * 3 * NUM_RRDB)
    check(back.keys() == sd.keys()
          and all(torch.equal(back[k], v) for k, v in sd.items()),
          "external: the BasicSR export loads back to the same weights")
    return paths


# ------------------------------------------- heads and multiple devices

SRGAN_SERVE_TILE = (8, 256, 256)  # the SRGAN serving tile batch (LR)
SRGAN_HEADLINE = (128, 96, 96)  # the headline pretrain batch (HR crop)
ESRGAN_TAIL = (16, 64, 64)  # the ESRGAN serving tile batch (LR)
SRGAN_TOWER = (128, 24, 24, 64)  # the tower's BatchNorm input
HALO_IMAGE = (96, 128)  # LR image of the halo phase
HALO_OVERLAP = 16
HALO_TOY_OVERLAP = 20  # covers one RRDB's receptive field
SHARD_FRAME = (1080, 1920)
SHARD_DEVICES = 2


def _rand(shape, seed: int, dtype=torch.float32) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand(shape, generator=g).to(DEVICE, dtype)


def _rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def _one_pass_bn(x: torch.Tensor, bn) -> torch.Tensor:
    """Training-mode BatchNorm by the JAX package's moments (one pass,
    shifted by the running mean) in f32, without the running-statistics
    update: the form ``models/layers.py`` would take if it won."""
    xf = x.float()
    d = xf - bn.running_mean
    m1 = d.mean((0, 1, 2))
    var = (d * d).mean((0, 1, 2)) - m1 * m1
    y = (xf - (bn.running_mean + m1)) * (torch.rsqrt(var + bn.eps)
                                        * bn.weight) + bn.bias
    return y.to(x.dtype)


def phase_subpixel_head(seed: int) -> dict:
    """SRGAN's 9x9 head (the partially folded form at 4x) and ESRGAN's
    3x3 tail in subpixel space against the direct conv, at full width:
    outputs per element in f32 (TF32 off) and bf16, both times at the
    serving tile batches and the SRGAN headline batch forward and
    backward; the whole generators both ways (B1's launches on the
    ESRGAN path); BatchNorm's two forms at the SRGAN tower's shape."""
    from torchsr_tpu_torch.models import esrgan as esrgan_mod
    from torchsr_tpu_torch.models import srgan as srgan_mod
    from torchsr_tpu_torch.models.layers import BatchNorm
    from torchsr_tpu_torch.ops.pixel_shuffle import depth_to_space
    from torchsr_tpu_torch.ops.subpixel_conv import (
        conv_head_partially_folded,
    )

    g = torch.Generator().manual_seed(seed + 30)
    srgan = srgan_mod.SRGANGenerator(
        num_residual=SRGAN_BLOCKS, generator=g).to(DEVICE).eval()
    w, b = srgan.conv3.weight.detach(), srgan.conv3.bias.detach()
    rows: dict = {}

    def head_pair(folded):
        hr = depth_to_space(folded, 2)
        return (lambda: conv_head_partially_folded(folded, w, b, 4, 2),
                lambda: srgan.conv3(hr))

    # the serving tile's head input: the last stage's pre-shuffle map
    n, h, wd = SRGAN_SERVE_TILE
    for dtype in (torch.float32, torch.bfloat16):
        folded = _rand((n, 2 * h, 2 * wd, 256), seed + 31, dtype) - 0.5
        sub, direct = head_pair(folded)
        with torch.no_grad():
            err = _rel_max(sub(), direct())
            rows[f"srgan_serve_{str(dtype)[6:]}"] = {
                "rel_err": err, "subpixel_ms": median_ms(sub, 10),
                "direct_ms": median_ms(direct, 10)}
        del folded
    # the headline batch, forward and backward
    n, hh, ww = SRGAN_HEADLINE
    folded = (_rand((n, hh // 2, ww // 2, 256), seed + 32, torch.bfloat16)
              - 0.5).requires_grad_(True)
    hr = depth_to_space(folded.detach(), 2).requires_grad_(True)
    wq = w.clone().requires_grad_(True)
    cot = _rand((n, hh, ww, 3), seed + 33, torch.bfloat16)

    def fwd_bwd(fn, x):
        def run():
            out = fn(x)
            torch.autograd.grad(out, (x, wq), cot)
        return run

    def direct_head(x):
        y = F.conv2d(x.permute(0, 3, 1, 2), wq.to(x.dtype), b.to(x.dtype),
                     padding=4)
        return y.permute(0, 2, 3, 1)

    sub_fb = fwd_bwd(lambda x: conv_head_partially_folded(x, wq, b, 4, 2),
                     folded)
    direct_fb = fwd_bwd(direct_head, hr)
    rows["srgan_headline_fwd_bwd_bfloat16"] = {
        "subpixel_ms": median_ms(sub_fb, 10),
        "direct_ms": median_ms(direct_fb, 10)}
    del folded, hr, cot
    # ESRGAN's tail at the serving tile batch
    esrgan = ESRGANGenerator(
        num_rrdb_blocks=NUM_RRDB,
        generator=torch.Generator().manual_seed(seed + 34)).to(
        DEVICE).requires_grad_(False)
    n, h, wd = ESRGAN_TAIL
    for dtype in (torch.float32, torch.bfloat16):
        x = _rand((n, 4 * h, 4 * wd, 64), seed + 35, dtype) - 0.5
        with torch.no_grad():
            sub = lambda: esrgan.head(x, True)  # noqa: E731
            direct = lambda: esrgan.head(x, False)  # noqa: E731
            rows[f"esrgan_tail_{str(dtype)[6:]}"] = {
                "rel_err": _rel_max(sub(), direct()),
                "subpixel_ms": median_ms(sub, 10),
                "direct_ms": median_ms(direct, 10)}
        del x
    # whole generators both ways (bf16): ESRGAN on B1, SRGAN on cuDNN
    gens = {}
    lr = _rand((n, h, wd, 3), seed + 36)
    esrgan.compute_dtype = torch.bfloat16
    paths = {}
    for fused in (True, False):
        esrgan.fused_tail = fused
        reset_counters()
        with torch.inference_mode():
            gens[f"esrgan_{fused}"] = esrgan(lr)
        torch.cuda.synchronize()
        paths[f"subpixel_head: esrgan fused_tail={fused}"] = read_counters()
    srgan.compute_dtype = torch.bfloat16
    lr_s = _rand((2, 64, 64, 3), seed + 37)
    for fused in (True, False):
        srgan.fused_head = fused
        with torch.inference_mode():
            gens[f"srgan_{fused}"] = srgan(lr_s)
    esrgan.fused_tail = srgan.fused_head = None
    gen_err = {m: _rel_max(gens[f"{m}_True"], gens[f"{m}_False"])
               for m in ("esrgan", "srgan")}
    # BatchNorm at the tower's shape, forward and backward, bf16 input
    bn = BatchNorm(64).to(DEVICE).train()
    xb = (_rand(SRGAN_TOWER, seed + 38, torch.bfloat16) - 0.5) \
        .requires_grad_(True)
    gb = _rand(SRGAN_TOWER, seed + 39, torch.bfloat16)
    with torch.no_grad():
        bn.running_mean.copy_(xb.detach().float().mean((0, 1, 2)) + 0.01)
    bn_err = _rel_max(_one_pass_bn(xb, bn), bn(xb))

    def bn_fb(fn):
        return lambda: torch.autograd.grad(fn(xb), xb, gb)

    rows["batchnorm_fwd_bwd_bfloat16"] = {
        "rel_err": bn_err, "one_pass_ms": median_ms(bn_fb(
            lambda x: _one_pass_bn(x, bn)), 20),
        "torch_ms": median_ms(bn_fb(bn), 20)}
    say("subpixel_head", rows=rows, generator_rel_err=gen_err,
        defaults={"srgan FUSED_HEAD_ON_CUDA": srgan_mod.FUSED_HEAD_ON_CUDA,
                  "esrgan FUSED_TAIL_ON_CUDA":
                      esrgan_mod.FUSED_TAIL_ON_CUDA},
        launches=paths)
    for name, row in rows.items():
        if "rel_err" not in row:
            continue
        limit = 1e-5 if name.endswith("float32") else 2e-2
        check(row["rel_err"] <= limit,
              f"subpixel_head: {name} within {limit} of the direct conv")
    for model, err in gen_err.items():
        check(err <= 2e-2, f"subpixel_head: the {model} generator's two "
                           f"heads agree in bf16 ({err})")
    for name, counts in paths.items():
        check_counts(name, counts, rdb_fwd=5 * 3 * NUM_RRDB)
    return paths


_TRAIN_SCRIPT = """
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
# the smoke's own settings: f32 convolutions and matmuls in full f32
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from torchsr_tpu_torch import cli, ops
from torchsr_tpu_torch.tools.profile_gan_step import chained_ms
from torchsr_tpu_torch.train.trainer import run_train
from torchsr_tpu_torch.utils.preemption import PreemptionGuard
dist = torch.distributed
# the launcher's variables, hidden from the runs without it
launcher = {k: os.environ.pop(k) for k in
            ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
            if k in os.environ}
out = {}
for job in sys.argv[3].split(","):
    run, model = job.split(":")
    if run == "torchrun":
        os.environ.update(launcher)
    os.makedirs(os.path.join(run, model), exist_ok=True)  # every rank
    os.chdir(os.path.join(run, model))
    for m in ops.MODEL_KERNELS:
        for n in m.LAUNCH_COUNTERS:
            setattr(m, n, 0)
    trainer = run_train(cli.parse_args([*sys.argv[4:], "--model", model]))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    state = [t.detach().double() for t in (
        *trainer.gen.state_dict().values(),
        *trainer.disc.state_dict().values())]
    row = {
        "counts": ops.launch_counts(),
        "fingerprint": [float(t.abs().sum()) for t in state],
        "finite": all(bool(torch.isfinite(t).all()) for t in state),
        "world": dist.get_world_size() if dist.is_initialized() else 1,
        "process_group": dist.is_initialized()}
    # the replayed step (its one-step graph, the run's tail) alone, and
    # with the preemption poll after each call as the epoch loop runs
    # it: under torchrun the poll casts the ranks' vote
    shape = (1, trainer.batch_size, trainer.crop_size, trainer.crop_size, 3)
    crops = torch.randint(0, 256, shape, dtype=torch.uint8,
                          device=trainer.device)
    flips = torch.zeros((*shape[:2], 2), dtype=torch.bool,
                        device=trainer.device)
    trainer._preemption = PreemptionGuard()  # polled, never set

    def call():
        trainer.pretrain_step_multi(crops, flips)
        trainer._check_preemption(1, "timing")

    row["replay_ms"] = chained_ms(lambda: trainer.pretrain_step_multi(
        crops, flips), 10)
    row["loop_step_ms"] = chained_ms(call, 10)
    trainer._check_preemption(1, "timing", last=True)
    out[job] = row
    os.chdir(os.path.join("..", ".."))
rank = dist.get_rank() if dist.is_initialized() else 0
with open(f"{sys.argv[2]}.{rank}", "w") as fh:
    json.dump(out, fh)
"""
DDP_MODELS = ("esrgan", "srgan")
DDP_RUNS = ("plain_a", "plain_b", "torchrun")


def _driven_train(argv: list, jobs: list, nproc: int) -> list:
    """``train`` (``argv`` plus ``--model m``) for each (run, model) of
    ``jobs`` in order, in one process under ``torchrun --standalone
    --nproc-per-node nproc``, each in its own ``run/model``
    subdirectory; the runs not named "torchrun" see no launcher (no
    process group).  Returns each rank's {"run:model": {"counts"
    (launches, by counter name), "fingerprint", "finite", "world",
    "process_group", "replay_ms", "loop_step_ms"}}."""
    script = os.path.join(ROOT, "build", "chip_smoke", "train_runs.py")
    os.makedirs(os.path.dirname(script), exist_ok=True)
    with open(script, "w") as fh:
        fh.write(_TRAIN_SCRIPT)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), script, ROOT, "rank.json",
         ",".join(f"{run}:{model}" for run, model in jobs),
         *map(str, argv)], capture_output=True,
        text=True, timeout=900, env={**os.environ, "PYTHONPATH": ROOT})
    check(out.returncode == 0, f"train (torchrun ranks {nproc}) exits 0: "
          f"{out.stderr[-3000:]}")
    ranks = []
    for r in range(nproc):
        with open(f"rank.json.{r}") as fh:
            rank = json.load(fh)
        for row in rank.values():
            row["counts"] = {name: row["counts"].get(attr, 0)
                             for name, (module, attr) in COUNTERS.items()}
        ranks.append(rank)
    return ranks


def phase_ddp_train(seed: int) -> dict:
    """ESRGAN's ``train``, one epoch a phase (graphed steps), three
    times in one process under ``torchrun --standalone --nproc-per-node
    1``: twice without the launcher's variables, then under them (NCCL,
    world 1: the gradients' all-reduce captured with each step, the
    preemption vote after each call).  The torchrun run's gan-latest
    within the noise floor of the two plain runs (the multistep phase's
    rule); B1/B2's launches exact in each; the epoch loop's replayed
    step timed in each.  (SRGAN reaches no kernel, and its
    world-size > 1 code, the global batch's BatchNorm and means, runs in
    multi_card and the CPU tests.)"""
    data = _run_data(seed)
    argv = _train_argv(data, seed, "--skip-image-save")
    paths, rows, states = {}, {}, {}
    with _workdir("ddp_train"):
        t0 = time.perf_counter()
        rank0 = _driven_train(argv, [(run, "esrgan") for run in DDP_RUNS],
                              1)[0]
        rows["process_s"] = time.perf_counter() - t0
        for run in DDP_RUNS:
            row = rank0[f"{run}:esrgan"]
            paths[f"ddp_train: esrgan {run}"] = row["counts"]
            rows[f"{run}_group"] = [row["process_group"], row["world"]]
            rows[f"{run}_step_ms"] = {"replay": row["replay_ms"],
                                      "loop": row["loop_step_ms"]}
            states[run] = _checkpoint_categories(
                os.path.join(run, "esrgan", "esrgan-gan-latest.pth"))
    floor = _state_diff(states["plain_a"], states["plain_b"])
    diff = _state_diff(states["torchrun"], states["plain_a"])
    rows["floor"], rows["torchrun_vs_plain"] = floor, diff
    say("ddp_train", rows=rows, launches=paths)
    check(rows["torchrun_group"] == [True, 1]
          and rows["plain_a_group"] == rows["plain_b_group"] == [False, 1],
          "ddp_train: a world-1 process group under torchrun alone")
    check(_within_floor(diff, floor),
          f"ddp_train: the torchrun checkpoint within the plain runs' "
          f"floor: {diff} vs {floor}")
    for name, counts in paths.items():
        check_counts(name, counts, **_run_launches(renders=0))
    return paths


def phase_multi_card(seed: int) -> dict:
    """Every visible card (run only with ``--only multi_card`` on a
    machine with several): ``train`` under ``torchrun --nproc-per-node
    N`` (NCCL: gradients averaged and BatchNorm statistics over the
    global batch inside the captured steps) for each model, every rank's
    generator and discriminator the same to the last bit, finite, B1/B2
    launched on each rank as its shard implies; a 1080p frame over the N
    cards (``tiled_upscale_sharded``) equal to one card's bit for bit;
    the halo grid over the cards against the monolithic forward."""
    from torchsr_tpu_torch.infer.halo import halo_upscale, make_spatial_mesh
    from torchsr_tpu_torch.infer.multichip import (
        sharded_forwards,
        tiled_upscale_sharded,
    )
    from torchsr_tpu_torch.infer.tiled import tile_forward
    from torchsr_tpu_torch.parallel.mesh import replicate_module

    n = torch.cuda.device_count()
    check(n > 1, f"multi_card: needs several cards, found {n}")
    data = _run_data(seed)
    paths, rows = {}, {}
    per_rank = -(-RUN_IMAGES // n)
    steps = max(1, per_rank // TRAIN_BATCH)
    with _workdir("multi_card"):
        t0 = time.perf_counter()
        ranks = _driven_train(_train_argv(data, seed, "--skip-image-save",
                                          "--num-devices", n),
                              [("torchrun", m) for m in DDP_MODELS], n)
        rows["train_s"] = time.perf_counter() - t0
        for model in DDP_MODELS:
            rows[f"{model}_files"] = sorted(
                os.listdir(os.path.join("torchrun", model)))
    for model in DDP_MODELS:
        mine = [rank[f"torchrun:{model}"] for rank in ranks]
        rows[f"{model}_step_ms"] = [{"replay": r["replay_ms"],
                                     "loop": r["loop_step_ms"]}
                                    for r in mine]
        rows[f"{model}_ranks_equal"] = all(
            r["fingerprint"] == mine[0]["fingerprint"] for r in mine)
        rows[f"{model}_finite"] = all(r["finite"] for r in mine)
        for r, row in enumerate(mine):
            paths[f"multi_card: {model} rank {r}"] = row["counts"]
        check(rows[f"{model}_ranks_equal"] and rows[f"{model}_finite"]
              and all(r["world"] == n for r in mine),
              f"multi_card: the {n} {model} ranks hold the same finite state")
        check(f"{model}-gan-latest.pth" in rows[f"{model}_files"],
              f"multi_card: rank 0 wrote the {model} checkpoints")
    devices = [torch.device(DEVICE, i) for i in range(n)]
    gen, _ = serving_generator(seed)
    gen.compute_dtype = torch.bfloat16
    h, w = SHARD_FRAME
    x = _rand((h, w, 3), seed + 40)
    kw = {"tile": 64, "overlap": 8, "tile_batch": 16}
    single_forward = tile_forward(gen, DEVICE)
    forwards = sharded_forwards(gen, devices)
    frames = {"single": lambda: tiled_upscale(single_forward, x, **kw),
              "sharded": lambda: tiled_upscale_sharded(forwards, x,
                                                       devices, **kw)}
    outs = {}
    for name, frame in frames.items():
        # the first call captures; each call timed from an idle host and
        # idle cards
        seconds = []
        for _ in range(3):
            for d in devices:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            outs[name] = frame()
            for d in devices:
                torch.cuda.synchronize(d)
            seconds.append(time.perf_counter() - t0)
        rows[f"{name}_frame_s"] = seconds
    single, sharded = outs["single"], outs["sharded"]
    rows["sharded_equals_single"] = torch.equal(sharded, single)
    mesh = make_spatial_mesh(devices)
    xh = _rand((*HALO_IMAGE, 3), seed + 52)
    replicas = replicate_module(gen, devices)
    with torch.inference_mode():
        mono = gen(xh[None])[0]
    halo = halo_upscale(replicas, xh, mesh, overlap=HALO_OVERLAP)
    tiled = tiled_upscale(gen, xh, tile=64, overlap=HALO_OVERLAP,
                          tile_batch=4)
    gen.compute_dtype = None
    rows["halo_grid"] = [mesh.ny, mesh.nx]
    rows["halo_max_abs_err"] = float((halo - mono).abs().max())
    rows["tiled_max_abs_err"] = float((tiled - mono).abs().max())
    say("multi_card", cards=n, rows=rows, launches=paths)
    for name, counts in paths.items():
        model = "esrgan" if "esrgan" in name else "srgan"
        # SRGAN's BatchNorms synchronise across the ranks in training (the
        # module composition, no bn_act call in a step); its evals run
        # bn_act in f32 as ESRGAN's run B1
        check_counts(name, counts, **_run_launches(
            steps=steps if model == "esrgan" else 0, renders=0,
            model=model))
    check(rows["sharded_equals_single"],
          "multi_card: the frame over the cards equals one card's")
    check(rows["halo_max_abs_err"] <= rows["tiled_max_abs_err"],
          "multi_card: the halo grid inside the tiled path's error")
    return paths


def phase_shard_tiles(gen: ESRGANGenerator, ckpt: str, seed: int) -> dict:
    """A 1080p frame through ``tiled_upscale_sharded`` over the card
    listed twice (a replica and a graph each) equals ``tiled_upscale``
    bit for bit; ``test --shard-tiles`` and ``serve --shard-tiles``
    answer; ``pair_conv`` over the device list equals one call (B4/B5
    launched once a part)."""
    from torchsr_tpu_torch.infer.multichip import (
        sharded_forwards,
        tiled_upscale_sharded,
    )
    from torchsr_tpu_torch.infer.tiled import tile_forward

    h, w = SHARD_FRAME
    tile, overlap, batch = 64, 8, 16
    batches = bench_tile_batches(SHARD_FRAME, tile, overlap, batch)
    x = _rand((h, w, 3), seed + 40)
    gen.compute_dtype = torch.bfloat16
    devices = [torch.device(DEVICE, 0)] * SHARD_DEVICES
    paths = {}
    forwards = sharded_forwards(gen, devices)
    single = tile_forward(gen, DEVICE)
    outs, secs = {}, {}
    for name, fn in (("sharded", lambda: tiled_upscale_sharded(
            forwards, x, devices, tile=tile, overlap=overlap,
            tile_batch=batch)),
                     ("single", lambda: tiled_upscale(
            single, x, tile=tile, overlap=overlap, tile_batch=batch))):
        # the counted call captures the graphs; a second call after it
        secs[name] = []
        for call in range(2):
            torch.cuda.synchronize()
            reset_counters()
            t0 = time.perf_counter()
            outs[name] = fn()
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
            if not call:
                paths[f"shard_tiles: {name} frame"] = read_counters()
    gen.compute_dtype = None
    equal = torch.equal(outs["sharded"], outs["single"])
    # the CLI and the daemon
    frame = np.random.default_rng(seed + 41).integers(
        0, 256, (150, 210, 3), np.uint8)
    with _workdir("shard_tiles"):
        _write_png("a.png", frame)
        reset_counters()
        _quiet(["test", "a.png", "--checkpoint", ckpt, "--shard-tiles",
                "--tile-overlap", overlap])
        torch.cuda.synchronize()
        paths["shard_tiles: test --shard-tiles"] = read_counters()
        from PIL import Image

        tested = np.asarray(Image.open("upres-a.png"))
    service = CheckpointUpscaleService(model="esrgan", checkpoint=ckpt,
                                       device=DEVICE, shard_devices=devices)
    reset_counters()
    served = _unpng(service.upscale_bytes(_png(frame))[0])
    torch.cuda.synchronize()
    paths["shard_tiles: serve --shard-tiles"] = read_counters()
    # pair_conv's batch split over the device list
    rng = np.random.default_rng(seed + 42)
    xp = torch.from_numpy(rng.standard_normal((128, 24, 24, 64))).to(
        DEVICE, torch.bfloat16).requires_grad_(True)
    kp = torch.from_numpy(rng.standard_normal((3, 3, 64, 64)) * 0.05).to(
        DEVICE, torch.float32).requires_grad_(True)
    grads = {}
    for name, devs in (("split", devices), ("one", None)):
        reset_counters()
        y = pc_ops.pair_conv(xp, kp, devices=devs)
        gx, gk = torch.autograd.grad(y.float().square().sum(), (xp, kp))
        torch.cuda.synchronize()
        grads[name] = (y, gx, gk)
        if devs:
            paths["shard_tiles: pair_conv split"] = read_counters()
    pair_err = max(_rel_max(a, b) for a, b in zip(grads["split"],
                                                   grads["one"]))
    say("shard_tiles", frame=[h, w], devices=len(devices),
        tile_batches=batches, sharded_equals_single=equal, seconds=secs,
        test_shape=list(tested.shape), served_shape=list(served.shape),
        served_equals_test=bool(np.array_equal(served, tested)),
        pair_conv_split_rel_err=pair_err, launches=paths)
    check(equal and outs["sharded"].shape == (4 * h, 4 * w, 3),
          "shard_tiles: the sharded frame equals tiled_upscale bit for bit")
    check(tested.shape == served.shape == (600, 840, 3),
          "shard_tiles: test and serve --shard-tiles write 4x images")
    check(pair_err <= 1e-2, f"shard_tiles: pair_conv split ({pair_err})")
    fwd = 5 * 3 * NUM_RRDB
    # each replica's graph: one eager warm-up forward, then a replay a
    # batch
    check_counts("shard_tiles: sharded frame",
                 paths["shard_tiles: sharded frame"],
                 rdb_fwd=fwd * (batches + SHARD_DEVICES * CAPTURE_FORWARDS))
    check_counts("shard_tiles: single frame",
                 paths["shard_tiles: single frame"],
                 rdb_fwd=fwd * (batches + CAPTURE_FORWARDS))
    check_counts("shard_tiles: pair_conv split",
                 paths["shard_tiles: pair_conv split"],
                 pair_fwd=SHARD_DEVICES, pair_bwd=SHARD_DEVICES)
    # test: one card, tile batches of 8; serve: batches of 16 over two
    # replicas (each captures at its first batch)
    check_counts("shard_tiles: test --shard-tiles",
                 paths["shard_tiles: test --shard-tiles"],
                 rdb_fwd=fwd * (bench_tile_batches(frame.shape[:2], 64, 8, 8)
                                + CAPTURE_FORWARDS))
    served_batches = bench_tile_batches(frame.shape[:2], 64, 8, 16)
    check_counts("shard_tiles: serve --shard-tiles",
                 paths["shard_tiles: serve --shard-tiles"],
                 rdb_fwd=fwd * (served_batches + CAPTURE_FORWARDS
                                * min(served_batches, SHARD_DEVICES)))
    return paths


def phase_halo(gen: ESRGANGenerator, ckpt: str, seed: int) -> dict:
    """A 2 x 2 grid on the card listed four times: a 1-RRDB generator
    (receptive field inside ``HALO_TOY_OVERLAP``) exact against its
    monolithic forward in f32; the full ESRGAN in bf16 no further from
    its monolithic forward than the tiled path at the same overlap;
    ``test --spatial-shard`` writes a 4x image."""
    from torchsr_tpu_torch.infer.halo import halo_upscale, make_spatial_mesh

    devices = [torch.device(DEVICE, 0)] * 4
    mesh = make_spatial_mesh(devices, 2, 2)
    toy = ESRGANGenerator(num_rrdb_blocks=1, generator=torch.Generator()
                          .manual_seed(seed + 50)).to(DEVICE) \
        .requires_grad_(False)
    # blocks wider than two halos: no block sees the whole image
    h, w = 6 * HALO_TOY_OVERLAP, 8 * HALO_TOY_OVERLAP
    x = _rand((h, w, 3), seed + 51)
    with torch.inference_mode():
        mono = toy(x[None])[0]
    toy_out = halo_upscale([toy] * 4, x, mesh, overlap=HALO_TOY_OVERLAP)
    toy_err = _rel_max(toy_out, mono)
    gen.compute_dtype = torch.bfloat16
    x = _rand((*HALO_IMAGE, 3), seed + 52)
    paths = {}
    with torch.inference_mode():
        reset_counters()
        mono = gen(x[None])[0]
        torch.cuda.synchronize()
        paths["halo: monolithic"] = read_counters()
    reset_counters()
    halo = halo_upscale([gen] * 4, x, mesh, overlap=HALO_OVERLAP)
    torch.cuda.synchronize()
    paths["halo: 2x2 grid"] = read_counters()
    tiled = tiled_upscale(gen, x, tile=64, overlap=HALO_OVERLAP,
                          tile_batch=4)
    gen.compute_dtype = None
    halo_err = float((halo - mono).abs().max())
    tiled_err = float((tiled - mono).abs().max())
    with _workdir("halo"):
        _write_png("a.png", np.random.default_rng(seed + 53).integers(
            0, 256, (70, 90, 3), np.uint8))
        reset_counters()
        _quiet(["test", "a.png", "--checkpoint", ckpt, "--spatial-shard",
                "--tile-overlap", 8])
        torch.cuda.synchronize()
        paths["halo: test --spatial-shard"] = read_counters()
        from PIL import Image

        shape = np.asarray(Image.open("upres-a.png")).shape
    say("halo", grid=[2, 2], toy_rel_err=toy_err, image=list(HALO_IMAGE),
        overlap=HALO_OVERLAP, halo_max_abs_err=halo_err,
        tiled_max_abs_err=tiled_err, test_shape=list(shape),
        launches=paths)
    check(toy_err <= 1e-5, f"halo: exact against the monolithic forward "
                           f"where the overlap covers the field ({toy_err})")
    check(halo_err <= tiled_err,
          f"halo: inside the tiled path's error ({halo_err} vs {tiled_err})")
    check(shape == (280, 360, 3), "halo: test --spatial-shard writes 4x")
    fwd = 5 * 3 * NUM_RRDB
    check_counts("halo: 2x2 grid", paths["halo: 2x2 grid"], rdb_fwd=4 * fwd)
    check_counts("halo: test --spatial-shard",
                 paths["halo: test --spatial-shard"], rdb_fwd=fwd)
    return paths


# The kernels of the kernels line: (name, source, the TPU kernel it
# replaces under torchsr_tpu/ops/pallas/, the timed rows and their key,
# the timed shape).
KERNELS = (
    ("rdb_fwd", "rdb_fwd.cu", "rdb.py:142", "rdb_fwd", "bfloat16",
     SERVE_RDB_SHAPE),
    ("rdb_fwd_f32", "rdb_fwd_tf32_sm90.cuh", "rdb.py:142", "rdb_fwd",
     "float32", SERVE_RDB_SHAPE),
    ("rdb_bwd", "rdb_bwd.cu", "rdb.py:495", "rdb_bwd", "bfloat16",
     TRAIN_RDB_SHAPE),
    ("rdb_bwd_f32", "rdb_bwd_tf32_sm90.cuh", "rdb.py:495", "rdb_bwd",
     "float32", TRAIN_RDB_SHAPE),
    ("rdb_fwd_ext", "rdb_ext.cu", "rdb.py:299", "rdb_fwd_ext", "bfloat16",
     SERVE_RDB_SHAPE),
    ("rdb_fwd_ext_f32", "rdb_fwd_tf32_sm90.cuh", "rdb.py:299",
     "rdb_fwd_ext", "float32", SERVE_RDB_SHAPE),
    ("rdb_bwd_ext", "rdb_ext.cu", "rdb.py:594", "rdb_bwd_ext", "bfloat16",
     TRAIN_RDB_SHAPE),
    ("rdb_bwd_ext_f32", "rdb_bwd_tf32_sm90.cuh", "rdb.py:594",
     "rdb_bwd_ext", "float32", TRAIN_RDB_SHAPE),
    ("rdb_fwd_ilv", "rdb_ilv.cu", "rdb.py:223", "rdb_fwd_ilv", "bfloat16",
     SERVE_RDB_SHAPE),
    ("rdb_fwd_ilv_f32", "rdb_ilv_tf32_sm90.cuh", "rdb.py:223",
     "rdb_fwd_ilv", "float32", SERVE_RDB_SHAPE),
    ("pair_synth", "pair_synth.cu", "preprocess.py:45", "pair_synth",
     "uint8", (*PAIR_SYNTH_SHAPES[0], PAIR_SYNTH_SHAPES[0][1], 3)),
    ("pair_fwd", "pair_conv.cu", "pair_conv.py:134", "pair_fwd", "bfloat16",
     (*PAIR_CONV_SHAPES[0], 64)),
    ("pair_bwd", "pair_conv.cu", "pair_conv.py:148", "pair_bwd", "bfloat16",
     (*PAIR_CONV_SHAPES[0], 64)),
    ("pair_fwd_f32", "pair_conv.cu", "pair_conv.py:134", "pair_fwd",
     "float32", (*PAIR_CONV_SHAPES[0], 64)),
    ("pair_bwd_f32", "pair_conv.cu", "pair_conv.py:148", "pair_bwd",
     "float32", (*PAIR_CONV_SHAPES[0], 64)),
    ("bn_act_fwd", "bn_act.cu", None, "bn_act", "bfloat16", SRGAN_TOWER),
    ("bn_act_bwd", "bn_act.cu", None, "bn_act", "bfloat16_bwd",
     SRGAN_TOWER),
    ("bn_act_fwd_f32", "bn_act.cu", None, "bn_act", "float32", SRGAN_TOWER),
    ("bn_act_bwd_f32", "bn_act.cu", None, "bn_act", "float32_bwd",
     SRGAN_TOWER),
)



def _profiled_ms(prof) -> float | None:
    """Device time per call of a phase's profile (None: not profiled):
    ``bwd_profile``'s or ``profile_device_time``'s."""
    if prof is None:
        return None
    if "device_ms" in prof:
        return prof["device_ms"]
    return sum(prof["device_ms_per_batch"].values())


def kernels_line(timed: dict, paths: dict) -> dict:
    """One entry per kernel: its time, plain time, bound and library
    time (where one PyTorch call computes it) from its phase, the device
    time of both where the phase profiles them, and its
    launches on each main path (counters set to 0 just before each
    path)."""
    out = []
    for name, source, replaces, phase, key, shape in KERNELS:
        row = timed[phase][key]
        by_path = {p: c[name] for p, c in paths.items()}
        out.append({
            "name": name,
            "route": "cuda",
            "source": f"torchsr_tpu_torch/ops/csrc/{source}",
            "replaces": (None if replaces is None
                         else f"torchsr_tpu/ops/pallas/{replaces}"),
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
            "device_ms": _profiled_ms(row.get("profile")),
            "library_device_ms": _profiled_ms(row.get("library_profile")),
            "dtype": key.removesuffix("_bwd"),
            "shape": list(shape),
        })
    return {"kernels": out}


# ------------------------------------------------------------ HAT (HA)
# HAT's serving tile batch: 8 tiles of 256x256 tokens, C = 180, 6 heads.
HAT_SHAPE = (8, 256, 256, 180)
HAT_HEADS = 6
# The attention kernel against its plain composition (f32 from the same
# bf16 qkv): the kernel rounds the softmax's probabilities to bf16 for the
# P.V product (2^-9 of each term) and its output to bf16 (2^-9 of the
# value), and sums in another order, so a result passes where
#     |got - ref| <= 2^-7 |ref| + 2^-8 max|ref|
# at every element (excess <= 1).  The planted fault, the bias table
# dropped (zeros), must read above 1: the inputs give the bias a std of
# 1 against scores of std ~1, so a dropped bias moves every output.
HA_LIMITS = {"rel": 2.0 ** -7, "frac": 2.0 ** -8}
# The graphed bf16 HAT tile batch against the plain f32 reference
# (port_bench/reference/hat.py, TF32 off), in [0, 1] pixel units: bf16
# activations through 42 blocks of a seeded network whose output spreads
# ~0.1 around its mean; the limits are the serving check's order, 16 and
# 2 levels of 255.
HA_NET_LIMITS = {"max_abs": 16 / 255, "mean_abs": 2 / 255}


def ha_excess(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |got - ref| / (rel |ref| + frac max|ref|)."""
    ref = ref.float()
    d = (got.float() - ref).abs()
    allow = HA_LIMITS["rel"] * ref.abs() + HA_LIMITS["frac"] * ref.abs().max()
    return float((d / allow.clamp_min(1e-30)).max())


def _ha_inputs(seed: int, overlap: bool):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w, c = HAT_SHAPE
    qkv = torch.randn((b, h, w, 3 * c), device="cuda", generator=gen)
    qkv = qkv.to(torch.bfloat16)
    rows = (16 + 24 - 1) ** 2 if overlap else (2 * 16 - 1) ** 2
    table = torch.randn((rows, HAT_HEADS), device="cuda", generator=gen)
    return qkv, table


def _ha_key(name: str) -> str:
    """A kernel's short name for the HA profiles."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", name, maxsplit=1)[0][:60]


def ha_bound_ms(overlap: bool) -> tuple[float, str]:
    """q, k and v read once, the output written once (bf16), against the
    two products' FLOPs at head dim 30."""
    b, h, w, c = HAT_SHAPE
    tokens = b * h * w
    keys = 576 if overlap else 256
    flops = 4.0 * tokens * keys * c
    nbytes = tokens * 4 * c * 2.0
    ops_ms, mem_ms = flops / 989e12 * 1e3, nbytes / 3.35e12 * 1e3
    return (max(ops_ms, mem_ms),
            "operations" if ops_ms > mem_ms else "bytes")


def phase_window_attn(seed: int) -> dict:
    """HA, HAT's attention kernel, at the serving tile batch: the HAB
    unshifted and shifted and the OCAB against the plain composition
    within ``HA_LIMITS``, the dropped-bias fault over them, the launch
    counts, times beside the bound and the plain composition; then the
    whole seeded HAT tile batch, graphed, against the f32 reference
    within ``HA_NET_LIMITS``, with its launch, window and pad counts."""
    from torchsr_tpu_torch.ops import window_attn as wa

    rows = {}
    for name, overlap, shift in (("hab", False, 0), ("hab_shifted", False, 8),
                                 ("ocab", True, 0)):
        qkv, table = _ha_inputs(seed + len(rows), overlap)
        kw = ({"overlap": 24} if overlap else {"shift": shift})
        kernel = wa.overlap_attn if overlap else wa.window_attn
        plain = (wa.overlap_attn_reference if overlap
                 else wa.window_attn_reference)
        reset_counters()
        got = kernel(qkv, table, heads=HAT_HEADS, window=16, **kw)
        torch.cuda.synchronize()
        counts = read_counters()
        ref = plain(qkv, table, heads=HAT_HEADS, window=16, **kw).float()
        ref_f32 = plain(qkv.float(), table, heads=HAT_HEADS, window=16, **kw)
        wrong = plain(qkv.float(), torch.zeros_like(table), heads=HAT_HEADS,
                      window=16, **kw)
        wins = HAT_SHAPE[0] * (HAT_SHAPE[1] // 16) * (HAT_SHAPE[2] // 16)
        row = {"max_abs_err": float((got.float() - ref_f32).abs().max()),
               "excess": ha_excess(got, ref_f32),
               "wrong_no_bias": ha_excess(wrong, ref_f32),
               "plain_bf16_out_excess": ha_excess(ref, ref_f32)}
        del ref, wrong
        bound, by = ha_bound_ms(overlap)
        row["ms"] = median_ms(lambda: kernel(qkv, table, heads=HAT_HEADS,
                                             window=16, **kw))
        row["plain_ms"] = median_ms(
            lambda: plain(qkv, table, heads=HAT_HEADS, window=16, **kw),
            reps=3, warmup=1)
        row.update(bound_ms=bound, bound_by=by,
                   roofline_pct=100.0 * bound / row["ms"])
        prof = profile_device_time(
            lambda: kernel(qkv, table, heads=HAT_HEADS, window=16, **kw),
            batches=3, key=_ha_key)
        row["profile"] = prof
        rows[name] = row
        say(f"window_attn[{name}]", shape=list(HAT_SHAPE), **row)
        launch = "overlap_attn" if overlap else "window_attn"
        check_counts(f"window_attn {name}", counts,
                     **{launch: 1,
                        ("hat_windows_ocab" if overlap
                         else "hat_windows_hab"): wins})
        check(row["excess"] <= 1, f"window_attn {name} within its limits: "
                                  f"{row['excess']}")
        check(row["wrong_no_bias"] > 1, f"window_attn {name}: the limits "
              f"see a dropped bias: {row['wrong_no_bias']}")
        del qkv, table, got, ref_f32
        torch.cuda.empty_cache()
    with contextlib.suppress(NotImplementedError):
        wa.window_attn(torch.zeros((1, 16, 16, 18), device="cuda"),
                       torch.zeros((31 * 31, 1), device="cuda"), heads=1,
                       window=16)
        check(False, "window_attn refuses f32 on CUDA")
    rows["net"] = _ha_network(seed)
    return rows


def _ha_network(seed: int) -> dict:
    """The seeded HAT SRx4 tile batch through the graphed tile forward
    (bf16) against port_bench's f32 reference, with its counts."""
    from port_bench import weights as pb_weights
    from port_bench.reference import hat as hat_ref
    from port_bench.reference import ops as ref_ops
    from torchsr_tpu_torch.infer.tiled import TileForward
    from torchsr_tpu_torch.models.hat import HATGenerator

    cfg = json.loads(open("port_bench/configs/hat.json").read())
    w = pb_weights.make(hat_ref.generator_specs(cfg), seed + 7, "generator",
                        "cuda")
    gen = HATGenerator.sized_to(w, compute_dtype=torch.bfloat16,
                                device="cuda")
    pb_weights.load_into(gen, w)
    gen.eval().requires_grad_(False)
    check(sum(p.numel() for p in gen.parameters())
          == cfg["generator_parameters"], "HAT SRx4's parameter count")
    b = HAT_SHAPE[0]
    x = torch.rand((b, 256, 256, 3), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(seed))
    reset_counters()
    fwd = TileForward(gen, (b, 256, 256, 3), torch.device("cuda"))
    capture = read_counters()
    reset_counters()
    got = fwd(x).clone()
    torch.cuda.synchronize()
    replay = read_counters()
    with ref_ops.exact_f32(), torch.no_grad():
        ref = torch.cat([hat_ref.generator(w, x[i:i + 2].permute(0, 3, 1, 2),
                                           cfg).permute(0, 2, 3, 1)
                         for i in range(0, b, 2)])
    d = (got.float().clamp(0, 1) - ref.clamp(0, 1)).abs()
    row = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
           "ref_std": float(ref.std()),
           "ref_clamped_share": float(((ref < 0) | (ref > 1)).float().mean()),
           "ms": median_ms(lambda: fwd(x), reps=10, warmup=2),
           "capture_counts": {k: v for k, v in capture.items() if v},
           "replay_counts": {k: v for k, v in replay.items() if v}}
    row["profile"] = profile_device_time(
        lambda: fwd(x), batches=2, key=_ha_key)
    say("window_attn[net]", **row)
    wins = b * 16 * 16
    check_counts("hat tile batch replay", replay, window_attn=36,
                 overlap_attn=6, hat_windows_hab=36 * wins,
                 hat_windows_ocab=6 * wins)
    check(row["max_abs"] <= HA_NET_LIMITS["max_abs"]
          and row["mean_abs"] <= HA_NET_LIMITS["mean_abs"],
          f"the graphed HAT tile batch within {HA_NET_LIMITS}: {row}")
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--only", type=str, default="",
        help="Comma-separated phases to run after probe and build (for "
             "kernel work; prints no kernels or final line): rdb_fwd, "
             "rdb_fwd_ext, rdb_fwd_ilv, rdb_bwd, rdb_bwd_ext, pair_synth, "
             "pair_conv, bench_preprocess, bench_pair_conv, bn_act, "
             "window_attn, "
             "train_grad, "
             "train_grad_ext, train_grad_xla, train, train_ext, train_f32, "
             "train_f32_ext, "
             "train_speed, eval, interp (both after train), eval_ilv, "
             "srgan_train, "
             "multistep, bench, serve_graph, export, batching, external, "
             "pack_train, scale, preempt, fast_compile, subpixel_head, "
             "ddp_train, prefetch, shard_tiles, halo; multi_card (on a "
             "machine with several cards only).")
    args = parser.parse_args()
    smi = phase_probe()
    # f32 references in full f32: cuDNN convolutions default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the default paths run with every knob off, whatever the environment
    for name in ("EXT_KERNEL", "ILV_KERNEL", "BWD_XLA"):
        setattr(rdb_ops, name, False)
    seconds = {}

    def run(name, fn, *fn_args, **fn_kwargs):
        t0 = time.perf_counter()
        out = fn(*fn_args, **fn_kwargs)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    run("build", phase_build)
    seed = args.seed
    if args.only:
        served = {}

        def serving(fn, *rest):
            """A serving phase on the seeded 23-RRDB generator and its
            checkpoint (made once, as the full run's generator phase
            makes them)."""
            def phase(s):
                if not served:
                    served["gen"], served["ckpt"] = serving_generator(s)
                return fn(*[served[k] for k in rest], s)
            return phase

        phases = {
            "rdb_fwd": phase_rdb,
            "rdb_fwd_ext": lambda s: phase_rdb_variant(s, "ext"),
            "rdb_fwd_ilv": lambda s: phase_rdb_variant(s, "ilv"),
            "rdb_bwd": phase_rdb_bwd, "rdb_bwd_ext": phase_rdb_bwd_ext,
            "pair_synth": phase_pair_synth, "pair_conv": phase_pair_conv,
            "bench_preprocess": phase_bench_preprocess,
            "bench_pair_conv": phase_bench_pair_conv,
            "bn_act": phase_bn_act,
            "window_attn": phase_window_attn,
            "train_grad": phase_train_grad,
            "train_grad_ext": lambda s: phase_train_grad(s, "ext"),
            "train_grad_xla": lambda s: phase_train_grad(s, "xla"),
            "train": phase_train,
            "train_ext": lambda s: phase_train(s, ext=True),
            "train_f32": lambda s: phase_train(s, f32=True),
            "train_f32_ext": lambda s: phase_train(s, ext=True, f32=True),
            "train_speed": phase_train_speed, "eval": phase_eval,
            "eval_ilv": phase_eval_ilv,
            "interp": phase_interp, "srgan_train": phase_srgan_train,
            "multistep": phase_multistep, "bench": phase_bench,
            "serve_graph": serving(
                lambda gen, s: {**phase_serve_graph(gen, s),
                                **phase_serve_graph(gen, s, ilv=True)},
                "gen"),
            "export": serving(phase_export, "gen", "ckpt"),
            "batching": serving(phase_batching, "ckpt"),
            "external": serving(phase_external, "gen", "ckpt"),
            "pack_train": phase_pack_train, "scale": phase_scale,
            "preempt": phase_preempt, "fast_compile": phase_fast_compile,
            "subpixel_head": phase_subpixel_head,
            "ddp_train": phase_ddp_train, "prefetch": phase_prefetch,
            "shard_tiles": serving(phase_shard_tiles, "gen", "ckpt"),
            "halo": serving(phase_halo, "gen", "ckpt"),
            "multi_card": phase_multi_card}
        for name in args.only.split(","):
            run(name, phases[name], seed)
        say("seconds", **seconds)
        return
    timed = {"rdb_fwd": run("rdb_fwd", phase_rdb, seed),
             "rdb_fwd_ext": run("rdb_fwd_ext", phase_rdb_variant, seed,
                                "ext"),
             "rdb_fwd_ilv": run("rdb_fwd_ilv", phase_rdb_variant, seed,
                                "ilv"),
             "rdb_bwd": run("rdb_bwd", phase_rdb_bwd, seed),
             "rdb_bwd_ext": run("rdb_bwd_ext", phase_rdb_bwd_ext, seed),
             "pair_synth": run("pair_synth", phase_pair_synth, seed),
             **run("pair_conv", phase_pair_conv, seed),
             "bn_act": run("bn_act", phase_bn_act, seed)}
    paths = {"bench_preprocess": run("bench_preprocess",
                                     phase_bench_preprocess, seed),
             **run("bench_pair_conv", phase_bench_pair_conv, seed)}
    for variant in TRAIN_GRAD_VARIANTS:
        run("train_grad", phase_train_grad, seed, variant)
    gen = run("generator", phase_generator, seed,
              timed["rdb_fwd"]["bfloat16"]["ms"])
    ckpt = save_serving_checkpoint(gen)
    paths["serve"], answers = run("serve", phase_serve, gen, ckpt, seed)
    paths["serve_ilv"], _ = run("serve", phase_serve, gen, ckpt, seed,
                                ilv=True, prior=answers)
    paths.update(run("serve_graph", phase_serve_graph, gen, seed))
    paths.update(run("serve_graph", phase_serve_graph, gen, seed, ilv=True))
    paths.update(run("export", phase_export, gen, ckpt, seed))
    paths.update(run("batching", phase_batching, ckpt, seed))
    run("test", phase_test, ckpt, seed)
    paths.update(run("external", phase_external, gen, ckpt, seed))
    paths.update(run("shard_tiles", phase_shard_tiles, gen, ckpt, seed))
    paths.update(run("halo", phase_halo, gen, ckpt, seed))
    del gen
    paths.update(run("subpixel_head", phase_subpixel_head, seed))
    for phase, ext, f32 in (("train", False, False),
                            ("train_ext", True, False),
                            ("train_f32", False, True),
                            ("train_f32_ext", True, True)):
        row = run(phase, phase_train, seed, ext=ext, f32=f32)
        paths[phase] = row["launches"]
        for t in row["test"]:
            paths[" ".join([f"{phase}: test", *t["args"]])] = t["launches"]
    paths.update(run("eval", phase_eval, seed))
    paths.update(run("eval_ilv", phase_eval_ilv, seed))
    paths.update(run("interp", phase_interp, seed))
    for name, fn in (("pack_train", phase_pack_train), ("scale", phase_scale),
                     ("preempt", phase_preempt),
                     ("fast_compile", phase_fast_compile)):
        paths.update(run(name, fn, seed))
    paths.update(run("ddp_train", phase_ddp_train, seed))
    paths.update(run("prefetch", phase_prefetch, seed))
    paths.update(run("srgan_train", phase_srgan_train, seed))
    paths.update(run("multistep", phase_multistep, seed))
    paths.update(run("bench", phase_bench, seed))
    run("train_speed", phase_train_speed, seed)
    say("seconds", **seconds)
    # the card again, beside the results: the phase lines above can
    # outgrow the part of the output a caller keeps
    print(smi, flush=True)
    print(json.dumps(kernels_line(timed, paths)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times [--tree DIR]

The second form only builds and times flash_decode, rwkv6_scan,
rglru_scan and the backwards of flash_attention, rwkv6_scan and rglru_scan
at the points below (one JSON line), importing the port from DIR/src (another
checkout, such as the parent commit's) when ``--tree`` is given, so two
trees' kernels are timed by the same code on one card (a tree whose
kernel modules have no cost functions cannot be timed so: the bounds
call them).
With no arguments:

1. prints the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel of the model paths from the sources in this
   checkout (flash_attention, flash_attention_bwd, flash_decode,
   rwkv6_scan, rwkv6_scan_bwd, rglru_scan, rglru_scan_bwd, matmul_qi8,
   bn_epilogue, dwconv; one nvcc per source, started together), prints
   ptxas's registers and spills of each kernel (failing if flash_decode,
   rwkv6_scan, rglru_scan or any of the three backwards spills) and the
   tensor-core instructions in
   the SASS of bf16 flash_attention, its backward and flash_decode
   (HMMA) and matmul_qi8 (IMMA), failing if any of their instantiations
   has none (the head dim 96 ones named, and the backward's head dim 256
   ones; flash_attention's D 96 instantiations must not spill either);
3. holds each kernel against its plain PyTorch version at the shapes the
   model paths give it (the flash kernels also at recurrentgemma's head dim
   256 with 16 q heads per kv head and at phi3-mini's head dim 96 with 32
   q and kv heads, bf16 and fp32, ragged S, decode lengths ending inside
   a split; flash_attention with recurrentgemma's
   window of 2048 at S = T = 4096; matmul_qi8 exactly at 512^3, ResNet50's
   head, a 1x1 conv and a ragged K; flash_decode with lengths ending
   inside a split, rwkv6_scan with decays of 1e-30 and 1; rglru_scan at
   recurrentgemma's S = 1 decode step at B 2 and 16, at S on both sides
   of its route threshold and of its piece edges, at S = 4096, with
   ragged R in fp32 and bf16 and with decays of 1e-30 and 1, one counted
   launch a call, staged results equal bit for bit to the step route's),
   and times kernel, plain version and, where one exists, one library
   call (the yardstick; the port never calls it; no single PyTorch call
   computes either recurrence), with flash_attention's achieved TFLOP/s
   beside SDPA's (both flash kernels also at D 96), flash_decode also at
   recurrentgemma's full window and beside one torch.sum over as many
   bytes, rwkv6_scan also at S = 1,
   rglru_scan in fp32 and bf16 and at S = 1 (B 2 and 16) beside one
   torch.add over as many bytes; ``bn_epilogue`` (the CNN forward's BN
   with its add and ReLU, no TPU counterpart) equal bit for bit to the
   eager ops at ResNet50's BN shapes (microbatch 32, with and without the
   residual, none / relu / relu6, a ragged C and an offset pointer),
   timed at the largest BN and at a residual block's output beside the
   eager chain and the byte bound, with the host's time a call of the
   wrapper and of the eager chain; ``dwconv`` (the CNN forward's depthwise
   convolution, its SAME pads inside the kernel, no TPU counterpart):
   ptxas's registers and spills of its k 3, 5 and 7 instantiations, the
   kernel within 4 ulp of max |plain| at MobileNetV2's depthwise shapes
   (microbatch 256) and at k 5 and 7, timed at MobileNetV2's expansions 1
   and 2 beside the byte bound, the plain version (F.pad and cuDNN's
   grouped conv2d, the port's route before the kernel: also its
   ``library_ms``) and cuDNN's conv alone on an input padded beforehand,
   with the host's time a call; a MobileNetV2 forward's 17 launches;
4. holds the full model on the card against the same model on the CPU at
   the smoke configs of qwen3-1.7b, rwkv6-1.6b, recurrentgemma-9b and the
   six archs of the LM-families slice (qwen2.5-14b, minitron-4b,
   phi3-mini-3.8b at its head dim 96, granite-moe-1b-a400m,
   phi3.5-moe-42b-a6.6b, qwen2-vl-72b; the CPU runs the plain versions),
   for a prefill forward and for a greedy decode loop through the KV cache
   or the recurrent state;
5. drives the prefill serving path -- the balanced 4-stage plan of
   full-width qwen3-1.7b with random weights from a seed, 8 streamed
   requests of 1024 tokens -- with every kernel's launch count set to 0
   just before and read just after, checks the output against the direct
   forward, and checks that every layer of every forward went through the
   kernel; then the same for full-width granite-moe-1b-a400m (at its
   config's MoE capacity) and phi3-mini-3.8b (head dim 96), each after
   the decode run of the arch before it;
6. drives the decode serving path the same way -- the decode_placement
   4-stage plan of full-width qwen3-1.7b at concurrency 8 and context 2048
   (planned for a device with a quarter of the card's memory per stage),
   16 streams of 1024-token prompts x 64 new tokens through the continuous
   batch -- checks that every decode step's every layer ran flash_decode
   and every prefill's every layer flash_attention, and holds each served
   token of the first streams against the full forward of its stream
   (teacher forcing through the prefill kernel), within the bf16 noise
   measured against an fp32 evaluation; then the same decode path at full
   width in fp32 against its fp32 teacher, within 2e-2; and the same for
   granite-moe-1b-a400m and phi3-mini-3.8b, the MoE served and
   teacher-forced at capacity_factor n_experts / top_k, which drops no
   token (its teacher routes its whole sequence as one group);
7. drives rwkv6-1.6b at full width through the model API (random bf16
   weights from seed 0, after printing its 4-stage balanced plan): 4
   prompts of 1024 tokens prefilled into the recurrent state, then 64
   greedy tokens each, with every kernel's count set to 0 just before and
   read just after (rwkv6_scan: 24 layers x decode calls, the others 0);
   the served tokens are teacher-forced as in 6, and the same loop runs in
   fp32 against its fp32 teacher within 2e-2;
8. drives recurrentgemma-9b at full width the same way (bf16 weights from
   seed 0, plan printed, the weights of 7 freed first): one forward of a
   (2, 1024) batch (26 rglru_scan and 12 flash_attention launches) and a
   decode loop of 16 rows, a 32-token prompt fed token by token plus 32
   greedy tokens at max_len 64 (26 rglru_scan and 12 flash_decode launches
   a step), teacher-forced and repeated in fp32 as in 7;
   then qwen2.5-14b (qkv bias), minitron-4b (relu^2, 256k vocab),
   phi3.5-moe-42b-a6.6b cut to 16 of its 32 layers and qwen2-vl-72b cut
   to 20 of its 80 layers (the cut printed), each at full width through
   the model API and freed before the next: one forward of a (1, 1024)
   batch (qwen2-vl: after 1024 stub patch embeddings from a numpy seed,
   patches on a 32 x 32 M-RoPE grid, text at its index), then
   ``api.prefill`` of it and 16 greedy decode steps, each with exact
   launch counts, the served tokens teacher-forced in bf16 and the loop
   repeated in fp32 with the weights upcast a layer at a time;
9. the encoder-decoder slice: both flash kernels at whisper-tiny's
   shapes (16 clips, 6/6 heads, D 64: the encoder's non-causal S = T =
   1500, the prefill's cross-attention of 448 tokens against 1500 frames,
   the decoder's causal 448; flash_decode over the memory's 1500 rows,
   full and ragged, and over a 448-row self-attention cache) against
   their plain versions in bf16 and fp32 and timed beside SDPA and their
   bounds; whisper's smoke config card vs CPU on a cache built from the
   encoder's memory; then whisper-tiny at full width (random bf16 weights
   from seed 0, plan printed): ``api.forward`` of 16 clips x 1500 stub
   frames (numpy seed) and 448 tokens (12 flash_attention launches),
   ``encode`` and a cache built from its memory, a 4-token prompt token
   by token and 64 greedy tokens (flash_decode = 2 x 4 layers a call),
   each with exact launch counts, the served tokens teacher-forced
   through ``decode_train`` in bf16 against the fp32 evaluation, and the
   loop repeated in fp32;
10. the card's segment memory reporter (``launch/cuda_reporter.py``):
   qwen3-1.7b at full width (batch 1, 1024 tokens), its balanced 4-stage
   cuts measured segment by segment on the card, then planned
   ``balanced`` with the reporter at a budget between the mean and the
   largest measured segment: the cuts before and after, runs, moves,
   convergence and each final segment's measured bytes beside its
   analytic weight bytes (one JSON line); fails unless it moved a cut and
   converged with every segment within the budget;
11. the SPMD tier (``launch/pipeline_spmd.py``, one CUDA stream per
   stage, TF32 off), batch 8 over 4 microbatches through
   ``Deployment.executor(backend="spmd")``: full-width qwen3-1.7b over
   its analytic balanced 4-stage plan (8 x 1024 tokens; fp32 activations
   on its bf16 weights made fp32, the reference's numerics) with every
   kernel's count set to 0 just before a call and read just after
   (flash_attention = layers x microbatches), its logits against the same
   stage bodies run microbatch by microbatch on one stream, and against
   them with flash_attention's plain version in its place, within 1e-4 of
   max |logit| each, and the gap to the bf16 forward printed beside the
   bf16 noise, then batch 7 (padded) and the comp plan's unequal block
   counts, ``pipeline_logits`` in bf16 against ``lm.forward`` (2e-2), and
   flash_attention's fp32 route timed at the microbatch's shape beside
   SDPA in fp32; then
   ResNet50 (analytic balanced and comp plans, batch 8 and 7) and
   MobileNetV2 over C4's balanced cuts [125, 126, 147] (a tensor rides
   through stage 1 as it is), each within 1e-4 of max |y| of the
   direct forward; for qwen3 and ResNet50 the fill and blocked seconds of
   overlapped and serial weight streaming (medians of 5 interleaved
   samples from pinned host copies), modeled vs achieved stage times,
   and items/s of 3 calls beside the host PipelineExecutor on the same
   plan and batch (one JSON line);
12. the training path: the flash-attention backward kernel against its
   plain version (``flash_attention_bwd_ref``) at qwen3-1.7b's training
   shape (8, 16/8, 1024, 128), whisper's encoder (16, 6/6, 1500, 64) and
   cross-attention (S 448, T 1500), recurrentgemma's D 256 group 16 with
   window 2048 at S = T = 4096 and at its training shape (8, 16/1, 1024),
   granite-moe's D 64, phi3-mini's D 96 and a ragged S, bf16 and fp32,
   each gradient within its tolerances (largest deviation and relative
   L2) and equal bit for bit from call to call, the output and lse of the
   forward launch that writes lse against the plain forward, the first
   four timed beside the plain version, SDPA's backward (the yardstick)
   and the bound; both flash kernels at qwen2-vl-72b's training call
   (8, 64/8, 2048, 128) causal bf16 against their plain versions, timed
   beside them, SDPA's forward and backward and their bounds; the scans'
   backward kernels against their plain
   versions (``rwkv6_scan_bwd_ref`` from the piece states of the forward
   kernel's checkpoint epilogue, those states against
   ``rwkv6_scan_states_ref`` and its output equal to the launch without
   it, at rwkv6-1.6b's training shape (8, 32, 1024, 64) in the model
   layout, ragged S, D 16 and 32, S = 1, decays of 1e-30 and 1, bf16;
   ``rglru_scan_bwd_ref`` from the checkpoints of the forward kernel's
   epilogue, those equal bit for bit to the fp32 forward's carries and its
   output to the launch without it, at (8, 1024, 4096), a short S, S = 1,
   ragged R with decays of 1e-30 and 1, bf16; its staged route equal bit
   for bit to its step route), each gradient within its
   tolerances and equal bit for bit from call to call, the training
   shapes timed beside the plain versions and the bound; one train step
   of the smoke configs of qwen3-1.7b, granite-moe-1b-a400m, whisper-tiny,
   rwkv6-1.6b, recurrentgemma-9b and qwen2-vl-72b on the card against the
   CPU (fp32);
   full-width qwen3-1.7b, granite-moe-1b-a400m, rwkv6-1.6b,
   recurrentgemma-9b cut to 6 of
   its 38 layers and qwen2-vl-72b cut to 3 of its 80 (bf16 weights from
   seed 0, remat) each trained 1 + 5 steps of 8 x 1024 tokens (qwen2-vl:
   after its 1024 stub patches), the update functional as the driver's
   but where ``launch/steps.py``'s ``donate_update`` says it does not fit
   (qwen2-vl: written into the state; qwen3's donated update held bit for
   bit against the functional one once), from ``launch/train.py``'s
   ``step_batch`` in loss chunks of its
   ``loss_chunk``, with every kernel's count set to 0 just before a step
   and read just after
   (flash_attention = 2 x 28, flash_attention_bwd = 28; 2 x 24 and 24;
   rwkv6_scan = 2 x
   24, rwkv6_scan_bwd = 24; rglru_scan = 8, rglru_scan_bwd = 4,
   flash_attention = 4, flash_attention_bwd = 2; flash_attention = 6,
   flash_attention_bwd = 3): loss, grad_norm, lr, step time, tokens/s,
   the share of the bf16 peak (the step's FLOPs counted by
   ``launch/op_analysis.py`` on the meta device, ``train_step_flops``'s
   hand formula beside them with its excess named), the allocator's peak
   and its retries; one
   step's loss and gradients against the same step with the plain
   versions in the kernels' places (qwen2-vl: the plain steps over 4
   slices of 2 of its 8 rows, averaged), in bf16 beside the bf16 noise (the plain bf16 step against the
   plain step on the weights made fp32) and in fp32; qwen3-1.7b's
   full-width train state (17.2 GB) checkpointed through
   ``checkpoint/store.py`` with a blocking save into a temporary
   directory and restored (bytes, save_s, restore_s, GB/s; the free disk
   checked first), the step from the restored state bit-equal to the
   step from the live one; the dry-run cell
   table on one card (``launch/dryrun.py --all --mesh 1x1 --no-count``:
   each cell's device bytes and fit), launch/mesh.py's memory constant
   against the card's, ``train_state_shapes``'s bytes against the
   allocator's for qwen3-1.7b and the cut qwen2-vl (within 512 bytes a
   tensor), and the cut qwen2-vl's modeled device bytes at (8, 2048)
   beside its step's allocator peak; the dry run's measured record
   (``dryrun.measure_cell``) of MEASURED's three cells at full width,
   every layer (qwen3-1.7b and granite-moe-1b-a400m at ``train_4k`` cut
   to 8 x 1024, qwen3-1.7b at ``decode_32k`` cut to 8 rows and a cache of
   2048): warm-up and step times, the allocator's stats, the device
   window, the counted fields and roofline terms, failing unless the
   card's count equals the meta count op for op and the kernels launched
   as MEASURED says (one JSON line); and the reference's fault-tolerance demo
   (``examples/train_lm.py``'s config, 200 steps, a failure at step 77)
   and the same on rwkv6-1.6b's smoke config (60 steps, a failure at step
   25) through ``launch/train.py`` (one JSON line);
13. the paper's CNN path (fp32, TF32 off): all 21 Table-1 models and
   synthetic_cnn(64) at their published input sizes, one forward each on
   the card against the CPU, with one ``bn_epilogue`` launch for each of
   the forward's fused groups and one ``dwconv`` launch for each
   depthwise convolution; ResNet50 planned by the analytic Edge TPU
   model (balanced, 4 stages) and served through ``cnn_stage_fns`` (64
   single-image requests), then profiled depth by depth on the card and
   re-planned from that trace (balanced_cost, ``trace:``) for the
   reference's Edge TPU and for a quarter of the card's memory a stage,
   the three plans served in turn twice, each served output equal to the
   direct forward;
   then the int8 API on ResNet50's head (``quantized_dense``, 1
   matmul_qi8 launch between a reset and a read of the counts);
14. the fault-tolerance tier on ResNet50 (the weights of 13): the placement
   DP's 4-stage cut with its two slowest modeled stages on a second
   device each (6 devices), served through ``cnn_stage_fns`` with
   stage-loss retries, hedging and a ``HealthMonitor`` while a
   ``ChaosMonkey`` kills one replica of each replicated stage and then
   the last replica of the second; the monitor replans the survivors
   through ``ElasticPlanner`` and hot-swaps.  64 requests 15 ms apart: 0
   lost, 0 misordered, every output equal to the direct forward;
15. full-width qwen3-1.7b prefill through ``serve.run`` with
   ``--device-budget 6 --stage-loss-retries 1``, hedging after three
   bottleneck-stage times of 5 and a deadline no request reaches: the
   first output within 2e-2 of the direct forward, flash_attention's
   launches equal to layers x forwards plus the layers of every hedged
   stage execution the executor reports;
16. self-healing on ResNet50: the analytic 4-stage plan served under
   ``dep.self_heal(canaries)``, a ``tick()`` after each of 12 batches of
   8 requests (deterministic in windows): each window's req/s, per-item
   stage busy, drift and state, the controller's commits, rollbacks and
   events, the live trace's per-stage times beside the card trace's (the
   ``vs trace`` form); then the plan the live trace gives, its canary
   cold and warm and the stream served over it and the incumbent in
   turns; every output equal to the direct forward;
17. a fleet of ResNet50 (share 3) and MobileNetV2 (share 1) over 6
   devices, each member served through ``cnn_stage_fns``: 4 windows of
   share-proportional traffic, then 4 with ResNet50's load tripled, the
   autoscaler ticked after each window: the pool split before and after,
   its events, attainment and the audit (0 lost, 0 misordered, every
   output equal to its member's direct forward); the phases 14 to 17
   launch no hand-written kernel but the prefill's flash_attention and
   the CNN forwards' bn_epilogue and dwconv (uncounted there);
18. prints one JSON line of CNN results, one of the fault-tolerance,
   self-healing and fleet results, one of kernel results, then, as the
   last line, ``{"ok": true, "device": {...}}``.

Any failed phase raises and exits non-zero.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
import contextlib
import dataclasses
import inspect
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time
import unittest.mock
import warnings

# recurrentgemma-9b's train step (6 of 38 layers) holds about 66 GiB of
# tensors at its peak, of the card's 79; the caching allocator's
# fixed-size segments can leave 13 GiB of it reserved in pieces too small
# for the optimizer's 3.9 GiB fp32 temporaries of the tied embedding.
# Expandable segments grow and map instead (read at the first CUDA
# allocation; a value the caller set is kept).
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel

ROOT = pathlib.Path(__file__).resolve().parent
# --tree DIR: the port is imported from DIR/src instead of this checkout's
TREE = (pathlib.Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()
        if "--tree" in sys.argv[:-1] else ROOT)
sys.path.insert(0, str(TREE / "src"))

from repro_torch import configs  # noqa: E402  (needs src/ on the path)
from repro_torch.api import (Deployment, DeploymentSpec,  # noqa: E402
                             deploy, plan)
from repro_torch.configs.common import concrete_batch  # noqa: E402
from repro_torch.core.edge_tpu_model import EdgeTPUSpec  # noqa: E402
from repro_torch.core.pipeline import (PipelineExecutor,  # noqa: E402
                                       stage_balance_metrics)
from repro_torch.core.placement import PlacementPlan  # noqa: E402
from repro_torch.decode.engine import PipelineDecodeEngine  # noqa: E402
from repro_torch.fleet import (FleetMemberSpec, FleetSpec,  # noqa: E402
                               deploy_fleet)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bn_epilogue as be  # noqa: E402
from repro_torch.kernels import dwconv as dw  # noqa: E402
from repro_torch.kernels import ref as kernel_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import matmul_qi8 as mq  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref, flash_decode_ref,
    matmul_qi8_ref, rglru_scan_bwd_ref, rglru_scan_ref, rwkv6_scan_bwd_ref,
    rwkv6_scan_ref)
from repro_torch.core.segmentation import segment_ranges  # noqa: E402
from repro_torch.checkpoint.store import (tree_flatten,  # noqa: E402
                                         tree_map, tree_unflatten)
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.launch import (pipeline_spmd, profile_serve,  # noqa: E402
                                serve)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as card_mesh  # noqa: E402
from repro_torch.launch import steps as train_steps  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_update  # noqa: E402
from repro_torch.optim.adamw import PIECE  # noqa: E402
from repro_torch.launch.cuda_reporter import (  # noqa: E402
    CudaSegmentReporter)
from repro_torch.models import (api, cnn, layers, lm,  # noqa: E402
                                lm_graph, rglru, rwkv6, whisper)
from repro_torch.profiling import profile_model  # noqa: E402
from repro_torch.runtime import (ChaosEvent, ChaosMonkey,  # noqa: E402
                                 ElasticPlanner, FaultPolicy,
                                 HealthMonitor)

KERNELS = ("flash_attention", "flash_attention_bwd", "flash_decode",
           "rwkv6_scan", "rwkv6_scan_bwd", "rglru_scan", "rglru_scan_bwd",
           "matmul_qi8")
# the kernels --kernel-times builds and times (the latest redesigns)
TIMED = ("flash_decode", "rwkv6_scan", "rglru_scan", "flash_attention_bwd",
         "rwkv6_scan_bwd", "rglru_scan_bwd")
# kernels whose ptxas report must show no spill
NO_SPILL = TIMED
# each kernel's design, as its source note sets it out
DESIGNS = {
    "flash_attention": "bf16: mma.sync m16n8k16 (fp32 accumulate), "
                       "ldmatrix / ldmatrix.trans, cp.async 2-stage K/V "
                       "ring (one barrier a tile), P in registers, 4 warps "
                       "x 16 q rows, heavy and light causal tiles paired "
                       "on each SM; fp32: CUDA cores, 64 x 64 tiles, 256 "
                       "threads",
    "flash_attention_bwd": "three launches (four at D 256), no atomics "
                           "(deterministic): "
                           "D = rowsum(P * dP) over the recomputed fp32 P; "
                           "bf16 at every head dim on mma.sync m16n8k16, "
                           "cp.async 2-stage rings: D one block per (64-row "
                           "q tile, q head, batch); dK/dV one block per "
                           "(64-key block, kv head, batch), a warp 16 keys, "
                           "over its group's q heads and visible query "
                           "tiles, P and dS rounded to bf16 in registers as "
                           "A operands; from D 96 dS^T stored as bf16 "
                           "tiles in a band per q tile and dQ one block per "
                           "(q tile, q head, batch) as dS K over them in key "
                           "order, no S or dP recomputed (D <= 64: dQ "
                           "recomputes S and dP); D 256: 32-key blocks, dV "
                           "in registers, then a second sweep of dK over "
                           "the stored dS^T, a kv head's q heads split over "
                           "4 blocks whose fp32 dK/dV parts a fourth launch "
                           "sums in order; fp32: CUDA cores, 256 threads, "
                           "dQ recomputing S and dP",
    "flash_decode": "bf16: mma.sync m16n8k16 (fp32 accumulate), one block "
                    "of 4 warps per (split, kv head, row) serving up to 16 "
                    "q heads, a cp.async ring per warp of 16-key tiles, P "
                    "in registers, splits from the SM count cut each row's "
                    "length, a combine pass; fp32: CUDA cores, 16-byte row "
                    "slices",
    "rwkv6_scan": "CUDA cores: 256 threads per (head, row), the state split "
                  "over 256 / D threads a column (a warp on one part, y's "
                  "partial sums through shared memory), rows staged 64 "
                  "steps a chunk by cp.async, double-buffered",
    "rglru_scan": "CUDA cores: S >= 64 on the staged route, one block of "
                  "256 threads per (128-byte tile row, batch row) copying "
                  "S in 64-step pieces by 16-byte cp.async, 3 in flight, "
                  "one thread a channel scanning each piece in order out "
                  "of shared memory; S < 64 (the decode step) one thread "
                  "per channel; both routes the same FMAs in the same "
                  "order; under autograd an epilogue writes the fp32 "
                  "carry every 64 steps",
    "rwkv6_scan_bwd": "CUDA cores: starts each 8-step piece from the "
                      "state the forward's checkpoint epilogue wrote; each "
                      "(head, row) split over D / 16 blocks of 16 state "
                      "columns, 2 threads a row, a thread holding 8 "
                      "columns of S and of G and the piece's 8 recomputed "
                      "states in registers; the blocks of a (head, row) a "
                      "thread block cluster: dr, dk, dw (and v . dy) summed "
                      "over its blocks' parts in rank order through "
                      "distributed shared memory after each round of two "
                      "pieces, dv by a reduce-scatter over a warp's rows "
                      "and a fixed-order sum over the warps; three "
                      "barriers a round; r, k, w rows, the block's v and "
                      "dy columns and checkpoint columns double-buffered "
                      "by cp.async; du summed over the batch by a second "
                      "launch; no atomics, no division by a decay",
    "rglru_scan_bwd": "CUDA cores: starts each 64-step piece from the "
                      "carry the forward's checkpoint epilogue wrote; one "
                      "block of 256 threads per (128-byte tile row, batch "
                      "row) walking the pieces from the last, a, g, dy and "
                      "the checkpoint row staged by 16-byte cp.async, the "
                      "next piece in flight; one thread a channel recomputes "
                      "the piece's carries into registers with the "
                      "forward's FMAs, walks it backwards writing da and "
                      "dg over the staged tiles, stored by 16-byte "
                      "stores; rows off 16 bytes one thread per channel; "
                      "no y read, no scratch",
    "matmul_qi8": "mma.sync m16n8k32 s8 -> s32, cp.async 2-stage x ring, w "
                  "transposed by prmt on load, 64 x 64 or 16 x 64 tiles, "
                  "split-K with int32 atomics",
    "bn_epilogue": "one pass: 16-byte loads and stores, 2 chunks a thread "
                   "loaded before any is computed, per-channel values "
                   "through the read-only cache; a scalar route for C % 4 "
                   "or a misaligned pointer; the eager chain's rounding",
    "dwconv": "SAME pads as offsets, no padded copy: a block stages its "
              "chunk of channel quads' taps tap-major in shared memory; a "
              "thread owns 4 channels (16-byte loads and stores) and a strip "
              "of 8 output columns (4 at stride 2 or k 5 and 7), loads each "
              "input row's window before its FMAs; halo rows and strip "
              "overlaps re-read from L1 and L2; the BN and ReLU / ReLU6 "
              "after it, where its group takes them, in an epilogue on the "
              "accumulators (bn_epilogue.cuh's arithmetic, the per-channel "
              "values loaded after the tap loop)",
}
# the hand-written kernels of the CNN forward: no TPU counterpart, and not
# in KERNELS, whose counts the LM and serving phases pin
EPILOGUE = "bn_epilogue"
DWCONV = "dwconv"
DWCONV_BN = "dwconv.bn"         # dwconv's launches with the BN epilogue

ARCH = "qwen3-1.7b"
SEQ = 1024
REQUESTS = 8
STAGES = 4
# the decode run: slots x context of the plan, streams x new tokens
DECODE_SLOTS = 8
DECODE_CONTEXT = 2048
DECODE_STREAMS = 16
DECODE_NEW = 64
TEACHER_STREAMS = 4
TEACHER_TOL = 2e-2
TEACHER_AGREE = 0.9     # share of served bf16 tokens = the teacher's argmax
# fewest positions where bf16 resolves the teacher's argmax (the recurrent
# families' agreement rule counts only those; fewer fails the check)
TEACHER_MIN_DECISIVE = 24
# per-slot lengths of the kernel check: empty, one, block edges, ragged,
# the path's range, full
DECODE_LENS = [0, 1, 127, 128, 1000, 1088, 2047, 2048]
# the timed point: every slot mid-stream of the decode run (1024-token
# prompts, 1 to 64 generated tokens)
DECODE_TIMED_LEN = 1056
COLD_SETS = 8           # distinct cache sets the kernel timing rotates over
BACKLOG_CYCLES = 100_000_000    # ~50 ms of device sleep while the host queues
# the recurrent families' runs
RWKV_ARCH = "rwkv6-1.6b"
RWKV_STREAMS = 4
RWKV_PROMPT = 1024
RWKV_NEW = 64
GEMMA_ARCH = "recurrentgemma-9b"
GEMMA_FORWARD = (2, 1024)       # batch, tokens of the timed forward
GEMMA_ROWS = 16         # decode rows: enough served tokens that bf16
                        # resolves the argmax at TEACHER_MIN_DECISIVE of them
GEMMA_PROMPT = 32
GEMMA_NEW = 32
GEMMA_MAX_LEN = 64
# recurrentgemma's windowed prefill above local_window: B, Hq, Hkv, S = T,
# D, window
WINDOWED = (1, 16, 1, 4096, 256, 2048)
# matmul_qi8: 512^3 (benchmarks/kernel_bench.py); ResNet50's head as a GEMM
# (the int8 path's shape: 8 images x 2048 features x 1000 classes); a 1x1
# conv as a GEMM (8 x 56 x 56 pixels, 64 -> 256 channels); a ragged K
QI8_SHAPES = ((512, 512, 512), (8, 2048, 1000), (8 * 56 * 56, 64, 256),
              (1000, 30, 300))
QI8_HEAD = (8, 2048, 1000)
# bn_epilogue: ResNet50's BN outputs at the benchmark's microbatch of 32
# (each C and spatial size), then a ragged C; timed at the largest BN
# (bn+relu) and at a residual block's output (bn+add+relu)
BN_SHAPES = ((32, 112, 112, 64), (32, 56, 56, 64), (32, 56, 56, 256),
             (32, 28, 28, 128), (32, 28, 28, 512), (32, 14, 14, 256),
             (32, 14, 14, 1024), (32, 7, 7, 512), (32, 7, 7, 2048),
             (4, 9, 9, 30))
BN_TIMED = (((32, 112, 112, 64), False), ((32, 56, 56, 256), True))
HOST_CALLS = 50         # calls a host-time sample issues while the card sleeps
# dwconv: MobileNetV2's depthwise convolutions at the benchmark's microbatch
# of 256 (N, H, W, C, k, stride), checked against the plain ops; timed at
# its expansion 1 (the largest input, stride 2) and expansion 2 (stride 1)
DW_SHAPES = ((256, 112, 112, 32, 3, 1), (256, 112, 112, 96, 3, 2),
             (256, 56, 56, 144, 3, 1), (256, 56, 56, 144, 3, 2),
             (256, 28, 28, 192, 3, 1), (256, 28, 28, 192, 3, 2),
             (256, 14, 14, 384, 3, 1), (256, 14, 14, 576, 3, 1),
             (256, 14, 14, 576, 3, 2), (256, 7, 7, 960, 3, 1),
             (8, 111, 111, 32, 5, 2), (8, 56, 56, 44, 5, 1),
             (8, 15, 15, 16, 7, 1))
DW_TIMED = ((256, 112, 112, 96, 3, 2), (256, 56, 56, 144, 3, 1))
DW_ULPS = 4             # kernel vs plain ops, of max |plain| (sum order)
# the CNN path: the analytic plan of paper Table 5 / examples/quickstart.py,
# then the same model planned from its own trace on the card
CNN = "ResNet50"
CNN_REQUESTS = 64
CNN_ROUNDS = 2          # every plan served in turn, twice: host noise shows
CNN_TOL = 1e-4          # card vs CPU forward, relative to max |y|
# the fault-tolerance, self-healing and fleet phases (ResNet50's weights of
# the CNN path, fp32): devices of the replicated plan and of the fleet's
# pool; the chaos stream's spacing and kill times (two replicas, then the
# last replica of one stage); a heartbeat timeout far above any stage time
FT_BUDGET = 6
FT_INTERVAL_S = 0.015
FT_KILL_AT_S = (0.15, 0.30, 0.45)
FT_HEARTBEAT_S = 10.0
FT_HEDGE_X = 3          # hedge after this many bottleneck-stage times
FT_DEADLINE_MS = 60_000.0       # a deadline no request should reach
# self-healing: batches of the stream, one tick() after each
HEAL_BATCHES = 12
HEAL_BATCH = 8
HEAL_CANARIES = 4
HEAL_DRIFT = 0.3
# the fleet: (member, Table-1 model, share, p95 SLO ms), windows a phase
FLEET = (("resnet50", "ResNet50", 3.0, 100.0),
         ("mobilenetv2", "MobileNetV2", 1.0, 50.0))
FLEET_WINDOWS = 4
FLEET_POOL = 16         # distinct images a member's requests cycle over
# H100 SXM data-sheet peaks (dense): bf16 tensor cores (launch/mesh.py's),
# fp32 CUDA cores, int8 tensor cores, HBM3 (launch/mesh.py's)
PEAK_FLOPS = {torch.bfloat16: card_mesh.PEAK_FLOPS_BF16, torch.float32: 67e12,
              torch.int8: 1979e12}
HBM_BYTES_PER_S = card_mesh.HBM_BW
# the LM-families slice: phi3-mini (head dim 96) and granite-moe served at
# full width as qwen3; their smoke configs and those of the other new archs
# card vs CPU; four archs through the model API, two cut in depth to fit
# the card in bf16 (phi3.5-moe 83.7 GB, qwen2-vl 145.4 GB at full depth)
D96_ARCH = "phi3-mini-3.8b"
MOE_ARCH = "granite-moe-1b-a400m"
FAMILY_SMOKE = ("qwen2.5-14b", "minitron-4b", "phi3-mini-3.8b",
                "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
                "qwen2-vl-72b")
API_RUNS = (("qwen2.5-14b", None), ("minitron-4b", None),
            ("phi3.5-moe-42b-a6.6b", 16), ("qwen2-vl-72b", 20))
API_PROMPT = 1024       # tokens of the forward (vlm: after its patches)
API_STEPS = 16          # greedy decode steps after the prefill's token
API_MIN_DECISIVE = 4    # of the 17 served tokens (one row; the rule of
                        # TEACHER_MIN_DECISIVE)
VLM_GRID = 32           # qwen2-vl's 1024 stub patches on a 32 x 32 grid
# the encoder-decoder slice: whisper-tiny at full width, 16 clips of its
# 1500 stub frame embeddings and its published decoder context of 448
# tokens; a 4-token prompt fed token by token, then 64 greedy tokens
WHISPER_ARCH = "whisper-tiny"
WHISPER_CLIPS = 16
WHISPER_TOKENS = 448
WHISPER_PROMPT = 4
WHISPER_NEW = 64
# its flash_attention calls (name, S, T, causal) and flash_decode calls
# (name, T, valid length), 16 clips x 6/6 heads x D 64
WHISPER_FA = (("encoder", 1500, 1500, False), ("cross", 448, 1500, False),
              ("decoder_self", 448, 448, True))
WHISPER_FD = (("cross", 1500, 1500), ("self", 448, 448))
# the segment memory reporter's refine: qwen3-1.7b at full width, batch 1
REPORTER_SEQ = 1024
# the SPMD tier: batch 8 over 4 microbatches on the 4 stage streams of the
# card (qwen3-1.7b 8 x 1024 tokens, ResNet50 and MobileNetV2 8 images);
# interleaved fill samples of each issue order; served calls of each
# executor (served throughput moves between calls on unchanged code)
SPMD_BATCH = 8
SPMD_M = 4
SPMD_FILL_REPS = 5
SPMD_CALLS = 3
SPMD_TOL = 1e-4         # relative to max |logit| or max |y| (fp32)
# the SPMD tier over four cards, one stage a card (the reference's mesh):
# phi3.5-moe-42b-a6.6b at full depth, which no card holds (83.7 GB of bf16
# weights, 167.5 GB in the executor's fp32; about 42 GB a card), made on
# card 0 a block at a time and kept on the host; its first CARDS_CHECK
# layers (fp32 42 GB, which card 0 holds alone) against lm.forward there;
# ResNet50 over the same cards.  Runs where CARDS cards are visible
# (``--spmd-cards`` runs it alone)
CARDS = 4
CARDS_ARCH = "phi3.5-moe-42b-a6.6b"
CARDS_CHECK = 8
# the launchers' per-device shared-memory setup, each kernel on every card
# at a shape above 48 KB of dynamic shared memory (flash_decode bf16 D 128
# 108 KB; the scans' staged routes), against its plain version there: the
# forwards within tol (1 + |plain|), the backwards within tol of each
# gradient's scale and BWD_L2_TOL
CARD_KERNEL_TOL = {"flash_attention": 1e-4, "flash_decode": 2e-2,
                   "rwkv6_scan": 2e-4, "rwkv6_scan_bwd": 2e-4,
                   "rglru_scan": 1e-5, "rglru_scan_bwd": 1e-4}
# the training path: the backward kernel's shapes (name, B, Hq, Hkv, S, T,
# D, causal, window), in bf16 and fp32, the first four also timed (and by
# --kernel-times);
# its tolerances per gradient: the largest deviation, of max(1, max
# |plain|) (fp32: summation order; bf16: one rounding of each gradient),
# and the relative L2 error ||g - e|| / ||e||, which a wrong bulk of rows
# moves even where causal attention's first rows set the scale (bf16: the
# kernel also rounds P and dS to bf16 for the tensor cores); the forward's
# output of the launch that writes lse, within the forward's tolerance
BWD_SHAPES = (
    ("qwen3-1.7b (8, 16/8, 1024, 128) causal", 8, 16, 8, 1024, 1024, 128,
     True, None),
    ("whisper encoder (16, 6/6, 1500, 64)", 16, 6, 6, 1500, 1500, 64, False,
     None),
    ("recurrentgemma (1, 16/1, 4096, 256) window 2048", 1, 16, 1, 4096,
     4096, 256, True, 2048),
    ("recurrentgemma training (8, 16/1, 1024, 256) window 2048", 8, 16, 1,
     1024, 1024, 256, True, 2048),
    ("granite-moe (8, 16/8, 1024, 64) causal", 8, 16, 8, 1024, 1024, 64,
     True, None),
    ("phi3-mini (2, 32/32, 1024, 96) causal", 2, 32, 32, 1024, 1024, 96,
     True, None),
    ("whisper cross (16, 6/6, S 448, T 1500, 64)", 16, 6, 6, 448, 1500, 64,
     False, None),
    ("ragged (2, 16/8, 1000, 128) causal", 2, 16, 8, 1000, 1000, 128, True,
     None),
)
BWD_TIMED = 4
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
BWD_L2_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
FWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the scans' backward kernels against their plain versions, each gradient
# within BWD_TOL of its scale and BWD_L2_TOL relative L2 (fp32: summation
# order; bf16: one rounding of each gradient), the first case of each (the
# training shape, fp32) and its bf16 case timed: rwkv6_scan_bwd (name, B,
# H, S, D, dtype, the model's (B, S, H, D) layout, decays 1e-30 and 1 on
# alternate steps), rglru_scan_bwd (name, B, S, R, dtype, decays 1e-30 and
# 1)
RWKV_BWD_CASES = (
    ("fp32 rwkv6-1.6b training (8, 32, 1024, 64), model layout", 8, 32,
     1024, 64, torch.float32, True, False),
    ("fp32 ragged S=300, model layout", 2, 32, 300, 64, torch.float32,
     True, False),
    ("fp32 D=32 S=257", 2, 4, 257, 32, torch.float32, False, False),
    ("fp32 D=16 S=100, model layout", 2, 4, 100, 16, torch.float32, True,
     False),
    ("fp32 S=1, model layout", 4, 32, 1, 64, torch.float32, True, False),
    ("fp32 S=300, decays 1e-30 and 1, model layout", 2, 32, 300, 64,
     torch.float32, True, True),
    ("bf16 (8, 32, 1024, 64), model layout", 8, 32, 1024, 64,
     torch.bfloat16, True, False),
    ("bf16 D=16 S=70", 2, 4, 70, 16, torch.bfloat16, False, False),
)
RGLRU_BWD_CASES = (
    ("fp32 recurrentgemma-9b training (8, 1024, 4096)", 8, 1024, 4096,
     torch.float32, False),
    ("fp32 short S=40", 2, 40, 4096, torch.float32, False),
    ("fp32 S=1", 2, 1, 4096, torch.float32, False),
    ("fp32 ragged R=1000 S=300, decays 1e-30 and 1", 3, 300, 1000,
     torch.float32, True),
    ("bf16 (8, 1024, 4096)", 8, 1024, 4096, torch.bfloat16, False),
    ("bf16 ragged R=1001 S=77, decays 1e-30 and 1", 2, 77, 1001,
     torch.bfloat16, True),
)
# the smoke configs' train step card vs CPU (fp32, TF32 off): batch, tokens,
# loss chunk, and the tolerance of loss, grad_norm and every updated
# parameter (relative to max(1, max |CPU|))
TRAIN_SMOKE = ("qwen3-1.7b", "granite-moe-1b-a400m", "whisper-tiny",
               "rwkv6-1.6b", "recurrentgemma-9b", "qwen2-vl-72b")
TRAIN_SMOKE_SHAPE = (2, 64, 32)
TRAIN_SMOKE_TOL = 1e-4
# full-width qwen3-1.7b: batch x SEQ tokens from SyntheticLMDataset, the
# loss in chunks of launch/train.py's loss_chunk (512), 1 warm-up + 5 timed
# steps of the train step; the
# driver's AdamW (lr 1e-3, 10 warm-up steps); the step against the same
# step with the plain versions: loss within 1e-3 relative, each gradient
# leaf's relative L2 error within 2e-2 in bf16 (where bf16 resolves the
# leaf; see check_against_plain) and, on the weights made fp32, within 1e-4
# rwkv6-1.6b trains at full width, recurrentgemma-9b at full width cut to
# its first 6 of 38 layers (2 super-blocks: AdamW's state of all 38 alone
# exceeds 80 GB); qwen2-vl-72b at full width cut to its first 3 of 80
# layers (the deepest whose step runs without the allocator running out:
# 5.1e9 parameters, 51 GB of bf16 weights and fp32 moments, a 71.8 GB
# peak of the card's 85.0; at 4 layers, 60 GB of state, the peak reached
# 80.2 GB and the allocator retried 4 times, steps of 1.6 to 3.2 s), SEQ
# text tokens after its 1024 stub patches; a step's update written into the
# state only where launch/steps.py's donate_update says the functional one
# does not fit (the vlm), and qwen3-1.7b's functional update held against
# the donated one; in the vlm's check against the plain versions, the
# plain steps run over slices of VLM_CHECK_ROWS rows (the plain
# attention's fp32 scores of all 8 rows do not fit beside its weights),
# their losses and gradients averaged on the host, against the kernels'
# steps over all 8 rows
TRAIN_BATCH = 8
GEMMA_TRAIN_LAYERS = 6
VLM_ARCH = "qwen2-vl-72b"
VLM_TRAIN_LAYERS = 3
VLM_CHECK_ROWS = 2
# both flash kernels at qwen2-vl-72b's training call: B, Hq, Hkv, S = T, D
# (1024 patches + 1024 text tokens, causal, bf16)
VLM_ATTN = (8, 64, 8, 2048, 128)
# the allocator rounds every tensor up to this many bytes
ALLOC_ROUND = 512
TRAIN_STEPS = 5
TRAIN_LR = 1e-3
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# the moe family's fp32 check replays the plain step's top-k choices
# (RoutingReplay); the kernels' step may choose otherwise on at most this
# share of them, ties within rounding (granite-moe-1b-a400m: 10 of 3145728)
MAX_FLIPPED_SHARE = 1e-5
# the reference's fault-tolerance demo (examples/train_lm.py): qwen3's smoke
# config at 2 layers, d_model 128, d_ff 256, fp32; steps, batch, seq, lr,
# warm-up, checkpoint interval, the injected failure
FT_DEMO = {"steps": 200, "batch": 8, "seq": 64, "lr": 3e-3, "warmup": 20,
           "ckpt_every": 50, "fail_at": 77}
# the same through launch/train.py on rwkv6-1.6b's smoke config (4 layers,
# d 64)
RWKV_FT_DEMO = {"steps": 60, "batch": 8, "seq": 64, "lr": 3e-3,
                "warmup": 10, "ckpt_every": 20, "fail_at": 25}
# the dry run's measured cells (launch/dryrun.py measure_cell), at full
# width with every layer: arch, shape, rows, sequence (decode: the cache's
# length, one token a row), the kernels' launches a step
MEASURED = (("qwen3-1.7b", "train_4k", 8, 1024,
             {"flash_attention": 56, "flash_attention_bwd": 28}),
            ("granite-moe-1b-a400m", "train_4k", 8, 1024,
             {"flash_attention": 48, "flash_attention_bwd": 24}),
            ("qwen3-1.7b", "decode_32k", 8, 2048, {"flash_decode": 28}))
CARD = "cuda"
D96_TAG = "ILi96E"      # a mangled template argument of 96 (the head dim)
D256_TAG = "ILi256E"
# bf16 kernels of one head dim: the forward's with and without the lse
# epilogue, the backward's D, dK/dV and dQ, flash_decode's one
BF16_KERNELS = {"flash_attention": 2, "flash_attention_bwd": 3,
                "flash_decode": 1}


def cuda_ms(fns, reps=20, backlog=True):
    """Mean time of one call over ``reps`` calls that rotate over ``fns``
    (one function: L2-warm inputs, as the prefill path's just-written
    projections; several, each on its own inputs together larger than the
    50 MB L2: reads from HBM, as on the decode path), after one warm-up
    round.  ``backlog``: the card first sleeps while the host enqueues
    every call, so the events time the device alone; else the calls run
    as the host issues them (a call's host time bounds it)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if backlog:
        torch.cuda._sleep(BACKLOG_CYCLES)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tensor_core_ops(path, op, kernel):
    """SASS instructions ``op`` (HMMA, IMMA) in each function of the built
    library at ``path`` whose name holds ``kernel``, by ``cuobjdump
    -sass``: name -> count."""
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return {fn.split("\n", 1)[0].strip(): len(re.findall(rf"\s{op}\.", fn))
            for fn in sass.split("Function : ")[1:]
            if kernel in fn.split("\n", 1)[0]}


def ptxas_spills(log):
    """Spill store bytes of each entry function in a ``-Xptxas -v`` log."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn is not None:
            out[fn] = int(m.group(1))
    return out


def cost_bound(cost, dtype):
    """Least time (ms) of a call of ``cost`` = (operations, bytes), a
    kernel's cost function (the one each wrapper reports to
    ``launch/op_analysis.py``): the larger of its operations over the
    peak rate of ``dtype`` and its bytes over HBM bandwidth; and which of
    the two bounds it."""
    flops, nbytes = cost
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(q, k, causal, window=None):
    """Least time (ms) for one flash-attention call on these inputs: q/k/v
    read and o written once over HBM bandwidth, against 4*D flops per
    unmasked (query, key) pair over the peak rate of the input type."""
    return cost_bound(fa.attention_cost(q, k, causal, window), q.dtype)


def attention_inputs(b, hq, hkv, s, t, d, dtype, model_layout=False):
    """Random q/k/v on the card; ``model_layout`` makes them (B, H, S, D)
    views of (B, S, H, D) tensors, as the model's projections are."""
    g = torch.Generator("cuda").manual_seed(0)
    out = []
    for h, n in ((hq, s), (hkv, t), (hkv, t)):
        if model_layout:
            x = torch.randn(b, n, h, d, generator=g, device="cuda",
                            dtype=dtype).transpose(1, 2)
        else:
            x = torch.randn(b, h, n, d, generator=g, device="cuda",
                            dtype=dtype)
        out.append(x)
    return out


def tflops(q, k, ms, window=None, causal=True):
    """Achieved TFLOP/s of a call that took ``ms``: the bound's operation
    count over the time."""
    return fa.attention_cost(q, k, causal, window)[0] / (ms * 1e-3) / 1e12


def sdpa_call(q, k, v, causal=True):
    """One SDPA call computing flash_attention on these inputs, and the
    name of its backend.  bf16: the default dispatch.  fp32 (TF32 off):
    the memory-efficient backend (fp32-accurate tensor-core GEMMs) where
    it takes the inputs, else the math one; its output is held against
    the plain version within 1e-4.  SDPA's causal mask is top-left
    aligned, so a causal S < T call is timed only at S = T (every causal
    shape timed here)."""
    def call(backend=None):
        if backend is None:
            return lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)

        def fn():
            with sdpa_kernel(backend):
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True)
        return fn

    if q.dtype != torch.float32:
        return call(), "default"
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("SDPA in fp32 is timed with TF32 off")
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        fn = call(backend)
        try:
            with warnings.catch_warnings():     # a refusal warns, then raises
                warnings.simplefilter("ignore", UserWarning)
                got = fn()
        except RuntimeError:        # the backend does not take the inputs
            continue
        err = (got - flash_attention_ref(q, k, v, causal)).abs().max().item()
        if err > 1e-4:
            raise SystemExit(f"SDPA ({backend.name}) in fp32 disagrees with "
                             f"the plain version: {err:.3e} > 1e-4")
        return fn, backend.name
    raise SystemExit("no SDPA backend takes these fp32 inputs")


def time_attention(q, k, v, causal=True):
    """Kernel, plain version and SDPA (:func:`sdpa_call`) (ms), and the
    bound, on one input."""
    ms = cuda_ms([lambda: fa.flash_attention(q, k, v, causal=causal)])
    plain_ms = cuda_ms([lambda: flash_attention_ref(q, k, v, causal)])
    sdpa, backend = sdpa_call(q, k, v, causal)
    library_ms = cuda_ms([sdpa])
    bound_ms, bound_by = attention_bound(q, k, causal=causal)
    return {"ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_backend": backend,
            "tflops": tflops(q, k, ms, causal=causal),
            "library_tflops": tflops(q, k, library_ms, causal=causal)}


def check_flash_attention():
    """Kernel vs plain version at the prefill path's widths (Hq 16, Hkv 8,
    D 128), at recurrentgemma's (Hq 16, Hkv 1, D 256) and at phi3-mini's
    (Hq = Hkv = 32, D 96).  Returns the record of the qwen3 shape, with
    the D 256 shape's times under ``d256`` and the D 96 shape's under
    ``d96`` (bf16) and ``d96_fp32``."""
    cases = [  # name, b, hq, hkv, s, t, d, dtype, model layout, tol
        ("bf16 causal S=T=1024, model layout", 1, 16, 8, 1024, 1024, 128,
         torch.bfloat16, True, 2e-2),
        ("bf16 causal ragged S=T=1000", 1, 16, 8, 1000, 1000, 128,
         torch.bfloat16, False, 2e-2),
        ("bf16 causal S=128 T=1024", 1, 16, 8, 128, 1024, 128,
         torch.bfloat16, False, 2e-2),
        ("fp32 causal S=T=1024", 1, 16, 8, 1024, 1024, 128,
         torch.float32, False, 1e-4),
        ("bf16 D=256 MQA 16:1 causal B=2 S=T=1024, model layout", 2, 16, 1,
         1024, 1024, 256, torch.bfloat16, True, 2e-2),
        ("fp32 D=256 MQA 16:1 causal ragged S=T=520", 1, 16, 1, 520, 520,
         256, torch.float32, False, 1e-4),
        # phi3-mini's prefill: MHA 32 heads, head dim 96
        ("bf16 D=96 MHA 32:32 causal S=T=1024, model layout", 1, 32, 32,
         1024, 1024, 96, torch.bfloat16, True, 2e-2),
        ("bf16 D=96 MHA 32:32 causal ragged S=T=1000", 1, 32, 32, 1000,
         1000, 96, torch.bfloat16, False, 2e-2),
        ("fp32 D=96 MHA 32:32 causal S=T=1024, model layout", 1, 32, 32,
         1024, 1024, 96, torch.float32, True, 1e-4),
        ("fp32 D=96 MHA 32:32 causal ragged S=T=777", 1, 32, 32, 777, 777,
         96, torch.float32, False, 1e-4),
    ]
    record = None
    for name, b, hq, hkv, s, t, d, dtype, layout, tol in cases:
        q, k, v = attention_inputs(b, hq, hkv, s, t, d, dtype, layout)
        got = fa.flash_attention(q, k, v, causal=True)
        expect = flash_attention_ref(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = (got.float() - expect.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        print(f"flash_attention {name}: max_abs_err {err:.3e} "
              f"(tol {tol:g}), finite={finite}")
        if not (finite and err <= tol):
            raise SystemExit(f"flash_attention disagrees with its plain "
                             f"version on {name}: {err:.3e} > {tol:g}")
        shape = {"b": b, "hq": hq, "hkv": hkv, "s": s, "t": t, "d": d,
                 "dtype": str(dtype), "causal": True}
        if record is None or (d in (96, 256) and layout):
            times = time_attention(q, k, v)
            sdpa = (f"{times['library_ms']:.4f} ms "
                    f"({times['library_tflops']:.1f} TFLOP/s, "
                    f"{times['library_backend']})")
            print(f"flash_attention timing at {name}: kernel "
                  f"{times['ms']:.4f} ms ({times['tflops']:.1f} TFLOP/s), "
                  f"plain {times['plain_ms']:.4f} ms, sdpa {sdpa}, bound "
                  f"{times['bound_ms']:.4f} ms ({times['bound_by']})")
            if record is None:
                record = {"name": "flash_attention", "route": "cuda",
                          "source": "src/repro_torch/kernels/csrc/"
                                    "flash_attention.cu",
                          "replaces": "src/repro/kernels/"
                                      "flash_attention.py:74",
                          "max_abs_err": err, **times, "shape": shape}
            else:
                key = f"d{d}" + ("_fp32" if dtype == torch.float32 else "")
                record[key] = {"max_abs_err": err, **times, "shape": shape}
        elif dtype == torch.float32 and d == 128:
            # the CUDA-core route, beside the bf16 route's times
            ms = cuda_ms([lambda: fa.flash_attention(q, k, v, causal=True)])
            record["fp32"] = {"max_abs_err": err, "ms": ms,
                              "tflops": tflops(q, k, ms), "shape": shape}
            print(f"flash_attention timing at {name}: kernel {ms:.4f} ms "
                  f"({record['fp32']['tflops']:.1f} TFLOP/s)")
    return record


def decode_bound(q, k, lens):
    """Least time (ms) for one flash-decode call on these inputs: q read, o
    written and each slot's valid K/V rows read once over HBM bandwidth,
    against 4*D flops per valid (q head, position) over the peak rate of
    the input type."""
    return cost_bound(fd.decode_cost(q, k, fd.valid_positions(
        lens, q.shape[0], k.shape[2])), q.dtype)


def decode_inputs(b, hq, hkv, t, d, dtype, model_layout=False, seed=0):
    """Random q (B, Hq, D) and k/v caches (B, Hkv, T, D) on the card;
    ``model_layout`` makes the caches (B, Hkv, T, D) views of (B, T, Hkv,
    D) tensors, as the decode engine's layer caches are."""
    g = torch.Generator("cuda").manual_seed(seed)
    q = torch.randn(b, hq, d, generator=g, device="cuda", dtype=dtype)
    kv = []
    for _ in range(2):
        if model_layout:
            x = torch.randn(b, t, hkv, d, generator=g, device="cuda",
                            dtype=dtype).transpose(1, 2)
        else:
            x = torch.randn(b, hkv, t, d, generator=g, device="cuda",
                            dtype=dtype)
        kv.append(x)
    return q, kv[0], kv[1]


def time_decode(sets, lens, reps=40):
    """Kernel (device time, and as the host issues the calls), plain
    version, SDPA and one torch.sum over as many bytes as the valid K/V
    rows (ms), and the bound, rotating over cache sets."""
    t = sets[0][1].shape[2]
    valid = (torch.arange(t, device="cuda")[None, :]
             < lens[:, None])[:, None, None, :]
    kernel = [lambda s=s: fd.flash_decode(*s, lens) for s in sets]
    ms = cuda_ms(kernel, reps=reps)
    bound_ms, bound_by = decode_bound(sets[0][0], sets[0][1], lens)
    # the reach of one plain read pass: torch.sum over contiguous tensors
    # of as many bytes as the valid K/V rows, rotated as the caches are
    n = int(lens.clamp(0, t).sum()) * 2 * sets[0][1].shape[1] * \
        sets[0][1].shape[3]
    flat = [torch.ones(n, dtype=sets[0][1].dtype, device="cuda")
            for _ in sets]
    stream_ms = cuda_ms([lambda x=x: x.sum() for x in flat], reps=reps)
    del flat
    return {"ms": ms, "kernel_ms": ms, "stream_ms": stream_ms,
            "issued_ms": cuda_ms(kernel, reps=reps, backlog=False),
            "plain_ms": cuda_ms([lambda s=s: flash_decode_ref(*s, lens)
                                 for s in sets], reps=reps),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms([
                lambda s=s: torch.nn.functional.scaled_dot_product_attention(
                    s[0][:, :, None], s[1], s[2], attn_mask=valid,
                    enable_gqa=True)
                for s in sets], reps=reps)}


def check_flash_decode():
    """Kernel vs plain version at the decode path's widths (B 8, Hq 16,
    Hkv 8, D 128, T 2048) with per-slot lengths, plus fp32, MQA and D 16
    cases, and recurrentgemma's D 256 with 16 q heads per kv head; rows of
    length 0 must be zeros.  Then times kernel, plain version and SDPA at
    the qwen3 decode path's point and at recurrentgemma's (under
    ``d256``), rotating over cache sets.  Returns the kernel's record."""
    cases = [  # name, b, hq, hkv, t, d, dtype, model layout, lengths, tol
        ("bf16 B=8 T=2048, model layout, per-slot lengths", 8, 16, 8, 2048,
         128, torch.bfloat16, True, DECODE_LENS, 2e-2),
        ("fp32 B=8 T=2048, per-slot lengths", 8, 16, 8, 2048, 128,
         torch.float32, False, DECODE_LENS, 1e-5),
        ("fp32 MQA group 8, D=64 T=1000, per-slot lengths", 4, 8, 1, 1000,
         64, torch.float32, False, [1, 255, 999, 1000], 1e-5),
        ("bf16 D=16 T=300, model layout, scalar length 200", 2, 4, 2, 300,
         16, torch.bfloat16, True, 200, 2e-2),
        ("bf16 D=256 MQA group 16, B=8 T=2048, model layout, per-slot "
         "lengths", 8, 16, 1, 2048, 256, torch.bfloat16, True, DECODE_LENS,
         2e-2),
        ("fp32 D=256 MQA group 16, B=8 T=2048, per-slot lengths", 8, 16, 1,
         2048, 256, torch.float32, False, DECODE_LENS, 1e-5),
        ("bf16 group 2 B=8 T=2048, model layout, lengths ending inside a "
         "split", 8, 16, 8, 2048, 128, torch.bfloat16, True,
         [0, 200, 223, 225, 500, 1056, 1057, 1999], 2e-2),
        ("bf16 D=256 group 16, B=16 T=64, model layout, per-slot lengths",
         16, 16, 1, 64, 256, torch.bfloat16, True,
         [0, 1, 15, 16, 17, 33, 63, 64] * 2, 2e-2),
        ("bf16 D=256 group 16, B=16 T=2048, model layout, lengths 2048 and "
         "inside a split", 16, 16, 1, 2048, 256, torch.bfloat16, True,
         [2048] * 8 + [0, 1, 100, 127, 129, 1000, 2047, 2048], 2e-2),
        # phi3-mini's decode point: MHA (group 1), head dim 96
        ("bf16 D=96 MHA 32:32, B=8 T=2048, model layout, per-slot lengths",
         8, 32, 32, 2048, 96, torch.bfloat16, True, DECODE_LENS, 2e-2),
        ("bf16 D=96 MHA 32:32, B=8 T=2048, model layout, lengths ending "
         "inside a split", 8, 32, 32, 2048, 96, torch.bfloat16, True,
         [0, 200, 223, 225, 500, 1056, 1057, 1999], 2e-2),
        ("fp32 D=96 MHA 32:32, B=8 T=2048, model layout, lengths ending "
         "inside a split", 8, 32, 32, 2048, 96, torch.float32, True,
         [0, 200, 223, 225, 500, 1056, 1057, 1999], 1e-5),
        ("fp32 D=96 group 8, B=2 T=300, per-slot lengths", 2, 16, 2, 300,
         96, torch.float32, False, [300, 17], 1e-5),
    ]
    record = None
    for name, b, hq, hkv, t, d, dtype, layout, lens, tol in cases:
        q, k, v = decode_inputs(b, hq, hkv, t, d, dtype, layout)
        arg = (lens if isinstance(lens, int) else
               torch.tensor(lens, dtype=torch.int32, device="cuda"))
        got = fd.flash_decode(q, k, v, arg)
        expect = flash_decode_ref(q, k, v, arg)
        torch.cuda.synchronize()
        live = torch.as_tensor(lens, device="cuda").expand(b) > 0
        err = (got[live].float() - expect[live].float()).abs().max().item()
        zeros = bool((got[~live] == 0).all())
        finite = bool(torch.isfinite(got).all())
        print(f"flash_decode {name}: max_abs_err {err:.3e} (tol {tol:g}), "
              f"length-0 rows zero={zeros}, finite={finite}")
        if not (finite and zeros and err <= tol):
            raise SystemExit(f"flash_decode disagrees with its plain "
                             f"version on {name}: {err:.3e} > {tol:g} or "
                             f"nonzero length-0 rows")
        if record is None:
            record = {"max_abs_err": err}

    times = time_decode_points()
    record.update({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:62",
        **times["qwen3"]})
    record["d256"] = times["d256"]
    record["d256_full"] = times["d256_full"]
    record["d96"] = times["d96"]
    return record


DECODE_POINTS = {  # b, hq, hkv, t, d, timed length
    "qwen3": (8, 16, 8, DECODE_CONTEXT, 128, DECODE_TIMED_LEN),
    "d256": (GEMMA_ROWS, 16, 1, GEMMA_MAX_LEN, 256, GEMMA_MAX_LEN),
    # recurrentgemma's window when full
    "d256_full": (GEMMA_ROWS, 16, 1, 2048, 256, 2048),
    # phi3-mini's decode run: 8 slots mid-stream, MHA, head dim 96
    "d96": (DECODE_SLOTS, 32, 32, DECODE_CONTEXT, 96, DECODE_TIMED_LEN)}


def time_decode_points():
    """Kernel, plain version and SDPA at the qwen3 decode path's point, at
    recurrentgemma's decode loop's (T 64) and at its full window (T 2048),
    and at phi3-mini's (D 96), bf16 in the model layout, rotating over
    cache sets."""
    out = {}
    for key, (b, hq, hkv, t, d, n) in DECODE_POINTS.items():
        lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
        sets = [decode_inputs(b, hq, hkv, t, d, torch.bfloat16, True, seed=i)
                for i in range(COLD_SETS)]
        times = time_decode(sets, lens)
        times["shape"] = {"b": b, "hq": hq, "hkv": hkv, "t": t, "d": d,
                          "dtype": str(torch.bfloat16), "lens": n,
                          "cache_sets": COLD_SETS}
        print(f"flash_decode timing at B={b} Hq={hq} Hkv={hkv} D={d} T={t} "
              f"len={n} (bf16, model layout, {COLD_SETS} cache sets): "
              f"kernel {times['ms']:.4f} ms ({times['issued_ms']:.4f} ms a "
              f"call as the host issues them), plain "
              f"{times['plain_ms']:.4f} ms, sdpa {times['library_ms']:.4f} "
              f"ms, bound {times['bound_ms']:.4f} ms ({times['bound_by']}), "
              f"one torch.sum over as many bytes {times['stream_ms']:.4f} "
              f"ms")
        out[key] = times
        del sets
        torch.cuda.empty_cache()
    return out


def allclose_err(got, expect, tol):
    """Largest |got - expect| and whether every element lies within
    tol * (1 + |expect|) (the CPU tests' rtol = atol = tol) and is
    finite."""
    g, e = got.float(), expect.float()
    diff = (g - e).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (diff <= tol * (1 + e.abs())).all())
    return diff.max().item(), ok


def scan_bound(cost):
    """A recurrence's bound: its cost's operations at the fp32 CUDA-core
    rate."""
    return cost_bound(cost, torch.float32)


def rwkv6_inputs(b, h, s, d, dtype, model_layout, seed=0):
    """r, k, v, w (B, H, S, D) on the card with the reference tests'
    spread (k 0.2 N, w in (0.7, 1)), u (H, D) and a nonzero s0;
    ``model_layout`` makes r/k/v/w views of (B, S, H, D) tensors."""
    g = torch.Generator("cuda").manual_seed(seed)

    def bshd(scale=1.0, uniform=False):
        shape = (b, s, h, d) if model_layout else (b, h, s, d)
        x = (0.7 + 0.3 * torch.rand(shape, generator=g, device="cuda")
             if uniform else
             scale * torch.randn(shape, generator=g, device="cuda"))
        x = x.to(dtype)
        return x.transpose(1, 2) if model_layout else x

    r, k, v, w = bshd(), bshd(0.2), bshd(), bshd(uniform=True)
    u = 0.2 * torch.randn(h, d, generator=g, device="cuda")
    s0 = 0.1 * torch.randn(b, h, d, d, generator=g, device="cuda")
    return r, k, v, w, u, s0


def check_rwkv6_scan():
    """Kernel vs plain version at rwkv6-1.6b's shape (B 4, H 32, S 1024, D
    64, fp32, the model's (B, S, H, D) layout, nonzero s0), in bf16, at the
    decode step S = 1, ragged S, the smaller head dims and the extreme
    decays (w 1e-30 and 1); y and s_last within tol (1 + |plain|).  Times
    kernel and plain version at the main shape and at S = 1.  Returns the
    kernel's record."""
    cases = [  # name, b, h, s, d, dtype, model layout, tol
        ("fp32 B=4 H=32 S=1024 D=64, model layout", 4, 32, 1024, 64,
         torch.float32, True, 2e-4),
        ("bf16 B=4 H=32 S=1024 D=64, model layout", 4, 32, 1024, 64,
         torch.bfloat16, True, 2e-2),
        ("fp32 S=1 (decode step), model layout", 4, 32, 1, 64,
         torch.float32, True, 2e-4),
        ("fp32 ragged S=1000", 2, 32, 1000, 64, torch.float32, False, 2e-4),
        ("fp32 D=32 S=257", 2, 4, 257, 32, torch.float32, False, 2e-4),
        ("bf16 D=16 S=300, model layout", 2, 4, 300, 16, torch.bfloat16,
         True, 2e-2),
        ("fp32 S=31, decays 1e-30 and 1, model layout", 4, 32, 31, 64,
         torch.float32, True, 2e-4),
    ]
    record = None
    for name, b, h, s, d, dtype, layout, tol in cases:
        x = rwkv6_inputs(b, h, s, d, dtype, layout)
        if "decays" in name:      # alternate steps at the two extremes
            x[3][:, :, 0::2] = 1e-30
            x[3][:, :, 1::2] = 1.0
        y, s_last = rw.rwkv6_scan(*x)
        y_ref, s_ref = rwkv6_scan_ref(*x)
        torch.cuda.synchronize()
        err_y, ok_y = allclose_err(y, y_ref, tol)
        err_s, ok_s = allclose_err(s_last, s_ref, tol)
        print(f"rwkv6_scan {name}: max_abs_err y {err_y:.3e}, s_last "
              f"{err_s:.3e} (within {tol:g} (1 + |plain|): {ok_y and ok_s})")
        if not (ok_y and ok_s):
            raise SystemExit(f"rwkv6_scan disagrees with its plain version "
                             f"on {name}: {err_y:.3e}, {err_s:.3e}")
        if record is None:
            record = {"max_abs_err": max(err_y, err_s)}
        del x
    times = time_rwkv6_points()
    record.update({"name": "rwkv6_scan", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "replaces": "src/repro/kernels/rwkv6_scan.py:53",
                   **times["main"], "s1": times["s1"]})
    return record


RWKV_POINTS = {"main": (4, 32, 1024, 64),   # b, h, s, d: rwkv6-1.6b's
               "s1": (4, 32, 1, 64)}        # forward and its decode step


def time_rwkv6_points():
    """Kernel and plain version (ms) and the bound at rwkv6-1.6b's forward
    shape and its S = 1 decode step, fp32 in the model layout (the kernel
    timed L2-warm, as the model's just-written projections)."""
    out = {}
    for key, (b, h, s, d) in RWKV_POINTS.items():
        x = rwkv6_inputs(b, h, s, d, torch.float32, True)
        ms = cuda_ms([lambda: rw.rwkv6_scan(*x)])
        plain_ms = cuda_ms([lambda: rwkv6_scan_ref(*x)], reps=3)
        bound_ms, bound_by = scan_bound(rw.scan_cost(x[0]))
        out[key] = {"ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None,
                    "shape": {"b": b, "h": h, "s": s, "d": d,
                              "dtype": str(torch.float32)}}
        print(f"rwkv6_scan timing at B={b} H={h} S={s} D={d} (fp32, model "
              f"layout): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); no single PyTorch call "
              f"computes it")
        del x
    return out


def rglru_inputs(b, s, r, dtype, seed=0):
    """a in (0.3, 1), g 0.2 N and a nonzero h0 on the card."""
    g = torch.Generator("cuda").manual_seed(seed)
    a = (0.3 + 0.7 * torch.rand(b, s, r, generator=g, device="cuda")
         ).to(dtype)
    gx = (0.2 * torch.randn(b, s, r, generator=g, device="cuda")).to(dtype)
    return a, gx, torch.randn(b, r, generator=g, device="cuda")


def rglru_cases():
    """(name, b, s, r, dtype, tol) of the kernel check: the model's shape
    in fp32 and bf16, the decode step at the two batch sizes of the paths,
    S on both sides of the route threshold and of the staged route's piece
    edges, prompts above recurrentgemma's 2048 window, ragged R (a partial
    tile; rows off 16 bytes, which take the step route), and the extreme
    decays."""
    piece = rg.STAGED.piece
    low = rg.STAGED_MIN_S
    f32, b16 = torch.float32, torch.bfloat16
    cases = [
        ("fp32 B=2 S=1024 R=4096", 2, 1024, 4096, f32, 1e-5),
        ("bf16 B=2 S=1024 R=4096", 2, 1024, 4096, b16, 2e-2),
        ("fp32 S=1 (decode step)", 2, 1, 4096, f32, 1e-5),
        ("fp32 S=1 B=16 (decode loop)", 16, 1, 4096, f32, 1e-5),
        ("fp32 ragged S=1000 R=1000", 3, 1000, 1000, f32, 1e-5),
        ("bf16 ragged S=300 R=1000", 3, 300, 1000, b16, 2e-2),
        ("fp32 S=300 R=1001 (rows off 16 bytes)", 2, 300, 1001, f32, 1e-5),
        ("fp32 S=4096 B=1 (prompt above the window)", 1, 4096, 4096, f32,
         1e-5),
        ("bf16 S=4096 B=1 (prompt above the window)", 1, 4096, 4096, b16,
         2e-2),
        ("fp32 S=1024, decays 1e-30 and 1", 2, 1024, 4096, f32, 1e-5),
        ("fp32 S=4096 B=1, decays 1e-30 and 1", 1, 4096, 4096, f32, 1e-5),
    ]
    for s in sorted({low - 1, low, piece - 1, piece + 1, 2 * piece - 1,
                     2 * piece + 1}):
        cases.append((f"fp32 S={s} (staged from {low}, pieces of {piece})",
                      2, s, 4096, f32, 1e-5))
    return cases


def check_rglru_scan():
    """Kernel vs plain version on every case of :func:`rglru_cases`; y and
    h_last within tol (1 + |plain|), one counted launch a call, and on the
    staged route equal bit for bit to the step route.  Times kernel, plain
    version and one torch.add over the same bytes at the points of
    :func:`time_rglru_points`.  Returns the kernel's record."""
    record = None
    for name, b, s, r, dtype, tol in rglru_cases():
        a, gx, h0 = rglru_inputs(b, s, r, dtype)
        if "decays" in name:
            # even channels decay 1 (a plain running sum over all of S), odd
            # channels 1e-30 and 1 on alternate steps
            a[..., 0::2] = 1.0
            a[:, 0::2, 1::2] = 1e-30
            a[:, 1::2, 1::2] = 1.0
        before = _build.launches("rglru_scan")
        y, h_last = rg.rglru_scan(a, gx, h0)
        calls = _build.launches("rglru_scan") - before
        y_ref, h_ref = rglru_scan_ref(a, gx, h0)
        plan = rg.scan_plan(s, r, a.element_size())
        same = True
        if plan.route == "staged":
            y_step, h_step = rg.launch(a, gx, h0, rg.STEP)
            same = bool(torch.equal(y, y_step)) and bool(
                torch.equal(h_last, h_step))
        torch.cuda.synchronize()
        err_y, ok_y = allclose_err(y, y_ref, tol)
        err_h, ok_h = allclose_err(h_last, h_ref, tol)
        print(f"rglru_scan {name} ({plan.route} route): max_abs_err y "
              f"{err_y:.3e}, h_last {err_h:.3e} (within {tol:g} (1 + "
              f"|plain|): {ok_y and ok_h}), counted launches {calls}, equal "
              f"to the step route: {same}")
        if not (ok_y and ok_h and same) or calls != 1:
            raise SystemExit(f"rglru_scan disagrees with its plain version "
                             f"or its step route on {name}: {err_y:.3e}, "
                             f"{err_h:.3e}, equal {same}, or counted {calls} "
                             f"launches, not 1")
        if record is None:
            record = {"max_abs_err": max(err_y, err_h)}
        del a, gx, y, y_ref
    times = time_rglru_points()
    record.update({"name": "rglru_scan", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "replaces": "src/repro/kernels/rglru_scan.py:47",
                   **times["main"],
                   **{k: v for k, v in times.items() if k != "main"}})
    return record


# b, s, r, dtype: recurrentgemma-9b's (2, 1024) forward in fp32 (the model
# casts to fp32 before the scan) and in bf16, its decode step at the
# forward's batch and at the decode loop's 16 rows
RGLRU_POINTS = {"main": (2, 1024, 4096, torch.float32),
                "bf16": (2, 1024, 4096, torch.bfloat16),
                "s1": (2, 1, 4096, torch.float32),
                "s1_b16": (16, 1, 4096, torch.float32)}


def time_rglru_points():
    """Kernel and plain version (ms), the bound, and one torch.add(a, g,
    out=y) over the same bytes (the reach of one plain elementwise pass of
    this size; not a library call of the recurrence, which has none) at
    each point of RGLRU_POINTS, L2-warm as the model's just-written
    gates."""
    out = {}
    for key, (b, s, r, dtype) in RGLRU_POINTS.items():
        a, gx, h0 = rglru_inputs(b, s, r, dtype)
        ms = cuda_ms([lambda: rg.rglru_scan(a, gx, h0)])
        plain_ms = cuda_ms([lambda: rglru_scan_ref(a, gx, h0)],
                           reps=3 if s > 1 else 20)
        y = torch.empty_like(a)
        stream_ms = cuda_ms([lambda: torch.add(a, gx, out=y)])
        bound_ms, bound_by = scan_bound(rg.scan_cost(a))
        plan = (rg.scan_plan(s, r, a.element_size())._asdict()
                if hasattr(rg, "scan_plan") else None)
        out[key] = {"ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
                    "stream_ms": stream_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": None, "plan": plan,
                    "shape": {"b": b, "s": s, "r": r, "dtype": str(dtype)}}
        print(f"rglru_scan timing at B={b} S={s} R={r} ({dtype}, plan "
              f"{plan}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), one torch.add over the same "
              f"bytes {stream_ms:.4f} ms; no single PyTorch call computes "
              f"it")
        del a, gx, y
    return out


def check_windowed_flash_attention():
    """recurrentgemma's windowed prefill above its window: the kernel with
    ``window=`` against its plain version at B 1, 16/1 heads, D 256, S = T
    = 4096, window 2048, in bf16 and fp32; then times the windowed kernel,
    the same kernel without the window, the plain version and SDPA with
    the window's boolean mask (bf16).  Returns the record."""
    b, hq, hkv, n, d, window = WINDOWED
    out = {"shape": {"b": b, "hq": hq, "hkv": hkv, "s": n, "t": n, "d": d,
                     "window": window}}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, k, v = attention_inputs(b, hq, hkv, n, n, d, dtype, True)
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        expect = flash_attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        err = (got.float() - expect.float()).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        print(f"flash_attention windowed {dtype} B={b} {hq}/{hkv} D={d} "
              f"S=T={n} window={window}: max_abs_err {err:.3e} (tol "
              f"{tol:g}), finite={finite}")
        if not (finite and err <= tol):
            raise SystemExit(f"windowed flash_attention disagrees with its "
                             f"plain version ({dtype}): {err:.3e} > {tol:g}")
        out[f"max_abs_err_{str(dtype).split('.')[-1]}"] = err
        del expect
    # q, k, v are fp32 here; time the bf16 model's call
    q, k, v = attention_inputs(b, hq, hkv, n, n, d, torch.bfloat16, True)
    pos = torch.arange(n, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - window)
    out["ms"] = cuda_ms([lambda: fa.flash_attention(q, k, v, causal=True,
                                                    window=window)])
    out["causal_ms"] = cuda_ms([lambda: fa.flash_attention(q, k, v,
                                                           causal=True)])
    out["plain_ms"] = cuda_ms([lambda: flash_attention_ref(
        q, k, v, causal=True, window=window)], reps=3)
    out["library_ms"] = cuda_ms([
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)])
    out["bound_ms"], out["bound_by"] = attention_bound(q, k, True, window)
    out["tflops"] = tflops(q, k, out["ms"], window)
    out["library_tflops"] = tflops(q, k, out["library_ms"], window)
    print(f"flash_attention windowed timing (bf16): kernel {out['ms']:.4f} "
          f"ms ({out['tflops']:.1f} TFLOP/s; without the window "
          f"{out['causal_ms']:.4f} ms), plain "
          f"{out['plain_ms']:.4f} ms, sdpa with the mask "
          f"{out['library_ms']:.4f} ms ({out['library_tflops']:.1f} "
          f"TFLOP/s), bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']})")
    return out


def qi8_bound(m, k, n):
    """Least time (ms) of an int8 (M,K) x (K,N) -> int32 product: x and w
    read and the int32 output written once over HBM bandwidth, against
    2*M*N*K operations at the int8 tensor-core peak."""
    return cost_bound(mq.qi8_cost(m, k, n), torch.int8)


def int_mm_ms(x, w):
    """``torch._int_mm``'s time (the library call: the port never calls
    it), or None with the reason where its shape rules refuse the
    shape."""
    try:
        torch._int_mm(x, w)
    except RuntimeError as e:
        return None, str(e).strip().splitlines()[0]
    return cuda_ms([lambda: torch._int_mm(x, w)]), None


def check_matmul_qi8():
    """Kernel vs plain version (float64 on the card, exact here) at every
    QI8_SHAPES entry, the extremes -128 x -128 included: exactly equal.
    Times kernel, plain version and ``torch._int_mm`` at each.  Returns
    the record of the head shape (QI8_HEAD), the others under
    ``shapes``."""
    record, shapes = None, []
    for m, k, n in QI8_SHAPES:
        g = torch.Generator("cuda").manual_seed(m + k + n)
        x = torch.randint(-128, 128, (m, k), generator=g, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                          dtype=torch.int8)
        x[0], w[:, 0] = -128, -128
        got = mq.matmul_qi8(x, w)
        expect = matmul_qi8_ref(x, w)
        torch.cuda.synchronize()
        err = (got.long() - expect.long()).abs().max().item()
        print(f"matmul_qi8 M={m} K={k} N={n}: max_abs_err {err} (must be "
              f"0), dtype {got.dtype}")
        if not (got.dtype == torch.int32 and torch.equal(got, expect)):
            raise SystemExit(f"matmul_qi8 differs from its plain version at "
                             f"{(m, k, n)}: {err}")
        lib_ms, lib_why = int_mm_ms(x, w)
        bound_ms, bound_by = qi8_bound(m, k, n)
        row = {"m": m, "k": k, "n": n, "max_abs_err": err,
               "ms": cuda_ms([lambda: mq.matmul_qi8(x, w)]),
               "plain_ms": cuda_ms([lambda: matmul_qi8_ref(x, w)]),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": lib_ms}
        if lib_why:
            row["library_null_reason"] = f"torch._int_mm: {lib_why}"
        print(f"matmul_qi8 timing at M={m} K={k} N={n}: kernel "
              f"{row['ms']:.4f} ms, plain (float64) {row['plain_ms']:.4f} "
              f"ms, torch._int_mm "
              f"{'%.4f ms' % lib_ms if lib_ms is not None else 'null'}"
              f"{' (' + row['library_null_reason'] + ')' if lib_why else ''}"
              f", bound {bound_ms:.5f} ms ({bound_by})")
        shapes.append(row)
        if (m, k, n) == QI8_HEAD:
            record = {"name": "matmul_qi8", "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/matmul_qi8.cu",
                      "replaces": "src/repro/kernels/matmul_qi8.py:44",
                      **{key: row[key] for key in (
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms")}}
            if lib_why:
                record["library_null_reason"] = row["library_null_reason"]
    record["max_abs_err"] = max(r["max_abs_err"] for r in shapes)
    record["shapes"] = shapes
    return record


def bn_inputs(shape, residual, offset=0, seed=0):
    """x and r (or None) of ``shape`` on the card, ``offset`` floats into
    their buffers, with values past relu6's 6; random mean, var, gamma,
    beta."""
    g = torch.Generator(CARD).manual_seed(seed)
    n, c = int(np.prod(shape)), shape[-1]

    def act(scale):
        buf = torch.randn(n + offset, generator=g, device=CARD) * scale
        return buf[offset:].view(shape)

    x = act(4.0)
    r = act(3.0) if residual else None
    ps = [torch.randn(c, generator=g, device=CARD) * 0.5,
          torch.rand(c, generator=g, device=CARD) * 2 + 0.01,
          torch.rand(c, generator=g, device=CARD) + 0.5,
          torch.randn(c, generator=g, device=CARD)]
    return x, r, ps


def host_us(fn, calls=HOST_CALLS, samples=7):
    """The host's time a call of ``fn`` (us), its calls issued while the
    card sleeps, so no launch waits for the device: the median of
    ``samples`` rounds of ``calls`` calls (the host is shared and noisy)."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(samples):
        torch.cuda._sleep(BACKLOG_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rounds.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(rounds))


def check_bn_epilogue():
    """``bn_epilogue`` against the eager ops (``bn_epilogue_ref``) at every
    BN_SHAPES entry, with and without the residual, for no activation,
    relu and relu6, and with x and r 4 bytes off 16 (the scalar route):
    equal bit for bit, one counted launch a call.  Times kernel, eager
    chain and bound at BN_TIMED, and the host's time a call of each.
    Returns the record of the first timed shape, both under ``shapes``."""
    checked = 0
    with torch.no_grad():
        for shape in BN_SHAPES:
            for residual in (False, True):
                for offset in (0, 1):
                    x, r, ps = bn_inputs(shape, residual, offset)
                    for act in (None, "relu", "relu6"):
                        before = _build.launches(EPILOGUE)
                        got = be.bn_epilogue(x, *ps, r, act)
                        expect = kernel_ref.bn_epilogue_ref(x, *ps, r, act)
                        torch.cuda.synchronize()
                        if not (torch.equal(got, expect) and
                                _build.launches(EPILOGUE) == before + 1):
                            err = (got - expect).abs().max().item()
                            raise SystemExit(
                                f"bn_epilogue differs from the eager ops "
                                f"at {shape} residual {residual} offset "
                                f"{offset} act {act}: {err}")
                        checked += 1
            del x, r, got, expect
        print(f"bn_epilogue: {checked} calls equal bit for bit to the eager "
              f"ops, one launch each")
        shapes = []
        for shape, residual in BN_TIMED:
            x, r, ps = bn_inputs(shape, residual)

            def kernel():
                return be.bn_epilogue(x, *ps, r, "relu")

            def plain():
                return kernel_ref.bn_epilogue_ref(x, *ps, r, "relu")

            # the wrapper's host time in parts: the output's allocation,
            # and the bare C call on ready arguments
            fn, raw_stream = be._kernel()
            y = torch.empty_like(x)
            args = (x.data_ptr(), None if r is None else r.data_ptr(),
                    y.data_ptr(), *(p.data_ptr() for p in ps), x.numel(),
                    shape[-1], 1, x.get_device(),
                    raw_stream(x.get_device()))
            bound_ms, bound_by = cost_bound(
                be.epilogue_cost(x, residual, "relu"), torch.float32)
            row = {"shape": list(shape), "residual": residual, "act": "relu",
                   "max_abs_err": (kernel() - plain()).abs().max().item(),
                   "ms": cuda_ms([kernel]),
                   "plain_ms": cuda_ms([plain]), "bound_ms": bound_ms,
                   "bound_by": bound_by, "host_us": host_us(kernel),
                   "plain_host_us": host_us(plain),
                   "host_empty_like_us": host_us(
                       lambda: torch.empty_like(x)),
                   "host_c_call_us": host_us(lambda: fn(*args))}
            print(f"bn_epilogue timing at {shape} "
                  f"{'bn+add+relu' if residual else 'bn+relu'}: max "
                  f"|kernel - eager| {row['max_abs_err']:g}; kernel "
                  f"{row['ms']:.4f} ms, eager chain {row['plain_ms']:.4f} "
                  f"ms, bound {bound_ms:.4f} ms ({bound_by}); host a call "
                  f"{row['host_us']:.2f} us (of it the output's "
                  f"allocation {row['host_empty_like_us']:.2f} us, the C "
                  f"call {row['host_c_call_us']:.2f} us), eager chain "
                  f"{row['plain_host_us']:.2f} us")
            shapes.append(row)
            del x, r, y
    torch.cuda.empty_cache()
    return {"name": EPILOGUE, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bn_epilogue.cu",
            "replaces": None, **{k: shapes[0][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "host_us", "plain_host_us")},
            "library_ms": None,
            "library_null_reason": "no single PyTorch call computes it "
                                   "(the eager chain is the plain version)",
            "checked_calls": checked, "shapes": shapes}


def dw_inputs(shape, seed=0):
    """x (N, H, W, C), the (C, 1, k, k) channels_last weight scaled by
    fan-in ** -0.5, the stride and XLA's SAME pads in ``F.pad``'s order."""
    n, h, w, c, k, stride = shape
    g = torch.Generator(CARD).manual_seed(seed)
    x = torch.randn((n, h, w, c), generator=g, device=CARD)
    wt = (torch.randn((c, 1, k, k), generator=g, device=CARD) / k).contiguous(
        memory_format=torch.channels_last)
    (pt, pb), (pl, pr) = (layers.same_pads(h, k, stride),
                          layers.same_pads(w, k, stride))
    return x, wt, stride, (pl, pr, pt, pb)


def dw_ptxas(log):
    """Registers and spill store bytes of each dwconv instantiation in a
    ``-Xptxas -v`` log: {"k3 s1": (registers, spill bytes), "k3 s1 bn":
    ..., ...} (``bn``: with the BN epilogue)."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '[^']*dwconv_kernel"
                      r"ILi(\d)ELi(\d)ELb([01])E", line)
        if m:
            key = (f"k{m.group(1)} s{m.group(2)}"
                   + (" bn" if m.group(3) == "1" else ""))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and key is not None:
            out[key] = [None, int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m and key in out:
            out[key][0] = int(m.group(1))
            key = None
    return {k: tuple(v) for k, v in sorted(out.items())}


def dw_bn(c, seed=1):
    """Per-channel (mean, var, gamma, beta) on the card that send a
    depthwise output of unit scale past ReLU6's 0 and 6."""
    g = torch.Generator(CARD).manual_seed(seed)
    return (torch.randn(c, generator=g, device=CARD) * 0.5,
            torch.rand(c, generator=g, device=CARD) * 0.1 + 0.01,
            torch.rand(c, generator=g, device=CARD) * 2 + 0.5,
            torch.randn(c, generator=g, device=CARD) * 2)


def check_dwconv(log):
    """``dwconv`` against its plain version (``dwconv_ref``: ``F.pad`` and
    cuDNN's grouped ``conv2d``) at DW_SHAPES: one counted launch a call,
    within DW_ULPS of max |plain|; with the BN and ReLU6 epilogue, one
    launch equal bit for bit to ``dwconv`` then ``bn_epilogue``.  Prints
    ptxas's registers and spills of each instantiation (``log``: the
    build's; none may spill), and times kernel, plain version, cuDNN's
    convolution alone on an input padded beforehand and the bound at
    DW_TIMED, with the host's time a call of the wrapper and of the plain
    version; and the fused launch beside the unfused pair (``dwconv`` then
    ``bn_epilogue`` with ReLU6), each against its byte bound.  The plain
    version is also the library's route (``library_ms``): F.pad then
    cuDNN, the port's route before the kernel, which it no longer calls.
    Returns the record of the first timed shape, both under ``shapes``."""
    regs = dw_ptxas(log)
    print(f"dwconv ptxas (registers, spill bytes) by instantiation: {regs}")
    plain_keys = ["k3 s1", "k3 s2", "k5 s1", "k5 s2", "k7 s1", "k7 s2"]
    if sorted(regs) != sorted(plain_keys + [f"{k} bn" for k in plain_keys]):
        raise SystemExit(f"dwconv: instantiations not found: {regs}")
    if any(spill != 0 for _, spill in regs.values()):
        raise SystemExit(f"dwconv: an instantiation spills: {regs}")
    eps = torch.finfo(torch.float32).eps
    worst = 0.0
    with torch.no_grad():
        for shape in DW_SHAPES:
            x, wt, stride, pads = dw_inputs(shape)
            before = _build.launches(DWCONV)
            got = dw.dwconv(x, wt, None, stride, pads)
            expect = kernel_ref.dwconv_ref(x, wt, None, stride, pads)
            torch.cuda.synchronize()
            err = ((got - expect).abs().max().item()
                   / expect.abs().max().item() / eps)
            worst = max(worst, err)
            if not (err <= DW_ULPS and got.shape == expect.shape
                    and _build.launches(DWCONV) == before + 1):
                raise SystemExit(f"dwconv at {shape}: {err:.2f} ulp of max "
                                 f"|plain| (tol {DW_ULPS}), shape "
                                 f"{tuple(got.shape)}")
            ps = dw_bn(shape[3])
            before = _build.launches(DWCONV), _build.launches(DWCONV_BN)
            fused = dw.dwconv(x, wt, None, stride, pads, ps, "relu6")
            pair = be.bn_epilogue(got, *ps, None, "relu6")
            torch.cuda.synchronize()
            if not (torch.equal(fused, pair) and (
                    _build.launches(DWCONV), _build.launches(DWCONV_BN)) == (
                    before[0] + 1, before[1] + 1)):
                raise SystemExit(f"dwconv with the BN epilogue at {shape}: "
                                 f"max |fused - pair| "
                                 f"{(fused - pair).abs().max().item():g}")
            del x, got, expect, fused, pair
        print(f"dwconv: {len(DW_SHAPES)} shapes within {worst:.2f} ulp of "
              f"max |plain| (tol {DW_ULPS}), one launch each; with the BN "
              f"and ReLU6 epilogue equal bit for bit to dwconv then "
              f"bn_epilogue, one launch each")
        shapes = []
        for shape in DW_TIMED:
            x, wt, stride, pads = dw_inputs(shape)
            padded = F.pad(x.permute(0, 3, 1, 2), pads)
            ps = dw_bn(shape[3])

            def kernel():
                return dw.dwconv(x, wt, None, stride, pads)

            def plain():
                return kernel_ref.dwconv_ref(x, wt, None, stride, pads)

            def cudnn():
                return F.conv2d(padded, wt, None, stride=stride,
                                groups=x.shape[-1])

            def fused():
                return dw.dwconv(x, wt, None, stride, pads, ps, "relu6")

            def pair():
                return be.bn_epilogue(kernel(), *ps, None, "relu6")

            y = kernel()
            bound_ms, bound_by = cost_bound(
                dw.dwconv_cost(x, shape[4], y.shape[1], y.shape[2], False),
                torch.float32)
            fused_bound = cost_bound(dw.dwconv_cost(
                x, shape[4], y.shape[1], y.shape[2], False, True, "relu6"),
                torch.float32)
            pair_cost = [a + b for a, b in zip(
                dw.dwconv_cost(x, shape[4], y.shape[1], y.shape[2], False),
                be.epilogue_cost(y, False, "relu6"))]
            pair_bound = cost_bound(pair_cost, torch.float32)
            row = {"shape": list(shape), "pads": list(pads),
                   "max_abs_err": (y - plain()).abs().max().item(),
                   "ms": cuda_ms([kernel]), "plain_ms": cuda_ms([plain]),
                   "cudnn_conv_alone_ms": cuda_ms([cudnn]),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "host_us": host_us(kernel), "plain_host_us": host_us(plain)}
            row["library_ms"] = row["plain_ms"]
            row["roofline"] = row["bound_ms"] / row["ms"]
            row.update(fused_ms=cuda_ms([fused]), pair_ms=cuda_ms([pair]),
                       fused_bound_ms=fused_bound[0],
                       pair_bound_ms=pair_bound[0],
                       fused_host_us=host_us(fused))
            row["fused_roofline"] = row["fused_bound_ms"] / row["fused_ms"]
            row["pair_roofline"] = row["pair_bound_ms"] / row["pair_ms"]
            print(f"dwconv timing at {shape} pads {pads}: max |kernel - "
                  f"plain| {row['max_abs_err']:g}; kernel {row['ms']:.4f} "
                  f"ms ({row['roofline']:.1%} of the bound {bound_ms:.4f} "
                  f"ms, {bound_by}), plain = library (F.pad + cuDNN) "
                  f"{row['plain_ms']:.4f} ms, "
                  f"cuDNN's conv alone on a padded input "
                  f"{row['cudnn_conv_alone_ms']:.4f} ms; host a call "
                  f"{row['host_us']:.2f} us, plain {row['plain_host_us']:.2f}"
                  f" us")
            print(f"dwconv with the BN and ReLU6 at {shape}: fused "
                  f"{row['fused_ms']:.4f} ms ({row['fused_roofline']:.1%} of "
                  f"its bound {row['fused_bound_ms']:.4f} ms, "
                  f"{fused_bound[1]}); dwconv then bn_epilogue "
                  f"{row['pair_ms']:.4f} ms ({row['pair_roofline']:.1%} of "
                  f"its bound {row['pair_bound_ms']:.4f} ms, "
                  f"{pair_bound[1]}); host a fused call "
                  f"{row['fused_host_us']:.2f} us")
            shapes.append(row)
            del x, padded, y
    torch.cuda.empty_cache()
    return {"name": DWCONV, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dwconv.cu",
            "replaces": None, **{k: shapes[0][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "host_us", "plain_host_us")},
            "library": "F.pad + cuDNN's grouped conv2d (the plain version)",
            "worst_ulps": worst, "ptxas": regs, "shapes": shapes}


def mobilenetv2_dwconv_launches():
    """One MobileNetV2 forward (batch 2, fp32, TF32 off): 17 dwconv
    launches, each with the BN and ReLU6 epilogue, 35 bn_epilogue
    launches, the output within 1.5e-5 of max |y| (the benchmark cell's
    limit) of the forward through the plain version."""
    m = cnn.REAL_CNNS["MobileNetV2"]()
    dev = torch.device(CARD)
    params = m.init(dev, torch.Generator(dev).manual_seed(0))
    x = torch.randn((2,) + m.input_shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    with torch.no_grad():
        _build.reset_launches()
        y = m.apply(params, x)
        torch.cuda.synchronize()
        n = _build.launches(DWCONV)
        counts = (n, _build.launches(DWCONV_BN), _build.launches(EPILOGUE))
        with unittest.mock.patch.object(layers, "dwconv",
                                        kernel_ref.dwconv_ref):
            plain = m.apply(params, x)
    err = (y - plain).abs().max().item() / plain.abs().max().item()
    print(f"MobileNetV2 forward: (dwconv, dwconv.bn, bn_epilogue) launches "
          f"{counts} (expected (17, 17, 35)); max_abs_err / max|y| against "
          f"the plain route {err:.3e}")
    if counts != (17, 17, 35) or not err <= 1.5e-5:
        raise SystemExit(f"MobileNetV2: launches {counts}, {err:.3e}")
    return n


def resnet50_epilogue_launches():
    """One ResNet50 forward (batch 2, fp32, TF32 off): its fused groups'
    bn_epilogue launches (53) and the output equal bit for bit to the
    nodes run one by one on the card."""
    m = cnn.REAL_CNNS[CNN]()
    dev = torch.device(CARD)
    params = m.init(dev, torch.Generator(dev).manual_seed(0))
    x = torch.randn((2,) + m.input_shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    want = len(m.program().groups)
    with torch.no_grad():
        _build.reset_launches()
        y = m.apply(params, x)
        torch.cuda.synchronize()
        n = _build.launches(EPILOGUE)
        acts = {m.INPUT: x}
        for name in m._order:
            node = m.nodes[name]
            acts[name] = node.apply(params.get(name, {}),
                                    [acts[i] for i in node.inputs])
        same = torch.equal(y, acts[m.output])
    print(f"{CNN} forward: {n} bn_epilogue launches (expected {want}); "
          f"equal bit for bit to the unfused nodes: {same}")
    if n != want or want != 53 or not same:
        raise SystemExit(f"{CNN}: {n} bn_epilogue launches of {want}, "
                         f"unfused equal {same}")
    return n


def check_cnn_zoo():
    """Every Table-1 model and synthetic_cnn(64) at its published input
    size, batch 1: graph totals against the model's own and the paper's
    Table 1 (the reference's bounds), the initialized tensors against the
    params count, and one fp32 forward on the card against the same port
    weights on the CPU within CNN_TOL of max |y| (TF32 off; cuDNN's and the
    CPU's convolutions sum in other orders).  The KERNELS' launches must
    stay 0 (the convolutions run cuDNN, as the reference runs XLA, but
    for the depthwise ones), bn_epilogue launches once for each of the
    forward's fused groups without a depthwise conv and dwconv once for
    each depthwise convolution, with the BN epilogue once for each group
    with one."""
    exempt = {"NASNetMobile", "ResNet50V2", "ResNet101V2", "ResNet152V2"}
    cpu = torch.device("cpu")
    worst = 0.0
    _build.reset_launches()
    for name in list(cnn.REAL_CNNS) + ["synthetic_cnn(64)"]:
        m = (cnn.synthetic_cnn(64) if name.startswith("synthetic")
             else cnn.REAL_CNNS[name]())
        g = m.to_layer_graph()
        params = m.init(cpu, torch.Generator(cpu).manual_seed(0))
        n_init = sum(t.numel() for p in params.values() for t in p.values())
        ok = (g.total_params == m.total_params == n_init
              and g.total_macs == m.total_macs)
        if name in cnn.TABLE1:
            p_m, macs_m = cnn.TABLE1[name]
            ok &= abs(m.total_params / 1e6 - p_m) / p_m < 0.08
            ok &= (name in exempt
                   or abs(m.total_macs / 1e6 - macs_m) / macs_m < 0.12)
        x = torch.randn((1,) + m.input_shape,
                        generator=torch.Generator(cpu).manual_seed(1))
        y_cpu = m.apply(params, x)
        before = (_build.launches(EPILOGUE), _build.launches(DWCONV),
                  _build.launches(DWCONV_BN))
        t0 = time.perf_counter()
        y = m.apply(to_card(params), x.cuda())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        groups = len(m.program().groups)
        with_conv = sum(1 for g in m.program().groups if g.conv)
        # depthwise: a (C, 1, k, k) weight over C > 1 input channels
        depthwise = sum(
            1 for n, node in m.nodes.items() if node.kind == "conv"
            and params[n]["w"].shape[1] == 1
            and params[n]["w"].shape[0] == m.shape_of(node.inputs[0])[-1] > 1)
        launched = (_build.launches(EPILOGUE) - before[0],
                    _build.launches(DWCONV) - before[1],
                    _build.launches(DWCONV_BN) - before[2])
        if launched != (groups - with_conv, depthwise, with_conv):
            raise SystemExit(f"cnn {name}: (bn_epilogue, dwconv, dwconv.bn)"
                             f" launches {launched}, groups without and "
                             f"with a depthwise conv and depthwise convs "
                             f"{(groups - with_conv, depthwise, with_conv)}")
        scale = y_cpu.abs().max().item()
        rel = (y.cpu() - y_cpu).abs().max().item() / scale
        worst = max(worst, rel)
        print(f"cnn {name} {m.input_shape}: {m.total_params} params, "
              f"{m.total_macs} MACs, depth {g.depth}, "
              f"{groups - with_conv} bn_epilogue and {depthwise} dwconv "
              f"launches ({with_conv} with the BN); card vs CPU max_abs_err "
              f"/ max|y| {rel:.3e} (tol {CNN_TOL:g}; max|y| {scale:.3e}), "
              f"out {tuple(y.shape)}, first card forward {dt * 1e3:.1f} ms")
        if not (ok and rel <= CNN_TOL and bool(torch.isfinite(y).all())):
            raise SystemExit(f"cnn {name}: totals {ok}, card vs CPU {rel:.3e}"
                             f" (tol {CNN_TOL:g}) or not finite")
        del params, y, y_cpu
    check_counts("cnn zoo forwards", read_counts(), {})
    return worst


def stage_trace_times(trace, graph, pl):
    """Per stage of ``pl``: the trace's measured seconds of its depths."""
    depth = graph.depths()
    tmap = trace.depth_time_map()
    return [sum(tmap[d] for d in {depth[n] for n in layers})
            for layers in pl.stage_layers]


def serve_cnn(label, m, params, dep, reqs):
    """One unprofiled stream (req/s, latency, stage busy), then one under
    torch.profiler (device busy and idle share); the first served output
    must equal the direct forward on the card.  Returns the numbers."""
    outs, snap, seconds = serve.serve_stream(dep, reqs)
    lat, busy = snap["latency"], snap["stage_busy_s"]
    direct = m.apply(params, reqs[0][m.INPUT])
    err = (outs[0][m.output] - direct).abs().max().item()
    prof, wall = profile_serve.profiled(lambda: serve.serve_stream(dep, reqs))
    summ = profile_serve.summarize(prof, wall, f"{label} serve "
                                               f"1+{len(reqs)}", top=5)
    idle = 1 - summ["busy_s"] / summ["wall_s"]
    print(f"{label}: {len(reqs)} requests in {seconds * 1e3:.2f} ms, "
          f"{snap['throughput_rps']:.2f} req/s; latency p50/p95 "
          f"{lat['p50_s'] * 1e3:.3f} / {lat['p95_s'] * 1e3:.3f} ms "
          f"(n={lat['n']}); stage busy (s) {[round(b, 5) for b in busy]}, "
          f"balance (mean/max) {stage_balance_metrics(busy)['balance']:.3f};"
          f" device idle share {idle:.3f} (profiled stream); served vs "
          f"direct max_abs_err {err:.3e} (must be 0)")
    if not (err == 0 and snap["failed"] == 0 and lat["n"] == len(reqs)
            and all(o[m.output].shape == (1, 1000) for o in outs)):
        raise SystemExit(f"{label}: served output differs from the direct "
                         f"forward by {err:.3e} or requests failed")
    return {"rps": snap["throughput_rps"], "p50_ms": lat["p50_s"] * 1e3,
            "p95_ms": lat["p95_s"] * 1e3, "n": lat["n"],
            "stage_busy_s": busy, "idle_share": idle,
            "served_vs_direct": err}


def run_cnn_path():
    """The paper's path on the card: ResNet50 planned by the analytic Edge
    TPU model (balanced, 4 stages, paper Table 5), served through
    cnn_stage_fns; its per-depth profile captured on the card and the
    trace-source balanced_cost plan served the same way, once planned for
    the reference's Edge TPU (8 MiB a stage: its memory refinement
    decides the cuts) and once for a quarter of the card's memory a stage
    (the decode path's planning device), the plans served in turn
    CNN_ROUNDS times.  Returns every plan's numbers, and the model, its
    weights, the requests and the trace for the phases after it."""
    m = cnn.REAL_CNNS[CNN]()
    graph = m.to_layer_graph()
    dev = torch.device("cuda")
    params = m.init(dev, torch.Generator(dev).manual_seed(0))
    reqs = serve.cnn_requests(m, CNN_REQUESTS, dev, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        m.apply(params, reqs[0][m.INPUT])
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"{CNN} direct forward (batch 1, fp32): {direct_ms:.3f} ms")

    t0 = time.perf_counter()
    trace = profile_model(m, warmup=2, repeats=5, device=dev)
    profile_s = time.perf_counter() - t0
    path = ROOT / "build" / "profile" / f"{CNN}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    trace.save(str(path))
    print(f"{CNN} profile on the card: {len(trace.samples)} depth levels in "
          f"{profile_s:.1f} s, sum of level times "
          f"{sum(s.time_s for s in trace.samples) * 1e3:.3f} ms; saved "
          f"{path.relative_to(ROOT)} ({trace.device})")
    card_stage = EdgeTPUSpec(onchip_bytes=torch.cuda.get_device_properties(
        0).total_memory // STAGES)
    traced = dict(model=f"cnn:{CNN}", stages=STAGES,
                  strategy="balanced_cost", cost_source=f"trace:{path}")
    deps = {
        "analytic": serve.deploy_cnn(m, params, DeploymentSpec(
            model=f"cnn:{CNN}", stages=STAGES, strategy="balanced"), dev),
        "trace": serve.deploy_cnn(m, params, DeploymentSpec(**traced), dev),
        "trace, card memory": serve.deploy_cnn(
            m, params, DeploymentSpec(**traced), dev, base_spec=card_stage),
    }
    out = {"direct_ms": direct_ms, "plans": {}}
    for label, dep in deps.items():
        pl = dep.plan
        measured = stage_trace_times(trace, graph, pl)
        print(f"{CNN} {label} plan: cuts {list(pl.cuts)}, layers per stage "
              f"{[len(ls) for ls in pl.stage_layers]}; trace-measured stage "
              f"ms {[round(t * 1e3, 4) for t in measured]}")
        print(f"{CNN} {label} report: {pl.report.describe()}")
        out["plans"][label] = {
            "cuts": list(pl.cuts), "trace_stage_ms": [t * 1e3 for t in
                                                      measured],
            "vs_trace_err_pct": (pl.report.stage_time_error_pct
                                 if pl.report.has_trace else None),
            "served": []}
    _build.reset_launches()
    for _ in range(CNN_ROUNDS):
        for label, dep in deps.items():
            out["plans"][label]["served"].append(serve_cnn(
                f"{CNN} {label} plan", m, params, dep, reqs))
    check_counts(f"{CNN} serving", read_counts(), {})
    return out, {"model": m, "params": params, "reqs": reqs, "trace": trace}


def run_int8_head():
    """The int8 API's path: ResNet50's classifier head (8 images' 2048
    pooled features x the 2048 x 1000 dense weights) through
    ``quant.quantized_dense``, with matmul_qi8's count set to 0 just before
    and read just after (1 launch); bit-equal to the same call on the CPU,
    and within the int8 quantization error of the fp32 head."""
    m = cnn.REAL_CNNS[CNN]()
    dev = torch.device("cuda")
    params = m.init(dev, torch.Generator(dev).manual_seed(0))
    feats = m.apply_subset(params, {m.INPUT: torch.randn(
        (QI8_HEAD[0],) + m.input_shape, device=dev,
        generator=torch.Generator(dev).manual_seed(2))},
        [n for n in m.nodes if n != m.output])
    x = next(iter(feats.values()))
    w = params[m.output]["w"]
    _build.reset_launches()
    y = quant.quantized_dense(x, w)
    torch.cuda.synchronize()
    counts = read_counts()
    y_cpu = quant.quantized_dense(x.cpu(), w.cpu())
    fp32 = x @ w
    rel = ((y - fp32).abs().max() / fp32.abs().max()).item()
    print(f"int8 head {tuple(x.shape)} x {tuple(w.shape)}: quantized_dense "
          f"card = CPU bit for bit: {torch.equal(y.cpu(), y_cpu)}; vs the "
          f"fp32 head max_abs_err / max|y| {rel:.3e} (int8 quantization)")
    check_counts("int8 head", counts, {"matmul_qi8": 1})
    if not (torch.equal(y.cpu(), y_cpu) and rel < 0.05):
        raise SystemExit(f"int8 head: card != CPU or {rel:.3e} off fp32")
    return counts["matmul_qi8"]


def exit_misordered(reqs):
    """Adjacent inversions in the order the requests that completed on
    their first admission left the pipeline (their completion times):
    the order-restoring merge keeps submission order across failover and
    hot swaps.  A request re-admitted after a stage loss re-enters the
    stream at its tail by design, so it is left out."""
    done = sorted((r.t_done, i) for i, r in enumerate(reqs)
                  if r.event.is_set() and r.error is None and r.retries == 0)
    order = [i for _, i in done]
    return sum(1 for a, b in zip(order, order[1:]) if b < a)


def check_outputs(label, m, reqs, direct):
    """Every completed request's output equals the direct forward of its
    input, bit for bit (the same kernels on one card)."""
    errs = [(r.result[m.output] - d).abs().max().item()
            for r, d in zip(reqs, direct)
            if r.event.is_set() and r.error is None]
    worst = max(errs, default=0.0)
    print(f"{label}: {len(errs)} served outputs vs the direct forward, "
          f"max_abs_err {worst:.3e} (must be 0)")
    if worst != 0:
        raise SystemExit(f"{label}: served outputs differ from the direct "
                         f"forward by {worst:.3e}")


def replicated_plan(graph, budget):
    """The placement DP's cut over STAGES devices, the stages of largest
    modeled time given one more device each until ``budget`` devices are
    used: a 4-stage cut with replicated bottleneck stages."""
    base = plan(DeploymentSpec(strategy="placement", device_budget=STAGES),
                graph=graph)
    reps = [1] * base.n_stages
    slowest = sorted(range(base.n_stages),
                     key=lambda i: -base.stage_times_s[i])
    for i in slowest[:budget - base.n_devices]:
        reps[i] += 1
    return PlacementPlan.from_cuts(graph, base.cuts, strategy="replicated",
                                   replicas=reps)


def run_chaos_phase(m, params, reqs, dev, hedge_after_s,
                    interval_s=FT_INTERVAL_S, kill_at_s=FT_KILL_AT_S):
    """ResNet50 over a replicated 4-stage plan on FT_BUDGET devices, served
    with stage-loss retries, hedging and a HealthMonitor, while a
    ChaosMonkey (getter: the server's live executor) kills one replica of
    each replicated stage and then the last replica of the second: the
    monitor replans the survivors through ElasticPlanner and hot-swaps.
    The requests arrive every ``interval_s``.  Requires 3 kills applied,
    1 replan, 0 lost and 0 misordered, and every completed output equal
    to the direct forward."""
    graph = m.to_layer_graph()
    placed = plan(DeploymentSpec(strategy="placement",
                                 device_budget=FT_BUDGET), graph=graph)
    print(f"chaos: the placement DP over {FT_BUDGET} devices cuts "
          f"{graph.name} into {placed.n_stages} stages, replicas "
          f"{list(placed.replica_counts)}")
    pl0 = replicated_plan(graph, FT_BUDGET)
    spec = DeploymentSpec(model=f"cnn:{CNN}", strategy="placement",
                          device_budget=FT_BUDGET, stage_loss_retries=2,
                          hedge_after=hedge_after_s)

    def builder(p):
        return serve.cnn_stage_fns(m, params, p, dev)

    dep = Deployment.from_plan(pl0, spec, graph=graph,
                               stage_fn_builder=builder)
    a, b = [i for i, k in enumerate(pl0.replica_counts) if k > 1][:2]
    events = [ChaosEvent(kill_at_s[0], "kill_replica", a, 1),
              ChaosEvent(kill_at_s[1], "kill_replica", b, 1),
              ChaosEvent(kill_at_s[2], "kill_replica", b, 0)]
    direct = [m.apply(params, r[m.INPUT]) for r in reqs]
    _build.reset_launches()
    with dep.serve() as server:
        server.serve_batch(reqs[:1])            # warm-up
        server.start()
        server.snapshot()
        mon = HealthMonitor(server, ElasticPlanner(graph, spec=spec),
                            builder, policy=FaultPolicy(
                                heartbeat_timeout_s=FT_HEARTBEAT_S,
                                poll_interval_s=0.01)).start()
        monkey = ChaosMonkey(lambda: server.executor, events).start()
        t0 = time.perf_counter()
        pending = []
        for i, r in enumerate(reqs):
            pending.append(server.submit(r))
            time.sleep(max(0.0, t0 + (i + 1) * interval_s
                           - time.perf_counter()))
        lost = sum(1 for r in pending if not r.event.wait(120))
        seconds = time.perf_counter() - t0
        snap = server.snapshot()
        health = server.executor.health_snapshot()
        monkey.join(timeout=10)
        mon.stop()
        pl1 = server.plan
    counts = read_counts()
    failed = sum(1 for r in pending if r.event.is_set() and r.error)
    completed = sum(1 for r in pending if r.event.is_set() and not r.error)
    retried = sum(1 for r in pending if r.retries)
    misordered = exit_misordered(pending)
    lat = snap["latency"]
    kills = [(ev.kind, ev.stage, ev.slot, ok) for ev, ok in monkey.applied]
    print(f"chaos plan before: {pl0.describe()}")
    print(f"chaos plan after: {pl1.describe()}")
    print(f"chaos: kills applied {kills}; replans {mon.replans}; "
          f"monitor kills {mon.kills}")
    print(f"chaos: {len(reqs)} requests every {interval_s * 1e3:.0f} ms in "
          f"{seconds * 1e3:.1f} ms: completed {completed}, failed {failed}, "
          f"lost {lost}, misordered {misordered}, retried {retried}; "
          f"p50/p95 {lat['p50_s'] * 1e3:.3f} / {lat['p95_s'] * 1e3:.3f} ms "
          f"(n={lat['n']}); the final executor's hedges {health['hedges']} "
          f"after {hedge_after_s * 1e3:.2f} ms and re-dispatches "
          f"{health['redispatches']}")
    check_outputs("chaos", m, pending, direct)
    check_counts("chaos serving", counts, {})
    if not (sum(ok for *_, ok in kills) == 3 and len(mon.replans) == 1
            and lost == 0 and misordered == 0
            and completed + failed == len(reqs)):
        raise SystemExit(f"chaos: kills {kills}, replans {mon.replans}, "
                         f"lost {lost}, misordered {misordered}")
    return {"plan_before": {"cuts": list(pl0.cuts),
                            "replicas": list(pl0.replica_counts)},
            "plan_after": {"cuts": list(pl1.cuts),
                           "replicas": list(pl1.replica_counts)},
            "kills": kills, "replans": mon.replans,
            "completed": completed, "failed": failed, "lost": lost,
            "misordered": misordered, "retried": retried,
            "p50_ms": lat["p50_s"] * 1e3, "p95_ms": lat["p95_s"] * 1e3,
            "n": lat["n"], "seconds": seconds, "hedges": health["hedges"],
            "hedge_after_ms": hedge_after_s * 1e3,
            "redispatches": health["redispatches"]}


def run_ft_prefill(arch, hedge_after_ms, argv=()):
    """Full-width qwen3-1.7b prefill through ``serve.run`` over the
    placement plan of FT_BUDGET devices with stage-loss retries, hedging
    after ``hedge_after_ms`` and a deadline no request should reach.  The
    first output must be within 2e-2 of the direct forward, and
    flash_attention's launches must equal layers x forwards plus, for each
    hedged duplicate the executor reports, its stage's layers."""
    args = serve.parse_args(
        ["--arch", arch, "--device-budget", str(FT_BUDGET),
         "--stage-loss-retries", "1", "--hedge-after-ms",
         f"{hedge_after_ms}", "--deadline-ms", f"{FT_DEADLINE_MS}",
         "--requests", str(REQUESTS), "--seq", str(SEQ), *argv])
    _build.reset_launches()
    res = serve.run(args)
    counts = read_counts()
    cfg, pl, snap = res["cfg"], res["plan"], res["snapshot"]
    blocks = serve.stage_block_counts(pl, cfg.n_layers)
    hedges = snap["health"]["hedges"]
    forwards = args.requests + 2        # warm-up, requests, direct reference
    expect = cfg.n_layers * forwards + sum(h * n for h, n in zip(hedges,
                                                                 blocks))
    lat = snap["latency"]
    print(f"fault-tolerant prefill plan: {pl.describe()}; blocks per stage "
          f"{blocks}")
    print(f"fault-tolerant prefill: {len(res['outs'])} requests in "
          f"{res['seconds'] * 1e3:.2f} ms ({snap['throughput_rps']:.2f} "
          f"req/s); p50/p95 {lat['p50_s'] * 1e3:.2f} / "
          f"{lat['p95_s'] * 1e3:.2f} ms; hedges {hedges} after "
          f"{hedge_after_ms:.2f} ms; failed {snap['failed']}; pipeline vs "
          f"direct max err {res['max_err']:.2e}")
    print(f"fault-tolerant prefill flash_attention launches: "
          f"{counts['flash_attention']} = {cfg.n_layers} layers x "
          f"{forwards} forwards + hedged stage executions {hedges} x "
          f"blocks {blocks}")
    if not (res["max_err"] < 2e-2 and snap["failed"] == 0):
        raise SystemExit(f"fault-tolerant prefill: err {res['max_err']:.2e}"
                         f" or {snap['failed']} failed")
    check_counts("fault-tolerant prefill", counts,
                 {"flash_attention": expect})
    return {"plan": {"cuts": list(pl.cuts),
                     "replicas": list(pl.replica_counts)},
            "blocks": blocks, "hedges": hedges,
            "hedge_after_ms": hedge_after_ms, "max_err": res["max_err"],
            "rps": snap["throughput_rps"], "p50_ms": lat["p50_s"] * 1e3,
            "p95_ms": lat["p95_s"] * 1e3,
            "flash_attention": counts["flash_attention"]}


def stage_times_of(tmap, graph, pl):
    depth = graph.depths()
    return [sum(tmap.get(d, 0.0) for d in {depth[n] for n in layers})
            for layers in pl.stage_layers]


def err_pct(got, ref):
    """The plan report's ``vs trace`` form: mean over stages of
    |got - ref| / ref, in percent."""
    rel = [abs(g - r) / r for g, r in zip(got, ref) if r > 0]
    return sum(rel) / len(rel) * 100 if rel else -1.0


def run_selfheal_phase(m, params, trace, dev, batches=HEAL_BATCHES,
                       batch=HEAL_BATCH):
    """ResNet50 over the analytic balanced STAGES-stage plan under
    ``dep.self_heal(canaries)``, its windows driven by ``tick()`` after
    each batch of the stream (deterministic in windows).  Prints each
    window (req/s, per-item stage busy, drift, state), the controller's
    windows, commits, rollbacks, state and events, both plans, and the
    live trace's per-stage times beside the card trace's.  Every served
    output must equal the direct forward."""
    graph = m.to_layer_graph()
    spec = DeploymentSpec(model=f"cnn:{CNN}", stages=STAGES,
                          strategy="balanced", drift_threshold=HEAL_DRIFT,
                          canary_requests=HEAL_CANARIES)
    dep = serve.deploy_cnn(m, params, spec, dev)
    reqs = serve.cnn_requests(m, batches * batch, dev, seed=2)
    canaries = serve.cnn_requests(m, HEAL_CANARIES, dev, seed=3)
    direct = [m.apply(params, r[m.INPUT]) for r in reqs]
    pl0 = dep.plan
    windows = []
    _build.reset_launches()
    with dep.serve() as server:
        server.serve_batch(reqs[:1])            # warm-up
        server.start()
        server.snapshot()
        healer = dep.self_heal(canaries)        # no thread: tick() drives
        pending = []
        for k in range(batches):
            ex = server.executor
            busy0, items0 = ex.busy_snapshot(), ex.items_snapshot()
            t0 = time.perf_counter()
            part = [server.submit(r)
                    for r in reqs[k * batch:(k + 1) * batch]]
            if not all(r.event.wait(120) for r in part):
                raise SystemExit(f"self-heal: batch {k} timed out")
            wall = time.perf_counter() - t0
            busy = [b - a for a, b in zip(busy0, ex.busy_snapshot())]
            items = [b - a for a, b in zip(items0, ex.items_snapshot())]
            cuts = list(server.plan.cuts)
            drift = healer.tick()
            per_item = [bz / max(1, n) * 1e3 for bz, n in zip(busy, items)]
            windows.append({"cuts": cuts, "rps": batch / wall,
                            "stage_ms_per_item": per_item,
                            "bottleneck_ms": max(per_item),
                            "drift": drift, "state": healer.state})
            print(f"self-heal window {k}: cuts {cuts}, "
                  f"{batch / wall:.2f} req/s, per-item stage busy ms "
                  f"{[round(t, 4) for t in per_item]}, drift "
                  f"{'-' if drift is None else round(drift, 4)}, state "
                  f"{healer.state}")
            pending += part
        pl1 = server.plan
    counts = read_counts()
    check_outputs("self-heal", m, pending, direct)
    check_counts("self-heal serving", counts, {})
    if any(r.error is not None for r in pending):
        raise SystemExit("self-heal: requests failed")
    live = healer.trace.trace().depth_time_map()
    card = trace.depth_time_map()
    stages = {}
    for label, pl in (("before", pl0), ("after", pl1)):
        lv = stage_times_of(live, graph, pl)
        cd = stage_times_of(card, graph, pl)
        stages[label] = {"cuts": list(pl.cuts),
                         "live_stage_ms": [t * 1e3 for t in lv],
                         "card_trace_stage_ms": [t * 1e3 for t in cd],
                         "live_vs_card_trace_err_pct": err_pct(lv, cd)}
        print(f"self-heal plan {label}: {pl.describe()}; live-trace stage "
              f"ms {[round(t * 1e3, 4) for t in lv]} vs card-trace stage ms "
              f"{[round(t * 1e3, 4) for t in cd]} (live vs card trace: "
              f"{err_pct(lv, cd):.1f}% err)")
    first = next((i for i, w in enumerate(windows)
                  if w["cuts"] != windows[0]["cuts"]), len(windows))
    phases = {"before": windows[:first], "after": windows[first:]}
    summary = {}
    for label, ws in phases.items():
        if ws:
            summary[label] = {
                "windows": len(ws),
                "rps": sum(w["rps"] for w in ws) / len(ws),
                "bottleneck_ms": sum(w["bottleneck_ms"] for w in ws)
                / len(ws)}
    print(f"self-heal: {healer.windows} windows, {healer.commits} commits, "
          f"{healer.rollbacks} rollbacks (state={healer.state}); mean over "
          f"windows before / after the first commit: {summary}")
    print(f"self-heal events: {healer.events}")
    live_plan = measure_live_plan(m, params, dep, healer, reqs[:CNN_REQUESTS],
                                  direct, canaries, dev)
    return {"windows": healer.windows, "commits": healer.commits,
            "rollbacks": healer.rollbacks, "state": healer.state,
            "events": healer.events, "per_window": windows,
            "before_after": summary, "stages": stages,
            "live_plan": live_plan}


def measure_live_plan(m, params, dep, healer, reqs, direct, canaries, dev):
    """The plan the controller derives from the live trace (its replan,
    redone: the spec's stage count, the time-balancing replan strategy,
    the live trace as the cost source), measured apart from the canary's
    verdict: its canary per-item stage busy cold (a fresh executor, as the
    controller runs it) and warm (the same executor again), and the stream
    served over the incumbent and over it in turns (incumbent, live, live,
    incumbent), every output equal to the direct forward."""
    graph = dep.graph
    shaped = dataclasses.replace(
        dep.spec.with_stages(dep.plan.n_devices),
        strategy=healer.policy.replan_strategy, objective=None)
    cand = plan(shaped, graph=graph,
                cost_source=healer.trace.cost_source("trace"),
                attach_report=False)

    def builder(p):
        return serve.cnn_stage_fns(m, params, p, dev)

    with PipelineExecutor.for_plan(cand, builder(cand),
                                   name_prefix="canary") as ex:
        _, cold = ex.run_batch(canaries, collect_stage_times=True)
        _, warm = ex.run_batch(canaries, collect_stage_times=True)
    cold = [b / len(canaries) * 1e3 for b in cold]
    warm = [b / len(canaries) * 1e3 for b in warm]
    print(f"live-trace plan: {cand.describe()}; canary per-item stage busy "
          f"ms cold {[round(t, 4) for t in cold]}, warm "
          f"{[round(t, 4) for t in warm]}")
    deps = {"incumbent": dep,
            "live": Deployment.from_plan(cand, dep.spec, graph=graph,
                                         stage_fn_builder=builder)}
    served = {"incumbent": [], "live": []}
    for label in ("incumbent", "live", "live", "incumbent"):
        outs, snap, seconds = serve.serve_stream(deps[label], reqs)
        err = max((o[m.output] - d).abs().max().item()
                  for o, d in zip(outs, direct))
        busy = snap["stage_busy_s"]
        served[label].append({"rps": snap["throughput_rps"],
                              "stage_busy_s": busy,
                              "p50_ms": snap["latency"]["p50_s"] * 1e3,
                              "p95_ms": snap["latency"]["p95_s"] * 1e3})
        print(f"self-heal {label} plan served: {len(reqs)} requests, "
              f"{snap['throughput_rps']:.2f} req/s, stage busy (s) "
              f"{[round(b, 5) for b in busy]}, balance (mean/max) "
              f"{stage_balance_metrics(busy)['balance']:.3f}; served vs "
              f"direct max_abs_err {err:.3e} (must be 0)")
        if err != 0:
            raise SystemExit(f"self-heal {label} plan: served outputs "
                             f"differ from the direct forward by {err:.3e}")
    return {"cuts": list(cand.cuts), "canary_cold_ms": cold,
            "canary_warm_ms": warm, "served": served}


def run_fleet_phase(members, dev, windows=FLEET_WINDOWS):
    """A FleetSpec of the members (name, model ref, model, weights, share,
    p95 SLO ms) over FT_BUDGET devices, each served by ``cnn_stage_fns``: share-
    proportional traffic for ``windows`` windows, then the first member's
    load tripled, the autoscaler ticked after every window (as
    ``serve.run_fleet``).  Prints the pool split before and after, the
    autoscaler's events, attainment and the audit; requires 0 lost and 0
    misordered and every output equal to its member's direct forward."""
    fspec = FleetSpec(members=tuple(
        FleetMemberSpec(name, DeploymentSpec(model=ref, strategy="balanced",
                                             slo_p95_ms=slo), share=share)
        for name, ref, _, _, share, slo in members), device_budget=FT_BUDGET)
    models = {name: (model, params) for name, _, model, params, *_ in members}
    pools, direct = {}, {}
    for name, (model, params) in models.items():
        pools[name] = serve.cnn_requests(model, FLEET_POOL, dev, seed=4)
        direct[name] = [model.apply(params, r[model.INPUT])
                        for r in pools[name]]
    _build.reset_launches()
    fleet = deploy_fleet(
        fspec, graphs={n: mp[0].to_layer_graph() for n, mp in models.items()},
        stage_fn_builders={
            n: (lambda p, mp=mp: serve.cnn_stage_fns(mp[0], mp[1], p, dev))
            for n, mp in models.items()})
    counts0 = fleet.device_counts()
    for name, dep in fleet.deployments.items():
        print(f"fleet member {name}: {dep.plan.describe()}")
    print(f"fleet pool split: {counts0} (mode={fleet.placement.mode}, "
          f"worst modeled norm {fleet.placement.worst_norm:.3f})")
    base = {m.name: max(1, round(2 * m.share)) for m in fspec.members}
    shifted = dict(base)
    first = fspec.members[0].name
    shifted[first] = 3 * base[first]
    stats = {n: {"submitted": 0, "completed": 0, "failed": 0, "lost": 0,
                 "within_slo": 0, "lat": [], "exit": [], "err": 0.0}
             for n in models}
    lock = threading.Lock()

    def tap(name, i):
        def on_done(req):
            if req.error is None:
                with lock:
                    stats[name]["exit"].append(i)
        return on_done

    with fleet:
        for n in models:                        # warm-up, not counted
            req = fleet.submit(n, pools[n][0])
            if not req.event.wait(120) or req.error is not None:
                raise SystemExit(f"fleet: warm-up of {n} failed")
        for rates in (base, shifted):
            for _ in range(windows):
                window = []
                for name, rate in rates.items():
                    for _ in range(rate):
                        st = stats[name]
                        i = st["submitted"]
                        st["submitted"] += 1
                        window.append((name, i, fleet.submit(
                            name, pools[name][i % FLEET_POOL],
                            on_done=tap(name, i))))
                for name, i, req in window:
                    st = stats[name]
                    if not req.event.wait(120):
                        st["lost"] += 1
                        continue
                    if req.error is not None:
                        st["failed"] += 1
                        continue
                    model = models[name][0]
                    st["completed"] += 1
                    st["err"] = max(st["err"], (
                        req.result[model.output]
                        - direct[name][i % FLEET_POOL]).abs().max().item())
                    lat = req.t_done - req.t_submit
                    st["lat"].append(lat)
                    slo = fspec.member(name).spec.slo_p95_ms
                    st["within_slo"] += lat <= slo / 1e3
                if fleet.autoscaler is not None:
                    fleet.autoscaler.tick()
        counts1 = fleet.device_counts()
        events = ([] if fleet.autoscaler is None
                  else list(fleet.autoscaler.events))
    counts = read_counts()
    audit = {}
    for name, st in stats.items():
        lat = sorted(st["lat"])
        ex = st["exit"]
        audit[name] = {
            "submitted": st["submitted"], "completed": st["completed"],
            "failed": st["failed"], "lost": st["lost"],
            "misordered": sum(1 for a, b in zip(ex, ex[1:]) if b < a),
            "attainment": st["within_slo"] / max(1, st["submitted"]),
            "p50_ms": lat[len(lat) // 2] * 1e3 if lat else 0.0,
            "p95_ms": (lat[min(len(lat) - 1, int(0.95 * len(lat)))] * 1e3
                       if lat else 0.0),
            "served_vs_direct": st["err"]}
    print(f"fleet pool split {counts0} -> {counts1}; autoscaler events "
          f"{events}")
    print(f"fleet audit: {audit}")
    check_counts("fleet serving", counts, {})
    if not all(a["lost"] == 0 and a["misordered"] == 0
               and a["served_vs_direct"] == 0 for a in audit.values()):
        raise SystemExit(f"fleet: lost, misordered or wrong outputs: "
                         f"{audit}")
    return {"split_before": counts0, "split_after": counts1,
            "events": events, "audit": audit}


def to_card(tree):
    if isinstance(tree, dict):
        return {k: to_card(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_card(v) for v in tree]
    return tree.to("cuda")


def greedy_decode(cfg, params, prompts, n_new, max_len, token_by_token,
                  cache=None):
    """Greedy decode through ``api.decode`` on the card: ``prompts`` (B, P)
    prefilled into the cache in one call (or fed token by token), then
    ``n_new`` tokens.  Returns (tokens (B, n_new) on the CPU, decode calls,
    prefill seconds, seconds per generated token after the first), on the
    host clock with the card synchronized.  ``cache``: a prepared one (a
    whisper cache built from its memory) in place of ``api.init_cache``'s."""
    dev = torch.device("cuda")
    if cache is None:
        cache = api.init_cache(cfg, prompts.shape[0], max_len, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = [prompts[:, i:i + 1] for i in range(prompts.shape[1])] \
        if token_by_token else [prompts]
    for tok in steps:
        logits, cache = api.decode(cfg, params, tok.to(dev), cache)
    toks = [logits[:, -1].argmax(-1, keepdim=True)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    while len(toks) < n_new:
        logits, cache = api.decode(cfg, params, toks[-1], cache)
        toks.append(logits[:, -1].argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (torch.cat(toks, 1).cpu(), len(steps) + n_new - 1, t1 - t0,
            (t2 - t1) / max(1, n_new - 1))


def check_family_on_card(arch, seq, prompt_len, n_new, max_len,
                         token_by_token, **over):
    """The arch's smoke config (fp32; ``over``: fields replaced) on the
    card against the same weights on the CPU, where the kernels' plain
    versions run: the forward of a (2, seq) batch (vlm: patch embeddings
    and text; encdec: frames and tokens), and a greedy decode loop of 2
    rows through the KV cache (encdec: built from each device's encoder
    memory) or the recurrent state; logits at every step within 1e-4
    (summation order over a few layers) and equal greedy tokens."""
    cfg = dataclasses.replace(configs.get(arch).smoke_config(), **over)
    cpu = torch.device("cpu")
    params = api.init(cfg, cpu, torch.Generator(cpu).manual_seed(0))
    card = to_card(params)
    batch = concrete_batch(cfg, seq, 2, kind="prefill")
    err = (api.forward(cfg, card, batch).cpu()
           - api.forward(cfg, params, batch)).abs().max().item()
    prompt_batch = concrete_batch(cfg, prompt_len, 2, kind="prefill")
    prompt = prompt_batch["tokens"]
    runs = []
    for dev, p in ((cpu, params), (torch.device("cuda"), card)):
        cache = (whisper_cache(cfg, p, prompt_batch["frames"], max_len)
                 if cfg.family == "encdec" else
                 api.init_cache(cfg, 2, max_len, dev))
        steps = ([prompt[:, i:i + 1] for i in range(prompt.shape[1])]
                 if token_by_token else [prompt])
        seen, toks = [], []
        for i in range(len(steps) + n_new):
            tok = steps[i] if i < len(steps) else toks[-1]
            logits, cache = api.decode(cfg, p, tok.to(dev), cache)
            seen.append(logits[:, -1:].cpu())
            toks.append(logits[:, -1].argmax(-1, keepdim=True).cpu())
        runs.append((torch.cat(seen, 1), torch.cat(toks, 1)))
    dec_err = (runs[0][0] - runs[1][0]).abs().max().item()
    same = torch.equal(runs[0][1], runs[1][1])
    label = arch + "".join(f" {k}={v}" for k, v in over.items())
    print(f"{label} smoke, card vs CPU (plain versions): forward max_abs_err "
          f"{err:.3e}, decode loop ({'token by token' if token_by_token else 'prefilled'} "
          f"{prompt_len}-token prompt + {n_new} steps, max_len {max_len}) "
          f"max_abs_err {dec_err:.3e} (tol 1e-4), greedy tokens equal={same}")
    if not (err <= 1e-4 and dec_err <= 1e-4 and same
            and torch.isfinite(runs[1][0]).all()):
        raise SystemExit(f"{arch} on the card disagrees with the CPU: "
                         f"{err}, {dec_err}, tokens equal={same}")


def read_counts():
    return {name: _build.launches(name) for name in KERNELS}


def check_counts(label, counts, expect):
    """Every kernel's launches in a run equal ``expect`` (absent: 0)."""
    want = {name: expect.get(name, 0) for name in counts}
    print(f"{label} launches: {counts} (expected {want})")
    if counts != want:
        raise SystemExit(f"{label}: kernel launches {counts} != {want}")


def print_plan(cfg, seq=SEQ):
    """The arch's 4-stage balanced plan over its full-width graph."""
    pl = plan(DeploymentSpec(stages=STAGES, strategy="balanced"),
              graph=lm_graph.lm_layer_graph(cfg, seq_len=seq))
    print(f"{cfg.name} plan:", pl.describe())
    print(f"{cfg.name} report:", pl.report.describe())


def teacher_rows(cfg, params, prompts, outs, frames=None):
    """Logits of the full forward of prompt + served tokens (whisper:
    against ``frames``) at the positions that predicted each served
    token: (B, n, V)."""
    batch = {"tokens": torch.cat([prompts, outs], 1)}
    if frames is not None:
        batch["frames"] = frames
    logits = api.forward(cfg, params, batch)
    p = prompts.shape[1]
    return logits[:, p - 1:p - 1 + outs.shape[1]]


def check_teacher(name, rows, rows32, outs, min_decisive):
    """Served bf16 tokens ``outs`` (B, n) against the teacher's logits at
    the positions that predicted them, ``rows`` (B, n, V) in bf16 and
    ``rows32`` in fp32 (the same weights): each served token's gap to its
    position's largest logit within twice the bf16 forward's largest
    deviation from the fp32 evaluation.  At least TEACHER_AGREE of the
    served tokens must be the teacher's argmax at the positions where bf16
    can resolve the argmax: the teacher's top-2 margin exceeds twice that
    position's largest bf16-vs-fp32 deviation (elsewhere two bf16
    evaluations may rank a near-tie either way; the gap bound still holds
    there), and there must be at least ``min_decisive`` such positions."""
    dev = (rows - rows32).abs().amax(-1)                # per position
    noise = dev.max().item()
    tk = outs.to(rows.device)[..., None]
    worst = (rows.max(-1).values - rows.gather(-1, tk)[..., 0]).max().item()
    top2 = rows.topk(2, dim=-1).values
    decisive = ((top2[..., 0] - top2[..., 1]) > 2 * dev).cpu()
    hit = rows.argmax(-1).cpu() == outs
    agree, total = int(hit.sum()), outs.numel()
    agree_dec, n_dec = int(hit[decisive].sum()), int(decisive.sum())
    print(f"{name} teacher-forced (bf16): largest gap {worst:.4e} "
          f"(bound 2 x {noise:.4e}, the bf16 forward's largest deviation "
          f"from fp32 on these positions; {TEACHER_TOL:g} "
          f"{'met' if worst <= TEACHER_TOL else 'not met'}); served token "
          f"= teacher argmax {agree}/{total} overall, {agree_dec}/{n_dec} "
          f"where the top-2 margin exceeds twice the position's deviation "
          f"(at least {min_decisive} such positions required)")
    if not (worst <= 2 * noise and n_dec >= min_decisive
            and agree_dec >= TEACHER_AGREE * n_dec):
        raise SystemExit(f"{name}: served tokens fail the teacher-forced "
                         f"check: gap {worst:.3e} > {2 * noise:.3e} or "
                         f"argmax agreement {agree_dec}/{n_dec} (fewer than "
                         f"{min_decisive} decisive positions, or "
                         f"below {TEACHER_AGREE:.0%})")


def check_fp32_loop(name, rows32, outs32, outs, how="at full width"):
    """The decode loop repeated in fp32: every token ``outs32`` (B, n)
    within TEACHER_TOL of its position's largest logit in the fp32
    teacher's ``rows32``; ``outs``: the bf16 tokens, for the count."""
    tk = outs32.to(rows32.device)[..., None]
    worst32 = (rows32.max(-1).values
               - rows32.gather(-1, tk)[..., 0]).max().item()
    print(f"{name} decode loop in fp32 {how}: largest teacher-forced gap "
          f"{worst32:.4e} over {outs32.numel()} tokens (tol "
          f"{TEACHER_TOL:g}); fp32 tokens = bf16 tokens "
          f"{int((outs32 == outs).sum())}/{outs.numel()}")
    if not worst32 <= TEACHER_TOL:
        raise SystemExit(f"{name}: fp32 decode loop fails the "
                         f"teacher-forced check: {worst32:.3e}")


def teacher_forced(cfg, params, prompts, outs, n_new, max_len,
                   token_by_token):
    """The served bf16 tokens against the full forward of prompt + tokens
    (:func:`check_teacher`, at least TEACHER_MIN_DECISIVE decisive
    positions), then the same decode loop in fp32 at full width
    (:func:`check_fp32_loop`)."""
    cfg32, p32 = dataclasses.replace(cfg, dtype=torch.float32), \
        to_fp32(params)
    check_teacher(cfg.name, teacher_rows(cfg, params, prompts, outs),
                  teacher_rows(cfg32, p32, prompts, outs), outs,
                  TEACHER_MIN_DECISIVE)
    outs32, _, _, _ = greedy_decode(cfg32, p32, prompts, n_new, max_len,
                                    token_by_token)
    check_fp32_loop(cfg.name, teacher_rows(cfg32, p32, prompts, outs32),
                    outs32, outs)


def run_rwkv6_path():
    """rwkv6-1.6b at full width: plan, then 4 x 1024-token prompts
    prefilled into the state and 64 greedy tokens each through the model
    API, launch counts, teacher forcing.  Returns the rwkv6_scan count."""
    cfg = configs.get(RWKV_ARCH).config()
    print_plan(cfg)
    params = api.init(cfg, "cuda", torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (RWKV_STREAMS, RWKV_PROMPT), dtype=np.int64))
    _build.reset_launches()
    outs, calls, prefill_s, step_s = greedy_decode(
        cfg, params, prompts, RWKV_NEW, RWKV_PROMPT + RWKV_NEW, False)
    counts = read_counts()
    print(f"{cfg.name}: prefill of {RWKV_STREAMS} x {RWKV_PROMPT} tokens "
          f"into the state {prefill_s * 1e3:.3f} ms, then {RWKV_NEW} tokens "
          f"each at {step_s * 1e3:.3f} ms a step ({RWKV_STREAMS} rows); "
          f"{calls} decode calls")
    check_counts(cfg.name, counts, {"rwkv6_scan": cfg.n_layers * calls})
    teacher_forced(cfg, params, prompts, outs, RWKV_NEW,
                   RWKV_PROMPT + RWKV_NEW, False)
    return counts["rwkv6_scan"]


def run_gemma_path():
    """recurrentgemma-9b at full width: plan, one forward of a (2, 1024)
    batch, a decode loop of 16 rows (32-token prompt token by token + 32
    greedy tokens, max_len 64), launch counts, teacher forcing.  Returns
    the launch counts of the forward and of the decode loop."""
    cfg = configs.get(GEMMA_ARCH).config()
    print_plan(cfg)
    n_rec = cfg.n_layers - cfg.n_layers // cfg.attn_every
    n_attn = cfg.n_layers // cfg.attn_every
    params = api.init(cfg, "cuda", torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, GEMMA_FORWARD, dtype=np.int64))}
    _build.reset_launches()
    logits = api.forward(cfg, params, batch, last_token_only=True)
    torch.cuda.synchronize()
    fwd_counts = read_counts()
    check_counts(f"{cfg.name} forward", fwd_counts,
                 {"rglru_scan": n_rec, "flash_attention": n_attn})
    if not (logits.shape == (GEMMA_FORWARD[0], 1, cfg.vocab)
            and bool(torch.isfinite(logits).all())):
        raise SystemExit(f"{cfg.name}: forward logits not finite "
                         f"{tuple(logits.shape)}")
    t0 = time.perf_counter()
    for _ in range(3):
        api.forward(cfg, params, batch, last_token_only=True)
    torch.cuda.synchronize()
    print(f"{cfg.name}: forward of a {GEMMA_FORWARD} batch "
          f"{(time.perf_counter() - t0) / 3 * 1e3:.3f} ms (last token "
          f"logits finite)")

    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (GEMMA_ROWS, GEMMA_PROMPT), dtype=np.int64))
    _build.reset_launches()
    outs, calls, prefill_s, step_s = greedy_decode(
        cfg, params, prompts, GEMMA_NEW, GEMMA_MAX_LEN, True)
    dec_counts = read_counts()
    print(f"{cfg.name}: {GEMMA_PROMPT}-token prompt fed token by token in "
          f"{prefill_s * 1e3:.3f} ms, then {GEMMA_NEW} tokens at "
          f"{step_s * 1e3:.3f} ms a step ({GEMMA_ROWS} rows, max_len "
          f"{GEMMA_MAX_LEN}); {calls} decode calls")
    check_counts(f"{cfg.name} decode", dec_counts,
                 {"rglru_scan": n_rec * calls, "flash_decode": n_attn * calls})
    teacher_forced(cfg, params, prompts, outs, GEMMA_NEW, GEMMA_MAX_LEN, True)
    return fwd_counts, dec_counts


def run_prefill_path(arch):
    """The prefill serving run of ``arch`` at full width (the balanced
    4-stage plan, REQUESTS streamed requests of SEQ tokens, the config's
    own MoE capacity) with every kernel's count set to 0 just before and
    read just after: the first output against the direct forward, and
    flash_attention's launches = layers x forwards.  Returns serve.run's
    results and the flash_attention count."""
    args = serve.parse_args(["--arch", arch, "--stages", str(STAGES),
                             "--requests", str(REQUESTS), "--seq", str(SEQ),
                             "--strategy", "balanced", "--device", CARD])
    _build.reset_launches()
    res = serve.run(args)
    counts = read_counts()
    launches = counts["flash_attention"]

    cfg, pl, snap = res["cfg"], res["plan"], res["snapshot"]
    print(f"{arch} plan:", pl.describe())
    print(f"{arch} blocks per stage:",
          serve.stage_block_counts(pl, cfg.n_layers))
    busy = snap["stage_busy_s"]
    lat = snap["latency"]
    print(f"{arch}: served {len(res['outs'])} requests of {SEQ} tokens in "
          f"{res['seconds'] * 1e3:.2f} ms: "
          f"{snap['throughput_rps']:.2f} req/s, "
          f"{snap['throughput_rps'] * SEQ:.0f} tokens/s")
    print(f"{arch} latency p50/p95 (ms): {lat['p50_s'] * 1e3:.2f} / "
          f"{lat['p95_s'] * 1e3:.2f}")
    print(f"{arch} stage busy (s): {[round(b, 5) for b in busy]}, balance "
          f"(mean/max) {stage_balance_metrics(busy)['balance']:.3f}")
    print(f"{arch} pipeline vs direct max err: {res['max_err']:.2e}")
    forwards = args.requests + 2        # warm-up, requests, direct reference
    print(f"{arch} flash_attention launches: {launches} "
          f"({cfg.n_layers} layers x {forwards} forwards)")
    outs = res["outs"]
    if not all(o.shape == (1, 1, cfg.vocab) and bool(torch.isfinite(o).all())
               for o in outs):
        raise SystemExit(f"{arch}: served logits are not finite (1, 1, "
                         f"vocab)")
    if not res["max_err"] < 2e-2:
        raise SystemExit(f"{arch}: pipeline vs direct {res['max_err']:.2e} "
                         f">= 2e-2")
    check_counts(f"{arch} prefill serving", counts,
                 {"flash_attention": cfg.n_layers * forwards})
    return res, launches


def run_decode_path(arch):
    """The decode serving run of ``arch`` with both kernels' counts set to
    0 just before and read just after; checks counts, stream lengths and
    the teacher-forced correctness of the served tokens, then the same
    path in fp32.  A moe arch is served at the capacity that drops no
    token (:func:`no_drop`).  Returns the flash_decode and flash_attention
    launch counts."""
    per_stage = torch.cuda.get_device_properties(0).total_memory // STAGES
    argv = ["--arch", arch, "--workload", "decode", "--stages", str(STAGES),
            "--decode-concurrency", str(DECODE_SLOTS),
            "--max-context", str(DECODE_CONTEXT), "--prompt-len", str(SEQ),
            "--max-new-tokens", str(DECODE_NEW),
            "--requests", str(DECODE_STREAMS),
            "--plan-device-bytes", str(per_stage), "--device", CARD]
    full = configs.get(arch).config()
    if full.family == "moe":
        cf = no_drop(full).capacity_factor
        argv += ["--moe-capacity-factor", str(cf)]
        print(f"{arch} decode serving and its teacher at capacity_factor "
              f"{cf:g} (n_experts / top_k: no token dropped; the config's "
              f"{full.capacity_factor:g} is checked on the prefill path)")
    args = serve.parse_args(argv)
    _build.reset_launches()
    res = serve.run_decode(args)
    counts = read_counts()
    fa_launches, fd_launches = counts["flash_attention"], counts["flash_decode"]

    cfg, pl, snap, warm = (res["cfg"], res["plan"], res["snapshot"],
                           res["warmup"])
    rep = pl.report
    outs = res["outs"]
    print(f"{arch} decode plan:", pl.describe())
    print(f"{arch} decode blocks per stage:",
          serve.stage_block_counts(pl, cfg.n_layers))
    print(f"{arch} planning device: {per_stage} bytes per stage (card memory / "
          f"{STAGES}); stage_kv_bytes {list(rep.stage_kv_bytes)}, "
          f"kv_headroom_pct {rep.kv_headroom_pct:.3f}")
    steps = warm["steps"] + snap["steps"]
    prefills = warm["admitted"] + snap["admitted"]
    gaps = snap["tokens"] - len(outs)
    busy = res["stage_busy_s"]
    print(f"{arch} decode: {len(outs)} streams x {DECODE_NEW} tokens of "
          f"{SEQ}-token prompts in {res['seconds'] * 1e3:.2f} ms: "
          f"{snap['tokens'] / res['seconds']:.2f} tokens/s over the stream")
    print(f"{arch} decode inter-token p50/p95 (ms): "
          f"{snap['inter_token_p50_s'] * 1e3:.3f} / "
          f"{snap['inter_token_p95_s'] * 1e3:.3f} ({gaps} gaps)")
    print(f"{arch} decode steps: {snap['steps']} in the stream, {steps} with the "
          f"warm-up; prefills {prefills}")
    print(f"{arch} decode stage busy (s): {[round(b, 5) for b in busy]}, balance "
          f"(mean/max) {stage_balance_metrics(busy)['balance']:.3f}")
    print(f"{arch} decode modeled: {rep.decode_tokens_per_s:.2f} tokens/s, KV "
          f"headroom {rep.kv_headroom_pct:.3f}%")
    print(f"{arch} decode launches: flash_decode {fd_launches} ({cfg.n_layers} "
          f"layers x {steps} steps), flash_attention {fa_launches} "
          f"({cfg.n_layers} layers x {prefills} prefills)")

    if not all(len(o) == DECODE_NEW for o in outs):
        raise SystemExit(f"{arch}: decode streams returned {[len(o) for o in outs]} "
                         f"tokens, expected {DECODE_NEW} each")
    if steps == 0:
        raise SystemExit(f"{arch}: the decode run took no step")
    check_counts(f"{arch} decode serving", counts,
                 {"flash_decode": cfg.n_layers * steps,
                  "flash_attention": cfg.n_layers * prefills})

    check_served_tokens(res)
    check_fp32_decode_path(res)
    return fd_launches, fa_launches


def no_drop(cfg, seq=None):
    """A moe config at the capacity that drops no token (capacity_factor
    n_experts / top_k: an expert's capacity is the whole group) and, with
    ``seq``, one routing group of ``seq`` tokens (a group must divide the
    length; with no drops the grouping changes no token's output).  Other
    families: ``cfg``."""
    if cfg.family != "moe":
        return cfg
    cfg = dataclasses.replace(cfg,
                              capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg if seq is None else dataclasses.replace(cfg, moe_group=seq)


def teacher_logits(cfg, params, prompt, toks):
    """Logits of the full forward of prompt + tokens (the prefill path,
    flash_attention) at the positions that predicted each token."""
    seq = torch.from_numpy(np.concatenate([prompt, toks]).astype(
        np.int64))[None]
    cfg = no_drop(cfg, seq.shape[1])
    logits = api.forward(cfg, params, {"tokens": seq})[0]
    return logits[len(prompt) - 1:len(prompt) - 1 + len(toks)]


def token_gaps(rows, toks):
    """Per position: largest logit minus the logit of the given token."""
    tk = torch.as_tensor(toks, device=rows.device)
    return rows.max(-1).values - rows[torch.arange(len(toks)), tk]


def to_host(tree):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [x.cpu() for x in leaves])


def to_fp32(tree):
    if isinstance(tree, dict):
        return {k: to_fp32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_fp32(v) for v in tree]
    return tree.float()


def check_served_tokens(res):
    """Teacher forcing of the bf16 stream: the full forward of prompt +
    served tokens ranks each served token near its position's largest
    logit.  Two bf16 evaluations of the model (the batched decode steps
    and the 1088-token forward) differ by their rounding, so the bound is
    twice the bf16 forward's own largest deviation from the fp32
    evaluation of the same weights, measured here on the same positions;
    and at least TEACHER_AGREE of the served tokens must be the teacher's
    argmax."""
    cfg, params = res["cfg"], res["params"]
    cfg32, p32 = dataclasses.replace(cfg, dtype=torch.float32), \
        to_fp32(params)
    worst = noise = 0.0
    agree = total = 0
    for prompt, toks in zip(res["prompts"][:TEACHER_STREAMS],
                            res["outs"][:TEACHER_STREAMS]):
        rows = teacher_logits(cfg, params, prompt, toks)
        rows32 = teacher_logits(cfg32, p32, prompt, toks)
        noise = max(noise, (rows - rows32).abs().max().item())
        worst = max(worst, token_gaps(rows, toks).max().item())
        agree += int((rows.argmax(-1).cpu() == torch.as_tensor(toks)).sum())
        total += len(toks)
    print(f"{cfg.name} decode teacher-forced (bf16): largest gap between a served "
          f"token's logit and its position's largest logit {worst:.4e} "
          f"(bound 2 x {noise:.4e}, the bf16 forward's largest deviation "
          f"from fp32 on these positions; {TEACHER_TOL:g} "
          f"{'met' if worst <= TEACHER_TOL else 'not met'}); served token "
          f"= teacher argmax {agree}/{total}")
    if not (worst <= 2 * noise and agree >= TEACHER_AGREE * total):
        raise SystemExit(f"served tokens fail the teacher-forced check: "
                         f"gap {worst:.3e} > {2 * noise:.3e} or argmax "
                         f"agreement {agree}/{total} < {TEACHER_AGREE:.0%}")


def check_fp32_decode_path(res, n_new=16):
    """The decode path at full width in fp32 (the served weights upcast,
    the same stage cuts, the flash_decode kernel's fp32 instantiation):
    two streams in slots 1 and 2 of 3 (slot 0 idle), each served token
    within TEACHER_TOL of its position's largest logit in the fp32
    teacher-forced forward."""
    cfg, params, pl = res["cfg"], res["params"], res["plan"]
    cfg32, p32 = dataclasses.replace(cfg, dtype=torch.float32), \
        to_fp32(params)
    prompts = res["prompts"][:2]
    eng = PipelineDecodeEngine(cfg32, p32, n_slots=3,
                               max_context=DECODE_CONTEXT,
                               stage_blocks=serve.stage_block_counts(
                                   pl, cfg.n_layers))
    with eng:
        outs = [[eng.prefill(1 + j, p)] for j, p in enumerate(prompts)]
        ctx = [len(p) + 1 for p in prompts]
        while len(outs[0]) < n_new:
            for o, t in zip(outs, eng.step([1, 2], ctx,
                                           [o[-1] for o in outs])):
                o.append(t)
            ctx = [c + 1 for c in ctx]
    worst = max(token_gaps(teacher_logits(cfg32, p32, p, o), o).max().item()
                for p, o in zip(prompts, outs))
    print(f"{cfg.name} decode path in fp32 at full width: largest teacher-forced gap "
          f"{worst:.4e} over 2 streams x {n_new} tokens (tol "
          f"{TEACHER_TOL:g})")
    if not worst <= TEACHER_TOL:
        raise SystemExit(f"fp32 decode path fails the teacher-forced "
                         f"check: {worst:.3e} > {TEACHER_TOL:g}")


class Fp32Blocks:
    """A block list read as fp32 copies made one layer at a time, so a
    model evaluates in fp32 with one fp32 layer on the card beside its
    bf16 weights (the depth-cut archs' fp32 weights would not fit)."""

    def __init__(self, blocks):
        self.blocks = blocks

    def __len__(self):
        return len(self.blocks)

    def __iter__(self):
        return (to_fp32(bp) for bp in self.blocks)


def fp32_view(params):
    return {k: Fp32Blocks(v) if k == "blocks" else to_fp32(v)
            for k, v in params.items()}


def vlm_positions(n_patches, n_text):
    """qwen2-vl's M-RoPE streams (3, 1, P + n_text): the stub patches on a
    (1, VLM_GRID, VLM_GRID) (t, h, w) grid, then text at its index on all
    three streams, which is where the reference's decode step puts the
    next token (its cache length)."""
    i = torch.arange(n_patches)
    text = torch.arange(n_patches, n_patches + n_text)
    streams = [torch.zeros_like(i), i // VLM_GRID, i % VLM_GRID]
    return torch.stack([torch.cat([x, text]) for x in streams])[:, None]


def api_decode(cfg, params, batch, n_new, max_len):
    """``api.prefill`` of a (1, P) batch into the cache, then greedy
    decode steps through ``api.decode``: (tokens (1, n_new) on the CPU,
    decode calls)."""
    dev = torch.device(CARD)
    cache = api.init_cache(cfg, 1, max_len, dev)
    logits, cache = api.prefill(cfg, params, batch, cache,
                                last_token_only=True)
    toks = [logits[:, -1].argmax(-1, keepdim=True)]
    while len(toks) < n_new:
        logits, cache = api.decode(cfg, params, toks[-1], cache)
        toks.append(logits[:, -1].argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    return torch.cat(toks, 1).cpu(), n_new - 1


def api_teacher_rows(cfg, params, batch, outs):
    """Logits of the forward of the batch + the served tokens (vlm: its
    positions extended at the text's index) at the positions that
    predicted each served token: (1, n, V)."""
    n_new = outs.shape[1]
    full = dict(batch, tokens=torch.cat([batch["tokens"], outs], 1))
    if "positions" in batch:
        p = batch["positions"].shape[-1]
        full["positions"] = vlm_positions(cfg.n_patches,
                                          p - cfg.n_patches + n_new)
    n = full["tokens"].shape[1] + (cfg.n_patches if "embeds" in batch else 0)
    logits = api.forward(no_drop(cfg, n), params, full)
    p = n - n_new
    return logits[:, p - 1:p - 1 + n_new]


def run_api_model(arch, layers):
    """``arch`` at full width (``layers``: cut to its first that many
    layers, printed) with random bf16 weights from seed 0 through the
    model API: one forward of a (1, API_PROMPT) batch at the config's own
    MoE capacity (vlm: after its n_patches stub patch embeddings from a
    numpy seed, on the M-RoPE grid of :func:`vlm_positions`), then
    ``api.prefill`` of the same batch and API_STEPS greedy decode steps
    (moe at :func:`no_drop`'s capacity), each with launch counts, the
    served tokens teacher-forced in bf16 and the loop repeated in fp32
    (weights upcast a layer at a time).  Returns the flash_attention and
    flash_decode counts."""
    full = configs.get(arch).config()
    cfg = full if layers is None else dataclasses.replace(
        full, n_layers=layers)
    cut = ("" if layers is None else
           f"; cut in depth to {layers} of {full.n_layers} layers (the "
           f"full {full.n_layers} layers need "
           f"{api.param_count(full) * 2 / 1e9:.1f} GB in bf16)")
    params = api.init(cfg, CARD, torch.Generator(CARD).manual_seed(0))
    print(f"{arch}: {api.param_count(cfg) * 2 / 1e9:.1f} GB of bf16 weights "
          f"on the card ({api.active_param_count(cfg) / 1e9:.2f} B "
          f"parameters active a token){cut}")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, API_PROMPT), dtype=np.int64))}
    if cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (1, cfg.n_patches, cfg.d_model), dtype=np.float32)).to(
                device=CARD, dtype=cfg.dtype)
        batch["positions"] = vlm_positions(cfg.n_patches, API_PROMPT)

    _build.reset_launches()
    t0 = time.perf_counter()
    logits = api.forward(cfg, params, batch, last_token_only=True)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd = read_counts()
    check_counts(f"{arch} forward", fwd, {"flash_attention": cfg.n_layers})
    if not (logits.shape == (1, 1, cfg.vocab)
            and bool(torch.isfinite(logits).all())):
        raise SystemExit(f"{arch}: forward logits not finite "
                         f"{tuple(logits.shape)}")
    n_in = API_PROMPT + (cfg.n_patches if cfg.family == "vlm" else 0)
    print(f"{arch}: forward of a (1, {n_in}) batch in {fwd_s * 1e3:.1f} ms "
          f"(first call; last-token logits finite)")

    dcfg = no_drop(cfg)
    if dcfg is not cfg:
        print(f"{arch} decode loop and its teacher at capacity_factor "
              f"{dcfg.capacity_factor:g} (n_experts / top_k: no token "
              f"dropped; the forward above ran at the config's "
              f"{cfg.capacity_factor:g})")
    max_len = n_in + API_STEPS + 1
    _build.reset_launches()
    t0 = time.perf_counter()
    outs, steps = api_decode(dcfg, params, batch, API_STEPS + 1, max_len)
    loop_s = time.perf_counter() - t0
    dec = read_counts()
    print(f"{arch}: prefill + {steps} greedy decode steps in "
          f"{loop_s * 1e3:.1f} ms")
    check_counts(f"{arch} prefill + decode", dec,
                 {"flash_attention": cfg.n_layers,
                  "flash_decode": cfg.n_layers * steps})

    # teacher forcing: bf16 against the fp32 evaluation of the same
    # weights.  A MoE's bf16 and fp32 evaluations may route a token to
    # different experts (top-k choices within rounding of each other), so
    # they deviate by whole experts' outputs and few positions are
    # decisive: no minimum there; its fp32 loop is the firm check
    p32 = fp32_view(params)
    cfg32 = dataclasses.replace(dcfg, dtype=torch.float32)
    check_teacher(arch, api_teacher_rows(dcfg, params, batch, outs),
                  api_teacher_rows(cfg32, p32, batch, outs), outs,
                  0 if cfg.family == "moe" else API_MIN_DECISIVE)
    outs32, _ = api_decode(cfg32, p32, {
        k: v.float() if k == "embeds" else v for k, v in batch.items()},
        API_STEPS + 1, max_len)
    check_fp32_loop(arch, api_teacher_rows(cfg32, p32, batch, outs32),
                    outs32, outs, "(weights upcast a layer at a time)")
    return fwd["flash_attention"], dec["flash_decode"]


def check_whisper_kernels():
    """Both flash kernels at whisper-tiny's shapes (:data:`WHISPER_FA`,
    :data:`WHISPER_FD`) against their plain versions in bf16 and fp32,
    flash_decode also at ragged lengths over the memory's 1500 rows; then
    each timed in bf16 in the model layout beside its plain version, SDPA
    and its bound.  Returns ({name: flash_attention row}, {name:
    flash_decode row})."""
    b, h, d = WHISPER_CLIPS, 6, 64
    fa_rows, fd_rows = {}, {}
    for name, s, t, causal in WHISPER_FA:
        row = {"shape": {"b": b, "hq": h, "hkv": h, "s": s, "t": t, "d": d,
                         "causal": causal}}
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q, k, v = attention_inputs(b, h, h, s, t, d, dtype, True)
            got = fa.flash_attention(q, k, v, causal=causal)
            expect = flash_attention_ref(q, k, v, causal=causal)
            err = (got.float() - expect.float()).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= tol
            print(f"flash_attention whisper {name} {dtype} B={b} {h}/{h} "
                  f"D={d} S={s} T={t} causal={causal}: max_abs_err "
                  f"{err:.3e} (tol {tol:g})")
            if not ok:
                raise SystemExit(f"flash_attention disagrees with its plain "
                                 f"version at whisper's {name} ({dtype}): "
                                 f"{err:.3e} > {tol:g}")
            key = "max_abs_err" if dtype == torch.bfloat16 else \
                "max_abs_err_fp32"
            row[key] = err
            del expect
        q, k, v = attention_inputs(b, h, h, s, t, d, torch.bfloat16, True)
        row.update(time_attention(q, k, v, causal=causal))
        print(f"flash_attention whisper {name} timing (bf16): kernel "
              f"{row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s), plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms "
              f"({row['library_tflops']:.1f} TFLOP/s), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        fa_rows[name] = row
        del q, k, v
    ragged = [0, 1, 15, 16, 17, 500, 749, 750, 751, 1000, 1234, 1488, 1499,
              1500, 3, 64]
    for name, t, n in WHISPER_FD:
        row = {}
        cases = [("bf16", torch.bfloat16, 2e-2, [n] * b),
                 ("fp32", torch.float32, 1e-5, [n] * b)]
        if t == 1500:
            cases.append(("bf16 ragged", torch.bfloat16, 2e-2, ragged))
        for label, dtype, tol, lens in cases:
            q, k, v = decode_inputs(b, h, h, t, d, dtype, True)
            arg = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = fd.flash_decode(q, k, v, arg)
            expect = flash_decode_ref(q, k, v, arg)
            live = arg > 0
            err = (got[live].float() - expect[live].float()).abs().max()\
                .item()
            ok = (bool(torch.isfinite(got).all()) and err <= tol
                  and bool((got[~live] == 0).all()))
            print(f"flash_decode whisper {name} {label} B={b} {h}/{h} D={d} "
                  f"T={t}: max_abs_err {err:.3e} (tol {tol:g})")
            if not ok:
                raise SystemExit(f"flash_decode disagrees with its plain "
                                 f"version at whisper's {name} ({label}): "
                                 f"{err:.3e} > {tol:g}")
            row["max_abs_err" if label == "bf16" else
                "max_abs_err_" + label.replace(" ", "_")] = err
        lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
        sets = [decode_inputs(b, h, h, t, d, torch.bfloat16, True, seed=i)
                for i in range(COLD_SETS)]
        row.update(time_decode(sets, lens))
        row["shape"] = {"b": b, "hq": h, "hkv": h, "t": t, "d": d,
                        "lens": n, "cache_sets": COLD_SETS}
        print(f"flash_decode whisper {name} timing (bf16, {COLD_SETS} cache "
              f"sets): kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), one "
              f"torch.sum over as many bytes {row['stream_ms']:.4f} ms")
        fd_rows[name] = row
        del sets
        torch.cuda.empty_cache()
    return fa_rows, fd_rows


def whisper_cache(cfg, params, frames, max_len):
    """A whisper decode cache built from the encoder's memory of
    ``frames`` on the parameters' device."""
    return whisper.init_cache(cfg, frames.shape[0], max_len,
                              params["embed"].device, params=params,
                              memory=whisper.encode(cfg, params, frames))


def run_whisper_path():
    """whisper-tiny at full width with random bf16 weights from seed 0
    (its 4-stage plan printed): ``api.forward`` of 16 clips x 1500 stub
    frames and 448 tokens (flash_attention = encoder layers + 2 x decoder
    layers), then ``encode``, a cache built from its memory, a 4-token
    prompt token by token and 64 greedy tokens (flash_attention = encoder
    layers, flash_decode = 2 x decoder layers a step), each with every
    count set to 0 just before and read just after; the served tokens
    teacher-forced through the forward (``encode`` + ``decode_train``)
    in bf16 against the fp32 evaluation, and the loop again in fp32.
    Returns the flash_attention counts of the forward and the loop and
    the flash_decode count."""
    cfg = configs.get(WHISPER_ARCH).config()
    print_plan(cfg, WHISPER_TOKENS)
    params = api.init(cfg, CARD, torch.Generator(CARD).manual_seed(0))
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (WHISPER_CLIPS, cfg.n_frames, cfg.d_model), dtype=np.float32)).to(
            device=CARD, dtype=cfg.dtype)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (WHISPER_CLIPS, WHISPER_TOKENS), dtype=np.int64))
    batch = {"frames": frames, "tokens": tokens}
    print(f"{WHISPER_ARCH}: {api.param_count(cfg) * 2 / 1e6:.1f} MB of bf16 "
          f"weights; {WHISPER_CLIPS} clips x {cfg.n_frames} frames, "
          f"{WHISPER_TOKENS} decoder tokens")

    api.forward(cfg, params, batch, last_token_only=True)      # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits = api.forward(cfg, params, batch, last_token_only=True)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd = read_counts()
    check_counts(f"{WHISPER_ARCH} forward", fwd,
                 {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers})
    if not (logits.shape == (WHISPER_CLIPS, 1, cfg.vocab)
            and bool(torch.isfinite(logits).all())):
        raise SystemExit(f"{WHISPER_ARCH}: forward logits not finite "
                         f"{tuple(logits.shape)}")
    print(f"{WHISPER_ARCH}: forward (encoder over {WHISPER_CLIPS} x "
          f"{cfg.n_frames} frames + decoder over {WHISPER_TOKENS} tokens) "
          f"in {fwd_s * 1e3:.3f} ms (second call, host clock)")

    prompts = tokens[:, :WHISPER_PROMPT]
    _build.reset_launches()
    t0 = time.perf_counter()
    outs, calls, _, step_s = greedy_decode(
        cfg, params, prompts, WHISPER_NEW, WHISPER_TOKENS, True,
        cache=whisper_cache(cfg, params, frames, WHISPER_TOKENS))
    loop_s = time.perf_counter() - t0
    dec = read_counts()
    print(f"{WHISPER_ARCH}: encode + {calls} decode calls ({WHISPER_PROMPT}"
          f"-token prompt + {WHISPER_NEW} greedy tokens x {WHISPER_CLIPS} "
          f"clips) in {loop_s * 1e3:.1f} ms ({loop_s / calls * 1e3:.3f} ms "
          f"a call; {step_s * 1e3:.3f} ms a generated token after the "
          f"first)")
    check_counts(f"{WHISPER_ARCH} encode + decode", dec,
                 {"flash_attention": cfg.n_enc_layers,
                  "flash_decode": 2 * cfg.n_layers * calls})

    cfg32, p32 = dataclasses.replace(cfg, dtype=torch.float32), \
        to_fp32(params)
    frames32 = frames.float()
    check_teacher(WHISPER_ARCH,
                  teacher_rows(cfg, params, prompts, outs, frames),
                  teacher_rows(cfg32, p32, prompts, outs, frames32),
                  outs, TEACHER_MIN_DECISIVE)
    outs32, _, _, _ = greedy_decode(
        cfg32, p32, prompts, WHISPER_NEW, WHISPER_TOKENS, True,
        cache=whisper_cache(cfg32, p32, frames32, WHISPER_TOKENS))
    check_fp32_loop(WHISPER_ARCH,
                    teacher_rows(cfg32, p32, prompts, outs32, frames32),
                    outs32, outs)
    return fwd["flash_attention"], dec["flash_attention"], \
        dec["flash_decode"]


def run_reporter_phase():
    """The §6.1.3 refine loop on the card: qwen3-1.7b at full width (batch
    1, REPORTER_SEQ tokens), its balanced 4-stage cuts, each balanced
    segment measured by :class:`CudaSegmentReporter`, then the balanced
    plan refined by the reporter at a budget halfway between the mean and
    the largest measured segment; fails unless it moved a cut and
    converged with every segment within the budget."""
    cfg = configs.get(ARCH).config()
    g = lm_graph.lm_layer_graph(cfg, seq_len=REPORTER_SEQ)
    n = len(g.levels())
    before = plan(DeploymentSpec(stages=STAGES, strategy="balanced_norefine"),
                  graph=g)
    free = CudaSegmentReporter(cfg, g, 1 << 62, seq=REPORTER_SEQ)
    sizes = [free.segment_report(lo, hi)[0]
             for lo, hi in segment_ranges(n, before.cuts)]
    budget = (max(sizes) + sum(sizes) // len(sizes)) // 2
    print(f"reporter: {ARCH} balanced cuts {before.cuts}, measured segment "
          f"bytes {sizes} ({free.compilations} runs); budget {budget}")
    rep = CudaSegmentReporter(cfg, g, budget, seq=REPORTER_SEQ)
    t0 = time.perf_counter()
    pl = plan(DeploymentSpec(stages=STAGES, strategy="balanced"), graph=g,
              reporter=rep)
    refine_s = time.perf_counter() - t0
    ref = pl.refinement
    final = []
    for (lo, hi), layers in zip(segment_ranges(n, pl.cuts), pl.stage_layers):
        used, over = rep.segment_report(lo, hi)
        weights = sum(g.nodes[name].weight_bytes for name in layers)
        final.append({"depths": [lo, hi],
                      "blocks": sum(n.startswith("block_") for n in layers),
                      "measured_bytes": used, "overflow_bytes": over,
                      "analytic_weight_bytes": weights})
    print(f"reporter: refined cuts {pl.cuts} (refinement {ref.cuts}), "
          f"{rep.compilations} runs on the card, {ref.compilations} "
          f"reporter calls, {ref.moves} moves, converged={ref.converged}, "
          f"{refine_s:.1f} s")
    for i, seg in enumerate(final):
        print(f"reporter: segment {i} depths {seg['depths']}, "
              f"{seg['blocks']} blocks: measured {seg['measured_bytes']} bytes "
              f"(overflow {seg['overflow_bytes']}), analytic weights "
              f"{seg['analytic_weight_bytes']} bytes")
    if not (ref.converged and ref.moves >= 1 and pl.cuts == ref.cuts
            and all(seg["overflow_bytes"] == 0 for seg in final)):
        raise SystemExit(f"reporter: the refine did not converge within "
                         f"{budget} bytes after moving a cut: {ref}, "
                         f"{final}")
    return {"arch": ARCH, "seq": REPORTER_SEQ, "budget": budget,
            "cuts_before": list(before.cuts), "balanced_bytes": sizes,
            "cuts_after": list(pl.cuts), "runs": rep.compilations,
            "compilations": ref.compilations, "moves": ref.moves,
            "converged": ref.converged, "segments": final,
            "seconds": refine_s}


def fill_samples(ex, host):
    """Medians of SPMD_FILL_REPS overlapped and as many serial bring-up
    fills of ``ex``'s weights, interleaved (the first order alternating):
    ``host``, pinned copies of what the executor streamed, streamed with
    the executor's bring-up as ``compile_fn``."""
    runs = {True: [], False: []}
    for i in range(SPMD_FILL_REPS):
        for overlap in ((True, False) if i % 2 == 0 else (False, True)):
            runs[overlap].append(pipeline_spmd.stream_stage_weights(
                ex.mesh, host, overlap=overlap, compile_fn=ex.bring_up)[2])
    out = {}
    for overlap, reps in runs.items():
        out["overlap" if overlap else "serial"] = {
            "fill_s": float(np.median([r.fill_s for r in reps])),
            "blocked_s": float(np.median([r.blocked_s for r in reps])),
            "fill_samples_s": [r.fill_s for r in reps],
            "blocked_samples_s": [r.blocked_s for r in reps]}
    return out


def served_rates(run_batch, items):
    """items/s of SPMD_CALLS calls of ``run_batch(items)`` after one
    warm-up call, each ending with the card finished."""
    run_batch(items)
    rates = []
    for _ in range(SPMD_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_batch(items)
        torch.cuda.synchronize()
        rates.append(len(items) / (time.perf_counter() - t0))
    return rates


def host_rates(dep, items):
    """The host PipelineExecutor of ``dep`` on the same items."""
    with dep.executor(start=True) as hx:
        return served_rates(hx.run_batch, items)


def report_spmd(label, ex, model, params, smi):
    """The executor's fill samples (from pinned host copies of its stage
    weights, made here and dropped after), modeled vs achieved stage
    times, printed once with the card; returns them."""
    host = pipeline_spmd.host_stage_weights(model, params, ex.plan)
    nbytes = sum(t.numel() * t.element_size() for tree in host
                 for t in tree_flatten(tree)[0])
    fills = fill_samples(ex, host)
    del host
    pred = ex.predicted_stage_times()
    ach = ex.achieved_stage_times(reps=5, warmup=1)
    for how, f in fills.items():
        print(f"spmd {label} fill, {how} streaming of {nbytes} bytes: median "
              f"fill_s {f['fill_s']:.6f} (samples "
              f"{[round(x, 6) for x in f['fill_samples_s']]}), blocked_s "
              f"{f['blocked_s']:.6f} (samples "
              f"{[round(x, 6) for x in f['blocked_samples_s']]}); {smi}")
    print(f"spmd {label} stage times (s): modeled "
          f"{[round(t, 6) for t in pred]}, achieved (alone on its stream, "
          f"median of 5) {[round(t, 6) for t in ach]}; {smi}")
    return {"weight_bytes": nbytes, "fills": fills, "predicted_s": pred,
            "achieved_s": ach}


def spmd_plans(graph, model_ref):
    """The analytic balanced and the comp 4-stage plans of ``graph``."""
    return {strategy: plan(DeploymentSpec(model=model_ref, stages=STAGES,
                                          strategy=strategy), graph=graph)
            for strategy in ("balanced", "comp")}


def rel_err(got, expect):
    """max |got - expect| / max |expect|."""
    return ((got - expect).abs().max() / expect.abs().max()).item()


def run_spmd_lm(record, smi):
    """qwen3-1.7b at full width through the SPMD tier: the analytic
    balanced 4-stage plan through ``Deployment.executor(backend="spmd")``,
    batch 8 x SEQ tokens over 4 microbatches, with every kernel's count set
    to 0 just before a call and read just after (flash_attention: layers x
    microbatches).  The logits against the same stage bodies run
    microbatch by microbatch on one stream (fp32 activations, the same
    weights made fp32), and against that composition with flash_attention's
    plain version in its place, each within SPMD_TOL of max |logit|; the
    gap to the bf16 forward printed beside the bf16 noise (the bf16
    forward against the plain composition); then batch 7 (padded), the comp
    plan's unequal block counts, the fill, stage times and items/s beside
    the host executor, ``pipeline_logits`` in bf16 against ``lm.forward``
    (2e-2), and flash_attention's fp32 route timed at the microbatch's
    shape."""
    dev = torch.device(CARD)
    cfg = configs.get(ARCH).config()
    params = lm.init_params(cfg, dev, torch.Generator(dev).manual_seed(0))
    graph = lm_graph.lm_layer_graph(cfg, seq_len=SEQ)
    plans = spmd_plans(graph, f"lm:{ARCH}:seq={SEQ}")
    counts = {k: serve.stage_block_counts(p, cfg.n_layers)
              for k, p in plans.items()}
    print(f"spmd {ARCH}: balanced cuts {plans['balanced'].cuts} blocks "
          f"{counts['balanced']}, comp cuts {plans['comp'].cuts} blocks "
          f"{counts['comp']}")
    if len(set(counts["comp"])) < 2:
        raise SystemExit(f"spmd {ARCH}: the comp plan's block counts are "
                         f"equal: {counts['comp']}")
    tokens = concrete_batch(cfg, SEQ, SPMD_BATCH, kind="prefill",
                            rng=np.random.default_rng(3))["tokens"].to(dev)
    mb = SPMD_BATCH // SPMD_M
    want = {"flash_attention": cfg.n_layers * SPMD_M}

    def executor(strategy):
        dep = deploy(DeploymentSpec(stages=STAGES, strategy=strategy,
                                    backend="spmd"), graph=graph)
        if dep.plan.cuts != plans[strategy].cuts:
            raise SystemExit(f"spmd {ARCH}: {dep.plan.cuts} != "
                             f"{plans[strategy].cuts}")
        return dep.executor(model=cfg, params=params,
                            mesh=pipeline_spmd.default_stage_mesh(
                                STAGES, CARD, cards=1),
                            n_microbatches=SPMD_M, batch_size=SPMD_BATCH,
                            seq_len=SEQ)

    launches = {}

    def counted(label, fn):
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches[label] = read_counts()
        check_counts(f"spmd {ARCH} {label}", launches[label], want)
        return out

    # the one-stream composition: fp32 weights, microbatch by microbatch;
    # with the kernel (``expect``) and through flash_attention's plain
    # version (``plain``: an evaluation that shares no kernel)
    blocks32 = [to_fp32(bp) for bp in params["blocks"]]
    rest32 = {k: to_fp32(v) for k, v in params.items() if k != "blocks"}

    def composition():
        parts = []
        for i in range(0, SPMD_BATCH, mb):
            x = lm.embed_tokens(cfg, rest32, tokens[i:i + mb])
            positions = lm.positions_for(cfg, x)
            for bp in blocks32:
                x = lm.block(cfg, bp, x, positions)
            parts.append(lm.unembed(cfg, rest32, x))
        return torch.cat(parts)

    with torch.no_grad():
        expect = composition()
        with unittest.mock.patch.object(lm, "flash_attention",
                                        plain_attention):
            plain = composition()
        del blocks32
        bf16 = torch.cat([lm.forward(cfg, params, {"tokens": tokens[i:i + mb]})
                          for i in range(0, SPMD_BATCH, mb)])

    out = {"arch": ARCH, "batch": SPMD_BATCH, "seq": SEQ,
           "n_microbatches": SPMD_M,
           "cuts": {k: list(p.cuts) for k, p in plans.items()},
           "blocks": counts}
    t0 = time.perf_counter()
    ex = executor("balanced")
    build_s = time.perf_counter() - t0
    got = counted("balanced", lambda: ex(tokens))
    err = rel_err(got, expect)
    err_plain = rel_err(got, plain)
    gap = (got - bf16).abs().max().item()
    noise = (bf16 - plain).abs().max().item()
    print(f"spmd {ARCH} balanced plan, batch {SPMD_BATCH} x {SEQ}, m "
          f"{SPMD_M}: executor built in {build_s:.2f} s (fill "
          f"{ex.fill_s:.4f} s, blocked {ex.fill_blocked_s:.4f} s); logits "
          f"max_abs_err / max|logit| vs the one-stream composition "
          f"{err:.3e}, vs the composition through plain attention "
          f"{err_plain:.3e} (tol {SPMD_TOL:g} each); max_abs_err vs the "
          f"bf16 forward {gap:.3e} beside the bf16 noise (bf16 forward vs "
          f"the plain fp32 composition) {noise:.3e}; logits "
          f"{tuple(got.shape)}")
    if not (got.shape == expect.shape and bool(torch.isfinite(got).all())
            and err <= SPMD_TOL and err_plain <= SPMD_TOL):
        raise SystemExit(f"spmd {ARCH}: executor vs one-stream composition "
                         f"{err:.3e}, vs plain attention {err_plain:.3e}, "
                         f"> {SPMD_TOL:g} or not finite")
    out.update(vs_composition=err, vs_plain_composition=err_plain,
               vs_bf16_forward=gap, bf16_noise=noise)
    del got, plain
    got = counted("balanced, batch 7", lambda: ex(tokens[:7]))
    err7 = rel_err(got, expect[:7])
    print(f"spmd {ARCH} batch 7 (padded to 8): max_abs_err / max|logit| "
          f"{err7:.3e} (tol {SPMD_TOL:g})")
    if not (got.shape == expect[:7].shape and err7 <= SPMD_TOL):
        raise SystemExit(f"spmd {ARCH}: batch 7 {err7:.3e}")
    del got
    out["vs_composition_batch7"] = err7
    out.update(report_spmd(ARCH, ex, cfg, params, smi))
    rows = list(tokens)
    out["spmd_items_per_s"] = served_rates(ex.run_batch, rows)
    ex.close()
    del ex
    torch.cuda.empty_cache()
    host = serve.make_stage_fns(cfg, params, counts["balanced"], dev)
    out["host_items_per_s"] = host_rates(
        deploy(DeploymentSpec(stages=STAGES, strategy="balanced"),
               graph=graph, stage_fns=host), [r[None] for r in rows])
    print(f"spmd {ARCH} served batch of {SPMD_BATCH}: SPMD executor "
          f"{[round(r, 3) for r in out['spmd_items_per_s']]} items/s (fp32 "
          f"activations, every position's logits) beside the host "
          f"PipelineExecutor on the same plan "
          f"{[round(r, 3) for r in out['host_items_per_s']]} items/s (bf16, "
          f"last-token logits); {smi}")
    ex = executor("comp")
    got = counted("comp", lambda: ex(tokens))
    errc = rel_err(got, expect)
    print(f"spmd {ARCH} comp plan (blocks {counts['comp']}): max_abs_err / "
          f"max|logit| {errc:.3e} (tol {SPMD_TOL:g})")
    if errc > SPMD_TOL:
        raise SystemExit(f"spmd {ARCH}: comp plan {errc:.3e}")
    out["vs_composition_comp"] = errc
    ex.close()
    del ex, got, expect
    torch.cuda.empty_cache()
    mesh = pipeline_spmd.default_stage_mesh(STAGES, CARD, cards=1)
    got = counted("pipeline_logits (bf16)",
                  lambda: pipeline_spmd.pipeline_logits(
                      cfg, mesh, plans["balanced"], params,
                      {"tokens": tokens}, n_microbatches=SPMD_M))
    errp = (got - bf16).abs().max().item()
    print(f"spmd {ARCH} pipeline_logits (bf16) vs lm.forward: max_abs_err "
          f"{errp:.3e} (bound 2e-2)")
    if not errp < 2e-2:
        raise SystemExit(f"spmd {ARCH}: pipeline_logits {errp:.3e}")
    out["pipeline_logits_vs_forward"] = errp
    del got, bf16, params
    torch.cuda.empty_cache()
    # flash_attention's fp32 route at the microbatch's shape (D 128)
    q, k, v = attention_inputs(mb, cfg.n_heads, cfg.n_kv_heads, SEQ, SEQ,
                               cfg.hd, torch.float32, True)
    fa_err = (fa.flash_attention(q, k, v) - flash_attention_ref(q, k, v)
              ).abs().max().item()
    times = time_attention(q, k, v)
    print(f"flash_attention fp32 at the SPMD microbatch ({mb}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, {SEQ}, D {cfg.hd}): kernel "
          f"{times['ms']:.4f} ms ({times['tflops']:.2f} TFLOP/s), plain "
          f"{times['plain_ms']:.4f} ms, sdpa {times['library_ms']:.4f} ms "
          f"({times['library_tflops']:.2f} TFLOP/s, "
          f"{times['library_backend']}), bound {times['bound_ms']:.4f} ms "
          f"({times['bound_by']}), max_abs_err {fa_err:.3e} (tol 1e-4); "
          f"{smi}")
    if fa_err > 1e-4:
        raise SystemExit(f"flash_attention fp32 at the SPMD shape: {fa_err}")
    record["spmd_fp32"] = {"max_abs_err": fa_err, **times, "shape": {
        "b": mb, "hq": cfg.n_heads, "hkv": cfg.n_kv_heads, "s": SEQ,
        "t": SEQ, "d": cfg.hd, "dtype": "torch.float32", "causal": True}}
    record["launches_spmd"] = launches["balanced"]["flash_attention"]
    return out


def run_spmd_cnn(name, smi, expect_cuts=None):
    """``name`` (fp32, TF32 off) through the SPMD tier: the analytic
    balanced 4-stage plan through ``Deployment.executor(backend="spmd")``,
    8 images over 4 microbatches, then 7 (padded) and the comp plan, each
    within SPMD_TOL of max |y| of the direct forward and launching no
    hand-written kernel; ResNet50 also reports the fill, stage times and
    items/s beside the host executor over ``cnn_stage_fns``."""
    dev = torch.device(CARD)
    m = cnn.REAL_CNNS[name]()
    graph = m.to_layer_graph()
    params = m.init(dev, torch.Generator(dev).manual_seed(0))
    x = torch.randn((SPMD_BATCH,) + m.input_shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(4))
    direct = m.apply(params, x)
    plans = spmd_plans(graph, f"cnn:{name}")
    if expect_cuts is not None and plans["balanced"].cuts != expect_cuts:
        raise SystemExit(f"spmd {name}: balanced cuts "
                         f"{plans['balanced'].cuts} != {expect_cuts}")
    out = {"cuts": {k: list(p.cuts) for k, p in plans.items()}}
    for strategy, pl in plans.items():
        dep = serve.deploy_cnn(m, params, DeploymentSpec(
            model=f"cnn:{name}", stages=STAGES, strategy=strategy,
            backend="spmd"), dev)
        if dep.plan.cuts != pl.cuts:
            raise SystemExit(f"spmd {name}: {dep.plan.cuts} != {pl.cuts}")
        ex = dep.executor(model=m, params=params, n_microbatches=SPMD_M,
                          mesh=pipeline_spmd.default_stage_mesh(
                              STAGES, CARD, cards=1),
                          batch_size=SPMD_BATCH)
        batches = (SPMD_BATCH, 7) if strategy == "balanced" else (
            SPMD_BATCH,)
        for b in batches:
            _build.reset_launches()
            y = ex(x[:b])
            torch.cuda.synchronize()
            check_counts(f"spmd {name} {strategy} batch {b}", read_counts(),
                         {})
            err = rel_err(y, direct[:b])
            print(f"spmd {name} {strategy} plan (cuts {pl.cuts}), batch {b}, "
                  f"m {SPMD_M}: max_abs_err / max|y| vs the direct forward "
                  f"{err:.3e} (tol {SPMD_TOL:g})")
            if not (y.shape == direct[:b].shape and err <= SPMD_TOL):
                raise SystemExit(f"spmd {name} {strategy} batch {b}: "
                                 f"{err:.3e}")
            out[f"{strategy}_batch{b}_rel_err"] = err
        if strategy == "balanced" and name == CNN:
            out.update(report_spmd(name, ex, m, params, smi))
            items = list(x)
            out["spmd_items_per_s"] = served_rates(ex.run_batch, items)
            out["host_items_per_s"] = host_rates(
                serve.deploy_cnn(m, params, DeploymentSpec(
                    model=f"cnn:{name}", stages=STAGES,
                    strategy=strategy), dev),
                [{m.INPUT: i[None]} for i in items])
            print(f"spmd {name} served batch of {SPMD_BATCH}: SPMD executor "
                  f"{[round(r, 2) for r in out['spmd_items_per_s']]} "
                  f"items/s beside the host PipelineExecutor over "
                  f"cnn_stage_fns on the same plan "
                  f"{[round(r, 2) for r in out['host_items_per_s']]} "
                  f"items/s; {smi}")
        ex.close()
    return out


def run_spmd_phase(record, smi):
    """The SPMD tier on the card: qwen3-1.7b, ResNet50 and MobileNetV2
    (C4's balanced cuts, a tensor riding through stage 1 as it is)."""
    t0 = time.perf_counter()
    out = {"lm": run_spmd_lm(record, smi)}
    torch.cuda.empty_cache()
    out["cnn"] = run_spmd_cnn(CNN, smi)
    out["mobilenetv2"] = run_spmd_cnn("MobileNetV2", smi,
                                      expect_cuts=[125, 126, 147])
    out["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"SPMD phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the SPMD tier over several cards
# ---------------------------------------------------------------------------
def sync_cards(n):
    for c in range(n):
        torch.cuda.synchronize(c)


def card_kernel_cases(dev):
    """(name, run, plain) of every launcher with a shared-memory setup, at
    a shape above 48 KB of dynamic shared memory, and flash_attention's
    fp32 route, each on ``dev``: ``run`` and ``plain`` return the outputs
    to compare."""
    def on(*xs):
        return [x.to(dev) for x in xs]

    q, k, v = on(*decode_inputs(8, 16, 8, 2048, 128, torch.bfloat16))
    fq, fk, fv = on(*attention_inputs(2, 32, 8, 256, 256, 128,
                                      torch.float32))
    rx = on(*rwkv6_inputs(2, 4, 256, 64, torch.float32, False))
    gx = on(*rglru_inputs(2, 256, 1024, torch.float32))
    rb, rdy, rds = rwkv6_bwd_case(2, 4, 128, 64, torch.float32, False)
    rb, (rdy, rds) = on(*rb), on(rdy, rds)
    gb, gdy, gdh = rglru_bwd_case(2, 256, 1024, torch.float32)
    gb, (gdy, gdh) = on(*gb), on(gdy, gdh)

    def rwkv6_bwd():
        states = rw._forward(*rb, None, with_states=True)[2]
        return rw.rwkv6_scan_bwd(*rb, rdy, rds, states)

    def rglru_bwd():
        ckpt = rg._forward(*gb, with_checkpoints=True)[2]
        return rg.rglru_scan_bwd(*gb, gdy, gdh, ckpt)

    return (
        ("flash_attention", lambda: fa.flash_attention(fq, fk, fv),
         lambda: flash_attention_ref(fq, fk, fv)),
        ("flash_decode", lambda: fd.flash_decode(q, k, v, 2048),
         lambda: flash_decode_ref(q, k, v, 2048)),
        ("rwkv6_scan", lambda: rw.rwkv6_scan(*rx),
         lambda: rwkv6_scan_ref(*rx)),
        ("rwkv6_scan_bwd", rwkv6_bwd,
         lambda: rwkv6_scan_bwd_ref(*rb, rdy, rds)),
        ("rglru_scan", lambda: rg.rglru_scan(*gx),
         lambda: rglru_scan_ref(*gx)),
        ("rglru_scan_bwd", rglru_bwd,
         lambda: rglru_scan_bwd_ref(*gb, gdy, gdh)))


def check_kernels_on_cards(n):
    """Every launcher with a shared-memory setup launched on each of the
    first ``n`` cards in turn (:func:`card_kernel_cases`) against its plain
    version there; a failure exits.  A launcher that configured its kernel
    once per process fails its first launch on the second card.  Returns
    {card: {kernel: max_abs_err}} and the launches by card."""
    _build.reset_launches()
    out = {}
    for c in range(n):
        dev = torch.device("cuda", c)
        res = {}
        for name, run, plain in card_kernel_cases(dev):
            try:
                got = run()
                torch.cuda.synchronize(dev)
            except RuntimeError as exc:
                raise SystemExit(f"{name} on {dev} failed to launch: {exc}")
            got = got if isinstance(got, tuple) else (got,)
            want = plain()
            want = want if isinstance(want, tuple) else (want,)
            tol = CARD_KERNEL_TOL[name]
            if name.endswith("_bwd"):   # the backward checks' two bounds
                errs, l2, ok = scan_grad_errs(got, want)
                err = max(errs)
                ok = ok and err <= tol and max(l2) <= BWD_L2_TOL[
                    torch.float32]
            else:
                errs = [allclose_err(a, b, tol) for a, b in zip(got, want)]
                err = max(e for e, _ in errs)
                ok = all(o for _, o in errs)
            ok = ok and all(a.device == dev for a in got)
            res[name] = err
            scale = ("of each gradient's scale" if name.endswith("_bwd")
                     else "(1 + |plain|)")
            print(f"spmd cards: {name} on {dev}: max err {err:.3e} (tol "
                  f"{tol:g} {scale}): {ok}")
            if not ok:
                raise SystemExit(f"{name} on {dev}: {err:.3e}")
        out[c] = res
    launches = {name: _build.launches_by_card(name)
                for name in CARD_KERNEL_TOL}
    print(f"spmd cards: launches by card {launches}")
    # the scans' backwards each also ran their forward with the epilogue
    want = {name: {c: 2 if name in ("rwkv6_scan", "rglru_scan") else 1
                   for c in range(n)} for name in CARD_KERNEL_TOL}
    if launches != want:
        raise SystemExit(f"launches by card {launches} != {want}")
    return {"errs": out, "launches_by_card": launches}


def run_cards_cnn(mesh, smi):
    """ResNet50 (fp32, TF32 off) over the mesh's cards through
    ``Deployment.executor(backend="spmd", mesh=)``: 8 images over 4
    microbatches and 7 (padded) against the direct forward on card 0, and
    the executor's own stages composed without the schedule, each within
    SPMD_TOL of max |y|; the fill and items/s."""
    dev = torch.device(CARD, 0)
    m = cnn.REAL_CNNS[CNN]()
    params = m.init(dev, torch.Generator(dev).manual_seed(0))
    x = torch.randn((SPMD_BATCH,) + m.input_shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(4))
    direct = m.apply(params, x)
    dep = serve.deploy_cnn(m, params, DeploymentSpec(
        model=f"cnn:{CNN}", stages=STAGES, strategy="balanced",
        backend="spmd"), dev)
    out = {"cuts": list(dep.plan.cuts)}
    with dep.executor(model=m, params=params, mesh=mesh,
                      n_microbatches=SPMD_M, batch_size=SPMD_BATCH) as ex:
        for b in (SPMD_BATCH, 7):
            _build.reset_launches()
            y = ex(x[:b])
            sync_cards(CARDS)
            check_counts(f"spmd cards {CNN} batch {b}", read_counts(), {})
            err = rel_err(y.to(dev), direct[:b])
            print(f"spmd cards {CNN} balanced plan (cuts {dep.plan.cuts}) "
                  f"over {[str(d) for d in mesh.devices]}, batch {b}: "
                  f"output on {y.device}, "
                  f"max_abs_err / max|y| vs the direct forward on {dev} "
                  f"{err:.3e} (tol {SPMD_TOL:g})")
            if not (y.shape == direct[:b].shape and err <= SPMD_TOL
                    and y.device == mesh.devices[-1]):
                raise SystemExit(f"spmd cards {CNN} batch {b}: {err:.3e}")
            out[f"batch{b}_rel_err"] = err
        errc = rel_err(ex.compose(x).to(dev), direct)
        if errc > SPMD_TOL:
            raise SystemExit(f"spmd cards {CNN} composed: {errc:.3e}")
        out["composed_rel_err"] = errc
        out["fill_s"], out["blocked_s"] = ex.fill_s, ex.fill_blocked_s
        out["items_per_s"] = served_rates(ex.run_batch, list(x))
        out["predicted_s"] = ex.predicted_stage_times()
        out["achieved_s"] = ex.achieved_stage_times(reps=5, warmup=1)
    print(f"spmd cards {CNN}: composed without the schedule {errc:.3e}; "
          f"fill {out['fill_s']:.4f} s (blocked {out['blocked_s']:.4f} s); "
          f"{[round(r, 2) for r in out['items_per_s']]} items/s; stage "
          f"times modeled {[round(t, 6) for t in out['predicted_s']]}, "
          f"achieved {[round(t, 6) for t in out['achieved_s']]}; {smi}")
    return out


def cards_executor(cfg, params, mesh):
    """The balanced 4-stage plan of ``cfg`` through the front door, priced
    for one card's memory, lowered onto ``mesh``; returns the executor,
    its plan and the seconds it took to build."""
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    dep = deploy(DeploymentSpec(stages=STAGES, strategy="balanced",
                                backend="spmd"),
                 graph=lm_graph.lm_layer_graph(cfg, seq_len=SEQ),
                 base_spec=EdgeTPUSpec(onchip_bytes=card_bytes))
    t0 = time.perf_counter()
    ex = dep.executor(model=cfg, params=params, mesh=mesh,
                      n_microbatches=SPMD_M, batch_size=SPMD_BATCH,
                      seq_len=SEQ)
    return ex, dep.plan, time.perf_counter() - t0


def launches_per_card(mesh, counts):
    """flash_attention's launches on each card of ``mesh`` in one call of
    SPMD_M microbatches over stages of ``counts`` blocks."""
    want = {}
    for dev, n in zip(mesh.devices, counts):
        want[dev.index] = want.get(dev.index, 0) + n * SPMD_M
    return want


def cards_launches(label, fn, want_per_card):
    """``fn()`` with every count set to 0 just before and read just after:
    flash_attention ``want_per_card[c]`` times on card c, no other
    kernel."""
    _build.reset_launches()
    out = fn()
    sync_cards(CARDS)
    total = sum(want_per_card.values())
    check_counts(label, read_counts(), {"flash_attention": total})
    by_card = _build.launches_by_card("flash_attention")
    print(f"{label}: flash_attention launches by card {by_card} (expected "
          f"{want_per_card})")
    if by_card != want_per_card:
        raise SystemExit(f"{label}: launches by card {by_card} != "
                         f"{want_per_card}")
    return out, by_card


def run_cards_lm(full, params, tokens, mesh, smi):
    """phi3.5-moe over the mesh's cards, batch 8 x SEQ over 4 microbatches
    (fp32 activations on the weights made fp32, the reference's numerics).
    (b) its first CARDS_CHECK layers against ``lm.forward`` of the same
    weights made fp32 on card 0, microbatch by microbatch; (c) all its
    layers against the executor's own stage functions composed without the
    schedule, with items/s and tokens/s, fill, modeled and achieved stage
    times, each card's allocator peak and flash_attention's launches by
    card.  Each within SPMD_TOL of max |logit|."""
    dev0 = torch.device(CARD, 0)
    mb = SPMD_BATCH // SPMD_M
    out = {}
    # (b): the cut model, which card 0 holds alone in fp32
    cfg = dataclasses.replace(full, n_layers=CARDS_CHECK)
    cut = {**params, "blocks": params["blocks"][:CARDS_CHECK]}
    with torch.no_grad():
        # copied in bf16, made fp32 on the card
        p32 = tree_map(lambda t: t.to(dev0).float(), cut)
        expect = torch.cat([lm.forward(cfg, p32, {"tokens": tokens[i:i + mb]
                                                  .to(dev0)})
                            for i in range(0, SPMD_BATCH, mb)])
        del p32
    torch.cuda.empty_cache()
    ex, pl, build_s = cards_executor(cfg, cut, mesh)
    counts = serve.stage_block_counts(pl, cfg.n_layers)
    with ex:
        got, by_card = cards_launches(
            f"spmd cards {CARDS_ARCH} {CARDS_CHECK} layers",
            lambda: ex(tokens), launches_per_card(mesh, counts))
        err = rel_err(got.to(dev0), expect)
    print(f"spmd cards {CARDS_ARCH} cut to {CARDS_CHECK} of "
          f"{full.n_layers} layers (blocks {counts}) over "
          f"{[str(d) for d in mesh.devices]}, batch {SPMD_BATCH} x {SEQ}: "
          f"logits {tuple(got.shape)} on {got.device}, max_abs_err / "
          f"max|logit| vs lm.forward of the fp32 weights on {dev0} "
          f"{err:.3e} (tol {SPMD_TOL:g})")
    if not (got.shape == expect.shape and bool(torch.isfinite(got).all())
            and err <= SPMD_TOL):
        raise SystemExit(f"spmd cards {CARDS_ARCH} {CARDS_CHECK} layers: "
                         f"{err:.3e}")
    out["cut"] = {"layers": CARDS_CHECK, "blocks": counts,
                  "vs_forward": err, "launches_by_card": by_card}
    del ex, got, expect
    for c in range(CARDS):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(c)
    # (c): every layer, which no card holds
    ex, pl, build_s = cards_executor(full, params, mesh)
    counts = serve.stage_block_counts(pl, full.n_layers)
    with ex:
        got, by_card = cards_launches(
            f"spmd cards {CARDS_ARCH}", lambda: ex(tokens),
            launches_per_card(mesh, counts))
        expect = ex.compose(tokens)
        err = rel_err(got, expect)
        print(f"spmd cards {CARDS_ARCH} at full depth ({full.n_layers} "
              f"layers, blocks {counts}, cuts {pl.cuts}) over "
              f"{[str(d) for d in mesh.devices]}: executor built in "
              f"{build_s:.2f} s (fill {ex.fill_s:.4f} s, blocked "
              f"{ex.fill_blocked_s:.4f} s); logits {tuple(got.shape)} on "
              f"{got.device}, max_abs_err / max|logit| vs its stage "
              f"functions composed without the schedule {err:.3e} (tol "
              f"{SPMD_TOL:g})")
        if not (got.shape == (SPMD_BATCH, SEQ, full.vocab)
                and bool(torch.isfinite(got).all()) and err <= SPMD_TOL):
            raise SystemExit(f"spmd cards {CARDS_ARCH}: {err:.3e}")
        del got, expect
        rates = served_rates(ex.run_batch, list(tokens))
        pred = ex.predicted_stage_times()
        ach = ex.achieved_stage_times(reps=5, warmup=1)
    peaks = {c: torch.cuda.max_memory_allocated(c) for c in range(CARDS)}
    reserved = {c: torch.cuda.max_memory_reserved(c) for c in range(CARDS)}
    print(f"spmd cards {CARDS_ARCH} served batch of {SPMD_BATCH} x {SEQ}: "
          f"{[round(r, 4) for r in rates]} items/s "
          f"({[round(r * SEQ, 1) for r in rates]} tokens/s); stage times "
          f"(s) modeled {[round(t, 6) for t in pred]}, achieved (alone on "
          f"its card, median of 5) {[round(t, 6) for t in ach]}; allocator "
          f"peak by card (GB) "
          f"{ {c: round(b / 1e9, 2) for c, b in peaks.items()} }, reserved "
          f"{ {c: round(b / 1e9, 2) for c, b in reserved.items()} }; {smi}")
    out.update(layers=full.n_layers, blocks=counts, cuts=list(pl.cuts),
               vs_composed=err, build_s=build_s, fill_s=ex.fill_s,
               blocked_s=ex.fill_blocked_s, items_per_s=rates,
               tokens_per_s=[r * SEQ for r in rates], predicted_s=pred,
               achieved_s=ach, peak_bytes=peaks, reserved_bytes=reserved,
               launches_by_card=by_card)
    return out


def run_spmd_cards_phase(smi):
    """The SPMD tier with one stage a card, as the reference's mesh lowers
    a plan, where CARDS cards are visible: each launcher's per-device
    setup on every card, ResNet50 (a) and phi3.5-moe (b, c: a model no
    card holds) over the cards.  With fewer cards it does nothing and says
    so."""
    visible = torch.cuda.device_count()
    out = {"ran": visible >= CARDS, "cards_visible": visible,
           "needs": CARDS}
    if not out["ran"]:
        return out
    t0 = time.perf_counter()
    mesh = pipeline_spmd.default_stage_mesh(STAGES, CARD, cards=CARDS)
    peer = pipeline_spmd.peer_access(mesh)
    out["stage_devices"] = [str(d) for d in mesh.devices]
    out["peer_access"] = {f"{a}->{b}": ok for (a, b), ok in peer.items()}
    print(f"spmd cards: {visible} cards visible, stages on "
          f"{out['stage_devices']}, peer access of the hops "
          f"{out['peer_access']}; {smi}")
    out["kernels"] = check_kernels_on_cards(CARDS)
    out["cnn"] = run_cards_cnn(mesh, smi)
    torch.cuda.empty_cache()
    full = configs.get(CARDS_ARCH).config()
    t1 = time.perf_counter()
    # made on card 0 a block at a time (the same numbers as made there
    # whole), kept on the host
    params = lm.init_params(full, torch.device(CARD, 0),
                            torch.Generator(CARD).manual_seed(0),
                            keep_on=torch.device("cpu"))
    out["init_s"] = time.perf_counter() - t1
    print(f"spmd cards {CARDS_ARCH}: {api.param_count(full) * 2 / 1e9:.1f} "
          f"GB of bf16 weights made on card 0 a block at a time and kept "
          f"on the host in {out['init_s']:.1f} s")
    tokens = concrete_batch(full, SEQ, SPMD_BATCH, kind="prefill",
                            rng=np.random.default_rng(3))["tokens"]
    out["lm"] = run_cards_lm(full, params, tokens, mesh, smi)
    del params
    for c in range(CARDS):
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"SPMD cards phase: {out['seconds']:.1f} s")
    return out


def spmd_cards_only(smi) -> int:
    """``--spmd-cards``: build the kernels the phase launches and run it
    alone; exits 1 where fewer than CARDS cards are visible."""
    t0 = time.perf_counter()
    _build.build(tuple(CARD_KERNEL_TOL))
    print(f"built {sorted(CARD_KERNEL_TOL)} in "
          f"{time.perf_counter() - t0:.1f} s")
    res = run_spmd_cards_phase(smi)
    print(json.dumps({"spmd_cards": res}, default=str))
    if not res["ran"]:
        return 1
    print(device_line())
    return 0


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------
def attention_bwd_bound(q, k, causal, window=None):
    """Least time (ms) for one flash-attention backward on these inputs:
    q, k, v, dO and lse read and dq, dk, dv written once over HBM
    bandwidth, against the 5 products (10 D flops per unmasked (query,
    key) pair: 2.5 times the forward's 2) over the peak rate of the input
    type."""
    cost = fa.attention_bwd_cost(q, k, causal, window)
    return (*cost_bound(cost, q.dtype), cost[0])


def sdpa_bwd_ms(q, k, v, do, causal):
    """The library yardstick of the backward (the port never calls it):
    ``torch.autograd.grad`` through one SDPA call less that call's forward
    (ms), and the backend.  The backends are tried in the order flash,
    memory-efficient, cuDNN, math, each with ``enable_gqa`` and, where it
    refuses that, with K/V expanded to the q heads.  SDPA's causal mask
    is top-left aligned, so a causal S < T shape is not timed."""
    if causal and q.shape[2] != k.shape[2]:
        return None, None
    group = q.shape[1] // k.shape[1]
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    expanded = [leaves[0]] + [x.detach().repeat_interleave(group, 1)
                              .requires_grad_() for x in (k, v)]
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        for args, gqa in ((leaves, True), (expanded, False)):
            def fwd(args=args, gqa=gqa, backend=backend):
                with sdpa_kernel(backend):
                    return torch.nn.functional.scaled_dot_product_attention(
                        *args, is_causal=causal, enable_gqa=gqa)

            def fwd_bwd(args=args, fwd=fwd):
                torch.autograd.grad(fwd(), args, do)
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    fwd_bwd()
                    torch.cuda.synchronize()
            except RuntimeError:            # the backend refuses the inputs
                continue
            total = cuda_ms([fwd_bwd], reps=10)
            forward = cuda_ms([fwd], reps=10)
            name = backend.name + ("" if gqa else ", K/V expanded")
            return total - forward, name
    raise SystemExit("no SDPA backend differentiates these inputs")


def check_flash_attention_bwd():
    """The backward kernel against its plain version at BWD_SHAPES in bf16
    and fp32 (dq, dk and dv each within BWD_TOL of its scale and within
    BWD_L2_TOL relative L2), on q/k/v as (B, S, H, D) views (the model's
    layout); two calls equal bit for bit; the output and lse of the
    forward launch that writes lse against the plain forward; the first
    BWD_TIMED shapes timed beside the plain version, SDPA's backward and
    the bound.  Returns the kernel record (the first shape's bf16 times at
    the top) and the largest relative L2 error of each dtype."""
    record, worst_l2 = None, {}
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, b, hq, hkv, s, t, d, causal, window) in enumerate(
                BWD_SHAPES):
            q, k, v, do = bwd_inputs(b, hq, hkv, s, t, d, dtype)
            o, lse = fa._forward(q, k, v, causal, window, with_lse=True)
            o_serve = fa._forward(q, k, v, causal, window, with_lse=False)
            got = fa.flash_attention_bwd(q, k, v, lse, do, causal, window)
            again = fa.flash_attention_bwd(q, k, v, lse, do, causal, window)
            expect = flash_attention_bwd_ref(q, k, v, lse, do, causal,
                                             window)
            o_ref, lse_ref = flash_attention_ref(q, k, v, causal, window,
                                                 return_lse=True)
            torch.cuda.synchronize()
            lse_err = (lse - lse_ref).abs().max().item()
            o_err = (o.float() - o_ref.float()).abs().max().item()
            o_same = torch.equal(o, o_serve)
            del o, o_serve, o_ref, lse_ref
            errs, l2 = bwd_errs(got, expect)
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            worst_l2[str(dtype)] = max(worst_l2.get(str(dtype), 0.0),
                                       *l2.values())
            tol, l2_tol = BWD_TOL[dtype], BWD_L2_TOL[dtype]
            print(f"flash_attention_bwd {dtype} {name}: max err of the "
                  f"scale dq {errs['dq']:.3e} dk {errs['dk']:.3e} dv "
                  f"{errs['dv']:.3e} (tol {tol:g}), rel L2 dq "
                  f"{l2['dq']:.3e} dk {l2['dk']:.3e} dv {l2['dv']:.3e} (tol "
                  f"{l2_tol:g}), lse {lse_err:.3e}, forward output with lse "
                  f"{o_err:.3e} (tol {FWD_TOL[dtype]:g}, equal to the "
                  f"serving launch's {o_same}), repeat equal {same}")
            if (max(errs.values()) > tol or max(l2.values()) > l2_tol
                    or lse_err > 1e-4 or o_err > FWD_TOL[dtype] or not same):
                raise SystemExit(f"flash_attention_bwd disagrees with its "
                                 f"plain version on {name} ({dtype})")
            del got, again, expect
            if i >= BWD_TIMED:
                continue
            times = {**time_attention_bwd(f"{dtype} {name}", q, k, v, lse,
                                          do, causal, window),
                     "max_abs_err": max(errs.values())}
            shape = {"b": b, "hq": hq, "hkv": hkv, "s": s, "t": t, "d": d,
                     "dtype": str(dtype), "causal": causal, "window": window}
            if record is None:
                record = {"name": "flash_attention_bwd", "route": "cuda",
                          "source": "src/repro_torch/kernels/csrc/"
                                    "flash_attention_bwd.cu",
                          "replaces": "src/repro/kernels/"
                                      "flash_attention.py:74",
                          **times, "shape": shape}
            else:
                tag = name.split(" (")[0].replace(" ", "_")
                key = tag + ("_fp32" if dtype == torch.float32 else "")
                record[key] = {**times, "shape": shape}
            del q, k, v, lse, do
            torch.cuda.empty_cache()
    return record, worst_l2


def bwd_errs(got, expect):
    """Each of dq, dk and dv: its largest deviation over max(1, max
    |plain|), and its relative L2 error ||g - e|| / ||e||."""
    errs, l2 = {}, {}
    for key, a, e in zip(("dq", "dk", "dv"), got, expect):
        a, e = a.float(), e.float()
        scale = max(1.0, e.abs().max().item())
        errs[key] = (a - e).abs().max().item() / scale
        l2[key] = (torch.linalg.vector_norm(a - e)
                   / torch.linalg.vector_norm(e)).item()
    return errs, l2


def time_attention_bwd(label, q, k, v, lse, do, causal, window=None):
    """The backward kernel, its plain version and SDPA's backward (ms), and
    the bound, on one input; printed under ``label``."""
    ms = cuda_ms([lambda: fa.flash_attention_bwd(
        q, k, v, lse, do, causal, window)], reps=10)
    plain_ms = cuda_ms([lambda: flash_attention_bwd_ref(
        q, k, v, lse, do, causal, window)], reps=5)
    library_ms, backend = sdpa_bwd_ms(q, k, v, do, causal)
    bound_ms, bound_by, flops = attention_bwd_bound(q, k, causal, window)
    lib = "null" if library_ms is None else f"{library_ms:.4f} ms ({backend})"
    tf = flops / (ms * 1e-3) / 1e12
    print(f"flash_attention_bwd timing {label}: kernel {ms:.4f} ms "
          f"({tf:.1f} TFLOP/s), plain {plain_ms:.4f} ms, SDPA backward "
          f"{lib}, bound {bound_ms:.4f} ms ({bound_by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_backend": backend, "tflops": tf}


def check_vlm_attention():
    """Both flash kernels at qwen2-vl-72b's training call VLM_ATTN (causal,
    bf16, q/k/v in the model's layout) against their plain versions: the
    forward within FWD_TOL, the backward's gradients within BWD_TOL of
    their scale and BWD_L2_TOL relative L2 and equal bit for bit from call
    to call; each timed beside its plain version, SDPA's forward or
    backward and its bound.  Returns the forward's and the backward's
    records."""
    b, hq, hkv, s, d = VLM_ATTN
    dtype = torch.bfloat16
    label = f"qwen2-vl-72b training ({b}, {hq}/{hkv}, {s}, {d}) causal bf16"
    shape = {"b": b, "hq": hq, "hkv": hkv, "s": s, "t": s, "d": d,
             "dtype": str(dtype), "causal": True}
    q, k, v, do = bwd_inputs(b, hq, hkv, s, s, d, dtype)
    got = fa.flash_attention(q, k, v, causal=True)
    err = (got.float() - flash_attention_ref(q, k, v, True).float()
           ).abs().max().item()
    del got
    print(f"flash_attention {label}: max_abs_err {err:.3e} (tol "
          f"{FWD_TOL[dtype]:g})")
    if err > FWD_TOL[dtype]:
        raise SystemExit(f"flash_attention disagrees with its plain version "
                         f"at {label}")
    fwd = {"max_abs_err": err, **time_attention(q, k, v), "shape": shape}
    print(f"flash_attention timing at {label}: kernel {fwd['ms']:.4f} ms "
          f"({fwd['tflops']:.1f} TFLOP/s), plain {fwd['plain_ms']:.4f} ms, "
          f"sdpa {fwd['library_ms']:.4f} ms ({fwd['library_tflops']:.1f} "
          f"TFLOP/s), bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']})")
    _, lse = fa._forward(q, k, v, True, None, with_lse=True)
    got = fa.flash_attention_bwd(q, k, v, lse, do, True, None)
    again = fa.flash_attention_bwd(q, k, v, lse, do, True, None)
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    del again
    errs, l2 = bwd_errs(got, flash_attention_bwd_ref(q, k, v, lse, do, True,
                                                     None))
    del got
    print(f"flash_attention_bwd {label}: max err of the scale "
          + " ".join(f"{key} {e:.3e}" for key, e in errs.items())
          + f" (tol {BWD_TOL[dtype]:g}), rel L2 "
          + " ".join(f"{key} {e:.3e}" for key, e in l2.items())
          + f" (tol {BWD_L2_TOL[dtype]:g}), repeat equal {same}")
    if (max(errs.values()) > BWD_TOL[dtype]
            or max(l2.values()) > BWD_L2_TOL[dtype] or not same):
        raise SystemExit(f"flash_attention_bwd disagrees with its plain "
                         f"version at {label}")
    bwd = {**time_attention_bwd(label, q, k, v, lse, do, True),
           "max_abs_err": max(errs.values()), "rel_l2": max(l2.values()),
           "shape": shape}
    del q, k, v, do, lse
    torch.cuda.empty_cache()
    return fwd, bwd


def bwd_inputs(b, hq, hkv, s, t, d, dtype):
    """q/k/v as (B, S, H, D) views on the card (the model's layout) and
    dO."""
    q, k, v = attention_inputs(b, hq, hkv, s, t, d, dtype, model_layout=True)
    g = torch.Generator("cuda").manual_seed(1)
    do = torch.randn(q.shape, generator=g, device="cuda", dtype=dtype)
    return q, k, v, do


def time_flash_attention_bwd_points():
    """The backward kernel alone (ms) at the first BWD_TIMED shapes of
    BWD_SHAPES in bf16 and fp32, beside its bound (--kernel-times: the
    same code times two trees)."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, b, hq, hkv, s, t, d, causal, window in (
                BWD_SHAPES[:BWD_TIMED]):
            q, k, v, do = bwd_inputs(b, hq, hkv, s, t, d, dtype)
            _, lse = fa._forward(q, k, v, causal, window, with_lse=True)
            ms = cuda_ms([lambda: fa.flash_attention_bwd(
                q, k, v, lse, do, causal, window)],
                reps=10 if dtype == torch.bfloat16 else 3)
            bound_ms, bound_by, flops = attention_bwd_bound(q, k, causal,
                                                            window)
            key = name + (" fp32" if dtype == torch.float32 else "")
            out[key] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "tflops": flops / (ms * 1e-3) / 1e12}
            print(f"flash_attention_bwd timing {dtype} {name}: kernel "
                  f"{ms:.4f} ms ({out[key]['tflops']:.1f} TFLOP/s), bound "
                  f"{bound_ms:.4f} ms ({bound_by})")
            del q, k, v, lse, do
            torch.cuda.empty_cache()
    return out


def scan_grad_errs(got, expect):
    """Each gradient's largest deviation over its scale max(1, max |plain|)
    and its relative L2 error ||g - e|| / ||e||, and whether all are
    finite."""
    errs, l2, finite = [], [], True
    for a, e in zip(got, expect):
        a, e = a.float(), e.float()
        finite = finite and bool(torch.isfinite(a).all())
        errs.append((a - e).abs().max().item()
                    / max(1.0, e.abs().max().item()))
        norm = torch.linalg.vector_norm(e).item()
        l2.append(torch.linalg.vector_norm(a - e).item() / (norm or 1.0))
    return errs, l2, finite


def check_scan_grads(kernel, label, names, got, again, expect, dtype):
    """Print and hold one case of a scan's backward: every gradient within
    BWD_TOL of its scale and BWD_L2_TOL relative L2, finite, and equal bit
    for bit to a second call's.  Returns (largest scaled error, largest
    relative L2 error)."""
    errs, l2, finite = scan_grad_errs(got, expect)
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    print(f"{kernel} {label}: max err of the scale "
          + " ".join(f"{n} {e:.2e}" for n, e in zip(names, errs))
          + f" (tol {BWD_TOL[dtype]:g}), rel L2 "
          + " ".join(f"{n} {e:.2e}" for n, e in zip(names, l2))
          + f" (tol {BWD_L2_TOL[dtype]:g}), finite {finite}, repeat equal "
          f"{same}")
    if (max(errs) > BWD_TOL[dtype] or max(l2) > BWD_L2_TOL[dtype]
            or not finite or not same):
        raise SystemExit(f"{kernel} disagrees with its plain version on "
                         f"{label}")
    return max(errs), max(l2)


def time_scan_bwd(kernel, label, run, plain, bound_ms, bound_by, shape):
    """Kernel and plain version (ms, the card asleep while the host queues
    the kernel's calls) beside the bound; no single PyTorch call computes
    either backward, so library_ms is null."""
    ms = cuda_ms([run], reps=10)
    plain_ms = cuda_ms([plain], reps=1)
    print(f"{kernel} timing {label}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); no "
          f"single PyTorch call computes it")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "shape": shape}


def rwkv6_bwd_case(b, h, s, d, dtype, layout, extreme=False):
    """rwkv6_scan_bwd's inputs on the card (decays 1e-30 and 1 on
    alternate steps with ``extreme``), dy in the inputs' layout and
    ds_last."""
    x = rwkv6_inputs(b, h, s, d, dtype, layout, seed=2)
    if extreme:
        x[3][:, :, 0::2] = 1e-30
        x[3][:, :, 1::2] = 1.0
    g = torch.Generator("cuda").manual_seed(3)
    dy = (torch.randn(b, s, h, d, generator=g, device="cuda")
          .transpose(1, 2) if layout else
          torch.randn(b, h, s, d, generator=g, device="cuda")).to(dtype)
    ds_last = torch.randn(b, h, d, d, generator=g, device="cuda")
    return x, dy, ds_last


def time_rwkv6_bwd_points():
    """rwkv6_scan_bwd at rwkv6-1.6b's training shape (8, 32, 1024, 64) in
    the model layout, fp32 and bf16, beside the bound: ``ms`` the backward
    as a train step calls it (given the piece states that the forward's
    checkpoint epilogue saved, where the tree's backward takes them; a
    tree whose backward takes none: the call, which walks the forward
    itself), ``ms_from_inputs`` the call without them (a forward launch
    with the epilogue first)."""
    out = {}
    takes_states = "states" in inspect.signature(
        rw.rwkv6_scan_bwd).parameters
    b, h, s, d = RWKV_BWD_CASES[0][1:5]
    for dtype in (torch.float32, torch.bfloat16):
        x, dy, ds_last = rwkv6_bwd_case(b, h, s, d, dtype, True)
        rec = {}
        if takes_states:
            states = rw._forward(*x, None, with_states=True)[2]
            rec["ms"] = cuda_ms([lambda: rw.rwkv6_scan_bwd(
                *x, dy, ds_last, states)], reps=10)
            rec["ms_from_inputs"] = cuda_ms([lambda: rw.rwkv6_scan_bwd(
                *x, dy, ds_last)], reps=10)
            del states
        else:
            rec["ms"] = cuda_ms([lambda: rw.rwkv6_scan_bwd(
                *x, dy, ds_last)], reps=10)
        rec["bound_ms"], rec["bound_by"] = scan_bound(rw.scan_bwd_cost(x[0]))
        out[str(dtype)] = rec
        extra = (f", from the inputs {rec['ms_from_inputs']:.4f} ms"
                 if takes_states else " (walks the forward itself)")
        print(f"rwkv6_scan_bwd timing {dtype} (8, 32, 1024, 64): kernel "
              f"{rec['ms']:.4f} ms{extra}, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})")
        del x, dy, ds_last
        torch.cuda.empty_cache()
    return out


def check_rwkv6_scan_bwd():
    """The rwkv6_scan backward kernel against ``rwkv6_scan_bwd_ref`` at
    RWKV_BWD_CASES (cotangents on y and s_last), from the piece states of
    the forward's checkpoint epilogue (those within 2e-4 (1 + |plain|) of
    ``rwkv6_scan_states_ref``, its y equal to the launch's without the
    epilogue; the call without states equal bit for bit), the training
    shape timed in fp32 and bf16.  Returns its record."""
    record, worst = None, {}
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    for label, b, h, s, d, dtype, layout, extreme in RWKV_BWD_CASES:
        x, dy, ds_last = rwkv6_bwd_case(b, h, s, d, dtype, layout, extreme)
        y, _, states = rw._forward(*x, None, with_states=True)
        y_serve = rw._forward(*x, None)[0]
        st_err, st_ok = allclose_err(
            states, kernel_ref.rwkv6_scan_states_ref(*x[1:4], x[5]), 2e-4)
        got = rw.rwkv6_scan_bwd(*x, dy, ds_last, states)
        again = rw.rwkv6_scan_bwd(*x, dy, ds_last, states)
        alone = rw.rwkv6_scan_bwd(*x, dy, ds_last)
        expect = rwkv6_scan_bwd_ref(*x, dy, ds_last)
        torch.cuda.synchronize()
        y_same = torch.equal(y, y_serve)
        alone_same = all(torch.equal(a, c) for a, c in zip(got, alone))
        print(f"rwkv6_scan checkpoint epilogue {label}: states max_abs_err "
              f"{st_err:.3e} (within 2e-4 (1 + |plain|): {st_ok}), y equal "
              f"to the launch without it {y_same}; the backward without "
              f"states equal {alone_same}")
        if not (st_ok and y_same and alone_same):
            raise SystemExit(f"rwkv6_scan's checkpoint epilogue disagrees "
                             f"on {label}")
        err, l2 = check_scan_grads("rwkv6_scan_bwd", label, names, got,
                                   again, expect, dtype)
        worst[str(dtype)] = max(worst.get(str(dtype), 0.0), l2)
        del got, again, alone, expect, y, y_serve
        if s == 1024:
            times = time_scan_bwd(
                "rwkv6_scan_bwd", label,
                lambda: rw.rwkv6_scan_bwd(*x, dy, ds_last, states),
                lambda: rwkv6_scan_bwd_ref(*x, dy, ds_last),
                *scan_bound(rw.scan_bwd_cost(x[0])),
                {"b": b, "h": h, "s": s, "d": d, "dtype": str(dtype)})
            times["ms_from_inputs"] = cuda_ms(
                [lambda: rw.rwkv6_scan_bwd(*x, dy, ds_last)], reps=10)
            print(f"rwkv6_scan_bwd timing {label}: the call without the "
                  f"forward's states (a forward launch with the epilogue "
                  f"first) {times['ms_from_inputs']:.4f} ms")
            if record is None:
                record = {"name": "rwkv6_scan_bwd", "route": "cuda",
                          "source": "src/repro_torch/kernels/csrc/"
                                    "rwkv6_scan_bwd.cu",
                          "replaces": "src/repro/kernels/rwkv6_scan.py:53",
                          **times, "max_abs_err": err}
            else:
                record["bf16"] = times
        del x, dy, ds_last, states
        torch.cuda.empty_cache()
    record["worst_rel_l2"] = worst
    return record


def rglru_bwd_case(b, s, r, dtype, extreme=False):
    """rglru_scan_bwd's inputs on the card (even steps decay 1e-30 and odd
    steps' even channels 1 with ``extreme``), dy and dh_last."""
    a, gx, h0 = rglru_inputs(b, s, r, dtype, seed=4)
    if extreme:
        a[:, 0::2] = 1e-30
        a[:, 1::2, 0::2] = 1.0
    g = torch.Generator("cuda").manual_seed(5)
    dy = torch.randn(b, s, r, generator=g, device="cuda").to(dtype)
    dh_last = torch.randn(b, r, generator=g, device="cuda")
    return (a, gx, h0), dy, dh_last


def rglru_bwd_stream_ms(x, dy):
    """One torch.add(a, g) and one torch.neg(dy) into two outputs: the
    backward's bytes (a, g and dy read, two rows written) through two
    plain elementwise passes, the reach of streaming them on this card
    (not a library call of the backward, which has none)."""
    u, v = torch.empty_like(dy), torch.empty_like(dy)
    return cuda_ms([lambda: (torch.add(x[0], x[1], out=u),
                             torch.neg(dy, out=v))], reps=10)


def time_rglru_bwd_points():
    """rglru_scan_bwd at recurrentgemma-9b's training shape (8, 1024, 4096),
    fp32 and bf16, beside the bound: ``ms`` the backward as a train step
    calls it (given the checkpoints that the forward's epilogue saved,
    where the tree's backward takes them; a tree whose backward takes y:
    given the forward's y), ``ms_from_inputs`` the call without them (a
    forward launch with the epilogue first), and the forward at that
    shape without and with the epilogue (``fwd_ms``, ``fwd_ckpt_ms``),
    beside :func:`rglru_bwd_stream_ms` (``stream_ms``)."""
    out = {}
    takes_ckpt = "checkpoints" in inspect.signature(
        rg.rglru_scan_bwd).parameters
    b, s, r = RGLRU_BWD_CASES[0][1:4]
    for dtype in (torch.float32, torch.bfloat16):
        x, dy, dh_last = rglru_bwd_case(b, s, r, dtype)
        rec = {}
        if takes_ckpt:
            ckpt = rg._forward(*x, with_checkpoints=True)[2]
            rec["ms"] = cuda_ms([lambda: rg.rglru_scan_bwd(
                *x, dy, dh_last, ckpt)], reps=10)
            rec["ms_from_inputs"] = cuda_ms([lambda: rg.rglru_scan_bwd(
                *x, dy, dh_last)], reps=10)
            rec["fwd_ms"] = cuda_ms([lambda: rg._forward(*x)], reps=10)
            rec["fwd_ckpt_ms"] = cuda_ms([lambda: rg._forward(
                *x, with_checkpoints=True)], reps=10)
            del ckpt
        else:
            with torch.no_grad():
                y, _ = rg.rglru_scan(*x)
            rec["ms"] = cuda_ms([lambda: rg.rglru_scan_bwd(
                *x, y, dy, dh_last)], reps=10)
            rec["fwd_ms"] = cuda_ms([lambda: rg.rglru_scan(*x)], reps=10)
            del y
        rec["bound_ms"], rec["bound_by"] = scan_bound(rg.scan_bwd_cost(x[0]))
        rec["stream_ms"] = rglru_bwd_stream_ms(x, dy)
        out[str(dtype)] = rec
        extra = (f", from the inputs {rec['ms_from_inputs']:.4f} ms; the "
                 f"forward {rec['fwd_ms']:.4f} ms, with the epilogue "
                 f"{rec['fwd_ckpt_ms']:.4f} ms" if takes_ckpt else
                 f" (given y); the forward {rec['fwd_ms']:.4f} ms")
        print(f"rglru_scan_bwd timing {dtype} ({b}, {s}, {r}): kernel "
              f"{rec['ms']:.4f} ms{extra}, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), torch.add + torch.neg over the same "
              f"bytes {rec['stream_ms']:.4f} ms")
        del x, dy, dh_last
        torch.cuda.empty_cache()
    return out


def check_rglru_checkpoints(label, x, y, ckpt):
    """The forward's checkpoint epilogue on one case: checkpoint 0 is h0,
    checkpoint p the fp32 forward kernel's y[:, 64p - 1] on the widened
    inputs, bit for bit, and y equal to the launch's without the
    epilogue."""
    a, gx, h0 = x
    y_serve = rg._forward(*x)[0]
    y32 = rg._forward(a.float(), gx.float(), h0)[0]
    torch.cuda.synchronize()
    piece = kernel_ref.RGLRU_PIECE
    same = bool(torch.equal(ckpt[:, 0], h0)) and all(
        torch.equal(ckpt[:, p], y32[:, piece * p - 1])
        for p in range(1, ckpt.shape[1]))
    y_same = bool(torch.equal(y, y_serve))
    print(f"rglru_scan checkpoint epilogue {label}: {ckpt.shape[1]} "
          f"checkpoints equal to the fp32 forward's carries {same}, y equal "
          f"to the launch without it {y_same}")
    if not (same and y_same):
        raise SystemExit(f"rglru_scan's checkpoint epilogue disagrees on "
                         f"{label}")


def check_rglru_scan_bwd():
    """The rglru_scan backward kernel against ``rglru_scan_bwd_ref`` at
    RGLRU_BWD_CASES (cotangents on y and h_last), from the checkpoints of
    the forward's epilogue (:func:`check_rglru_checkpoints`; the call
    without them equal bit for bit; the staged route equal bit for bit to
    the step route), the training shape timed in fp32 and bf16.  Returns
    its record."""
    record, worst = None, {}
    names = ("da", "dg", "dh0")
    for label, b, s, r, dtype, extreme in RGLRU_BWD_CASES:
        x, dy, dh_last = rglru_bwd_case(b, s, r, dtype, extreme)
        y, _, ckpt = rg._forward(*x, with_checkpoints=True)
        check_rglru_checkpoints(label, x, y, ckpt)
        del y
        got = rg.rglru_scan_bwd(*x, dy, dh_last, ckpt)
        again = rg.rglru_scan_bwd(*x, dy, dh_last, ckpt)
        alone = rg.rglru_scan_bwd(*x, dy, dh_last)
        plan = rg.bwd_plan(r, x[0].element_size())
        step = (rg.bwd_launch(x[0], x[1], ckpt, dy, dh_last, rg.STEP)
                if plan.route == "staged" else got)
        expect = rglru_scan_bwd_ref(*x, dy, dh_last)
        torch.cuda.synchronize()
        alone_same = all(torch.equal(u, v) for u, v in zip(got, alone))
        step_same = all(torch.equal(u, v) for u, v in zip(got, step))
        print(f"rglru_scan_bwd {label} ({plan.route} route): the call "
              f"without the checkpoints equal {alone_same}, equal to the "
              f"step route {step_same}")
        if not (alone_same and step_same):
            raise SystemExit(f"rglru_scan_bwd's calls or routes disagree on "
                             f"{label}")
        err, l2 = check_scan_grads("rglru_scan_bwd", label, names, got,
                                   again, expect, dtype)
        worst[str(dtype)] = max(worst.get(str(dtype), 0.0), l2)
        del got, again, alone, step, expect
        if s == 1024:
            times = time_scan_bwd(
                "rglru_scan_bwd", label,
                lambda: rg.rglru_scan_bwd(*x, dy, dh_last, ckpt),
                lambda: rglru_scan_bwd_ref(*x, dy, dh_last),
                *scan_bound(rg.scan_bwd_cost(x[0])),
                {"b": b, "s": s, "r": r, "dtype": str(dtype)})
            times["ms_from_inputs"] = cuda_ms(
                [lambda: rg.rglru_scan_bwd(*x, dy, dh_last)], reps=10)
            times["stream_ms"] = rglru_bwd_stream_ms(x, dy)
            print(f"rglru_scan_bwd timing {label}: the call without the "
                  f"forward's checkpoints (a forward launch with the "
                  f"epilogue first) {times['ms_from_inputs']:.4f} ms; "
                  f"torch.add + torch.neg over the same bytes "
                  f"{times['stream_ms']:.4f} ms")
            if record is None:
                record = {"name": "rglru_scan_bwd", "route": "cuda",
                          "source": "src/repro_torch/kernels/csrc/"
                                    "rglru_scan_bwd.cu",
                          "replaces": "src/repro/kernels/rglru_scan.py:47",
                          **times, "max_abs_err": err}
            else:
                record["bf16"] = times
        del x, dy, dh_last, ckpt
        torch.cuda.empty_cache()
    record["worst_rel_l2"] = worst
    return record


def tree_rel_errs(got, expect):
    """||g - e|| / ||e|| (fp32, on the card) of each leaf, in the trees'
    leaf order."""
    out = []
    for a, e in zip(tree_flatten(got)[0], tree_flatten(expect)[0]):
        a, e = a.to(CARD).float(), e.to(CARD).float()
        norm = torch.linalg.vector_norm(e).item()
        diff = torch.linalg.vector_norm(a - e).item()
        out.append(diff / norm if norm > 0 else diff)
    return out


def step_counts(cfg):
    """Launches of each kernel in one train step of ``cfg``: one forward
    and one backward of every attention and recurrence, and with remat a
    second forward (the recompute)."""
    fwd = 2 if cfg.remat else 1
    if cfg.family == "ssm":
        return {"rwkv6_scan": fwd * cfg.n_layers,
                "rwkv6_scan_bwd": cfg.n_layers}
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        n_rec = cfg.n_layers - n_attn
        return {"rglru_scan": fwd * n_rec, "rglru_scan_bwd": n_rec,
                "flash_attention": fwd * n_attn,
                "flash_attention_bwd": n_attn}
    n_attn = (cfg.n_enc_layers + 2 * cfg.n_layers
              if cfg.family == "encdec" else cfg.n_layers)
    return {"flash_attention": fwd * n_attn, "flash_attention_bwd": n_attn}


def check_smoke_train_steps():
    """One train step of each TRAIN_SMOKE smoke config (fp32) on the card
    against the same step on the CPU from the same weights, AdamW state and
    batch: loss, grad_norm and every updated parameter within
    TRAIN_SMOKE_TOL of max(1, max |CPU|); every attention and recurrence
    call once through its forward kernel and once through its backward
    (:func:`step_counts`; the smoke configs keep no remat)."""
    b, seq, chunk = TRAIN_SMOKE_SHAPE
    cpu = torch.device("cpu")
    for arch in TRAIN_SMOKE:
        cfg = configs.get(arch).smoke_config()
        params, state = train_steps.init_train_state(
            cfg, cpu, torch.Generator(cpu).manual_seed(0))
        batch = concrete_batch(cfg, seq, b, rng=np.random.default_rng(0))
        step = train_steps.make_train_step(
            cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4), chunk)
        expect = step(params, state, batch)
        _build.reset_launches()
        got = step(to_card(params), to_card(state), to_card(batch))
        torch.cuda.synchronize()
        check_counts(f"{arch} smoke train step", read_counts(),
                     step_counts(cfg))
        errs = {key: abs(got[2][key].item() - expect[2][key].item())
                / max(1.0, abs(expect[2][key].item()))
                for key in ("loss", "grad_norm", "lr")}
        worst = 0.0
        for a, e in zip(tree_flatten(got[0])[0], tree_flatten(expect[0])[0]):
            worst = max(worst, (a.cpu() - e).abs().max().item()
                        / max(1.0, e.abs().max().item()))
        print(f"{arch} smoke train step card vs CPU: loss "
              f"{got[2]['loss'].item():.6f} (err {errs['loss']:.2e}), "
              f"grad_norm err {errs['grad_norm']:.2e}, lr err "
              f"{errs['lr']:.2e}, worst updated parameter {worst:.2e} (tol "
              f"{TRAIN_SMOKE_TOL:g})")
        if max(worst, *errs.values()) > TRAIN_SMOKE_TOL:
            raise SystemExit(f"{arch}: the card's train step disagrees with "
                             f"the CPU's")


# parameters of a model's blocks that are not matmul weights: rwkv6's
# token-shift mixes and bonus u, recurrentgemma's depthwise conv taps
ELEMENTWISE_PARAMS = ("mu", "u", "conv_w")


def block_matmul_weights(params):
    """Weights of the blocks' matrix products: every parameter of two or
    more dims outside the embedding, the head and the final norm, less
    ELEMENTWISE_PARAMS."""
    return sum(x.numel() for key, sub in params.items()
               if key not in ("embed", "head", "final_norm")
               for path, x in zip(leaf_paths(sub), tree_flatten(sub)[0])
               if x.dim() >= 2 and path[-1] not in ELEMENTWISE_PARAMS)


def train_step_flops(cfg, params, batch, seq):
    """The hand formula of a train step's FLOPs, printed beside the count
    (``launch/op_analysis.py``), and its text: the blocks' matrix products
    (:func:`block_matmul_weights`) and the unembedding 4 times (forward,
    the remat or loss-chunk recompute, and a backward of twice the
    forward), attention's two forward products 2 times (forward, remat)
    plus the backward's 5; the recurrences' few CUDA-core operations are
    not counted.  It overstates the step: remat does not recompute each
    block's last product (:func:`remat_skipped_flops`)."""
    tokens = batch * seq
    n_attn = (0 if cfg.family == "ssm"
              else cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
              else cfg.n_layers)
    block_w = block_matmul_weights(params)
    unembed_w = cfg.d_model * cfg.vocab
    attn_fwd = 4 * cfg.hd * cfg.n_heads * batch * seq * (seq + 1) // 2
    matmul = 4 * 2 * tokens * (block_w + unembed_w)
    attention = n_attn * attn_fwd * (2 + 2.5)
    formula = (f"4 x 2 x {tokens} tokens x ({block_w} block matmul weights "
               f"of {cfg.n_layers} layers + {unembed_w} unembedding) + "
               f"{n_attn} attention layers x 4.5 x {attn_fwd} causal "
               f"attention flops")
    return matmul + attention, formula


def remat_skipped_flops(cfg, batch, seq):
    """FLOPs of the products that remat does not recompute, which
    :func:`train_step_flops` counts 4 times where the step runs them 3:
    non-reentrant ``torch.utils.checkpoint`` stops recomputing once the
    tensors the backward saved are rebuilt, so each block's last product,
    the MLP's down projection, runs once forward.  dense and vlm: 2 x
    tokens x d_ff x d_model a layer; moe: the experts' (E, groups, C, F) x
    (E, F, D) products; None for the other families (or no remat)."""
    if not cfg.remat or cfg.family not in ("dense", "vlm", "moe"):
        return None
    tokens = batch * seq
    if cfg.family != "moe":
        return cfg.n_layers * 2 * tokens * cfg.d_ff * cfg.d_model
    g = min(cfg.moe_group, seq)
    cap = min(int(cfg.capacity_factor * g * cfg.top_k / cfg.n_experts) + 1,
              g)
    return (cfg.n_layers * 2 * cfg.n_experts * (tokens // g) * cap
            * cfg.d_ff * cfg.d_model)


def plain_attention(q, k, v, causal=True, window=None):
    return flash_attention_ref(q, k, v, causal=causal, window=window)


def plain_rwkv6_scan(r, k, v, w, u, s0, out=None):
    return rwkv6_scan_ref(r, k, v, w, u, s0)


def grads_of(cfg, params, batch, chunk, plain=False):
    """``loss_and_grads`` of one step in loss chunks of ``chunk``;
    ``plain``: with the plain versions (``flash_attention_ref``,
    ``rwkv6_scan_ref``, ``rglru_scan_ref``, differentiated by autograd) in
    the kernels' places."""
    if not plain:
        return train_steps.loss_and_grads(cfg, params, batch, chunk)
    with unittest.mock.patch.object(lm, "flash_attention", plain_attention), \
            unittest.mock.patch.object(rwkv6, "rwkv6_scan",
                                       plain_rwkv6_scan), \
            unittest.mock.patch.object(rglru, "rglru_scan", rglru_scan_ref):
        return train_steps.loss_and_grads(cfg, params, batch, chunk)


def print_leaf_errs(label, names, errs):
    print(f"{label}, gradient rel L2 per leaf:")
    for i in range(0, len(errs), 6):
        print("  " + ", ".join(f"{n} {e:.2e}" for n, e in
                               zip(names[i:i + 6], errs[i:i + 6])))
    worst = max(errs)
    print(f"{label}: largest {worst:.3e} ({names[errs.index(worst)]})")
    return {"worst": worst, "leaf": names[errs.index(worst)],
            "median": float(np.median(errs))}


def row_slice(batch, lo, hi):
    """Rows ``lo:hi`` of a batch (positions: (3, B, S))."""
    return {k: v[:, lo:hi] if k == "positions" else v[lo:hi]
            for k, v in batch.items()}


def sliced_grads(cfg, params, batch, chunk, rows):
    """The plain step's loss and gradients over ``batch`` as the mean of
    its steps over slices of ``rows`` rows, summed on the host in fp32
    (the loss is a mean over positions and every row has as many, so the
    mean of the slices' is the whole batch's)."""
    n = batch["tokens"].shape[0] // rows
    loss, acc = 0.0, None
    for i in range(n):
        part_loss, grads = grads_of(cfg, params,
                                    row_slice(batch, i * rows,
                                              (i + 1) * rows),
                                    chunk, plain=True)
        leaves, treedef = tree_flatten(grads)
        if acc is None:
            acc = [x.cpu().float() for x in leaves]
        else:
            for a, x in zip(acc, leaves):
                a.add_(x.cpu())
        loss += part_loss.item()
        del grads, leaves
    return (torch.tensor(loss / n),
            tree_unflatten(treedef, [a.div_(n) for a in acc]))


class RoutingReplay:
    """The MoE's top-k choices (``torch.topk`` in ``models/lm.py``'s
    moe_block, the only top-k of a train step) recorded in one step and
    replayed in another, so that two fp32 steps whose router logits differ
    by rounding (the kernels' attention against its plain version) route
    every token alike: a choice between two experts within rounding would
    otherwise flip, and with it a token's whole path.  ``flipped`` counts
    the replayed step's own choices that differ from the recorded ones."""

    def __init__(self):
        self.idx, self.calls, self.flipped, self.choices = [], 0, 0, 0
        self.topk = torch.topk

    def _record(self, probs, k, dim=-1):
        vals, idx = self.topk(probs, k, dim=dim)
        self.idx.append(idx)
        return vals, idx

    def _replay(self, probs, k, dim=-1):
        own = self.topk(probs, k, dim=dim)[1]
        idx = self.idx[self.calls]
        self.calls += 1
        self.choices += idx.numel()
        self.flipped += int((torch.sort(own, dim=dim)[0]
                             != torch.sort(idx, dim=dim)[0]).sum())
        return probs.gather(dim, idx), idx

    def record(self):
        return unittest.mock.patch.object(torch, "topk", self._record)

    def replay(self):
        return unittest.mock.patch.object(torch, "topk", self._replay)


def check_against_plain(cfg, params, batch, chunk, plain_rows=None):
    """One step's loss and gradients (bf16, the trained weights) against the
    same step with the plain versions in the kernels' places, beside both
    steps' distance to the plain step on the weights made fp32 (the bf16
    noise): the loss within TRAIN_LOSS_TOL relative; each leaf that bf16
    resolves (the plain bf16 step within TRAIN_GRAD_TOL[bf16] of the fp32
    plain step: every leaf of qwen3-1.7b) within TRAIN_GRAD_TOL[bf16] of
    the plain bf16 step; each leaf that bf16 does not resolve (where any
    two bf16 evaluations that round differently part by its noise) no
    further from the fp32 plain step than the plain bf16 step is, plus
    TRAIN_GRAD_TOL[bf16].  Then the kernels' own fp32 step (all layers,
    their fp32 routes) against that plain fp32 step, the loss within
    TRAIN_LOSS_TOL and each leaf within TRAIN_GRAD_TOL[fp32] (the moe
    family: with the plain step's top-k choices replayed,
    :class:`RoutingReplay`, of which at most MAX_FLIPPED_SHARE may differ
    from the kernels' step's own).  Each leaf's relative L2 error is printed.
    Each step's gradients wait in the host's memory (the card holds the
    weights and one step's: a 4-layer qwen2-vl-72b's fp32 weights and
    three gradient trees do not fit).
    ``plain_rows``: the plain steps over slices of that many rows
    (:func:`sliced_grads`); the kernels' steps always take the whole
    batch."""
    names = [".".join(map(str, path)) for path in leaf_paths(params)]
    tol = TRAIN_GRAD_TOL[torch.bfloat16]

    def grads_of_step(*args, plain=False):
        if plain and plain_rows is not None:
            return sliced_grads(*args, plain_rows)
        loss, grads = grads_of(*args, plain=plain)
        return loss, to_host(grads)
    loss, grads = grads_of_step(cfg, params, batch, chunk)
    loss_p, grads_p = grads_of_step(cfg, params, batch, chunk, plain=True)
    loss_err = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
    print(f"bf16 step: loss {loss.item():.6f} vs the plain versions "
          f"{loss_p.item():.6f} (rel {loss_err:.2e}, tol "
          f"{TRAIN_LOSS_TOL:g})")
    out = {"loss_rel_err": loss_err}
    kp = tree_rel_errs(grads, grads_p)
    out["bf16_vs_plain"] = print_leaf_errs("bf16 step vs the plain step",
                                           names, kp)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = to_fp32(params)
    routing = RoutingReplay() if cfg.family == "moe" else None
    with routing.record() if routing else contextlib.nullcontext():
        loss_f, grads_f = grads_of_step(cfg32, params32, batch, chunk,
                                        plain=True)
    kf = tree_rel_errs(grads, grads_f)
    pf = tree_rel_errs(grads_p, grads_f)
    del grads, grads_p
    out["bf16_vs_fp32"] = print_leaf_errs("bf16 step vs the fp32 plain step",
                                          names, kf)
    out["plain_bf16_vs_fp32"] = print_leaf_errs(
        "plain bf16 step vs the fp32 plain step (the bf16 noise)", names, pf)
    ratio = max(a / b for a, b in zip(kf, pf) if b > 0)
    out["worst_noise_ratio"] = ratio
    print(f"bf16: the kernels' distance to the fp32 step over the plain "
          f"step's, worst leaf {ratio:.3f}")
    resolved = [p <= tol for p in pf]
    out["bf16_resolved_leaves"] = sum(resolved)
    out["bf16_resolved_worst"] = max(
        (e for e, r in zip(kp, resolved) if r), default=0.0)
    out["bf16_unresolved_worst_excess"] = max(
        (k - p for k, p, r in zip(kf, pf, resolved) if not r), default=0.0)
    print(f"bf16: {sum(resolved)} of {len(names)} leaves resolved (the plain "
          f"bf16 step within {tol:g} of the fp32 step), the kernels' step "
          f"vs the plain step on them worst "
          f"{out['bf16_resolved_worst']:.3e} (tol {tol:g}); on the others "
          f"the kernels' distance to the fp32 step beyond the plain bf16 "
          f"step's, worst {out['bf16_unresolved_worst_excess']:.3e} (tol "
          f"{tol:g})")
    with routing.replay() if routing else contextlib.nullcontext():
        loss32, grads32 = grads_of(cfg32, params32, batch, chunk)
    if routing:
        out["fp32_routing"] = {"topk_calls": routing.calls,
                               "recorded": len(routing.idx),
                               "choices": routing.choices,
                               "flipped": routing.flipped}
        print(f"fp32: the plain step's top-k choices replayed in the "
              f"kernels' step ({routing.calls} calls of {len(routing.idx)} "
              f"recorded); of its own {routing.choices} choices "
              f"{routing.flipped} differ from the plain step's")
        if routing.calls != len(routing.idx):
            raise SystemExit("the two fp32 steps' top-k calls differ")
        if routing.flipped > MAX_FLIPPED_SHARE * routing.choices:
            raise SystemExit(f"fp32: {routing.flipped} of the kernels' "
                             f"{routing.choices} top-k choices differ from "
                             f"the plain step's, above the "
                             f"{MAX_FLIPPED_SHARE:g} share that rounding "
                             f"ties explain")
    out["fp32_loss_rel_err"] = abs(loss32.item() - loss_f.item()) / abs(
        loss_f.item())
    out["fp32_vs_plain"] = print_leaf_errs(
        f"fp32 step ({cfg.n_layers} layers) vs the plain step",
        names, tree_rel_errs(grads32, grads_f))
    print(f"bounds: loss {TRAIN_LOSS_TOL:g}, gradients bf16 "
          f"{TRAIN_GRAD_TOL[torch.bfloat16]:g}, fp32 "
          f"{TRAIN_GRAD_TOL[torch.float32]:g}")
    if (loss_err > TRAIN_LOSS_TOL
            or out["bf16_resolved_worst"] > tol
            or out["bf16_unresolved_worst_excess"] > tol
            or out["fp32_loss_rel_err"] > TRAIN_LOSS_TOL
            or out["fp32_vs_plain"]["worst"] > TRAIN_GRAD_TOL[torch.float32]):
        raise SystemExit("the kernels' train step disagrees with the "
                         "plain step")
    return out


def leaf_paths(tree, prefix=()):
    """The key path of each leaf, in ``tree_flatten``'s order."""
    if isinstance(tree, dict):
        return [p for key in sorted(tree)
                for p in leaf_paths(tree[key], prefix + (key,))]
    if isinstance(tree, list):
        return [p for i, sub in enumerate(tree)
                for p in leaf_paths(sub, prefix + (i,))]
    return [prefix]


def check_donated_update(opt_cfg, params, state, grads):
    """One update of full-width weights both ways from the same gradients:
    the functional one (fresh tensors), then the donated one (written into
    ``params`` and ``state``, which hold its values after); every
    parameter and moment, lr and grad_norm bit-equal.  Returns the
    record."""
    new_p, new_s, m = adamw_update(opt_cfg, params, grads, state)
    got_p, got_s, m2 = adamw_update(opt_cfg, params, grads, state,
                                    donate=True)
    torch.cuda.synchronize()
    got = tree_flatten((got_p, got_s["mu"], got_s["nu"]))[0]
    new = tree_flatten((new_p, new_s["mu"], new_s["nu"]))[0]
    differ = sum(not torch.equal(a, e) for a, e in zip(got, new))
    differ += sum(not torch.equal(m[k], m2[k]) for k in ("lr", "grad_norm"))
    out = {"tensors": len(got), "over_piece": sum(x.numel() > PIECE
                                                  for x in got),
           "elements": sum(x.numel() for x in got), "differ": differ}
    print(f"donated update vs functional: {out['tensors']} parameter and "
          f"moment tensors ({out['elements']} elements, "
          f"{out['over_piece']} of them longer than a piece of {PIECE}), "
          f"lr and grad_norm; {differ} differ (must be 0)")
    if differ:
        raise SystemExit("the donated update disagrees with the functional "
                         "one")
    return out


def run_training_path(arch, smi, layers=None, plain_rows=None,
                      check_donation=False):
    """``arch`` at full width (bf16 weights from seed 0, remat; ``layers``:
    cut to its first that many layers, said wherever its numbers are
    printed): 1 warm-up + TRAIN_STEPS timed train steps of TRAIN_BATCH x
    SEQ tokens (the vlm: after its patches) from ``launch/train.py``'s
    ``step_batch``, in loss chunks of its ``loss_chunk``, the update
    functional as the driver's unless ``launch/steps.py``'s
    ``donate_update`` says it does not fit on the card (then written into
    the state), each with every kernel's count set to 0 just before and
    read just after (:func:`step_counts`: forward and remat, one
    backward).  ``check_donation``: then one more update of step 0's batch
    both ways (:func:`check_donated_update`).  Then one step's loss and
    gradients against the step through the plain versions
    (:func:`check_against_plain`; ``plain_rows``: the plain steps over
    slices of that many rows).  Returns the phase's record."""
    full = configs.get(arch).config()
    cfg = (full if layers is None
           else dataclasses.replace(full, n_layers=layers))
    cut = ("" if layers is None
           else f" ({layers} of {full.n_layers} layers)")
    n_params = api.param_count(cfg)
    chunk = train_driver.loss_chunk(cfg, SEQ)
    seq = SEQ + (cfg.n_patches if cfg.family == "vlm" else 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, state = train_steps.init_train_state(
        cfg, CARD, torch.Generator(CARD).manual_seed(0))
    data = SyntheticLMDataset(DataConfig(global_batch=TRAIN_BATCH,
                                         seq_len=SEQ, vocab=cfg.vocab))
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=10,
                          total_steps=TRAIN_STEPS + 1)
    donate = train_steps.donate_update(
        cfg, torch.cuda.get_device_properties(0).total_memory)
    step = train_steps.make_train_step(cfg, opt_cfg, chunk, donate=donate)
    # the step's FLOPs counted from the program (launch/op_analysis.py, the
    # step on the meta device), the hand formula beside them
    counted, count_s = dryrun.count_cell(cfg, configs.ShapeSpec(
        f"train ({TRAIN_BATCH}, {seq})", seq, TRAIN_BATCH, "train"))
    flops = counted.flops
    formula_flops, formula = train_step_flops(cfg, params, TRAIN_BATCH, seq)
    skipped = remat_skipped_flops(cfg, TRAIN_BATCH, seq)
    expect = step_counts(cfg)
    print(f"training {cfg.name}{cut} at full width: {n_params} parameters, "
          f"{TRAIN_BATCH} x {seq} tokens a step, loss chunk {chunk}, "
          f"remat={cfg.remat}, "
          f"{'donated' if donate else 'functional'} update; "
          f"{flops / 1e12:.4f} TFLOP a step counted in {count_s:.1f} s "
          f"(aten {counted.aten_flops / 1e12:.4f} + kernels "
          f"{(flops - counted.aten_flops) / 1e12:.4f}: "
          f"{ {k: v['launches'] for k, v in counted.kernels.items()} })")
    print(f"  train_step_flops gives {formula_flops / 1e12:.4f} TFLOP = "
          f"{formula}; {(formula_flops - flops) / 1e12:.4f} TFLOP over the "
          f"count ({formula_flops / flops - 1:.2%})"
          + ("" if skipped is None else
             f", of it {skipped / 1e12:.4f} TFLOP the MLP down projection "
             f"(each block's last product) that remat does not recompute"))
    rows, launches = [], dict.fromkeys(expect, 0)
    step_launches = None
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    for i in range(TRAIN_STEPS + 1):
        batch = train_driver.step_batch(cfg, data, i, TRAIN_BATCH, SEQ, CARD)
        if i == 0:
            first = batch
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        check_counts(f"{arch}{cut} train step {i}", counts, expect)
        for key in launches:
            launches[key] += counts[key]
        if i == 1:                  # the first timed step's counts
            step_launches = {key: counts[key] for key in launches}
        row = {"step": i, "loss": m["loss"].item(),
               "grad_norm": m["grad_norm"].item(), "lr": m["lr"].item(),
               "s": dt}
        print(f"{arch}{cut} train step {i}{' (warm-up)' if i == 0 else ''}: "
              f"loss {row['loss']:.4f} grad_norm {row['grad_norm']:.4f} lr "
              f"{row['lr']:.3e} {dt:.3f} s")
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
            raise SystemExit(f"{arch} train step {i}: a loss or grad_norm "
                             f"that is not finite")
        rows.append(row)
        del batch
    peak = torch.cuda.max_memory_allocated()
    # allocations that found no free block until the allocator released
    # its cached memory (a synchronizing retry)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    step_s = float(np.median([r["s"] for r in rows[1:]]))
    out = {"arch": arch, "layers": cfg.n_layers, "batch": TRAIN_BATCH,
           "seq": seq, "loss_chunk": chunk, "params": n_params,
           "steps": rows, "step_s_median": step_s,
           "tokens_per_s": TRAIN_BATCH * seq / step_s,
           "flops_per_step": flops, "flops_source": "launch/op_analysis.py",
           "aten_flops_per_step": counted.aten_flops,
           "kernel_counts": counted.kernels,
           "flops_formula_value": formula_flops, "flops_formula": formula,
           "remat_skipped_flops": skipped,
           "peak_share": flops / (step_s * PEAK_FLOPS[torch.bfloat16]),
           "peak_share_formula": formula_flops / (
               step_s * PEAK_FLOPS[torch.bfloat16]),
           "peak_bytes": peak, "alloc_retries": retries,
           "launches": launches,
           "launches_per_step": step_launches, "donated": donate,
           "card": smi}
    print(f"{arch}{cut} full-width training: median step {step_s:.3f} s, "
          f"{out['tokens_per_s']:.0f} tokens/s, {flops / 1e12:.4f} TFLOP "
          f"counted / ({step_s:.3f} s x 989 TFLOP/s) = "
          f"{out['peak_share']:.2%} of the bf16 peak (the formula's: "
          f"{out['peak_share_formula']:.2%}); allocator peak "
          f"{peak / 1e9:.2f} GB, {retries} allocation retries in "
          f"{TRAIN_STEPS + 1} steps")
    if check_donation:
        out["donation"] = check_donated_update(
            opt_cfg, params, state, grads_of(cfg, params, first, chunk)[1])
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if plain_rows is not None:
        print(f"{arch}{cut}: the check against the plain versions on all "
              f"{TRAIN_BATCH} rows of step 0's batch, the plain steps over "
              f"slices of {plain_rows} rows")
    out["vs_plain"] = check_against_plain(cfg, params, first, chunk,
                                          plain_rows)
    out["vs_plain"].update(plain_rows=plain_rows or TRAIN_BATCH,
                           peak_bytes=torch.cuda.max_memory_allocated())
    print(f"{arch}{cut}: the steps against the plain versions took "
          f"{time.perf_counter() - t0:.1f} s, allocator peak "
          f"{out['vs_plain']['peak_bytes'] / 1e9:.2f} GB")
    del params, first
    torch.cuda.empty_cache()
    return out


def run_ft_demo(arch, demo, **over):
    """The reference's fault-tolerance demo (``examples/train_lm.py``)
    through ``launch/train.py`` on the card: ``demo``'s steps of ``arch``'s
    smoke config (fp32; ``over`` replaces its fields) under the
    TrainSupervisor, checkpoints in a temporary directory, a failure
    injected once; fails unless it restarted once and the mean of the last
    10 losses is below that of the first 10."""
    import shutil
    import tempfile
    cfg = dataclasses.replace(configs.get(arch).smoke_config(), **over)
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ft_demo_")
    try:
        _, report, seconds = train_driver.train(
            cfg, demo["steps"], demo["batch"], demo["seq"],
            AdamWConfig(lr=demo["lr"], warmup_steps=demo["warmup"],
                        total_steps=demo["steps"]),
            ckpt, demo["ckpt_every"], [demo["fail_at"]], CARD)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = [m["loss"] for _, m in report.history]
    head, tail = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    out = {"arch": arch, "steps": demo["steps"], "restarts": report.restarts,
           "checkpoints": report.checkpoints, "steps_run": len(losses),
           "loss_first10": head, "loss_last10": tail, "seconds": seconds}
    print(f"{arch} fault-tolerance demo: {len(losses)} steps run in "
          f"{seconds:.1f} s, restarts={report.restarts} "
          f"checkpoints={report.checkpoints}, loss {head:.3f} -> {tail:.3f}")
    if report.restarts != 1 or not tail < head:
        raise SystemExit(f"{arch} fault-tolerance demo: expected one restart "
                         f"and a falling loss")
    return out


def run_checkpoint_phase():
    """A full-width checkpoint, timed: qwen3-1.7b's train state (bf16
    weights from seed 0 and their fp32 AdamW moments) saved through
    ``checkpoint/store.py``'s CheckpointStore with a blocking save into a
    temporary directory (removed after), then restored; the bytes,
    save_s, restore_s and GB/s.  The restored state must equal the saved
    one bit for bit, and the train step from it the step from the live
    state (loss, grad_norm, lr, every new parameter and moment; both
    under ``torch.use_deterministic_algorithms``).  Fails
    first, with the bytes needed, where the disk lacks the room."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointStore
    cfg = configs.get(ARCH).config()
    torch.cuda.empty_cache()
    live = train_steps.init_train_state(
        cfg, CARD, torch.Generator(CARD).manual_seed(0))
    leaves = tree_flatten(live)[0]
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    root = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        print(f"checkpoint phase: {cfg.name}'s train state, {len(leaves)} "
              f"tensors, {nbytes} bytes; {free} bytes free under {root}")
        if free < nbytes * 1.05:
            raise SystemExit(f"checkpoint phase: {int(nbytes * 1.05)} bytes "
                             f"needed under {root}, {free} free")
        store = CheckpointStore(root, keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.save(0, live, blocking=True)
        save_s = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size
                      for f in pathlib.Path(root).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        step_no, restored = store.restore(live)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = sum(torch.equal(a, b) for a, b in zip(
        leaves, tree_flatten(restored)[0]))
    data = SyntheticLMDataset(DataConfig(global_batch=TRAIN_BATCH,
                                         seq_len=SEQ, vocab=cfg.vocab))
    batch = train_driver.step_batch(cfg, data, 0, TRAIN_BATCH, SEQ, CARD)
    step = train_steps.make_train_step(
        cfg, AdamWConfig(lr=TRAIN_LR, warmup_steps=10,
                         total_steps=TRAIN_STEPS + 1),
        train_driver.loss_chunk(cfg, SEQ))
    # the embedding's gradient (index_put with accumulate) is otherwise
    # summed in an order that varies from call to call
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        from_restored = step(*restored, batch)
        del restored
        from_live = step(*live, batch)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    got = tree_flatten(from_restored)[0]
    expect = tree_flatten(from_live)[0]
    differ = sum(not torch.equal(a, b) for a, b in zip(got, expect))
    out = {"arch": cfg.name, "tensors": len(leaves), "bytes": nbytes,
           "bytes_on_disk": on_disk, "save_s": save_s,
           "restore_s": restore_s, "save_gb_per_s": nbytes / save_s / 1e9,
           "restore_gb_per_s": nbytes / restore_s / 1e9,
           "restored_step": step_no, "restored_equal": same,
           "step_outputs": len(got), "step_outputs_differ": differ}
    print(f"checkpoint of {cfg.name} at full width: {nbytes} bytes "
          f"({on_disk} on disk), save {save_s:.3f} s "
          f"({out['save_gb_per_s']:.3f} GB/s), restore {restore_s:.3f} s "
          f"({out['restore_gb_per_s']:.3f} GB/s); restored tensors equal "
          f"to the saved {same} of {len(leaves)}; the step from the "
          f"restored state against the step from the live state: "
          f"{differ} of {len(got)} outputs differ (must be 0)")
    if step_no != 0 or same != len(leaves) or differ:
        raise SystemExit("the restored checkpoint differs from the live "
                         "state")
    del live, from_live, from_restored, batch
    torch.cuda.empty_cache()
    return out


def run_measured_cells(smi):
    """The dry run's measured record (``launch/dryrun.py`` measure_cell)
    of each MEASURED cell: warm-up and step times, memory stats, the
    device window, the counted fields at the reduced shape and the card's
    count against the meta count.  Fails unless the two counts agree op
    for op and the kernels launched as MEASURED says, in the count and on
    the card."""
    out = []
    for arch, shape, b, seq, expect in MEASURED:
        t0 = time.perf_counter()
        rec = dryrun.measure_cell(configs.get(arch).config(),
                                  configs.SHAPES[shape],
                                  dryrun.Reduced(b, seq))
        counted = {k: v["launches"] for k, v in rec["kernels"].items()}
        r = rec["roofline"]
        m = rec["memory_stats"]
        print(f"measured {arch} x {shape} at ({b}, {seq}), "
              f"{rec['reduced']['layers']} of "
              f"{rec['reduced']['cell_layers']} layers: warm-up "
              f"+{rec['warmup_s']:.3f} s, step {rec['step_s']:.4f} s "
              f"({rec['step_s_spread'][0]:.4f} to "
              f"{rec['step_s_spread'][1]:.4f}); counted "
              f"{rec['counted_flops_per_device']:.4e} FLOP "
              f"({rec['aten_flops_per_device']:.4e} aten), "
              f"{rec['counted_bytes_per_device']:.4e} B; terms "
              f"C={r['compute_s'] * 1e3:.3f} M={r['memory_s'] * 1e3:.3f} ms "
              f"-> {r['dominant']}; roofline share "
              f"{rec['roofline_share']:.3f}, peak share "
              f"{rec['peak_share']:.3f}, useful "
              f"{rec['useful_flops_ratio']:.3f}; memory at entry "
              f"{m['state_bytes_at_entry'] / 1e9:.2f} GB, peak "
              f"{m['peak_bytes'] / 1e9:.2f} GB, {m['alloc_retries']} "
              f"retries, {m['ooms']} OOMs; idle share "
              f"{rec['device']['idle_share']:.3f}; launches counted "
              f"{counted}, on the card {rec['launches']}; card count equal "
              f"{rec['card_count_equal']} ({time.perf_counter() - t0:.1f} s)")
        out.append(rec)
        torch.cuda.empty_cache()
        if not rec["card_count_equal"]:
            diff = rec["count_differs"]
            for key in list(diff)[:20]:
                print(f"  count differs at {key}: {diff[key]}")
            raise SystemExit(f"{arch} x {shape}: the card's count differs "
                             f"from the meta count at {len(diff)} entries")
        if counted != expect or rec["launches"] != expect:
            raise SystemExit(f"{arch} x {shape}: launches {counted} counted, "
                             f"{rec['launches']} on the card, expected "
                             f"{expect}")
    return out


def state_bytes_on_card(cfg):
    """The bytes the allocator holds for ``init_train_state``'s parameters
    and AdamW state of ``cfg`` on the card, the bytes of
    ``train_state_shapes``'s meta tensors, and their count."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params, state = train_steps.init_train_state(
        cfg, CARD, torch.Generator(CARD).manual_seed(0))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    del params, state
    torch.cuda.empty_cache()
    leaves = tree_flatten(train_steps.train_state_shapes(cfg))[0]
    return held, sum(x.numel() * x.element_size() for x in leaves), len(leaves)


def run_dryrun_phase(vlm_cfg, vlm_peak, smi):
    """The dry-run cell table on one card (``launch/dryrun.py --all --mesh
    1x1``: every cell's device bytes and fit); launch/mesh.py's memory
    constant against the card's; ``train_state_shapes``'s bytes against
    the allocator's bytes of the state ``init_train_state`` builds, for
    qwen3-1.7b and ``vlm_cfg`` (within ALLOC_ROUND bytes a tensor); the
    vlm's modeled device bytes at its train shape beside its step's
    measured allocator peak ``vlm_peak`` (a report: the activation model
    is the reference's).  Returns the phase's record."""
    t0 = time.perf_counter()
    records = dryrun.main(["--all", "--mesh", "1x1", "--no-count"])
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"card memory {total} bytes, launch/mesh.py's HBM_BYTES "
          f"{card_mesh.HBM_BYTES:.0f}")
    if not card_mesh.HBM_BYTES <= total <= 1.1 * card_mesh.HBM_BYTES:
        raise SystemExit("launch/mesh.py's HBM_BYTES is not this card's")
    out = {"cells": len(records), "total_memory": total,
           "fit": [f"{r['arch']} x {r['shape']}" for r in records
                   if r.get("fits_hbm")]}
    for cfg in (configs.get(ARCH).config(), vlm_cfg):
        held, modeled, n = state_bytes_on_card(cfg)
        label = f"{cfg.name} ({cfg.n_layers} layers)"
        print(f"{label} train state: the allocator holds {held} bytes, "
              f"train_state_shapes gives {modeled} in {n} tensors "
              f"(difference {held - modeled}, at most {ALLOC_ROUND * n})")
        if not 0 <= held - modeled <= ALLOC_ROUND * n:
            raise SystemExit(f"{label}: train_state_shapes disagrees with "
                             f"the allocator")
        out[cfg.name] = {"layers": cfg.n_layers, "allocated": held,
                         "modeled": modeled, "tensors": n}
    seq = SEQ + vlm_cfg.n_patches
    rec = dryrun.cell_record(vlm_cfg, configs.ShapeSpec(
        f"train ({TRAIN_BATCH}, {seq})", seq, TRAIN_BATCH, "train"),
        card_mesh.GRIDS["1x1"], count=False)
    print(f"{vlm_cfg.name} ({vlm_cfg.n_layers} layers) at ({TRAIN_BATCH}, "
          f"{seq}), modeled against measured: device_bytes "
          f"{rec['device_bytes'] / 1e9:.2f} GB (state "
          f"{rec['state_bytes_per_device'] / 1e9:.2f} + activations "
          f"{rec['activation_bytes_per_device'] / 1e9:.2f}), the step's "
          f"allocator peak {vlm_peak / 1e9:.2f} GB")
    out["vlm_train"] = {**rec, "peak_bytes": vlm_peak}
    out["table_seconds"] = time.perf_counter() - t0
    out["measured"] = run_measured_cells(smi)
    print(json.dumps({"measured": out["measured"]}))
    out["seconds"] = time.perf_counter() - t0
    print(f"dry-run phase: {out['seconds']:.1f} s (the table and the state "
          f"bytes {out['table_seconds']:.1f} s)")
    return out


def run_training_phase(smi):
    """The training slice: the backward kernels (and both flash kernels at
    qwen2-vl-72b's training call), the smoke configs' train step card vs
    CPU, full-width qwen3-1.7b, rwkv6-1.6b, recurrentgemma-9b
    (GEMMA_TRAIN_LAYERS of its layers) and qwen2-vl-72b (VLM_TRAIN_LAYERS),
    the dry-run phase, the fault-tolerance demo on qwen3's and rwkv6's
    smoke configs.  Returns the three backward kernels' records and the
    phase's record."""
    t0 = time.perf_counter()
    record, worst_l2 = check_flash_attention_bwd()
    vlm_kernels = check_vlm_attention()
    rwkv_bwd = check_rwkv6_scan_bwd()
    rglru_bwd = check_rglru_scan_bwd()
    print(f"backward kernel checks and timings: "
          f"{time.perf_counter() - t0:.1f} s")
    check_smoke_train_steps()
    out = run_training_path(ARCH, smi, check_donation=True)
    out["checkpoint"] = run_checkpoint_phase()
    out["moe"] = run_training_path(MOE_ARCH, smi)
    out["rwkv6"] = run_training_path(RWKV_ARCH, smi)
    out["recurrentgemma"] = run_training_path(GEMMA_ARCH, smi,
                                              layers=GEMMA_TRAIN_LAYERS)
    out["vlm"] = run_training_path(VLM_ARCH, smi, layers=VLM_TRAIN_LAYERS,
                                   plain_rows=VLM_CHECK_ROWS)
    out["vlm"]["kernels"] = dict(zip(("flash_attention",
                                      "flash_attention_bwd"), vlm_kernels))
    out["dryrun"] = run_dryrun_phase(
        dataclasses.replace(configs.get(VLM_ARCH).config(),
                            n_layers=VLM_TRAIN_LAYERS),
        out["vlm"]["peak_bytes"], smi)
    out["bwd_worst_rel_l2"] = worst_l2
    out["ft_demo"] = run_ft_demo(ARCH, FT_DEMO, n_layers=2, d_model=128,
                                 d_ff=256)
    out["ft_demo_rwkv6"] = run_ft_demo(RWKV_ARCH, RWKV_FT_DEMO)
    record["launches"] = out["launches"]["flash_attention_bwd"]
    record["launches_recurrentgemma"] = (
        out["recurrentgemma"]["launches"]["flash_attention_bwd"])
    record["vlm"] = {**vlm_kernels[1], "launches_train_step": (
        out["vlm"]["launches_per_step"]["flash_attention_bwd"])}
    rwkv_bwd["launches"] = out["rwkv6"]["launches"]["rwkv6_scan_bwd"]
    rglru_bwd["launches"] = (
        out["recurrentgemma"]["launches"]["rglru_scan_bwd"])
    out["seconds"] = time.perf_counter() - t0
    print(f"training phase: {out['seconds']:.1f} s")
    return (record, rwkv_bwd, rglru_bwd), out


def device_line():
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})


def kernel_times() -> int:
    """Build and time TIMED of the imported tree at this script's timing
    points."""
    t0 = time.perf_counter()
    _build.build(TIMED)
    print(f"built {', '.join(TIMED)} from {TREE} in "
          f"{time.perf_counter() - t0:.1f} s")
    times = {"flash_decode": time_decode_points(),
             "rwkv6_scan": time_rwkv6_points(),
             "rglru_scan": time_rglru_points(),
             "flash_attention_bwd": time_flash_attention_bwd_points(),
             "rwkv6_scan_bwd": time_rwkv6_bwd_points(),
             "rglru_scan_bwd": time_rglru_bwd_points()}
    print(json.dumps({"kernel_times": times, "tree": str(TREE)}))
    print(device_line())
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = dryrun.nvidia_smi()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--kernel-times" in sys.argv:
        return kernel_times()
    if "--spmd-cards" in sys.argv:
        return spmd_cards_only(smi)

    t0 = time.perf_counter()
    libs = _build.build(KERNELS + (EPILOGUE, DWCONV))
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "entry function" in line or "Used" in line or "spill" in line:
                print(f"  {name} ptxas: {line.strip()}")
    # the three latest redesigns and the scans' backwards must not spill,
    # nor flash_attention's head dim 96 instantiations
    for name in NO_SPILL:
        log = libs[name].with_suffix(".log").read_text()
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
        if not spills or max(spills) > 0:
            raise SystemExit(f"{name}: ptxas reports spills {spills}")
    d96_spills = {fn: n for fn, n in ptxas_spills(
        libs["flash_attention"].with_suffix(".log").read_text()).items()
        if D96_TAG in fn}
    print(f"flash_attention D 96 instantiations, spill bytes: "
          f"{sorted(d96_spills.values())}")
    if not d96_spills or max(d96_spills.values()) > 0:
        raise SystemExit(f"flash_attention D 96 spills: {d96_spills}")
    # the tensor-core kernels: every bf16 flash_attention, backward and
    # flash_decode and every matmul_qi8 instantiation holds mma.sync
    tensor_ops = {}
    for name, op, kernel in (("flash_attention", "HMMA", "bf16_kernel"),
                             ("flash_attention_bwd", "HMMA", "mma_kernel"),
                             ("flash_decode", "HMMA", "bf16_kernel"),
                             ("matmul_qi8", "IMMA", "matmul_qi8_kernel")):
        counts = tensor_core_ops(libs[name], op, kernel)
        print(f"{name} SASS: {op} per {kernel} instantiation "
              f"{sorted(counts.values())}")
        if not counts or min(counts.values()) == 0:
            raise SystemExit(f"{name}: a {kernel} without {op} (or none "
                             f"found): {counts}")
        tensor_ops[name] = {"op": op, "instantiations": len(counts),
                            "count": sum(counts.values())}
        if op == "HMMA":                # the head dim 96 instantiations
            d96 = [n for fn, n in counts.items() if D96_TAG in fn]
            # flash_attention's with and without the lse epilogue; the
            # backward's D, dK/dV and dQ kernels
            want = BF16_KERNELS[name]
            print(f"{name} SASS: {op} in the D 96 bf16 instantiations {d96}")
            if len(d96) != want or min(d96) == 0:
                raise SystemExit(f"{name}: not {want} D 96 bf16 kernels "
                                 f"with {op}: {d96}")
            tensor_ops[name]["d96"] = d96[0]
        if name == "flash_attention_bwd":   # no longer on CUDA cores
            d256 = [n for fn, n in counts.items() if D256_TAG in fn]
            print(f"{name} SASS: {op} in the D 256 bf16 instantiations "
                  f"{d256}")
            if len(d256) != BF16_KERNELS[name] or min(d256) == 0:
                raise SystemExit(f"{name}: not {BF16_KERNELS[name]} D 256 "
                                 f"bf16 kernels with {op}: {d256}")
            tensor_ops[name]["d256"] = d256

    t0 = time.perf_counter()
    record = check_flash_attention()
    record["windowed"] = check_windowed_flash_attention()
    decode_record = check_flash_decode()
    print(f"flash kernel checks and timings (D 96 included): "
          f"{time.perf_counter() - t0:.1f} s")
    rwkv_record = check_rwkv6_scan()
    rglru_record = check_rglru_scan()
    qi8_record = check_matmul_qi8()
    bn_record = check_bn_epilogue()
    bn_record["launches_resnet50"] = resnet50_epilogue_launches()
    dw_record = check_dwconv(libs[DWCONV].with_suffix(".log").read_text())
    dw_record["launches_mobilenetv2"] = mobilenetv2_dwconv_launches()
    torch.cuda.empty_cache()
    # max_len 300 puts qwen3's cache over two flash_decode splits
    check_family_on_card(ARCH, seq=200, prompt_len=40, n_new=8, max_len=300,
                         token_by_token=True)
    check_family_on_card(RWKV_ARCH, seq=200, prompt_len=40, n_new=8,
                         max_len=48, token_by_token=False)
    # max_len 24 over the smoke window 16: the ring cache wraps
    check_family_on_card(GEMMA_ARCH, seq=16, prompt_len=8, n_new=16,
                         max_len=24, token_by_token=True)
    t0 = time.perf_counter()
    for arch in FAMILY_SMOKE:
        # phi3-mini's smoke config at its own head dim 96
        over = {"head_dim": 96} if arch == D96_ARCH else {}
        check_family_on_card(arch, seq=200, prompt_len=40, n_new=8,
                             max_len=300, token_by_token=True, **over)
    print(f"the LM families' smoke configs card vs CPU: "
          f"{time.perf_counter() - t0:.1f} s")

    res, launches = run_prefill_path(ARCH)
    record["launches"] = launches
    cfg, busy = res["cfg"], res["snapshot"]["stage_busy_s"]
    # the fault-tolerant prefill phase hedges after a few bottleneck-stage
    # times of this stream
    ft_hedge_ms = FT_HEDGE_X * max(busy) / len(res["outs"]) * 1e3
    direct_ms = direct_forward_ms(cfg, res["params"], res["requests"][0])
    print(f"direct forward of one {SEQ}-token request: {direct_ms:.3f} ms; "
          f"{cfg.n_layers} flash_attention calls at {record['ms']:.4f} ms = "
          f"{cfg.n_layers * record['ms'] / direct_ms:.1%} of it")
    del res

    decode_record["launches"] = run_decode_path(ARCH)[0]
    torch.cuda.empty_cache()
    # the LM-families slice: MoE and head dim 96 served at full width
    for arch in (MOE_ARCH, D96_ARCH):
        t0 = time.perf_counter()
        res, launches = run_prefill_path(arch)
        del res
        torch.cuda.empty_cache()
        record[f"launches_{arch}"] = launches
        fd_n, fa_n = run_decode_path(arch)
        decode_record[f"launches_{arch}"] = fd_n
        record[f"launches_{arch}_decode_prefills"] = fa_n
        torch.cuda.empty_cache()
        print(f"{arch} served phases: {time.perf_counter() - t0:.1f} s")
    rwkv_record["launches"] = run_rwkv6_path()
    torch.cuda.empty_cache()
    fwd_counts, dec_counts = run_gemma_path()
    rglru_record["launches"] = (fwd_counts["rglru_scan"]
                                + dec_counts["rglru_scan"])
    # the flash kernels' launches on recurrentgemma's paths, beside the
    # qwen3 paths' counts above
    record["launches_recurrentgemma"] = fwd_counts["flash_attention"]
    decode_record["launches_recurrentgemma"] = dec_counts["flash_decode"]
    torch.cuda.empty_cache()
    # the rest of the LM families at full width through the model API
    for arch, layers in API_RUNS:
        t0 = time.perf_counter()
        fa_n, fd_n = run_api_model(arch, layers)
        record[f"launches_{arch}"] = fa_n
        decode_record[f"launches_{arch}"] = fd_n
        torch.cuda.empty_cache()
        print(f"{arch} model-API phase: {time.perf_counter() - t0:.1f} s")
    # the encoder-decoder slice: whisper-tiny's kernel shapes, its smoke
    # config card vs CPU, and its full-width path through the model API
    t0 = time.perf_counter()
    record["whisper"], decode_record["whisper"] = check_whisper_kernels()
    check_family_on_card(WHISPER_ARCH, seq=40, prompt_len=8, n_new=16,
                         max_len=24, token_by_token=True)
    fa_fwd, fa_enc, fd_n = run_whisper_path()
    record[f"launches_{WHISPER_ARCH}"] = fa_fwd
    record[f"launches_{WHISPER_ARCH}_encode"] = fa_enc
    decode_record[f"launches_{WHISPER_ARCH}"] = fd_n
    torch.cuda.empty_cache()
    print(f"{WHISPER_ARCH} phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reporter = run_reporter_phase()
    torch.cuda.empty_cache()
    print(f"segment memory reporter phase: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"reporter": reporter}))
    print(json.dumps({"spmd": run_spmd_phase(record, smi)}))
    print(json.dumps({"spmd_cards": run_spmd_cards_phase(smi)}, default=str))
    bwd_records, training = run_training_phase(smi)
    record["launches_train_step"] = (
        training["launches_per_step"]["flash_attention"])
    rwkv_record["launches_train_step"] = (
        training["rwkv6"]["launches_per_step"]["rwkv6_scan"])
    rglru_record["launches_train_step"] = (
        training["recurrentgemma"]["launches_per_step"]["rglru_scan"])
    record["vlm"] = {**training["vlm"]["kernels"]["flash_attention"],
                     "launches_train_step": (
                         training["vlm"]["launches_per_step"]
                         ["flash_attention"])}
    print(json.dumps({"training": training}))

    zoo_worst = check_cnn_zoo()
    cnn_res, ctx = run_cnn_path()
    qi8_record["launches"] = run_int8_head()
    print(json.dumps({"cnn": {"zoo_worst_rel_err": zoo_worst, **cnn_res}}))

    # the fault-tolerance, self-healing and fleet tiers
    dev = torch.device("cuda")
    m, params = ctx["model"], ctx["params"]
    busy = cnn_res["plans"]["analytic"]["served"][0]["stage_busy_s"]
    ft = {"chaos": run_chaos_phase(m, params, ctx["reqs"], dev,
                                   FT_HEDGE_X * max(busy) / CNN_REQUESTS)}
    ft["prefill"] = run_ft_prefill(ARCH, ft_hedge_ms)
    record["launches_ft_prefill"] = ft["prefill"]["flash_attention"]
    torch.cuda.empty_cache()
    ft["self_heal"] = run_selfheal_phase(m, params, ctx["trace"], dev)
    members = []
    for name, model_name, share, slo in FLEET:
        fm = m if model_name == CNN else cnn.REAL_CNNS[model_name]()
        fp = (params if fm is m
              else fm.init(dev, torch.Generator(dev).manual_seed(0)))
        members.append((name, f"cnn:{model_name}", fm, fp, share, slo))
    ft["fleet"] = run_fleet_phase(members, dev)
    print(json.dumps({"ft": ft}, default=str))

    bwd_record, rwkv_bwd_record, rglru_bwd_record = bwd_records
    kernels = [record, bwd_record, decode_record, rwkv_record,
               rwkv_bwd_record, rglru_record, rglru_bwd_record, qi8_record,
               bn_record, dw_record]
    for rec in kernels:
        rec["design"] = DESIGNS[rec["name"]]
        if rec["name"] in tensor_ops:
            rec["sass"] = tensor_ops[rec["name"]]
    print(json.dumps({"kernels": kernels}))
    print(device_line())
    return 0


def direct_forward_ms(cfg, params, tokens, reps=5):
    """Host-clock time of one whole-model forward ending in a device
    synchronize (the single-request latency floor of the pipeline)."""
    lm.forward(cfg, params, {"tokens": tokens}, last_token_only=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        lm.forward(cfg, params, {"tokens": tokens}, last_token_only=True)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


if __name__ == "__main__":
    sys.exit(main())

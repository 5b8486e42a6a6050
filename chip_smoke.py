#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero (there
is no CPU fall-back, and without CUDA it stops before printing a result):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel under ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
2b. the planner (host only): probe a scrambled 8-node Clos datacenter,
   compile the training mix of full-width ``qwen2-0.5b`` (988,065,536
   gradient bytes) with the port's ``PlanCompiler`` and print the plan;
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it, and time both: the WKV chunk kernel at the
   rwkv6-1.6b layer shape in bf16 and f32 (y, the final state, a second
   launch for the same bits); ``fused_add`` at 64, 100, 1024 and 2^20+3 elements, at the
   training run's largest reduce and its largest bucket payload, in f32
   and bf16, out of place and in place (bit-equal), and on views at
   element offsets 0-7 of a, b and out (the same and different, below one
   tile and across many), beside ``torch.add``
   (both timed by CUDA-graph replay: device time without the host's); the
   flash-attention kernels on the seven ``FLASH_CASES`` shapes of
   ``tests/test_kernels.py`` and on ragged tails, head width 256 and a
   window in f32 and bf16, and at head widths 64 and 128 (``flash_fwd_wgmma``
   in bf16) on S below a tile, ragged S, GQA 16, a window, no mask and the
   model's transposed q/k/v views, each launch counted by kernel and run
   twice for the same bits; then on one glm4-9b layer at the serving shape
   (8 x 32 heads / 2 kv heads x 2048 x 128, causal) in bf16 and f32 and one
   qwen2-0.5b layer (8 x 14 / 2 x 2048 x 64) in bf16, timed beside
   ``F.scaled_dot_product_attention`` (the library yardstick, never on the
   path; ``time_flash_layer``, as at every model's layer shape below); the
   peer-memory ring
   reduce-scatter at n = 2, 3, 4, 8 (odd chunk lengths, several ring
   orders, the plan's among them) and at every bucket shape of the planned
   training path, bit for bit against its plain version and against
   ``ring_reduce_scatter`` (gather + ``fused_add``) in f32 and bf16, f32
   also against ``ring_reduce_scatter_ref``, chunks below and ragged
   against a tile, the bf16 scalar path, 20 launches of mixed L in a row,
   a captured launch replayed on fresh data, its status word read after
   every synchronise, its FIFO's bytes and schedule printed; timed at
   the largest bucket and at 4 MB a rank beside ``x.sum(0)``; the exact
   WKV scan kernel (``wkv_scan``) on the five ``WKV_CASES`` shapes of
   ``tests/test_kernels.py`` and the rwkv6-1.6b layer shape, in f32 and
   bf16, against its plain version, called twice from a zero state, timed
   by CUDA-graph replay;
3b. the group phase: the planned all-reduce (a certified ring at the
   plan's order) over 8 processes on the one card, spawned after the
   kernels are built, in a gloo group over a file store, on the plan's
   group-backed mesh: each process one schedule position (its mesh slot),
   its row run by ``run_schedule_group`` (every payload
   staged through pinned host memory, every reduce one ``fused_add``
   launch, counted against the schedule's reduces at that position) at
   4 MiB a rank and at the largest bucket, in bf16 and f32; the rows
   gathered at rank 0 bit for bit against ``run_schedule`` on the card
   with plain ``+`` (so a wrong ``fused_add`` at these piece sizes shows);
   two more calls a job timed (wall ms, the staging copies' share);
   before the spawn, the pipeline on the virtual mesh (``pipeline_virtual``):
   full-width ``qwen2-0.5b``'s 24 blocks as 8 stages of 3 over 8
   microbatches of 2 x 1024 tokens, a bf16 forward with
   ``attention_impl="flash"`` counted (192 ``flash_fwd_wgmma`` launches)
   and held to the blocks in sequence (``PIPE_BF16_BOUND``, with a
   control), then ``pipeline_loss`` forward and backward in f32 on the
   plain attention path, the gradients held to the sequential chain's
   (``PIPE_GRAD_BOUND``, with a control); in the same spawn, after the
   all-reduce jobs, that f32 step over the 8 processes (stage i in the
   process of slot i), every stage's gradient, the output and the loss
   bit for bit against the virtual run's, its wall time a step beside
   the bubble share 7/15; and one ``dbrx-132b`` MoE layer at published
   widths armed over the group (``arm_ep`` on the group-backed mesh of a
   ``serve_mix(moe=True)`` plan, 2 experts and 1024 tokens a process), its
   rows and aux loss bit for bit against ``moe_a2a`` on the virtual mesh,
   its drops and wall time beside the virtual layer's;
3c. gradient compression: ``compressed_psum`` on each of the training
   path's buckets over 8 virtual ranks, counted (``fused_add`` a reduce),
   bit for bit against plain ``+`` and within the f32 rounding of the
   dequantized rows' sum (one scale over the ranks as the control), and
   error feedback over 50 steps at the largest bucket's width;
3d. the solver's batched evaluator: a 1024-node datacenter's ring cost
   matrix and a [256, 1024] batch of permutations on the card against
   numpy's f64 costs, timed beside numpy; ``solve_sa(backend="jax")``
   against ``backend="numpy"`` on one seed and budget, each engine;
4. small-input checks: the smoke ``rwkv6`` in f32 (kernel-path prefill
   and decode against the exact recurrence, greedy tokens equal); the
   smoke ``glm4-9b`` in f32 (the flash prefill against the plain one,
   greedy tokens equal); the
   virtual-mesh schedules (ring, halving-doubling and double-binary-tree
   all-reduce and the ring reduce-scatter over 8 ranks in a reordered
   ring: postconditions, kernel path == ``+`` path and ``run_overlapped``
   == ``run_schedule`` bit for bit); the smoke ``qwen2-0.5b`` in f32,
   whose overlapped 8-rank step (bucketed and fused, and the planned step
   through ``reducer_from_plan(..., transport="peer_ring")``) matches the
   one-card baseline step;
5. the serving path: full-width ``rwkv6-1.6b`` (bf16,
   ``wkv_impl="kernel"``, random weights from ``--seed``) serves 8
   requests of 512-token prompts and 32 new tokens through
   ``GenerationEngine.generate``; launch counts zeroed just before, read
   just after; a spy around the model's ``wkv_chunked_op`` calls through
   and also runs ``ops.wkv_op`` (the scan kernel) on each layer's WKV
   inputs in that run, held to the chunk kernel's y; then prefill time,
   decode rate, peak memory and a ``torch.profiler`` window (without the
   spy) with the chunk kernel's share of the prefill; then full-width ``glm4-9b`` (bf16,
   ``attention_impl="flash"``) serves 8 requests of 2048-token prompts
   and 32 new tokens after a warm-up wave, counted (40 flash launches, one
   a layer of the prefill, every one ``flash_fwd_wgmma``), timed and
   profiled the same way; then the same wave armed
   (``GenerationEngine.arm_overlap``) with the all-gather of a simulated
   plan of the serving mix (1e6 bytes) over an 8-rank virtual mesh,
   counted (the same tokens, 40 ``flash_fwd_wgmma`` launches, the
   gather's postcondition checked), its prefill and decode step timed
   beside the unarmed ones;
6. the training path: full-width ``qwen2-0.5b`` (bf16, random weights
   from ``--seed``) over 8 virtual data-parallel ranks of 2 x 1024
   tokens each, its gradients reduced by a certified ring all-reduce in
   the rank order [3,1,4,7,5,0,2,6] (chunk factor 2, bucketed, every
   reduce through ``fused_add``): the reducer's output on step 0's grads
   against a plain f32 mean and against the ``+`` path, then a warm-up
   step and 3 timed steps with launch counts zeroed just before and read
   just after, and a ``torch.profiler`` window over one more step;
7. the planned training path: the same model and data through
   ``reducer_from_plan(plan, 988065536, transport="peer_ring")``: the
   plan's bucket size (12 buckets), a certified ring at the plan's rank
   order, every bucket one launch of the peer-memory ring kernel; the
   reducer on step 0's grads against an f32 mean, then a warm-up step and
   3 steps, counted (one ``peer_ring`` launch a bucket a step), timed and
   profiled;
8. the user's entry point: ``python -m repro_torch train`` in process
   (``repro_torch.cli.main``) at published widths cut to
   ``TRAIN_CLI_DEPTH`` (12) of its 24 blocks — ``qwen2-0.5b``, an 8-rank
   mesh planned through a ``Session`` on a scrambled simulated fabric,
   16 x 1024 tokens a step, 12 steps (the reference's 10-step warm-up of
   the learning rate, so the loss is seen to fall), the peer-memory ring a
   bucket, a
   checkpoint of the last step in a temporary directory (deleted after):
   the plan, the steps' times and losses, the exact ``peer_ring`` launch
   count, the reducer's CUDA-event time, peak memory and the checkpoint's
   bytes and seconds;
9. hybrid serving: full-width ``recurrentgemma-9b`` (bf16,
   ``attention_impl="flash"``) serves 4 requests of 4096-token prompts
   (past its 2048-token window) and 32 new tokens, counted (12
   ``flash_fwd_mma`` launches, one an attention layer of the prefill);
   then the same wave with ``"xla"`` on the same weights, its tokens
   compared and every flash-wave token held, teacher forced, within
   ``TOKEN_MARGIN`` of the xla model's top logit, and the two prefills'
   logits within ``LOGIT_BOUND``; a control wave, the flash model with
   half the window (``CONTROL_WINDOW``), must land outside both limits;
   prefill, decode step, peak memory and a profiled prefill; then the
   flash kernel at the layer's shape ``[4, 16/1, 4096, 256]`` in the
   window, against its plain version and timed beside it and SDPA with
   the window as a mask;
10. Whisper serving: full-width ``whisper-small`` on the reference's
    1500-frame stub, 8 x 64-token prompts x 32 new, the same way (24
    ``flash_fwd_wgmma`` launches: 12 unmasked encoder layers, 12 causal
    decoder ones), its tokens equal to the xla wave's; the encoder layer
    ``[8, 12/12, 1500, 64]`` and the decoder layer ``[8, 12/12, 64, 64]``
    (causal) as the hybrid's;
11. the VLM front end: one full-width ``llava-next-mistral-7b`` prefill of
    2 x 2048 tokens whose first 576 slots are the image stub (32
    ``flash_fwd_wgmma`` launches), its logits against the text-only
    prefill's, against the xla prefill's (within ``LOGIT_BOUND``) and
    against a control prefill with a window of half the prompt (outside
    it); the layer ``[2, 32/8, 2048, 128]`` (causal) as the hybrid's;
12. training the ssm family: first the gradient at full width
    (``rwkv6-1.6b`` in f32, 2 x 16 tokens): for every parameter tensor,
    the loss's central difference along that tensor's gradient against
    the gradient's own prediction (``GRAD_RTOL``); then the user's entry
    point, ``python -m repro_torch train --arch rwkv6-1.6b`` cut to
    ``SSM_TRAIN_DEPTH`` (8) of its 24 blocks over the planned 8-rank mesh
    (64 x 16 tokens a rank, 14 steps), checked and
    measured as phase 8: an entry-point smoke at a short sequence, not a
    measure of training throughput.

13. MoE with MLA: ``deepseek-v2-236b`` at published widths cut to 4
    layers (the dense head layer and 3 MoE layers of 160 experts top-6),
    bf16, 4 x 2048-token prompts x 32 new through the engine (no kernel on
    MLA's path); each MoE layer's capacity drops at 1.25; every MLA
    layer's absorbed decode held to the naive one (``MLA_DECODE_BOUND``)
    and ``moe_dense`` to ``moe_scatter`` at the capacity factor E/K
    (``MOE_REL_BOUND``), each against a control;
14. ``dbrx-132b`` cut to 4 layers, served as phase 9 (4
    ``flash_fwd_wgmma`` launches a prefill at GQA 48/8, the ``xla`` wave,
    margin and logits against a control whose prefill sees a 1024
    window);
15. the EP all-to-all armed from a plan (``serve_mix(moe=True)``) on one
    dbrx layer over an 8-slot virtual mesh: the shift order, the three
    certified schedule runs and their postconditions, the obs records,
    ``moe_a2a`` against ``moe_dense`` with a control, drops and times at
    1.25; then the flash kernel at dbrx's layer ``[4, 48/8, 2048, 128]``.

16. ``python -m repro_torch bench --scenario overlap`` at full width: the
    scenario's ``run`` (``repro_torch.bench.overlap_step``) with
    ``qwen2-0.5b`` at published widths in f32 over 8 virtual ranks of one
    16-token row, the modeled section (the planned ring on the scrambled
    8-node fabric, the 1.15x gate) and the three overlap modes beside the
    baseline step, comm-only and compute-only (``BENCH_REPS`` timed calls
    each, the reference's 5 cut to 3), each mode's loss held to the
    baseline's at ``rtol=2e-5``, the postcondition, ``peer_ring`` counted
    at one launch a bucket a reducer call; then ``bucketed`` over the
    runner transport, one ``fused_add`` a reduce step a bucket, counted;
17. the host commands through ``repro_torch.cli.main`` on a machine with
    no JAX: ``bench`` (plan, faults, obs), ``analyze`` (sweep, ``--equiv``,
    ``--plan``, ``--lint`` over this checkout), ``status``, ``trace
    export`` and ``trace replay`` (the three that plan a session's fabric
    at 16 nodes), each required to exit 0, each timed.

18. tensor parallelism and ZeRO-1 through the user's entry point:
    ``python -m repro_torch train --arch qwen2-0.5b --mesh 4x2 --reorder
    simulate`` at published widths (24 blocks, vocab 151936, bf16, the
    command's default 8 x 64 tokens) for 2 steps, then ``--mesh 8``, the
    losses held to each other at every step (``TP_BF16_RTOL``); both at
    depth 2 in f32 for one step (``TP_F32_RTOL``); ``--mesh 2x4`` (14
    heads on a model axis of 4: attention whole, MLP and vocabulary
    sharded) at depth 4 for 2 steps against ``--mesh 8`` at depth 4.
    Every run counted: ``fused_add`` a reduce step of each model-axis
    all-reduce (the reckoning of ``_tp_reckon``: forward, backward, the
    checkpoint's recompute and the clip), ``peer_ring`` a bucket a step
    over the data axis; the report's collectives per step held to the
    same reckoning.  Then one step built as the command builds it, timed
    with CUDA events, every model-axis collective timed with CUDA events
    in a ``torch.profiler`` window: their count, ms a step and share.

19. MoE training: (a) ``python -m repro_torch train --arch dbrx-132b
    --mesh 4 --reorder simulate`` in process at published widths cut to 1
    block (bf16, the command's default 8 x 64 tokens, the published
    capacity factor 1.25, 3 steps), after the memory reckoning and the
    host's free disk and memory against the checkpoint: the losses finite,
    the plan's all-to-all order armed, the capacity drops, ``peer_ring``
    launches equal to buckets x steps over the replicated leaves only, 2
    all-to-all records a MoE layer a forward, peak memory beside the
    reckoning, the steps on the host clock, the checkpoint deleted after;
    (b) the step-0 loss of the EP path under ``no_grad`` against the dense
    per-rank path at the capacity factor E/K (``TP_BF16_RTOL``, top-(K-1)
    routing the control); (c) one dbrx MoE layer on a 4x2 mesh, its experts
    gathered over the model axis, against the layer on (4,) at E/K on 8 x
    256 tokens, forward and backward (``MOE_TP_BOUND``; the control drops
    one model rank's share of the reduce-scatters), ``fused_add`` counted
    against the reduce-scatters' and router all-reduces' reduce steps; (d)
    deepseek-v2's MoE layer (160 experts top-6, 2 shared) over 8 EP ranks
    at E/K, its gradients against the sum of ``moe_scatter``'s over the
    ranks' shards (``MOE_MLA_BOUND``; the control leaves one shard out);
    (e), in the group phase (3b), the EP layer's backward over the 8
    processes, each process's input, router and expert gradients held to
    the virtual mesh's (``EP_GROUP_GRAD_BOUND``; the controls: the next
    rank's gradients, a router sum missing one process).
20. MoE training where the data axis does not divide the experts, and a
    wrapped session: (a) ``train --arch dbrx-132b --smoke --mesh 8`` (4
    smoke experts: EP cannot arm, the data-parallel step on
    ``moe_dense``), each step's loss printed, ``peer_ring`` launches held
    to buckets x steps over every leaf, no ``fused_add`` launch and no
    all-to-all record; then the published dbrx-132b cut to one block on
    ``--mesh 3``, whose memory the command reckons first: where the
    reckoning fits the card it runs ``MOE_DP_STEPS`` steps (peak memory
    beside the reckoning), else it refuses, and the phase holds the
    outcome to the reckoning; the same command with
    ``MOE_DP_MID_EXPERTS`` experts, which fits, holds the reckoning where
    the step runs: its peak lies between the state (weights, moments, the
    ranks' gradient buffers) and the reckoned total plus
    ``MOE_DP_ACT_BYTES`` of activations; (c) one published dbrx MoE layer
    on 3 data ranks of 3 x 256 tokens, ``moe_dense_ranks`` forward and
    backward against ``moe_dense`` on the global batch: outputs, the
    input's and the summed ranks' gradients within ``MOE_DP_LAYER_BOUND``
    of their largest entry, the aux within ``MOE_DP_AUX_BOUND`` (the
    controls, which must fail: the mean of the ranks' own aux terms, the
    gradients with one rank left out); (b) inside ``Session.wrap()`` of a session
    planned with ``moe=True`` for 4 ranks, ``arm_ep`` with no plan arms the
    plan's all-to-all order (its entry's ``local_perm``), and one
    full-width dbrx MoE layer on 8 x 256 tokens armed so is bit for bit
    the layer armed with ``plan=``; inside the wrap of a session planned at
    ``(16, 16)``, ``make_production_mesh()`` is the plan's order and
    allocates nothing on the card.

21. the dry run (``repro_torch.launch.dryrun``): (a) ``run_cell`` of
    ``qwen2-0.5b`` and ``dbrx-132b`` x ``train_4k`` on the production mesh
    ``(16, 16)`` at the depths of ``DRY_CELLS`` (all on ``meta``: the card's
    allocated bytes unchanged), each record's roofline,
    ``live_bytes_per_device`` and ``trace_s`` printed; (b) the anchor:
    full-width ``qwen2-0.5b`` (24 blocks) on a one-rank mesh at
    ``ANCHOR_BATCH`` x ``ANCHOR_SEQ``, ``ANCHOR_STEPS`` train steps with
    attention ``xla`` (the first under the counters), then one prefill
    with ``flash`` (``flash_fwd_wgmma<64>``): FlopCounterMode over the
    card's run plus the kernels' ``work()`` at their launches equals the
    dry run's meta count of the same cell exactly;
    ``torch.cuda.max_memory_allocated()`` of the counted step lies within
    ``MEM_BAND`` of the reckoned ``live_bytes_per_device``, and the
    reckoning without the temporaries (the control) outside it; the
    steady step's time over the roofline's ``bound_s`` is printed; (c) the
    train step on ``--mesh 8`` (the data-parallel step, ``peer_ring`` a
    bucket) at ``ANCHOR_MESH_DEPTH`` blocks: the tracker's total peak over
    the 8 virtual ranks (arguments plus the step's storage, undivided)
    within ``MEM_BAND`` of the card's measured peak, the FLOPs equal.

Phase 4 also holds the smoke ``recurrentgemma-9b`` (a group and a tail,
at P > W and P == W) and ``whisper-small`` in f32 on the card: flash
prefill == xla prefill, greedy tokens equal.

Its last lines are a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi``
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
#: outside the tensor cores (the WKV scan's arithmetic), dense TF32 tensor-
#: core FLOP/s (the WKV chunk kernel's products, in three TF32 passes) and
#: dense bf16 tensor-core FLOP/s (the flash kernel's products)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12

BATCH, PROMPT, NEW = 8, 512, 32
# the training path: 8 virtual ranks x 2 rows x 1024 tokens, a certified
# ring in this rank order (tests/test_overlap.py:300-301)
TRAIN_ARCH, RANKS, ROWS_PER_RANK, SEQ, TRAIN_STEPS = "qwen2-0.5b", 8, 2, 1024, 3
TRAIN_PERM = [3, 1, 4, 7, 5, 0, 2, 6]
MESH_PERM = [0, 3, 1, 7, 2, 6, 4, 5]      # tests/test_system.py:134-141
LR = 1e-3
# the planned path: an 8-node Clos datacenter, scrambled, probed, and the
# training mix of qwen2-0.5b's bf16 gradients (494,032,768 parameters)
PLAN_FABRIC = dict(nodes_per_rack=4, racks_per_agg=2, seed=0)
PLAN_SCRAMBLE_SEED, PLAN_PROBE_SEED, PLAN_PAYLOAD = 1, 0, 988_065_536
# the dense serving path: glm4-9b, 8 requests x 2048-token prompts x 32 new
DENSE_ARCH, DENSE_BATCH, DENSE_PROMPT, DENSE_NEW = "glm4-9b", 8, 2048, 32
# the hybrid serving path: recurrentgemma-9b, 4 requests x 4096-token prompts
# (past its 2048-token window, so the ring roll and the window mask run) x 32
HYBRID_ARCH, HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW = "recurrentgemma-9b", 4, 4096, 32
# Whisper serving: whisper-small, 8 requests x 64-token prompts x 32 new on the
# reference's front-end stub (ones of [batch, 1500 frames, d_model])
WHISPER_ARCH, WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW = "whisper-small", 8, 64, 32
# the VLM front end: llava-next-mistral-7b, 2 x 2048-token prompts whose first
# 576 slots hold the image embeddings (the reference's stub: ones)
VLM_ARCH, VLM_BATCH, VLM_PROMPT = "llava-next-mistral-7b", 2, 2048
# the group phase: 8 processes on the one card in a gloo group, the planned
# all-reduce at 4 MiB a rank and at the largest bucket, 2 timed calls each
GROUP_RANK_BYTES, GROUP_TIMED_CALLS, GROUP_TIMEOUT_S = 4 * 1024 * 1024, 2, 480
# tests/test_kernels.py:21-29: (B, H, KV, S, hd, block_q, block_k, causal, window)
FLASH_CASES = [
    (2, 4, 2, 64, 16, 16, 16, True, 0),
    (1, 8, 8, 128, 32, 32, 64, True, 0),
    (2, 4, 1, 64, 16, 32, 16, False, 0),
    (1, 4, 2, 128, 16, 32, 32, True, 32),
    (1, 2, 2, 64, 16, 64, 64, True, 0),
    (1, 2, 2, 64, 16, 16, 16, True, 0),
    (2, 6, 3, 96, 8, 32, 32, True, 0),
]
# beyond them: ragged tails (S not a multiple of the kernel's tiles), head
# width 256 with a window (recurrentgemma's local attention), GQA 16; at
# head widths 64 and 128 (flash_fwd_wgmma in bf16): S below a 128-row
# tile, S = 130 and 200, GQA 16, a window of 70, no mask
FLASH_EXTRA = [
    (1, 4, 2, 130, 64, 130, 130, True, 0),
    (2, 2, 1, 17, 8, 17, 17, True, 0),
    (1, 4, 2, 256, 256, 128, 128, True, 100),
    (1, 4, 1, 200, 32, 8, 8, False, 70),
    (1, 32, 2, 256, 128, 128, 128, True, 0),
    (1, 2, 1, 64, 64, 64, 64, True, 0),
    (1, 2, 1, 64, 128, 64, 64, True, 0),
    (1, 4, 2, 130, 128, 130, 130, True, 0),
    (2, 2, 1, 200, 64, 200, 200, True, 0),
    (2, 2, 1, 200, 128, 200, 200, True, 0),
    (1, 32, 2, 256, 64, 128, 128, True, 0),
    (1, 4, 2, 256, 64, 128, 128, True, 70),
    (1, 4, 2, 256, 128, 128, 128, True, 70),
    (2, 4, 2, 256, 64, 128, 128, False, 0),
    (2, 4, 2, 256, 128, 128, 128, False, 0),
]
# the model's q/k/v: transposed views of [B, S, heads, hd] (models/layers.py
# _qkv), at both wgmma head widths
FLASH_VIEWS = [(2, 8, 2, 192, 64, 64, 64, True, 0),
               (2, 8, 2, 192, 128, 64, 64, True, 0)]
# flash kernel vs its plain version: f32 is the same math summed in another
# order (the reference's f32 tolerance); bf16 also rounds each probability
# to bf16 for the P.V product and the output once (about two bf16 ulps)
FLASH_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 1.6e-2)}
# tests/test_kernels.py:58-64: (B, S, H, K, V, chunk) of WKV_CASES, run here
# in f32 and bf16 each
WKV_CASES = [(2, 32, 2, 8, 8, 8), (1, 64, 4, 16, 16, 16), (2, 16, 1, 8, 16, 16),
             (1, 32, 2, 8, 8, 32), (1, 32, 2, 8, 8, 8)]
# the train command of the user's entry point (phase 8)
# the entry point's runs cut in depth to fit the script's time (PR 25 added
# phase 19 and an archive run took 1123 s): phase 8's command at
# TRAIN_CLI_DEPTH of qwen2-0.5b's 24 blocks, phase 12's at SSM_TRAIN_DEPTH
# of rwkv6-1.6b's 24 (its step is the exact recurrence, a loop over tokens
# a block); phase 16's scenario at BENCH_REPS timed calls a step (the
# reference's 5), phase 18's published-depth runs at 2 steps
TRAIN_CLI_DEPTH, SSM_TRAIN_DEPTH, BENCH_REPS = 12, 8, 3
TRAIN_CLI = ["train", "--arch", TRAIN_ARCH, "--mesh", str(RANKS),
             "--batch", str(RANKS * ROWS_PER_RANK), "--seq", str(SEQ),
             "--steps", "12", "--reorder", "simulate",
             "--payload-bytes", str(PLAN_PAYLOAD), "--lr", str(LR)]
# tensor parallelism through the user's entry point (phase 18): the train
# command at its default batch and sequence (8 x 64 tokens), the model
# axis's losses held to the data-parallel mesh's: bf16 at every step, f32
# at depth 2 on step 0 (one rounding of a reordered sum)
TP_CLI = ["train", "--arch", TRAIN_ARCH, "--reorder", "simulate"]
TP_BF16_RTOL, TP_F32_RTOL = 1e-2, 2e-5
# (label, mesh, steps, depth or None for published, dtype or None)
TP_RUNS = [("4x2", "4x2", 2, None, None), ("8", "8", 2, None, None),
           ("4x2 f32 depth 2", "4x2", 1, 2, "float32"),
           ("8 f32 depth 2", "8", 1, 2, "float32"),
           ("2x4 depth 4", "2x4", 2, 4, None), ("8 depth 4", "8", 2, 4, None)]
# bf16 serving, flash wave against the xla model on the same prefix: a
# generated token's logit may lie TOKEN_MARGIN below the top one, and the
# two prefills' last-position logits LOGIT_BOUND apart (in bf16 a logit of
# magnitude 4 to 8 has a step of 1/32).  Each limit lies between the sound
# reading and a control's: the flash model with a window of CONTROL_WINDOW
# (half the hybrid's 2048, half the VLM's 2048-token prompt), a fault that
# drops half of what attention should see; the phases hold both sides.
# Readings on an H100 80GB HBM3 at 700 W, sound / control: the hybrid's
# margin 0.125 / 0.5 and logits 0.172 / 0.730, the VLM's logits 0.086 /
# 3.82, dbrx's margin 0.125 / 8.07 and logits 0.445 / 10.53
TOKEN_MARGIN = 0.25
LOGIT_BOUND = {"recurrentgemma-9b": 0.35, "llava-next-mistral-7b": 0.25,
               "dbrx-132b": 1.0}
CONTROL_WINDOW = 1024
# the full-width gradient witness (rwkv6-1.6b in f32, GRAD_ROWS x SSM_SEQ
# tokens): for each parameter tensor, the forward-mode derivative of the loss
# along its gradient g must equal |g|^2 within GRAD_RTOL (f32 rounding: at
# most 7.8e-7 at full width on an H100; g 10 % off in every other entry, the
# control: at least 4.7e-2)
GRAD_ROWS, GRAD_RTOL = 2, 1e-4
# training the ssm family through the user's entry point: rwkv6-1.6b over 8
# virtual ranks of 64 x 16 tokens, 14 steps (the reference's 10-step warm-up
# of the learning rate, then 4 more), the payload its gradients' bytes.  The
# exact WKV recurrence is a loop over tokens, so a step costs by the sequence
# and rows are nearly free; at 2 x 64 tokens a rank and lr 1e-3 the loss
# rose after the warm-up, here at 5e-4 it falls (the gradient itself is held
# at full width by check_ssm_gradient).  An entry-point smoke at a short
# sequence, not a measure of training throughput
SSM_ARCH, SSM_ROWS_PER_RANK, SSM_SEQ, SSM_STEPS, SSM_LR = "rwkv6-1.6b", 64, 16, 14, 5e-4
TRAIN_SSM_CLI = ["train", "--arch", SSM_ARCH, "--mesh", str(RANKS),
                 "--batch", str(RANKS * SSM_ROWS_PER_RANK), "--seq", str(SSM_SEQ),
                 "--steps", str(SSM_STEPS), "--reorder", "simulate",
                 "--lr", str(SSM_LR)]
# MoE and MLA serving: deepseek-v2-236b cut to 4 layers (the dense head
# layer and 3 MoE layers) and dbrx-132b to 4, 4 requests x 2048-token
# prompts x 32 new; every MLA layer's absorbed decode held to the naive one
# over MLA_CHECK_STEPS teacher-forced steps; the MoE paths compared at the
# capacity factor E/K, where no path can drop (tests/test_perf_opts.py's
# 8.0 dropped on deepseek's real activations: 26.7 there, 4 for dbrx); the
# armed EP check on the first EP_TOKENS positions of each prompt row, the
# plan's all-to-all entry at EP_PAYLOAD bytes (cli.SERVE_PAYLOAD_BYTES).
# The limits lie between the sound readings and their controls' (an H100
# 80GB HBM3 at 700 W, sound / control): MLA's attention outputs (up to
# 0.90) 0.0039 / 0.096 apart; the MoE paths relative to their largest
# output (the reference's 1/sqrt(E) expert init makes a random layer's
# outputs reach 286 on deepseek and 32768 on dbrx, where one bf16 step is
# 2 and 256): dense vs scatter 0.0105 / 0.174, the a2a vs dense 0.0078 /
# 0.729, about three bf16 steps at the top and over twenty
MLA_ARCH, MLA_DEPTH, MOE_ARCH, MOE_DEPTH = "deepseek-v2-236b", 4, "dbrx-132b", 4
MOE_BATCH, MOE_PROMPT, MOE_NEW, MLA_CHECK_STEPS = 4, 2048, 32, 4
EP_TOKENS, EP_PAYLOAD = 512, 1e6
MLA_DECODE_BOUND, MOE_REL_BOUND = 0.02, 0.03
# the pipeline (GPipe, parallel/pipeline.py): qwen2-0.5b's 24 stacked blocks
# as PIPE_STAGES stages of 3 over PIPE_MICRO microbatches of PIPE_ROWS x SEQ
# tokens (16,384, a train step's), on the virtual mesh and over the group's 8
# processes (stage i in the process holding slot i of the training plan's
# mesh).  The bf16 flash forward against the same blocks in sequence on the
# whole batch, relative to its largest output: the same per-row math, the
# matmuls batched otherwise (a bf16 step is 2^-8 of the top; the control, the
# sequence without its last stage, is far).  The f32 gradients against the
# sequential chain's, each relative to its largest entry: f32 sums over
# 16,384 tokens in another order (the control: the chain on 7 of the 8
# microbatches, a lost drain tick, about 1/8 off)
PIPE_ARCH, PIPE_STAGES, PIPE_MICRO, PIPE_ROWS = TRAIN_ARCH, 8, 8, 2
# the LM loss's sequence chunk: every process of the group computes the loss
# on its copy of the output, as the reference's stages do, so the [16, chunk,
# 151936] f32 logits of 8 processes share the card (512, the config's, ran
# out of its 80 GB)
PIPE_LOSS_CHUNK = 64
PIPE_BF16_BOUND, PIPE_GRAD_BOUND = 0.05, 1e-3
# the EP all-to-all over the group: one dbrx-132b MoE layer at published
# widths (16 experts top-4, 2 a process), one 1024-token row a process
EP_GROUP_SEQ = 1024
# MoE training (phase 19): the train command on dbrx-132b at published
# widths cut to MOE_TRAIN_DEPTH block over 4 virtual data ranks (EP, 4
# experts a rank), the command's default 8 x 64 tokens, the published
# capacity factor, MOE_TRAIN_STEPS steps; the step-0 loss of the EP path
# against the dense per-rank path at the capacity factor E/K; one dbrx MoE
# layer on a 4x2 (data, model) mesh against the same layer on (4,), on
# MOE_TP_ROWS x MOE_TP_SEQ tokens; deepseek-v2's MoE layer over 8 EP
# ranks (20 experts each) on 8 x MOE_MLA_SEQ tokens against moe_scatter's
# gradient summed over the ranks' shards (at E/K the EP buffers hold
# E/K times the tokens, so the tokens are few).  The bounds are relative
# to the largest entry and lie between the sound readings and their
# controls' (the readings are in PERF.md section 6)
MOE_TRAIN_DEPTH, MOE_TRAIN_STEPS, MOE_TRAIN_RANKS = 1, 3, 4
MOE_TRAIN_CLI = ["train", "--arch", MOE_ARCH, "--mesh", str(MOE_TRAIN_RANKS),
                 "--reorder", "simulate", "--steps", str(MOE_TRAIN_STEPS)]
MOE_TP_ROWS, MOE_TP_SEQ, MOE_MLA_SEQ = 8, 256, 32
MOE_TP_BOUND, MOE_MLA_BOUND, EP_GROUP_GRAD_BOUND = 0.03, 0.03, 0.03
# MoE training where the data axis does not divide the experts (phase 20):
# the smoke dbrx (4 experts) on 8 data ranks for MOE_DP_SMOKE_STEPS steps;
# the published dbrx cut to MOE_TRAIN_DEPTH block on MOE_DP_RANKS data ranks,
# one 64-token row a rank, MOE_DP_STEPS steps where its reckoning fits
MOE_DP_SMOKE_STEPS, MOE_DP_RANKS, MOE_DP_STEPS = 4, 3, 2
MOE_DP_SMOKE_CLI = ["train", "--arch", MOE_ARCH, "--smoke", "--mesh", "8",
                    "--batch", "8", "--seq", "64", "--lr", "3e-3",
                    "--reorder", "simulate",
                    "--steps", str(MOE_DP_SMOKE_STEPS)]
MOE_DP_CLI = ["train", "--arch", MOE_ARCH, "--mesh", str(MOE_DP_RANKS),
              "--batch", str(MOE_DP_RANKS), "--seq", "64",
              "--reorder", "simulate", "--steps", str(MOE_DP_STEPS)]
# the reckoning held where the fallback runs: the published dbrx widths at
# MOE_TRAIN_DEPTH block with MOE_DP_MID_EXPERTS experts (which 3 does not
# divide either), MOE_DP_CLI's run; its peak must lie between the state the
# step holds (weights, moments, the ranks' gradient buffers) and the
# reckoned total plus MOE_DP_ACT_BYTES of activations (192 tokens: the f32
# logits over 100,352 and their gradient 0.15 GB, one block's activations
# under 0.1 GB; the allocator's rounding)
MOE_DP_MID_EXPERTS, MOE_DP_ACT_BYTES = 8, 2e9
# (c) the fallback's layer at full width: one published dbrx MoE layer on
# MOE_DP_RANKS data ranks of MOE_DP_LAYER_ROWS // MOE_DP_RANKS rows x
# MOE_TP_SEQ tokens at the published capacity factor, moe_dense_ranks
# forward and backward against moe_dense on the global batch; outputs and
# gradients relative to their largest entry, the aux relative to itself.
# The bounds lie between the sound readings and their controls' (PERF.md
# section 6): a mean of the ranks' own aux terms, and the gradients summed
# over every rank but the last
MOE_DP_LAYER_ROWS = 9
MOE_DP_LAYER_BOUND, MOE_DP_AUX_BOUND = 0.02, 1e-5
# the wrapped session's EP ranks (a 4-node datacenter, planned with moe=True)
WRAP_EP_RANKS = 4
# compression: error feedback over COMP_STEPS steps at one bucket's width
COMP_STEPS = 50
# the solver evaluator: a SOLVER_NODES-node datacenter's ring cost matrix at
# the training payload, a [SOLVER_CHAINS, SOLVER_NODES] batch of
# permutations; solve_sa on both backends, each engine at its iterations
SOLVER_NODES, SOLVER_CHAINS = 1024, 256
SOLVER_ITERS = {"vectorized": 256, "reference": 32}
# kernel vs plain on the same inputs: the same f32 math summed in another
# order (f32: the chunk-form tolerance of the CPU tests); bf16 y also
# rounds once to bf16 (2 ulps relative)
TOL = {"float32": (5e-4, 5e-3), "bfloat16": (2e-2, 1.6e-2)}
#: phase 21: the production-mesh cells' depth (the whole cells are the
#: dry run's ``--all``), the anchor's shapes, and
#: the band the card's measured peak must lie in around the reckoning
DRY_CELLS = (("qwen2-0.5b", 2), ("dbrx-132b", 1))
ANCHOR_ARCH, ANCHOR_BATCH, ANCHOR_SEQ, ANCHOR_STEPS = "qwen2-0.5b", 4, 2048, 3
ANCHOR_MESH_DEPTH, ANCHOR_MESH_RANKS, ANCHOR_MESH_SEQ = 4, 8, 1024
MEM_BAND = (0.97, 1.03)


def _say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int) -> float:
    """Device time of one ``fn`` call: ``iters`` calls captured in a CUDA
    graph and replayed between CUDA events, so the host's cost per call
    (the Python wrapper, the launch) stays out of a short kernel's time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _check_close(name, got, want, atol, rtol) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if not bool(torch.isfinite(got.float()).all()) or bool((err > limit).any()):
        raise AssertionError(f"{name}: disagrees with its reference "
                             f"(max abs err {err.max().item():.3e}, "
                             f"atol {atol}, rtol {rtol})")
    return err.max().item()


def check_wkv_kernel(seed: int) -> dict:
    """Phase 3: the WKV chunk kernel against its plain version, and its times.

    At the rwkv6-1.6b layer shape in f32 and bf16: y within ``TOL``, the
    final state within the f32 tolerance in both dtypes, a second launch on
    the same inputs equal bit for bit; the kernel timed by CUDA-graph
    replay, the plain version by events.
    """
    import torch

    from repro_torch.kernels import rwkv6_chunked as wk

    H, K, chunk = 32, 64, 16     # rwkv6-1.6b: 2048 / head_dim 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (BATCH, PROMPT, H, K)
    base = [torch.randn(shape, generator=gen, device="cuda") * 0.5 for _ in range(3)]
    w32 = 0.3 + 0.699 * torch.rand(shape, generator=gen, device="cuda")
    u32 = torch.randn((H, K), generator=gen, device="cuda") * 0.1
    errs, times = {}, {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        r, k, v = (x.to(dt) for x in base)
        w, u = w32.to(dt), u32.to(dt)
        y, s = wk.wkv_chunked_matmul(r, k, v, w, u, chunk=chunk)
        y2, s2 = wk.wkv_chunked_matmul(r, k, v, w, u, chunk=chunk)
        torch.cuda.synchronize()
        if not (torch.equal(y, y2) and torch.equal(s, s2)):
            raise AssertionError(f"wkv_chunked {dtype}: a second launch on the "
                                 f"same inputs differs")
        y_p, s_p = wk.wkv_chunked_matmul_plain(r, k, v, w, u, chunk=chunk)
        atol, rtol = TOL[dtype]
        errs[dtype] = _check_close(f"wkv_chunked y ({dtype})", y, y_p, atol, rtol)
        _check_close(f"wkv_chunked state ({dtype})", s, s_p, *TOL["float32"])
        times[dtype] = (
            _graph_ms(lambda: wk.wkv_chunked_matmul(r, k, v, w, u, chunk=chunk), 20),
            _time_ms(lambda: wk.wkv_chunked_matmul_plain(r, k, v, w, u, chunk=chunk), 5),
        )
        _say(f"wkv_chunked {dtype} [{BATCH},{PROMPT},{H},{K}] chunk {chunk}: "
             f"max abs err vs plain {errs[dtype]:.3e}; a second launch equal; "
             f"kernel {times[dtype][0]:.4f} ms (CUDA-graph replay), plain "
             f"{times[dtype][1]:.4f} ms")
    moved, flops = wk.work(BATCH, PROMPT, H, K, K, chunk, 2)
    tc = wk.tensor_core_flops(BATCH, PROMPT, H, K, K, chunk)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    # the products on tensor cores in three TF32 passes, the rest in f32
    t_ops = (3 * tc / TF32_FLOPS_PER_S + (flops - tc) / F32_FLOPS_PER_S) * 1e3
    _say(f"wkv_chunked bf16 work: {moved} bytes, {flops} FLOP ({tc} of them "
         f"products on tensor cores) -> {t_bytes:.4f} ms at 3.35 TB/s, "
         f"{t_ops:.4f} ms (3 TF32 passes at 495 TFLOP/s, the rest at 67 "
         f"TFLOP/s f32); kernel at {max(t_bytes, t_ops) / times['bfloat16'][0]:.3f} "
         f"of the bound")
    return {
        "name": "wkv_chunked",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv_chunked.cu",
        "replaces": "src/repro/kernels/rwkv6_chunked.py:105",
        "launches": None,            # filled from the main path's run
        "max_abs_err": errs["bfloat16"],
        "max_abs_err_f32": errs["float32"],
        "ms": times["bfloat16"][0],
        "plain_ms": times["bfloat16"][1],
        "ms_f32": times["float32"][0],
        "plain_ms_f32": times["float32"][1],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes_ms": t_bytes,
        "bound_ops_ms": t_ops,
        "library_ms": None,          # no single PyTorch call computes WKV
        "timing": "CUDA-graph replay (kernel); CUDA events (plain)",
    }


def check_wkv_scan_kernel(seed: int) -> dict:
    """Phase 3: the exact-recurrence WKV kernel against its plain version.

    The five ``WKV_CASES`` shapes and the rwkv6-1.6b layer shape, in f32
    and bf16; each result also equals a second launch on the same inputs
    (the state starts from zero every call).  The layer shape is timed:
    the kernel by CUDA-graph replay, the plain version by events.
    """
    import torch

    from repro_torch.kernels import rwkv6_scan as ws

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def inputs(B, S, H, K, V, dtype):
        r, k = (torch.randn((B, S, H, K), generator=gen, device="cuda") * 0.5
                for _ in range(2))
        v = torch.randn((B, S, H, V), generator=gen, device="cuda") * 0.5
        w = 0.3 + 0.699 * torch.rand((B, S, H, K), generator=gen, device="cuda")
        u = torch.randn((H, K), generator=gen, device="cuda") * 0.1
        return [x.to(dtype) for x in (r, k, v, w)] + [u]

    H, K = 32, 64
    layer = (BATCH, PROMPT, H, K, K, 64)
    errs, times, worst = {}, {}, {}
    for case in WKV_CASES + [layer]:
        for dtype in ("float32", "bfloat16"):
            args = inputs(*case[:5], getattr(torch, dtype))
            chunk = case[5]
            y = ws.wkv_scan(*args, chunk=chunk)
            again = ws.wkv_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            if not torch.equal(y, again):
                raise AssertionError(f"wkv_scan {case} {dtype}: a second call "
                                     f"on the same inputs differs (state kept?)")
            err = _check_close(f"wkv_scan {case} {dtype}", y,
                               ws.wkv_scan_plain(*args, chunk=chunk), *TOL[dtype])
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            if case == layer:
                errs[dtype] = err
                times[dtype] = (
                    _graph_ms(lambda: ws.wkv_scan(*args, chunk=chunk), 10),
                    _time_ms(lambda: ws.wkv_scan_plain(*args, chunk=chunk), 3,
                             warmup=1),
                )
                _say(f"wkv_scan {dtype} [{BATCH},{PROMPT},{H},{K}]: max abs err "
                     f"vs plain {err:.3e}; kernel {times[dtype][0]:.4f} ms "
                     f"(CUDA-graph replay), plain {times[dtype][1]:.4f} ms")
            del args
    _say(f"wkv_scan == plain on the {len(WKV_CASES)} WKV_CASES shapes and the "
         f"layer shape in f32 and bf16 (max abs err {worst}); every second "
         f"call equal to the first")
    moved, flops = ws.work(BATCH, PROMPT, H, K, K, 2)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    _say(f"wkv_scan bf16 work: {moved} bytes, {flops} FLOP -> {t_bytes:.4f} ms "
         f"at 3.35 TB/s, {t_ops:.4f} ms at 67 TFLOP/s f32; kernel at "
         f"{max(t_bytes, t_ops) / times['bfloat16'][0]:.3f} of the bound")
    return {
        "name": "wkv_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:80",
        "launches": None,            # filled from the serving spy's run
        "max_abs_err": errs["bfloat16"],
        "max_abs_err_f32": errs["float32"],
        "max_abs_err_cases": worst,
        "ms": times["bfloat16"][0],
        "plain_ms": times["bfloat16"][1],
        "ms_f32": times["float32"][0],
        "plain_ms_f32": times["float32"][1],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,          # no single PyTorch call computes WKV
        "timing": "CUDA-graph replay (kernel); CUDA events (plain)",
    }


class _ScanSpy:
    """Calls the model's ``wkv_chunked_op`` through and runs ``ops.wkv_op``
    (the scan kernel) on the same layer inputs, holding its y to the chunk
    kernel's without a synchronise (checked after the run)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0
        self.errs = []           # per call: the max abs difference (device)
        self.ratios = []         # per call: the worst element's share of TOL
        self.first = None        # one layer's inputs and scan y, for the plain

    def __call__(self, r, k, v, w, u, chunk=16):
        import torch

        from repro_torch.kernels import ops

        y, state = self.inner(r, k, v, w, u, chunk=chunk)
        scan = ops.wkv_op(r, k, v, w, u)
        atol, rtol = TOL["float32" if y.dtype == torch.float32 else "bfloat16"]
        diff = (scan.float() - y.float()).abs()
        ratio = (diff / (atol + rtol * y.float().abs())).max()
        # a non-finite scan output counts as off the chunk kernel's y
        self.ratios.append(torch.where(torch.isfinite(ratio), ratio,
                                       torch.full_like(ratio, float("inf"))))
        self.errs.append(diff.max())
        if self.first is None:
            self.first = ([x.clone() for x in (r, k, v, w, u)], scan.clone())
        self.calls += 1
        return y, state


def check_small_model(seed: int) -> None:
    """Phase 4: kernel path == exact recurrence on the smoke config (f32)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, GenerationEngine

    base = get_config("rwkv6-1.6b").smoke()
    ref = get_model(dataclasses.replace(base, wkv_impl="xla"), device="cuda")
    ker = get_model(dataclasses.replace(base, wkv_impl="kernel"), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = ref.init(gen)
    params["blocks"]["time_mix"]["u"].normal_(0.0, 0.3, generator=gen)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, base.vocab_size, (2, 32))).cuda()
    with torch.inference_mode():
        la, ca = ker.prefill(params, toks)
        lb, cb = ref.prefill(params, toks)
        for _ in range(4):
            _check_close("smoke logits", la, lb, 1e-4, 1e-4)
            for name in cb:
                _check_close(f"smoke cache {name}", ca[name], cb[name], 1e-4, 1e-4)
            cur = lb.argmax(-1)
            la, ca = ker.decode_step(params, cur, ca)
            lb, cb = ref.decode_step(params, cur, cb)
    prompts = toks.tolist()
    cfg = GenerationConfig(max_new_tokens=8, eos_token=-1)
    a = GenerationEngine(ker, params, cfg).generate(prompts)
    b = GenerationEngine(ref, params, cfg).generate(prompts)
    if a != b:
        raise AssertionError(f"smoke greedy tokens differ: {a} vs {b}")
    _say("smoke rwkv6 f32 on the card: kernel-path prefill + decode == "
         "exact recurrence (atol/rtol 1e-4); greedy tokens equal")


def check_flash_kernel(seed: int) -> dict:
    """Phase 3: the flash kernels against their plain version, and times.

    Every ``FLASH_CASES``/``FLASH_EXTRA`` shape in f32 and bf16 and the
    ``FLASH_VIEWS`` in bf16, each launched twice (the same bits) and
    counted by kernel; then one glm4-9b layer at the serving shape in bf16
    and f32 and one qwen2-0.5b layer in bf16, timed beside the plain
    version and ``F.scaled_dot_product_attention`` (the library yardstick
    only).
    """
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def inputs(B, H, KV, S, hd, dtype, view=False):
        shapes = ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)) if view else \
            ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd))
        xs = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
              for shape in shapes]
        return [x.transpose(1, 2) for x in xs] if view else xs

    def check(case, dtype, view=False):
        B, H, KV, S, hd, bq, bk, causal, window = case
        q, k, v = inputs(B, H, KV, S, hd, getattr(torch, dtype), view)
        kw = dict(causal=causal, window=window, block_q=bq, block_k=bk)
        before = dict(fa.flash_attention.kernel_launches)
        got = fa.flash_attention(q, k, v, **kw)
        again = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ran = {n for n in fa.KERNELS
               if fa.flash_attention.kernel_launches[n] != before[n]}
        want_kernel = ("flash_fwd_wgmma" if hd in (64, 128) else
                       "flash_fwd_fma" if hd == 8 else "flash_fwd_mma") \
            if dtype == "bfloat16" else "flash_fwd_fma"
        if ran != {want_kernel}:
            raise AssertionError(f"flash_attention {dtype} {case}: ran {ran}, "
                                 f"expected {want_kernel}")
        if not torch.equal(got, again):
            raise AssertionError(f"flash_attention {dtype} {case}: a second "
                                 f"launch gave other bits")
        err = _check_close(f"flash_attention {dtype} {case}"
                           f"{' (views)' if view else ''}", got,
                           fa.flash_attention_plain(q, k, v, **kw),
                           *FLASH_TOL[dtype])
        return err, (q, k, v)

    worst = {}
    for case in FLASH_CASES + FLASH_EXTRA:
        for dtype in ("float32", "bfloat16"):
            err, _ = check(case, dtype)
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    for case in FLASH_VIEWS:
        err, _ = check(case, "bfloat16", view=True)
        worst["bfloat16"] = max(worst["bfloat16"], err)
    _say(f"flash_attention == plain on the {len(FLASH_CASES)} FLASH_CASES "
         f"shapes and {len(FLASH_EXTRA)} more in f32 and bf16, and "
         f"{len(FLASH_VIEWS)} transposed views in bf16, each the kernel its "
         f"dtype and width select and the same bits twice: max abs err "
         f"{worst}")

    from repro_torch.configs import get_config

    cfg = _dense_cfg()
    shape = (DENSE_BATCH, cfg.n_heads, cfg.n_kv_heads, DENSE_PROMPT,
             cfg.head_dim)
    dense = time_flash_layer(DENSE_ARCH, shape, True, 0, seed)
    err32, (q, k, v) = check(shape + (128, 128, True, 0), "float32")
    ms32 = _graph_ms(lambda: fa.flash_attention(q, k, v), 5)
    plain32 = _time_ms(lambda: fa.flash_attention_plain(q, k, v), 3, warmup=1)
    _say(f"flash_attention float32 {DENSE_ARCH} layer {list(shape)} causal: "
         f"max abs err vs plain {err32:.3e}; kernel {ms32:.4f} ms, plain "
         f"{plain32:.4f} ms")
    del q, k, v
    torch.cuda.empty_cache()
    qcfg = get_config(TRAIN_ARCH)      # qwen2-0.5b: 14 / 2 heads of 64
    qwen = time_flash_layer(TRAIN_ARCH, (DENSE_BATCH, qcfg.n_heads,
                                         qcfg.n_kv_heads, DENSE_PROMPT,
                                         qcfg.head_dim), True, 0, seed)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:119",
        "launches": None,            # filled from the dense serving run
        "max_abs_err": dense["max_abs_err"],
        "max_abs_err_f32": err32,
        "max_abs_err_cases": worst,
        "shape": dense["shape"],
        "ms": dense["ms"],
        "plain_ms": dense["plain_ms"],
        "ms_f32": ms32,
        "plain_ms_f32": plain32,
        "bound_ms": dense["bound_ms"],
        "bound_by": dense["bound_by"],
        "library_ms": dense["library_ms"],   # F.scaled_dot_product_attention
        "qwen2_layer": qwen,
    }


def _dense_cfg(smoke: bool = False, impl: str = "flash"):
    from repro_torch.configs import get_config

    cfg = get_config(DENSE_ARCH)
    return dataclasses.replace(cfg.smoke() if smoke else cfg, attention_impl=impl)


def check_small_dense(seed: int) -> None:
    """Phase 4d: the smoke glm4-9b (f32): the flash prefill == the plain one,
    greedy tokens equal."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, GenerationEngine

    ker = get_model(_dense_cfg(smoke=True), device="cuda")
    ref = get_model(_dense_cfg(smoke=True, impl="xla"), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = ref.init(gen)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, ker.cfg.vocab_size, (2, 40))).cuda()
    before = fa.flash_attention.launches
    with torch.inference_mode():
        la, ca = ker.prefill(params, toks)
        lb, cb = ref.prefill(params, toks)
    if fa.flash_attention.launches - before != ker.cfg.n_layers:
        raise AssertionError("the smoke flash prefill did not launch the kernel "
                             "once a layer")
    _check_close("smoke dense logits", la, lb, 1e-4, 1e-4)
    for name in ("k", "v"):
        _check_close(f"smoke dense cache {name}", ca["scan"][name],
                     cb["scan"][name], 1e-4, 1e-4)
    prompts = toks.tolist()
    cfg = GenerationConfig(max_new_tokens=8, eos_token=-1)
    a = GenerationEngine(ker, params, cfg).generate(prompts)
    b = GenerationEngine(ref, params, cfg).generate(prompts)
    if a != b:
        raise AssertionError(f"smoke dense greedy tokens differ: {a} vs {b}")
    _say(f"smoke {DENSE_ARCH} f32 on the card: flash prefill == xla prefill "
         f"(logits and k/v cache, atol/rtol 1e-4); greedy tokens equal")


def check_small_families(seed: int) -> None:
    """Phase 4e: the smoke recurrentgemma-9b (5 layers: a group and a tail)
    and whisper-small in f32 on the card: the flash prefill == the plain
    one, greedy tokens equal, the hybrid at P > W and P == W (its ring
    buffers never grown), Whisper on random audio frames."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, GenerationEngine

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)
    for arch, n_layers in ((HYBRID_ARCH, 5), (WHISPER_ARCH, None)):
        base = get_config(arch).smoke()
        if n_layers:
            base = dataclasses.replace(base, n_layers=n_layers)
        ker, ref = (get_model(dataclasses.replace(base, attention_impl=impl),
                              device="cuda") for impl in ("flash", "xla"))
        params = ref.init(gen)
        fe = None if base.family != "encdec" else torch.randn(
            (2, base.n_audio_ctx, base.d_model), generator=gen, device="cuda")
        n_flash = (base.layer_kinds().count("A") if base.family == "hybrid"
                   else base.n_encoder_layers + base.n_layers)
        lens = (40, base.attn_window) if base.family == "hybrid" else (24,)
        for P in lens:
            toks = torch.from_numpy(rng.integers(0, base.vocab_size, (2, P))).cuda()
            before = fa.flash_attention.launches
            with torch.inference_mode():
                la, _ = ker.prefill(params, toks, fe)
                lb, _ = ref.prefill(params, toks, fe)
            if fa.flash_attention.launches - before != n_flash:
                raise AssertionError(f"smoke {arch}: the flash prefill did not "
                                     f"launch the kernel {n_flash} times")
            _check_close(f"smoke {arch} logits at P={P}", la, lb, 1e-4, 1e-4)
            cfg = GenerationConfig(max_new_tokens=8, eos_token=-1)
            a = GenerationEngine(ker, params, cfg).generate(toks.tolist(),
                                                            frontend_embeds=fe)
            b = GenerationEngine(ref, params, cfg).generate(toks.tolist(),
                                                            frontend_embeds=fe)
            if a != b:
                raise AssertionError(f"smoke {arch} P={P}: greedy tokens differ: "
                                     f"{a} vs {b}")
        _say(f"smoke {arch} f32 on the card: flash prefill == xla prefill "
             f"(atol/rtol 1e-4) and greedy tokens equal at P = {lens}")


def serve_dense_full_width(seed: int, card: str) -> dict:
    """Phase 5b: dense serving at full width (glm4-9b, flash), counted, then
    timed and profiled."""
    import numpy as np
    import torch

    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, GenerationEngine
    from repro_torch.serve.engine import _grow_cache

    from repro_torch.kernels import flash_attention as fa

    counted = _counted()
    cfg = _dense_cfg()
    model = get_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = model.init(gen)
    torch.cuda.empty_cache()
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT)).tolist()
    eng = GenerationEngine(model, params,
                           GenerationConfig(max_new_tokens=DENSE_NEW, eos_token=-1))
    eng.generate(prompts, max_new_tokens=2)    # warm-up wave, same shapes
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    fa.flash_attention.kernel_launches = dict.fromkeys(fa.KERNELS, 0)
    t0 = time.monotonic()
    outs = eng.generate(prompts)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    by_kernel = dict(fa.flash_attention.kernel_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if launches["flash_attention"] != cfg.n_layers or \
            by_kernel["flash_fwd_wgmma"] != cfg.n_layers:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times in one "
                             f"prefill ({by_kernel}), expected {cfg.n_layers}, "
                             f"all flash_fwd_wgmma")
    if len(outs) != DENSE_BATCH or any(len(o) != DENSE_NEW for o in outs):
        raise AssertionError(f"not every request got {DENSE_NEW} tokens: "
                             f"{[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("generated token out of the vocabulary")

    tokens = torch.tensor(prompts, device="cuda")
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens)
        if tuple(logits.shape) != (DENSE_BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 f"not finite / not [B, vocab]")
        prefill_ms = _time_ms(lambda: model.prefill(params, tokens), 3, warmup=1)
        cache = _grow_cache(cache, DENSE_PROMPT, DENSE_PROMPT + DENSE_NEW)
        cur = logits.argmax(-1)
        step_ms = _time_ms(lambda: model.decode_step(params, cur, cache), 10)
        prof_prefill = profile_window("dense prefill",
                                      lambda: model.prefill(params, tokens))
        prof_decode = profile_window("dense decode x4", lambda: [
            model.decode_step(params, cur, cache) for _ in range(4)])
    res = {
        "arch": cfg.name, "params": n_params, "batch": DENSE_BATCH,
        "prompt_len": DENSE_PROMPT, "new_tokens": DENSE_NEW,
        "attention_impl": cfg.attention_impl,
        "generate_s": wall, "generated_tokens": sum(len(o) for o in outs),
        "prefill_ms": prefill_ms,
        "prefill_tok_per_s": DENSE_BATCH * DENSE_PROMPT / (prefill_ms / 1e3),
        "decode_step_ms": step_ms,
        "decode_tok_per_s": DENSE_BATCH / (step_ms / 1e3),
        "peak_mem_gb": peak_gb, "launches": launches,
        "flash_kernel_launches": by_kernel,
        "profile_prefill": prof_prefill, "profile_decode": prof_decode,
        "card": card,
    }
    _say(f"serve {cfg.name} ({n_params} params, bf16, flash) batch {DENSE_BATCH} "
         f"x prompt {DENSE_PROMPT} x {DENSE_NEW} new: {res['generated_tokens']} "
         f"tokens in {wall:.3f} s; prefill {prefill_ms:.3f} ms "
         f"({res['prefill_tok_per_s']:.0f} tok/s); decode {step_ms:.3f} ms/step "
         f"({res['decode_tok_per_s']:.1f} tok/s); peak memory {peak_gb:.3f} GB; "
         f"flash_attention launches {launches['flash_attention']} "
         f"({by_kernel}) [{card}]")
    _say("serve dense " + json.dumps(res))
    res["armed"] = serve_dense_armed(model, params, prompts, outs, cfg.n_layers,
                                     prefill_ms, step_ms, card)
    return res


def serve_dense_armed(model, params, prompts, want, n_layers: int,
                      prefill_ms: float, step_ms: float, card: str) -> dict:
    """Phase 5c: the same glm4-9b wave with the serving plan's all-gather
    armed (``GenerationEngine.arm_overlap``) over an 8-rank virtual mesh,
    counted; then the armed prefill and decode step timed beside the
    unarmed ones."""
    import torch

    from repro_torch import obs
    from repro_torch.cli import SERVE_PAYLOAD_BYTES as SERVE_PAYLOAD
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import build_mesh
    from repro_torch.serve import GenerationConfig, GenerationEngine
    from repro_torch.serve.engine import _grow_cache
    from repro_torch.session import serve_mix

    args = argparse.Namespace(mesh=str(RANKS), reorder="simulate",
                              plan_cache_dir=None, payload_bytes=SERVE_PAYLOAD)
    mesh, plan = build_mesh(args, mix=serve_mix(SERVE_PAYLOAD), device="cuda")
    eng = GenerationEngine(model, params, GenerationConfig(
        max_new_tokens=DENSE_NEW, eos_token=-1), plan=plan)
    sched = eng.arm_overlap(mesh, "data", SERVE_PAYLOAD)
    hints = eng.collective_hints(SERVE_PAYLOAD)
    eng.generate(prompts, max_new_tokens=2)    # warm-up wave, armed
    torch.cuda.synchronize()

    counted = _counted()
    ok = obs.metrics().counter("serve.overlap.postcondition_ok")
    checked = ok.value
    for fn in counted.values():
        fn.launches = 0
    fa.flash_attention.kernel_launches = dict.fromkeys(fa.KERNELS, 0)
    t0 = time.monotonic()
    outs = eng.generate(prompts)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    by_kernel = dict(fa.flash_attention.kernel_launches)
    checked = ok.value - checked
    if outs != want:
        raise AssertionError("armed serving's tokens differ from the unarmed "
                             "wave's")
    if launches["flash_attention"] != n_layers or \
            by_kernel["flash_fwd_wgmma"] != n_layers:
        raise AssertionError(f"armed prefill: flash_attention launched "
                             f"{launches['flash_attention']} times ({by_kernel}), "
                             f"expected {n_layers}, all flash_fwd_wgmma")
    if checked < 1:
        raise AssertionError("armed serving checked no gather's postcondition")

    P, grown = DENSE_PROMPT, DENSE_PROMPT + DENSE_NEW
    tokens = torch.tensor(prompts, device="cuda")

    def armed_prefill():
        logits, cache = model.prefill(params, tokens)
        return eng._gather(eng._ag_payload(logits),
                           lambda: _grow_cache(cache, P, grown))

    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens)
        payload = eng._ag_payload(logits)
        cache = _grow_cache(cache, P, grown)
        cur = logits.argmax(-1)
        unarmed_prefill_ms = _time_ms(
            lambda: _grow_cache(model.prefill(params, tokens)[1], P, grown),
            3, warmup=1)
        armed_prefill_ms = _time_ms(armed_prefill, 3, warmup=1)
        armed_step_ms = _time_ms(lambda: eng._gather(
            payload, lambda: model.decode_step(params, cur, cache)), 10)
        gather_ms = _time_ms(lambda: eng._gather(payload, lambda: None), 10)
    res = {
        "plan_digest": plan.fingerprint.digest, "mesh_order": list(mesh.order),
        "algorithm": sched.algorithm, "schedule_order": list(sched.order),
        "rounds": len(sched.rounds), "payload": list(payload.shape),
        "hints": hints, "generate_s": wall, "launches": launches,
        "flash_kernel_launches": by_kernel, "postconditions_checked": checked,
        "prefill_ms": {"unarmed": prefill_ms,
                       "unarmed_with_cache_growth": unarmed_prefill_ms,
                       "armed": armed_prefill_ms},
        "decode_step_ms": {"unarmed": step_ms, "armed": armed_step_ms},
        "gather_alone_ms": gather_ms, "card": card,
    }
    _say(f"armed serve {DENSE_ARCH}: plan {res['plan_digest']} all-gather "
         f"{sched.algorithm} ({len(sched.rounds)} rounds, order "
         f"{list(sched.order)}) over {RANKS} virtual ranks, payload "
         f"{list(payload.shape)}; tokens == the unarmed wave's; flash launches "
         f"{launches['flash_attention']} ({by_kernel}); postcondition checked "
         f"{checked:.0f}x; prefill (+ cache growth) unarmed "
         f"{unarmed_prefill_ms:.3f} ms, armed {armed_prefill_ms:.3f} ms; decode "
         f"step unarmed {step_ms:.3f} ms, armed {armed_step_ms:.3f} ms; the "
         f"gather alone {gather_ms:.3f} ms [{card}]")
    _say("serve armed " + json.dumps(res, default=float))
    return res


def _counted() -> dict:
    """Every kernel wrapper, by name: each counts its own launches."""
    from repro_torch.kernels import (
        flash_attention, ring_collective, rwkv6_chunked, rwkv6_scan)

    return {"wkv_chunked": rwkv6_chunked.wkv_chunked_matmul,
            "wkv_scan": rwkv6_scan.wkv_scan,
            "fused_add": ring_collective.fused_add,
            "flash_attention": flash_attention.flash_attention,
            "peer_ring": ring_collective.remote_ring_reduce_scatter}


def serve_full_width(seed: int, card: str) -> dict:
    """Phase 5: the serving path at full width, counted, then timed."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, GenerationEngine

    counted = _counted()
    cfg = dataclasses.replace(get_config("rwkv6-1.6b"), wkv_impl="kernel")
    model = get_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = model.init(gen)
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).tolist()
    eng = GenerationEngine(model, params,
                           GenerationConfig(max_new_tokens=NEW, eos_token=-1))
    eng.generate([p[:16] for p in prompts], max_new_tokens=2)    # warm-up
    torch.cuda.synchronize()

    from repro_torch.kernels import rwkv6_scan
    from repro_torch.models import rwkv6 as rwkv6_mod

    spy = _ScanSpy(rwkv6_mod.wkv_chunked_op)
    rwkv6_mod.wkv_chunked_op = spy
    try:
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        t0 = time.monotonic()
        outs = eng.generate(prompts)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        rwkv6_mod.wkv_chunked_op = spy.inner

    if launches["wkv_scan"] != cfg.n_layers or spy.calls != cfg.n_layers:
        raise AssertionError(f"wkv_scan launched {launches['wkv_scan']} times "
                             f"on {spy.calls} prefill layers, expected "
                             f"{cfg.n_layers}")
    scan_ratio = max(float(r) for r in spy.ratios)
    if not scan_ratio <= 1.0:
        raise AssertionError(f"wkv_scan on the prefill's WKV inputs is off the "
                             f"chunk kernel's y by {scan_ratio:.3f} of TOL")
    scan_err = max(float(e) for e in spy.errs)
    (layer_args, layer_scan) = spy.first
    plain_err = _check_close("wkv_scan on layer 0 of the prefill", layer_scan,
                             rwkv6_scan.wkv_scan_plain(*layer_args), *TOL["bfloat16"])
    del spy, layer_args, layer_scan
    _say(f"serving spy: {launches['wkv_scan']} wkv_scan launches on the "
         f"prefill's WKV inputs, each within TOL of the chunk kernel's y (the "
         f"worst element at {scan_ratio:.4f} of TOL, max abs err "
         f"{scan_err:.3e}); layer 0 within {plain_err:.3e} of wkv_scan_plain")

    if launches["wkv_chunked"] != cfg.n_layers:
        raise AssertionError(f"wkv_chunked launched {launches['wkv_chunked']} "
                             f"times in one prefill, expected {cfg.n_layers}")
    if len(outs) != BATCH or any(len(o) != NEW for o in outs):
        raise AssertionError(f"not every request got {NEW} tokens: "
                             f"{[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("generated token out of the vocabulary")

    tokens = torch.tensor(prompts, device="cuda")
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens)
        if tuple(logits.shape) != (BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 f"not finite / not [B, vocab]")
        prefill_ms = _time_ms(lambda: model.prefill(params, tokens), 3, warmup=1)
        cur = logits.argmax(-1)
        step_ms = _time_ms(lambda: model.decode_step(params, cur, cache), 10)
        prof = profile_window("prefill", lambda: model.prefill(params, tokens))
        profile_window("decode x4", lambda: [model.decode_step(params, cur, cache)
                                             for _ in range(4)])
    res = {
        "arch": cfg.name, "params": n_params, "batch": BATCH,
        "prompt_len": PROMPT, "new_tokens": NEW,
        "generate_s": wall, "generated_tokens": sum(len(o) for o in outs),
        "prefill_ms": prefill_ms,
        "prefill_tok_per_s": BATCH * PROMPT / (prefill_ms / 1e3),
        "decode_step_ms": step_ms,
        "decode_tok_per_s": BATCH / (step_ms / 1e3),
        "peak_mem_gb": peak_gb, "launches": launches, "card": card,
        "wkv_scan_vs_chunk_max_abs_err": scan_err,
        "wkv_scan_vs_chunk_share_of_tol": scan_ratio,
        "wkv_scan_vs_plain_max_abs_err": plain_err,
        # the profiled prefill: the chunk kernel's device time and share
        "prefill_wkv_chunked_ms": prof.get("ms_by_kind", {}).get("wkv_chunked"),
        "prefill_busy_ms": prof.get("busy_ms"),
    }
    _say(f"serve {cfg.name} ({n_params} params, bf16) batch {BATCH} x prompt "
         f"{PROMPT} x {NEW} new: {res['generated_tokens']} tokens in "
         f"{wall:.3f} s; prefill {prefill_ms:.3f} ms; decode "
         f"{step_ms:.3f} ms/step ({res['decode_tok_per_s']:.1f} tok/s); peak "
         f"memory {peak_gb:.3f} GB; wkv_chunked launches {launches['wkv_chunked']}"
         f" (the counted run's wall time includes the spy's {launches['wkv_scan']} "
         f"wkv_scan launches) [{card}]")
    if res["prefill_wkv_chunked_ms"] is not None:
        _say(f"prefill: {launches['wkv_chunked']} wkv_chunked calls "
             f"{res['prefill_wkv_chunked_ms']:.3f} ms of "
             f"{res['prefill_busy_ms']:.3f} ms busy in the profiled prefill")
    _say("serve " + json.dumps(res))
    return res


def train_layout() -> dict:
    """The training run's schedule and buckets, from the shapes alone.

    The largest ``fused_add`` call of the run is one reduce step of one
    piece of the largest bucket: ``[n, 1, piece_len]``.
    """
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.train import certified_allreduce, partition_tree

    cfg = get_config(TRAIN_ARCH)
    model = DecoderLM(cfg, device="cuda")
    shapes = L.map_spec(model.param_spec(), lambda e: torch.empty(
        e[0], dtype=model.dtype, device="meta"))
    leaves = list(_leaves(shapes))
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    bucket_bytes = param_bytes / 3.5
    sched = certified_allreduce(RANKS, bucket_bytes, "ring", perm=TRAIN_PERM,
                                chunk_factor=2)
    buckets = partition_tree(shapes, bucket_bytes)
    quantum = sched.n_chunks * sched.chunk_factor
    padded = [b.n_elems + (-b.n_elems) % quantum for b in buckets]
    reduce_steps = sum(1 for rnd in sched.rounds for st in rnd
                       if st.op == "reduce")
    return {
        "cfg": cfg, "shapes": shapes, "param_bytes": param_bytes,
        "bucket_bytes": bucket_bytes,
        "schedule": sched, "buckets": buckets,
        "n_params": sum(t.numel() for t in leaves),
        "largest_call": max(padded) // sched.chunk_factor,
        "largest_payload": RANKS * max(padded),
        # one launch per reduce step, per piece, per bucket
        "launches_per_step": len(buckets) * reduce_steps * sched.chunk_factor,
    }


def check_fused_add_kernel(seed: int, layout: dict) -> dict:
    """Phase 3: ``fused_add`` against its plain version, bit for bit; times."""
    import numpy as np
    import torch

    from repro_torch.kernels import ring_collective as rc

    sizes = [64, 100, 1024, (1 << 20) + 3, layout["largest_call"],
             layout["largest_payload"]]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for n in sizes:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.randn(n, generator=gen, device="cuda").to(dtype)
            b = torch.randn(n, generator=gen, device="cuda").to(dtype)
            want = rc.fused_add_plain(a, b)
            got = rc.fused_add(a, b)
            rc.fused_add(a, b, out=a)                  # in place
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(a, want)):
                bad = (got.float() - want.float()).abs().max().item()
                raise AssertionError(f"fused_add {dtype} n={n}: kernel != plain "
                                     f"(max abs err {bad:.3e})")
            del a, b, want, got
        torch.cuda.empty_cache()
    # views at element offsets 0-7 into their buffers: the same offset for
    # a, b and out (a scalar head, the 16-byte body, a scalar tail) and
    # different ones (scalars throughout), below one tile and across many
    rng_o = np.random.default_rng(seed)
    offsets = [(o, o, o) for o in range(8)] + [
        tuple(int(v) for v in rng_o.integers(0, 8, 3)) for _ in range(8)]
    for n in (5, 1000, 3 * 8192 + 11, (1 << 20) + 3):
        for dtype in (torch.float32, torch.bfloat16):
            abuf = torch.randn(n + 8, generator=gen, device="cuda").to(dtype)
            bbuf = torch.randn(n + 8, generator=gen, device="cuda").to(dtype)
            for oa, ob, oo in offsets:
                a, b = abuf[oa:oa + n], bbuf[ob:ob + n]
                want = rc.fused_add_plain(a, b)
                out = torch.zeros(n + 8, dtype=dtype, device="cuda")
                got = rc.fused_add(a, b, out=out[oo:oo + n])
                acc = abuf.clone()
                rc.fused_add(acc[oa:oa + n], b, out=acc[oa:oa + n])
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(acc[oa:oa + n], want)
                        and torch.equal(acc[:oa], abuf[:oa])
                        and torch.equal(acc[oa + n:], abuf[oa + n:])
                        and not bool(out[:oo].any()) and not bool(out[oo + n:].any())):
                    raise AssertionError(f"fused_add {dtype} n={n} offsets a={oa} "
                                         f"b={ob} out={oo}: kernel != plain")
    _say(f"fused_add == plain bit for bit, f32 and bf16, in and out of place, "
         f"at n = {sizes}, and at n = 5, 1000, 24587, 2^20+3 on views at "
         f"element offsets (a, b, out) {offsets}")

    n = layout["largest_call"]
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        a = torch.randn(n, generator=gen, device="cuda").to(dtype)
        b = torch.randn(n, generator=gen, device="cuda").to(dtype)
        out = torch.empty_like(a)
        times[dtype] = (
            _graph_ms(lambda: rc.fused_add(a, b, out=out), 50),
            _time_ms(lambda: rc.fused_add_plain(a, b), 20),
            _graph_ms(lambda: torch.add(a, b, out=out), 50),
        )
        moved = rc.work(n, a.element_size())
        _say(f"fused_add {dtype} n={n}: kernel {times[dtype][0]:.4f} ms, plain "
             f"{times[dtype][1]:.4f} ms, torch.add {times[dtype][2]:.4f} ms; "
             f"bound {moved / HBM_BYTES_PER_S * 1e3:.4f} ms ({moved} bytes at "
             f"3.35 TB/s)")
        del a, b, out
    torch.cuda.empty_cache()
    k, p, lib = times[torch.bfloat16]
    return {
        "name": "fused_add",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_add.cu",
        "replaces": "src/repro/kernels/ring_collective.py:62",
        "launches": None,            # filled from the training path's run
        "max_abs_err": 0.0,          # bit-equal to the plain version above
        "ms": k, "plain_ms": p,
        "ms_f32": times[torch.float32][0],
        "plain_ms_f32": times[torch.float32][1],
        "library_ms_f32": times[torch.float32][2],
        "elements": n,
        "bound_ms": rc.work(n, 2) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": lib,           # torch.add on the same tensors
    }


def check_virtual_mesh(seed: int) -> None:
    """Phase 4b: certified schedules on the card's virtual mesh."""
    import torch

    from repro_torch.kernels import ring_collective as rc
    from repro_torch.kernels.overlap import run_overlapped
    from repro_torch.kernels.ref import ring_reduce_scatter_ref
    from repro_torch.kernels.schedule_runner import check_postcondition, run_schedule
    from repro_torch.train import certified_allreduce

    n, per_rank = 8, 1 << 20
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((n, per_rank), generator=gen, device="cuda")
    for algo, k in (("ring", 2), ("halving_doubling", 1),
                    ("double_binary_tree", 1)):
        sched = certified_allreduce(n, per_rank * 4, algo, perm=MESH_PERM,
                                    chunk_factor=k)
        before = rc.fused_add.launches
        out = run_schedule(x, sched)
        torch.cuda.synchronize()
        if rc.fused_add.launches == before:
            raise AssertionError(f"{algo}: no fused_add launch")
        bad = check_postcondition(sched, x, out, atol=1e-4)
        if bad:
            raise AssertionError(f"{algo}: postcondition fails: {bad[:3]}")
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            ker = run_schedule(xd, sched)
            if not torch.equal(ker, run_schedule(xd, sched, use_kernel_add=False)):
                raise AssertionError(f"{algo} {dt}: kernel path != + path")
            if not torch.equal(ker, run_overlapped(xd, sched)[0]):
                raise AssertionError(f"{algo} {dt}: run_overlapped != run_schedule")
    rs = rc.ring_reduce_scatter(x, perm=MESH_PERM)
    err = (rs - ring_reduce_scatter_ref(x, n)).abs().max().item()
    if err > 1e-4:
        raise AssertionError(f"ring reduce-scatter off the oracle by {err:.3e}")
    if not torch.equal(rs, rc.ring_reduce_scatter(x, perm=MESH_PERM,
                                                  use_kernel_add=False)):
        raise AssertionError("ring reduce-scatter: kernel path != + path")
    _say(f"virtual mesh n={n}, {per_rank} f32 per rank, perm {MESH_PERM}: ring "
         f"(k=2), halving-doubling, double binary tree all-reduce meet their "
         f"postcondition; kernel == + and overlapped == runner bit for bit in "
         f"f32 and bf16; ring reduce-scatter within {err:.2e} of the oracle")


def check_small_train(seed: int, plan) -> None:
    """Phase 4c: the smoke qwen2-0.5b (f32): overlapped 8-rank step == baseline.

    Bucketed and fused through the runner, and the planned step: the plan
    compiled for the full-width payload (``Plan.lookup`` takes the nearest
    octave, so the smoke tree gets the planned ring), every bucket through
    the peer-memory ring kernel.
    """
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, host_batch
    from repro_torch.kernels import ring_collective as rc
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (
        OverlapGradReducer, certified_allreduce, init_state,
        make_overlap_train_step, make_train_step, reducer_from_plan)

    cfg = get_config(TRAIN_ARCH).smoke()
    model = get_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    state = init_state(model, gen)
    batch = host_batch(SyntheticLM(cfg.vocab_size, 16, RANKS, seed=seed), 0)
    opt = AdamWConfig(lr=LR)
    base, base_m = make_train_step(model, opt)(state, batch)
    pb = sum(t.numel() * t.element_size() for t in _leaves(state.params))
    sched = certified_allreduce(RANKS, pb / 3.5, "ring", perm=TRAIN_PERM,
                                chunk_factor=2)
    reducers = {mode: OverlapGradReducer(sched, bucket_bytes=pb / 3.5, mode=mode)
                for mode in ("bucketed", "fused")}
    reducers["planned"] = reducer_from_plan(plan, PLAN_PAYLOAD)
    for mode, red in reducers.items():
        before = rc.remote_ring_reduce_scatter.launches
        new, met = make_overlap_train_step(model, opt, red)(state, batch)
        torch.cuda.synchronize()
        if mode == "planned" and (rc.remote_ring_reduce_scatter.launches == before
                                  or rc.ring_status() != 0):
            raise AssertionError("the planned smoke step did not run the ring "
                                 "kernel cleanly")
        # tests/test_overlap.py:306-325
        _check_close(f"smoke loss ({mode})", met["loss"], base_m["loss"], 2e-6, 2e-5)
        _check_close(f"smoke grad_norm ({mode})", met["grad_norm"],
                     base_m["grad_norm"], 1e-5, 2e-4)
        for a, b in zip(_leaves(new.params), _leaves(base.params)):
            _check_close(f"smoke params ({mode})", a, b, 1e-4, 0.0)
    _say(f"smoke {TRAIN_ARCH} f32 on the card: the overlapped {RANKS}-rank step "
         f"(bucketed, fused; planned through the peer_ring kernel at order "
         f"{list(reducers['planned'].schedule.order)}) == the baseline step "
         f"(loss rtol 2e-5, grad_norm rtol 2e-4, params atol 1e-4)")


class _TimedReducer:
    """The reducer, with CUDA events around each call (read after the step)."""

    def __init__(self, inner):
        self.inner = inner
        self.n = inner.n
        self.events = []

    def __call__(self, stacked, compute=()):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.inner(stacked, compute)
        end.record()
        self.events.append((start, end))
        return out

    def last_ms(self) -> float:
        start, end = self.events[-1]
        return start.elapsed_time(end)


def check_reducer_at_full_width(model, state, batch, reducer, twin=None) -> dict:
    """Phase 6a / 7a: the reducer on step 0's stacked bf16 grads.

    Against a plain f32 mean of the same grads: the ring sums 8 bf16
    values with one rounding per add, so an element may be off by at
    most ``8 * 2^-8 * mean_r |g_r|`` (the summation bound: n-1 adds plus
    the final rounding, at bf16's unit roundoff 2^-8).  Against ``twin``
    (the same schedule reduced with ``+``), where given: bit for bit.
    """
    import torch

    from repro_torch.kernels import ring_collective as rc
    from repro_torch.train import stacked_grads
    from repro_torch.train.train_step import batch_on
    from repro_torch.tree import tree_leaves

    _, gstack = stacked_grads(model, state.params, batch_on(batch, "cuda"), RANKS)
    ker, _ = reducer(gstack)
    prof = profile_window("reducer", lambda: reducer(gstack))
    plus = twin(gstack)[0] if twin is not None else ker
    torch.cuda.synchronize()
    if rc.ring_status() != 0:
        raise AssertionError("reducer: the ring kernel's status word is set")
    worst = 0.0
    with torch.no_grad():
        for g, k, p in zip(tree_leaves(gstack), tree_leaves(ker), tree_leaves(plus)):
            if not torch.equal(k, p):
                raise AssertionError("reducer: kernel path != + path")
            gf = g.float()
            limit = RANKS * 2.0 ** -8 * gf.abs().mean(0) + 1e-30
            ratio = ((k.float() - gf.mean(0)).abs() / limit).max().item()
            if not ratio <= 1.0:
                raise AssertionError(f"reducer off the f32 mean by {ratio:.3f} "
                                     f"of the bound")
            worst = max(worst, ratio)
            del gf, limit
    del gstack, ker, plus
    torch.cuda.empty_cache()
    _say(f"reducer ({reducer.transport}) on step 0's bf16 grads: "
         f"{'kernel path == + path bit for bit; ' if twin is not None else ''}"
         f"worst element at {worst:.4f} of the bf16 summation bound of the "
         f"f32 mean")
    return {"reducer_err_of_bound": worst, "reducer_profile": prof}


def train_full_width(seed: int, card: str, cfg, reducer, twin, kernel: str,
                     per_step: int, info: dict) -> dict:
    """Phase 6 / 7: a training path at full width, counted, then profiled.

    ``kernel`` names the kernel the reducer carries, ``per_step`` the
    launches it makes in a step; ``info`` describes the reduction.
    """
    import math

    import torch

    from repro_torch.data import SyntheticLM, host_batch
    from repro_torch.kernels import ring_collective as rc
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_state, make_overlap_train_step

    model = get_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    state = init_state(model, gen)
    ds = SyntheticLM(cfg.vocab_size, SEQ, RANKS * ROWS_PER_RANK, seed=seed)
    batches = [host_batch(ds, s) for s in range(TRAIN_STEPS + 2)]   # set-up
    checks = check_reducer_at_full_width(model, state, batches[0], reducer, twin)
    # learning, apart from batch-to-batch noise: the loss on the last
    # batch (never trained on) before and after the steps
    from repro_torch.train.train_step import batch_on
    held_out = batch_on(batches[-1], "cuda")
    with torch.no_grad():
        held_out_before = float(model.loss(state.params, held_out))

    timed_reducer = _TimedReducer(reducer)
    step_fn = make_overlap_train_step(model, AdamWConfig(lr=LR), timed_reducer)
    tokens = RANKS * ROWS_PER_RANK * SEQ
    counted = _counted()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    steps = []
    for s in range(1 + TRAIN_STEPS):
        before = counted[kernel].launches
        t0 = time.monotonic()
        state, met = step_fn(state, batches[s])
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        row = {"step": s, "warmup": s == 0, "loss": float(met["loss"]),
               "grad_norm": float(met["grad_norm"]), "step_ms": dt * 1e3,
               "tokens_per_s": tokens / dt, "reducer_ms": timed_reducer.last_ms(),
               f"{kernel}_launches": counted[kernel].launches - before,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        steps.append(row)
        _say("train step " + json.dumps(row))
    launches = {name: fn.launches for name, fn in counted.items()}

    if rc.ring_status() != 0:
        raise AssertionError("training: the ring kernel's status word is set")
    if any(r[f"{kernel}_launches"] != per_step for r in steps):
        raise AssertionError(f"{kernel} launches per step "
                             f"{[r[f'{kernel}_launches'] for r in steps]}, "
                             f"expected {per_step} (every bucket of every step)")
    losses = [r["loss"] for r in steps]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"step 0 loss {losses[0]:.4f} is not within 0.5 of "
                             f"ln V = {math.log(cfg.vocab_size):.4f}")
    if not sum(losses[1:]) / TRAIN_STEPS < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")

    with torch.no_grad():
        held_out_after = float(model.loss(state.params, held_out))
    prof = profile_window("train step", lambda: step_fn(state, batches[-1]))
    timed = steps[1:]
    res = {
        "arch": cfg.name, "dtype": cfg.dtype,
        "ranks": RANKS, "rows_per_rank": ROWS_PER_RANK, "seq": SEQ,
        "tokens_per_step": tokens, **info,
        "transport": reducer.transport,
        "losses": losses,
        "held_out_loss": [held_out_before, held_out_after],
        "step_ms": [r["step_ms"] for r in timed],
        "tokens_per_s": [r["tokens_per_s"] for r in timed],
        "reducer_ms": [r["reducer_ms"] for r in timed],
        f"{kernel}_launches_per_step": per_step,
        "peak_mem_gb": max(r["peak_mem_gb"] for r in steps),
        "launches": launches, "profile": prof, "card": card, **checks,
    }
    _say(f"train {cfg.name} ({info['params']} params, bf16), {RANKS} ranks x "
         f"{ROWS_PER_RANK} x {SEQ} tokens, {reducer.schedule.algorithm} order "
         f"{info['perm']} ({reducer.transport}): losses "
         f"{[round(v, 4) for v in losses]} (held-out batch "
         f"{held_out_before:.4f} -> {held_out_after:.4f}); step "
         f"{[round(v, 1) for v in res['step_ms']]} ms; reducer "
         f"{[round(v, 2) for v in res['reducer_ms']]} ms; {kernel} launches "
         f"{launches[kernel]} ({per_step} a step); peak memory "
         f"{res['peak_mem_gb']:.3f} GB [{card}]")
    _say("train " + json.dumps(res))
    return res


def compile_plan() -> dict:
    """Phase 2b: probe the fabric and compile the training mix's plan.

    Host work only (numpy): the port's ``PlanCompiler`` with the
    contention-aware simulator as its oracle.  The CPU tests pin this plan
    equal to the JAX package's on the same inputs.
    """
    from repro_torch.fabric import make_datacenter, probe_fabric, scramble
    from repro_torch.plan import PlanCompiler
    from repro_torch.session import train_mix

    fab, _ = scramble(make_datacenter(8, **PLAN_FABRIC), seed=PLAN_SCRAMBLE_SEED)
    probe = probe_fabric(fab, seed=PLAN_PROBE_SEED)
    plan = PlanCompiler(fabric=fab, seed=0).compile(
        probe, train_mix(PLAN_PAYLOAD), mesh_shape=(8,))
    _say(f"plan: fabric fingerprint {plan.fingerprint.digest}, oracle "
         f"{plan.meta['oracle']}, mix {plan.mix_key}")
    for (op, bucket, group), e in sorted(plan.entries.items()):
        _say(f"plan entry {op} octave {bucket} ({e.size_bytes:.0f} bytes): "
             f"{e.algo} {e.algo_kwargs} chunks {e.chunks} perm {list(e.perm)} "
             f"bucket_bytes {e.bucket_bytes:.0f}; modeled {e.expected_time:.6f} s,"
             f" {e.identity_times[e.algo] / e.expected_time:.3f}x its identity "
             f"order, {e.best_identity_time / e.expected_time:.3f}x the best "
             f"identity-order algorithm (simulator, not measured)")
    mp = plan.mesh_plan
    _say(f"plan mesh {mp.axis_names}: {mp.assignment.tolist()}, modeled cost "
         f"{mp.cost:.4f} vs {mp.baseline_cost:.4f} in identity order")
    _say(f"plan compiled in {plan.compile_seconds:.3f} s of host time (the CPU "
         f"of the machine with the card)")
    return plan


def planned_layout(plan, layout: dict) -> dict:
    """The planned reducer and the bucket shapes it hands the ring kernel."""
    from repro_torch.train import partition_tree, reducer_from_plan

    red = reducer_from_plan(plan, PLAN_PAYLOAD)
    buckets = partition_tree(layout["shapes"], red.bucket_bytes)
    quantum = red.schedule.n_chunks * max(1, red.schedule.chunk_factor)
    widths = [b.n_elems + (-b.n_elems) % quantum for b in buckets]
    _say(f"planned reducer: {red.schedule.algorithm} at order "
         f"{list(red.schedule.order)}, bucket_bytes {red.bucket_bytes:.0f}, "
         f"{len(buckets)} buckets of {widths} elements a rank, transport "
         f"{red.transport}")
    return {"reducer": red, "buckets": buckets, "widths": widths}


def _group_input(rank: int, width: int, dtype, seed: int):
    """Logical rank ``rank``'s input: ``width`` normal values drawn on the
    card from ``seed + rank``, so every process draws the same rows."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + rank)
    return torch.randn(width, generator=gen, device="cuda").to(dtype)


def _group_worker(rank: int, store: str, plan, jobs: list, out_dir: str,
                  seed: int, port: dict) -> None:
    """One process of the group phase (spawned; one slot of the plan's
    group-backed mesh, one schedule position).

    Each job runs the certified all-reduce through
    ``run_schedule_group``: once counted (its ``fused_add`` launches against
    the schedule's reduces at this position), its rows gathered at rank 0
    and held bit for bit to the virtual-mesh runner with plain ``+`` on the
    same card and inputs, then ``GROUP_TIMED_CALLS`` times for the wall and
    staging times.  Then the pipeline's f32 step (:func:`_group_pipeline`)
    and the EP all-to-all (:func:`_group_ep`) in the same processes.
    """
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", world_size=RANKS, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        from repro_torch.kernels import ring_collective as rc
        from repro_torch.kernels.group_runner import (
            gather_rows, local_rank, reduce_count, run_schedule_group)
        from repro_torch.kernels.schedule_runner import (
            check_postcondition, run_schedule)
        from repro_torch.launch import make_planned_mesh

        mesh = make_planned_mesh(plan, "cuda", group=dist.group.WORLD)
        out = []
        for label, pair, width, dtype_name in jobs:
            sched, dtype = pair[1], getattr(torch, dtype_name)
            x = _group_input(local_rank(sched, mesh), width, dtype, seed)
            before = rc.fused_add.launches
            row = run_schedule_group(x, pair, mesh)
            torch.cuda.synchronize()
            launches = rc.fused_add.launches - before
            want = reduce_count(sched, mesh.slot)
            if launches != want:
                raise AssertionError(f"group {label} rank {rank}: {launches} "
                                     f"fused_add launches, the schedule has "
                                     f"{want} reduces here")
            rows = gather_rows(row, sched, mesh)
            del row
            if rank == 0:
                full = torch.stack([_group_input(r, width, dtype, seed)
                                    for r in range(RANKS)])
                if not torch.equal(rows, run_schedule(full, sched,
                                                      use_kernel_add=False)):
                    raise AssertionError(f"group {label}: the processes' rows "
                                         f"!= the virtual-mesh runner's")
                if dtype == torch.float32 and width * 4 <= GROUP_RANK_BYTES:
                    bad = check_postcondition(sched, full, rows, atol=1e-4)
                    if bad:
                        raise AssertionError(f"group {label}: {bad[:3]}")
                del full
            del rows
            torch.cuda.empty_cache()
            walls, stages = [], []
            for _ in range(GROUP_TIMED_CALLS):
                stats = {}
                dist.barrier()      # rank 0's check above must not be timed
                run_schedule_group(x, pair, mesh, stats=stats)
                walls.append(stats["wall_s"] * 1e3)
                stages.append(stats["stage_s"] * 1e3)
            out.append({"label": label, "slot": mesh.slot,
                        "launches": launches, "reduces": want,
                        "wall_ms": walls, "stage_ms": stages})
            del x
        res = {"jobs": out,
               "pipeline": _group_pipeline(rank, seed, plan, port["ref_dir"]),
               "ep": _group_ep(rank, seed, port["ep_plan"], out_dir)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _group_pipeline(rank: int, seed: int, plan, ref_dir: str) -> dict:
    """This process's stage of the pipeline's f32 step over the group
    (stage ``i`` in the process holding slot ``i`` of ``plan``'s mesh):
    ``pipeline_loss`` forward and backward, every process backpropagating
    its own loss, twice (the first warms up); then its stage's gradients
    and the output held to the virtual run's (``ref_dir``), and the other
    stages' gradient slices zero here."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import make_planned_mesh
    from repro_torch.parallel.pipeline import pipeline_forward, pipeline_loss
    from repro_torch.tree import tree_leaves, tree_map

    # the first checkpoint call imports torch._dynamo (seconds); here every
    # process pays it at once, not each in its turn along the stage chain
    import torch._dynamo  # noqa: F401

    st = _pipe_setup(seed)
    mesh = make_planned_mesh(plan, "cuda", group=dist.group.WORLD)
    axis = mesh.axis_names[0]
    fwd = _pipe_stage_fn(st.model, st.per, remat=True)
    head_fn = _pipe_head(st.model, st.head)
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        leaves = tree_map(lambda a: a.detach().requires_grad_(True), st.staged)
        dist.barrier()
        t0 = time.perf_counter()
        loss = pipeline_loss(fwd, head_fn, leaves, st.x, st.labels, mesh,
                             axis=axis)
        loss.backward()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s = mesh.slot
    grads = [t.grad for t in tree_leaves(leaves)]
    ref = torch.load(os.path.join(ref_dir, f"stage{s}.pt"))
    mine = [g[s].cpu() for g in grads]
    others = any(bool(g[:s].any()) or bool(g[s + 1:].any()) for g in grads)
    del grads, leaves
    with torch.no_grad():
        y = pipeline_forward(fwd, st.staged, st.x, mesh, axis=axis).cpu()
    out = torch.load(os.path.join(ref_dir, "out.pt"))
    res = {"rank": rank, "stage": s, "wall_s": walls, "peak_gb": peak_gb,
           "grads_equal": all(torch.equal(g, r) for g, r in zip(mine, ref)),
           "grad_relative": max(_rel(g, r) for g, r in zip(mine, ref)),
           "other_stages_zero": not others,
           "loss_equal": bool(torch.equal(loss.detach().cpu(), out["loss"])),
           "y_equal": bool(torch.equal(y, out["y"])),
           "y_relative": _rel(y, out["y"])}
    del st, y, out, mine, ref
    _free()
    return res


def _group_pipeline_report(per_rank: list, card: str) -> dict:
    rows = sorted((r["pipeline"] for r in per_rank), key=lambda p: p["stage"])
    if [p["stage"] for p in rows] != list(range(PIPE_STAGES)):
        raise AssertionError(f"the group's stages {[p['stage'] for p in rows]}")
    bad = [p for p in rows if not (p["grads_equal"] and p["loss_equal"]
                                   and p["y_equal"] and p["other_stages_zero"])]
    # a step ends when its slowest process does
    wall_ms = [max(p["wall_s"][c] for p in rows) * 1e3 for c in range(2)]
    bubble = (PIPE_STAGES - 1) / (PIPE_MICRO + PIPE_STAGES - 1)
    res = {"stages_by_rank": {p["rank"]: p["stage"] for p in rows},
           "step_wall_ms": wall_ms, "bubble_share": bubble,
           "bit_for_bit": not bad,
           "worst_grad_relative": max(p["grad_relative"] for p in rows),
           "worst_y_relative": max(p["y_relative"] for p in rows),
           "peak_gb_by_stage": [p["peak_gb"] for p in rows], "card": card}
    _say(f"pipeline over {PIPE_STAGES} gloo processes ({PIPE_ARCH}, f32, "
         f"stage by rank {res['stages_by_rank']}): every stage's gradient, the "
         f"output and the loss == the virtual mesh's bit for bit: {not bad} "
         f"(worst relative {res['worst_grad_relative']:.3g}, output "
         f"{res['worst_y_relative']:.3g}); a step {wall_ms[1]:.1f} ms of wall "
         f"time (the first, warming up, {wall_ms[0]:.1f} ms), bubble share "
         f"{PIPE_STAGES - 1}/{PIPE_MICRO + PIPE_STAGES - 1} = {bubble:.4f} of "
         f"the schedule's ticks; peak memory a process up to "
         f"{max(res['peak_gb_by_stage']):.3f} GB [{card}; host clock]")
    if bad:
        raise AssertionError(f"the group pipeline parts from the virtual "
                             f"mesh's on stages {[p['stage'] for p in bad]}: "
                             f"{bad[:2]}")
    return res


def compile_ep_plan():
    """A plan of the serving mix with the EP all-to-all
    (``serve_mix(moe=True)``) on the scrambled 8-node Clos fabric for an
    ``(8,)`` data mesh; its all-to-all entry, the mesh placement and the
    shift order ``arm_ep`` must arm (the entry's node order in axis-index
    space)."""
    from repro_torch.fabric import make_datacenter, probe_fabric, scramble
    from repro_torch.plan import PlanCompiler
    from repro_torch.session import serve_mix

    fab, _ = scramble(make_datacenter(RANKS, **PLAN_FABRIC), seed=PLAN_SCRAMBLE_SEED)
    plan = PlanCompiler(fabric=fab, seed=0).compile(
        probe_fabric(fab, seed=PLAN_PROBE_SEED),
        serve_mix(EP_PAYLOAD, moe=True), mesh_shape=(RANKS,),
        axis_names=("data",))
    entry = max((e for (op, _b, grp), e in plan.entries.items()
                 if op == "all-to-all" and len(grp) == RANKS),
                key=lambda e: e.size_bytes)
    flat = [int(i) for i in plan.mesh_plan.flat]
    want = tuple(flat.index(int(node)) for node in entry.perm)
    return plan, entry, flat, want


def _ep_layer(cfg, seed: int, experts) -> dict:
    """One MoE layer of ``cfg`` holding ``experts``: the f32 router, and
    each expert's ``w1``/``w3``/``w2`` drawn from its own seed at the
    spec's scale, so a process holding two experts and one holding all
    sixteen hold the same values."""
    import torch

    from repro_torch.models import layers as L

    spec = L.moe_spec(cfg)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape, (_, scale), rdt = spec["router"]
    p = {"router": L.dense_init(gen, shape, scale, rdt)}
    if "shared" in spec:
        p["shared"] = L.init_from_spec(gen, spec["shared"], dtype)
    experts = list(experts)
    for k in ("w1", "w3", "w2"):
        p[k] = torch.empty((len(experts), *spec[k][0][1:]), dtype=dtype,
                           device="cuda")
    for i, e in enumerate(experts):
        gen.manual_seed(seed * 1000 + 1 + e)
        for k in ("w1", "w3", "w2"):
            shape, (_, scale) = spec[k][:2]
            p[k][i] = L.dense_init(gen, shape[1:], scale, dtype)
    return p


def _ep_input(cfg, seed: int):
    """``[RANKS, EP_GROUP_SEQ, D]`` layer inputs from ``seed``, one row a
    process."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 7)
    return torch.randn((RANKS, EP_GROUP_SEQ, cfg.d_model), generator=gen,
                       device="cuda").to(getattr(torch, cfg.dtype))


def _ep_cot(cfg, seed: int):
    """``[RANKS, EP_GROUP_SEQ, D]`` f32 cotangents of the layer's output."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 9)
    return torch.randn((RANKS, EP_GROUP_SEQ, cfg.d_model), generator=gen,
                       device="cuda")


EP_GRAD_LEAVES = ("w1", "w3", "w2")


def _group_ep(rank: int, seed: int, ep_plan, out_dir: str) -> dict:
    """This process's EP rank of one dbrx-132b MoE layer at published
    widths, armed over the group from the plan: its row of tokens, its
    two experts; the layer once checked and twice timed.  Rank 0 gathers
    the rows in EP rank order and holds them, and the aux loss, bit for
    bit to ``moe_a2a`` on the virtual mesh (all sixteen experts, the same
    plan's order), and reports its drops and time.  Then phase 19 (e):
    the layer's backward over the group (each all-to-all's transpose),
    every process's gradients of its input row, its router and its two
    experts saved to ``out_dir``; rank 0 holds them to the virtual mesh's
    backward on the same loss."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import make_planned_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel import moe_a2a

    plan, _entry, _flat, want = ep_plan
    cfg = get_config(MOE_ARCH)
    E_loc = cfg.n_experts // RANKS
    mesh = make_planned_mesh(plan, "cuda", group=dist.group.WORLD)
    moe_a2a.arm_ep(mesh, "data", None, plan=plan)
    try:
        r = moe_a2a.ep_rank()
        order = moe_a2a._EP_STATE["a2a_order"]
        p = _ep_layer(cfg, seed, range(r * E_loc, (r + 1) * E_loc))
        x = _ep_input(cfg, seed)[r:r + 1].clone()
        walls = []
        with torch.inference_mode():
            y, aux = L.moe_layer(p, x, cfg)
            torch.cuda.synchronize()
            for _ in range(2):
                dist.barrier()
                t0 = time.perf_counter()
                y2, _ = L.moe_layer(p, x, cfg)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        # (e) the backward: every process runs it, its all-to-alls'
        # transposes being collectives
        pg = {k: v.detach().requires_grad_() for k, v in p.items()}
        xg = x.clone().requires_grad_()
        cot = _ep_cot(cfg, seed)[r:r + 1]
        dist.barrier()
        t0 = time.perf_counter()
        yb, ab = L.moe_layer(pg, xg, cfg)
        ((yb.float() * cot).sum() + ab).backward()
        torch.cuda.synchronize()
        backward_ms = (time.perf_counter() - t0) * 1e3
        torch.save({"input": xg.grad.cpu(), "router": pg["router"].grad.cpu(),
                    **{k: pg[k].grad.cpu() for k in EP_GRAD_LEAVES}},
                   os.path.join(out_dir, f"ep_grad{r}.pt"))
        del pg, xg, yb, ab, cot
    finally:
        moe_a2a.clear_ep()
    res = {"rank": rank, "ep_rank": r, "order": list(order),
           "wall_ms": walls, "repeat_equal": bool(torch.equal(y, y2)),
           "forward_backward_ms": backward_ms}
    del p, y2
    got = [None] * RANKS if rank == 0 else None
    dist.gather_object((r, y.cpu(), aux.item()), got, dst=0)
    del x, y
    _free()
    if rank != 0:
        return res
    blocks = dict((i, (yb, a)) for i, yb, a in got)
    p = _ep_layer(cfg, seed, range(cfg.n_experts))
    x_all = _ep_input(cfg, seed)
    moe_a2a.arm_ep(make_planned_mesh(plan, "cuda"), "data", None, plan=plan)
    try:
        with torch.inference_mode():
            y_v, aux_v = moe_a2a.moe_a2a(p, x_all, cfg)
            virtual_ms = _time_ms(lambda: L.moe_layer(p, x_all, cfg), 2,
                                  warmup=1)
            drops = _a2a_drops(p, x_all, cfg, RANKS)
            dense = _dense_drops(p, x_all, cfg)
    finally:
        moe_a2a.clear_ep()
    res["grad"] = _ep_grads_against_virtual(cfg, seed, plan, p, x_all, out_dir)
    y_g = torch.cat([blocks[i][0] for i in range(RANKS)]).to(y_v.device)
    aux_g = torch.tensor([blocks[i][1] for i in range(RANKS)],
                         dtype=torch.float32)
    res.update(want_order=list(want), bit_for_bit=bool(torch.equal(y_g, y_v)),
               relative=_rel(y_g, y_v),
               aux_equal=bool(aux_g.eq(aux_v.cpu()).all()),
               finite=bool(torch.isfinite(y_g.float()).all()),
               virtual_ms=virtual_ms, drops_source=drops[0],
               drops_destination=drops[1], dense_drops=dense,
               choices=RANKS * EP_GROUP_SEQ * cfg.moe_top_k)
    del p, x_all, y_v, y_g
    _free()
    return res


def _ep_grads_against_virtual(cfg, seed: int, plan, p, x_all, out_dir: str
                              ) -> dict:
    """Phase 19 (e) at rank 0: the virtual mesh's backward of the group's
    loss (all sixteen experts, the plan's order), and every process's
    saved gradients against it, each relative to its largest entry: its
    input row and its two experts one by one, the processes' own router
    gradients summed.  The controls: each row's (or expert's) gradient
    against the next EP rank's, the cotangents sent back to the wrong
    rank; the router's sum with one process's left out."""
    import torch

    from repro_torch.launch import make_planned_mesh
    from repro_torch.parallel import moe_a2a

    E_loc = cfg.n_experts // RANKS
    pv = {k: v.detach().requires_grad_() for k, v in p.items()}
    xv = x_all.clone().requires_grad_()
    moe_a2a.arm_ep(make_planned_mesh(plan, "cuda"), "data", None, plan=plan)
    try:
        yv, av = moe_a2a.moe_a2a(pv, xv, cfg)
        ((yv.float() * _ep_cot(cfg, seed)).sum() + av).backward()
    finally:
        moe_a2a.clear_ep()
    del yv, av
    want = {k: pv[k].grad for k in ("router",) + EP_GRAD_LEAVES}
    want["input"] = xv.grad
    rel = {"input": [], "experts": [], "control_input": [],
           "control_experts": []}
    equal = {"input": True, "experts": True}
    routers = []
    for r in range(RANKS):
        got = torch.load(os.path.join(out_dir, f"ep_grad{r}.pt"))
        nxt = (r + 1) % RANKS
        g = got["input"].cuda()
        equal["input"] &= bool(torch.equal(g, want["input"][r:r + 1]))
        rel["input"].append(_rel(g, want["input"][r:r + 1]))
        rel["control_input"].append(_rel(g, want["input"][nxt:nxt + 1]))
        for k in EP_GRAD_LEAVES:
            g = got[k].cuda()
            mine = want[k][r * E_loc:(r + 1) * E_loc]
            theirs = want[k][nxt * E_loc:(nxt + 1) * E_loc]
            equal["experts"] &= bool(torch.equal(g, mine))
            rel["experts"].append(_rel(g, mine))
            rel["control_experts"].append(_rel(g, theirs))
        routers.append(got["router"].cuda())
        del got, g
    router = torch.stack(routers).sum(0)
    res = {"bit_for_bit": equal,
           "input": max(rel["input"]), "experts": max(rel["experts"]),
           "router_sum": _rel(router, want["router"]),
           "control_input": min(rel["control_input"]),
           "control_experts": min(rel["control_experts"]),
           "control_router": _rel(router - routers[-1], want["router"])}
    res["worst"] = max(res["input"], res["experts"], res["router_sum"])
    res["control"] = min(res["control_input"], res["control_experts"],
                         res["control_router"])
    del pv, xv, want, router, routers
    _free()
    return res


def _group_ep_report(per_rank: list, card: str) -> dict:
    rows = sorted((r["ep"] for r in per_rank), key=lambda e: e["ep_rank"])
    head = next(e for e in rows if e["rank"] == 0)
    want = head["want_order"]
    wall_ms = [max(e["wall_ms"][c] for e in rows) for c in range(2)]
    res = {"arch": MOE_ARCH, "ep_ranks": RANKS, "tokens": RANKS * EP_GROUP_SEQ,
           "ep_rank_by_rank": {e["rank"]: e["ep_rank"] for e in rows},
           "order": want, "bit_for_bit": head["bit_for_bit"],
           "relative": head["relative"], "aux_equal": head["aux_equal"],
           "wall_ms": wall_ms, "virtual_ms": head["virtual_ms"],
           "drops": {"a2a_source": head["drops_source"],
                     "a2a_destination": head["drops_destination"],
                     "dense": head["dense_drops"]},
           "choices": head["choices"], "card": card}
    _say(f"EP all-to-all over {RANKS} gloo processes ({MOE_ARCH}, one MoE "
         f"layer, {RANKS} x {EP_GROUP_SEQ} tokens, 2 experts a process, shift "
         f"order {want}): the rows == the virtual mesh's moe_a2a bit for bit: "
         f"{head['bit_for_bit']} (relative {head['relative']:.3g}), aux equal "
         f"{head['aux_equal']}; drops at the source {head['drops_source']}, "
         f"at the destination {head['drops_destination']} (moe_dense "
         f"{head['dense_drops']}) of {head['choices']} choices; the layer "
         f"{wall_ms[1]:.1f} ms of wall time over the group (first "
         f"{wall_ms[0]:.1f} ms), {head['virtual_ms']:.3f} ms on the virtual "
         f"mesh [{card}; host clock for the group, CUDA events for the "
         f"virtual layer]")
    if [e["ep_rank"] for e in rows] != list(range(RANKS)):
        raise AssertionError(f"EP ranks {[e['ep_rank'] for e in rows]}")
    if any(e["order"] != want for e in rows):
        raise AssertionError(f"a process armed another shift order than the "
                             f"plan's {want}: {[e['order'] for e in rows]}")
    if not (head["bit_for_bit"] and head["aux_equal"] and head["finite"]
            and all(e["repeat_equal"] for e in rows)):
        raise AssertionError(f"the EP all-to-all over the group parts from "
                             f"the virtual mesh's: {head}")
    grad = head["grad"]
    res["backward"] = dict(grad, bound=EP_GROUP_GRAD_BOUND, forward_backward_ms=[
        e["forward_backward_ms"] for e in rows])
    _say(f"EP backward over {RANKS} gloo processes (phase 19 e): bit for bit "
         f"{grad['bit_for_bit']}; relative to the virtual mesh's: input "
         f"{grad['input']:.3g}, experts {grad['experts']:.3g}, the processes' "
         f"router gradients summed {grad['router_sum']:.3g} (bound "
         f"{EP_GROUP_GRAD_BOUND}; controls: the next rank's input "
         f"{grad['control_input']:.3g}, experts {grad['control_experts']:.3g}, "
         f"a router sum missing one process {grad['control_router']:.3g}); "
         f"forward and backward {max(res['backward']['forward_backward_ms']):.1f} "
         f"ms of wall time [{card}]")
    _held_apart("EP backward over the group vs the virtual mesh", grad["worst"],
                EP_GROUP_GRAD_BOUND, grad["control"])
    return res


def run_group(seed: int, card: str, plan, planned: dict, port: dict) -> dict:
    """Phase 3b: the planned all-reduce over 8 processes on the one card,
    then the pipeline's f32 step and the EP all-to-all in those processes
    (``port``: the virtual pipeline's saved results, ``ref_dir``, and the
    serving plan with the all-to-all, ``ep_plan``).

    A gloo group over a file store (NCCL builds no multi-rank communicator
    on one GPU); every payload staged through pinned host memory; every
    reduce one ``fused_add`` launch on the card.  Position ``i`` runs in
    the process at group rank ``order[i]`` of the plan's mesh.  The
    kernels were built by the parent, so no two processes run ``nvcc``.
    """
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.train import certified_allreduce_pair

    red = planned["reducer"]
    sched = red.schedule
    pair = certified_allreduce_pair(RANKS, red.bucket_bytes, "ring",
                                    perm=sched.order,
                                    chunk_factor=sched.chunk_factor)
    if pair[1] != sched:
        raise AssertionError("the rebuilt (program, schedule) pair is not the "
                             "planned reducer's schedule")
    quantum = sched.n_chunks * max(1, sched.chunk_factor)
    jobs = []
    for dtype, item in (("bfloat16", 2), ("float32", 4)):
        small = GROUP_RANK_BYTES // item
        jobs.append((f"4 MiB a rank {dtype}", pair, small - small % quantum, dtype))
        jobs.append((f"largest bucket {dtype}", pair, max(planned["widths"]), dtype))
    tmp = tempfile.mkdtemp(prefix="repro_torch_group_")
    t0 = time.monotonic()
    ctx = mp.start_processes(_group_worker, nprocs=RANKS, join=False,
                             start_method="spawn",
                             args=(os.path.join(tmp, "store"), plan, jobs,
                                   tmp, seed, port))
    try:
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the group phase's {RANKS} processes did "
                                   f"not finish in {GROUP_TIMEOUT_S} s")
        wall = time.monotonic() - t0
        per_rank = []
        for r in range(RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                per_rank.append(json.load(f))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(30)
        shutil.rmtree(tmp, ignore_errors=True)
    results, total = [], 0
    for j, (label, _, width, dtype) in enumerate(jobs):
        rows = [per_rank[r]["jobs"][j] for r in range(RANKS)]
        launches = [row["launches"] for row in rows]
        if launches != [row["reduces"] for row in rows] or min(launches) < 1:
            raise AssertionError(f"group {label}: fused_add launches {launches}")
        total += sum(launches)
        # a call ends when its slowest process does
        wall_ms = [max(row["wall_ms"][c] for row in rows)
                   for c in range(GROUP_TIMED_CALLS)]
        share = [sum(row["stage_ms"][c] for row in rows)
                 / sum(row["wall_ms"][c] for row in rows)
                 for c in range(GROUP_TIMED_CALLS)]
        res = {"label": label, "elements_a_rank": width, "dtype": dtype,
               "launches_per_rank": launches, "wall_ms": wall_ms,
               "staging_share": share}
        results.append(res)
        _say(f"group {label} ({width} elements a rank, {RANKS} processes, "
             f"gloo, ring at {list(sched.order)}): rows == virtual-mesh runner "
             f"bit for bit; fused_add launches a rank {launches}; wall "
             f"{[round(v, 2) for v in wall_ms]} ms a call, staging copies "
             f"{[round(v, 3) for v in share]} of it [{card}]")
    res = {"jobs": results, "launches": {"fused_add": total},
           "order": list(sched.order), "wall_s": wall, "card": card,
           "pipeline": _group_pipeline_report(per_rank, card),
           "ep": _group_ep_report(per_rank, card)}
    _say(f"group phase: {RANKS} processes, {total} fused_add launches on the "
         f"card in the counted calls, {wall:.1f} s in all")
    _say("group " + json.dumps(res))
    return res


def _pipe_setup(seed: int):
    """The pipeline's model, weights and step from ``seed`` on the card:
    qwen2-0.5b in f32 (its 24 stacked blocks regrouped as ``PIPE_STAGES``
    stages), the step's tokens and labels as ``PIPE_MICRO`` microbatches
    of ``PIPE_ROWS`` x ``SEQ``, and their embeddings.  Every process of
    the group phase draws the same."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config(PIPE_ARCH), dtype="float32",
                              attention_impl="xla")
    model = DecoderLM(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = model.init(gen)
    per = cfg.n_layers // PIPE_STAGES
    staged = tree_map(lambda a: a.reshape(PIPE_STAGES, per, *a.shape[1:]),
                      params["blocks"])
    rng = np.random.default_rng(seed)
    shape = (PIPE_MICRO, PIPE_ROWS, SEQ)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).cuda()
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).cuda()
    with torch.no_grad():
        x = params["embed"][tokens]
    head = {"embed": params["embed"], "final_norm": params["final_norm"]}
    return SimpleNamespace(cfg=cfg, model=model, staged=staged, x=x,
                           labels=labels, head=head, per=per)


def _pipe_stage_fn(model, per: int, remat: bool):
    """``per`` blocks of ``model`` on a microbatch (the model's own block
    forward, each block checkpointed under grad as ``remat="block"``)."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from repro_torch.tree import tree_map

    def one(bp, h):
        pos = torch.arange(h.shape[1], device=h.device)
        return model._block_fwd(bp, h, pos)[0]

    def stage_fn(p, h):
        for j in range(per):
            bp = tree_map(lambda a: a[j], p)
            h = checkpoint(one, bp, h, use_reentrant=False) \
                if remat and torch.is_grad_enabled() else one(bp, h)
        return h

    return stage_fn


def _pipe_head(model, head):
    """The LM loss on the pipeline's output (the final norm, the tied head,
    cross entropy over all microbatches in sequence chunks of
    ``PIPE_LOSS_CHUNK``); the head's weights are not stage parameters and
    take no gradient."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import lm_loss

    cfg = model.cfg
    embed, norm = head["embed"].detach(), head["final_norm"].detach()

    def head_fn(y, labels):
        feats = L.rms_norm(y.reshape(-1, *y.shape[2:]), norm, cfg.norm_eps)
        return lm_loss(feats, embed.T, labels.reshape(-1, labels.shape[-1]),
                       PIPE_LOSS_CHUNK)

    return head_fn


def _rel(a, b) -> float:
    """max |a - b| relative to max |b|."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _pipe_sequence(stage_fn, staged, x, stages: int = PIPE_STAGES):
    """The first ``stages`` stages' blocks in sequence on the whole batch
    ``x [n_micro, rows, S, D]`` at once."""
    from repro_torch.tree import tree_map

    h = x.reshape(-1, *x.shape[2:])
    for i in range(stages):
        h = stage_fn(tree_map(lambda a, i=i: a[i], staged), h)
    return h.reshape(x.shape)


def pipeline_virtual(seed: int, card: str, ref_dir: str) -> dict:
    """The pipeline on the virtual mesh: qwen2-0.5b's 24 blocks as 8 stages
    of 3 over 8 microbatches of 2 x 1024 tokens.

    A bf16 forward with ``attention_impl="flash"``, counted (one
    ``flash_fwd_wgmma`` launch a block a microbatch), held to the same
    blocks run in sequence on the whole batch within ``PIPE_BF16_BOUND``
    of its largest output (the control: the sequence without its last
    stage); then ``pipeline_loss`` forward and backward in f32 on the plain
    attention path, every stage's gradient held to the sequential chain's
    within ``PIPE_GRAD_BOUND`` of its largest entry (the control: the chain
    on the first 7 microbatches, a lost drain tick).  The stages'
    gradients, the output and the loss go to ``ref_dir`` for the group
    phase.
    """
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import make_mesh
    from repro_torch.parallel.pipeline import pipeline_forward, pipeline_loss
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.monotonic()
    st = _pipe_setup(seed)
    cfg, per = st.cfg, st.per
    mesh = make_mesh((PIPE_STAGES,), ("stage",), device="cuda")
    model16 = type(st.model)(dataclasses.replace(
        cfg, dtype="bfloat16", attention_impl="flash"), device="cuda")
    staged16 = tree_map(lambda a: a.to(torch.bfloat16), st.staged)
    x16 = st.x.to(torch.bfloat16)
    fwd16 = _pipe_stage_fn(model16, per, remat=False)
    counted = _counted()
    with torch.inference_mode():
        pipeline_forward(fwd16, staged16, x16, mesh)          # warm-up
        torch.cuda.synchronize()
        for fn in counted.values():
            fn.launches = 0
        fa.flash_attention.kernel_launches = dict.fromkeys(fa.KERNELS, 0)
        y16 = pipeline_forward(fwd16, staged16, x16, mesh)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counted.items()}
        by_kernel = dict(fa.flash_attention.kernel_launches)
        want = cfg.n_layers * PIPE_MICRO
        if launches["flash_attention"] != want or \
                by_kernel["flash_fwd_wgmma"] != want:
            raise AssertionError(f"the pipeline's forward launched flash "
                                 f"{launches['flash_attention']} times "
                                 f"({by_kernel}), expected {want}, all "
                                 f"flash_fwd_wgmma")
        if tuple(y16.shape) != tuple(x16.shape) or \
                not bool(torch.isfinite(y16.float()).all()):
            raise AssertionError(f"the bf16 pipeline's output "
                                 f"{tuple(y16.shape)} is not finite or not "
                                 f"the microbatches' shape")
        seq16 = _pipe_sequence(fwd16, staged16, x16)
        bf16_rel = _rel(y16, seq16)
        bf16_control = _rel(_pipe_sequence(fwd16, staged16, x16,
                                           PIPE_STAGES - 1), seq16)
        fwd_ms = _time_ms(lambda: pipeline_forward(fwd16, staged16, x16, mesh),
                          2, warmup=0)
        seq_ms = _time_ms(lambda: _pipe_sequence(fwd16, staged16, x16), 2,
                          warmup=0)
    _held_apart("the bf16 pipeline vs the blocks in sequence (relative)",
                bf16_rel, PIPE_BF16_BOUND, bf16_control)
    del model16, staged16, x16, y16, seq16
    _free()

    # -- f32 loss forward and backward, plain attention ------------------
    fwd32 = _pipe_stage_fn(st.model, per, remat=True)
    head_fn = _pipe_head(st.model, st.head)

    def run(n_micro, pipelined):
        leaves = tree_map(lambda a: a.detach().requires_grad_(True), st.staged)
        x, labels = st.x[:n_micro], st.labels[:n_micro]
        t0 = time.monotonic()
        if pipelined:
            loss = pipeline_loss(fwd32, head_fn, leaves, x, labels, mesh)
        else:
            loss = head_fn(_pipe_sequence(fwd32, leaves, x), labels)
        loss.backward()
        torch.cuda.synchronize()
        return (loss.detach(), [t.grad for t in tree_leaves(leaves)],
                time.monotonic() - t0)

    run(PIPE_MICRO, True)                                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    loss, grads, step_s = run(PIPE_MICRO, True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    seq_loss, seq_grads, seq_step_s = run(PIPE_MICRO, False)
    grad_rel = max(_rel(g, w) for g, w in zip(grads, seq_grads))
    _, short_grads, _ = run(PIPE_MICRO - 1, False)
    grad_control = min(_rel(g, w) for g, w in zip(short_grads, seq_grads))
    del short_grads, seq_grads
    with torch.no_grad():
        y32 = pipeline_forward(fwd32, st.staged, st.x, mesh)
        out_rel = _rel(y32, _pipe_sequence(fwd32, st.staged, st.x))
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"the pipeline's loss {loss.item()} is not finite")
    _held_apart("the f32 pipeline's gradients vs the sequential chain's "
                "(relative, the worst tensor)", grad_rel, PIPE_GRAD_BOUND,
                grad_control)
    for i in range(PIPE_STAGES):
        torch.save([g[i].cpu() for g in grads],
                    os.path.join(ref_dir, f"stage{i}.pt"))
    torch.save({"y": y32.cpu(), "loss": loss.cpu()},
               os.path.join(ref_dir, "out.pt"))
    res = {"arch": PIPE_ARCH, "stages": PIPE_STAGES, "blocks_per_stage": per,
           "microbatches": PIPE_MICRO, "microbatch": [PIPE_ROWS, SEQ],
           "tokens": PIPE_MICRO * PIPE_ROWS * SEQ,
           "bf16_flash": {"launches": launches,
                          "flash_kernel_launches": by_kernel,
                          "relative_to_sequence": bf16_rel,
                          "limit": PIPE_BF16_BOUND,
                          "control_last_stage_dropped": bf16_control,
                          "forward_ms": fwd_ms, "sequence_ms": seq_ms},
           "f32": {"loss": loss.item(), "sequence_loss": seq_loss.item(),
                   "grad_relative": grad_rel, "grad_limit": PIPE_GRAD_BOUND,
                   "grad_control_7_of_8_microbatches": grad_control,
                   "output_relative": out_rel, "step_s": step_s,
                   "sequence_step_s": seq_step_s, "peak_mem_gb": peak_gb},
           "card": card}
    del grads, y32, st
    _free()
    res["phase_s"] = time.monotonic() - t_phase
    _say(f"pipeline {PIPE_ARCH} on the virtual mesh: {PIPE_STAGES} stages x "
         f"{per} blocks, {PIPE_MICRO} microbatches of {PIPE_ROWS} x {SEQ}; bf16 "
         f"flash forward {fwd_ms:.3f} ms (the blocks in sequence "
         f"{seq_ms:.3f} ms), {launches['flash_attention']} flash launches "
         f"({by_kernel}), within {bf16_rel:.4g} of the sequence (limit "
         f"{PIPE_BF16_BOUND}, control {bf16_control:.4g}); f32 loss "
         f"{loss.item():.6f} (sequence {seq_loss.item():.6f}), step "
         f"{step_s:.3f} s (sequence {seq_step_s:.3f} s), gradients within "
         f"{grad_rel:.4g} (limit {PIPE_GRAD_BOUND}, control "
         f"{grad_control:.4g}), peak {peak_gb:.3f} GB; phase "
         f"{res['phase_s']:.1f} s [{card}]")
    _say("pipeline " + json.dumps(res))
    return res


def check_compression(seed: int, card: str, layout: dict) -> dict:
    """Gradient compression on the training path's buckets: every bucket
    of qwen2-0.5b's gradients (``train_layout``) over the 8 virtual ranks,
    rank ``r``'s f32 rows at its own scale, through ``compressed_psum``
    (each rank's int8 quantization, the certified ring with ``fused_add``
    a reduce), its launches counted against the schedule's reduces, bit
    for bit against the run with plain ``+``, and within the f32 rounding
    of two summation orders of the dequantized rows' ``sum(0)`` (each
    element within ``2 (n - 1) u`` of the sum of the magnitudes, ``u =
    2^-24``); the control: one scale over the stacked ranks, outside it.
    Then error feedback over ``COMP_STEPS`` steps of one constant gradient
    at the largest bucket's width, as ``tests/test_substrate.py:71-82``."""
    import torch

    from repro_torch.kernels import ring_collective as rc
    from repro_torch.kernels.schedule_runner import schedule_tables
    from repro_torch.launch import make_mesh
    from repro_torch.optim import compression as C
    from repro_torch.train import certified_allreduce_pair

    t_phase = time.monotonic()
    mesh = make_mesh((RANKS,), ("data",), device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 11)
    scales = torch.logspace(-4, -2, RANKS, device="cuda")[:, None]
    u = 2.0 ** -24
    buckets, launches, reduces = [], 0, 0
    for b in layout["buckets"]:
        width = int(b.n_elems)
        x = torch.randn((RANKS, width), generator=gen, device="cuda") * scales
        sched = certified_allreduce_pair(RANKS, width * 4.0, "ring")[1]
        tables, ops = schedule_tables(sched)
        want_launches = sum(1 for rnd, rops in zip(tables, ops)
                            for (eff, _, _), op in zip(rnd, rops)
                            if op == "reduce" and eff) * max(1, sched.chunk_factor)
        before = rc.fused_add.launches
        got = C.compressed_psum(x, mesh)
        torch.cuda.synchronize()
        n_launch = rc.fused_add.launches - before
        if n_launch != want_launches:
            raise AssertionError(f"compressed_psum launched fused_add "
                                 f"{n_launch} times, the schedule has "
                                 f"{want_launches} reduces")
        ms = _time_ms(lambda: C.compressed_psum(x, mesh), 1, warmup=0)
        before = rc.fused_add.launches
        if not torch.equal(got, C.compressed_psum(x, mesh,
                                                  use_kernel_add=False)):
            raise AssertionError("compressed_psum with fused_add != with +")
        if rc.fused_add.launches != before:
            raise AssertionError("the plain-+ run launched fused_add")
        deq = torch.stack([C._dequantize(*C._quantize(r)) for r in x])
        want = deq.sum(0)
        room = 2 * (RANKS - 1) * u * deq.abs().sum(0)
        worst = max(float(((g - want).abs() / room.clamp_min(1e-30)).max())
                    for g in got)
        q, sc = C._quantize(x)
        one_scale = float(((C._dequantize(q, sc).sum(0) - want).abs()
                           / room.clamp_min(1e-30)).max())
        del deq, q, got, x
        _free()
        if worst > 1.0 or one_scale <= 1.0:
            raise AssertionError(f"compressed_psum's rows at {worst:.3g} of "
                                 f"the f32 rounding room (limit 1), one scale "
                                 f"over the ranks at {one_scale:.3g}")
        launches += n_launch
        reduces += want_launches
        buckets.append({"elements_a_rank": width, "fused_add": n_launch,
                        "ms": ms, "of_rounding_room": worst,
                        "one_scale_control": one_scale})
    width = max(int(b.n_elems) for b in layout["buckets"])
    g = {"w": torch.randn(width, generator=gen, device="cuda") * 1e-3}
    residual = C.error_feedback_update(g)
    acc = torch.zeros(width, device="cuda")
    t0 = time.monotonic()
    for _ in range(COMP_STEPS):
        q, sc, residual = C.compress_grads(g, residual)
        acc += C.decompress_grads(q, sc)["w"]
    torch.cuda.synchronize()
    ef_s = time.monotonic() - t0
    mean_err = float((acc / COMP_STEPS - g["w"]).abs().max())
    res_max = float(residual["w"].abs().max())
    del g, residual, acc, q
    if mean_err > 1e-4 or res_max >= 1e-3:
        raise AssertionError(f"error feedback: mean {mean_err:.3g} from the "
                             f"gradient (limit 1e-4), residual {res_max:.3g}")
    res = {"ranks": RANKS, "buckets": buckets,
           "launches": {"fused_add": launches}, "schedule_reduces": reduces,
           "error_feedback": {"width": width, "steps": COMP_STEPS,
                              "mean_max_abs_err": mean_err,
                              "residual_max": res_max, "seconds": ef_s},
           "card": card}
    _free()
    res["phase_s"] = time.monotonic() - t_phase
    _say(f"compressed_psum on {len(buckets)} qwen2-0.5b buckets x {RANKS} "
         f"virtual ranks: {launches} fused_add launches (the schedules' "
         f"{reduces} reduces), == the plain-+ run bit for bit, within "
         f"{max(b['of_rounding_room'] for b in buckets):.3g} of the f32 "
         f"rounding room of the rows' sum (one scale over the ranks: "
         f"{min(b['one_scale_control'] for b in buckets):.3g}); "
         f"{[round(b['ms'], 3) for b in buckets]} ms a call; error feedback "
         f"over {COMP_STEPS} steps at {width} elements: mean within "
         f"{mean_err:.3g}, residual {res_max:.3g}; phase {res['phase_s']:.1f} "
         f"s [{card}]")
    _say("compression " + json.dumps(res))
    return res


def _canonical_ring(perm) -> list:
    """A ring as a sequence from node 0 in its smaller direction."""
    p = [int(v) for v in perm]
    i = p.index(0)
    r = p[i:] + p[:i]
    return min(r, [r[0]] + r[1:][::-1])


def check_solver_eval(seed: int, card: str) -> dict:
    """The solver's batched evaluator on the card: the ring cost matrix of
    a ``SOLVER_NODES``-node datacenter at the training payload and a
    ``[SOLVER_CHAINS, SOLVER_NODES]`` batch of permutations, against
    numpy's f64 ``cost_batch`` (within ``N u`` relative, f32 sums of N
    positive terms); a call's host time (the permutations shipped, the
    costs back) and the gather and sum's device time beside numpy's host
    time; then ``solve_sa(backend="jax")`` against ``backend="numpy"`` on
    one seed and budget, each engine: both reported costs (f64), wall
    times, the evaluator's calls, and whether the tours agree."""
    import numpy as np
    import torch

    from repro_torch.core import cost_models as cm
    from repro_torch.core import solver as so
    from repro_torch.fabric import make_datacenter
    from repro_torch.kernels import solver_eval as se

    t_phase = time.monotonic()
    fab = make_datacenter(SOLVER_NODES, seed=seed)
    fabric_s = time.monotonic() - t_phase
    model = cm.make_cost_model("ring", lat=fab.lat, bw=fab.bw,
                               size_bytes=PLAN_PAYLOAD)
    c = so._ring_matrix(model)
    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(SOLVER_NODES)
                      for _ in range(SOLVER_CHAINS)])
    evaluate = se.make_ring_evaluator(c, device="cuda")
    got, want = evaluate(perms), model.cost_batch(perms)
    rel = float(np.max(np.abs(got - want) / want))
    bound = SOLVER_NODES * 2.0 ** -24
    if not np.all(np.isfinite(got)) or rel > bound:
        raise AssertionError(f"the evaluator on the card is {rel:.3g} from "
                             f"numpy's f64 costs (limit {bound:.3g})")
    t0 = time.perf_counter()
    for _ in range(20):
        evaluate(perms)
    call_ms = (time.perf_counter() - t0) / 20 * 1e3
    cd = torch.as_tensor(c.astype(np.float32), device="cuda")
    pd = torch.as_tensor(perms, device="cuda")
    device_ms = _time_ms(lambda: se._ring_cost(cd, pd), 20)
    t0 = time.perf_counter()
    for _ in range(5):
        model.cost_batch(perms)
    numpy_ms = (time.perf_counter() - t0) / 5 * 1e3
    del cd, pd

    calls = [0]
    real = se.make_ring_evaluator

    def counted(cmat, device="cuda"):
        fn = real(cmat, device)

        def call(p):
            calls[0] += 1
            return fn(p)
        return call

    solves = {}
    se.make_ring_evaluator = counted
    try:
        for engine, iters in SOLVER_ITERS.items():
            calls[0] = 0
            out = {}
            for backend in ("jax", "numpy"):
                t0 = time.perf_counter()
                r = so.solve_sa(model, iters=iters, chains=SOLVER_CHAINS,
                                seed=seed, engine=engine, backend=backend,
                                device="cuda")
                out[backend] = (r, time.perf_counter() - t0)
                if sorted(r.perm) != list(range(SOLVER_NODES)) or \
                        r.cost != float(model.cost(r.perm)):
                    raise AssertionError(f"solve_sa({backend}) reported "
                                         f"{r.cost}, not its tour's f64 cost")
            (a, ta), (b, tb) = out["jax"], out["numpy"]
            if calls[0] < 2:
                raise AssertionError(f"solve_sa(backend='jax') called the "
                                     f"evaluator {calls[0]} times")
            solves[engine] = {
                "iters": iters, "cost_jax": a.cost, "cost_numpy": b.cost,
                "wall_s_jax": ta, "wall_s_numpy": tb,
                "evaluator_calls": calls[0],
                "perms_equal": [int(v) for v in a.perm] ==
                [int(v) for v in b.perm],
                "same_ring": _canonical_ring(a.perm) == _canonical_ring(b.perm)}
    finally:
        se.make_ring_evaluator = real
    res = {"nodes": SOLVER_NODES, "chains": SOLVER_CHAINS,
           "payload_bytes": PLAN_PAYLOAD, "relative_to_f64": rel,
           "limit": bound, "evaluator_call_ms_host": call_ms,
           "gather_sum_ms_device": device_ms, "numpy_cost_batch_ms_host":
           numpy_ms, "fabric_s_host": fabric_s, "solve_sa": solves,
           "card": card}
    res["phase_s"] = time.monotonic() - t_phase
    _say(f"solver evaluator: {SOLVER_CHAINS} x {SOLVER_NODES} ring costs on "
         f"the card within {rel:.3g} of numpy's f64 (limit {bound:.3g}); a "
         f"call {call_ms:.3f} ms host clock (the gather and sum "
         f"{device_ms:.4f} ms of device time), numpy's cost_batch "
         f"{numpy_ms:.3f} ms host clock; solve_sa " + "; ".join(
             f"{e}: jax {v['cost_jax']:.6f} in {v['wall_s_jax']:.2f} s "
             f"({v['evaluator_calls']} evaluator calls), numpy "
             f"{v['cost_numpy']:.6f} in {v['wall_s_numpy']:.2f} s, tours "
             f"equal {v['perms_equal']} (same ring {v['same_ring']})"
             for e, v in solves.items())
         + f"; the fabric {fabric_s:.1f} s; phase {res['phase_s']:.1f} s "
         f"[{card}]")
    _say("solver " + json.dumps(res))
    return res


def check_peer_ring_kernel(seed: int, planned: dict) -> dict:
    """Phase 3: the peer-memory ring against its plain version, the virtual
    ring and the oracle; its times beside ``x.sum(0)``."""
    import numpy as np
    import torch

    from repro_torch.kernels import ring_collective as rc
    from repro_torch.kernels.ref import ring_reduce_scatter_ref

    order = list(planned["reducer"].schedule.order)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rng = np.random.default_rng(seed)

    def check(n, width, perm, dtype, label):
        x = torch.randn((n, width), generator=gen, device="cuda").to(dtype)
        got = rc.remote_ring_reduce_scatter(x, perm)
        torch.cuda.synchronize()
        if rc.ring_status() != 0:
            raise AssertionError(f"peer_ring {label}: status word "
                                 f"{rc.ring_status()} (a spin timed out)")
        for name, want in (("plain", rc.remote_ring_reduce_scatter_plain(x, perm)),
                           ("ring_reduce_scatter", rc.ring_reduce_scatter(x, perm))):
            if not torch.equal(got, want):
                bad = (got.float() - want.float()).abs().max().item()
                raise AssertionError(f"peer_ring {label}: != {name} (max abs "
                                     f"err {bad:.3e})")
        err = 0.0
        if dtype == torch.float32:
            ref = ring_reduce_scatter_ref(x, n)
            err = (got - ref).abs().max().item()
            tol = 1e-5 * n * x.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"peer_ring {label}: off the oracle by "
                                     f"{err:.3e} > {tol:.3e}")
            del ref
        del x, got
        return err

    fifo = {n: rc.ring_fifo(n) for n in (2, 3, 4, 8)}
    for n, info in fifo.items():
        _say(f"peer_ring FIFO at n={n}: {info['bytes']} bytes allocated "
             f"({info['blocks_per_rank']} blocks a rank x {info['slots']} slots "
             f"x {info['tile_bytes']}-byte tiles; one tile a handshake, W = 1)")
    if fifo[RANKS]["bytes"] > rc.RING_FIFO_BUDGET:
        raise AssertionError(f"peer_ring FIFO {fifo[RANKS]['bytes']} bytes > "
                             f"{rc.RING_FIFO_BUDGET}")
    cases = 0
    worst = 0.0
    for n in (2, 3, 4, 8):
        perms = [list(range(n)), list(range(n))[::-1],
                 [int(p) for p in rng.permutation(n)]]
        if n == len(order):
            perms.append(order)
        for width in (n * 7, n * 1031, n * 8 * 4099):    # odd chunk lengths
            for perm in perms:
                for dt in (torch.float32, torch.bfloat16):
                    worst = max(worst, check(n, width, perm, dt,
                                             f"n={n} L={width} perm={perm} {dt}"))
                    cases += 1
    for width in sorted(set(planned["widths"])):
        for dt in (torch.bfloat16, torch.float32):
            worst = max(worst, check(RANKS, width, order, dt,
                                     f"bucket [{RANKS}, {width}] {dt}"))
            cases += 1
        torch.cuda.empty_cache()
    # chunks below a tile and ragged against it; the bf16 scalar variant
    # (rows one element off 16 bytes); then 20 launches of mixed L, order
    # and dtype one after another on the same counters and FIFO
    tile = fifo[RANKS]["tile_bytes"] // 2
    for width in (8, tile - 8, tile + 8, 5 * tile + 40, 5 * tile + 3):
        worst = max(worst, check(RANKS, RANKS * width, order, torch.bfloat16,
                                 f"chunk {width} vs tile {tile}"))
        cases += 1
    for n in (2, 3, RANKS):
        buf = torch.randn(n * n * 4099 + 1, generator=gen,
                          device="cuda").to(torch.bfloat16)
        x = buf[1:].view(n, n * 4099)
        got = rc.remote_ring_reduce_scatter(x, list(range(n))[::-1])
        torch.cuda.synchronize()
        if rc.ring_status() != 0 or not torch.equal(
                got, rc.remote_ring_reduce_scatter_plain(x, list(range(n))[::-1])):
            raise AssertionError(f"peer_ring n={n}: the bf16 scalar path != plain")
        cases += 1
        del buf, x, got
    widths = [7, 1031, tile - 8, tile + 8, 3 * tile + 24, 8 * 4099, 131072]
    for k in range(20):
        perm = [int(p) for p in rng.permutation(RANKS)]
        dt = (torch.bfloat16, torch.float32)[k % 2]
        worst = max(worst, check(RANKS, RANKS * widths[k % len(widths)], perm,
                                 dt, f"sequence launch {k}"))
        cases += 1
    # a captured launch replayed on fresh data: the epochs come from the
    # counters on the device, so every replay must still be exact
    x = torch.empty((RANKS, RANKS * 8 * 4099), dtype=torch.bfloat16, device="cuda")
    x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rc.remote_ring_reduce_scatter(x, order)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rc.remote_ring_reduce_scatter(x, order)
    for rep in range(3):
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
        graph.replay()
        torch.cuda.synchronize()
        if rc.ring_status() != 0 or not torch.equal(
                out, rc.remote_ring_reduce_scatter_plain(x, order)):
            raise AssertionError(f"peer_ring: graph replay {rep} != plain")
    del graph, out, x
    _say(f"peer_ring == plain == ring_reduce_scatter bit for bit on {cases} "
         f"cases (n = 2, 3, 4, 8, odd chunk lengths, identity / reversed / "
         f"random / planned orders, the {len(set(planned['widths']))} bucket "
         f"shapes of the planned path, chunks below and ragged against a "
         f"tile, the bf16 scalar path, 20 launches of mixed L in a row; f32 "
         f"and bf16); f32 within {worst:.3e} of "
         f"ring_reduce_scatter_ref; a captured launch exact on 3 graph "
         f"replays of fresh data; status word 0 after every synchronise")

    largest = max(planned["widths"])
    times = {}
    for label, width, iters in (("largest", largest, 5),
                                ("4MB", 2 * 1024 * 1024, 20)):
        x = torch.randn((RANKS, width), generator=gen,
                        device="cuda").to(torch.bfloat16)
        kernel = _graph_ms(lambda: rc.remote_ring_reduce_scatter(x, order), iters)
        torch.cuda.synchronize()
        if rc.ring_status() != 0:
            raise AssertionError("peer_ring: status word set while timing")
        plain = _time_ms(lambda: rc.remote_ring_reduce_scatter_plain(x, order),
                         3, warmup=1)
        lib = _graph_ms(lambda: x.sum(0).view(RANKS, width // RANKS), iters)
        ring_b, fn_b = rc.ring_work(RANKS, width, 2)
        times[label] = {
            "shape": [RANKS, width], "ms": kernel, "plain_ms": plain,
            "library_ms": lib, "ring_bytes": ring_b, "function_bytes": fn_b,
            "ring_bound_ms": ring_b / HBM_BYTES_PER_S * 1e3,
            "bound_ms": fn_b / HBM_BYTES_PER_S * 1e3,
        }
        _say(f"peer_ring bf16 [{RANKS}, {width}] order {order}: kernel "
             f"{kernel:.4f} ms (CUDA-graph replay), plain {plain:.4f} ms, "
             f"x.sum(0) {lib:.4f} ms; the ring's bytes {ring_b} -> "
             f"{times[label]['ring_bound_ms']:.4f} ms, the function's {fn_b} -> "
             f"{times[label]['bound_ms']:.4f} ms at 3.35 TB/s")
        del x
        torch.cuda.empty_cache()
    step_ring = sum(rc.ring_work(RANKS, w, 2)[0] for w in planned["widths"])
    _say(f"peer_ring: one training step's {len(planned['widths'])} calls move "
         f"{step_ring} bytes in the ring, "
         f"{step_ring / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s")
    big = times["largest"]
    return {
        "name": "peer_ring",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/peer_ring.cu",
        "replaces": "src/repro/kernels/ring_collective.py:210",
        "launches": None,            # filled from the planned training run
        "max_abs_err": 0.0,          # bit-equal to the plain version above
        "max_abs_err_vs_ref_f32": worst,
        "shape": big["shape"],
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        # the function's bytes: x read once, the output written once
        "bound_ms": big["bound_ms"], "bound_by": "bytes",
        "ring_bound_ms": big["ring_bound_ms"],
        "library_ms": big["library_ms"],   # x.sum(0) on the same tensor
        "ms_4mb": times["4MB"]["ms"], "plain_ms_4mb": times["4MB"]["plain_ms"],
        "library_ms_4mb": times["4MB"]["library_ms"],
        "bound_ms_4mb": times["4MB"]["bound_ms"],
        "ring_bound_ms_4mb": times["4MB"]["ring_bound_ms"],
        "step_ring_bound_ms": step_ring / HBM_BYTES_PER_S * 1e3,
        "timing": "CUDA-graph replay (kernel, x.sum(0)); CUDA events (plain)",
    }


def train_cli_full_width(card: str, shapes, argv=TRAIN_CLI,
                         arch: str = TRAIN_ARCH) -> dict:
    """Phases 8 and 12: ``python -m repro_torch train`` at full width, in
    process (``argv``; ``shapes`` the model's parameters on the meta
    device, for its buckets).

    Every launch count zeroed just before ``cli.main`` and read just
    after; the reducer's calls timed with CUDA events by a spy on
    ``OverlapGradReducer.__call__`` that calls through; the checkpoint
    written under a temporary directory, measured, then deleted.
    """
    import contextlib
    import io
    import math
    import shutil
    import tempfile

    import torch

    from repro_torch import cli
    from repro_torch.kernels import ring_collective as rc
    from repro_torch.train import overlap_grads, partition_tree

    counted = _counted()
    events = []
    inner = overlap_grads.OverlapGradReducer.__call__

    def timed(self, stacked, compute=()):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(self, stacked, compute)
        end.record()
        events.append((start, end))
        return out

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_")
    argv = list(argv) + ["--ckpt-dir", ckpt_dir]
    _say("python -m repro_torch " + " ".join(argv))
    buf = io.StringIO()
    overlap_grads.OverlapGradReducer.__call__ = timed
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc_main = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        overlap_grads.OverlapGradReducer.__call__ = inner
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = buf.getvalue()
    for line in out.splitlines():
        _say("cli | " + line)
    if rc_main != 0:
        raise AssertionError(f"python -m repro_torch train exited {rc_main}")
    report = json.loads(out.split("[train] report ")[1].splitlines()[0])
    steps = report["steps"]
    reducer_ms = [s.elapsed_time(e) for s, e in events]
    buckets = len(partition_tree(shapes, report["bucket_bytes"]))
    if report["buckets"] != buckets or report["transport"] != "peer_ring":
        raise AssertionError(f"the CLI's reducer: {report['buckets']} buckets "
                             f"over {report['transport']}, expected {buckets} "
                             f"over peer_ring")
    if launches["peer_ring"] != buckets * steps or len(reducer_ms) != steps:
        raise AssertionError(f"peer_ring launched {launches['peer_ring']} times "
                             f"in {len(reducer_ms)} reducer calls, expected "
                             f"{buckets} x {steps}")
    if rc.ring_status() != 0:
        raise AssertionError("train CLI: the ring kernel's status word is set")
    losses = report["losses"]
    if not all(math.isfinite(v) for v in losses) or \
            not sum(losses[1:]) / (steps - 1) < losses[0]:
        raise AssertionError(f"train CLI: the loss did not fall: {losses}")
    ck = report["checkpoint"]
    res = {
        "argv": argv[:-2], "plan_digest": report["plan_digest"],
        "algorithm": report["algorithm"], "order": report["order"],
        "mesh_order": report["mesh_order"],
        "bucket_bytes": report["bucket_bytes"], "buckets": buckets,
        "losses": losses, "step_ms": [v * 1e3 for v in report["step_s"]],
        "tokens_per_s": [report["batch"] * report["seq"] / v
                         for v in report["step_s"]],
        "reducer_ms": reducer_ms, "launches": launches,
        "peak_mem_gb": peak_gb, "wall_s": wall,
        "checkpoint_bytes": ck["bytes"],
        "checkpoint_snapshot_s": ck["snapshot_s"],
        "checkpoint_write_s": ck["write_s"], "card": card,
    }
    _say(f"train CLI {arch}: plan {res['plan_digest']} {res['algorithm']} "
         f"order {res['order']} (mesh order {res['mesh_order']}), "
         f"{buckets} buckets of {res['bucket_bytes']:.0f} bytes; losses "
         f"{[round(v, 4) for v in losses]}; step "
         f"{[round(v, 1) for v in res['step_ms']]} ms; reducer "
         f"{[round(v, 2) for v in reducer_ms]} ms; peer_ring launches "
         f"{launches['peer_ring']} ({buckets} x {steps}); peak memory "
         f"{peak_gb:.3f} GB; checkpoint {ck['bytes']} bytes, snapshot "
         f"{ck['snapshot_s']:.3f} s, write {ck['write_s']:.3f} s; "
         f"{wall:.1f} s in all [{card}]")
    _say("train cli " + json.dumps(res))
    return res


def _tp_reckon(cfg, m: int, dp: int) -> dict:
    """Model-axis schedule runs of one sharded step, from the rules: a
    data-parallel rank's forward runs the embedding's all-reduce, each
    block's attention and MLP all-reduce where they shard, the loss's
    all-gather of logz and its gold all-reduce; its backward one
    all-reduce a column-parallel input (the attention's query input, its
    k and v too where the KV heads stay whole, the MLP's, the head's); the
    block's checkpoint recomputes up to the last tensor the backward saved,
    so the attention's all-reduce runs again and the MLP's, which ends the
    block, does not; then the clip's one all-reduce a step."""
    heads, kv = cfg.n_heads % m == 0, cfg.n_kv_heads % m == 0
    mlp, vocab = cfg.d_ff % m == 0, cfg.vocab_size % m == 0
    L = cfg.n_layers
    fwd = vocab + L * (heads + mlp) + vocab
    bwd = L * (heads * (1 + 2 * (not kv)) + mlp) + vocab
    return {"model_allreduce": dp * (fwd + bwd + L * heads) + 1,
            "model_allgather": dp * vocab, "data_allgather": int(dp > 1),
            "data_allreduce": int(dp > 1)}


def _cut_config(depth, dtype, arch=TRAIN_ARCH):
    """``repro_torch.configs.get_config`` with ``arch`` cut to ``depth``
    blocks in ``dtype`` (None: as published), for the train command, which
    reads it at call time."""
    from repro_torch import configs

    base = configs.get_config

    def get(name):
        cfg = base(name)
        if name != arch:
            return cfg
        return dataclasses.replace(cfg, n_layers=depth or cfg.n_layers,
                                   dtype=dtype or cfg.dtype)
    return base, get


def _tp_run(argv, refusal: str = "") -> dict:
    """One train command in process, launch counts zeroed just before and
    read just after, its checkpoint in a temporary directory.  Given
    ``refusal``, a ``ValueError`` whose words hold it is the command's
    outcome (its ``refusal``, no report) rather than a failure."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch import cli

    counted = _counted()
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_tp_")
    buf = io.StringIO()
    refused, rc_main = None, None
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            try:
                rc_main = cli.main(list(argv) + ["--ckpt-dir", ckpt_dir])
            except ValueError as e:
                if not refusal or refusal not in str(e):
                    raise
                refused = str(e)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    out = buf.getvalue()
    for line in out.splitlines():
        if not line.startswith("[train] step"):
            _say("cli | " + line[:600])
    res = {"report": None, "refusal": refused, "launches": launches,
           "peak_mem_gb": peak_gb, "wall_s": wall, "stdout": out}
    if refused is None:
        if rc_main != 0:
            raise AssertionError(f"python -m repro_torch {' '.join(argv)} "
                                 f"exited {rc_main}")
        res["report"] = json.loads(
            out.split("[train] report ")[1].splitlines()[0])
    return res


def _tp_profiled_step(card: str) -> dict:
    """One sharded step of full-width qwen2-0.5b on the 4x2 mesh, built
    as the train command builds it, after a warm-up step: the step timed
    with CUDA events, each model-axis collective with CUDA events, all in
    one ``torch.profiler`` window."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, make_global_batch
    from repro_torch.launch import make_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import tensor as tpm
    from repro_torch.parallel.sharding import batch_spec
    from repro_torch.train import OverlapGradReducer, certified_allreduce
    from repro_torch.train.sharded_step import (
        init_sharded_state, make_sharded_train_step)

    cfg = get_config(TRAIN_ARCH)
    model = get_model(cfg, device="cuda")
    mesh = make_mesh((4, 2), ("data", "model"), device="cuda")
    bb = 4 * 1024 * 1024
    red = OverlapGradReducer(certified_allreduce(4, bb, "ring"), bb,
                             "bucketed", transport="peer_ring")
    step = make_sharded_train_step(model, AdamWConfig(lr=LR), mesh, red)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = init_sharded_state(model, gen, step.layout)
    ds = SyntheticLM(cfg.vocab_size, 64, 8, seed=0)
    state, _ = step(state, make_global_batch(ds, 0, mesh, batch_spec(mesh)))
    batch = make_global_batch(ds, 1, mesh, batch_spec(mesh))
    events = []
    inner = {"all_reduce": tpm.TensorParallel.all_reduce,
             "all_gather": tpm.TensorParallel.all_gather}

    def timed(name):
        def run(self, x):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner[name](self, x)
            end.record()
            events.append((name, start, end))
            return out
        return run

    held = {}

    def one():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        held["state"], held["metrics"] = step(state, batch)
        b.record()
        held["step"] = (a, b)

    for name in inner:
        setattr(tpm.TensorParallel, name, timed(name))
    try:
        prof = profile_window("tp step 4x2", one)
    finally:
        for name, fn in inner.items():
            setattr(tpm.TensorParallel, name, fn)
    torch.cuda.synchronize()
    step_ms = held["step"][0].elapsed_time(held["step"][1])
    coll_ms = sum(s.elapsed_time(e) for _, s, e in events)
    res = {"collectives": len(events),
           "by_kind": {k: sum(1 for n, *_ in events if n == k) for k in inner},
           "collective_ms": coll_ms, "step_ms_cuda_events": step_ms,
           "collective_share": coll_ms / step_ms,
           "loss": float(held["metrics"]["loss"]), "profile": prof,
           "card": card}
    del state, held
    return res


def train_tp_full_width(card: str) -> dict:
    """Phase 18: the tensor-parallel ZeRO-1 step through ``python -m
    repro_torch train`` at published widths, held to the data-parallel
    mesh and counted."""
    import math

    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.train import partition_tree
    from repro_torch.train.sharded_step import param_shapes

    t_phase = time.monotonic()
    runs = {}
    for label, mesh, steps, depth, dtype in TP_RUNS:
        base, cut = _cut_config(depth, dtype)
        configs.get_config = cut
        try:
            run = _tp_run(TP_CLI + ["--mesh", mesh, "--steps", str(steps)])
        finally:
            configs.get_config = base
        _free()
        rep = run["report"]
        cfg = cut(TRAIN_ARCH)
        m, dp = rep["model"], rep["dp"]
        buckets = len(partition_tree(param_shapes(get_model(cfg, "cuda")),
                                     rep["bucket_bytes"]))
        want = {"peer_ring": buckets * steps}
        if m > 1:
            per_step = _tp_reckon(cfg, m, dp)
            if rep["tp_collectives"] != {k: float(v) for k, v in per_step.items()}:
                raise AssertionError(f"{label}: collectives per step "
                                     f"{rep['tp_collectives']}, reckoned "
                                     f"{per_step}")
            want["fused_add"] = per_step["model_allreduce"] * (m - 1) * steps
        for k, v in want.items():
            if run["launches"][k] != v:
                raise AssertionError(f"{label}: {k} launched "
                                     f"{run['launches'][k]} times, reckoned {v}")
        if not all(math.isfinite(v) for v in rep["losses"]):
            raise AssertionError(f"{label}: losses {rep['losses']}")
        runs[label] = {"mesh": mesh, "depth": cfg.n_layers, "dtype": cfg.dtype,
                       "losses": rep["losses"],
                       "step_ms_host_clock": [v * 1e3 for v in rep["step_s"]],
                       "peak_mem_gb": run["peak_mem_gb"], "wall_s": run["wall_s"],
                       "launches": run["launches"], "reckoned": want,
                       "tp_collectives": rep["tp_collectives"],
                       "mesh_order": rep["mesh_order"],
                       "buckets": buckets, "model": m, "dp": dp}
    rel = {}
    for a, b, rtol, n in (("4x2", "8", TP_BF16_RTOL, 2),
                          ("2x4 depth 4", "8 depth 4", TP_BF16_RTOL, 2),
                          ("4x2 f32 depth 2", "8 f32 depth 2", TP_F32_RTOL, 1)):
        la, lb = runs[a]["losses"], runs[b]["losses"]
        rel[f"{a} vs {b}"] = [abs(x - y) / abs(y) for x, y in zip(la, lb)]
        if len(la) != n or max(rel[f"{a} vs {b}"]) > rtol:
            raise AssertionError(f"{a} against {b}: losses {la} and {lb}, "
                                 f"relative {rel[f'{a} vs {b}']} (limit {rtol})")
    prof = _tp_profiled_step(card)
    _free()
    res = {"runs": runs, "relative_loss_diff": rel, "profiled_step": prof,
           "phase_s": time.monotonic() - t_phase, "card": card}
    _say(f"tp: 4x2 losses {[round(v, 5) for v in runs['4x2']['losses']]} vs 8 "
         f"{[round(v, 5) for v in runs['8']['losses']]}; step ms (host clock) "
         f"4x2 {[round(v, 1) for v in runs['4x2']['step_ms_host_clock']]}, 8 "
         f"{[round(v, 1) for v in runs['8']['step_ms_host_clock']]}; fused_add "
         f"{runs['4x2']['launches']['fused_add']}, peer_ring "
         f"{runs['4x2']['launches']['peer_ring']}; model-axis collectives "
         f"{prof['collectives']} a step, {prof['collective_ms']:.2f} ms of "
         f"{prof['step_ms_cuda_events']:.2f} ms (CUDA events); "
         f"{res['phase_s']:.1f} s [{card}]")
    _say("tp " + json.dumps(res, default=float))
    return res


def _moe_reckon(cfg, d: int) -> dict:
    """The EP step's device memory from the config (nothing measured):
    the weights, the f32 AdamW moments, the experts' gradient once, the
    replicated leaves' gradient on each of the ``d`` data ranks and their
    mean; the checkpoint holds the weights and the moments."""
    from repro_torch.models import get_model
    from repro_torch.train.sharded_step import expert_leaves, param_shapes
    from repro_torch.tree import tree_leaves

    shapes = param_shapes(get_model(cfg, device="cpu"))
    leaves = list(zip(tree_leaves(shapes), expert_leaves(shapes)))
    n = sum(t.numel() for t, _ in leaves)
    w = sum(t.numel() * t.element_size() for t, _ in leaves)
    ex = sum(t.numel() * t.element_size() for t, e in leaves if e)
    rep = w - ex
    res = {"params": n, "expert_params": sum(t.numel() for t, e in leaves if e),
           "weights_gb": w / 1e9, "moments_gb": 8 * n / 1e9,
           "expert_grad_gb": ex / 1e9, "replicated_grad_gb": d * rep / 1e9,
           "mean_grad_gb": rep / 1e9, "checkpoint_gb": (w + 8 * n) / 1e9}
    res["total_gb"] = (res["weights_gb"] + res["moments_gb"]
                       + res["expert_grad_gb"] + res["replicated_grad_gb"])
    return res


def _host_room() -> dict:
    """The temporary directory's free disk and the host's available
    memory, in GB."""
    import shutil
    import tempfile

    avail = None
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024 / 1e9
    return {"tmp_free_gb": shutil.disk_usage(tempfile.gettempdir()).free / 1e9,
            "host_available_gb": avail}


def _token_losses(model, params, shards, ep: bool):
    """Every token's cross entropy ``[ranks, rows, S]`` (f32) and each
    rank's loss (its mean + 0.01 x the aux), under ``no_grad``: over the
    EP all-to-all of the ranks (``DecoderLM._blocks_ranks``, what
    ``loss_ranks`` runs), or each rank's shard alone (EP disarmed: the
    dense dispatch, its aux over its own shard)."""
    import torch

    from repro_torch.models import layers as L

    cfg = model.cfg
    S = shards[0]["tokens"].shape[1]
    positions = torch.arange(S, device="cuda")
    xs = [model._embed(params, b["tokens"], None) for b in shards]
    if ep:
        aux = torch.zeros((), device="cuda")
        for _, bp, _ in model._layer_list(params):
            xs, a = model._blocks_ranks([bp] * len(xs), xs, positions)
            aux = aux + a
        auxes = [aux] * len(xs)
    else:
        feats = [model._features(params, b["tokens"]) for b in shards]
        xs, auxes = [f[0] for f in feats], [f[1] for f in feats]
    head = model._head(params)
    per, losses = [], []
    for x, a, b in zip(xs, auxes, shards):
        if ep:
            x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = (x @ head).float()
        ce = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, b["labels"][..., None])[..., 0]
        per.append(ce)
        losses.append(float(ce.mean() + 0.01 * a))
    return torch.stack(per), losses


def _moe_step0(seed: int) -> dict:
    """Phase 19 (b): dbrx-132b cut to one block at the capacity factor
    E/K, on step 0's rows of the train command: the EP loss under
    ``no_grad`` (``loss_ranks``) against the dense per-rank path (EP
    disarmed, each rank's shard alone, its aux over its own shard: the
    reference's pmean of per-shard aux), and every token's loss, relative
    to the largest, held within ``TP_BF16_RTOL``; the control routes
    top-(K-1).  At random weights the mean loss moves little with the
    routing (any features give a loss near ln V), so the power is in the
    per-token losses."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, make_global_batch
    from repro_torch.launch import make_mesh
    from repro_torch.models import get_model
    from repro_torch.parallel import moe_a2a
    from repro_torch.parallel.sharding import batch_spec

    cfg = _no_drop(dataclasses.replace(get_config(MOE_ARCH),
                                       n_layers=MOE_TRAIN_DEPTH))
    model = get_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = model.init(gen)
    mesh = make_mesh((MOE_TRAIN_RANKS,), ("data",), device="cuda")
    batch = make_global_batch(SyntheticLM(cfg.vocab_size, 64, 8, seed=0), 0,
                              mesh, batch_spec(mesh))
    shards = [{k: torch.as_tensor(v[r], device="cuda").long()
               for k, v in batch.items()} for r in range(MOE_TRAIN_RANKS)]
    with torch.no_grad():
        moe_a2a.clear_ep()
        dense_tok, dense = _token_losses(model, params, shards, ep=False)
        moe_a2a.arm_ep(mesh, "data", None)
        try:
            ep = float(torch.stack(model.loss_ranks(
                [params] * MOE_TRAIN_RANKS, shards)).mean())
            ep_tok, ep_ranks = _token_losses(model, params, shards, ep=True)
            ctl = get_model(dataclasses.replace(cfg, moe_top_k=cfg.moe_top_k - 1),
                            device="cuda")
            ctl_tok, ctl_ranks = _token_losses(ctl, params, shards, ep=True)
        finally:
            moe_a2a.clear_ep()
    d = sum(dense) / len(dense)
    res = {"dense": d, "ep": ep, "ep_by_ranks": sum(ep_ranks) / len(ep_ranks),
           "relative": abs(ep - d) / abs(d),
           "control_top_k_minus_1": sum(ctl_ranks) / len(ctl_ranks),
           "token_relative": _rel(ep_tok, dense_tok),
           "control_token_relative": _rel(ctl_tok, dense_tok),
           "bound": TP_BF16_RTOL, "capacity_factor": cfg.capacity_factor}
    res["control_relative"] = abs(res["control_top_k_minus_1"] - d) / abs(d)
    del params, model
    return res


def _moe_tp_layer(seed: int, card: str) -> dict:
    """Phase 19 (c): one dbrx-132b MoE layer at published widths on a 4x2
    (data, model) mesh, its experts in model-axis storage and gathered
    over the model axis, against the same layer on (4,), at E/K, forward
    and backward; the outputs and the gradients of the experts, the router
    and the input, each relative to its largest entry; ``fused_add``
    counted against the reckoning of the reduce-scatters' and the router
    all-reduces' reduce steps; the control drops one model rank's share
    from the reduce-scatters' sums."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ring_collective as rc
    from repro_torch.launch import make_mesh
    from repro_torch.parallel import moe_a2a
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor as tpm

    cfg = _no_drop(get_config(MOE_ARCH))
    d, m = 4, 2
    p = _ep_layer(cfg, seed, range(cfg.n_experts))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 11)
    dtype = getattr(torch, cfg.dtype)
    x = torch.randn((MOE_TP_ROWS, MOE_TP_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(dtype)
    cot = torch.randn(x.shape, generator=gen, device="cuda")

    def run(params, tp):
        xg = x.clone().requires_grad_()
        y, _ = moe_a2a.moe_a2a(params, xg, cfg, tp) if tp is not None else \
            moe_a2a.moe_a2a(params, xg, cfg)
        (y.float() * cot).sum().backward()
        return y.detach(), xg.grad

    names = ("w1", "w3", "w2", "router")
    moe_a2a.arm_ep(make_mesh((d,), ("data",), device="cuda"), "data", None)
    try:
        for t in p.values():
            t.requires_grad_()
        t0 = time.monotonic()
        y4, gx4 = run(p, None)
        torch.cuda.synchronize()
        one_axis_s = time.monotonic() - t0
        want = {k: p[k].grad for k in names}
        mesh = make_mesh((d, m), ("data", "model"), device="cuda")
        moe_a2a.arm_ep(mesh)
        pspecs = shd.param_pspecs({"moe": p}, cfg, mesh)["moe"]
        storage = {k: v.detach().requires_grad_() for k, v in tpm.shard_params(
            {k: v.detach() for k, v in p.items()}, pspecs, m).items()}
        del p
        _free()
        tp = tpm.TensorParallel(mesh, pspecs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rc.fused_add.launches = 0
        t0 = time.monotonic()
        y2, gx2 = run(storage, tp)
        torch.cuda.synchronize()
        two_axis_s = time.monotonic() - t0
        launches = rc.fused_add.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        got = tpm.unshard_params({k: storage[k].grad for k in names},
                                 {k: pspecs[k] for k in names})
        rel = {"output": _rel(y2, y4), "input_grad": _rel(gx2, gx4)}
        rel.update({f"{k}_grad": _rel(got[k], want[k]) for k in names})
        counts = dict(tp.counts)
        # the control: the reduce-scatters lose model rank 1's share
        real = tpm.TensorParallel.reduce_scatter

        def lossy(self, parts):
            parts = parts.clone()
            parts[1] = 0
            return real(self, parts)

        for t in storage.values():
            t.grad = None
        tpm.TensorParallel.reduce_scatter = lossy
        try:
            run(storage, tp)
        finally:
            tpm.TensorParallel.reduce_scatter = real
        bad = tpm.unshard_params({k: storage[k].grad for k in ("w1", "w3", "w2")},
                                 {k: pspecs[k] for k in ("w1", "w3", "w2")})
        control = max(_rel(bad[k], want[k]) for k in bad)
    finally:
        moe_a2a.clear_ep()
    # each data rank: one reduce-scatter a gathered expert leaf and one
    # all-reduce of the router's gradient, each m - 1 reduce steps
    reckoned = d * (3 + 1) * (m - 1)
    res = {"mesh": "4x2 against 4", "tokens": [MOE_TP_ROWS, MOE_TP_SEQ],
           "relative": rel, "worst": max(rel.values()),
           "control_experts_grad": control, "bound": MOE_TP_BOUND,
           "fused_add": launches, "fused_add_reckoned": reckoned,
           "collective_runs": counts, "peak_mem_gb": peak_gb,
           "layer_s_host_clock": {"4": one_axis_s, "4x2": two_axis_s},
           "card": card}
    del storage, want, got, bad, y4, y2, gx4, gx2
    _free()
    return res


def _moe_mla_layer(seed: int, card: str) -> dict:
    """Phase 19 (d): deepseek-v2-236b's MoE layer at published widths (160
    experts top-6, 2 shared) over 8 virtual EP ranks (20 experts each) at
    E/K, forward and backward, against the sum over the ranks of
    ``moe_scatter``'s gradient on each rank's shard (phase 13 holds
    ``moe_scatter`` to ``moe_dense`` at E/K), each leaf relative to its
    largest entry; the control is that sum with one rank's shard left
    out."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel import moe_a2a

    cfg = _no_drop(get_config(MLA_ARCH))
    n = RANKS
    p = _ep_layer(cfg, seed, range(cfg.n_experts))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 13)
    x = torch.randn((n, MOE_MLA_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(getattr(torch, cfg.dtype))
    cot = torch.randn(x.shape, generator=gen, device="cuda")
    for _, parent, key, t in list(_named_leaves(p)):
        parent[key] = t.requires_grad_()
    xg = x.clone().requires_grad_()
    moe_a2a.arm_ep(make_mesh((n,), ("data",), device="cuda"), "data", None)
    try:
        torch.cuda.reset_peak_memory_stats()
        y, aux = moe_a2a.moe_a2a(p, xg, cfg)
        ((y.float() * cot).sum() + aux).backward()
    finally:
        moe_a2a.clear_ep()
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {name: t.grad for name, _, _, t in _named_leaves(p)}
    want["input"] = xg.grad
    for _, parent, key, t in list(_named_leaves(p)):
        parent[key] = t.detach().requires_grad_()
    xs = x.clone().requires_grad_()

    def reading():
        got = {name: t.grad for name, _, _, t in _named_leaves(p)}
        got["input"] = xs.grad
        return {k: _rel(got[k], want[k]) for k in want}

    control = None
    for r in range(n):
        yr, ar = L.moe_scatter(p, xs[r:r + 1], cfg)
        ((yr.float() * cot[r:r + 1]).sum() + ar / n).backward()
        if r == n - 2:
            control = reading()
    sound = reading()
    res = {"ep_ranks": n, "experts_per_rank": cfg.n_experts // n,
           "tokens": [n, MOE_MLA_SEQ], "relative": sound,
           "worst": max(sound.values()),
           "control_one_shard_left_out": control,
           "control_worst": max(v for k, v in control.items() if k != "input"),
           "bound": MOE_MLA_BOUND, "peak_mem_gb": peak_gb, "card": card}
    del p, want, x, xs, xg, y
    _free()
    return res


def train_moe_full_width(seed: int, card: str) -> dict:
    """Phase 19: MoE training.  (a) ``python -m repro_torch train --arch
    dbrx-132b --mesh 4`` in process at published widths cut to one block,
    bf16, its memory reckoned first; (b) the step-0 loss of the EP path
    against the dense per-rank path at E/K; (c) the model axis at full
    width; (d) deepseek-v2's MoE layer's gradient over 8 EP ranks.  (e),
    the group's backward, runs in the group phase."""
    import math

    import torch

    from repro_torch import configs, obs
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import partition_tree
    from repro_torch.train.sharded_step import expert_leaves, param_shapes
    from repro_torch.tree import tree_leaves

    t_phase = time.monotonic()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_DEPTH)
    reckon = _moe_reckon(cfg, MOE_TRAIN_RANKS)
    room = _host_room()
    _say(f"moe train: {MOE_ARCH} cut to {MOE_TRAIN_DEPTH} block, "
         f"{reckon['params']} parameters ({reckon['expert_params']} in the "
         f"experts): weights {reckon['weights_gb']:.2f} GB, AdamW moments "
         f"{reckon['moments_gb']:.2f} GB, the experts' gradient "
         f"{reckon['expert_grad_gb']:.2f} GB, the replicated gradients "
         f"{reckon['replicated_grad_gb']:.2f} GB over {MOE_TRAIN_RANKS} ranks: "
         f"{reckon['total_gb']:.2f} GB reckoned before AdamW's temporaries; "
         f"the checkpoint {reckon['checkpoint_gb']:.2f} GB against "
         f"{room['tmp_free_gb']:.1f} GB of free disk and "
         f"{room['host_available_gb']:.1f} GB of available host memory "
         f"[{card}]")
    if room["tmp_free_gb"] < 1.1 * reckon["checkpoint_gb"] or \
            room["host_available_gb"] < 1.1 * reckon["checkpoint_gb"]:
        raise AssertionError(f"the host cannot take the "
                             f"{reckon['checkpoint_gb']:.1f} GB checkpoint: "
                             f"{room}")
    # (a) the entry point, the all-to-all records counted
    rec = obs.recorder()
    was, before = rec.enabled, rec.captured
    rec.enabled = True
    base, cut = _cut_config(MOE_TRAIN_DEPTH, None, MOE_ARCH)
    configs.get_config = cut
    try:
        run = _tp_run(MOE_TRAIN_CLI)
        records = rec.trace().records
        ops = [r.op for r in records[len(records) - (rec.captured - before):]]
    finally:
        configs.get_config = base
        rec.enabled = was
    _free()
    rep = run["report"]
    shapes = param_shapes(get_model(cfg, device="cpu"))
    replicated = [t for t, e in zip(tree_leaves(shapes), expert_leaves(shapes))
                  if not e]
    buckets = len(partition_tree(replicated, rep["bucket_bytes"]))
    want_ring = buckets * MOE_TRAIN_STEPS
    a2a = ops.count("all-to-all")
    want_a2a = 2 * MOE_TRAIN_DEPTH * MOE_TRAIN_STEPS
    ep = rep["ep"]
    a = {"losses": rep["losses"],
         "step_ms_host_clock": [v * 1e3 for v in rep["step_s"]],
         "wall_s": run["wall_s"], "peak_mem_gb": run["peak_mem_gb"],
         "reckoned_gb": reckon["total_gb"], "launches": run["launches"],
         "peer_ring_reckoned": want_ring, "buckets": buckets,
         "bucket_bytes": rep["bucket_bytes"], "a2a_records": a2a,
         "a2a_records_reckoned": want_a2a, "a2a_order": ep["order"],
         "plan_entry_order": ep["plan_entry_order"],
         "choices": ep["choices"], "source_drops": ep["source_drops"],
         "destination_drops": ep["destination_drops"],
         "replicated_bytes": ep["replicated_bytes"],
         "checkpoint_bytes": rep["checkpoint"]["bytes"],
         "checkpoint_write_s": rep["checkpoint"]["write_s"],
         "checkpoint_snapshot_s": rep["checkpoint"]["snapshot_s"],
         "plan_digest": rep["plan_digest"], "mesh_order": rep["mesh_order"]}
    if not all(math.isfinite(v) for v in rep["losses"]) or \
            len(rep["losses"]) != MOE_TRAIN_STEPS:
        raise AssertionError(f"moe train: losses {rep['losses']}")
    if run["launches"]["peer_ring"] != want_ring:
        raise AssertionError(f"moe train: peer_ring launched "
                             f"{run['launches']['peer_ring']} times, reckoned "
                             f"{buckets} buckets x {MOE_TRAIN_STEPS} steps")
    if a2a != want_a2a:
        raise AssertionError(f"moe train: {a2a} all-to-all records, reckoned "
                             f"{want_a2a}")
    if ep["order"] is None or sorted(ep["order"]) != list(range(MOE_TRAIN_RANKS)) \
            or ep["plan_entry_order"] is None:
        raise AssertionError(f"moe train: no planned all-to-all order: {ep}")
    if ep["choices"] != MOE_TRAIN_STEPS * MOE_TRAIN_DEPTH * 8 * 64 * cfg.moe_top_k:
        raise AssertionError(f"moe train: {ep['choices']} choices routed")
    if run["peak_mem_gb"] < reckon["weights_gb"] + reckon["moments_gb"]:
        raise AssertionError(f"moe train: peak {run['peak_mem_gb']:.2f} GB "
                             f"below the state's reckoning")
    _say(f"moe train (a): losses {[round(v, 4) for v in rep['losses']]}, step "
         f"ms (host clock) {[round(v, 1) for v in a['step_ms_host_clock']]}; "
         f"all-to-all order {ep['order']} (the plan's entry "
         f"{ep['plan_entry_order']}); drops at the source "
         f"{ep['source_drops']}, at the destination {ep['destination_drops']} "
         f"of {ep['choices']} choices at capacity factor {cfg.capacity_factor}; "
         f"peer_ring {run['launches']['peer_ring']} = {buckets} buckets x "
         f"{MOE_TRAIN_STEPS} steps over the replicated leaves "
         f"({ep['replicated_bytes']} bytes); fused_add "
         f"{run['launches']['fused_add']}; {a2a} all-to-all records; peak "
         f"{run['peak_mem_gb']:.2f} GB against {reckon['total_gb']:.2f} GB "
         f"reckoned; checkpoint {a['checkpoint_bytes']} bytes written in "
         f"{a['checkpoint_write_s']:.1f} s [{card}]")
    # (b) the step-0 loss at E/K
    b = _moe_step0(seed)
    _free()
    _say(f"moe train (b): step-0 loss at E/K, EP {b['ep']:.5f} vs the dense "
         f"per-rank path {b['dense']:.5f}: relative {b['relative']:.3g} (bound "
         f"{b['bound']}; the top-(K-1) control {b['control_relative']:.3g}); "
         f"every token's loss relative to the largest {b['token_relative']:.3g} "
         f"(control {b['control_token_relative']:.3g})")
    if b["relative"] > b["bound"] or abs(b["ep_by_ranks"] - b["ep"]) > \
            b["bound"] * abs(b["ep"]):
        raise AssertionError(f"moe step-0 loss: {b}")
    _held_apart("moe step-0 token losses EP vs dense", b["token_relative"],
                b["bound"], b["control_token_relative"])
    # (c) the model axis at full width
    c = _moe_tp_layer(seed, card)
    _say(f"moe train (c): dbrx layer 4x2 vs 4 on {MOE_TP_ROWS} x {MOE_TP_SEQ} "
         f"tokens, relative {json.dumps({k: float(f'{v:.3g}') for k, v in c['relative'].items()})} "
         f"(bound {c['bound']}; control {c['control_experts_grad']:.3g}); "
         f"fused_add {c['fused_add']} (reckoned {c['fused_add_reckoned']}); "
         f"runs {c['collective_runs']}; peak {c['peak_mem_gb']:.2f} GB")
    _held_apart("moe 4x2 layer vs 4", c["worst"], c["bound"],
                c["control_experts_grad"])
    if c["fused_add"] != c["fused_add_reckoned"]:
        raise AssertionError(f"moe 4x2 layer: fused_add {c['fused_add']}, "
                             f"reckoned {c['fused_add_reckoned']}")
    # (d) deepseek-v2's MoE layer over 8 EP ranks
    dd = _moe_mla_layer(seed, card)
    _say(f"moe train (d): {MLA_ARCH} layer over {RANKS} EP ranks vs the sum of "
         f"moe_scatter's gradients, relative "
         f"{json.dumps({k: float(f'{v:.3g}') for k, v in dd['relative'].items()})} "
         f"(bound {dd['bound']}; control {dd['control_worst']:.3g}); peak "
         f"{dd['peak_mem_gb']:.2f} GB")
    _held_apart("deepseek EP layer gradient vs moe_scatter", dd["worst"],
                dd["bound"], dd["control_worst"])
    res = {"train": a, "step0": b, "tp_layer": c, "mla_layer": dd,
           "reckon": reckon, "host": room,
           "phase_s": time.monotonic() - t_phase, "card": card}
    _say("moe train " + json.dumps(res, default=float))
    return res


def _wrapped_ep_layer(seed: int, card: str) -> dict:
    """Phase 20 (b), the EP half: a session planned with ``moe=True`` for
    ``WRAP_EP_RANKS`` ranks (no mesh shape, so the order is the entry's
    ``local_perm``, as the reference's wrap test reads it); inside its
    ``wrap()`` an unmodified ``arm_ep`` call arms that order, and one
    full-width dbrx MoE layer run so is bit for bit the layer armed with
    ``plan=``."""
    import torch

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel import moe_a2a
    from repro_torch.session import Session, SessionConfig

    cfg = get_config(MOE_ARCH)
    scfg = SessionConfig.from_dict({
        "fabric": {"kind": "datacenter", "nodes": WRAP_EP_RANKS,
                   "scramble_seed": 1},
        "solver": {"budget": {"iters": 80, "chains": 2}},
        "payload_bytes": EP_PAYLOAD, "moe": True})
    p = _ep_layer(cfg, seed, range(cfg.n_experts))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 20)
    x = torch.randn((MOE_TP_ROWS, MOE_TP_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(getattr(torch, cfg.dtype))
    mesh = make_mesh((WRAP_EP_RANKS,), ("data",), device="cuda")
    rec = obs.recorder()
    was, before = rec.enabled, rec.captured
    rec.enabled = True
    try:
        with Session(scfg) as s:
            plan = s.plan()
            entry = max((e for (op, _b, grp), e in plan.entries.items()
                         if op == "all-to-all" and len(grp) == WRAP_EP_RANKS),
                        key=lambda e: e.size_bytes)
            with s.wrap(), torch.no_grad():
                moe_a2a.arm_ep(mesh, "data", None)      # no plan passed
                wrapped = moe_a2a._EP_STATE["a2a_order"]
                y_w, aux_w = L.moe_layer(p, x, cfg)
            moe_a2a.clear_ep()
            with torch.no_grad():
                moe_a2a.arm_ep(mesh, "data", None, plan=plan)
                explicit = moe_a2a._EP_STATE["a2a_order"]
                y_e, aux_e = L.moe_layer(p, x, cfg)
            torch.cuda.synchronize()
        records = rec.trace().records
        ops = [r.op for r in records[len(records) - (rec.captured - before):]]
    finally:
        moe_a2a.clear_ep()
        rec.enabled = was
    local = tuple(int(i) for i in entry.local_perm)
    res = {"wrapped_order": list(wrapped), "explicit_order": list(explicit),
           "entry_local_perm": list(local), "entry_perm": list(entry.perm),
           "bit_equal": bool(torch.equal(y_w, y_e)
                             and torch.equal(aux_w, aux_e)),
           "a2a_records": ops.count("all-to-all"),
           "output_max_abs": float(y_e.float().abs().max()), "card": card}
    if wrapped != local or explicit != local:
        raise AssertionError(f"wrapped arm_ep: {res}")
    if not res["bit_equal"] or res["a2a_records"] != 4:
        raise AssertionError(f"wrapped EP layer: {res}")
    return res


def _wrapped_production_mesh(card: str) -> dict:
    """Phase 20 (b), the mesh half: a session planned at the production
    shape ``(16, 16)`` on the simulated fleet (one small request: the mesh
    assignment is what this reads); inside ``wrap()``,
    ``make_production_mesh()`` is the plan's order on the card, and the
    card's allocated bytes do not move."""
    import torch

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.plan import CollectiveRequest, JobMix
    from repro_torch.session import Session, SessionConfig

    scfg = SessionConfig.from_dict({
        "fabric": {"kind": "tpu-fleet", "n_pods": 1, "pod_shape": [16, 16],
                   "scramble_seed": 0},
        "mesh": {"shape": [16, 16], "axis_names": ["data", "model"]},
        "probe": {"n_probes": 4},
        "solver": {"budget": {"iters": 20, "chains": 1}},
        "payload_bytes": 1e6})
    with Session(scfg) as s:
        plan = s.plan(mix=JobMix((CollectiveRequest("all-reduce", 1e6,
                                                    group=(0, 1)),)))
        want = tuple(int(i) for i in plan.mesh_plan.flat)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with s.wrap():
            mesh = mesh_mod.make_production_mesh()
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
    res = {"order_is_plans": mesh.order == want, "shape": list(mesh.shape),
           "axis_names": list(mesh.axis_names), "device": str(mesh.device),
           "identity": mesh.order == tuple(range(256)),
           "allocated_before": before, "allocated_after": after, "card": card}
    if not res["order_is_plans"] or res["identity"] or before != after or \
            mesh.shape != (16, 16) or mesh.device.type != "cuda":
        raise AssertionError(f"wrapped production mesh: {res}")
    return res


def _dense_ranks_layer(seed: int, card: str) -> dict:
    """Phase 20 (c): one dbrx-132b MoE layer at published widths (16
    experts top-4, the published capacity factor) on ``MOE_DP_RANKS``
    data ranks of ``MOE_DP_LAYER_ROWS // MOE_DP_RANKS`` rows x
    ``MOE_TP_SEQ`` tokens: ``moe_dense_ranks`` forward and backward, each
    rank its own view of the layer, its gradient a row of a ``[d, ...]``
    buffer as in the step, against ``moe_dense`` on the global batch.
    The outputs, the input's gradient and the ranks' summed gradients of
    the experts and the router, each relative to its largest entry; the
    aux relative to the reference's.  The controls: the mean of the
    ranks' own aux terms (each rank's routing shares), and the gradients
    summed over every rank but the last."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = get_config(MOE_ARCH)
    d = MOE_DP_RANKS
    rows = MOE_DP_LAYER_ROWS // d
    p = _ep_layer(cfg, seed, range(cfg.n_experts))
    if set(p) != {"router", "w1", "w3", "w2"}:
        raise AssertionError(f"moe dense (c): layer leaves {sorted(p)}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 21)
    x = torch.randn((MOE_DP_LAYER_ROWS, MOE_TP_SEQ, cfg.d_model), generator=gen,
                    device="cuda").to(getattr(torch, cfg.dtype))
    cot = torch.randn(x.shape, generator=gen, device="cuda")
    names = ("w1", "w3", "w2", "router")
    # the reference's fallback: moe_dense on the global batch
    for k in names:
        p[k].requires_grad_()
    xg = x.clone().requires_grad_()
    y, aux = L.moe_dense(p, xg, cfg)
    ((y.float() * cot).sum() + aux).backward()
    want = {k: p[k].grad for k in names}
    want["input"] = xg.grad
    y, aux = y.detach(), aux.detach()
    del xg
    base = {k: p[k].detach() for k in names}
    del p
    _free()
    # the step's fallback: each rank its own view, its gradient a row of
    # one [d, ...] buffer, the ranks in one graph
    bufs = {k: torch.zeros((d, *base[k].shape), dtype=base[k].dtype,
                           device="cuda") for k in names}
    views, xs = [], []
    for r in range(d):
        v = {}
        for k in names:
            v[k] = base[k].detach().requires_grad_()
            v[k].grad = bufs[k][r]          # backward accumulates in place
        views.append(v)
        xs.append(x[r * rows:(r + 1) * rows].clone().requires_grad_())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ys, aux_r = L.moe_dense_ranks(views, xs, cfg)
    (sum((yr.float() * cot[r * rows:(r + 1) * rows]).sum()
         for r, yr in enumerate(ys)) + aux_r).backward()
    torch.cuda.synchronize()
    layer_s = time.monotonic() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del views

    def summed(k, ranks):
        acc = bufs[k][0].float()
        for r in range(1, ranks):
            acc += bufs[k][r]
        return acc

    rel = {"output": _rel(torch.cat([yr.detach() for yr in ys]), y),
           "input_grad": _rel(torch.cat([xr.grad for xr in xs]),
                              want["input"])}
    rel.update({f"{k}_grad": _rel(summed(k, d), want[k]) for k in names})
    aux_rel = abs(aux_r.item() - aux.item()) / abs(aux.item())
    control_grad = max(_rel(summed(k, d - 1), want[k]) for k in names)
    # the control aux: each rank's term over its own routing shares
    with torch.no_grad():
        terms = []
        for xr in xs:
            _, _, me, ce = L._router_stats(base, L._dispatch_groups(xr, cfg),
                                           cfg)
            terms.append(cfg.n_experts * torch.sum(me * ce))
        control_aux = abs(torch.stack(terms).mean().item() - aux.item()) \
            / abs(aux.item())
    res = {"ranks": d, "tokens": [MOE_DP_LAYER_ROWS, MOE_TP_SEQ],
           "capacity_factor": cfg.capacity_factor, "relative": rel,
           "worst": max(rel.values()), "aux": aux.item(),
           "aux_relative": aux_rel, "control_aux_relative": control_aux,
           "control_grad_one_rank_left_out": control_grad,
           "bound": MOE_DP_LAYER_BOUND, "aux_bound": MOE_DP_AUX_BOUND,
           "peak_mem_gb": peak_gb, "layer_s_host_clock": layer_s,
           "card": card}
    del base, bufs, want, ys, xs, y, x, cot
    _free()
    return res


def _memory_line(run: dict) -> dict:
    """The data-parallel MoE step's reckoning, as the train command
    printed it (``[train] memory {...}``)."""
    line = run["stdout"].split("[train] memory ")[1].splitlines()[0]
    return json.loads(line)


def train_moe_dense_fallback(seed: int, card: str) -> dict:
    """Phase 20: MoE training where the data axis does not divide the
    experts (the reference's fallback to ``moe_dense``): the smoke run,
    the published run's reckoning, a run that fits held to its
    reckoning, the fallback's layer at published widths; then a wrapped
    session on the card (see the module docstring)."""
    import math

    from repro_torch import configs, obs
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import partition_tree
    from repro_torch.train.sharded_step import param_shapes
    from repro_torch.tree import tree_leaves

    t_phase = time.monotonic()
    # (a) the smoke dbrx on 8 data ranks: 4 experts, EP cannot arm
    rec = obs.recorder()
    was, before = rec.enabled, rec.captured
    rec.enabled = True
    try:
        smoke = _tp_run(MOE_DP_SMOKE_CLI)
        records = rec.trace().records
        ops = [r.op for r in records[len(records) - (rec.captured - before):]]
    finally:
        rec.enabled = was
    smoke["a2a_records"] = ops.count("all-to-all")
    rep = smoke["report"]
    scfg = dataclasses.replace(get_config(MOE_ARCH).smoke(), vocab_size=2048)
    leaves = tree_leaves(param_shapes(get_model(scfg, device="cpu")))
    buckets = len(partition_tree(leaves, rep["bucket_bytes"]))
    want_ring = buckets * MOE_DP_SMOKE_STEPS
    every = sum(t.numel() * t.element_size() for t in leaves)
    _say(f"moe dense (a): {MOE_ARCH} smoke on --mesh 8, losses "
         f"{[round(v, 4) for v in rep['losses']]}; peer_ring "
         f"{smoke['launches']['peer_ring']} = {buckets} buckets x "
         f"{MOE_DP_SMOKE_STEPS} steps over every leaf ({every} bytes), "
         f"fused_add {smoke['launches']['fused_add']}, all-to-all records "
         f"{smoke['a2a_records']} [{card}]")
    if len(rep["losses"]) != MOE_DP_SMOKE_STEPS or \
            not all(math.isfinite(v) for v in rep["losses"]):
        raise AssertionError(f"moe dense (a): losses {rep['losses']}")
    if "ep" in rep or rep["dense_moe"]["all_reduce_bytes"] != every or \
            rep["buckets"] != buckets:
        raise AssertionError(f"moe dense (a): not the data-parallel step over "
                             f"every leaf: {rep}")
    if smoke["launches"]["peer_ring"] != want_ring or \
            smoke["launches"]["fused_add"] != 0 or smoke["a2a_records"] != 0:
        raise AssertionError(f"moe dense (a): launches {smoke['launches']}, "
                             f"{smoke['a2a_records']} all-to-all records; "
                             f"reckoned peer_ring {want_ring}, 0 and 0")
    _free()
    # (a) the published dbrx at one block on 3 data ranks: the reckoning
    # decides whether it runs
    base, cut = _cut_config(MOE_TRAIN_DEPTH, None, MOE_ARCH)
    configs.get_config = cut
    try:
        pub = _tp_run(MOE_DP_CLI, refusal="reckoned")
    finally:
        configs.get_config = base
    _free()
    mem = _memory_line(pub)
    fits = mem["total"] <= mem["card_bytes"]
    published = {"memory": mem, "fits": fits, "refusal": pub["refusal"],
                 "peak_mem_gb": pub["peak_mem_gb"], "wall_s": pub["wall_s"],
                 "launches": pub["launches"]}
    if fits != (pub["refusal"] is None):
        raise AssertionError(f"moe dense (a): the reckoning ({mem['total']} "
                             f"of {mem['card_bytes']} bytes) predicted "
                             f"{'a run' if fits else 'a refusal'}: "
                             f"{published}")
    if fits:
        prep = pub["report"]
        want_pub = prep["buckets"] * MOE_DP_STEPS
        published.update(losses=prep["losses"],
                         step_ms_host_clock=[v * 1e3 for v in prep["step_s"]],
                         buckets=prep["buckets"],
                         bucket_bytes=prep["bucket_bytes"],
                         checkpoint_bytes=prep["checkpoint"]["bytes"])
        if len(prep["losses"]) != MOE_DP_STEPS or \
                not all(math.isfinite(v) for v in prep["losses"]) or \
                pub["launches"]["peer_ring"] != want_pub or \
                pub["peak_mem_gb"] * 1e9 > mem["card_bytes"]:
            raise AssertionError(f"moe dense (a) published: {published}")
        _say(f"moe dense (a): {MOE_ARCH} at {MOE_TRAIN_DEPTH} block on --mesh "
             f"{MOE_DP_RANKS} ran, as its reckoning of "
             f"{mem['total'] / 1e9:.2f} "
             f"GB (weights {mem['weights'] / 1e9:.2f}, moments "
             f"{mem['moments'] / 1e9:.2f}, {MOE_DP_RANKS} ranks' gradient "
             f"buffers {mem['gradients'] / 1e9:.2f}, their mean "
             f"{mem['mean'] / 1e9:.2f}, in flight "
             f"{mem['in_flight'] / 1e9:.2f}) against the card's "
             f"{mem['card_bytes'] / 1e9:.2f} GB predicted: losses "
             f"{[round(v, 4) for v in prep['losses']]}, step ms (host clock) "
             f"{[round(v * 1e3, 1) for v in prep['step_s']]}, peak "
             f"{pub['peak_mem_gb']:.2f} GB, peer_ring "
             f"{pub['launches']['peer_ring']} = {prep['buckets']} buckets x "
             f"{MOE_DP_STEPS} [{card}]")
    else:
        _say(f"moe dense (a): {MOE_ARCH} at {MOE_TRAIN_DEPTH} block on --mesh "
             f"{MOE_DP_RANKS} refused, as its reckoning of "
             f"{mem['total'] / 1e9:.2f} GB against the card's "
             f"{mem['card_bytes'] / 1e9:.2f} GB predicted: {pub['refusal']} "
             f"[{card}]")
    # (a) the reckoning held where the fallback runs: the same command with
    # MOE_DP_MID_EXPERTS experts, its peak against the reckoned bytes
    def mid(name):
        cfg = cut(name)
        return dataclasses.replace(cfg, n_experts=MOE_DP_MID_EXPERTS) \
            if name == MOE_ARCH else cfg

    configs.get_config = mid
    try:
        run = _tp_run(MOE_DP_CLI)
    finally:
        configs.get_config = base
    _free()
    mmem, mrep = _memory_line(run), run["report"]
    state = mmem["weights"] + mmem["moments"] + mmem["gradients"]
    peak = run["peak_mem_gb"] * 1e9
    reckoned = {"memory": mmem, "state": state, "peak_bytes": peak,
                "upper": mmem["total"] + MOE_DP_ACT_BYTES,
                "losses": mrep["losses"], "buckets": mrep["buckets"],
                "launches": run["launches"], "wall_s": run["wall_s"],
                "step_ms_host_clock": [v * 1e3 for v in mrep["step_s"]],
                "checkpoint_bytes": mrep["checkpoint"]["bytes"]}
    _say(f"moe dense (a): {MOE_ARCH} at {MOE_TRAIN_DEPTH} block with "
         f"{MOE_DP_MID_EXPERTS} experts on --mesh {MOE_DP_RANKS}: peak "
         f"{peak / 1e9:.3f} GB against the state {state / 1e9:.3f} GB "
         f"(weights, moments, {MOE_DP_RANKS} gradient buffers) and the "
         f"reckoned {mmem['total'] / 1e9:.3f} GB (mean "
         f"{mmem['mean'] / 1e9:.3f}, in flight {mmem['in_flight'] / 1e9:.3f})"
         f" + {MOE_DP_ACT_BYTES / 1e9:.0f} GB of activations; losses "
         f"{[round(v, 4) for v in mrep['losses']]}, peer_ring "
         f"{run['launches']['peer_ring']} = {mrep['buckets']} buckets x "
         f"{MOE_DP_STEPS} [{card}]")
    if mmem["total"] > mmem["card_bytes"] or \
            len(mrep["losses"]) != MOE_DP_STEPS or \
            not all(math.isfinite(v) for v in mrep["losses"]) or \
            run["launches"]["peer_ring"] != mrep["buckets"] * MOE_DP_STEPS:
        raise AssertionError(f"moe dense (a) with {MOE_DP_MID_EXPERTS} "
                             f"experts: {reckoned}")
    if not state <= peak <= reckoned["upper"]:
        raise AssertionError(f"moe dense (a): the peak {peak} bytes lies "
                             f"outside the reckoning's [{state}, "
                             f"{reckoned['upper']}]: {reckoned}")
    # (c) the fallback's layer at published widths against moe_dense
    layer_dp = _dense_ranks_layer(seed, card)
    _say(f"moe dense (c): dbrx layer on {MOE_DP_RANKS} ranks x "
         f"{MOE_DP_LAYER_ROWS // MOE_DP_RANKS} rows x {MOE_TP_SEQ} tokens "
         f"against moe_dense on the global batch: relative "
         f"{json.dumps(layer_dp['relative'])} (bound {MOE_DP_LAYER_BOUND}; "
         f"control, one rank left out, "
         f"{layer_dp['control_grad_one_rank_left_out']:.4g}); aux "
         f"{layer_dp['aux']:.6f} relative {layer_dp['aux_relative']:.3g} "
         f"(bound {MOE_DP_AUX_BOUND}; control, the ranks' own terms, "
         f"{layer_dp['control_aux_relative']:.3g}); peak "
         f"{layer_dp['peak_mem_gb']:.2f} GB [{card}]")
    if layer_dp["worst"] > MOE_DP_LAYER_BOUND or \
            layer_dp["aux_relative"] > MOE_DP_AUX_BOUND:
        raise AssertionError(f"moe dense (c): {layer_dp}")
    if layer_dp["control_grad_one_rank_left_out"] <= MOE_DP_LAYER_BOUND or \
            layer_dp["control_aux_relative"] <= MOE_DP_AUX_BOUND:
        raise AssertionError(f"moe dense (c): a control passed its bound: "
                             f"{layer_dp}")
    # (b) a wrapped session on the card
    layer = _wrapped_ep_layer(seed, card)
    _free()
    _say(f"moe dense (b): inside wrap(), arm_ep with no plan armed "
         f"{layer['wrapped_order']} (the entry's local_perm "
         f"{layer['entry_local_perm']}, its nodes {layer['entry_perm']}; "
         f"plan= armed {layer['explicit_order']}); the dbrx layer on "
         f"{MOE_TP_ROWS} x {MOE_TP_SEQ} tokens bit for bit: "
         f"{layer['bit_equal']} ({layer['a2a_records']} all-to-all records)")
    prod = _wrapped_production_mesh(card)
    _say(f"moe dense (b): inside wrap(), make_production_mesh() is the plan's "
         f"order: {prod['order_is_plans']} ({prod['shape']} "
         f"{prod['axis_names']} on {prod['device']}); allocated bytes "
         f"{prod['allocated_before']} -> {prod['allocated_after']}")
    res = {"smoke": {"losses": rep["losses"], "launches": smoke["launches"],
                     "peer_ring_reckoned": want_ring, "buckets": buckets,
                     "a2a_records": smoke["a2a_records"],
                     "memory": _memory_line(smoke), "wall_s": smoke["wall_s"]},
           "published": published, "reckoned_run": reckoned,
           "dense_ranks_layer": layer_dp, "wrapped_layer": layer,
           "production_mesh": prod, "phase_s": time.monotonic() - t_phase,
           "card": card}
    _say("moe dense " + json.dumps(res, default=float))
    return res


def time_flash_layer(label: str, shape, causal: bool, window: int,
                     seed: int) -> dict:
    """The flash kernel at one model's layer shape (bf16): held to its plain
    version (the model path's blocks, ``gcd(S, 128)``), launched twice for
    the same bits, timed beside the plain version and beside
    ``F.scaled_dot_product_attention`` (the library yardstick, never on the
    path: ``is_causal`` for a causal mask, the window as a boolean mask).
    Every time is device time: the kernel and SDPA by CUDA-graph replay,
    the plain version (many calls a layer) by CUDA events."""
    import math

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    B, H, KV, S, hd = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
               for s in ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))
    block = math.gcd(S, 128)
    kw = dict(causal=causal, window=window, block_q=block, block_k=block)
    before = dict(fa.flash_attention.kernel_launches)
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ran = {n for n in fa.KERNELS
           if fa.flash_attention.kernel_launches[n] != before[n]}
    want_kernel = "flash_fwd_wgmma" if hd in (64, 128) else "flash_fwd_mma"
    if ran != {want_kernel}:
        raise AssertionError(f"flash_attention {label} {shape}: ran {ran}, "
                             f"expected {want_kernel}")
    if not torch.equal(got, again):
        raise AssertionError(f"flash_attention {label} {shape}: a second "
                             f"launch gave other bits")
    err = _check_close(f"flash_attention {label} {shape}", got,
                       fa.flash_attention_plain(q, k, v, **kw),
                       *FLASH_TOL["bfloat16"])
    ms = _graph_ms(lambda: fa.flash_attention(q, k, v, **kw), 5)
    plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw), 2,
                        warmup=1)
    sdpa = dict(enable_gqa=H != KV, is_causal=causal and not window)
    if window:
        pos = torch.arange(S, device="cuda")
        rel = pos[:, None] - pos[None, :]
        sdpa["attn_mask"] = (rel < window) & (rel >= 0 if causal else True)
    lib_ms = _graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, **sdpa),
                       5)
    flops, moved = fa.work(B, H, KV, S, hd, causal, window, itemsize=2)
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    res = {"shape": list(shape), "causal": causal, "window": window,
           "kernel": want_kernel, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "flops": flops, "bytes": moved}
    _say(f"flash_attention bf16 {label} layer {list(shape)} causal={causal} "
         f"window={window} ({want_kernel}): max abs err vs plain {err:.3e}; "
         f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms; "
         f"{flops} FLOP, {moved} bytes -> bound {res['bound_ms']:.4f} ms "
         f"({res['bound_by']}), the kernel at {res['bound_ms'] / ms:.3f} of it")
    del q, k, v, got, again
    torch.cuda.empty_cache()
    return res


def _serve_wave(model, params, prompts, new: int, fe=None):
    """One counted wave through the engine: launch counts zeroed just
    before ``generate``, read just after; peak memory over the wave."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import GenerationConfig, GenerationEngine

    counted = _counted()
    eng = GenerationEngine(model, params,
                           GenerationConfig(max_new_tokens=new, eos_token=-1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    fa.flash_attention.kernel_launches = dict.fromkeys(fa.KERNELS, 0)
    t0 = time.monotonic()
    outs = eng.generate(prompts, frontend_embeds=fe)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return outs, {
        "generate_s": wall,
        "launches": {name: fn.launches for name, fn in counted.items()},
        "flash_kernel_launches": dict(fa.flash_attention.kernel_launches),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _teacher_forced_margin(model, params, prompts, outs, fe) -> float:
    """The largest gap, over every generated position, between the top
    logit of ``model`` (fed the prompt and the tokens generated before that
    position) and its logit of the generated token: 0 when every token is
    ``model``'s own greedy choice on that prefix.

    One ``forward`` over prompt and tokens; for an MoE model, whose dense
    dispatch groups a prompt by ``moe_group_size`` tokens (the reference's
    too), the prompt's ``prefill`` and one teacher-forced ``decode_step``
    a generated token."""
    import torch

    from repro_torch.serve.engine import _grow_cache

    seq = torch.tensor([p + o for p, o in zip(prompts, outs)], device="cuda")
    P = len(prompts[0])
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    with torch.inference_mode():
        if model.cfg.n_experts:
            first, cache = model.prefill(params, seq[:, :P], fe)
            cache = _grow_cache(cache, P, seq.shape[1])
            rows = [first]
            for t in range(P, seq.shape[1] - 1):
                step, cache = model.decode_step(params, seq[:, t], cache)
                rows.append(step)
            logits = torch.stack(rows, 1).float()
        else:
            feats, _ = model.forward(params, seq[:, :-1], fe,
                                     return_features=True)
            logits = (feats[:, P - 1:] @ head).float()
        chosen = logits.gather(-1, seq[:, P:, None])[..., 0]
        return (logits.amax(-1) - chosen).max().item()


class _PrefillFault:
    """The control model of a decoder without windowed decode: the sound
    model with the faulty (windowed) model's prefill, so the fault drops
    half of what the prompt's attention should see and decode runs on the
    cache it leaves."""

    def __init__(self, faulty, sound):
        self.cfg, self.device = sound.cfg, sound.device
        self.prefill, self.decode_step = faulty.prefill, sound.decode_step


def _held_apart(what: str, sound: float, limit: float, control: float) -> None:
    """A check and its power: the sound reading within ``limit``, the
    control's (a deliberately faulty path) beyond it."""
    if not sound <= limit < control:
        raise AssertionError(f"{what}: sound {sound:.4f}, limit {limit}, "
                             f"control {control:.4f}: the sound reading must "
                             f"lie within the limit and the control beyond it")


def _prefill_logits(model, params, tokens, fe):
    import torch

    with torch.inference_mode():
        return model.prefill(params, tokens, fe)[0].float()


def serve_two_ways(arch: str, seed: int, card: str, batch: int, prompt: int,
                   new: int, kernel: str, fe_slots: int = 0,
                   exact: bool = False, depth: int = 0,
                   keep: bool = False) -> dict:
    """Phases 9, 10 and 14: one model family served at full width with
    ``attention_impl="flash"``, counted (one flash launch an attention
    layer of the prefill, every one ``kernel``), then the same wave with
    ``"xla"`` on the same weights; prefill time, decode step and peak
    memory of the flash model.

    The two waves' tokens are compared, but in bf16 with random weights
    they need not be equal: the logits are bf16, their top two often tie
    or lie within the two attention paths' rounding (each layer's flash
    output within ``FLASH_TOL`` of the plain one), and one flipped token
    sends a row down another continuation.  So the check is teacher
    forced: the ``xla`` model, fed each flash row's prompt and tokens,
    must find every generated token within ``TOKEN_MARGIN`` of its own
    top logit, and the two prefills' logits must lie within
    ``LOGIT_BOUND[arch]``.  A control wave, the flash model with a window
    of ``CONTROL_WINDOW`` on the same weights, must land beyond both.
    With ``exact`` (Whisper, whose two waves agree) the tokens must be
    equal instead.  Exact equality is held in f32 for every family
    (``check_small_families``).  ``depth`` > 0 cuts the model to that many
    layers (the widths stay published); ``keep`` returns the model and
    weights under ``"_model"``/``"_params"`` for a later phase.  A decoder
    has no windowed decode, so its control wave decodes with the sound
    model from the windowed prefill's cache (:class:`_PrefillFault`).
    """
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_config(arch), attention_impl="flash")
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    model = get_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = model.init(gen)
    torch.cuda.empty_cache()
    n_params = sum(t.numel() for t in _leaves(params))
    # attention layers of one prefill: the hybrid's "A" blocks, Whisper's
    # encoder and decoder self-attention, a decoder's every layer
    n_flash = (cfg.layer_kinds().count("A") if cfg.family == "hybrid" else
               cfg.n_encoder_layers + cfg.n_layers if cfg.family == "encdec"
               else cfg.n_layers)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt)).tolist()
    fe = None if not fe_slots else torch.ones(
        (batch, fe_slots, cfg.d_model), dtype=torch.float32, device="cuda")
    model.init_cache(1, 1)
    outs, counted = _serve_wave(model, params, prompts, new, fe)
    launches, by_kernel = counted["launches"], counted["flash_kernel_launches"]
    if launches["flash_attention"] != n_flash or by_kernel[kernel] != n_flash:
        raise AssertionError(f"{arch}: flash_attention launched "
                             f"{launches['flash_attention']} times in one "
                             f"prefill ({by_kernel}), expected {n_flash}, all "
                             f"{kernel}")
    if len(outs) != batch or any(len(o) != new for o in outs):
        raise AssertionError(f"{arch}: not every request got {new} tokens: "
                             f"{[len(o) for o in outs]}")
    if not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError(f"{arch}: generated token out of the vocabulary")
    plain = get_model(dataclasses.replace(cfg, attention_impl="xla"), device="cuda")
    outs_xla, counted_xla = _serve_wave(plain, params, prompts, new, fe)
    if counted_xla["launches"]["flash_attention"]:
        raise AssertionError(f"{arch}: the xla wave launched the flash kernel")
    equal = sum(a == b for o, p in zip(outs, outs_xla) for a, b in zip(o, p))
    first_diff = [next((t for t, (a, b) in enumerate(zip(o, p)) if a != b), new)
                  for o, p in zip(outs, outs_xla)]
    margin = _teacher_forced_margin(plain, params, prompts, outs, fe)
    tokens = torch.tensor(prompts, device="cuda")
    lx = _prefill_logits(plain, params, tokens, fe)
    # how far the two attention paths' bf16 logits lie apart on one prefix,
    # and how close the xla model's top two logits come (0: a tie)
    logit_diff = (_prefill_logits(model, params, tokens, fe) - lx).abs().max().item()
    top2 = lx.topk(2, dim=-1).values
    top2_gap = (top2[:, 0] - top2[:, 1]).tolist()
    control = {}
    if exact:
        if equal != batch * new:
            raise AssertionError(f"{arch}: {equal} of {batch * new} tokens "
                                 f"equal the xla wave's")
    else:
        faulty = get_model(dataclasses.replace(cfg, attn_window=CONTROL_WINDOW),
                           device="cuda")
        waved = faulty if cfg.family == "hybrid" else _PrefillFault(faulty, model)
        outs_c, _ = _serve_wave(waved, params, prompts, new, fe)
        control = {
            "window": CONTROL_WINDOW,
            "teacher_forced_margin": _teacher_forced_margin(
                plain, params, prompts, outs_c, fe),
            "prefill_logit_diff_vs_xla": (_prefill_logits(
                faulty, params, tokens, fe) - lx).abs().max().item(),
            "tokens_equal_xla_wave": sum(a == b for o, p in zip(outs_c, outs_xla)
                                         for a, b in zip(o, p))}
        del faulty
        _say(f"serve {arch} control (the flash model with a window of "
             f"{CONTROL_WINDOW}): {control['tokens_equal_xla_wave']} of "
             f"{batch * new} tokens equal the xla wave's; its tokens within "
             f"{control['teacher_forced_margin']:.4f} of the xla model's top "
             f"logit, its prefill's logits within "
             f"{control['prefill_logit_diff_vs_xla']:.4f} of the xla model's")
        _held_apart(f"{arch} teacher-forced margin", margin, TOKEN_MARGIN,
                    control["teacher_forced_margin"])
        _held_apart(f"{arch} prefill logits vs xla", logit_diff,
                    LOGIT_BOUND[arch], control["prefill_logit_diff_vs_xla"])
    del lx, plain
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens, fe)
        if tuple(logits.shape) != (batch, cfg.vocab_size) or \
                not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"{arch}: prefill logits {tuple(logits.shape)} "
                                 f"not finite / not [B, vocab]")
        prefill_ms = _time_ms(lambda: model.prefill(params, tokens, fe), 2,
                              warmup=1)
        from repro_torch.serve.engine import _grow_cache
        grow = getattr(model, "grow_cache", _grow_cache)
        cache = grow(cache, prompt, prompt + new)
        cur = logits.argmax(-1)
        step_ms = _time_ms(lambda: model.decode_step(params, cur, cache), 10)
        prof = profile_window(f"{arch} prefill",
                              lambda: model.prefill(params, tokens, fe))
    res = {
        "arch": cfg.name, "params": n_params, "batch": batch,
        "prompt_len": prompt, "new_tokens": new, "frontend_slots": fe_slots,
        "generate_s": counted["generate_s"],
        "generate_s_xla": counted_xla["generate_s"],
        "prefill_ms": prefill_ms,
        "prefill_tok_per_s": batch * prompt / (prefill_ms / 1e3),
        "decode_step_ms": step_ms, "decode_tok_per_s": batch / (step_ms / 1e3),
        "peak_mem_gb": counted["peak_mem_gb"],
        "peak_mem_gb_xla": counted_xla["peak_mem_gb"],
        "launches": launches, "flash_kernel_launches": by_kernel,
        "tokens_equal_xla_wave": equal, "tokens": batch * new,
        "first_divergence_step": first_diff,
        "teacher_forced_margin": margin,
        "prefill_logit_diff_vs_xla": logit_diff, "prefill_top2_gap_xla": top2_gap,
        "control": control,
        "prefill_flash_ms": prof.get("ms_by_kind", {}).get("flash_attention"),
        "prefill_busy_ms": prof.get("busy_ms"),
        "prefill_idle_share": prof.get("idle_share"), "card": card,
    }
    if depth:
        res["depth"] = {"n_layers": depth, "published": get_config(arch).n_layers}
    _say(f"serve {cfg.name} ({n_params} params, bf16, flash) batch {batch} x "
         f"prompt {prompt} x {new} new: {equal} of {batch * new} tokens equal "
         f"the xla wave's (rows first differ at steps {first_diff}); every "
         f"token within {margin:.4f} of the xla model's top logit on its "
         f"prefix (limit {'exact' if exact else TOKEN_MARGIN}); the prefill's "
         f"logits within {logit_diff:.4f} of the xla model's (limit "
         f"{'none' if exact else LOGIT_BOUND[arch]}), whose top two lie "
         f"{[round(g, 4) for g in top2_gap]} apart; prefill "
         f"{prefill_ms:.3f} ms ({res['prefill_tok_per_s']:.0f} tok/s); decode "
         f"{step_ms:.3f} ms/step ({res['decode_tok_per_s']:.1f} tok/s); peak "
         f"memory {res['peak_mem_gb']:.3f} GB (xla wave "
         f"{res['peak_mem_gb_xla']:.3f}); flash_attention launches "
         f"{launches['flash_attention']} ({by_kernel}) [{card}]")
    _say(f"serve {arch} " + json.dumps(res))
    if keep:
        res.update(_model=model, _params=params)
    return res


def vlm_prefill_full_width(seed: int, card: str) -> dict:
    """Phase 11: the VLM front end at full width: one prefill with the
    576 image slots filled by the reference's stub (ones), counted (32
    ``flash_fwd_wgmma`` launches), against the text-only prefill (the
    image slots must move the logits), against the ``xla`` model's prefill
    on the same weights and inputs (within ``LOGIT_BOUND``) and against a
    control, the flash model with a window of ``CONTROL_WINDOW`` (beyond
    it)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import get_model

    counted = _counted()
    cfg = dataclasses.replace(get_config(VLM_ARCH), attention_impl="flash")
    model = get_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = model.init(gen)
    torch.cuda.empty_cache()
    n_params = sum(t.numel() for t in _leaves(params))
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (VLM_BATCH, VLM_PROMPT))).cuda()
    fe = torch.ones((VLM_BATCH, cfg.n_img_tokens, cfg.d_model),
                    dtype=torch.float32, device="cuda")
    with torch.inference_mode():
        model.prefill(params, tokens[:, :1024], fe)      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        fa.flash_attention.kernel_launches = dict.fromkeys(fa.KERNELS, 0)
        logits, cache = model.prefill(params, tokens, fe)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counted.items()}
        by_kernel = dict(fa.flash_attention.kernel_launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        text, _ = model.prefill(params, tokens)
        prefill_ms = _time_ms(lambda: model.prefill(params, tokens, fe), 2,
                              warmup=1)
    del cache
    lx = _prefill_logits(get_model(dataclasses.replace(cfg, attention_impl="xla"),
                                   device="cuda"), params, tokens, fe)
    lc = _prefill_logits(get_model(dataclasses.replace(
        cfg, attn_window=CONTROL_WINDOW), device="cuda"), params, tokens, fe)
    xla_diff = (logits.float() - lx).abs().max().item()
    control_diff = (lc - lx).abs().max().item()
    _say(f"VLM {cfg.name}: the flash prefill's logits within {xla_diff:.4f} "
         f"of the xla prefill's (limit {LOGIT_BOUND[VLM_ARCH]}); the control "
         f"(a window of {CONTROL_WINDOW}) {control_diff:.4f}")
    _held_apart(f"{VLM_ARCH} prefill logits vs xla", xla_diff,
                LOGIT_BOUND[VLM_ARCH], control_diff)
    if launches["flash_attention"] != cfg.n_layers or \
            by_kernel["flash_fwd_wgmma"] != cfg.n_layers:
        raise AssertionError(f"{VLM_ARCH}: flash_attention launched "
                             f"{launches['flash_attention']} times ({by_kernel}), "
                             f"expected {cfg.n_layers}, all flash_fwd_wgmma")
    if tuple(logits.shape) != (VLM_BATCH, cfg.vocab_size) or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{VLM_ARCH}: prefill logits {tuple(logits.shape)} "
                             f"not finite / not [B, vocab]")
    diff = (logits.float() - text.float()).abs().max().item()
    if not diff > 0.0:
        raise AssertionError(f"{VLM_ARCH}: the image embeddings did not change "
                             f"the logits")
    res = {"arch": cfg.name, "params": n_params, "batch": VLM_BATCH,
           "prompt_len": VLM_PROMPT, "image_slots": cfg.n_img_tokens,
           "prefill_ms": prefill_ms,
           "prefill_tok_per_s": VLM_BATCH * VLM_PROMPT / (prefill_ms / 1e3),
           "peak_mem_gb": peak_gb, "launches": launches,
           "flash_kernel_launches": by_kernel,
           "max_abs_logit_change_vs_text_only": diff,
           "prefill_logit_diff_vs_xla": xla_diff,
           "control": {"window": CONTROL_WINDOW,
                       "prefill_logit_diff_vs_xla": control_diff},
           "card": card}
    _say(f"VLM {cfg.name} ({n_params} params, bf16, flash): prefill of "
         f"{VLM_BATCH} x {VLM_PROMPT} tokens, {cfg.n_img_tokens} image slots, "
         f"{prefill_ms:.3f} ms; logits differ from the text-only prefill's by "
         f"up to {diff:.4f}; flash_attention launches "
         f"{launches['flash_attention']} ({by_kernel}); peak memory "
         f"{peak_gb:.3f} GB [{card}]")
    _say("vlm " + json.dumps(res))
    return res


def check_ssm_gradient(seed: int, card: str) -> dict:
    """Phase 12a: the ssm family's gradient at full width, the witness
    beside the train command's falling loss.  ``rwkv6-1.6b`` in f32 with
    the exact recurrence (the training path), ``GRAD_ROWS`` x ``SSM_SEQ``
    tokens: ``loss`` and its gradient g by backward; then, for every
    parameter tensor (stacked over the layers), the loss's derivative
    along that tensor's g by forward-mode AD (dual numbers through every
    op, no backward involved), which must equal |g|^2 within
    ``GRAD_RTOL``.  The control, g made 10 % larger in every other entry,
    must miss it for every tensor."""
    import numpy as np
    import torch
    import torch.autograd.forward_ad as fwAD

    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = dataclasses.replace(get_config(SSM_ARCH), dtype="float32",
                              wkv_impl="xla")
    model = get_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = model.init(gen)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (GRAD_ROWS, SSM_SEQ + 1))).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    named = list(_named_leaves(params))
    for *_, t in named:
        t.requires_grad_(True)
    t0 = time.monotonic()
    loss = model.loss(params, batch)
    loss.backward()
    torch.cuda.synchronize()
    grad_s = time.monotonic() - t0

    def along(parent, key, t, tangent) -> float:
        """The loss's derivative along ``tangent`` in ``parent[key]``,
        relative to ``tangent . tangent``, less one."""
        with fwAD.dual_level():
            parent[key] = fwAD.make_dual(t, tangent)
            out = model.loss(params, batch)
            got = fwAD.unpack_dual(out).tangent.double().item()
        parent[key] = t
        return abs(got / tangent.double().square().sum().item() - 1.0)

    sound, faulty = {}, {}
    t0 = time.monotonic()
    with torch.no_grad():
        for name, parent, key, t in named:
            t.requires_grad_(False)
            g, t.grad = t.grad, None
            if not bool(g.any()):
                raise AssertionError(f"{SSM_ARCH} gradient: {name} got a "
                                     f"zero gradient")
            sound[name] = along(parent, key, t, g)
            g.view(-1)[::2] *= 1.1
            faulty[name] = along(parent, key, t, g)
            del g
    torch.cuda.synchronize()
    jvp_s = time.monotonic() - t0
    worst, least = max(sound.values()), min(faulty.values())
    res = {"arch": cfg.name, "dtype": "float32", "rows": GRAD_ROWS,
           "seq": SSM_SEQ, "loss": loss.item(), "tensors": len(sound),
           "max_rel_err": worst, "control_min_rel_err": least,
           "rel_err": sound, "backward_s": grad_s, "forward_mode_s": jvp_s,
           "card": card}
    _say(f"{SSM_ARCH} gradient (f32, {GRAD_ROWS} x {SSM_SEQ} tokens, loss "
         f"{res['loss']:.4f}): for each of {len(sound)} parameter tensors the "
         f"forward-mode derivative along its gradient within {worst:.2e} of "
         f"|g|^2 (limit {GRAD_RTOL}; the control, g 10 % off in every other "
         f"entry, at least {least:.2e} off); backward {grad_s:.1f} s, forward "
         f"mode {jvp_s:.1f} s [{card}]")
    _say("ssm gradient " + json.dumps(res))
    _held_apart(f"{SSM_ARCH} gradient vs forward mode", worst, GRAD_RTOL, least)
    del params, named, loss
    return res


def _moe_spy():
    """Wrap ``layers.moe_layer``: each call on a prompt (S > 1) keeps its
    input; ``restore()`` puts the layer back."""
    from repro_torch.models import layers as L

    real, seen = L.moe_layer, []

    def spy(p, x, cfg):
        if x.shape[1] > 1:
            seen.append((p, x))
        return real(p, x, cfg)

    L.moe_layer = spy
    return SimpleNamespace(seen=seen, restore=lambda: setattr(L, "moe_layer", real))


def _no_drop(cfg):
    """``cfg`` at the capacity factor E/K: a group's every token fits each
    expert's queue (and, for the EP all-to-all with E/n_ep <= E/K experts
    a rank, every rank's buffers), so no path drops a choice."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.moe_top_k)


def _dense_drops(p, x, cfg) -> int:
    """(token, k) choices ``moe_dense`` drops on ``x``: per dispatch group,
    an expert's choices past its capacity."""
    import math

    import torch.nn.functional as F

    from repro_torch.models import layers as L

    B, S, D = x.shape
    group = min(cfg.moe_group_size, S)
    idx, _, _ = L._router_probs(p, x.reshape(-1, group, D), cfg)
    K = idx.shape[-1]
    C = max(int(math.ceil(group * K / cfg.n_experts * cfg.capacity_factor)), K)
    counts = F.one_hot(idx, cfg.n_experts).sum((1, 2))        # [G, E]
    return int((counts - C).clamp_min(0).sum())


def _scatter_drops(p, x, cfg) -> int:
    """(token, k) choices ``moe_scatter`` drops on ``x``: an expert's
    choices past its capacity over all ``B*S`` tokens."""
    import math

    import torch.nn.functional as F

    from repro_torch.models import layers as L

    idx, _, _ = L._router_probs(p, x.reshape(-1, x.shape[-1]), cfg)
    T, K = idx.shape
    C = max(int(math.ceil(T * K / cfg.n_experts * cfg.capacity_factor)), K)
    counts = F.one_hot(idx, cfg.n_experts).sum((0, 1))
    return int((counts - C).clamp_min(0).sum())


def _a2a_drops(p, x, cfg, n_ep: int):
    """(token, k) choices ``moe_a2a`` drops on ``x`` (a batch that splits
    over the ``n_ep`` ranks): at the source (a destination rank's buffer
    full) and at the destination (a local expert's slots full; padding
    rows of the buffers, which the receiver also queues, not counted)."""
    import math

    import torch

    from repro_torch.models import layers as L
    from repro_torch.models.layers import _pack

    E_loc = cfg.n_experts // n_ep
    shards = x.chunk(n_ep)
    T = shards[0].shape[0] * shards[0].shape[1]
    K = cfg.moe_top_k
    C = max(int(math.ceil(T * K / n_ep * cfg.capacity_factor)), K)
    C2 = max(int(math.ceil(n_ep * C / E_loc * cfg.capacity_factor)), 1)
    first, ids, real = 0, [], []
    for xl in shards:
        idx, _, _ = L._router_probs(p, xl.reshape(T, -1), cfg)
        order, keep, slot = _pack((idx // E_loc).reshape(-1), n_ep, C)
        first += int((~keep).sum())
        local = (idx % E_loc).reshape(-1)[order]
        e = torch.zeros(n_ep * C, dtype=torch.int64, device=x.device)
        e[slot[keep]] = local[keep]
        r = torch.zeros(n_ep * C, dtype=torch.bool, device=x.device)
        r[slot[keep]] = True
        ids.append(e.reshape(n_ep, C))
        real.append(r.reshape(n_ep, C))
    second = 0
    for dst in range(n_ep):
        e = torch.stack([t[dst] for t in ids]).reshape(-1)
        r = torch.stack([t[dst] for t in real]).reshape(-1)
        order2, keep2, _ = _pack(e, E_loc, C2)
        second += int((~keep2 & r[order2]).sum())
    return first, second


def serve_mla_full_width(seed: int, card: str) -> dict:
    """Phase 13: deepseek-v2-236b at published widths, depth cut to
    ``MLA_DEPTH`` layers (the dense head layer and three MoE layers of 160
    experts top-6 and 2 shared), bf16: one counted wave of ``MOE_BATCH`` x
    ``MOE_PROMPT`` prompt tokens x ``MOE_NEW`` new through the engine (MLA
    has no kernel on this path: its q/k width, 192, is not a flash width),
    each MoE layer's capacity drops on the prompt at the published
    capacity factor, prefill and decode times and peak memory; then two
    checks, each against a control:

    * the config's matrix-absorbed decode against the naive one
      (``mla_absorb=False``) on the same weights, teacher forced on the
      wave's tokens: every MLA layer's attention output, on the same input
      and cache, within ``MLA_DECODE_BOUND``; the control is the absorbed
      decode with the rope term left out (``wk_rope`` and the cache's
      ``k_rope`` zeroed).  The two models' logits are printed, not held:
      a bf16 difference flips the routers' top-k, and a flipped expert
      moves the logits by whole units;
    * ``moe_dense`` against ``moe_scatter`` on the first MoE layer's real
      activations (one prompt row) at the capacity factor E/K, where
      neither can drop (asserted), within ``MOE_REL_BOUND`` of the largest
      output; the control is ``moe_scatter`` with K-1 experts a token.
    """
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import _grow_cache

    base = get_config(MLA_ARCH)
    cfg = dataclasses.replace(base, n_layers=MLA_DEPTH)
    model = get_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = model.init(gen)
    torch.cuda.empty_cache()
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT)).tolist()
    spy = _moe_spy()
    try:
        outs, counted = _serve_wave(model, params, prompts, MOE_NEW)
    finally:
        spy.restore()
    if len(outs) != MOE_BATCH or any(len(o) != MOE_NEW for o in outs) or \
            not all(0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError(f"{MLA_ARCH}: not {MOE_NEW} in-vocabulary tokens "
                             f"a request: {[len(o) for o in outs]}")
    if len(spy.seen) != cfg.n_layers - cfg.n_dense_layers:
        raise AssertionError(f"{MLA_ARCH}: {len(spy.seen)} MoE layers ran on "
                             f"the prompt, expected "
                             f"{cfg.n_layers - cfg.n_dense_layers}")
    with torch.inference_mode():
        drops = [_dense_drops(p, x, cfg) for p, x in spy.seen]
    moe_p, moe_x = spy.seen[0]
    spy.seen.clear()
    tokens = torch.tensor(prompts, device="cuda")
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens)
        if tuple(logits.shape) != (MOE_BATCH, cfg.vocab_size) or \
                not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"{MLA_ARCH}: prefill logits "
                                 f"{tuple(logits.shape)} not finite / not "
                                 f"[B, vocab]")
        prefill_ms = _time_ms(lambda: model.prefill(params, tokens), 2, warmup=1)
        steps = MOE_NEW
        grown = _grow_cache(cache, MOE_PROMPT, MOE_PROMPT + steps)
        cur = logits.argmax(-1)
        step_ms = _time_ms(lambda: model.decode_step(params, cur, grown), 5)
        prof = profile_window(f"{MLA_ARCH} prefill",
                              lambda: model.prefill(params, tokens))

        # absorbed against naive decode, teacher forced on the wave's tokens
        forced = torch.tensor(outs, device="cuda")
        naive_cfg = dataclasses.replace(cfg, mla_absorb=False)
        attn = {"sound": 0.0, "control": 0.0, "scale": 0.0}
        real = L.mla_attention_decode

        def compare(p, x, c, pos, c_cfg):
            """Each MLA layer's step: the absorbed and the control's
            attention output against the naive one's, on copies of the
            layer's cache; then the step itself."""
            def run(ps, run_cfg, zero_rope=False):
                cc = {k: v.clone() for k, v in c.items()}
                if zero_rope:
                    cc["k_rope"].zero_()
                return real(ps, x, cc, pos, run_cfg)[0].float()

            ref = run(p, naive_cfg)
            no_rope = {**p, "wk_rope": torch.zeros_like(p["wk_rope"])}
            attn["sound"] = max(attn["sound"], (run(p, cfg) - ref).abs().max().item())
            attn["control"] = max(attn["control"], (run(no_rope, cfg, True)
                                                    - ref).abs().max().item())
            attn["scale"] = max(attn["scale"], ref.abs().max().item())
            return real(p, x, c, pos, c_cfg)

        def decode(m, spy=False):
            # a padded copy of the prefill's cache, written in place
            c = _grow_cache(cache, MOE_PROMPT, MOE_PROMPT + MLA_CHECK_STEPS)
            rows = []
            L.mla_attention_decode = compare if spy else real
            try:
                for t in range(MLA_CHECK_STEPS):
                    step, c = m.decode_step(params, forced[:, t], c)
                    rows.append(step.float())
            finally:
                L.mla_attention_decode = real
            return torch.stack(rows)

        naive = get_model(naive_cfg, device="cuda")
        absorbed = decode(model, spy=True)
        plain = decode(naive)
        logit_diff = (absorbed - plain).abs().max().item()
        argmax_equal = int((absorbed.argmax(-1) == plain.argmax(-1)).sum())
        del naive, absorbed, plain
    sound, control = attn["sound"], attn["control"]
    _say(f"{MLA_ARCH} absorbed decode vs naive, every MLA layer over "
         f"{MLA_CHECK_STEPS} teacher-forced steps: attention outputs within "
         f"{sound:.4f} (limit {MLA_DECODE_BOUND}, outputs up to "
         f"{attn['scale']:.3f}); the control (no rope term) {control:.4f}; the "
         f"two models' logits {logit_diff:.4f} apart (the routers' top-k flips "
         f"on bf16 differences, not held), {argmax_equal} of "
         f"{MOE_BATCH * MLA_CHECK_STEPS} argmax tokens equal")
    _held_apart(f"{MLA_ARCH} absorbed vs naive decode", sound,
                MLA_DECODE_BOUND, control)
    paths = check_moe_paths(moe_p, moe_x[:1], cfg)
    del moe_p, moe_x, cache, grown, logits
    res = {
        "arch": cfg.name, "params": n_params, "batch": MOE_BATCH,
        "prompt_len": MOE_PROMPT, "new_tokens": MOE_NEW,
        "depth": {"n_layers": MLA_DEPTH, "published": base.n_layers,
                  "dense_head_layers": cfg.n_dense_layers},
        "generate_s": counted["generate_s"], "prefill_ms": prefill_ms,
        "prefill_tok_per_s": MOE_BATCH * MOE_PROMPT / (prefill_ms / 1e3),
        "decode_step_ms": step_ms,
        "decode_tok_per_s": MOE_BATCH / (step_ms / 1e3),
        "peak_mem_gb": counted["peak_mem_gb"], "launches": counted["launches"],
        "capacity_factor": cfg.capacity_factor,
        "prefill_drops_per_moe_layer": drops,
        "choices_per_moe_layer": MOE_BATCH * MOE_PROMPT * cfg.moe_top_k,
        "absorbed_vs_naive_decode": {
            "steps": MLA_CHECK_STEPS, "attention_max_abs": sound,
            "limit": MLA_DECODE_BOUND, "control_no_rope": control,
            "attention_scale": attn["scale"], "logits_max_abs": logit_diff,
            "argmax_equal": argmax_equal},
        "moe_dense_vs_scatter": paths,
        "prefill_busy_ms": prof.get("busy_ms"),
        "prefill_idle_share": prof.get("idle_share"),
        "prefill_ms_by_kind": prof.get("ms_by_kind"), "card": card,
    }
    _say(f"serve {cfg.name} ({n_params} params, bf16, {MLA_DEPTH} of "
         f"{base.n_layers} layers) batch {MOE_BATCH} x prompt {MOE_PROMPT} x "
         f"{MOE_NEW} new: prefill {prefill_ms:.3f} ms "
         f"({res['prefill_tok_per_s']:.0f} tok/s); decode {step_ms:.3f} ms/step "
         f"({res['decode_tok_per_s']:.1f} tok/s); peak memory "
         f"{res['peak_mem_gb']:.3f} GB; capacity drops a MoE layer at "
         f"{cfg.capacity_factor}: {drops} of {res['choices_per_moe_layer']} "
         f"choices; kernel launches {counted['launches']} [{card}]")
    _say(f"serve {MLA_ARCH} " + json.dumps(res))
    return res


def check_moe_paths(p, x, cfg) -> dict:
    """``moe_dense`` against ``moe_scatter`` on one MoE layer's activations
    at the capacity factor E/K (neither may drop), and the control:
    ``moe_scatter`` with one expert fewer a token."""
    import torch

    from repro_torch.models import layers as L

    wide = _no_drop(cfg)
    with torch.inference_mode():
        drops = {"dense": _dense_drops(p, x, wide),
                 "scatter": _scatter_drops(p, x, wide)}
        if any(drops.values()):
            raise AssertionError(f"{cfg.name}: at capacity factor "
                                 f"{wide.capacity_factor} "
                                 f"the MoE paths drop {drops}")
        dense = L.moe_dense(p, x, wide)[0].float()
        scale = dense.abs().max().item()
        sound = (L.moe_scatter(p, x, wide)[0].float() - dense).abs().max().item()
        fewer = dataclasses.replace(wide, moe_top_k=cfg.moe_top_k - 1)
        control = (L.moe_scatter(p, x, fewer)[0].float() - dense).abs().max().item()
    _say(f"{cfg.name} moe_dense vs moe_scatter on a MoE layer's activations "
         f"{list(x.shape)} at capacity factor {wide.capacity_factor:.3f} (no "
         f"drops): within {sound:.4f} of outputs up to {scale:.3f}, "
         f"{sound / scale:.4f} of it (limit {MOE_REL_BOUND}); the control "
         f"(top-{cfg.moe_top_k - 1}) {control:.4f}, {control / scale:.4f}")
    _held_apart(f"{cfg.name} moe_dense vs moe_scatter (relative)", sound / scale,
                MOE_REL_BOUND, control / scale)
    return {"shape": list(x.shape), "capacity_factor": wide.capacity_factor,
            "max_abs": sound, "output_scale": scale,
            "relative": sound / scale, "limit": MOE_REL_BOUND,
            "control_top_k_minus_1": control / scale}


def check_ep_armed(model, params, seed: int, card: str) -> dict:
    """Phase 15: the expert-parallel all-to-all, armed from a plan, on one
    full-width dbrx-132b MoE layer over an 8-slot virtual mesh (16 experts,
    2 a rank).  A plan of the serving mix with the EP all-to-all
    (``serve_mix(moe=True)``) compiled on the scrambled 8-node Clos fabric
    for an ``(8,)`` data mesh; ``arm_ep`` on that planned mesh.  The first
    MoE layer's activations from a prefill of ``MOE_BATCH`` x
    ``MOE_PROMPT`` tokens: their first ``EP_TOKENS`` positions, each row
    split in two, one half a rank.  Checks: the armed shift order is the
    plan's entry order composed with the mesh placement, and every
    all-to-all runs the certified schedule of that order; ``moe_layer``
    (armed: ``moe_a2a``) against ``moe_dense`` at the capacity factor E/K,
    where neither drops, within ``MOE_REL_BOUND`` of its largest output
    (the control: the dense path at K-1); two ``all-to-all`` records a call; every schedule run's
    postcondition; and, at the published capacity factor on all the
    prompt's tokens (one 1024-token row a rank), the a2a's drops beside the
    dense path's and both layers' times."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.kernels import schedule_runner
    from repro_torch.launch import make_planned_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel import moe_a2a

    cfg = model.cfg
    plan, entry, flat, want = compile_ep_plan()
    mesh = make_planned_mesh(plan, "cuda")
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT))).cuda()
    spy = _moe_spy()
    try:
        with torch.inference_mode():
            model.prefill(params, tokens)
    finally:
        spy.restore()
    p, h = spy.seen[0]
    spy.seen.clear()
    x = h[:, :EP_TOKENS].reshape(2 * MOE_BATCH, EP_TOKENS // 2, -1)
    x_all = h.reshape(RANKS, -1, h.shape[-1])
    wide = _no_drop(cfg)
    runs, real = [], schedule_runner.run_schedule
    rec = obs.recorder()
    was = rec.enabled

    def run_spy(xs, sched):
        out = real(xs, sched)
        runs.append((sched, schedule_runner.check_postcondition(sched, xs, out)))
        return out

    moe_a2a.arm_ep(mesh, "data", None, plan=plan)
    try:
        armed = moe_a2a._EP_STATE["a2a_order"]
        if armed != want:
            raise AssertionError(f"arm_ep armed the shift order {armed}, the "
                                 f"plan's is {want}")
        with torch.inference_mode():
            drops = {"a2a": _a2a_drops(p, x, wide, RANKS),
                     "dense": _dense_drops(p, x, wide)}
            if drops["a2a"] != (0, 0) or drops["dense"]:
                raise AssertionError(f"at capacity factor "
                                     f"{wide.capacity_factor} the "
                                     f"paths drop {drops}")
            schedule_runner.run_schedule = run_spy
            rec.enabled, before = True, rec.captured
            try:
                got, _ = L.moe_layer(p, x, wide)
            finally:
                schedule_runner.run_schedule = real
                rec.enabled = was
            n_rec = rec.captured - before
            records = rec.trace().records[len(rec) - n_rec:] if n_rec else []
            dense = L.moe_dense(p, x, wide)[0].float()
            scale = dense.abs().max().item()
            sound = (got.float() - dense).abs().max().item() / scale
            control = (L.moe_dense(p, x, dataclasses.replace(
                wide, moe_top_k=cfg.moe_top_k - 1))[0].float()
                - got.float()).abs().max().item() / scale
            published = {"a2a": _a2a_drops(p, x_all, cfg, RANKS),
                         "dense": _dense_drops(p, x_all, cfg)}
            a2a_ms = _time_ms(lambda: L.moe_layer(p, x_all, cfg), 2, warmup=1)
            dense_ms = _time_ms(lambda: L.moe_dense(p, x_all, cfg), 2, warmup=1)
    finally:
        moe_a2a.clear_ep()
    low = moe_a2a._lowered_a2a(RANKS, want)
    if [r[0] for r in runs] != [low.schedule] * 3:
        raise AssertionError(f"the EP all-to-all ran {len(runs)} schedules, not "
                             f"3 of the plan order's certified schedule")
    bad = [b for _, b in runs if b]
    if bad:
        raise AssertionError(f"an EP all-to-all violated its postcondition: "
                             f"{bad[0][:3]}")
    if [r.op for r in records] != ["all-to-all"] * 2:
        raise AssertionError(f"the obs recorder holds {[r.op for r in records]}"
                             f" for one armed layer call, expected two "
                             f"all-to-all records")
    _say(f"EP all-to-all on {cfg.name}: plan {plan.fingerprint.digest}, entry "
         f"{entry.algo} perm {list(entry.perm)}, mesh placement {flat} -> shift "
         f"order {list(want)}, rounds {[list(r) for r in low.shift_rounds]}; "
         f"3 certified all-to-all runs, postconditions held, 2 all-to-all "
         f"records of {records[0].size_bytes:.0f} bytes")
    _say(f"EP moe_a2a vs moe_dense on {list(x.shape)} at capacity factor "
         f"{wide.capacity_factor} (no drops): within {sound:.4f} of outputs up "
         f"to {scale:.1f} (relative; limit {MOE_REL_BOUND}); the control "
         f"(dense top-{cfg.moe_top_k - 1}) {control:.4f}")
    _held_apart(f"{cfg.name} moe_a2a vs moe_dense (relative)", sound,
                MOE_REL_BOUND, control)
    res = {"arch": cfg.name, "ranks": RANKS, "experts_per_rank":
           cfg.n_experts // RANKS, "plan_fingerprint": plan.fingerprint.digest,
           "entry_perm": list(entry.perm), "mesh_flat": flat,
           "shift_order": list(want),
           "shift_rounds": [list(r) for r in low.shift_rounds],
           "check_shape": list(x.shape), "capacity_factor": wide.capacity_factor,
           "relative": sound, "limit": MOE_REL_BOUND, "output_scale": scale,
           "control_dense_top_k_minus_1": control,
           "a2a_record_bytes": records[0].size_bytes,
           "published_cf": cfg.capacity_factor,
           "prefill_shape": list(x_all.shape),
           "drops_at_published_cf": {"a2a_source": published["a2a"][0],
                                     "a2a_destination": published["a2a"][1],
                                     "dense": published["dense"]},
           "choices": int(x_all.shape[0] * x_all.shape[1] * cfg.moe_top_k),
           "layer_ms": {"moe_a2a": a2a_ms, "moe_dense": dense_ms},
           "card": card}
    _say(f"EP at the published capacity factor {cfg.capacity_factor} on "
         f"{list(x_all.shape)}: moe_a2a drops {published['a2a'][0]} at the "
         f"source and {published['a2a'][1]} at the destination, moe_dense "
         f"{published['dense']}, of {res['choices']} choices; the layer "
         f"{a2a_ms:.3f} ms through the a2a, {dense_ms:.3f} ms dense [{card}]")
    _say("ep " + json.dumps(res))
    return res


def bench_overlap_full_width(seed: int, card: str, shapes) -> dict:
    """Phase 16: ``bench --scenario overlap`` at full width on the card.

    The scenario's ``run`` (``repro_torch.bench.overlap_step``) with
    ``qwen2-0.5b`` at published widths over 8 virtual ranks and all three
    modes, 5 timed calls each after an untimed one (the reference's count
    at full width); every launch count zeroed just
    before and read just after, every reducer call timed with CUDA events by
    a spy on ``OverlapGradReducer.__call__`` that calls through.  Each mode's
    loss against the baseline's at the scenario's ``rtol``, the
    postcondition, the transport (``peer_ring``, as ``train`` picks on
    CUDA), and ``peer_ring`` launched once a bucket a reducer call.  Then
    ``bucketed`` once more over the runner transport, counted: one
    ``fused_add`` a reduce step, a piece and a bucket (as ``train_layout``
    reckons them), its loss against the baseline's the same way.
    ``shapes`` is the model's parameters on the meta device.
    """
    import contextlib
    import io
    import math
    import shutil
    import tempfile

    import torch

    from repro_torch.bench import overlap_step
    from repro_torch.kernels import ring_collective as rc
    from repro_torch.train import (
        OverlapGradReducer, make_overlap_train_step, make_train_step,
        partition_tree)
    from repro_torch.train import overlap_grads

    counted = _counted()
    calls = []
    inner = overlap_grads.OverlapGradReducer.__call__

    def timed(self, stacked, compute=()):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(self, stacked, compute)
        end.record()
        calls.append((self.transport, self.mode, start, end))
        return out

    out_dir = tempfile.mkdtemp(prefix="repro_torch_bench_overlap_")
    path = os.path.join(out_dir, "o.json")
    buf = io.StringIO()
    overlap_grads.OverlapGradReducer.__call__ = timed
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            res = overlap_step.run(smoke=False, seed=seed, device="cuda",
                                   out_path=path, reps=BENCH_REPS)
        torch.cuda.synchronize()
        scenario_s = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(path) as f:
            written = json.load(f)
    finally:
        overlap_grads.OverlapGradReducer.__call__ = inner
        # the scenario's rows, and its JSON, also when its gate failed
        for line in buf.getvalue().splitlines():
            _say("bench overlap | " + line)
        if os.path.exists(path):
            with open(path) as f:
                _say("bench overlap json " + f.read().replace("\n", " "))
        shutil.rmtree(out_dir, ignore_errors=True)
    host, modeled = res["host"], res["modeled"]
    if written["host"] != host or not res["gate_ok"]:
        raise AssertionError("bench overlap: the JSON written is not the run's")
    base_loss = host["baseline_loss"]
    for mode in ("sequential", "bucketed", "fused"):
        loss = host[f"{mode}_loss"]
        if not (host[f"{mode}_loss_ok"] and math.isfinite(loss) and math.isclose(
                loss, base_loss, rel_tol=overlap_step.LOSS_RTOL)):
            raise AssertionError(f"bench overlap {mode}: loss {loss!r} against "
                                 f"the baseline's {base_loss!r}")
    if not host["postcondition_ok"]:
        raise AssertionError("bench overlap: the postcondition failed")
    buckets = len(partition_tree(shapes, host["bucket_bytes"]))
    reps = host["reps"]
    # each mode and the comm-only run: one untimed call, then reps timed
    want_calls = 4 * (reps + 1)
    if host["transport"] != "peer_ring" or host["buckets"] != buckets:
        raise AssertionError(f"bench overlap: {host['buckets']} buckets over "
                             f"{host['transport']}, expected {buckets} over "
                             f"peer_ring")
    if len(calls) != want_calls or launches["peer_ring"] != buckets * want_calls:
        raise AssertionError(f"bench overlap: peer_ring launched "
                             f"{launches['peer_ring']} times in {len(calls)} "
                             f"reducer calls, expected {buckets} x {want_calls}")
    if launches["fused_add"] != 0 or rc.ring_status() != 0:
        raise AssertionError(f"bench overlap: fused_add {launches['fused_add']} "
                             f"launches on the peer_ring path, or the ring's "
                             f"status word is set")
    reducer_ms = {}
    for transport, mode, start, end in calls:
        reducer_ms.setdefault(mode, []).append(start.elapsed_time(end))

    # bucketed again over the runner transport, so fused_add runs on this path
    t_runner = time.monotonic()
    _free()
    h = overlap_step.host_setup(res["scenario"], smoke=False, device="cuda")
    sched = h.schedule
    reduce_steps = sum(1 for rnd in sched.rounds for st in rnd
                       if st.op == "reduce")
    per_step = buckets * reduce_steps * max(1, sched.chunk_factor)
    runner_base = float(make_train_step(h.model, h.opt)(h.state, h.batch)[1]["loss"])
    red = OverlapGradReducer(sched, bucket_bytes=h.bucket_bytes,
                             mode="bucketed", transport="runner")
    step = make_overlap_train_step(h.model, h.opt, red)
    torch.cuda.synchronize()
    runner = {}
    for name in ("warm-up", "counted"):
        for fn in counted.values():
            fn.launches = 0
        del calls[:]
        overlap_grads.OverlapGradReducer.__call__ = timed
        try:
            t0 = time.monotonic()
            loss = float(step(h.state, h.batch)[1]["loss"])
            torch.cuda.synchronize()
            runner[name] = {"step_ms": (time.monotonic() - t0) * 1e3,
                            "reducer_ms": calls[0][2].elapsed_time(calls[0][3]),
                            "loss": loss,
                            "launches": {k: fn.launches
                                         for k, fn in counted.items()}}
        finally:
            overlap_grads.OverlapGradReducer.__call__ = inner
    got = runner["counted"]["launches"]
    if got["fused_add"] != per_step or got["peer_ring"] != 0:
        raise AssertionError(f"bench overlap runner: fused_add launched "
                             f"{got['fused_add']} times, expected {buckets} "
                             f"buckets x {reduce_steps} reduce steps x "
                             f"{max(1, sched.chunk_factor)} pieces = {per_step}")
    if not math.isclose(runner["counted"]["loss"], runner_base,
                        rel_tol=overlap_step.LOSS_RTOL):
        raise AssertionError(f"bench overlap runner: loss "
                             f"{runner['counted']['loss']!r} against the "
                             f"baseline's {runner_base!r}")
    del h, red, step
    out = {
        "arch": host["config"], "ranks": overlap_step.N, "tokens_per_rank":
        overlap_step.SEQ, "reps": reps, "transport": host["transport"],
        "buckets": buckets, "bucket_bytes": host["bucket_bytes"],
        "param_bytes": host["param_bytes"],
        "algorithm": res["scenario"]["algo"], "perm": res["scenario"]["perm"],
        "host_clock_s": {k: host[f"{k}_s"] for k in (
            "baseline", "sequential", "bucketed", "fused", "comm_only",
            "compute_only")},
        "exposed_comm_fraction": host["exposed_comm_fraction"],
        "modeled_speedup": modeled["speedup_bucketed_vs_sequential"],
        "modeled_exposed_fraction": modeled["modeled_exposed_fraction"],
        "losses": {k: host[f"{k}_loss"] for k in (
            "baseline", "sequential", "bucketed", "fused")},
        "reducer_cuda_ms": reducer_ms, "launches": launches,
        "peak_mem_gb": peak_gb, "scenario_s": scenario_s,
        "runner": dict(runner, baseline_loss=runner_base,
                       fused_add_per_step=per_step,
                       reduce_steps=reduce_steps),
        "card": card,
    }
    out["phase_s"] = scenario_s + time.monotonic() - t_runner
    _say("bench overlap " + json.dumps(res["scenario"]))
    _say("bench overlap modeled " + json.dumps(modeled))
    _say(f"bench overlap {host['config']} over {overlap_step.N} ranks x "
         f"{overlap_step.SEQ} tokens, {buckets} buckets of "
         f"{host['bucket_bytes']:.0f} bytes over {host['transport']} at "
         f"{res['scenario']['perm']}, {reps} reps; host clock (obs timers, "
         f"synchronised), s a call: " + ", ".join(
             f"{k} {v:.4f}" for k, v in out["host_clock_s"].items())
         + f"; exposed fraction {host['exposed_comm_fraction']:.4f} (modeled "
         f"{modeled['modeled_exposed_fraction']:.4f}, modeled speedup "
         f"{modeled['speedup_bucketed_vs_sequential']:.4f}); reducer CUDA "
         f"events, mean ms a call: " + ", ".join(
             f"{k} {sum(v) / len(v):.3f}" for k, v in reducer_ms.items())
         + f"; peer_ring launches {launches['peer_ring']} ({buckets} x "
         f"{want_calls}); peak memory {peak_gb:.3f} GB; runner step "
         f"{runner['counted']['step_ms']:.1f} ms host clock, its reducer "
         f"{runner['counted']['reducer_ms']:.2f} ms CUDA events, fused_add "
         f"{got['fused_add']} ({per_step} a step) [{card}]")
    _say("bench overlap full " + json.dumps(out))
    return out


def host_commands(card: str) -> dict:
    """Phase 17: the host-only commands through ``repro_torch.cli.main`` on
    a machine with no JAX, each required to exit 0, timed on the host
    clock; the tracer's state restored after (``trace export`` turns it
    on)."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch import cli, obs

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="repro_torch_host_cmds_")
    commands = [
        ["bench", "--smoke"],
        ["bench", "--scenario", "faults", "--smoke"],
        ["bench", "--scenario", "obs", "--smoke"],
        ["analyze", "--n-list", "4,8,16"],
        ["analyze", "--equiv", "--n-list", "4,8,16"],
        ["analyze", "--plan", "--nodes", "16"],
        ["analyze", "--lint", "--root", root],
        ["status", "--nodes", "16", "--format", "prom"],
        ["trace", "export", "--nodes", "16", "--out",
         os.path.join(tmp, "trace.json")],
        ["trace", "replay"],
    ]
    enabled = obs.tracer().enabled
    seconds = {}
    t_all = time.monotonic()
    try:
        for argv in commands:
            buf = io.StringIO()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(buf):
                code = cli.main(list(argv))
            dt = time.monotonic() - t0
            text = buf.getvalue().strip().splitlines()
            label = " ".join(argv).replace(tmp, "<tmp>").replace(root, "<repo>")
            seconds[label] = dt
            _say(f"python -m repro_torch {label}: exit {code} in {dt:.2f} s "
                 f"(host clock) | {text[-1] if text else ''}")
            if code != 0:
                raise AssertionError(f"python -m repro_torch {label} exited "
                                     f"{code}:\n" + "\n".join(text[-30:]))
    finally:
        obs.tracer().set_enabled(enabled)
        shutil.rmtree(tmp, ignore_errors=True)
    res = {"seconds": seconds, "phase_s": time.monotonic() - t_all,
           "card": card}
    _say("host commands " + json.dumps(res))
    return res


def _cut_cli(arch: str, depth: int, card: str, argv) -> dict:
    """:func:`train_cli_full_width` on ``arch`` cut to ``depth`` blocks at
    published widths (``get_config`` patched as phase 18 patches it), its
    buckets from the cut model's parameters on the meta device."""
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.train.sharded_step import param_shapes

    base, cut = _cut_config(depth, None, arch)
    configs.get_config = cut
    try:
        shapes = param_shapes(get_model(cut(arch), device="cuda"))
        return train_cli_full_width(card, shapes, argv, arch)
    finally:
        configs.get_config = base


def _kind(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "wkv_chunked" in n:
        return "wkv_chunked"
    if "wkv_scan" in n:
        return "wkv_scan"
    if "fused_add" in n:
        return "fused_add"
    if "flash_fwd" in n:
        return "flash_attention"
    if "peer_ring" in n:
        return "peer_ring"
    if any(s in n for s in ("nvjet", "gemm", "gemv", "xmma", "cutlass")):
        return "matmul"
    if any(s in n for s in ("copy", "catarray")):
        return "copy"
    if any(s in n for s in ("index", "gather", "scatter")):
        return "index"
    return "other"


def profile_window(label: str, fn) -> dict:
    """Device busy share and kernel time by kind over one run of ``fn``.

    From ``torch.profiler``'s CUDA kernel events: busy is the union of the
    kernels' intervals, the span runs from the first kernel's start to the
    last one's end.  The profiler adds host time to every op, so a
    host-bound window reads idler here than it runs unprofiled.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        _say(f"profile {label}: the profiler gave no device events; "
             f"device time not measured")
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    span = max(e for _, e in spans) - spans[0][0]
    by_kind, by_name = {}, {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        by_kind[_kind(e.name)] = by_kind.get(_kind(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    res = {
        "window": label, "kernels": len(kern), "busy_ms": busy / 1e3,
        "span_ms": span / 1e3, "idle_share": 1.0 - busy / max(span, 1e-9),
        "ms_by_kind": {k: v / 1e3 for k, v in sorted(by_kind.items())},
        "top_ms": [[n[:90], v / 1e3] for n, v in top],
    }
    _say("profile " + json.dumps(res))
    return res


def _anchor_peak(cfg, shape, mesh, seed: int) -> dict:
    """One real step of a dry-run cell on the card under the counters:
    its count, the card's peak over it, and the state it left."""
    import torch

    from repro_torch.launch import dryrun

    fn, args, build = dryrun.cell_step(cfg, shape, mesh, "cuda",
                                       _seeded(seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = dryrun.account(fn, args, build, shape)
    torch.cuda.synchronize()
    got["peak"] = torch.cuda.max_memory_allocated()
    got["fn"], got["args"] = fn, args
    return got


def _in_band(what: str, measured: float, reckoned: float, control: float
             ) -> None:
    lo, hi = MEM_BAND
    ratio, c_ratio = measured / reckoned, measured / control
    _say(f"dry run {what}: measured peak {measured} bytes, reckoned "
         f"{reckoned} ({ratio:.4f}); the control {control} ({c_ratio:.4f}); "
         f"band {MEM_BAND}")
    if not lo <= ratio <= hi:
        raise AssertionError(f"dry run {what}: measured/reckoned {ratio:.4f} "
                             f"outside {MEM_BAND}")
    if lo <= c_ratio <= hi:
        raise AssertionError(f"dry run {what}: the control {c_ratio:.4f} "
                             f"lies inside {MEM_BAND}")


def dry_run_phase(seed: int, card: str) -> dict:
    """Phase 21: the dry run on the card's host, and held to real steps
    on the card (see the module docstring)."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.monotonic()
    out = {"production": {}}
    # (a) the production mesh, on meta
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for arch, depth in DRY_CELLS:
        rec = dryrun.run_cell(arch, "train_4k", do_diff=False,
                              overrides={"n_layers": depth}, verbose=False,
                              device="cuda")
        torch.cuda.synchronize()
        if rec["status"] != "ok" or torch.cuda.memory_allocated() != before:
            raise AssertionError(f"dry run (a) {arch}: status "
                                 f"{rec['status']}, allocated "
                                 f"{torch.cuda.memory_allocated() - before}")
        keep = {k: rec[k] for k in ("step", "trace_s", "roofline",
                                    "cost_analysis_raw", "collectives")}
        keep["live_bytes_per_device"] = rec["memory"][
            "live_bytes_per_device"]
        keep["fits_hbm"] = rec["memory"]["fits_hbm"]
        out["production"][arch] = keep
        _say(f"dry run (a) {arch} x train_4k on 16x16 at {depth} blocks: "
             f"step {rec['step']}, trace {rec['trace_s']} s, live "
             f"{keep['live_bytes_per_device']} bytes a device, collectives "
             f"{json.dumps(rec['collectives'])} a device, roofline "
             f"{json.dumps(rec['roofline'])} [{card}]")

    # (b) the anchor: full-width qwen2-0.5b on one rank
    cfg = get_config(ANCHOR_ARCH)
    mesh = make_mesh((1,), ("data",), "cuda")
    tshape = ShapeSpec("anchor_train", ANCHOR_SEQ, ANCHOR_BATCH, "train")
    rec = dryrun.cell_record(cfg, tshape, mesh, "cuda", do_diff=False,
                             verbose=False)
    real = _anchor_peak(cfg, tshape, mesh, seed)
    count = real["count"]
    if count.flops != rec["cost_analysis_raw"]["flops"]:
        raise AssertionError(f"dry run (b): the card's step counts "
                             f"{count.flops} FLOPs, the meta run "
                             f"{rec['cost_analysis_raw']['flops']}")
    mem = rec["memory"]
    control = (mem["argument_bytes"] + mem["output_bytes"]
               - mem["alias_bytes"])
    _in_band("(b) train", real["peak"], mem["live_bytes_per_device"], control)
    fn, (state, batch) = real["fn"], real["args"]
    losses = [float(count.out[1]["loss"])]
    state = count.out[0]
    del real, count
    step_ms = []
    for _ in range(ANCHOR_STEPS - 1):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state, metrics = fn(state, batch)
        t1.record()
        torch.cuda.synchronize()
        step_ms.append(t0.elapsed_time(t1))
        losses.append(float(metrics["loss"]))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"dry run (b): losses {losses}")
    bound_s = rec["roofline"]["bound_s"]
    share = bound_s / (min(step_ms) / 1e3)
    out["anchor_train"] = {
        "flops": rec["cost_analysis_raw"]["flops"],
        "bytes_accessed": rec["cost_analysis_raw"]["bytes_accessed"],
        "live_bytes_per_device": mem["live_bytes_per_device"],
        "control_bytes": control, "losses": losses, "step_ms": step_ms,
        "roofline": rec["roofline"], "bound_share": share}
    _say(f"dry run (b) {ANCHOR_ARCH} train {ANCHOR_BATCH} x {ANCHOR_SEQ} on "
         f"one rank: FLOPs {rec['cost_analysis_raw']['flops']:.6e} counted "
         f"alike on meta and on the card; losses {losses}; steady step "
         f"{min(step_ms):.2f} ms, roofline bound {bound_s * 1e3:.2f} ms "
         f"({rec['roofline']['dominant']}): the step at {share:.4f} of its "
         f"bound [{card}]")
    del state, batch, fn
    _free()

    pshape = ShapeSpec("anchor_prefill", ANCHOR_SEQ, ANCHOR_BATCH, "prefill")
    prec = dryrun.cell_record(cfg, pshape, mesh, "cuda", do_diff=False,
                              verbose=False)
    launches = dict(fa.flash_attention.kernel_launches)
    with torch.no_grad():
        preal = dryrun.measure_cell(cfg, pshape, mesh, "cuda",
                                    generator=_seeded(seed))
    got = {k: fa.flash_attention.kernel_launches[k] - launches[k]
           for k in launches}
    pc = preal["count"]
    if pc.flops != prec["cost_analysis_raw"]["flops"] or \
            got["flash_fwd_wgmma"] != cfg.n_layers or \
            pc.kernel_calls.get("flash_attention") != cfg.n_layers:
        raise AssertionError(f"dry run (b) prefill: FLOPs {pc.flops} on the "
                             f"card, {prec['cost_analysis_raw']['flops']} on "
                             f"meta; launches {got}")
    out["anchor_prefill"] = {"flops": pc.flops, "kernel_flops": pc.kernel_flops,
                             "launches": got}
    out["launches"] = {"flash_attention": sum(got.values())}
    _say(f"dry run (b) {ANCHOR_ARCH} flash prefill {ANCHOR_BATCH} x "
         f"{ANCHOR_SEQ}: FLOPs {pc.flops:.6e} on the card (of them the "
         f"kernel's work() {pc.kernel_flops:.6e} at {got['flash_fwd_wgmma']} "
         f"flash_fwd_wgmma launches) equal to the meta count [{card}]")
    del preal, pc
    _free()

    # (c) the virtual mesh: 8 data-parallel ranks on the one card
    ccfg = dataclasses.replace(cfg, n_layers=ANCHOR_MESH_DEPTH)
    cmesh = make_mesh((ANCHOR_MESH_RANKS,), ("data",), "cuda")
    cshape = ShapeSpec("anchor_mesh", ANCHOR_MESH_SEQ, ANCHOR_MESH_RANKS,
                       "train")
    crec = dryrun.cell_record(ccfg, cshape, cmesh, "cuda", do_diff=False,
                              verbose=False)
    creal = _anchor_peak(ccfg, cshape, cmesh, seed)
    cmem = crec["memory"]
    # the tracker's peak over all 8 ranks: their arguments and the most
    # storage the step held at once, undivided; the control without the
    # step's temporaries (its new state alone)
    total = cmem["argument_bytes_total"] + cmem["step_peak_bytes_total"]
    ctl = cmem["argument_bytes_total"] + creal["out_new_total"]
    if creal["count"].flops != crec["cost_analysis_raw"]["flops"] * \
            ANCHOR_MESH_RANKS:
        raise AssertionError(f"dry run (c): FLOPs {creal['count'].flops} "
                             f"on the card, {crec['cost_analysis_raw']}")
    _in_band("(c) --mesh 8", creal["peak"], total, ctl)
    out["anchor_mesh"] = {"step": crec["step"], "peak": creal["peak"],
                          "tracked_total": total, "control": ctl,
                          "ring": creal["count"].kernel_calls}
    del creal
    _free()
    out["phase_s"] = round(time.monotonic() - t_phase, 1)
    _say(f"dry run phase: {out['phase_s']} s")
    return out


def _seeded(seed: int):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return gen


def _free() -> None:
    """Drop the last phase's tensors before the next (glm4-9b's weights alone
    are 18.8 GB)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _named_leaves(tree, prefix: str = ""):
    """(dotted path, parent, key, leaf) for every leaf of a tree of dicts
    and lists."""
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree, k, v


def _leaves(tree):
    return (leaf for *_, leaf in _named_leaves(tree))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.monotonic()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    card = card.splitlines()[0]
    _say(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    libs = build.build_all()
    _say(f"built {sorted(libs)} in {time.monotonic() - t0:.1f} s")
    for name, log in build.ptxas_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                _say(f"ptxas {name}: {line.strip()}")

    from repro_torch.configs import get_config
    from repro_torch.train import OverlapGradReducer

    plan = compile_plan()
    ep_plan = compile_ep_plan()
    layout = train_layout()
    planned = planned_layout(plan, layout)
    kernels = [check_wkv_kernel(args.seed),
               check_wkv_scan_kernel(args.seed),
               check_fused_add_kernel(args.seed, layout),
               check_flash_kernel(args.seed),
               check_peer_ring_kernel(args.seed, planned)]
    _free()
    import shutil
    import tempfile

    ref_dir = tempfile.mkdtemp(prefix="repro_torch_pipeline_")
    try:
        piped = pipeline_virtual(args.seed, card, ref_dir)
        _free()
        t0 = time.monotonic()
        grouped = run_group(args.seed, card, plan, planned,
                            {"ref_dir": ref_dir, "ep_plan": ep_plan})
        _say(f"the group phase with the pipeline and EP cases took "
             f"{time.monotonic() - t0:.1f} s")
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    compressed = check_compression(args.seed, card, layout)
    _free()
    solver = check_solver_eval(args.seed, card)
    check_small_model(args.seed)
    check_small_dense(args.seed)
    check_small_families(args.seed)
    check_virtual_mesh(args.seed)
    check_small_train(args.seed, plan)
    served = serve_full_width(args.seed, card)
    _free()
    served_dense = serve_dense_full_width(args.seed, card)
    _free()
    sched, bb = layout["schedule"], layout["bucket_bytes"]
    trained = train_full_width(
        args.seed, card, layout["cfg"], OverlapGradReducer(sched, bb, "bucketed"),
        OverlapGradReducer(sched, bb, "bucketed", use_kernel_add=False),
        "fused_add", layout["launches_per_step"],
        {"params": layout["n_params"], "perm": TRAIN_PERM,
         "buckets": len(layout["buckets"]), "bucket_bytes": bb})
    _free()
    red = planned["reducer"]
    trained_planned = train_full_width(
        args.seed, card, layout["cfg"], red, None, "peer_ring",
        len(planned["buckets"]),
        {"params": layout["n_params"], "perm": list(red.schedule.order),
         "algorithm": red.schedule.algorithm,
         "plan_fingerprint": plan.fingerprint.digest,
         "buckets": len(planned["buckets"]), "bucket_bytes": red.bucket_bytes})
    _free()
    trained_cli = _cut_cli(TRAIN_ARCH, TRAIN_CLI_DEPTH, card, TRAIN_CLI)
    _free()
    hybrid = serve_two_ways(HYBRID_ARCH, args.seed, card, HYBRID_BATCH,
                            HYBRID_PROMPT, HYBRID_NEW, "flash_fwd_mma")
    _free()
    hcfg = get_config(HYBRID_ARCH)
    hybrid["flash_layer"] = time_flash_layer(
        HYBRID_ARCH, (HYBRID_BATCH, hcfg.n_heads, hcfg.n_kv_heads, HYBRID_PROMPT,
                      hcfg.head_dim), True, hcfg.attn_window, args.seed)
    wcfg = get_config(WHISPER_ARCH)
    whisper = serve_two_ways(WHISPER_ARCH, args.seed, card, WHISPER_BATCH,
                             WHISPER_PROMPT, WHISPER_NEW, "flash_fwd_wgmma",
                             fe_slots=wcfg.n_audio_ctx, exact=True)
    _free()
    heads = (wcfg.n_heads, wcfg.n_kv_heads)
    whisper["flash_layer"] = time_flash_layer(
        WHISPER_ARCH, (WHISPER_BATCH, *heads, wcfg.n_audio_ctx, wcfg.head_dim),
        False, 0, args.seed)
    whisper["flash_decoder_layer"] = time_flash_layer(
        f"{WHISPER_ARCH} decoder", (WHISPER_BATCH, *heads, WHISPER_PROMPT,
                                    wcfg.head_dim), True, 0, args.seed)
    vlm = vlm_prefill_full_width(args.seed, card)
    _free()
    vcfg = get_config(VLM_ARCH)
    vlm["flash_layer"] = time_flash_layer(
        VLM_ARCH, (VLM_BATCH, vcfg.n_heads, vcfg.n_kv_heads, VLM_PROMPT,
                   vcfg.head_dim), True, 0, args.seed)
    check_ssm_gradient(args.seed, card)
    _free()
    trained_ssm = _cut_cli(SSM_ARCH, SSM_TRAIN_DEPTH, card, TRAIN_SSM_CLI)
    _free()
    mla = serve_mla_full_width(args.seed, card)
    _free()
    moe = serve_two_ways(MOE_ARCH, args.seed, card, MOE_BATCH, MOE_PROMPT,
                         MOE_NEW, "flash_fwd_wgmma", depth=MOE_DEPTH, keep=True)
    moe["ep"] = check_ep_armed(moe.pop("_model"), moe.pop("_params"),
                               args.seed, card)
    _free()
    mcfg = get_config(MOE_ARCH)
    moe["flash_layer"] = time_flash_layer(
        MOE_ARCH, (MOE_BATCH, mcfg.n_heads, mcfg.n_kv_heads, MOE_PROMPT,
                   mcfg.head_dim), True, 0, args.seed)
    _free()
    bench_overlap = bench_overlap_full_width(args.seed, card, layout["shapes"])
    _free()
    host_cmds = host_commands(card)
    trained_tp = train_tp_full_width(card)
    _free()
    trained_moe = train_moe_full_width(args.seed, card)
    _free()
    trained_moe_dense = train_moe_dense_fallback(args.seed, card)
    _free()
    dry = dry_run_phase(args.seed, card)
    _free()
    # each kernel's launches come from the path it carries; the peer ring's
    # from the user's entry point (the hand-wired planned run's beside it)
    paths = {"wkv_chunked": served, "wkv_scan": served, "fused_add": trained,
             "flash_attention": served_dense, "peer_ring": trained_cli}
    for k in kernels:
        k["launches"] = paths[k["name"]]["launches"][k["name"]]
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on its path")
        if k["name"] == "peer_ring":
            k["launches_planned_run"] = trained_planned["launches"]["peer_ring"]
        if k["name"] == "fused_add":
            k["launches_group_run"] = grouped["launches"]["fused_add"]
            k["launches_compression"] = compressed["launches"]["fused_add"]
            k["launches_bench_overlap_runner"] = bench_overlap["runner"][
                "counted"]["launches"]["fused_add"]
        if k["name"] == "peer_ring":
            k["launches_moe_train"] = trained_moe["train"]["launches"]["peer_ring"]
            k["launches_moe_dense_train"] = {
                "smoke": trained_moe_dense["smoke"]["launches"]["peer_ring"],
                "published": trained_moe_dense["published"]["launches"][
                    "peer_ring"]}
        if k["name"] == "fused_add":
            k["launches_moe_tp_layer"] = trained_moe["tp_layer"]["fused_add"]
        if k["name"] in ("fused_add", "peer_ring"):
            k["launches_tp_train"] = {
                label: run["launches"][k["name"]]
                for label, run in trained_tp["runs"].items()}
        if k["name"] == "peer_ring":
            k["launches_ssm_train"] = trained_ssm["launches"]["peer_ring"]
            k["launches_bench_overlap"] = bench_overlap["launches"]["peer_ring"]
        if k["name"] == "flash_attention":
            k["launches_by_path"] = {
                DENSE_ARCH: served_dense["launches"]["flash_attention"],
                HYBRID_ARCH: hybrid["launches"]["flash_attention"],
                WHISPER_ARCH: whisper["launches"]["flash_attention"],
                VLM_ARCH: vlm["launches"]["flash_attention"],
                MOE_ARCH: moe["launches"]["flash_attention"],
                MLA_ARCH: mla["launches"]["flash_attention"],
                "dry run anchor": dry["launches"]["flash_attention"],
                f"{PIPE_ARCH} pipeline": piped["bf16_flash"]["launches"][
                    "flash_attention"]}
            # every model's layer shape on a flash path (PERF.md section 6)
            k["hybrid_layer"] = hybrid["flash_layer"]
            k["whisper_encoder_layer"] = whisper["flash_layer"]
            k["whisper_decoder_layer"] = whisper["flash_decoder_layer"]
            k["vlm_layer"] = vlm["flash_layer"]
            k["dbrx_layer"] = moe["flash_layer"]
    if trained_ssm["launches"]["peer_ring"] < 1:
        raise AssertionError("peer_ring never launched on the ssm train command")
    _say("new phases' seconds: " + json.dumps({
        "pipeline_virtual": piped["phase_s"], "group_spawn": grouped["wall_s"],
        "compression": compressed["phase_s"], "solver_eval": solver["phase_s"],
        "bench_overlap": bench_overlap["phase_s"],
        "host_commands": host_cmds["phase_s"],
        "tp_train": trained_tp["phase_s"],
        "moe_train": trained_moe["phase_s"],
        "moe_dense_train": trained_moe_dense["phase_s"],
        "dry_run": dry["phase_s"]}))
    _say(f"the whole script: {time.monotonic() - t_start:.1f} s (host clock)")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
